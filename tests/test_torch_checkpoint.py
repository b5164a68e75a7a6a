"""The port's configuration JSON and model archives against the JAX
package's, on the CPU: both packages read each other's files.

- The JSON of every zoo model's configuration, and of one configuration
  per layer family this slice ports, equals the JAX package's key for
  key; `fromJson(toJson(c))` gives the same JSON back.
- A JAX-written archive restored by the port, and a port-written one by
  the JAX package: parameters and BN state exactly equal, `output()`
  within 1e-5 relative to max(1, max |JAX|) (f32 sums in another order).
- Updater state: a JAX archive resumed for 2 steps in the port against 2
  more JAX steps (Adam, Nesterovs, per-layer updaters through
  multi_transform, a Bidirectional layer's nested parameters), and the
  reverse direction: parameters within 1e-6 relative to max(1, max |JAX|).
  bf16 momentum (`momentumDtype`) bit for bit.
- Normalizers, the unpickler's refusal of other JAX globals, ModelGuesser,
  the generator state and a custom SameDiff layer through the port's own
  archive."""
import importlib
import io
import json
import pickle
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.normalizers import \
    NormalizerStandardize as JNormalizerStandardize
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.util.model_guesser import \
    ModelGuesser as JModelGuesser
from deeplearning4j_tpu.util.model_serializer import \
    ModelSerializer as JModelSerializer
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.datasets.normalizers import \
    NormalizerStandardize
from deeplearning4j_tpu_torch.models import zoo as tzoo
from deeplearning4j_tpu_torch.nn import ComputationGraph, MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.conf.samediff_layers import SameDiffLayer
from deeplearning4j_tpu_torch.util import serde
from deeplearning4j_tpu_torch.util.model_guesser import (
    ModelGuesser, ModelGuesserException)
from deeplearning4j_tpu_torch.util.model_serializer import ModelSerializer

from test_torch_layers_rest import JCG, JMLN, J, T
from test_torch_multilayer import _close, _np_tree

# -- configurations, built alike in both packages ------------------------------
def _conv_conf(ns, updater):
    return (ns.NeuralNetConfiguration.Builder().seed(3).updater(updater)
            .list()
            .layer(ns.ConvolutionLayer(kernelSize=(3, 3), nOut=4,
                                       activation="tanh"))
            .layer(ns.BatchNormalization())
            .layer(ns.SubsamplingLayer(kernelSize=(2, 2), stride=(2, 2)))
            .layer(ns.DenseLayer(nOut=6, activation="tanh"))
            .layer(ns.OutputLayer(nOut=3))
            .setInputType(ns.InputType.convolutional(8, 8, 2)).build())


def _dense_conf(ns, updater, own=None):
    """tanh layers (no dead units: every gradient element well away from 0);
    `own`: an updater of layer 1's own (multi_transform)."""
    return (ns.NeuralNetConfiguration.Builder().seed(5).updater(updater)
            .list()
            .layer(ns.DenseLayer(nOut=7, activation="tanh"))
            .layer(ns.DenseLayer(nOut=5, activation="tanh", updater=own))
            .layer(ns.OutputLayer(nOut=3))
            .setInputType(ns.InputType.feedForward(4)).build())


def _bilstm_conf(ns, updater):
    return (ns.NeuralNetConfiguration.Builder().seed(7).updater(updater)
            .list()
            .layer(ns.Bidirectional(ns.LSTM(nOut=3, activation="tanh")))
            .layer(ns.RnnOutputLayer(nOut=2, lossFunction="mcxent"))
            .setInputType(ns.InputType.recurrent(3, 5)).build())


def _graph_conf(ns, updater):
    return (ns.NeuralNetConfiguration.Builder().seed(9).updater(updater)
            .graphBuilder().addInputs("in")
            .setInputTypes(ns.InputType.convolutional(6, 6, 2))
            .addLayer("c1", ns.ConvolutionLayer(kernelSize=(1, 1), nOut=4,
                                                hasBias=False), "in")
            .addLayer("bn", ns.BatchNormalization(activation="relu"), "c1")
            .addLayer("c2", ns.ConvolutionLayer(kernelSize=(3, 3), nOut=3,
                                                convolutionMode="same",
                                                activation="tanh"), "in")
            .addVertex("cat", ns.MergeVertex(), "bn", "c2")
            .addLayer("gap", ns.GlobalPoolingLayer(poolingType="avg"), "cat")
            .addLayer("out", ns.OutputLayer(nOut=3), "gap")
            .setOutputs("out").build())


def _family_confs(ns):
    """One configuration per layer family this slice ports."""
    b = lambda: ns.NeuralNetConfiguration.Builder().seed(1).updater(  # noqa
        ns.Adam(1e-3)).list()
    vae = ns.VariationalAutoencoder(
        nOut=2, encoderLayerSizes=(5,), decoderLayerSizes=(5,),
        reconstructionDistribution=ns.CompositeReconstructionDistribution(
            [(3, ns.BernoulliReconstructionDistribution()),
             (3, ns.GaussianReconstructionDistribution("tanh"))]))
    return {
        "layers": b().layer(ns.ZeroPaddingLayer(padding=(1, 2)))
        .layer(ns.Cropping2D(cropping=(1, 1)))
        .layer(ns.LocalResponseNormalization(n=3))
        .layer(ns.Deconvolution2D(nOut=3, kernelSize=(4, 4), stride=(2, 2),
                                  padding=(1, 1)))
        .layer(ns.PReLULayer(alphaInit=0.1))
        .layer(ns.CnnLossLayer(lossFunction="mse", activation="identity"))
        .setInputType(ns.InputType.convolutional(5, 5, 2)).build(),
        "seq1d": b().layer(ns.Convolution1DLayer(nOut=4, kernelSize=3))
        .layer(ns.Subsampling1DLayer(kernelSize=2, stride=1))
        .layer(ns.Upsampling1D(size=2)).layer(ns.ZeroPadding1DLayer(1))
        .layer(ns.Cropping1D(1))
        .layer(ns.LocallyConnected1D(nOut=3, kernelSize=2))
        .layer(ns.ElementWiseMultiplicationLayer(activation="tanh"))
        .layer(ns.RnnOutputLayer(nOut=2))
        .setInputType(ns.InputType.recurrent(3, 6)).build(),
        "special": b().layer(ns.LocallyConnected2D(nOut=3, kernelSize=(2, 2)))
        .layer(ns.PermuteLayer(dims=(2, 1, 3)))
        .layer(ns.DenseLayer(nOut=6, weightNoise=ns.DropConnect(0.7)))
        .layer(ns.AutoEncoder(nOut=4, corruptionLevel=0.2))
        .layer(ns.RepeatVector(repetitionFactor=2))
        .layer(ns.LSTM(nOut=3, weightNoise=ns.WeightNoise(
            {"type": "normal", "std": 0.05})))
        .layer(ns.RnnOutputLayer(nOut=2))
        .setInputType(ns.InputType.convolutional(5, 5, 2)).build(),
        "vae": b().layer(vae).layer(ns.OutputLayer(nOut=2))
        .setInputType(ns.InputType.feedForward(6)).build(),
        "capsules": b().layer(ns.ConvolutionLayer(kernelSize=(3, 3), nOut=4))
        .layer(ns.PrimaryCapsules(capsuleDimensions=4, channels=2,
                                  kernelSize=(3, 3), stride=(2, 2)))
        .layer(ns.CapsuleLayer(capsules=3, capsuleDimensions=4, routings=2))
        .layer(ns.CapsuleStrengthLayer())
        .layer(ns.LossLayer(lossFunction="mcxent", activation="softmax"))
        .setInputType(ns.InputType.convolutional(9, 9, 1)).build(),
        "3d": b().layer(ns.Convolution3D(nOut=3, kernelSize=(2, 2, 2),
                                         convolutionMode="same"))
        .layer(ns.Subsampling3DLayer(kernelSize=(2, 2, 2), stride=(1, 1, 1)))
        .layer(ns.ZeroPadding3DLayer(padding=1)).layer(ns.Cropping3D(1))
        .layer(ns.Upsampling3D(size=2))
        .layer(ns.Deconvolution3D(nOut=2, kernelSize=(2, 2, 2)))
        .layer(ns.Cnn3DLossLayer(lossFunction="mse", activation="identity"))
        .setInputType(ns.InputType.convolutional3D(3, 3, 3, 2)).build(),
        "ocnn": b().layer(ns.DenseLayer(nOut=4))
        .layer(ns.OCNNOutputLayer(hiddenLayerSize=3))
        .setInputType(ns.InputType.feedForward(5)).build(),
        "bilstm": _bilstm_conf(ns, ns.Nesterovs(0.1, 0.9)),
        "graph": _graph_conf(ns, ns.RmsProp(1e-2)),
    }


ZOO = [n for n in dir(tzoo) if n[0].isupper() and n != "ZooModel"
       and hasattr(tzoo.__dict__[n], "conf")]


@pytest.mark.parametrize("name", ZOO)
def test_zoo_configuration_json_equals_the_jax_package(name):
    """The zoo model's configuration at its default width: the same JSON in
    both packages, and the port's fromJson(toJson(c)) gives it back."""
    tconf = getattr(tzoo, name)().conf()
    want = json.loads(getattr(jzoo, name)().conf().toJson())
    assert json.loads(tconf.toJson()) == want
    again = type(tconf).fromJson(tconf.toJson())
    assert json.loads(again.toJson()) == want


@pytest.mark.parametrize("family", sorted(_family_confs(T)))
def test_family_configuration_json_equals_the_jax_package(family):
    """One configuration per new layer family: the JSON is the JAX
    package's key for key; each package reads the other's."""
    tconf, jconf = _family_confs(T)[family], _family_confs(J)[family]
    want = json.loads(jconf.toJson())
    assert json.loads(tconf.toJson()) == want
    for reader in (type(tconf), type(jconf)):
        assert json.loads(reader.fromJson(tconf.toJson()).toJson()) == want


def test_objects_outside_the_registry_round_trip_through_the_port():
    """Dropout objects and constraints record their module: the port writes
    the JAX package's name for its own module and reads either back (the
    JAX package refuses such classes at restore, so only the port reads
    them), with a schedule as a learning rate."""
    def conf(ns):
        return (ns.NeuralNetConfiguration.Builder().seed(1)
                .updater(ns.Adam(ns.StepSchedule(1e-2, 0.5, 10))).list()
                .layer(ns.DenseLayer(nOut=4, dropOut=ns.GaussianDropout(0.3),
                                     constraints=[ns.MaxNormConstraint(2.0)]))
                .layer(ns.DenseLayer(nOut=4, dropOut=ns.AlphaDropout(0.8)))
                .layer(ns.OutputLayer(nOut=2))
                .setInputType(ns.InputType.feedForward(3)).build())

    want = json.loads(conf(J).toJson())
    assert json.loads(conf(T).toJson()) == want
    assert want["layers"][0]["dropOut"]["@module"] == \
        "deeplearning4j_tpu.nn.dropout"
    back = type(conf(T)).fromJson(json.dumps(want))
    assert type(back.layers[0].dropOut) is T.GaussianDropout
    assert type(back.layers[0].constraints[0]) is T.MaxNormConstraint
    assert json.loads(back.toJson()) == want


def test_every_registry_class_of_the_jax_package_resolves_in_the_port():
    """Each config class of the JAX package's serde registry resolves, by
    name, to the port's class of that name in the port's module of the
    same path, FrozenVertex and the quantized configurations
    (`quantize.policy`, `quantize.infer`) among them."""
    from deeplearning4j_tpu.util import serde as jserde
    assert [m.replace("deeplearning4j_tpu.", "deeplearning4j_tpu_torch.", 1)
            for m in jserde._CONFIG_MODULES] == serde._CONFIG_MODULES
    for mod in jserde._CONFIG_MODULES:
        m = importlib.import_module(mod)
        for name, cls in vars(m).items():
            if not (isinstance(cls, type) and cls.__module__ == mod
                    and not name.startswith("_")):
                continue
            got = type(serde.decode({"@class": name}))
            assert (got.__name__, got.__module__) == (
                name, mod.replace("deeplearning4j_tpu.",
                                  "deeplearning4j_tpu_torch.", 1)), name


def test_unknown_config_classes_raise():
    """A module that is not imported is never imported by a configuration
    file."""
    with pytest.raises(ValueError, match="not imported"):
        serde.decode({"@class": "X", "@module": "no_such_module_of_tests"})


# -- archives ------------------------------------------------------------------
def _batch(conf_name, b=6, seed=0):
    rng = np.random.default_rng(seed)
    shape, n = {"conv": ((8, 8, 2), 3), "dense": ((4,), 3),
                "bilstm": ((5, 3), 2), "graph": ((6, 6, 2), 3)}[conf_name]
    x = rng.standard_normal((b,) + shape).astype(np.float32)
    cls = rng.integers(0, n, b if conf_name != "bilstm" else (b, 5))
    return x, np.eye(n, dtype=np.float32)[cls]


CONFS = {"conv": _conv_conf, "dense": _dense_conf, "bilstm": _bilstm_conf,
         "graph": _graph_conf}


def _jax_net(name, updater):
    return (JCG if name == "graph" else JMLN)(CONFS[name](J, updater)).init()


def _port_net(name, updater):
    conf = CONFS[name](T, updater)
    cls = ComputationGraph if name == "graph" else MultiLayerNetwork
    return cls(conf).init(device="cpu")


def _jout(net, x):
    out = net.output(x)
    return np.asarray(out.numpy() if hasattr(out, "numpy") else out)


def _same_trees(port_tree, jax_tree_np, exact=True, rel=0.0, what=""):
    """Port tree (flat names) against a JAX numpy tree (nested)."""
    from deeplearning4j_tpu_torch.nn.convert import _flat
    assert set(port_tree) == set(jax_tree_np), what
    for n, d in jax_tree_np.items():
        flat = _flat(d)
        assert set(flat) == set(port_tree[n]), (what, n)
        for k, v in flat.items():
            got = port_tree[n][k].detach().float().numpy()
            if exact:
                assert np.array_equal(got, np.asarray(v, np.float32)), \
                    (what, n, k)
            else:
                _close(got, v, rel, f"{what} {n}/{k}")


@pytest.mark.parametrize("name", sorted(CONFS))
def test_jax_archive_restores_in_the_port(name, tmp_path):
    """A JAX-written archive (after one JAX step, so BN state and the
    optimizer state are not their initial values): the port's restore on
    the CPU holds the same parameters and state bit for bit and the same
    output within 1e-5."""
    jnet = _jax_net(name, J.Adam(1e-2))
    x, y = _batch(name)
    jnet.fit(JDataSet(x, y))
    path = str(tmp_path / "jax.zip")
    JModelSerializer.writeModel(jnet, path, saveUpdater=True)
    cls = ComputationGraph if name == "graph" else MultiLayerNetwork
    tnet = cls.load(path, device="cpu")
    assert isinstance(tnet, cls) and tnet._device.type == "cpu"
    _same_trees(tnet._params, _np_tree(jnet._params), what="params")
    _same_trees(tnet._state, _np_tree(jnet._state), what="state")
    _close(tnet.output(x), _jout(jnet, x), 1e-5, f"{name} output")


@pytest.mark.parametrize("name", sorted(CONFS))
def test_port_archive_restores_in_the_jax_package(name, tmp_path):
    """A port-written archive (after one port step): the JAX package's
    restore holds the same parameters and state bit for bit and gives the
    same output within 1e-5."""
    tnet = _port_net(name, T.Adam(1e-2))
    x, y = _batch(name)
    tnet.fit(DataSet(x, y))
    path = str(tmp_path / "port.zip")
    tnet.save(path)
    jnet = (JModelSerializer.restoreComputationGraph if name == "graph"
            else JModelSerializer.restoreMultiLayerNetwork)(path)
    _same_trees(tnet._params, _np_tree(jnet._params), what="params")
    _same_trees(tnet._state, _np_tree(jnet._state), what="state")
    _close(tnet.output(x), _jout(jnet, x), 1e-5, f"{name} output")


def test_port_archive_stores_its_arrays_and_deflates_its_text(tmp_path):
    """The array entries are stored (deflate spends seconds on a model's
    weights to save a few percent), the text entries deflated; the JAX
    package restores the archive with the same parameters bit for bit."""
    tnet = _port_net("graph", T.Adam(1e-2))
    x, y = _batch("graph")
    tnet.fit(DataSet(x, y))
    path = str(tmp_path / "port.zip")
    tnet.save(path)
    with zipfile.ZipFile(path) as zf:
        kinds = {i.filename: i.compress_type for i in zf.infolist()}
    assert kinds == {"modeltype.txt": zipfile.ZIP_DEFLATED,
                     "configuration.json": zipfile.ZIP_DEFLATED,
                     "coefficients.npz": zipfile.ZIP_STORED,
                     "state.npz": zipfile.ZIP_STORED,
                     "updaterState.bin": zipfile.ZIP_STORED,
                     "generatorState.bin": zipfile.ZIP_DEFLATED}, kinds
    jnet = JModelSerializer.restoreComputationGraph(path)
    _same_trees(tnet._params, _np_tree(jnet._params), what="params")


FAMILY_ARCHIVES = {"capsules": (9, 9, 1), "3d": (3, 3, 3, 2), "vae": (6,),
                   "layers": (5, 5, 2), "seq1d": (6, 3)}


@pytest.mark.parametrize("family", sorted(FAMILY_ARCHIVES))
def test_family_archives_restore_both_ways(family, tmp_path):
    """The new families' parameter layouts (capsule W, 3-D and transposed
    kernels, the VAE's heads, the unshared kernels, PReLU's alpha) carry
    across as they are: a JAX archive restores in the port and the port's
    archive of that network in the JAX package, parameters bit for bit,
    outputs within 1e-5."""
    jnet = JMLN(_family_confs(J)[family]).init()
    x = np.random.default_rng(3).standard_normal(
        (2,) + FAMILY_ARCHIVES[family]).astype(np.float32)
    jpath, tpath = str(tmp_path / "jax.zip"), str(tmp_path / "port.zip")
    JModelSerializer.writeModel(jnet, jpath)
    tnet = MultiLayerNetwork.load(jpath, device="cpu")
    _same_trees(tnet._params, _np_tree(jnet._params), what=family)
    want = _jout(jnet, x)
    _close(tnet.output(x), want, 1e-5, f"{family} output")
    tnet.save(tpath)
    back = JModelSerializer.restoreMultiLayerNetwork(tpath)
    _same_trees(tnet._params, _np_tree(back._params), what=family)
    np.testing.assert_array_equal(_jout(back, x), want)


RESUME = {"adam": (lambda ns: ns.Adam(1e-2), None),
          "nesterovs": (lambda ns: ns.Nesterovs(1e-2, 0.9), None),
          "per-layer": (lambda ns: ns.Adam(1e-2), lambda ns: ns.Nesterovs(
              5e-2, 0.8))}


@pytest.mark.parametrize("case", sorted(RESUME))
@pytest.mark.parametrize("direction", ["jax->port", "port->jax"])
def test_updater_state_resumes_across_the_packages(case, direction,
                                                   tmp_path):
    """Two steps in the writing package, save with the updater state,
    restore in the other; then 2 more steps in each: the parameters
    agree within 1e-6."""
    upd, own = RESUME[case]
    x, y = _batch("dense", b=8)
    x2, y2 = _batch("dense", b=8, seed=1)
    jconf = _dense_conf(J, upd(J), own and own(J))
    tconf = _dense_conf(T, upd(T), own and own(T))
    path = str(tmp_path / "resume.zip")
    if direction == "jax->port":
        jnet = JMLN(jconf).init()
        for xb, yb in ((x, y), (x2, y2)):
            jnet.fit(JDataSet(xb, yb))
        JModelSerializer.writeModel(jnet, path, saveUpdater=True)
        tnet = MultiLayerNetwork.load(path, device="cpu")
    else:
        tnet = MultiLayerNetwork(tconf).init(device="cpu")
        for xb, yb in ((x, y), (x2, y2)):
            tnet.fit(DataSet(xb, yb))
        tnet.save(path)
        jnet = JModelSerializer.restoreMultiLayerNetwork(path)
    for xb, yb in ((x2, y2), (x, y)):
        jnet.fit(JDataSet(xb, yb))
        tnet.fit(DataSet(xb, yb))
    _same_trees(tnet._params, _np_tree(jnet._params), exact=False,
                rel=1e-6, what=f"{case} {direction}")


def test_bidirectional_updater_leaves_follow_optax_order(tmp_path):
    """A Bidirectional LSTM keeps flat "fwd_W" names in the port and nested
    {"fwd": {"W"}} ones in the JAX package: the archive's Nesterovs traces
    land on their own parameters in both directions (2 more steps agree
    within 1e-6)."""
    x, y = _batch("bilstm")
    jnet = _jax_net("bilstm", J.Nesterovs(5e-2, 0.9))
    jnet.fit(JDataSet(x, y))
    path = str(tmp_path / "bi.zip")
    JModelSerializer.writeModel(jnet, path)
    tnet = MultiLayerNetwork.load(path, device="cpu")
    trace = jax.tree_util.tree_leaves(jnet._opt_state)
    from deeplearning4j_tpu_torch.util.model_serializer import _optax_leaves
    for got, want in zip(_optax_leaves(tnet), trace):
        assert np.array_equal(got.numpy(), np.asarray(want))
    for _ in range(2):
        jnet.fit(JDataSet(x, y))
        tnet.fit(DataSet(x, y))
    _same_trees(tnet._params, _np_tree(jnet._params), exact=False,
                rel=1e-6, what="bilstm")


def test_bf16_momentum_restores_bit_for_bit(tmp_path):
    """Nesterovs(momentumDtype="bfloat16"): the JAX archive stores the
    trace through ml_dtypes; the port reads the raw bits as torch.bfloat16
    and writes them back (widened to f32, exactly)."""
    jconf = _dense_conf(J, J.Nesterovs(1e-2, 0.9, momentumDtype="bfloat16"))
    jnet = JMLN(jconf).init()
    x, y = _batch("dense")
    jnet.fit(JDataSet(x, y))
    path = str(tmp_path / "bf16.zip")
    JModelSerializer.writeModel(jnet, path)
    tnet = MultiLayerNetwork.load(path, device="cpu")
    from deeplearning4j_tpu_torch.util.model_serializer import _optax_leaves
    leaves = _optax_leaves(tnet)
    want = jax.tree_util.tree_leaves(jnet._opt_state)
    # the six traces, then the learning-rate schedule's count
    assert len(leaves) == len(want) == 7 and leaves[-1].dtype == torch.int32
    assert all(t.dtype == torch.bfloat16 for t in leaves[:-1])
    for got, w in zip(leaves, want):
        assert np.array_equal(got.float().numpy(),
                              np.asarray(w.astype(jnp.float32)))
    path2 = str(tmp_path / "bf16_port.zip")
    tnet.save(path2)
    again = MultiLayerNetwork.load(path2, device="cpu")
    for a, b in zip(_optax_leaves(again), leaves):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_bf16_npz_entries_read_as_raw_bits():
    """A bf16 array the JAX package writes into an npz (through ml_dtypes:
    a 2-byte void entry) is read as the same bf16 values, nested names
    joined into the port's flat ones."""
    import ml_dtypes
    from deeplearning4j_tpu_torch.util.model_serializer import \
        _npz_bytes_to_tree
    a = np.array([1.5, -2.25, 3e-3, 7.0], ml_dtypes.bfloat16)
    buf = io.BytesIO()
    np.savez(buf, **{"0/fwd/W": a})
    got = _npz_bytes_to_tree(buf.getvalue())["0"]["fwd_W"]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, torch.tensor(a.astype(np.float32)).bfloat16())


def test_normalizer_from_a_jax_archive_and_a_planted_pickle(tmp_path):
    """A JAX archive's NormalizerStandardize becomes the port's with the
    same statistics; a normalizer entry naming another global of the JAX
    package is refused."""
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((16, 4)).astype(np.float32) * 3 + 1
    jnorm = JNormalizerStandardize()
    jnorm.fit(JDataSet(feats, np.zeros((16, 3), np.float32)))
    path = str(tmp_path / "norm.zip")
    jnet = _jax_net("dense", J.Sgd(0.1))
    JModelSerializer.writeModel(jnet, path, normalizer=jnorm)
    norm = ModelSerializer.restoreNormalizerFromFile(path)
    assert type(norm) is NormalizerStandardize
    np.testing.assert_array_equal(norm.mean, jnorm.mean)
    np.testing.assert_array_equal(norm.std, jnorm.std)
    np.testing.assert_array_equal(norm.transform(feats),
                                  jnorm.transform(feats))
    assert type(ModelGuesser.loadNormalizer(path)) is NormalizerStandardize
    planted = str(tmp_path / "planted.zip")
    JModelSerializer.writeModel(jnet, planted, normalizer=J.Sgd(0.5))
    with pytest.raises(pickle.UnpicklingError, match="deeplearning4j_tpu"):
        ModelSerializer.restoreNormalizerFromFile(planted)
    # the port's own normalizer round-trips through the port
    own = str(tmp_path / "own.zip")
    tnet = _port_net("dense", T.Sgd(0.1))
    tnorm = NormalizerStandardize()
    tnorm.fit(DataSet(feats, np.zeros((16, 3), np.float32)))
    tnet.save(own, normalizer=tnorm)
    np.testing.assert_array_equal(
        ModelSerializer.restoreNormalizerFromFile(own).std, tnorm.std)


def test_updater_pickle_refuses_other_globals(tmp_path):
    """The updater state is read as numpy arrays only."""
    tnet = _port_net("dense", T.Adam(1e-2))
    path = str(tmp_path / "bad.zip")
    tnet.save(path, saveUpdater=False)
    with zipfile.ZipFile(path, "a") as zf:
        zf.writestr("updaterState.bin", pickle.dumps([T.Sgd(0.1)]))
    with pytest.raises(pickle.UnpicklingError, match="numpy arrays"):
        MultiLayerNetwork.load(path, device="cpu")


def test_model_guesser_on_both_kinds_and_its_a17_errors(tmp_path):
    """Either kind of archive from either package. The SameDiff and Keras
    branches are ported (they were ROADMAP A17's): a broken SameDiff
    archive and a file that is neither a zip nor Keras raise naming every
    format tried, the SameDiff and the Keras readers among them."""
    mln_path, cg_path = str(tmp_path / "m.zip"), str(tmp_path / "g.zip")
    JModelSerializer.writeModel(_jax_net("dense", J.Sgd(0.1)), mln_path)
    _port_net("graph", T.Sgd(0.1)).save(cg_path)
    assert isinstance(ModelGuesser.loadModelGuess(mln_path, device="cpu"),
                      MultiLayerNetwork)
    assert isinstance(ModelGuesser.loadModelGuess(cg_path, device="cpu"),
                      ComputationGraph)
    assert type(JModelGuesser.loadModelGuess(cg_path)).__name__ == \
        "ComputationGraph"
    sd = str(tmp_path / "sd.zip")
    with zipfile.ZipFile(sd, "w") as zf:
        zf.writestr("samediff.json", "{}")
    other = tmp_path / "model.h5"
    other.write_bytes(b"not a zip")
    for bad, tried in ((sd, "samediff"), (str(other), "keras")):
        with pytest.raises(ModelGuesserException,
                           match=f"any known.*{tried}"):
            ModelGuesser.loadModelGuess(bad, device="cpu")
    garbage = str(tmp_path / "garbage.zip")
    with zipfile.ZipFile(garbage, "w") as zf:
        zf.writestr("x.txt", "x")
    with pytest.raises(ModelGuesserException, match="any known"):
        ModelGuesser.loadModelGuess(garbage, device="cpu")


def test_resumed_training_with_dropout_equals_the_uninterrupted_run(
        tmp_path):
    """The archive carries the dropout generator's state: 2 steps after a
    restore equal 2 more steps of the uninterrupted network bit for bit."""
    conf = (T.NeuralNetConfiguration.Builder().seed(2).updater(T.Adam(1e-2))
            .list().layer(T.DenseLayer(nOut=8, activation="tanh",
                                       dropOut=0.7))
            .layer(T.OutputLayer(nOut=3))
            .setInputType(T.InputType.feedForward(4)).build())
    net = MultiLayerNetwork(conf).init(device="cpu")
    x, y = _batch("dense", b=8)
    for _ in range(2):
        net.fit(DataSet(x, y))
    path = str(tmp_path / "drop.zip")
    net.save(path)
    back = MultiLayerNetwork.load(path, device="cpu")
    for _ in range(2):
        net.fit(DataSet(x, y))
        back.fit(DataSet(x, y))
    for n in net._params:
        for k in net._params[n]:
            assert torch.equal(net._params[n][k], back._params[n][k]), (n, k)
    assert net.score() == back.score()


class TimesPlus(SameDiffLayer):
    """A custom layer of this test module (restored through @module)."""

    def __init__(self, nOut=None, **kw):
        super().__init__(**kw)
        self.nOut = nOut

    def defineParameters(self):
        return {"W": (self.nIn, self.nOut), "b": (self.nOut,)}

    def defineLayer(self, params, x, mask=None):
        return torch.tanh(x @ params["W"] + params["b"])


def test_custom_samediff_layer_round_trips_through_the_port(tmp_path):
    """A SameDiffLayer subclass of an imported module: the configuration
    records its module, the restore resolves it, outputs equal."""
    conf = (T.NeuralNetConfiguration.Builder().seed(4).updater(T.Sgd(0.1))
            .list().layer(TimesPlus(nOut=5))
            .layer(T.OutputLayer(nOut=2))
            .setInputType(T.InputType.feedForward(3)).build())
    net = MultiLayerNetwork(conf).init(device="cpu")
    assert json.loads(conf.toJson())["layers"][0]["@module"] == __name__
    path = str(tmp_path / "custom.zip")
    net.save(path)
    back = MultiLayerNetwork.load(path, device="cpu")
    x = np.random.default_rng(0).standard_normal((4, 3)).astype(np.float32)
    assert type(back.layers[0]) is TimesPlus
    assert torch.equal(back.output(x), net.output(x))
