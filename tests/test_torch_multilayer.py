"""The port's MultiLayerNetwork (nn/multilayer.py) and the zoo's `.list()`
CNNs against the JAX package on the CPU: the same seeded numpy inputs and
the same parameters, carried across by `multilayer_params_from_numpy`, go
through both packages. Then the contracts of tests/test_multilayer.py that
this slice covers, mirrored on the port, and MultiLayerNetwork against a
ComputationGraph of the same layer chain (the two classes share one step).

Tolerances: forward and score 1e-5 relative to max(1, max |JAX|) (f32
convolutions and sums in another order); parameters and BN state after one
Nesterovs step 1e-5 the same way; the MultiLayerNetwork against the chain
graph and `stepsPerDispatch` against the sequential loop bit for bit (the
same operations on the same tensors)."""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu_torch.nn as tnn
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models.zoo import models as jzoo
from deeplearning4j_tpu.models.zoo import models2 as jzoo2
from deeplearning4j_tpu_torch.datasets import (DataSet, IrisDataSetIterator,
                                               ListDataSetIterator,
                                               MnistDataSetIterator)
from deeplearning4j_tpu_torch.models import zoo as tzoo
from deeplearning4j_tpu_torch.runtime.executables import tensor_leaves
from deeplearning4j_tpu_torch.nn import (Activation, Adam, BatchNormalization,
                                         ComputationGraph, ConvolutionLayer,
                                         DenseLayer, InputType,
                                         LossFunction, MultiLayerNetwork,
                                         Nesterovs, NeuralNetConfiguration,
                                         OutputLayer, Sgd, SubsamplingLayer,
                                         WeightInit)

JZOO = {"LeNet": jzoo.LeNet, "SimpleCNN": jzoo.SimpleCNN,
        "AlexNet": jzoo.AlexNet, "VGG16": jzoo.VGG16, "VGG19": jzoo2.VGG19,
        "Darknet19": jzoo2.Darknet19}


def _close(got, want, rel, what=""):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = rel * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, (what, err, tol)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# -- against the JAX package ----------------------------------------------------
PARITY = {"LeNet": dict(inputShape=(28, 28, 1)),
          "SimpleCNN": dict(inputShape=(48, 48, 3)),
          "VGG16": dict(inputShape=(32, 32, 3))}


def _zoo_pair(name, no_dropout=False, perturb_bn=False, nesterovs=False):
    kw = dict(PARITY[name], numClasses=10)
    jkw, tkw = dict(kw), dict(kw)
    if nesterovs:
        jkw["updater"], tkw["updater"] = (jnn.Nesterovs(1e-2, 0.9),
                                          Nesterovs(1e-2, 0.9))
    jconf = JZOO[name](**jkw).conf()
    tconf = getattr(tzoo, name)(**tkw).conf()
    if no_dropout:
        for conf in (jconf, tconf):
            for layer in conf.layers:
                layer.dropOut = None
    jnet = jnn.MultiLayerNetwork(jconf).init()
    params, state = _np_tree(jnet._params), _np_tree(jnet._state)
    if perturb_bn:   # running statistics away from (0, 1)
        rng = np.random.default_rng(9)
        for n in state:
            state[n] = {"mean": rng.standard_normal(
                state[n]["mean"].shape).astype(np.float32) * 0.1,
                "var": rng.uniform(0.5, 2.0, state[n]["var"].shape).astype(
                    np.float32)}
        jnet._state = jax.tree_util.tree_map(jnp.asarray, state)
    tnet = tnn.multilayer_params_from_numpy(MultiLayerNetwork(tconf), params,
                                            state, device="cpu")
    return jnet, tnet


def _zoo_batch(name, b=4, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.random((b,) + PARITY[name]["inputShape"], np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, b)]
    return x, y


@pytest.mark.parametrize("name", sorted(PARITY))
def test_zoo_forward_and_score_match_the_jax_package(name):
    """Inference forward, feedForward and score (BN running statistics
    included) on the same weights and inputs."""
    _zoo_forward_and_score(*_zoo_pair(name, perturb_bn=True), name)


def _zoo_forward_and_score(jnet, tnet, name):
    x, y = _zoo_batch(name)
    _close(tnet.output(x), np.asarray(jnet.output(x).numpy()), 1e-5,
           f"{name} output")
    jacts, tacts = jnet.feedForward(x), tnet.feedForward(x)
    assert len(jacts) == len(tacts) == tnet.getnLayers()
    _close(tacts[-2], np.asarray(jacts[-2].numpy()), 1e-5, "feedForward")
    _close(tnet.score(DataSet(x, y)), jnet.score(JDataSet(x, y)), 1e-5,
           f"{name} score")


@pytest.mark.parametrize("name", ["LeNet", "SimpleCNN"])
def test_one_nesterovs_step_matches_the_jax_package(name):
    """One `fit` step (training BN, Nesterovs) on the same batch: the new
    parameters, BN state and loss, both nets on Nesterovs(1e-2, 0.9).
    Dropout is taken off both nets: the masks cannot match across the two
    packages' generators."""
    jnet, tnet = _zoo_pair(name, no_dropout=True, nesterovs=True)
    x, y = _zoo_batch(name, b=8)
    jnet.fit(JDataSet(x, y))
    tnet.fit(DataSet(x, y))
    _close(tnet.score(), float(jnet.score()), 1e-5, "loss")
    for n, d in _np_tree(jnet._params).items():
        for k, v in d.items():
            _close(tnet._params[n][k], v, 1e-5, f"{name} {n}/{k}")
    for n, d in _np_tree(jnet._state).items():
        for k, v in d.items():
            _close(tnet._state[n][k], v, 1e-5, f"{name} state {n}/{k}")


def test_compute_gradients_match_the_jax_package():
    """computeGradients (the full regularized loss, training-mode forward,
    no dropout) on LeNet: every leaf to 1e-4 of its largest |JAX| value
    (f32 convolution backward sums in another order)."""
    jnet, tnet = _zoo_pair("LeNet")
    x, y = _zoo_batch("LeNet", b=8)
    jgrads = _np_tree(jnet.computeGradients(jnp.asarray(x), jnp.asarray(y)))
    tgrads = tnet.computeGradients(x, y)
    assert set(tgrads) == set(jgrads)
    for n, d in jgrads.items():
        for k, v in d.items():
            err = float(np.abs(tgrads[n][k].numpy() - v).max())
            assert err <= 1e-4 * float(np.abs(v).max()), (n, k, err)


@pytest.mark.parametrize("name", sorted(JZOO))
def test_zoo_model_builds_with_the_jax_layers_and_shapes(name):
    """Each `.list()` model of the zoo: a MultiLayerNetwork whose layer
    types and parameter and state shapes are the JAX package's (at 64×64,
    10 classes; the JAX shapes by `jax.eval_shape`, nothing drawn)."""
    kw = dict(inputShape=(64, 64, 3), numClasses=10)
    jconf = JZOO[name](**kw).conf()
    net = getattr(tzoo, name)(**kw).init("cpu")
    assert isinstance(net, MultiLayerNetwork)
    assert [type(l).__name__ for l in net.layers] == [
        type(l).__name__ for l in jconf.layers]
    want_p, want_s = {}, {}
    for i, layer in enumerate(jconf.layers):
        p, s = jax.eval_shape(
            lambda k, layer=layer, i=i: layer.initialize(
                k, jconf.input_types[i])[:2], jax.random.PRNGKey(0))
        if p:
            want_p[str(i)] = {k: tuple(v.shape) for k, v in p.items()}
        if s:
            want_s[str(i)] = {k: tuple(v.shape) for k, v in s.items()}
    got_p = {n: {k: tuple(v.shape) for k, v in d.items()}
             for n, d in net._params.items()}
    got_s = {n: {k: tuple(v.shape) for k, v in d.items()}
             for n, d in net._state.items()}
    assert got_p == want_p and got_s == want_s
    assert net.numParams() == sum(int(np.prod(s)) for d in want_p.values()
                                  for s in d.values())


def test_zoo_init_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        assert tzoo.LeNet().init()._device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tzoo.LeNet().init()
    with pytest.raises(RuntimeError, match="no network egress"):
        tzoo.VGG16().initPretrained()


def test_vgg16_at_full_width_has_the_published_parameter_count():
    """224×224×3 and 1000 classes: 138,357,544 parameters (counted from the
    built configuration; nothing drawn)."""
    conf = tzoo.VGG16().conf()
    n = 0
    for layer in conf.layers:
        if isinstance(layer, ConvolutionLayer):
            kh, kw = layer.kernelSize
            n += kh * kw * layer.nIn * layer.nOut + layer.nOut
        elif isinstance(layer, DenseLayer):
            n += layer.nIn * layer.nOut + layer.nOut
    assert n == 138_357_544


# -- the contracts of tests/test_multilayer.py ----------------------------------
def _mlp_conf(n_in=4, n_hidden=16, n_out=3, seed=42, updater=None, l2=0.0):
    return (NeuralNetConfiguration.Builder()
            .seed(seed)
            .updater(updater or Adam(1e-2))
            .weightInit(WeightInit.XAVIER)
            .activation(Activation.RELU)
            .l2(l2)
            .list()
            .layer(DenseLayer.Builder().nOut(n_hidden).build())
            .layer(DenseLayer.Builder().nOut(n_hidden).build())
            .layer(OutputLayer.Builder(LossFunction.MCXENT)
                   .nOut(n_out).activation(Activation.SOFTMAX).build())
            .setInputType(InputType.feedForward(n_in))
            .build())


def _mlp(**kw):
    return MultiLayerNetwork(_mlp_conf(**kw)).init("cpu")


def test_build_and_init():
    net = _mlp()
    assert net.getnLayers() == 3
    assert [l.nIn for l in net.layers] == [4, 16, 16]
    expected = 4 * 16 + 16 + 16 * 16 + 16 + 16 * 3 + 3
    assert net.numParams() == expected
    assert net.params().numel() == expected
    assert set(net.paramTable()) == {"0_W", "0_b", "1_W", "1_b", "2_W",
                                     "2_b"}


def test_output_shape_and_softmax():
    net = _mlp()
    x = np.random.default_rng(0).standard_normal((5, 4)).astype(np.float32)
    out = net.output(x)
    assert out.shape == (5, 3)
    np.testing.assert_allclose(out.sum(-1).numpy(), np.ones(5), rtol=1e-5)


def test_feedforward_activations():
    net = _mlp()
    acts = net.feedForward(np.zeros((2, 4), np.float32))
    assert len(acts) == 3
    assert acts[0].shape == (2, 16) and acts[-1].shape == (2, 3)
    sel = net.activateSelectedLayers(1, 2, acts[0])
    assert torch.allclose(sel, acts[-1])


def _iris_standardized(batch):
    it = IrisDataSetIterator(batch_size=150)
    full = it.next(150)
    mean, std = full.features.mean(0), full.features.std(0)
    x = (full.features - mean) / std
    return ListDataSetIterator([DataSet(x, full.labels)], batch), \
        DataSet(x, full.labels)


def test_fit_decreases_loss_iris():
    it, ds = _iris_standardized(50)
    net = _mlp()
    first = net.score(ds)
    net.fit(it, epochs=30)
    assert net.score(ds) < first * 0.5
    assert net.evaluate(ListDataSetIterator([ds], 150)).accuracy() > 0.9


def test_score_and_listeners_called():
    calls = []

    class Listener:
        def iterationDone(self, model, iteration, epoch):
            calls.append((iteration, epoch, model.score()))

        def onEpochEnd(self, model):
            calls.append("epoch")

    net = _mlp()
    net.setListeners(Listener())
    net.fit(IrisDataSetIterator(batch_size=75), epochs=2)
    assert [c[:2] for c in calls if c != "epoch"] == [(1, 0), (2, 0),
                                                      (3, 1), (4, 1)]
    assert calls.count("epoch") == 2
    assert isinstance(net.score(), float)
    assert net.getIterationCount() == 4 and net.getEpochCount() == 2


def _lenet_conf(updater):
    """LeNet (dl4j-examples' LenetMnistExample), through the reference's
    builder idiom."""
    return (NeuralNetConfiguration.Builder()
            .seed(123)
            .updater(updater)
            .weightInit(WeightInit.XAVIER)
            .list()
            .layer(ConvolutionLayer.Builder(5, 5)
                   .stride(1, 1).nOut(20).activation(Activation.IDENTITY)
                   .build())
            .layer(SubsamplingLayer.Builder("max")
                   .kernelSize(2, 2).stride(2, 2).build())
            .layer(ConvolutionLayer.Builder(5, 5)
                   .stride(1, 1).nOut(50).activation(Activation.IDENTITY)
                   .build())
            .layer(SubsamplingLayer.Builder("max")
                   .kernelSize(2, 2).stride(2, 2).build())
            .layer(DenseLayer.Builder().activation(Activation.RELU)
                   .nOut(500).build())
            .layer(OutputLayer.Builder(LossFunction.NEGATIVELOGLIKELIHOOD)
                   .nOut(10).activation(Activation.SOFTMAX).build())
            .setInputType(InputType.convolutionalFlat(28, 28, 1))
            .build())


def test_lenet_learns_synthetic_mnist():
    """The LeNet MNIST drive: LeNet, Adam(1e-2), 3 epochs of 384
    synthetic MNIST digits in batches of 64, accuracy above 0.85."""
    net = MultiLayerNetwork(_lenet_conf(Adam(1e-2))).init("cpu")
    net.fit(MnistDataSetIterator(64, num_examples=384), epochs=3)
    ev = net.evaluate(MnistDataSetIterator(128, train=False,
                                           num_examples=256))
    assert ev.accuracy() > 0.85, ev.accuracy()


def test_batchnorm_updates_running_stats():
    conf = (NeuralNetConfiguration.Builder()
            .seed(1).updater(Adam(1e-2))
            .list()
            .layer(DenseLayer.Builder().nOut(8).activation("relu").build())
            .layer(BatchNormalization.Builder().build())
            .layer(OutputLayer.Builder("mcxent").nOut(2)
                   .activation("softmax").build())
            .setInputType(InputType.feedForward(4))
            .build())
    net = MultiLayerNetwork(conf).init("cpu")
    before = net._state["1"]["mean"].clone()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((32, 4)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 32)]
    net.fit(x, y)
    assert not torch.allclose(before, net._state["1"]["mean"])


def test_setparams_roundtrip():
    net = _mlp()
    flat = net.params().numpy()
    net2 = _mlp(seed=7)
    net2.setParams(flat)
    np.testing.assert_array_equal(net2.params().numpy(), flat)
    x = np.random.default_rng(2).standard_normal((3, 4)).astype(np.float32)
    assert torch.equal(net.output(x), net2.output(x))
    net2.setParam("0_b", np.full(16, 0.5, np.float32))
    assert torch.equal(net2.getParam("0_b"), torch.full((16,), 0.5))


def test_params_vector_is_the_jax_package_order():
    jnet = jnn.MultiLayerNetwork(jzoo.LeNet(numClasses=10).conf()).init()
    tnet = tnn.multilayer_params_from_numpy(
        MultiLayerNetwork(tzoo.LeNet(numClasses=10).conf()),
        _np_tree(jnet._params), _np_tree(jnet._state), device="cpu")
    np.testing.assert_array_equal(tnet.params().numpy(),
                                  np.asarray(jnet.params().numpy()))
    assert tnet.numParams() == jnet.numParams()


def test_l2_regularization_changes_loss():
    _, ds = _iris_standardized(150)
    assert _mlp(l2=0.1).score(ds) > _mlp(l2=0.0).score(ds)


def test_dropout_only_at_train_time():
    conf = (NeuralNetConfiguration.Builder()
            .seed(3).updater(Adam(1e-3)).dropOut(0.5)
            .list()
            .layer(DenseLayer.Builder().nOut(32).activation("relu").build())
            .layer(OutputLayer.Builder("mcxent").nOut(2)
                   .activation("softmax").build())
            .setInputType(InputType.feedForward(8))
            .build())
    net = MultiLayerNetwork(conf).init("cpu")
    x = np.ones((4, 8), np.float32)
    assert torch.equal(net.output(x), net.output(x))
    gen = torch.Generator().manual_seed(0)
    assert not torch.equal(net.output(x, train=True, generator=gen),
                           net.output(x))


def test_fit_array_signature():
    net = _mlp()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((10, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 10)]
    net.fit(x, y)
    net.fit(DataSet(x, y))
    assert net.getIterationCount() == 2


def test_summary_prints():
    s = _mlp().summary()
    assert "DenseLayer" in s and "Total params: 403" in s


def test_predict_and_f1score():
    conf = (NeuralNetConfiguration.Builder()
            .seed(2).updater(Sgd(0.2)).activation("relu")
            .list()
            .layer(DenseLayer.Builder().nOut(16).build())
            .layer(OutputLayer.Builder("mcxent").nOut(2)
                   .activation("softmax").build())
            .setInputType(InputType.feedForward(3))
            .build())
    net = MultiLayerNetwork(conf).init("cpu")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 3)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x[:, 0] > 0).astype(int)]
    ds = DataSet(x, y)
    for _ in range(40):
        net.fit(ds)
    preds = net.predict(x)
    assert preds.shape == (64,)
    assert (preds == y.argmax(1)).mean() > 0.9
    f1 = net.f1Score(ds)
    assert 0.9 < f1 <= 1.0
    assert abs(net.f1Score(x, y) - f1) < 1e-9


def test_steps_per_dispatch_matches_sequential_fit():
    rng = np.random.default_rng(3)
    sets = [DataSet(rng.normal(size=(16, 6)).astype(np.float32),
                    np.eye(3, dtype=np.float32)[rng.integers(3, size=16)])
            for _ in range(6)]

    def build():
        return MultiLayerNetwork(
            NeuralNetConfiguration.Builder().seed(11).updater(Adam(1e-2))
            .weightInit("xavier").list()
            .layer(DenseLayer(nOut=24, activation="tanh"))
            .layer(OutputLayer(nOut=3, activation="softmax",
                               lossFunction="mcxent"))
            .setInputType(InputType.feedForward(6)).build()).init("cpu")

    seq, grouped = build(), build()
    seq_scores, grouped_scores = [], []
    for _ in range(2):
        for ds in sets:
            seq.fit(ds)
            seq_scores.append(seq.score())

    class Rec:
        def iterationDone(self, net, iteration, epoch):
            grouped_scores.append(net.score())

    grouped.setListeners(Rec())
    grouped.fit(ListDataSetIterator(sets, 16), epochs=2, stepsPerDispatch=4)
    for n in seq._params:
        for k in seq._params[n]:
            assert torch.equal(seq._params[n][k], grouped._params[n][k])
    assert grouped.getIterationCount() == 12
    assert grouped_scores == seq_scores


def test_evaluate_forms_match_the_jax_package():
    """evaluate, evaluateROC, evaluateROCMultiClass, evaluateRegression and
    evaluateCalibration over the same weights and batches."""
    jnet = jnn.MultiLayerNetwork(_jax_mlp_conf()).init()
    tnet = tnn.multilayer_params_from_numpy(
        MultiLayerNetwork(_mlp_conf(n_out=2)), _np_tree(jnet._params),
        _np_tree(jnet._state), device="cpu")
    rng = np.random.default_rng(8)
    x = rng.standard_normal((40, 4)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 40)]
    jsets = [JDataSet(x[i:i + 10], y[i:i + 10]) for i in range(0, 40, 10)]
    tsets = [DataSet(x[i:i + 10], y[i:i + 10]) for i in range(0, 40, 10)]
    e_j, e_t = jnet.evaluate(jsets), tnet.evaluate(tsets)
    assert e_t.accuracy() == e_j.accuracy()
    np.testing.assert_array_equal(e_t.confusionMatrix(), e_j.confusionMatrix())
    assert abs(tnet.evaluateROC(tsets).calculateAUC()
               - jnet.evaluateROC(jsets).calculateAUC()) < 1e-6
    assert abs(tnet.evaluateROCMultiClass(tsets).calculateAUC(1)
               - jnet.evaluateROCMultiClass(jsets).calculateAUC(1)) < 1e-6
    r_t, r_j = tnet.evaluateRegression(tsets), jnet.evaluateRegression(jsets)
    np.testing.assert_allclose(r_t.meanSquaredError(0),
                               r_j.meanSquaredError(0), rtol=1e-5)
    c_t = tnet.evaluateCalibration(tsets, 5, 5)
    c_j = jnet.evaluateCalibration(jsets, 5, 5)
    np.testing.assert_allclose(c_t.expectedCalibrationError(1),
                               c_j.expectedCalibrationError(1), atol=1e-6)


def _jax_mlp_conf():
    return (jnn.NeuralNetConfiguration.Builder().seed(42)
            .updater(jnn.Adam(1e-2)).weightInit("xavier").activation("relu")
            .l2(0.0).list()
            .layer(jnn.DenseLayer(nOut=16)).layer(jnn.DenseLayer(nOut=16))
            .layer(jnn.OutputLayer(lossFunction="mcxent", nOut=2,
                                   activation="softmax"))
            .setInputType(jnn.InputType.feedForward(4)).build())


def test_what_is_not_ported_raises_naming_its_item(tmp_path):
    net = _mlp()
    x = np.zeros((2, 4), np.float32)
    # pretraining, the archives and the JSON run now
    # (tests/test_torch_layers_train.py, tests/test_torch_checkpoint.py):
    # this net has no pretrainable layer, and its archive restores it
    before = [v.clone() for v in net._leaves()]
    assert net.pretrain(x) is net and net.pretrainLayer(0, x) is net
    assert all(torch.equal(a, b) for a, b in zip(before, net._leaves()))
    assert net.toJson() == net.conf.toJson()
    net.save(str(tmp_path / "m.zip"))
    back = MultiLayerNetwork.load(str(tmp_path / "m.zip"), device="cpu")
    assert torch.equal(back.output(x), net.output(x))
    # the detection decode runs now (tests/test_torch_objdetect.py); this
    # net has no Yolo2OutputLayer head
    with pytest.raises(TypeError, match="Yolo2OutputLayer"):
        net.getPredictedObjects(x)
    # the recurrent surface runs now (tests/test_torch_recurrent.py): on a
    # feed-forward net a step is one row, a mask changes nothing, and a
    # truncated-BPTT configuration fits a 2-d batch in one step
    assert net.rnnTimeStep(x).shape == net.output(x).shape
    assert net.rnnGetPreviousState(0) is None
    net.rnnClearPreviousState()
    assert torch.equal(net.output(x, fmask=np.ones((2, 1))), net.output(x))
    tbptt = (NeuralNetConfiguration.Builder().seed(1).updater(Sgd(0.1))
             .list().backpropType("truncated_bptt")
             .layer(OutputLayer(nOut=2))
             .setInputType(InputType.feedForward(4)).build())
    tnet = MultiLayerNetwork(tbptt).init("cpu").fit(x, np.eye(2)[[0, 1]])
    assert tnet.getIterationCount() == 1
    remat = (NeuralNetConfiguration.Builder().seed(1).updater(Sgd(0.1))
             .list().rematPolicy("layers").layer(DenseLayer(nOut=3))
             .layer(OutputLayer(nOut=2))
             .setInputType(InputType.feedForward(4)).build())
    # remat runs now (tests/test_torch_remat.py): the same step as without
    plain = (NeuralNetConfiguration.Builder().seed(1).updater(Sgd(0.1))
             .list().layer(DenseLayer(nOut=3)).layer(OutputLayer(nOut=2))
             .setInputType(InputType.feedForward(4)).build())
    nets = [MultiLayerNetwork(c).init("cpu").fit(x, np.eye(2)[[0, 1]])
            for c in (remat, plain)]
    assert torch.equal(nets[0].params().tensor, nets[1].params().tensor)
    # frozen layers run now (tests/test_torch_transfer.py): inference mode
    # in training, so a frozen layer's dropout draws nothing
    frozen = _mlp_conf()
    frozen.layers[0].frozen = True
    frozen_net = MultiLayerNetwork(frozen).init("cpu")
    frozen_net.fit(x, np.eye(3)[[0, 1]])
    assert np.isfinite(frozen_net.score())
    # weight noise trains now (tests/test_torch_layers_train.py)
    from deeplearning4j_tpu_torch.nn.conf.weightnoise import DropConnect
    noisy = _mlp_conf()
    noisy.layers[1].weightNoise = DropConnect(0.5)
    noisy_net = MultiLayerNetwork(noisy).init("cpu")
    noisy_net.fit(x, np.eye(3)[[0, 1]])
    assert np.isfinite(noisy_net.score())


# -- MultiLayerNetwork against a chain ComputationGraph --------------------------
def chain_graph(conf):
    """A ComputationGraph of a MultiLayerConfiguration's layers as a chain,
    node i named "i" (so its parameter tree is keyed as the network's)."""
    g = (NeuralNetConfiguration.Builder().seed(conf.seed)
         .updater(conf.defaults["updater"]).dataType(conf.data_type)
         .graphBuilder().addInputs("input")
         .setInputTypes(conf.input_type))
    prev = "input"
    for i, layer in enumerate(conf.layers):
        g.addLayer(str(i), copy.deepcopy(layer), prev)
        prev = str(i)
    return ComputationGraph(g.setOutputs(prev).build())


def test_multilayer_equals_its_chain_graph():
    """A narrow VGG (dropout on its dense layers) as a MultiLayerNetwork
    and as a chain ComputationGraph on the same parameters: the outputs and
    two training steps' parameters, optimizer state and loss are equal
    bit for bit (one shared step, one dropout generator stream)."""
    conf = tzoo.VGG16(inputShape=(32, 32, 3), numClasses=10).conf()
    net = MultiLayerNetwork(conf).init("cpu")
    graph = tnn.graph_params_from_numpy(
        chain_graph(conf), *tnn.multilayer_params_to_numpy(net),
        device="cpu")
    x, y = _zoo_batch("VGG16", b=4)
    assert torch.equal(net.output(x), graph.output(x))
    for _ in range(2):
        net.fit(DataSet(x, y))
        graph.fit(DataSet(x, y))
    assert net.score() == graph.score()
    for attr in ("_params", "_opt_state"):
        a, b = getattr(net, attr), getattr(graph, attr)
        la, lb = tensor_leaves(a), tensor_leaves(b)
        assert len(la) == len(lb)
        assert all(torch.equal(p, q) for p, q in zip(la, lb)), attr
