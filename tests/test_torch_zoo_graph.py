"""The zoo's graph models and TinyYOLO against the JAX package on the CPU,
with the layers and vertices they brought into the port.

Each model at its reference test's shrunk configuration (or the smallest
input its pools allow) is built in both packages; the JAX network's
parameters carry across (`graph_params_from_numpy` /
`multilayer_params_from_numpy`) with every BN's running statistics drawn
away from (0, 1), and the same seeded numpy batch goes through both.
Tolerances: forward and score 1e-5 relative to max(1, max |JAX|) (f32
convolutions and sums in another order); parameters and BN state after
one `fit` step (Nesterovs(1e-2, 0.9), dropout off in both packages: the
masks cannot match across the two generators) 1e-5 the same way; a layer
or vertex against its JAX twin, its gradient included, 1e-5; the fused
graph against the unfused one 1e-4 (the plain versions of the fused
kernels sum in another order)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu.nn.conf.graph_vertices as jgv
import deeplearning4j_tpu.nn.conf.layers as jlayers
import deeplearning4j_tpu.nn.conf.preprocessors as jpp
import deeplearning4j_tpu.nn.fused as jfused
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
import deeplearning4j_tpu_torch.nn as tnn
import deeplearning4j_tpu_torch.nn.conf.graph_vertices as tgv
import deeplearning4j_tpu_torch.nn.conf.layers as tlayers
import deeplearning4j_tpu_torch.nn.conf.preprocessors as tpp
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.conf.special_layers import \
    CenterLossOutputLayer as JCenterLoss
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.models import zoo as tzoo
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType as TInputType
from deeplearning4j_tpu_torch.nn.conf.special_layers import \
    CenterLossOutputLayer as TCenterLoss
from deeplearning4j_tpu_torch.nn.fused import find_conv1x1_bn_fusions

from test_torch_multilayer import _close, _np_tree

TOL = 1e-5

#: each model at the size its reference test runs it, or the smallest
#: input its pools allow (YOLO at 64×64 for a 2×2 grid)
SMALL = {
    "UNet": dict(inputShape=(8, 8, 3)),
    "TinyYOLO": dict(inputShape=(64, 64, 3), numClasses=3),
    "SqueezeNet": dict(inputShape=(16, 16, 3), numClasses=4),
    "Xception": dict(inputShape=(64, 64, 3), numClasses=4,
                     middleFlowBlocks=1),
    "InceptionResNetV1": dict(inputShape=(64, 64, 3), numClasses=4,
                              blocks=(1, 1, 1)),
    "YOLO2": dict(inputShape=(64, 64, 3), numClasses=4),
    "FaceNetNN4Small2": dict(inputShape=(16, 16, 3), numClasses=5),
    "NASNet": dict(inputShape=(32, 32, 3), numClasses=4, numBlocks=1,
                   filters=8, stemFilters=8),
    "EfficientNet": dict(inputShape=(32, 32, 3), numClasses=3),
}
#: the models one `fit` step is held to the JAX package's in
FIT = ("InceptionResNetV1", "FaceNetNN4Small2", "TinyYOLO", "YOLO2",
       "NASNet")
#: fusable conv1x1+BN pairs at full width (the JAX package's own count)
PAIRS = {"InceptionResNetV1": 36, "FaceNetNN4Small2": 21, "EfficientNet": 16,
         "NASNet": 8, "Xception": 4, "YOLO2": 0, "UNet": 0, "SqueezeNet": 0}


def yolo_labels(b, h, w, n_cls, seed=0):
    """One ground-truth box in a random cell per image, in grid units (the
    layout of tests/test_objdetect.py)."""
    rng = np.random.default_rng(seed)
    lab = np.zeros((b, h, w, 4 + n_cls), np.float32)
    for i in range(b):
        ci, cj = rng.integers(h), rng.integers(w)
        lab[i, ci, cj, 0] = cj + rng.random()
        lab[i, ci, cj, 1] = ci + rng.random()
        lab[i, ci, cj, 2] = 1 + rng.random() * 2
        lab[i, ci, cj, 3] = 1 + rng.random() * 2
        lab[i, ci, cj, 4 + rng.integers(n_cls)] = 1.0
    return lab


def _batch(name, b=4, seed=1):
    """(features, labels) of `b` examples for model `name`."""
    kw = SMALL[name]
    rng = np.random.default_rng(seed)
    x = rng.random((b,) + kw["inputShape"], np.float32)
    h, w = kw["inputShape"][:2]
    if name == "UNet":
        y = (rng.random((b, h, w, 1)) > 0.5).astype(np.float32)
    elif name in ("TinyYOLO", "YOLO2"):
        y = yolo_labels(b, h // 32, w // 32, kw["numClasses"], seed)
    else:
        n = kw["numClasses"]
        y = np.eye(n, dtype=np.float32)[rng.integers(0, n, b)]
    return x, y


def _no_dropout(conf):
    layers = (conf.layers if hasattr(conf, "layers")
              else [n.ref for n in conf.nodes.values() if n.kind == "layer"])
    for layer in layers:
        layer.dropOut = None


def _np(tree):
    return {n: {k: v.detach().numpy().copy() for k, v in d.items()}
            for n, d in tree.items()}


def _bn_stats_in_compute_dtype(x):
    """The JAX package's `_bn_stats` without its cast to f32."""
    axes = tuple(range(x.ndim - 1))
    s1 = jnp.mean(x, axes)
    return s1, jnp.maximum(jnp.mean(x * x, axes) - s1 * s1, 0.0)


def _pair(name, step=False, fuse=False, monkeypatch=None):
    """(JAX net, port net) of model `name` at SMALL on one set of weights:
    the port's draw from the zoo's seed (the JAX package would draw the
    same shapes; its layers size themselves in an `init` traced by
    `jax.eval_shape`, which draws nothing), with BN running statistics
    from seed 9. `step`: Nesterovs(1e-2, 0.9), dropout off and both nets
    in f64 (see test_one_fit_step_matches_the_jax_package)."""
    kw = dict(SMALL[name])
    jkw, tkw = dict(kw), dict(kw)
    if step:
        jkw.update(updater=jnn.Nesterovs(1e-2, 0.9), dataType="float64")
        tkw.update(updater=tnn.Nesterovs(1e-2, 0.9), dataType="float64")
    jconf = getattr(jzoo, name)(**jkw).conf()
    tconf = getattr(tzoo, name)(**tkw).conf()
    if step:
        _no_dropout(jconf)
        _no_dropout(tconf)
    graph = not hasattr(jconf, "layers")
    tnet = (tnn.ComputationGraph if graph else tnn.MultiLayerNetwork)(tconf)
    params, state = (_np(t) for t in tnet._draw())
    rng = np.random.default_rng(9)
    for n in sorted(state):
        state[n] = {"mean": (rng.standard_normal(state[n]["mean"].shape)
                             * 0.1).astype(np.float32),
                    "var": rng.uniform(0.5, 2.0, state[n]["var"].shape)
                    .astype(np.float32)}
    jnet = (JGraph if graph else jnn.MultiLayerNetwork)(jconf)
    with jax.enable_x64(step):
        jax.eval_shape(lambda: jnet.init()._state)
        jnet._params = jax.tree_util.tree_map(jnp.asarray, params)
        jnet._state = jax.tree_util.tree_map(jnp.asarray, state)
        jnet._build_optimizer()
    if fuse:
        monkeypatch.setenv("DL4J_TPU_FUSE_CONV_BN", "1")
    convert = (tnn.graph_params_from_numpy if graph
               else tnn.multilayer_params_from_numpy)
    return jnet, convert(tnet, params, state, device="cpu")


def _first(out):
    return out[0] if isinstance(out, (list, tuple)) else out


# -- the models ----------------------------------------------------------------
def test_every_zoo_model_imports_from_the_port_zoo():
    for name in list(SMALL) + ["ResNet50", "LeNet", "SimpleCNN", "AlexNet",
                               "VGG16", "VGG19", "Darknet19",
                               "TextGenerationLSTM"]:
        assert name in tzoo.__all__ and hasattr(tzoo, name), name
    assert set(jzoo.__all__) <= set(tzoo.__all__)


def _jax_output_and_score(jnet, x, y):
    """The JAX net's inference output and score(DataSet) (its `_forward`
    and `_loss` at train=False, as `output()` and `score()` call them),
    in one jitted program: one XLA compile instead of one per operation."""
    if hasattr(jnet.conf, "layers"):
        def f(p, s, x, y):
            out = jnet._forward(p, s, x, False, None)[0]
            return out, jnet._loss(p, s, x, y, None, None, None,
                                   train=False)[0]
        return jax.jit(f)(jnet._params, jnet._state, x, y)
    ins, labels, fm, lm = jnet._unpack(JDataSet(x, y))

    def g(p, s, ins, labels):
        out = jnet._forward(p, s, ins, False, None)[0][
            jnet.conf.output_names[0]]
        return out, jnet._loss(p, s, ins, labels, fm, lm, None,
                               train=False)[0]
    return jax.jit(g)(jnet._params, jnet._state, ins, labels)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_zoo_graph_model_forward_and_score_match_the_jax_package(name):
    """Inference forward and score (BN running statistics, l2 penalty
    and, for FaceNet, the center loss included) on the same weights."""
    jnet, tnet = _pair(name)
    x, y = _batch(name)
    want, jscore = _jax_output_and_score(jnet, x, y)
    _close(_first(tnet.output(x)), np.asarray(want), TOL, f"{name} output")
    assert [type(l).__name__ for _, l in tnet._layer_items()] == [
        type(l).__name__ for l in (
            jnet.conf.layers if hasattr(jnet.conf, "layers")
            else [jnet.nodes[n].ref for n in jnet._layer_names])]
    _close(tnet.score(DataSet(x, y)), float(jscore), TOL, f"{name} score")


@pytest.mark.parametrize("name", FIT)
def test_one_fit_step_matches_the_jax_package(name, monkeypatch):
    """One `fit` step with Nesterovs(1e-2, 0.9), dropout off: the loss,
    every parameter (FaceNet's `centers` and NASNet's separable `dW`/`pW`
    under l2 included) and the BN state.

    Both nets compute in f64 (parameters stay f32), the JAX package's BN
    statistics taken in the compute dtype: it casts them to f32 whatever
    the dtype, and in f32 its statistics at these 16-row BNs are ~1e-5
    from f64 (E[x²] − E[x]² summed in XLA's order), enough to flip a
    relu or leakyrelu mask (InceptionResNetV1's redB_bn had one flip and a
    β gradient 27 % from f64, YOLO2's head gradient was 2e-4 off), while
    the port's f32 step is within 1e-6 of its f64 one. In f64 the two
    packages' parameters after the step agree to ~1e-7."""
    monkeypatch.setattr(jlayers, "_bn_stats", _bn_stats_in_compute_dtype)
    jnet, tnet = _pair(name, step=True)
    x, y = _batch(name, b=4, seed=3)
    with jax.enable_x64(True):
        jnet.fit(JDataSet(x, y))
        jloss = float(jnet.score())
        jp, js = _np_tree(jnet._params), _np_tree(jnet._state)
    tnet.fit(DataSet(x, y))
    _close(tnet.score(), jloss, TOL, f"{name} loss")
    assert set(jp) == set(tnet._params)
    for n, d in jp.items():
        for k, v in d.items():
            _close(tnet._params[n][k], v, TOL, f"{name} {n}/{k}")
    for n, d in js.items():
        for k, v in d.items():
            _close(tnet._state[n][k], v, TOL, f"{name} state {n}/{k}")
    if name == "FaceNetNN4Small2":
        assert float(tnet._params["out"]["centers"].abs().max()) > 0


def test_inception_resnet_fused_equals_unfused(monkeypatch):
    """With DL4J_TPU_FUSE_CONV_BN=1 the six 1×1 conv+BN pairs of the
    shrunk InceptionResNetV1 run the fused path (plain versions on the
    CPU); its output and score equal the unfused net's within 1e-4."""
    _, plain = _pair("InceptionResNetV1")
    _, fused = _pair("InceptionResNetV1", fuse=True, monkeypatch=monkeypatch)
    assert len(fused._fused_pairs) == 6 and not plain._fused_pairs
    x, y = _batch("InceptionResNetV1")
    _close(fused.output(x), plain.output(x).numpy(), 1e-4, "fused output")
    _close(fused.score(DataSet(x, y)), plain.score(DataSet(x, y)), 1e-4,
           "fused score")


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_fusion_marks_the_jax_package_pairs(name):
    """At full width the port's fusion pass marks the JAX pass's pairs, and
    never a DepthwiseConvolution2D or SeparableConvolution2D."""
    jpairs = jfused.find_conv1x1_bn_fusions(getattr(jzoo, name)().conf())
    tconf = getattr(tzoo, name)().conf()
    tpairs = find_conv1x1_bn_fusions(tconf)
    assert tpairs == jpairs and len(tpairs) == PAIRS[name]
    assert all(type(tconf.nodes[c].ref) is tlayers.ConvolutionLayer
               for c in tpairs.values())


@pytest.mark.parametrize("name,count", [("InceptionResNetV1", 11_565_192),
                                        ("YOLO2", 67_445_065),
                                        ("EfficientNet", 5_288_548)])
def test_full_width_parameter_counts(name, count):
    """The published widths' parameter counts, from the port's own draw
    of the built configuration on the CPU."""
    net = tnn.ComputationGraph(getattr(tzoo, name)().conf())
    params, _ = net._draw()
    assert sum(v.numel() for d in params.values()
               for v in d.values()) == count


def test_carried_parameters_are_checked_key_by_key():
    """`graph_params_from_numpy` takes the new parameter trees (separable
    `dW`/`pW`, depthwise `W`, `centers`; the parameterless heads have no
    entry) and refuses a missing key or a wrong shape, as for every
    layer."""
    for name, node, key in (("NASNet", "n1_0_b1a_s", "pW"),
                            ("EfficientNet", "s1r0_d_c", "W"),
                            ("FaceNetNN4Small2", "out", "centers")):
        tconf = getattr(tzoo, name)(**SMALL[name]).conf()
        params, state = (_np(t) for t in
                         tnn.ComputationGraph(tconf)._draw())
        assert key in params[node]
        net = tnn.graph_params_from_numpy(tnn.ComputationGraph(tconf),
                                          params, state, device="cpu")
        assert net._params[node][key].shape == params[node][key].shape
        bad = {n: dict(d) for n, d in params.items()}
        bad[node][key] = bad[node][key][..., :-1]
        with pytest.raises(ValueError, match=f"{node}.{key}: expected"):
            tnn.graph_params_from_numpy(tnn.ComputationGraph(tconf), bad,
                                        state, device="cpu")
        del bad[node][key]
        with pytest.raises(ValueError, match="expected keys"):
            tnn.graph_params_from_numpy(tnn.ComputationGraph(tconf), bad,
                                        state, device="cpu")
    assert "out" not in tnn.ComputationGraph(
        tzoo.YOLO2(**SMALL["YOLO2"]).conf())._draw()[0]


def test_efficientnet_scaling_se_and_dropout():
    E = tzoo.EfficientNet
    for args, want in (((32, 1.0), 32), ((32, 1.1), 32), ((320, 1.4), 448),
                       ((1280, 2.0), 2560), ((24, 1.8), 40)):
        assert E._round_filters(*args) == want \
            == jzoo.EfficientNet._round_filters(*args)
    assert E._round_repeats(3, 1.8) == 6 \
        == jzoo.EfficientNet._round_repeats(3, 1.8)
    conf = E("B0", numClasses=3, inputShape=(32, 32, 3)).conf()
    assert sum(n.endswith("_se_mul") for n in conf.nodes) == 16
    assert sum(n.endswith("_add") for n in conf.nodes) == 9
    assert isinstance(conf.nodes["s1r0_se_rs"].ref, tgv.ReshapeVertex)
    b2 = E("B2", numClasses=3, inputShape=(32, 32, 3)).conf()
    assert len(b2.nodes) > len(conf.nodes)
    assert E("B4", numClasses=2).DEFAULT_INPUT == (380, 380, 3)
    for variant, retain in (("B0", 0.8), ("B7", 0.5)):
        c = E(variant, numClasses=3, inputShape=(32, 32, 3)).conf()
        assert abs(c.nodes["drop"].ref.dropOut - retain) < 1e-9
    with pytest.raises(ValueError, match="variant"):
        E("B9")


def test_zoo_defaults_follow_the_jax_package():
    for name in SMALL:
        t, j = getattr(tzoo, name)(), getattr(jzoo, name)()
        assert t.DEFAULT_INPUT == j.DEFAULT_INPUT, name
        assert type(t.conf().defaults["updater"]).__name__ == type(
            j.conf().defaults["updater"]).__name__, name
    assert tzoo.YOLO2.PRIORS == jzoo.YOLO2.PRIORS
    assert tzoo.TinyYOLO.PRIORS == jzoo.TinyYOLO.PRIORS
    assert tzoo.TinyYOLO(boxes=2).priors == jzoo.TinyYOLO(boxes=2).priors
    with pytest.raises(ValueError, match="boxes=9"):
        tzoo.TinyYOLO(boxes=9)


# -- the layers ----------------------------------------------------------------
def _in_both(jlayer, tlayer, input_type, x, seed=0):
    """Run one layer in both packages on the same parameters (drawn by
    numpy in the JAX layer's shapes) and input, forward and the gradient
    of Σ out·r to the input and every parameter."""
    jp, _, jout = jlayer.initialize(jax.random.PRNGKey(0),
                                    JInputType.convolutional(*input_type))
    tp, _, tout = tlayer.initialize(torch.Generator().manual_seed(0),
                                    TInputType.convolutional(*input_type))
    assert {k: tuple(v.shape) for k, v in tp.items()} == {
        k: tuple(v.shape) for k, v in jp.items()}
    assert tuple(tout.shape()) == tuple(jout.shape())
    rng = np.random.default_rng(seed)
    p = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.3
         for k, v in jp.items()}

    def jf(p, x):
        return jlayer.apply(p, {}, x)[0]

    jp = {k: jnp.asarray(v) for k, v in p.items()}
    y = np.asarray(jax.jit(jf)(jp, jnp.asarray(x)))
    r = rng.standard_normal(y.shape).astype(np.float32)
    jg = jax.jit(jax.grad(lambda p, x: jnp.sum(jf(p, x) * r),
                          argnums=(0, 1)))(jp, jnp.asarray(x))
    tpar = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    ty = tlayer.apply(tpar, {}, tx)[0]
    _close(ty, y, TOL, "forward")
    (ty * torch.tensor(r)).sum().backward()
    _close(tx.grad, np.asarray(jg[1]), TOL, "dx")
    for k in p:
        _close(tpar[k].grad, np.asarray(jg[0][k]), TOL, f"d{k}")
    return ty


@pytest.mark.parametrize("mult", [1, 2])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("mode", ["same", "truncate"])
def test_depthwise_convolution_matches_the_jax_package(mult, stride, mode):
    kw = dict(kernelSize=(3, 3), stride=(stride, stride),
              convolutionMode=mode, depthMultiplier=mult,
              activation="identity", weightInit="relu")
    x = np.random.default_rng(1).standard_normal((2, 9, 9, 5)).astype(
        np.float32)
    jl = jlayers.DepthwiseConvolution2D(**kw).apply_defaults({})
    tl = tlayers.DepthwiseConvolution2D(**kw).apply_defaults({})
    y = _in_both(jl, tl, (9, 9, 5), x)
    assert tl.nOut == 5 * mult and y.shape[-1] == 5 * mult


@pytest.mark.parametrize("case", ["5x5/2 same", "3x3 truncate bias",
                                  "7x7/2 same mult 2"])
def test_separable_convolution_matches_the_jax_package(case):
    kw = {"5x5/2 same": dict(kernelSize=(5, 5), stride=(2, 2),
                             convolutionMode="same", hasBias=False),
          "3x3 truncate bias": dict(kernelSize=(3, 3), padding=(1, 1)),
          "7x7/2 same mult 2": dict(kernelSize=(7, 7), stride=(2, 2),
                                    convolutionMode="same",
                                    depthMultiplier=2, hasBias=False),
          }[case]
    kw.update(nOut=6, activation="relu", weightInit="relu")
    x = np.random.default_rng(2).standard_normal((2, 11, 11, 4)).astype(
        np.float32)
    _in_both(jlayers.SeparableConvolution2D(**kw).apply_defaults({}),
             tlayers.SeparableConvolution2D(**kw).apply_defaults({}),
             (11, 11, 4), x)


@pytest.mark.parametrize("size", [2, (2, 3)])
def test_upsampling_matches_the_jax_package(size):
    x = np.random.default_rng(3).standard_normal((2, 3, 4, 5)).astype(
        np.float32)
    y = _in_both(jlayers.Upsampling2D(size=size).apply_defaults({}),
                 tlayers.Upsampling2D(size=size).apply_defaults({}),
                 (3, 4, 5), x)
    s = tlayers._pair(size)
    assert tuple(y.shape) == (2, 3 * s[0], 4 * s[1], 5)


def test_loss_layer_matches_the_jax_package():
    """LossLayer: the activation in `apply`, the loss on the raw input."""
    x = np.random.default_rng(4).standard_normal((3, 4, 4, 1)).astype(
        np.float32)
    y = (np.random.default_rng(5).random((3, 4, 4, 1)) > 0.5).astype(
        np.float32)
    jl = jlayers.LossLayer(lossFunction="xent",
                           activation="sigmoid").apply_defaults({})
    tl = tlayers.LossLayer(lossFunction="xent",
                           activation="sigmoid").apply_defaults({})
    _in_both(jl, tl, (4, 4, 1), x)
    _close(tl.compute_loss(torch.tensor(y), tl.pre_activation({},
                                                              torch.tensor(x))),
           float(jl.compute_loss(jnp.asarray(y), jnp.asarray(x))), TOL,
           "loss")


def test_center_loss_layer_in_a_multilayer_network():
    """CenterLossOutputLayer at the end of a MultiLayerNetwork: the loss
    reads the layer's input; score and one Sgd step, `centers` included,
    against the JAX package."""
    def conf(nn, center):
        return (nn.NeuralNetConfiguration.Builder().seed(3)
                .updater(nn.Sgd(0.5)).list()
                .layer(nn.DenseLayer(nOut=6, activation="tanh"))
                .layer(center(lambda_=0.3, alpha=0.4, nOut=3,
                              activation="softmax"))
                .setInputType(nn.InputType.feedForward(5)).build())

    jnet = jnn.MultiLayerNetwork(conf(jnn, JCenterLoss)).init()
    tnet = tnn.multilayer_params_from_numpy(
        tnn.MultiLayerNetwork(conf(tnn, TCenterLoss)),
        _np_tree(jnet._params), {}, device="cpu")
    rng = np.random.default_rng(6)
    x = rng.standard_normal((8, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    _close(tnet.score(DataSet(x, y)), jnet.score(JDataSet(x, y)), TOL,
           "score")
    for _ in range(2):
        jnet.fit(JDataSet(x, y))
        tnet.fit(DataSet(x, y))
    for n, d in _np_tree(jnet._params).items():
        for k, v in d.items():
            _close(tnet._params[n][k], v, TOL, f"{n}/{k}")
    assert float(tnet._params["1"]["centers"].abs().max()) > 0


# -- the vertices --------------------------------------------------------------
_RNG = np.random.default_rng(7)
_X4 = _RNG.standard_normal((2, 4, 6, 3)).astype(np.float32)
_X2 = _RNG.standard_normal((4, 6)).astype(np.float32)
_Y2 = _RNG.standard_normal((4, 6)).astype(np.float32)

VERTICES = {
    "ScaleVertex": (lambda m: m.ScaleVertex(0.17), [_X4],
                    [(4, 6, 3)]),
    "ShiftVertex": (lambda m: m.ShiftVertex(-0.5), [_X2], [6]),
    "L2NormalizeVertex": (lambda m: m.L2NormalizeVertex(), [_X2], [6]),
    "PreprocessorVertex": (lambda m: m.PreprocessorVertex(
        (jpp if m is jgv else tpp).CnnToFeedForwardPreProcessor(4, 6, 3)),
        [_X4], [(4, 6, 3)]),
    "ReshapeVertex 2-D": (lambda m: m.ReshapeVertex(-1, 72), [_X4],
                          [(4, 6, 3)]),
    "ReshapeVertex 4-D": (lambda m: m.ReshapeVertex(-1, 1, 1, 6), [_X2],
                          [6]),
    "SpaceToDepthVertex": (lambda m: m.SpaceToDepthVertex(2), [_X4],
                           [(4, 6, 3)]),
    "SubsetVertex": (lambda m: m.SubsetVertex(1, 3), [_X2], [6]),
    "StackVertex": (lambda m: m.StackVertex(), [_X2, _Y2], [6, 6]),
    "UnstackVertex": (lambda m: m.UnstackVertex(1, 2), [_X2], [6]),
    "L2Vertex": (lambda m: m.L2Vertex(), [_X2, _Y2], [6, 6]),
}


def _itype(mod, t):
    it = JInputType if mod is jgv else TInputType
    return (it.convolutional(*t) if isinstance(t, tuple)
            else it.feedForward(t))


@pytest.mark.parametrize("name", sorted(VERTICES))
def test_vertices_match_the_jax_package(name):
    make, xs, types = VERTICES[name]
    jv, tv = make(jgv), make(tgv)
    want = np.asarray(jv.apply(*[jnp.asarray(x) for x in xs]))
    got = tv.apply(*[torch.tensor(x) for x in xs])
    _close(got, want, TOL, name)
    jt = jv.output_type(*[_itype(jgv, t) for t in types])
    tt = tv.output_type(*[_itype(tgv, t) for t in types])
    assert type(tt).__name__ == type(jt).__name__
    assert tuple(tt.shape()) == tuple(jt.shape())


def test_space_to_depth_is_the_reference_permutation():
    """(n, h/b, b, w/b, b, c) → (0, 1, 3, 2, 4, 5): output channel
    (i·b + j)·C + c of block (y, x) is pixel (y·b + i, x·b + j), channel c."""
    x = torch.arange(2 * 4 * 6 * 3, dtype=torch.float32).reshape(2, 4, 6, 3)
    y = tgv.SpaceToDepthVertex(2).apply(x)
    assert tuple(y.shape) == (2, 2, 3, 12)
    for i in range(2):
        for j in range(2):
            assert torch.equal(y[:, :, :, (i * 2 + j) * 3:(i * 2 + j + 1) * 3],
                               x[:, i::2, j::2, :])


def test_l2_normalize_takes_eps_inside_the_root():
    v = tgv.L2NormalizeVertex(eps=1.0)
    x = torch.tensor([[3.0, 4.0]])
    assert torch.allclose(v.apply(x), x / np.sqrt(26.0))
