"""ComputationGraph training in the port (nn/graph.py `fit`/`score`,
nn/updaters.py `build_optimizer`, the training BatchNorm and the conv1x1+BN
training fusion) against the JAX package on the CPU. The graphs are
tests/test_torch_graph.py's: the JAX weights carry across with
`graph_params_from_numpy`; the port's fused pairs run the plain versions
of its kernels, the JAX package's their Pallas kernels in interpret mode.

Tolerances: parameters, BN state and scores after 3 steps 1e-5 ×
max(1, max |JAX|) per leaf (f32 sums in another order through forward,
backward and 3 updates); the optimizer alone 1e-6 (elementwise f32 math
in the same order); fused against unfused inside the port, the contracts
of tests/test_fused.py:80-122."""
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu_torch.nn as tnn
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn import updaters as jup
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu_torch.datasets import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.nn import updaters as tup
from test_torch_graph import _perturbed, _resnetish_conf


def _close(got, want, rel=1e-5, what=""):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    tol = rel * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, (what, err, tol)


def _batch(seed=5, n=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 8, 8, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


def _nets(monkeypatch, fuse):
    monkeypatch.setenv("DL4J_TPU_FUSE_CONV_BN", "1" if fuse else "0")
    jnet = JGraph(_resnetish_conf("jax")).init()
    params, state = _perturbed(jnet)
    tnet = tnn.graph_params_from_numpy(
        tnn.ComputationGraph(_resnetish_conf("torch")), params, state,
        device="cpu")
    return jnet, tnet


def _trees_close(jtree, ttree, rel, what):
    assert set(jtree) == set(ttree), what
    for n in jtree:
        assert set(jtree[n]) == set(ttree[n]), (what, n)
        for k in jtree[n]:
            _close(ttree[n][k], np.asarray(jtree[n][k]), rel,
                   f"{what} {n}/{k}")


@pytest.mark.parametrize("fuse", [False, True])
def test_three_fit_steps_match_jax(monkeypatch, fuse):
    """`output(x, train=True)`, then 3 `fit` steps (Nesterovs 0.05/0.9):
    parameters, BN running statistics, the last training loss and
    score(ds) as the JAX package's."""
    jnet, tnet = _nets(monkeypatch, fuse)
    assert tnet._fused_pairs == jnet._fused_pairs
    x, y = _batch()
    _close(tnet.output(x, train=True), jnet.output(x, train=True).numpy(),
           1e-4, "output(train=True)")
    for _ in range(3):
        jnet.fit(JDataSet(x, y))
        tnet.fit(DataSet(x, y))
    _trees_close(jnet._params, tnet._params, 1e-5, "params")
    _trees_close(jnet._state, tnet._state, 1e-5, "state")
    _close(tnet.score(), jnet.score(), 1e-5, "score()")
    _close(tnet.score(DataSet(x, y)), jnet.score(JDataSet(x, y)), 1e-5,
           "score(ds)")
    assert tnet.getIterationCount() == jnet.getIterationCount() == 3


def test_fused_matches_unfused_within_the_port(monkeypatch):
    """tests/test_fused.py's contracts: one seed gives both nets the same
    parameters; inference and train-mode forwards agree; 3 steps leave
    scores, parameters and BN statistics equal."""
    nets = []
    for fuse in ("0", "1"):
        monkeypatch.setenv("DL4J_TPU_FUSE_CONV_BN", fuse)
        nets.append(tnn.ComputationGraph(_resnetish_conf("torch"))
                    .init("cpu"))
    plain, fused = nets
    assert fused._fused_pairs == {"bn1": "c1", "bn4": "c4"}
    for name in plain._params:
        for k in plain._params[name]:
            assert torch.equal(plain._params[name][k],
                               fused._params[name][k])
    x, y = _batch()
    np.testing.assert_allclose(plain.output(x), fused.output(x), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(plain.output(x, train=True),
                               fused.output(x, train=True), atol=1e-4,
                               rtol=1e-4)
    for _ in range(3):
        plain.fit(DataSet(x, y))
        fused.fit(DataSet(x, y))
    ds = DataSet(x, y)
    assert np.isfinite(plain.score(ds)) and np.isfinite(fused.score(ds))
    np.testing.assert_allclose(plain.score(ds), fused.score(ds), atol=2e-4,
                               rtol=2e-4)
    for name in plain._params:
        for k in plain._params[name]:
            np.testing.assert_allclose(plain._params[name][k],
                                       fused._params[name][k], atol=2e-3,
                                       rtol=2e-3, err_msg=f"{name}/{k}")
    for name in ("bn1", "bn4"):
        for k in ("mean", "var"):
            np.testing.assert_allclose(plain._state[name][k],
                                       fused._state[name][k], atol=1e-4,
                                       rtol=1e-4, err_msg=f"{name}/{k}")


def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": {"W": rng.standard_normal((3, 4)).astype(np.float32),
                  "b": rng.standard_normal(4).astype(np.float32)},
            "b": {"W": rng.standard_normal((5, 2)).astype(np.float32)},
            "c": {"beta": rng.standard_normal(2).astype(np.float32),
                  "gamma": rng.standard_normal(2).astype(np.float32)}}


def _tmap(fn, tree):
    return {n: {k: fn(v) for k, v in d.items()} for n, d in tree.items()}


#: (name, updater kwargs, gradient normalization, threshold, weight decay,
#: per-node override updaters)
OPT_CASES = [
    ("sgd", ("Sgd", dict(learningRate=0.1)), None, 1.0, 0.0, {}),
    ("nesterovs", ("Nesterovs", dict(learningRate=0.1, momentum=0.9)), None,
     1.0, 0.0, {}),
    ("nesterovs bf16 momentum",
     ("Nesterovs", dict(learningRate=0.1, momentum=0.9,
                        momentumDtype="bfloat16")), None, 1.0, 0.0, {}),
    ("adam", ("Adam", dict(learningRate=1e-2)), None, 1.0, 0.0, {}),
    ("clip elementwise", ("Nesterovs", dict(learningRate=0.1)),
     "ClipElementwiseAbsoluteValue", 0.5, 0.0, {}),
    ("clip l2 per layer", ("Nesterovs", dict(learningRate=0.1)),
     "ClipL2PerLayer", 1.0, 0.0, {}),
    ("clip l2 per param type", ("Sgd", dict(learningRate=0.1)),
     "ClipL2PerParamType", 0.8, 0.0, {}),
    ("renormalize l2", ("Adam", dict(learningRate=1e-2)),
     "RenormalizeL2PerLayer", 1.0, 0.0, {}),
    ("weight decay", ("Adam", dict(learningRate=1e-2)), None, 1.0, 1e-2, {}),
    ("per-layer overrides", ("Nesterovs", dict(learningRate=0.1)),
     "ClipL2PerLayer", 2.0, 1e-3,
     {"b": ("Adam", dict(learningRate=1e-3)),
      "c": ("Sgd", dict(learningRate=0.5))}),
]


@pytest.mark.parametrize("case", OPT_CASES, ids=[c[0] for c in OPT_CASES])
def test_build_optimizer_matches_optax(case):
    """Three updates of the port's optimizer against the JAX package's
    optax chain on the same parameters and gradients."""
    _, (uname, kw), gn, thr, wd, overrides = case
    params = _opt_tree(0)

    def opt(mod, chain):
        tx = mod.build_optimizer(getattr(mod, uname)(**kw), gn, thr, wd)
        if not overrides:
            return tx
        parts = {n: mod.build_optimizer(getattr(mod, u)(**k), gn, thr, wd)
                 for n, (u, k) in overrides.items()}
        labels = {n: (n if n in overrides else "__global__")
                  for n in params}
        return chain({"__global__": tx, **parts}, labels)

    jtx = opt(jup, optax.multi_transform)
    ttx = opt(tup, tup.multi_transform)
    jp, tp = _tmap(jnp.asarray, params), _tmap(torch.from_numpy, params)
    js, ts = jtx.init(jp), ttx.init(tp)
    for step in range(3):
        grads = _tmap(lambda v: v * 3.0, _opt_tree(10 + step))
        ju, js = jtx.update(_tmap(jnp.asarray, grads), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = ttx.update(_tmap(torch.from_numpy, grads), ts, tp)
        tp = tup.apply_updates(tp, tu)
        _trees_close(jp, tp, 1e-6, f"step {step}")


def _mlp_conf(pkg, override):
    """A small dense graph with L2, gradient clipping, weight decay and
    (optionally) its hidden layer on its own updater."""
    nn = jnn if pkg == "jax" else tnn
    hidden = dict(nOut=8, activation="relu")
    if override:
        hidden["updater"] = nn.Adam(1e-2)
    return (nn.NeuralNetConfiguration.Builder()
            .seed(3).updater(nn.Nesterovs(0.05, 0.9)).l2(1e-3)
            .weightDecay(1e-3).gradientNormalization("ClipL2PerLayer")
            .gradientNormalizationThreshold(0.5)
            .graphBuilder().addInputs("input")
            .setInputTypes(nn.InputType.feedForward(6))
            .addLayer("h", nn.DenseLayer(**hidden), "input")
            .addLayer("out", nn.OutputLayer(lossFunction="mcxent", nOut=3,
                                            activation="softmax"), "h")
            .setOutputs("out").build())


@pytest.mark.parametrize("override", [False, True])
def test_graph_optimizer_settings_match_jax(override):
    """L2 in the loss, gradient normalization, weight decay and a layer's
    own updater, through `fit` on both packages."""
    jnet = JGraph(_mlp_conf("jax", override)).init()
    params = jax.tree_util.tree_map(np.asarray, jnet._params)
    tnet = tnn.graph_params_from_numpy(
        tnn.ComputationGraph(_mlp_conf("torch", override)), params, {},
        device="cpu")
    rng = np.random.default_rng(1)
    for _ in range(3):
        x = rng.standard_normal((10, 6)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 10)]
        jnet.fit(x, y)
        tnet.fit(x, y)
        _close(tnet.score(), jnet.score(), 1e-5, "score")
    _trees_close(jnet._params, tnet._params, 1e-5, "params")


class _Recorder:
    def __init__(self):
        self.iterations, self.epochs = [], 0

    def iterationDone(self, net, iteration, epoch):
        self.iterations.append((iteration, epoch, net.score()))

    def onEpochEnd(self, net):
        self.epochs += 1


def test_fit_forms_listeners_counters_and_clone(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_FUSE_CONV_BN", "1")
    net = tnn.ComputationGraph(_resnetish_conf("torch")).init("cpu")
    assert net.score() is None
    rec = _Recorder()
    net.setListeners(rec)
    x, y = _batch()
    twin = net.clone()
    net.fit(x, y)                                  # fit(features, labels)
    twin.fit((x, y))                               # a (features, labels) pair
    _trees_close(net._params, twin._params, 0.0, "fit forms")
    net.fit(MultiDataSet([x], [y]))
    batches = DataSet(x, y).batchBy(8)
    net.fit(batches, epochs=2, stepsPerDispatch=2)
    assert net.getIterationCount() == 6 and net.getEpochCount() == 2
    assert rec.epochs == 2 and [i for i, _, _ in rec.iterations] == list(
        range(1, 7))
    assert all(np.isfinite(s) for _, _, s in rec.iterations)
    # a clone has its own tensors and a fresh optimizer
    c = net.clone()
    assert c._tx is None and c._params["c1"]["W"] is not \
        net._params["c1"]["W"]
    c.fit(x, y)
    assert not torch.equal(c._params["c1"]["W"], net._params["c1"]["W"])


def test_what_is_not_ported_raises_naming_its_slice(monkeypatch):
    x, y = _batch()
    g = (tnn.NeuralNetConfiguration.Builder().seed(1)
         .updater(tup.RmsProp(1e-2)).graphBuilder().addInputs("input")
         .setInputTypes(tnn.InputType.feedForward(4))
         .addLayer("out", tnn.OutputLayer(nOut=2), "input")
         .setOutputs("out"))
    net = tnn.ComputationGraph(g.build()).init("cpu")
    xs, ys = x[:4, 0, 0], y[:4, :2]
    with pytest.raises(NotImplementedError, match="RmsProp.*ROADMAP A10"):
        net.fit(xs, ys)
    with pytest.raises(NotImplementedError, match="schedule"):
        tup.build_optimizer(tup.Sgd(lambda step: 0.1))
    with pytest.raises(NotImplementedError, match="evaluate"):
        net.evaluate([])
    with pytest.raises(NotImplementedError, match="feature masks"):
        net.fit(DataSet(xs, ys, featuresMask=np.ones((4, 1))))
    with pytest.raises(ValueError, match="GradientNormalization"):
        tup.build_optimizer(tup.Sgd(0.1), "clipEverything")
    with pytest.raises(ValueError, match="no updater"):
        tup.build_optimizer(None)
    acc = (tnn.NeuralNetConfiguration.Builder().seed(1)
           .updater(tup.Sgd(0.1)).gradientAccumulation(2).graphBuilder()
           .addInputs("input").setInputTypes(tnn.InputType.feedForward(4))
           .addLayer("out", tnn.OutputLayer(nOut=2), "input")
           .setOutputs("out").build())
    with pytest.raises(NotImplementedError, match="gradientAccumulation"):
        tnn.ComputationGraph(acc).init("cpu").fit(xs, ys)
