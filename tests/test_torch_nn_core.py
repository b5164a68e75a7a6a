"""The port's nn core training surface against the JAX package on the CPU,
one case per item: the updaters against the JAX package's optax chains,
every loss of the JAX table (value and gradient), the schedules, the
constraints, gradient accumulation and the dropout objects.

Tolerances: the updaters 1e-6 × max(1, max |JAX|) per leaf over 5 steps
(elementwise f32 math in optax's order); losses and schedules 1e-5 / 1e-6
relative (the same f32 formulas; exp, log and pow may differ by an ulp);
constraints 1e-6; accumulated steps equal the port's sequential loop bit
for bit and the JAX package's `accum_scan` step to 1e-5; dropout by its
statistics over 2^16 draws (5 sigma of the estimate) and exactly at eval.
"""
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu_torch.nn as tnn
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn import constraints as jcons
from deeplearning4j_tpu.nn import losses as jloss
from deeplearning4j_tpu.nn import schedules as jsch
from deeplearning4j_tpu.nn import updaters as jup
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn import accum as taccum
from deeplearning4j_tpu_torch.nn import constraints as tcons
from deeplearning4j_tpu_torch.nn import losses as tloss
from deeplearning4j_tpu_torch.nn import schedules as tsch
from deeplearning4j_tpu_torch.nn import updaters as tup

PKGS = {"jax": jnn, "torch": tnn}


def _close(got, want, rel, what=""):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = rel * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, (what, err, tol)


def _tmap(fn, tree):
    return {n: {k: fn(v) for k, v in d.items()} for n, d in tree.items()}


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"0": {"W": rng.standard_normal((3, 4)).astype(np.float32),
                  "b": rng.standard_normal(4).astype(np.float32)},
            "1": {"W": rng.standard_normal((5, 2)).astype(np.float32)}}


# -- updaters -------------------------------------------------------------------
UPDATERS = {
    "AdaMax": ("AdaMax", dict(learningRate=1e-2)),
    "Nadam": ("Nadam", dict(learningRate=1e-2)),
    "AMSGrad": ("AMSGrad", dict(learningRate=1e-2)),
    "RmsProp": ("RmsProp", dict(learningRate=1e-2)),
    "AdaGrad": ("AdaGrad", dict(learningRate=1e-1)),
    "AdaDelta": ("AdaDelta", dict()),
    "NoOp": ("NoOp", dict()),
    "Sgd with StepSchedule": ("Sgd", dict(learningRate=("StepSchedule",
                                                        (0.1, 0.5, 2)))),
    "Adam with ExponentialSchedule": (
        "Adam", dict(learningRate=("ExponentialSchedule", (1e-2, 0.9)))),
}


def _updater(mod, sched_mod, name, kw):
    kw = dict(kw)
    lr = kw.get("learningRate")
    if isinstance(lr, tuple):
        kw["learningRate"] = getattr(sched_mod, lr[0])(*lr[1])
    return getattr(mod, name)(**kw)


@pytest.mark.parametrize("case", sorted(UPDATERS))
def test_updater_matches_the_jax_optax_chain(case):
    """Five updates of the port's optimizer against the JAX package's optax
    chain on the same parameters and gradients."""
    name, kw = UPDATERS[case]
    jtx = jup.build_optimizer(_updater(jup, jsch, name, kw))
    ttx = tup.build_optimizer(_updater(tup, tsch, name, kw))
    params = _tree(0)
    jp, tp = _tmap(jnp.asarray, params), _tmap(torch.from_numpy, params)
    js, ts = jtx.init(jp), ttx.init(tp)
    for step in range(5):
        grads = _tmap(lambda v: v * 3.0, _tree(10 + step))
        ju, js = jtx.update(_tmap(jnp.asarray, grads), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = ttx.update(_tmap(torch.from_numpy, grads), ts, tp)
        tp = tup.apply_updates(tp, tu)
        for n in jp:
            for k in jp[n]:
                _close(tp[n][k], jp[n][k], 1e-6, f"step {step} {n}/{k}")


# -- losses -----------------------------------------------------------------------
def _loss_inputs(name, seed=3, b=6, f=4):
    rng = np.random.default_rng(seed)
    if name in ("fmeasure", "LossFMeasure"):
        f = 2
    if name == "LossMixtureDensity":
        f = 3 * (2 + 2)
    preact = rng.standard_normal((b, f)).astype(np.float32)
    if name in ("mcxent", "negativeloglikelihood", "kl_divergence",
                "LossMCXENT", "LossNegativeLogLikelihood", "fmeasure",
                "LossFMeasure"):
        labels = np.eye(f, dtype=np.float32)[rng.integers(0, f, b)]
    elif name in ("xent", "reconstruction_crossentropy", "hinge",
                  "squared_hinge", "multilabel", "LossMultiLabel",
                  "LossBinaryXENT"):
        labels = (rng.random((b, f)) < 0.5).astype(np.float32)
    elif name == "LossMixtureDensity":
        labels = rng.standard_normal((b, 2)).astype(np.float32)
    elif name in ("poisson",):
        labels = rng.integers(0, 4, (b, f)).astype(np.float32)
        preact = np.abs(preact) + 0.1
    else:
        labels = rng.standard_normal((b, f)).astype(np.float32)
    mask = (rng.random(b) < 0.7).astype(np.float32)
    mask[0] = 1.0
    return labels, preact, mask


LOSS_OBJECTS = {
    "LossWasserstein": lambda m: m.LossWasserstein(),
    "LossMultiLabel": lambda m: m.LossMultiLabel(),
    "LossFMeasure": lambda m: m.LossFMeasure(beta=2.0),
    "LossMixtureDensity": lambda m: m.LossMixtureDensity(3, 2),
    "LossMCXENT": lambda m: m.LossMCXENT(weights=[1.0, 2.0, 0.5, 1.5],
                                         labelSmoothing=0.1),
    "LossNegativeLogLikelihood": lambda m: m.LossNegativeLogLikelihood(),
    "LossBinaryXENT": lambda m: m.LossBinaryXENT(
        weights=[1.0, 2.0, 0.5, 1.5], labelSmoothing=0.2),
    "LossMSE": lambda m: m.LossMSE(weights=[1.0, 2.0, 0.5, 1.5]),
}


@pytest.mark.parametrize("name", sorted(jloss.LOSSES) + sorted(LOSS_OBJECTS))
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_loss_matches_the_jax_function(name, masked):
    """The loss value and its gradient in the pre-activation, with the
    loss's default activation, against the JAX package's."""
    labels, preact, mask = _loss_inputs(name)
    if name in LOSS_OBJECTS:
        jfn, tfn = LOSS_OBJECTS[name](jloss), LOSS_OBJECTS[name](tloss)
    else:
        jfn, tfn = jloss.LOSSES[name], tloss.get_loss(name)
    m = mask if masked else None
    jval, jgrad = jax.value_and_grad(
        lambda p: jfn(jnp.asarray(labels), p,
                      mask=None if m is None else jnp.asarray(m)))(
        jnp.asarray(preact))
    tp = torch.from_numpy(preact).requires_grad_()
    tval = tfn(torch.from_numpy(labels), tp,
               mask=None if m is None else torch.from_numpy(m))
    (tgrad,) = torch.autograd.grad(tval, tp)
    _close(tval, jval, 1e-5, f"{name} value")
    _close(tgrad, jgrad, 1e-5, f"{name} gradient")


def test_every_loss_name_resolves_and_an_unknown_one_raises():
    assert set(tloss.LOSSES) == set(jloss.LOSSES)
    for name in jloss.LOSSES:
        assert callable(tloss.get_loss(name.upper()))
    with pytest.raises(ValueError, match="Unknown loss"):
        tloss.get_loss("nope")


# -- schedules --------------------------------------------------------------------
SCHEDULES = {
    "Fixed": ("FixedSchedule", (0.05,)),
    "Step": ("StepSchedule", (0.1, 0.5, 3)),
    "Exponential": ("ExponentialSchedule", (0.1, 0.97)),
    "Inverse": ("InverseSchedule", (0.1, 0.2, 0.75)),
    "Poly": ("PolySchedule", (0.1, 2.0, 20)),
    "Sigmoid": ("SigmoidSchedule", (0.1, 0.5, 10)),
    "Map": ("MapSchedule", ({0: 0.1, 4: 0.05, 11: 0.01},)),
    "Cycle": ("CycleSchedule", (0.01, 0.1, 20, 6)),
    "callable": (None, None),
}


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_schedule_matches_the_jax_package(case):
    """Iterations 0..29 (past every boundary) as the optimizer's int32
    count, and the host-side `value`."""
    name, args = SCHEDULES[case]
    if name is None:
        fn = lambda step: 0.1 / (1.0 + step)          # noqa: E731
        jfn, tfn = jsch.as_schedule(fn), tsch.as_schedule(fn)
    else:
        jfn, tfn = getattr(jsch, name)(*args), getattr(tsch, name)(*args)
    steps = np.arange(30, dtype=np.int32)
    want = np.asarray(jax.vmap(jfn)(jnp.asarray(steps)), np.float32)
    got = tfn(torch.from_numpy(steps))
    _close(got.to(torch.float32), want, 1e-6, case)
    if name is not None:
        assert got.dtype == torch.float32
        for s in (0, 7, 29):
            assert abs(tfn.value(s) - float(want[s])) <= 1e-6 * max(
                1.0, abs(float(want[s])))


def test_a_schedule_advances_with_the_optimizer_count():
    """The optimizer's count tensor drives the rate: a StepSchedule halves
    the step after its boundary, inside one optimizer."""
    tx = tup.build_optimizer(tup.Sgd(tsch.StepSchedule(0.1, 0.5, 2)))
    p = {"0": {"W": torch.zeros(3)}}
    st = tx.init(p)
    steps = []
    for _ in range(4):
        u, st = tx.update({"0": {"W": torch.ones(3)}}, st, p)
        steps.append(float(u["0"]["W"][0]))
    assert steps == [pytest.approx(-0.1), pytest.approx(-0.1),
                     pytest.approx(-0.05), pytest.approx(-0.05)]


# -- constraints -------------------------------------------------------------------
CONSTRAINTS = {
    "MaxNorm": lambda m: m.MaxNormConstraint(1.5),
    "MinMaxNorm": lambda m: m.MinMaxNormConstraint(0.8, 1.2, rate=0.7),
    "UnitNorm": lambda m: m.UnitNormConstraint(),
    "NonNegative": lambda m: m.NonNegativeConstraint(),
}


@pytest.mark.parametrize("case", sorted(CONSTRAINTS))
def test_constraint_matches_the_jax_package(case):
    """On a dense and a conv weight (norms per output unit) and through
    apply_layer_constraints (weights only; the bias untouched)."""
    rng = np.random.default_rng(7)
    jc, tc = CONSTRAINTS[case](jcons), CONSTRAINTS[case](tcons)
    for shape in ((6, 5), (3, 3, 4, 5)):
        w = (2.0 * rng.standard_normal(shape)).astype(np.float32)
        _close(tc.apply(torch.from_numpy(w)), jc.apply(jnp.asarray(w)),
               1e-6, f"{case} {shape}")
    layer = type("L", (), {"constraints": [tc]})()
    p = {"0": {"W": torch.from_numpy(w), "b": torch.full((5,), -3.0)}}
    out = tcons.apply_layer_constraints([("0", layer)], p)
    assert torch.equal(out["0"]["b"], p["0"]["b"])
    _close(out["0"]["W"], jc.apply(jnp.asarray(w)), 1e-6, case)


def _dense_conf(pkg, updater=None, constraints=None, accum=1, bn=False,
                dropout=None):
    nn = PKGS[pkg]
    b = (nn.NeuralNetConfiguration.Builder().seed(11)
         .updater(updater or nn.Nesterovs(0.1, 0.9)).activation("tanh"))
    if accum > 1:
        b = b.gradientAccumulation(accum)
    lb = b.list().layer(nn.DenseLayer(nOut=6, constraints=constraints,
                                      dropOut=dropout))
    if bn:
        lb = lb.layer(nn.BatchNormalization())
    return (lb.layer(nn.OutputLayer(lossFunction="mcxent", nOut=3,
                                    activation="softmax"))
            .setInputType(nn.InputType.feedForward(5)).build())


def _batches(n, b=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n * b, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n * b)]
    return [(x[i:i + b], y[i:i + b]) for i in range(0, n * b, b)]


def _pair(conf_kw):
    jnet = jnn.MultiLayerNetwork(_dense_conf("jax", **conf_kw(jnn))).init()
    params = jax.tree_util.tree_map(np.asarray, jnet._params)
    state = jax.tree_util.tree_map(np.asarray, jnet._state)
    tnet = tnn.multilayer_params_from_numpy(
        tnn.MultiLayerNetwork(_dense_conf("torch", **conf_kw(tnn))), params,
        state, device="cpu")
    return jnet, tnet


def _same_params(jnet, tnet, rel, what):
    for n in jnet._params:
        for k in jnet._params[n]:
            _close(tnet._params[n][k], np.asarray(jnet._params[n][k]), rel,
                   f"{what} {n}/{k}")


def test_a_constrained_layer_trains_as_in_the_jax_package():
    """MaxNorm on the hidden layer applied after each update, inside the
    step: 3 steps against the JAX fit, and the norms hold."""
    jnet, tnet = _pair(lambda m: dict(
        constraints=[m.MaxNormConstraint(0.5)]))
    for x, y in _batches(3):
        jnet.fit(JDataSet(x, y))
        tnet.fit(DataSet(x, y))
        norms = torch.linalg.vector_norm(tnet._params["0"]["W"], dim=0)
        assert float(norms.max()) <= 0.5 + 1e-6
    _same_params(jnet, tnet, 1e-5, "constrained")


# -- gradient accumulation -----------------------------------------------------------
def test_accumulation_equals_the_sequential_loop():
    """`gradientAccumulation(4)` against the explicit loop: the BN state
    threads through the microbatches, the gradients and the loss are
    summed in order and divided by 4, and one update follows."""
    data = _batches(4)
    conf = _dense_conf("torch", accum=4, bn=True)
    net = tnn.MultiLayerNetwork(conf).init("cpu")
    ref = net.clone()
    net.fit([DataSet(x, y) for x, y in data])
    assert net.getIterationCount() == 1
    ref._build_optimizer()
    state, gsum, lsum = ref._state, None, None
    for x, y in data:
        ins, labels, lm = ref._unpack(DataSet(x, y))
        loss, grads, state = ref._value_and_grad(ins, labels, lm,
                                                 state=state)
        gsum = grads if gsum is None else _tmap2(torch.add, gsum, grads)
        lsum = loss if lsum is None else lsum + loss
    ref._update_in_place(_tmap(lambda g: g * 0.25, gsum), state)
    for n in ref._params:
        for k in ref._params[n]:
            assert torch.equal(net._params[n][k], ref._params[n][k]), (n, k)
    for n in ref._state:
        for k in ref._state[n]:
            assert torch.equal(net._state[n][k], ref._state[n][k]), (n, k)
    assert net.score() == float(lsum * 0.25)


def _tmap2(fn, a, b):
    return {n: {k: fn(v, b[n][k]) for k, v in d.items()} for n, d in a.items()}


@pytest.mark.parametrize("network", ["MultiLayerNetwork",
                                     "ComputationGraph"])
def test_accumulation_matches_the_jax_accum_scan(network):
    """Two accumulated updates of 4 microbatches (with BN) and a 1-batch
    tail against the JAX package's fit, whose accumulated step runs
    `nn/accum.accum_scan`."""
    data = _batches(9, seed=4)
    if network == "MultiLayerNetwork":
        jnet, tnet = _pair(lambda m: dict(accum=4, bn=True))
    else:
        def conf(nn):
            return (nn.NeuralNetConfiguration.Builder().seed(11)
                    .updater(nn.Nesterovs(0.1, 0.9)).activation("tanh")
                    .gradientAccumulation(4).graphBuilder().addInputs("in")
                    .setInputTypes(nn.InputType.feedForward(5))
                    .addLayer("h", nn.DenseLayer(nOut=6), "in")
                    .addLayer("bn", nn.BatchNormalization(), "h")
                    .addLayer("out", nn.OutputLayer(nOut=3), "bn")
                    .setOutputs("out").build())
        jnet = JGraph(conf(jnn)).init()
        tnet = tnn.graph_params_from_numpy(
            tnn.ComputationGraph(conf(tnn)),
            jax.tree_util.tree_map(np.asarray, jnet._params),
            jax.tree_util.tree_map(np.asarray, jnet._state), device="cpu")
    jnet.fit([JDataSet(x, y) for x, y in data])
    tnet.fit([DataSet(x, y) for x, y in data])
    assert tnet.getIterationCount() == jnet.getIterationCount() == 3
    _same_params(jnet, tnet, 1e-5, "accumulated")
    for n in jnet._state:
        for k in jnet._state[n]:
            _close(tnet._state[n][k], np.asarray(jnet._state[n][k]), 1e-5,
                   f"state {n}/{k}")
    _close(tnet.score(), float(jnet.score()), 1e-5, "score")


def test_accumulate_sums_in_microbatch_order():
    grads = [{"a": {"W": torch.tensor([1.0, 2.0])}},
             {"a": {"W": torch.tensor([3.0, -1.0])}}]
    out, loss, state = taccum.accumulate(
        lambda s, i: (torch.tensor(float(i + 1)), grads[i], s + [i]), [],
        [0, 1])
    assert torch.equal(out["a"]["W"], torch.tensor([2.0, 0.5]))
    assert float(loss) == 1.5 and state == [0, 1]


# -- dropout ---------------------------------------------------------------------
DROPOUTS = {
    "float shorthand": lambda m: 0.7,
    "Dropout": lambda m: m.Dropout(0.7),
    "GaussianDropout": lambda m: m.GaussianDropout(0.2),
    "GaussianNoise": lambda m: m.GaussianNoise(0.3),
    "AlphaDropout": lambda m: m.AlphaDropout(0.8),
    "SpatialDropout": lambda m: m.SpatialDropout(0.6),
}


def _moments(case, p):
    """(mean, var) of the output on x = 1 everywhere."""
    if case in ("float shorthand", "Dropout", "SpatialDropout"):
        return 1.0, (1.0 - p) / p
    if case == "GaussianDropout":
        return 1.0, p / (1.0 - p)
    if case == "GaussianNoise":
        return 1.0, p * p
    return None


@pytest.mark.parametrize("case", sorted(DROPOUTS))
def test_dropout_by_statistics_and_identity_at_eval(case):
    """Train-time draws from the network's generator have the mean and
    variance the JAX package's draws have; the eval forward applies none
    and equals the JAX package's output."""
    jnet, tnet = _pair(lambda m: dict(dropout=DROPOUTS[case](
        m if case != "float shorthand" else None)))
    x = np.random.default_rng(2).standard_normal((4, 5)).astype(np.float32)
    _close(tnet.output(x), np.asarray(jnet.output(x).numpy()), 1e-5,
           "eval output")
    layer = tnet.getLayer(0)
    gen = torch.Generator().manual_seed(0)
    ones = torch.ones(16, 64, 64)
    y = layer._dropout_in(ones, True, gen)
    assert not torch.equal(y, ones)
    assert torch.equal(layer._dropout_in(ones, False, gen), ones)
    jlayer = jnet.getLayer(0)
    jy = np.asarray(jlayer._dropout_in(jnp.ones((16, 64, 64)), True,
                                       jax.random.PRNGKey(0)))
    if case == "SpatialDropout":       # one draw per (example, channel)
        y, jy = y[:, 0, :], jy[:, 0, :]
    n = y.numel()
    for got, want_mean, want_var in ((y.double(), float(jy.mean()),
                                      float(jy.var())),):
        se = 5 * np.sqrt(max(want_var, 1e-12) / n) + 1e-6
        assert abs(float(got.mean()) - want_mean) <= 2 * se, (case, "mean")
        assert abs(float(got.var()) - want_var) <= 0.1 * want_var + 1e-6, \
            (case, "var")
    p = getattr(layer.dropOut, "p", None) or getattr(
        layer.dropOut, "rate", None) or getattr(layer.dropOut, "stddev",
                                                None) or layer.dropOut
    m = _moments(case, float(p))
    if m is not None:
        se = 5 * np.sqrt(m[1] / n)
        assert abs(float(y.double().mean()) - m[0]) <= se, (case, m)
