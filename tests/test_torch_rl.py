"""The port's rl/ (`deeplearning4j_tpu_torch/rl/`) against the JAX
package's, on the CPU, at small sizes (nets 2×16, one 8-filter conv on
12×12 frames with history 2).

- Host work equal bit for bit: the seeded environments' trajectories,
  ExpReplay's batches, the HistoryProcessor (RGB uint8, float, crop,
  rescale, the ring), EpsGreedy's action stream, and `split(key, 3)`.
- A fresh A3C learner (dense and conv) starts within INIT_TOL of the
  JAX one: both draw through threefry from `PRNGKey(seed)`.
- With weights carried by `rl.params_from_numpy`: the Q-networks' outputs
  and one `td_learn_batch` within STEP_TOL (Adam's bias corrections differ
  by a few ulp), one A3C, A3C-conv and n-step-Q `update` within STEP_TOL
  (conv: CONV_STEP_TOL), RMSprop's ν included.
- A short `train()` of every learner: equal rewards and parameters within
  TRAIN_TOL; each prints the smallest margin of the choices it made (the
  greedy argmax gap, or the distance of a sampled uniform from the CDF
  step it fell between).
"""
import copy

import jax
import numpy as np
import pytest

import deeplearning4j_tpu.rl as J
import deeplearning4j_tpu_torch.rl as T
from deeplearning4j_tpu.rl import conv as jconv
from deeplearning4j_tpu.rl import dqn as jdqn
from deeplearning4j_tpu_torch.ops.random import seed_key, split
from deeplearning4j_tpu_torch.rl import a3c as ta3c
from deeplearning4j_tpu_torch.rl import conv as tconv
from deeplearning4j_tpu_torch.rl import dqn as tdqn

#: a fresh learner's parameters against the JAX one's (threefry normal:
#: XLA's erfinv polynomial, `log1p` an ulp apart)
INIT_TOL = 1e-6
#: one TD update or one A3C update from the same weights
STEP_TOL = 1e-6
#: the same through the conv torso (its f32 sums over 72 taps per output
#: add in other orders in XLA and in torch)
CONV_STEP_TOL = 1e-5
#: parameters after a short train()
TRAIN_TOL = 1e-5

HP_SMALL = dict(historyLength=2, rescaledWidth=12, rescaledHeight=12,
                skipFrame=1)
CONV_SMALL = dict(learningRate=1e-3, filters=(8,), kernels=((3, 3),),
                  strides=((2, 2),), denseUnits=16)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _maxdiff(a, b):
    la = jax.tree_util.tree_leaves(a)
    lb = jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    return max(float(np.abs(np.asarray(x, np.float64)
                            - np.asarray(y, np.float64)).max())
               for x, y in zip(la, lb))


# -- host work, bit for bit ----------------------------------------------------
@pytest.mark.parametrize("env", ["cartpole", "simpletoy", "pixelgrid"])
def test_environment_trajectories_are_bit_identical(env):
    make = {"cartpole": lambda m: m.CartpoleNative(seed=3),
            "simpletoy": lambda m: m.SimpleToy(length=5),
            "pixelgrid": lambda m: m.PixelGridWorld(size=6, scale=3,
                                                    maxSteps=25, seed=1)}[env]
    ej, et = make(J), make(T)
    rng = np.random.default_rng(11)
    for _episode in range(3):
        np.testing.assert_array_equal(ej.reset(), et.reset())
        while not ej.isDone():
            a = int(rng.integers(2))
            oj, rj, dj, _ = ej.step(a)
            ot, rt, dt, _ = et.step(a)
            assert oj.dtype == ot.dtype
            np.testing.assert_array_equal(oj, ot)
            assert (rj, dj) == (rt, dt)
        assert et.isDone()


def test_exp_replay_batches_are_bit_identical():
    """The ring overwrites in the same slots and the uniform draws pick the
    same transitions, batch after batch (sizes vary)."""
    rj, rt = J.ExpReplay(7, 4, seed=5), T.ExpReplay(7, 4, seed=5)
    rng = np.random.default_rng(0)
    for i in range(12):
        obs, nxt = rng.standard_normal((2, 3)).astype(np.float32)
        tr = (obs, int(rng.integers(2)), float(rng.random()), nxt,
              i % 4 == 0)
        rj.store(J.Transition(*tr))
        rt.store(T.Transition(*tr))
        if i >= 3:
            size = 3 if i % 2 else None
            for bj, bt in zip(rj.getBatch(size), rt.getBatch(size)):
                assert bj.dtype == bt.dtype
                np.testing.assert_array_equal(bj, bt)
    assert len(rj) == len(rt) == 7


@pytest.mark.parametrize("case", ["rgb_uint8", "float", "crop_rescale",
                                  "ring"])
def test_history_processor_is_bit_identical(case):
    rng = np.random.default_rng(2)
    conf = {"rgb_uint8": dict(historyLength=3, rescaledWidth=7,
                              rescaledHeight=9),
            "float": dict(historyLength=2, rescaledWidth=16,
                          rescaledHeight=20),
            "crop_rescale": dict(historyLength=2, rescaledWidth=5,
                                 rescaledHeight=6, croppingWidth=11,
                                 croppingHeight=13, offsetX=3, offsetY=4),
            "ring": dict(historyLength=4, rescaledWidth=8,
                         rescaledHeight=8)}[case]
    hj = J.HistoryProcessor(J.HistoryProcessorConfiguration(**conf))
    ht = T.HistoryProcessor(T.HistoryProcessorConfiguration(**conf))
    for i in range(6):
        if case == "rgb_uint8":
            frame = rng.integers(0, 256, (20, 16, 3)).astype(np.uint8)
        elif case == "crop_rescale" and i % 2:
            frame = rng.integers(0, 8, (20, 16)).astype(np.uint8)
        else:
            frame = rng.random((20, 16)).astype(np.float32)
        fj, ft = hj.preProcess(frame), ht.preProcess(frame)
        assert fj.dtype == ft.dtype == np.float32
        np.testing.assert_array_equal(fj, ft)
        hj.record(frame)
        ht.record(frame)
        np.testing.assert_array_equal(hj.getHistory(), ht.getHistory())
    ht.reset()
    with pytest.raises(RuntimeError, match="record"):
        ht.getHistory()


def test_eps_greedy_action_stream_is_bit_identical():
    conf = dict(minEpsilon=0.05, epsilonNbStep=40)
    pj = J.EpsGreedy(J.QLearningConfiguration(**conf),
                     np.random.default_rng(9))
    pt = T.EpsGreedy(T.QLearningConfiguration(**conf),
                     np.random.default_rng(9))
    q_rng = np.random.default_rng(1)
    space_j, space_t = J.DiscreteSpace(3), T.DiscreteSpace(3)
    aj, at = [], []
    for _ in range(80):
        q = q_rng.standard_normal(3).astype(np.float32)
        aj.append(pj.nextAction(q, space_j))
        at.append(pt.nextAction(q, space_t))
        assert pj.epsilon() == pt.epsilon()
    assert aj == at
    assert len(set(at)) == 3


def test_split_into_three_is_bit_identical():
    for seed in (0, 5, 123, 2 ** 31 - 1):
        want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), 3))
        got = split(seed_key(seed), 3).numpy().astype(np.uint32)
        np.testing.assert_array_equal(got, want)
        k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
        t1, t2 = split(seed_key(seed))
        np.testing.assert_array_equal(t1.numpy().astype(np.uint32), k1)
        np.testing.assert_array_equal(t2.numpy().astype(np.uint32), k2)


# -- learners: a fresh start, the carrier, one update --------------------------
def _a3c_conf(m, **kw):
    base = dict(seed=4, numEnvs=4, nstep=4, gamma=0.9, learningRate=5e-3,
                hiddenNodes=16, numLayers=2)
    base.update(kw)
    return m.A3CConfiguration(**base)


def _make_a3c(m, kind, **kw):
    dev = {} if m is J else {"device": "cpu"}
    if kind == "dense":
        return m.A3CDiscreteDense(lambda: m.SimpleToy(length=4),
                                  _a3c_conf(m, **kw), **dev)
    if kind == "nstep":
        return m.AsyncNStepQLearningDiscreteDense(
            lambda: m.SimpleToy(length=4), _a3c_conf(m, **kw),
            epsilonNbStep=100, **dev)
    return m.A3CDiscreteConv(
        lambda: m.PixelGridWorld(size=6, scale=2, maxSteps=20),
        _a3c_conf(m, numEnvs=2, **kw),
        m.HistoryProcessorConfiguration(**HP_SMALL),
        m.DQNConvNetworkConfiguration(**CONV_SMALL), **dev)


@pytest.mark.parametrize("kind", ["dense", "conv"])
def test_fresh_a3c_learner_starts_at_the_jax_parameters(kind):
    lj, lt = _make_a3c(J, kind), _make_a3c(T, kind)
    pt, nu = T.params_to_numpy(lt)
    assert _maxdiff(_np(lj.params), pt) <= INIT_TOL
    assert _maxdiff(_np(lj.opt_state[0].nu), nu) == 0.0
    assert lt.device.type == "cpu"


def _carry_a3c(lj, lt, nu_scale=0.0):
    """The JAX learner's weights onto the port's, with a positive ν drawn
    from a seed (so the update reads it) given to both."""
    rng = np.random.default_rng(3)
    nu = jax.tree_util.tree_map(
        lambda a: (nu_scale * rng.random(np.shape(a))).astype(np.float32),
        _np(lj.params))
    lj.opt_state = (lj.opt_state[0]._replace(
        nu=jax.tree_util.tree_map(jax.numpy.asarray, nu)),) \
        + tuple(lj.opt_state[1:])
    T.params_from_numpy(lt, _np(lj.params), nu=nu)
    return nu


def _rollout(lj, n, seed):
    rng = np.random.default_rng(seed)
    shape = lj.envs[0].getObservationSpace().shape
    obs = rng.random((n,) + tuple(shape)).astype(np.float32)
    actions = rng.integers(lj.num_actions, size=n).astype(np.int32)
    returns = rng.standard_normal(n).astype(np.float32)
    return obs, actions, returns


@pytest.mark.parametrize("kind", ["dense", "nstep", "conv"])
def test_one_update_matches_the_jax_learner(kind):
    lj, lt = _make_a3c(J, kind), _make_a3c(T, kind)
    _carry_a3c(lj, lt, nu_scale=1e-3)
    n = lj.conf.numEnvs * lj.conf.nstep
    obs, actions, returns = _rollout(lj, n, seed=7)
    pj, sj = lj._update(lj.params, lj.opt_state, jax.numpy.asarray(obs),
                        jax.numpy.asarray(actions),
                        jax.numpy.asarray(returns))
    v_before = copy.deepcopy(T.params_to_numpy(lt)[0]["v"])
    lt.params, lt.opt_state = lt._update(lt.params, lt.opt_state, obs,
                                         actions, returns)
    got, nu = T.params_to_numpy(lt)
    tol = CONV_STEP_TOL if kind == "conv" else STEP_TOL
    assert _maxdiff(_np(pj), got) <= tol
    assert _maxdiff(_np(sj[0].nu), nu) <= tol * 1e-2
    moved = _maxdiff(_np(lj.params), got)
    assert moved > 100 * tol          # the update did move the weights
    if kind == "nstep":
        # the Q learner never trains the value head
        assert _maxdiff(v_before, got["v"]) == 0.0
        assert _maxdiff(_np(sj[0].nu["v"]), nu["v"]) <= tol * 1e-2


def _fill(replay_pair, shape, n, seed):
    rng = np.random.default_rng(seed)
    for i in range(n):
        obs = rng.random(shape).astype(np.float32)
        nxt = rng.random(shape).astype(np.float32)
        tr = (obs, int(rng.integers(2)), float(rng.standard_normal()), nxt,
              bool(i % 7 == 6))
        for rp, m in replay_pair:
            rp.store(m.Transition(*tr))


def _make_dqn(m, kind, **kw):
    dev = {} if m is J else {"device": "cpu"}
    conf = dict(seed=6, maxStep=120, maxEpochStep=20, batchSize=8,
                targetDqnUpdateFreq=25, updateStart=16, gamma=0.9,
                minEpsilon=0.05, epsilonNbStep=80, expRepMaxSize=500)
    conf.update(kw)
    if kind == "dense":
        return m.QLearningDiscreteDense(
            m.SimpleToy(length=4),
            m.DQNDenseNetworkConfiguration(numLayers=2, numHiddenNodes=16,
                                           learningRate=5e-3),
            m.QLearningConfiguration(**conf), **dev)
    return m.QLearningDiscreteConv(
        m.PixelGridWorld(size=6, scale=2, maxSteps=20),
        m.DQNConvNetworkConfiguration(**CONV_SMALL),
        m.HistoryProcessorConfiguration(**HP_SMALL),
        m.QLearningConfiguration(**conf), **dev)


def _dqn_tree(lj):
    return {name: (_np(getattr(lj, name)._params),
                   _np(getattr(lj, name)._state))
            for name in ("net", "target")}


@pytest.mark.parametrize("kind", ["dense", "conv"])
def test_q_network_and_one_td_update_match_the_jax_learner(kind):
    lj, lt = _make_dqn(J, kind), _make_dqn(T, kind)
    T.params_from_numpy(lt, _dqn_tree(lj))
    assert lt.target._params["0"]["W"] is not lt.net._params["0"]["W"]
    shape = ((4,) if kind == "dense" else (12, 12, 2))
    _fill([(lj.replay, J), (lt.replay, T)], shape, 40, seed=8)
    x = np.random.default_rng(4).random((5,) + shape).astype(np.float32)
    qj, qt = np.asarray(lj.net.output(x)), np.asarray(lt.net.output(x))
    assert np.abs(qj - qt).max() <= STEP_TOL
    jdqn.td_learn_batch(lj.net, lj.target, lj.replay, lj.conf)
    tdqn.td_learn_batch(lt.net, lt.target, lt.replay, lt.conf)
    got = T.params_to_numpy(lt)
    tol = CONV_STEP_TOL if kind == "conv" else STEP_TOL
    assert _maxdiff(_np(lj.net._params), got["net"][0]) <= tol
    assert _maxdiff(_np(lj.net._params), got["target"][0]) > 100 * tol


# -- short train() runs ---------------------------------------------------------
class _GapRecorder:
    """Wraps a numpy Generator: every `choice(n, p=)` records how far its
    uniform fell from the nearest CDF step (numpy draws one double and
    searches the normalised cumulative sum)."""

    def __init__(self, rng):
        self.rng, self.gap = rng, np.inf

    def choice(self, n, p):
        u = np.random.Generator(copy.deepcopy(self.rng.bit_generator))\
            .random()
        cdf = np.cumsum(np.asarray(p, np.float64))
        cdf /= cdf[-1]
        self.gap = min(self.gap, float(np.abs(cdf[:-1] - u).min()))
        return self.rng.choice(n, p=p)

    def __getattr__(self, name):
        return getattr(self.rng, name)


def _greedy_gaps(learner):
    """Wrap the port learner's policy forward to record the gap between
    its best and second-best Q-value at every step."""
    gaps = []
    inner = learner._greedy_q

    def recorded(obs):
        vals = inner(obs)
        s = np.sort(vals)
        gaps.append(float(s[-1] - s[-2]))
        return vals

    learner._greedy_q = recorded
    return gaps


@pytest.mark.parametrize("kind", ["dense", "conv"])
def test_short_dqn_training_matches_the_jax_learner(kind):
    kw = {} if kind == "dense" else dict(maxStep=60, updateStart=12)
    lj, lt = _make_dqn(J, kind, **kw), _make_dqn(T, kind, **kw)
    T.params_from_numpy(lt, _dqn_tree(lj))
    gaps = _greedy_gaps(lt)
    rj, rt = lj.train(), lt.train()
    print(f"{kind} DQN: smallest greedy gap {min(gaps):.3e} over "
          f"{len(gaps)} steps")
    assert rj == pytest.approx(rt, abs=1e-12)
    assert lt.step_count == lj.step_count
    assert lt.target_syncs == lj.conf.maxStep // lj.conf.targetDqnUpdateFreq
    assert lt.host_reads == lt.step_count + 3 * lt.updates
    got = T.params_to_numpy(lt)
    assert _maxdiff(_np(lj.net._params), got["net"][0]) <= TRAIN_TOL
    assert _maxdiff(_np(lj.target._params), got["target"][0]) <= TRAIN_TOL


@pytest.mark.parametrize("kind", ["dense", "nstep", "conv"])
def test_short_a3c_training_matches_the_jax_learner(kind):
    kw = dict(maxStep=160) if kind != "conv" else dict(maxStep=40)
    lj, lt = _make_a3c(J, kind, **kw), _make_a3c(T, kind, **kw)
    T.params_from_numpy(lt, _np(lj.params))
    rec = lt._rng = _GapRecorder(lt._rng)
    rj, rt = lj.train(), lt.train()
    if kind != "nstep":
        print(f"{kind} A3C: smallest CDF gap {rec.gap:.3e}")
    assert [float(r) for r in rj] == pytest.approx(
        [float(r) for r in rt], abs=1e-12)
    assert len(rt) > 0 or kind == "conv"
    assert lt.updates == lt.step_count // (lt.conf.numEnvs * lt.conf.nstep)
    got, _ = T.params_to_numpy(lt)
    assert _maxdiff(_np(lj.params), got) <= TRAIN_TOL


# -- the carrier ---------------------------------------------------------------
def test_carrier_rejects_wrong_groups_keys_and_shapes():
    lj, lt = _make_a3c(J, "dense"), _make_a3c(T, "dense")
    good = _np(lj.params)
    bad = copy.deepcopy(good)
    bad.pop("v")
    with pytest.raises(ValueError, match="groups"):
        T.params_from_numpy(lt, bad)
    bad = copy.deepcopy(good)
    bad["body"] = bad["body"][:1]
    with pytest.raises(ValueError, match="layers"):
        T.params_from_numpy(lt, bad)
    bad = copy.deepcopy(good)
    bad["pi"][0]["W"] = bad["pi"][0].pop("w")
    with pytest.raises(ValueError, match="keys"):
        T.params_from_numpy(lt, bad)
    bad = copy.deepcopy(good)
    bad["body"][1]["w"] = bad["body"][1]["w"][:, :3]
    with pytest.raises(ValueError, match="shape"):
        T.params_from_numpy(lt, bad)
    with pytest.raises(ValueError, match="shape"):
        T.params_from_numpy(lt, good, nu=_np(jax.tree_util.tree_map(
            lambda a: a[..., :1], lj.params)))
    dj, dt = _make_dqn(J, "dense"), _make_dqn(T, "dense")
    tree = _dqn_tree(dj)
    with pytest.raises(ValueError, match="net"):
        T.params_from_numpy(dt, {"net": tree["net"]})
    p, s = tree["target"]
    p = copy.deepcopy(p)
    p["0"]["W"] = p["0"]["W"][:2]
    with pytest.raises(ValueError, match="shape"):
        T.params_from_numpy(dt, {"net": tree["net"], "target": (p, s)})


def test_pixel_adapter_imports_conv_lazily_and_shapes_the_history():
    # conv imports dqn and a3c imports conv: the adapter imports it at the
    # call, so the module holds no name of conv's
    assert "deeplearning4j_tpu_torch.rl.conv" in \
        ta3c._PixelEnvAdapter.__init__.__code__.co_names
    assert not hasattr(ta3c, "HistoryProcessor")
    env = ta3c._PixelEnvAdapter(T.PixelGridWorld(size=6, scale=2),
                                T.HistoryProcessorConfiguration(**HP_SMALL))
    assert env.reset().shape == (12, 12, 2)
    assert env.getObservationSpace().shape == (12, 12, 2)
    assert tconv._nearest_resize is not jconv._nearest_resize
