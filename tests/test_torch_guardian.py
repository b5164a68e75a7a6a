"""The port's training guardian (resilience/guardian + integrity +
watchdog), held to the contracts of the JAX package's
tests/test_guardian.py (all but its sharded-mode test, which waits for
the sharded trainer): 
divergence detection escalates skip → reduced-LR retry → rollback to the
last VERIFIED checkpoint → DivergenceError; manifests make restores
trustworthy (corrupt generation → previous-generation fallback); the
stall watchdog dumps evidence when a step wedges. The headline
regression: NaN injected into the grads at step k → the guardian rolls
back and final params are bit-identical to a run that never saw the
fault window's poisoned steps."""
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import monitoring
from deeplearning4j_tpu_torch.datasets.iterators import ArrayDataSetIterator
from deeplearning4j_tpu_torch.nn import (DenseLayer, InputType,
                                         NeuralNetConfiguration, OutputLayer,
                                         Sgd)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.resilience import (CheckpointIntegrityError,
                                                 DivergenceError, FaultPlan,
                                                 InjectedFault, faults,
                                                 health_snapshot)
from deeplearning4j_tpu_torch.resilience import guardian as guardian_mod
from deeplearning4j_tpu_torch.resilience import integrity
from deeplearning4j_tpu_torch.resilience import watchdog as watchdog_mod
from deeplearning4j_tpu_torch.resilience.guardian import TrainingGuardian
from deeplearning4j_tpu_torch.resilience.trainer import (FaultTolerantTrainer,
                                                         _finite)
from deeplearning4j_tpu_torch.resilience.watchdog import StallWatchdog
from deeplearning4j_tpu_torch.runtime.executables import tensor_leaves


def _net(seed=3):
    conf = (NeuralNetConfiguration.Builder()
            .seed(seed).updater(Sgd(0.1)).activation("tanh")
            .list()
            .layer(DenseLayer.Builder().nOut(8).build())
            .layer(OutputLayer.Builder("mcxent").nOut(3)
                   .activation("softmax").build())
            .setInputType(InputType.feedForward(5))
            .build())
    return MultiLayerNetwork(conf).init(device="cpu")


def _data(n=120, nan_from=None):
    # X and Y draw from independent streams so _data(k) is an exact
    # prefix of _data(n>k) — the rollback test compares runs fed
    # different-length views of the same stream.
    rng = np.random.default_rng(0)
    X = rng.standard_normal((n, 5)).astype(np.float32)
    Y = np.eye(3, dtype=np.float32)[
        np.random.default_rng(1).integers(0, 3, n)]
    if nan_from is not None:
        X[nan_from:] = np.nan
    return X, Y


def _params(net):
    return {n: {k: v.detach().clone().numpy() for k, v in d.items()}
            for n, d in net._params.items()}


def _leaves(tree):
    return [np.asarray(l) for _, l in integrity.flatten(tree)]


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def _guardian_syncs(reg=None):
    snap = (reg or monitoring.get_registry()).snapshot()
    rows = snap.get(monitoring.PIPELINE_SYNCS, [])
    return sum(r["value"] for r in rows
               if r.get("labels", {}).get("site") == "guardian")


def _total_syncs(reg=None):
    snap = (reg or monitoring.get_registry()).snapshot()
    return sum(r["value"] for r in snap.get(monitoring.PIPELINE_SYNCS, []))


@pytest.fixture(autouse=True)
def _clean_globals():
    yield
    faults.clear_plan()
    guardian_mod.clear_guardian()
    watchdog_mod.clear_watchdog()
    monitoring.get_registry().clear()
    monitoring.disable()


# ===================== guardian unit: the escalation ladder ===============
def test_ladder_escalates_skip_then_retry_then_rollback_then_raises():
    g = TrainingGuardian(check_every=1, max_skips=2, max_lr_retries=1,
                         max_rollbacks=1, warmup_steps=10**6)
    for _ in range(4):
        g.on_step(0.5, 1.0, True)
    assert g.take_action() is None and g.skipped == 0

    # rung 1: the first max_skips bad steps only count (the device
    # already refused the update)
    g.on_step(float("nan"), float("nan"), False)
    g.on_step(float("nan"), float("nan"), False)
    assert g.take_action() is None
    assert g.skipped == 2 and g.lr_scale == 1.0

    # rung 2: streak past max_skips → reduce LR + ask for a retry
    g.on_step(float("nan"), float("nan"), False)
    assert g.take_action() == guardian_mod.RETRY
    assert g.lr_scale == 0.5 and g.lr_retries == 1

    # rung 3: LR rungs exhausted → request a rollback
    for _ in range(3):
        g.on_step(float("nan"), float("nan"), False)
    assert g.take_action() == guardian_mod.ROLLBACK
    assert g.rollbacks == 1
    g.note_rollback(4)
    # trainer-step vs guardian-step timelines stay separate: the
    # checkpoint's step surfaces as last_restored_step, while last-good
    # on the guardian's own timeline is NOW (restored state is verified)
    assert g.last_restored_step == 4
    assert g.last_good_step == g.step

    # rung 4: everything exhausted → DivergenceError
    g.on_step(float("nan"), float("nan"), False)
    g.on_step(float("nan"), float("nan"), False)
    with pytest.raises(DivergenceError, match="ladder exhausted"):
        g.on_step(float("nan"), float("nan"), False)
    assert not g.healthy
    assert g.snapshot()["status"] == "diverged"


def test_spike_detection_arms_after_warmup_and_sets_device_threshold():
    g = TrainingGuardian(check_every=1, spike_factor=4.0, warmup_steps=3,
                         ema_decay=0.5, max_skips=10,
                         raise_on_divergence=False)
    for _ in range(3):
        g.on_step(0.5, 1.0, True)
    # EMA warmed on an all-1.0 stream → threshold = spike_factor * 1.0
    assert g.max_gnorm == pytest.approx(4.0)
    before = g.last_good_step
    g.on_step(0.5, 100.0, True)       # finite but 25x the EMA: a spike
    assert g.snapshot()["status"] == "degraded"
    assert g.last_good_step == before, "a spike step is not a good step"
    # the spike must NOT be folded into the EMA (it would drag the
    # threshold up toward the divergence it should catch)
    assert g.max_gnorm == pytest.approx(4.0)


def test_lr_scale_recovers_after_clean_stretch():
    g = TrainingGuardian(check_every=1, max_skips=0, max_lr_retries=2,
                         recovery_checks=2, warmup_steps=10**6)
    g.on_step(float("nan"), float("nan"), False)
    assert g.take_action() == guardian_mod.RETRY and g.lr_scale == 0.5
    g.on_step(0.5, 1.0, True)
    assert g.lr_scale == 0.5, "one healthy flush is not yet recovery"
    g.on_step(0.5, 1.0, True)
    assert g.lr_scale == 1.0 and g.lr_retries == 0


def test_retry_only_for_newest_device_refused_step():
    # a bad step that is NOT the newest in its flush window must not
    # request a batch retry: the driver's current batch is a later,
    # healthy one whose update already landed — re-running it would
    # apply it twice. The LR rung still climbs (applies from the next
    # step).
    g = TrainingGuardian(check_every=2, max_skips=0, max_lr_retries=2,
                         warmup_steps=10**6)
    g.on_step(float("nan"), float("nan"), False)
    g.on_step(0.5, 1.0, True)
    assert g.lr_scale == 0.5, "LR rung climbs for the stale bad step"
    assert g.take_action() is None, "no retry for a stale step"

    # a host-side spike detection (ok=True: the device threshold had not
    # learned the spike yet, so the update WAS applied) must not request
    # a retry and is not a 'skipped update'
    g2 = TrainingGuardian(check_every=1, spike_factor=4.0, warmup_steps=2,
                          ema_decay=0.5, max_skips=0,
                          raise_on_divergence=False)
    g2.on_step(0.5, 1.0, True)
    g2.on_step(0.5, 1.0, True)
    g2.on_step(0.5, 100.0, True)
    assert g2.take_action() is None
    assert g2.skipped == 0, "an applied update is not a skip"
    assert g2.lr_scale == 0.5

    # a verify_now()-triggered flush never issues RETRY: the driver
    # already consumed its actions for the batch it just ran
    g3 = TrainingGuardian(check_every=100, max_skips=0,
                          warmup_steps=10**6)
    g3.on_step(float("nan"), float("nan"), False)
    g3.verify_now()
    assert g3.take_action() is None and g3.lr_scale == 0.5


def test_stale_action_dropped_at_next_flush():
    """A driverless (bare-fit) guardian must not freeze on an
    unconsumed action: it is dropped at the next flush so health
    reports recover and later save-gating is not spuriously blocked."""
    g = TrainingGuardian(check_every=1, max_skips=0, recovery_checks=3,
                         warmup_steps=10**6)
    g.on_step(float("nan"), float("nan"), False)   # LR rung sets RETRY
    assert g.snapshot()["status"] == "degraded"
    for _ in range(3):
        g.on_step(0.5, 1.0, True)
    assert g.lr_scale == 1.0
    assert g.snapshot()["status"] == "ok", \
        "the unconsumed action must not report degraded forever"
    assert g.verify_now() is True


def test_driver_attached_rollback_survives_mid_batch_flushes():
    """With a driver attached (FaultTolerantTrainer), an escalation
    action must PERSIST across flushes until take_action() — the driver
    only runs after the whole batch, and a TBPTT segment loop flushes
    once per segment, so segment k's ROLLBACK must not be dropped (or a
    second rollback burned) by segment k+1's flush."""
    g = TrainingGuardian(check_every=1, max_skips=0, max_lr_retries=0,
                         max_rollbacks=2, warmup_steps=10**6)
    g.driver_attached = True
    # one TBPTT batch of 4 NaN segments: segment 1 requests ROLLBACK,
    # segments 2-4 flush while the action is still unconsumed
    for _ in range(4):
        g.on_step(float("nan"), float("nan"), False, retryable=False)
    assert g.rollbacks == 1, \
        "later segments must not burn extra rollback budget"
    assert g.healthy
    assert g.take_action() == guardian_mod.ROLLBACK, \
        "the mid-batch rollback request must reach the driver"
    assert g.take_action() is None


def test_tbptt_mid_batch_rollback_reaches_the_driver(tmp_path):
    """End to end: a NaN TBPTT segment mid-batch escalates to ROLLBACK,
    and FaultTolerantTrainer actually executes it after the batch —
    final params land bit-identically on the last verified generation
    (the pre-fix failure: every segment flush dropped the pending
    action, so the rollback never ran and the budget silently burned)."""
    rng = np.random.default_rng(11)
    X = rng.standard_normal((4, 12, 5)).astype(np.float32)
    Y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (4, 12))]
    Xbad = X.copy()
    Xbad[2:, 4:, :] = np.nan     # batch 2: segments 2 and 3 poisoned

    ref = _tbptt_rnn()
    g_ref = TrainingGuardian(check_every=1, warmup_steps=10**6)
    FaultTolerantTrainer(ref, str(tmp_path / "ref"), save_every=100,
                         prefetch=0, guardian=g_ref) \
        .fit(ArrayDataSetIterator(X[:2], Y[:2], 2))
    p_good = _params(ref)

    net = _tbptt_rnn()
    g = TrainingGuardian(check_every=1, max_skips=0, max_lr_retries=0,
                         max_rollbacks=2, warmup_steps=10**6)
    t = FaultTolerantTrainer(net, str(tmp_path / "run"), save_every=1,
                             prefetch=0, skip_non_finite=False, guardian=g)
    t.fit(ArrayDataSetIterator(Xbad, Y, 2))

    assert g.rollbacks == 1, "exactly one rollback, not a burned budget"
    assert g.healthy and g.take_action() is None
    _assert_trees_equal(_params(net), p_good)


def test_bare_fit_driverless_ladder_still_diverges():
    """Without a driver (no FaultTolerantTrainer), unconsumed actions
    are dropped rather than freezing the ladder: persistent NaN in a
    bare fit still ends in DivergenceError — with check_every > 1."""
    X, Y = _data(60, nan_from=0)
    net = _net()
    with TrainingGuardian(check_every=3, max_skips=1, max_lr_retries=1,
                          max_rollbacks=1, warmup_steps=10**6) as g:
        with pytest.raises(DivergenceError):
            net.fit(ArrayDataSetIterator(X, Y, 10), epochs=10)
    assert not g.healthy
    assert g.snapshot()["status"] == "diverged"


def test_rollback_delivered_with_check_every_gt_1(tmp_path):
    """One check_every>1 window full of bad steps must deliver ONE rung
    per flush to the driver — not burn the whole ladder internally,
    destroying every rollback request before the driver could act."""
    X, Y = _data(60, nan_from=20)
    net = _net()
    g = TrainingGuardian(check_every=5, max_skips=1, max_lr_retries=1,
                         max_rollbacks=1, warmup_steps=10**6)
    delivered = []
    orig = g.note_rollback
    g.note_rollback = lambda s: (delivered.append(s), orig(s))[1]
    t = FaultTolerantTrainer(net, tmp_path / "g", save_every=2,
                             guardian=g, skip_non_finite=False)
    with pytest.raises(DivergenceError):
        t.fit(ArrayDataSetIterator(X, Y, 10), epochs=4)
    # step 4's save passed verify_now legitimately: the device refused
    # steps 3-4's updates, so that tree is clean (identical to step 2's)
    # and becomes the newest verified generation the rollback restores
    assert delivered == [4], \
        "the driver must perform the requested rollback before the " \
        "ladder exhausts"
    assert g.rollbacks == 1
    leaves = _leaves(_params(net))
    assert all(np.isfinite(l).all() for l in leaves)
    t.close()


def test_ambient_guardian_driven_and_gates_saves(tmp_path):
    """A with-block guardian (no guardian= kwarg) must be driven by the
    trainer too: its verdict gates saves and lands in the manifest."""
    X, Y = _data(40)
    net = _net()
    with TrainingGuardian(check_every=1, warmup_steps=10**6) as g:
        t = FaultTolerantTrainer(net, tmp_path / "g", save_every=2)
        t.fit(ArrayDataSetIterator(X, Y, 10))
        t.close()
    assert g.step == 4
    m = integrity.read_manifest(str(tmp_path / "g"), 4)
    assert m is not None and m["guardian"] == "verified"


def test_exit_flushes_tail_verdicts():
    # steps after the last check_every boundary must still be judged
    # when the with-block ends — a divergence in the final steps of a
    # fit would otherwise report status "ok"
    with TrainingGuardian(check_every=4, max_skips=100,
                          warmup_steps=10**6) as g:
        for _ in range(5):
            g.on_step(float("nan"), float("nan"), False)
        assert g.checks == 1 and g.skipped == 4
    assert g.checks == 2 and g.skipped == 5
    assert g.snapshot()["pending"] == 0


def test_check_cadence_is_one_stacked_sync_per_check_every():
    monitoring.enable()
    reg = monitoring.get_registry()
    reg.clear()
    g = TrainingGuardian(check_every=4, warmup_steps=10**6)
    for _ in range(12):
        g.on_step(torch.tensor(0.5), torch.tensor(1.0),
                  torch.tensor(True))
    assert g.checks == 3
    assert _guardian_syncs(reg) == 3, \
        "guardian must sync once per check_every steps, never per step"


def test_health_snapshot_statuses(tmp_path):
    snap = health_snapshot()
    assert snap["status"] == "ok"
    assert snap["guardian"] is None
    assert snap["watchdog"] is None
    assert snap["distributed"] is None
    # the serving section lists GenerationServers when that subsystem
    # is loaded (None otherwise); none may be dead/degraded here
    assert all(s["state"] in ("serving", "shutdown", "cold")
               for s in snap["serving"] or [])
    g = TrainingGuardian(check_every=1, max_skips=5,
                         warmup_steps=10**6).install()
    g.on_step(float("nan"), float("nan"), False)
    snap = health_snapshot()
    assert snap["status"] == "degraded"
    assert snap["guardian"]["skipped_updates"] == 1
    guardian_mod.clear_guardian()

    t = [0.0]
    wd = StallWatchdog(stall_timeout=10, poll_interval=100,
                       dump_dir=str(tmp_path), clock=lambda: t[0]).install()
    wd.arm()
    t[0] = 11.0
    wd.check_now()
    assert health_snapshot()["status"] == "stalled"


# ===================== guarded step: device-side refusal ==================
def test_guarded_step_never_applies_nan_update_bit_identical():
    net = _net()
    X, Y = _data(30)
    with TrainingGuardian(check_every=1, max_skips=100,
                          warmup_steps=10**6) as g:
        net.fit(ArrayDataSetIterator(X, Y, 10))
        before = _params(net)
        bad = np.full((10, 5), np.nan, dtype=np.float32)
        net.fit(ArrayDataSetIterator(bad, Y[:10], 10))
        _assert_trees_equal(_params(net), before)
        assert g.skipped == 1
        # params must still be live and trainable afterwards
        net.fit(ArrayDataSetIterator(X, Y, 10))
        after = _leaves(_params(net))
        assert all(np.isfinite(l).all() for l in after)


@pytest.mark.parametrize("accum", [1, 2])
def test_guarded_steps_match_the_jax_package(accum):
    """The guarded single step (accum 1) and the guarded accumulation step
    (`.gradientAccumulation(2)`) in both packages from the same weights,
    over 8 batches: a NaN batch (a microbatch of the second update under
    accumulation) and an update over a low `max_gnorm` are refused. The
    verdicts and skip counts are equal, each healthy step's grad norm (the
    guardian's EMA) agrees to 1e-6 relative, and the parameters and the
    optimizer state (the momenta and the count) to 1e-6."""
    import jax

    from deeplearning4j_tpu import nn as jnn
    from deeplearning4j_tpu.datasets.iterators import \
        ArrayDataSetIterator as JIter
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
    from deeplearning4j_tpu.resilience.guardian import \
        TrainingGuardian as JGuardian
    from deeplearning4j_tpu_torch import nn as tnn
    from deeplearning4j_tpu_torch.nn.convert import jax_tree

    def conf(pkg):
        b = (pkg.NeuralNetConfiguration.Builder().seed(3)
             .updater(pkg.Nesterovs(0.1, 0.9)).activation("tanh"))
        if accum > 1:
            b = b.gradientAccumulation(accum)
        return (b.list().layer(pkg.DenseLayer.Builder().nOut(8).build())
                .layer(pkg.OutputLayer.Builder("mcxent").nOut(3)
                       .activation("softmax").build())
                .setInputType(pkg.InputType.feedForward(5)).build())

    jnet = JMLN(conf(jnn)).init()
    init = jax.tree_util.tree_map(np.asarray, jnet._params)
    tnet = tnn.multilayer_params_from_numpy(
        MultiLayerNetwork(conf(tnn)), init, {}, device="cpu")
    X, Y = _data(80)
    X[20:30] = np.nan                     # batch 2
    over = 4 // accum                     # the update holding batch 4

    def run(net, Guardian, It):
        emas, skipped = [], []
        with Guardian(check_every=1, max_skips=10,
                      warmup_steps=10**6) as g:
            for u in range(8 // accum):
                g.max_gnorm = 1e-3 if u == over else float("inf")
                rows = slice(u * accum * 10, (u + 1) * accum * 10)
                net.fit(It(X[rows], Y[rows], 10))
                emas.append(g._ema)
                skipped.append(g.skipped)
        return emas, skipped

    jemas, jskipped = run(jnet, JGuardian, JIter)
    temas, tskipped = run(tnet, TrainingGuardian, ArrayDataSetIterator)
    assert tskipped == jskipped and tskipped[-1] == 2
    assert tnet._iteration == jnet._iteration == 8 // accum
    np.testing.assert_allclose(temas, jemas, rtol=1e-6)
    got = jax_tree(tnet, {n: {k: v.numpy() for k, v in d.items()}
                          for n, d in tnet._params.items()})
    for n in got:
        for k in got[n]:
            np.testing.assert_allclose(got[n][k], np.asarray(
                jnet._params[n][k]), rtol=1e-6, atol=1e-6)
    tleaves = tensor_leaves(tnet._opt_state)   # momenta, then the count
    jleaves = jax.tree_util.tree_leaves(jnet._opt_state)
    assert len(tleaves) == len(jleaves)
    for t, j in zip(tleaves, jleaves):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-6)


def _tbptt_rnn(seed=7):
    from deeplearning4j_tpu_torch.nn import Adam
    from deeplearning4j_tpu_torch.nn.conf.builders import BackpropType
    from deeplearning4j_tpu_torch.nn.conf.recurrent import (LSTM,
                                                            RnnOutputLayer)
    b = (NeuralNetConfiguration.Builder().seed(seed).updater(Adam(5e-3))
         .list()
         .layer(LSTM.Builder().nOut(6).build())
         .layer(RnnOutputLayer.Builder("mcxent").nOut(3)
                .activation("softmax").build())
         .setInputType(InputType.recurrent(5)))
    b.backpropType(BackpropType.TruncatedBPTT)
    b.tBPTTLength(4)
    return MultiLayerNetwork(b.build()).init(device="cpu")


def test_tbptt_guarded_segments_refuse_nan_and_never_retry():
    """The TBPTT segment loop must be guarded too: each segment reports
    its own verdict (retryable=False — earlier healthy segments of the
    batch already updated params), a NaN segment is refused on device,
    and the guardian never asks the driver to re-run the batch."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 12, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (2, 12))]

    net = _tbptt_rnn()
    with TrainingGuardian(check_every=1, max_skips=100,
                          warmup_steps=10**6) as g:
        net.fit(DataSet(x, y))
        assert g.step == 3, "12 steps / tBPTTLength 4 → 3 verdicts"
        xbad = x.copy()
        xbad[:, 4:, :] = np.nan      # poisons segments 2 and 3
        net.fit(DataSet(xbad, y))
        assert g.skipped == 2
        leaves = _leaves(_params(net))
        assert all(np.isfinite(l).all() for l in leaves), \
            "a NaN TBPTT segment reached the live params"

    net2 = _tbptt_rnn()
    g2 = TrainingGuardian(check_every=1, max_skips=0, max_lr_retries=5,
                          warmup_steps=10**6)
    with g2:
        net2.fit(DataSet(xbad, y))
    assert g2.skipped == 2 and g2.lr_retries == 2
    assert g2.take_action() is None, \
        "TBPTT segments must never request a batch retry"


def test_inner_trainer_guardian_restores_outer_on_exit(tmp_path):
    """An inner scope's guardian (FaultTolerantTrainer driving its own)
    must RESTORE the guardian it shadowed, not strip it — the fits that
    follow inside the user's with-block are still meant to be guarded."""
    outer = TrainingGuardian(check_every=1, warmup_steps=10**6)
    inner = TrainingGuardian(check_every=1, warmup_steps=10**6)
    X, Y = _data(30)
    with outer:
        net = _net()
        t = FaultTolerantTrainer(net, tmp_path / "g", save_every=100,
                                 guardian=inner)
        t.fit(ArrayDataSetIterator(X, Y, 10))
        t.close()
        assert guardian_mod.ACTIVE is outer, \
            "inner fit must restore the shadowed guardian"
        assert inner.step == 3
        net.fit(ArrayDataSetIterator(X, Y, 10))
        assert outer.step == 3, "the outer guard must see later fits"
    assert guardian_mod.ACTIVE is None


def test_manifests_pruned_with_generation_gc(tmp_path):
    """max_to_keep GC removes step dirs; the sidecar manifests must go
    with them (a long run would otherwise leak one file per retired
    generation until the next restart's sweep)."""
    from deeplearning4j_tpu_torch.parallel.elastic import \
        ElasticCheckpointer
    ck = ElasticCheckpointer(tmp_path, max_to_keep=2)
    state = {"a": np.ones(3, np.float32)}
    for step in range(1, 6):
        ck.save(step, state, wait=True)
    assert set(ck.all_steps()) == {4, 5}
    stems = {f[:-5] for f in os.listdir(tmp_path / "manifests")
             if f.endswith(".json")}
    assert stems == {"4", "5"}, \
        "retired generations' manifests must be pruned at save time"
    ck.close()


def test_manifest_treedef_mismatch_detected(tmp_path):
    """Same leaf count, same bytes, different structure: the manifest's
    treedef must catch it."""
    state = {"a": np.ones(3, np.float32), "b": np.zeros(3, np.float32)}
    integrity.write_manifest(tmp_path, 1, state)
    assert integrity.verify_restored(tmp_path, 1, state) == "verified"
    renamed = {"a": np.ones(3, np.float32), "c": np.zeros(3, np.float32)}
    with pytest.raises(CheckpointIntegrityError, match="tree structure"):
        integrity.verify_restored(tmp_path, 1, renamed)


def test_guardian_fit_sync_cadence_matches_check_every():
    """The zero-sync harness, guardian flavor: a listener-free
    guarded fit syncs exactly steps/check_every times — the health
    check adds NO per-step host sync."""
    monitoring.enable()
    reg = monitoring.get_registry()
    reg.clear()
    X, Y = _data(200)
    net = _net()
    with TrainingGuardian(check_every=5, warmup_steps=10**6):
        net.fit(ArrayDataSetIterator(X, Y, 10))   # 20 steps
    assert _guardian_syncs(reg) == 4
    assert _total_syncs(reg) == 4, \
        "no other host-blocking sync may ride along with the guardian"


# ===================== THE acceptance test: rollback bit-identity =========
def test_nan_grads_at_step_k_roll_back_to_last_good_bit_identical(tmp_path):
    """NaN features from step 5 on (skip_non_finite OFF, so the NaN
    flows into loss/grads — the 'one overflowing step' scenario).
    save_every=4 → the step-4 checkpoint is the last verified
    generation. The ladder burns skip → LR retry → rollback → raise;
    final params must equal a run trained ONLY on the 4 clean
    batches, bit for bit."""
    bs, clean_steps = 10, 4
    Xc, Yc = _data(bs * clean_steps)

    ref = _net(seed=7)
    g_ref = TrainingGuardian(check_every=1, warmup_steps=10**6)
    FaultTolerantTrainer(ref, str(tmp_path / "ref"), save_every=100,
                         prefetch=0, guardian=g_ref) \
        .fit(ArrayDataSetIterator(Xc, Yc, bs))
    p_good = _params(ref)

    X, Y = _data(bs * (clean_steps + 6), nan_from=bs * clean_steps)
    net = _net(seed=7)
    g = TrainingGuardian(check_every=1, max_skips=1, max_lr_retries=1,
                         max_rollbacks=1, warmup_steps=10**6)
    t = FaultTolerantTrainer(net, str(tmp_path / "run"), save_every=4,
                             prefetch=0, skip_non_finite=False, guardian=g)
    with pytest.raises(DivergenceError):
        t.fit(ArrayDataSetIterator(X, Y, bs))

    assert g.rollbacks == 1
    _assert_trees_equal(_params(net), p_good)

    # the checkpoint the rollback landed on was guardian-verified
    man = integrity.read_manifest(str(tmp_path / "run"), 4)
    assert man is not None and man["guardian"] == "verified"
    # and no poisoned generation was ever persisted
    assert t.ckpt.all_steps() == [4]


# ===================== save gating ========================================
def test_saves_gated_until_guardian_vouches(tmp_path):
    monitoring.enable()
    net = _net()
    g = TrainingGuardian(check_every=1, max_skips=5, warmup_steps=10**6)
    t = FaultTolerantTrainer(net, str(tmp_path), save_every=1, guardian=g)
    t.step = 1
    g.on_step(float("nan"), float("nan"), False)    # live bad streak
    assert t._maybe_save(g) is False
    assert t.ckpt.latest_step() is None, "poisoned tree must not persist"
    snap = monitoring.get_registry().snapshot()
    gated = sum(r["value"]
                for r in snap.get(monitoring.GUARDIAN_SAVES_GATED, []))
    assert gated == 1

    for _ in range(3):
        g.on_step(0.5, 1.0, True)                   # streak cleared
    assert t._maybe_save(g, wait=True) is True
    assert t.ckpt.latest_step() == 1
    assert integrity.read_manifest(str(tmp_path), 1)["guardian"] \
        == "verified"


# ===================== integrity manifests ================================
def test_manifest_roundtrip_tamper_and_absence(tmp_path):
    d = str(tmp_path)
    state = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
             "b": np.ones(4, dtype=np.float32)}
    integrity.write_manifest(d, 3, state, verdict="verified")
    assert integrity.verify_restored(d, 3, state) == "verified"

    tampered = {"a": state["a"], "b": state["b"] + 1.0}
    with pytest.raises(CheckpointIntegrityError, match="checksum"):
        integrity.verify_restored(d, 3, tampered)

    # a dropped leaf changes the structure: the treedef check names it
    wrong_shape = {"a": state["a"]}
    with pytest.raises(CheckpointIntegrityError, match="tree structure"):
        integrity.verify_restored(d, 3, wrong_shape)

    # no manifest → restorable but unverified (pre-manifest checkpoint)
    assert integrity.verify_restored(d, 99, state) == "unverified"

    # non-finite params are refused even with a matching manifest
    poisoned = {"a": np.full((2, 3), np.nan, np.float32), "b": state["b"]}
    with pytest.raises(CheckpointIntegrityError, match="non-finite"):
        integrity.verify_restored(d, 99, poisoned)

    # a PRESENT but truncated manifest is corruption, not absence
    with open(integrity.manifest_path(d, 5), "w") as f:
        f.write('{"format": 1, "step"')
    with pytest.raises(CheckpointIntegrityError, match="unreadable"):
        integrity.read_manifest(d, 5)


def test_corrupted_manifest_restore_falls_back_a_generation(tmp_path):
    monitoring.enable()
    bs = 10
    X, Y = _data(bs * 5)
    net = _net(seed=11)
    t = FaultTolerantTrainer(net, str(tmp_path), save_every=2, prefetch=0)
    t.fit(ArrayDataSetIterator(X, Y, bs))     # gens 2, 4 + final 5
    assert t.ckpt.all_steps() == [2, 4, 5]
    t.ckpt.close()

    # flip one checksum in the newest generation's manifest
    mpath = integrity.manifest_path(str(tmp_path), 5)
    with open(mpath) as f:
        man = json.load(f)
    man["checksums"][0] = "crc32:deadbeef"
    with open(mpath, "w") as f:
        json.dump(man, f)

    net2 = _net(seed=11)
    t2 = FaultTolerantTrainer(net2, str(tmp_path), save_every=2)
    assert t2.resume_or_init() == 4, \
        "corrupt gen 5 must fall back to gen 4, not kill the run"
    snap = monitoring.get_registry().snapshot()
    fb = sum(r["value"]
             for r in snap.get(monitoring.RESILIENCE_CKPT_FALLBACKS, []))
    assert fb == 1
    # and the restored params are exactly generation 4's bytes
    like = {"params": net2._params, "opt_state": net2._opt_state,
            "extra": t2._net_extra()}
    _, state4 = t2.ckpt.restore(step=4, like=like)
    _assert_trees_equal(net2._params, state4["params"])
    t2.ckpt.close()


def test_checkpoint_corrupt_fault_injection_proves_fallback(tmp_path):
    bs = 10
    X, Y = _data(bs * 3)
    net = _net(seed=11)
    t = FaultTolerantTrainer(net, str(tmp_path), save_every=2, prefetch=0)
    t.fit(ArrayDataSetIterator(X, Y, bs))     # gens 2 + final 3
    t.ckpt.close()

    FaultPlan(seed=0).fail_at(faults.CHECKPOINT_CORRUPT, 1).install()
    net2 = _net(seed=11)
    t2 = FaultTolerantTrainer(net2, str(tmp_path), save_every=2)
    assert t2.resume_or_init() == 2, \
        "injected corruption on gen 3 verification → fall back to gen 2"
    t2.ckpt.close()


def test_checkpoint_restore_fault_point_fires_and_falls_back(tmp_path):
    bs = 10
    X, Y = _data(bs * 3)
    net = _net(seed=11)
    t = FaultTolerantTrainer(net, str(tmp_path), save_every=2, prefetch=0)
    t.fit(ArrayDataSetIterator(X, Y, bs))     # gens 2 + final 3
    t.ckpt.close()

    like = {"params": net._params, "opt_state": net._opt_state,
            "extra": t._net_extra()}
    from deeplearning4j_tpu_torch.parallel.elastic import \
        ElasticCheckpointer
    ckpt = ElasticCheckpointer(str(tmp_path))
    # direct restore: the injected fault surfaces
    FaultPlan(seed=0).fail_at(faults.CHECKPOINT_RESTORE, 1).install()
    with pytest.raises(InjectedFault):
        ckpt.restore(like=like)
    # verified restore: the faulted read burns gen 3, gen 2 restores
    faults.clear_plan()
    FaultPlan(seed=0).fail_at(faults.CHECKPOINT_RESTORE, 1).install()
    step, _ = ckpt.restore_verified(like=like)
    assert step == 2
    ckpt.close()


# ===================== eval.forward fault point ===========================
def test_eval_forward_fault_point():
    net = _net()
    X, Y = _data(30)
    it = ArrayDataSetIterator(X, Y, 10)
    FaultPlan(seed=0).fail_at(faults.EVAL_FORWARD, 1).install()
    with pytest.raises(InjectedFault):
        net.evaluate(it)
    faults.clear_plan()
    ev = net.evaluate(ArrayDataSetIterator(X, Y, 10))
    assert ev is not None


# ===================== _finite satellite ==================================
def test_finite_handles_scalar_int_and_exotic_leaves():
    assert _finite(None) and _finite(3) and _finite(True)
    assert _finite(3.5) and _finite("label")
    assert not _finite(float("nan"))
    assert not _finite(np.float64("inf"))
    assert _finite(np.arange(4))          # int array: nothing to check
    assert _finite(np.zeros(3, np.float32))
    assert not _finite(np.array([1.0, np.nan], np.float32))
    # bfloat16 registers with numpy as kind 'V' — the old
    # issubdtype(floating) gate reported its NaNs as finite
    bad = torch.tensor([1.0, float("nan")], dtype=torch.bfloat16)
    assert not _finite(bad)
    assert _finite(torch.ones(3, dtype=torch.bfloat16))


# ===================== orphan sweep =======================================
def test_startup_sweep_removes_orphans_keeps_live_generations(tmp_path):
    monitoring.enable()
    bs = 10
    X, Y = _data(bs * 3)
    net = _net(seed=11)
    t = FaultTolerantTrainer(net, str(tmp_path), save_every=2, prefetch=0)
    t.fit(ArrayDataSetIterator(X, Y, bs))     # gens 2 + final 3
    t.ckpt.close()

    d = str(tmp_path)
    os.makedirs(os.path.join(d, f"99{integrity.TMP_MARK}-123-0"))
    with open(os.path.join(d, "7.tmp"), "w") as f:
        f.write("partial")
    with open(integrity.manifest_path(d, 77), "w") as f:
        f.write("{}")                         # its generation was GC'd
    with open(integrity.manifest_path(d, 3) + ".tmp", "w") as f:
        f.write("{")

    net2 = _net(seed=11)
    t2 = FaultTolerantTrainer(net2, d, save_every=2)
    assert t2.ckpt.orphans_removed == 4
    snap = monitoring.get_registry().snapshot()
    removed = sum(
        r["value"]
        for r in snap.get(monitoring.RESILIENCE_CKPT_ORPHANS_REMOVED, []))
    assert removed == 4
    # the real generations and their manifests survived the sweep
    assert t2.resume_or_init() == 3
    assert integrity.read_manifest(d, 3) is not None
    t2.ckpt.close()


# ===================== stall watchdog =====================================
def _fake_watchdog(tmp_path, timeout=10.0, **kw):
    t = [0.0]
    wd = StallWatchdog(stall_timeout=timeout, poll_interval=3600,
                       dump_dir=str(tmp_path), clock=lambda: t[0], **kw)
    return wd, t


def test_watchdog_trips_latches_and_recovers_on_beat(tmp_path):
    wd, t = _fake_watchdog(tmp_path)
    assert wd.beat_age() is None, "disarmed: no stall detection"
    wd.arm()
    wd.beat("multilayer")
    t[0] = 5.0
    assert wd.check_now() is False
    t[0] = 11.0
    assert wd.check_now() is True
    assert wd.stalled and wd.stall_count == 1
    assert wd.check_now() is False, "latched: one stall, one report"
    wd.beat("multilayer")
    assert not wd.stalled, "a completed step is the recovery signal"
    t[0] = 25.0
    assert wd.check_now() is True and wd.stall_count == 2


def test_watchdog_report_contains_the_wedged_stack(tmp_path):
    release = threading.Event()

    def _wedged_collective():
        release.wait(30)

    th = threading.Thread(target=_wedged_collective, daemon=True)
    th.start()
    try:
        wd, t = _fake_watchdog(tmp_path)
        wd.arm()                      # arming is the implicit first beat
        t[0] = 11.0
        assert wd.check_now() is True
        assert wd.last_report_path and os.path.exists(wd.last_report_path)
        report = open(wd.last_report_path).read()
        assert "no trainer heartbeat for 11.0 s" in report
        assert "_wedged_collective" in report, \
            "the report must show the wedged thread's stack"
        assert "flight recorder" in report
    finally:
        release.set()
        th.join(timeout=5)


def test_open_spans_evicts_dead_threads():
    """A thread that exits with a span still open must not show up as a
    phantom wedged thread in later stall reports (and its stack list
    must not be pinned forever)."""
    monitoring.enable()
    tracer = monitoring.get_tracer()

    def run():
        tracer.span("wedged.zombie").__enter__()   # never exited

    th = threading.Thread(target=run)
    th.start()
    th.join()
    for stack in tracer.open_spans().values():
        assert "wedged.zombie" not in stack
    assert th.ident not in tracer._stacks_by_tid


def test_watchdog_abort_callable_runs_on_trip(tmp_path):
    calls = []
    wd, t = _fake_watchdog(tmp_path, abort=lambda: calls.append(1))
    wd.arm()
    t[0] = 11.0
    wd.check_now()
    assert calls == [1]


def test_watchdog_install_shadow_chain_restores_outer():
    """A second watchdog must not strip the first from the global — an
    armed outer watchdog starved of heartbeats by an inner scope's
    install() would false-trip (and abort) a healthy run."""
    wd1 = StallWatchdog(stall_timeout=5).install()
    wd2 = StallWatchdog(stall_timeout=5).install()
    assert watchdog_mod.ACTIVE is wd2
    wd2.stop()
    assert watchdog_mod.ACTIVE is wd1, "inner stop() must restore outer"
    wd1.stop()
    assert watchdog_mod.ACTIVE is None


def test_watchdog_oldest_live_trainer_trips_not_masked(tmp_path):
    """Detection watches the OLDEST live trainer: with two trainers
    beating one watchdog, the live one's fresh beats must not mask the
    wedged one's silence — and a trainer whose fit legitimately ENDED
    (retire) must not age into a false trip."""
    wd, t = _fake_watchdog(tmp_path)
    wd.arm()
    wd.beat("a")
    wd.beat("b")
    t[0] = 5.0
    wd.beat("b")                  # a silent for 5 s — inside timeout
    assert wd.check_now() is False
    t[0] = 11.0
    wd.beat("b")                  # a silent for 11 s, b fresh
    assert wd.check_now() is True, \
        "a live trainer's beats masked the wedged one"
    assert "a: 11.0 s ago" in open(wd.last_report_path).read()

    wd2, t2 = _fake_watchdog(tmp_path)
    wd2.arm()
    wd2.beat("a")
    wd2.beat("b")
    wd2.retire("a")               # a's fit finished — not stall evidence
    t2[0] = 11.0
    wd2.beat("b")
    assert wd2.check_now() is False, "a finished fit must not false-trip"


def test_fit_heartbeats_reach_installed_watchdog():
    wd = StallWatchdog(stall_timeout=3600, poll_interval=3600).install()
    X, Y = _data(30)
    _net().fit(ArrayDataSetIterator(X, Y, 10))
    snap = wd.snapshot()
    # heartbeats key per instance (multilayer@<id>): two concurrent
    # same-class fits must not mask or retire each other
    assert any(k.startswith("multilayer@") for k in snap["heartbeats"])
    assert not any(k.startswith("multilayer@") for k in snap["live"]), \
        "a finished fit must retire its heartbeat"


def test_ftt_fit_preserves_externally_armed_watchdog(tmp_path):
    """FaultTolerantTrainer arms the watchdog for its own fit — but a
    caller who armed a wider window (multi-phase script) must get it
    back intact: fit's disarm would silently close the window and leave
    the NEXT phase's hang unwatched."""
    wd = StallWatchdog(stall_timeout=3600, poll_interval=3600).install()
    wd.arm()
    X, Y = _data(30)
    FaultTolerantTrainer(_net(), str(tmp_path), prefetch=0,
                         watchdog=wd).fit(ArrayDataSetIterator(X, Y, 10))
    assert wd.armed, "fit must not close the caller's armed window"
    # and without an outer window, fit still arms/disarms its own
    wd.disarm()
    FaultTolerantTrainer(_net(), str(tmp_path / "b"), prefetch=0,
                         watchdog=wd).fit(ArrayDataSetIterator(X, Y, 10))
    assert not wd.armed
    wd.stop()


# ===================== GET /health ========================================
def test_ui_health_endpoint_reports_and_degrades_to_503(tmp_path):
    from deeplearning4j_tpu_torch.ui.server import UIServer
    server = UIServer.getInstance()
    server.start(port=0)
    try:
        base = f"http://127.0.0.1:{server.port}"
        snap = json.loads(urllib.request.urlopen(
            base + "/health", timeout=10).read().decode())
        assert snap["status"] == "ok"
        assert snap["guardian"] is None
        assert snap["watchdog"] is None
        assert snap["distributed"] is None
        assert all(s["state"] in ("serving", "shutdown", "cold")
                   for s in snap["serving"] or [])

        t = [0.0]
        wd = StallWatchdog(stall_timeout=10, poll_interval=3600,
                           dump_dir=str(tmp_path),
                           clock=lambda: t[0]).install()
        wd.arm()
        t[0] = 11.0
        wd.check_now()
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(base + "/health", timeout=10)
        assert exc.value.code == 503
        body = json.loads(exc.value.read().decode())
        assert body["status"] == "stalled"
        assert body["watchdog"]["stall_count"] == 1
    finally:
        server.stop()
