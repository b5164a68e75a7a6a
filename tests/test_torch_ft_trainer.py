"""The port's FaultTolerantTrainer (network mode) over its
ElasticCheckpointer and integrity manifests, held to the contracts of
the JAX package's tests/test_resilience.py (its network-mode tests) and
against the JAX package's trainer on the same faulted run: a NaN batch
skipped, a transient dispatch fault retried, a kill and a resume.
Kill-and-resume and retry are bit for bit inside the port; against the
JAX package the parameters agree to 1e-5 and every count is equal.
Also: the guardian's and the watchdog's events reach the ops journal."""
import threading

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import monitoring
from deeplearning4j_tpu_torch.datasets.iterators import ArrayDataSetIterator
from deeplearning4j_tpu_torch.monitoring import events
from deeplearning4j_tpu_torch.nn import (ComputationGraph, DenseLayer,
                                         InputType, NeuralNetConfiguration,
                                         OutputLayer, Sgd)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel.elastic import (ElasticCheckpointer,
                                                       ElasticTrainer)
from deeplearning4j_tpu_torch.resilience import (FatalTrainingError,
                                                 FaultPlan, InjectedFault,
                                                 RetryPolicy, TransientError,
                                                 faults, integrity)
from deeplearning4j_tpu_torch.resilience import guardian as guardian_mod
from deeplearning4j_tpu_torch.resilience import watchdog as watchdog_mod
from deeplearning4j_tpu_torch.resilience.guardian import TrainingGuardian
from deeplearning4j_tpu_torch.resilience.trainer import FaultTolerantTrainer
from deeplearning4j_tpu_torch.resilience.watchdog import StallWatchdog


def _conf(seed=3):
    return (NeuralNetConfiguration.Builder()
            .seed(seed).updater(Sgd(0.1)).activation("tanh")
            .list()
            .layer(DenseLayer.Builder().nOut(8).build())
            .layer(OutputLayer.Builder("mcxent").nOut(3)
                   .activation("softmax").build())
            .setInputType(InputType.feedForward(5))
            .build())


def _net(seed=3):
    return MultiLayerNetwork(_conf(seed)).init(device="cpu")


def _data(n=120, nan_at=None):
    rng = np.random.default_rng(0)
    X = rng.standard_normal((n, 5)).astype(np.float32)
    Y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    if nan_at is not None:
        X[nan_at] = np.nan
    return X, Y


def _params(net):
    return [v.detach().clone() for _, v in integrity.flatten(net._params)]


def _assert_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.fixture(autouse=True)
def _clean():
    yield
    faults.clear_plan()
    guardian_mod.clear_guardian()
    watchdog_mod.clear_watchdog()
    monitoring.get_registry().clear()
    monitoring.disable()


def test_fault_smoke_injection_reaches_train_dispatch():
    net = _net()
    X, Y = _data(16)
    with FaultPlan().fail_at(faults.TRAIN_DISPATCH, 1):
        with pytest.raises(InjectedFault):
            net.fit(ArrayDataSetIterator(X, Y, 8))
    assert faults.ACTIVE is None
    net.fit(ArrayDataSetIterator(X, Y, 8))
    assert net.getIterationCount() == 2


def test_fit_fires_data_next_once_per_batch():
    net = _net()
    X, Y = _data(24)
    plan = FaultPlan().fail_at(faults.DATA_NEXT, 99)
    with plan:
        net.fit(ArrayDataSetIterator(X, Y, 8), epochs=2)
    assert plan.calls(faults.DATA_NEXT) == 6
    assert plan.calls(faults.TRAIN_DISPATCH) == 6


@pytest.mark.parametrize("prefetch", [0, 2])
def test_kill_and_resume_bit_identical(tmp_path, prefetch):
    X, Y = _data(120)

    def it():
        return ArrayDataSetIterator(X, Y, 8)   # 15 batches/epoch

    ref_tr = FaultTolerantTrainer(_net(), tmp_path / "ref", save_every=10,
                                  prefetch=prefetch)
    ref = _params(ref_tr.fit(it(), epochs=2))
    ref_tr.close()

    plan = FaultPlan(seed=7).fail_at(
        faults.TRAIN_DISPATCH, 17,
        exc=lambda s, n: FatalTrainingError(f"kill at {s}#{n}"))
    t1 = FaultTolerantTrainer(_net(), tmp_path / "ckpt", save_every=10,
                              prefetch=prefetch)
    with plan:
        with pytest.raises(FatalTrainingError):
            t1.fit(it(), epochs=2)
    t1.close()

    t2 = FaultTolerantTrainer(_net(), tmp_path / "ckpt", save_every=10,
                              prefetch=prefetch)
    with plan:
        m2 = t2.fit(it(), epochs=2)
    assert t2.resumed_step == 10, "must resume from the step-10 checkpoint"
    _assert_equal(ref, _params(m2))
    assert m2._epoch == 2
    assert m2._iteration == ref_tr.model._iteration
    t2.close()


def test_transient_dispatch_faults_are_retried_exactly(tmp_path):
    X, Y = _data(80)

    def it():
        return ArrayDataSetIterator(X, Y, 8)   # 10 batches

    ref_tr = FaultTolerantTrainer(_net(), tmp_path / "ref", save_every=100)
    ref = _params(ref_tr.fit(it(), epochs=1))
    ref_tr.close()

    pol = RetryPolicy(max_attempts=3, initial_backoff=0.0,
                      sleep=lambda s: None)
    t = FaultTolerantTrainer(_net(), tmp_path / "faulty", save_every=100,
                             retry_policy=pol)
    plan = FaultPlan(seed=1).every(faults.TRAIN_DISPATCH, 4, max_fires=2)
    with plan:
        m = t.fit(it(), epochs=1)
    assert plan.fired[faults.TRAIN_DISPATCH] == 2
    assert t.retries == 2
    _assert_equal(ref, _params(m))
    t.close()


def test_retry_restores_a_half_written_step_exactly(tmp_path):
    """A failure after the step wrote the live tensors (not only the
    injection point before the dispatch) is retried from the snapshot,
    bit for bit: the snapshot is a copy, not a reference."""
    X, Y = _data(40)
    ref_tr = FaultTolerantTrainer(_net(), tmp_path / "ref", save_every=100)
    ref = _params(ref_tr.fit(ArrayDataSetIterator(X, Y, 8)))
    net = _net()
    real = net._train_step
    fired = []

    def step_then_fail(batches, graphs=True):
        real(batches, graphs)
        if not fired:
            fired.append(1)
            raise RuntimeError("transient: lost the result")
    net._train_step = step_then_fail
    pol = RetryPolicy(max_attempts=2, initial_backoff=0.0,
                      sleep=lambda s: None,
                      classifier=lambda e: "transient" in str(e))
    t = FaultTolerantTrainer(net, tmp_path / "half", save_every=100,
                             retry_policy=pol)
    t.fit(ArrayDataSetIterator(X, Y, 8))
    assert t.retries == 1
    _assert_equal(ref, _params(net))
    assert net._iteration == ref_tr.model._iteration


def test_retry_stops_on_oom_classified_dispatch(tmp_path):
    X, Y = _data(40)
    t = FaultTolerantTrainer(_net(), tmp_path / "oom", save_every=100,
                             retry_policy=RetryPolicy(
                                 max_attempts=5, initial_backoff=0.0,
                                 sleep=lambda s: None))
    plan = FaultPlan().fail_at(
        faults.TRAIN_DISPATCH, 2,
        exc=lambda s, n: RuntimeError("CUDA out of memory"))
    with plan:
        with pytest.raises(RuntimeError, match="out of memory"):
            t.fit(ArrayDataSetIterator(X, Y, 8), epochs=1)
    assert plan.fired[faults.TRAIN_DISPATCH] == 1
    assert plan.calls(faults.TRAIN_DISPATCH) == 2, \
        "no re-attempt after the OOM"
    t.close()


@pytest.mark.parametrize("prefetch", [0, 2])
def test_non_finite_batches_skipped_and_counted(tmp_path, prefetch):
    X, Y = _data(40, nan_at=10)          # batch 2 of 5 is corrupt
    monitoring.enable()
    monitoring.get_registry().clear()
    t = FaultTolerantTrainer(_net(), tmp_path / "nan", save_every=100,
                             prefetch=prefetch)
    t.fit(ArrayDataSetIterator(X, Y, 8), epochs=1)
    assert t.skipped == 1
    c = monitoring.get_registry().get(
        monitoring.RESILIENCE_BATCHES_SKIPPED,
        labels={"reason": "non_finite"})
    assert c is not None and c.value == 1
    for leaf in _params(t.model):
        assert torch.isfinite(leaf).all()
    t.close()


def test_data_fault_skips_one_real_batch(tmp_path):
    X, Y = _data(40)                     # 5 batches of 8
    t = FaultTolerantTrainer(_net(), tmp_path / "df", save_every=100)
    plan = FaultPlan().fail_at(faults.DATA_NEXT, 2)
    with plan:
        t.fit(ArrayDataSetIterator(X, Y, 8), epochs=1)
    assert t.skipped == 1
    assert t.step == 5, "all 5 iterator positions consumed"
    assert t.model._iteration == 4, "4 batches actually trained"
    t.close()


def test_iterator_error_mid_pull_is_skipped_with_prefetch(tmp_path):
    """An iterator that raises a transient error mid-pull loses that
    position; with prefetch on the worker restarts from the base's
    position (`resume_after_error`) and the epoch goes on."""
    X, Y = _data(40)

    class Flaky(ArrayDataSetIterator):
        calls = 0

        def next(self, num=None):
            Flaky.calls += 1
            if Flaky.calls == 3:
                raise TransientError("transient read error")
            return super().next()

    t = FaultTolerantTrainer(_net(), tmp_path / "flaky", save_every=100,
                             prefetch=2)
    t.fit(Flaky(X, Y, 8), epochs=1)
    assert t.skipped == 1
    assert t.model._iteration >= 3
    t.close()


def test_max_skipped_batches_aborts(tmp_path):
    X, Y = _data(40)
    X[:] = np.nan
    t = FaultTolerantTrainer(_net(), tmp_path / "allnan", save_every=100,
                             max_skipped_batches=2)
    with pytest.raises(FatalTrainingError, match="max_skipped_batches"):
        t.fit(ArrayDataSetIterator(X, Y, 8), epochs=1)
    t.close()


def test_checkpointer_close_idempotent_and_error_surfacing(tmp_path):
    ck = ElasticCheckpointer(tmp_path / "ck")
    ck.save(1, {"w": np.ones((2,), np.float32)}, wait=True)
    ck._error = RuntimeError("async save failed on the background thread")
    with pytest.raises(RuntimeError, match="async save failed"):
        ck.save(2, {"w": np.ones((2,), np.float32)})
    ck.close()
    ck.close()       # idempotent


def test_checkpoint_save_fault_site_and_async_write_error(tmp_path):
    ck = ElasticCheckpointer(tmp_path / "ck")
    with FaultPlan().fail_at(faults.CHECKPOINT_SAVE, 1):
        with pytest.raises(InjectedFault):
            ck.save(1, {"w": torch.ones(2)})
    assert ck.all_steps() == []
    # an error on the writer thread surfaces at the next save or close
    def disk_full(*args):
        raise OSError("disk full")
    ck._write = disk_full
    ck.save(2, {"w": torch.ones(2)})
    with pytest.raises(OSError, match="disk full"):
        ck.close()


def test_checkpoint_round_trip_dtypes_and_structure(tmp_path):
    ck = ElasticCheckpointer(tmp_path / "rt", max_to_keep=1)
    tree = {"params": {"0": {"W": torch.randn(3, 4),
                             "b": torch.randn(4).to(torch.bfloat16)}},
            "count": (torch.tensor(5, dtype=torch.int32),),
            "gen": torch.Generator().manual_seed(4).get_state()}
    ck.save(7, tree["params"], opt_state=tree["count"],
            extra={"gen": tree["gen"]}, wait=True)
    like = {"params": tree["params"], "opt_state": tree["count"],
            "extra": {"gen": tree["gen"]}}
    step, got = ck.restore_verified(like=like)
    assert step == 7 and isinstance(got["opt_state"], tuple)
    for (pa, a), (pb, b) in zip(integrity.flatten(like),
                                integrity.flatten(got)):
        assert pa == pb and a.dtype == b.dtype and torch.equal(a, b)
    # the manifest's checksums are the JAX package's over the same bytes
    from deeplearning4j_tpu.resilience import integrity as jint
    w = tree["params"]["0"]["W"]
    assert integrity._leaf_checksum(w) == jint._leaf_checksum(w.numpy())
    with pytest.raises(ValueError, match="do not match"):
        ck.restore(like={"params": tree["params"]})
    ck.close()


def _sharded(compress=False):
    """A functional trainer at one rank: the sharded mode's target."""
    from deeplearning4j_tpu_torch.parallel import (MultiHostTrainer,
                                                   ShardedTrainer)
    from deeplearning4j_tpu_torch.parallel.mesh import DeviceMesh

    def loss_fn(p, batch, gen):
        x = torch.as_tensor(batch["x"])
        return (torch.tanh(x @ p["W1"]) @ p["W2"]).pow(2).mean()

    if compress:
        return MultiHostTrainer(loss_fn, Sgd(0.2), buckets=2,
                                compression_kw={"initial_threshold": 1e-3})
    return ShardedTrainer(loss_fn, Sgd(0.2), DeviceMesh(dp=1))


def _sharded_params():
    r = np.random.default_rng(7)
    return {"W1": r.standard_normal((6, 5)).astype(np.float32) * 0.5,
            "W2": r.standard_normal((5, 2)).astype(np.float32) * 0.5}


def _sharded_batch(step, nan=False):
    x = np.random.default_rng(200 + step).standard_normal(
        (8, 6)).astype(np.float32)
    if nan:
        x[0, 0] = np.nan
    return {"x": x}


@pytest.mark.parametrize("compress", [False, True])
def test_sharded_mode_resume_equals_uninterrupted(tmp_path, compress):
    """FaultTolerantTrainer's sharded mode over ShardedTrainer and over a
    one-rank MultiHostTrainer (encoder state in the checkpoint): a run
    killed after step 7 and resumed from the step-6 save ends bit for bit
    where the uninterrupted 10-step run ends; a NaN host batch is skipped
    (loss None, counted) without touching the state."""
    def run(directory, steps, start=None):
        t = FaultTolerantTrainer(_sharded(compress), directory,
                                 save_every=3)
        p, o = t.resume_or_init_sharded(_sharded_params())
        if start is not None:
            assert t.step == start and t.resumed_step == start
        while t.step < steps:
            p, o, loss = t.fit_batch(p, o, _sharded_batch(t.step), None)
            assert loss is not None
        return t, p, o

    t, want_p, want_o = run(tmp_path / "a", 10)
    t.finalize(want_p, want_o)
    t, p, o = run(tmp_path / "b", 7)
    t.ckpt.wait_until_finished()
    t.close()
    t, p, o = run(tmp_path / "b", 10, start=6)
    for (pa, a), (pb, b) in zip(integrity.flatten({"p": p, "o": o}),
                                integrity.flatten({"p": want_p,
                                                   "o": want_o})):
        assert pa == pb and torch.equal(a, b), pa
    before = {k: v.clone() for k, v in p.items()}
    p, o, loss = t.fit_batch(p, o, _sharded_batch(10, nan=True), None)
    assert loss is None and t.skipped == 1 and t.step == 11
    assert all(torch.equal(before[k], p[k]) for k in p)
    t.finalize(p, o)
    assert t.ckpt.latest_step() == 11


def test_sharded_mode_guardian_rollback_restores_in_place(tmp_path):
    """A NaN window in sharded mode: the guarded step refuses the
    updates, the ladder reaches ROLLBACK, and the newest verified
    generation is written into the live tensors."""
    from deeplearning4j_tpu_torch.parallel import ShardedTrainer
    from deeplearning4j_tpu_torch.parallel.mesh import DeviceMesh

    def loss_fn(p, batch, gen):
        x = batch["x"]
        return (torch.tanh(x @ p["W1"]) @ p["W2"]).pow(2).mean()

    g = TrainingGuardian(check_every=1, warmup_steps=100, max_skips=1,
                         max_lr_retries=0, max_rollbacks=2)
    t = FaultTolerantTrainer(ShardedTrainer(loss_fn, Sgd(0.2),
                                            DeviceMesh(dp=1)),
                             tmp_path / "g", save_every=2, guardian=g)
    p, o = t.resume_or_init_sharded(_sharded_params())
    for step in range(8):
        x = torch.as_tensor(_sharded_batch(step, nan=step in (4, 5))["x"])
        p, o, _ = t.fit_batch(p, o, {"x": x}, None)
    assert g.skipped >= 2 and g.rollbacks == 1
    assert g.last_restored_step == 4
    assert all(torch.isfinite(v).all() for v in p.values())
    t.finalize(p, o)


def test_elastic_trainer_resume_equals_uninterrupted(tmp_path):
    """ElasticTrainer (the sharded trainer's checkpoint loop): a run
    stopped after step 5 resumes from its step-4 save and ends where the
    uninterrupted 8-step run ends, bit for bit."""
    def run(directory, steps):
        e = ElasticTrainer(_sharded(), directory, save_every=2)
        p, o = e.resume_or_init(_sharded_params())
        start = e.step_num
        while e.step_num < steps:
            p, o, _ = e.fit_batch(p, o, _sharded_batch(e.step_num), None)
        return e, p, o, start

    e, want, want_o, start = run(tmp_path / "a", 8)
    assert start == 0
    e.finalize(want, want_o)
    e, p, o, _ = run(tmp_path / "b", 5)
    e.ckpt.wait_until_finished()
    e, p, o, start = run(tmp_path / "b", 8)
    assert start == 4
    for k in want:
        assert torch.equal(p[k], want[k])
    e.finalize(p, o)


def test_graph_trainer_kill_resume_and_guarded_equal(tmp_path):
    """ComputationGraph through the trainer: a kill and resume equals the
    uninterrupted guarded run bit for bit, which equals an unguarded
    plain fit."""
    def graph():
        g = (NeuralNetConfiguration.Builder().seed(5).updater(Sgd(0.1))
             .graphBuilder().addInputs("in")
             .setInputTypes(InputType.feedForward(5))
             .addLayer("d", DenseLayer(nOut=6, activation="tanh"), "in")
             .addLayer("out", OutputLayer(lossFunction="mcxent", nOut=3,
                                          activation="softmax"), "d")
             .setOutputs("out").build())
        return ComputationGraph(g).init(device="cpu")

    X, Y = _data(64)
    plain = graph()
    plain.fit(ArrayDataSetIterator(X, Y, 8), epochs=1)
    ref = FaultTolerantTrainer(graph(), tmp_path / "ref", save_every=3,
                               guardian=TrainingGuardian(check_every=2))
    ref.fit(ArrayDataSetIterator(X, Y, 8))
    _assert_equal(_params(plain), _params(ref.model))
    plan = FaultPlan().fail_at(faults.TRAIN_DISPATCH, 5,
                               exc=lambda s, n: FatalTrainingError("kill"))
    t1 = FaultTolerantTrainer(graph(), tmp_path / "k", save_every=3,
                              guardian=TrainingGuardian(check_every=2))
    with plan:
        with pytest.raises(FatalTrainingError):
            t1.fit(ArrayDataSetIterator(X, Y, 8))
    t2 = FaultTolerantTrainer(graph(), tmp_path / "k", save_every=3,
                              guardian=TrainingGuardian(check_every=2))
    t2.fit(ArrayDataSetIterator(X, Y, 8))
    assert t2.resumed_step == 3
    _assert_equal(_params(ref.model), _params(t2.model))


def test_soak_random_faults_training_always_completes(tmp_path):
    X, Y = _data(64)

    def it():
        return ArrayDataSetIterator(X, Y, 8)   # 8 batches/epoch

    ref_tr = FaultTolerantTrainer(_net(), tmp_path / "ref", save_every=3)
    ref = _params(ref_tr.fit(it(), epochs=2))
    ref_tr.close()
    plan = (FaultPlan(seed=11)
            .probability(faults.TRAIN_DISPATCH, 0.1, max_fires=6)
            .probability(faults.CHECKPOINT_SAVE, 0.1, max_fires=2))
    pol = RetryPolicy(max_attempts=2, initial_backoff=0.0,
                      sleep=lambda s: None)
    final = None
    with plan:
        for _ in range(30):
            t = FaultTolerantTrainer(_net(), tmp_path / "soak",
                                     save_every=3, retry_policy=pol)
            try:
                final = _params(t.fit(it(), epochs=2))
                t.close()
                break
            except Exception:   # noqa: BLE001 — simulated process death
                t.close()
        else:
            pytest.fail("soak never completed in 30 restarts")
    _assert_equal(ref, final)


# -- the ops journal: every guardian and watchdog event kind ----------------
def _kinds():
    return [e["kind"] for e in events.snapshot(last=256)["events"]]


def test_guardian_events_reach_the_journal(tmp_path):
    monitoring.enable()
    g = TrainingGuardian(check_every=1, max_skips=0, max_lr_retries=1,
                         max_rollbacks=1, recovery_checks=1,
                         warmup_steps=10**6, raise_on_divergence=False)
    g.on_step(float("nan"), float("nan"), False)      # → retry
    g.on_step(0.5, 1.0, True)                         # → recovered
    g.on_step(float("nan"), float("nan"), False)      # → retry again
    g.on_step(float("nan"), float("nan"), False)      # → rollback asked
    g.take_action()
    g.note_rollback(3)                                # → rollback done
    g.on_step(float("nan"), float("nan"), False)
    g.on_step(float("nan"), float("nan"), False)      # → diverged
    kinds = _kinds()
    for kind in (events.GUARDIAN_RETRY, events.GUARDIAN_RECOVERED,
                 events.GUARDIAN_ROLLBACK, events.GUARDIAN_DIVERGED):
        assert kind in kinds, kind
    phases = [e["attrs"].get("phase")
              for e in events.snapshot(last=256)["events"]
              if e["kind"] == events.GUARDIAN_ROLLBACK]
    assert phases == ["requested", "restored"]


def test_watchdog_events_reach_the_journal(tmp_path):
    monitoring.enable()
    t = [0.0]
    wd = StallWatchdog(stall_timeout=1.0, poll_interval=3600,
                       dump_dir=str(tmp_path), clock=lambda: t[0])
    wd.arm()
    t[0] = 2.0
    assert wd.check_now()
    wd.beat("multilayer@1")
    kinds = _kinds()
    assert events.WATCHDOG_STALL in kinds
    assert events.WATCHDOG_RECOVERED in kinds
    assert kinds.index(events.WATCHDOG_STALL) < \
        kinds.index(events.WATCHDOG_RECOVERED)


def test_real_watchdog_thread_trips_on_a_sleeping_step(tmp_path):
    """The monitor thread (real clock) trips on a fit step that sleeps
    past the timeout; the report names the stalled thread's stack; the
    next beat clears the latch."""
    wd = StallWatchdog(stall_timeout=0.3, poll_interval=0.05,
                       dump_dir=str(tmp_path)).start()
    net = _net()
    X, Y = _data(24)
    real = net._run_step
    slept = []

    def slow_step(batches, graphs):
        if not slept:
            slept.append(1)
            threading.Event().wait(1.0)
        return real(batches, graphs)
    net._run_step = slow_step
    wd.arm()
    try:
        net.fit(ArrayDataSetIterator(X, Y, 8))
    finally:
        wd.disarm()
        wd.stop()
    assert wd.stall_count == 1 and not wd.stalled
    assert "slow_step" in open(wd.last_report_path).read()


# -- against the JAX package ------------------------------------------------
def test_faulted_run_matches_the_jax_package(tmp_path):
    """The same faulted run in both packages (the parameters carried
    across by nn/convert.py): a NaN batch skipped, a transient dispatch
    fault retried, a kill after batch 7 and a resume from step 5's
    checkpoint. Parameters agree to 1e-5; skip, retry and resume counts
    are equal."""
    import jax

    from deeplearning4j_tpu.datasets.iterators import \
        ArrayDataSetIterator as JIter
    from deeplearning4j_tpu.nn import (DenseLayer as JDense,
                                       InputType as JInputType,
                                       NeuralNetConfiguration as JConf,
                                       OutputLayer as JOut, Sgd as JSgd)
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
    from deeplearning4j_tpu.resilience import FaultPlan as JPlan
    from deeplearning4j_tpu.resilience import RetryPolicy as JRetry
    from deeplearning4j_tpu.resilience import faults as jfaults
    from deeplearning4j_tpu.resilience.errors import \
        FatalTrainingError as JFatal
    from deeplearning4j_tpu.resilience.trainer import \
        FaultTolerantTrainer as JTrainer
    from deeplearning4j_tpu_torch.nn import multilayer_params_from_numpy

    jconf = (JConf.Builder().seed(3).updater(JSgd(0.1)).activation("tanh")
             .list().layer(JDense.Builder().nOut(8).build())
             .layer(JOut.Builder("mcxent").nOut(3)
                    .activation("softmax").build())
             .setInputType(JInputType.feedForward(5)).build())
    init = jax.tree_util.tree_map(np.asarray, JMLN(jconf).init()._params)

    def tnet():
        return multilayer_params_from_numpy(MultiLayerNetwork(_conf()),
                                            init, {}, device="cpu")

    def jnet():
        return JMLN(jconf).init(params=None)

    X, Y = _data(80, nan_at=20)         # batch 3 of 10 is corrupt

    def run(pkg):
        d = tmp_path / pkg
        if pkg == "jax":
            Plan, fs, Tr, It, Pol, Fatal = (JPlan, jfaults, JTrainer, JIter,
                                            JRetry, JFatal)
            make = jnet
        else:
            Plan, fs, Tr, It, Pol, Fatal = (FaultPlan, faults,
                                            FaultTolerantTrainer,
                                            ArrayDataSetIterator,
                                            RetryPolicy, FatalTrainingError)
            make = tnet
        pol = Pol(max_attempts=3, initial_backoff=0.0, sleep=lambda s: None)
        plan = (Plan(seed=2).fail_at(fs.TRAIN_DISPATCH, 4)
                .fail_at(fs.TRAIN_DISPATCH, 8,
                         exc=lambda s, n: Fatal("kill")))
        m1 = make()
        if pkg == "jax":
            m1._params = jax.tree_util.tree_map(jax.numpy.asarray, init)
        t1 = Tr(m1, d, save_every=5, retry_policy=pol, prefetch=0)
        with plan:
            with pytest.raises(Fatal):
                t1.fit(It(X, Y, 8))
        t1.close()
        m2 = make()
        if pkg == "jax":
            m2._params = jax.tree_util.tree_map(jax.numpy.asarray, init)
        t2 = Tr(m2, d, save_every=5, retry_policy=pol, prefetch=0)
        t2.fit(It(X, Y, 8))
        t2.close()
        return m2, t1, t2, plan.fired[fs.TRAIN_DISPATCH]

    jm, jt1, jt2, jfired = run("jax")
    tm, tt1, tt2, tfired = run("torch")
    assert tfired == jfired == 2 and tt1.retries == 1
    assert (tt1.skipped, tt2.skipped) == (jt1.skipped, jt2.skipped)
    assert tt2.resumed_step == jt2.resumed_step == 5
    assert tm._iteration == jm._iteration
    for key in ("0", "1"):
        for name in ("W", "b"):
            np.testing.assert_allclose(
                tm._params[key][name].numpy(),
                np.asarray(jm._params[key][name]), rtol=1e-5, atol=1e-5)
