"""The port's resilience pieces (deeplearning4j_tpu_torch/resilience/ and
util/crash_reporting.py) on the CPU: `FaultPlan`, `RetryPolicy`,
`default_classifier`, `CircuitBreaker`'s monitoring hook, `is_oom` (which
must read torch's "CUDA out of memory") and the crash dump over a tree of
tensors — the contracts of the JAX package's tests/test_resilience.py —
plus parity with the JAX package: the same seeded plan fires at the same
calls, and the same policy sleeps the same backoff sequence."""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import resilience as jres
from deeplearning4j_tpu.resilience import faults as jfaults
from deeplearning4j_tpu.resilience.policy import RetryPolicy as JaxRetry
from deeplearning4j_tpu.util.crash_reporting import \
    CrashReportingUtil as JaxCrash
from deeplearning4j_tpu_torch import monitoring, resilience
from deeplearning4j_tpu_torch.resilience import (
    CircuitBreaker, CircuitOpenError, FatalTrainingError, FaultPlan,
    InferenceTimeoutError, InjectedFault, MemoryPressureError,
    PeerLostError, PreemptionSignal, RetryExhaustedError, RetryPolicy,
    TransientError, default_classifier, faults)
from deeplearning4j_tpu_torch.resilience.errors import PagePoolExhaustedError
from deeplearning4j_tpu_torch.util.crash_reporting import (
    CrashReportingUtil, with_crash_dump)


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    yield
    faults.clear_plan()
    jfaults.clear_plan()
    monitoring.disable()


# ===================== RetryPolicy ========================================
def test_retry_recovers_from_transient():
    slept = []
    pol = RetryPolicy(max_attempts=4, initial_backoff=0.01, jitter=0.0,
                      sleep=slept.append)
    n = [0]

    def flaky():
        n[0] += 1
        if n[0] < 3:
            raise TransientError("blip")
        return "ok"

    assert pol.call(flaky) == "ok"
    assert n[0] == 3
    np.testing.assert_allclose(slept, [0.01, 0.02])


def test_retry_never_retries_oom():
    pol = RetryPolicy(max_attempts=5, initial_backoff=0.0,
                      sleep=lambda s: None)
    n = [0]

    def oom():
        n[0] += 1
        raise torch.cuda.OutOfMemoryError(
            "CUDA out of memory. Tried to allocate 2.00 GiB")

    with pytest.raises(torch.cuda.OutOfMemoryError):
        pol.call(oom)
    assert n[0] == 1, "OOM must fail fast, not burn retry budget"


def test_retry_budget_exhaustion_is_typed():
    pol = RetryPolicy(max_attempts=3, initial_backoff=0.0,
                      sleep=lambda s: None)

    def always():
        raise TransientError("down")

    with pytest.raises(RetryExhaustedError) as ei:
        pol.call(always)
    assert ei.value.attempts == 3
    assert isinstance(ei.value.last_error, TransientError)


def test_retry_non_retryable_propagates_untouched_and_on_retry_runs():
    seen = []
    pol = RetryPolicy(max_attempts=4, initial_backoff=0.0,
                      sleep=lambda s: None)
    n = [0]

    def flaky():
        n[0] += 1
        if n[0] == 1:
            raise TransientError("blip")
        raise ValueError("a bug, not a blip")

    with pytest.raises(ValueError, match="a bug"):
        pol.call(flaky, on_retry=lambda a, e: seen.append((a, type(e))))
    assert seen == [(1, TransientError)]


def test_retry_deadline_budget():
    t = [0.0]
    pol = RetryPolicy(max_attempts=100, initial_backoff=1.0, jitter=0.0,
                      deadline=2.5,
                      sleep=lambda s: t.__setitem__(0, t[0] + s),
                      clock=lambda: t[0])

    def always():
        raise TransientError("down")

    with pytest.raises(RetryExhaustedError, match="deadline"):
        pol.call(always)
    assert t[0] <= 2.5


def test_retry_jitter_deterministic():
    a = RetryPolicy(seed=42, jitter=0.5)
    b = RetryPolicy(seed=42, jitter=0.5)
    schedule = [a.backoff(i) for i in range(1, 6)]
    assert schedule == [b.backoff(i) for i in range(1, 6)]
    c = RetryPolicy(seed=43, jitter=0.5)
    assert schedule != [c.backoff(i) for i in range(1, 6)]


@pytest.mark.parametrize("knobs", [
    dict(seed=0),
    dict(seed=7, jitter=0.5, initial_backoff=0.02, multiplier=3.0),
    dict(seed=123, jitter=0.25, initial_backoff=0.1, max_backoff=0.4),
], ids=["default", "wide-jitter", "capped"])
def test_backoff_sequence_equals_the_jax_packages(knobs):
    """Parity: the same policy sleeps the same backoffs, attempt by
    attempt, in both packages — through `call` as well as `backoff`."""
    ours, theirs = RetryPolicy(**knobs), JaxRetry(**knobs)
    assert [ours.backoff(i) for i in range(1, 12)] == \
        [theirs.backoff(i) for i in range(1, 12)]
    slept = {"port": [], "jax": []}
    for name, cls, err in (("port", RetryPolicy, TransientError),
                           ("jax", JaxRetry, jres.TransientError)):
        pol = cls(max_attempts=6, sleep=slept[name].append, **knobs)
        with pytest.raises(Exception) as ei:
            pol.call(lambda: (_ for _ in ()).throw(err("x")))
        assert type(ei.value).__name__ == "RetryExhaustedError"
    assert slept["port"] == slept["jax"] and len(slept["port"]) == 5


# ===================== default_classifier =================================
@pytest.mark.parametrize("exc,retry", [
    (TransientError("blip"), True),
    (InjectedFault("injected"), True),
    (RuntimeError("UNAVAILABLE: socket closed"), True),
    (ConnectionError("Connection reset by peer"), True),
    (RuntimeError("request timed out"), True),
    (RuntimeError("RESOURCE_EXHAUSTED: try again"), False),
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate"),
     False),
    (PagePoolExhaustedError("RESOURCE_EXHAUSTED: no free KV pages"), False),
    (FatalTrainingError("preempted"), False),
    (RetryExhaustedError("gave up"), False),
    (InferenceTimeoutError("deadline timed out"), False),
    (PeerLostError("peer timed out"), False),
    (PreemptionSignal("preempted"), False),
    (ValueError("shape mismatch"), False),
], ids=lambda v: type(v).__name__ if isinstance(v, BaseException)
    else str(v))
def test_default_classifier_agrees_with_the_jax_package(exc, retry):
    """Typed verdicts win over messages, OOM over everything; the JAX
    package's classifier gives the same verdict on the same message."""
    from deeplearning4j_tpu.resilience.policy import \
        default_classifier as jax_classifier
    assert default_classifier(exc) is retry
    twin = getattr(jres, type(exc).__name__, None)
    probe = twin(str(exc)) if twin is not None else exc
    assert jax_classifier(probe) is retry


# ===================== CircuitBreaker =====================================
def test_breaker_opens_and_half_opens_on_schedule():
    t = [0.0]
    br = CircuitBreaker(failure_threshold=3, cooldown=10.0,
                        clock=lambda: t[0])
    for _ in range(2):
        br.record_failure()
    assert br.state == CircuitBreaker.CLOSED
    br.record_failure()
    assert br.state == CircuitBreaker.OPEN
    assert not br.allow()
    t[0] = 10.0
    assert br.state == CircuitBreaker.HALF_OPEN
    assert br.allow() and not br.allow()
    br.record_failure()
    assert br.state == CircuitBreaker.OPEN
    t[0] = 20.1
    assert br.allow()
    br.record_success()
    assert br.state == CircuitBreaker.CLOSED


def test_breaker_call_sheds_with_typed_error():
    t = [0.0]
    br = CircuitBreaker(failure_threshold=1, cooldown=5.0,
                        clock=lambda: t[0])
    with pytest.raises(ValueError):
        br.call(lambda: (_ for _ in ()).throw(ValueError("x")))
    with pytest.raises(CircuitOpenError):
        br.call(lambda: "never runs")
    t[0] = 5.0
    assert br.call(lambda: "probe ok") == "probe ok"


def test_resilience_metrics_observable():
    """Retries and trips land on dl4j.resilience.*; disabled monitoring
    allocates no metric."""
    reg = monitoring.get_registry()
    monitoring.enable()
    retries0 = reg.counter(monitoring.RESILIENCE_RETRIES).value
    pol = RetryPolicy(max_attempts=2, initial_backoff=0.0,
                      sleep=lambda s: None)
    with pytest.raises(RetryExhaustedError):
        pol.call(lambda: (_ for _ in ()).throw(TransientError("x")))
    br = CircuitBreaker(failure_threshold=1, cooldown=1.0,
                        name="port-test-breaker")
    br.record_failure()
    assert reg.get(monitoring.RESILIENCE_RETRIES).value - retries0 == 1
    assert reg.get(monitoring.RESILIENCE_BREAKER_TRIPS,
                   labels={"breaker": "port-test-breaker"}).value == 1
    assert "dl4j_resilience_retries" in reg.prometheus_text()
    monitoring.disable()
    CircuitBreaker(failure_threshold=1, name="never-counted") \
        .record_failure()
    assert reg.get(monitoring.RESILIENCE_BREAKER_TRIPS,
                   labels={"breaker": "never-counted"}) is None


# ===================== FaultPlan ==========================================
def _hits(plan, site, n, exc_type=InjectedFault):
    hits = []
    for i in range(1, n + 1):
        try:
            plan.fire(site)
        except exc_type:
            hits.append(i)
    return hits


def test_fault_plan_schedules_are_deterministic():
    plan = (FaultPlan(seed=5)
            .fail_at("site.a", 3)
            .every("site.b", 2, max_fires=2)
            .probability("site.c", 0.5))
    assert _hits(plan, "site.a", 6) == [3]
    assert _hits(plan, "site.b", 8) == [2, 4]
    prob = _hits(plan, "site.c", 20)
    plan2 = FaultPlan(seed=5).probability("site.c", 0.5)
    assert _hits(plan2, "site.c", 20) == prob
    assert plan.calls("site.a") == 6
    assert plan.fired == {"site.a": 1, "site.b": 2, "site.c": len(prob)}


def test_fault_plan_installs_one_global_hook_and_custom_errors():
    assert faults.ACTIVE is None
    oom = MemoryPressureError("RESOURCE_EXHAUSTED: injected")
    with FaultPlan(seed=1).fail_at(faults.CACHE_GROW, 1, exc=oom) as plan:
        assert faults.ACTIVE is plan
        with pytest.raises(MemoryPressureError):
            faults.ACTIVE.fire(faults.CACHE_GROW)
        faults.ACTIVE.fire(faults.CACHE_GROW)           # call 2: quiet
    assert faults.ACTIVE is None
    made = []
    plan = FaultPlan().every(faults.GENERATION_ADMIT, 2,
                             exc=lambda site, n: made.append(n)
                             or RuntimeError(f"{site}#{n}"))
    assert _hits(plan, faults.GENERATION_ADMIT, 6, RuntimeError) == [2, 4,
                                                                   6]
    assert made == [2, 4, 6]


@pytest.mark.parametrize("seed", [0, 5, 2026])
def test_seeded_plan_fires_at_the_same_calls_as_the_jax_packages(seed):
    """Parity: one seeded plan over the serving sites fires at the same
    calls in both packages."""
    def build(mod):
        return (mod.FaultPlan(seed=seed)
                .fail_at(mod.GENERATION_STEP, 4)
                .every(mod.GENERATION_SUPERSTEP, 3, max_fires=3)
                .probability(mod.GENERATION_ADMIT, 0.3)
                .probability(mod.CACHE_PAGE, 0.1, max_fires=2)
                .fail_at(mod.CACHE_GROW, 2))

    ours, theirs = build(faults), build(jfaults)
    for site in (faults.GENERATION_STEP, faults.GENERATION_SUPERSTEP,
                 faults.GENERATION_ADMIT, faults.CACHE_PAGE,
                 faults.CACHE_GROW):
        assert getattr(jfaults, [k for k in faults.__all__
                                 if getattr(faults, k, None) == site][0]
                       ) == site
        got = _hits(ours, site, 40, Exception)
        want = _hits(theirs, site, 40, Exception)
        assert got == want, site
    assert ours.fired == theirs.fired


def test_fault_sites_and_exports_match_the_jax_package():
    names = [n for n in jfaults.__all__ if n.isupper() and n != "ACTIVE"
             and n != "PROCESS_ID"]
    for n in names:
        assert getattr(faults, n) == getattr(jfaults, n), n
    # the training half (TrainingGuardian, StallWatchdog,
    # FaultTolerantTrainer) is ported too: the exports are the same
    assert set(resilience.__all__) == set(jres.__all__)
    assert resilience.TrainingGuardian.__module__.endswith(".guardian")


def test_fault_injection_counts_and_emits_when_monitoring_is_on():
    from deeplearning4j_tpu_torch.monitoring import events as ev
    ev.reset()
    reg = monitoring.get_registry()
    monitoring.enable()
    plan = FaultPlan(seed=3).fail_at(faults.GENERATION_STEP, 2)
    with plan:
        plan.fire(faults.GENERATION_STEP)
        with pytest.raises(InjectedFault):
            plan.fire(faults.GENERATION_STEP)
    evs = ev.snapshot(last=None)["events"]
    assert [e["kind"] for e in evs] == [ev.FAULT_INJECTED]
    assert evs[0]["attrs"]["site"] == faults.GENERATION_STEP
    assert evs[0]["attrs"]["call"] == 2
    assert reg.get(monitoring.RESILIENCE_FAULTS_INJECTED,
                   labels={"site": faults.GENERATION_STEP}).value >= 1
    ev.reset()


# ===================== is_oom and the crash dump ==========================
@pytest.mark.parametrize("exc,oom", [
    (torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 20.00 GiB. GPU 0 has a "
        "total capacity of 79.10 GiB of which 1.2 GiB is free."), True),
    (RuntimeError("RESOURCE_EXHAUSTED: out of memory"), True),
    (PagePoolExhaustedError("RESOURCE_EXHAUSTED: no free KV pages"), True),
    (MemoryError("failed to allocate 4096 bytes"), True),
    (RuntimeError("OOM while growing the cache"), True),
    (ValueError("tensor BLOOM_head has the wrong shape"), False),
    (RuntimeError("CUDA error: an illegal memory access"), False),
], ids=["torch-cuda-oom", "xla", "page-pool", "alloc", "word-oom",
        "bloom", "illegal-address"])
def test_is_oom_keeps_the_jax_packages_pattern(exc, oom):
    assert CrashReportingUtil.is_oom(exc) is oom
    assert JaxCrash.is_oom(exc) is oom


class _Model:
    """A tree of tensors shaped like the port's nets: dicts of dicts,
    lists of dicts."""

    def __init__(self):
        self._params = {
            "embeddings": {"word": torch.zeros(10, 4),
                           "position": torch.zeros(6, 4)},
            "layers": [{"W": torch.zeros(4, 4)}, {"W": torch.zeros(4, 4)}]}
        self._opt_state = [torch.zeros(4, dtype=torch.float64)]


def test_crash_dump_walks_tensor_trees_and_embeds_monitoring(tmp_path):
    monitoring.enable()
    monitoring.get_registry().counter(
        monitoring.RESILIENCE_RETRIES, help="x").inc(3)
    exc = torch.cuda.OutOfMemoryError("CUDA out of memory.")
    path = CrashReportingUtil.writeMemoryCrashDump(
        _Model(), exc, path=str(tmp_path / "dump.txt"))
    text = open(path).read()
    assert "OutOfMemoryError: CUDA out of memory." in text
    assert "embeddings: 256 bytes" in text             # (10 + 6) x 4 x 4
    assert "layers: 128 bytes" in text
    assert "TOTAL params: 384 bytes" in text
    assert "updater state: 32 bytes" in text
    assert "(no CUDA device)" in text or "Device cuda:0" in text
    assert "Monitoring at crash time" in text
    assert "dl4j.resilience.retries" in text
    assert "Mitigations (CUDA)" in text


def test_maybe_dump_only_on_oom_once_and_never_masks(tmp_path):
    CrashReportingUtil.crashDumpOutputDirectory(str(tmp_path))
    try:
        assert CrashReportingUtil.maybe_dump(
            _Model(), ValueError("shape")) is None
        exc = torch.cuda.OutOfMemoryError("CUDA out of memory.")
        path = CrashReportingUtil.maybe_dump(_Model(), exc)
        assert path is not None and path.startswith(str(tmp_path))
        assert CrashReportingUtil.maybe_dump(_Model(), exc) is None

        class Net(_Model):
            @with_crash_dump
            def fit(self):
                raise torch.cuda.OutOfMemoryError("CUDA out of memory.")

        with pytest.raises(torch.cuda.OutOfMemoryError):
            Net().fit()
        assert len(list(tmp_path.glob("dl4j-torch-memory-crash-dump-*"))) \
            == 2
    finally:
        CrashReportingUtil.crashDumpOutputDirectory(".")


def test_health_snapshot_reports_serving_and_none_for_later_slices():
    snap = resilience.health_snapshot()
    assert set(snap) == {"status", "guardian", "watchdog", "distributed",
                         "serving", "fleet", "slo"}
    assert snap["status"] in ("ok", "degraded", "serving_dead")
    for later in ("guardian", "watchdog", "distributed"):
        assert snap[later] is None
    # the fleet section came with the FleetRouter: one compact state per
    # live router (tests/test_torch_fleet*.py drive it), read from
    # sys.modules like the serving section
    import sys
    if "deeplearning4j_tpu_torch.generation.fleet" in sys.modules:
        assert isinstance(snap["fleet"], list)
        assert all(f["state"] in ("serving", "degraded", "dead")
                   for f in snap["fleet"])
    else:
        assert snap["fleet"] is None
