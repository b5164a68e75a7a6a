"""Serving chaos on the port's GenerationServer (deeplearning4j_tpu_torch/
generation/server.py) at bert_tiny on the CPU: the generation contracts of
the JAX package's tests/test_serving_chaos.py, held on `BertDecoder`.

The invariants every scenario asserts:
- no request hangs — every accepted request resolves or fails with a
  TYPED error within its timeout;
- completed token streams equal the fault-free run's token for token
  (per-slot rng keys make streams pure functions of admission state, so
  crash-replay continues them exactly);
- recovery adds no key to the warm store and captures nothing;
- a dead server pushes its typed error to every open stream at once.

And the slice against the JAX package: under a `FaultPlan` that kills two
decode blocks and one admission, the port's server delivers the JAX
server's fault-free streams for the same parameters (carried across with
`params_from_numpy`) and seed, greedy and sampled, dense and paged; and
the replay key advance equals JAX's iterated `split_keys` bit for bit.
"""
import random
import threading
import time

import numpy as np
import pytest

import jax

from deeplearning4j_tpu.generation import BertDecoder as JaxDecoder
from deeplearning4j_tpu.generation import GenerationServer as JaxServer
from deeplearning4j_tpu.generation.sampling import split_keys as jax_split
from deeplearning4j_tpu.models import bert as jb
from deeplearning4j_tpu_torch import monitoring as mon
from deeplearning4j_tpu_torch.generation import (BertDecoder,
                                                 GenerationRequest,
                                                 GenerationServer)
from deeplearning4j_tpu_torch.generation import server as gsrv
from deeplearning4j_tpu_torch.generation.sampling import method_id
from deeplearning4j_tpu_torch.models import bert as tb
from deeplearning4j_tpu_torch.models.convert import params_from_numpy
from deeplearning4j_tpu_torch.monitoring import events as ev
from deeplearning4j_tpu_torch.monitoring import memory as memmod
from deeplearning4j_tpu_torch.monitoring import requests as reqmod
from deeplearning4j_tpu_torch.resilience import faults, health_snapshot
from deeplearning4j_tpu_torch.resilience.errors import (
    MemoryPressureError, PagePoolExhaustedError, ReplayDivergedError,
    ServerDeadError)
from deeplearning4j_tpu_torch.resilience.policy import RetryPolicy


@pytest.fixture(autouse=True)
def _clean_harness():
    faults.clear_plan()
    yield
    faults.clear_plan()
    mon.disable()


@pytest.fixture(scope="module")
def bert():
    cfg = jb.bert_tiny()
    jp = jb.init_bert_params(cfg, jax.random.PRNGKey(1))
    tcfg = tb.bert_tiny()
    tp = params_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return cfg, jp, tcfg, tp


def _server(bert, paged=False, pool_pages=40, **kw):
    """The reference file's `_bert_server` / `_bert_paged_server`."""
    _, _, tcfg, tp = bert
    dkw = dict(page_size=8, pool_pages=pool_pages) if paged else {}
    kw.setdefault("slots", 2)
    kw.setdefault("cache_lengths", [16, 32])
    kw.setdefault("prompt_buckets", [8])
    kw.setdefault("method", "greedy")
    kw.setdefault("seed", 11)
    srv = GenerationServer(BertDecoder(tcfg, tp, **dkw), **kw)
    srv.warmup()
    return srv


#: the 4-request soak workload: mixed prompt lengths, budgets and
#: sampling configs (temperature/top-k requests prove the rng stream
#: survives replay, not just greedy argmax)
_WORKLOAD = [
    dict(prompt=[1, 4, 2], max_new_tokens=8),
    dict(prompt=[5, 6], max_new_tokens=8, method="temperature",
         temperature=0.8),
    dict(prompt=[7, 3, 2, 1, 4, 6], max_new_tokens=12, method="top_k",
         temperature=0.9, top_k=3),
    dict(prompt=[2, 2, 5], max_new_tokens=6),
]


def _run_workload(srv, workload=_WORKLOAD, timeout=60):
    """Submit the workload, consume every request through a streaming
    consumer THREAD (the production shape), return the token lists."""
    reqs = [srv.submit(**dict(w)) for w in workload]
    out = [None] * len(reqs)
    errs = [None] * len(reqs)

    def consume(i, req):
        try:
            out[i] = list(req.stream(timeout=timeout))
        except Exception as e:  # noqa: BLE001 — asserted by callers
            errs[i] = e

    threads = [threading.Thread(target=consume, args=(i, r))
               for i, r in enumerate(reqs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout + 10)
        assert not t.is_alive(), "stream consumer hung"
    return reqs, out, errs


def _store_keys(srv):
    st = srv._store.stats
    return (len(srv._store), st["compiled"], st["captures"],
            st["live_captures"], st["rebinds"])


@pytest.fixture(scope="module")
def want_streams(bert):
    """Fault-free streams of the soak workload on the port (superstep 1),
    shared by every token-identity scenario."""
    srv = _server(bert)
    try:
        _, want, errs = _run_workload(srv)
        assert errs == [None] * 4
        return want
    finally:
        srv.shutdown()


@pytest.fixture(scope="module")
def jax_streams(bert):
    """The JAX server's fault-free streams of the soak workload."""
    cfg, jp, _, _ = bert
    srv = JaxServer(JaxDecoder(cfg, jp), slots=2, cache_lengths=[16, 32],
                    prompt_buckets=[8], method="greedy", seed=11,
                    superstep=4)
    srv.warmup()
    try:
        reqs = [srv.submit(**dict(w)) for w in _WORKLOAD]
        return [r.result(timeout=120) for r in reqs]
    finally:
        srv.shutdown()


# ===================== the slice against the JAX package ================
@pytest.mark.parametrize("knobs,site", [
    (dict(superstep=1), faults.GENERATION_STEP),
    (dict(superstep=4), faults.GENERATION_SUPERSTEP),
    (dict(superstep=2, paged=True), faults.GENERATION_SUPERSTEP),
    (dict(draft=2), faults.GENERATION_SUPERSTEP),
], ids=["dense-k1", "dense-k4", "paged-k2", "draft2"])
def test_chaos_streams_equal_the_jax_servers_fault_free_streams(
        bert, jax_streams, knobs, site):
    """ACCEPTANCE: two decode-block kills and one admission kill; every
    stream equals the JAX server's fault-free stream, greedy and
    sampled; recovery adds nothing to the store; each fetch is a block,
    an admission or a replay, and a block in flight at a kill is
    dropped, never delivered."""
    srv = _server(bert, **knobs)
    try:
        keys0 = _store_keys(srv)
        plan = (faults.FaultPlan(seed=9)
                .fail_at(site, 2)
                .fail_at(site, 5)
                .fail_at(faults.GENERATION_ADMIT, 3))
        with plan:
            _, got, errs = _run_workload(srv)
        assert plan.fired == {site: 2, faults.GENERATION_ADMIT: 1}
        assert errs == [None] * 4
        assert got == jax_streams
        state = srv.serving_state()["state"]
        srv.shutdown()      # delivers the block in flight: fetches balance
        st = srv.status()
        assert st["replays"] >= 2 and st["errors"] >= 2
        assert _store_keys(srv) == keys0
        assert st["token_fetches"] == (st["steps"] + st["admissions"]
                                       + st["replays"])
        assert 1 <= st["blocks_dropped"] <= 2
        assert state == "serving"
    finally:
        srv.shutdown()


def test_advance_key_equals_jax_iterated_split_bit_for_bit(bert):
    """`_advance_key(key, n)` is n applications of `split_keys(k)[0]` —
    the JAX server's ("advance_key_n",) `fori_loop` — for n in 0..600,
    on the host (no device work, no store call)."""
    srv = _server(bert)
    try:
        step = jax.jit(lambda k: jax_split(k[None])[0][0])
        for admit_id in (1, 7):
            key = srv._admit_key(admit_id)
            k = jax.numpy.asarray(key)
            want = [np.asarray(k)]
            for _ in range(600):
                k = step(k)
                want.append(np.asarray(k))
            for n in range(601):
                got = srv._advance_key(key, n)
                assert got.dtype == np.uint32
                np.testing.assert_array_equal(got, want[n], err_msg=str(n))
        st = srv._store.stats
        assert srv.status()["key_advances"] == 2 * 601
        assert st["eager_calls"] == 0
        assert ("advance_key_n",) in srv.executable_keys()
        assert ("advance_key_n",) not in srv._store
    finally:
        srv.shutdown()


# ===================== crash-replay ====================================
def test_chaos_decode_kill_streams_bit_identical(bert, want_streams):
    """Kill the decode loop at a seeded step with 4 concurrent streaming
    requests: every stream completes identical to the fault-free run and
    `dl4j.gen.replays` counts the re-admissions."""
    kill_step = random.Random(20260804).randint(3, 9)
    srv = _server(bert)
    try:
        mon.enable()
        replays0 = mon.get_registry().counter(mon.GEN_REPLAYS).value
        plan = faults.FaultPlan(seed=5).fail_at(faults.GENERATION_STEP,
                                                kill_step)
        with plan:
            _, got, errs = _run_workload(srv)
        assert plan.fired.get(faults.GENERATION_STEP) == 1
        assert errs == [None] * 4
        assert got == want_streams
        assert srv.stats["replays"] >= 1
        assert mon.get_registry().counter(mon.GEN_REPLAYS).value \
            - replays0 == srv.stats["replays"]
        assert srv.stats["errors"] == 1
        # the server is healthy again: a fresh request serves normally
        assert len(srv.generate([3, 1], max_new_tokens=3,
                                timeout=60)) == 3
    finally:
        srv.shutdown()


def test_chaos_double_kill_and_admission_faults(bert, want_streams):
    srv = _server(bert)
    try:
        plan = (faults.FaultPlan(seed=9)
                .fail_at(faults.GENERATION_ADMIT, 2)
                .fail_at(faults.GENERATION_STEP, 4)
                .fail_at(faults.GENERATION_STEP, 11))
        with plan:
            _, got, errs = _run_workload(srv)
        assert errs == [None] * 4
        assert got == want_streams
        assert srv.stats["replays"] >= 2
        assert srv.stats["errors"] >= 2
    finally:
        srv.shutdown()


def test_chaos_kill_mid_superstep_streams_bit_identical(bert,
                                                        want_streams):
    """Kills mid-SUPERSTEP (k=4: the block in flight dies undelivered) at
    two points; streams equal the fault-free run and recovery adds no
    key. One fetch per block still amortizes the batch."""
    srv = _server(bert, superstep=4)
    try:
        keys0 = _store_keys(srv)
        plan = (faults.FaultPlan(seed=17)
                .fail_at(faults.GENERATION_SUPERSTEP, 2)
                .fail_at(faults.GENERATION_SUPERSTEP, 4))
        with plan:
            _, got, errs = _run_workload(srv)
        assert plan.fired.get(faults.GENERATION_SUPERSTEP) == 2
        assert errs == [None] * 4
        assert got == want_streams
        assert srv.stats["replays"] >= 1
        assert srv.stats["errors"] >= 2
        assert _store_keys(srv) == keys0
        assert srv.stats["supersteps"] > 0
    finally:
        srv.shutdown()


@pytest.mark.parametrize("buckets,mode", [([8, 16], "prefix"),
                                          ([8], "regenerate")])
def test_replay_modes_prefix_and_regenerate(bert, buckets, mode):
    """A prefix that fits a prompt bucket replays by re-prefill with the
    advanced key; one that does not regenerates with delivery suppressed.
    Both continue the stream exactly (slots=1: admission ids are
    deterministic)."""
    w = [dict(prompt=[1, 4, 2, 9, 9, 3, 5], max_new_tokens=8,
              method="temperature", temperature=0.8)]
    base = _server(bert, slots=1, prompt_buckets=buckets)
    try:
        _, want, _ = _run_workload(base, w)
    finally:
        base.shutdown()
    srv = _server(bert, slots=1, prompt_buckets=buckets)
    try:
        mon.enable()
        ev.reset()
        with faults.FaultPlan(seed=2).fail_at(faults.GENERATION_STEP, 4):
            _, got, errs = _run_workload(srv, w)
        assert errs == [None] and got == want
        replays = [e["attrs"] for e in ev.snapshot(last=None)["events"]
                   if e["kind"] == ev.SERVER_REPLAY]
        assert replays and {r["mode"] for r in replays} == {mode}
        assert all(r["delivered"] > 0 for r in replays)
        if mode == "prefix":
            assert srv.key_advances == len(replays)
    finally:
        srv.shutdown()
        ev.reset()


def test_regenerated_token_that_diverges_fails_typed(bert):
    """The regenerate path checks every suppressed token against the
    journal: a mismatch fails the request with ReplayDivergedError (a
    prompt bucket of 4 leaves no room for a prefix re-prefill)."""
    srv = _server(bert, slots=1, prompt_buckets=[4])
    try:
        req = GenerationRequest(np.array([1, 4, 2], np.int32), 6, None,
                                method_id("greedy"), 1.0, 0)
        want = srv.generate([1, 4, 2], max_new_tokens=6, timeout=60)
        req.tokens = [want[0], want[1] + 1]   # a journal the model denies
        srv.adopt(req, admit_id=1)
        with pytest.raises(ReplayDivergedError):
            req.result(timeout=60)
        # and the server serves on
        assert len(srv.generate([3, 1], max_new_tokens=3,
                                timeout=60)) == 3
    finally:
        srv.shutdown()


def test_adopt_continues_a_stream_under_an_explicit_id(bert, jax_streams):
    """`adopt(req, admit_id)`: a fresh record admits like a submission
    under its id; one carrying a delivered prefix (a replica that died
    mid-stream) continues without re-delivering; one whose prefix is
    already complete only finishes."""
    srv = _server(bert)
    try:
        spec = _WORKLOAD[1]                 # admission id 2, sampled

        def request():
            return GenerationRequest(
                np.asarray(spec["prompt"], np.int32),
                spec["max_new_tokens"], None, method_id(spec["method"]),
                spec["temperature"], 0)

        fresh = srv.adopt(request(), admit_id=2)
        assert fresh.result(timeout=60) == jax_streams[1]
        mid, seen = request(), []
        mid.tokens = list(jax_streams[1][:3])
        mid.on_token = seen.append
        srv.adopt(mid, admit_id=2)
        assert mid.result(timeout=60) == jax_streams[1]
        assert seen == jax_streams[1][3:]   # nothing delivered twice
        done = request()
        done.tokens = list(jax_streams[1])
        srv.adopt(done, admit_id=2)
        assert done.result(timeout=60) == jax_streams[1]
        assert done.finish_reason == "length"
        with pytest.raises(ValueError, match="top cache rung"):
            srv.adopt(GenerationRequest(np.array([1], np.int32), 40, None,
                                        0, 1.0, 0), admit_id=9)
    finally:
        srv.shutdown()


def test_chaos_killed_request_timeline_full_lifecycle(bert, want_streams):
    """A decode kill mid-stream at superstep 4 leaves every request with a
    finished timeline: enqueue → admit → blocks → replay → re-admit →
    more blocks → retire, while the streams stay identical."""
    srv = _server(bert, superstep=4)
    try:
        mon.enable()
        reqmod.log().clear()
        plan = faults.FaultPlan(seed=17).fail_at(
            faults.GENERATION_SUPERSTEP, 2)
        with plan:
            reqs, got, errs = _run_workload(srv)
        assert plan.fired.get(faults.GENERATION_SUPERSTEP) == 1
        assert errs == [None] * 4
        assert got == want_streams
        replayed = 0
        for req, toks in zip(reqs, got):
            assert req.trace_id is not None
            tl = reqmod.log().get(req.trace_id)
            assert tl is not None and tl.status == req.finish_reason
            names = [e["event"] for e in tl.events]
            assert names[0] == "enqueue"
            assert "admit" in names and names[-1] == "retire"
            assert names.count("block") >= 1
            retire = next(e for e in tl.events if e["event"] == "retire")
            assert retire["tokens"] == len(toks)
            if "replay" in names:
                replayed += 1
                i_replay = names.index("replay")
                assert "admit" in names[i_replay:]
                i_readmit = i_replay + names[i_replay:].index("admit")
                assert "block" in names[i_readmit:]
        assert replayed >= 1
        window = mon.get_registry().get(
            mon.GEN_PER_TOKEN_MS).exemplars(top=64)
        assert {r.trace_id for r in reqs} & {e["trace_id"] for e in window}
    finally:
        srv.shutdown()
        reqmod.log().clear()


def test_chaos_decode_kill_yields_one_resolved_incident(bert):
    """The events of a kill form one incident: server.disrupted →
    server.replay* → server.recovered, after the fault's own marker."""
    srv = _server(bert)
    try:
        mon.enable()
        ev.reset()
        with faults.FaultPlan(seed=5).fail_at(faults.GENERATION_STEP, 4):
            _, out, errs = _run_workload(srv, _WORKLOAD[:2])
        assert errs == [None, None]
        inc = ev.incidents()
        assert inc["open"] == [] and inc["resolved_total"] == 1
        kinds = inc["recent"][0]["kinds"]
        assert kinds[0] == ev.SERVER_DISRUPTED
        assert kinds[-1] == ev.SERVER_RECOVERED
        assert ev.SERVER_REPLAY in kinds
        served = [e["kind"] for e in ev.snapshot(last=None)["events"]]
        assert served == [ev.FAULT_INJECTED] + kinds
    finally:
        srv.shutdown()
        ev.reset()


def test_submit_rejection_status_not_mislabeled_as_shed(bert):
    srv = _server(bert)
    try:
        mon.enable()
        reqmod.log().clear()
        srv.shutdown()
        with pytest.raises(RuntimeError):
            srv.submit(prompt=[1, 2], max_new_tokens=2)
        rec = reqmod.log().snapshot()["recent"][-1]
        assert rec["status"] == "rejected"
        assert rec["events"][-1]["event"] == "rejected"
        assert rec["events"][-1]["error"] == "RuntimeError"
    finally:
        srv.shutdown()
        reqmod.log().clear()


def test_supervised_restart_from_warm_store_zero_compiles(bert):
    """A recovery failure (the replay admission itself faults) triggers a
    supervised restart from the warm store — no new key, no capture —
    and the stream is still identical. slots=1: admission 1 is the fresh
    request and admission 2 is the replay."""
    workload = [dict(prompt=[1, 4, 2], max_new_tokens=16,
                     method="temperature", temperature=0.8)]
    base = _server(bert, slots=1)
    try:
        _, want, _ = _run_workload(base, workload)
    finally:
        base.shutdown()
    srv = _server(bert, slots=1)
    try:
        keys0 = _store_keys(srv)
        plan = (faults.FaultPlan(seed=1)
                .fail_at(faults.GENERATION_STEP, 2)
                .fail_at(faults.GENERATION_ADMIT, 2))
        with plan:
            _, got, errs = _run_workload(srv, workload)
        assert errs == [None]
        assert got == want
        assert srv.stats["restarts"] >= 1
        assert srv.stats["replays"] >= 1
        assert _store_keys(srv) == keys0
    finally:
        srv.shutdown()


# ===================== death: typed, prompt, bounded ==================
def test_restart_budget_exhaustion_latches_typed_dead(bert):
    srv = _server(bert, restart_policy=RetryPolicy(
        max_attempts=2, initial_backoff=0.005, max_backoff=0.01))
    try:
        plan = faults.FaultPlan(seed=2).every(faults.GENERATION_ADMIT, 1)
        with plan:
            req = srv.submit([1, 2, 3], max_new_tokens=4)
            with pytest.raises(ServerDeadError):
                req.result(timeout=30)
        assert srv.stats["restarts"] >= 1
        with pytest.raises(ServerDeadError):
            srv.submit([1, 2], max_new_tokens=4)
        assert srv.serving_state()["state"] == "dead"
        snap = health_snapshot()
        assert snap["status"] == "serving_dead"
        assert any(s["state"] == "dead" for s in snap["serving"])
    finally:
        srv.shutdown()
    # deliberate shutdown demotes the dead report: /health stops paging
    assert srv.serving_state()["state"] == "shutdown"


def test_dead_server_unblocks_stream_consumers_promptly(bert):
    """A short prompt-bucket ladder forces the regenerate replay (no
    prefill progress), so an every-step fault makes zero forward progress
    and trips the no-progress guard; the blocked consumer raises typed
    well before its own timeout."""
    srv = _server(bert, slots=1, prompt_buckets=[4], cache_lengths=[16],
                  max_consecutive_failures=3,
                  restart_policy=RetryPolicy(max_attempts=2,
                                             initial_backoff=0.005))
    state = {}

    def consume(req):
        t0 = time.monotonic()
        try:
            for _ in req.stream(timeout=120):
                pass
        except Exception as e:  # noqa: BLE001 — asserted below
            state["err"] = e
        state["elapsed"] = time.monotonic() - t0

    try:
        plan = faults.FaultPlan(seed=3).every(faults.GENERATION_STEP, 1)
        with plan:
            req = srv.submit([1, 2, 3], max_new_tokens=8)
            t = threading.Thread(target=consume, args=(req,))
            t.start()
            t.join(timeout=60)
            assert not t.is_alive(), "consumer never unblocked"
        assert isinstance(state["err"], ServerDeadError)
        assert state["elapsed"] < 30
        assert req.finish_reason == "error"
    finally:
        srv.shutdown()


def test_crash_during_retirement_never_overshoots_the_stream(bert):
    """A crash after a request's terminal token was delivered but before
    its retirement completed finishes the request — a replay would
    generate past max_new_tokens."""
    srv = _server(bert, slots=1)
    try:
        want = srv.generate([1, 4, 2], max_new_tokens=4, timeout=60)
        orig = srv._store._fns["retire"]
        fired = []

        def flaky_retire(*a):
            if not fired:
                fired.append(True)
                raise RuntimeError("injected retire crash")
            return orig(*a)

        srv._store._fns["retire"] = flaky_retire
        r = srv.submit([1, 4, 2], max_new_tokens=4)
        assert r.result(timeout=60) == want
        assert len(r.tokens) == 4
        assert r.finish_reason == "length"
        assert srv.stats["errors"] == 1
        assert srv.generate([1, 4, 2], max_new_tokens=4,
                            timeout=60) == want
    finally:
        srv.shutdown()


# ===================== memory-pressure degradation ladder =============
def _oom(site, call_n):
    return RuntimeError(
        f"RESOURCE_EXHAUSTED: out of memory (injected at {site} "
        f"call {call_n})")


def _cuda_oom(site, call_n):
    # the message torch.cuda.OutOfMemoryError carries
    return RuntimeError(
        f"CUDA out of memory. Tried to allocate 2.00 GiB (injected at "
        f"{site} call {call_n})")


@pytest.mark.parametrize("exc", [_oom, _cuda_oom], ids=["xla", "cuda"])
def test_pressure_level1_refuses_growth_keeps_serving(bert, exc):
    """An OOM during cache growth escalates to level 1: the grown-past
    request fails typed, in-flight requests replay at the capped rung,
    and fresh requests that fit keep serving."""
    base = _server(bert)
    try:
        want = base.generate([1, 4, 2], max_new_tokens=8, timeout=60)
    finally:
        base.shutdown()
    srv = _server(bert)
    try:
        with faults.FaultPlan(seed=4).fail_at(faults.CACHE_GROW, 1,
                                              exc=exc):
            a = srv.submit([1, 4, 2], max_new_tokens=8)      # fits 16
            b = srv.submit([5, 6, 7, 8, 9, 10, 11],
                           max_new_tokens=20)                # needs 32
            assert a.result(timeout=60) == want
            with pytest.raises(MemoryPressureError):
                b.result(timeout=60)
        assert srv._pressure == 1
        assert srv._rung_cap == 16
        assert srv.stats["degradations"] >= 1
        assert srv.serving_state()["state"] == "degraded"
        assert health_snapshot()["status"] == "degraded"
        errors0 = srv.stats["errors"]
        with pytest.raises(MemoryPressureError):
            srv.generate([5, 6, 7, 8, 9, 10, 11], max_new_tokens=20,
                         timeout=60)
        assert srv.stats["errors"] == errors0     # refusal, not a crash
        assert srv.generate([1, 4, 2], max_new_tokens=8,
                            timeout=60) == want
    finally:
        srv.shutdown()


def test_pressure_ladder_sheds_queue_then_shrinks(bert):
    """Repeated OOM incidents walk the whole ladder: level 2 sheds the
    queued admissions typed; level 3 caps the rung one smaller — the
    in-flight request that no longer fits fails typed, and a fitting
    request still serves at the smaller rung."""
    srv = _server(bert, slots=1)
    try:
        mon.enable()
        plan = (faults.FaultPlan(seed=6)
                .fail_at(faults.GENERATION_STEP, 2, exc=_oom)
                .fail_at(faults.GENERATION_STEP, 4, exc=_oom)
                .fail_at(faults.GENERATION_STEP, 6, exc=_oom))
        with plan:
            big = srv.submit([5, 6, 7, 8, 9, 10, 11], max_new_tokens=20)
            q1 = srv.submit([1, 2], max_new_tokens=4)
            q2 = srv.submit([3, 4], max_new_tokens=4)
            for r in (big, q1, q2):
                with pytest.raises(MemoryPressureError):
                    r.result(timeout=60)
        assert srv._pressure == 3
        assert srv._rung_cap == 16
        assert srv.stats["degradations"] >= 3
        reg = mon.get_registry()
        for action in ("refuse_growth", "shed_queue", "shrink"):
            assert reg.counter(mon.GEN_DEGRADATIONS,
                               labels={"action": action}).value >= 1
        assert len(srv.generate([1, 2], max_new_tokens=4,
                                timeout=60)) == 4
        assert srv._rung == 16
    finally:
        srv.shutdown()


def test_pressure_decays_after_clean_stretch(bert):
    srv = _server(bert, slots=1, pressure_relief_steps=10)
    try:
        with faults.FaultPlan(seed=7).fail_at(faults.GENERATION_STEP, 2,
                                              exc=_oom):
            srv.generate([1, 2], max_new_tokens=8, timeout=60)
        assert srv._pressure == 1
        srv.generate([1, 2], max_new_tokens=8, timeout=60)
        assert srv._pressure == 0
        assert srv._rung_cap is None
        assert srv.generate([5, 6, 7, 8, 9, 10, 11], max_new_tokens=20,
                            timeout=60)
        assert srv._rung == 32
    finally:
        srv.shutdown()


def test_pressure_decays_while_idle(bert):
    srv = _server(bert, slots=1, pressure_relief_secs=0.05)
    try:
        with faults.FaultPlan(seed=8).fail_at(faults.CACHE_GROW, 1,
                                              exc=_oom):
            with pytest.raises(MemoryPressureError):
                srv.generate([5, 6, 7, 8, 9, 10, 11],
                             max_new_tokens=20, timeout=60)
        assert srv._pressure == 1
        deadline = time.monotonic() + 10
        while srv.serving_state()["state"] != "serving":
            assert time.monotonic() < deadline, \
                "idle server never relieved its pressure"
            time.sleep(0.02)
        assert srv._pressure == 0
    finally:
        srv.shutdown()


def test_pressure_decays_by_wall_clock_without_steps(bert):
    srv = _server(bert, slots=1, pressure_relief_secs=0.05)
    try:
        with faults.FaultPlan(seed=8).fail_at(faults.CACHE_GROW, 1,
                                              exc=_oom):
            with pytest.raises(MemoryPressureError):
                srv.generate([5, 6, 7, 8, 9, 10, 11],
                             max_new_tokens=20, timeout=60)
        assert srv._pressure == 1
        time.sleep(0.1)
        assert len(srv.generate([5, 6, 7, 8, 9, 10, 11],
                                max_new_tokens=20, timeout=60)) == 20
        assert srv._pressure == 0
        assert srv._rung == 32
    finally:
        srv.shutdown()


def test_memory_telemetry_high_water_refuses_growth(bert, monkeypatch):
    """The ladder reads monitoring/memory.py too: a device already past
    the high-water mark refuses growth (typed, before any dispatch)."""
    srv = _server(bert, slots=1, memory_high_water=0.9)
    try:
        srv.generate([1, 2], max_new_tokens=4, timeout=60)   # rung 16
        monkeypatch.setattr(
            memmod, "device_memory_stats",
            lambda device=None: {"cuda:0": {"bytes_in_use": 95,
                                            "bytes_limit": 100}})
        with pytest.raises(MemoryPressureError, match="high-water"):
            srv.generate([5, 6, 7, 8, 9, 10, 11], max_new_tokens=20,
                         timeout=60)
        assert srv.stats["errors"] == 0
        assert srv.serving_state()["state"] == "degraded"
        monkeypatch.setattr(
            memmod, "device_memory_stats",
            lambda device=None: {"cuda:0": {"bytes_in_use": 10,
                                            "bytes_limit": 100}})
        assert srv.generate([5, 6, 7, 8, 9, 10, 11], max_new_tokens=20,
                            timeout=60)
    finally:
        srv.shutdown()


def test_high_water_reads_the_servers_own_device_alone(bert, monkeypatch):
    """A neighbour device past the mark does not refuse this server's
    growth: the ladder asks the telemetry for its decoder's device."""
    asked = []

    def reading(device=None):
        asked.append(device)
        if device is None:
            return {"cuda:1": {"bytes_in_use": 99, "bytes_limit": 100}}
        return {"cuda:0": {"bytes_in_use": 10, "bytes_limit": 100}}

    srv = _server(bert, slots=1, memory_high_water=0.9)
    try:
        srv.generate([1, 2], max_new_tokens=4, timeout=60)   # rung 16
        monkeypatch.setattr(memmod, "device_memory_stats", reading)
        assert len(srv.generate([5, 6, 7, 8, 9, 10, 11], max_new_tokens=20,
                                timeout=60)) == 20
        assert srv._rung == 32
        assert srv.serving_state()["state"] == "serving"
        assert asked and all(d == srv.device for d in asked)
    finally:
        srv.shutdown()


# ===================== paged KV pool chaos ============================
def test_chaos_page_fault_replay_bit_identical(bert):
    """A `cache.page` fault mid-stream crashes the loop; recovery resets
    the pool, rebuilds the page table and the prefix registry from the
    journal, and every stream equals the fault-free dense run; at the end
    no page stays mapped."""
    dense = _server(bert, superstep=2)
    try:
        _, want, errs = _run_workload(dense)
        assert errs == [None] * 4
    finally:
        dense.shutdown()
    srv = _server(bert, paged=True, superstep=2)
    try:
        plan = faults.FaultPlan(seed=9).fail_at(faults.CACHE_PAGE, 6)
        with plan:
            _, got, errs = _run_workload(srv)
        assert plan.fired.get(faults.CACHE_PAGE) == 1
        assert errs == [None] * 4
        assert got == want
        assert srv.stats["replays"] >= 1
        assert srv.serving_state()["page_pool"]["pages_mapped"] == 0
        assert len(srv.generate([3, 1], max_new_tokens=3,
                                timeout=60)) == 3
    finally:
        srv.shutdown()


def _pool_oom(site, call_n):
    return PagePoolExhaustedError(
        f"kv page pool exhausted (injected at {site} call {call_n})")


def test_chaos_paged_ladder_evicts_cold_pages_before_shrink(bert):
    """The paged ladder has FOUR levels: refuse-growth → shed-queue →
    EVICT-COLD-PAGES → shrink."""
    srv = _server(bert, paged=True, slots=1)
    try:
        mon.enable()

        def deg(a):
            return mon.get_registry().counter(
                mon.GEN_DEGRADATIONS, labels={"action": a}).value

        base = {a: deg(a) for a in ("refuse_growth", "shed_queue",
                                    "evict_pages", "shrink")}
        plan = (faults.FaultPlan(seed=8)
                .fail_at(faults.GENERATION_STEP, 2, exc=_pool_oom)
                .fail_at(faults.GENERATION_STEP, 4, exc=_pool_oom))
        with plan:
            big = srv.submit([5, 6, 7, 8, 9, 10, 11], max_new_tokens=20)
            assert len(big.result(timeout=60)) == 20
        assert srv._pressure == 2
        assert srv._rung_cap == 32
        assert deg("refuse_growth") - base["refuse_growth"] == 1
        assert deg("shed_queue") - base["shed_queue"] == 1
        assert srv.serving_state()["page_pool"]["pages_cold"] > 0
        ev0 = srv._pages.stats["evictions"]
        with faults.FaultPlan(seed=9).fail_at(faults.GENERATION_STEP, 1,
                                              exc=_pool_oom):
            assert len(srv.generate([1, 2], max_new_tokens=4,
                                    timeout=60)) == 4
        assert srv._pressure == 3
        assert srv._rung_cap == 32
        assert deg("evict_pages") - base["evict_pages"] == 1
        assert deg("shrink") == base["shrink"]
        assert srv._pages.stats["evictions"] > ev0
        assert mon.get_registry().counter(
            mon.GEN_PAGE_EVICTIONS).value >= srv._pages.stats["evictions"]
        with faults.FaultPlan(seed=10).fail_at(faults.GENERATION_STEP, 1,
                                               exc=_pool_oom):
            big2 = srv.submit([5, 6, 7, 8, 9, 10, 11], max_new_tokens=20)
            with pytest.raises(MemoryPressureError):
                big2.result(timeout=60)
        assert srv._pressure == 4
        assert srv._rung_cap == 16
        assert deg("shrink") - base["shrink"] == 1
        assert len(srv.generate([1, 2], max_new_tokens=4,
                                timeout=60)) == 4
    finally:
        srv.shutdown()


def test_paged_metrics_and_health_surface(bert):
    """The page gauges and counters emit behind the enabled-guard, and
    the serving state and status() carry the pool's occupancy."""
    srv = _server(bert, paged=True, cache_lengths=[32],
                  prompt_buckets=[24])
    try:
        mon.enable()
        p = list(range(1, 18))
        srv.generate(p, max_new_tokens=4, timeout=120)
        srv.generate(p, max_new_tokens=4, timeout=120)
        reg = mon.get_registry()
        assert reg.gauge(mon.GEN_PAGES_ACTIVE).value > 0
        assert reg.counter(mon.GEN_PREFIX_HITS).value >= 1
        sstate = srv.serving_state()
        assert sstate["page_pool"]["pages_cold"] > 0
        assert sstate["page_pool"]["prefix_hits"] >= 1
        agg = gsrv.status()["servers"]
        assert any(s.get("paged") and "page_pool" in s for s in agg)
    finally:
        srv.shutdown()


def test_monitoring_off_leaves_the_registry_untouched(bert):
    """With monitoring off a served workload creates no series and no
    events, and requests carry no timeline."""
    mon.disable()
    ev.reset()
    srv = _server(bert)
    try:
        before = set(mon.get_registry().snapshot())
        reqs, out, errs = _run_workload(srv, _WORKLOAD[:2])
        assert errs == [None, None]
        assert all(r.trace is None and r.trace_id is None for r in reqs)
        assert set(mon.get_registry().snapshot()) == before
        assert ev.snapshot(last=None)["emitted"] == 0
    finally:
        srv.shutdown()


@pytest.mark.parametrize("case", ["dense ladder", "paged ladder"])
def test_ladder_and_refusal_events_reach_the_journal(bert, case):
    """Each ladder step and each refusal emits its ops event, as the JAX
    server's do: PRESSURE_ESCALATED, SERVER_SHED and CACHE_SHRUNK up the
    dense ladder, PRESSURE_RELIEVED on the way down, SERVER_REFUSED for a
    submit to a stopped server; PAGES_EXHAUSTED for an admission the pool
    cannot hold, PAGES_EVICTED at the paged ladder's eviction level."""
    mon.enable()
    ev.reset()
    if case == "dense ladder":
        srv = _server(bert, slots=1, pressure_relief_steps=4)
        plan = (faults.FaultPlan(seed=6)
                .fail_at(faults.GENERATION_STEP, 2, exc=_oom)
                .fail_at(faults.GENERATION_STEP, 4, exc=_oom)
                .fail_at(faults.GENERATION_STEP, 6, exc=_oom))
        want = {ev.PRESSURE_ESCALATED, ev.SERVER_SHED, ev.CACHE_SHRUNK,
                ev.PRESSURE_RELIEVED, ev.SERVER_REFUSED}
    else:
        srv = _server(bert, paged=True, slots=1, pool_pages=2,
                      cache_lengths=[32], prompt_buckets=[24])
        plan = (faults.FaultPlan(seed=8)
                .fail_at(faults.GENERATION_STEP, 1, exc=_pool_oom)
                .fail_at(faults.GENERATION_STEP, 2, exc=_pool_oom)
                .fail_at(faults.GENERATION_STEP, 3, exc=_pool_oom))
        want = {ev.PAGES_EXHAUSTED, ev.PAGES_EVICTED,
                ev.PRESSURE_ESCALATED}
    try:
        with plan:
            if case == "dense ladder":
                reqs = [srv.submit([5, 6, 7, 8, 9, 10, 11],
                                   max_new_tokens=20),
                        srv.submit([1, 2], max_new_tokens=4),
                        srv.submit([3, 4], max_new_tokens=4)]
            else:
                reqs = [srv.submit(list(range(1, 18)), max_new_tokens=4),
                        srv.submit([1, 2], max_new_tokens=12)]
            for r in reqs:
                try:
                    r.result(timeout=60)
                except (MemoryPressureError, PagePoolExhaustedError):
                    pass
        # clean tokens relieve the ladder step by step
        for _ in range(4):
            srv.generate([1, 2], max_new_tokens=4, timeout=60)
    finally:
        srv.shutdown()
    with pytest.raises(RuntimeError):
        srv.submit([1, 2], max_new_tokens=2)
    kinds = {e["kind"] for e in ev.snapshot(last=None)["events"]}
    assert want <= kinds, want - kinds
