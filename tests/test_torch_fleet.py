"""The port's FleetRouter (deeplearning4j_tpu_torch/generation/fleet.py) at
bert_tiny on the CPU: the contracts of the JAX package's
tests/test_fleet.py, held on `BertDecoder` replicas.

The load-bearing invariant: a stream is a pure function of (server seed,
admission id, prompt, sampling config), and the router assigns FLEET-wide
admission ids over seed-aligned replicas. So the fleet's streams, greedy
and sampled, equal the JAX `GenerationServer`'s over the same parameters
(carried across with `params_from_numpy`), seed and submissions, token
for token, whatever the replica count. The reference runs its fleet tests
over an LSTM decoder (ROADMAP A12), so the port is held to the
reference's computed streams and documented contracts.
"""
import time

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.generation import BertDecoder as JaxDecoder
from deeplearning4j_tpu.generation import GenerationServer as JaxServer
from deeplearning4j_tpu.models import bert as jb
from deeplearning4j_tpu_torch import monitoring as mon
from deeplearning4j_tpu_torch import resilience
from deeplearning4j_tpu_torch.generation import (BertDecoder, FleetRouter,
                                                 GenerationRequest,
                                                 GenerationServer)
from deeplearning4j_tpu_torch.generation import fleet as fleet_mod
from deeplearning4j_tpu_torch.generation.sampling import method_id
from deeplearning4j_tpu_torch.models import bert as tb
from deeplearning4j_tpu_torch.models.convert import params_from_numpy
from deeplearning4j_tpu_torch.monitoring import events
from deeplearning4j_tpu_torch.resilience import faults
from deeplearning4j_tpu_torch.resilience.errors import (
    InferenceOverloadedError, InferenceTimeoutError)
from test_torch_server import REQUESTS, SERVER


@pytest.fixture(autouse=True)
def _clean_harness():
    faults.clear_plan()
    yield
    faults.clear_plan()
    mon.disable()


@pytest.fixture(scope="module")
def models():
    cfg = jb.bert_tiny()
    jp = jb.init_bert_params(cfg, jax.random.PRNGKey(1))
    tcfg = tb.bert_tiny()
    tp = params_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return cfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def cache_dir(tmp_path_factory):
    """One manifest directory for every replica and replacement."""
    return str(tmp_path_factory.mktemp("fleet-exec"))


@pytest.fixture(scope="module")
def jax_streams(models):
    """The JAX server's streams over the workload, in submission order."""
    cfg, jp, _, _ = models
    srv = JaxServer(JaxDecoder(cfg, jp), superstep=4, **SERVER)
    try:
        handles = [srv.submit(**r) for r in REQUESTS]
        return [h.result(timeout=120) for h in handles]
    finally:
        srv.shutdown()


def _server(models, cache_dir, **kw):
    _, _, tcfg, tp = models
    return GenerationServer(BertDecoder(tcfg, tp), exec_cache_dir=cache_dir,
                            **{**SERVER, **kw})


def _fleet(models, cache_dir, n=3, server_kw=None, **kw):
    return FleetRouter(
        factory=lambda i: _server(models, cache_dir, **(server_kw or {})),
        num_replicas=n, **kw)


# -- the adopt() hook (the server side of the router contract) -------------

@pytest.mark.parametrize("delivered", [0, 3, "all"])
def test_adopt_under_an_explicit_id_continues_the_stream(models, cache_dir,
                                                         jax_streams,
                                                         delivered):
    """adopt() under admission id 2 reproduces the second submission's
    stream; a delivered prefix is replayed suppressed (only the
    continuation streams); a prefix that exhausted the budget closes the
    request with no decode."""
    want = jax_streams[1]
    r = REQUESTS[1]
    g = len(want) if delivered == "all" else delivered
    srv = _server(models, cache_dir)
    try:
        req = GenerationRequest(np.asarray(r["prompt"], np.int32),
                                r["max_new_tokens"], None,
                                method_id(r["method"]), r["temperature"], 0)
        req.tokens = list(want[:g])
        srv.adopt(req, admit_id=2)
        assert list(req.stream(timeout=60)) == want[g:]
        assert req.tokens == want
        assert req.finish_reason == "length"
    finally:
        srv.shutdown()


# -- routing ------------------------------------------------------------------

def test_fleet_streams_token_identical_to_the_jax_server(models, cache_dir,
                                                         jax_streams):
    """The headline identity: a 3-replica fleet serves the workload
    (greedy, temperature and top-k) token for token as the JAX server
    does; every admission went through exactly one replica; replicas
    after the first warm from the shared manifest."""
    with _fleet(models, cache_dir) as router:
        reqs = [router.submit(**r) for r in REQUESTS]
        got = [list(q.stream(timeout=60)) for q in reqs]
        assert got == jax_streams
        assert [q.finish_reason for q in reqs] == ["length"] * len(REQUESTS)
        st = router.status()
        assert sum(r["routed"] for r in st["replicas"]) == len(REQUESTS)
        assert st["completed"] == st["submitted"] == len(REQUESTS)
        assert st["failovers"] == st["failed"] == st["shed"] == 0
        for rep in router._replicas:
            stats = rep.server._store.stats
            assert stats["live_captures"] == 0
            if rep is not router._replicas[0]:
                assert stats["compiled"] == 0
                assert stats["from_disk"] == len(rep.server._store)
        assert [q.admit_id for q in reqs] \
            == list(range(1, len(REQUESTS) + 1))
        assert all(len(q.routes) == 1 for q in reqs)


def test_routing_spreads_load_least_loaded_first(models, cache_dir):
    with _fleet(models, cache_dir) as router:
        reqs = [router.submit(**REQUESTS[i % len(REQUESTS)])
                for i in range(6)]
        for q in reqs:
            q.result(timeout=60)
        routed = [rep.routed for rep in router._replicas]
        assert sum(routed) == 6 and all(n >= 1 for n in routed), routed


@pytest.mark.parametrize("bad", [dict(prompt=[]),
                                 dict(prompt=list(range(1, 10))),
                                 dict(prompt=[1], max_new_tokens=0),
                                 dict(prompt=[1], max_new_tokens=32)])
def test_submit_validation_mirrors_the_server(models, cache_dir, bad):
    with _fleet(models, cache_dir, n=1) as router:
        with pytest.raises(ValueError):
            router.submit(**bad)
        assert router.stats["submitted"] == 0


def test_replicas_must_be_seed_aligned(models, cache_dir):
    a = _server(models, cache_dir)
    b = _server(models, cache_dir, seed=SERVER["seed"] + 1)
    with pytest.raises(ValueError, match="bit-identical"):
        FleetRouter(replicas=[a, b])
    with pytest.raises(ValueError, match="factory"):
        FleetRouter()


# -- health gating --------------------------------------------------------------

def test_burn_breached_replica_gets_zero_admissions_until_recovery(
        models, cache_dir):
    """A burn-breached replica receives no admission while breached (one
    replica.unhealthy event marks the edge), and rejoins once its bad
    samples age out of the long window."""
    mon.enable()
    events.reset()
    clk = {"t": 100.0}
    with _fleet(models, cache_dir, clock=lambda: clk["t"]) as router:
        victim = router._replicas[0]
        for _ in range(6):
            victim.gauge.record(clk["t"], bad=True)
        assert victim.health(clk["t"]) == "unhealthy"
        for q in [router.submit(**REQUESTS[i]) for i in range(4)]:
            q.result(timeout=60)
        assert victim.routed == 0
        kinds = [e["kind"] for e in events.snapshot(last=None)["events"]]
        assert kinds.count(events.REPLICA_UNHEALTHY) == 1
        assert router.fleet_state()["state"] == "degraded"
        clk["t"] += 30.0
        assert victim.health(clk["t"]) == "healthy"
        for q in [router.submit(**REQUESTS[0]) for _ in range(3)]:
            q.result(timeout=60)
        assert victim.routed > 0
        assert router.fleet_state()["state"] == "serving"


def test_pressure_degraded_replica_not_admitted(models, cache_dir):
    with _fleet(models, cache_dir, n=2) as router:
        victim = router._replicas[0]
        victim.server._pressure = 1
        victim.server._pressure_ts = time.monotonic()
        for q in [router.submit(**REQUESTS[0]) for _ in range(3)]:
            q.result(timeout=60)
        assert victim.routed == 0 and router._replicas[1].routed == 3
        assert router.fleet_state()["state"] == "degraded"
        assert resilience.health_snapshot()["status"] == "degraded"


def test_all_degraded_sheds_typed_without_latching(models, cache_dir,
                                                   jax_streams):
    with _fleet(models, cache_dir, n=1) as router:
        srv = router._replicas[0].server
        srv._pressure = 2
        srv._pressure_ts = time.monotonic()
        with pytest.raises(InferenceOverloadedError):
            router.submit(**REQUESTS[0]).result(timeout=30)
        assert router.status()["shed"] == 1 and router._dead is None
        srv._pressure = 0
        # the shed request consumed admission id 1: id 2 is the JAX
        # server's second submission
        assert router.submit(**REQUESTS[1]).result(timeout=60) \
            == jax_streams[1]


def test_expired_deadline_fails_typed_before_dispatch(models, cache_dir):
    with _fleet(models, cache_dir, n=1) as router:
        req = router.submit(**REQUESTS[0], timeout_ms=-1.0)
        with pytest.raises(InferenceTimeoutError):
            req.result(timeout=30)
        assert router._replicas[0].routed == 0
        assert router.status()["failed"] == 1


# -- observability, autoscale, registry -------------------------------------------

def test_request_timeline_and_fleet_metrics_under_monitoring(models,
                                                             cache_dir):
    mon.enable()
    with _fleet(models, cache_dir, n=2) as router:
        req = router.submit(**REQUESTS[0])
        req.result(timeout=60)
        assert req.trace is not None and req.trace.kind == "fleet"
        evs = [e["event"] for e in req.trace.snapshot()["events"]]
        assert "route" in evs
        router.autoscale()
        names = set(mon.get_registry().snapshot())
        for name in (mon.FLEET_ROUTED, mon.FLEET_HEALTHY,
                     mon.FLEET_DESIRED_REPLICAS):
            assert name in names


def test_monitoring_off_leaves_the_registry_untouched(models, cache_dir):
    before = set(mon.get_registry().snapshot())
    with _fleet(models, cache_dir, n=2) as router:
        req = router.submit(**REQUESTS[0])
        req.result(timeout=60)
        router.autoscale()
        assert req.trace is None
    assert set(mon.get_registry().snapshot()) == before


def test_autoscale_signal_shape_and_floor(models, cache_dir):
    with _fleet(models, cache_dir, n=2, max_replicas=2) as router:
        sig = router.autoscale()
        assert (sig["replicas_live"], sig["replicas_healthy"]) == (2, 2)
        assert 1 <= sig["desired_replicas"] <= 2
        assert 0.0 <= sig["utilization"] <= 1.0 and sig["slo_burn"] >= 1.0
        for rep in router._replicas:
            rep.server._pressure = 3
            rep.server._pressure_ts = time.monotonic()
        assert router.autoscale()["replicas_healthy"] == 0


def test_fleet_status_and_health_snapshot(models, cache_dir):
    with _fleet(models, cache_dir, n=2) as router:
        router.submit(**REQUESTS[0]).result(timeout=60)
        st = router.status()
        assert {r["name"] for r in st["replicas"]} == {"r0", "r1"}
        assert all(r["health"] == "healthy" and r["state"] == "serving"
                   for r in st["replicas"])
        assert router.fleet_state()["state"] == "serving"
        snap = resilience.health_snapshot()
        assert snap["status"] == "ok"
        assert any(f["state"] == "serving" for f in snap["fleet"])
        assert any(r["replicas"] == st["replicas"]
                   for r in fleet_mod.status()["routers"])


def _coordinators(tmp_path):
    """Two real coordinators of two hosts over one shared LocalKV."""
    from deeplearning4j_tpu_torch.parallel.coordination import (
        LocalKV, PeerCoordinator)
    kv = LocalKV()
    return [PeerCoordinator(sync_every=1, peer_timeout=5.0, client=kv,
                            process_id=i, num_processes=2,
                            dump_dir=str(tmp_path)) for i in (0, 1)]


def test_replica_registry_publishes_over_a_coordinator(models, cache_dir,
                                                       tmp_path):
    c0, c1 = _coordinators(tmp_path)
    with _fleet(models, cache_dir, n=2) as router:
        # no coordinator is active: the reference's answers
        assert router.publish() is None and fleet_mod.directory() == {}
        doc = router.publish(coordinator=c0)
        assert doc["process_id"] == 0
        router.publish(coordinator=c1)
        view = fleet_mod.directory(coordinator=c0)
        assert set(view) == {"0", "1"}
        assert len(view["0"]["replicas"]) == 2
        assert view["1"]["autoscale"]["desired_replicas"] >= 1
        # the installed coordinator is found through sys.modules
        with c1:
            assert router.publish()["process_id"] == 1
            assert set(fleet_mod.directory()) == {"0", "1"}


def test_shutdown_refuses_new_submits(models, cache_dir):
    router = _fleet(models, cache_dir, n=1)
    router.warmup()
    router.submit(**REQUESTS[0]).result(timeout=60)
    router.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        router.submit(**REQUESTS[0])
    assert router._replicas[0].server.serving_state()["state"] == "shutdown"


def test_idle_replica_death_revived_off_the_dispatch_path(models,
                                                          cache_dir):
    """An idle replica that dies is revived by a background supervision
    kick from the next routed request, which a survivor serves; the
    replacement warms from the manifest."""
    with _fleet(models, cache_dir, n=2) as router:
        victim = router._replicas[1]
        victim.server._die(RuntimeError("idle chaos kill"))
        assert victim.health(time.monotonic()) == "dead"
        assert router.fleet_state()["state"] == "degraded"
        assert router.submit(**REQUESTS[0]).result(timeout=60)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline \
                and victim.health(time.monotonic()) != "healthy":
            time.sleep(0.02)
        assert victim.health(time.monotonic()) == "healthy"
        assert victim.replacements == 1
        stats = victim.server._store.stats
        assert stats["compiled"] == 0 and stats["from_disk"] > 0
        assert router.fleet_state()["state"] == "serving"
