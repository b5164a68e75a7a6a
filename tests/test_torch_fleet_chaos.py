"""Fleet chaos on the port's FleetRouter at bert_tiny on the CPU: the
contracts of the JAX package's tests/test_fleet_chaos.py, held on
`BertDecoder` replicas, and the slice against the JAX package: under a
replica killed mid-stream and under dispatch faults, the fleet delivers
the JAX `GenerationServer`'s fault-free streams for the same parameters
and seed, greedy and sampled.

Replicas are built with `max_consecutive_failures=0`: a step fault kills
the REPLICA (no in-process restart), so the fleet's failover and its
supervisor carry the recovery. Fault sites driven here (`python -m
deeplearning4j_tpu_torch.lint.fault_coverage`): ROUTER_DISPATCH and
REPLICA_RESTART; event kinds (`...lint.event_coverage`):
REPLICA_UNHEALTHY, REPLICA_DRAINED, REPLICA_REPLACED and REQUEST_FAILOVER.
"""
import gc
import threading
import weakref

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.generation import BertDecoder as JaxDecoder
from deeplearning4j_tpu.generation import GenerationServer as JaxServer
from deeplearning4j_tpu.models import bert as jb
from deeplearning4j_tpu_torch import monitoring as mon
from deeplearning4j_tpu_torch import resilience
from deeplearning4j_tpu_torch.generation import (BertDecoder, FleetRouter,
                                                 GenerationServer)
from deeplearning4j_tpu_torch.models import bert as tb
from deeplearning4j_tpu_torch.models.convert import params_from_numpy
from deeplearning4j_tpu_torch.monitoring import events
from deeplearning4j_tpu_torch.resilience import faults
from deeplearning4j_tpu_torch.resilience.errors import (FleetDeadError,
                                                        InjectedFault,
                                                        ServerDeadError)
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
def jax_streams(models):
    cfg, jp, _, _ = models
    srv = JaxServer(JaxDecoder(cfg, jp), superstep=4, **SERVER)
    try:
        handles = [srv.submit(**r) for r in REQUESTS]
        return [h.result(timeout=120) for h in handles]
    finally:
        srv.shutdown()


@pytest.fixture(scope="module")
def cache_dir(models, tmp_path_factory):
    """The shared manifest directory, written once by a first server: every
    replica and replacement after it warms from it."""
    d = str(tmp_path_factory.mktemp("fleet-chaos-exec"))
    _server(models, d).warmup()
    return d


def _server(models, cache_dir, **kw):
    _, _, tcfg, tp = models
    kw.setdefault("superstep", 1)      # the k=1 path fires GENERATION_STEP
    kw.setdefault("max_consecutive_failures", 0)
    return GenerationServer(BertDecoder(tcfg, tp), exec_cache_dir=cache_dir,
                            **{**SERVER, **kw})


def _fleet(models, cache_dir, n=3, **kw):
    return FleetRouter(factory=lambda i: _server(models, cache_dir),
                       num_replicas=n, **kw)


def _consume(reqs, timeout=60):
    """One streaming consumer thread per request (the production shape).
    Returns (token lists, errors)."""
    out = [None] * len(reqs)
    errs = [None] * len(reqs)

    def run(i, req):
        try:
            out[i] = list(req.stream(timeout=timeout))
        except Exception as e:  # noqa: BLE001 — asserted by callers
            errs[i] = e

    threads = [threading.Thread(target=run, args=(i, r))
               for i, r in enumerate(reqs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout + 30)
    assert not any(t.is_alive() for t in threads), "consumer hung"
    return out, errs


def _kind(x):
    return x.get("kind") if isinstance(x, dict) else x


def test_replica_killed_mid_stream_streams_equal_the_jax_server(
        models, cache_dir, jax_streams):
    """Kill 1 of 3 replicas mid-stream: zero client-visible failures, the
    JAX server's streams token for token, one ordered replica-lost →
    drain → replace incident, a replacement warmed from the manifest, and
    nothing left holding the dead server."""
    mon.enable()
    events.reset()
    plan = faults.FaultPlan(seed=5).fail_at(faults.GENERATION_STEP, 12)
    with plan:
        with _fleet(models, cache_dir) as router:
            first = [weakref.ref(r.server) for r in router._replicas]
            reqs = [router.submit(**r) for r in REQUESTS]
            out, errs = _consume(reqs)
            assert errs == [None] * len(reqs), errs
            assert out == jax_streams
            assert plan.fired[faults.GENERATION_STEP] == 1
            st = router.status()
            assert st["failovers"] >= 1 and st["replacements"] == 1
            assert st["failed"] == st["shed"] == 0
            assert router._dead is None
            assert router.fleet_state()["state"] == "serving"
            assert any(len(q.routes) == 2 for q in reqs)
            for rep in router._replicas:
                stats = rep.server._store.stats
                assert stats["compiled"] == 0 and stats["live_captures"] == 0
            live = {id(r.server) for r in router._replicas}
            dead = [w for w in first if w() is not None
                    and id(w()) not in live]
            assert len(dead) == 1 and dead[0]().serving_state()["state"] \
                == "shutdown"
            del reqs
            gc.collect()
            assert dead[0]() is None, gc.get_referrers(dead[0]())
    incs = events.incidents()
    closed = [i for i in incs["recent"] + incs["open"]
              if events.REPLICA_REPLACED in i["kinds"]]
    assert closed, incs
    inc = closed[0]
    kinds = inc["kinds"]
    assert kinds.index(events.REPLICA_UNHEALTHY) \
        < kinds.index(events.REPLICA_DRAINED) \
        < kinds.index(events.REPLICA_REPLACED)
    assert _kind(inc["resolution"]) == events.REPLICA_REPLACED
    assert inc["state"] == "resolved"
    evs = events.snapshot(last=None)["events"]
    assert events.REQUEST_FAILOVER in [e["kind"] for e in evs]
    replaced = [e for e in evs if e["kind"] == events.REPLICA_REPLACED]
    assert replaced[0]["attrs"]["compiled"] == 0
    assert replaced[0]["attrs"]["from_disk"] > 0


def test_dispatch_chaos_absorbed_within_the_budget(models, cache_dir,
                                                   jax_streams):
    """Every 5th ROUTER_DISPATCH faults: the failover budget absorbs each
    one, and the streams are the JAX server's."""
    plan = faults.FaultPlan(seed=7).every(faults.ROUTER_DISPATCH, 5)
    with plan:
        with _fleet(models, cache_dir, failover_budget=6) as router:
            reqs = [router.submit(**r) for r in REQUESTS]
            out, errs = _consume(reqs)
            assert errs == [None] * len(reqs), errs
            assert out == jax_streams
            fired = plan.fired[faults.ROUTER_DISPATCH]
            assert fired >= 1
            st = router.status()
            assert st["failovers"] >= fired and st["failed"] == 0


def test_dispatch_budget_exhaustion_fails_typed(models, cache_dir):
    plan = faults.FaultPlan(seed=3).every(faults.ROUTER_DISPATCH, 1)
    with plan:
        with _fleet(models, cache_dir, failover_budget=2) as router:
            req = router.submit(**REQUESTS[0])
            with pytest.raises(InjectedFault):
                req.result(timeout=30)
            st = router.status()
            assert (st["failed"], st["failovers"]) == (1, 2)
            assert plan.fired[faults.ROUTER_DISPATCH] == 3


def test_replica_restart_fault_leaves_slot_dead_fleet_serves_on(
        models, cache_dir, jax_streams):
    """A replacement that itself fails (REPLICA_RESTART): the slot stays
    dead, the in-flight streams complete on the survivor, and the fleet —
    and /health — report degraded without latching."""
    plan = (faults.FaultPlan(seed=9)
            .fail_at(faults.GENERATION_STEP, 6)
            .every(faults.REPLICA_RESTART, 1))
    with plan:
        with _fleet(models, cache_dir, n=2) as router:
            reqs = [router.submit(**r) for r in REQUESTS[:2]]
            out, errs = _consume(reqs)
            assert errs == [None, None], errs
            assert out == jax_streams[:2]
            assert plan.fired[faults.GENERATION_STEP] == 1
            assert plan.fired[faults.REPLICA_RESTART] >= 1
            st = router.status()
            assert st["replacements"] == 0
            assert sorted(r["health"] for r in st["replicas"]) \
                == ["dead", "healthy"]
            assert router.fleet_state()["state"] == "degraded"
            assert resilience.health_snapshot()["status"] == "degraded"
            assert router._dead is None
            # the survivor carries new traffic alone (admission id 3)
            assert router.submit(**REQUESTS[2]).result(timeout=60) \
                == jax_streams[2]


def test_fleet_dead_latches_only_at_zero_live_replicas(models, cache_dir):
    """A one-replica fleet whose replica dies with no restart budget fails
    its open request with the typed FleetDeadError (a ServerDeadError)
    and refuses every later submit; /health reports serving_dead."""
    plan = faults.FaultPlan(seed=4).fail_at(faults.GENERATION_STEP, 3)
    with plan:
        with _fleet(models, cache_dir, n=1, restart_budget=0) as router:
            req = router.submit(**REQUESTS[1])
            with pytest.raises(FleetDeadError) as ei:
                req.result(timeout=30)
            assert isinstance(ei.value, ServerDeadError)
            assert router._dead is not None
            assert router.fleet_state()["state"] == "dead"
            assert resilience.health_snapshot()["status"] == "serving_dead"
            with pytest.raises(FleetDeadError):
                router.submit(**REQUESTS[0])
