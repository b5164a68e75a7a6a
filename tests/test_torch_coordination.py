"""The port's coordination plane (parallel/coordination.py) and hardened
bootstrap (parallel/multihost.initialize), held to the JAX package's
tests/test_multihost_chaos.py contracts (its :58-400): two
`PeerCoordinator`s driven from two threads, over each of the port's two
clients — the in-process `LocalKV`, and `StoreKV` over a loopback
`torch.distributed.TCPStore` (one server object, one client object, as
two hosts would hold them). Every wait is bounded: a silent peer is a
`PeerLostError` within its timeout plus slack, never a hang.

Also here: the coordinator's consumers (the fleet registry, the UI's
cluster view, the watchdog's peer table, the health snapshot) against a
real coordinator, and the port's `StoreKV` index (prefix listing over a
store that has none)."""
import datetime
import json
import os
import threading
import time

import numpy as np
import pytest
import torch.distributed as dist

from deeplearning4j_tpu_torch.parallel import coordination as coord_mod
from deeplearning4j_tpu_torch.parallel.coordination import (LocalKV,
                                                            PeerCoordinator,
                                                            StoreKV)
from deeplearning4j_tpu_torch.resilience import faults
from deeplearning4j_tpu_torch.resilience.errors import (DistributedInitError,
                                                        InjectedFault,
                                                        PeerDesyncError,
                                                        PeerLostError,
                                                        PreemptionSignal)

CLIENTS = ["local", "store"]


@pytest.fixture(autouse=True)
def _clean_switches():
    yield
    coord_mod.clear_coordinator()
    faults.clear_plan()
    faults.PROCESS_ID = None
    from deeplearning4j_tpu_torch.resilience import guardian as _g
    _g.clear_guardian()


def _tcp_pair(n=2):
    """n StoreKV clients over one loopback TCPStore: the first holds the
    server, the others connect to it."""
    server = dist.TCPStore("127.0.0.1", 0, n, True,
                           timeout=datetime.timedelta(seconds=30),
                           wait_for_workers=False)
    stores = [server] + [dist.TCPStore(
        "127.0.0.1", server.port, n, False,
        timeout=datetime.timedelta(seconds=30)) for _ in range(n - 1)]
    return [StoreKV(s, num_processes=n) for s in stores]


def _clients(kind, n=2):
    if kind == "local":
        kv = LocalKV()
        return [kv] * n
    return _tcp_pair(n)


def _pair(tmp_path, kind="local", sync_every=2, peer_timeout=2.0):
    kvs = _clients(kind)
    return [PeerCoordinator(sync_every=sync_every,
                            peer_timeout=peer_timeout,
                            client=kvs[i], process_id=i, num_processes=2,
                            dump_dir=str(tmp_path)) for i in (0, 1)]


# ===================== the clients =========================================
@pytest.mark.parametrize("kind", CLIENTS)
def test_kv_and_barrier_semantics(kind):
    kv, peer = _clients(kind)
    kv.key_value_set("a/b", "1")
    with pytest.raises(RuntimeError):
        kv.key_value_set("a/b", "2")            # write-once by default
    kv.key_value_set("a/b", "2", allow_overwrite=True)
    assert peer.blocking_key_value_get("a/b", 100) == "2"
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        kv.blocking_key_value_get("missing", 150)
    assert 0.1 < time.monotonic() - t0 < 2.0
    assert peer.key_value_dir_get("a/") == [("a/b", "2")]
    done = []

    def arrive():
        peer.wait_at_barrier("bar", 2000, expected=2)
        done.append(1)

    t = threading.Thread(target=arrive)
    t.start()
    kv.wait_at_barrier("bar", 2000, expected=2)
    t.join(timeout=2)
    assert len(done) == 1
    with pytest.raises(TimeoutError):
        kv.wait_at_barrier("bar2", 100, expected=2)


@pytest.mark.parametrize("kind", CLIENTS)
def test_kv_prefix_listing_nested_and_deletes(kind):
    """The listing a store lacks: nested directories, partial-name
    prefixes, deletes (a prefix removes its subtree) and a re-set after a
    delete, seen alike from both holders."""
    a, b = _clients(kind)
    for k in ("ns/hb/0/0", "ns/hb/0/1", "ns/hb/1/0", "ns/alive/0",
              "ns/alive/1", "ns/alpha"):
        a.key_value_set(k, k[-1], allow_overwrite=True)
    assert [k for k, _ in b.key_value_dir_get("ns/hb/")] == \
        ["ns/hb/0/0", "ns/hb/0/1", "ns/hb/1/0"]
    assert [k for k, _ in b.key_value_dir_get("ns/al")] == \
        ["ns/alive/0", "ns/alive/1", "ns/alpha"]
    b.key_value_delete("ns/hb/0/")
    assert [k for k, _ in a.key_value_dir_get("ns/hb/")] == ["ns/hb/1/0"]
    b.key_value_delete("ns/alive/1")
    assert a.key_value_dir_get("ns/alive/") == [("ns/alive/0", "0")]
    a.key_value_set("ns/alive/1", "again")
    assert b.key_value_dir_get("ns/alive/1") == [("ns/alive/1", "again")]
    assert b.key_value_dir_get("nothing/") == []


def test_storekv_holds_a_bounded_number_of_keys_over_many_rounds(tmp_path):
    """Heartbeats per sync round, a fence every third step and an
    overwritten registry entry per host: the store ends 60 rounds with
    as many keys as it held after 10, and its index lists only what the
    store holds (a delete takes a key out of the index, the last to leave
    a barrier removes its keys)."""
    kvs = _tcp_pair()
    cs = [PeerCoordinator(sync_every=1, peer_timeout=10.0, client=kvs[i],
                          process_id=i, num_processes=2,
                          dump_dir=str(tmp_path)) for i in (0, 1)]
    errors = []

    def run(c, steps):
        try:
            for step in range(steps):
                c.on_step()
                c.publish_json(f"fleet/{c.process_id}", {"step": step})
                if step % 3 == 0:
                    c.barrier(f"fence/{c.step}")
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    def both(steps):
        ts = [threading.Thread(target=run, args=(c, steps)) for c in cs]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not errors and not any(t.is_alive() for t in ts)
        return kvs[0].store.num_keys()

    after_10 = both(10)
    assert both(50) == after_10
    listed = [k for k, _ in kvs[1].key_value_dir_get("")]
    assert listed == sorted(kvs[0]._keys()) and len(listed) <= 8, listed
    assert [k for k, _ in kvs[1].key_value_dir_get(cs[0]._key("fleet/"))] \
        == [cs[0]._key("fleet/0"), cs[0]._key("fleet/1")]


def test_storekv_reads_never_block_on_a_deleted_key():
    """A key deleted between a listing and its read is skipped, and a
    blocking get of a key that appears later returns it — no read waits
    out the store's own timeout."""
    a, b = _tcp_pair()
    a.key_value_set("x/1", "v")
    b.key_value_delete("x/1")
    t0 = time.monotonic()
    assert a.key_value_dir_get("x/") == []
    assert a._peek("x/1") is None
    assert time.monotonic() - t0 < 1.0
    threading.Timer(0.2, lambda: b.key_value_set("late", "ok")).start()
    assert a.blocking_key_value_get("late", 3000) == "ok"


# ===================== agreement and containment ===========================
@pytest.mark.parametrize("kind", CLIENTS)
def test_preemption_agreement_two_coordinators(tmp_path, kind):
    """Worker 1 requests preemption mid-window; BOTH coordinators reach
    the drain decision at the SAME sync round/step."""
    c0, c1 = _pair(tmp_path, kind)
    c0.driver_attached = c1.driver_attached = True
    decisions = {}

    def run(c, preempt_at):
        for step in range(6):
            if step == preempt_at:
                c.request_preemption("test")
            c.on_step()
            d = c.take_decision()
            if d is not None:
                decisions[c.process_id] = (d, c.step)
                return

    t0 = threading.Thread(target=run, args=(c0, None))
    t1 = threading.Thread(target=run, args=(c1, 1))
    t0.start(); t1.start()
    t0.join(timeout=10); t1.join(timeout=10)
    assert decisions == {0: ("preempt", 2), 1: ("preempt", 2)}
    assert c0.preempted and c1.preempted


@pytest.mark.parametrize("kind", CLIENTS)
def test_undriven_preemption_raises_signal(tmp_path, kind):
    c0, c1 = _pair(tmp_path, kind)
    errs = {}

    def run(c):
        c.request_preemption("test")
        try:
            c.on_step(); c.on_step()
        except PreemptionSignal as e:
            errs[c.process_id] = e

    ts = [threading.Thread(target=run, args=(c,)) for c in (c0, c1)]
    [t.start() for t in ts]
    [t.join(timeout=10) for t in ts]
    assert set(errs) == {0, 1}
    assert errs[0].step == errs[1].step == 2


@pytest.mark.parametrize("kind", CLIENTS)
def test_peer_lost_is_bounded_and_dumps(tmp_path, kind):
    """A peer that never reaches the sync point surfaces as PeerLostError
    within ~peer_timeout, with a forensics report holding the peer table
    — never an indefinite hang."""
    c0, _ = _pair(tmp_path, kind, peer_timeout=1.0)
    t0 = time.monotonic()
    with pytest.raises(PeerLostError) as ei:
        c0.on_step(); c0.on_step()
    assert time.monotonic() - t0 < 10.0
    assert ei.value.report_path and os.path.exists(ei.value.report_path)
    text = open(ei.value.report_path).read()
    assert "Peer table" in text and "PEER LOST" in text


@pytest.mark.parametrize("kind", CLIENTS)
def test_step_desync_detected(tmp_path, kind):
    c0, c1 = _pair(tmp_path, kind)
    # forge worker 1's round-0 heartbeat with a diverged step count
    c1._client.key_value_set(
        "dl4j/hb/0/1", json.dumps({"step": 99, "t": time.time(),
                                   "preempt": False}))
    with pytest.raises(PeerDesyncError):
        c0.on_step(); c0.on_step()


@pytest.mark.parametrize("kind", CLIENTS)
def test_monitor_detects_silent_peer(tmp_path, kind):
    c0, c1 = _pair(tmp_path, kind, peer_timeout=0.5)
    m0 = c0.start_monitor(poll_interval=0.1)
    m1 = c1.start_monitor(poll_interval=0.1)
    time.sleep(0.3)
    assert not c0._lost
    c1.stop_monitor()                     # peer 1 goes silent
    deadline = time.monotonic() + 5
    while not c0._lost and time.monotonic() < deadline:
        time.sleep(0.05)
    assert 1 in c0._lost
    with pytest.raises(PeerLostError):
        c0.on_step()
    c0.stop_monitor()
    assert m0 is not None and m1 is not None


@pytest.mark.parametrize("kind", CLIENTS)
def test_barrier_timeout_is_peer_lost(tmp_path, kind):
    c0, _ = _pair(tmp_path, kind)
    t0 = time.monotonic()
    with pytest.raises(PeerLostError):
        c0.barrier("fence", timeout=0.2)
    assert time.monotonic() - t0 < 5.0


def test_bound_coordinator_ignores_auxiliary_trainers(tmp_path):
    c0, _ = _pair(tmp_path, sync_every=100)
    main, aux = object(), object()
    c0.bind(main)
    c0.on_step(aux)
    c0.on_step()
    assert c0.step == 0
    c0.on_step(main)
    assert c0.step == 1
    c0.bind(None)
    c0.on_step(aux)
    c0.on_step()
    assert c0.step == 3


# ===================== process-aware fault seeds ===========================
def test_faultplan_seed_is_process_aware():
    def schedule(seed, pid):
        plan = faults.FaultPlan(seed=seed, process_id=pid)
        plan.probability("site", 0.3)
        fired = []
        for _ in range(40):
            try:
                plan.fire("site")
                fired.append(0)
            except Exception:  # noqa: BLE001
                fired.append(1)
        return fired

    s0a, s0b = schedule(7, 0), schedule(7, 0)
    s1a, s1b = schedule(7, 1), schedule(7, 1)
    assert s0a == s0b and s1a == s1b
    assert s0a != s1a
    p = faults.FaultPlan(seed=7, process_id=3).fail_at("s", 2)
    p.fire("s")
    with pytest.raises(Exception):
        p.fire("s")


def test_faultplan_process_id_resolution(monkeypatch):
    monkeypatch.setenv("DL4J_PROCESS_ID", "5")
    assert faults.resolve_process_id() == 5
    faults.PROCESS_ID = 2
    assert faults.resolve_process_id() == 2
    assert faults.resolve_process_id(9) == 9
    faults.PROCESS_ID = None
    monkeypatch.delenv("DL4J_PROCESS_ID")
    assert faults.resolve_process_id() == 0


# ===================== hardened bootstrap ==================================
def test_bootstrap_noop_without_coordinator(monkeypatch):
    from deeplearning4j_tpu_torch.parallel import multihost
    for k in ("DL4J_COORDINATOR", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize() is False


def test_bootstrap_retries_then_typed_error(monkeypatch):
    """A coordinator that never comes up is retried with backoff, then
    surfaces as DistributedInitError — typed, bounded, loud."""
    from deeplearning4j_tpu_torch.parallel import multihost
    from deeplearning4j_tpu_torch.resilience.policy import RetryPolicy
    calls = []

    def fake_store(*a, **kw):
        calls.append(a)
        raise RuntimeError("UNAVAILABLE: failed to connect to all "
                           "addresses")

    monkeypatch.setattr(dist, "TCPStore", fake_store)
    policy = RetryPolicy(max_attempts=3, initial_backoff=0.01,
                         max_backoff=0.02, deadline=10)
    with pytest.raises(DistributedInitError) as ei:
        multihost.initialize("localhost:1", 2, 1, connect_deadline=10,
                             retry_policy=policy)
    assert len(calls) == 3
    assert "could not join" in str(ei.value)


def test_bootstrap_nonretryable_fails_fast(monkeypatch):
    from deeplearning4j_tpu_torch.parallel import multihost
    calls = []

    def fake_store(*a, **kw):
        calls.append(a)
        raise RuntimeError("INVALID_ARGUMENT: bad process id")

    monkeypatch.setattr(dist, "TCPStore", fake_store)
    with pytest.raises(DistributedInitError):
        multihost.initialize("localhost:1", 2, 1, connect_deadline=10)
    assert len(calls) == 1


def test_bootstrap_env_config_brings_up_a_group(monkeypatch):
    """DL4J_* env vars drive the config: process 0 hosts a loopback
    TCPStore, a gloo group of one comes up on it, the sanity barrier and
    the device agreement pass, the process id registers with the fault
    harness, and the store becomes the coordination KV's client."""
    from deeplearning4j_tpu_torch.parallel import multihost
    probe = dist.TCPStore("127.0.0.1", 0, 1, True, wait_for_workers=False)
    port = probe.port
    del probe
    monkeypatch.setenv("DL4J_COORDINATOR", f"127.0.0.1:{port}")
    monkeypatch.setenv("DL4J_NUM_PROCESSES", "1")
    monkeypatch.setenv("DL4J_PROCESS_ID", "0")
    monkeypatch.setattr(coord_mod, "_CLIENT", None)
    try:
        assert multihost.initialize(backend="gloo") is True
        assert dist.is_initialized() and dist.get_world_size() == 1
        assert faults.PROCESS_ID == 0
        client = coord_mod._distributed_client()
        assert isinstance(client, StoreKV)
        c = PeerCoordinator(sync_every=1, peer_timeout=2.0)
        assert (c.process_id, c.num_processes) == (0, 1)
        c.on_step()
        assert c.rounds == 1
        assert multihost.initialize() is True      # already up: no-op
    finally:
        multihost._teardown()
        multihost._STORE = None
        faults.PROCESS_ID = None


def test_bootstrap_without_world_shape_is_a_typed_error(monkeypatch):
    from deeplearning4j_tpu_torch.parallel import multihost
    for k in ("DL4J_NUM_PROCESSES", "WORLD_SIZE", "DL4J_PROCESS_ID",
              "RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(DistributedInitError, match="number of processes"):
        multihost.initialize("127.0.0.1:1")


# ===================== coordinated guardian ================================
@pytest.mark.parametrize("kind", CLIENTS)
def test_coordinated_guardian_folds_verdicts(tmp_path, kind):
    """Each host publishes its flush window; both fold to the SAME (AND of
    ok, max of gnorm) — a NaN on ONE host skips the update on EVERY host
    and both climb the same ladder rung."""
    from deeplearning4j_tpu_torch.parallel.multihost import \
        CoordinatedGuardian
    c0, c1 = _pair(tmp_path, kind, sync_every=2, peer_timeout=5.0)
    g0 = CoordinatedGuardian(c0, check_every=2, warmup_steps=100)
    g1 = CoordinatedGuardian(c1, check_every=2, warmup_steps=100)
    results = {}

    def run(g, gnorms_oks):
        for gn, ok in gnorms_oks:
            g.on_step(None, np.float32(gn), np.asarray(ok))
        results[g.coordinator.process_id] = (g.skipped, g._bad_streak)

    t0 = threading.Thread(target=run,
                          args=(g0, [(1.0, True), (1.0, True)]))
    t1 = threading.Thread(target=run,
                          args=(g1, [(1.0, True), (float("nan"), False)]))
    t0.start(); t1.start()
    t0.join(timeout=10); t1.join(timeout=10)
    assert results[0] == results[1] == (1, 1)


@pytest.mark.parametrize("kind", CLIENTS)
def test_coordinated_guardian_desync_window(tmp_path, kind):
    from deeplearning4j_tpu_torch.parallel.multihost import \
        CoordinatedGuardian
    c0, c1 = _pair(tmp_path, kind, sync_every=2, peer_timeout=2.0)
    g0 = CoordinatedGuardian(c0, check_every=2, warmup_steps=100)
    errs = {}
    c1._client.key_value_set(
        "dl4j/gv/0/1", json.dumps({"g": [1.0], "ok": [True]}))

    def run():
        try:
            g0.on_step(None, np.float32(1.0), np.asarray(True))
            g0.on_step(None, np.float32(1.0), np.asarray(True))
        except PeerDesyncError as e:
            errs["e"] = e

    t = threading.Thread(target=run)
    t.start(); t.join(timeout=10)
    assert "e" in errs


def test_coordinated_guardian_matches_the_jax_package(tmp_path):
    """The same two verdict windows through the JAX package's
    CoordinatedGuardian pair and the port's: equal skips, streaks and
    device thresholds on both hosts."""
    from deeplearning4j_tpu.parallel import coordination as jcoord
    from deeplearning4j_tpu.parallel.multihost import \
        CoordinatedGuardian as JGuardian
    from deeplearning4j_tpu_torch.parallel.multihost import \
        CoordinatedGuardian
    windows = ([(1.0, True), (2.0, True), (3.0, True), (1.5, True)],
               [(1.0, True), (float("nan"), False), (2.5, True),
                (9.0, True)])

    def drive(make_pair, make_guard):
        c0, c1 = make_pair()
        gs = [make_guard(c, check_every=2, warmup_steps=1, max_skips=5)
              for c in (c0, c1)]
        out = {}

        def run(g, w):
            for gn, ok in w:
                g.on_step(None, np.float32(gn), np.asarray(ok))
            out[g.coordinator.process_id] = (g.skipped, g._bad_streak,
                                             g.max_gnorm)

        ts = [threading.Thread(target=run, args=(g, w))
              for g, w in zip(gs, windows)]
        [t.start() for t in ts]
        [t.join(timeout=10) for t in ts]
        return out

    def jpair():
        kv = jcoord.LocalKV()
        return [jcoord.PeerCoordinator(sync_every=2, peer_timeout=5.0,
                                       client=kv, process_id=i,
                                       num_processes=2,
                                       dump_dir=str(tmp_path))
                for i in (0, 1)]

    want = drive(jpair, JGuardian)
    got = drive(lambda: _pair(tmp_path, "local", peer_timeout=5.0),
                CoordinatedGuardian)
    assert got == want and got[0] == got[1]


# ===================== the coordinator's consumers =========================
@pytest.mark.parametrize("kind", CLIENTS)
def test_health_snapshot_has_peer_table(tmp_path, kind):
    from deeplearning4j_tpu_torch import resilience
    c0, c1 = _pair(tmp_path, kind, sync_every=1, peer_timeout=5.0)
    c0.install()
    try:
        done = threading.Event()

        def peer():
            c1.on_step()
            done.set()

        t = threading.Thread(target=peer)
        t.start()
        c0.on_step()
        done.wait(timeout=5)
        snap = resilience.health_snapshot()
        dist_ = snap["distributed"]
        assert dist_["process_id"] == 0 and dist_["num_processes"] == 2
        assert set(dist_["peers"]) == {"0", "1"}
        assert snap["status"] == "ok"
        c0.request_preemption("test")
        assert resilience.health_snapshot()["status"] == "degraded"
        c0._lost[1] = {"round": 0}
        assert resilience.health_snapshot()["status"] == "peer_lost"
    finally:
        c0.uninstall()


def test_watchdog_report_reads_the_active_coordinator(tmp_path):
    """The stall report's peer-table section comes from the installed
    coordinator (found through sys.modules)."""
    from deeplearning4j_tpu_torch.resilience import watchdog
    assert "no coordinator installed" in \
        "\n".join(watchdog._peer_table_lines())
    c0, c1 = _pair(tmp_path, "local", sync_every=1, peer_timeout=5.0)
    t = threading.Thread(target=c1.on_step)
    t.start()
    c0.on_step()
    t.join(timeout=5)
    with c0:
        lines = "\n".join(watchdog._peer_table_lines())
    assert "no coordinator installed" not in lines
    assert "step" in lines


def test_ui_cluster_view_reads_the_active_coordinator(tmp_path):
    """The UI server's cluster routes answer from the installed
    coordinator's KV (found through sys.modules), and say so when there
    is none."""
    from deeplearning4j_tpu_torch.ui import server as ui
    assert ui._coordinator() is None
    c0, c1 = _pair(tmp_path, "local", sync_every=1, peer_timeout=5.0)
    with c0:
        assert ui._coordinator() is c0
        c0.publish_json("metrics/0", {"t": time.time(), "metrics": {}})
        c1.publish_json("metrics/1", {"t": time.time(), "metrics": {}})
        from deeplearning4j_tpu_torch.monitoring import cluster
        assert set(cluster.gather(c0)) == {0, 1}
    assert ui._coordinator() is None


@pytest.mark.parametrize("kind", CLIENTS)
def test_comm_barrier_fault_site_breaks_a_fence(tmp_path, kind):
    """The comm.barrier site fires before every named fence, so a chaos
    plan breaks one on schedule; the next fence passes."""
    c0, c1 = _pair(tmp_path, kind)
    plan = faults.FaultPlan(seed=0).fail_at(faults.COMM_BARRIER, 1)
    with plan:
        with pytest.raises(InjectedFault):
            c0.barrier("fence-a", timeout=1.0)
        t = threading.Thread(target=c1.barrier, args=("fence-b", 5.0))
        t.start()
        c0.barrier("fence-b", timeout=5.0)
        t.join(timeout=5)
    assert plan.fired[faults.COMM_BARRIER] == 1
