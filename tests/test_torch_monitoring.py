"""The port's monitoring package (deeplearning4j_tpu_torch/monitoring/) on
the CPU: the contracts of the JAX package's tests/test_monitoring.py,
tests/test_events.py and tests/test_stragglers.py that hold without a
trainer or a dashboard — the registry, the disabled fast path, spans and
the Chrome trace, the event journal and its incidents, the post-mortem
bundle, the SLO tracker, the straggler attribution over a published
digest — plus what the port redid on torch (memory telemetry, the
profiler's surface) and parity with the JAX package: the same registry
operations give the same Prometheus exposition text, and both packages
export the same names and metric names."""
import glob
import json
import re
import threading

import pytest
import torch

from deeplearning4j_tpu import monitoring as jmon
from deeplearning4j_tpu.monitoring.registry import \
    MetricsRegistry as JaxRegistry
from deeplearning4j_tpu_torch import monitoring as mon
from deeplearning4j_tpu_torch.monitoring import events as ev
from deeplearning4j_tpu_torch.monitoring import memory as memmod
from deeplearning4j_tpu_torch.monitoring import profiler
from deeplearning4j_tpu_torch.monitoring import requests as reqmod
from deeplearning4j_tpu_torch.monitoring import slo
from deeplearning4j_tpu_torch.monitoring import steps as steps_mod
from deeplearning4j_tpu_torch.monitoring import stragglers
from deeplearning4j_tpu_torch.monitoring.registry import MetricsRegistry
from deeplearning4j_tpu_torch.monitoring.tracing import Tracer
from deeplearning4j_tpu_torch.util.crash_reporting import CrashReportingUtil


@pytest.fixture(autouse=True)
def _monitoring_off_after():
    """Every test leaves monitoring off and the process-global journal,
    tracer, recorder, request log and SLO tracker empty."""
    ev.reset()
    yield
    mon.disable()
    mon.get_tracer().clear()
    ev.reset()
    steps_mod.recorder().clear()
    reqmod.log().clear()
    slo.clear_tracker()


# ===================== registry semantics ==============================
def test_counter_gauge_semantics():
    reg = MetricsRegistry()
    c = reg.counter("req.total")
    c.inc()
    c.inc(4)
    assert c.value == 5
    assert reg.counter("req.total") is c
    g = reg.gauge("queue.depth")
    g.set(3)
    g.inc()
    g.dec(0.5)
    assert g.value == pytest.approx(3.5)


def test_histogram_quantiles_snapshot_and_bounded_reservoir():
    reg = MetricsRegistry()
    h = reg.histogram("lat")
    for v in range(1, 101):
        h.observe(v)
    assert h.count == 100 and h.sum == pytest.approx(5050)
    assert h.quantile(0.5) == pytest.approx(50, abs=1)
    assert h.quantile(0.99) == pytest.approx(99, abs=1)
    snap = h.snapshot()
    assert snap["min"] == 1 and snap["max"] == 100
    json.dumps(reg.snapshot())
    small = reg.histogram("lat2", reservoir=64)
    for v in range(10_000):
        small.observe(float(v))
    assert small.count == 10_000 and len(small._ring) == 64
    assert small.quantile(0.5) > 9_000


def test_labels_make_distinct_children_and_kind_conflict_raises():
    reg = MetricsRegistry()
    a = reg.counter("hits", labels={"route": "/a"})
    b = reg.counter("hits", labels={"route": "/b"})
    a.inc(2)
    b.inc(3)
    assert a is not b and a.value == 2 and b.value == 3
    with pytest.raises(TypeError):
        reg.gauge("hits", labels={"route": "/a"})
    assert reg.get("hits", labels={"route": "/a"}) is a
    assert reg.get("nope") is None


def test_prometheus_text_format():
    reg = MetricsRegistry()
    reg.counter("dl4j.test.count", help="a counter").inc(7)
    reg.gauge("dl4j.test.gauge", labels={"device": "cuda:0"}).set(1.5)
    h = reg.histogram("dl4j.test.lat")
    for v in (1.0, 2.0, 3.0, 4.0):
        h.observe(v)
    text = reg.prometheus_text()
    assert "# TYPE dl4j_test_count counter" in text
    assert "dl4j_test_count 7" in text
    assert '# HELP dl4j_test_count a counter' in text
    assert 'dl4j_test_gauge{device="cuda:0"} 1.5' in text
    assert "# TYPE dl4j_test_lat summary" in text
    assert "dl4j_test_lat_count 4" in text
    sample = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{.*\})? \S+$")
    for line in text.strip().splitlines():
        if not line.startswith("#"):
            assert sample.match(line), line


def _registry_ops(reg, gen_names):
    """One fixed sequence of registry operations (the serving series)."""
    reg.counter(gen_names.GEN_TOKENS, help="tokens generated").inc(641)
    reg.counter(gen_names.GEN_REPLAYS, help="replays").inc(20)
    for action, n in (("refuse_growth", 2), ("shed_queue", 1),
                      ("shrink", 1)):
        reg.counter(gen_names.GEN_DEGRADATIONS, labels={"action": action},
                    help="ladder events").inc(n)
    reg.gauge(gen_names.GEN_ACTIVE_SLOTS, help="occupied").set(8)
    reg.gauge(gen_names.DEVICE_MEMORY_BYTES,
              labels={"device": "cuda:0", "stat": "bytes_in_use"},
              help="device memory").set(5791088640.0)
    h = reg.histogram(gen_names.GEN_PER_TOKEN_MS, help="per token",
                      reservoir=128)
    for i in range(300):
        h.observe(4.0 + (i * 37 % 101) / 100.0, trace_id=f"t{i % 7}")
    reg.histogram(gen_names.GEN_PREFILL_MS, help="prefill").observe(1.25)


def test_prometheus_exposition_text_equals_the_jax_packages():
    """Parity: the same registry operations on both packages give the
    same exposition text, byte for byte (dashboards scrape one format)."""
    ours, theirs = MetricsRegistry(), JaxRegistry()
    _registry_ops(ours, mon)
    _registry_ops(theirs, jmon)
    assert ours.prometheus_text() == theirs.prometheus_text()

    def untimed(snap):
        # exemplars carry the wall-clock time they were taken at
        for recs in snap.values():
            for rec in recs:
                for ex in rec.get("exemplars", ()):
                    ex.pop("ts")
        return json.dumps(snap, sort_keys=True)

    assert untimed(ours.snapshot()) == untimed(theirs.snapshot())


def test_exports_and_metric_names_equal_the_jax_packages():
    assert set(mon.__all__) == set(jmon.__all__)
    for name in mon.__all__:
        value = getattr(mon, name)
        if isinstance(value, str):
            assert value == getattr(jmon, name), name
    assert ev.KIND_SEVERITY == __import__(
        "deeplearning4j_tpu.monitoring.events",
        fromlist=["KIND_SEVERITY"]).KIND_SEVERITY


# ===================== the disabled fast path ==========================
def test_disabled_span_is_shared_noop_singleton():
    mon.disable()
    s1, s2 = mon.span("a"), mon.span("b")
    assert s1 is s2 is mon.NULL_SPAN
    with s1:
        pass
    assert mon.get_tracer().events() == []


def test_disabled_traced_iter_transfer_and_request_start_are_noops():
    mon.disable()
    data = [1, 2, 3]
    assert mon.traced_iter(data) is data
    reg = MetricsRegistry()
    mon.record_transfer(1 << 20, registry=reg)
    assert reg.get(mon.TRANSFER_H2D_BYTES) is None
    assert reqmod.start("generation") is None


# ===================== spans and the Chrome trace ======================
def test_span_nesting_and_chrome_trace_json(tmp_path):
    mon.enable()
    mon.get_tracer().clear()
    with mon.span("outer"):
        with mon.span("inner"):
            pass
        with mon.span("inner2"):
            pass
    path = str(tmp_path / "trace.json")
    mon.export_chrome_trace(path)
    with open(path) as f:
        doc = json.loads(f.read())
    metas = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    assert metas and metas[0]["name"] == "process_name"
    evs = [e for e in doc["traceEvents"] if e["ph"] != "M"]
    assert [e["name"] for e in evs] == ["inner", "inner2", "outer"]
    outer = evs[-1]
    for child in evs[:-1]:
        assert outer["ts"] <= child["ts"]
        assert outer["ts"] + outer["dur"] >= child["ts"] + child["dur"]
        assert child["args"]["depth"] == 1
    assert outer["args"]["depth"] == 0


def test_tracer_event_cap():
    tr = Tracer(max_events=5)
    mon.enable()
    for i in range(10):
        with tr.span(f"s{i}"):
            pass
    assert len(tr.events()) == 5
    assert tr.to_chrome_trace()["otherData"]["droppedEvents"] == 5


def test_request_timeline_lifecycle_and_exemplars():
    mon.enable()
    tl = reqmod.start("generation", meta={"prompt_len": 3})
    tl.event("enqueue")
    tl.event("admit", slot=0)
    tl.finish("length")
    got = reqmod.log().get(tl.trace_id)
    assert got is tl and tl.status == "length"
    assert [e["event"] for e in tl.events] == ["enqueue", "admit"]
    reg = MetricsRegistry()
    h = reg.histogram("lat")
    h.observe(9.0, trace_id=tl.trace_id)
    h.observe(1.0, trace_id="other")
    assert h.exemplars(top=1)[0]["trace_id"] == tl.trace_id


# ===================== the event journal ===============================
def _fake_journal(**kw):
    t = [0.0]
    kw.setdefault("window_s", 5.0)
    kw.setdefault("quiet_s", 10.0)
    return ev.reset(clock=lambda: t[0], **kw), t


def test_ring_is_bounded_ordered_and_counts_drops():
    j = ev.reset(capacity=4)
    mon.enable()
    for i in range(6):
        ev.emit("test", ev.CACHE_GROWN, attrs={"i": i})
    snap = ev.snapshot(last=None)
    assert snap["capacity"] == 4 and snap["emitted"] == 6
    assert snap["dropped"] == 2
    assert [e["seq"] for e in snap["events"]] == [3, 4, 5, 6]
    assert [e["seq"] for e in ev.snapshot(last=2)["events"]] == [5, 6]
    assert j.snapshot(last=0)["events"] == []


def test_disabled_emit_is_a_noop_behind_one_branch():
    mon.disable()
    assert ev.emit("test", ev.SERVER_DEAD, attrs={"reason": "x"}) is None
    snap = ev.snapshot(last=None)
    assert snap["emitted"] == 0 and snap["events"] == []
    assert ev.incidents()["open"] == []


@pytest.mark.parametrize("kind", sorted(ev.KIND_SEVERITY))
def test_kind_catalog_severity_opens_incidents_on_errors(kind):
    j = ev.EventJournal(capacity=8)
    e = j.emit("test", kind)
    assert e["severity"] == ev.KIND_SEVERITY[kind]
    assert (len(j.incidents()["open"]) == 1) == (e["severity"] == "error")


def test_incident_trigger_actions_resolution_and_links():
    j, t = _fake_journal()
    mon.enable()
    ev.emit("generation", ev.SERVER_DISRUPTED,
            attrs={"error": "InjectedFault"}, correlation_id="g1")
    t[0] = 1.0
    ev.emit("generation", ev.SERVER_REPLAY, attrs={"request": "req-a"},
            correlation_id="g1")
    t[0] = 2.5
    ev.emit("generation", ev.SERVER_RECOVERED, attrs={"via": "replay"},
            correlation_id="g1")
    inc = ev.incidents()
    assert inc["open"] == [] and inc["resolved_total"] == 1
    snap = inc["recent"][0]
    assert snap["kinds"] == [ev.SERVER_DISRUPTED, ev.SERVER_REPLAY,
                             ev.SERVER_RECOVERED]
    assert snap["resolution"] == ev.SERVER_RECOVERED
    assert snap["duration_s"] == pytest.approx(2.5)
    assert snap["links"]["requests"] == ["/requests/req-a"]


def test_incident_window_quiet_close_and_correlation_beyond_window():
    j, t = _fake_journal(window_s=5.0, quiet_s=10.0)
    mon.enable()
    ev.emit("resilience", ev.WATCHDOG_STALL)
    t[0] = 3.0
    ev.emit("resilience", ev.GUARDIAN_RETRY)
    assert len(ev.incidents()["open"]) == 1
    t[0] = 20.0
    inc = ev.incidents()
    assert inc["open"] == [] and inc["recent"][0]["resolution"] is None
    t[0] = 30.0
    ev.emit("parallel", ev.PEER_LOST, correlation_id="peers-0")
    t[0] = 38.0
    ev.emit("parallel", ev.MEMBERSHIP_REPLACED, correlation_id="peers-0")
    assert ev.incidents()["open"][0]["kinds"] == [ev.PEER_LOST,
                                                  ev.MEMBERSHIP_REPLACED]
    t[0] = 44.5
    ev.emit("generation", ev.SERVER_DEAD, correlation_id="other")
    assert len(ev.incidents()["open"]) == 2


def test_quiet_sweep_closes_every_stale_incident_and_keeps_fresh_ones():
    j, t = _fake_journal(window_s=1.0, quiet_s=10.0)
    mon.enable()
    ev.emit("resilience", ev.WATCHDOG_STALL, correlation_id="a")
    t[0] = 2.0
    ev.emit("parallel", ev.PEER_LOST, correlation_id="b")
    t[0] = 4.0
    ev.emit("generation", ev.SERVER_DEAD, correlation_id="c")
    assert len(ev.incidents()["open"]) == 3
    t[0] = 13.0
    ev.emit("generation", ev.SERVER_RESTARTED, correlation_id="c")
    inc = ev.incidents()
    assert [i["trigger"]["correlation_id"] for i in inc["open"]] == ["c"]
    assert inc["resolved_total"] == 2
    t[0] = 30.0
    inc = ev.incidents()
    assert inc["open"] == [] and inc["resolved_total"] == 3


def test_env_knobs_size_the_ring_and_correlator(monkeypatch):
    monkeypatch.setenv("DL4J_EVENT_RING", "7")
    monkeypatch.setenv("DL4J_INCIDENT_WINDOW", "2.5")
    monkeypatch.setenv("DL4J_INCIDENT_QUIET", "20")
    j = ev.EventJournal()
    assert j.capacity == 7 and j.window_s == 2.5 and j.quiet_s == 20.0
    monkeypatch.setenv("DL4J_EVENT_RING", "bogus")
    assert ev.EventJournal().capacity == 512


def test_journal_metrics_published_on_the_registry():
    ev.reset(capacity=2)
    mon.enable()
    reg = mon.get_registry()
    emitted0 = reg.counter(mon.EVENTS_EMITTED).value
    ev.emit("generation", ev.SERVER_DISRUPTED, correlation_id="m1")
    ev.emit("generation", ev.SERVER_REPLAY, correlation_id="m1")
    ev.emit("generation", ev.SERVER_RECOVERED, correlation_id="m1")
    assert reg.counter(mon.EVENTS_EMITTED).value - emitted0 == 3
    assert reg.gauge(mon.EVENTS_DROPPED).value == 1
    assert reg.gauge(mon.INCIDENTS_RESOLVED).value == 1


def test_emission_is_thread_safe_and_totally_ordered():
    ev.reset(capacity=4096)
    mon.enable()

    def pump(k):
        for _ in range(100):
            ev.emit("test", ev.CACHE_GROWN, attrs={"w": k})

    threads = [threading.Thread(target=pump, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    seqs = [e["seq"] for e in ev.snapshot(last=None)["events"]]
    assert len(seqs) == 400 and seqs == sorted(seqs)
    assert len(set(seqs)) == 400


def test_bundle_has_all_seven_sections_and_roundtrips(tmp_path):
    mon.enable()
    ev.emit("test", ev.SERVER_DISRUPTED, correlation_id="b1")
    ev.emit("test", ev.SERVER_RECOVERED, correlation_id="b1")
    path = ev.write_bundle(dump_dir=str(tmp_path), headline="unit test")
    with open(path) as f:
        doc = json.load(f)
    assert tuple(doc["meta"]["sections"]) == ev.BUNDLE_SECTIONS
    for section in ev.BUNDLE_SECTIONS:
        assert section in doc, section
    assert doc["events"]["emitted"] == 2
    assert doc["incidents"]["resolved_total"] == 1
    assert "records" in doc["steps"] and "recent" in doc["requests"]
    # the health section is the port's own resilience.health_snapshot()
    assert doc["health"]["status"] in ("ok", "degraded", "serving_dead")
    assert doc["health"]["guardian"] is None


def test_crash_dump_embeds_journal_tail_and_writes_bundle(tmp_path):
    mon.enable()
    ev.emit("generation", ev.SERVER_SHED, attrs={"shed": 3},
            correlation_id="crash")
    path = CrashReportingUtil.writeMemoryCrashDump(
        object(), torch.cuda.OutOfMemoryError("CUDA out of memory."),
        path=str(tmp_path / "dump.txt"))
    text = open(path).read()
    assert "Ops event journal (tail):" in text
    assert ev.SERVER_SHED in text and "corr=crash" in text
    bundles = glob.glob(str(tmp_path / "dl4j-bundle-*.json"))
    assert len(bundles) == 1
    assert set(ev.BUNDLE_SECTIONS) <= set(json.load(open(bundles[0])))


def test_slo_breach_and_recover_events_close_the_incident():
    mon.enable()
    reg = MetricsRegistry()
    h = reg.histogram("lat", reservoir=64)
    fake = [0.0]
    obj = slo.LatencyObjective("per_token_p99", metric="lat",
                               max_value=5.0)
    obj.measure = lambda registry=None, _o=obj, _r=reg: \
        slo.LatencyObjective.measure(_o, registry=_r)
    tr = slo.SloTracker([obj], clock=lambda: fake[0], short_window=10.0,
                        long_window=40.0, min_interval=0.0)
    h.observe(1.0)
    for _ in range(15):
        fake[0] += 2.0
        tr.evaluate(force=True)
    for _ in range(64):
        h.observe(100.0)
    for _ in range(9):
        fake[0] += 2.0
        tr.evaluate(force=True)
    assert tr.breaches() == ["per_token_p99"]
    for _ in range(64):
        h.observe(0.1)
    for _ in range(30):
        fake[0] += 2.0
        tr.evaluate(force=True)
    assert tr.breaches() == []
    kinds = [e["kind"] for e in ev.snapshot(last=None)["events"]]
    assert kinds == [ev.SLO_BREACH, ev.SLO_RECOVER]
    assert ev.incidents()["recent"][0]["resolution"] == ev.SLO_RECOVER


def test_slo_breach_degrades_the_health_snapshot():
    from deeplearning4j_tpu_torch.resilience import health_snapshot
    reg = MetricsRegistry()
    h = reg.histogram("lat", reservoir=16)
    for _ in range(16):
        h.observe(100.0)
    obj = slo.LatencyObjective("p99", metric="lat", max_value=5.0)
    obj.measure = lambda registry=None, _o=obj, _r=reg: \
        slo.LatencyObjective.measure(_o, registry=_r)
    fake = [0.0]
    tr = slo.SloTracker([obj], clock=lambda: fake[0], short_window=4.0,
                        long_window=8.0, min_interval=0.0)
    for _ in range(8):
        fake[0] += 1.0
        tr.evaluate(force=True)
    tr.install()
    try:
        snap = health_snapshot()
        assert snap["slo"] is not None and snap["status"] == "degraded"
    finally:
        slo.clear_tracker()


# ===================== steps and stragglers ============================
class _KV:
    """The slice of a coordinator that `stragglers` reads: a process id, a
    step, and a shared key-value directory."""

    def __init__(self, store, pid):
        self.store, self.process_id, self.step = store, pid, 0

    def publish(self, key, value, overwrite=True):
        self.store[key] = value

    def fetch_dir(self, prefix):
        return [(k[len(prefix):], v) for k, v in sorted(self.store.items())
                if k.startswith(prefix)]


def _pair():
    store = {}
    return _KV(store, 0), _KV(store, 1)


def _feed(rec, data_ms=1.0, dispatch_ms=5.0, steps=4):
    for _ in range(steps):
        rec.on_span("fit.data_next", data_ms)
        rec.on_span("sharded.dispatch", dispatch_ms)


def _publish_pair(c0, c1, slow_dispatch_ms=60.0, fast_dispatch_ms=5.0):
    fast, slow = steps_mod.StepRecorder(), steps_mod.StepRecorder()
    _feed(fast, dispatch_ms=fast_dispatch_ms)
    _feed(slow, data_ms=2.0, dispatch_ms=slow_dispatch_ms)
    stragglers.publish(c0, recorder=fast)
    stragglers.publish(c1, recorder=slow)


def test_compact_summary_shape_and_json_roundtrip():
    rec = steps_mod.StepRecorder()
    _feed(rec, steps=6)
    d = json.loads(json.dumps(rec.compact_summary(tail=3)))
    assert d["count"] == 6
    assert set(d["phases"]) == {"data_next", "dispatch"}
    assert d["phases"]["dispatch"]["p50"] == 5.0
    assert [r["step"] for r in d["tail"]] == [4, 5, 6]


def test_publish_gather_roundtrip():
    c0, c1 = _pair()
    rec = steps_mod.StepRecorder()
    _feed(rec)
    snap = stragglers.publish(c0, recorder=rec,
                              extra={"steps_per_s": 3.5})
    assert snap["steps_per_s"] == 3.5
    stragglers.publish(c1, recorder=rec)
    got = stragglers.gather(c0)
    assert sorted(got) == [0, 1]
    assert got[0]["timeline"]["phases"]["dispatch"]["p50"] == 5.0


def test_attribution_names_slowest_host_and_phase():
    c0, c1 = _pair()
    _publish_pair(c0, c1)
    att = stragglers.attribution(c0)
    assert att["published"] == 2
    assert att["ratio"] == pytest.approx(62.0 / 6.0, rel=1e-3)
    assert att["slowest"]["host"] == "1"
    assert att["slowest"]["phase"] == "dispatch"
    assert att["slowest"]["excess_ms"] == pytest.approx(55.0)


def test_attribution_inconclusive_below_two_hosts():
    c0, _ = _pair()
    rec = steps_mod.StepRecorder()
    _feed(rec)
    stragglers.publish(c0, recorder=rec)
    att = stragglers.attribution(c0)
    assert att["ratio"] is None and att["slowest"] is None


def test_attribution_sets_gauges_on_process0_when_enabled():
    c0, c1 = _pair()
    _publish_pair(c0, c1)
    labels = {"host": "1", "phase": "dispatch"}
    stragglers.attribution(c0)
    assert mon.get_registry().get(mon.DIST_STRAGGLER_RATIO,
                                  labels) is None
    mon.enable()
    stragglers.attribution(c0)
    g = mon.get_registry().get(mon.DIST_STRAGGLER_RATIO, labels)
    assert g.value == pytest.approx(62.0 / 6.0, rel=1e-3)
    assert mon.get_registry().get(mon.DIST_STRAGGLER_SKEW_MS,
                                  labels).value == pytest.approx(56.0)


def test_derived_exchange_exposure_and_trace_lanes():
    c0, c1 = _pair()
    assert stragglers.derived_exchange_ms(c0) is None
    _publish_pair(c0, c1)
    assert stragglers.derived_exchange_ms(c0) == pytest.approx(55.0)
    lanes = stragglers.chrome_events(c0)
    names = {e["args"]["name"] for e in lanes if e["ph"] == "M"}
    assert names == {"train host 0", "train host 1"}
    assert sum(e["ph"] == "X" for e in lanes) == 8


def test_straggler_objective_breach_culprit_and_recovery():
    c0, c1 = _pair()
    obj = slo.StragglerObjective("straggler_ratio", max_ratio=2.0,
                                 coordinator=c0)
    assert obj.measure() is None
    _publish_pair(c0, c1)
    assert obj.measure() is True
    assert obj.describe()["culprit"] == {"host": "1", "phase": "dispatch"}
    _publish_pair(c0, c1, slow_dispatch_ms=5.0)
    assert obj.measure() is False


def test_step_time_objective_and_standard_objectives(monkeypatch):
    obj = slo.StepTimeObjective("step_p99", max_ms=1000.0)
    assert obj.measure() is None
    steps_mod.recorder().on_span("sharded.dispatch", 50.0)
    assert obj.measure() is False
    assert slo.standard_objectives() == []
    monkeypatch.setenv("DL4J_SLO_STEP_P99_MS", "600")
    assert [o.name for o in slo.standard_objectives()] == ["step_p99"]


# ===================== what the port redid on torch ====================
def test_device_memory_stats_on_the_cpu_is_empty_and_never_raises():
    """No CUDA device: {} — never a pretend device, never an exception —
    and the gauges a sample writes stay empty of devices."""
    assert not torch.cuda.is_available()
    assert memmod.device_memory_stats() == {}
    reg = MetricsRegistry()
    snap = memmod.sample(registry=reg)
    assert snap["devices"] == {} and memmod.last_sample() is snap
    assert reg.get(mon.DEVICE_MEMORY_SUPPORTED,
                   labels={"device": "cuda:0"}) is None


def test_device_memory_stats_reads_mem_get_info_and_the_allocator(
        monkeypatch):
    """On a card: in use = total − free from `mem_get_info` (the device,
    not the caching allocator), with the allocator's figures beside it;
    a device whose query fails reports None."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)

    def info(i):
        if i == 1:
            raise RuntimeError("device lost")
        return (30 << 30, 80 << 30)

    monkeypatch.setattr(torch.cuda, "mem_get_info", info)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: {
        "allocated_bytes.all.current": 7, "reserved_bytes.all.current": 9,
        "allocated_bytes.all.peak": 8, "num_ooms": 0})
    stats = memmod.device_memory_stats()
    assert stats["cuda:1"] is None
    assert stats["cuda:0"] == {
        "bytes_in_use": 50 << 30, "bytes_limit": 80 << 30,
        "bytes_free": 30 << 30, "allocated_bytes": 7, "reserved_bytes": 9,
        "peak_bytes_in_use": 8, "num_ooms": 0}
    reg = MetricsRegistry()
    memmod.sample(registry=reg)
    assert reg.get(mon.DEVICE_MEMORY_BYTES, labels={
        "device": "cuda:0", "stat": "bytes_limit"}).value == 80 << 30
    assert reg.get(mon.DEVICE_MEMORY_SUPPORTED,
                   labels={"device": "cuda:1"}).value == 0.0


def test_device_memory_stats_reads_one_device_or_the_ones_in_use(
        monkeypatch):
    """Given a device, only that device is read (a CPU device: {}); with
    none, only the devices where this process's allocator holds memory,
    so no other card is queried (which would open a context on it)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    read = []

    def info(i):
        read.append(i)
        return ((10, 70)[i] << 30, 80 << 30)

    monkeypatch.setattr(torch.cuda, "mem_get_info", info)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: {
        "reserved_bytes.all.current": (0, 9)[i]})
    assert set(memmod.device_memory_stats()) == {"cuda:1"}
    assert read == [1]
    read.clear()
    got = memmod.device_memory_stats("cuda:0")
    assert read == [0] and got["cuda:0"]["bytes_in_use"] == 70 << 30
    read.clear()
    assert set(memmod.device_memory_stats(torch.device("cuda"))) == {
        "cuda:1"}
    assert memmod.device_memory_stats("cpu") == {} and read == [1]


def test_footprint_walks_dicts_lists_and_tensors():
    class Net:
        _params = {"a": torch.zeros(10, 4), "layers": [
            {"W": torch.zeros(4, 4, dtype=torch.float64)}]}
        _opt_state = [torch.zeros(3, dtype=torch.int8)]

    assert memmod.footprint(Net()) == {"params_bytes": 160 + 128,
                                       "opt_state_bytes": 3,
                                       "layer_state_bytes": 0}
    reg = MetricsRegistry()
    snap = memmod.sample(registry=reg, model=Net())
    assert snap["model"]["params_bytes"] == 288
    assert reg.get(mon.MODEL_PARAMS_BYTES).value == 288


def test_memory_monitor_samples_only_while_enabled():
    reg = MetricsRegistry()
    m = memmod.MemoryMonitor(interval_s=0.01, registry=reg).start()
    try:
        mon.enable()
        deadline = threading.Event()
        for _ in range(200):
            if reg.get(mon.HOST_RSS_BYTES) is not None:
                break
            deadline.wait(0.01)
        assert reg.get(mon.HOST_RSS_BYTES).value > 0
    finally:
        m.stop()


def test_profiler_surface_arms_but_capture_waits_for_a16():
    """The capture was ROADMAP A16's (step_start raised); it is ported:
    step_start opens the window, a re-arm finishes it into a report, and
    a session that never ran fails without replacing that report."""
    session = profiler.profile_next_steps(2, device="cpu")
    assert profiler.active_session() is session
    assert profiler.status()["active"]["steps"] == 2
    session.step_start()
    assert session.state == "tracing"
    again = profiler.profile_next_steps(1, device="cpu")
    assert session.state == "done", session.error
    assert profiler.last_session() is session
    assert profiler.last_report() is session.report
    again.finish()
    assert profiler.active_session() is None
    assert again.state == "failed" and "failed" in again.render()
    assert profiler.last_report() is session.report
