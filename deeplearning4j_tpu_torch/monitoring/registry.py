"""MetricsRegistry: dependency-free counters, gauges, and streaming
histograms with Prometheus text exposition.

Host-side observability for the XLA-fused world: device ops collapse into
one step executable (SURVEY §1 inversion), so the actionable numbers are
host-side — dispatch wall time, jit-cache compile events, host↔device
transfer bytes, device memory watermarks. This registry is where all of
them land; `ui/server.py` exposes it at `GET /metrics` and
`optimize/listeners.MetricsListener` feeds it per iteration.

Division of labour with the rest of the repo's observability:
- `optimize/xplane.py` + `ProfilerListener` — DEVICE-side per-op traces
  (jax.profiler / xplane.pb, viewable in TensorBoard/Perfetto);
- `ui/stats.py` StatsListener — learning diagnostics (score, update
  ratios, activation histograms) for the training dashboard;
- this module — HOST-side operational metrics in Prometheus shape, plus
  `monitoring.tracing` for span-level phase timing.

Everything is JSON-native (`snapshot()`), same idiom as `ui/stats.py`.
"""
from __future__ import annotations

import collections
import math
import re
import threading
import time

from deeplearning4j_tpu_torch.monitoring.state import STATE

# canonical metric names used by the built-in collectors (dots are
# sanitized to underscores in the Prometheus exposition)
JIT_CACHE_MISSES = "dl4j.jit.cache_misses"
JIT_COMPILE_SECONDS = "dl4j.jit.compile_seconds"
# persistent-compilation-cache tier split (runtime/executables.py wires
# jax's cache events): a "hit" skipped the XLA compile (served from the
# cross-process on-disk cache); "requests" counts every compile that
# consulted the cache, so live compiles = requests - hits. NOTE jax's
# "miss" event fires only when a NEW entry is WRITTEN — sub-threshold
# compiles (jax_persistent_cache_min_compile_time_secs/_entry_size) are
# not persisted and land in neither hits nor misses, only in requests.
JIT_PERSISTENT_HITS = "dl4j.jit.persistent_hits"
JIT_PERSISTENT_MISSES = "dl4j.jit.persistent_misses"
JIT_PERSISTENT_REQUESTS = "dl4j.jit.persistent_requests"
OP_DISPATCHES = "dl4j.op.dispatches"

# AOT serving-executable store (runtime/executables.py): two-tier cache
# of pre-compiled bucketed forwards. Steady-state serving must show ZERO
# compiles — every forward resolves in the in-memory tier; a restarted
# replica warms via disk_hits (deserialize, no XLA compile)
EXEC_COMPILES = "dl4j.exec.compiles"
EXEC_COMPILE_SECONDS = "dl4j.exec.compile_seconds"
EXEC_DISK_HITS = "dl4j.exec.disk_hits"
EXEC_DESERIALIZE_FAILURES = "dl4j.exec.deserialize_failures"
EXEC_SERIALIZE_FAILURES = "dl4j.exec.serialize_failures"
# XLA cost model per cached executable, recorded once at compile/load
# time (labels: store, signature) — the per-dispatch FLOPs/bytes
# denominator behind "as fast as the hardware allows"
EXEC_FLOPS = "dl4j.exec.flops"
EXEC_BYTES_ACCESSED = "dl4j.exec.bytes_accessed"

# shape-bucketed continuous batching (parallel/inference.py AOT path):
# padding waste = padded_rows / (rows + padded_rows); occupancy is the
# per-dispatch fill ratio rows/bucket; splits count oversized batches
# served across several max-bucket dispatches instead of a novel shape
SERVING_ROWS = "dl4j.serving.rows"
SERVING_PADDED_ROWS = "dl4j.serving.padded_rows"
SERVING_BUCKET_OCCUPANCY = "dl4j.serving.bucket_occupancy"
SERVING_SPLITS = "dl4j.serving.splits"
SERVING_STAGED_BUFFERS = "dl4j.serving.staged_buffers"
SERVING_STAGING_OCCUPANCY = "dl4j.serving.staging_occupancy"
SERVING_AOT_FALLBACKS = "dl4j.serving.aot_fallbacks"
TRANSFER_H2D_BYTES = "dl4j.transfer.host_to_device_bytes"
DEVICE_MEMORY_BYTES = "dl4j.device.memory_bytes"
DEVICE_MEMORY_SUPPORTED = "dl4j.device.memory_stats_supported"
HOST_RSS_BYTES = "dl4j.host.rss_bytes"

# resilience subsystem (resilience/ + the hardened serving/training
# paths): every retry, breaker trip, shed request, skipped batch, and
# checkpoint resume lands on one of these
RESILIENCE_RETRIES = "dl4j.resilience.retries"
RESILIENCE_BACKOFF_SECONDS = "dl4j.resilience.backoff_seconds"
RESILIENCE_BREAKER_TRIPS = "dl4j.resilience.breaker_trips"
RESILIENCE_FAULTS_INJECTED = "dl4j.resilience.faults_injected"
RESILIENCE_BATCHES_SKIPPED = "dl4j.resilience.batches_skipped"
RESILIENCE_CHECKPOINT_SAVES = "dl4j.resilience.checkpoint_saves"
RESILIENCE_RESUMES = "dl4j.resilience.resumes"
RESILIENCE_RESUME_STEP = "dl4j.resilience.resume_step"
RESILIENCE_INFERENCE_SHED = "dl4j.resilience.inference_shed"
RESILIENCE_INFERENCE_TIMEOUTS = "dl4j.resilience.inference_timeouts"
RESILIENCE_COLLECTOR_RESTARTS = "dl4j.resilience.collector_restarts"
RESILIENCE_CKPT_ORPHANS_REMOVED = "dl4j.resilience.ckpt_orphans_removed"
RESILIENCE_CKPT_FALLBACKS = "dl4j.resilience.ckpt_restore_fallbacks"

# training guardian (resilience/guardian.py): model-state health —
# device-side per-step verdicts, skipped (never-applied) updates, and
# the escalation ladder's LR retries / checkpoint rollbacks
GUARDIAN_CHECKS = "dl4j.guardian.checks"
GUARDIAN_SKIPPED_UPDATES = "dl4j.guardian.skipped_updates"
GUARDIAN_LR_RETRIES = "dl4j.guardian.lr_retries"
GUARDIAN_ROLLBACKS = "dl4j.guardian.rollbacks"
GUARDIAN_SAVES_GATED = "dl4j.guardian.saves_gated"
GUARDIAN_LAST_GOOD_STEP = "dl4j.guardian.last_good_step"

# stall watchdog (resilience/watchdog.py): per-trainer heartbeat age and
# stall trips (a step exceeding DL4J_STALL_TIMEOUT)
WATCHDOG_STALLS = "dl4j.watchdog.stalls"
WATCHDOG_BEAT_AGE_SECONDS = "dl4j.watchdog.beat_age_seconds"
WATCHDOG_DUMPS = "dl4j.watchdog.dumps"

# multi-host coordination (parallel/multihost.py): peer liveness, the
# preemption drain, barrier health, and the compressed gradient
# exchange's wire/residual telemetry
DIST_PEERS = "dl4j.dist.peers"
DIST_PEER_LOST = "dl4j.dist.peer_lost"
DIST_PREEMPTIONS = "dl4j.dist.preemptions"
DIST_BARRIER_TIMEOUTS = "dl4j.dist.barrier_timeouts"
DIST_ENCODED_BYTES = "dl4j.dist.encoded_bytes"
DIST_RESIDUAL_NORM = "dl4j.dist.residual_norm"
# in-step accumulation + bucketed/overlapped exchange (parallel/buckets
# + the accumulating trainer steps): configured knobs and the measured
# standalone exchange cost (the time overlap exists to hide)
DIST_ACCUM_MICROBATCHES = "dl4j.dist.accum_microbatches"
DIST_EXCHANGE_BUCKETS = "dl4j.dist.exchange_buckets"
DIST_BUCKET_BYTES = "dl4j.dist.bucket_bytes"
DIST_EXPOSED_EXCHANGE_MS = "dl4j.dist.exposed_exchange_ms"
DIST_ENCODER_MIGRATIONS = "dl4j.dist.encoder_migrations"
# elastic membership (parallel/membership.py): agreed membership
# changes, executed mesh re-forms (labels: kind=join|leave|replace) and
# the wall cost of the last re-form (drain save + rebuild + re-place)
DIST_REFORMS_AGREED = "dl4j.dist.reforms_agreed"
DIST_REFORMS = "dl4j.dist.reforms"
DIST_REFORM_MS = "dl4j.dist.reform_ms"
DIST_WIRE_BYTES = "dl4j.dist.wire_bytes"
# straggler attribution (monitoring/stragglers.py): process 0 computes
# per-step skew across the published per-host step timelines and names
# the slowest host AND phase — the labels on these gauges ARE the
# culprit (labels: host, phase). `ratio` is max-host / median-host
# attributed step time; `skew_ms` the slow host's absolute excess over
# the median host.
DIST_STRAGGLER_RATIO = "dl4j.dist.straggler_ratio"
DIST_STRAGGLER_SKEW_MS = "dl4j.dist.straggler_skew_ms"

# host pipeline (runtime/pipeline.py): is the host running ahead of the
# device, or blocking on it? `syncs` counts every host-blocking
# materialization (a listener-free fit should record ZERO per-step syncs),
# `host_blocked_ms` is how long each one stalled the host, and
# `prefetch_depth` samples the staging queue occupancy (0 = the device is
# waiting on the loader; full = the loader is comfortably ahead)
PIPELINE_SYNCS = "dl4j.pipeline.syncs"
PIPELINE_HOST_BLOCKED_MS = "dl4j.pipeline.host_blocked_ms"
PIPELINE_PREFETCH_DEPTH = "dl4j.pipeline.prefetch_depth"
PIPELINE_STAGED_BATCHES = "dl4j.pipeline.staged_batches"

# device profiling (monitoring/profiler.py ProfileSession): one on-demand
# jax.profiler window around k training steps, rolled up to a per-op table
PROFILE_SESSIONS = "dl4j.profile.sessions"
PROFILE_CAPTURED_STEPS = "dl4j.profile.captured_steps"
PROFILE_DEVICE_MS = "dl4j.profile.device_ms"
PROFILE_OP_MS = "dl4j.profile.op_ms"
PROFILE_OP_COUNT = "dl4j.profile.op_count"

# step-time attribution flight recorder (monitoring/steps.py)
STEP_WALL_MS = "dl4j.step.wall_ms"
STEP_PHASE_MS = "dl4j.step.phase_ms"

# model memory footprint estimates from the live trees
# (monitoring/memory.py)
MODEL_PARAMS_BYTES = "dl4j.model.params_bytes"
MODEL_OPT_STATE_BYTES = "dl4j.model.opt_state_bytes"
MODEL_LAYER_STATE_BYTES = "dl4j.model.layer_state_bytes"

# quantization (quantize/): the memory-traffic diet's observability —
# how many layers actually serve int8, how their activation scales were
# obtained, which weight-bearing layers fell back to fp (dequant
# fallbacks), and the per-model activation-traffic estimate by
# precision policy (quantize/traffic.py gauge; labels: model, policy)
QUANT_INT8_LAYERS = "dl4j.quant.int8_layers"
QUANT_CALIBRATIONS = "dl4j.quant.calibrations"
QUANT_DEQUANT_FALLBACKS = "dl4j.quant.dequant_fallbacks"
QUANT_ACTIVATION_BYTES = "dl4j.quant.activation_traffic_bytes"

# request-scoped serving metrics (monitoring/requests.py wires the
# timelines; the latency histograms carry EXEMPLAR trace ids so a bad
# p99 clicks through to an actual slow-request timeline on /requests)
INFERENCE_REQUEST_MS = "dl4j.inference.request_ms"

# SLO tracker (monitoring/slo.py): declarative objectives evaluated on
# a multi-window burn-rate rule over the histograms / flight recorder
# already collected. `breaches` counts objective trips (labels:
# objective), `burn_rate` is the current error-budget burn per window
# (labels: objective, window), `breached` is 0/1 per objective.
SLO_BREACHES = "dl4j.slo.breaches"
SLO_BURN_RATE = "dl4j.slo.burn_rate"
SLO_BREACHED = "dl4j.slo.breached"

# ops event journal + incident correlation (monitoring/events.py):
# emitted/dropped count the bounded ring's intake, open/resolved track
# the correlator — an open incident is the fleet router's drain signal
EVENTS_EMITTED = "dl4j.events.emitted"
EVENTS_DROPPED = "dl4j.events.dropped"
INCIDENTS_OPEN = "dl4j.incidents.open"
INCIDENTS_RESOLVED = "dl4j.incidents.resolved"

# cluster metrics plane (monitoring/cluster.py): per-host snapshot age
# as seen from process 0 (labels: host; host="cluster" is the max age —
# a stale host means its publishing process stopped syncing)
CLUSTER_SNAPSHOT_AGE = "dl4j.cluster.snapshot_age_seconds"

# autoregressive generation (generation/server.py): KV-cache decode loop
# with continuous-batching admission
GEN_TOKENS = "dl4j.gen.tokens"
GEN_ACTIVE_SLOTS = "dl4j.gen.active_slots"
GEN_ADMISSIONS = "dl4j.gen.admissions"
GEN_RETIREMENTS = "dl4j.gen.retirements"
GEN_PREFILL_MS = "dl4j.gen.prefill_ms"
GEN_PER_TOKEN_MS = "dl4j.gen.per_token_ms"
# serving survivability: crash-replay re-admissions, supervised decode
# restarts, and memory-pressure degradation-ladder events
GEN_REPLAYS = "dl4j.gen.replays"
GEN_RESTARTS = "dl4j.gen.restarts"
GEN_DEGRADATIONS = "dl4j.gen.degradations"
# decode superstep pipeline: multi-token block dispatches (superstep /
# draft-verify), live tokens delivered per decode dispatch, the window
# the async token fetch overlapped the next dispatch, and greedy-draft
# acceptance accounting
GEN_SUPERSTEPS = "dl4j.gen.supersteps"
GEN_TOKENS_PER_DISPATCH = "dl4j.gen.tokens_per_dispatch"
GEN_FETCH_OVERLAP_MS = "dl4j.gen.fetch_overlap_ms"
GEN_DRAFT_ACCEPTS = "dl4j.gen.draft_accepts"
GEN_DRAFT_REJECTS = "dl4j.gen.draft_rejects"
# paged KV cache: pool occupancy/sharing gauges plus prefix-dedup and
# cold-page-eviction counters (emitted on the decode dispatch boundary)
GEN_PAGES_ACTIVE = "dl4j.gen.pages_active"
GEN_PAGES_SHARED = "dl4j.gen.pages_shared"
GEN_PAGE_EVICTIONS = "dl4j.gen.page_evictions"
GEN_PREFIX_HITS = "dl4j.gen.prefix_hits"

# fleet router (generation/fleet.py): health-driven routing across
# GenerationServer replicas. `routed` counts admissions per replica
# (labels: replica), `failovers` mid-stream re-routes via journal
# replay, `replacements` supervisor-built replacement replicas;
# `healthy` and `desired_replicas` are the live roster gauge and the
# autoscale signal (queue depth x SLO burn)
FLEET_ROUTED = "dl4j.fleet.routed"
FLEET_FAILOVERS = "dl4j.fleet.failovers"
FLEET_REPLACEMENTS = "dl4j.fleet.replacements"
FLEET_HEALTHY = "dl4j.fleet.healthy"
FLEET_DESIRED_REPLICAS = "dl4j.fleet.desired_replicas"

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_RE = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(name):
    n = _NAME_RE.sub("_", str(name))
    return "_" + n if n[:1].isdigit() else n


def _esc_label_value(v):
    """Label-value escaping per the text exposition format: backslash
    first, then newline and double quote — a value containing any of
    them must round-trip through a strict scraper."""
    return str(v).replace("\\", "\\\\").replace("\n", "\\n") \
                 .replace('"', '\\"')


def _esc_help(text):
    """HELP-line escaping (the spec escapes `\\` and line feeds only;
    quotes are legal in help text)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _prom_value(v):
    """Sample-value rendering: the format spec requires `+Inf` / `-Inf`
    / `NaN` spellings — Python's `inf`/`nan` break strict scrapers."""
    if isinstance(v, float):
        if math.isnan(v):
            return "NaN"
        if math.isinf(v):
            return "+Inf" if v > 0 else "-Inf"
        return f"{v:.9g}"
    return str(v)


def _prom_labels(labels, extra=()):
    items = list(labels) + list(extra)
    if not items:
        return ""
    body = ",".join(f'{_LABEL_RE.sub("_", str(k))}="{_esc_label_value(v)}"'
                    for k, v in items)
    return "{" + body + "}"


def _render_family_header(lines, pname, kind, help_text=None):
    """The `# HELP` / `# TYPE` lines for one family — ONE rule shared
    by the local renderer and the cluster plane (monitoring/cluster.py)
    so the conformance guarantees cannot drift between them."""
    if help_text is not None:
        lines.append(f"# HELP {pname} {_esc_help(help_text)}")
    lines.append(f"# TYPE {pname} "
                 f"{'summary' if kind == 'histogram' else kind}")


def _render_sample_lines(lines, pname, kind, labelitems, rec):
    """The sample lines for one series. `rec` carries `quantiles`
    ((q, value) pairs, Nones skipped) + `count`/`sum` for histograms,
    `value` otherwise — escaping and the `+Inf`/`NaN` spellings all
    route through `_prom_labels`/`_prom_value` here, for every
    renderer."""
    if kind == "histogram":
        for q, qv in rec.get("quantiles", ()):
            if qv is not None:
                lines.append(
                    f"{pname}"
                    f"{_prom_labels(labelitems, [('quantile', q)])}"
                    f" {_prom_value(float(qv))}")
        lines.append(f"{pname}_count{_prom_labels(labelitems)} "
                     f"{int(rec.get('count', 0))}")
        lines.append(f"{pname}_sum{_prom_labels(labelitems)} "
                     f"{_prom_value(float(rec.get('sum', 0.0)))}")
    else:
        lines.append(f"{pname}{_prom_labels(labelitems)} "
                     f"{_prom_value(rec.get('value', 0))}")


class Counter:
    """Monotonic counter. inc() is lock-free on CPython (int += under the
    GIL is not torn; a lost increment under extreme contention is an
    acceptable metrics trade, same as statsd)."""

    __slots__ = ("name", "labels", "_value")
    kind = "counter"

    def __init__(self, name, labels=()):
        self.name = name
        self.labels = labels
        self._value = 0

    def inc(self, amount=1):
        self._value += amount

    @property
    def value(self):
        return self._value


class Gauge:
    __slots__ = ("name", "labels", "_value")
    kind = "gauge"

    def __init__(self, name, labels=()):
        self.name = name
        self.labels = labels
        self._value = 0.0

    def set(self, value):
        self._value = float(value)

    def inc(self, amount=1.0):
        self._value += amount

    def dec(self, amount=1.0):
        self._value -= amount

    @property
    def value(self):
        return self._value


class Histogram:
    """Streaming histogram: exact count/sum/min/max plus quantiles
    (p50/p95/p99) over a bounded ring-buffer reservoir of the most recent
    observations — O(reservoir) memory however long training runs."""

    __slots__ = ("name", "labels", "_lock", "_count", "_sum", "_min",
                 "_max", "_ring", "_ring_n", "_idx", "_exemplars")
    kind = "histogram"

    #: recent (value, trace_id, ts) observations retained for exemplar
    #: lookup — bounded, newest wins on eviction
    EXEMPLAR_WINDOW = 64

    def __init__(self, name, labels=(), reservoir=2048):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._ring = [0.0] * int(reservoir)
        self._ring_n = 0
        self._idx = 0
        self._exemplars = None      # allocated on first traced observe

    def observe(self, value, trace_id=None):
        """Record one observation; `trace_id` (optional) attaches a
        request-timeline exemplar — the top values of the recent window
        keep their trace ids (`exemplars()`), so a bad p99 links to an
        actual slow request on `GET /requests/<id>`."""
        v = float(value)
        with self._lock:
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            self._ring[self._idx] = v
            self._idx = (self._idx + 1) % len(self._ring)
            if self._ring_n < len(self._ring):
                self._ring_n += 1
            if trace_id is not None:
                if self._exemplars is None:
                    self._exemplars = collections.deque(
                        maxlen=self.EXEMPLAR_WINDOW)
                self._exemplars.append((v, str(trace_id), time.time()))

    def exemplars(self, top=5):
        """The highest-valued recent traced observations, descending:
        [{"value", "trace_id", "ts"}]. These are the trace ids behind
        the current tail of the distribution — the p99 click-through."""
        with self._lock:
            recent = list(self._exemplars) if self._exemplars else []
        recent.sort(key=lambda e: e[0], reverse=True)
        return [{"value": v, "trace_id": t, "ts": ts}
                for v, t, ts in recent[:int(top)]]

    @property
    def count(self):
        return self._count

    @property
    def sum(self):
        return self._sum

    def quantile(self, q):
        """Quantile over the reservoir (recent window); None when empty."""
        with self._lock:
            window = sorted(self._ring[:self._ring_n])
        if not window:
            return None
        pos = min(len(window) - 1,
                  max(0, int(math.ceil(q * len(window)) - 1)))
        return window[pos]

    def snapshot(self):
        with self._lock:
            window = sorted(self._ring[:self._ring_n])
            out = {"count": self._count, "sum": self._sum,
                   "min": None if self._count == 0 else self._min,
                   "max": None if self._count == 0 else self._max}
            has_ex = bool(self._exemplars)
        if has_ex:
            out["exemplars"] = self.exemplars()
        for label, q in (("p50", 0.50), ("p95", 0.95), ("p99", 0.99)):
            if window:
                pos = min(len(window) - 1,
                          max(0, int(math.ceil(q * len(window)) - 1)))
                out[label] = window[pos]
            else:
                out[label] = None
        return out


class MetricsRegistry:
    """Named metric families, each a set of label-keyed children.

    counter/gauge/histogram are get-or-create: the same (name, labels)
    always returns the same object, so call sites never cache handles
    unless they want to skip the dict lookup."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}          # (name, labelitems) -> metric
        self._help = {}             # name -> help string
        #: bumped by clear() so hot paths that cache metric handles
        #: (runtime/executioner.py) know to re-resolve them
        self.generation = 0

    def _get(self, cls, name, labels, help=None, **kw):
        key = (name, tuple(sorted((labels or {}).items())))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, labels=key[1], **kw)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{m.kind}, not {cls.kind}")
            if help:
                self._help.setdefault(name, help)
        return m

    def counter(self, name, labels=None, help=None):
        return self._get(Counter, name, labels, help)

    def gauge(self, name, labels=None, help=None):
        return self._get(Gauge, name, labels, help)

    def histogram(self, name, labels=None, help=None, reservoir=2048):
        return self._get(Histogram, name, labels, help,
                         reservoir=reservoir)

    def get(self, name, labels=None):
        """Existing metric or None (never creates)."""
        key = (name, tuple(sorted((labels or {}).items())))
        with self._lock:
            return self._metrics.get(key)

    def clear(self):
        with self._lock:
            self._metrics.clear()
            self._help.clear()
            self.generation += 1

    # -- export ----------------------------------------------------------
    def help_texts(self):
        """{metric name: help string} — the cluster renderer
        (monitoring/cluster.py) reuses the local help lines for the
        per-host-labeled families."""
        with self._lock:
            return dict(self._help)

    def snapshot(self):
        """JSON-native dump (same idiom as ui/stats records):
        {name: [{labels: {...}, ...metric fields}]}."""
        with self._lock:
            items = list(self._metrics.items())
        out = {}
        for (name, labelitems), m in items:
            rec = {"labels": dict(labelitems), "kind": m.kind}
            if isinstance(m, Histogram):
                rec.update(m.snapshot())
            else:
                rec["value"] = m.value
            out.setdefault(name, []).append(rec)
        return out

    def prometheus_text(self):
        """Prometheus text exposition format 0.0.4. Histograms are emitted
        as summaries (streaming quantiles, not cumulative buckets).
        Conformance guarantees (unit-tested): every family gets a
        `# TYPE` line (and a `# HELP` line whenever a help string was
        registered, escaped per the spec), label values escape `\\`,
        `"` and newlines, and non-finite samples render as `+Inf` /
        `-Inf` / `NaN` — strict scrapers must never choke on a value
        that came out of the registry."""
        with self._lock:
            items = sorted(self._metrics.items(), key=lambda kv: kv[0])
            helps = dict(self._help)
        lines = []
        seen_header = set()
        for (name, labelitems), m in items:
            pname = _prom_name(name)
            if pname not in seen_header:
                seen_header.add(pname)
                _render_family_header(lines, pname, m.kind,
                                      helps.get(name))
            if isinstance(m, Histogram):
                snap = m.snapshot()
                rec = {"count": snap["count"], "sum": snap["sum"],
                       "quantiles": [("0.5", snap["p50"]),
                                     ("0.95", snap["p95"]),
                                     ("0.99", snap["p99"])]}
            else:
                rec = {"value": m.value}
            _render_sample_lines(lines, pname, m.kind, labelitems, rec)
        return "\n".join(lines) + "\n"


_global_registry = MetricsRegistry()


def get_registry():
    """THE process-global registry every built-in collector feeds."""
    return _global_registry


# -- built-in collectors ---------------------------------------------------
def record_transfer(nbytes, registry=None):
    """Count host→device bytes at explicit placement points
    (jax.device_put call sites in the parallel stack). No-op when
    monitoring is disabled — one branch, no allocation."""
    if not STATE.enabled:
        return
    (registry or _global_registry).counter(
        TRANSFER_H2D_BYTES,
        help="bytes explicitly placed host-to-device").inc(int(nbytes))


def collect_device_memory(registry=None, device_stats=None):
    """Per-device memory gauges from `monitoring.memory.
    device_memory_stats()` (each CUDA device; a device whose query failed
    reports None → the `supported 0` gauge says so instead of inventing
    numbers), plus the host RSS from /proc.

    `device_stats` lets a caller that already holds a
    `{device_str: stats_or_None}` snapshot (monitoring.memory.sample)
    feed the gauges without a second memory_stats sweep; when omitted,
    the LOCAL devices are queried — this process can only meaningfully
    gauge the chips it owns."""
    reg = registry or _global_registry
    if device_stats is None:
        from deeplearning4j_tpu_torch.monitoring.memory import device_memory_stats
        device_stats = device_memory_stats()
    for dev, stats in device_stats.items():
        reg.gauge(DEVICE_MEMORY_SUPPORTED, labels={"device": dev},
                  help="1 when the backend exposes memory_stats()") \
           .set(0.0 if not stats else 1.0)
        if stats:
            for key in ("bytes_in_use", "peak_bytes_in_use",
                        "bytes_limit", "largest_free_block_bytes"):
                if key in stats:
                    reg.gauge(DEVICE_MEMORY_BYTES,
                              labels={"device": dev, "stat": key},
                              help="device memory from memory_stats()") \
                       .set(float(stats[key]))
        else:
            reg.gauge(DEVICE_MEMORY_BYTES,
                      labels={"device": dev, "stat": "bytes_in_use"},
                      help="device memory from memory_stats()").set(0.0)
    try:
        with open("/proc/self/statm") as f:
            rss_pages = int(f.read().split()[1])
        import os
        reg.gauge(HOST_RSS_BYTES, help="host process resident set size") \
           .set(rss_pages * os.sysconf("SC_PAGE_SIZE"))
    except Exception:   # noqa: BLE001 — non-Linux hosts
        pass
    return reg


def bootstrap_core_metrics(registry=None):
    """Make sure the core metric families exist (scrape targets must see
    stable series even before the first compile/transfer happens) and
    refresh the device-memory gauges. Called by the /metrics handler and
    by MetricsListener on construction."""
    reg = registry or _global_registry
    reg.counter(JIT_CACHE_MISSES,
                help="OpExecutioner.exec jit-cache misses")
    reg.histogram(JIT_COMPILE_SECONDS,
                  help="wall time of OpExecutioner.exec cache-miss "
                       "dispatches (trace+compile+first run)")
    reg.counter(OP_DISPATCHES, help="OpExecutioner.exec dispatches")
    reg.counter(TRANSFER_H2D_BYTES,
                help="bytes explicitly placed host-to-device")
    return collect_device_memory(reg)
