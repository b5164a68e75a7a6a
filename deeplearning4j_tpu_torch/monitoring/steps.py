"""Step-time attribution flight recorder.

Answers the question the per-op device trace cannot: for each training
step, where did the HOST wall time go — pulling the batch
(`data_next`), dispatching the jitted step (`dispatch`), running
listeners (`listeners`) — and how much of that was the host *blocked*
on the device (`host_blocked_ms`, from `runtime/pipeline.py`'s counted
syncs) or stalled in a jit cache-miss compile
(`runtime/executioner.py`)?

Mechanism: the span tracer (`monitoring/tracing.py`) already brackets
every phase of every fit loop; each completed span is forwarded here
(one dict lookup) and folded into the CURRENT step's accumulator. A
step-closing span ("train.listeners" in the trainer loops,
"sharded.dispatch" for the listener-free functional trainer) finalizes
the record into a bounded ring buffer. Wall time is measured
end-of-step to end-of-step, so `sum(phases) / wall` is a meaningful
coverage number (~1.0 when the loop is fully attributed; the gap is
un-spanned glue: array conversion, rng splits, group bookkeeping).

Zero-overhead when monitoring is disabled: spans don't record at all,
so nothing reaches the recorder — the trainers pay the same single
`STATE.enabled` branch as before.

Surfaces: `GET /steps` on the UI server, `recorder().summary()` /
`records()` programmatically, `dl4j.step.*` metrics, and the tail of
the ring embedded in OOM crash dumps (`util/crash_reporting.py`).
"""
from __future__ import annotations

import threading
import time
from collections import deque

from deeplearning4j_tpu_torch.monitoring.state import STATE

# span name -> attributed phase. Only TOP-LEVEL step phases appear here:
# nested spans (listener.evaluate inside train.listeners) would double
# count the wall time their parent already covers, so they are tracked
# as separate "detail" keys that stay OUT of the coverage sum.
PHASE_BY_SPAN = {
    "fit.data_next": "data_next",
    "train.stage": "stage",
    "train.dispatch": "dispatch",
    "train.scan_dispatch": "dispatch",
    "parallel.dispatch": "dispatch",
    "parallel.scan_dispatch": "dispatch",
    "sharded.dispatch": "dispatch",
    # an EXPLICIT exchange span (a trainer that dispatches its gradient
    # exchange separately from the step, e.g. a parameter-server-style
    # loop). The overlapped bucketed exchange lives INSIDE the jitted
    # dispatch, so today this phase is usually empty per-host — the
    # fleet-level exchange exposure is instead DERIVED from cross-host
    # dispatch-phase skew (monitoring/stragglers.py).
    "train.exchange": "exchange",
    "multihost.exchange": "exchange",
    "train.listeners": "listeners",
}
DETAIL_BY_SPAN = {
    "listener.evaluate": "eval",
    "listener.checkpoint": "checkpoint",
}
#: spans whose completion closes the current step record. The trainer
#: loops all end a step with "train.listeners" (even when the listener
#: list is empty); the functional ShardedTrainer has no listener phase,
#: so its dispatch span is the closer.
STEP_END_SPANS = ("train.listeners", "sharded.dispatch")

#: phases that add up to (approximately) the step wall time
SUM_PHASES = ("data_next", "stage", "dispatch", "exchange", "listeners")

#: a gap larger than this between one step's end and the next step's
#: first span means the loop was IDLE in between (a later fit() call, a
#: notebook pause, inter-epoch eval) — wall is then anchored at the
#: first span instead of the previous step's end, so one record cannot
#: report an hours-long "step" that poisons the ring's percentiles and
#: coverage
_IDLE_GAP_NS = 1_000_000_000


def _percentile(sorted_vals, q):
    if not sorted_vals:
        return None
    import math
    pos = min(len(sorted_vals) - 1,
              max(0, int(math.ceil(q * len(sorted_vals)) - 1)))
    return sorted_vals[pos]


class StepRecorder:
    """Bounded ring buffer of per-step attribution records.

    A record:
        {"step": n, "wall_ms": w, "ts": unix_ts,
         "phases": {"data_next": ms, "dispatch": ms, "listeners": ms,
                    ...detail keys...},
         "host_blocked_ms": ms, "compile_count": c, "compile_ms": m}
    """

    def __init__(self, capacity=512):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._ring = deque(maxlen=self.capacity)
        self._step = 0
        self._reset_acc()
        self._last_end_ns = None

    def _reset_acc(self):
        self._acc = {}
        self._acc_start_ns = None
        self._host_blocked_ms = 0.0
        self._compile_count = 0
        self._compile_ms = 0.0

    # -- feed points (hot path; called only when monitoring is ON) -------
    def on_span(self, name, dur_ms):
        phase = PHASE_BY_SPAN.get(name)
        if phase is None:
            detail = DETAIL_BY_SPAN.get(name)
            if detail is None:
                return
            with self._lock:
                self._mark_start_locked(dur_ms)
                self._acc[detail] = self._acc.get(detail, 0.0) + dur_ms
            return
        with self._lock:
            self._mark_start_locked(dur_ms)
            self._acc[phase] = self._acc.get(phase, 0.0) + dur_ms
            if name in STEP_END_SPANS:
                self._finalize_locked()

    def _mark_start_locked(self, dur_ms):
        # remember when this step's FIRST span began (spans report at
        # exit, so subtract the duration) — the idle-gap wall anchor
        if self._acc_start_ns is None:
            self._acc_start_ns = time.perf_counter_ns() - int(dur_ms * 1e6)

    def on_host_blocked(self, ms):
        with self._lock:
            self._host_blocked_ms += ms

    def on_compile(self, seconds):
        with self._lock:
            self._compile_count += 1
            self._compile_ms += seconds * 1e3

    def _finalize_locked(self):
        now_ns = time.perf_counter_ns()
        anchor = self._last_end_ns
        if anchor is None or (self._acc_start_ns is not None
                              and self._acc_start_ns - anchor > _IDLE_GAP_NS):
            anchor = self._acc_start_ns
        wall = None if anchor is None else (now_ns - anchor) / 1e6
        self._last_end_ns = now_ns
        self._step += 1
        rec = {
            "step": self._step,
            "wall_ms": wall,
            "ts": time.time(),
            "phases": dict(self._acc),
            "host_blocked_ms": self._host_blocked_ms,
            "compile_count": self._compile_count,
            "compile_ms": self._compile_ms,
        }
        self._ring.append(rec)
        self._reset_acc()
        # per-step metrics ride the same ON-state: one histogram observe
        # per phase per step, none of it reachable when disabled
        if STATE.enabled:
            from deeplearning4j_tpu_torch.monitoring import registry as _reg
            reg = _reg.get_registry()
            if wall is not None:
                reg.histogram(_reg.STEP_WALL_MS,
                              help="end-to-end wall time per training "
                                   "step").observe(wall)
            for phase in SUM_PHASES:
                v = rec["phases"].get(phase)
                if v is not None:
                    reg.histogram(_reg.STEP_PHASE_MS,
                                  labels={"phase": phase},
                                  help="host wall time attributed to one "
                                       "step phase").observe(v)

    # -- read side --------------------------------------------------------
    def records(self, last=None):
        with self._lock:
            recs = list(self._ring)
        if last is None:
            return recs
        last = int(last)
        # recs[-0:] would be the WHOLE ring — a bound of 0 (or less)
        # means "no records", not "all of them"
        return recs[-last:] if last > 0 else []

    def summary(self):
        """Percentile roll-up over the ring: per-phase p50/p95/p99 + mean,
        wall percentiles, attribution coverage (sum of top-level phases /
        wall), and compile/host-blocked totals."""
        recs = self.records()
        out = {"count": len(recs), "capacity": self.capacity,
               "phases": {}, "wall_ms": None, "coverage": None,
               "host_blocked_ms_total": sum(r["host_blocked_ms"]
                                            for r in recs),
               "compile_count_total": sum(r["compile_count"]
                                          for r in recs),
               "compile_ms_total": sum(r["compile_ms"] for r in recs)}
        if not recs:
            return out
        walls = sorted(r["wall_ms"] for r in recs
                       if r["wall_ms"] is not None)
        if walls:
            out["wall_ms"] = {
                "mean": sum(walls) / len(walls),
                "p50": _percentile(walls, 0.50),
                "p95": _percentile(walls, 0.95),
                "p99": _percentile(walls, 0.99),
            }
        keys = sorted({k for r in recs for k in r["phases"]})
        for k in keys:
            vals = sorted(r["phases"][k] for r in recs if k in r["phases"])
            out["phases"][k] = {
                "mean": sum(vals) / len(vals),
                "p50": _percentile(vals, 0.50),
                "p95": _percentile(vals, 0.95),
                "p99": _percentile(vals, 0.99),
                "count": len(vals),
            }
        # coverage over steps that have a wall measurement (a step with
        # no spans at all has nothing to anchor wall on)
        covs = []
        for r in recs:
            if r["wall_ms"]:
                attributed = sum(r["phases"].get(p, 0.0)
                                 for p in SUM_PHASES)
                covs.append(attributed / r["wall_ms"])
        if covs:
            out["coverage"] = sum(covs) / len(covs)
        return out

    def compact_summary(self, tail=16):
        """Bounded, KV-publishable digest of the ring: per-phase
        p50/p99 (+mean/count), wall p50/p99, blocked/compile totals,
        and a short record tail (step, ts, wall, phases) so process 0
        can render per-host trace lanes. Everything is plain JSON
        numbers — publishing is serialization of values the recorder
        already holds, never a device touch."""
        s = self.summary()
        out = {"count": s["count"],
               "host_blocked_ms_total": round(s["host_blocked_ms_total"],
                                              3),
               "compile_count_total": s["compile_count_total"],
               "compile_ms_total": round(s["compile_ms_total"], 3),
               "wall_ms": None, "phases": {}}
        if s["wall_ms"]:
            out["wall_ms"] = {"p50": round(s["wall_ms"]["p50"], 3),
                              "p99": round(s["wall_ms"]["p99"], 3)}
        for k, v in s["phases"].items():
            out["phases"][k] = {"p50": round(v["p50"], 3),
                                "p99": round(v["p99"], 3),
                                "mean": round(v["mean"], 3),
                                "count": v["count"]}
        out["tail"] = [
            {"step": r["step"], "ts": r["ts"],
             "wall_ms": (None if r["wall_ms"] is None
                         else round(r["wall_ms"], 3)),
             "phases": {k: round(v, 3) for k, v in r["phases"].items()}}
            for r in self.records(last=tail)]
        return out

    def clear(self):
        with self._lock:
            self._ring.clear()
            self._step = 0
            self._reset_acc()
            self._last_end_ns = None

    def crash_lines(self, last=8):
        """Human-readable tail for crash dumps (never raises)."""
        try:
            lines = []
            s = self.summary()
            if not s["count"]:
                return ["  (no step records)"]
            if s["wall_ms"]:
                lines.append(
                    f"  wall_ms p50={s['wall_ms']['p50']:.2f} "
                    f"p95={s['wall_ms']['p95']:.2f} over {s['count']} steps")
            for k, v in s["phases"].items():
                lines.append(f"  {k}_ms p50={v['p50']:.2f} "
                             f"p95={v['p95']:.2f}")
            lines.append(f"  compiles={s['compile_count_total']} "
                         f"({s['compile_ms_total']:.1f} ms), host_blocked="
                         f"{s['host_blocked_ms_total']:.1f} ms")
            for r in self.records(last=last):
                ph = " ".join(f"{k}={v:.2f}"
                              for k, v in sorted(r["phases"].items()))
                wall = "?" if r["wall_ms"] is None else f"{r['wall_ms']:.2f}"
                lines.append(f"  step {r['step']}: wall={wall} ms  {ph}")
            return lines
        except Exception as e:  # noqa: BLE001 — crash dumps must not raise
            return [f"  (flight recorder unavailable: {e})"]


def _default_capacity():
    import os
    try:
        return max(16, int(os.environ.get("DL4J_STEP_RING", "512")))
    except ValueError:
        return 512


_global_recorder = StepRecorder(capacity=_default_capacity())


def recorder():
    """THE process-global flight recorder the span tracer feeds.
    Ring size comes from DL4J_STEP_RING (default 512)."""
    return _global_recorder
