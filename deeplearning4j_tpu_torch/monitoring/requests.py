"""Request-scoped tracing: one bounded lifecycle timeline per served
request, with trace ids that link everything else together.

Per-process aggregates (the metrics registry) answer "is p99 bad"; this
module answers "WHICH request was slow and WHERE did its time go" —
queue vs prefill vs superstep blocks vs crash-replay. Every
`GenerationServer` and `ParallelInference` request gets a trace id at
admission; lifecycle events (enqueue, admit/prefill, each decode
block's dispatch+delivery, grow, replay, retire/shed/timeout) append to
a bounded per-request timeline. Completed timelines land in a bounded
recent ring; `GET /requests` serves the ring + the in-flight set and
`GET /requests/<id>` one timeline. The latency histograms carry
EXEMPLAR trace ids (`Histogram.observe(v, trace_id=...)`), so "p99 is
bad" on `/metrics` clicks through to an actual slow-request timeline
here. `merged_chrome_trace()` renders every timeline as its own lane
merged with the host-side `Tracer` spans — one Perfetto-loadable file
showing spans AND requests.

Cost contract (lint-enforced by scripts/check_fastpath.py):

- **Disabled path**: `start()` is ONE flag check returning None; every
  instrumented call site holds a `timeline is None` (or enabled-guard)
  branch and nothing allocates. Same discipline as `tracing.span`.
- **Hot path**: an `event()` append is pure host-side bookkeeping — a
  perf-counter read and a dict append onto a bounded list. In the
  generation decode loop the appends ride the EXISTING `_deliver_block`
  / `_fetch_tokens` host boundary (the fetched token block is already
  host data), so request tracing adds ZERO device syncs; the fast-path
  sync lint walks this module to prove no materialization hides here.
- **Bounded everywhere**: per-timeline events cap at `max_events`
  (overflow counts on `dropped`, never grows), the recent ring at
  `DL4J_REQUEST_RING` (default 256), and the active set is keyed by
  live requests only.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque

from deeplearning4j_tpu_torch.monitoring.state import STATE

__all__ = ["RequestTimeline", "RequestLog", "log", "request_log",
           "start", "merged_chrome_trace"]


class RequestTimeline:
    """Bounded event list for ONE request. Appends are GIL-atomic list
    ops (same trade as Counter.inc: a torn read under extreme
    contention is an acceptable metrics trade, never a crash)."""

    __slots__ = ("trace_id", "kind", "meta", "status", "events",
                 "dropped", "max_events", "t0_ns", "ts", "ts_end",
                 "_log")

    def __init__(self, log, trace_id, kind, meta=None, max_events=256):
        self._log = log
        self.trace_id = trace_id
        self.kind = kind
        self.meta = dict(meta) if meta else {}
        self.status = None            # None while in flight
        self.events = []
        self.dropped = 0
        self.max_events = int(max_events)
        self.t0_ns = time.perf_counter_ns()
        self.ts = time.time()
        self.ts_end = None

    def event(self, name, **fields):
        """Append one lifecycle event (host-side only: a perf-counter
        read + a dict append; MUST stay free of device access — the
        fast-path sync lint walks this). A finished timeline is
        immutable: a worker racing the client's timeout (claim vs
        cancel) must not append a 'dispatch' after the terminal
        event."""
        if self.status is not None:
            return self
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return self
        ev = {"t_ms": round((time.perf_counter_ns() - self.t0_ns) / 1e6,
                            3),
              "event": name}
        if fields:
            ev.update(fields)
        self.events.append(ev)
        return self

    def finish(self, status="ok"):
        """Terminal: record the status, move from the active set to the
        recent ring. Idempotent — the first status wins (a request must
        never finish twice with different verdicts)."""
        if self.status is not None:
            return self
        self.status = str(status)
        self.ts_end = time.time()
        if self._log is not None:
            self._log._retire(self)
        return self

    def snapshot(self):
        out = {"trace_id": self.trace_id, "kind": self.kind,
               "status": self.status, "ts": self.ts,
               "ts_end": self.ts_end, "events": list(self.events)}
        if self.meta:
            out["meta"] = dict(self.meta)
        if self.dropped:
            out["dropped_events"] = self.dropped
        return out


class RequestLog:
    """Process-global request-timeline store: the in-flight set plus a
    bounded ring of recently finished timelines."""

    def __init__(self, capacity=None):
        if capacity is None:
            try:
                capacity = max(16, int(os.environ.get(
                    "DL4J_REQUEST_RING", "256")))
            except ValueError:
                capacity = 256
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._active = {}                     # trace_id -> timeline
        self._ring = deque(maxlen=self.capacity)
        self._seq = itertools.count(1)
        self._lanes = {}                      # trace_id -> chrome lane id
        self._lane_seq = itertools.count(1_000_000)
        self._pid_tag = f"{os.getpid():x}"

    def start(self, kind, meta=None, trace_id=None, max_events=256):
        if trace_id is None:
            trace_id = f"{kind[:3]}-{self._pid_tag}-{next(self._seq):06x}"
        tl = RequestTimeline(self, trace_id, kind, meta=meta,
                             max_events=max_events)
        with self._lock:
            self._active[trace_id] = tl
        return tl

    def _retire(self, tl):
        with self._lock:
            self._active.pop(tl.trace_id, None)
            self._ring.append(tl)

    def get(self, trace_id):
        """Timeline by trace id — in-flight first, then the recent
        ring; None when it aged out (or never existed)."""
        with self._lock:
            tl = self._active.get(trace_id)
            if tl is None:
                for cand in reversed(self._ring):
                    if cand.trace_id == trace_id:
                        tl = cand
                        break
        return tl

    def snapshot(self, last=32):
        """The `GET /requests` payload: in-flight timelines plus the
        `last` most recent finished ones (newest last)."""
        with self._lock:
            active = list(self._active.values())
            recent = list(self._ring)
        last = int(last)
        recent = recent[-last:] if last > 0 else []
        return {"active": [t.snapshot() for t in active],
                "recent": [t.snapshot() for t in recent],
                "ring_capacity": self.capacity}

    def clear(self):
        with self._lock:
            self._active.clear()
            self._ring.clear()
            self._lanes.clear()

    # -- chrome-trace export ----------------------------------------------
    def _lane(self, trace_id):
        lane = self._lanes.get(trace_id)
        if lane is None:
            # request lanes live far above real thread ids so they never
            # collide with the span tracer's tid space; the counter is
            # monotonic so an evicted lane id is never reissued
            lane = next(self._lane_seq)
            self._lanes[trace_id] = lane
        return lane

    def chrome_events(self, epoch_ns=None):
        """Chrome trace events rendering each timeline as its own lane:
        a thread-name metadata event per request, one "X" slice per
        stage (event k → event k+1), an instant for the terminal event.
        `epoch_ns` aligns timestamps with a Tracer's timebase."""
        pid = os.getpid()
        out = []
        with self._lock:
            timelines = list(self._active.values()) + list(self._ring)
            # lane ids stay stable across exports but never outlive
            # their timelines — the map is bounded by active + ring
            live = {tl.trace_id for tl in timelines}
            for stale in [t for t in self._lanes if t not in live]:
                del self._lanes[stale]
            lanes = {tl.trace_id: self._lane(tl.trace_id)
                     for tl in timelines}
        for tl in timelines:
            tid = lanes[tl.trace_id]
            base_us = (tl.t0_ns - (epoch_ns if epoch_ns is not None
                                   else tl.t0_ns)) / 1e3
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid,
                        "args": {"name": f"req {tl.trace_id} "
                                         f"({tl.kind})"}})
            evs = list(tl.events)
            for i, ev in enumerate(evs):
                ts = base_us + ev["t_ms"] * 1e3
                args = {k: v for k, v in ev.items()
                        if k not in ("t_ms", "event")}
                args["trace_id"] = tl.trace_id
                if i + 1 < len(evs):
                    dur = (evs[i + 1]["t_ms"] - ev["t_ms"]) * 1e3
                    out.append({"ph": "X", "cat": "request",
                                "name": ev["event"], "ts": ts,
                                "dur": max(dur, 0.0), "pid": pid,
                                "tid": tid, "args": args})
                else:
                    out.append({"ph": "i", "cat": "request",
                                "name": ev["event"], "ts": ts, "s": "t",
                                "pid": pid, "tid": tid, "args": args})
        return out


_global_log = RequestLog()


def log():
    """THE process-global request log (`GET /requests` serves it)."""
    return _global_log


#: package-namespace alias (`monitoring.request_log()` reads better
#: than `monitoring.log()` next to the metrics/span accessors)
request_log = log


def start(kind, meta=None, trace_id=None, max_events=256):
    """THE instrumentation entry point: a new request timeline, or None
    when monitoring is disabled — call sites keep the one-branch
    discipline by checking `timeline is not None` before every append
    (same contract as `tracing.span`)."""
    if not STATE.enabled:
        return None
    return _global_log.start(kind, meta=meta, trace_id=trace_id,
                             max_events=max_events)


def merged_chrome_trace():
    """One Chrome trace-event document merging the host-side span
    tracer (its own per-thread lanes, now with process metadata) with
    every request timeline as a dedicated lane — and, when a peer
    coordinator is active, one named training lane per HOST from the
    published step timelines (monitoring/stragglers.py), so cross-host
    step skew is visually obvious next to the local phases. Load in
    Perfetto."""
    import sys
    from deeplearning4j_tpu_torch.monitoring.tracing import get_tracer
    tracer = get_tracer()
    doc = tracer.to_chrome_trace()
    events = list(doc["traceEvents"]) + \
        _global_log.chrome_events(epoch_ns=tracer.epoch_ns)
    # sys.modules, never a fresh import: a trace export must not pull
    # the parallel stack (and jax.distributed with it) into a process
    # that never used it
    coord_mod = sys.modules.get("deeplearning4j_tpu_torch.parallel.coordination")
    coord = getattr(coord_mod, "ACTIVE", None) if coord_mod else None
    if coord is not None:
        try:
            from deeplearning4j_tpu_torch.monitoring import stragglers as _sg
            events += _sg.chrome_events(coord, epoch_ns=tracer.epoch_ns)
        except Exception:  # noqa: BLE001 — lanes are best-effort
            pass
    doc["traceEvents"] = events
    return doc
