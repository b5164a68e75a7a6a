"""Lightweight span tracing with Chrome trace-event JSON export.

`span("name")` is a context manager; nesting is tracked per thread, and
the recorded events are Chrome trace-event "X" (complete) events, so the
export loads directly into Perfetto / `chrome://tracing` and shows the
host-side phase structure of a `fit()` — data-iter / dispatch / listener
/ eval / checkpoint — that the device-side xplane trace
(`optimize/xplane.py`) cannot see.

Disabled fast path: `span()` returns a shared no-op singleton after ONE
flag check — no allocation, nothing recorded. Event storage is bounded
(`max_events`), so a forgotten `enable()` cannot leak memory over a long
training run.
"""
from __future__ import annotations

import json
import os
import threading
import time

from deeplearning4j_tpu_torch.monitoring.state import STATE
from deeplearning4j_tpu_torch.monitoring import steps as _steps


class _NullSpan:
    """Shared do-nothing span for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class Span:
    __slots__ = ("name", "args", "_tracer", "_t0")

    def __init__(self, tracer, name, args=None):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._t0 = 0

    def __enter__(self):
        self._tracer._local.stack.append(self.name)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter_ns()
        local = self._tracer._local
        stack = local.stack
        if stack and stack[-1] == self.name:
            stack.pop()
        self._tracer._record(self, self._t0, t1, len(stack),
                             exc_type is not None)
        return False


class Tracer:
    """Collects span events; thread-safe; bounded."""

    def __init__(self, max_events=200_000):
        self.max_events = int(max_events)
        self._lock = threading.Lock()
        self._events = []
        self._dropped = 0
        self._epoch_ns = time.perf_counter_ns()
        self._local = threading.local()
        self._pid = os.getpid()   # constant; skip the syscall per record
        # tid -> the SAME list object as that thread's _local.stack, so
        # a monitor thread (resilience/watchdog.py) can snapshot what
        # every thread is doing right now without cross-thread locals
        self._stacks_by_tid = {}

    def _ensure_local(self):
        if not hasattr(self._local, "stack"):
            # registering a new thread is rare — use it to evict tids of
            # exited threads, so a watchdog-less process (where
            # open_spans() never runs) doesn't pin one stack list per
            # dead span-recording thread forever
            if len(self._stacks_by_tid) > threading.active_count():
                live = {t.ident for t in threading.enumerate()}
                for tid in list(self._stacks_by_tid):
                    if tid not in live:
                        self._stacks_by_tid.pop(tid, None)
            self._local.stack = []
            self._stacks_by_tid[threading.get_ident()] = self._local.stack

    def span(self, name, args=None):
        self._ensure_local()
        return Span(self, name, args)

    def _record(self, span, t0_ns, t1_ns, depth, failed):
        ev = {
            "name": span.name,
            "cat": "host",
            "ph": "X",
            "ts": (t0_ns - self._epoch_ns) / 1e3,      # microseconds
            "dur": (t1_ns - t0_ns) / 1e3,
            "pid": self._pid,
            "tid": threading.get_ident(),
        }
        args = dict(span.args) if span.args else {}
        args["depth"] = depth
        if failed:
            args["error"] = True
        ev["args"] = args
        with self._lock:
            if len(self._events) < self.max_events:
                self._events.append(ev)
            else:
                self._dropped += 1
        # feed the step-attribution flight recorder (monitoring/steps.py):
        # reached only when monitoring is enabled (disabled spans are the
        # shared NULL_SPAN and never get here), and on_span is one dict
        # lookup for spans it doesn't track
        _steps.recorder().on_span(span.name, (t1_ns - t0_ns) / 1e6)

    def current_stack(self):
        """The CALLING thread's open-span stack, outermost first (what
        the process was doing right now — crash_reporting embeds this in
        OOM dumps so post-mortems show the phase that died)."""
        self._ensure_local()
        return list(self._local.stack)

    def open_spans(self):
        """{thread_id: open-span stack} across ALL LIVE threads that
        have recorded a span — the cross-thread view a stall watchdog
        needs (a wedged trainer thread cannot report on itself). Exited
        threads are evicted here (cold path — their stale stacks would
        otherwise read as phantom wedged threads in a stall report, and
        pin their lists forever). Best effort: stacks mutate
        concurrently; the copy is taken per list and never raises."""
        live = {t.ident for t in threading.enumerate()}
        out = {}
        for tid, stack in list(self._stacks_by_tid.items()):
            if tid not in live:
                self._stacks_by_tid.pop(tid, None)
                continue
            try:
                snap = list(stack)
            except Exception:  # noqa: BLE001 — concurrent mutation
                snap = []
            if snap:
                out[tid] = snap
        return out

    # -- export ----------------------------------------------------------
    @property
    def epoch_ns(self):
        """perf_counter origin of this tracer's timestamps — lets other
        event sources (monitoring/requests.py lanes) align with the
        span timebase when merging into one Chrome trace."""
        return self._epoch_ns

    def events(self):
        with self._lock:
            return list(self._events)

    def clear(self):
        with self._lock:
            self._events = []
            self._dropped = 0
        self._epoch_ns = time.perf_counter_ns()

    def _process_metadata(self, process_name=None):
        """Chrome "M" metadata events naming this PROCESS (and its
        span-recording threads): merged multi-process traces then
        render each process as its own named lane group instead of
        interleaving everything under one anonymous pid. The process
        index comes from the distributed bootstrap when one ran
        (resilience.faults.PROCESS_ID / DL4J_PROCESS_ID) — no jax
        import from the export path."""
        if process_name is None:
            idx = None
            import sys
            faults = sys.modules.get(
                "deeplearning4j_tpu_torch.resilience.faults")
            if faults is not None:
                idx = getattr(faults, "PROCESS_ID", None)
            if idx is None:
                idx = os.environ.get("DL4J_PROCESS_ID")
            tag = f"p{idx} " if idx is not None else ""
            process_name = f"dl4j {tag}(pid {self._pid})"
        meta = [
            {"ph": "M", "name": "process_name", "pid": self._pid,
             "args": {"name": process_name}},
        ]
        names = {t.ident: t.name for t in threading.enumerate()}
        for tid in list(self._stacks_by_tid):
            meta.append({"ph": "M", "name": "thread_name",
                         "pid": self._pid, "tid": tid,
                         "args": {"name": names.get(tid,
                                                    f"thread-{tid}")}})
        return meta

    def to_chrome_trace(self, process_name=None):
        """Chrome trace-event JSON object (the {"traceEvents": [...]}
        envelope both Perfetto and chrome://tracing load). Leads with
        real pid/process-name (and thread-name) metadata events, so
        traces from several processes concatenated into one document
        render as separate named lanes."""
        with self._lock:
            events = list(self._events)
            dropped = self._dropped
        doc = {"traceEvents": self._process_metadata(process_name)
               + events,
               "displayTimeUnit": "ms"}
        if dropped:
            doc["otherData"] = {"droppedEvents": dropped}
        return doc

    def export(self, path):
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        return path


_global_tracer = Tracer()


def get_tracer():
    return _global_tracer


def span(name, args=None):
    """THE instrumentation point: a context manager timing one phase.

    Disabled (the default): one flag check, returns the shared no-op
    singleton — no allocation, no lock, nothing recorded."""
    if not STATE.enabled:
        return NULL_SPAN
    return _global_tracer.span(name, args)


def export_chrome_trace(path):
    """Write everything recorded so far as Chrome trace-event JSON."""
    return _global_tracer.export(path)


def traced_iter(iterable, name="fit.data_next"):
    """Wrap data iteration so time spent PULLING batches (host input
    pipeline) shows as its own span per batch. Disabled → returns the
    iterable untouched (zero cost)."""
    if not STATE.enabled:
        return iterable

    def gen():
        it = iter(iterable)
        while True:
            with span(name):
                try:
                    item = next(it)
                except StopIteration:
                    return
            yield item

    return gen()
