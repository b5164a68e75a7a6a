"""On-demand device profiling sessions (ProfileSession): the port of
`deeplearning4j_tpu/monitoring/profiler.py`.

The device-side complement of the host metrics/span layer: arm a
session, run training, and the next k steps are captured with
`torch.profiler` (CPU activity always, CUDA activity when the session's
device is the card); the trace is exported as Kineto's Chrome JSON into
the trace directory and decoded by the port's `optimize/xplane.py` into a
per-op cost table — self time, category rollup, memory movers —
published three ways:

- programmatic: `session = profile_next_steps(3)` ... `session.report`
  (dict) / `session.render()` (text) / `last_report()`;
- HTTP: `POST /profile?steps=k` on the UI server arms one,
  `GET /profile` returns the latest report JSON;
- metrics: `dl4j.profile.*` (sessions, captured steps, device ms, and
  per-op gauges for the top ops).

Cost model: ZERO when disarmed — every trainer hook is one module-level
`ACTIVE is not None` branch, so an uninstrumented `fit()` pays a single
pointer compare per step. A window opens only at a step boundary
(`step_start`), and a network does not open it at a step that captures a
CUDA graph (a fresh network's first step, a new batch signature, weights
rebound): on a fresh network it opens at the first replayed step. A step
of a new signature inside an open window still captures there, and its
eager warm-up and capture then stand in the trace. A replayed graph's
kernels appear one by one.

torch.profiler allows one active profiler per process: a window that
cannot open (another profiler is running) fails the session with the
error, and `fit` goes on — as the JAX package's `start_trace` refusal
does.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time

from deeplearning4j_tpu_torch.monitoring import registry as _registry

__all__ = ["ProfileSession", "active_session", "last_report",
           "last_session", "profile_next_steps"]

#: the armed session, or None (the one-branch trainer fast path:
#: `if _prof.ACTIVE is not None: _prof.ACTIVE.step_start()`)
ACTIVE = None

_lock = threading.Lock()
_last_session = None


class ProfileSession:
    """One profiling window over k training steps.

    Lifecycle: armed → tracing → done (or failed). Trainers drive it
    through two hooks at each step boundary: `step_start()` (starts the
    torch.profiler window on the first step after arming, so the window
    always covers WHOLE steps) and `step_end()` (counts captured steps;
    on the k-th, stops the trace, decodes it, and publishes the report).
    `finish()` force-closes a window the loop abandoned early (fit
    raised / iterator exhausted); re-arming via `profile_next_steps()`
    calls it on a still-tracing predecessor so torch.profiler is never
    double-started. A window that outlives one `fit()` simply keeps
    capturing the next trainer's steps — that is the contract ("the
    next k steps of whatever runs next")."""

    def __init__(self, steps=None, trace_dir=None, device_substr=None,
                 top=25, registry=None, keep_trace=None, device=None):
        if steps is None:   # DL4J_PROFILE_STEPS sets the default window
            try:
                steps = int(os.environ.get("DL4J_PROFILE_STEPS", "3"))
            except ValueError:
                steps = 3
        self.steps = max(1, int(steps))
        # the temp dir is created LAZILY in _begin(): an armed-but-
        # replaced (or never-run) session must not leak an empty
        # dl4j-profile-* directory per POST /profile
        self._own_trace_dir = trace_dir is None
        self.trace_dir = str(trace_dir) if trace_dir is not None else None
        # None → auto: the card's "GPU" planes for a session on the
        # card (none there fails the session); otherwise those, else the
        # host-thread planes CPU traces use
        self.device_substr = device_substr
        self.top = int(top)
        self.registry = registry
        self.keep_trace = (not self._own_trace_dir if keep_trace is None
                           else bool(keep_trace))
        self.state = "armed"
        self.captured_steps = 0
        self.report = None
        self.error = None
        self._t_begin = None
        # where the traced steps run: CUDA activity is traced only for the
        # card (None: the card when there is one)
        self.device = device
        self._prof = None
        # serializes the armed→tracing→done/failed transitions: the
        # trainer thread (k-th step_end) and an HTTP re-arm thread
        # (profile_next_steps → finish) can both reach _end(); only one
        # may stop the trace and publish
        self._window_lock = threading.Lock()

    # -- trainer hooks (hot path only while armed) -----------------------
    def step_start(self):
        if self.state == "armed":
            self._begin()

    def step_end(self):
        if self.state != "tracing":
            return
        self.captured_steps += 1
        if self.captured_steps >= self.steps:
            self._end()

    # -- window control ---------------------------------------------------
    def begin(self):
        """Manually open the trace window (listener-driven mode —
        optimize.listeners.ProfilerListener; the armed/global mode uses
        step_start instead)."""
        if self.state == "armed":
            self._begin()
        return self

    def end(self):
        """Manually close the window: stop the trace, decode the xplane,
        publish the report/metrics."""
        if self.state == "tracing":
            self._end()
        return self

    def _on_card(self):
        import torch
        if self.device is not None:
            return torch.device(self.device).type == "cuda"
        return torch.cuda.is_available()

    def _begin(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        with self._window_lock:
            if self.state != "armed":   # lost the race to another opener
                return
            try:
                if self.trace_dir is None:
                    self.trace_dir = tempfile.mkdtemp(
                        prefix="dl4j-profile-")
                os.makedirs(self.trace_dir, exist_ok=True)
                if torch._C._autograd._profiler_enabled():
                    # torch.profiler does not refuse a second window: it
                    # opens it and breaks the first one's trace
                    raise RuntimeError("torch.profiler is already running "
                                       "in this process")
                acts = [ProfilerActivity.CPU]
                if self._on_card():
                    acts.append(ProfilerActivity.CUDA)
                    torch.cuda.synchronize()   # the window starts clean
                prof = profile(activities=acts)
                prof.__enter__()
                self._prof = prof
            except Exception as e:  # noqa: BLE001 — must not kill fit
                self.state, self.error = "failed", f"start_trace: {e}"
            else:
                self._t_begin = time.perf_counter()
                self.state = "tracing"
                return
        _deactivate(self)
        if self._own_trace_dir and not self.keep_trace:
            self._cleanup_trace()

    def _end(self):
        import torch
        with self._window_lock:
            if self.state != "tracing":   # another thread closed it first
                return
            wall_ms = None
            try:
                # flush queued device work so the trace contains the
                # whole k-th step (≡ OpExecutioner.commit()) and the wall
                # time covers it (a graph replay returns before the card
                # is done), then stop and write Kineto's trace into the
                # trace directory
                if self._on_card():
                    torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - self._t_begin) * 1e3
                prof, self._prof = self._prof, None
                prof.__exit__(None, None, None)
                path = os.path.join(self.trace_dir, f"dl4j-profile-"
                                    f"{os.getpid()}-{id(self):x}"
                                    ".pt.trace.json")
                prof.export_chrome_trace(path)
                if not os.path.exists(path):   # Kineto only logs it
                    raise OSError(f"the trace was not written to {path}")
            except Exception as e:  # noqa: BLE001
                self.state, self.error = "failed", f"stop_trace: {e}"
            else:
                try:
                    self.report = self._build_report(wall_ms)
                    self.state = "done"
                    self._publish_metrics()
                except Exception as e:  # noqa: BLE001 — a decode bug
                    self.state = "failed"        # must not kill fit
                    self.error = f"decode: {e}"
        _deactivate(self)
        if self._own_trace_dir and not self.keep_trace:
            self._cleanup_trace()

    def finish(self):
        """Force-close: stop a still-open trace window and build the
        report from however many steps were captured. No-op unless
        armed or tracing."""
        with self._window_lock:
            never_ran = self.state == "armed"
            if never_ran:
                # never saw a step: nothing to decode
                self.state = "failed"
                self.error = "no steps ran while armed"
        if never_ran:
            _deactivate(self)
            return
        self._end()   # no-op unless tracing (checked under the lock)

    # -- decoding ---------------------------------------------------------
    def _build_report(self, wall_ms):
        from deeplearning4j_tpu_torch.optimize import xplane
        on_card = self._on_card()
        if self.device_substr is not None:
            candidates = [self.device_substr]
        elif on_card:
            # a card session's report holds device time or nothing: host
            # rows published as device_self_ms would mislead every reader
            candidates = ["GPU"]
        else:
            candidates = ["GPU", ""]
        rows, used, lines = [], "", []
        for sub in candidates:
            # one decode per candidate plane; both tables derive from it
            lines = xplane.collect_lines(self.trace_dir,
                                         device_substr=sub)
            rows = xplane.op_table(self.trace_dir, lines=lines)
            if rows:
                used = sub
                break
        if on_card and not rows:
            raise RuntimeError(
                f"the trace holds no events on its {candidates[0]!r} "
                f"planes: the profiler recorded no device activity in "
                f"this window")
        memory = xplane.memory_breakdown(self.trace_dir, lines=lines)
        report = {
            "steps": self.captured_steps,
            "wall_ms": wall_ms,
            "trace_dir": self.trace_dir if self.keep_trace else None,
            "device_substr": used,
            "device_self_ms": sum(r["self_ms"] for r in rows),
            "op_count": len(rows),
            "ops": rows[:self.top],
            "categories": xplane.category_rollup(rows),
            "memory": [{"name": n, "total_ms": ms, "bytes_accessed": b,
                        "gb_per_s": gbps}
                       for n, ms, b, gbps in memory[:self.top]],
            "ts": time.time(),
        }
        return report

    def _publish_metrics(self):
        reg = self.registry if self.registry is not None \
            else _registry.get_registry()
        reg.counter(_registry.PROFILE_SESSIONS,
                    help="completed ProfileSession windows").inc()
        reg.gauge(_registry.PROFILE_CAPTURED_STEPS,
                  help="steps captured by the last profile window") \
           .set(self.captured_steps)
        reg.gauge(_registry.PROFILE_DEVICE_MS,
                  help="device self time decoded from the last profile "
                       "window").set(self.report["device_self_ms"])
        for r in self.report["ops"][:10]:
            labels = {"op": r["name"][:80]}
            reg.gauge(_registry.PROFILE_OP_MS, labels=labels,
                      help="per-op self ms from the last profile window") \
               .set(r["self_ms"])
            reg.gauge(_registry.PROFILE_OP_COUNT, labels=labels,
                      help="per-op occurrences in the last profile "
                           "window").set(r["count"])

    def _cleanup_trace(self):
        if self.trace_dir is None:
            return
        import shutil
        try:
            shutil.rmtree(self.trace_dir, ignore_errors=True)
        except Exception:  # noqa: BLE001
            pass

    # -- presentation -----------------------------------------------------
    def render(self, top=None):
        """Text report (top-K ops + category rollup + memory movers)."""
        if self.report is None:
            return f"<ProfileSession {self.state}" + \
                (f": {self.error}>" if self.error else ">")
        from deeplearning4j_tpu_torch.optimize import xplane
        mem = [(m["name"], m["total_ms"], m["bytes_accessed"],
                m["gb_per_s"]) for m in self.report["memory"]]
        head = (f"ProfileSession: {self.report['steps']} steps, "
                f"{self.report['wall_ms']:.1f} ms wall\n"
                if self.report.get("wall_ms") else "")
        return head + xplane.render_report(self.report["ops"], mem,
                                           top=top or self.top)

    def to_json(self):
        return json.dumps({"state": self.state, "error": self.error,
                           "report": self.report})


def _deactivate(session):
    global ACTIVE, _last_session
    with _lock:
        if ACTIVE is session:
            ACTIVE = None
        # a session that failed before its window ever OPENED carries no
        # report — don't let it clobber a real one in last_report() /
        # GET /profile (e.g. a ProfilerListener whose start_trace lost to
        # an already-open global window)
        if (session._t_begin is None and session.report is None
                and _last_session is not None
                and _last_session.report is not None):
            return
        _last_session = session


def profile_next_steps(steps=None, **kwargs):
    """Arm a ProfileSession over the next `steps` training steps of
    WHATEVER trainer runs next (MultiLayerNetwork/ComputationGraph fit,
    ParallelWrapper, ShardedTrainer). Returns the session; its `.report`
    appears once the window closes. Re-arming replaces a still-armed
    session (an in-flight tracing window is finished first so
    torch.profiler isn't double-started)."""
    global ACTIVE
    with _lock:
        prev = ACTIVE
    if prev is not None:
        # unconditionally: a still-"armed" predecessor may be racing a
        # trainer thread through step_start — finish() marks it failed
        # under its window lock, so that in-flight _begin becomes a
        # no-op instead of opening a trace nothing will ever close
        prev.finish()
    session = ProfileSession(steps=steps, **kwargs)
    with _lock:
        ACTIVE = session
    return session


def active_session():
    return ACTIVE


def last_session():
    """The most recently completed (or failed) session."""
    with _lock:
        return _last_session


def last_report():
    s = last_session()
    return None if s is None else s.report


def status():
    """JSON-able status for GET /profile: the armed session (if any) and
    the last completed report."""
    with _lock:
        active, last = ACTIVE, _last_session
    out = {"active": None, "last": None}
    if active is not None:
        out["active"] = {"state": active.state, "steps": active.steps,
                         "captured_steps": active.captured_steps}
    if last is not None:
        out["last"] = {"state": last.state, "error": last.error,
                       "report": last.report}
    return out
