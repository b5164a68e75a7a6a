"""On-demand profiling sessions: the session surface of
`deeplearning4j_tpu/monitoring/profiler.py`, without its capture.

The JAX package arms a `ProfileSession` over the next k training steps,
captures them with `jax.profiler` and decodes the xplane into a per-op
table. The port keeps the surface — `ProfileSession`,
`profile_next_steps`, `active_session`, `last_session`, `last_report`,
`status` and the one-branch `ACTIVE` hook — so callers and dashboards
find it where they expect. Opening a capture window (`begin()`, or
`step_start()` on an armed session) raises `NotImplementedError`: the
torch.profiler capture and its decode come with ROADMAP A16. Until then
`chip_smoke.py --profile` is the port's device trace.
"""
from __future__ import annotations

import json
import os
import threading

__all__ = ["ProfileSession", "active_session", "last_report",
           "last_session", "profile_next_steps"]

#: the armed session, or None (the one-branch trainer fast path)
ACTIVE = None

_lock = threading.Lock()
_last_session = None

_NOT_PORTED = ("ProfileSession capture is not ported yet: the "
               "torch.profiler window and its per-op decode come with "
               "ROADMAP A16")


class ProfileSession:
    """One profiling window over k steps. Lifecycle as in the JAX
    package — armed → tracing → done (or failed) — but a window never
    opens here: `begin()` and `step_start()` raise `NotImplementedError`
    (ROADMAP A16), and `finish()` closes an armed session as failed."""

    def __init__(self, steps=None, trace_dir=None, device_substr=None,
                 top=25, registry=None, keep_trace=None):
        if steps is None:   # DL4J_PROFILE_STEPS sets the default window
            try:
                steps = int(os.environ.get("DL4J_PROFILE_STEPS", "3"))
            except ValueError:
                steps = 3
        self.steps = max(1, int(steps))
        self.trace_dir = None if trace_dir is None else str(trace_dir)
        self.device_substr = device_substr
        self.top = int(top)
        self.registry = registry
        self.keep_trace = keep_trace
        self.state = "armed"
        self.captured_steps = 0
        self.report = None
        self.error = None

    # -- trainer hooks ----------------------------------------------------
    def step_start(self):
        if self.state == "armed":
            self.begin()

    def step_end(self):
        """Nothing to count: no window is ever open."""

    # -- window control ---------------------------------------------------
    def begin(self):
        raise NotImplementedError(_NOT_PORTED)

    def end(self):
        return self

    def finish(self):
        """Force-close: an armed session that never captured fails."""
        if self.state == "armed":
            self.state = "failed"
            self.error = "no steps ran while armed"
            _deactivate(self)

    # -- presentation -----------------------------------------------------
    def render(self, top=None):
        return f"<ProfileSession {self.state}" + \
            (f": {self.error}>" if self.error else ">")

    def to_json(self):
        return json.dumps({"state": self.state, "error": self.error,
                           "report": self.report})


def _deactivate(session):
    global ACTIVE, _last_session
    with _lock:
        if ACTIVE is session:
            ACTIVE = None
        _last_session = session


def profile_next_steps(steps=None, **kwargs):
    """Arm a ProfileSession over the next `steps` steps (a still-armed
    predecessor is finished first). Arming succeeds; the capture itself
    is ROADMAP A16's."""
    global ACTIVE
    with _lock:
        prev = ACTIVE
    if prev is not None:
        prev.finish()
    session = ProfileSession(steps=steps, **kwargs)
    with _lock:
        ACTIVE = session
    return session


def active_session():
    return ACTIVE


def last_session():
    """The most recently finished (failed, here) session."""
    with _lock:
        return _last_session


def last_report():
    s = last_session()
    return None if s is None else s.report


def status():
    """JSON-able status: the armed session (if any) and the last one."""
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
