"""Shared on/off switch for the monitoring subsystem.

One module-level flag read by every instrumentation point in the repo:
the disabled fast path is a single attribute check (`STATE.enabled`),
no allocation, no lock — trainers stay exactly as fast as before when
nobody asked for metrics. Kept in its own module so registry.py and
tracing.py (and the instrumented call sites) share one source of truth
without import cycles.
"""
from __future__ import annotations


class _MonitoringState:
    __slots__ = ("enabled",)

    def __init__(self):
        self.enabled = False


STATE = _MonitoringState()
