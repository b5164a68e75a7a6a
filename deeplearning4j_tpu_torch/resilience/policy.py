"""The circuit breaker of `deeplearning4j_tpu/resilience/policy.py`,
copied without its monitoring hooks (which come with ROADMAP A16).

`CircuitBreaker` — classic closed/open/half-open. After
`failure_threshold` consecutive failures the breaker OPENS and sheds
calls with `CircuitOpenError` for `cooldown` seconds; the first call
after cooldown runs as a HALF-OPEN probe — success closes the breaker,
failure re-opens it for another cooldown. `RetryPolicy` comes with the
training resilience slice (ROADMAP A14).
"""
from __future__ import annotations

import threading
import time

from deeplearning4j_tpu_torch.resilience.errors import CircuitOpenError

__all__ = ["CircuitBreaker"]


class CircuitBreaker:
    """Closed/open/half-open breaker guarding a repeatedly-failing
    dependency (e.g. the inference collector thread restart path).

    Thread-safe; `clock` injectable so tests drive the cooldown without
    sleeping."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, failure_threshold=5, cooldown=30.0,
                 clock=time.monotonic, name="breaker"):
        self.failure_threshold = int(failure_threshold)
        self.cooldown = float(cooldown)
        self.name = name
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probe_inflight = False

    @property
    def state(self):
        with self._lock:
            return self._state_locked()

    def _state_locked(self):
        if self._state == self.OPEN and not self._probe_inflight and \
                self._clock() - self._opened_at >= self.cooldown:
            self._state = self.HALF_OPEN
        return self._state

    def allow(self):
        """True when a call may proceed (CLOSED, or the single HALF_OPEN
        probe after cooldown). OPEN — and HALF_OPEN with the probe still
        out — sheds without trying."""
        with self._lock:
            st = self._state_locked()
            if st == self.CLOSED:
                return True
            if st == self.HALF_OPEN and not self._probe_inflight:
                self._probe_inflight = True
                return True
            return False

    def record_success(self):
        with self._lock:
            self._probe_inflight = False
            self._state = self.CLOSED
            self._failures = 0

    def record_failure(self):
        with self._lock:
            probe_failed = self._probe_inflight or \
                self._state == self.HALF_OPEN
            self._probe_inflight = False
            self._failures += 1
            tripped = (self._state != self.OPEN or probe_failed) and \
                (probe_failed or self._failures >= self.failure_threshold)
            if tripped:
                self._state = self.OPEN
                self._opened_at = self._clock()

    def call(self, fn, *args, **kwargs):
        """Guarded call: sheds with `CircuitOpenError` when OPEN,
        otherwise runs `fn` and records the verdict."""
        if not self.allow():
            raise CircuitOpenError(
                f"{self.name}: circuit open "
                f"(cooldown {self.cooldown:.3g}s)")
        try:
            out = fn(*args, **kwargs)
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return out
