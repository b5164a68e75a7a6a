"""Retry + circuit-breaker policies: a copy of
`deeplearning4j_tpu/resilience/policy.py` with its imports re-pointed at
the port (≡ the reference's SharedTrainingMaster transport retry / mesh
rejoin behavior, distilled into two reusable host-side primitives).

`RetryPolicy` — exponential backoff with deterministic seeded jitter,
attempt and wall-clock deadline budgets, and a retryable-error
classifier: transient device/runtime errors retry, device OOM never
does (retrying an OOM-ed dispatch just OOMs again and hides the real
fix — see `util/crash_reporting.py` for the mitigations we print
instead).

`CircuitBreaker` — classic closed/open/half-open. After
`failure_threshold` consecutive failures the breaker OPENS and sheds
calls with `CircuitOpenError` for `cooldown` seconds; the first call
after cooldown runs as a HALF-OPEN probe — success closes the breaker,
failure re-opens it for another cooldown.

Every retry, trip, and shed is counted through `monitoring/`
(`dl4j.resilience.*`), one flag check and no allocation when monitoring
is disabled.
"""
from __future__ import annotations

import random
import re
import threading
import time

from deeplearning4j_tpu_torch import monitoring as _mon
from deeplearning4j_tpu_torch.resilience.errors import (CircuitOpenError,
                                                  DistributedInitError,
                                                  FatalTrainingError,
                                                  InferenceTimeoutError,
                                                  PeerLostError,
                                                  PreemptionSignal,
                                                  RetryExhaustedError,
                                                  TransientError)
from deeplearning4j_tpu_torch.util.crash_reporting import CrashReportingUtil

__all__ = ["RetryPolicy", "CircuitBreaker", "default_classifier"]

#: transient device/runtime signatures (XLA/PJRT status codes and the
#: usual transport blips); word-ish bounded like crash_reporting's OOM
#: regex so ordinary ValueErrors don't read as retryable
_TRANSIENT_RE = re.compile(
    r"UNAVAILABLE|DEADLINE_EXCEEDED|ABORTED|CANCELLED|INTERNAL"
    r"|[Cc]onnection (?:reset|refused|closed)|[Bb]roken pipe"
    r"|[Tt]emporarily unavailable|[Pp]reempt|[Ss]ocket closed"
    r"|[Tt]imed? ?out")


def default_classifier(exc):
    """True when `exc` is safe to retry.

    Order matters: the explicit TYPES win over message heuristics (a
    `FatalTrainingError("preempted")` must not retry just because its
    message pattern-matches transient), and OOM wins over everything
    (a RESOURCE_EXHAUSTED that also says "try again" must NOT retry —
    reusing `CrashReportingUtil.is_oom` keeps the two subsystems'
    definitions of OOM identical); only then the transient message
    signatures."""
    if CrashReportingUtil.is_oom(exc):
        return False
    if isinstance(exc, (FatalTrainingError, RetryExhaustedError,
                        InferenceTimeoutError, DistributedInitError,
                        PeerLostError, PreemptionSignal)):
        # typed non-retryables: a deadline that fully elapsed, an
        # already-exhausted retry, a dead peer, or a preemption notice
        # must not be retried just because the class name / message
        # ("...TimeoutError", "preempted") pattern-matches transient
        # below — the bootstrap retries connects itself; a lost peer
        # needs a worker restart, not an in-process retry; a preemption
        # means EXIT, retrying it defeats the drain
        return False
    if isinstance(exc, TransientError):
        return True
    msg = f"{type(exc).__name__}: {exc}"
    return _TRANSIENT_RE.search(msg) is not None


class RetryPolicy:
    """Exponential backoff + jitter with attempt/deadline budgets.

    Deterministic: jitter comes from a seeded `random.Random`, so a
    seeded fault plan plus a seeded policy replays the exact same retry
    schedule run after run (the property the resume tests rely on).
    `sleep`/`clock` are injectable for tests.
    """

    def __init__(self, max_attempts=5, initial_backoff=0.05,
                 max_backoff=5.0, multiplier=2.0, jitter=0.1,
                 deadline=None, classifier=None, seed=0,
                 sleep=time.sleep, clock=time.monotonic):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = int(max_attempts)
        self.initial_backoff = float(initial_backoff)
        self.max_backoff = float(max_backoff)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self.deadline = None if deadline is None else float(deadline)
        self.classifier = classifier or default_classifier
        self._rng = random.Random(seed)
        self._sleep = sleep
        self._clock = clock

    def backoff(self, attempt):
        """Backoff before retry number `attempt` (1-based), jittered
        multiplicatively in [1-jitter, 1+jitter]."""
        base = min(self.max_backoff,
                   self.initial_backoff * self.multiplier ** (attempt - 1))
        if self.jitter:
            base *= 1.0 + self._rng.uniform(-self.jitter, self.jitter)
        return max(0.0, base)

    def call(self, fn, *args, on_retry=None, label="call", **kwargs):
        """Run `fn(*args, **kwargs)`, retrying classified-transient
        failures with backoff. Non-retryable errors propagate untouched
        on the spot; exhausted budgets raise `RetryExhaustedError` with
        the last failure as `__cause__`. `on_retry(attempt, exc)` runs
        before each re-attempt (the trainer restores its pre-attempt rng
        snapshot there)."""
        start = self._clock()
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn(*args, **kwargs)
            except Exception as e:  # noqa: BLE001 — classified below
                if not self.classifier(e):
                    raise
                if attempt >= self.max_attempts:
                    raise RetryExhaustedError(
                        f"{label}: gave up after {attempt} attempts",
                        last_error=e, attempts=attempt) from e
                delay = self.backoff(attempt)
                if self.deadline is not None and \
                        self._clock() - start + delay > self.deadline:
                    raise RetryExhaustedError(
                        f"{label}: retry deadline ({self.deadline:.3g}s) "
                        f"exceeded after {attempt} attempts",
                        last_error=e, attempts=attempt) from e
                if on_retry is not None:
                    on_retry(attempt, e)   # may abort (donation guard)
                # counted only after the budget checks AND on_retry
                # passed: an exhausted budget or an aborted retry never
                # slept, so it is not a retry
                if _mon.enabled():
                    reg = _mon.get_registry()
                    reg.counter(
                        _mon.RESILIENCE_RETRIES,
                        help="transient failures retried with backoff"
                    ).inc()
                    reg.histogram(
                        _mon.RESILIENCE_BACKOFF_SECONDS,
                        help="seconds slept between retry attempts"
                    ).observe(delay)
                if delay:
                    self._sleep(delay)


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
        if tripped and _mon.enabled():
            _mon.get_registry().counter(
                _mon.RESILIENCE_BREAKER_TRIPS,
                labels={"breaker": self.name},
                help="circuit breaker transitions to OPEN").inc()

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
