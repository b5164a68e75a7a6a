"""Typed errors of the port, copied whole from
`deeplearning4j_tpu/resilience/errors.py` (the class hierarchy unchanged:
`PagePoolExhaustedError` is a `MemoryPressureError`).

Kept dependency-free (no torch, no package imports) so any layer —
`parallel/inference.py`, the paging allocator, the server, user code —
can import them without cycles. Each error names the degradation mode it
represents instead of one opaque RuntimeError.
"""
from __future__ import annotations

__all__ = [
    "ResilienceError", "TransientError", "RetryExhaustedError",
    "CircuitOpenError", "InferenceTimeoutError",
    "InferenceOverloadedError", "InjectedFault", "FatalTrainingError",
    "DivergenceError", "CheckpointIntegrityError",
    "DistributedInitError", "PeerLostError", "PeerDesyncError",
    "PreemptionSignal", "ServerDeadError", "FleetDeadError",
    "MemoryPressureError", "PagePoolExhaustedError",
    "ReplayDivergedError", "WireFormatError", "MembershipChangeError",
]


class ResilienceError(RuntimeError):
    """Base class for every typed resilience error."""


class TransientError(ResilienceError):
    """An error the raiser asserts is safe to retry (device hiccup,
    preempted dispatch, transport blip). `RetryPolicy` always classifies
    this type as retryable."""


class RetryExhaustedError(ResilienceError):
    """RetryPolicy gave up: attempt budget or deadline exceeded. The
    last underlying failure rides along as `__cause__` / `.last_error`."""

    def __init__(self, message, last_error=None, attempts=0):
        super().__init__(message)
        self.last_error = last_error
        self.attempts = attempts


class CircuitOpenError(ResilienceError):
    """The circuit breaker is OPEN: calls are shed without being tried
    until the cooldown elapses (then one half-open probe is allowed)."""


class InferenceTimeoutError(ResilienceError):
    """A ParallelInference request missed its per-request deadline
    (`output(x, timeout_ms=...)`). The request is cancelled: a late
    result, if one arrives, is discarded."""


class InferenceOverloadedError(ResilienceError):
    """ParallelInference shed the request because the queue stayed full
    for the whole bounded enqueue wait — graceful degradation instead of
    blocking the caller indefinitely."""


class InjectedFault(TransientError):
    """Default exception raised by the fault-injection harness
    (`resilience/faults.py`). Transient by definition, so retry paths
    exercise their backoff logic under injection."""


class FatalTrainingError(ResilienceError):
    """A deliberately NON-retryable injected/classified failure — used by
    fault plans to simulate a process kill (the trainer must crash and
    later resume from its checkpoint, not retry through it)."""


class DivergenceError(ResilienceError):
    """The training guardian exhausted its escalation ladder
    (skip-and-count → reduced-LR retry → checkpoint rollback) and the
    run is still producing non-finite losses or grad-norm spikes.
    Deliberately non-retryable: retrying a diverged run just re-diverges
    — the fix is data/LR/config, and the model still holds the
    last-known-good (rolled-back) parameters for a post-mortem."""


class CheckpointIntegrityError(ResilienceError):
    """A checkpoint failed manifest verification on restore (checksum /
    structure mismatch, non-finite params, or a truncated write) and no
    older generation could be restored either."""


class DistributedInitError(ResilienceError):
    """Multi-host bootstrap failed LOUDLY: the coordinator never came up
    within the connect deadline, the post-init sanity barrier timed out,
    or the cluster shape (process count / device count) does not match
    what every peer expected. Deliberately typed so supervisors can tell
    'the cluster never formed' (re-schedule the whole job) from a
    mid-run peer loss (`PeerLostError`, restart one worker)."""


class PeerLostError(ResilienceError):
    """A peer process stopped heartbeating / never reached a barrier
    within the configured timeout — it was killed, wedged inside a
    collective, or partitioned. Raised on the SURVIVING host within a
    bounded time instead of hanging in the next collective forever; a
    peer-table dump is written first (`.report_path` when available)."""

    def __init__(self, message, peers=None, report_path=None):
        super().__init__(message)
        #: peer-table snapshot at detection time (pid -> info dict)
        self.peers = peers or {}
        self.report_path = report_path


class PeerDesyncError(PeerLostError):
    """Peers are alive but NOT on the same step / control decision — the
    lockstep SPMD contract is broken (e.g. one worker skipped a batch
    the others trained). Continuing would silently corrupt the model, so
    the step-agreement check fails the run instead."""


class ServerDeadError(ResilienceError):
    """A serving loop (the GenerationServer decode thread) exhausted
    its supervised-restart budget and is permanently down: every
    in-flight, replay-pending, and queued request was failed with this
    error and future submits refuse immediately. Deliberately typed so
    a fleet supervisor can tell 'replace this replica' from a transient
    per-request failure; `GET /health` reports `serving_dead`."""


class FleetDeadError(ServerDeadError):
    """Every replica behind a FleetRouter is dead and replacement is
    exhausted (or disabled): the fleet as a whole can no longer serve.
    Latched exactly like the per-replica ServerDeadError — every open
    fleet request fails with this error and future submits refuse
    immediately. Deliberately a ServerDeadError subclass so callers
    handling 'serving is down' catch both; the distinct type tells an
    operator the outage is fleet-wide, not one replaceable replica."""


class MemoryPressureError(ResilienceError):
    """The serving memory-pressure degradation ladder refused work
    instead of risking (or after observing) a device OOM: a cache
    growth past the capped rung, a queued admission shed while under
    pressure, or an in-flight request that no longer fits the shrunken
    cache rung. The server itself stays up — only the refused request
    fails."""


class PagePoolExhaustedError(MemoryPressureError):
    """The paged KV allocator ran out of physical pages even after
    evicting every cold (refcount-zero) shared page. At admission the
    request is refused typed and the server keeps serving; mid-stream
    the error carries the RESOURCE_EXHAUSTED token so the OOM
    classifier routes it through the degradation ladder (shed →
    evict-cold-pages → shrink) and crash-replay re-packs the pool from
    the journal."""

    def __init__(self, message):
        super().__init__(f"{message} (RESOURCE_EXHAUSTED: kv page pool)")


class ReplayDivergedError(ResilienceError):
    """Crash-replay re-generated a token that does not match the
    journaled (already-delivered) stream — the per-slot-key purity
    contract was violated (should never happen; a bug or nondeterminism
    in the decode path). The affected request fails typed rather than
    silently delivering a forked continuation."""


class WireFormatError(ResilienceError):
    """A sparse gradient wire message failed structural validation
    (truncated payload, count/token mismatch, non-finite threshold, or an
    out-of-range token index). The in-jit decode path poisons the
    delivered gradient to NaN so the guardian gates the step — this typed
    error is what the host-side validator (`compression.check_payload`)
    and the `wire.decode` fault site raise, so corruption is contained
    loudly, never delivered as a silent wrong gradient."""


class MembershipChangeError(ResilienceError):
    """An elastic membership transition (join admission, leave, or
    replacement re-form) failed before it could commit: the joiner died
    mid-admission, the reform barrier timed out, or the roster write was
    lost. The previous membership epoch stays authoritative — survivors
    keep training on the old roster and the transition is retried or
    abandoned, never half-applied."""


class PreemptionSignal(ResilienceError):
    """A preemption notice (SIGTERM, or the `host.preempt` injection
    site): the process must drain the in-flight step, write a final
    coordinated checkpoint, and exit cleanly. Raised to UNWIND the fit
    loop after the drain — it means 'shut down now', not 'something
    broke'; `resume_or_init` on restart continues bit-identically."""

    def __init__(self, message="preempted", step=None):
        super().__init__(message)
        self.step = step
