"""Typed errors of the port's serving path, copied from
`deeplearning4j_tpu/resilience/errors.py` (only the classes the port
raises so far). Dependency-free, as there."""
from __future__ import annotations

__all__ = ["ResilienceError", "CircuitOpenError", "InferenceTimeoutError",
           "InferenceOverloadedError", "ServerDeadError"]


class ResilienceError(RuntimeError):
    """Base class for every typed resilience error."""


class CircuitOpenError(ResilienceError):
    """The circuit breaker is OPEN: calls are shed without being tried
    until the cooldown elapses (then one half-open probe is allowed)."""


class InferenceTimeoutError(ResilienceError):
    """A request missed its per-request deadline while waiting for queue
    space. The request is cancelled."""


class InferenceOverloadedError(ResilienceError):
    """The request was shed because the queue stayed full for the whole
    bounded enqueue wait — graceful degradation instead of blocking the
    caller indefinitely."""


class ServerDeadError(ResilienceError):
    """A serving loop (the GenerationServer decode thread) is permanently
    down: every in-flight and queued request was failed with this error
    and future submits refuse immediately."""
