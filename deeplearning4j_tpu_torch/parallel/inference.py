"""Bounded admission shared by the port's serving front ends.

Only `bounded_enqueue` of `deeplearning4j_tpu/parallel/inference.py` is
ported so far, without its monitoring hooks; `ParallelInference` waits
for a later slice.
"""
from __future__ import annotations

import queue
import time

from deeplearning4j_tpu_torch.resilience.errors import (
    InferenceOverloadedError, InferenceTimeoutError)

__all__ = ["bounded_enqueue"]


def bounded_enqueue(q, item, deadline, enqueue_timeout, count_timeout=None,
                    what="inference"):
    """Wait at most `enqueue_timeout` seconds (clipped to the caller's
    deadline) for queue space, then SHED with `InferenceOverloadedError` —
    callers never block indefinitely. A caller deadline that expires
    while waiting raises `InferenceTimeoutError` instead (callers retry on
    overloaded, not on timeout); `count_timeout` lets the owner count that
    case on its own metric."""
    wait = enqueue_timeout
    if deadline is not None:
        wait = min(wait, max(0.0, deadline - time.monotonic()))
    try:
        if wait > 0:
            q.put(item, timeout=wait)
        else:
            q.put_nowait(item)
    except queue.Full:
        if deadline is not None and time.monotonic() >= deadline:
            if count_timeout is not None:
                count_timeout()
            raise InferenceTimeoutError(
                f"{what} request deadline expired while waiting "
                "for queue space") from None
        raise InferenceOverloadedError(
            f"{what} queue full (limit {q.maxsize}) "
            f"after {wait * 1e3:.6g} ms — request shed") from None
