"""Batch statistics over the data-parallel ranks (synchronized BatchNorm).

The JAX package trains a data-parallel BatchNorm network as one SPMD
program, so its batch statistics are the GLOBAL batch's. The port runs one
rank per device; while `parallel.ParallelWrapper` runs a step, `ACTIVE`
holds a `BatchSync` for its dp group, and the training BatchNorm
Functions (`nn.conf.layers._BNTrain`, `kernels.pointwise_conv.
_FusedConv1x1BN`) sum their per-channel statistics over it: Σx and Σx²
(Σy and Σy² from B5) in the forward, Σdz·x̂ and Σdz (from B7) in the
backward. Outside such a step `ACTIVE` is None and nothing is summed.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["ACTIVE", "BatchSync", "active"]

ACTIVE = None


class BatchSync:
    """Sums per-channel statistics over `n` ranks with `all_reduce(t)` (a
    function returning the sum of a tensor over the ranks, on its
    device)."""

    def __init__(self, all_reduce, n):
        self.all_reduce, self.n = all_reduce, int(n)

    def sum(self, *ts):
        """Each tensor summed over the ranks (one collective for all)."""
        flat = torch.cat([t.reshape(-1) for t in ts])
        out = self.all_reduce(flat)
        parts, i = [], 0
        for t in ts:
            parts.append(out[i:i + t.numel()].reshape(t.shape))
            i += t.numel()
        return parts


@contextlib.contextmanager
def active(sync):
    """`ACTIVE` = sync for the span of a step (None leaves it as it is)."""
    global ACTIVE
    prev = ACTIVE
    if sync is not None:
        ACTIVE = sync
    try:
        yield
    finally:
        ACTIVE = prev
