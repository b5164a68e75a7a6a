"""Single-device attention of `deeplearning4j_tpu/parallel/ring_attention.py`.

Only `dense_attention` is ported so far; blockwise and ring attention wait
for the `parallel/` slice.

Shapes: (B, H, T, D) throughout.
"""
from __future__ import annotations

import math

import torch

__all__ = ["dense_attention"]


def dense_attention(q, k, v, causal=False, mask=None, scale=None):
    """Reference O(T²) attention (numerics oracle for the other paths).

    Unlike the flash kernels it masks with -inf and does NOT zero
    fully-masked rows (they come back as NaN), as in the JAX package.
    The default scale is 1/√d rounded through q's dtype, as there."""
    if scale is None:
        root = torch.tensor(math.sqrt(q.shape[-1]), dtype=torch.float32)
        scale = float((1.0 / root.to(q.dtype)).float())
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    if causal:
        tq, tk = logits.shape[-2], logits.shape[-1]
        causal_mask = torch.tril(
            torch.ones((tq, tk), dtype=torch.bool, device=q.device),
            diagonal=tk - tq)
        logits = torch.where(causal_mask, logits, -math.inf)
    if mask is not None:
        logits = torch.where(mask, logits, -math.inf)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)
