"""In-step gradient accumulation: the port of `deeplearning4j_tpu/nn/
accum.py` (≡ `.gradientAccumulation(G)` on the configuration builder).

`accumulate` runs a group's G microbatches in order: each one's forward
sees the state (batch-norm running statistics) the one before it left,
the gradients and the loss are summed in microbatch order and divided by
G, and the caller applies ONE optimizer update. It is the JAX package's
`accum_scan` written as a loop (a CUDA graph of the whole group replaces
the scan on the card), so its sums equal an explicit sequential
accumulation loop's bit for bit. Both network classes step through it.
"""
from __future__ import annotations

import torch

__all__ = ["accumulate"]


def _keys(tree):
    return [(n, k) for n in sorted(tree) for k in sorted(tree[n])]


def accumulate(grad_fn, state, batches):
    """(mean gradients, mean loss, final state) of `batches`.

    grad_fn(state, batch) -> (loss, grads {node: {key: tensor}}, new
    state) computes one microbatch at the current parameters."""
    gsum, lsum, keys = None, None, None
    for batch in batches:
        loss, grads, state = grad_fn(state, batch)
        if gsum is None:
            keys = _keys(grads)
            gsum, lsum = [grads[n][k] for n, k in keys], loss
        else:
            gsum = torch._foreach_add(gsum, [grads[n][k] for n, k in keys])
            lsum = lsum + loss
    inv = 1.0 / len(batches)
    out = {}
    for (n, k), g in zip(keys, torch._foreach_mul(gsum, inv)):
        out.setdefault(n, {})[k] = g
    return out, lsum * inv, state
