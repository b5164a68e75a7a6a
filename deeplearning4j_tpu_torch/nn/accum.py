"""In-step gradient accumulation: the port of `deeplearning4j_tpu/nn/
accum.py` (≡ `.gradientAccumulation(G)` on the configuration builder).

`accumulate` runs a group's G microbatches in order: each one's forward
sees the state (batch-norm running statistics) the one before it left,
the gradients and the loss are summed in microbatch order and divided by
G, and the caller applies ONE optimizer update. It is the JAX package's
`accum_scan` written as a loop (a CUDA graph of the whole group replaces
the scan on the card), so its sums equal an explicit sequential
accumulation loop's bit for bit. Both network classes step through it.
`accum_scan` is the same loop under the JAX package's signature: inputs
stacked on a leading G axis, and the AND of the microbatches' loss
finiteness returned beside the means.
"""
from __future__ import annotations

import torch

__all__ = ["accum_scan", "accumulate"]


def _flatten(tree):
    """The tensors of a tree of dicts (keys sorted), lists and tuples, and
    a function that rebuilds the tree from such a list."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [_flatten(v) for v in tree]
    else:
        return [tree], lambda leaves: leaves[0]
    sizes = [len(leaves) for leaves, _ in parts]

    def rebuild(leaves):
        out, i = [], 0
        for (_, unflat), n in zip(parts, sizes):
            out.append(unflat(leaves[i:i + n]))
            i += n
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out)
    return [leaf for leaves, _ in parts for leaf in leaves], rebuild


def accumulate(grad_fn, state, batches):
    """(mean gradients, mean loss, final state) of `batches`.

    grad_fn(state, batch) -> (loss, grads, new state) computes one
    microbatch at the current parameters; grads is a tree of tensors
    (dicts, lists, tuples), the same for every microbatch."""
    gsum, lsum, rebuild = None, None, None
    for batch in batches:
        loss, grads, state = grad_fn(state, batch)
        leaves, unflat = _flatten(grads)
        if gsum is None:
            gsum, lsum, rebuild = leaves, loss, unflat
        else:
            gsum = torch._foreach_add(gsum, leaves)
            lsum = lsum + loss
    inv = 1.0 / len(batches)
    return rebuild(torch._foreach_mul(gsum, inv)), lsum * inv, state


def accum_scan(grad_fn, params, state, inputs):
    """The JAX package's `accum_scan` over `accumulate`: (mean_grads,
    mean_loss, micro_ok, final_state) of the microbatches stacked on the
    leading G axis of every tensor of `inputs`.

    grad_fn(params, state, inp) -> ((loss, new_state), grads) computes one
    microbatch; `state` threads through the microbatches in order.
    micro_ok is the AND of the microbatches' loss finiteness (a bool
    tensor): a NaN loss in any microbatch shows there even where the
    gradients are finite."""
    leaves, unflat = _flatten(inputs)
    micro = [unflat([leaf[i] for leaf in leaves])
             for i in range(leaves[0].shape[0])]
    ok = []

    def one(s, inp):
        (loss, new_state), grads = grad_fn(params, s, inp)
        fin = torch.isfinite(loss)
        ok.append(fin if not ok else ok[-1] & fin)
        return loss, grads, new_state

    grads, loss, state = accumulate(one, state, micro)
    return grads, loss, ok[-1], state
