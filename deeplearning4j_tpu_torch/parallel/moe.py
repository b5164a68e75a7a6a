"""Expert-parallel helpers (the `ep` mesh axis): the port of
`deeplearning4j_tpu/parallel/moe.py`.

`models/bert.py`'s MoE FFN layers route with the same top-1 switch rule
(a dense one-hot dispatch, static shapes).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["switch_router"]


def switch_router(x, router_w, num_experts):
    """Top-1 switch routing: (one-hot dispatch, gate, aux_loss). aux_loss
    is the load-balancing loss (Switch Transformer eq. 4: E · Σ mean
    dispatch · mean probability) that keeps the experts evenly used."""
    logits = x @ router_w.to(x.dtype)
    probs = torch.softmax(logits.float(), dim=-1)
    top = probs.argmax(dim=-1)
    onehot = F.one_hot(top, num_experts).to(x.dtype)
    gate = probs.amax(dim=-1).to(x.dtype)
    dims = tuple(range(onehot.ndim - 1))
    density = onehot.float().mean(dim=dims)
    mean_prob = probs.mean(dim=dims)
    aux = num_experts * (density * mean_prob).sum()
    return onehot, gate, aux
