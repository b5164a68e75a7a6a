"""Loss functions: the part of `deeplearning4j_tpu/nn/losses.py` that the
zoo heads name (≡ nd4j-api :: lossfunctions.LossFunctions.LossFunction).

`get_loss` resolves a name at build time, as `Layer.validate` needs it.
Only `mcxent` and its alias `negativeloglikelihood` are ported so far;
every other name of the JAX catalog raises `NotImplementedError`, naming
the training slice that brings it (ROADMAP A10).

Each loss takes (labels, preact, activation, mask) where `preact` is the
layer pre-activation; softmax+MCXENT lowers to a stable log-softmax. The
scalar loss is the masked mean over examples of the per-example sum.
"""
from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.activations import get_activation

#: the JAX catalog's names that the training slice still has to port
_LATER = ("xent", "mse", "squared_loss", "l2", "mae", "l1", "hinge",
          "squared_hinge", "kl_divergence", "reconstruction_crossentropy",
          "poisson", "cosine_proximity", "mean_absolute_percentage_error",
          "mape", "wasserstein", "multilabel", "fmeasure")


def _apply_mask_mean(per_elem, mask):
    """per_elem: (batch, ...) per-element loss; returns the scalar masked
    mean over examples (sum over feature dims, mean over examples)."""
    reduce_axes = tuple(range(1, per_elem.ndim))
    per_example = per_elem.sum(dim=reduce_axes) if reduce_axes else per_elem
    if mask is None:
        return per_example.mean()
    m = mask.reshape(per_example.shape).to(per_elem.dtype)
    return (per_example * m).sum() / m.sum().clamp_min(1.0)


def _flatten_time(labels, preact, mask):
    """Fold the time dim of rank-3 (batch, time, feat) into batch."""
    if preact.ndim == 3:
        b, t, f = preact.shape
        preact = preact.reshape(b * t, f)
        labels = labels.reshape(b * t, -1)
        if mask is not None:
            mask = mask.reshape(b * t)
    return labels, preact, mask


def mcxent(labels, preact, activation="softmax", mask=None):
    labels, preact, mask = _flatten_time(labels, preact, mask)
    if activation in ("softmax", "logsoftmax"):
        logp = torch.log_softmax(preact, dim=-1)
    elif activation == "sigmoid":
        logp = torch.log(torch.clamp(torch.sigmoid(preact), 1e-10, 1.0))
    else:
        logp = torch.log(torch.clamp(get_activation(activation)(preact),
                                     1e-10, 1.0))
    return _apply_mask_mean(-(labels * logp), mask)


LOSSES = {
    "mcxent": mcxent,
    "negativeloglikelihood": mcxent,  # ND4J aliases NLL to MCXENT semantics
}


def get_loss(name):
    if callable(name):
        return name
    key = str(name).lower()
    if key in _LATER:
        raise NotImplementedError(
            f"loss '{name}' is not ported yet: it comes with the training "
            "slice (ROADMAP A10)")
    if key not in LOSSES:
        raise ValueError(
            f"Unknown loss '{name}'. Available: "
            f"{sorted(set(LOSSES) | set(_LATER))}")
    return LOSSES[key]


class LossFunction:
    MCXENT = "mcxent"
    NEGATIVELOGLIKELIHOOD = "negativeloglikelihood"
