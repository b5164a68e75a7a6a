"""Parameter constraints: the port of `deeplearning4j_tpu/nn/constraints.py`
(≡ org.deeplearning4j.nn.conf.constraint :: MaxNormConstraint,
MinMaxNormConstraint, NonNegativeConstraint, UnitNormConstraint).

The reference applies a constraint in place after each parameter update.
Here each is a function of a tensor that the training step of both
network classes applies right after the optimizer's update, inside the
step (and so inside its CUDA graph on the card).

Norms are taken per output unit (over all axes except the last), as the
JAX package takes them for dense and conv weights.
"""
from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.conf.builders import WEIGHT_KEYS

__all__ = ["BaseConstraint", "MaxNormConstraint", "MinMaxNormConstraint",
           "UnitNormConstraint", "NonNegativeConstraint",
           "apply_layer_constraints", "WEIGHT_KEYS"]

_EPS = 1e-12


class BaseConstraint:
    """Applies to weight params by default (≡ BaseConstraint.paramNames)."""

    applies_to = WEIGHT_KEYS

    def apply(self, w):
        raise NotImplementedError

    def apply_to_params(self, layer_params):
        return {k: (self.apply(v) if k in self.applies_to else v)
                for k, v in layer_params.items()}

    @staticmethod
    def _norm(w):
        axes = tuple(range(w.ndim - 1)) or (0,)
        return torch.sqrt(torch.sum(w * w, dim=axes, keepdim=True))


class MaxNormConstraint(BaseConstraint):
    """Rescale any output unit whose L2 norm exceeds maxNorm."""

    def __init__(self, maxNorm):
        self.maxNorm = float(maxNorm)

    def apply(self, w):
        norm = self._norm(w)
        return w * torch.clamp_max(self.maxNorm / (norm + _EPS),
                                   1.0).to(w.dtype)


class MinMaxNormConstraint(BaseConstraint):
    """Project each output unit's norm into [min, max]; `rate` interpolates
    between no-op (0) and full projection (1), as in the reference."""

    def __init__(self, minNorm, maxNorm, rate=1.0):
        self.minNorm = float(minNorm)
        self.maxNorm = float(maxNorm)
        self.rate = float(rate)

    def apply(self, w):
        norm = self._norm(w)
        target = torch.clamp(norm, self.minNorm, self.maxNorm)
        scale = self.rate * (target / (norm + _EPS)) + (1.0 - self.rate)
        return w * scale.to(w.dtype)


class UnitNormConstraint(BaseConstraint):
    """Force each output unit onto the unit sphere."""

    def apply(self, w):
        return w / (self._norm(w) + _EPS).to(w.dtype)


class NonNegativeConstraint(BaseConstraint):
    """Clamp negative entries to zero (elementwise)."""

    def apply(self, w):
        return torch.clamp_min(w, 0)


def apply_layer_constraints(layers, params):
    """Fold each layer's constraints over its parameter dict. `layers` is
    [(key, layer config)]; `params` the network's {key: {name: tensor}}
    (keys "0".."n-1" in a MultiLayerNetwork, node names in a
    ComputationGraph). Returns a new tree; layers without constraints keep
    their dicts."""
    out = dict(params)
    for key, layer in layers:
        cs = getattr(layer, "constraints", None)
        if not cs or key not in out:
            continue
        lp = out[key]
        for c in cs:
            lp = c.apply_to_params(lp)
        out[key] = lp
    return out
