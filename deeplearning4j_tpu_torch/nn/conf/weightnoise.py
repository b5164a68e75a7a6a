"""Weight-space noise: the port of `deeplearning4j_tpu/nn/conf/weightnoise.py`
(≡ deeplearning4j-nn :: conf.weightnoise.{WeightNoise, DropConnect,
IWeightNoise}).

Unlike dropout (on activations), these perturb a layer's PARAMETERS at
every training step, inside the step: the network classes hand each
layer's parameters through `nn._network.hook_params`, which draws the
noise from the network's `torch.Generator` on its device, so a CUDA graph
of the step draws fresh noise at every replay. Inference uses the clean
weights (DropConnect's inverted scaling keeps the training-time
expectation equal to them).

Usage: a layer kwarg or a builder default, `weightNoise=DropConnect(0.5)`
or `WeightNoise({"type": "normal", "std": 0.01}, additive=True)`.
"""
from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.dropout import keep_mask


def _sample(distribution, generator, shape, like):
    kind = (distribution or {}).get("type", "normal")
    if kind == "normal":
        return (distribution.get("mean", 0.0)
                + distribution.get("std", 1.0)
                * torch.randn(shape, generator=generator, dtype=like.dtype,
                              device=like.device))
    if kind == "uniform":
        lo = distribution.get("lower", -1.0)
        hi = distribution.get("upper", 1.0)
        u = torch.rand(shape, generator=generator, dtype=like.dtype,
                       device=like.device)
        return lo + (hi - lo) * u
    raise ValueError(f"Unknown weight-noise distribution type '{kind}'")


class IWeightNoise:
    """Contract: map a layer's parameters {name: tensor} to noised ones
    (training only; the caller gates on `train`)."""

    def apply_to_params(self, params, generator):
        raise NotImplementedError


def _is_bias(name):
    return name == "b" or name.endswith("b") or "bias" in name.lower()


class WeightNoise(IWeightNoise):
    """≡ conf.weightnoise.WeightNoise — additive (W + ε) or multiplicative
    (W · ε) noise from a distribution spec dict."""

    def __init__(self, distribution=None, applyToBias=False, additive=True):
        self.distribution = dict(distribution
                                 or {"type": "normal", "std": 0.01})
        self.applyToBias = bool(applyToBias)
        self.additive = bool(additive)

    def apply_to_params(self, params, generator):
        out = {}
        for k, v in sorted(params.items()):
            if _is_bias(k) and not self.applyToBias:
                out[k] = v
                continue
            eps = _sample(self.distribution, generator, v.shape, v)
            out[k] = v + eps if self.additive else v * eps
        return out


class DropConnect(IWeightNoise):
    """≡ conf.weightnoise.DropConnect — inverted dropout on the weights:
    W' = W · Bernoulli(p) / p with retain probability p (inference uses
    the clean W, expectation preserved)."""

    def __init__(self, weightRetainProb=0.5, applyToBias=False):
        p = float(weightRetainProb)
        if not 0.0 < p <= 1.0:
            raise ValueError(
                f"DropConnect: weightRetainProb must be in (0, 1], got {p}")
        self.weightRetainProb = p
        self.applyToBias = bool(applyToBias)

    def apply_to_params(self, params, generator):
        p = self.weightRetainProb
        if p == 1.0:
            return params
        out = {}
        for k, v in sorted(params.items()):
            if _is_bias(k) and not self.applyToBias:
                out[k] = v
                continue
            keep = keep_mask(v, p, generator=generator)
            out[k] = torch.where(keep, v / p, torch.zeros_like(v))
        return out
