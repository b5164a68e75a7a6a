"""Dropout variants: the port of `deeplearning4j_tpu/nn/dropout.py`
(≡ org.deeplearning4j.nn.conf.dropout.*: Dropout, GaussianDropout,
GaussianNoise, AlphaDropout, SpatialDropout).

A layer's `dropOut` may be the reference's float shorthand (p = RETAIN
probability, inverted dropout) or one of these objects; either is applied
to the layer INPUT at train time, inside the training step. `apply(x,
generator)` draws from the network's `torch.Generator` on x's device, the
one the step's CUDA graph registers, so a replay draws fresh masks. The
draws cannot equal JAX's threefry stream: the port is held to the JAX
package on the eval path (no draw) and by the statistics of the draws.
"""
from __future__ import annotations

import torch
from torch.overrides import handle_torch_function, has_torch_function

__all__ = ["IDropout", "Dropout", "GaussianDropout", "GaussianNoise",
           "AlphaDropout", "SpatialDropout", "keep_mask"]


def keep_mask(x, p, shape=None, *, generator):
    """A boolean Bernoulli(p) keep mask of `shape` (x's by default) on x's
    device, drawn from `generator`. Every dropout draw goes through here so
    that a remat segment's draw tape (nn/_network.remat_call), a torch
    function mode, sees the call whole: it keeps the one-byte mask for the
    recompute, not the f32 uniform draw behind it."""
    if has_torch_function((x,)):
        return handle_torch_function(keep_mask, (x,), x, p, shape,
                                     generator=generator)
    return torch.rand(x.shape if shape is None else shape,
                      generator=generator, device=x.device) < p


class IDropout:
    def apply(self, x, generator):
        raise NotImplementedError


class Dropout(IDropout):
    """p = retain probability (the reference's convention)."""

    def __init__(self, p):
        self.p = float(p)

    def apply(self, x, generator):
        if self.p <= 0.0 or self.p >= 1.0:
            return x
        keep = keep_mask(x, self.p, generator=generator)
        return torch.where(keep, x / self.p, torch.zeros_like(x))


class GaussianDropout(IDropout):
    """Multiplicative N(1, sqrt(rate/(1-rate))) noise (≡ GaussianDropout)."""

    def __init__(self, rate):
        self.rate = float(rate)

    def apply(self, x, generator):
        if self.rate <= 0.0:
            return x
        std = (self.rate / (1.0 - self.rate)) ** 0.5
        noise = 1.0 + std * torch.randn(x.shape, generator=generator,
                                        device=x.device)
        return x * noise.to(x.dtype)


class GaussianNoise(IDropout):
    """Additive N(0, stddev) noise (≡ GaussianNoise)."""

    def __init__(self, stddev):
        self.stddev = float(stddev)

    def apply(self, x, generator):
        if self.stddev <= 0.0:
            return x
        return x + (self.stddev * torch.randn(
            x.shape, generator=generator, device=x.device)).to(x.dtype)


class AlphaDropout(IDropout):
    """SELU-preserving dropout (≡ AlphaDropout): dropped units take the
    negative saturation value α′ and the output is affinely rescaled so the
    self-normalizing mean/variance survive. p = retain probability."""

    _ALPHA = 1.6732632423543772
    _SCALE = 1.0507009873554805

    def __init__(self, p):
        self.p = float(p)

    def apply(self, x, generator):
        p = self.p
        if p <= 0.0 or p >= 1.0:
            return x
        alpha_p = -self._ALPHA * self._SCALE
        a = (p + alpha_p ** 2 * p * (1.0 - p)) ** -0.5
        b = -a * alpha_p * (1.0 - p)
        keep = keep_mask(x, p, generator=generator)
        y = torch.where(keep, x, torch.full_like(x, alpha_p))
        return (a * y + b).to(x.dtype)


class SpatialDropout(IDropout):
    """≡ conf.dropout.SpatialDropout — drops ENTIRE feature maps: one
    Bernoulli draw per (example, channel), broadcast over the spatial or
    time axes. Layouts are channels-LAST (NHWC conv, (B, T, F) sequences),
    so the mask is (B, 1, ..., 1, C). p = retain probability, inverted
    scaling, as in the reference."""

    def __init__(self, p):
        self.p = float(p)

    def apply(self, x, generator):
        if self.p <= 0.0 or self.p >= 1.0 or x.ndim < 2:
            return x
        mask_shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
        keep = keep_mask(x, self.p, mask_shape, generator=generator)
        return torch.where(keep, x / self.p, torch.zeros_like(x))
