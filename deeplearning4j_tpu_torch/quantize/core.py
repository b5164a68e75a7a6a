"""Symmetric int8 primitives: the port of the elementwise codec of
`deeplearning4j_tpu/quantize/core.py` (`INT8_MAX`, `per_channel_scales`,
`per_tensor_scale`, `quantize`, `dequantize`).

Everything is symmetric int8 without zero-points, so a dequantized product
is exactly `acc * (sx * sw)`. The division by a scale stays in float32 and
rounds half to even (`torch.round`, as `jnp.round`), so the int8 bytes
equal the JAX package's.
"""
from __future__ import annotations

import torch

#: symmetric int8 range: [-127, 127] (−128 unused, so |q| is symmetric)
INT8_MAX = 127.0

__all__ = ["INT8_MAX", "per_channel_scales", "per_tensor_scale", "quantize",
           "dequantize"]


def per_channel_scales(w, channel_axis=-1):
    """Symmetric per-output-channel scales of a weight tensor: one float32
    scale per channel, absmax/127, zero-guarded (an all-zero channel gets
    scale 1 so q = 0 round-trips)."""
    axis = channel_axis % w.ndim
    dims = tuple(i for i in range(w.ndim) if i != axis)
    amax = w.float().abs().amax(dim=dims) if dims else w.float().abs()
    return torch.where(amax > 0, amax / INT8_MAX, 1.0)


def per_tensor_scale(x):
    """Symmetric whole-tensor scale (activations): absmax/127."""
    amax = x.float().abs().amax()
    return torch.where(amax > 0, amax / INT8_MAX, 1.0)


def _broadcast_scale(x, scale, channel_axis):
    """Scale shaped to broadcast against x: a scalar as it is, a
    per-channel vector reshaped onto `channel_axis`. The one broadcast rule
    that quantize and dequantize share."""
    s = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    if channel_axis is not None and s.ndim == 1:
        shape = [1] * x.ndim
        shape[channel_axis % x.ndim] = s.shape[0]
        s = s.reshape(shape)
    return s


def quantize(x, scale, channel_axis=None):
    """x/scale, rounded half to even and clipped to [-127, 127], as int8.
    `scale` is a scalar (per-tensor) or a per-channel vector (then
    `channel_axis` names the axis it broadcasts over)."""
    s = _broadcast_scale(x, scale, channel_axis)
    q = torch.round(x.float() / s)
    return q.clamp(-INT8_MAX, INT8_MAX).to(torch.int8)


def dequantize(q, scale, channel_axis=None, dtype=torch.float32):
    s = _broadcast_scale(q, scale, channel_axis)
    return (q.float() * s).to(dtype)
