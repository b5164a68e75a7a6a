"""Symmetric int8 primitives: the port of
`deeplearning4j_tpu/quantize/core.py`.

- the elementwise codec: `INT8_MAX`, `per_channel_scales`,
  `per_tensor_scale`, `quantize`, `dequantize`;
- QAT: `fake_quant` (quantize→dequantize forward, clipped
  straight-through backward), `fake_quant_weight`, `fake_quant_act`;
- the int8 contraction `int8_dot` (exact int32), its f32 twin
  `scaled_int8_dot`, and the dequant epilogue `dequant_epilogue`.

Everything is symmetric int8 without zero-points, so a dequantized product
is exactly `acc * (sx * sw)`. The division by a scale stays in float32 and
rounds half to even (`torch.round`, as `jnp.round`), so the int8 bytes
equal the JAX package's. The int8 serving path on the card does not call
`int8_dot`: `quantize/infer.py` hands the int8 operands to
`kernels.pointwise_conv.int8_matmul_epilogue`, which runs the contraction
and the epilogue in one kernel.
"""
from __future__ import annotations

import numpy as np
import torch

#: symmetric int8 range: [-127, 127] (−128 unused, so |q| is symmetric)
INT8_MAX = 127.0

__all__ = ["INT8_MAX", "per_channel_scales", "per_tensor_scale", "quantize",
           "dequantize", "fake_quant", "fake_quant_weight", "fake_quant_act",
           "int8_dot", "scaled_int8_dot", "dequant_epilogue"]


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


# -- QAT fake-quant (straight-through estimator) ----------------------------
class _FakeQuant(torch.autograd.Function):
    """quantize→dequantize forward, in f32 and cast back to x's dtype; the
    clipped straight-through backward: dx = dy where |x| ≤ 127·s, 0 where
    the forward clipped; the scale gets no gradient (the JAX package's
    custom VJP)."""

    @staticmethod
    def forward(ctx, x, scale, channel_axis):
        s = _broadcast_scale(x, scale, channel_axis)
        xf = x.float()
        q = torch.round(xf / s).clamp(-INT8_MAX, INT8_MAX)
        ctx.save_for_backward(xf.abs() <= INT8_MAX * s)
        return (q * s).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        inside, = ctx.saved_tensors
        return torch.where(inside, dy, torch.zeros_like(dy)), None, None


def fake_quant(x, scale, channel_axis=None):
    """quantize→dequantize in the forward pass; straight-through gradient
    in the backward (dx = dy inside [-127·s, 127·s], 0 where the forward
    clipped). `scale` receives no gradient (the callers recompute it from
    the data each step)."""
    return _FakeQuant.apply(x, scale, channel_axis)


#: f32(1/127): XLA compiles the division of a scale by the constant 127 into
#: a product by this reciprocal, so the JAX package's compiled QAT step
#: computes its scales as absmax × f32(1/127), which can differ from
#: absmax / 127 in the last bit (and then flips the straight-through mask
#: of the largest element). QAT computes its scales the same way.
_INV_INT8_MAX = float(np.float32(1.0) / np.float32(INT8_MAX))


def _qat_scale(amax):
    return torch.where(amax > 0, amax * _INV_INT8_MAX, 1.0)


def fake_quant_weight(w, channel_axis=-1):
    """QAT weight fake-quant: per-output-channel scales from the current
    weights (the scales track the weights as they train)."""
    axis = channel_axis % w.ndim
    dims = tuple(i for i in range(w.ndim) if i != axis)
    amax = w.detach().float().abs().amax(dim=dims)
    return fake_quant(w, _qat_scale(amax), channel_axis)


def fake_quant_act(x):
    """QAT activation fake-quant: one per-tensor absmax scale."""
    return fake_quant(x, _qat_scale(x.detach().float().abs().amax()), None)


# -- the int8 contraction ---------------------------------------------------
def int8_dot(xq, wq):
    """int8 (..., K) × int8 (K, N) → int32 (..., N), exactly: the product
    in int64 (the JAX package's `lax.dot_general` with an int32 result;
    no layer calls this on the card, where `int8_matmul_epilogue` runs the
    contraction and its epilogue in one kernel)."""
    acc = torch.matmul(xq.to(torch.int64), wq.to(torch.int64)) \
        if not xq.is_cuda else torch.matmul(xq.double(), wq.double())
    return acc.to(torch.int32)


def scaled_int8_dot(xq, wq, out_scale):
    """The same contraction in f32 with the dequant scale applied after:
    int-valued operands (|q| ≤ 127), so for K ≤ 2^10 every partial sum is
    exact in f32's 24-bit mantissa and this equals the int32 sums.
    `out_scale`: scalar or (N,) per-channel dequant factor."""
    acc = torch.matmul(xq.float(), wq.float())
    return acc * out_scale


def dequant_epilogue(acc, scale, bias=None, residual=None, act=None):
    """y = act(acc·scale + bias [+ residual]) over a raw int32 (or exactly
    int-valued f32) accumulator, in f32."""
    y = acc.float() * scale
    if bias is not None:
        y = y + bias
    if residual is not None:
        y = y + residual.float()
    if act is not None:
        from deeplearning4j_tpu_torch.nn.activations import get_activation
        y = get_activation(act)(y)
    return y
