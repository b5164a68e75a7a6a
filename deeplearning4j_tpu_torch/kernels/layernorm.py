"""Fused layer normalisation: the port of `fused_layernorm` of
`deeplearning4j_tpu/kernels/layernorm.py`.

    out = γ·(x − μ)/√(σ² + ε) + β   over the last axis, σ² = mean((x − μ)²)

On a CUDA tensor the forward is one hand-written Hopper kernel
(csrc/layernorm.cu): one read and one write of each element, f32 math,
the output in x's type, and each row's μ and 1/√(σ² + ε) written for the
backward. The backward is the closed form of the JAX `_ln_bwd_rule`
(:82-90) in PyTorch. On a CPU tensor the forward is the plain version
beside the kernel, `_layernorm_reference`. Launches are counted on
`fused_layernorm.launches`; nothing falls back from the kernel to its
plain version on the card.

No model of the JAX package calls it (BERT normalises with its own
`_layer_norm`); it is an entry point of the kernels' public surface.
"""
from __future__ import annotations

import ctypes

import torch

from deeplearning4j_tpu_torch.kernels import _build

__all__ = ["fused_layernorm"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
# x, gamma, beta, out, mean, rstd, dtype, rows, D, eps, device, stream
_ARGTYPES = [_P] * 6 + [_I] * 3 + [ctypes.c_float, _I, _P]
_bound = []


def _entry():
    if not _bound:
        fn = _build.library("layernorm").dl4j_layernorm
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _bound.append(fn)
    return _bound[0]


def _wide(dtype):
    return torch.float64 if dtype == torch.float64 else torch.float32


def _layernorm_reference(x2, gamma, beta, eps):
    """Plain version of the kernel on (rows, D): f32 math (f64 for f64
    inputs), output in x's type; also each row's μ and 1/√(σ² + ε)."""
    wide = _wide(x2.dtype)
    xf = x2.to(wide)
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    out = xc * inv * gamma.to(wide) + beta.to(wide)
    return out.to(x2.dtype), mean[:, 0], inv[:, 0]


def _launch(x2, gamma, beta, eps):
    """The kernel on (rows, D); returns (out, mean, rstd)."""
    if x2.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_layernorm takes float32 or bfloat16 on the "
                        f"card, got {x2.dtype}")
    rows, d = x2.shape
    vecs = []
    for what, v in (("gamma", gamma), ("beta", beta)):
        if tuple(v.shape) != (d,):
            raise ValueError(f"fused_layernorm: {what} must be ({d},), got "
                             f"{tuple(v.shape)}")
        if v.device != x2.device:
            raise ValueError(f"fused_layernorm: {what} lies on {v.device}, "
                             f"x on {x2.device}")
        vecs.append(v.to(torch.float32).contiguous())
    x2 = x2.contiguous()
    out = torch.empty_like(x2)
    mean = torch.empty((rows,), dtype=torch.float32, device=x2.device)
    rstd = torch.empty_like(mean)
    code = _entry()(
        x2.data_ptr(), vecs[0].data_ptr(), vecs[1].data_ptr(), out.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), _DTYPE_CODES[x2.dtype], rows, d,
        float(eps), x2.device.index or 0,
        ctypes.c_void_p(torch.cuda.current_stream(x2.device).cuda_stream))
    _build.check(code, "fused_layernorm")
    fused_layernorm.launches += 1
    return out, mean, rstd


class _FusedLayerNorm(torch.autograd.Function):
    """The kernel (or its plain version) forward and the closed-form
    backward of the JAX `_ln_bwd_rule`, from the saved per-row μ and
    1/√(σ² + ε)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        x2 = x.reshape(-1, x.shape[-1])
        if x2.is_cuda:
            out, mean, rstd = _launch(x2, gamma, beta, eps)
        else:
            out, mean, rstd = _layernorm_reference(x2, gamma, beta, eps)
        ctx.save_for_backward(x2, gamma, mean, rstd)
        return out.reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        x2, gamma, mean, rstd = ctx.saved_tensors
        wide = _wide(x2.dtype)
        xhat = (x2.to(wide) - mean.to(wide)[:, None]) * rstd.to(wide)[:, None]
        gf = g.reshape(x2.shape).to(wide)
        dg = (gf * xhat).sum(dim=0)
        db = gf.sum(dim=0)
        wg = gf * gamma.to(wide)
        dx = rstd.to(wide)[:, None] * (
            wg - wg.mean(dim=-1, keepdim=True)
            - xhat * (wg * xhat).mean(dim=-1, keepdim=True))
        return (dx.to(g.dtype).reshape(g.shape), dg.to(gamma.dtype),
                db.to(gamma.dtype), None)


def fused_layernorm(x, gamma, beta, eps=1e-5):
    """LayerNorm over the last axis, γ·(x−μ)/√(σ²+ε)+β, one fused kernel
    on the card (f32 or bf16; f32 math, output in x.dtype). x: (..., D);
    γ, β: (D,). Differentiable in x, γ and β."""
    return _FusedLayerNorm.apply(x, gamma, beta, float(eps))


fused_layernorm.launches = 0
