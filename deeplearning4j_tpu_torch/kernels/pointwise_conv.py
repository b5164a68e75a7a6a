"""The inference epilogue GEMM of a conv1x1+BN pair: the port of
`matmul_epilogue` and `int8_matmul_epilogue` of
`deeplearning4j_tpu/kernels/pointwise_conv.py` (:179-200).

    y = act((x @ w) · scale + shift [+ residual])

One hand-written Hopper kernel carries both (csrc/matmul_epilogue.cu): f32
or bf16 inputs accumulate in f32, int8 × int8 accumulates exactly in
int32, and one shared epilogue applies the affine, the residual and the
activation in registers, so the fp and int8 paths cannot drift apart.
The kernel tiles M, N and K itself and guards every ragged edge, so the
wrappers pad nothing.

Each wrapper launches the kernel for a CUDA tensor, counts the launch on
its `launches` attribute, and raises on what the kernel does not take.
For a CPU tensor it runs the plain PyTorch version beside it
(`_epilogue_reference`), which the CPU tests hold against the JAX
package. Nothing falls back from the kernel to its plain version on the
card.

The training-mode kernels of the JAX module (`matmul_stats`,
`bn_grad_stats`, `bn_conv_grads`, `fused_conv1x1_bn`) come with the
training slice (ROADMAP B5, B7, B8).
"""
from __future__ import annotations

import ctypes

import torch

from deeplearning4j_tpu_torch.kernels import _build

__all__ = ["matmul_epilogue", "int8_matmul_epilogue"]

#: dtype codes of the C entry (csrc/matmul_epilogue.cu)
_IN_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = ("identity", "relu")

_P, _I = ctypes.c_void_p, ctypes.c_int
# x, w, scale, shift, residual, out, in_dtype, out_dtype, M, K, N, relu,
# device, stream
_ARGTYPES = [_P] * 6 + [_I] * 7 + [_P]
_bound = []


def _entry():
    if not _bound:
        fn = _build.library("matmul_epilogue").dl4j_matmul_epilogue
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _bound.append(fn)
    return _bound[0]


def _check_act(act):
    if act not in _ACTS:
        raise ValueError(f"epilogue act must be identity|relu: {act!r}")


def _epilogue_reference(x, w, scale, shift, residual, act, out_dtype):
    """Plain version of the kernel: the product in f32 (int8: exactly, in
    f64, which holds every int32 sum the kernel can form), then the same
    epilogue in f32, cast to `out_dtype`. f64 inputs stay f64 (gradcheck)."""
    if x.dtype == torch.int8:
        acc = (x.double() @ w.double()).float()
    elif x.dtype == torch.float64:
        acc = x @ w.double()
    else:
        acc = x.float() @ w.float()
    y = acc * scale.to(acc.dtype) + shift.to(acc.dtype)
    if residual is not None:
        y = y + residual.to(acc.dtype)
    if act == "relu":
        y = torch.clamp_min(y, 0.0)
    return y.to(out_dtype)


def _launch(name, x, w, scale, shift, residual, act, out_dtype, in_dtypes):
    """Check what the kernel takes and launch it; returns the output."""
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"{name}: x (M, K) and w (K, N) expected, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    if x.dtype != w.dtype or x.dtype not in in_dtypes:
        raise TypeError(f"{name} takes x and w in one of "
                        f"{[str(d) for d in in_dtypes]}, got {x.dtype} and "
                        f"{w.dtype}")
    if out_dtype not in _OUT_CODES:
        raise TypeError(f"{name}: out_dtype must be float32 or bfloat16, "
                        f"got {out_dtype}")
    vecs = []
    for what, v in (("scale", scale), ("shift", shift)):
        if tuple(v.shape) != (n,):
            raise ValueError(f"{name}: {what} must be (N,) = ({n},), got "
                             f"{tuple(v.shape)}")
        vecs.append(v.to(torch.float32).contiguous())
    tensors = [w, *vecs] + ([] if residual is None else [residual])
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"{name}: every operand must lie on "
                             f"{x.device}, one lies on {t.device}")
    if residual is not None:
        if tuple(residual.shape) != (m, n):
            raise ValueError(f"{name}: residual must be (M, N) = "
                             f"{(m, n)}, got {tuple(residual.shape)}")
        residual = residual.to(out_dtype).contiguous()
    x, w = x.contiguous(), w.contiguous()
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    code = _entry()(
        x.data_ptr(), w.data_ptr(), vecs[0].data_ptr(), vecs[1].data_ptr(),
        None if residual is None else residual.data_ptr(), out.data_ptr(),
        _IN_CODES[x.dtype], _OUT_CODES[out_dtype], m, k, n,
        int(act == "relu"), x.device.index or 0,
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    _build.check(code, name)
    return out


def matmul_epilogue(x, w, scale, shift, residual=None, act="identity",
                    out_dtype=None):
    """y = act((x @ w)·scale + shift [+ residual]) in ONE kernel: the
    affine is the folded inference BN (scale = γ·rsqrt(var+ε),
    shift = β − γ·μ·rsqrt(var+ε)), applied per tile in registers — the
    separate BN-apply and residual-add passes disappear. x: (M, K),
    w: (K, N), f32 or bf16 on the card; scale/shift: (N,); residual:
    (M, N) or None; act identity or relu. Returns (M, N) in `out_dtype`
    (default x.dtype). Kernel csrc/matmul_epilogue.cu on a CUDA tensor,
    its plain version on a CPU one."""
    _check_act(act)
    out_dtype = out_dtype or x.dtype
    if not x.is_cuda:
        return _epilogue_reference(x, w, scale, shift, residual, act,
                                   out_dtype)
    out = _launch("matmul_epilogue", x, w, scale, shift, residual, act,
                  out_dtype, (torch.float32, torch.bfloat16))
    matmul_epilogue.launches += 1
    return out


matmul_epilogue.launches = 0


def int8_matmul_epilogue(xq, wq, scale, shift, residual=None,
                         act="identity", out_dtype=torch.float32):
    """The int8 variant: xq (M, K) int8 × wq (K, N) int8 → int32, with the
    dequant (scale = x_scale·w_scale[·γr]) + bias (+ residual) (+ act)
    epilogue of `matmul_epilogue` in the same kernel — the int32
    accumulator never leaves the registers."""
    _check_act(act)
    if not xq.is_cuda:
        if xq.dtype != torch.int8 or wq.dtype != torch.int8:
            raise TypeError(f"int8_matmul_epilogue takes int8 operands, "
                            f"got {xq.dtype} and {wq.dtype}")
        return _epilogue_reference(xq, wq, scale, shift, residual, act,
                                   out_dtype)
    out = _launch("int8_matmul_epilogue", xq, wq, scale, shift, residual,
                  act, out_dtype, (torch.int8,))
    int8_matmul_epilogue.launches += 1
    return out


int8_matmul_epilogue.launches = 0
