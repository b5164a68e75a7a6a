"""The inference epilogue GEMM of a conv1x1+BN pair: the port of
`matmul_epilogue` and `int8_matmul_epilogue` of
`deeplearning4j_tpu/kernels/pointwise_conv.py` (:179-200).

    y = act((x @ w) · scale + shift [+ residual])

One hand-written Hopper source carries both (csrc/matmul_epilogue.cu), on
the tensor cores (mma.sync) through one kernel template: f32 (as 3×TF32)
and bf16 inputs accumulate in f32, int8 × int8 accumulates exactly in
int32 (m16n8k32), and one shared epilogue applies the affine, the residual
and the activation in registers, so the fp and int8 paths cannot drift
apart.
The kernel tiles M, N and K itself and guards every ragged edge, so the
wrappers pad nothing.

Each wrapper launches the kernel for a CUDA tensor, counts the launch on
its `launches` attribute, and raises on what the kernel does not take.
For a CPU tensor it runs the plain PyTorch version beside it
(`_epilogue_reference`), which the CPU tests hold against the JAX
package. Nothing falls back from the kernel to its plain version on the
card.

The training half, the counterpart of the JAX module's `matmul_stats`,
`bn_grad_stats`, `bn_conv_grads` and `fused_conv1x1_bn`:

- `matmul_stats` (csrc/matmul_stats.cu): y = x @ w with the per-channel
  Σy and Σy² of the training BN in the same kernel, on the tensor-core
  tile of `matmul_epilogue`.
- `bn_grad_stats` (csrc/bn_grad_stats.cu): dγ and dβ in one read of
  (y, dz).
- `bn_conv_grads` (csrc/bn_conv_grads.cu): dX and dW of the conv, with BN's
  input gradient formed on chip and never written to device memory.
- `fused_conv1x1_bn`: z = act(batchnorm_train(x @ w)) as an autograd
  Function over the three, returning (z, μ, var).

Each training kernel sums across blocks through per-block partials added
in a fixed order, so its results are the same bits on every run.
"""
from __future__ import annotations

import ctypes

import torch

from deeplearning4j_tpu_torch import batch_sync as _batch_sync
from deeplearning4j_tpu_torch.kernels import _build

__all__ = ["matmul_epilogue", "int8_matmul_epilogue", "matmul_stats",
           "bn_grad_stats", "bn_conv_grads", "fused_conv1x1_bn"]

#: dtype codes of the C entries (the inputs of csrc/matmul_epilogue.cu;
#: the outputs there, and every operand of the training kernels)
_IN_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_FLOAT_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = ("identity", "relu")
#: the longest int8 contraction whose int32 sums cannot overflow:
#: K · 128² < 2^31
_INT8_MAX_K = (2 ** 31 - 1) // 128 ** 2

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


def _fwd_tile(m, k, n, int8=False):
    """(BM, BN): the output tile the tensor-core route of `matmul_epilogue`
    and `matmul_stats` picks for (M, K, N) on the current card, or the int8
    route of `int8_matmul_epilogue` where `int8` (csrc/mma_tile.cuh
    `fwd_plan`)."""
    fn = _build.library("matmul_epilogue").dl4j_fwd_tile
    fn.argtypes, fn.restype = [_I] * 4, _I
    code = fn(m, k, n, int(int8))
    return code // 1000, code % 1000


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
    if out_dtype not in _FLOAT_CODES:
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
        _IN_CODES[x.dtype], _FLOAT_CODES[out_dtype], m, k, n,
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
    _build.count_launch(matmul_epilogue)
    return out


matmul_epilogue.launches = 0


def int8_matmul_epilogue(xq, wq, scale, shift, residual=None,
                         act="identity", out_dtype=torch.float32):
    """The int8 variant: xq (M, K) int8 × wq (K, N) int8 → int32, with the
    dequant (scale = x_scale·w_scale[·γr]) + bias (+ residual) (+ act)
    epilogue of `matmul_epilogue` in the same kernel — the int32
    accumulator never leaves the registers. On the card K is at most
    131,071, so no int32 sum of K products of int8 values can overflow."""
    _check_act(act)
    if not xq.is_cuda:
        if xq.dtype != torch.int8 or wq.dtype != torch.int8:
            raise TypeError(f"int8_matmul_epilogue takes int8 operands, "
                            f"got {xq.dtype} and {wq.dtype}")
        return _epilogue_reference(xq, wq, scale, shift, residual, act,
                                   out_dtype)
    if xq.ndim == 2 and xq.shape[1] > _INT8_MAX_K:
        raise ValueError(f"int8_matmul_epilogue: K = {xq.shape[1]} > "
                         f"{_INT8_MAX_K}: the int32 sums could overflow")
    out = _launch("int8_matmul_epilogue", xq, wq, scale, shift, residual,
                  act, out_dtype, (torch.int8,))
    _build.count_launch(int8_matmul_epilogue)
    return out


int8_matmul_epilogue.launches = 0


# -- training: the kernels behind fused_conv1x1_bn ----------------------------
_L = ctypes.c_longlong
#: C entry -> (argtypes, restype); the *_scratch entries size the buffer of
#: per-block partial sums each kernel reduces in a fixed order
_TRAIN_ENTRIES = {
    # x, w, y, part, stats, dtype, M, K, N, device, stream
    "dl4j_matmul_stats": ([_P] * 5 + [_I] * 5 + [_P], _I),
    "dl4j_matmul_stats_scratch": ([_I] * 3, _L),
    # y, dz, mu, r, part, out, dtype, M, N, device, stream
    "dl4j_bn_grad_stats": ([_P] * 6 + [_I] * 4 + [_P], _I),
    "dl4j_bn_grad_stats_scratch": ([_I] * 2, _L),
    # x, y, dz, w, k1, k2, c, mu, dx, dw, part, dtype, M, K, N, device,
    # stream
    "dl4j_bn_conv_grads": ([_P] * 11 + [_I] * 5 + [_P], _I),
    "dl4j_bn_conv_grads_scratch": ([_I] * 3, _L),
}
_train_fns = {}


def _c(source, entry):
    """The C entry `entry` of csrc/<source>.cu, built and bound once."""
    fn = _train_fns.get(entry)
    if fn is None:
        fn = getattr(_build.library(source), entry)
        fn.argtypes, fn.restype = _TRAIN_ENTRIES[entry]
        _train_fns[entry] = fn
    return fn


def _wide(dtype):
    """The plain versions' accumulation type: f32, or f64 for f64 inputs
    (gradcheck)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _train_operands(name, mats, vecs, n):
    """Check the operands of a training kernel and return them ready to
    launch: `mats` {name: tensor} in one of f32/bf16, all of one dtype and
    one device, made contiguous; `vecs` {name: (N,) tensor} as contiguous
    f32. Raises on what the kernel does not take."""
    first = next(iter(mats.values()))
    for what, t in mats.items():
        if t.dtype not in _FLOAT_CODES or t.dtype != first.dtype:
            raise TypeError(f"{name} takes its matrices in float32 or "
                            f"bfloat16, all of one dtype; {what} is "
                            f"{t.dtype} (first {first.dtype})")
    for what, t in list(mats.items()) + list(vecs.items()):
        if t.device != first.device:
            raise ValueError(f"{name}: every operand must lie on "
                             f"{first.device}, {what} lies on {t.device}")
    for what, v in vecs.items():
        if tuple(v.shape) != (n,):
            raise ValueError(f"{name}: {what} must be (N,) = ({n},), got "
                             f"{tuple(v.shape)}")
    return ({k: t.contiguous() for k, t in mats.items()},
            {k: v.to(torch.float32).contiguous() for k, v in vecs.items()})


def _check_2d(name, **mats):
    for what, t in mats.items():
        if t.ndim != 2:
            raise ValueError(f"{name}: {what} must be 2-D, got "
                             f"{tuple(t.shape)}")


def _matmul_stats_reference(x, w):
    """Plain version of csrc/matmul_stats.cu: y = x @ w summed in f32 and
    stored in x.dtype, then Σy and Σy² over the rows of the stored value."""
    wide = _wide(x.dtype)
    y = (x.to(wide) @ w.to(wide)).to(x.dtype)
    yc = y.to(wide)
    return y, yc.sum(dim=0), (yc * yc).sum(dim=0)


def matmul_stats(x, w):
    """(x @ w, Σ over rows, Σ of squares over rows) in one kernel: the
    forward of the training conv1x1+BN pair. x: (M, K), w: (K, N), f32 or
    bf16 on the card. Returns y (M, N) in x.dtype and s1, s2 (N,) f32,
    taken over y as stored (bf16: the rounded value). Kernel
    csrc/matmul_stats.cu on a CUDA tensor, its plain version on a CPU one."""
    _check_2d("matmul_stats", x=x, w=w)
    if x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul_stats: x (M, K) and w (K, N) expected, got"
                         f" {tuple(x.shape)} and {tuple(w.shape)}")
    if not x.is_cuda:
        return _matmul_stats_reference(x, w)
    mats, _ = _train_operands("matmul_stats", {"x": x, "w": w}, {},
                              w.shape[1])
    x, w = mats["x"], mats["w"]
    m, k = x.shape
    n = w.shape[1]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    stats = torch.empty((2, n), dtype=torch.float32, device=x.device)
    part = torch.empty(
        (_c("matmul_stats", "dl4j_matmul_stats_scratch")(m, k, n),),
        dtype=torch.float32, device=x.device)
    code = _c("matmul_stats", "dl4j_matmul_stats")(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), part.data_ptr(),
        stats.data_ptr(), _FLOAT_CODES[x.dtype], m, k, n,
        x.device.index or 0, _stream(x))
    _build.check(code, "matmul_stats")
    _build.count_launch(matmul_stats)
    return y, stats[0], stats[1]


matmul_stats.launches = 0


def _bn_grad_stats_reference(y, dz, mu, r):
    """Plain version of csrc/bn_grad_stats.cu, in f32 (f64 for f64)."""
    wide = _wide(y.dtype)
    dzf = dz.to(wide)
    xhat = (y.to(wide) - mu.to(wide)) * r.to(wide)
    return (dzf * xhat).sum(dim=0), dzf.sum(dim=0)


def bn_grad_stats(y, dz, mu, r):
    """dγ = Σ dz·(y − μ)·r and dβ = Σ dz over the rows, in one read of
    (y, dz). y, dz: (M, N) f32 or bf16; μ, r: (N,). Any relu mask must
    already be folded into dz. Returns two (N,) f32. Kernel
    csrc/bn_grad_stats.cu on a CUDA tensor, its plain version on a CPU
    one."""
    _check_2d("bn_grad_stats", y=y, dz=dz)
    if dz.shape != y.shape:
        raise ValueError(f"bn_grad_stats: y and dz must share one (M, N) "
                         f"shape, got {tuple(y.shape)} and "
                         f"{tuple(dz.shape)}")
    if not y.is_cuda:
        return _bn_grad_stats_reference(y, dz, mu, r)
    m, n = y.shape
    mats, vecs = _train_operands("bn_grad_stats", {"y": y, "dz": dz},
                                 {"mu": mu, "r": r}, n)
    out = torch.empty((2, n), dtype=torch.float32, device=y.device)
    part = torch.empty(
        (_c("bn_grad_stats", "dl4j_bn_grad_stats_scratch")(m, n),),
        dtype=torch.float32, device=y.device)
    code = _c("bn_grad_stats", "dl4j_bn_grad_stats")(
        mats["y"].data_ptr(), mats["dz"].data_ptr(), vecs["mu"].data_ptr(),
        vecs["r"].data_ptr(), part.data_ptr(), out.data_ptr(),
        _FLOAT_CODES[y.dtype], m, n, y.device.index or 0, _stream(y))
    _build.check(code, "bn_grad_stats")
    _build.count_launch(bn_grad_stats)
    return out[0], out[1]


bn_grad_stats.launches = 0


def _bn_dy(y, dz, k1, k2, c, mu, dtype):
    """BN's input gradient dy = k1·dz − (y − μ)·k2 − c in f32 (f64 for f64),
    rounded to `dtype` as the kernel rounds it before both products."""
    wide = _wide(dtype)
    dy = (k1.to(wide) * dz.to(wide) - (y.to(wide) - mu.to(wide)) * k2.to(wide)
          - c.to(wide))
    return dy.to(dtype).to(wide)


def _bn_conv_grads_reference(x, y, dz, w, k1, k2, c, mu):
    """Plain version of csrc/bn_conv_grads.cu: dy formed and rounded to
    x.dtype, then dX = dy·wᵀ in x.dtype and dW = xᵀ·dy, summed in f32."""
    wide = _wide(x.dtype)
    dy = _bn_dy(y, dz, k1, k2, c, mu, x.dtype)
    dx = (dy @ w.to(wide).T).to(x.dtype)
    return dx, x.to(wide).T @ dy


def bn_conv_grads(x, y, dz, w, k1, k2, c, mu):
    """Both conv gradients of a conv1x1+BN pair from one kernel: dX (M, K)
    in x.dtype and dW (K, N) f32, where BN's input gradient
    dy = k1·dz − k2·(y − μ) − c is formed on chip (relu mask pre-folded
    into dz) and never stored. x (M, K), y and dz (M, N), w (K, N), f32 or
    bf16; k1, k2, c, μ (N,). Kernel csrc/bn_conv_grads.cu on a CUDA
    tensor, its plain version on a CPU one."""
    _check_2d("bn_conv_grads", x=x, y=y, dz=dz, w=w)
    m, k = x.shape
    n = w.shape[1]
    if (w.shape[0] != k or tuple(y.shape) != (m, n)
            or tuple(dz.shape) != (m, n)):
        raise ValueError(f"bn_conv_grads: x (M, K), y and dz (M, N), w (K, "
                         f"N) expected, got {tuple(x.shape)}, "
                         f"{tuple(y.shape)}, {tuple(dz.shape)}, "
                         f"{tuple(w.shape)}")
    if not x.is_cuda:
        return _bn_conv_grads_reference(x, y, dz, w, k1, k2, c, mu)
    mats, vecs = _train_operands(
        "bn_conv_grads", {"x": x, "y": y, "dz": dz, "w": w},
        {"k1": k1, "k2": k2, "c": c, "mu": mu}, n)
    dx = torch.empty((m, k), dtype=x.dtype, device=x.device)
    dw = torch.empty((k, n), dtype=torch.float32, device=x.device)
    part = torch.empty(
        (_c("bn_conv_grads", "dl4j_bn_conv_grads_scratch")(m, k, n),),
        dtype=torch.float32, device=x.device)
    code = _c("bn_conv_grads", "dl4j_bn_conv_grads")(
        *(mats[t].data_ptr() for t in ("x", "y", "dz", "w")),
        *(vecs[t].data_ptr() for t in ("k1", "k2", "c", "mu")),
        dx.data_ptr(), dw.data_ptr(), part.data_ptr(),
        _FLOAT_CODES[x.dtype], m, k, n, x.device.index or 0, _stream(x))
    _build.check(code, "bn_conv_grads")
    _build.count_launch(bn_conv_grads)
    return dx, dw


bn_conv_grads.launches = 0


class _FusedConv1x1BN(torch.autograd.Function):
    """z = act(batchnorm_train(x @ w)) and the batch (μ, var): the
    counterpart of the JAX custom VJP (`fused_conv1x1_bn`,
    pointwise_conv.py:368-419). The forward is `matmul_stats` and the BN
    affine; the backward is `bn_grad_stats`, then `bn_conv_grads` with
    BN's closed-form input gradient formed inside the conv-gradient
    kernel. μ and var get no gradient: they feed only the running
    averages. Under a data-parallel step (`batch_sync.ACTIVE`) the
    statistics and BN's backward sums are the global batch's."""

    @staticmethod
    def forward(ctx, x, w, gamma, beta, eps, act):
        y, s1, s2 = matmul_stats(x, w)
        m = x.shape[0]
        sync = _batch_sync.ACTIVE
        ctx.sync = sync
        if sync is not None:
            # data parallel: Σy and Σy² over the dp ranks' rows
            s1, s2 = sync.sum(s1, s2)
            m = m * sync.n
        mu = s1 / m
        var = torch.clamp_min(s2 / m - mu * mu, 0.0)
        r = torch.rsqrt(var + eps)
        a = (gamma * r).to(y.dtype)
        b = (beta - gamma * mu * r).to(y.dtype)
        z = y * a + b
        if act == "relu":
            z = torch.clamp_min(z, 0)
        ctx.save_for_backward(x, w, gamma, y, z, mu, r)
        ctx.act = act
        ctx.mark_non_differentiable(mu, var)
        return z, mu, var

    @staticmethod
    def backward(ctx, dz, _dmu, _dvar):
        x, w, gamma, y, z, mu, r = ctx.saved_tensors
        dz = dz.to(z.dtype)
        if ctx.act == "relu":
            dz = torch.where(z > 0, dz, torch.zeros_like(dz))
        dgamma, dbeta = bn_grad_stats(y, dz, mu, r)
        m = y.shape[0]
        sgamma, sbeta = dgamma, dbeta
        if ctx.sync is not None:
            # the global Σdz·x̂ and Σdz before B8 forms dX; dγ and dβ stay
            # this rank's share (the data-parallel step sums the gradients)
            sgamma, sbeta = ctx.sync.sum(dgamma, dbeta)
            m = m * ctx.sync.n
        k1 = gamma * r
        k2 = gamma * r * r * sgamma / m
        c = gamma * r * sbeta / m
        dx, dw = bn_conv_grads(x, y, dz, w, k1, k2, c, mu)
        return (dx, dw.to(w.dtype), dgamma.to(gamma.dtype),
                dbeta.to(gamma.dtype), None, None)


def fused_conv1x1_bn(x, w, gamma, beta, eps=1e-5, act="identity"):
    """z = act(batchnorm_train(x @ w)); returns (z, μ, var).

    x: (M, K) activations (M = B·H·W), w: (K, N) the conv kernel reshaped,
    γ, β: (N,). act is identity or relu. μ and var are the batch
    statistics, var = max(Σy²/M − μ², 0), for the running-average update;
    they carry no gradient. Gradients flow to x, w, γ and β through BN's
    closed-form backward fused into the conv-gradient kernel. On the card
    each call launches matmul_stats, and its backward bn_grad_stats and
    bn_conv_grads."""
    if act not in _ACTS:
        raise ValueError(f"fused_conv1x1_bn: unsupported act {act!r}")
    return _FusedConv1x1BN.apply(x, w, gamma, beta, float(eps), act)
