"""Flash attention, forward and backward: the port of
`deeplearning4j_tpu/kernels/flash_attention.py`.

Four hand-written Hopper kernels carry it on the card:

- `flash_fwd` (csrc/flash_fwd.cu): tiled online-softmax attention over
  (B, H, Tq, D) × (B, H, Tk, D) with an optional causal mask and an
  optional (B, Tk) key mask; it emits O and the per-row logsumexp. BERT
  encode (`attn_impl="flash"`) and decoder prefill run it.
- `flash_bwd_dq` (csrc/flash_bwd_dq.cu) and `flash_bwd_dkv`
  (csrc/flash_bwd_dkv.cu): the backward pair. Both recompute
  P = exp(S − lse) from the forward's saved logsumexp; one warp owns 16
  query rows (dQ) or 16 key rows (dK, dV), so each gradient row is written
  by one warp and two runs agree bit for bit. `flash_attention` is a
  `torch.autograd.Function` whose backward runs them, so BERT fine-tuning
  trains through the kernels.
- `flash_decode` (csrc/flash_decode.cu): one query per (b, h) against a
  (B, H, C, D) cache under a (B, C) cache mask; the decode step runs it.
  One launch splits each (b, h)'s cache rows over a thread-block cluster
  of 2, 4 or 8 CTAs (`decode_cluster_size`).

Each wrapper launches its kernel for a CUDA tensor, counts the launch on
its `launches` attribute, and raises on what the kernel does not take. For
a CPU tensor it runs the kernel's plain PyTorch version beside it
(`_flash_forward_reference`, `_dq_reference`, `_dkv_reference`,
`_decode_reference`), which is what the CPU tests compare with the JAX
package. Nothing falls back from a kernel to its plain version on the card.

Layout (B, H, T, D) as in the JAX package. Scores that a mask removes take
-1e30, as in the JAX kernel; rows with no valid key come back as zeros.
"""
from __future__ import annotations

import ctypes

import torch

from deeplearning4j_tpu_torch.kernels import _build

__all__ = ["flash_attention", "flash_attention_decode",
           "flash_attention_decode_mq", "flash_fwd", "flash_bwd_dq",
           "flash_bwd_dkv", "flash_decode", "decode_cluster_size"]

_NEG_INF = -1e30

#: dtype codes of the C entry points (csrc/common.cuh)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_FWD_HEAD_DIMS = (16, 32, 64)
_DECODE_HEAD_DIMS = (32, 64, 128)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: C entry point -> (its library, csrc/<library>.cu; its argument types)
_ENTRIES = {
    # q, k, v, kv_mask, o, lse, dtype, BH, H, Tq, Tk, D, causal, scale,
    # device, stream
    "dl4j_flash_fwd": ("flash_fwd", [_P] * 6 + [_I] * 7 + [_F, _I, _P]),
    # q, k, v, dO, lse, delta, kv_mask, dq, dtype, BH, H, Tq, Tk, D,
    # causal, scale, device, stream
    "dl4j_flash_bwd_dq": ("flash_bwd_dq",
                          [_P] * 8 + [_I] * 7 + [_F, _I, _P]),
    # q, k, v, dO, lse, delta, kv_mask, dk, dv, dtype, BH, H, Tq, Tk, D,
    # causal, scale, device, stream
    "dl4j_flash_bwd_dkv": ("flash_bwd_dkv",
                           [_P] * 9 + [_I] * 7 + [_F, _I, _P]),
    # q, k, v, mask, o, dtype, BH, H, C, D, scale, device, stream
    "dl4j_flash_decode": ("flash_decode",
                          [_P] * 5 + [_I] * 5 + [_F, _I, _P]),
    # dtype, BH, C, D, device -> CTAs per (b, h)
    "dl4j_flash_decode_cluster": ("flash_decode", [_I] * 5),
}
_bound = {}


def _entry(sym):
    fn = _bound.get(sym)
    if fn is None:
        lib, argtypes = _ENTRIES[sym]
        fn = getattr(_build.library(lib), sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _bound[sym] = fn
    return fn


def _operands(name, tensors, head_dims):
    """Check what a kernel takes and return its operands contiguous and
    16-byte aligned (the kernels load 16-byte vectors)."""
    dev = tensors[0].device
    dt = tensors[0].dtype
    for t in tensors:
        if t.device != dev or t.dtype != dt:
            raise ValueError(
                f"{name}: q/k/v must share one device and dtype, got "
                f"{[(str(x.device), x.dtype) for x in tensors]}")
    if dt not in _DTYPE_CODES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {dt}")
    d = tensors[0].shape[-1]
    if d not in head_dims:
        raise ValueError(
            f"{name} takes head dims {head_dims} on the card, got {d}")
    return [_aligned(t) for t in tensors]


def _aligned(t):
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _mask_bytes(mask, device, what):
    """A truthy mask as contiguous bool bytes on `device`."""
    m = mask.to(torch.bool).contiguous()
    if m.device != device:
        raise ValueError(f"{what} lies on {m.device}, the operands on "
                         f"{device}")
    return m


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


# ---------------------------------------------------------------------------
# kernel 1: flash forward
# ---------------------------------------------------------------------------
def _wide(t):
    """The plain versions compute in f32, or in f64 for f64 inputs (which
    no kernel takes; gradcheck uses them)."""
    return t if t.dtype == torch.float64 else t.float()


def _masked_scores(q, k, kv_mask, causal):
    """(q·scale)·kᵀ in f32, (B, H, Tq, Tk), with -1e30 where the key mask
    or causality removes a key (the JAX kernels' `where(mask, s, -1e30)`)."""
    tq, tk, d = q.shape[2], k.shape[2], q.shape[3]
    s = torch.einsum("bhqd,bhkd->bhqk", _wide(q) * (1.0 / d ** 0.5),
                     _wide(k))
    valid = torch.ones((1, 1, tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        valid = torch.tril(valid)
    if kv_mask is not None:
        valid = valid & kv_mask.to(torch.bool)[:, None, None, :]
    return torch.where(valid, s, _NEG_INF)


def _flash_forward_reference(q, k, v, kv_mask, causal):
    """Plain version of `flash_fwd`: the same masked online-softmax result
    computed densely in f32. Returns (out (B, H, Tq, D) in q.dtype,
    lse (B*H, Tq) f32)."""
    b, h, tq, d = q.shape
    s = _masked_scores(q, k, kv_mask, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bhkd->bhqd", p, _wide(v)) / l
    lse = (m + torch.log(l))[..., 0].reshape(b * h, tq)
    return out.to(q.dtype), lse


def flash_fwd(q, k, v, kv_mask=None, causal=False):
    """Kernel 1 (csrc/flash_fwd.cu) on a CUDA tensor, its plain version on
    a CPU one. q (B, H, Tq, D), k/v (B, H, Tk, D), kv_mask (B, Tk) truthy
    or None. Returns (out (B, H, Tq, D) in q.dtype, lse (B*H, Tq) f32);
    query rows are not zeroed here (see `_flash_forward`)."""
    if not q.is_cuda:
        return _flash_forward_reference(q, k, v, kv_mask, causal)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if k.shape != (b, h, tk, d) or v.shape != k.shape:
        raise ValueError(f"flash_fwd: q {tuple(q.shape)} does not match "
                         f"k {tuple(k.shape)} / v {tuple(v.shape)}")
    q, k, v = _operands("flash_fwd", (q, k, v), _FWD_HEAD_DIMS)
    mask = None
    if kv_mask is not None:
        mask = _mask_bytes(kv_mask, q.device, "kv_mask")
        if mask.shape != (b, tk):
            raise ValueError(f"flash_fwd: kv_mask must be (B, Tk) = "
                             f"{(b, tk)}, got {tuple(mask.shape)}")
    out = torch.empty_like(q)
    lse = torch.empty((b * h, tq), dtype=torch.float32, device=q.device)
    code = _entry("dl4j_flash_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(),
        lse.data_ptr(), _DTYPE_CODES[q.dtype], b * h, h, tq, tk, d,
        int(causal), 1.0 / d ** 0.5, q.device.index or 0, _stream(q.device))
    _build.check(code, "flash_fwd")
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


def _flash_forward(q, k, v, q_mask, kv_mask, causal):
    """Returns (out (B, H, Tq, D), lse (B*H, Tq)). Invalid query rows (by
    `q_mask`, or in an example with no valid key) come back zeroed with
    lse = +1e30, the sentinel the backward kernels of the JAX package
    rely on."""
    out, lse = flash_fwd(q, k, v, kv_mask, causal)
    if q_mask is None and kv_mask is None:
        return out, lse
    b, h, tq, _ = q.shape
    qvalid = (torch.ones((b, tq), dtype=torch.bool, device=q.device)
              if q_mask is None else q_mask.to(torch.bool))
    if kv_mask is not None:
        # an example with NO valid keys has no defined softmax
        qvalid = qvalid & kv_mask.to(torch.bool).any(dim=1)[:, None]
    out = torch.where(qvalid[:, None, :, None], out, 0)
    lse = torch.where(qvalid[:, None, :].expand(b, h, tq).reshape(b * h, tq),
                      lse, 1e30)
    return out, lse


# ---------------------------------------------------------------------------
# backward kernels: dQ and dK/dV
# ---------------------------------------------------------------------------
def _bwd_tiles(q, k, v, g, lse, delta, kv_mask, causal):
    """P = exp(where(mask, S, -1e30) - lse) and dS = P∘(dO·Vᵀ - Δ), f32
    (B, H, Tq, Tk), as `_recompute_p` and the TPU backward kernels form
    them. There is no query-side mask: invalid query rows carry
    lse = +1e30 (`_flash_forward`), so their P is exactly 0."""
    b, h, tq, _ = q.shape
    s = _masked_scores(q, k, kv_mask, causal)
    p = torch.exp(s - lse.reshape(b, h, tq, 1))
    dp = torch.einsum("bhqd,bhkd->bhqk", _wide(g), _wide(v))
    ds = p * (dp - delta.reshape(b, h, tq, 1))
    return p, ds


def _dq_reference(q, k, v, g, lse, delta, kv_mask, causal):
    """Plain version of `flash_bwd_dq`: dQ = scale·dS·K in q.dtype."""
    _, ds = _bwd_tiles(q, k, v, g, lse, delta, kv_mask, causal)
    scale = 1.0 / q.shape[-1] ** 0.5
    return (scale * torch.einsum("bhqk,bhkd->bhqd", ds, _wide(k))).to(
        q.dtype)


def _dkv_reference(q, k, v, g, lse, delta, kv_mask, causal):
    """Plain version of `flash_bwd_dkv`: dK = scale·dSᵀ·Q and dV = Pᵀ·dO,
    in k.dtype and v.dtype."""
    p, ds = _bwd_tiles(q, k, v, g, lse, delta, kv_mask, causal)
    scale = 1.0 / q.shape[-1] ** 0.5
    dk = scale * torch.einsum("bhqk,bhqd->bhkd", ds, _wide(q))
    dv = torch.einsum("bhqk,bhqd->bhkd", p, _wide(g))
    return dk.to(k.dtype), dv.to(v.dtype)


def _delta(g, o):
    """Δ = rowsum(dO∘O) in f32, (B*H, Tq): one PyTorch reduction, as the
    JAX package computes it outside its kernels (`_flash_backward`)."""
    b, h, tq, _ = o.shape
    return (_wide(g) * _wide(o)).sum(dim=-1).reshape(b * h, tq)


def _flash_backward_reference(q, k, v, o, lse, g, kv_mask, causal):
    """Plain version of both backward kernels, the counterpart of the JAX
    `_flash_backward`: (dq, dk, dv) from the forward's out `o` and
    lse (B*H, Tq) and the output cotangent `g`."""
    delta = _delta(g, o)
    dq = _dq_reference(q, k, v, g, lse, delta, kv_mask, causal)
    return (dq, *_dkv_reference(q, k, v, g, lse, delta, kv_mask, causal))


def _bwd_operands(name, q, k, v, g, lse, delta, kv_mask):
    """Check what a backward kernel takes; returns its operands ready for
    the C entry: (q, k, v, g, lse, delta, mask bytes or None)."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if (k.shape != (b, h, tk, d) or v.shape != k.shape
            or g.shape != q.shape):
        raise ValueError(
            f"{name}: q {tuple(q.shape)} / dO {tuple(g.shape)} do not match "
            f"k {tuple(k.shape)} / v {tuple(v.shape)}")
    q, k, v, g = _operands(name, (q, k, v, g), _FWD_HEAD_DIMS)
    rows = []
    for what, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or t.device != q.device
                or t.shape != (b * h, tq)):
            raise ValueError(
                f"{name}: {what} must be float32 (B*H, Tq) = {(b * h, tq)} "
                f"on {q.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
        rows.append(_aligned(t))
    mask = None
    if kv_mask is not None:
        mask = _mask_bytes(kv_mask, q.device, "kv_mask")
        if mask.shape != (b, tk):
            raise ValueError(f"{name}: kv_mask must be (B, Tk) = {(b, tk)}, "
                             f"got {tuple(mask.shape)}")
    return q, k, v, g, rows[0], rows[1], mask


def _bwd_args(q, k, v, g, lse, delta, mask):
    b, h, tq, d = q.shape
    return ([q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
             lse.data_ptr(), delta.data_ptr(),
             None if mask is None else mask.data_ptr()],
            [_DTYPE_CODES[q.dtype], b * h, h, tq, k.shape[2], d])


def flash_bwd_dq(q, k, v, g, lse, delta, kv_mask=None, causal=False):
    """Kernel csrc/flash_bwd_dq.cu on a CUDA tensor, its plain version on a
    CPU one. q/g (B, H, Tq, D), k/v (B, H, Tk, D), lse and delta (B*H, Tq)
    f32 (lse with the +1e30 sentinel of `_flash_forward`), kv_mask (B, Tk)
    truthy or None. Returns dq (B, H, Tq, D) in q.dtype."""
    if not q.is_cuda:
        return _dq_reference(q, k, v, g, lse, delta, kv_mask, causal)
    q, k, v, g, lse, delta, mask = _bwd_operands(
        "flash_bwd_dq", q, k, v, g, lse, delta, kv_mask)
    dq = torch.empty_like(q)
    d = q.shape[-1]
    ptrs, ints = _bwd_args(q, k, v, g, lse, delta, mask)
    code = _entry("dl4j_flash_bwd_dq")(
        *ptrs, dq.data_ptr(), *ints, int(causal), 1.0 / d ** 0.5,
        q.device.index or 0, _stream(q.device))
    _build.check(code, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, g, lse, delta, kv_mask=None, causal=False):
    """Kernel csrc/flash_bwd_dkv.cu on a CUDA tensor, its plain version on a
    CPU one. Takes what `flash_bwd_dq` takes; returns (dk, dv), each
    (B, H, Tk, D) in k's dtype."""
    if not q.is_cuda:
        return _dkv_reference(q, k, v, g, lse, delta, kv_mask, causal)
    q, k, v, g, lse, delta, mask = _bwd_operands(
        "flash_bwd_dkv", q, k, v, g, lse, delta, kv_mask)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    d = q.shape[-1]
    ptrs, ints = _bwd_args(q, k, v, g, lse, delta, mask)
    code = _entry("dl4j_flash_bwd_dkv")(
        *ptrs, dk.data_ptr(), dv.data_ptr(), *ints, int(causal),
        1.0 / d ** 0.5, q.device.index or 0, _stream(q.device))
    _build.check(code, "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


class _FlashAttention(torch.autograd.Function):
    """The counterpart of the JAX `_flash_attention_vjp` with its
    `_flash_fwd_rule` / `_flash_bwd_rule`: the forward saves q, k, v, the
    output, the lse and the key mask; the backward runs the two backward
    kernels (their plain versions on the CPU). The masks get no gradient,
    as `_zero_mask_cotangent` gives them zeros."""

    @staticmethod
    def forward(ctx, q, k, v, q_mask, kv_mask, causal):
        out, lse = _flash_forward(q, k, v, q_mask, kv_mask, causal)
        ctx.save_for_backward(q, k, v, out, lse, kv_mask)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse, kv_mask = ctx.saved_tensors
        delta = _delta(g, o)
        dq = flash_bwd_dq(q, k, v, g, lse, delta, kv_mask, ctx.causal)
        dk, dv = flash_bwd_dkv(q, k, v, g, lse, delta, kv_mask, ctx.causal)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal=False, mask=None, kv_mask=None):
    """Fused attention softmax(QKᵀ/√d)·V, differentiable in q, k and v:
    the forward runs `flash_fwd`, the backward `flash_bwd_dq` and
    `flash_bwd_dkv` (their plain versions on the CPU). Cross-attention
    (Tq ≠ Tk) runs the same kernels.

    Masks for padded batches, as in the JAX package:
    - self-attention: pass `mask` (B, T); a False position is invalid as
      both key and query; its output rows come back as zeros.
    - cross-attention: pass `kv_mask` (B, Tk) for key padding and
      optionally `mask` (B, Tq) for query-row padding.
    Gradients flow to q/k/v only at valid positions; the masks get none.
    """
    tq, tk = q.shape[2], k.shape[2]
    if causal and tq != tk:
        raise ValueError(
            f"causal flash attention requires Tq == Tk, got {tq} != {tk}")
    if mask is not None and mask.ndim != 2:
        raise ValueError(f"mask must be (batch, seq), got {mask.shape}")
    if kv_mask is not None and kv_mask.ndim != 2:
        raise ValueError(
            f"kv_mask must be (batch, kv_seq), got {kv_mask.shape}")
    if kv_mask is None:
        if mask is not None and tq != tk:
            raise ValueError(
                "a single (B, T) mask implies self-attention (Tq == Tk); "
                f"got Tq={tq}, Tk={tk} — pass kv_mask for cross-attention")
        kv_mask = mask
    if mask is not None and mask.shape[1] != tq:
        raise ValueError(
            f"query mask length {mask.shape[1]} != Tq {tq}")
    if kv_mask is not None and kv_mask.shape[1] != tk:
        raise ValueError(
            f"kv_mask length {kv_mask.shape[1]} != Tk {tk}")
    return _FlashAttention.apply(q, k, v, mask, kv_mask, causal)


# ---------------------------------------------------------------------------
# kernel 2: single-query decode
# ---------------------------------------------------------------------------
def _decode_reference(q, k_cache, v_cache, cache_mask):
    """Plain version of `flash_decode`: softmax(q·Kᵀ/√d)·V over the VALID
    cache rows only, in f32. q (B, H, 1, D). Rows with no valid key come
    back zeroed."""
    d = q.shape[-1]
    scale = 1.0 / d ** 0.5
    s = torch.einsum("bhqd,bhcd->bhqc", q.float(), k_cache.float()) * scale
    valid = cache_mask.to(torch.bool)
    s = torch.where(valid[:, None, None, :], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqc,bhcd->bhqd", p, v_cache.float()).to(q.dtype)
    any_valid = valid.any(dim=-1)
    return torch.where(any_valid[:, None, None, None], out, 0)


def flash_decode(q, k_cache, v_cache, cache_mask):
    """Kernel 2 (csrc/flash_decode.cu) on a CUDA tensor, its plain version
    on a CPU one. q (B, H, 1, D), caches (B, H, C, D), cache_mask (B, C)
    truthy. Returns (B, H, 1, D) in q.dtype."""
    if not q.is_cuda:
        return _decode_reference(q, k_cache, v_cache, cache_mask)
    b, h, _, d = q.shape
    c = k_cache.shape[2]
    q, k, v = _operands("flash_decode", (q, k_cache, v_cache),
                        _DECODE_HEAD_DIMS)
    mask = _mask_bytes(cache_mask, q.device, "cache_mask")
    out = torch.empty_like(q)
    code = _entry("dl4j_flash_decode")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        out.data_ptr(), _DTYPE_CODES[q.dtype], b * h, h, c, d,
        1.0 / d ** 0.5, q.device.index or 0, _stream(q.device))
    _build.check(code, "flash_decode")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


def decode_cluster_size(b, h, c, d, dtype, device):
    """The CTAs of the thread-block cluster that `flash_decode` launches
    for each (b, h) at this shape on `device` (a CUDA device): 2, 4 or 8,
    each reading a contiguous share of the C cache rows."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"decode_cluster_size: flash_decode runs on a CUDA "
                         f"device, got {dev}")
    if dtype not in _DTYPE_CODES or d not in _DECODE_HEAD_DIMS:
        raise ValueError(f"flash_decode takes float32 or bfloat16 at head "
                         f"dims {_DECODE_HEAD_DIMS}, got {dtype}, {d}")
    return _entry("dl4j_flash_decode_cluster")(
        _DTYPE_CODES[dtype], b * h, c, d, dev.index or 0)


def flash_attention_decode(q1, k_cache, v_cache, cache_mask, impl="auto"):
    """Incremental-decode attention: ONE query per sequence attends that
    sequence's cached K/V under a cache-validity mask.

    - q1: (B, H, D) or (B, H, 1, D) — current-token query
    - k_cache / v_cache: (B, H, C, D)
    - cache_mask: (B, C) truthy — valid cache rows (ragged lengths)
    - impl: 'auto' (kernel on the card, dense on the CPU), 'kernel'
      (`flash_decode`: the kernel on the card, its plain version on the
      CPU) or 'dense'
    Rows whose mask has NO valid cache entry return zeros. Returns the
    same rank as q1.
    """
    squeeze = q1.ndim == 3
    q = q1[:, :, None, :] if squeeze else q1
    if q.ndim != 4 or q.shape[2] != 1:
        raise ValueError(
            f"q1 must be (B, H, D) or (B, H, 1, D), got {q1.shape}")
    if k_cache.shape != v_cache.shape or k_cache.ndim != 4:
        raise ValueError(
            f"k_cache/v_cache must match as (B, H, C, D): "
            f"{k_cache.shape} vs {v_cache.shape}")
    if tuple(cache_mask.shape) != (q.shape[0], k_cache.shape[2]):
        raise ValueError(
            f"cache_mask must be (B, C) = "
            f"{(q.shape[0], k_cache.shape[2])}, got {cache_mask.shape}")
    if impl not in ("auto", "kernel", "dense"):
        raise ValueError(
            f"unknown decode impl {impl!r}; expected 'auto', 'kernel' "
            "or 'dense'")
    if impl == "auto":
        impl = "kernel" if q.is_cuda else "dense"
    if impl == "kernel":
        out = flash_decode(q, k_cache, v_cache, cache_mask)
    else:
        out = _decode_reference(q, k_cache, v_cache, cache_mask)
    return out[:, :, 0, :] if squeeze else out


def flash_attention_decode_mq(q, k_cache, v_cache, q_mask, impl="auto"):
    """Multi-query decode attention: a block of queries per sequence
    attends the cached K/V under a per-query validity mask
    `q_mask[b, j, c]` (row c valid for query j). As in the JAX package it
    is an einsum on every device; 'kernel' is rejected. Queries with NO
    valid cache row return zeros."""
    if q.ndim != 4:
        raise ValueError(f"q must be (B, H, Tq, D), got {q.shape}")
    if k_cache.shape != v_cache.shape or k_cache.ndim != 4:
        raise ValueError(
            f"k_cache/v_cache must match as (B, H, C, D): "
            f"{k_cache.shape} vs {v_cache.shape}")
    expect = (q.shape[0], q.shape[2], k_cache.shape[2])
    if tuple(q_mask.shape) != expect:
        raise ValueError(
            f"q_mask must be (B, Tq, C) = {expect}, got {q_mask.shape}")
    if impl == "kernel":
        raise ValueError(
            "impl='kernel' has no multi-query ragged-mask variant — "
            "the draft q-block runs the einsum path on every device")
    if impl not in ("auto", "dense"):
        raise ValueError(
            f"unknown decode impl {impl!r}; expected 'auto', 'kernel' "
            "or 'dense'")
    d = q.shape[-1]
    scale = 1.0 / d ** 0.5
    s = torch.einsum("bhqd,bhcd->bhqc", q.float(), k_cache.float()) * scale
    valid = q_mask.to(torch.bool)
    s = torch.where(valid[:, None, :, :], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqc,bhcd->bhqd", p, v_cache.float()).to(q.dtype)
    any_valid = valid.any(dim=-1)
    return torch.where(any_valid[:, None, :, None], out, 0)
