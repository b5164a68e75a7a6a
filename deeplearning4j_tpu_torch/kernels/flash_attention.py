"""Flash attention, forward only: the port of
`deeplearning4j_tpu/kernels/flash_attention.py`.

Two hand-written Hopper kernels carry it on the card:

- `flash_fwd` (csrc/flash_fwd.cu): tiled online-softmax attention over
  (B, H, Tq, D) × (B, H, Tk, D) with an optional causal mask and an
  optional (B, Tk) key mask; it emits O and the per-row logsumexp. BERT
  encode (`attn_impl="flash"`) and decoder prefill run it.
- `flash_decode` (csrc/flash_decode.cu): one query per (b, h) against a
  (B, H, C, D) cache under a (B, C) cache mask; the decode step runs it.

Each wrapper launches its kernel for a CUDA tensor, counts the launch on
its `launches` attribute, and raises on what the kernel does not take. For
a CPU tensor it runs the kernel's plain PyTorch version beside it
(`_flash_forward_reference`, `_decode_reference`), which is what the CPU
tests compare with the JAX package.

Layout (B, H, T, D) as in the JAX package. Scores that a mask removes take
-1e30, as in the JAX kernel; rows with no valid key come back as zeros.
"""
from __future__ import annotations

import ctypes

import torch

from deeplearning4j_tpu_torch.kernels import _build

__all__ = ["flash_attention", "flash_attention_decode",
           "flash_attention_decode_mq", "flash_fwd", "flash_decode"]

_NEG_INF = -1e30

#: dtype codes of the C entry points (csrc/common.cuh)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_FWD_HEAD_DIMS = (16, 32, 64)
_DECODE_HEAD_DIMS = (32, 64, 128)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ENTRIES = {
    # q, k, v, kv_mask, o, lse, dtype, BH, H, Tq, Tk, D, causal, scale,
    # device, stream
    "flash_fwd": ("dl4j_flash_fwd",
                  [_P] * 6 + [_I] * 7 + [_F, _I, _P]),
    # q, k, v, mask, o, dtype, BH, H, C, D, scale, device, stream
    "flash_decode": ("dl4j_flash_decode",
                     [_P] * 5 + [_I] * 5 + [_F, _I, _P]),
}
_bound = {}


def _entry(name):
    fn = _bound.get(name)
    if fn is None:
        sym, argtypes = _ENTRIES[name]
        fn = getattr(_build.library(name), sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _bound[name] = fn
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
def _flash_forward_reference(q, k, v, kv_mask, causal):
    """Plain version of `flash_fwd`: the same masked online-softmax result
    computed densely in f32. Returns (out (B, H, Tq, D) in q.dtype,
    lse (B*H, Tq) f32)."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    scale = 1.0 / d ** 0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, k.float())
    valid = torch.ones((1, 1, tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        valid = torch.tril(valid)
    if kv_mask is not None:
        valid = valid & kv_mask.to(torch.bool)[:, None, None, :]
    s = torch.where(valid, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / l
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
    code = _entry("flash_fwd")(
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


def flash_attention(q, k, v, causal=False, mask=None, kv_mask=None):
    """Fused attention softmax(QKᵀ/√d)·V, forward only.

    Masks for padded batches, as in the JAX package:
    - self-attention: pass `mask` (B, T); a False position is invalid as
      both key and query; its output rows come back as zeros.
    - cross-attention: pass `kv_mask` (B, Tk) for key padding and
      optionally `mask` (B, Tq) for query-row padding.
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
    if q.is_cuda and torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward on the card yet: the dQ and "
            "dK/dV kernels (_flash_bwd_dq_kernel, _flash_bwd_dkv_kernel) "
            "come with the training slice of the port")
    out, _ = _flash_forward(q, k, v, mask, kv_mask, causal)
    return out


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
    code = _entry("flash_decode")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        out.data_ptr(), _DTYPE_CODES[q.dtype], b * h, h, c, d,
        1.0 / d ** 0.5, q.device.index or 0, _stream(q.device))
    _build.check(code, "flash_decode")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


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
