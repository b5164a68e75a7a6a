"""Ring attention, sequence parallelism over the `sp` axis: the port of
`deeplearning4j_tpu/parallel/ring_attention.py`.

The sequence is split over the axis's ranks; K/V blocks rotate around
the ring (`mesh.ppermute`, one hop a step) while each rank accumulates its
queries' attention with an online softmax (Liu et al., Ring Attention).
Single-device callers get the same math from `blockwise_attention` or
`dense_attention`.

Two rings, as in the JAX package:
- the plain ring: the online-softmax accumulator in PyTorch, a key mask
  (B, T/n) rotating with its block; differentiable through autograd
  (each hop's adjoint is the reverse hop);
- the flash ring (`_RingFlash`): each held block runs the flash forward
  kernel (B1) and the partial (o, lse) pairs merge with a logsumexp merge
  that is safe at -inf; its backward is a second ring that runs the dQ
  and dK/dV kernels (B2a, B2b) under the GLOBAL lse, with Δ taken once
  from the global O and dO, and the dK/dV partial sums riding around the
  ring with their blocks until they are home. Causal: at step i a rank
  holds the block of rank (my − i) mod n, so i == 0 is the diagonal
  (the causal kernel), i ≤ my a past block (the full kernel), and i > my
  a future block, skipped (lse −inf, zero gradients). The kernel's two
  sentinels read as "no contribution": +1e30 for a row with no valid key
  (`_flash_forward`) and ≤ −1e29 for a causal row starved by the mask.

The flash ring is the default on CUDA tensors for the non-causal ring;
causal and masked flash rings are opt-in (`use_flash=True`), and
`ring_attention` picks the plain ring for a masked batch. The port's
kernels return lse as (B·H, T/n) with no padding (the JAX kernels pad it
to the query tile).

Shapes: (B, H, T, D) throughout; softmax statistics in float32.
"""
from __future__ import annotations

import math

import torch

from deeplearning4j_tpu_torch.kernels.flash_attention import (
    _delta, _flash_forward, flash_bwd_dkv, flash_bwd_dq)
from deeplearning4j_tpu_torch.parallel import mesh as _mesh
from deeplearning4j_tpu_torch.parallel.mesh import P, shard_map

__all__ = ["dense_attention", "blockwise_attention", "make_ring_attention",
           "ring_attention"]


def dense_attention(q, k, v, causal=False, mask=None, scale=None):
    """Reference O(T²) attention (numerics oracle for the other paths).

    Unlike the flash kernels it masks with -inf and does NOT zero
    fully-masked rows (they come back as NaN), as in the JAX package.
    The default scale is 1/√d rounded through q's dtype, as there."""
    if scale is None:
        root = torch.tensor(math.sqrt(q.shape[-1]), dtype=torch.float32)
        scale = float((1.0 / root.to(q.dtype)).float())
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    if causal:
        tq, tk = logits.shape[-2], logits.shape[-1]
        causal_mask = torch.tril(
            torch.ones((tq, tk), dtype=torch.bool, device=q.device),
            diagonal=tk - tq)
        logits = torch.where(causal_mask, logits, -math.inf)
    if mask is not None:
        logits = torch.where(mask, logits, -math.inf)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def _scale(d):
    """1/√d in f32, as `1.0 / jnp.sqrt(d)`."""
    return torch.tensor(1.0, dtype=torch.float32) / torch.sqrt(
        torch.tensor(float(d), dtype=torch.float32))


def _block_accumulate(carry, q, k, v, logits_mask, scale):
    """Online-softmax accumulation of one K/V block into (o, l, m)."""
    o, l, m = carry
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    if logits_mask is not None:
        s = torch.where(logits_mask, s, -1e30)
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * alpha + p.sum(dim=-1)
    o_new = o * alpha[..., None] + torch.einsum(
        "bhqk,bhkd->bhqd", p.to(v.dtype), v).float()
    return o_new, l_new, m_new


def _start(q):
    b, h, t, d = q.shape
    return (torch.zeros((b, h, t, d), dtype=torch.float32, device=q.device),
            torch.zeros((b, h, t), dtype=torch.float32, device=q.device),
            torch.full((b, h, t), -math.inf, dtype=torch.float32,
                       device=q.device))


def blockwise_attention(q, k, v, block_size=512, causal=False,
                        kv_mask=None):
    """Single-device flash-style attention: a loop over K/V blocks with an
    online softmax, O(T·block) memory. kv_mask (B, T): key validity
    (invalid keys never receive probability)."""
    b, h, t, d = q.shape
    scale = _scale(d).to(q.device)
    q_pos = torch.arange(t, device=q.device)
    carry = _start(q)
    for start in range(0, t, block_size):
        stop = min(start + block_size, t)
        k_pos = torch.arange(start, stop, device=q.device)
        lm = None
        if causal:
            lm = (q_pos[:, None] >= k_pos[None, :])[None, None]
        if kv_mask is not None:
            km = (kv_mask[:, start:stop] > 0)[:, None, None, :]
            lm = km if lm is None else lm & km
        carry = _block_accumulate(carry, q, k[:, :, start:stop],
                                  v[:, :, start:stop], lm, scale)
    o, l, _ = carry
    return (o / l.clamp_min(1e-30)[..., None]).to(q.dtype)


def _ring_context(axis_name):
    """(group, ranks, my index, n) of the current mesh's axis."""
    mesh = _mesh.current_mesh()
    n = mesh.shape[axis_name]
    group = mesh.group(axis_name)
    ranks = mesh.group_ranks.get(axis_name, [0])
    return group, ranks, mesh.index(axis_name), (n if group else 1)


def _hop(x, ctx):
    """One hop around the ring (no autograd: the flash ring's backward is
    its own ring)."""
    group, ranks, _, n = ctx
    if x is None or n == 1:
        return x
    return _mesh._ppermute(x, group, ranks, 1)


def _kind(i, my, causal):
    """The flash ring's block at step i: "full", "diag" or "future"."""
    if not causal:
        return "full"
    if i == 0:
        return "diag"
    return "full" if i <= my else "future"


def _ring_forward(q, k, v, kv_mask, causal, ctx):
    """The forward ring: per-block (o, lse) partials merged -inf-safely.
    Returns (o f32 (B, H, T/n, D), lse f32 (B, H, T/n))."""
    _, _, my, n = ctx
    b, h, t, _ = q.shape
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, t), -math.inf, dtype=torch.float32,
                     device=q.device)
    kblk, vblk, mblk = k, v, kv_mask
    for i in range(n):
        kind = _kind(i, my, causal)
        if kind != "future":
            ob, lse_b = _flash_forward(q, kblk, vblk, None, mblk,
                                       kind == "diag")
            lse_b = lse_b.reshape(b, h, t)
            # +1e30: the kernel's row with no valid key; <= -1e29: a causal
            # row the mask starved. Neither contributes.
            lse_b = torch.where((lse_b >= 1e29) | (lse_b <= -1e29),
                                -math.inf, lse_b)
            m = torch.maximum(lse, lse_b)
            m_safe = torch.where(torch.isfinite(m), m, 0.0)
            w1 = torch.where(torch.isfinite(lse), torch.exp(lse - m_safe),
                             0.0)
            w2 = torch.where(torch.isfinite(lse_b),
                             torch.exp(lse_b - m_safe), 0.0)
            s = (w1 + w2).clamp_min(1e-30)
            o = (o * w1[..., None] + ob.float() * w2[..., None]) / s[..., None]
            lse = m + torch.log(s)
        if i < n - 1:
            kblk, vblk, mblk = (_hop(kblk, ctx), _hop(vblk, ctx),
                                _hop(mblk, ctx))
    return o, lse


def _ring_backward(q, k, v, kv_mask, out, lse, g, causal, ctx):
    """The backward ring under the global lse: dq accumulates here, the
    dk/dv partials travel with their blocks and arrive home after the
    full cycle."""
    _, _, my, n = ctx
    b, h, t, _ = q.shape
    # rows that saw no valid key anywhere merged to -inf; the kernels read
    # +1e30 there, so P = exp(finite - 1e30) == 0
    lse2 = torch.where(torch.isfinite(lse), lse, 1e30).reshape(b * h, t)
    g = g.contiguous()
    delta = _delta(g, out)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    kblk, vblk, mblk = k, v, kv_mask
    for i in range(n):
        kind = _kind(i, my, causal)
        if kind != "future":
            # a future block never entered the softmax: the global-lse
            # recompute would give it a nonzero P, so it is skipped
            diag = kind == "diag"
            dq = dq + flash_bwd_dq(q, kblk, vblk, g, lse2, delta, mblk,
                                   diag).float()
            dk_i, dv_i = flash_bwd_dkv(q, kblk, vblk, g, lse2, delta, mblk,
                                       diag)
            dk = dk + dk_i.float()
            dv = dv + dv_i.float()
        if i < n - 1:
            kblk, vblk, mblk = (_hop(kblk, ctx), _hop(vblk, ctx),
                                _hop(mblk, ctx))
        dk, dv = _hop(dk, ctx), _hop(dv, ctx)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingFlash(torch.autograd.Function):
    """The flash ring (≡ the JAX package's `_make_ring_flash` custom VJP):
    B1 per held block forward, B2a and B2b per block backward, under the
    global lse. The mask gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, ring):
        o, lse = _ring_forward(q, k, v, kv_mask, causal, ring)
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.causal, ctx.ring = causal, ring
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_backward(q, k, v, kv_mask, out, lse, g,
                                    ctx.causal, ctx.ring)
        return dq, dk, dv, None, None, None


def _make_ring_flash(axis_name, causal=False):
    def ring_flash(q, k, v, kv_mask=None):
        if kv_mask is not None and kv_mask.dtype == torch.bool:
            kv_mask = kv_mask.to(torch.uint8)   # bytes on every transport
        return _RingFlash.apply(q, k, v, kv_mask, causal,
                                _ring_context(axis_name))

    return ring_flash


def _make_plain_ring(axis_name, causal=False):
    def ring_attn(q, k, v, kv_mask=None):
        """kv_mask: the local (B, T/n) key-validity slice; it rotates
        around the ring with its K/V block."""
        ring = _ring_context(axis_name)
        my, n = ring[2], ring[3]
        b, h, t, d = q.shape
        scale = _scale(d).to(q.device)
        q_pos = my * t + torch.arange(t, device=q.device)
        carry = _start(q)
        kblk, vblk, mblk = k, v, kv_mask
        for i in range(n):
            src = (my - i) % n   # whose K/V block this rank holds
            lm = None
            if causal:
                k_pos = src * t + torch.arange(t, device=q.device)
                lm = (q_pos[:, None] >= k_pos[None, :])[None, None]
            if mblk is not None:
                km = (mblk > 0)[:, None, None, :]
                lm = km if lm is None else lm & km
            carry = _block_accumulate(carry, q, kblk, vblk, lm, scale)
            if i < n - 1:
                kblk = _mesh.ppermute(kblk, axis_name)
                vblk = _mesh.ppermute(vblk, axis_name)
                if mblk is not None:
                    mblk = _mesh.ppermute(mblk, axis_name)
        o, l, _ = carry
        return (o / l.clamp_min(1e-30)[..., None]).to(q.dtype)

    return ring_attn


def make_ring_attention(mesh, axis_name="sp", causal=False, use_flash=None,
                        block_q=128, block_k=128, interpret=None):
    """f(q_local, k_local, v_local, kv_mask=None) for use INSIDE shard_map
    over `mesh`: each of the n ranks holds (B, H, T/n, D) and the K/V
    blocks rotate around the ring, one hop a step.

    use_flash None: the flash ring on CUDA tensors when not causal, the
    plain ring otherwise; True or False forces one. `block_q`, `block_k`
    and `interpret` are the JAX package's Pallas knobs, accepted for its
    signature: the port's kernels pick their own tiles."""
    flash = _make_ring_flash(axis_name, causal)
    plain = _make_plain_ring(axis_name, causal)

    def ring(q, k, v, kv_mask=None):
        use = use_flash
        if use is None:
            use = q.is_cuda and not causal
        return (flash if use else plain)(q, k, v, kv_mask)

    return ring


def ring_attention(q, k, v, mesh, axis_name="sp", causal=False,
                   kv_mask=None):
    """Convenience wrapper over global tensors: shard (B, H, T, D) over T,
    run the ring, gather. kv_mask (B, T): key validity for a padded batch;
    a masked batch takes the plain ring (the masked flash ring is opt-in
    through make_ring_attention(use_flash=True))."""
    fn = make_ring_attention(mesh, axis_name, causal,
                             use_flash=False if kv_mask is not None
                             else None)
    spec = P(None, None, axis_name, None)
    args, specs = [q, k, v], [spec, spec, spec]
    if kv_mask is not None:
        args.append(kv_mask)
        specs.append(P(None, axis_name))
    return shard_map(fn, mesh=mesh, in_specs=tuple(specs),
                     out_specs=spec, check_vma=False)(*args)
