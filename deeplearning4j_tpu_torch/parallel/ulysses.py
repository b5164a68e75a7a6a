"""All-to-all (Ulysses-style) sequence parallelism over the `sp` axis: the
port of `deeplearning4j_tpu/parallel/ulysses.py`.

The complement to ring attention: instead of rotating K/V blocks, two
all-to-alls re-shard

    (B, H, T/n, D)  --all_to_all-->  (B, H/n, T, D)

so each rank holds the whole sequence for its group of heads and runs
ordinary attention locally (causal unchanged; a padding mask rides one
all-gather), and a last all-to-all restores sequence sharding. Passing
`kernels.flash_attention.flash_attention` as `attn_fn` runs the flash
kernels (B1 forward, B2a and B2b backward) on the local heads.
"""
from __future__ import annotations

import inspect

from deeplearning4j_tpu_torch.parallel import mesh as _mesh
from deeplearning4j_tpu_torch.parallel.mesh import P, shard_map
from deeplearning4j_tpu_torch.parallel.ring_attention import \
    blockwise_attention
from deeplearning4j_tpu_torch.util.introspect import explicit_mask_param

__all__ = ["make_ulysses_attention", "ulysses_attention_sharded"]


def make_ulysses_attention(mesh, axis_name="sp", causal=False,
                           attn_fn=None, block_size=512):
    """f(q_local, k_local, v_local, mask_local=None) for use INSIDE
    shard_map over `mesh`: q/k/v locals are (B, H, T/n, D) sharded on
    time, the optional padding mask (B, T/n); the output is sharded like
    q. Requires H % n == 0. attn_fn overrides the local attention
    (default: `blockwise_attention`, O(T) memory, masked batches too);
    its signature is f(q, k, v, causal=..., kv_mask=None), and a custom
    attn_fn without an explicit kv_mask parameter fails loudly on a
    masked batch rather than attending to padding. The whole (B, T) mask
    is all-gathered once."""
    custom_attn = attn_fn is not None
    if attn_fn is None:
        def attn_fn(q, k, v, causal=False, kv_mask=None):
            return blockwise_attention(q, k, v, block_size=block_size,
                                       causal=causal, kv_mask=kv_mask)

    def ulysses(q, k, v, mask=None):
        n = _mesh.psum(1, axis_name)
        h = q.shape[1]
        if h % n:
            raise ValueError(
                f"ulysses attention needs heads ({h}) divisible by the "
                f"{axis_name!r} axis size ({n}) — use ring attention for "
                "head counts below the mesh axis")

        def gather_seq(x):   # (B, H, T/n, D) -> (B, H/n, T, D)
            return _mesh.all_to_all(x, axis_name, split_axis=1,
                                    concat_axis=2, tiled=True)

        def scatter_seq(x):  # (B, H/n, T, D) -> (B, H, T/n, D)
            return _mesh.all_to_all(x, axis_name, split_axis=2,
                                    concat_axis=1, tiled=True)

        qg, kg, vg = gather_seq(q), gather_seq(k), gather_seq(v)
        if mask is not None:
            full = _mesh.all_gather(mask, axis_name, axis=1, tiled=True)
            if custom_attn:
                # kv_mask goes BY KEYWORD, so the impl must name it as a
                # keyword-reachable parameter (a bare **kwargs would
                # swallow it); bind() then checks the rest of the call
                ok = explicit_mask_param(attn_fn,
                                         names=("kv_mask",)) is not None
                if ok:
                    try:
                        inspect.signature(attn_fn).bind(
                            qg, kg, vg, causal=causal, kv_mask=full)
                    except TypeError:
                        ok = False
                if not ok:
                    raise ValueError(
                        "masked batch but the custom attn_fn does not "
                        "explicitly declare a kv_mask parameter (bare "
                        "**kwargs does not count) or cannot be called "
                        "with (q, k, v, causal=..., kv_mask=...) — "
                        "silent padding attention is not an option; "
                        "accept attn_fn(q, k, v, causal=..., "
                        "kv_mask=None)")
            out = attn_fn(qg, kg, vg, causal=causal, kv_mask=full)
        else:
            out = attn_fn(qg, kg, vg, causal=causal)
        return scatter_seq(out.to(q.dtype))

    return ulysses


def ulysses_attention_sharded(mesh, q, k, v, mask=None, axis_name="sp",
                              causal=False, attn_fn=None):
    """Convenience wrapper over global (B, H, T, D) tensors (mask (B, T)):
    shards the time axis over `axis_name`, runs the all-to-all attention,
    and returns the global result."""
    spec = P(None, None, axis_name, None)
    fn = make_ulysses_attention(mesh, axis_name, causal=causal,
                                attn_fn=attn_fn)
    if mask is None:
        return shard_map(lambda a, b, c: fn(a, b, c), mesh=mesh,
                         in_specs=(spec, spec, spec), out_specs=spec,
                         check_vma=False)(q, k, v)
    return shard_map(fn, mesh=mesh,
                     in_specs=(spec, spec, spec, P(None, axis_name)),
                     out_specs=spec, check_vma=False)(q, k, v, mask)
