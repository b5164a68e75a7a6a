"""int8 KV-cache codec of the decode path: the port of
`deeplearning4j_tpu/quantize/kvcache.py`.

The single-query decode step reads the whole K/V cache once per token.
Storing it int8 with one float32 scale per (head, row) cuts that read to
about a quarter of f32 at a per-row error that the softmax largely absorbs.

Layout: beside each `(..., C, D)` int8 cache tensor rides a `(..., C)`
float32 scale tensor. Each head quantizes each cached row against that
row's own absmax, so one outlier head or position cannot crush the
resolution of the rest. The scales fold into the attention contractions
(`flash_attention_decode(..., k_scale=, v_scale=)`: the key scale onto the
logits, the value scale onto the softmax weights), so no dequantized copy
of the cache is kept.

The codec composes with the paged layout unchanged: an int8 page is the
same `(H, ps, Dh)` block plus its `(H, ps)` scale page; `cache_page_bytes`
is the one place that arithmetic lives.
"""
from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.quantize.core import INT8_MAX

__all__ = ["quantize_rows", "dequantize_rows", "cache_page_bytes"]


def cache_page_bytes(layers, heads, page_size, head_dim, kv_dtype="fp",
                     dtype_bytes=4):
    """Device bytes one physical KV page costs across all layers: K and V
    blocks of `(heads, page_size, head_dim)` per layer. int8 pages pay 1
    byte an element plus the per-(head, row) float32 scales, fp pages
    `dtype_bytes`. Host arithmetic only (pool sizing)."""
    rows = int(heads) * int(page_size)
    if kv_dtype == "int8":
        per = rows * int(head_dim) * 1 + rows * 4   # payload + scales
    else:
        per = rows * int(head_dim) * int(dtype_bytes)
    return 2 * int(layers) * per                    # K and V pools


def quantize_rows(x):
    """Per-row symmetric int8: x (..., D) → (q int8 (..., D), scale f32
    (...,)) with scale = absmax(row)/127 (an all-zero row gets scale 1 so
    it round-trips to zeros). The division stays in f32 and rounds half to
    even, as in the JAX package, so the bytes equal its bytes."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / INT8_MAX, 1.0)
    q = torch.round(xf / scale[..., None])
    return q.clamp(-INT8_MAX, INT8_MAX).to(torch.int8), scale


def dequantize_rows(q, scale, dtype=torch.float32):
    """Inverse of quantize_rows (materializing: the decode path folds the
    scales into attention instead)."""
    return (q.float() * scale[..., None]).to(dtype)
