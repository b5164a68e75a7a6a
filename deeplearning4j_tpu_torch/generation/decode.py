"""Decode-mode forwards: the port of
`deeplearning4j_tpu/generation/decode.py`'s `BertDecoder`, dense fp cache.

`BertDecoder` keeps per-layer K/V caches `(L, S, H, C, Dh)` (C = the
cache-length rung). `step` embeds each slot's current token at its
position, writes its K/V row, and attends the single query against the
cache through `flash_attention_decode` (the `flash_decode` kernel on the
card). `prefill` runs the causal full forward over a length-bucketed
prompt (the `flash_fwd` kernel on the card) and writes the slot's K/V
block. Where the JAX package donates the cache through each dispatch, the
port updates it in place and returns the same dict. `step`, `prefill`
and `grow_into` read no device value on the host and allocate nothing
that outlives them, so `GenerationServer` captures them into CUDA graphs;
`prefill` takes its slot and prompt length as device tensors for that.

The full-sequence reference this must match (≤ 1e-5) is
`bert_encode(..., causal=True)` + `bert_mlm_logits` over the same prefix.

Not in this slice: the int8 cache (`kv_dtype="int8"`), paged KV
(`page_size`), draft verification (`verify`) and `RecurrentDecoder`.
"""
from __future__ import annotations

import hashlib

import torch

from deeplearning4j_tpu_torch.kernels.flash_attention import (
    flash_attention, flash_attention_decode)
from deeplearning4j_tpu_torch.models.bert import (_ffn, _layer_norm,
                                                  bert_mlm_logits,
                                                  check_supported)
from deeplearning4j_tpu_torch.parallel.ring_attention import dense_attention

__all__ = ["BertDecoder"]


def _shape_tree_repr(tree):
    if isinstance(tree, dict):
        return repr({k: _shape_tree_repr(v) for k, v in sorted(tree.items())})
    if isinstance(tree, (list, tuple)):
        return repr([_shape_tree_repr(v) for v in tree])
    return repr((tuple(tree.shape), str(tree.dtype)))


class BertDecoder:
    """KV-cache decode over a `models/bert.py` parameter dict. Runs on the
    device the parameters lie on."""

    def __init__(self, cfg, params, attn_impl="auto", kv_dtype="fp",
                 page_size=None, pool_pages=None):
        check_supported(cfg)
        if attn_impl not in ("auto", "dense", "kernel"):
            raise ValueError(
                f"attn_impl must be 'auto', 'dense' or 'kernel', "
                f"got {attn_impl!r}")
        if kv_dtype == "int8":
            raise NotImplementedError(
                "kv_dtype='int8' is not ported yet; the int8 KV cache "
                "comes with the quantize/ slice")
        if kv_dtype != "fp":
            raise ValueError(
                f"kv_dtype must be 'fp' or 'int8', got {kv_dtype!r}")
        if page_size is not None or pool_pages is not None:
            raise NotImplementedError(
                "paged KV (page_size/pool_pages) is not ported yet; it "
                "comes with the paged-serving slice")
        self.cfg = cfg
        self.params = params
        self.attn_impl = attn_impl
        self.device = params["embeddings"]["word"].device
        self.vocab_size = int(cfg.vocab_size)
        self.max_cache_len = int(cfg.max_position_embeddings)

    def fingerprint(self):
        parts = ("bert-decode", repr(self.cfg), self.attn_impl,
                 _shape_tree_repr(self.params), torch.__version__)
        return hashlib.sha256(repr(parts).encode()).hexdigest()[:16]

    def model_args(self):
        return (self.params,)

    def init_cache(self, slots, cache_len):
        cfg = self.cfg
        shape = (cfg.num_layers, slots, cfg.num_heads, cache_len,
                 cfg.head_dim)
        dt = cfg.compute_dtype
        return {"k": torch.zeros(shape, dtype=dt, device=self.device),
                "v": torch.zeros(shape, dtype=dt, device=self.device)}

    def grow(self, cache, new_len):
        """The cache padded with zero rows to the longer rung `new_len`."""
        big = {name: t.new_zeros(t.shape[:3] + (int(new_len),) + t.shape[4:])
               for name, t in cache.items()}
        return self.grow_into(cache, big)

    def grow_into(self, cache, big):
        """Copy `cache` into the longer rung's cache `big` (rows beyond
        the shorter rung zeroed), in place; returns `big`."""
        for name, t in cache.items():
            big[name].zero_()
            big[name][:, :, :, :t.shape[3]].copy_(t)
        return big

    def verify(self, margs, cache, tokens, pos, draft):
        raise NotImplementedError(
            "draft verification is not ported yet; it comes with the "
            "drafting slice of the serving port")

    def _embed(self, params, tokens, pos):
        """Token + position embedding at per-slot positions (mirrors
        bert_encode's embedding block; token_type unused in LM mode)."""
        emb = params["embeddings"]
        x = emb["word"][tokens] + emb["position"][pos]
        return _layer_norm(x.to(self.cfg.compute_dtype), emb["ln_scale"],
                           emb["ln_bias"], self.cfg.layer_norm_eps)

    def _decode_attn(self, q, kc, vc, cmask):
        impl = self.attn_impl
        if impl == "auto":
            impl = "kernel" if q.is_cuda else "dense"
        return flash_attention_decode(q, kc, vc, cmask, impl=impl)

    def _prefill_attn(self, q, k, v):
        if self.attn_impl == "kernel" or (
                self.attn_impl == "auto" and q.is_cuda):
            return flash_attention(q, k, v, causal=True)
        return dense_attention(q, k, v, causal=True)

    def step(self, margs, cache, tokens, pos):
        """One decode step for the whole batch: embed `tokens` (S,) at
        their slot positions `pos` (S,) (the number of already-cached
        tokens), write each slot's K/V row at `pos`, attend the single
        query over rows 0..pos, and return (next-token logits (S, V),
        cache)."""
        (params,) = margs
        cfg = self.cfg
        x = self._embed(params, tokens, pos)            # (S, H)
        kc, vc = cache["k"], cache["v"]
        s = tokens.shape[0]
        c = kc.shape[3]
        ar = torch.arange(s, device=kc.device)
        nh, hd = cfg.num_heads, cfg.head_dim
        # rows 0..pos are valid (the current write included)
        cmask = torch.arange(c, device=kc.device)[None, :] <= pos[:, None]
        # a frozen lane may sit at pos == C: the JAX scatter silently
        # drops that out-of-range write, a torch index write would fault —
        # so write at a clamped row and keep its old contents there
        inside = (pos < c)[:, None, None]
        wpos = pos.clamp(max=c - 1)
        dt = x.dtype
        for li, layer in enumerate(params["layers"]):
            qkv = x @ layer["qkv_W"].to(dt) + layer["qkv_b"].to(dt)
            q, k, v = qkv.split(cfg.hidden_size, dim=-1)
            q = q.reshape(s, nh, hd)
            for cache_l, new in ((kc[li], k), (vc[li], v)):
                new = new.reshape(s, nh, hd).to(cache_l.dtype)
                cache_l[ar, :, wpos] = torch.where(inside, new,
                                                   cache_l[ar, :, wpos])
            ctx = self._decode_attn(q, kc[li], vc[li], cmask).to(dt)
            a = ctx.reshape(s, cfg.hidden_size) @ layer["proj_W"].to(dt) \
                + layer["proj_b"].to(dt)
            x = _layer_norm(x + a, layer["ln1_scale"], layer["ln1_bias"],
                            cfg.layer_norm_eps)
            f = _ffn(cfg, layer, x)
            x = _layer_norm(x + f, layer["ln2_scale"], layer["ln2_bias"],
                            cfg.layer_norm_eps)
        logits = bert_mlm_logits(cfg, params, x)
        return logits, cache

    def prefill(self, margs, cache, slot, prompt, plen):
        """Causal full forward over one length-bucketed prompt (P,); writes
        slot `slot`'s K/V block for rows 0..P-1 and returns (cache, the
        logits (V,) at the last REAL position plen - 1). Rows beyond plen
        hold padding garbage that the decode cache mask hides. `slot` and
        `plen` are ints or one-element int64 tensors on the cache's
        device."""
        (params,) = margs
        cfg = self.cfg
        p_len = prompt.shape[0]
        slot = torch.as_tensor(slot, device=prompt.device).reshape(1)
        plen = torch.as_tensor(plen, device=prompt.device).reshape(1)
        emb = params["embeddings"]
        x = emb["word"][prompt[None]] + emb["position"][None, :p_len]
        x = _layer_norm(x.to(cfg.compute_dtype), emb["ln_scale"],
                        emb["ln_bias"], cfg.layer_norm_eps)
        kc, vc = cache["k"], cache["v"]
        nh, hd = cfg.num_heads, cfg.head_dim
        dt = x.dtype
        for li, layer in enumerate(params["layers"]):
            qkv = x @ layer["qkv_W"].to(dt) + layer["qkv_b"].to(dt)
            q, k, v = qkv.split(cfg.hidden_size, dim=-1)

            def heads(t):
                return t.reshape(1, p_len, nh, hd).transpose(1, 2)

            q, k, v = heads(q), heads(k), heads(v)      # (1, nh, P, hd)
            kc[li, :, :, :p_len][slot] = k.to(kc.dtype)
            vc[li, :, :, :p_len][slot] = v.to(vc.dtype)
            ctx = self._prefill_attn(q, k, v)
            a = ctx.transpose(1, 2).reshape(1, p_len, cfg.hidden_size) \
                @ layer["proj_W"].to(dt) + layer["proj_b"].to(dt)
            x = _layer_norm(x + a, layer["ln1_scale"], layer["ln1_bias"],
                            cfg.layer_norm_eps)
            f = _ffn(cfg, layer, x)
            x = _layer_norm(x + f, layer["ln2_scale"], layer["ln2_bias"],
                            cfg.layer_norm_eps)
        h_last = x[0].index_select(0, plen - 1)[0]      # (H,)
        logits = bert_mlm_logits(cfg, params, h_last)
        return cache, logits
