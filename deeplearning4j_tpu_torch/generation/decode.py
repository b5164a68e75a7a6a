"""Decode-mode forwards: the port of
`deeplearning4j_tpu/generation/decode.py`'s `BertDecoder` and
`RecurrentDecoder`.

`BertDecoder` keeps per-layer K/V caches `(L, S, H, C, Dh)` (C = the
cache-length rung). `step` embeds each slot's current token at its
position, writes its K/V row, and attends the single query against the
cache through `flash_attention_decode` (the `flash_decode` kernel on the
card). `prefill` runs the causal full forward over a length-bucketed
prompt (the `flash_fwd` kernel on the card) and writes the slot's K/V
block. `verify` runs a draft block of d queries through the stack in one
call (greedy drafting's oracle). Where the JAX package donates the cache
through each dispatch, the port updates it in place and returns the same
dict. `step`, `verify`, `prefill`, `grow_into` and `page_copy` read no
device value on the host, index nothing by a boolean mask and allocate
nothing that outlives them, so `GenerationServer` captures them into CUDA
graphs; their slots, prompt lengths, page tables and page ids come as
device tensors for that.

int8 cache (`kv_dtype="int8"`): K/V rows are stored int8 with one f32
scale per (head, row) beside them (`ks`/`vs`, `quantize/kvcache.py`); the
scales fold into the decode contractions, an einsum on every device.

Paged mode (`page_size=ps, pool_pages=P`): the cache is a pool
`(L, P, H, ps, Dh)` (and `(L, P, H, ps)` scales under int8) shared by every
slot through a per-slot page index that the host allocator
(`generation/paging.py`) builds between dispatches: `ptab` (S, rung // ps)
for `step`/`verify`, the write-redirect row `wrow` (ceil(P_bucket / ps),)
for `prefill`. Page 0 is the null page: unmapped reads land there (hidden
by the cache mask) and redundant writes are redirected into it, so it holds
garbage by design. `grow` is the identity and `page_copy` the
copy-on-write primitive. Attention reads the view gathered from the pool
(`flash_attention_decode_paged`), which feeds the unchanged dense
arithmetic, so paged streams are bit-identical to slot-contiguous ones.

The full-sequence reference this must match (≤ 1e-5) is
`bert_encode(..., causal=True)` + `bert_mlm_logits` over the same prefix.

`RecurrentDecoder` serves a recurrent `MultiLayerNetwork` (the zoo's
TextGenerationLSTM): its decode state is the recurrent layers' carries,
(S, nOut) per layer, which `step` and `prefill` overwrite in place, so the
server captures them as it captures BertDecoder's.
"""
from __future__ import annotations

import hashlib

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.generation.paging import NULL_PAGE
from deeplearning4j_tpu_torch.kernels.flash_attention import (
    flash_attention, flash_attention_decode, flash_attention_decode_mq,
    flash_attention_decode_mq_paged, flash_attention_decode_paged)
from deeplearning4j_tpu_torch.models.bert import (_ffn, _layer_norm,
                                                  bert_mlm_logits)
from deeplearning4j_tpu_torch.parallel.ring_attention import dense_attention
from deeplearning4j_tpu_torch.quantize.kvcache import quantize_rows

__all__ = ["BertDecoder", "RecurrentDecoder"]

#: the value each cache entry starts at: scale rows at 1, so that rows
#: never written round-trip to zeros; every other entry at 0
_FILL = {"ks": 1.0, "vs": 1.0}


def _shape_tree_repr(tree):
    if isinstance(tree, dict):
        return repr({k: _shape_tree_repr(v) for k, v in sorted(tree.items())})
    if isinstance(tree, (list, tuple)):
        return repr([_shape_tree_repr(v) for v in tree])
    return repr((tuple(tree.shape), str(tree.dtype)))


def _put_rows(t, rows, new, keep=None):
    """Write `new` (N, H[, D]) at `t[rows[0], :, rows[1]]` of one layer's
    cache or pool `t`; where `keep` (N,) is False the old contents stay
    (a clamped out-of-range write: the JAX scatter drops those)."""
    i0, i1 = rows
    if keep is not None:
        keep = keep.reshape((-1,) + (1,) * (new.ndim - 1))
        new = torch.where(keep, new, t[i0, :, i1])
    t[i0, :, i1] = new


class BertDecoder:
    """KV-cache decode over a `models/bert.py` parameter dict. Runs on the
    device the parameters lie on."""

    #: the server's decoder protocol: the cache grows through length rungs,
    #: and `model_args()` is one tree (the parameters)
    uses_cache_rungs = True
    n_model_args = 1

    def __init__(self, cfg, params, attn_impl="auto", kv_dtype="fp",
                 page_size=None, pool_pages=None):
        if cfg.moe_layers:
            raise ValueError(
                "BertDecoder does not support MoE layers (dense-dispatch "
                "expert FFNs have no single-token decode path yet)")
        if attn_impl not in ("auto", "dense", "kernel"):
            raise ValueError(
                f"attn_impl must be 'auto', 'dense' or 'kernel', "
                f"got {attn_impl!r}")
        if kv_dtype not in ("fp", "int8"):
            raise ValueError(
                f"kv_dtype must be 'fp' or 'int8', got {kv_dtype!r}")
        if kv_dtype == "int8" and attn_impl == "kernel":
            raise ValueError(
                "attn_impl='kernel' has no int8-cache variant — the "
                "quantized decode runs the scale-folding einsum; use "
                "attn_impl='auto' or 'dense' with kv_dtype='int8'")
        self.cfg = cfg
        self.params = params
        self.attn_impl = attn_impl
        self.kv_dtype = kv_dtype
        self.device = params["embeddings"]["word"].device
        self.vocab_size = int(cfg.vocab_size)
        self.max_cache_len = int(cfg.max_position_embeddings)
        self.paged = page_size is not None
        if self.paged:
            self.page_size = int(page_size)
            if self.page_size < 1:
                raise ValueError(f"page_size must be >= 1, got {page_size}")
            if pool_pages is None:
                raise ValueError(
                    "paged mode needs an explicit pool_pages — the page "
                    "pool (not the rung) is the device memory budget; "
                    "slots * rung // page_size + 1 reproduces the "
                    "slot-contiguous footprint")
            self.pool_pages = int(pool_pages)
            if self.pool_pages < 2:
                raise ValueError(
                    f"pool_pages must be >= 2 (null page + 1), "
                    f"got {pool_pages}")
        else:
            if pool_pages is not None:
                raise ValueError("pool_pages requires page_size")
            self.page_size = self.pool_pages = None

    def fingerprint(self):
        parts = ("bert-decode", repr(self.cfg), self.attn_impl,
                 self.kv_dtype, self.page_size, self.pool_pages,
                 _shape_tree_repr(self.params), torch.__version__)
        return hashlib.sha256(repr(parts).encode()).hexdigest()[:16]

    def model_args(self):
        return (self.params,)

    @property
    def supports_draft(self):
        """Greedy drafting needs `verify`; the int8 codec has no multi-row
        quantized write path, so drafting is fp-cache only."""
        return self.kv_dtype == "fp"

    # -- the cache --------------------------------------------------------
    def init_cache(self, slots, cache_len):
        """The cache of `slots` slots at rung `cache_len`; paged, the pool
        (slot- and rung-independent: the rung only sets the width of the
        page table a dispatch reads through)."""
        cfg = self.cfg
        if self.paged:
            shape = (cfg.num_layers, self.pool_pages, cfg.num_heads,
                     self.page_size, cfg.head_dim)
        else:
            shape = (cfg.num_layers, slots, cfg.num_heads, cache_len,
                     cfg.head_dim)
        if self.kv_dtype == "int8":
            cache = {"k": torch.empty(shape, dtype=torch.int8,
                                      device=self.device),
                     "v": torch.empty(shape, dtype=torch.int8,
                                      device=self.device),
                     "ks": torch.empty(shape[:4], dtype=torch.float32,
                                       device=self.device),
                     "vs": torch.empty(shape[:4], dtype=torch.float32,
                                       device=self.device)}
        else:
            cache = {name: torch.empty(shape, dtype=cfg.compute_dtype,
                                       device=self.device)
                     for name in ("k", "v")}
        return self.reset_cache(cache)

    def reset_cache(self, cache):
        """Every entry back to its initial value, in place; returns it."""
        for name, t in cache.items():
            t.fill_(_FILL.get(name, 0))
        return cache

    def grow(self, cache, new_len):
        """The cache padded to the longer rung `new_len` (zero rows, scale
        rows 1); paged, the pool itself."""
        if self.paged:
            return cache
        big = {name: t.new_empty(t.shape[:3] + (int(new_len),)
                                 + t.shape[4:])
               for name, t in cache.items()}
        return self.grow_into(cache, big)

    def grow_into(self, cache, big):
        """Copy `cache` into the longer rung's cache `big` (rows beyond the
        shorter rung at their initial value), in place; returns `big`."""
        for name, t in cache.items():
            big[name].fill_(_FILL.get(name, 0))
            big[name][:, :, :, :t.shape[3]].copy_(t)
        return big

    def page_copy(self, cache, src, dst):
        """Copy physical page `src` over `dst` across every layer and pool
        entry, in place: the copy-on-write primitive, dispatched before the
        first block that writes into a shared page. `src`/`dst` are
        one-element integer tensors on the pool's device."""
        for t in cache.values():
            t.index_copy_(1, dst, t.index_select(1, src))
        return cache

    # -- pieces -----------------------------------------------------------
    def _embed(self, params, tokens, pos):
        """Token + position embedding at per-slot positions (mirrors
        bert_encode's embedding block; token_type unused in LM mode). A
        lane past the position table (a frozen lane, or a draft query
        beyond a request's end, whose output is never delivered) reads its
        last row: a torch index out of range faults where JAX clamps."""
        emb = params["embeddings"]
        pos = pos.clamp(max=self.max_cache_len - 1)
        x = emb["word"][tokens] + emb["position"][pos]
        return _layer_norm(x.to(self.cfg.compute_dtype), emb["ln_scale"],
                           emb["ln_bias"], self.cfg.layer_norm_eps)

    def _impl(self, q, quantized):
        if self.attn_impl != "auto":
            return self.attn_impl
        return "kernel" if q.is_cuda and not quantized else "dense"

    def _prefill_attn(self, q, k, v):
        if self.attn_impl == "kernel" or (
                self.attn_impl == "auto" and q.is_cuda):
            return flash_attention(q, k, v, causal=True)
        return dense_attention(q, k, v, causal=True)

    def _write_rows(self, pos, ptab, c):
        """Where the K/V rows at `pos` (S,) or (S, d) land: (index into the
        layer's first axis, row index, keep mask or None). Dense: the slot's
        row, clamped into the rung with a keep mask. Paged: page
        `ptab[s, pos // ps]` at offset `pos % ps`; a lane past the mapped
        view (pos >= C) is redirected to the null page."""
        s = pos.shape[0]
        ar = torch.arange(s, device=pos.device).reshape(
            (s,) + (1,) * (pos.ndim - 1)).expand_as(pos)
        if not self.paged:
            return ar, pos.clamp(max=c - 1), pos < c
        psz, maxp = self.page_size, ptab.shape[1]
        phys = ptab[ar, (pos // psz).clamp(max=maxp - 1)]
        return (torch.where(pos < c, phys, NULL_PAGE), pos % psz, None)

    def _write_kv(self, cache, li, where, k, v):
        """Write one layer's new rows (quantized first under int8)."""
        i0, i1, keep = where
        writes = [("k", k), ("v", v)]
        if self.kv_dtype == "int8":
            (kq, k_sc), (vq, v_sc) = quantize_rows(k), quantize_rows(v)
            writes = [("k", kq), ("v", vq), ("ks", k_sc), ("vs", v_sc)]
        for name, new in writes:
            t = cache[name][li]
            _put_rows(t, (i0, i1), new.to(t.dtype), keep)

    # -- the contract -----------------------------------------------------
    def step(self, margs, cache, tokens, pos, ptab=None):
        """One decode step for the whole batch: embed `tokens` (S,) at
        their slot positions `pos` (S,) (the number of already-cached
        tokens), write each slot's K/V row at `pos`, attend the single
        query over rows 0..pos, and return (next-token logits (S, V),
        cache). Paged mode takes `ptab` (S, rung // ps)."""
        (params,) = margs
        cfg = self.cfg
        x = self._embed(params, tokens, pos)            # (S, H)
        s = tokens.shape[0]
        nh, hd = cfg.num_heads, cfg.head_dim
        c = (ptab.shape[1] * self.page_size if self.paged
             else cache["k"].shape[3])
        where = self._write_rows(pos, ptab, c)
        # rows 0..pos are valid (the current write included)
        cmask = torch.arange(c, device=pos.device)[None, :] <= pos[:, None]
        quantized = self.kv_dtype == "int8"
        dt = x.dtype
        for li, layer in enumerate(params["layers"]):
            qkv = x @ layer["qkv_W"].to(dt) + layer["qkv_b"].to(dt)
            q, k, v = qkv.split(cfg.hidden_size, dim=-1)
            q = q.reshape(s, nh, hd)
            self._write_kv(cache, li, where, k.reshape(s, nh, hd),
                           v.reshape(s, nh, hd))
            ks = cache["ks"][li] if quantized else None
            vs = cache["vs"][li] if quantized else None
            impl = self._impl(q, quantized)
            if self.paged:
                ctx = flash_attention_decode_paged(
                    q, cache["k"][li], cache["v"][li], ptab, cmask,
                    impl=impl, k_scale_pool=ks, v_scale_pool=vs)
            else:
                ctx = flash_attention_decode(
                    q, cache["k"][li], cache["v"][li], cmask, impl=impl,
                    k_scale=ks, v_scale=vs)
            a = ctx.to(dt).reshape(s, cfg.hidden_size) \
                @ layer["proj_W"].to(dt) + layer["proj_b"].to(dt)
            x = _layer_norm(x + a, layer["ln1_scale"], layer["ln1_bias"],
                            cfg.layer_norm_eps)
            f = _ffn(cfg, layer, x)
            x = _layer_norm(x + f, layer["ln2_scale"], layer["ln2_bias"],
                            cfg.layer_norm_eps)
        logits = bert_mlm_logits(cfg, params, x)
        return logits, cache

    def verify(self, margs, cache, tokens, pos, draft, ptab=None):
        """Draft-block decode: for each slot, run the q-block
        `[tokens[s], draft[s, 0], ..., draft[s, d-2]]` at positions
        `pos[s] .. pos[s]+d-1` through the stack in ONE call — write all d
        K/V rows, attend query j over cache rows `0 .. pos[s]+j`, and
        return (logits (S, d, V), cache): `logits[s, j]` is the next-token
        distribution after consuming j draft tokens, the same arithmetic
        and masks as d sequential `step` calls. Rows written past the
        accepted prefix hold draft garbage beyond the slot's advanced
        position, hidden by the cache mask until overwritten. fp cache only
        (`supports_draft`)."""
        if not self.supports_draft:
            raise ValueError("verify needs an fp cache (kv_dtype='fp')")
        (params,) = margs
        cfg = self.cfg
        s = tokens.shape[0]
        d = 1 + draft.shape[1]
        tok_block = torch.cat([tokens[:, None], draft.to(tokens.dtype)],
                              dim=1)
        pos_block = pos[:, None] + torch.arange(d, device=pos.device)[None]
        x = self._embed(params, tok_block, pos_block)   # (S, d, H)
        nh, hd = cfg.num_heads, cfg.head_dim
        c = (ptab.shape[1] * self.page_size if self.paged
             else cache["k"].shape[3])
        i0, i1, keep = self._write_rows(pos_block, ptab, c)
        # query j sees rows 0..pos+j (its own write included)
        qmask = torch.arange(c, device=pos.device)[None, None, :] \
            <= pos_block[:, :, None]
        dt = x.dtype
        for li, layer in enumerate(params["layers"]):
            qkv = x @ layer["qkv_W"].to(dt) + layer["qkv_b"].to(dt)
            q, k, v = qkv.split(cfg.hidden_size, dim=-1)
            q = q.reshape(s, d, nh, hd).transpose(1, 2)     # (S, nh, d, hd)
            k = k.reshape(s, d, nh, hd)
            v = v.reshape(s, d, nh, hd)
            # one query's rows at a time: S distinct rows a write, and a
            # clamped out-of-range row reads back what the rows before it
            # wrote, so it keeps them (the JAX scatter drops it)
            for j in range(d):
                self._write_kv(cache, li,
                               (i0[:, j], i1[:, j],
                                None if keep is None else keep[:, j]),
                               k[:, j], v[:, j])
            if self.paged:
                ctx = flash_attention_decode_mq_paged(
                    q, cache["k"][li], cache["v"][li], ptab, qmask)
            else:
                ctx = flash_attention_decode_mq(
                    q, cache["k"][li], cache["v"][li], qmask)
            a = ctx.to(dt).transpose(1, 2).reshape(s, d, cfg.hidden_size) \
                @ layer["proj_W"].to(dt) + layer["proj_b"].to(dt)
            x = _layer_norm(x + a, layer["ln1_scale"], layer["ln1_bias"],
                            cfg.layer_norm_eps)
            f = _ffn(cfg, layer, x)
            x = _layer_norm(x + f, layer["ln2_scale"], layer["ln2_bias"],
                            cfg.layer_norm_eps)
        logits = bert_mlm_logits(cfg, params, x)        # (S, d, V)
        return logits, cache

    def _write_prompt_pages(self, pool, block, wrow):
        """Scatter one layer's prefill block into pool pages: `pool` is the
        layer's (P, nh, ps, ...) pool, `block` its (nh, P_bucket, ...)
        rows, `wrow[j]` the page logical page j writes into — the null page
        for pages whose bytes already exist (a shared-prefix hit) or that
        hold only bucket padding, so redundant writes land in page 0 (the
        only page one write may name twice)."""
        psz = self.page_size
        npp = wrow.shape[0]
        nh, p_len = block.shape[:2]
        if npp * psz > p_len:
            block = torch.cat([block, block.new_zeros(
                (nh, npp * psz - p_len) + block.shape[2:])], dim=1)
        pages = block.reshape((nh, npp, psz) + block.shape[2:]).transpose(
            0, 1)
        pool[wrow] = pages.to(pool.dtype)

    def prefill(self, margs, cache, slot, prompt, plen, wrow=None):
        """Causal full forward over one length-bucketed prompt (P,); writes
        slot `slot`'s K/V block for rows 0..P-1 (paged: through the
        write-redirect row `wrow`) and returns (cache, the logits (V,) at
        the last REAL position plen - 1). Rows beyond plen hold padding
        garbage that the decode cache mask hides. `slot` and `plen` are
        ints or one-element int64 tensors on the cache's device."""
        (params,) = margs
        cfg = self.cfg
        p_len = prompt.shape[0]
        slot = torch.as_tensor(slot, device=prompt.device).reshape(1)
        plen = torch.as_tensor(plen, device=prompt.device).reshape(1)
        emb = params["embeddings"]
        x = emb["word"][prompt[None]] + emb["position"][None, :p_len]
        x = _layer_norm(x.to(cfg.compute_dtype), emb["ln_scale"],
                        emb["ln_bias"], cfg.layer_norm_eps)
        nh, hd = cfg.num_heads, cfg.head_dim
        dt = x.dtype
        for li, layer in enumerate(params["layers"]):
            qkv = x @ layer["qkv_W"].to(dt) + layer["qkv_b"].to(dt)
            q, k, v = qkv.split(cfg.hidden_size, dim=-1)

            def heads(t):
                return t.reshape(1, p_len, nh, hd).transpose(1, 2)

            q, k, v = heads(q), heads(k), heads(v)      # (1, nh, P, hd)
            blocks = {"k": k, "v": v}
            if self.kv_dtype == "int8":
                (kq, k_sc), (vq, v_sc) = quantize_rows(k), quantize_rows(v)
                blocks = {"k": kq, "v": vq, "ks": k_sc, "vs": v_sc}
            for name, block in blocks.items():
                t = cache[name][li]
                if self.paged:
                    self._write_prompt_pages(t, block[0], wrow)
                else:
                    t[:, :, :p_len][slot] = block.to(t.dtype)
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


class RecurrentDecoder:
    """Carry-state decode over a recurrent `MultiLayerNetwork` (stacked
    LSTM / GravesLSTM / SimpleRnn layers and an RnnOutputLayer-style dense
    head, e.g. the zoo's TextGenerationLSTM). Tokens enter as one-hot
    feature vectors (the char-RNN convention: head nOut == input feature
    width == vocabulary). A decode step is the network's own carried-state
    forward (`_forward(carries=)`) over T = 1 under an all-ones mask, the
    same masked pass as the bucketed prefill and the masked full-sequence
    forward. Runs on the network's device."""

    uses_cache_rungs = False
    supports_draft = False
    n_model_args = 2      # model_args(): the parameters and the state

    def __init__(self, net):
        self.net = net
        layers = net.layers
        head = layers[-1]
        if not hasattr(head, "pre_activation"):
            raise ValueError(
                f"RecurrentDecoder needs a dense (RnnOutputLayer-style) "
                f"head with pre_activation; got {type(head).__name__}")
        rec = [l for l in layers[:-1] if getattr(l, "is_recurrent", False)]
        if not rec:
            raise ValueError(
                "RecurrentDecoder needs at least one recurrent layer")
        for l in rec:
            if not hasattr(l, "scan_apply"):
                raise ValueError(
                    f"{type(l).__name__} cannot run step-by-step "
                    "(no carried-state protocol)")
        it = getattr(net.conf, "input_type", None)
        if it is None or not hasattr(it, "size"):
            raise ValueError("net conf has no sized recurrent InputType")
        self.n_features = int(it.size)
        self.vocab_size = int(head.nOut)
        if self.vocab_size != self.n_features:
            raise ValueError(
                f"char-RNN generation feeds sampled tokens back as one-hot "
                f"inputs: head nOut ({self.vocab_size}) must equal the "
                f"input feature width ({self.n_features})")
        if net._params is None:
            raise ValueError("RecurrentDecoder needs an initialised network "
                             "(init() or multilayer_params_from_numpy)")
        self.device = net._device
        # the carries are O(1) in sequence length: the server keeps one
        # rung, which only bounds prompt_len + max_new_tokens
        self.max_cache_len = None

    def fingerprint(self):
        from deeplearning4j_tpu_torch.runtime.executables import \
            model_fingerprint
        return hashlib.sha256(
            ("recurrent-decode-" + model_fingerprint(self.net)).encode()
        ).hexdigest()[:16]

    def model_args(self):
        return (self.net._params, self.net._state)

    # -- the cache: the carries --------------------------------------------
    def init_cache(self, slots, cache_len):
        return {"carries": self.net._zero_carries(int(slots))}

    def reset_cache(self, cache):
        for carry in cache["carries"].values():
            for t in carry:
                t.zero_()
        return cache

    def grow(self, cache, new_len):
        return cache    # the carries do not depend on the length

    def _write(self, cache, carries, rows=None):
        """Write new carries into the cache's tensors, in place: every row,
        or the rows `rows` (a one-element index tensor)."""
        for key, carry in cache["carries"].items():
            for dst, src in zip(carry, carries[key]):
                if rows is None:
                    dst.copy_(src)
                else:
                    dst.index_copy_(0, rows, src.to(dst.dtype))

    # -- the contract -------------------------------------------------------
    def step(self, margs, cache, tokens, pos):
        """One decode step: the current tokens (S,) one-hot through a T = 1
        masked carried-state pass; returns (the head's pre-activation
        logits (S, V) in f32, the cache with the advanced carries)."""
        params, state = margs
        s = tokens.shape[0]
        x = F.one_hot(tokens, self.n_features).to(torch.float32)[:, None]
        _, preact, _, _, carries = self.net._forward(
            params, state, x, False,
            mask=torch.ones((s, 1), dtype=torch.float32,
                            device=tokens.device),
            carries=cache["carries"])
        self._write(cache, carries)
        return preact[:, 0].float(), cache

    def prefill(self, margs, cache, slot, prompt, plen):
        """The length-bucketed prompt (P,) through the full masked pass
        from zero carries (masked steps hold the carry), its final carries
        grafted into row `slot` of the cache; returns (the cache, the
        logits (V,) at the last real step plen - 1). `slot` and `plen` are
        ints or one-element int64 tensors on the cache's device."""
        params, state = margs
        p_len = prompt.shape[0]
        slot = torch.as_tensor(slot, device=prompt.device).reshape(1)
        plen = torch.as_tensor(plen, device=prompt.device).reshape(1)
        x = F.one_hot(prompt, self.n_features).to(torch.float32)[None]
        mask = (torch.arange(p_len, device=prompt.device)[None, :]
                < plen).to(torch.float32)
        _, preact, _, _, fresh = self.net._forward(
            params, state, x, False, mask=mask, carries={})
        self._write(cache, fresh, rows=slot)
        logits = preact[0].index_select(0, plen - 1)[0].float()
        return cache, logits
