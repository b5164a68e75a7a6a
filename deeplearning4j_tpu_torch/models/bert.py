"""BERT-style transformer encoder, inference only: the port of
`deeplearning4j_tpu/models/bert.py`.

Parameters are a plain dict of tensors with the same leaf names and
shapes as the JAX parameter tree (`models/convert.py` carries one across).
Dropout is off (inference). Attention runs the flash kernel on the card
(`attn_impl="auto"` or `"flash"`) or the dense einsum (`"dense"`). MoE
layers and blockwise/custom attention wait for a later slice.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.kernels.flash_attention import flash_attention
from deeplearning4j_tpu_torch.parallel.ring_attention import dense_attention

__all__ = ["BertConfig", "bert_base", "bert_tiny", "bert_encode",
           "bert_pooled", "bert_classify", "bert_mlm_logits"]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    num_labels: int = 2           # fine-tune classifier head
    layer_norm_eps: float = 1e-12
    dtype: str = "float32"        # compute dtype ("bfloat16" for serving)
    moe_layers: tuple = ()        # rejected: MoE waits for a later slice

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


def check_supported(cfg):
    """Raise for what this slice of the port does not run yet."""
    if cfg.moe_layers:
        raise NotImplementedError(
            "MoE FFN layers (moe_layers) are not ported yet; they come "
            "with the expert-parallel slice")


def _layer_norm(x, scale, bias, eps):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def _attention(cfg, layer, x, attn_mask, attn_impl, causal=False):
    B, T, H = x.shape
    nh, hd = cfg.num_heads, cfg.head_dim
    dt = x.dtype
    qkv = x @ layer["qkv_W"].to(dt) + layer["qkv_b"].to(dt)
    q, k, v = qkv.split(H, dim=-1)

    def heads(t):
        return t.reshape(B, T, nh, hd).transpose(1, 2)

    q, k, v = heads(q), heads(k), heads(v)
    if attn_impl == "auto":
        attn_impl = "flash" if x.is_cuda else "dense"
    if attn_impl == "flash":
        ctx = flash_attention(q, k, v, causal=causal, mask=attn_mask)
    elif attn_impl == "dense":
        mask = None
        if attn_mask is not None:
            mask = attn_mask[:, None, None, :] > 0
        ctx = dense_attention(q, k, v, causal=causal, mask=mask)
    elif attn_impl == "blockwise" or callable(attn_impl):
        raise NotImplementedError(
            f"attn_impl {attn_impl!r} is not ported yet; blockwise and "
            "custom attention come with the parallel/ slice — use "
            "'auto', 'flash' or 'dense'")
    else:
        raise ValueError(f"unknown attn_impl {attn_impl!r}; expected "
                         "'auto', 'dense' or 'flash'")
    ctx = ctx.transpose(1, 2).reshape(B, T, H)
    return ctx @ layer["proj_W"].to(dt) + layer["proj_b"].to(dt)


def _ffn(cfg, layer, x):
    dt = x.dtype
    f = layer["ffn"]
    h = _gelu(x @ f["up_W"].to(dt) + f["up_b"].to(dt))
    return h @ f["down_W"].to(dt) + f["down_b"].to(dt)


def _encoder_layer(cfg, layer, x, attn_mask, attn_impl, causal=False):
    # generation/decode.py BertDecoder mirrors this block's arithmetic
    # against its K/V cache
    a = _attention(cfg, layer, x, attn_mask, attn_impl, causal)
    x = _layer_norm(x + a, layer["ln1_scale"], layer["ln1_bias"],
                    cfg.layer_norm_eps)
    f = _ffn(cfg, layer, x)
    return _layer_norm(x + f, layer["ln2_scale"], layer["ln2_bias"],
                       cfg.layer_norm_eps)


def bert_encode(cfg, params, input_ids, token_type_ids=None, attn_mask=None,
                attn_impl="auto", causal=False):
    """(B, T) int ids -> (B, T, H) hidden states, on the ids' device.

    `causal=True` masks attention to past-and-present positions only —
    the full-sequence reference for the KV-cache decode path."""
    check_supported(cfg)
    dt = cfg.compute_dtype
    T = input_ids.shape[1]
    emb = params["embeddings"]
    x = emb["word"][input_ids] + emb["position"][None, :T, :]
    if token_type_ids is not None:
        x = x + emb["token_type"][token_type_ids]
    x = _layer_norm(x.to(dt), emb["ln_scale"], emb["ln_bias"],
                    cfg.layer_norm_eps)
    for layer in params["layers"]:
        x = _encoder_layer(cfg, layer, x, attn_mask, attn_impl, causal)
    return x


def bert_pooled(cfg, params, hidden):
    cls = hidden[:, 0, :]
    return torch.tanh(cls @ params["pooler"]["W"].to(cls.dtype)
                      + params["pooler"]["b"].to(cls.dtype))


def bert_classify(cfg, params, input_ids, token_type_ids=None,
                  attn_mask=None, attn_impl="auto"):
    """Fine-tune head: (B, T) -> (B, num_labels) f32 logits."""
    hidden = bert_encode(cfg, params, input_ids, token_type_ids, attn_mask,
                         attn_impl)
    pooled = bert_pooled(cfg, params, hidden)
    c = params["classifier"]
    return (pooled @ c["W"].to(pooled.dtype)
            + c["b"].to(pooled.dtype)).float()


def bert_mlm_logits(cfg, params, hidden):
    """Masked-LM head with tied word embeddings: (..., H) -> (..., V) f32."""
    m = params["mlm_head"]
    dt = hidden.dtype
    h = _gelu(hidden @ m["W"].to(dt) + m["b"].to(dt))
    h = _layer_norm(h, m["ln_scale"], m["ln_bias"], 1e-12)
    logits = h @ params["embeddings"]["word"].T.to(dt) + m["out_bias"].to(dt)
    return logits.float()


def bert_base(**overrides):
    return BertConfig(**overrides)


def bert_tiny(**overrides):
    """Test-sized config."""
    d = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
             intermediate_size=64, max_position_embeddings=64,
             type_vocab_size=2, num_labels=3)
    d.update(overrides)
    return BertConfig(**d)
