"""BERT-style transformer encoder and its fine-tune loss: the port of
`deeplearning4j_tpu/models/bert.py`.

Parameters are a plain dict of tensors with the same leaf names and
shapes as the JAX parameter tree (`models/convert.py` carries one across).
Attention runs the flash kernels on the card (`attn_impl="auto"` or
`"flash"`; differentiable through the dQ and dK/dV kernels) or the dense
einsum (`"dense"`). `classification_loss` is the fine-tune objective;
`cfg.remat` recomputes each encoder layer in the backward pass.

Dropout runs when `train` is true, `cfg.dropout` > 0 and a
`torch.Generator` is given (on the activations' device), as the JAX
package runs it only with an rng key. Its masks come from torch's
generator, not from JAX's threefry, so with dropout on the two packages
draw different masks from the same seed; the parity tests hold them
together with dropout off. MoE layers and blockwise/custom attention wait
for a later slice.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from deeplearning4j_tpu_torch.kernels.flash_attention import flash_attention
from deeplearning4j_tpu_torch.parallel.ring_attention import dense_attention

__all__ = ["BertConfig", "bert_base", "bert_tiny", "bert_encode",
           "bert_pooled", "bert_classify", "bert_mlm_logits",
           "classification_loss"]


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
    dropout: float = 0.1
    layer_norm_eps: float = 1e-12
    dtype: str = "float32"        # compute dtype ("bfloat16" for serving)
    remat: bool = False           # recompute each layer in the backward
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


def _dropout(x, rate, train, generator):
    if not train or rate <= 0.0 or generator is None:
        return x
    keep = torch.rand(x.shape, generator=generator,
                      device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def _attention(cfg, layer, x, attn_mask, attn_impl, causal=False,
               train=False, generator=None):
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
    out = ctx @ layer["proj_W"].to(dt) + layer["proj_b"].to(dt)
    return _dropout(out, cfg.dropout, train, generator)


def _ffn(cfg, layer, x, train=False, generator=None):
    dt = x.dtype
    f = layer["ffn"]
    h = _gelu(x @ f["up_W"].to(dt) + f["up_b"].to(dt))
    out = h @ f["down_W"].to(dt) + f["down_b"].to(dt)
    return _dropout(out, cfg.dropout, train, generator)


def _encoder_layer(cfg, layer, x, attn_mask, attn_impl, causal=False,
                   train=False, generator=None):
    # generation/decode.py BertDecoder mirrors this block's arithmetic
    # against its K/V cache
    a = _attention(cfg, layer, x, attn_mask, attn_impl, causal, train,
                   generator)
    x = _layer_norm(x + a, layer["ln1_scale"], layer["ln1_bias"],
                    cfg.layer_norm_eps)
    f = _ffn(cfg, layer, x, train, generator)
    return _layer_norm(x + f, layer["ln2_scale"], layer["ln2_bias"],
                       cfg.layer_norm_eps)


def _remat_layer(cfg, layer, x, attn_mask, attn_impl, causal, train,
                 generator):
    """`_encoder_layer` under `torch.utils.checkpoint` (the counterpart of
    `jax.checkpoint` per layer): only the layer's input is kept, and the
    backward runs the layer again. Its dropout draws from a generator
    reset to the layer's starting state on every run, so the recomputed
    masks are the forward's; `generator` then moves on past the layer."""
    if generator is None:
        return checkpoint(_encoder_layer, cfg, layer, x, attn_mask,
                          attn_impl, causal, train, None,
                          use_reentrant=False)
    start = generator.get_state()
    end = []

    def run(x):
        g = torch.Generator(device=generator.device)
        g.set_state(start)
        y = _encoder_layer(cfg, layer, x, attn_mask, attn_impl, causal,
                           train, g)
        end.append(g.get_state())
        return y

    y = checkpoint(run, x, use_reentrant=False)
    generator.set_state(end[0])
    return y


def bert_encode(cfg, params, input_ids, token_type_ids=None, attn_mask=None,
                train=False, generator=None, attn_impl="auto", causal=False):
    """(B, T) int ids -> (B, T, H) hidden states, on the ids' device.

    `train` with a `generator` applies dropout (see the module docstring).
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
    x = _dropout(x, cfg.dropout, train, generator)
    block = _remat_layer if cfg.remat else _encoder_layer
    for layer in params["layers"]:
        x = block(cfg, layer, x, attn_mask, attn_impl, causal, train,
                  generator)
    return x


def bert_pooled(cfg, params, hidden):
    cls = hidden[:, 0, :]
    return torch.tanh(cls @ params["pooler"]["W"].to(cls.dtype)
                      + params["pooler"]["b"].to(cls.dtype))


def bert_classify(cfg, params, input_ids, token_type_ids=None,
                  attn_mask=None, train=False, generator=None,
                  attn_impl="auto"):
    """Fine-tune head: (B, T) -> (B, num_labels) f32 logits."""
    hidden = bert_encode(cfg, params, input_ids, token_type_ids, attn_mask,
                         train, generator, attn_impl)
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


def classification_loss(cfg, params, batch, train=True, generator=None,
                        attn_impl="auto"):
    """Mean cross-entropy of `bert_classify` over a batch dict with
    "input_ids", "labels" and optionally "token_type_ids" and
    "attention_mask"; a 0-d f32 tensor."""
    logits = bert_classify(cfg, params, batch["input_ids"],
                           batch.get("token_type_ids"),
                           batch.get("attention_mask"), train, generator,
                           attn_impl)
    logp = F.log_softmax(logits, dim=-1)
    onehot = F.one_hot(batch["labels"].long(), cfg.num_labels).to(logp.dtype)
    return -(onehot * logp).sum(dim=-1).mean()


def bert_base(**overrides):
    return BertConfig(**overrides)


def bert_tiny(**overrides):
    """Test-sized config."""
    d = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
             intermediate_size=64, max_position_embeddings=64,
             type_vocab_size=2, num_labels=3)
    d.update(overrides)
    return BertConfig(**d)
