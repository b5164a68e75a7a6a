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
together with dropout off.

Layers listed in `cfg.moe_layers` run a top-1 switch mixture-of-experts
FFN (dense one-hot dispatch, as the JAX package's). `attn_impl` also takes
"blockwise" (the online-softmax loop of `parallel/ring_attention.py`) or a
callable attn_impl(q, k, v[, mask]) such as a `shard_map` of the ring or
Ulysses attention; a callable must declare the mask explicitly to run a
padded batch. `sharding_rules` gives the tensor-, data- and
expert-parallel spec of every parameter (`parallel/mesh.py`'s
NamedSharding).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from deeplearning4j_tpu_torch.kernels.flash_attention import flash_attention
# defined beside the other tree conversions; importable here, as in the
# JAX package
from deeplearning4j_tpu_torch.models.convert import init_bert_params
from deeplearning4j_tpu_torch.parallel.moe import switch_router
from deeplearning4j_tpu_torch.parallel.ring_attention import (
    blockwise_attention, dense_attention)
from deeplearning4j_tpu_torch.util.introspect import explicit_mask_param

__all__ = ["BertConfig", "bert_base", "bert_tiny", "bert_encode",
           "bert_pooled", "bert_classify", "bert_mlm_logits",
           "classification_loss", "init_bert_params", "sharding_rules"]


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
    # MoE (expert parallel): layers listed here use a mixture-of-experts FFN
    moe_layers: tuple = ()
    num_experts: int = 8

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


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
    if causal and callable(attn_impl):
        raise ValueError(
            "causal attention is only wired through the built-in "
            "'dense'/'flash' impls; custom attn_impl callables do not "
            "declare a causal parameter")
    if causal and attn_impl == "blockwise":
        raise ValueError("'blockwise' attn_impl has no causal path; "
                         "use flash or dense for causal encoding")
    if callable(attn_impl):
        ctx = _custom_attention(attn_impl, q, k, v, attn_mask)
    elif attn_impl == "flash":
        ctx = flash_attention(q, k, v, causal=causal, mask=attn_mask)
    elif attn_impl == "blockwise":
        if attn_mask is not None:
            raise ValueError("'blockwise' attn_impl has no padding-mask "
                             "path; use flash or dense for masked batches")
        ctx = blockwise_attention(q, k, v, block_size=max(128, T // 4))
    elif attn_impl == "dense":
        mask = None
        if attn_mask is not None:
            mask = attn_mask[:, None, None, :] > 0
        ctx = dense_attention(q, k, v, causal=causal, mask=mask)
    else:
        raise ValueError(f"unknown attn_impl {attn_impl!r}; expected "
                         "'dense', 'blockwise', 'flash', or a callable")
    ctx = ctx.transpose(1, 2).reshape(B, T, H)
    out = ctx @ layer["proj_W"].to(dt) + layer["proj_b"].to(dt)
    return _dropout(out, cfg.dropout, train, generator)


def _custom_attention(attn_impl, q, k, v, attn_mask):
    """A callable attn_impl. A padded batch must never silently attend to
    padding: the impl has to DECLARE the mask, as a 4th positional slot
    or an explicit 'mask'/'attn_mask'/'kv_mask' parameter, and gets it by
    that convention. Bare *args/**kwargs catch-alls and signatures that
    cannot be read are refused."""
    if attn_mask is None:
        return attn_impl(q, k, v)
    conv = explicit_mask_param(attn_impl, positional_slot=4)
    if conv is None:
        raise ValueError(
            "attn_impl callable does not explicitly declare a mask "
            "parameter (bare *args/**kwargs or a non-introspectable "
            "signature does not count) but the batch carries "
            "attention_mask — use a masked impl (flash/dense) or an "
            "attn_impl(q, k, v, mask)")
    if conv[0] == "positional":
        return attn_impl(q, k, v, attn_mask)
    return attn_impl(q, k, v, **{conv[1]: attn_mask})


def _ffn(cfg, layer, x, train=False, generator=None):
    dt = x.dtype
    f = layer["ffn"]
    h = _gelu(x @ f["up_W"].to(dt) + f["up_b"].to(dt))
    out = h @ f["down_W"].to(dt) + f["down_b"].to(dt)
    return _dropout(out, cfg.dropout, train, generator)


def _moe_ffn(cfg, layer, x, train=False, generator=None):
    """Top-1 switch MoE with a dense one-hot dispatch: every expert's FFN
    runs on all tokens and the one-hot of `parallel.moe.switch_router`
    picks each token's expert, scaled by its gate."""
    dt = x.dtype
    m = layer["moe"]
    onehot, gate, _ = switch_router(x, m["router_W"], cfg.num_experts)
    up = (torch.einsum("bth,ehi->beti", x, m["up_W"].to(dt))
          + m["up_b"].to(dt)[None, :, None, :])
    down = (torch.einsum("beti,eih->beth", _gelu(up), m["down_W"].to(dt))
            + m["down_b"].to(dt)[None, :, None, :])
    out = torch.einsum("beth,bte->bth", down, onehot) * gate[..., None]
    return _dropout(out, cfg.dropout, train, generator)


def _encoder_layer(cfg, layer, x, attn_mask, attn_impl, causal=False,
                   train=False, generator=None):
    # generation/decode.py BertDecoder mirrors this block's arithmetic
    # against its K/V cache
    a = _attention(cfg, layer, x, attn_mask, attn_impl, causal, train,
                   generator)
    x = _layer_norm(x + a, layer["ln1_scale"], layer["ln1_bias"],
                    cfg.layer_norm_eps)
    if "moe" in layer:
        f = _moe_ffn(cfg, layer, x, train, generator)
    else:
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


def sharding_rules(cfg, mesh, dp="dp", tp="tp", ep=None):
    """The spec of every parameter, as a tree matching the parameters
    (`parallel.mesh.NamedSharding` leaves), the JAX package's rules:
    column-parallel (last dim over tp) for QKV and the FFN's up
    projection, row-parallel (first dim over tp) for the output
    projection and the FFN's down projection, the word embeddings' vocab
    dim over tp, an MoE layer's expert dim over ep (default tp), the rest
    replicated. `parallel.ShardedTrainer` stores each shard as its spec
    says. `dp` is accepted for the reference's signature."""
    from deeplearning4j_tpu_torch.parallel.mesh import NamedSharding, P

    def ns(*spec):
        return NamedSharding(mesh, P(*spec))

    rep = ns()
    rules = {
        "embeddings": {"word": ns(tp, None), "position": rep,
                       "token_type": rep, "ln_scale": rep, "ln_bias": rep},
        "pooler": {"W": rep, "b": rep},
        "classifier": {"W": rep, "b": rep},
        "mlm_head": {"W": rep, "b": rep, "ln_scale": rep, "ln_bias": rep,
                     "out_bias": rep},
        "layers": [],
    }
    for li in range(cfg.num_layers):
        layer = {
            "qkv_W": ns(None, tp), "qkv_b": ns(tp),
            "proj_W": ns(tp, None), "proj_b": rep,
            "ln1_scale": rep, "ln1_bias": rep,
            "ln2_scale": rep, "ln2_bias": rep,
        }
        if li in cfg.moe_layers:
            e = ep or tp
            layer["moe"] = {"router_W": rep,
                            "up_W": ns(e, None, None),
                            "up_b": ns(e, None),
                            "down_W": ns(e, None, None),
                            "down_b": ns(e, None)}
        else:
            layer["ffn"] = {"up_W": ns(None, tp), "up_b": ns(tp),
                            "down_W": ns(tp, None), "down_b": rep}
        rules["layers"].append(layer)
    return rules


def bert_base(**overrides):
    return BertConfig(**overrides)


def bert_tiny(**overrides):
    """Test-sized config."""
    d = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
             intermediate_size=64, max_position_embeddings=64,
             type_vocab_size=2, num_labels=3)
    d.update(overrides)
    return BertConfig(**d)
