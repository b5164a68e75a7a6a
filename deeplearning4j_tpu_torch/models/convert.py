"""BERT parameters for the port: carried across from the JAX tree, or
made from a seed.

The layout is the JAX package's `init_bert_params` tree
(`deeplearning4j_tpu/models/bert.py:65`): a dict with "embeddings",
"layers" (a list), "pooler", "classifier" and "mlm_head", each a dict of
arrays. `param_shapes(cfg)` states it; both functions below check every
leaf's name and shape against it.
"""
from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve
from deeplearning4j_tpu_torch.models.bert import check_supported

__all__ = ["param_shapes", "params_from_numpy", "params_to_numpy",
           "named_param_leaves", "param_leaves", "init_bert_params"]

#: leaves initialised as N(0, 0.02²); the rest are LayerNorm scales (ones)
#: or biases (zeros), as in the JAX package
_RANDOM = {"word", "position", "token_type", "W", "qkv_W", "proj_W",
           "up_W", "down_W"}


def param_shapes(cfg):
    """The parameter tree of `cfg` with a shape tuple at every leaf."""
    check_supported(cfg)
    H, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    layer = {
        "qkv_W": (H, 3 * H), "qkv_b": (3 * H,),
        "proj_W": (H, H), "proj_b": (H,),
        "ln1_scale": (H,), "ln1_bias": (H,),
        "ln2_scale": (H,), "ln2_bias": (H,),
        "ffn": {"up_W": (H, I), "up_b": (I,),
                "down_W": (I, H), "down_b": (H,)},
    }
    return {
        "embeddings": {"word": (V, H),
                       "position": (cfg.max_position_embeddings, H),
                       "token_type": (cfg.type_vocab_size, H),
                       "ln_scale": (H,), "ln_bias": (H,)},
        "layers": [layer] * cfg.num_layers,
        "pooler": {"W": (H, H), "b": (H,)},
        "classifier": {"W": (H, cfg.num_labels), "b": (cfg.num_labels,)},
        "mlm_head": {"W": (H, H), "b": (H,), "ln_scale": (H,),
                     "ln_bias": (H,), "out_bias": (V,)},
    }


def _map(spec, tree, fn, path="params"):
    """Walk `spec` and `tree` together, checking names and list lengths,
    and apply fn(path, shape, leaf) at every leaf."""
    if isinstance(spec, dict):
        if not isinstance(tree, dict) or set(tree) != set(spec):
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"{path}: expected keys {sorted(spec)}, "
                             f"got {got}")
        return {k: _map(spec[k], tree[k], fn, f"{path}.{k}") for k in spec}
    if isinstance(spec, list):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(spec):
            raise ValueError(f"{path}: expected a list of {len(spec)} "
                             f"layers")
        return [_map(s, t, fn, f"{path}[{i}]")
                for i, (s, t) in enumerate(zip(spec, tree))]
    return fn(path, spec, tree)


def params_from_numpy(cfg, tree, device=None, dtype=torch.float32):
    """The JAX parameter tree, as numpy arrays, to the port's tensors on
    `device` (default: the card) in `dtype`. Every leaf's name and shape
    is checked against `param_shapes(cfg)`."""
    dev = resolve(device)

    def leaf(path, shape, a):
        a = np.asarray(a)
        if a.shape != shape:
            raise ValueError(f"{path}: expected shape {shape}, got "
                             f"{a.shape}")
        return torch.from_numpy(np.array(a, np.float32)).to(dev, dtype)

    return _map(param_shapes(cfg), tree, leaf)


def params_to_numpy(params):
    """The port's parameter dict as a tree of float32 numpy arrays."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to_numpy(v) for v in params]
    return params.detach().float().cpu().numpy()


def named_param_leaves(params, path="params"):
    """(path, leaf) for every leaf of a parameter tree in the JAX package's
    tree order (dict keys sorted, lists in order), as
    `jax.tree_util.tree_leaves` lists them."""
    if isinstance(params, dict):
        return [x for k in sorted(params)
                for x in named_param_leaves(params[k], f"{path}.{k}")]
    if isinstance(params, (list, tuple)):
        return [x for i, v in enumerate(params)
                for x in named_param_leaves(v, f"{path}[{i}]")]
    return [(path, params)]


def param_leaves(params):
    """The leaves of a parameter tree in the JAX package's tree order: what
    an optimizer takes, and what lines the port's gradients up with
    `jax.grad`'s tree."""
    return [leaf for _, leaf in named_param_leaves(params)]


def init_bert_params(cfg, seed=0, device=None, dtype=torch.float32):
    """Random BERT parameters made by a `torch.Generator` seeded with
    `seed`: N(0, 0.02²) weights and embeddings, unit LayerNorm scales,
    zero biases. Drawn on the CPU, so a seed gives the same weights on
    every device; then moved to `device` (default: the card)."""
    dev = resolve(device)
    gen = torch.Generator().manual_seed(int(seed))

    def leaf(path, shape, _):
        name = path.rsplit(".", 1)[-1]
        if name in _RANDOM:
            t = torch.randn(shape, generator=gen) * 0.02
        elif name.endswith("scale"):
            t = torch.ones(shape)
        else:
            t = torch.zeros(shape)
        return t.to(dev, dtype)

    spec = param_shapes(cfg)
    return _map(spec, spec, leaf)
