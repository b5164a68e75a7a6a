"""Network parameters carried across from the JAX package.

`graph_params_from_numpy` takes a JAX `ComputationGraph`'s `_params` and
`_state` as numpy dicts (node → {"W", "b", "gamma", "beta"} and
{"mean", "var"}), checks every node, key and shape against what the
port's own `init` draws for the same configuration, and installs them on
the port's graph; `graph_params_to_numpy` is the way back.
`multilayer_params_from_numpy` / `multilayer_params_to_numpy` do the same
for a `MultiLayerNetwork`, whose trees are keyed "0".."n-1" as the JAX
`_params` / `_state` are. A layer whose JAX parameters nest one level
deeper (Bidirectional's {"fwd": {...}, "bwd": {...}}) carries across
into the port's flat names ("fwd_W", "bwd_W", ...); the `_to_numpy`
direction gives the flat names, and `jax_tree` / `jax_path` nest them
again as the JAX package does (what `util/model_serializer.py` writes).
Every other layer keeps the JAX package's names and layouts (HWIO and
DHWIO kernels, the unshared kernels of the locally connected layers, the
VAE's heads, the capsule W, PReLU's alpha), so its parameters carry
across as they are. Entries may be numpy arrays or tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve

__all__ = ["graph_params_from_numpy", "graph_params_to_numpy",
           "jax_path", "jax_tree", "multilayer_params_from_numpy",
           "multilayer_params_to_numpy"]


def _shapes(tree):
    return {n: {k: tuple(v.shape) for k, v in d.items()}
            for n, d in tree.items()}


def _flat(d):
    """{name: array}, with a nested {sub: {name: array}} as "sub_name"."""
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update({f"{k}_{n}": a for n, a in _flat(v).items()})
        else:
            out[k] = v
    return out


def _convert(what, spec, tree, dev):
    if set(tree) != set(spec):
        raise ValueError(f"{what}: expected nodes {sorted(spec)}, got "
                         f"{sorted(tree)}")
    out = {}
    for node, keys in spec.items():
        got = _flat(tree[node])
        if set(got) != set(keys):
            raise ValueError(f"{what}.{node}: expected keys {sorted(keys)}, "
                             f"got {sorted(got)}")
        out[node] = {}
        for k, shape in keys.items():
            a = got[k]
            if not torch.is_tensor(a):
                a = torch.from_numpy(np.array(a, np.float32))
            if tuple(a.shape) != shape:
                raise ValueError(f"{what}.{node}.{k}: expected shape "
                                 f"{shape}, got {tuple(a.shape)}")
            out[node][k] = a.to(device=dev, dtype=torch.float32)
    return out


def _install(net, params, state, device):
    """Check `params`/`state` against the port's own draw for `net` (or its
    live trees) and install them on `device`."""
    dev = resolve(device)
    spec_p, spec_s = ((net._draw() if net._params is None
                       else (net._params, net._state)))
    net._params = _convert("params", _shapes(spec_p), params, dev)
    net._state = _convert("state", _shapes(spec_s), state, dev)
    net._device = dev
    return net


def graph_params_from_numpy(net, params, state, device=None):
    """Install the JAX graph's parameters and state (numpy trees) on the
    port's `net`, on `device` (default: the card). Every node, key and
    shape is checked against the port's own initialisation of the same
    configuration. Takes the fusion decision as `init` does, so an
    uninitialised graph is ready to run afterwards. Returns `net`."""
    if net._params is None:
        net._decide_fusion()
    return _install(net, params, state, device)


def graph_params_to_numpy(net):
    """(params, state) of the port's graph (or MultiLayerNetwork) as
    float32 numpy trees."""
    def tree(t):
        return {n: {k: v.detach().float().cpu().numpy()
                    for k, v in d.items()} for n, d in t.items()}
    return tree(net._params), tree(net._state)


def multilayer_params_from_numpy(net, params, state, device=None):
    """Install the JAX MultiLayerNetwork's parameters and state (numpy
    trees keyed "0".."n-1") on the port's `net`, on `device` (default: the
    card). Every layer key, name and shape is checked against the port's
    own initialisation of the same configuration. Returns `net`."""
    return _install(net, params, state, device)


multilayer_params_to_numpy = graph_params_to_numpy


def jax_path(layer, name):
    """The JAX package's path of the port's parameter `name` within its
    layer: ("fwd", "W") for Bidirectional's "fwd_W", else (name,)."""
    head, _, rest = name.partition("_")
    if rest and head in getattr(layer, "param_groups", ()):
        return (head, rest)
    return (name,)


def jax_tree(net, tree):
    """A tree {key: {name: value}} of `net` (parameters, state or one
    parameter-shaped tree of the optimizer) nested as the JAX package
    nests it."""
    layers = dict(net._layer_items())
    out = {}
    for n, d in tree.items():
        node = out[n] = {}
        for k, v in d.items():
            *heads, last = jax_path(layers.get(n), k)
            for h in heads:
                node = node.setdefault(h, {})
            node[last] = v
            node = out[n]
    return out
