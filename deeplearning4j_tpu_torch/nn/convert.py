"""ComputationGraph parameters carried across from the JAX package.

`graph_params_from_numpy` takes a JAX `ComputationGraph`'s `_params` and
`_state` as numpy dicts (node → {"W", "b", "gamma", "beta"} and
{"mean", "var"}), checks every node, key and shape against what the
port's own `init` draws for the same configuration, and installs them on
the port's graph; `graph_params_to_numpy` is the way back.
"""
from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve

__all__ = ["graph_params_from_numpy", "graph_params_to_numpy"]


def _shapes(tree):
    return {n: {k: tuple(v.shape) for k, v in d.items()}
            for n, d in tree.items()}


def _convert(what, spec, tree, dev):
    if set(tree) != set(spec):
        raise ValueError(f"{what}: expected nodes {sorted(spec)}, got "
                         f"{sorted(tree)}")
    out = {}
    for node, keys in spec.items():
        got = tree[node]
        if set(got) != set(keys):
            raise ValueError(f"{what}.{node}: expected keys {sorted(keys)}, "
                             f"got {sorted(got)}")
        out[node] = {}
        for k, shape in keys.items():
            a = np.asarray(got[k])
            if a.shape != shape:
                raise ValueError(f"{what}.{node}.{k}: expected shape "
                                 f"{shape}, got {a.shape}")
            out[node][k] = torch.from_numpy(np.array(a, np.float32)).to(dev)
    return out


def graph_params_from_numpy(net, params, state, device=None):
    """Install the JAX graph's parameters and state (numpy trees) on the
    port's `net`, on `device` (default: the card). Every node, key and
    shape is checked against the port's own initialisation of the same
    configuration. Takes the fusion decision as `init` does, so an
    uninitialised graph is ready to run afterwards. Returns `net`."""
    dev = resolve(device)
    if net._params is None:
        spec_p, spec_s = net._draw()
        net._decide_fusion()
    else:
        spec_p, spec_s = net._params, net._state
    net._params = _convert("params", _shapes(spec_p), params, dev)
    net._state = _convert("state", _shapes(spec_s), state, dev)
    net._device = dev
    return net


def graph_params_to_numpy(net):
    """(params, state) of the port's graph as float32 numpy trees."""
    def tree(t):
        return {n: {k: v.detach().float().cpu().numpy()
                    for k, v in d.items()} for n, d in t.items()}
    return tree(net._params), tree(net._state)
