"""Learner weights carried across from the JAX package.

`params_from_numpy(learner, tree, device=None, nu=None)` installs a JAX
learner's parameters on the port's learner of the same configuration,
before it trains:

- a DQN learner (`QLearningDiscreteDense`, `QLearningDiscreteConv`):
  `tree` is {"net": (params, state), "target": (params, state)}, the JAX
  Q-network's and target's `_params` / `_state`, installed through
  `nn.multilayer_params_from_numpy`;
- the A3C family (`A3CDiscreteDense`, `AsyncNStepQLearningDiscreteDense`,
  `A3CDiscreteConv`): `tree` is the JAX learner's `params`, {"body",
  "pi", "v"[, "conv"]} lists of {"w", "b"}, and `nu` (optional) the same
  tree of RMSprop's second moments (`opt_state[0].nu`); the optimizer
  starts afresh from them.

Every group, layer, key and shape is checked against the learner's own
tree. Entries may be numpy arrays or tensors; `device` defaults to where
the learner lives. `params_to_numpy` is the way back.
"""
from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.convert import (multilayer_params_from_numpy,
                                                 multilayer_params_to_numpy)
from deeplearning4j_tpu_torch.rl.a3c import _flat, rms_nu

__all__ = ["params_from_numpy", "params_to_numpy"]


def _a3c_tree(what, spec, tree, dev):
    """`tree` checked against `spec` (the learner's {group: [{"w", "b"}]})
    as float32 tensors on `dev`."""
    if not isinstance(tree, dict) or set(tree) != set(spec):
        raise ValueError(f"{what}: expected groups {sorted(spec)}, got "
                         f"{sorted(tree) if isinstance(tree, dict) else tree}")
    out = {}
    for g, layers in spec.items():
        got = list(tree[g])
        if len(got) != len(layers):
            raise ValueError(f"{what}.{g}: expected {len(layers)} layers, "
                             f"got {len(got)}")
        out[g] = []
        for i, (want, have) in enumerate(zip(layers, got)):
            if set(have) != set(want):
                raise ValueError(f"{what}.{g}[{i}]: expected keys "
                                 f"{sorted(want)}, got {sorted(have)}")
            lyr = {}
            for k, ref in want.items():
                a = have[k]
                a = a if torch.is_tensor(a) else torch.from_numpy(
                    np.array(a, np.float32))
                if tuple(a.shape) != tuple(ref.shape):
                    raise ValueError(f"{what}.{g}[{i}].{k}: expected shape "
                                     f"{tuple(ref.shape)}, got "
                                     f"{tuple(a.shape)}")
                lyr[k] = a.to(device=dev, dtype=torch.float32)
            out[g].append(lyr)
    return out


def params_from_numpy(learner, tree, device=None, nu=None):
    """Install the JAX learner's weights on `learner` (see the module
    docstring). Returns `learner`."""
    if hasattr(learner, "target"):                     # a DQN learner
        if nu is not None:
            raise ValueError("nu: a DQN learner's optimizer is the "
                             "network's Adam (not carried)")
        if not isinstance(tree, dict) or set(tree) != {"net", "target"}:
            raise ValueError("a DQN learner takes {'net': (params, state), "
                             "'target': (params, state)}")
        dev = device or learner.net._device
        for name in ("net", "target"):
            params, state = tree[name]
            multilayer_params_from_numpy(getattr(learner, name), params,
                                         state, dev)
        return learner
    dev = torch.device(device) if device is not None else learner.device
    params = _a3c_tree("params", learner.params, tree, dev)
    learner.params, learner.device = params, dev
    learner.opt_state = learner.tx.init(_flat(params))
    if nu is not None:
        flat = _flat(_a3c_tree("nu", learner.params, nu, dev))
        leaves = [flat[n][k] for n in sorted(flat) for k in sorted(flat[n])]
        for t, a in zip(rms_nu(learner.opt_state), leaves):
            t.copy_(a)
    return learner


def params_to_numpy(learner):
    """A DQN learner's {"net": (params, state), "target": (params,
    state)}, or an A3C learner's (params, ν) as numpy trees."""
    if hasattr(learner, "target"):
        return {name: multilayer_params_to_numpy(getattr(learner, name))
                for name in ("net", "target")}

    def host(t):
        return t.detach().float().cpu().numpy()

    params = {g: [{k: host(v) for k, v in lyr.items()} for lyr in layers]
              for g, layers in learner.params.items()}
    flat = _flat(learner.params)
    keys = [(n, k) for n in sorted(flat) for k in sorted(flat[n])]
    nu_flat = {}
    for (n, k), t in zip(keys, rms_nu(learner.opt_state)):
        nu_flat.setdefault(n, {})[k] = host(t)
    nu = {g: [nu_flat[f"{g}.{i}"] for i in range(len(layers))]
          for g, layers in learner.params.items()}
    return params, nu
