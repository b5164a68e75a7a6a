"""ZeRO-1 optimizer-state sharding over the data-parallel axis: the port
of `deeplearning4j_tpu/parallel/zero.py`.

Data parallelism replicates the updater state on every worker; for Adam
that is two f32 moments per parameter, the largest per-device memory cost
of dp training. ZeRO stage 1 (Rajbhandari et al. 2019, arXiv:1910.02054)
shards it over the dp axis instead.

Each state leaf keeps its largest dp-divisible axis sharded (`_leaf_spec`,
the JAX package's rule): this rank holds its 1/dp block of that axis, and
leaves with no such axis stay whole. The update (`zero_update`) runs on
this rank's block of every parameter and gradient (the blocks cut by the
same rule from the parameter's shape, so they line up with the state),
and the updated blocks are all-gathered back into whole parameters. The
slices are exact for the element-wise updaters (every updater of
`nn/updaters.py`); a per-leaf gradient norm (`clipl2perlayer`,
`renormalizel2perlayer`) needs the whole leaf and is refused.

Usage:
    pw = (ParallelWrapper.Builder(net).workers(8)
          .shardOptimizerState(True).build())
or directly, with a trainer's state:
    opt_state = shard_optimizer_state(opt_state, mesh, axis="dp")
"""
from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.parallel import mesh as _mesh
from deeplearning4j_tpu_torch.parallel.mesh import P
from deeplearning4j_tpu_torch.resilience.guardian import write_where

__all__ = ["shard_optimizer_state", "state_memory_bytes", "ZeroState",
           "zero_apply", "zero_update"]


def _leaf_spec(shape, n, axis):
    """P for one leaf: the largest dim whose size divides by `n` is
    sharded over `axis`; P() (whole) when no dim qualifies."""
    best = -1
    for d, s in enumerate(shape):
        if s % n == 0 and s >= n and (best < 0 or s > shape[best]):
            best = d
    if best < 0:
        return P()
    spec = [None] * len(shape)
    spec[best] = axis
    return P(*spec)


def _dim(shape, n, axis):
    spec = _leaf_spec(tuple(shape), n, axis)
    return next((d for d, a in enumerate(spec) if a is not None), None)


class ZeroState:
    """An optimizer state sharded over a dp axis: `state` holds this
    rank's blocks; `mesh` and `axis` say where the rest live."""

    #: read by the networks: their own step cannot update these blocks
    sharded_over_dp = True

    def __init__(self, state, mesh, axis):
        self.state, self.mesh, self.axis = state, mesh, axis

    @property
    def n(self):
        return self.mesh.shape[self.axis]

    @property
    def index(self):
        return self.mesh.index(self.axis)


def _map_tensors(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return fn(tree) if torch.is_tensor(tree) else tree


def _block(t, n, index, axis):
    d = _dim(t.shape, n, axis)
    if d is None or n == 1:
        return t
    size = t.shape[d] // n
    return t.narrow(d, index * size, size)


def shard_optimizer_state(opt_state, mesh, axis="dp"):
    """This rank's blocks of every tensor leaf of an optimizer state (each
    leaf's largest dp-divisible axis cut over `axis`; others whole), as a
    `ZeroState` the trainers update with `zero_update`. mesh: a
    DeviceMesh."""
    mesh = getattr(mesh, "mesh", mesh)
    if isinstance(opt_state, ZeroState):
        return opt_state
    n, index = mesh.shape[axis], mesh.index(axis)
    return ZeroState(_map_tensors(
        lambda t: _block(t, n, index, axis).clone(), opt_state), mesh, axis)


def state_memory_bytes(opt_state):
    """Bytes of the state's tensors held by THIS rank: with ZeRO sharding
    about 1/dp of the replicated size."""
    if isinstance(opt_state, ZeroState):
        opt_state = opt_state.state
    total = 0

    def add(t):
        nonlocal total
        total += t.numel() * t.element_size()
        return t

    _map_tensors(add, opt_state)
    return total


def _check_elementwise(tx):
    from deeplearning4j_tpu_torch.nn import updaters as U
    parts = []
    for t in getattr(tx, "transforms", {}).values():
        parts += list(getattr(t, "parts", [t]))
    for t in parts:
        if isinstance(t, (U._ClipL2PerLeaf, U._RenormL2PerLeaf)):
            raise ValueError(
                "ZeRO-1 updates each rank's block of a parameter; a per-leaf "
                "gradient norm needs the whole leaf — drop the gradient "
                "normalization or the state sharding")


def zero_update(tx, grads, zstate, params, lr_scale=None):
    """One optimizer step under ZeRO-1: `tx` (an `nn.updaters` Optimizer
    over {node: {key: tensor}}) updates this rank's blocks of `params`
    with the same blocks of `grads` and the sharded state, then the new
    blocks are all-gathered along their sharded dim. Returns (whole new
    parameters, new ZeroState); the gradients must already be the dp
    mean. `lr_scale` (a 0-d tensor or None) scales the updates, the
    guardian's reduce-LR rung."""
    from deeplearning4j_tpu_torch.nn.updaters import apply_updates
    _check_elementwise(tx)
    mesh, axis = zstate.mesh, zstate.axis
    n, index = zstate.n, zstate.index

    def cut(tree):
        return {nd: {k: _block(v, n, index, axis) for k, v in d.items()}
                for nd, d in tree.items()}

    pblk = cut(params)
    updates, state = tx.update(cut(grads), zstate.state, pblk)
    if lr_scale is not None:
        torch._foreach_mul_([u for d in updates.values() for u in d.values()],
                            lr_scale)
    new_blk = apply_updates(pblk, updates)
    group = mesh.group(axis)
    out = {}
    for nd, d in new_blk.items():
        out[nd] = {}
        for k, v in d.items():
            dim = _dim(params[nd][k].shape, n, axis)
            if dim is None or group is None or n == 1:
                out[nd][k] = v
            else:
                out[nd][k] = _mesh._all_gather(v, group, n, dim)
    return out, ZeroState(state, mesh, axis)


def zero_apply(tx, grads, opt_state, params, lr_scale=None, ok=None,
               constraints=None, extra=()):
    """`zero_update` written into the live tensors: the parameters, this
    rank's state blocks and each (new, old) pair of `extra`, where `ok`
    (a guarded step's verdict) holds, or everywhere when ok is None."""
    new_params, zs = zero_update(tx, grads, opt_state, params, lr_scale)
    if constraints is not None:
        new_params = constraints(new_params)
    write_where(ok, [(new_params, params), (zs.state, opt_state.state)]
                + list(extra))
