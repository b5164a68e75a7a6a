"""Device mesh and collectives over `torch.distributed`: the port of
`deeplearning4j_tpu/parallel/mesh.py`.

The JAX package runs one SPMD program over a `jax.sharding.Mesh` in one
process. The port runs one rank per device in a process group (NCCL on
CUDA, gloo on the CPU), and each rank holds its own shard. Without a
process group the world is one rank and every collective is the identity.

Axis-name conventions, as in the JAX package:
  dp — data parallel        tp — tensor (model) parallel
  pp — pipeline parallel    sp — sequence/context parallel
  ep — expert parallel

`DeviceMesh(dp=2, sp=2)` lays the group's ranks out row-major over the
named axes and makes one subgroup per axis line. Inside `shard_map` (or
`with mesh:`) the axis collectives run on the calling rank's subgroup of
the named axis: `axis_index`, `axis_size`, `psum`, `ppermute` (one ring
hop), tiled `all_to_all` and tiled `all_gather`. Each is differentiable
with the transpose the JAX package's differentiation gives it: psum's
adjoint is a psum, ppermute's the reverse hop, all_to_all's the inverse
all_to_all, all_gather's a reduce-scatter.

`shard_map(f, mesh, in_specs, out_specs)` takes inputs that every rank of
the mapped axes holds alike; each rank slices its own shard, calls `f`,
and gathers the output by `out_specs`. The work around the call is
replicated, so every rank holds the whole cotangent of a gathered output:
its adjoint is a slice, and the adjoint of an input slice an all-gather.
An output replicated over a mapped axis (`P()`) hands each rank 1/n of
its cotangent and an input replicated over it sums the ranks' cotangents
(a psum), as JAX's shard_map transposes them: a psum inside `f` followed
by a replicated output passes the cotangent through unchanged.

Transport: a gloo group moves CUDA tensors through host copies (gloo has
no CUDA point-to-point or all-to-all); a NCCL group moves them on the
device. The group's backend decides this.
"""
from __future__ import annotations

import os
import threading

import numpy as np
import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

__all__ = ["P", "PartitionSpec", "NamedSharding", "DeviceMesh",
           "initialize_distributed", "shard_map", "axis_index", "axis_size",
           "psum", "ppermute", "all_to_all", "all_gather",
           "current_mesh"]


class P(tuple):
    """A partition spec: one entry per dimension, an axis name or None
    (that dimension is whole on every rank). `P()` is replicated."""

    def __new__(cls, *spec):
        return super().__new__(cls, spec)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


PartitionSpec = P


class NamedSharding:
    """A (mesh, spec) pair: where a tensor's shards live."""

    def __init__(self, mesh, spec):
        self.mesh, self.spec = mesh, P(*spec)

    def __repr__(self):
        return f"NamedSharding({self.mesh.shape}, {self.spec!r})"


def _world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _backend(group):
    return dist.get_backend(group) if group is not None else None


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, **kw):
    """Bring up the default process group (≡ the JAX package's
    `initialize_distributed`). Delegates to the HARDENED bootstrap in
    `parallel/multihost.py` (`initialize`): the address, world size and
    rank from the arguments, else `DL4J_COORDINATOR` /
    `DL4J_NUM_PROCESSES` / `DL4J_PROCESS_ID`, else torchrun's
    `MASTER_ADDR`/`MASTER_PORT`/`WORLD_SIZE`/`RANK`; connect
    retry/backoff under a deadline and a post-init barrier; failures
    raise the typed `DistributedInitError`, never hang. With none of them
    configured it does nothing (a world of one) and returns False.
    `backend` defaults to NCCL when CUDA is available, else gloo;
    `timeout_s` and `device` as `multihost.initialize` takes them."""
    from deeplearning4j_tpu_torch.parallel.multihost import initialize
    return initialize(coordinator_address, num_processes, process_id, **kw)


class DeviceMesh:
    """Named axes over the process group's ranks (≡ the JAX package's
    `DeviceMesh`): `DeviceMesh(dp=2, tp=2, sp=2)` needs 8 ranks; an axis
    set to -1 absorbs the ranks the others leave. `devices` (optional)
    lists the group ranks to lay out, default all of them. Every rank of
    the group must build the same meshes in the same order (each builds
    one subgroup per axis line). A mesh that asks for more ranks than the
    group has raises ValueError. `device` is where this rank's tensors
    live: by default the card (cuda:LOCAL_RANK under NCCL), or the CPU
    when CUDA is absent."""

    def __init__(self, devices=None, device=None, **axes):
        world, rank = _world()
        ranks = list(range(world)) if devices is None else [
            int(getattr(d, "index", d)) for d in devices]
        if not axes:
            axes = {"dp": len(ranks)}
        names = list(axes.keys())
        sizes = [int(v) for v in axes.values()]
        if -1 in sizes:
            known = int(np.prod([s for s in sizes if s != -1]))
            sizes[sizes.index(-1)] = max(1, len(ranks) // known)
        total = int(np.prod(sizes))
        if total > len(ranks):
            raise ValueError(
                f"mesh {dict(zip(names, sizes))} needs {total} ranks, the "
                f"process group has {len(ranks)}: start one process per "
                f"device, e.g. torchrun --nproc_per_node={total}")
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, sizes))
        self.ranks = np.array(ranks[:total]).reshape(sizes)
        self.rank = rank
        where = np.argwhere(self.ranks == rank)
        self.coords = (dict(zip(names, (int(c) for c in where[0])))
                       if len(where) else None)
        self.groups, self.group_ranks = {}, {}
        if dist.is_available() and dist.is_initialized():
            for ai, name in enumerate(names):
                lines = np.moveaxis(self.ranks, ai, -1).reshape(-1, sizes[ai])
                for line in lines:
                    line = [int(r) for r in line]
                    g = dist.new_group(line)
                    if rank in line:
                        self.groups[name] = g
                        self.group_ranks[name] = line
        self.device = _default_device(device)

    # -- the reference's surface -----------------------------------------
    def __enter__(self):
        _push(self)
        return self

    def __exit__(self, *a):
        _pop()
        return False

    @property
    def mesh(self):
        """The mesh itself (the JAX package's DeviceMesh wraps a
        jax.sharding.Mesh under this name)."""
        return self

    @property
    def devices(self):
        """The rank layout, as `jax.sharding.Mesh.devices`."""
        return self.ranks

    def sharding(self, *spec):
        """NamedSharding from axis names; None entries replicate."""
        return NamedSharding(self, P(*spec))

    def replicated(self):
        return NamedSharding(self, P())

    def shard_batch(self, tree, axis="dp"):
        """This rank's rows (dim 0 split over `axis`) of every array of a
        global batch, as tensors on the rank's device."""
        return _tree_map(lambda a: _local_slice(
            _as_tensor(a, self.device), 0, self.index(axis),
            self.shape.get(axis, 1)), tree)

    def replicate(self, tree):
        """Every array of `tree` as a tensor on this rank's device."""
        return _tree_map(lambda a: _as_tensor(a, self.device), tree)

    @property
    def size(self):
        return int(np.prod(list(self.shape.values())))

    def axis_size(self, name):
        return self.shape[name]

    # -- the port's helpers ----------------------------------------------
    def index(self, name):
        """This rank's coordinate on axis `name` (0 outside the mesh)."""
        if self.coords is None:
            return 0
        return self.coords[name]

    def group(self, name):
        """This rank's subgroup along axis `name` (None without a process
        group)."""
        return self.groups.get(name)

    def backend(self, name):
        return _backend(self.groups.get(name))

    def __repr__(self):
        return f"DeviceMesh({self.shape}, rank={self.rank})"


def _default_device(device):
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        return torch.device("cpu")
    if dist.is_available() and dist.is_initialized() \
            and dist.get_backend() == "nccl":
        local = int(os.environ.get("LOCAL_RANK",
                                   dist.get_rank() % torch.cuda.device_count()))
        return torch.device("cuda", local)
    return torch.device("cuda", torch.cuda.current_device())


def _as_tensor(a, device):
    if torch.is_tensor(a):
        return a.to(device)
    return torch.as_tensor(np.asarray(a), device=device)


def _tree_map(fn, *trees):
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)) and not isinstance(t, P):
        out = [_tree_map(fn, *xs) for xs in zip(*trees)]
        return type(t)(out) if isinstance(t, tuple) else out
    if t is None:
        return None
    return fn(*trees)


def _local_slice(x, dim, index, n):
    if n == 1:
        return x
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"dimension {dim} of size {size} does not split "
                         f"over {n} ranks")
    return x.narrow(dim, index * (size // n), size // n)


# -- the current mesh (set by shard_map and `with mesh:`) ---------------------
_local = threading.local()


def _push(mesh):
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    stack.append(mesh)


def _pop():
    _local.stack.pop()


def current_mesh():
    stack = getattr(_local, "stack", None)
    if not stack:
        raise RuntimeError("no mesh: call axis collectives inside shard_map "
                           "or a `with mesh:` block")
    return stack[-1]


def _axis(axis_name):
    mesh = current_mesh()
    if axis_name not in mesh.shape:
        raise ValueError(f"axis {axis_name!r} is not an axis of {mesh}")
    return mesh, mesh.group(axis_name), mesh.shape[axis_name]


# -- raw transport -------------------------------------------------------------
def _staged(t, group):
    """(what to hand the backend, whether it is a host copy)."""
    if t.is_cuda and _backend(group) == "gloo":
        return t.detach().contiguous().cpu(), True
    return t.detach().contiguous(), False


def _all_reduce(t, group, fresh=False):
    """The sum of `t` over `group`. A `fresh` tensor (no one else holds
    it) is reduced in place; any other is copied first."""
    buf, host = _staged(t, group)
    if not host and not fresh:
        buf = buf.clone()
    dist.all_reduce(buf, group=group)
    return buf.to(t.device) if host else buf


def all_reduce_tree(tensors, loss, group):
    """(tensors, loss) summed over `group`: one all-reduce of one flat
    buffer per dtype, the loss (as f32) riding in the f32 buffer, or in
    one of its own when no tensor is f32. Returns the sums in the order
    given and the loss as an f32 scalar."""
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    out = list(tensors)
    lossw = loss.reshape(1).to(torch.float32)
    for dt, idx in by_dtype.items():
        ts = [tensors[i] for i in idx]
        if dt == torch.float32:
            ts.append(lossw)
        # one tensor flattens to a view of itself: not fresh
        buf = _all_reduce(_flatten_dense_tensors(ts), group,
                          fresh=len(ts) > 1)
        parts = _unflatten_dense_tensors(buf, ts)
        for i, g in zip(idx, parts):
            out[i] = g
        if dt == torch.float32:
            lossw = parts[-1]
    if torch.float32 not in by_dtype:
        lossw = _all_reduce(lossw, group)
    return out, lossw.reshape(())


def _all_gather(t, group, n, dim):
    buf, host = _staged(t, group)
    parts = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(parts, buf, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(t.device) if host else out


def _ppermute(t, group, ranks, shift):
    """One ring hop: this rank's `t` goes to the rank `shift` places on,
    and the rank `shift` places back's arrives."""
    n = len(ranks)
    if n == 1 or shift % n == 0:
        return t
    me = ranks.index(dist.get_rank())
    buf, host = _staged(t, group)
    out = torch.empty_like(buf)
    ops = [dist.P2POp(dist.isend, buf, ranks[(me + shift) % n], group),
           dist.P2POp(dist.irecv, out, ranks[(me - shift) % n], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out.to(t.device) if host else out


def _all_to_all(t, group, ranks, split_dim, concat_dim):
    """Tiled all-to-all: chunk j of `split_dim` goes to rank j, and the
    chunks received are concatenated along `concat_dim` in rank order."""
    n = len(ranks)
    if n == 1:
        return t
    if t.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dimension {split_dim} of size "
                         f"{t.shape[split_dim]} does not split over {n} "
                         "ranks")
    buf, host = _staged(t, group)
    chunks = [c.contiguous() for c in buf.chunk(n, dim=split_dim)]
    recv = [torch.empty_like(c) for c in chunks]
    me = ranks.index(dist.get_rank())
    if _backend(group) == "gloo":
        recv[me] = chunks[me]
        ops = []
        for j in range(n):
            if j != me:
                ops.append(dist.P2POp(dist.isend, chunks[j], ranks[j], group))
                ops.append(dist.P2POp(dist.irecv, recv[j], ranks[j], group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    else:
        dist.all_to_all(recv, chunks, group=group)
    out = torch.cat(recv, dim=concat_dim)
    return out.to(t.device) if host else out


# -- differentiable axis collectives ------------------------------------------
class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, ranks, shift):
        ctx.args = (group, ranks, shift)
        return _ppermute(x, group, ranks, shift)

    @staticmethod
    def backward(ctx, g):
        group, ranks, shift = ctx.args
        return _ppermute(g, group, ranks, -shift), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, ranks, split_dim, concat_dim):
        ctx.args = (group, ranks, split_dim, concat_dim)
        return _all_to_all(x, group, ranks, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, ranks, split_dim, concat_dim = ctx.args
        return (_all_to_all(g, group, ranks, concat_dim, split_dim),
                None, None, None, None)


class _AllGather(torch.autograd.Function):
    """Tiled all-gather; its adjoint is the reduce-scatter (a psum, then
    this rank's block)."""

    @staticmethod
    def forward(ctx, x, group, n, index, dim):
        ctx.args = (group, n, index, dim)
        return _all_gather(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        group, n, index, dim = ctx.args
        return (_local_slice(_all_reduce(g, group), dim, index, n),
                None, None, None, None)


class _GatherOut(torch.autograd.Function):
    """A shard_map output gathered over an axis: every rank holds the
    whole cotangent, so the adjoint is this rank's slice."""

    @staticmethod
    def forward(ctx, x, group, n, index, dim):
        ctx.args = (n, index, dim)
        return _all_gather(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        n, index, dim = ctx.args
        return _local_slice(g, dim, index, n).contiguous(), None, None, \
            None, None


class _SliceIn(torch.autograd.Function):
    """A shard_map input sliced over an axis: the adjoint gathers the
    ranks' cotangent slices into the whole one."""

    @staticmethod
    def forward(ctx, x, group, n, index, dim):
        ctx.args = (group, n, dim)
        return _local_slice(x, dim, index, n)

    @staticmethod
    def backward(ctx, g):
        group, n, dim = ctx.args
        return _all_gather(g.contiguous(), group, n, dim), None, None, \
            None, None


class _ScaleOut(torch.autograd.Function):
    """A shard_map output replicated over mapped axes: the identity, with
    1/n of the cotangent to each rank (JAX's shard_map transpose)."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def _grad_on(t):
    return torch.is_tensor(t) and t.requires_grad and torch.is_grad_enabled()


def axis_index(axis_name):
    """This rank's coordinate on the mapped axis `axis_name`."""
    mesh, _, _ = _axis(axis_name)
    return mesh.index(axis_name)


def axis_size(axis_name):
    _, _, n = _axis(axis_name)
    return n


def psum(x, axis_name):
    """Sum over the axis (a Python number: times the axis size)."""
    mesh, group, n = _axis(axis_name)
    if not torch.is_tensor(x):
        return x * n
    if group is None:
        return x
    return _PSum.apply(x, group)


def ppermute(x, axis_name, shift=1):
    """One ring hop along the axis: rank i's `x` arrives at rank
    i + shift (mod n). (The JAX package passes the permutation
    [(j, (j + 1) % n)]; the port takes its shift.)"""
    mesh, group, n = _axis(axis_name)
    if group is None or n == 1:
        return x
    return _PPermute.apply(x, group, mesh.group_ranks[axis_name], shift)


def all_to_all(x, axis_name, split_axis, concat_axis, tiled=True):
    """Tiled all-to-all along the axis (`lax.all_to_all(..., tiled=True)`):
    chunk j of `split_axis` goes to rank j; the received chunks concatenate
    along `concat_axis`."""
    if not tiled:
        raise ValueError("the port's all_to_all is the tiled one")
    mesh, group, n = _axis(axis_name)
    if group is None or n == 1:
        return x
    return _AllToAll.apply(x, group, mesh.group_ranks[axis_name],
                           split_axis, concat_axis)


def all_gather(x, axis_name, axis=0, tiled=True):
    """Tiled all-gather along the axis, concatenated on dim `axis`."""
    if not tiled:
        raise ValueError("the port's all_gather is the tiled one")
    mesh, group, n = _axis(axis_name)
    if group is None or n == 1:
        return x
    return _AllGather.apply(x, group, n, mesh.index(axis_name), axis)


# -- shard_map -----------------------------------------------------------------
def _spec_axes(spec):
    return {a for a in spec if a is not None}


def _specs_of(specs, tree):
    """The spec of every leaf of `tree`: one P for all, or a tree of P."""
    if isinstance(specs, P):
        return _tree_map(lambda _: specs, tree)
    return specs


def _all_axes(in_specs, out_specs):
    axes = set()

    def visit(s):
        if isinstance(s, P):
            axes.update(_spec_axes(s))
        elif isinstance(s, dict):
            for v in s.values():
                visit(v)
        elif isinstance(s, (list, tuple)):
            for v in s:
                visit(v)

    visit(in_specs)
    visit(out_specs)
    return axes


def _slice_in(mesh, x, spec, axes):
    if not torch.is_tensor(x):
        return x
    for dim, name in enumerate(spec):
        if name is None:
            continue
        if isinstance(name, (tuple, list)):
            raise ValueError("the port's partition specs name one axis per "
                             f"dimension, got {name!r}")
        n = mesh.shape[name]
        group = mesh.group(name)
        if group is None or n == 1:
            continue
        if _grad_on(x):
            x = _SliceIn.apply(x, group, n, mesh.index(name), dim)
        else:
            x = _local_slice(x, dim, mesh.index(name), n)
    for name in sorted(axes - _spec_axes(spec)):
        group = mesh.group(name)
        if group is not None and mesh.shape[name] > 1 and _grad_on(x):
            # replicated over a mapped axis: the ranks' cotangents sum
            x = _IdentityPSum.apply(x, group)
    return x


class _IdentityPSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def _gather_out(mesh, y, spec, axes):
    if not torch.is_tensor(y):
        return y
    for dim, name in enumerate(spec):
        if name is None:
            continue
        n = mesh.shape[name]
        group = mesh.group(name)
        if group is None or n == 1:
            continue
        if _grad_on(y):
            y = _GatherOut.apply(y.contiguous(), group, n, mesh.index(name),
                                 dim)
        else:
            y = _all_gather(y, group, n, dim)
    rep = 1
    for name in axes - _spec_axes(spec):
        if mesh.group(name) is not None:
            rep *= mesh.shape[name]
    if rep > 1 and _grad_on(y):
        y = _ScaleOut.apply(y, rep)
    return y


def shard_map(f, mesh=None, in_specs=None, out_specs=None, check_vma=None,
              **kw):
    """`f` over the mesh (≡ `jax.shard_map`): each rank slices its shard
    of every input by `in_specs`, runs `f` with the mesh current (so the
    axis collectives find their groups), and gathers the outputs by
    `out_specs`. Specs are a P for every leaf of an argument or a tree of
    P matching it; the mapped axes are those the specs name. `check_vma`
    is accepted for the reference's signature."""
    if mesh is None:
        raise ValueError("shard_map needs a mesh")
    mesh = getattr(mesh, "mesh", mesh)

    import functools
    import inspect

    @functools.wraps(f)
    def call(*args, **kwargs):
        if kwargs:
            # callers that introspect `f` (the models' mask guards) call
            # by keyword: rebind to f's positional order, as the JAX
            # package's shard_map wrapper does
            ba = inspect.signature(f).bind(*args, **kwargs)
            ba.apply_defaults()
            if ba.kwargs:
                raise TypeError(
                    f"shard_map cannot pass keyword-only args "
                    f"{sorted(ba.kwargs)} positionally to "
                    f"{getattr(f, '__name__', f)!r}")
            args = ba.args
        ins = in_specs if isinstance(in_specs, (tuple, list)) \
            and not isinstance(in_specs, P) else (in_specs,)
        if len(ins) != len(args):
            raise TypeError(f"shard_map: {len(args)} arguments, "
                            f"{len(ins)} in_specs")
        axes = _all_axes(in_specs, out_specs)
        local = [_tree_map(lambda x, s: _slice_in(mesh, x, s, axes), a,
                           _specs_of(s, a))
                 for a, s in zip(args, ins)]
        with mesh:
            out = f(*local)
        return _tree_map(lambda y, s: _gather_out(mesh, y, s, axes), out,
                         _specs_of(out_specs, out))

    return call
