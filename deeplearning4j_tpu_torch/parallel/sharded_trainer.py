"""ShardedTrainer and ParameterAveragingTrainer (≡ dl4j-spark's
SharedTrainingMaster and ParameterAveragingTrainingMaster): the port of
`deeplearning4j_tpu/parallel/sharded_trainer.py`.

- ShardedTrainer: synchronous data parallelism over the mesh's dp axis,
  every step: each rank runs `loss_fn` on its rows of the batch, the
  gradients are averaged over dp (one all-reduce of one flat buffer), and
  every rank applies the same update. A parameter with a spec that names
  mesh axes (e.g. `models.bert.sharding_rules`' tp) is stored as this
  rank's shard and all-gathered inside the step, so the loss and the
  kernels see plain tensors; the gather's adjoint is a reduce-scatter,
  which sums the identical cotangents of the ranks that share the batch
  rows, so the step divides by their count. An optimizer state made by
  `zero.shard_optimizer_state` updates this rank's blocks (ZeRO-1).
- ParameterAveragingTrainer: the reference's semantics: each dp rank
  takes local steps with NO gradient sync, and the parameters are
  averaged over dp every `averaging_frequency` iterations.

loss_fn(params, batch, generator) -> 0-d tensor, where `generator` is a
torch.Generator for dropout or None.
"""
from __future__ import annotations

import torch

from deeplearning4j_tpu_torch import monitoring as _mon
from deeplearning4j_tpu_torch.monitoring import profiler as _prof
from deeplearning4j_tpu_torch.nn.accum import accumulate
from deeplearning4j_tpu_torch.nn.updaters import (Optimizer, Updater,
                                                  _Transform, apply_updates,
                                                  build_optimizer)
from deeplearning4j_tpu_torch.parallel import coordination as _dist
from deeplearning4j_tpu_torch.parallel import mesh as _mesh
from deeplearning4j_tpu_torch.parallel.mesh import NamedSharding, P
from deeplearning4j_tpu_torch.parallel.zero import ZeroState, zero_apply
from deeplearning4j_tpu_torch.resilience import faults as _faults
from deeplearning4j_tpu_torch.resilience import guardian as _guardian
from deeplearning4j_tpu_torch.resilience import watchdog as _watchdog

__all__ = ["accumulate_grads", "ShardedTrainer", "ParameterAveragingTrainer"]

_NODE = "params"


def _as_tx(updater):
    """An optimizer over {node: {key: tensor}} from an updater config, a
    transform (`compression.encoded_updater`) or an optimizer."""
    if isinstance(updater, Updater):
        return build_optimizer(updater)
    if isinstance(updater, Optimizer):
        return updater
    if isinstance(updater, _Transform):
        return Optimizer({"__global__": updater})
    raise TypeError(f"updater {updater!r} is not an Updater config, a "
                    "transform or an optimizer")


def _paths(tree, path=""):
    """[(path, leaf)] of a tree of dicts and lists, dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _paths(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return [x for i, v in enumerate(tree)
                for x in _paths(v, f"{path}/{i}")]
    return [(path, tree)]


def _rebuild(template, values, path=""):
    if isinstance(template, dict):
        return {k: _rebuild(v, values, f"{path}/{k}")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        out = [_rebuild(v, values, f"{path}/{i}")
               for i, v in enumerate(template)]
        return type(template)(out) if isinstance(template, tuple) else out
    return values[path]


def _flat(tree):
    """{_NODE: {path: leaf}}: the two-level tree the optimizers take."""
    return {_NODE: dict(_paths(tree))}


def _opt_specs(tx, params, specs, state):
    """A P at every leaf of an updater state: a list parallel to a label
    group's parameters (entry i a tensor of parameter i's shape: the
    moments) takes the parameters' specs, every other leaf (the counts)
    is whole."""
    flat = _flat(params)
    groups = tx._groups(flat) if isinstance(tx, Optimizer) else {}

    def walk(s, keys):
        if isinstance(s, dict):
            return {k: walk(v, keys) for k, v in s.items()}
        if isinstance(s, list) and keys and len(s) == len(keys) and all(
                torch.is_tensor(t)
                and tuple(t.shape) == tuple(flat[n][k].shape)
                for t, (n, k) in zip(s, keys)):
            return [specs.get(k, P()) for _, k in keys]
        if isinstance(s, (list, tuple)):
            out = [walk(v, keys) for v in s]
            return type(s)(out) if isinstance(s, tuple) else out
        return None if s is None else P()

    if isinstance(state, dict):
        return {lab: walk(v, groups.get(lab, []))
                for lab, v in state.items()}
    return walk(state, [])


def accumulate_grads(loss_fn, params, batch, generator, n_micro):
    """(mean gradients, mean loss, ok) of `loss_fn` over `n_micro`
    microbatches (batch leaves carry a leading (G, ...) axis), through
    `nn.accum.accumulate`, the core both network classes step through:
    gradients and loss summed in microbatch order on the device, one
    update after. `ok` is the finiteness of the mean loss (a NaN in any
    microbatch poisons it). n_micro == 1 is the plain step. Gradients are
    {path: tensor} of `params`' leaves."""
    leaves = dict(_paths(params))

    def grad_fn(state, mb):
        live = {p: v.detach().requires_grad_() for p, v in leaves.items()}
        loss = loss_fn(_rebuild(params, live), mb, generator)
        grads = torch.autograd.grad(loss, list(live.values()),
                                    allow_unused=True)
        tree = {p: torch.zeros_like(v) if g is None else g
                for (p, v), g in zip(live.items(), grads)}
        return loss.detach(), {_NODE: tree}, state

    if n_micro <= 1:
        loss, grads, _ = grad_fn(None, batch)
        return grads[_NODE], loss, torch.isfinite(loss)
    micro = [_mesh._tree_map(lambda a, i=i: a[i], batch)
             for i in range(n_micro)]
    grads, loss, _ = accumulate(grad_fn, None, micro)
    return grads[_NODE], loss, torch.isfinite(loss)


def _spec_of(s):
    if s is None:
        return P()
    return s.spec if isinstance(s, NamedSharding) else P(*s)


class ShardedTrainer:
    """Synchronous data-parallel trainer over an explicit mesh.

    loss_fn(params, batch, generator) -> scalar; the batch's dim 0 is
    split over `batch_axis` (`shard_batch`); params are sharded per
    `param_specs` (whole where a spec is None or P()).

    accumulation=G > 1 makes each `fit_batch` ONE optimizer step over a
    super-batch whose leaves carry a leading microbatch axis (G, B, ...):
    G backward passes summed on the device, a single update. The dp split
    is then the SECOND axis; `shard_batch` handles it."""

    def __init__(self, loss_fn, updater, mesh, param_specs=None,
                 batch_axis="dp", donate=True, accumulation=1):
        self.loss_fn = loss_fn
        self.tx = _as_tx(updater)
        self.mesh = getattr(mesh, "mesh", mesh)
        self.param_specs = param_specs
        self.batch_axis = batch_axis
        self._donate = donate
        self.accumulation = int(accumulation)
        if self.accumulation < 1:
            raise ValueError("accumulation must be >= 1")
        self._specs = None    # {path: P} of the parameters
        if self.accumulation > 1 and _mon.enabled():
            _mon.get_registry().gauge(
                _mon.DIST_ACCUM_MICROBATCHES,
                help="microbatches accumulated per optimizer step") \
                .set(self.accumulation)

    # -- placement -------------------------------------------------------
    def _path_specs(self, params):
        """{path: P} of every parameter: one P for all, or a tree of specs
        (P or NamedSharding) matching the parameters; whole by default."""
        specs = self.param_specs
        if specs is None or isinstance(specs, P):
            return {p: specs or P() for p, _ in _paths(params)}
        by_path = dict(_paths(_mesh._tree_map(_spec_of, specs)))
        return {p: by_path.get(p) or P() for p, _ in _paths(params)}

    def shard_params(self, params):
        """This rank's shard of every parameter (whole where its spec
        names no axis), as a tensor on the mesh's device."""
        self._specs = self._path_specs(params)
        mesh = self.mesh

        def put(path, a):
            t = _mesh._as_tensor(a, mesh.device)
            for dim, name in enumerate(self._specs[path]):
                if name is not None:
                    t = _mesh._local_slice(t, dim, mesh.index(name),
                                           mesh.shape[name])
            return t.detach().clone()

        values = {p: put(p, a) for p, a in _paths(params)}
        return _rebuild(params, values)

    def shard_batch(self, batch, owned=False):
        """This rank's rows of one global batch (dim 0, or dim 1 for an
        accumulation super-batch), as tensors on the mesh's device.
        `owned` is accepted for the reference's signature: the rows are
        always copied out of the caller's arrays."""
        dim = 1 if self.accumulation > 1 else 0
        mesh, axis = self.mesh, self.batch_axis
        n = mesh.shape.get(axis, 1)

        def put(a):
            _mon.record_transfer(getattr(a, "nbytes", 0))
            t = _mesh._as_tensor(a, mesh.device)
            return _mesh._local_slice(t, dim, mesh.index(axis), n).clone()

        return _mesh._tree_map(put, batch)

    def prefetch_batches(self, batches, depth=2):
        """An iterator whose background worker pulls `batches` and cuts
        this rank's rows of batch N+1 while the caller's step N runs:

            for staged in trainer.prefetch_batches(loader, depth=2):
                params, opt_state, loss = trainer.fit_batch(
                    params, opt_state, staged, generator)

        Call .close() (or exhaust it) to stop the worker."""
        from deeplearning4j_tpu_torch.runtime.pipeline import \
            PrefetchIterator
        return PrefetchIterator(
            batches, depth=depth,
            stage=lambda b: self.shard_batch(b, owned=True))

    def init(self, params):
        params = self.shard_params(params)
        return params, self.tx.init(_flat(params))

    def state_specs(self, params, opt_state):
        """{"params", "opt_state"} shaped like the training state with a P
        at every leaf: how each leaf is laid out over the mesh, which a
        checkpoint gathers it by and a restore slices it by. Each
        parameter's spec, the same on its optimizer moments, P() on the
        counts. A ZeRO-1 state is refused: its blocks follow their own
        rule and are not checkpointed."""
        if isinstance(opt_state, ZeroState):
            raise ValueError(
                "a ZeRO-1 optimizer state (zero.shard_optimizer_state) "
                "cannot be checkpointed: its blocks are not gathered")
        specs = self._specs or self._path_specs(params)
        return {"params": _rebuild(params, {p: specs.get(p, P())
                                            for p, _ in _paths(params)}),
                "opt_state": _opt_specs(self.tx, params, specs, opt_state)}

    # -- the step --------------------------------------------------------
    def _gathered_loss(self, local, batch, generator):
        """loss_fn on whole parameters: each sharded one all-gathered from
        the ranks' shards (differentiable: the adjoint is a
        reduce-scatter)."""
        mesh = self.mesh
        values = {}
        for path, t in _paths(local):
            for dim, name in enumerate(self._specs.get(path, P())):
                group = mesh.group(name) if name is not None else None
                if group is not None and mesh.shape[name] > 1:
                    t = _mesh._AllGather.apply(t, group, mesh.shape[name],
                                               mesh.index(name), dim)
            values[path] = t
        return self.loss_fn(_rebuild(local, values), batch, generator)

    def _sync(self, grads, loss):
        """The dp mean of the gradients (and of the loss), one all-reduce
        of one flat buffer per dtype."""
        mesh, axis = self.mesh, self.batch_axis
        group = mesh.group(axis)
        dp = mesh.shape.get(axis, 1)
        paths = list(grads)
        scale = {}
        for p in paths:
            rep = 1
            for name in self._specs.get(p, P()):
                if name is not None and mesh.group(name) is not None:
                    rep *= mesh.shape[name]
            scale[p] = 1.0 / (dp * rep) if group is not None else 1.0 / rep
        if group is not None:
            sums, loss = _mesh.all_reduce_tree([grads[p] for p in paths],
                                               loss, group)
            grads = dict(zip(paths, sums))
            loss = loss / dp
        for p in paths:
            if scale[p] != 1.0:
                grads[p] = grads[p] * scale[p]
        return grads, loss

    def _gnorm(self, grads):
        """The global gradient norm: the squares of sharded leaves summed
        over the ranks that hold their other shards."""
        mesh = self.mesh
        whole = torch.zeros((), dtype=torch.float32)
        parts = {}
        for p, g in grads.items():
            sq = (g.float() ** 2).sum()
            names = tuple(n for n in self._specs.get(p, P())
                          if n is not None and mesh.group(n) is not None
                          and mesh.shape[n] > 1)
            parts[names] = parts.get(names, 0.0) + sq
        whole = whole.to(next(iter(grads.values())).device)
        for names, sq in parts.items():
            for name in names:
                sq = _mesh._all_reduce(sq, mesh.group(name))
            whole = whole + sq
        return torch.sqrt(whole)

    def _step(self, params, opt_state, batch, generator, guard):
        local = dict(_paths(params))
        grads, loss, ok_micro = accumulate_grads(
            self._gathered_loss, params, batch, generator, self.accumulation)
        grads, loss = self._sync(dict(grads), loss)
        fparams = {_NODE: local}
        fgrads = {_NODE: grads}
        lr_scale = guard[0] if guard is not None else None
        gnorm = ok = None
        if guard is not None:
            gnorm = self._gnorm(grads)
            ok = _guardian.healthy(torch.where(ok_micro, loss, float("nan")),
                                   gnorm, guard[1])
        if isinstance(opt_state, ZeroState):
            zero_apply(self.tx, fgrads, opt_state, fparams, lr_scale, ok)
        else:
            updates, state_new = self.tx.update(fgrads, opt_state, fparams)
            if lr_scale is not None:
                ups = [u for d in updates.values() for u in d.values()]
                torch._foreach_mul_(ups, lr_scale)
            _guardian.write_where(ok, [
                (apply_updates(fparams, updates), fparams),
                (state_new, opt_state)])
        return loss, gnorm, ok

    def make_step(self):
        """step(params, opt_state, batch, generator) -> (params, opt_state,
        loss): one synchronous update written into the live tensors."""
        def step(params, opt_state, batch, generator=None):
            loss, _, _ = self._step(params, opt_state, batch, generator,
                                    None)
            return params, opt_state, loss
        return step

    def make_guarded_step(self):
        """The guardian variant: the same update applied only where the
        step is healthy (finite loss, finite global gradient norm under
        the guardian's threshold); returns (params, opt_state, loss,
        gnorm, ok). The gradients are the dp mean, so every rank takes the
        same verdict."""
        def step(params, opt_state, batch, generator, lr_scale, max_gnorm):
            dev = self.mesh.device
            guard = (torch.as_tensor(lr_scale, dtype=torch.float32,
                                     device=dev),
                     torch.as_tensor(max_gnorm, dtype=torch.float32,
                                     device=dev))
            loss, gnorm, ok = self._step(params, opt_state, batch,
                                         generator, guard)
            return params, opt_state, loss, gnorm, ok
        return step

    def fit_batch(self, params, opt_state, batch, rng=None):
        """One step on this rank's batch (from `shard_batch`); `rng` is a
        torch.Generator for dropout or None."""
        if self._specs is None:
            self._specs = self._path_specs(params)
        if _faults.ACTIVE is not None:
            _faults.ACTIVE.fire(_faults.TRAIN_DISPATCH)
        if _watchdog.ACTIVE is not None:
            _watchdog.ACTIVE.beat(f"sharded_trainer@{id(self):x}")
        if _dist.ACTIVE is not None:
            # multi-host sync point every sync_every steps: heartbeat,
            # step agreement, the preemption decision (an int increment
            # and a modulo off the sync cadence); `self` lets a bound
            # coordinator ignore host-local auxiliary trainers
            _dist.ACTIVE.on_step(self)
        _ps = _prof.ACTIVE
        if _ps is not None:
            _ps.step_start()
        _g = _guardian.ACTIVE
        with _mon.span("sharded.dispatch"):
            if _g is not None:
                params, opt_state, loss, gnorm, ok = \
                    self.make_guarded_step()(params, opt_state, batch, rng,
                                             _g.lr_scale, _g.max_gnorm)
            else:
                params, opt_state, loss = self.make_step()(
                    params, opt_state, batch, rng)
        if _g is not None:
            # device scalars; no sync here. `source` lets a bound
            # guardian ignore host-local auxiliary trainers
            _g.on_step(loss, gnorm, ok, source=self)
        _ps = _prof.ACTIVE
        if _ps is not None:
            _ps.step_end()
        return params, opt_state, loss


class ParameterAveragingTrainer:
    """≡ ParameterAveragingTrainingMaster: independent local steps on each
    dp rank's rows, parameters averaged over dp every
    `averaging_frequency` iterations (no gradient sync in between)."""

    def __init__(self, loss_fn, updater, mesh, averaging_frequency=5,
                 batch_axis="dp"):
        self.loss_fn = loss_fn
        self.tx = _as_tx(updater)
        self.mesh = getattr(mesh, "mesh", mesh)
        self.freq = int(averaging_frequency)
        self.batch_axis = batch_axis

    @property
    def _n(self):
        return self.mesh.shape[self.batch_axis]

    def init(self, params):
        """Each rank's own copy of the parameters (they diverge between
        averages, like the reference's Spark workers) and its optimizer
        state."""
        dev = self.mesh.device
        params = _mesh._tree_map(
            lambda a: _mesh._as_tensor(a, dev).detach().clone(), params)
        return params, self.tx.init(_flat(params))

    def average(self, params):
        """The mean over dp of every rank's copy: one tree, alike on every
        rank."""
        group = self.mesh.group(self.batch_axis)
        if group is None:
            return params
        return _mesh._tree_map(
            lambda a: _mesh._all_reduce(a, group) / self._n, params)

    def make_step(self):
        """step(params, opt_state, batch, rng=None, iteration=0) ->
        (params, opt_state, loss): a local step on this rank's rows of the
        GLOBAL `batch`, written into the live tensors; every
        `averaging_frequency`-th iteration the parameters are averaged.
        The loss is the dp mean."""
        mesh, axis = self.mesh, self.batch_axis

        def step(params, opt_state, batch, rng=None, iteration=0):
            local = _mesh._tree_map(lambda a: _mesh._local_slice(
                _mesh._as_tensor(a, mesh.device), 0, mesh.index(axis),
                self._n), batch)
            grads, loss, _ = accumulate_grads(self.loss_fn, params, local,
                                              rng, 1)
            leaves = dict(_paths(params))
            updates, new_state = self.tx.update(
                {_NODE: grads}, opt_state, {_NODE: leaves})
            new = apply_updates({_NODE: leaves}, updates)[_NODE]
            group = mesh.group(axis)
            if iteration % self.freq == self.freq - 1 and group is not None:
                new = {p: _mesh._all_reduce(v, group) / self._n
                       for p, v in new.items()}
            _guardian.write_where(None, [(new, leaves),
                                         (new_state, opt_state)])
            if group is not None:
                loss = _mesh._all_reduce(loss.reshape(1), group)[0] / self._n
            return params, opt_state, loss
        return step

    def fit_batch(self, params, opt_state, batch, rng=None, iteration=0):
        """`make_step()`'s step, with the dispatch's fault site, watchdog
        heartbeat and profiler step hooks. Returns (params, opt_state, the
        dp mean of the losses)."""
        if _faults.ACTIVE is not None:
            _faults.ACTIVE.fire(_faults.TRAIN_DISPATCH)
        if _watchdog.ACTIVE is not None:
            _watchdog.ACTIVE.beat(f"param_averaging@{id(self):x}")
        _ps = _prof.ACTIVE
        if _ps is not None:
            _ps.step_start()
        with _mon.span("sharded.dispatch"):
            out = self.make_step()(params, opt_state, batch, rng, iteration)
        _ps = _prof.ACTIVE
        if _ps is not None:
            _ps.step_end()
        return out
