"""ParallelWrapper (≡ deeplearning4j-parallel-wrapper ::
parallelism.ParallelWrapper): synchronous data-parallel training, the
port of `deeplearning4j_tpu/parallel/wrapper.py`.

One rank per device (`torchrun --nproc_per_node=N`, or a process group
brought up by `mesh.initialize_distributed`); every rank builds the same
network and runs the same `fit`. Each rank takes its rows of every global
batch and runs the network's own training step on them
(`nn/_network.py`), with three additions while the wrapper steps:

- the loss is a mean over the GLOBAL batch's real rows: a ragged final
  batch is padded to a multiple of the ranks with zero-weighted rows (the
  labels mask, as the JAX package pads it), each rank's loss is scaled by
  its share of the real rows (a device scalar the host fills before the
  step) before its backward, and the gradients and loss are summed over
  dp in one all-reduce of one flat buffer;
- BatchNorm uses the global batch's statistics (`batch_sync`: Σx and Σx²
  forward, Σdz·x̂ and Σdz backward, summed over dp in the BN Functions and
  in the fused conv1x1+BN pair of B5, B7 and B8);
- `shardOptimizerState(True)` keeps each rank's ZeRO-1 blocks of the
  updater state (`parallel/zero.py`).

On the card each step replays a CUDA graph (the network's store, keys
`dp_fit...`; `Builder.cudaGraphs(False)` runs them eagerly) and the graph
holds the collectives when the group is NCCL: the all-reduces are
captured in it and replayed with it. A gloo group stages CUDA tensors
through the host, which a graph cannot capture, so its steps run
eagerly.

Usage parity:
    pw = (ParallelWrapper.Builder(net)
          .workers(8).prefetchBuffer(4).averagingFrequency(1).build())
    pw.fit(iterator)
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch import batch_sync as _batch_sync
from deeplearning4j_tpu_torch import monitoring as _mon
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.parallel import mesh as _mesh
from deeplearning4j_tpu_torch.parallel.mesh import DeviceMesh
from deeplearning4j_tpu_torch.parallel.zero import (ZeroState,
                                                    shard_optimizer_state,
                                                    zero_apply)
from deeplearning4j_tpu_torch.resilience import guardian as _guardian
from deeplearning4j_tpu_torch.resilience import watchdog as _watchdog
from deeplearning4j_tpu_torch.runtime import pipeline as _pipeline
from deeplearning4j_tpu_torch.runtime.executables import tensor_leaves

__all__ = ["ParallelWrapper"]


class _DataParallel:
    """The dp context a network's step reads (`Network._dp`): this rank's
    share of the global batch's real rows (`weight`, a device scalar the
    graphs read), the gradient and loss all-reduce, the BatchNorm
    statistics' sync, and ZeRO-1's update."""

    def __init__(self, mesh, device, zero, axis="dp"):
        self.mesh, self.axis, self.zero = mesh, axis, bool(zero)
        self.group = mesh.group(axis)
        self.n = mesh.shape[axis]
        self.weight = torch.ones((), dtype=torch.float32, device=device)
        self._host_weight = 1.0
        self._sync = None
        if self.group is not None and self.n > 1:
            # BatchSync hands over a fresh concatenation: reduced in place
            self._sync = _batch_sync.BatchSync(
                lambda t: _mesh._all_reduce(t, self.group, fresh=True),
                self.n)

    def bound(self):
        return [self.weight]

    def set_weight(self, w):
        if w != self._host_weight:
            with torch.no_grad():
                self.weight.fill_(w)
            self._host_weight = w

    def batch_stats(self):
        return _batch_sync.active(self._sync)

    def reduce(self, loss, grads):
        """(loss, grads) summed over dp: the network scaled this rank's
        loss by its share of the global batch's real rows (`weight`)
        before its backward, so the sums are the global batch's mean and
        its gradients. With no process group the share is 1 and nothing
        moves."""
        if self.group is None:
            return loss, grads
        keys = [(n, k) for n in sorted(grads) for k in sorted(grads[n])]
        sums, total = _mesh.all_reduce_tree(
            [grads[n][k] for n, k in keys], loss, self.group)
        out = {n: dict(d) for n, d in grads.items()}
        for (n, k), g in zip(keys, sums):
            out[n][k] = g
        return total.to(loss.dtype), out

    def update(self, net, grads, state, loss=None, lr_scale=None,
               max_gnorm=None):
        """ZeRO-1's update into the network's live tensors; guarded (with
        `lr_scale`) it returns (gnorm, ok) and writes only where ok."""
        gnorm = ok = None
        if lr_scale is not None:
            gnorm = _guardian.global_norm(grads)
            ok = _guardian.healthy(loss, gnorm, max_gnorm)
        zero_apply(net._tx, grads, net._opt_state, net._params, lr_scale,
                   ok, net._apply_constraints, [(state, net._state)])
        return None if ok is None else (gnorm, ok)


class ParallelWrapper:
    def __init__(self, model, workers=None, prefetch_buffer=2,
                 averaging_frequency=1, report_score=True, devices=None,
                 shard_optimizer_state=False, gradient_accumulation=None,
                 cuda_graphs=True):
        self.model = model
        world, _ = _mesh._world()
        n = workers or world
        self.mesh = DeviceMesh(devices, device=getattr(model, "_device", None),
                               dp=n)
        self.prefetch_buffer = prefetch_buffer
        self.averaging_frequency = averaging_frequency  # sync ⇒ always 1
        self.report_score = report_score
        self.shard_optimizer_state = shard_optimizer_state  # ZeRO-1
        # None = inherit the model conf's gradientAccumulation; an
        # EXPLICIT 1 overrides the conf back to per-batch steps
        self.gradient_accumulation = (None if gradient_accumulation
                                      is None else
                                      int(gradient_accumulation))
        if self.gradient_accumulation is not None \
                and self.gradient_accumulation < 1:
            raise ValueError("gradient_accumulation must be >= 1")
        self.cuda_graphs = bool(cuda_graphs)
        self._dp = None

    class Builder:
        def __init__(self, model):
            self._model = model
            self._kw = {}

        def workers(self, n):
            self._kw["workers"] = int(n)
            return self

        def prefetchBuffer(self, n):
            self._kw["prefetch_buffer"] = int(n)
            return self

        def averagingFrequency(self, n):
            self._kw["averaging_frequency"] = int(n)
            return self

        def reportScoreAfterAveraging(self, flag):
            self._kw["report_score"] = bool(flag)
            return self

        def shardOptimizerState(self, flag=True):
            """ZeRO-1: shard updater state over dp (parallel/zero.py)."""
            self._kw["shard_optimizer_state"] = bool(flag)
            return self

        def gradientAccumulation(self, n):
            """Every G consecutive same-shape batches make ONE dp
            optimizer step (gradients summed on the device, one update).
            Unset, it is inherited from the conf DSL's
            `.gradientAccumulation(G)`; an explicit 1 overrides the conf
            back to per-batch steps."""
            self._kw["gradient_accumulation"] = int(n)
            return self

        def cudaGraphs(self, flag=True):
            """Replay each step's CUDA graph on the card (NCCL groups;
            gloo steps run eagerly)."""
            self._kw["cuda_graphs"] = bool(flag)
            return self

        def workspaceMode(self, *_):
            return self  # accepted for parity

        def trainingMode(self, *_):
            return self  # always synchronous averaging

        def build(self):
            return ParallelWrapper(self._model, **self._kw)

    # -- placement -------------------------------------------------------
    def _shard_model(self):
        """Every rank starts from rank 0's parameters and state (the ranks
        built the same network from one seed: a broadcast keeps them one),
        the optimizer is built, and the dp context is installed; with
        shardOptimizerState the updater state keeps this rank's blocks."""
        m = self.model
        if m._params is None:
            m.init(device=self.mesh.device)
        m._ensure_training()
        group = self.mesh.group("dp")
        if group is not None and self._dp is None:
            src = int(self.mesh.group_ranks["dp"][0])
            ts = tensor_leaves(m._params) + tensor_leaves(m._state)
            with torch.no_grad():
                for t in ts:
                    buf, host = _mesh._staged(t, group)
                    dist.broadcast(buf, src, group=group)
                    if host or buf.data_ptr() != t.data_ptr():
                        t.copy_(buf)
        if self.shard_optimizer_state and not isinstance(m._opt_state,
                                                         ZeroState):
            m._opt_state = shard_optimizer_state(m._opt_state, self.mesh)
        if self._dp is None:
            self._dp = _DataParallel(self.mesh, m._device,
                                     self.shard_optimizer_state)

    @contextlib.contextmanager
    def _stepping(self):
        """The network steps under the dp context for the span and without
        it after, so a later `net.fit` of one rank runs no collective and
        reads no stale share of the rows."""
        m = self.model
        prev, m._dp = m._dp, self._dp
        try:
            yield
        finally:
            m._dp = prev

    @staticmethod
    def _pad_rows(arr, pad):
        """Append `pad` copies of the last row (row CONTENT is irrelevant:
        padded rows are zero-weighted in the loss; repeating keeps dtypes
        and value ranges valid, e.g. int label ids)."""
        return np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)])

    def _graph_model(self):
        """Resolved ONCE per wrapper: is the wrapped model a (validated)
        single-input/single-output ComputationGraph?"""
        cached = getattr(self, "_is_graph", None)
        if cached is not None:
            return cached
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
        self._is_graph = isinstance(self.model, ComputationGraph)
        if self._is_graph and (len(self.model.conf.input_names) != 1
                               or len(self.model.conf.output_names) != 1):
            raise ValueError(
                "ParallelWrapper needs a single-input/single-output "
                "ComputationGraph (got "
                f"{len(self.model.conf.input_names)} inputs, "
                f"{len(self.model.conf.output_names)} outputs); use "
                "ShardedTrainer for general graphs")
        return self._is_graph

    def _host_prep(self, ds):
        """Host side of one global batch: unwrap (Multi)DataSet, pad a
        ragged batch to a dp multiple with zero-weighted rows. Returns
        numpy (feats, labs, fmask, lmask)."""
        if isinstance(ds, MultiDataSet):
            if len(ds.features) != 1 or len(ds.labels) != 1:
                raise ValueError(
                    "ParallelWrapper.fit got a MultiDataSet with "
                    f"{len(ds.features)} feature / {len(ds.labels)} label "
                    "arrays; only single-input/single-output data is "
                    "supported — use ShardedTrainer for general graphs")
            fms, lms = ds.featuresMasks, ds.labelsMasks
            feats = np.asarray(ds.features[0])
            labs = np.asarray(ds.labels[0])
            fm = None if not fms or fms[0] is None else np.asarray(fms[0])
            lm = None if not lms or lms[0] is None else np.asarray(lms[0])
        else:
            feats = _host(ds.features)
            labs = _host(ds.labels)
            lm = None if ds.labelsMask is None else _host(ds.labelsMask)
            fm = None if ds.featuresMask is None else _host(ds.featuresMask)
        pad = (-feats.shape[0]) % self.mesh.size
        if pad:
            # ragged: pad rows to a multiple of the dp axis and ZERO-WEIGHT
            # them through the labels mask, so the masked-mean loss
            # excludes them exactly
            b = feats.shape[0]
            feats = self._pad_rows(feats, pad)
            labs = self._pad_rows(labs, pad)
            if lm is None:
                mshape = labs.shape[:-1] if labs.ndim >= 2 else labs.shape
                lm = np.ones(mshape, np.float32)
            else:
                lm = self._pad_rows(lm, pad)
            lm = lm.copy()
            lm[b:] = 0.0
            if fm is not None:
                fm = self._pad_rows(fm, pad)
        if _mon.enabled():
            _mon.record_transfer(feats.nbytes + labs.nbytes
                                 + (0 if lm is None else lm.nbytes)
                                 + (0 if fm is None else fm.nbytes))
        return feats, labs, fm, lm

    def _local(self, ds):
        """(this rank's rows as a DataSet, this rank's count of real loss
        terms, the global count)."""
        feats, labs, fm, lm = self._host_prep(ds)
        n, r = self.mesh.shape["dp"], self.mesh.index("dp")
        rows = feats.shape[0] // n
        sl = slice(r * rows, (r + 1) * rows)
        if lm is not None:
            counts = [float(np.asarray(lm[i * rows:(i + 1) * rows],
                                       np.float64).sum()) for i in range(n)]
        else:
            per = int(np.prod(labs.shape[1:-1])) if labs.ndim > 2 else 1
            counts = [float(rows * per)] * n
        local = DataSet(feats[sl], labs[sl],
                        None if fm is None else fm[sl],
                        None if lm is None else lm[sl])
        return local, counts[r], sum(counts)

    def _graphs(self):
        return self.cuda_graphs and self.mesh.backend("dp") != "gloo"

    def _fit_dataset(self, ds):
        """One dp train step on a global (Multi)DataSet: the shared inner
        loop, also driven by EarlyStoppingParallelTrainer."""
        if self._dp is None:
            self._shard_model()
        self._graph_model()
        m = self.model
        with _mon.span("train.stage"):
            local, mine, total = self._local(ds)
            self._dp.set_weight(mine / total if total else 0.0)
            batch = m._unpack(local)
        with _mon.span("parallel.dispatch"), self._stepping():
            m._train_step([batch], self._graphs())
        return m._score

    def _fit_group_accum(self, group):
        """One ACCUMULATED dp optimizer step over G same-shape batches:
        the network's accumulation step on this rank's rows of each, then
        the dp all-reduce of the mean gradients, one update."""
        m = self.model
        with _mon.span("train.stage"):
            locals_ = [self._local(ds) for ds in group]
            mine = sum(x[1] for x in locals_)
            total = sum(x[2] for x in locals_)
            self._dp.set_weight(mine / total if total else 0.0)
            batches = [m._unpack(x[0]) for x in locals_]
        with _mon.span("parallel.accum_dispatch"), self._stepping():
            m._train_step(batches, self._graphs())

    @staticmethod
    def _scan_sig(ds):
        if isinstance(ds, MultiDataSet) or ds.features is None:
            return None

        def sh(a):
            return None if a is None else tuple(np.shape(a))
        return (sh(ds.features), sh(ds.labels), sh(ds.featuresMask),
                sh(ds.labelsMask))

    def fit(self, iterator, epochs=1, stepsPerDispatch=1):
        """Data-parallel fit: the network's own training step on this
        rank's rows of each global batch, gradients and BN statistics
        reduced over dp. stepsPerDispatch=k runs k steps back to back (the
        port's network runs its steps in order with no host sync between
        them, which is the JAX package's scanned dispatch's math).
        gradientAccumulation=G (builder knob, or inherited from the model
        conf): every G same-shape batches make ONE accumulated update."""
        self._shard_model()
        self._graph_model()
        accum = self.gradient_accumulation
        if accum is None:
            accum = int(self.model.conf.defaults.get(
                "gradientAccumulation", 1) or 1)
        it, pf = iterator, None
        if self.prefetch_buffer and hasattr(iterator, "asyncSupported") \
                and iterator.asyncSupported():
            # the host pull runs in the background; the rank's rows are
            # cut on this thread
            it = pf = _pipeline.PrefetchIterator(
                iterator, depth=self.prefetch_buffer, stage=None)
        try:
            for _ in range(int(epochs)):
                with _mon.span("fit.epoch"):
                    if hasattr(it, "reset"):
                        it.reset()
                    if accum == 1:
                        for ds in _mon.traced_iter(it):
                            self._fit_dataset(ds)
                    else:
                        self._fit_accum_epoch(it, accum)
                    self.model._epoch += 1
        finally:
            if _watchdog.ACTIVE is not None:
                _watchdog.ACTIVE.retire(self.model._beat_name())
            if pf is not None:
                pf.close()
        return self.model

    def _fit_accum_epoch(self, it, accum):
        group, sig = [], None

        def flush():
            nonlocal group
            for g in group:   # a shorter tail runs batch by batch
                self._fit_dataset(g)
            group = []

        for ds in _mon.traced_iter(it):
            s = self._scan_sig(ds)
            if s is None or s[0][0] % self.mesh.size:
                flush()
                sig = None
                self._fit_dataset(ds)
                continue
            if s != sig:
                flush()
                sig = s
            group.append(ds)
            if len(group) == accum:
                self._fit_group_accum(group)
                group = []
        flush()

    def shutdown(self):
        """Parity: the wrapper holds no worker, and the network steps
        without the dp context outside the wrapper's fit already."""


def _host(a):
    if a is None:
        return None
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)

