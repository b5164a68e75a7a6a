"""Batch prefetch for `fit`: the part of `deeplearning4j_tpu/runtime/
pipeline.py` that feeds the training step (`PrefetchIterator`,
`maybe_prefetch`, `stage_dataset`, `DEFAULT_PREFETCH`).

A background thread pulls batch N+1 from the caller's iterable and stages
it onto the device while step N runs: its arrays go through the
iterator's `StagingRing` of pinned host buffers and from there, with
`non_blocking` copies on a side stream, into device tensors that the step
then copies into its graph's static inputs. This replaces the synchronous copy from pageable memory that
`fit` made for every batch. The staged tensors own their memory; none
aliases the caller's numpy arrays.

As in the reference, `maybe_prefetch` wraps only an iterable that opts in
(`asyncSupported()` True, as every `datasets.iterators.DataSetIterator`
does): a plain list of DataSets is stepped through as it is. The
evaluation loop stages with `stage_for_eval` (features only; the
evaluators read the labels on the host). `record_sync` counts a
host-blocking read (the guardian's) on `dl4j.pipeline.syncs`. With
monitoring on, each staged batch counts on `dl4j.pipeline.staged_batches`
and each delivered one sets `dl4j.pipeline.prefetch_depth` to the staged
batches still waiting (0: the step waited on the loader), as in the
reference.
"""
from __future__ import annotations

import os
import queue as _queue
import threading
import time
from contextlib import nullcontext

import numpy as np
import torch

from deeplearning4j_tpu_torch.runtime.executables import (StagingRing,
                                                          torch_dtype)

__all__ = ["DEFAULT_PREFETCH", "PrefetchIterator", "StagedBatch",
           "StagedMultiBatch", "blocking_float", "materialize_score",
           "maybe_prefetch", "record_sync", "stage_dataset",
           "stage_for_eval"]

#: default staging queue depth (double buffer): batch N+1 stages while
#: step N computes. 0 disables prefetch.
DEFAULT_PREFETCH = int(os.environ.get("DL4J_PIPELINE_PREFETCH", "2"))


def record_sync(site, blocked_ms):
    """Account ONE host-blocking device sync: `dl4j.pipeline.syncs` and
    `host_blocked_ms` with the site, and the flight recorder's current
    step (the JAX package's `record_sync`; the guardian's stacked verdict
    read counts here as site "guardian")."""
    from deeplearning4j_tpu_torch import monitoring as _mon
    if not _mon.enabled():
        return
    reg = _mon.get_registry()
    reg.counter(_mon.PIPELINE_SYNCS, labels={"site": site},
                help="host-blocking device syncs (0/step when the "
                     "pipeline is healthy)").inc()
    reg.histogram(_mon.PIPELINE_HOST_BLOCKED_MS, labels={"site": site},
                  help="wall time the host spent blocked per sync") \
       .observe(blocked_ms)
    _mon.step_recorder().on_host_blocked(blocked_ms)


def blocking_float(value, site="score"):
    """float(value), counted: a tensor's read (on the card or the CPU)
    lands on `dl4j.pipeline.syncs{site}` with the ms it blocked, when
    monitoring is on. None stays None; a Python number is returned as a
    float, uncounted."""
    if value is None:
        return None
    if isinstance(value, (float, int)):
        return float(value)
    from deeplearning4j_tpu_torch import monitoring as _mon
    if not _mon.enabled():
        return float(value)
    t0 = time.perf_counter()
    v = float(value)
    record_sync(site, (time.perf_counter() - t0) * 1e3)
    return v


def materialize_score(model, site="score"):
    """`model._score` as a float, read once: a device loss is floated
    through `blocking_float` and the float written back, so later reads
    of the same iteration's score cost no sync."""
    s = model._score
    if s is None or isinstance(s, float):
        return s
    v = blocking_float(s, site=site)
    model._score = v
    return v


class StagedBatch:
    """A DataSet whose arrays are already device tensors. `event` (None on
    the CPU) completes when the copies that made them have."""

    __slots__ = ("features", "labels", "featuresMask", "labelsMask",
                 "event")

    def __init__(self, features, labels, featuresMask=None,
                 labelsMask=None, event=None):
        self.features = features
        self.labels = labels
        self.featuresMask = featuresMask
        self.labelsMask = labelsMask
        self.event = event

    def numExamples(self):
        return 0 if self.features is None else int(self.features.shape[0])


class StagedMultiBatch:
    """The MultiDataSet counterpart of StagedBatch (lists of tensors)."""

    __slots__ = ("features", "labels", "featuresMasks", "labelsMasks",
                 "event")

    def __init__(self, features, labels, featuresMasks=None,
                 labelsMasks=None, event=None):
        self.features = features
        self.labels = labels
        self.featuresMasks = featuresMasks
        self.labelsMasks = labelsMasks
        self.event = event


def stage_dataset(ds, device, ring=None, stream=None):
    """One DataSet or MultiDataSet copied onto `device` through `ring` (a
    `StagingRing`; a fresh one when None), into new tensors made on
    `stream` (on the card: a side stream, so the copies overlap the
    step). Runs on the prefetch thread; counted on
    `dl4j.pipeline.staged_batches` when monitoring is on."""
    staged = _stage(ds, device, ring, stream)
    from deeplearning4j_tpu_torch import monitoring as _mon
    if _mon.enabled():
        _mon.get_registry().counter(
            _mon.PIPELINE_STAGED_BATCHES,
            help="batches staged to device by the prefetch worker").inc()
    return staged


def _stage(ds, device, ring, stream):
    ring = StagingRing(1) if ring is None else ring
    dev = torch.device(device)
    multi = hasattr(ds, "featuresMasks")
    groups = ([ds.features, ds.labels, ds.featuresMasks, ds.labelsMasks]
              if multi else [[ds.features], [ds.labels], [ds.featuresMask],
                             [ds.labelsMask]])
    groups = [None if g is None else
              [None if a is None else np.ascontiguousarray(a) for a in g]
              for g in groups]
    arrays = [a for g in groups if g is not None for a in g
              if a is not None]
    event = None
    with torch.cuda.stream(stream) if stream is not None else nullcontext():
        dsts = [torch.empty(a.shape, dtype=torch_dtype(a.dtype), device=dev)
                for a in arrays]
        ring.stage(arrays, dsts)
        if dev.type == "cuda":
            event = torch.cuda.Event()
            event.record()
    staged = iter(dsts)
    groups = [None if g is None else
              [None if a is None else next(staged) for a in g]
              for g in groups]
    if multi:
        return StagedMultiBatch(*groups, event=event)
    return StagedBatch(*(g[0] for g in groups), event=event)


def stage_for_eval(ds, device, ring=None, stream=None):
    """A DataSet's features staged onto `device` as `stage_dataset` stages
    them; the labels and masks stay numpy for the evaluators."""
    staged = _stage(StagedBatch(ds.features, None), device, ring, stream)
    return StagedBatch(staged.features, ds.labels, ds.featuresMask,
                       ds.labelsMask, event=staged.event)


class PrefetchIterator:
    """Background-thread prefetch with device staging over an iterable of
    DataSets (or an iterator with the hasNext/next protocol). The worker
    pulls from `base`, applies `stage`, and feeds a bounded queue of
    `depth` batches.

    An exception in the worker is captured and re-raised in the consumer,
    never taken for the end of the stream; the consumer polls with a
    timeout and checks the worker is alive, so a worker that dies without
    posting surfaces as an error instead of a hang."""

    _EMPTY = object()    # nothing peeked yet
    _EOS = object()      # worker saw clean end-of-stream
    _FAILED = object()   # worker captured an exception (see self._error)
    _POLL_S = 0.25       # consumer liveness-poll interval

    def __init__(self, base, depth=2, stage=None):
        self._base = base
        self._depth = max(1, int(depth))
        self._stage = stage
        self._queue = _queue.Queue(maxsize=self._depth)
        self._stop = threading.Event()
        self._thread = None
        self._peek = self._EMPTY
        self._error = None
        self._it = None      # the base's iterator, kept across restarts

    # -- worker side -----------------------------------------------------
    def _offer(self, q, stop, item):
        """put() that a reset()/close() can always interrupt."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except _queue.Full:
                continue
        return False

    def _items(self):
        base = self._base
        if hasattr(base, "hasNext") and hasattr(base, "next"):
            while base.hasNext():
                yield base.next()
        else:
            if self._it is None:
                self._it = iter(base)
            yield from self._it

    def _worker(self, q, stop):
        # q/stop belong to this generation: a worker from before a reset()
        # never touches the fresh queue
        try:
            for item in self._items():
                if stop.is_set():
                    return
                if self._stage is not None:
                    item = self._stage(item)
                if not self._offer(q, stop, item):
                    return
        except BaseException as e:  # noqa: BLE001 — delivered to consumer
            self._error = e
            self._offer(q, stop, self._FAILED)
            return
        self._offer(q, stop, self._EOS)

    # -- consumer side ---------------------------------------------------
    def _get_item(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._worker, args=(self._queue, self._stop),
                daemon=True, name="dl4j-pipeline-prefetch")
            self._thread.start()
        while True:
            try:
                item = self._queue.get(timeout=self._POLL_S)
            except _queue.Empty:
                if self._thread.is_alive():
                    continue
                # the worker is gone: drain once more, in case it posted
                # between the timeout and the liveness check
                try:
                    item = self._queue.get_nowait()
                except _queue.Empty:
                    if self._error is not None:
                        raise self._error from None
                    raise RuntimeError(
                        "prefetch worker died without delivering a batch, "
                        "an error, or end-of-stream") from None
            from deeplearning4j_tpu_torch import monitoring as _mon
            if _mon.enabled():
                _mon.get_registry().gauge(
                    _mon.PIPELINE_PREFETCH_DEPTH,
                    help="staged batches waiting in the prefetch queue "
                         "(0 = device waiting on the loader)") \
                    .set(self._queue.qsize())
            return item

    def hasNext(self):
        if self._peek is self._EMPTY:
            self._peek = self._get_item()
        if self._peek is self._FAILED:
            raise self._error
        return self._peek is not self._EOS

    def next(self, num=None):
        """The next staged batch (`num` is the DL4J iterator's argument
        and is ignored: a batch is what the base yields)."""
        if not self.hasNext():
            raise StopIteration("prefetch exhausted; call reset()")
        item, self._peek = self._peek, self._EMPTY
        return item

    def failed(self):
        """True once the worker has died on an error: hasNext and next
        re-raise it until reset() or resume_after_error()."""
        return self._peek is self._FAILED

    def __iter__(self):
        # a second `for` pass starts the base over, as the reference's does
        if self.resetSupported():
            self.reset()
        return self

    def __next__(self):
        if not self.hasNext():
            raise StopIteration
        return self.next()

    # -- protocol parity: forwarded to the base ----------------------------
    def resetSupported(self):
        sup = getattr(self._base, "resetSupported", None)
        return hasattr(self._base, "reset") if sup is None else sup()

    def asyncSupported(self):
        return False    # already async; double-wrapping buys nothing

    def batch(self):
        return self._base.batch()

    def numExamples(self):
        return self._base.numExamples()

    def totalOutcomes(self):
        return self._base.totalOutcomes()

    def inputColumns(self):
        return self._base.inputColumns()

    def setPreProcessor(self, pp):
        self._base.setPreProcessor(pp)

    def getPreProcessor(self):
        getpp = getattr(self._base, "getPreProcessor", None)
        return None if getpp is None else getpp()

    def resume_after_error(self):
        """Clear a worker failure and prefetch on from the base's CURRENT
        position (the failed pull's batch is lost, as with a raw iterator
        whose next() raised): how skip-and-count consumers
        (FaultTolerantTrainer) count one error and continue with prefetch
        on. A no-op unless in the failed state."""
        if self._peek is not self._FAILED:
            return
        self.close()
        self._stop = threading.Event()
        self._queue = _queue.Queue(maxsize=self._depth)
        self._peek = self._EMPTY
        self._error = None

    # -- lifecycle -------------------------------------------------------
    def close(self):
        """Stop the worker without resetting the base."""
        self._stop.set()
        t = self._thread
        if t is not None:
            deadline = time.monotonic() + 10.0
            while t.is_alive() and time.monotonic() < deadline:
                try:     # unblock a worker stuck in _offer on a full queue
                    self._queue.get_nowait()
                except _queue.Empty:
                    time.sleep(0.002)
            t.join(timeout=5)
        self._thread = None

    def reset(self):
        """Stop the worker, reset the base if it can be, and start over."""
        self.close()
        self._stop = threading.Event()
        self._queue = _queue.Queue(maxsize=self._depth)
        self._peek = self._EMPTY
        self._error = None
        self._it = None
        if hasattr(self._base, "reset"):
            self._base.reset()


def maybe_prefetch(data, depth, device, stage=stage_dataset):
    """(iterator, prefetcher or None): `data` wrapped in a PrefetchIterator
    that stages onto `device` with `stage` when `depth` (None:
    DEFAULT_PREFETCH) is above 0 and `data` opts in (`asyncSupported()`
    True). The second element is the caller's close() handle."""
    depth = DEFAULT_PREFETCH if depth is None else int(depth)
    if depth <= 0 or isinstance(data, PrefetchIterator):
        return data, None
    sup = getattr(data, "asyncSupported", None)
    if sup is None or not sup():
        return data, None
    dev = torch.device(device)
    ring = StagingRing(2)
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    pf = PrefetchIterator(
        data, depth=depth,
        stage=lambda ds: stage(ds, dev, ring, stream))
    return pf, pf
