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

Differences from the reference: the port has no DataSetIterator classes
yet (ROADMAP A18), so `maybe_prefetch` wraps any iterable of DataSets
except one whose `asyncSupported()` says no, and the staging has no
monitoring counters (ROADMAP A16).
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
           "StagedMultiBatch", "maybe_prefetch", "stage_dataset"]

#: default staging queue depth (double buffer): batch N+1 stages while
#: step N computes. 0 disables prefetch.
DEFAULT_PREFETCH = int(os.environ.get("DL4J_PIPELINE_PREFETCH", "2"))


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
    step). Runs on the prefetch thread."""
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
            yield from iter(base)

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
                return self._queue.get(timeout=self._POLL_S)
            except _queue.Empty:
                if self._thread.is_alive():
                    continue
                # the worker is gone: drain once more, in case it posted
                # between the timeout and the liveness check
                try:
                    return self._queue.get_nowait()
                except _queue.Empty:
                    if self._error is not None:
                        raise self._error from None
                    raise RuntimeError(
                        "prefetch worker died without delivering a batch, "
                        "an error, or end-of-stream") from None

    def hasNext(self):
        if self._peek is self._EMPTY:
            self._peek = self._get_item()
        if self._peek is self._FAILED:
            raise self._error
        return self._peek is not self._EOS

    def next(self):
        if not self.hasNext():
            raise StopIteration("prefetch exhausted; call reset()")
        item, self._peek = self._peek, self._EMPTY
        return item

    def __iter__(self):
        return self

    def __next__(self):
        if not self.hasNext():
            raise StopIteration
        return self.next()

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
        if hasattr(self._base, "reset"):
            self._base.reset()


def maybe_prefetch(data, depth, device):
    """(iterator, prefetcher or None): `data` wrapped in a PrefetchIterator
    that stages onto `device` when `depth` (None: DEFAULT_PREFETCH) is
    above 0 and `data` does not refuse (`asyncSupported()` False). The
    second element is the caller's close() handle."""
    depth = DEFAULT_PREFETCH if depth is None else int(depth)
    if depth <= 0 or isinstance(data, PrefetchIterator):
        return data, None
    sup = getattr(data, "asyncSupported", None)
    if sup is not None and not sup():
        return data, None
    dev = torch.device(device)
    ring = StagingRing(2)
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    pf = PrefetchIterator(
        data, depth=depth,
        stage=lambda ds: stage_dataset(ds, dev, ring, stream))
    return pf, pf
