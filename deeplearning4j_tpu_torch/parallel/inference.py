"""ParallelInference (≡ deeplearning4j-parallel-wrapper ::
inference.ParallelInference): the port of
`deeplearning4j_tpu/parallel/inference.py`, SEQUENTIAL and BATCHED modes.

One model serves every thread; the value is in the coalescing. A
collector thread drains the request queue, groups compatible shapes up
to `batchLimit` rows, pads the batch dim to a power of two, runs one
`model.output` and scatters the rows back to their callers as numpy
arrays. With a `ComputationGraph` whose conv1x1+BN fusion is on, each
forward runs the hand-written epilogue GEMM on the card.

Graceful degradation, as in the JAX package — callers never block
indefinitely:
- `output(x, timeout_ms=...)` enforces a per-request deadline — expiry
  cancels the request and raises `InferenceTimeoutError`;
- enqueue is bounded: a queue that stays full for `enqueue_timeout_ms`
  sheds the request with `InferenceOverloadedError`;
- a dead collector thread is restarted behind a `CircuitBreaker` —
  repeated deaths OPEN the breaker and requests are served directly
  (degraded, uncoalesced) until the cooldown's half-open probe brings
  the collector back;
- `shutdown()` is idempotent and drains the queue clean.

The executable path: with `bucketLadder([...])` a batch is padded to the
smallest bucket that holds it, or split across max-bucket chunks
(`runtime.executables.BucketLadder`), and each chunk replays the CUDA
graph of that bucket's forward from an `ExecutableStore` (on the CPU the
same forward runs eagerly). `warmup()` captures every bucket up front;
inputs enter the graphs' static inputs through a `StagingRing` of
`stagingDepth` pinned buffers; `executableCacheDir` keeps the store's
manifest of keys, whose signatures a later `warmup()` captures too. A failed replay opens the `aotBreaker` and the batch is
served through the eager forward, counted in `status()`.

Not ported yet: the monitoring and fault-injection hooks (ROADMAP A16,
A14) and `lengthBuckets`, which serves the recurrent models (ROADMAP
A12); it raises, naming them.

Usage parity:
    pi = (ParallelInference.Builder(net)
          .inferenceMode(InferenceMode.BATCHED)
          .batchLimit(32).queueLimit(256).build())
    pi.warmup()                           # with .bucketLadder([1, 2, 4, 8])
    out = pi.output(x)                    # thread-safe, blocks
    out = pi.output(x, timeout_ms=50)     # bounded wait
    pi.shutdown()
"""
from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch

from deeplearning4j_tpu_torch.resilience.errors import (
    InferenceOverloadedError, InferenceTimeoutError)
from deeplearning4j_tpu_torch.resilience.policy import CircuitBreaker
from deeplearning4j_tpu_torch.runtime.executables import (BucketLadder,
                                                          ExecutableStore,
                                                          StagingRing)

__all__ = ["InferenceMode", "ParallelInference", "bounded_enqueue"]


class InferenceMode:
    SEQUENTIAL = "SEQUENTIAL"   # direct call, no queue
    BATCHED = "BATCHED"         # coalesce requests up to batchLimit
    INPLACE = "INPLACE"         # reference alias: shared model, no copy —
    #                             identical to BATCHED here


def _bucket(n):
    b = 1
    while b < n:
        b *= 2
    return b


def _length_buckets():
    return NotImplementedError(
        "ParallelInference.lengthBuckets: length-bucketed serving pads the "
        "time axis of the recurrent models, which come with ROADMAP A12")


def bounded_enqueue(q, item, deadline, enqueue_timeout, count_timeout=None,
                    what="inference"):
    """Wait at most `enqueue_timeout` seconds (clipped to the caller's
    deadline) for queue space, then SHED with `InferenceOverloadedError` —
    callers never block indefinitely. A caller deadline that expires
    while waiting raises `InferenceTimeoutError` instead (callers retry on
    overloaded, not on timeout); `count_timeout` lets the owner count that
    case on its own metric."""
    wait = enqueue_timeout
    if deadline is not None:
        wait = min(wait, max(0.0, deadline - time.monotonic()))
    try:
        if wait > 0:
            q.put(item, timeout=wait)
        else:
            q.put_nowait(item)
    except queue.Full:
        if deadline is not None and time.monotonic() >= deadline:
            if count_timeout is not None:
                count_timeout()
            raise InferenceTimeoutError(
                f"{what} request deadline expired while waiting "
                "for queue space") from None
        raise InferenceOverloadedError(
            f"{what} queue full (limit {q.maxsize}) "
            f"after {wait * 1e3:.6g} ms — request shed") from None


def _host(out):
    """The first output of a forward, as a numpy array on the host."""
    out = out[0] if isinstance(out, list) else out
    return out.detach().cpu().numpy()


class _Request:
    __slots__ = ("x", "event", "result", "error", "claimed", "cancelled",
                 "server")

    def __init__(self, x):
        self.x = x
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.claimed = False
        self.cancelled = False  # deadline expired: discard, never serve
        self.server = None      # thread that claimed it (set under lock)


class ParallelInference:
    def __init__(self, model, inference_mode=InferenceMode.BATCHED,
                 batch_limit=32, queue_limit=256, collect_timeout_ms=2.0,
                 enqueue_timeout_ms=100.0, breaker=None, bucket_ladder=None,
                 exec_cache_dir=None, staging_depth=2, aot_breaker=None):
        self.model = model
        self.mode = inference_mode
        # a ladder closes the shape vocabulary and serves through the
        # executable store; admission coalesces up to its top bucket
        self._ladder = None
        if bucket_ladder is not None:
            self._ladder = (bucket_ladder
                            if isinstance(bucket_ladder, BucketLadder)
                            else BucketLadder(batch=bucket_ladder))
            batch_limit = self._ladder.max_batch
        self.batch_limit = int(batch_limit)
        self.collect_timeout = collect_timeout_ms / 1e3
        self.enqueue_timeout = enqueue_timeout_ms / 1e3
        self.model_calls = 0          # diagnostic: forwards actually run
        self.timeouts = 0             # diagnostic: requests cancelled late
        self.collector_restarts = 0   # diagnostic: breaker-guarded revives
        self.collector_error = None   # last error that killed a collector
        self._restart_unconfirmed = False   # revive awaiting 1st success
        self._exec_cache_dir = exec_cache_dir
        self._store = None            # ExecutableStore, built lazily
        self._ring = StagingRing(staging_depth)
        # one dispatch at a time through the graphs: they share static
        # inputs and outputs
        self._graph_lock = threading.Lock()
        self.aot_fallbacks = 0        # failed graph dispatches, served eager
        self._aot_error = None        # the last one's exception
        # ONE failed dispatch opens it (serve eagerly for the cooldown);
        # the half-open probe tries the graphs again
        self._aot_breaker = aot_breaker or CircuitBreaker(
            failure_threshold=1, cooldown=30.0, name="inference.aot")
        self._queue = queue.Queue(maxsize=int(queue_limit))
        self._claim_lock = threading.Lock()
        self._lifecycle_lock = threading.Lock()   # restart + shutdown
        self._breaker = breaker or CircuitBreaker(
            failure_threshold=3, cooldown=5.0, name="inference.collector")
        self._last_dead = None    # thread whose death was already recorded
        self._shutdown = False
        self._thread = None
        if self.mode != InferenceMode.SEQUENTIAL:
            self._thread = self._start_collector()

    def _start_collector(self):
        t = threading.Thread(target=self._collector_main, daemon=True)
        t.start()
        return t

    def _collector_main(self):
        try:
            self._collector()
        except BaseException as e:  # noqa: BLE001 — thread is dying anyway
            # remember why (surfaced by the revive path / diagnostics);
            # waiting clients detect the death and revive or degrade
            self.collector_error = e

    class Builder:
        def __init__(self, model):
            self._model = model
            self._kw = {}

        def inferenceMode(self, mode):
            self._kw["inference_mode"] = mode
            return self

        def batchLimit(self, n):
            self._kw["batch_limit"] = int(n)
            return self

        def queueLimit(self, n):
            self._kw["queue_limit"] = int(n)
            return self

        def enqueueTimeoutMs(self, ms):
            """How long output() may wait for queue space before shedding
            with InferenceOverloadedError."""
            self._kw["enqueue_timeout_ms"] = float(ms)
            return self

        def breaker(self, breaker):
            """Circuit breaker guarding collector-thread restarts."""
            self._kw["breaker"] = breaker
            return self

        def workers(self, *_):
            return self  # one model serves all threads

        def aotBreaker(self, breaker):
            """Circuit breaker guarding the executable path: a failed
            dispatch opens it and batches are served eagerly until its
            half-open probe succeeds."""
            self._kw["aot_breaker"] = breaker
            return self

        def bucketLadder(self, buckets):
            """Serve through one CUDA graph per batch bucket (a list of
            sizes or a BucketLadder)."""
            self._kw["bucket_ladder"] = buckets
            return self

        def lengthBuckets(self, buckets):
            raise _length_buckets()

        def executableCacheDir(self, path):
            """Where the executable store keeps its manifest of keys."""
            self._kw["exec_cache_dir"] = path
            return self

        def stagingDepth(self, n):
            """Pinned staging buffers per input signature."""
            self._kw["staging_depth"] = int(n)
            return self

        def build(self):
            return ParallelInference(self._model, **self._kw)

    # -- the executable path -----------------------------------------------
    def warmup(self, buckets=None, lengths=None, example=None):
        """Capture the forward of every bucket of the ladder up front, so
        that serving never captures. `buckets` (re)configures the ladder
        (with neither it nor a Builder ladder: powers of two up to
        batchLimit); the per-input feature shapes come from `example`
        (one example or a batch, as output() takes it) or from the
        model's input types. With `executableCacheDir`, every signature
        the store's manifest records is captured too. Returns {compiled,
        from_disk, captures, nvcc_runs, seconds, keys, signatures}; a
        successful warmup closes the AOT breaker."""
        if lengths is not None:
            raise _length_buckets()
        if buckets is not None or self._ladder is None:
            if buckets is None:
                buckets, b = [], 1
                while b < self.batch_limit:
                    buckets.append(b)
                    b *= 2
                buckets.append(self.batch_limit)
            self._ladder = BucketLadder(batch=buckets)
            self.batch_limit = self._ladder.max_batch
        feats = self._feature_shapes(example)
        sigs = [tuple(((b,) + shp, "float32") for shp in feats)
                for b in self._ladder.batch]
        with self._graph_lock:
            stats = self._ensure_store().warmup(sigs)
        stats["signatures"] = len(sigs)
        self._aot_breaker.record_success()
        return stats

    def _feature_shapes(self, example):
        """Per-input feature shapes (no batch dim): from an example, else
        from the model's input types."""
        if example is not None:
            n_inputs = len(self._input_ranks())
            if isinstance(example, (list, tuple)) and n_inputs > 1:
                xs = tuple(np.asarray(a, np.float32) for a in example)
            else:
                xs = (np.asarray(example, np.float32),)
            if self._needs_batch(xs):
                return [tuple(a.shape) for a in xs]
            return [tuple(a.shape[1:]) for a in xs]
        conf = getattr(self.model, "conf", None)
        types = getattr(conf, "node_output_types", None)
        if not types:
            raise ValueError("the model has no input types: pass "
                             "warmup(example=)")
        feats = [tuple(types[n].shape()) for n in conf.input_names]
        if any(d is None for shp in feats for d in shp):
            raise ValueError(f"cannot warm variable-size inputs {feats}: "
                             "pass warmup(example=)")
        return feats

    def _ensure_store(self):
        with self._lifecycle_lock:
            if self._store is None:
                self._store = ExecutableStore(
                    self.model, directory=self._exec_cache_dir)
            return self._store

    def status(self):
        """Serving counters and the executable store's status."""
        return {"mode": self.mode, "batch_limit": self.batch_limit,
                "bucket_ladder": (None if self._ladder is None
                                  else list(self._ladder.batch)),
                "model_calls": self.model_calls, "timeouts": self.timeouts,
                "collector_restarts": self.collector_restarts,
                "aot_fallbacks": self.aot_fallbacks,
                "aot_error": (None if self._aot_error is None
                              else repr(self._aot_error)),
                "aot_breaker": self._aot_breaker.state,
                "staged": self._ring.staged,
                "executables": (None if self._store is None
                                else self._store.status())}

    # -- client side -----------------------------------------------------
    def output(self, x, timeout_ms=None):
        """Thread-safe inference. x: one example (features without batch
        dim) or a batch; for multi-input ComputationGraphs a LIST/TUPLE
        with one array per model input (coalesced per-input). Returns the
        model output as a numpy array with matching leading dims.

        timeout_ms bounds the WHOLE call (enqueue + wait): expiry cancels
        the request and raises InferenceTimeoutError. A full queue that
        stays full past the bounded enqueue wait sheds the request with
        InferenceOverloadedError. Direct (SEQUENTIAL / degraded /
        post-shutdown) forwards run synchronously and cannot be
        interrupted mid-flight: the deadline is enforced after the
        forward."""
        n_inputs = len(self._input_ranks())
        if isinstance(x, (list, tuple)) and n_inputs > 1:
            if len(x) != n_inputs:
                raise ValueError(
                    f"model has {n_inputs} inputs but output() got "
                    f"{len(x)} arrays")
            multi = True
            xs = tuple(np.asarray(a, np.float32) for a in x)
        else:
            # single-input model: a list of rows is just a batch
            multi = False
            xs = (np.asarray(x, np.float32),)
        single = self._needs_batch(xs)
        if single:
            xs = tuple(a[None] for a in xs)
        deadline = None if timeout_ms is None \
            else time.monotonic() + float(timeout_ms) / 1e3
        if self.mode == InferenceMode.SEQUENTIAL or self._shutdown:
            return self._direct_deadline(xs, multi, single, deadline)
        if self._thread is not None and not self._thread.is_alive():
            # dead collector noticed up front: revive (breaker willing)
            # or serve this request directly — no pointless queue wait
            if not self._revive_collector():
                return self._direct_deadline(xs, multi, single, deadline)
        req = _Request(xs)
        self._enqueue(req, deadline)
        degraded = False
        while not req.event.is_set():
            wait = 0.25
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self._cancel(req)
                    raise InferenceTimeoutError(
                        f"inference request missed its "
                        f"{float(timeout_ms):.6g} ms deadline")
                wait = min(wait, remaining)
            if req.event.wait(wait):
                break
            dead = self._thread is not None and not self._thread.is_alive()
            if dead and not self._shutdown:
                # breaker-guarded revive; False → breaker OPEN, serve
                # this request directly (degraded but live)
                if self._revive_collector():
                    continue
                degraded = True
            if self._shutdown or (dead and degraded):
                with self._claim_lock:
                    # reclaim an unclaimed request, or one whose claiming
                    # THREAD died before delivering (a claim held by a live
                    # thread — e.g. shutdown()'s drain — stays theirs, so a
                    # request is never served twice)
                    orphaned = (req.claimed and req.server is not None
                                and not req.server.is_alive()
                                and not req.event.is_set())
                    mine = not req.claimed or orphaned
                    req.claimed = True
                    if mine:
                        req.server = threading.current_thread()
                if mine:
                    self._run([req])  # forward OUTSIDE the lock
        if req.error is not None:
            raise req.error
        if deadline is not None and time.monotonic() > deadline:
            # result landed after the deadline: honour the contract
            self._count_timeout()
            raise InferenceTimeoutError(
                f"inference request missed its "
                f"{float(timeout_ms):.6g} ms deadline (late result "
                "discarded)")
        if self._restart_unconfirmed and not degraded:
            # the FIRST queued result after a restart proves the revived
            # collector is healthy: close the breaker exactly once
            self._restart_unconfirmed = False
            self._breaker.record_success()
        return req.result[0] if single else req.result

    def _direct(self, xs, multi, single):
        self.model_calls += 1
        out = _host(self.model.output(list(xs) if multi else xs[0]))
        return out[0] if single else out

    def _direct_deadline(self, xs, multi, single, deadline):
        """Direct serve with the deadline enforced AFTER the forward."""
        out = self._direct(xs, multi, single)
        if deadline is not None and time.monotonic() > deadline:
            self._count_timeout()
            raise InferenceTimeoutError(
                "inference request missed its deadline (direct forward "
                "finished late; result discarded)")
        return out

    def _count_timeout(self):
        self.timeouts += 1

    def _enqueue(self, req, deadline):
        bounded_enqueue(self._queue, req, deadline, self.enqueue_timeout,
                        count_timeout=self._count_timeout)

    def _cancel(self, req):
        """Deadline expiry: mark the request so no thread serves it (or,
        if already in flight, so its late result is discarded)."""
        with self._claim_lock:
            req.cancelled = True
            req.claimed = True
        self._count_timeout()

    def _revive_collector(self):
        """Restart a dead collector behind the circuit breaker. Each
        distinct thread death records ONE breaker failure; when the
        breaker is OPEN the restart is shed and the caller degrades to
        direct serving. Returns True when a live collector exists after
        the call."""
        with self._lifecycle_lock:
            if self._shutdown:
                return False
            t = self._thread
            if t is None or t.is_alive():
                return True
            if t is not self._last_dead:
                self._last_dead = t
                self._breaker.record_failure()
            if not self._breaker.allow():
                return False
            self._thread = self._start_collector()
            self.collector_restarts += 1
            self._restart_unconfirmed = True
        return True

    def _input_ranks(self):
        want = getattr(self.model, "_input_ranks", None)
        if want is None:
            want = self._infer_input_ranks()
            self.model._input_ranks = want
        return want

    def _needs_batch(self, xs):
        """True when xs holds ONE example (no batch dim): the FIRST
        input's rank equals the model's expected feature rank."""
        return xs[0].ndim == self._input_ranks()[0]

    def _infer_input_ranks(self):
        """Expected FEATURE rank (no batch dim) per model input."""
        from deeplearning4j_tpu_torch.nn.conf.inputs import (
            ConvolutionalType, RecurrentType)

        def rank(it):
            if isinstance(it, ConvolutionalType):
                return 3
            if isinstance(it, RecurrentType):
                return 2
            return 1

        conf = getattr(self.model, "conf", None)
        if conf is not None:
            node_types = getattr(conf, "node_output_types", None)
            input_names = getattr(conf, "input_names", None)
            if node_types and input_names:
                return [rank(node_types.get(n)) for n in input_names]
            return [rank(getattr(conf, "input_type", None))]
        return [1]

    # -- collector thread ------------------------------------------------
    def _collector(self):
        while not self._shutdown:
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            if first is None:
                break
            batch = [first]
            strays = []    # incompatible shapes: run AFTER the main batch
            total = first.x[0].shape[0]
            # admit queued requests into the next dispatch up to
            # batch_limit or a brief quiet period; whatever arrives during
            # the dispatch queues for the next
            while total < self.batch_limit:
                try:
                    nxt = self._queue.get(timeout=self.collect_timeout)
                except queue.Empty:
                    break
                if nxt is None:
                    self._shutdown = True
                    break
                if self._incompatible(nxt, first):
                    strays.append(nxt)
                    continue
                batch.append(nxt)
                total += nxt.x[0].shape[0]
            self._dispatch(batch)
            for s in strays:
                self._dispatch([s])

    @staticmethod
    def _incompatible(nxt, first):
        """Can nxt coalesce into first's dispatch? Exact feature-shape
        match of every input."""
        if len(nxt.x) != len(first.x):
            return True
        return any(a.shape[1:] != b.shape[1:] for a, b in zip(nxt.x,
                                                               first.x))

    def _dispatch(self, batch):
        """Claim-then-run: a request the fallback path already claimed
        (shutdown race) or that was cancelled at its deadline must not
        be served (twice / at all)."""
        with self._claim_lock:
            batch = [r for r in batch if not r.claimed and not r.cancelled]
            me = threading.current_thread()
            for r in batch:
                r.claimed = True
                r.server = me
        if batch:
            self._run(batch)

    def _run(self, batch):
        try:
            if self._ladder is not None and self._aot_breaker.allow():
                try:
                    self._serve_graphs(batch)
                    self._aot_breaker.record_success()
                    return
                except Exception as e:  # noqa: BLE001 — degrade, stay up
                    self._aot_error = e
                    self.aot_fallbacks += 1
                    self._aot_breaker.record_failure()
            self._serve(batch)
        except BaseException as e:  # noqa: BLE001 — deliver to the waiter
            # even KeyboardInterrupt/SystemExit must release the waiters
            # before propagating, or output() blocks forever
            err = e if isinstance(e, Exception) else RuntimeError(
                f"inference worker died: {type(e).__name__}: {e}")
            for r in batch:
                r.error = err
                r.event.set()
            if not isinstance(e, Exception):
                raise

    def _serve_graphs(self, batch):
        """The coalesced batch through the bucket graphs: split into
        ladder chunks, each padded to its bucket (copies of the last row,
        sliced away before delivery), staged into the bucket's static
        inputs and replayed. Each chunk's rows are copied out of the
        graph's static output before the next replay; results are
        delivered only after every chunk ran, so a failure part-way can
        still fall back to the eager path."""
        store = self._ensure_store()
        n_inputs = len(batch[0].x)
        cols = [np.concatenate([r.x[j] for r in batch], axis=0)
                for j in range(n_inputs)]
        parts, i = [], 0
        with self._graph_lock:
            for c in self._ladder.chunks(cols[0].shape[0]):
                b = self._ladder.bucket(c)
                chunk = [xj[i:i + c] for xj in cols]
                if b != c:
                    chunk = [np.concatenate(
                        [xj, np.repeat(xj[-1:], b - c, axis=0)], axis=0)
                        for xj in chunk]
                sig = tuple((tuple(xj.shape), "float32") for xj in chunk)
                self._ring.stage(chunk, store.ensure(sig))
                self.model_calls += 1
                parts.append(store.run(("forward", sig))[:c].clone())
                i += c
        out = torch.cat(parts).cpu().numpy()
        i = 0
        for r in batch:
            k = r.x[0].shape[0]
            r.result = out[i:i + k]
            i += k
        for r in batch:
            r.event.set()

    def _serve(self, batch):
        """One `model.output` per coalesced batch, batch dim padded to the
        next power of two (copies of the last row; sliced away before
        delivery)."""
        n_inputs = len(batch[0].x)
        cols = [np.concatenate([r.x[j] for r in batch], axis=0)
                for j in range(n_inputs)]
        n = cols[0].shape[0]
        nb = _bucket(n)
        if nb != n:
            cols = [np.concatenate(
                [xj, np.repeat(xj[-1:], nb - n, axis=0)], axis=0)
                for xj in cols]
        self.model_calls += 1
        out = _host(self.model.output(cols if n_inputs > 1 else cols[0]))
        out = out[:n]
        i = 0
        for r in batch:
            k = r.x[0].shape[0]
            r.result = out[i:i + k]
            i += k
            r.event.set()

    def shutdown(self):
        """Idempotent: the first call stops the collector and drains the
        queue (serving every live request, discarding cancelled ones);
        repeats are no-ops. Post-shutdown output() serves directly."""
        with self._lifecycle_lock:
            if self._shutdown:
                return
            self._shutdown = True
            t = self._thread
        if t is not None:
            try:
                self._queue.put_nowait(None)
            except queue.Full:
                pass
            t.join(timeout=5)
        # serve anything the collector left behind
        while True:
            try:
                r = self._queue.get_nowait()
            except queue.Empty:
                break
            if r is not None:
                self._dispatch([r])
