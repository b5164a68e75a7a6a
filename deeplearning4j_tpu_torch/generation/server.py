"""GenerationServer — continuous-batching autoregressive serving: the port
of `deeplearning4j_tpu/generation/server.py`, dense KV cache.

Long-lived requests share one fixed-size decode batch of `slots` slots. A
background decode thread runs decode BLOCKS of `superstep` steps for the
whole batch; new requests are admitted into free slots between blocks
(prefill + first sampled token) and finished ones retire, so shapes never
change but for the cache rung, which grows to the next of
`cache_lengths` when an admission needs more room.

A block is a Python loop of k decoder steps with fused per-slot sampling
(greedy / temperature / top-k, all per-slot tensors). Per-slot EOS/budget
halt masks freeze finished slots mid-block (frozen steps are computed but
emitted as -1 and never delivered), so a block equals k sequential steps.
The whole decode state (cache, positions, active mask, tokens, rng keys,
sampling knobs) stays on the device; the ONLY host syncs are one fetch of
the (k, S) token block per block and one of the first token per
admission.

Executable store: `warmup` adds the reference's closed key set to a
`runtime.executables.FunctionStore` — ("superstep", rung, k) per rung,
("admit", rung, p) per prompt bucket p <= rung, ("grow_to_<bigger>",
rung) per rung pair and ("retire",) — and on the card captures each into
a CUDA graph, so a decode block is one graph launch on the host. The
decode state lives in static tensors: one cache per rung, allocated at
warmup, and the per-slot columns. Host values (EOS and budget columns,
the admitted slot, prompt, key and sampling knobs, the retired slot)
enter static inputs through a `StagingRing`. `exec_cache_dir` keeps the
store's manifest of keys on disk; `cuda_graphs=False` runs the same
functions eagerly on the card (the reference the graphs are held to). On
the CPU they always run eagerly.

Each request's rng key is a pure function of (server seed, admission
order) (`_admit_key`, the JAX package's derivation), and sampling follows
JAX's threefry bit for bit, so streams match the JAX server's.

Not in this slice, each waiting for a later slice of the port: greedy
drafting (`draft`), paged KV, `adopt`, crash-replay and the supervised
restart (a decode-loop failure here latches `ServerDeadError`), the
memory-pressure ladder, the asynchronous token fetch, monitoring, the
replay key-advance executable, and `RecurrentDecoder`.
"""
from __future__ import annotations

import collections
import queue
import threading
import time
import weakref

import numpy as np
import torch

from deeplearning4j_tpu_torch.generation.sampling import (method_id,
                                                          sample_step)
from deeplearning4j_tpu_torch.parallel.inference import bounded_enqueue
from deeplearning4j_tpu_torch.resilience.errors import ServerDeadError
from deeplearning4j_tpu_torch.runtime.executables import (FunctionStore,
                                                          StagingRing)

__all__ = ["GenerationRequest", "GenerationServer", "status"]

_SERVERS = weakref.WeakSet()

#: per-slot decode-state columns
_POS, _ACTIVE, _TOKENS, _RNG, _METHOD, _TEMP, _TOPK = range(7)
#: the admit input's leading scalars, then the padded prompt
_A_SLOT, _A_PLEN, _A_KEY, _A_METHOD, _A_TOPK, _A_PROMPT = 0, 1, 2, 4, 5, 6

#: knobs of the JAX server that this slice does not port, with their
#: defaults there; any other value raises
_LATER = {
    "restart_policy": (None, "crash-replay and supervised restarts"),
    "max_consecutive_failures": (8, "crash-replay and supervised restarts"),
    "pressure_relief_steps": (256, "the memory-pressure ladder"),
    "pressure_relief_secs": (60.0, "the memory-pressure ladder"),
    "memory_high_water": (0.92, "the memory-pressure ladder"),
    "draft": (0, "greedy drafting"),
}


class GenerationRequest:
    """Handle for one submitted prompt: collects generated tokens,
    streams them (`stream()` / `on_token`), resolves via `result()`."""

    def __init__(self, prompt, max_new_tokens, eos_id, method,
                 temperature, top_k, on_token=None):
        self.prompt = prompt                  # np.int32 (plen,)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.method = method                  # sampling.GREEDY/SAMPLE
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.on_token = on_token
        self.tokens = []                      # generated token ids
        self.error = None
        self.finish_reason = None             # "eos" | "length" | "error"
        self._done = threading.Event()
        self._stream = queue.Queue()

    # -- server side ------------------------------------------------------
    def _push(self, tok):
        self.tokens.append(tok)
        self._stream.put(tok)
        if self.on_token is not None:
            try:
                self.on_token(tok)
            except Exception:  # noqa: BLE001 — a bad callback must not
                pass           # kill the shared decode loop

    def _finish(self, reason):
        self.finish_reason = reason
        self._done.set()
        self._stream.put(None)

    def _fail(self, exc):
        self.error = exc
        self._finish("error")

    # -- client side ------------------------------------------------------
    def done(self):
        return self._done.is_set()

    def result(self, timeout=None):
        """Block until the request finished; returns the generated
        token ids — when generation stopped on `eos_id`, the EOS token
        is the last element (finish_reason tells which case hit)."""
        if not self._done.wait(timeout):
            raise TimeoutError("generation request still in flight")
        if self.error is not None:
            raise self.error
        return list(self.tokens)

    def stream(self, timeout=None):
        """Yield tokens as they are generated (ends at EOS/length).
        `timeout` bounds the wait per token (TimeoutError on expiry).
        A server death pushes the terminal error at once."""
        while True:
            try:
                tok = self._stream.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(
                    "generation stream produced no token within the "
                    "timeout") from None
            if tok is None:
                if self.error is not None:
                    raise self.error
                return
            yield tok


class GenerationServer:
    """Continuous-batching KV-cache decode server over one model.

    `decoder`: a `generation.decode.BertDecoder`; the server runs on its
    device. `slots` is the decode batch; `cache_lengths` the cache rungs
    (prompt_len + max_new_tokens must fit the top rung); `prompt_buckets`
    the prefill length ladder; `superstep` the decode steps per block.
    `exec_cache_dir` holds the executable store's manifest; `cuda_graphs`
    (on the card) replays CUDA graphs, or runs the same functions eagerly
    when False."""

    def __init__(self, decoder, slots=4, cache_lengths=(128,),
                 prompt_buckets=None, method="greedy", temperature=1.0,
                 top_k=0, eos_id=None, max_new_tokens=64, seed=0,
                 queue_limit=256, enqueue_timeout_ms=100.0, superstep=1,
                 exec_cache_dir=None, cuda_graphs=True, **later):
        for name, value in later.items():
            if name not in _LATER:
                raise TypeError(f"unexpected keyword argument {name!r}")
            default, what = _LATER[name]
            if value != default:
                raise ValueError(
                    f"{name}={value!r} is not ported yet: {what} comes "
                    f"with a later slice of the serving port")
        if not hasattr(decoder, "init_cache"):
            raise NotImplementedError(
                "RecurrentDecoder (LSTM/GRU networks) is not ported yet; "
                "it comes with the nn/ slice — pass a BertDecoder")
        self.decoder = decoder
        self.device = decoder.device
        self.slots = int(slots)
        if self.slots < 1:
            raise ValueError("slots must be >= 1")
        self.superstep = int(superstep)
        if self.superstep < 1:
            raise ValueError("superstep must be >= 1")
        rungs = tuple(sorted({int(c) for c in cache_lengths}))
        if not rungs or rungs[0] < 2:
            raise ValueError(f"cache_lengths must be >= 2: {cache_lengths}")
        if rungs[-1] > decoder.max_cache_len:
            raise ValueError(
                f"top cache rung {rungs[-1]} exceeds the model's "
                f"maximum decodable length {decoder.max_cache_len}")
        self.cache_lengths = rungs
        if prompt_buckets is None:
            prompt_buckets, b = [], 8
            while b < rungs[-1]:
                prompt_buckets.append(b)
                b *= 2
            prompt_buckets.append(rungs[-1])
        self.prompt_buckets = tuple(sorted({int(p)
                                            for p in prompt_buckets}))
        if self.prompt_buckets[-1] > rungs[-1]:
            raise ValueError("prompt buckets cannot exceed the top "
                             "cache rung")
        self.default_method = method_id(method)
        self.default_temperature = float(temperature)
        self.default_top_k = int(top_k)
        self.default_eos_id = eos_id
        self.default_max_new_tokens = int(max_new_tokens)
        self.seed = int(seed)
        self.enqueue_timeout = float(enqueue_timeout_ms) / 1e3
        self.stats = {"tokens": 0, "steps": 0, "supersteps": 0,
                      "admissions": 0, "retirements": 0, "errors": 0}
        self.token_fetches = 0       # host syncs: one per block/admission
        self._queue = queue.Queue(maxsize=int(queue_limit))
        self._exec_cache_dir = exec_cache_dir
        self.cuda_graphs = bool(cuda_graphs)
        self._store = None           # FunctionStore, built at warmup
        self._ring = StagingRing(2)
        self._margs = None
        self._caches = None          # rung -> static K/V cache
        self._cols = None            # static per-slot columns
        self._rung = None
        self._slot_req = {}          # slot -> (request, admission id)
        self._latencies = collections.deque(maxlen=512)  # per-token ms
        self._free = list(range(self.slots))
        self._counter = 0            # admission counter (rng derivation)
        self._lock = threading.RLock()
        self._work = threading.Event()
        self._shutdown = False
        self._dead = None            # typed ServerDeadError once latched
        self._warm = False
        self._thread = None
        _SERVERS.add(self)

    # -- warmup (the capture boundary) -------------------------------------
    def warmup(self):
        """Build the kernels (on the card), allocate the static decode
        state (a cache per rung), add the closed key set to the executable
        store (on the card: capture a CUDA graph of each), and start the
        decode loop. Idempotent. Returns {compiled, from_disk, captures,
        nvcc_runs, seconds, executables}."""
        with self._lock:
            if self._warm:
                return {"compiled": 0, "from_disk": 0, "captures": 0,
                        "nvcc_runs": 0, "seconds": 0.0,
                        "executables": len(self._store)}
            t0 = time.perf_counter()
            nvcc = 0
            if self.device.type == "cuda":
                from deeplearning4j_tpu_torch.kernels import _build
                nvcc = _build.nvcc_runs
                _build.build_all()
                nvcc = _build.nvcc_runs - nvcc
            self._margs = tuple(self.decoder.model_args())
            s, dev, rungs = self.slots, self.device, self.cache_lengths

            def zeros(*shape, dtype=torch.int64):
                return torch.zeros(shape, dtype=dtype, device=dev)

            self._caches = {r: self.decoder.init_cache(s, r) for r in rungs}
            self._cols = [zeros(s), zeros(s, dtype=torch.bool), zeros(s),
                          zeros(s, 2), zeros(s),
                          zeros(s, dtype=torch.float32), zeros(s)]
            # static inputs: [eos; budget] of a block; an admission's
            # scalars and padded prompt, and its temperature; the retired
            # slot. The warm-up runs admit a one-token prompt into slot 0.
            self._block_in = zeros(2, s)
            self._admit_in = zeros(_A_PROMPT + self.prompt_buckets[-1])
            self._admit_in[_A_PLEN] = 1
            self._admit_temp = zeros(1, dtype=torch.float32)
            self._retire_in = zeros(1)
            # slots is part of every graph's shape but not of the keys, so
            # it is part of the store's identity
            store = FunctionStore(
                f"{self.decoder.fingerprint()}-s{s}", dev,
                directory=self._exec_cache_dir,
                capture=self.cuda_graphs and dev.type == "cuda")
            store.register("superstep", self._superstep)
            store.register("admit", self._admit_fn)
            store.register("retire", self._retire_fn)
            items = []
            for ci, rung in enumerate(rungs):
                items.append((("superstep", rung, self.superstep), (rung,)))
                items += [(("admit", rung, p), (rung, p))
                          for p in self.prompt_buckets if p <= rung]
                for bigger in rungs[ci + 1:]:
                    name = f"grow_to_{bigger}"
                    store.register(name, self._grow_fn)
                    items.append(((name, rung), (rung, bigger)))
            items.append((("retire",), ()))
            stats = store.warmup(items)
            self._store = store
            self._reset_state()
            self._rung = rungs[0]
            self._warm = True
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()
            stats.update(nvcc_runs=stats["nvcc_runs"] + nvcc,
                         seconds=time.perf_counter() - t0,
                         executables=len(store))
            return stats

    @torch.no_grad()
    def _reset_state(self):
        """The decode state as at start (the warm-up runs wrote into it):
        every cache and column 0, temperatures 1."""
        for cache in self._caches.values():
            for t in cache.values():
                t.zero_()
        for i, t in enumerate(self._cols):
            t.fill_(1 if i == _TEMP else 0)

    # -- device work: the store's functions ---------------------------------
    @torch.no_grad()
    def _superstep(self, rung):
        """k decode steps for all slots at cache rung `rung`. Per-slot halt
        masks freeze a slot the moment it samples its EOS token or
        exhausts its budget — frozen steps recompute the held token at
        the held position (idempotent cache writes, output -1). The
        static input holds `eos` (-1 for slots with no EOS) and `budget`
        (the tokens each slot may still emit). Returns the (k, S) token
        block, on the device."""
        cache = self._caches[rung]
        pos, active, tokens, rng, method, temp, topk = self._cols
        eos, budget = self._block_in[0], self._block_in[1]
        outs = []
        for _ in range(self.superstep):
            logits, cache = self.decoder.step(self._margs, cache, tokens,
                                              pos)
            sampled, rng = sample_step(logits, rng, method, temp, topk)
            outs.append(torch.where(active, sampled, -1))
            budget = budget - active.long()
            halt = (sampled == eos) | (budget <= 0)
            tokens = torch.where(active, sampled, tokens)
            pos = torch.where(active, pos + 1, pos)
            active = active & ~halt
        for col, new in zip(self._cols, (pos, active, tokens, rng)):
            col.copy_(new)
        return torch.stack(outs)

    @torch.no_grad()
    def _admit_fn(self, rung, p):
        """Prefill the staged prompt (bucket `p`) into the staged slot of
        rung `rung`'s cache, arm the slot's sampling knobs and rng key,
        and sample its first token. Returns it, (1,) on the device."""
        a = self._admit_in
        slot, plen = a[_A_SLOT:_A_SLOT + 1], a[_A_PLEN:_A_PLEN + 1]
        method, topk = a[_A_METHOD:_A_METHOD + 1], a[_A_TOPK:_A_TOPK + 1]
        _, logits = self.decoder.prefill(self._margs, self._caches[rung],
                                         slot, a[_A_PROMPT:_A_PROMPT + p],
                                         plen)
        first, key = sample_step(logits[None], a[None, _A_KEY:_A_KEY + 2],
                                 method, self._admit_temp, topk)
        pos, active, tokens, rng, m, temp, k = self._cols
        # scalars by index_fill_: an index write of a Python scalar copies
        # it from the host, which a capture refuses
        pos[slot] = plen
        active.index_fill_(0, slot, True)
        tokens[slot] = first
        rng[slot] = key
        m[slot] = method
        temp[slot] = self._admit_temp
        k[slot] = topk
        return first

    @torch.no_grad()
    def _retire_fn(self):
        """Clear the staged slot's position/active/token columns (cache
        rows need no clearing: the cache mask hides them)."""
        slot = self._retire_in
        for col in self._cols[_POS:_TOKENS + 1]:
            col.index_fill_(0, slot, 0)

    @torch.no_grad()
    def _grow_fn(self, rung, bigger):
        """Copy rung `rung`'s cache into rung `bigger`'s."""
        self.decoder.grow_into(self._caches[rung], self._caches[bigger])

    # -- client side ------------------------------------------------------
    def submit(self, prompt, max_new_tokens=None, eos_id="default",
               method=None, temperature=None, top_k=None, on_token=None,
               timeout_ms=None):
        """Queue one prompt for generation; returns a GenerationRequest
        immediately (tokens stream in as the decode loop reaches it).
        Admission is bounded: a full queue sheds with
        InferenceOverloadedError after the enqueue timeout; a dead
        server refuses with the latched ServerDeadError."""
        if not self._warm:
            self.warmup()
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must hold at least one token")
        if prompt.size > self.prompt_buckets[-1]:
            raise ValueError(
                f"prompt length {prompt.size} exceeds the top prompt "
                f"bucket {self.prompt_buckets[-1]}")
        max_new = (self.default_max_new_tokens if max_new_tokens is None
                   else int(max_new_tokens))
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if prompt.size + max_new > self.cache_lengths[-1]:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens ({max_new}) "
                f"exceeds the top cache rung {self.cache_lengths[-1]}")
        req = GenerationRequest(
            prompt, max_new,
            self.default_eos_id if eos_id == "default" else eos_id,
            self.default_method if method is None else method_id(method),
            (self.default_temperature if temperature is None
             else temperature),
            self.default_top_k if top_k is None else top_k,
            on_token=on_token)
        deadline = (None if timeout_ms is None
                    else time.monotonic() + float(timeout_ms) / 1e3)
        # liveness check + enqueue are ONE locked step: a request must
        # never land in the queue after shutdown()/_die() drained it
        with self._lock:
            if self._shutdown:
                raise RuntimeError("GenerationServer is shut down")
            if self._dead is not None:
                raise self._dead
            bounded_enqueue(self._queue, req, deadline,
                            self.enqueue_timeout, what="generation")
        self._work.set()
        return req

    def generate(self, prompt, timeout=None, **kw):
        """Blocking convenience: submit + result."""
        return self.submit(prompt, **kw).result(timeout=timeout)

    # -- decode loop ------------------------------------------------------
    def _loop(self):
        while not self._shutdown:
            try:
                self._admit_pending()
                if self._slot_req:
                    self._dispatch_block()
                elif self._work.wait(timeout=0.05):
                    self._work.clear()
            except Exception as e:  # noqa: BLE001 — latch, fail, report
                self.stats["errors"] += 1
                self._die(e)
                return

    def _admit_pending(self):
        """Admit queued requests into free slots of the in-flight batch —
        one prefill each (a longer request may first GROW the cache to
        the next rung)."""
        while self._free:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return
            self._counter += 1
            try:
                self._admit(req, self._counter)
            except Exception as e:
                if not any(r is req for r, _ in self._slot_req.values()):
                    req._fail(e)    # not registered: nothing else fails it
                raise

    def _admit(self, req, admit_id):
        plen = int(req.prompt.size)
        pbucket = next(p for p in self.prompt_buckets if p >= plen)
        needed = plen + req.max_new_tokens
        if needed > self._rung or pbucket > self._rung:
            rung = next(c for c in self.cache_lengths
                        if c >= needed and c >= pbucket)
            self._store.run((f"grow_to_{rung}", self._rung))
            self._rung = rung
        slot = self._free.pop()
        self._slot_req[slot] = (req, admit_id)
        ints = np.zeros(self._admit_in.shape, np.int64)
        ints[[_A_SLOT, _A_PLEN, _A_METHOD, _A_TOPK]] = (slot, plen,
                                                        req.method,
                                                        req.top_k)
        ints[_A_KEY:_A_KEY + 2] = self._admit_key(admit_id)
        ints[_A_PROMPT:_A_PROMPT + plen] = req.prompt
        self._ring.stage(
            [ints, np.array([req.temperature], np.float32)],
            [self._admit_in, self._admit_temp])
        first = self._store.run(("admit", self._rung, pbucket))
        first = int(self._fetch(first)[0])
        self.stats["admissions"] += 1
        self.stats["tokens"] += 1     # the prefill's first sampled token
        self._deliver(slot, req, first)

    def _admit_key(self, admit_id):
        """Per-request admission rng key: a pure function of
        (server seed, admission id) — the identity crash-replay re-derives."""
        return np.random.default_rng(
            (self.seed, admit_id)).integers(0, 2 ** 32, size=2,
                                            dtype=np.uint32)

    def _block_args(self):
        """Per-block [EOS; budget] columns from the host-side requests: -1
        for slots with no EOS (sampled ids are >= 0, so it never
        matches); budget = tokens the slot may still emit."""
        args = np.zeros((2, self.slots), np.int64)
        args[0] = -1
        for slot, (req, _) in self._slot_req.items():
            if req.eos_id is not None:
                args[0, slot] = req.eos_id
            args[1, slot] = max(req.max_new_tokens - len(req.tokens), 0)
        return args

    def _dispatch_block(self):
        """Run one decode block, fetch its (k, S) token block (THE host
        sync of the block) and deliver it step-major: -1 marks a
        frozen/empty lane."""
        t0 = time.perf_counter()
        self._ring.stage([self._block_args()], [self._block_in])
        toks = self._fetch(self._store.run(
            ("superstep", self._rung, self.superstep)))
        dt_ms = (time.perf_counter() - t0) * 1e3
        recs = dict(self._slot_req)
        live = 0
        for row in toks:
            for slot, rec in recs.items():
                tok = int(row[slot])
                if tok < 0 or self._slot_req.get(slot) is not rec:
                    continue
                live += 1
                self._deliver(slot, rec[0], tok)
        self.stats["steps"] += 1
        self.stats["tokens"] += live
        if self.superstep > 1:
            self.stats["supersteps"] += 1
        self._latencies.append(dt_ms / self.superstep)

    def _fetch(self, t):
        """Device → host copy of sampled tokens (synchronizes)."""
        self.token_fetches += 1
        return t.cpu().numpy()

    def _deliver(self, slot, req, tok):
        req._push(tok)
        reason = self._finished_reason(req)
        if reason is not None:
            self._retire_slot(slot, reason)

    @staticmethod
    def _finished_reason(req):
        if req.tokens and req.eos_id is not None \
                and req.tokens[-1] == req.eos_id:
            return "eos"
        if len(req.tokens) >= req.max_new_tokens:
            return "length"
        return None

    def _retire_slot(self, slot, reason):
        """Clear a slot's columns on the device and free it."""
        self._ring.stage([np.array([slot], np.int64)], [self._retire_in])
        self._store.run(("retire",))
        req, _ = self._slot_req.pop(slot)
        self._free.append(slot)
        self.stats["retirements"] += 1
        req._finish(reason)

    # -- failure / lifecycle ----------------------------------------------
    def _fail_open_requests(self, err):
        """Fail every in-flight request (caller holds the lock)."""
        for req, _ in list(self._slot_req.values()):
            if not req.done():
                req._fail(err)
        self._slot_req.clear()

    def _drain_queue(self, err):
        while True:
            try:
                self._queue.get_nowait()._fail(err)
            except queue.Empty:
                return

    def _die(self, cause, reason="decode loop died"):
        """Terminal: latch the typed ServerDeadError, refuse future
        submits, and fail every open request (in flight and queued) at
        once."""
        err = ServerDeadError(f"GenerationServer {reason}: {cause!r}")
        err.__cause__ = cause
        with self._lock:
            self._dead = err
            self._fail_open_requests(err)
        self._drain_queue(err)

    def shutdown(self):
        """Idempotent: stops the decode loop; in-flight and queued
        requests fail with a RuntimeError."""
        with self._lock:
            if self._shutdown:
                return
            self._shutdown = True
        self._work.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        err = RuntimeError("GenerationServer shut down")
        with self._lock:
            self._fail_open_requests(err)
            self._drain_queue(err)

    def __enter__(self):
        self.warmup()
        return self

    def __exit__(self, *exc):
        self.shutdown()

    def serving_state(self):
        if self._shutdown:
            state = "shutdown"
        elif self._dead is not None:
            state = "dead"
        else:
            state = "serving" if self._warm else "cold"
        return {"state": state, "active_slots": len(self._slot_req)}

    def _latency_percentiles(self):
        """Per-token latency p50/p99 (ms) over the recent decode blocks
        (block wall / block steps)."""
        if not self._latencies:
            return {"per_token_p50_ms": None, "per_token_p99_ms": None}
        p50, p99 = np.percentile(list(self._latencies), [50, 99])
        return {"per_token_p50_ms": float(p50),
                "per_token_p99_ms": float(p99)}

    def status(self):
        dispatches = self.stats["steps"] + self.stats["admissions"]
        return {
            "decoder": type(self.decoder).__name__,
            "device": str(self.device),
            "slots": self.slots,
            "cache_lengths": list(self.cache_lengths),
            "rung": self._rung,
            "prompt_buckets": list(self.prompt_buckets),
            "superstep": self.superstep,
            "cuda_graphs": self._store is not None and self._store.capture,
            "executables": (None if self._store is None
                            else self._store.status()),
            "queued": self._queue.qsize(),
            "warm": self._warm,
            "token_fetches": self.token_fetches,
            "tokens_per_dispatch": (self.stats["tokens"] / dispatches
                                    if dispatches else None),
            "host_syncs_per_token": (self.token_fetches
                                     / self.stats["tokens"]
                                     if self.stats["tokens"] else None),
            **self._latency_percentiles(),
            **self.serving_state(),
            **self.stats,
        }


def status():
    """Aggregate generation status for every live server."""
    return {"servers": [s.status() for s in list(_SERVERS)]}
