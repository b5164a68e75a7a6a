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

Each request's rng key is a pure function of (server seed, admission
order) (`_admit_key`, the JAX package's derivation), and sampling follows
JAX's threefry bit for bit, so streams match the JAX server's.

Not in this slice, each waiting for a later slice of the port: greedy
drafting (`draft`), paged KV, `adopt`, crash-replay and the supervised
restart (a decode-loop failure here latches `ServerDeadError`), the
memory-pressure ladder, the executable store (`exec_cache_dir`), the
asynchronous token fetch, monitoring, and `RecurrentDecoder`.
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

__all__ = ["GenerationRequest", "GenerationServer", "status"]

_SERVERS = weakref.WeakSet()

#: decode-state tuple layout
_CACHE, _POS, _ACTIVE, _TOKENS, _RNG, _METHOD, _TEMP, _TOPK = range(8)

#: knobs of the JAX server that this slice does not port, with their
#: defaults there; any other value raises
_LATER = {
    "exec_cache_dir": (None, "the executable store"),
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
    the prefill length ladder; `superstep` the decode steps per block."""

    def __init__(self, decoder, slots=4, cache_lengths=(128,),
                 prompt_buckets=None, method="greedy", temperature=1.0,
                 top_k=0, eos_id=None, max_new_tokens=64, seed=0,
                 queue_limit=256, enqueue_timeout_ms=100.0, superstep=1,
                 **later):
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
        self._margs = None
        self._state = None
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

    # -- warmup -----------------------------------------------------------
    def warmup(self):
        """Build the kernels (on the card), initialize the decode state at
        the smallest rung, and start the decode loop. Idempotent."""
        with self._lock:
            if self._warm:
                return {"seconds": 0.0}
            t0 = time.perf_counter()
            if self.device.type == "cuda":
                from deeplearning4j_tpu_torch.kernels import _build
                _build.build_all()
            self._margs = tuple(self.decoder.model_args())
            self._rung = self.cache_lengths[0]
            self._state = self._init_state(self._rung)
            self._warm = True
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()
            return {"seconds": time.perf_counter() - t0}

    def _init_state(self, rung):
        s, dev = self.slots, self.device

        def zeros(dtype):
            return torch.zeros((s,), dtype=dtype, device=dev)

        return [self.decoder.init_cache(s, rung), zeros(torch.int64),
                zeros(torch.bool), zeros(torch.int64),
                torch.zeros((s, 2), dtype=torch.int64, device=dev),
                zeros(torch.int64),
                torch.ones((s,), dtype=torch.float32, device=dev),
                zeros(torch.int64)]

    # -- device work ------------------------------------------------------
    @torch.no_grad()
    def _run_block(self, eos, budget):
        """k decode steps for all slots. Per-slot halt masks freeze a slot
        the moment it samples its EOS token or exhausts its budget —
        frozen steps recompute the held token at the held position
        (idempotent cache writes, output -1). `eos` is -1 for slots with
        no EOS; `budget` the per-slot count of tokens the block may still
        emit. Returns the (k, S) token block, on the device."""
        st = self._state
        cache, pos, active, tokens, rng = st[_CACHE:_RNG + 1]
        method, temp, topk = st[_METHOD], st[_TEMP], st[_TOPK]
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
        st[_CACHE:_RNG + 1] = [cache, pos, active, tokens, rng]
        return torch.stack(outs)

    @torch.no_grad()
    def _prefill_slot(self, slot, padded, plen, key, req):
        """Prefill one prompt into `slot`, arm the slot's sampling config
        and rng key, and sample its first token (on the device)."""
        st, dev = self._state, self.device
        st[_CACHE], logits = self.decoder.prefill(
            self._margs, st[_CACHE], slot,
            torch.as_tensor(padded, dtype=torch.int64, device=dev), plen)
        m = torch.tensor([req.method], device=dev)
        t = torch.tensor([req.temperature], dtype=torch.float32, device=dev)
        k = torch.tensor([req.top_k], device=dev)
        key = torch.as_tensor(key.astype(np.int64), device=dev)[None]
        first, key2 = sample_step(logits[None], key, m, t, k)
        st[_POS][slot] = plen
        st[_ACTIVE][slot] = True
        st[_TOKENS][slot] = first[0]
        st[_RNG][slot] = key2[0]
        st[_METHOD][slot] = m[0]
        st[_TEMP][slot] = t[0]
        st[_TOPK][slot] = k[0]
        return first[0]

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
            st = self._state
            st[_CACHE] = self.decoder.grow(st[_CACHE], rung)
            self._rung = rung
        slot = self._free.pop()
        self._slot_req[slot] = (req, admit_id)
        padded = np.zeros((pbucket,), np.int32)
        padded[:plen] = req.prompt
        first = self._prefill_slot(slot, padded, plen,
                                   self._admit_key(admit_id), req)
        first = int(self._fetch(first))
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
        """Per-block EOS/budget columns from the host-side requests: -1
        for slots with no EOS (sampled ids are >= 0, so it never
        matches); budget = tokens the slot may still emit."""
        eos = np.full((self.slots,), -1, np.int64)
        budget = np.zeros((self.slots,), np.int64)
        for slot, (req, _) in self._slot_req.items():
            if req.eos_id is not None:
                eos[slot] = req.eos_id
            budget[slot] = max(req.max_new_tokens - len(req.tokens), 0)
        dev = self.device
        return (torch.as_tensor(eos, device=dev),
                torch.as_tensor(budget, device=dev))

    def _dispatch_block(self):
        """Run one decode block, fetch its (k, S) token block (THE host
        sync of the block) and deliver it step-major: -1 marks a
        frozen/empty lane."""
        t0 = time.perf_counter()
        toks = self._fetch(self._run_block(*self._block_args()))
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
        """Clear a slot's position/active/token columns (cache rows need
        no clearing: the cache mask hides them) and free it."""
        st = self._state
        st[_POS][slot] = 0
        st[_ACTIVE][slot] = False
        st[_TOKENS][slot] = 0
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
