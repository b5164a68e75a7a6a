"""GenerationServer — continuous-batching autoregressive serving: the port
of `deeplearning4j_tpu/generation/server.py`.

Long-lived requests share one fixed-size decode batch of `slots` slots. A
background decode thread runs decode BLOCKS for the whole batch — a
superstep of `superstep` steps, or with `draft=d` one greedy-drafting
verify round — and new requests are admitted into free slots between
blocks (prefill + first sampled token) and finished ones retire, so shapes
never change but for the cache rung, which grows to the next of
`cache_lengths` when an admission needs more room.

A superstep is a Python loop of k decoder steps with fused per-slot
sampling (greedy / temperature / top-k, all per-slot tensors). Per-slot
EOS/budget halt masks freeze finished slots mid-block (frozen steps are
computed but emitted as -1 and never delivered), so a block equals k
sequential steps. The whole decode state (cache, positions, active mask,
tokens, rng keys, sampling knobs) stays on the device; the ONLY host syncs
are one fetch of each block's (k, S) tokens and one of the first token per
admission.

Asynchronous token fetch: right after a block's dispatch its tokens start
a `non_blocking` copy into one of two pinned host buffers, on the stream
the replays run on (so no later replay overwrites the graph's output
before the copy lands), and block n is delivered while block n+1 runs. A
block's EOS/budget columns are built before the block ahead of it is
delivered, so they may over-allow by one block: the surplus is computed
but never delivered, and EOS retirement may lag up to two blocks.

Greedy drafting (`draft=d`): the host proposes up to d tokens per greedy
slot (prompt-lookup n-gram over the request's own history, the round
ahead delivered first, so a round does not overlap the fetch), and one
("verify", rung, d) call runs the q-block [current, draft...] through
`BertDecoder.verify` and delivers the longest prefix of drafts that match
the model's own argmax, plus the model's next token: streams are the
undrafted greedy streams. Non-greedy slots advance exactly one sampled
token per round (one rng split).

Paged KV (a decoder built with `page_size`/`pool_pages`): the cache is one
pool of pages shared by all slots, and the host `PageAllocator`
(`generation/paging.py`) maps prompts onto pages between dispatches, with
hash-of-prefix sharing and copy-on-write. Admission stages the prefill's
write-redirect row; a block stages its page table at the rung's width,
after each copy-on-write ran as a ("page_copy",) call. Growth is a
host-side relabel of the rung (no grow keys). A request the pool cannot
hold at admission fails with `PagePoolExhaustedError` before dispatch and
the server keeps serving; retiring a slot frees its private pages, while
shared prefix pages stay resident cold. Coverage uses each record's
`disp_pos`, the host's upper bound of rows dispatched, so the allocator
never reads the device's positions. An int8 decoder (`kv_dtype="int8"`)
is served through the same keys.

Executable store: `warmup` adds the reference's closed key set to a
`runtime.executables.FunctionStore` — ("superstep", rung, k) or
("verify", rung, d) per rung, ("admit", rung, p) per prompt bucket
p <= rung, ("grow_to_<bigger>", rung) per rung pair (dense) or
("page_copy",) (paged), and ("retire",) — and on the card captures each
into a CUDA graph, so a decode block is one graph launch on the host. The
decode state lives in static tensors: one cache per rung (or the pool),
allocated at warmup, and the per-slot columns. Host values (EOS and budget
columns, page tables, drafts, the admitted slot, prompt, key, sampling
knobs and write-redirect row, the retired slot, the copied pages) enter
static inputs through a `StagingRing`. `exec_cache_dir` keeps the store's
manifest of keys on disk; `cuda_graphs=False` runs the same functions
eagerly on the card (the reference the graphs are held to). On the CPU
they always run eagerly.

Each request's rng key is a pure function of (server seed, admission
order) (`_admit_key`, the JAX package's derivation), and sampling follows
JAX's threefry bit for bit, so streams match the JAX server's.

Survivability (the JAX server's, on the same journal):

- **Crash-replay.** Every admitted request carries a host-side journal
  (`_SlotJournal`: admission id → rng key; the prompt, sampling config
  and delivered tokens live on the request). A decode-loop failure does
  not fail the batch: the block in flight is dropped (its copy waited
  for, its tokens never delivered), the static decode state is reset in
  place (graphs read fixed addresses, so nothing is reallocated and
  nothing is captured again), and every surviving request is re-admitted
  through the warm store — by re-prefilling prompt + delivered prefix
  with the admission key advanced past the consumed splits when the
  prefix fits a prompt bucket, else by regenerating the prefix from the
  original admission with delivery suppressed (`ReplayDivergedError` on
  a mismatch). Either way the continuation is token-identical to an
  uninterrupted run. `adopt(req, admit_id)` admits a request under an
  explicit admission id through the same path (fleet failover).
- **Supervised restart.** A recovery that itself fails is retried from
  the warm store under `restart_policy` (a bounded `RetryPolicy`); an
  exhausted budget, or `max_consecutive_failures` incidents without a
  delivered token, latches the typed `ServerDeadError`, pushed to every
  open stream at once.
- **Memory-pressure ladder.** An OOM-classified failure, or device
  memory past `memory_high_water` (`monitoring/memory.py`), degrades
  stepwise: refuse growth, shed the queue, (paged) evict cold prefix
  pages, cap the rung one smaller; `pressure_relief_steps` clean tokens
  or `pressure_relief_secs` of quiet relieve one level. Every rung's
  cache (or the pool) is allocated at warm-up, so a cap frees no device
  memory here; it bounds which rung admissions may use.

Monitoring (`monitoring/`, off by default) counts the JAX server's
`dl4j.gen.*` series and emits its events, and each request carries its
timeline (`GenerationRequest.trace`); with monitoring off the hot path
pays one `enabled()` or `is None` branch a site. Fault sites
(`resilience/faults.py`): `generation.step`, `generation.superstep`,
`generation.admit`, `cache.grow` and `cache.page`, each one
module-attribute check when no plan is installed.

`RecurrentDecoder` (LSTM/GRU networks) is not ported yet.
"""
from __future__ import annotations

import collections
import queue
import threading
import time
import weakref

import numpy as np
import torch

from deeplearning4j_tpu_torch import monitoring as _mon
from deeplearning4j_tpu_torch.generation.paging import PageAllocator
from deeplearning4j_tpu_torch.generation.sampling import (GREEDY, method_id,
                                                          sample_step,
                                                          threefry2x32)
from deeplearning4j_tpu_torch.monitoring import events as _events
from deeplearning4j_tpu_torch.monitoring import memory as _mem
from deeplearning4j_tpu_torch.monitoring import requests as _req
from deeplearning4j_tpu_torch.parallel.inference import bounded_enqueue
from deeplearning4j_tpu_torch.resilience import faults as _faults
from deeplearning4j_tpu_torch.resilience.errors import (
    InferenceOverloadedError, InferenceTimeoutError, MemoryPressureError,
    PagePoolExhaustedError, ReplayDivergedError, ServerDeadError)
from deeplearning4j_tpu_torch.resilience.policy import RetryPolicy
from deeplearning4j_tpu_torch.runtime.executables import (FunctionStore,
                                                          StagingRing)
from deeplearning4j_tpu_torch.util.crash_reporting import CrashReportingUtil

__all__ = ["GenerationRequest", "GenerationServer", "status"]

_SERVERS = weakref.WeakSet()

#: keys of the reference's closed set that run on the host here
_HOST_KEYS = (("advance_key_n",),)

#: per-slot decode-state columns
_POS, _ACTIVE, _TOKENS, _RNG, _METHOD, _TEMP, _TOPK = range(7)
#: the admit input's leading scalars, then the padded prompt
_A_SLOT, _A_PLEN, _A_KEY, _A_METHOD, _A_TOPK, _A_PROMPT = 0, 1, 2, 4, 5, 6


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
        #: request-scoped tracing (monitoring/requests.py): None with
        #: monitoring off — every append below is one is-None branch
        self.trace = None
        self.trace_id = None
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
        if self.trace is not None:
            self.trace.event("retire", reason=reason,
                             tokens=len(self.tokens))
            self.trace.finish(reason)
        self._done.set()
        self._stream.put(None)

    def _fail(self, exc):
        self.error = exc
        if self.trace is not None:
            self.trace.event("failed", error=type(exc).__name__)
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


class _SlotJournal:
    """Host-side crash-replay journal for one admitted request.

    `admit_id` (the admission counter value) derives the slot's rng key;
    the prompt, sampling config and delivered tokens live on the request
    itself — together they make the token stream a pure function of this
    record, which is what `_replay_one` needs to continue an interrupted
    request token for token. While a regenerating replay is in flight,
    `expect` holds the already-delivered prefix and `replay_idx` the
    suppression cursor. `disp_pos` (paged servers) is the host's upper
    bound of the KV rows whose writes have been dispatched: the allocator
    covers `[disp_pos, disp_pos + k)` before each block, so live writes
    always land on mapped private pages without reading the device's
    `pos`."""

    __slots__ = ("req", "admit_id", "expect", "replay_idx", "disp_pos")

    def __init__(self, req, admit_id):
        self.req = req
        self.admit_id = admit_id
        self.expect = None
        self.replay_idx = 0
        self.disp_pos = 0


def _queued_req(item):
    """The GenerationRequest behind one admission-queue entry: adopted
    records (`adopt()`) ride the queue as their `_SlotJournal`, local
    submits as the bare request — drain and shed must fail either form."""
    return item.req if isinstance(item, _SlotJournal) else item


class _Block:
    """One dispatched block: its token fetch in flight, the slot → journal
    map at dispatch (delivery never hands a token to a slot re-admitted
    since), its depth k, its dispatch time and the time its copy started
    (the fetch-overlap window; None with monitoring off), and the per-slot
    draft counts (drafting rounds only)."""

    __slots__ = ("tokens", "recs", "k", "t0", "t_copy", "proposed")

    def __init__(self, tokens, recs, k, t0, t_copy, proposed=None):
        self.tokens = tokens
        self.recs = recs
        self.k = k
        self.t0 = t0
        self.t_copy = t_copy
        self.proposed = proposed


def _ngram_propose(history, nd, n=3):
    """Prompt-lookup drafting: the `nd` tokens that followed the most
    recent PREVIOUS occurrence of the history's trailing n-gram (falling
    back to shorter grams down to a unigram). A wrong proposal costs only
    masked lanes of one verify call; only exact greedy matches are ever
    delivered."""
    h = np.array(history, np.int64)
    t = len(h)
    for g in range(min(n, t - 1), 0, -1):
        gram = h[t - g:]
        # all candidate windows end before the trailing gram starts
        wins = np.lib.stride_tricks.sliding_window_view(h[:t - 1], g)
        hits = np.flatnonzero((wins == gram).all(axis=1))
        if len(hits):
            j = int(hits[-1])       # rightmost = freshest context wins
            tail = h[j + g:j + g + nd]
            if len(tail):
                return tail
    return h[:0]


class GenerationServer:
    """Continuous-batching KV-cache decode server over one model.

    `decoder`: a `generation.decode.BertDecoder` (dense or paged, fp or
    int8); the server runs on its device. `slots` is the decode batch;
    `cache_lengths` the cache rungs (prompt_len + max_new_tokens must fit
    the top rung; whole pages when paged); `prompt_buckets` the prefill
    length ladder; `superstep` the decode steps per block; `draft` the
    draft tokens a greedy-drafting round verifies (0: off; needs
    superstep 1 and an fp decoder). `exec_cache_dir` holds the executable
    store's manifest; `cuda_graphs` (on the card) replays CUDA graphs, or
    runs the same functions eagerly when False.

    Survivability knobs, the JAX server's: `restart_policy` bounds
    supervised restarts after a failed recovery (default 3 attempts,
    short backoff); `max_consecutive_failures` bounds crash-recover churn
    with zero forward progress; `pressure_relief_steps` clean decode
    tokens — or `pressure_relief_secs` of wall-clock quiet, whichever
    first — decay one memory-pressure level; `memory_high_water`
    (fraction of device memory, None disables) refuses cache growth from
    the `monitoring/memory.py` telemetry (reported 'degraded' while it
    lasts)."""

    def __init__(self, decoder, slots=4, cache_lengths=(128,),
                 prompt_buckets=None, method="greedy", temperature=1.0,
                 top_k=0, eos_id=None, max_new_tokens=64, seed=0,
                 queue_limit=256, enqueue_timeout_ms=100.0,
                 exec_cache_dir=None, restart_policy=None,
                 max_consecutive_failures=8, pressure_relief_steps=256,
                 pressure_relief_secs=60.0, memory_high_water=0.92,
                 superstep=1, draft=0, cuda_graphs=True):
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
        self.draft = int(draft)
        if self.draft < 0:
            raise ValueError("draft must be >= 0")
        if self.draft and self.superstep > 1:
            raise ValueError(
                "draft and superstep > 1 are alternative decode fast "
                "paths — a drafting round already amortizes the dispatch "
                "over up to draft+1 tokens; pick one")
        if self.draft and not getattr(decoder, "supports_draft", False):
            raise ValueError(
                f"{type(decoder).__name__} has no draft-verify forward "
                "(greedy drafting needs the multi-query `verify` path — "
                "BertDecoder with kv_dtype='fp')")
        rungs = tuple(sorted({int(c) for c in cache_lengths}))
        if not rungs or rungs[0] < 2:
            raise ValueError(f"cache_lengths must be >= 2: {cache_lengths}")
        if rungs[-1] > decoder.max_cache_len:
            raise ValueError(
                f"top cache rung {rungs[-1]} exceeds the model's "
                f"maximum decodable length {decoder.max_cache_len}")
        self.cache_lengths = rungs
        self.paged = bool(getattr(decoder, "paged", False))
        self._pages = None
        if self.paged:
            ps = int(decoder.page_size)
            bad = [c for c in rungs if c % ps]
            if bad:
                raise ValueError(
                    f"paged decode needs cache rungs divisible by the page "
                    f"size {ps}: {bad}")
            self._pages = PageAllocator(decoder.pool_pages, ps)
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
        # a caller-supplied policy sets the budget/backoff knobs but is
        # never mutated (it may be shared): the supervisor runs a private
        # clone whose classifier is the server's own _restartable
        rp = restart_policy or RetryPolicy(
            max_attempts=3, initial_backoff=0.02, max_backoff=0.5)
        self.restart_policy = RetryPolicy(
            max_attempts=rp.max_attempts,
            initial_backoff=rp.initial_backoff,
            max_backoff=rp.max_backoff, multiplier=rp.multiplier,
            jitter=rp.jitter, deadline=rp.deadline, seed=self.seed,
            sleep=rp._sleep, clock=rp._clock,
            classifier=self._restartable)
        self.max_consecutive_failures = int(max_consecutive_failures)
        self.pressure_relief_steps = int(pressure_relief_steps)
        # wall-clock decay: a server whose remaining traffic is all
        # refused (or that idles) takes no decode steps
        self.pressure_relief_secs = (None if pressure_relief_secs is None
                                     else float(pressure_relief_secs))
        self.memory_high_water = (None if memory_high_water is None
                                  else float(memory_high_water))
        self.stats = {"tokens": 0, "steps": 0, "supersteps": 0,
                      "admissions": 0, "retirements": 0, "errors": 0,
                      "replays": 0, "restarts": 0, "degradations": 0,
                      "draft_accepts": 0, "draft_rejects": 0,
                      "blocks_dropped": 0}
        # host syncs: one per delivered block, admission and replay (a
        # block dropped at a fault is waited for but never fetched)
        self.token_fetches = 0
        self.key_advances = 0        # prefix replays' host key advances
        self._queue = queue.Queue(maxsize=int(queue_limit))
        self._exec_cache_dir = exec_cache_dir
        self.cuda_graphs = bool(cuda_graphs)
        self._store = None           # FunctionStore, built at warmup
        self._ring = StagingRing(2)
        self._margs = None
        self._caches = None          # rung -> static cache (paged: the pool)
        self._cols = None            # static per-slot columns
        self._fetch_ring = []        # [pinned token buffer, event] x 2
        self._fetch_next = 0
        self._rung = None
        self._slot_req = {}          # slot -> _SlotJournal
        self._inflight = None        # _Block dispatched, not delivered
        self._latencies = collections.deque(maxlen=512)  # per-token ms
        self._replaying = []         # journals awaiting re-admission
        self._free = list(range(self.slots))
        self._counter = 0            # admission counter (rng derivation)
        # RLock: recovery replays deliveries (user on_token callbacks)
        # under the lock; a callback calling submit() must not deadlock
        self._lock = threading.RLock()
        self._work = threading.Event()
        self._shutdown = False
        self._dead = None            # typed ServerDeadError once latched
        self._pressure = 0           # ladder level (0..3; paged 0..4)
        self._page_counts = {"prefix_hits": 0, "evictions": 0}
        self._rung_cap = None        # growth cap while under pressure
        self._clean_steps = 0        # tokens since the last OOM event
        self._pressure_ts = 0.0      # monotonic time of last escalation
        self._consecutive_failures = 0   # incidents without a delivery
        self._warm = False
        self._thread = None
        self._corr = "genserver-%x" % id(self)   # ops-event incident key
        _SERVERS.add(self)

    @property
    def _block_depth(self):
        """Tokens a block may deliver per slot: the superstep, or the
        current token plus the drafts of a verify round."""
        return self.draft + 1 if self.draft else self.superstep

    # -- warmup (the capture boundary) -------------------------------------
    def warmup(self):
        """Build the kernels (on the card), allocate the static decode
        state (a cache per rung, or the page pool), add the closed key set
        to the executable store (on the card: capture a CUDA graph of
        each), and start the decode loop. Idempotent. Returns {compiled, from_disk, captures,
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
                self._fetch_ring = [
                    [torch.empty((self._block_depth, self.slots),
                                 dtype=torch.int64, pin_memory=True), None]
                    for _ in range(2)]
            self._margs = tuple(self.decoder.model_args())
            s, dev, rungs = self.slots, self.device, self.cache_lengths
            paged = self._pages is not None

            def zeros(*shape, dtype=torch.int64):
                return torch.zeros(shape, dtype=dtype, device=dev)

            if paged:
                pool = self.decoder.init_cache(s, rungs[0])
                self._caches = {r: pool for r in rungs}
                ps = self.decoder.page_size
                self._ptab_in = {r: zeros(s, r // ps) for r in rungs}
                self._wrow_in = {p: zeros(-(-p // ps))
                                 for p in self.prompt_buckets}
                self._copy_in = zeros(2)
            else:
                self._caches = {r: self.decoder.init_cache(s, r)
                                for r in rungs}
            self._cols = [zeros(s), zeros(s, dtype=torch.bool), zeros(s),
                          zeros(s, 2), zeros(s),
                          zeros(s, dtype=torch.float32), zeros(s)]
            # static inputs: [eos; budget] of a block (and its drafts); an
            # admission's scalars and padded prompt, and its temperature;
            # the retired slot. The warm-up runs admit a one-token prompt
            # into slot 0, through page 0 when paged.
            self._block_in = zeros(2, s)
            if self.draft:
                self._draft_in = zeros(s, self.draft)
                self._dlen_in = zeros(s)
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
            store.register("verify", self._verify_fn)
            store.register("admit", self._admit_fn)
            store.register("retire", self._retire_fn)
            items = []
            for ci, rung in enumerate(rungs):
                if self.draft:
                    items.append((("verify", rung, self.draft),
                                  (rung, self.draft)))
                else:
                    items.append((("superstep", rung, self.superstep),
                                  (rung,)))
                items += [(("admit", rung, p), (rung, p))
                          for p in self.prompt_buckets if p <= rung]
                if paged:
                    # the pool is rung-independent: growth is a host-side
                    # relabel of the rung, no grow keys exist
                    continue
                for bigger in rungs[ci + 1:]:
                    name = f"grow_to_{bigger}"
                    store.register(name, self._grow_fn)
                    items.append(((name, rung), (rung, bigger)))
            items.append((("retire",), ()))
            if paged:
                store.register("page_copy", self._page_copy_fn)
                items.append((("page_copy",), ()))
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

    def executable_keys(self):
        """The closed key set: the store's keys, and the reference's
        ("advance_key_n",), which here runs on the host (`_advance_key`)
        and is never captured."""
        return set(self._store._entries) | set(_HOST_KEYS)

    @torch.no_grad()
    def _reset_state(self):
        """The decode state as at start (the warm-up runs wrote into it):
        every cache at its initial values, every column 0, temperatures
        1."""
        for cache in {id(c): c for c in self._caches.values()}.values():
            self.decoder.reset_cache(cache)
        for i, t in enumerate(self._cols):
            t.fill_(1 if i == _TEMP else 0)

    # -- device work: the store's functions ---------------------------------
    def _page_table(self, rung):
        """The staged page table of rung `rung`, as the decoder's trailing
        argument: () when not paged."""
        return () if self._pages is None else (self._ptab_in[rung],)

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
        ptab = self._page_table(rung)
        pos, active, tokens, rng, method, temp, topk = self._cols
        eos, budget = self._block_in[0], self._block_in[1]
        outs = []
        for _ in range(self.superstep):
            logits, cache = self.decoder.step(self._margs, cache, tokens,
                                              pos, *ptab)
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
    def _verify_fn(self, rung, nd):
        """One greedy-drafting round: `BertDecoder.verify` scores the
        q-block [current, draft...] of every slot, and each slot delivers
        the longest prefix of its drafts that equal the model's own argmax,
        plus the model's next token — every delivered token IS the
        undrafted greedy token. Position 0 samples with the slot's own
        config (one rng split a round), so a non-greedy slot, which the
        host gives no drafts, delivers exactly its one sampled token. EOS
        and budget truncate the delivered prefix and freeze the slot.
        Returns the (d, S) token block (-1: not delivered)."""
        d = nd + 1
        pos, active, tokens, rng, method, temp, topk = self._cols
        eos, budget = self._block_in[0], self._block_in[1]
        draft, dlen = self._draft_in, self._dlen_in
        logits, _ = self.decoder.verify(self._margs, self._caches[rung],
                                        tokens, pos, draft,
                                        *self._page_table(rung))
        greedy = logits.argmax(dim=-1)                      # (S, d)
        first, rng = sample_step(logits[:, 0], rng, method, temp, topk)
        cand = torch.cat([first[:, None], greedy[:, 1:]], dim=1)
        js = torch.arange(d, device=pos.device)[None, :]
        # draft j is consumed iff every draft up to j matched (prefix rule)
        ok = (js[:, :nd] < dlen[:, None]) & (cand[:, :nd] == draft)
        m = torch.cumprod(ok.long(), dim=1).sum(dim=1)
        deliver = (js <= m[:, None]) & (js < budget[:, None])
        # stop AFTER the first delivered EOS (it is itself emitted)
        is_eos = (deliver & (cand == eos[:, None])).long()
        deliver = deliver & (torch.cumsum(is_eos, dim=1) - is_eos == 0) \
            & active[:, None]
        ndel = deliver.sum(dim=1)
        last = cand.gather(1, (ndel - 1).clamp(0, d - 1)[:, None])[:, 0]
        new = (pos + ndel,
               active & ~((is_eos > 0).any(dim=1) | (budget - ndel <= 0)),
               torch.where(ndel > 0, last, tokens), rng)
        for col, value in zip(self._cols, new):
            col.copy_(value)
        return torch.where(deliver, cand, -1).T.contiguous()

    @torch.no_grad()
    def _admit_fn(self, rung, p):
        """Prefill the staged prompt (bucket `p`) into the staged slot of
        rung `rung`'s cache (paged: through the staged write-redirect row),
        arm the slot's sampling knobs and rng key, and sample its first
        token. Returns it, (1,) on the device."""
        a = self._admit_in
        slot, plen = a[_A_SLOT:_A_SLOT + 1], a[_A_PLEN:_A_PLEN + 1]
        method, topk = a[_A_METHOD:_A_METHOD + 1], a[_A_TOPK:_A_TOPK + 1]
        wrow = () if self._pages is None else (self._wrow_in[p],)
        _, logits = self.decoder.prefill(self._margs, self._caches[rung],
                                         slot, a[_A_PROMPT:_A_PROMPT + p],
                                         plen, *wrow)
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

    @torch.no_grad()
    def _page_copy_fn(self):
        """Copy-on-write: the staged page `src` over page `dst` of the
        pool (every rung's cache is the pool)."""
        self.decoder.page_copy(self._caches[self.cache_lengths[0]],
                               self._copy_in[0:1], self._copy_in[1:2])

    # -- client side ------------------------------------------------------
    def _validate(self, plen, max_new):
        if plen < 1:
            raise ValueError("prompt must hold at least one token")
        if plen > self.prompt_buckets[-1]:
            raise ValueError(
                f"prompt length {plen} exceeds the top prompt "
                f"bucket {self.prompt_buckets[-1]}")
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if plen + max_new > self.cache_lengths[-1]:
            raise ValueError(
                f"prompt ({plen}) + max_new_tokens ({max_new}) "
                f"exceeds the top cache rung {self.cache_lengths[-1]}")

    def _enqueue(self, item, timeout_ms):
        """Liveness check + bounded enqueue as ONE locked step: an item
        must never land in the queue after shutdown()/_die() drained it."""
        deadline = (None if timeout_ms is None
                    else time.monotonic() + float(timeout_ms) / 1e3)
        with self._lock:
            if self._shutdown:
                raise RuntimeError("GenerationServer is shut down")
            if self._dead is not None:
                raise self._dead
            bounded_enqueue(self._queue, item, deadline,
                            self.enqueue_timeout, what="generation")
        self._work.set()

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
        max_new = (self.default_max_new_tokens if max_new_tokens is None
                   else int(max_new_tokens))
        self._validate(int(prompt.size), max_new)
        req = GenerationRequest(
            prompt, max_new,
            self.default_eos_id if eos_id == "default" else eos_id,
            self.default_method if method is None else method_id(method),
            (self.default_temperature if temperature is None
             else temperature),
            self.default_top_k if top_k is None else top_k,
            on_token=on_token)
        req.trace = _req.start("generation", meta={
            "prompt_len": int(prompt.size),
            "max_new_tokens": req.max_new_tokens,
            "method": req.method})
        if req.trace is not None:
            req.trace_id = req.trace.trace_id
            req.trace.event("enqueue", queued=self._queue.qsize())
        try:
            self._enqueue(req, timeout_ms)
        except BaseException as e:
            if req.trace is not None:
                # only the bounded-queue overload is a "shed": a ring of
                # dead-server refusals must never read as load shedding
                if isinstance(e, InferenceOverloadedError):
                    status = "shed"
                elif isinstance(e, InferenceTimeoutError):
                    status = "timeout"
                else:
                    status = "rejected"
                req.trace.event(status, error=type(e).__name__)
                req.trace.finish(status)
            if _mon.enabled():
                _events.emit(
                    "generation", _events.SERVER_REFUSED,
                    attrs={"error": type(e).__name__,
                           "request": req.trace_id},
                    correlation_id=self._corr)
            raise
        return req

    def generate(self, prompt, timeout=None, **kw):
        """Blocking convenience: submit + result."""
        return self.submit(prompt, **kw).result(timeout=timeout)

    def adopt(self, req, admit_id, timeout_ms=None):
        """Admit a pre-built request under an EXPLICIT admission id — the
        fleet-router hook behind cross-replica failover. A stream is a
        pure function of (server seed, admit_id, prompt, sampling config),
        so a router that keeps replica seeds aligned and assigns
        fleet-wide admission ids gets streams independent of which
        replica serves them. `req.tokens` may already hold the delivered
        prefix of a request whose replica died mid-stream: the record then
        re-enters through crash-replay (prefix re-prefill, or
        regeneration with delivery suppressed), so the continuation is
        token-identical to an uninterrupted run and nothing is delivered
        twice."""
        if not self._warm:
            self.warmup()
        self._validate(int(req.prompt.size), req.max_new_tokens)
        self._enqueue(_SlotJournal(req, int(admit_id)), timeout_ms)
        return req

    # -- decode loop ------------------------------------------------------
    def _loop(self):
        while not self._shutdown:
            try:
                self._admit_pending()
                if self._slot_req:
                    self._dispatch_block()
                elif self._inflight is not None:
                    # every occupant retired, but the pipelined tail block
                    # is still in flight: deliver it (its lanes are all
                    # frozen or stale), so fetches and blocks balance
                    blk, self._inflight = self._inflight, None
                    self._deliver_block(blk)
                else:
                    if self._pressure:
                        # an idle server takes no steps and may see no
                        # growth attempt: wall-clock relief fires here
                        self._maybe_relieve_by_time()
                    if self._work.wait(timeout=0.05):
                        self._work.clear()
            except Exception as e:  # noqa: BLE001 — replay, stay up
                if not self._survive(e):
                    return
        if self._inflight is not None:
            # shut down: deliver the block still in flight, so that every
            # dispatched block is fetched and counted once
            blk, self._inflight = self._inflight, None
            try:
                self._deliver_block(blk)
            except Exception:  # noqa: BLE001 — the server is stopping;
                pass           # shutdown() fails what stays open

    def _admit_pending(self):
        """Admit queued requests into free slots of the in-flight batch —
        one prefill each (a longer request may first GROW the cache to the
        next rung).

        Failure containment: a degradation-ladder refusal
        (`MemoryPressureError`, an exhausted page pool included) is
        raised before any dispatch, so it fails only that request. Any
        later failure happens after the request was journaled: it
        propagates, and `_survive` resets the state and replays every
        journaled request, the one whose admission failed included."""
        while self._free:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return
            # adopted records ride the queue as their journal; local
            # submits get theirs in _admit_one
            rec = item if isinstance(item, _SlotJournal) else None
            req = _queued_req(item)
            try:
                if rec is None:
                    self._admit_one(req)
                else:
                    self._admit_adopted(rec)
            except MemoryPressureError as e:
                req._fail(e)        # pre-dispatch refusal: state intact
            except Exception as e:
                if not any(r.req is req for r in self._slot_req.values()):
                    req._fail(e)    # not journaled: nothing replays it
                raise

    def _admit_one(self, req):
        """Fresh admission: the next admission id (the rng-key derivation
        the journal replays)."""
        self._counter += 1
        self._admit_fresh(_SlotJournal(req, self._counter))

    def _admit_adopted(self, rec):
        """Admit an adopted record: with no delivered prefix exactly like
        a local submission under its explicit id; with one, through
        `_replay_one`, the path an in-process crash uses. A record whose
        prefix already ends the stream only lost its retirement: finish
        it, never generate past EOS / max_new_tokens."""
        req = rec.req
        if req.done():
            return
        reason = self._finished_reason(req)
        if reason is not None:
            req._finish(reason)
            return
        if req.tokens:
            self._replay_one(rec)
        else:
            self._admit_fresh(rec)

    def _admit_fresh(self, rec):
        """Dispatch one journaled first-time admission and count it."""
        req = rec.req
        t0 = time.perf_counter() if _mon.enabled() else None
        self._admit_rec(rec, req.prompt, self._admit_key(rec.admit_id))
        self.stats["admissions"] += 1
        self.stats["tokens"] += 1     # the prefill's first sampled token
        if t0 is not None and _mon.enabled():
            prefill_ms = (time.perf_counter() - t0) * 1e3
            reg = _mon.get_registry()
            reg.counter(_mon.GEN_ADMISSIONS,
                        help="sequences admitted into the decode "
                             "batch").inc()
            reg.counter(_mon.GEN_TOKENS,
                        help="tokens generated (all slots)").inc()
            reg.histogram(_mon.GEN_PREFILL_MS,
                          help="prompt prefill + cache-graft wall "
                               "time").observe(prefill_ms,
                                               trace_id=req.trace_id)
            reg.gauge(_mon.GEN_ACTIVE_SLOTS,
                      help="occupied decode slots").set(
                len(self._slot_req))

    def _admit_rec(self, rec, prompt, key):
        """Admission shared by fresh admissions and crash-replay
        re-admissions: gate growth through the ladder, journal the record
        before the first dispatch (a later failure re-admits it from the
        journal), grow if needed, prefill `prompt` with the rng `key`, and
        deliver the first sampled token (suppressed while the record
        regenerates an already-delivered prefix)."""
        req = rec.req
        plen = int(prompt.size)
        pbucket = next(p for p in self.prompt_buckets if p >= plen)
        needed = int(req.prompt.size) + req.max_new_tokens
        rung = self._rung
        if needed > rung or pbucket > rung:
            rung = self._rung_for(needed, pbucket)
            self._check_growth(rung)    # raises MemoryPressureError
        if self._pages is not None and _faults.ACTIVE is not None:
            # fired before the slot pop: an injected admission-time pool
            # fault is contained to the request without leaking the slot
            _faults.ACTIVE.fire(_faults.CACHE_PAGE)
        slot = self._free.pop()
        arrays = [np.zeros(self._admit_in.shape, np.int64),
                  np.array([req.temperature], np.float32)]
        dsts = [self._admit_in, self._admit_temp]
        if self._pages is not None:
            try:
                wrow = self._pages.admit_slot(slot, prompt, pbucket)
            except PagePoolExhaustedError:
                # refused before dispatch (allocations rolled back): the
                # slot goes back untouched and only this request fails
                self._free.append(slot)
                if _mon.enabled():
                    _events.emit(
                        "generation", _events.PAGES_EXHAUSTED,
                        attrs={"request": req.trace_id},
                        correlation_id=self._corr)
                raise
            rec.disp_pos = plen
            arrays.append(wrow.astype(np.int64))
            dsts.append(self._wrow_in[pbucket])
        self._slot_req[slot] = rec
        if rung != self._rung:
            if _faults.ACTIVE is not None:
                _faults.ACTIVE.fire(_faults.CACHE_GROW)
            if req.trace is not None:
                req.trace.event("grow", to_rung=rung)
            if _mon.enabled():
                _events.emit("generation", _events.CACHE_GROWN,
                             attrs={"to_rung": rung},
                             correlation_id=self._corr)
            if self._pages is None:
                self._store.run((f"grow_to_{rung}", self._rung))
            # paged: the pool is rung-independent; growth only widens the
            # page table the next blocks read through
            self._rung = rung
        if req.trace is not None:
            req.trace.event("admit", slot=slot, rung=rung,
                            bucket=pbucket, admit_id=rec.admit_id)
        ints = arrays[0]
        ints[[_A_SLOT, _A_PLEN, _A_METHOD, _A_TOPK]] = (slot, plen,
                                                        req.method,
                                                        req.top_k)
        ints[_A_KEY:_A_KEY + 2] = key
        ints[_A_PROMPT:_A_PROMPT + plen] = prompt
        if _faults.ACTIVE is not None:
            _faults.ACTIVE.fire(_faults.GENERATION_ADMIT)
        self._ring.stage(arrays, dsts)
        first = self._store.run(("admit", self._rung, pbucket))
        if self._pages is not None:
            self._emit_page_metrics()
        first = int(self._fetch(first)[0])
        self._deliver(slot, rec, first)

    def _admit_key(self, admit_id):
        """Per-request admission rng key: a pure function of
        (server seed, admission id) — the identity crash-replay re-derives."""
        return np.random.default_rng(
            (self.seed, admit_id)).integers(0, 2 ** 32, size=2,
                                            dtype=np.uint32)

    def _rung_for(self, needed, pbucket):
        """Smallest cache rung admitting a request that needs `needed`
        rows and prefills at prompt bucket `pbucket`."""
        return next(c for c in self.cache_lengths
                    if c >= needed and c >= pbucket)

    def _block_args(self):
        """Per-block [EOS; budget] columns from the host-side journals: -1
        for slots with no EOS (sampled ids are >= 0, so it never
        matches); budget = tokens the slot may still emit, plus a
        regenerating slot's undelivered journaled prefix. With a block in
        flight its tokens are not counted yet, so a budget may over-allow
        by one block: the surplus is computed, never delivered."""
        args = np.zeros((2, self.slots), np.int64)
        args[0] = -1
        for slot, rec in self._slot_req.items():
            req = rec.req
            if req.eos_id is not None:
                args[0, slot] = req.eos_id
            left = req.max_new_tokens - len(req.tokens)
            if rec.expect is not None:
                left += len(rec.expect) - rec.replay_idx
            args[1, slot] = max(left, 0)
        return args

    def _propose_drafts(self):
        """Host-side draft proposal (numpy over each request's journal, no
        device work): a regenerating slot proposes its journaled prefix
        (an exact draft); a greedy slot the prompt-lookup n-gram
        continuation of its own history; a non-greedy slot nothing, so it
        consumes exactly one rng split per token."""
        nd = self.draft
        draft = np.zeros((self.slots, nd), np.int64)
        dlen = np.zeros((self.slots,), np.int64)
        for slot, rec in self._slot_req.items():
            req = rec.req
            if req.method != GREEDY:
                continue
            if rec.expect is not None:
                tail = np.asarray(
                    rec.expect[rec.replay_idx:rec.replay_idx + nd],
                    np.int64)
            else:
                tail = _ngram_propose(
                    np.concatenate([req.prompt,
                                    np.array(req.tokens, np.int64)]), nd)
            draft[slot, :len(tail)] = tail
            dlen[slot] = len(tail)
        return draft, dlen

    def _page_args(self, k):
        """Page preparation for one block (host work between dispatches):
        every occupied slot gets writable pages for its next `k` rows —
        fresh pages, and a ("page_copy",) call for each shared page that
        must be copied on write, queued before the block — then the page
        table at the current rung's width. Coverage stops at the request's
        own row count; a write past it lands on the null page (an unmapped
        table entry) or in the slot's own last page."""
        if _faults.ACTIVE is not None:
            _faults.ACTIVE.fire(_faults.CACHE_PAGE)
        for slot, rec in self._slot_req.items():
            req = rec.req
            needed = int(req.prompt.size) + req.max_new_tokens
            hi = min(rec.disp_pos + k, needed)
            if hi <= rec.disp_pos:
                continue
            for src, dst in self._pages.ensure_range(slot, rec.disp_pos,
                                                     hi - 1):
                self._ring.stage([np.array([src, dst], np.int64)],
                                 [self._copy_in])
                self._store.run(("page_copy",))
            rec.disp_pos = hi
        self._emit_page_metrics()
        return self._pages.build_table(
            self.slots, self._rung // self.decoder.page_size).astype(
                np.int64)

    def _emit_page_metrics(self):
        """Page-pool gauges (occupancy, sharing) and the eviction and
        prefix-hit counters, incremented by delta from the allocator's
        monotonic stats; enabled-guarded, on the dispatch boundary."""
        if not _mon.enabled():
            return
        reg = _mon.get_registry()
        occ = self._pages.occupancy()
        reg.gauge(_mon.GEN_PAGES_ACTIVE,
                  help="physical KV pages holding live or cold-resident "
                       "content").set(occ["pages_active"])
        reg.gauge(_mon.GEN_PAGES_SHARED,
                  help="shared (prefix-dedup) pages referenced by >= 1 "
                       "live slot").set(occ["pages_shared"])
        st = self._pages.stats
        for metric, key, hlp in (
                (_mon.GEN_PAGE_EVICTIONS, "evictions",
                 "cold shared KV pages evicted (LRU / ladder)"),
                (_mon.GEN_PREFIX_HITS, "prefix_hits",
                 "admissions that reused >= 1 shared prefix page")):
            delta = st[key] - self._page_counts[key]
            if delta:
                reg.counter(metric, help=hlp).inc(delta)
                self._page_counts[key] = st[key]

    def _dispatch_block(self):
        """Dispatch the next block (a superstep, or a drafting round) for
        the whole batch, start the asynchronous host copy of its tokens,
        then deliver the PREVIOUS block while this one runs. A drafting
        round first delivers the round ahead of it: its drafts continue
        each slot's whole history, and a proposal made one round late
        continues a history the device has already moved past (the JAX
        server proposes that way)."""
        if _faults.ACTIVE is not None:
            # multi-token blocks (supersteps and drafting rounds) fire the
            # superstep site; the k=1 path keeps the step site
            _faults.ACTIVE.fire(_faults.GENERATION_SUPERSTEP
                                if self.superstep > 1 or self.draft
                                else _faults.GENERATION_STEP)
        if self.draft and self._inflight is not None:
            blk, self._inflight = self._inflight, None
            self._deliver_block(blk)
            self._admit_pending()
            if not self._slot_req:
                return
        t0 = time.perf_counter()
        arrays, dsts = [self._block_args()], [self._block_in]
        if self._pages is not None:
            arrays.append(self._page_args(self._block_depth))
            dsts.append(self._ptab_in[self._rung])
        proposed = None
        if self.draft:
            draft, proposed = self._propose_drafts()
            arrays += [draft, proposed]
            dsts += [self._draft_in, self._dlen_in]
            key = ("verify", self._rung, self.draft)
        else:
            key = ("superstep", self._rung, self.superstep)
        self._ring.stage(arrays, dsts)
        fetch = self._start_fetch(self._store.run(key))
        blk = _Block(fetch, dict(self._slot_req), self._block_depth, t0,
                     time.perf_counter() if _mon.enabled() else None,
                     proposed)
        prev, self._inflight = self._inflight, blk
        if prev is not None:
            self._deliver_block(prev)

    def _deliver_block(self, blk):
        """Fetch one block's (k, S) tokens (THE host sync of the block) and
        deliver them step-major: -1 marks a frozen/empty lane; a slot
        retired or re-admitted since the block's dispatch is skipped."""
        mon_on = _mon.enabled() and blk.t_copy is not None
        if mon_on:
            overlap_ms = (time.perf_counter() - blk.t_copy) * 1e3
        toks = self._fetch_tokens(blk.tokens)
        dt_ms = (time.perf_counter() - blk.t0) * 1e3
        if mon_on:
            ex_tid = self._trace_block(blk, toks, dt_ms, overlap_ms)
        live = 0
        ndel = np.zeros(self.slots, np.int64)
        for row in toks:
            for slot, rec in blk.recs.items():
                tok = int(row[slot])
                if tok < 0 or self._slot_req.get(slot) is not rec:
                    continue
                if rec.expect is None:
                    live += 1
                ndel[slot] += 1
                self._deliver(slot, rec, tok)
        self.stats["steps"] += 1
        self.stats["tokens"] += live
        multi = self.superstep > 1 or self.draft > 0
        if multi:
            self.stats["supersteps"] += 1
        # a drafting round's depth is what it delivered, not draft + 1
        k_real = (blk.k if blk.proposed is None
                  else max(1, int(ndel.max(initial=0))))
        self._latencies.append(dt_ms / k_real)
        accepts = rejects = 0
        if blk.proposed is not None:
            # only tokens that reached delivery count as accepted drafts
            accepts = int(np.minimum(np.maximum(ndel - 1, 0),
                                     blk.proposed).sum())
            rejects = int(blk.proposed.sum()) - accepts
            self.stats["draft_accepts"] += accepts
            self.stats["draft_rejects"] += rejects
        if self._pressure:
            self._clean_steps += k_real
            if self._clean_steps >= self.pressure_relief_steps:
                self._relieve_pressure()
        if mon_on:
            reg = _mon.get_registry()
            reg.counter(_mon.GEN_TOKENS,
                        help="tokens generated (all slots)").inc(live)
            reg.histogram(_mon.GEN_PER_TOKEN_MS,
                          help="decode wall time per token (block "
                               "wall / realized block depth)").observe(
                dt_ms / k_real, trace_id=ex_tid)
            reg.histogram(_mon.GEN_TOKENS_PER_DISPATCH,
                          help="live tokens delivered per decode "
                               "dispatch").observe(live)
            reg.histogram(_mon.GEN_FETCH_OVERLAP_MS,
                          help="window the async token fetch had to "
                               "overlap the next dispatch").observe(
                overlap_ms)
            if multi:
                reg.counter(_mon.GEN_SUPERSTEPS,
                            help="multi-token decode-block dispatches "
                                 "(superstep blocks / draft-verify "
                                 "rounds)").inc()
            if blk.proposed is not None:
                reg.counter(_mon.GEN_DRAFT_ACCEPTS,
                            help="draft tokens accepted (delivered "
                                 "beyond the per-round baseline "
                                 "token)").inc(accepts)
                reg.counter(_mon.GEN_DRAFT_REJECTS,
                            help="draft tokens proposed but not "
                                 "delivered (mismatch or EOS/budget "
                                 "truncation)").inc(rejects)

    def _trace_block(self, blk, toks, dt_ms, overlap_ms):
        """Request timelines: one "block" event per still-owned slot, on
        the fetch boundary (toks is host data already), before delivery
        so a retirement in this block lands after its block event.
        Returns the trace id of the first live slot (the latency
        histogram's exemplar)."""
        ex_tid = None
        for slot, rec in blk.recs.items():
            if self._slot_req.get(slot) is not rec:
                continue
            if ex_tid is None and rec.expect is None:
                ex_tid = rec.req.trace_id
            tr = rec.req.trace
            if tr is not None:
                tr.event("block", k=blk.k,
                         tokens=int((toks[:, slot] >= 0).sum()),
                         wall_ms=round(dt_ms, 3),
                         overlap_ms=round(overlap_ms, 3))
        return ex_tid

    def _start_fetch(self, t):
        """Start the device → host copy of a block's tokens: on the card a
        `non_blocking` copy into the next of two pinned buffers, queued on
        the stream the replays run on, so the next replay cannot overwrite
        the graph's output before it lands; its event marks it done.
        Returns what `_fetch_tokens` reads."""
        if not t.is_cuda:
            return t, None
        ring = self._fetch_ring[self._fetch_next]
        self._fetch_next ^= 1
        if ring[1] is not None:
            ring[1].synchronize()   # the buffer's last copy has landed
        ring[0].copy_(t, non_blocking=True)
        ring[1] = torch.cuda.Event()
        ring[1].record(torch.cuda.current_stream(t.device))
        return ring[0], ring[1]

    def _fetch_tokens(self, fetch):
        """Wait for a started fetch and return its tokens as numpy."""
        self.token_fetches += 1
        buf, event = fetch
        if event is not None:
            event.synchronize()
        return buf.numpy().copy()

    def _fetch(self, t):
        """Device → host copy of an admission's first token (synchronizes)."""
        self.token_fetches += 1
        return t.cpu().numpy()

    def _drop_inflight(self):
        """Recovery: the block in flight at a fault is dropped, never
        delivered (its tokens were not journaled, so replay regenerates
        exactly them). Its copy is waited for, so the pinned buffer it
        lands in is idle before anything reuses it, and it counts
        `blocks_dropped` instead of a fetch."""
        blk, self._inflight = self._inflight, None
        if blk is None:
            return
        event = blk.tokens[1]
        if event is not None:
            event.synchronize()
        self.stats["blocks_dropped"] += 1

    def _deliver(self, slot, rec, tok):
        req = rec.req
        if rec.expect is not None:
            # crash-replay suppression: this token was delivered before
            # the crash — check the regenerated stream against the
            # journal and hand delivery back to the live path once the
            # prefix is exhausted
            if tok != rec.expect[rec.replay_idx]:
                req.error = ReplayDivergedError(
                    f"replayed token {tok} != journaled "
                    f"{rec.expect[rec.replay_idx]} at position "
                    f"{rec.replay_idx}")
                rec.expect = None
                self._retire_slot(slot, "error")
                return
            rec.replay_idx += 1
            if rec.replay_idx >= len(rec.expect):
                rec.expect = None
            return
        self._consecutive_failures = 0      # forward progress
        req._push(tok)
        reason = self._finished_reason(req)
        if reason is not None:
            self._retire_slot(slot, reason)

    def _retire_slot(self, slot, reason):
        """Clear a slot's columns on the device and free it; a paged slot's
        private pages go free, its shared prefix pages stay resident cold
        for the next identical prompt."""
        self._ring.stage([np.array([slot], np.int64)], [self._retire_in])
        self._store.run(("retire",))
        rec = self._slot_req.pop(slot)
        self._free.append(slot)
        if self._pages is not None:
            self._pages.release_slot(slot)
        self.stats["retirements"] += 1
        try:
            if _mon.enabled():
                reg = _mon.get_registry()
                reg.counter(_mon.GEN_RETIREMENTS,
                            help="sequences retired (EOS or "
                                 "length)").inc()
                reg.gauge(_mon.GEN_ACTIVE_SLOTS,
                          help="occupied decode slots").set(
                    len(self._slot_req))
        finally:
            # once popped from the journal the request MUST finish, or
            # nothing would ever replay or resolve it
            rec.req._finish(reason)

    @staticmethod
    def _finished_reason(req):
        """The finish reason a delivered-but-unretired request should get
        ("eos" / "length"), or None while it still needs tokens — the
        guard that keeps crash-replay from continuing a stream whose
        terminal token already reached the consumer."""
        if req.tokens and req.eos_id is not None \
                and req.tokens[-1] == req.eos_id:
            return "eos"
        if len(req.tokens) >= req.max_new_tokens:
            return "length"
        return None

    # -- survivability: crash-replay, supervision, degradation -----------
    def _survive(self, exc):
        """Decode-loop failure: crash-replay recovery first (journal →
        reset → re-admit), then supervised restarts under the
        RetryPolicy budget. OOM-classified failures escalate the
        memory-pressure ladder before the recovery. Returns False when
        the server latched dead (the loop must exit)."""
        self.stats["errors"] += 1
        self._consecutive_failures += 1
        if self._consecutive_failures > self.max_consecutive_failures:
            self._die(exc, reason=(
                f"no forward progress after "
                f"{self._consecutive_failures} consecutive "
                f"decode-loop failures"))
            return False
        if _mon.enabled():
            _events.emit(
                "generation", _events.SERVER_DISRUPTED,
                attrs={"error": type(exc).__name__,
                       "consecutive": self._consecutive_failures},
                correlation_id=self._corr)
        if CrashReportingUtil.is_oom(exc):
            self._note_memory_pressure(exc)
        try:
            self._recover()
            if _mon.enabled():
                _events.emit("generation", _events.SERVER_RECOVERED,
                             attrs={"via": "replay"},
                             correlation_id=self._corr)
            return True
        except Exception as e2:  # noqa: BLE001 — supervisor takes over
            ok = self._supervised_restart(e2)
            if ok and _mon.enabled():
                _events.emit("generation", _events.SERVER_RECOVERED,
                             attrs={"via": "restart"},
                             correlation_id=self._corr)
            return ok

    def _recover(self):
        """Crash-replay recovery: the block in flight is dropped, every
        in-flight journal moves to the replay-pending set, the static
        decode state is reset in place at the smallest rung (the graphs
        keep their addresses: no capture, no allocation), and each
        surviving request is re-admitted with its continuation
        token-identical to an uninterrupted run. Raises when the
        re-admission itself fails — the supervisor retries; pending
        journals survive the retry because re-admission is idempotent
        from the journal."""
        with self._lock:
            if self._shutdown or self._dead is not None:
                return
            self._drop_inflight()
            for rec in self._slot_req.values():
                if rec not in self._replaying:
                    self._replaying.append(rec)
            self._slot_req.clear()
            self._free = list(range(self.slots))
            self._replaying.sort(key=lambda r: r.admit_id)
            self._rung = self.cache_lengths[0]
            self._reset_state()
            if self._pages is not None:
                # the pool's contents are presumed lost: the allocator
                # forgets everything and the ordered re-admissions rebuild
                # the table and the prefix registry from the journal
                self._pages.reset()
            while self._replaying:
                rec = self._replaying[0]
                if rec.req.done():
                    self._replaying.pop(0)
                    continue
                reason = self._finished_reason(rec.req)
                if reason is not None:
                    # the final token was delivered and only the
                    # retirement was lost: finish, never generate past it
                    rec.req._finish(reason)
                    self._replaying.pop(0)
                    continue
                try:
                    self._replay_one(rec)
                except MemoryPressureError as e:
                    # pre-dispatch refusal (no longer fits the capped
                    # rung): fail this request, keep replaying the rest
                    rec.req._fail(e)
                self._replaying.pop(0)

    def _replay_one(self, rec):
        """Re-admit one journaled request. Preferred path: re-prefill
        prompt + delivered prefix in ONE admission, with the admission key
        advanced past the consumed sampling splits — the next sampled
        token continues the stream. When the prefix outgrows the
        prompt-bucket ladder (or its bucket would force a bigger rung),
        regenerate it from the original admission with delivery
        suppressed. Per-slot keys make both continuations
        token-identical."""
        req = rec.req
        g = len(req.tokens)
        plen = int(req.prompt.size)
        needed = plen + req.max_new_tokens
        use_prefix = g and plen + g <= self.prompt_buckets[-1]
        if use_prefix:
            # a crash must never make a request need a bigger rung than
            # its uninterrupted run did
            pb_prefix = next(p for p in self.prompt_buckets
                             if p >= plen + g)
            pb_orig = next(p for p in self.prompt_buckets if p >= plen)
            use_prefix = (self._rung_for(needed, pb_prefix)
                          == self._rung_for(needed, pb_orig))
        mode = "prefix" if use_prefix else "regenerate"
        if req.trace is not None:
            req.trace.event("replay", mode=mode, delivered=g)
        if use_prefix:
            prefix = np.concatenate(
                [req.prompt, np.asarray(req.tokens, np.int32)])
            key = self._advance_key(self._admit_key(rec.admit_id), g)
            rec.expect = None
            rec.replay_idx = 0
            self._admit_rec(rec, prefix, key)
            live_first = True       # the prefill sampled a NEW token
        else:
            rec.expect = list(req.tokens) or None
            live_first = rec.expect is None   # g == 0: first-ever token
            rec.replay_idx = 0
            self._admit_rec(rec, req.prompt, self._admit_key(rec.admit_id))
        self.stats["replays"] += 1
        if live_first:
            self.stats["tokens"] += 1
        if _mon.enabled():
            reg = _mon.get_registry()
            reg.counter(_mon.GEN_REPLAYS,
                        help="in-flight requests re-admitted by "
                             "crash-replay").inc()
            _events.emit(
                "generation", _events.SERVER_REPLAY,
                attrs={"request": req.trace_id, "mode": mode,
                       "delivered": g},
                correlation_id=self._corr)
            if live_first:
                reg.counter(_mon.GEN_TOKENS,
                            help="tokens generated (all slots)").inc()
            reg.gauge(_mon.GEN_ACTIVE_SLOTS,
                      help="occupied decode slots").set(
                len(self._slot_req))

    def _advance_key(self, key, n):
        """Advance an admission key past `n` consumed sampling splits —
        the prefix replay's continuation key: `n` applications of
        `split_keys(k)[0]`, JAX's `fori_loop` of `split_keys` bit for bit.

        It runs on the host, in place of the reference's ("advance_key_n",)
        executable (`executable_keys` lists it): a CUDA graph replays a
        fixed sequence of launches and cannot loop a data-dependent `n`
        times (a captured fixed-trip loop would cost the longest prefix's
        trip count on every replay), and the admission key it feeds is
        made and staged on the host anyway.
        So a replay captures nothing, compiles nothing and adds no device
        dispatch however long the prefix (one threefry2x32 of two 32-bit
        words per consumed split, microseconds)."""
        self.key_advances += 1
        return _advance_key_host(key, n)

    def _supervised_restart(self, exc):
        """Recovery failed: retry it from the warm store under the bounded
        RetryPolicy. The typed ServerDeadError latch engages only once the
        budget is exhausted (or the failure is classified unrestartable)."""

        def on_retry(attempt, e):
            self._count_restart()
            if CrashReportingUtil.is_oom(e):
                self._note_memory_pressure(e)

        self._count_restart()
        try:
            self.restart_policy.call(self._recover, on_retry=on_retry,
                                     label="generation-server restart")
            return True
        except Exception as final:  # noqa: BLE001 — budget exhausted
            self._die(final, reason="supervised restart budget "
                                    "exhausted")
            return False

    def _restartable(self, exc):
        """Restart classifier: anything is worth a bounded restart except a
        latched death, or an OOM once the ladder has no smaller rung left
        to cap to (another attempt at the same size cannot help)."""
        if isinstance(exc, ServerDeadError):
            return False
        if CrashReportingUtil.is_oom(exc):
            if self._pressure < (4 if self._pages is not None else 3):
                return True
            cap = self._rung_cap or self.cache_lengths[-1]
            return any(c < cap for c in self.cache_lengths)
        return True

    def _count_restart(self):
        self.stats["restarts"] += 1
        if _mon.enabled():
            _mon.get_registry().counter(
                _mon.GEN_RESTARTS,
                help="supervised decode-loop restarts from the warm "
                     "store").inc()
            _events.emit("generation", _events.SERVER_RESTARTED,
                         attrs={"restarts": self.stats["restarts"]},
                         correlation_id=self._corr)

    # -- memory-pressure degradation ladder -------------------------------
    def _note_memory_pressure(self, exc):
        """Escalate the ladder one level: 1 = refuse cache growth past the
        current rung, 2 = also shed every queued admission, 3 = cap the
        rung one smaller (in-flight requests replay into it; ones that no
        longer fit fail typed). Paged servers get a level between shed and
        cap — 3 = evict every cold (refcount-zero) shared prefix page —
        and cap moves to 4. Keeps a `monitoring/memory.py` reading for OOM
        forensics."""
        self._clean_steps = 0
        self._pressure_ts = time.monotonic()
        if self._pressure == 0 or self._rung_cap is None:
            self._rung_cap = self._rung
        if self._pages is not None:
            ladder = ("refuse_growth", "shed_queue", "evict_pages",
                      "shrink")
        else:
            ladder = ("refuse_growth", "shed_queue", "shrink")
        self._pressure = min(len(ladder), self._pressure + 1)
        action = ladder[self._pressure - 1]
        if _mon.enabled():
            _events.emit(
                "generation", _events.PRESSURE_ESCALATED,
                attrs={"level": self._pressure, "action": action,
                       "error": type(exc).__name__},
                correlation_id=self._corr)
        if self._pressure >= 2:
            self._shed_queue(exc)
        if self._pages is not None and self._pressure >= 3:
            evicted = self._pages.evict_cold()
            if _mon.enabled():
                _events.emit("generation", _events.PAGES_EVICTED,
                             attrs={"evicted": evicted},
                             correlation_id=self._corr)
        if self._pressure >= len(ladder):
            smaller = [c for c in self.cache_lengths
                       if c < self._rung_cap]
            if smaller:
                self._rung_cap = smaller[-1]
                if _mon.enabled():
                    _events.emit("generation", _events.CACHE_SHRUNK,
                                 attrs={"cap": self._rung_cap},
                                 correlation_id=self._corr)
            else:
                # no smaller rung: the ladder is out of moves — say so
                # instead of reporting a phantom shrink
                action = "at_floor"
        self._count_degradation(action)
        if _mon.enabled():
            try:
                _mem.sample()
            except Exception:  # noqa: BLE001 — telemetry best-effort
                pass

    def _relieve_pressure(self):
        """A clean stretch of decode tokens — or of wall-clock quiet —
        decays one pressure level; back at level 0 the growth cap lifts."""
        self._clean_steps = 0
        self._pressure_ts = time.monotonic()
        self._pressure = max(0, self._pressure - 1)
        if self._pressure == 0:
            self._rung_cap = None
        if _mon.enabled():
            _events.emit("generation", _events.PRESSURE_RELIEVED,
                         attrs={"level": self._pressure},
                         correlation_id=self._corr,
                         resolves=self._pressure == 0)

    def _maybe_relieve_by_time(self):
        """Wall-clock decay, re-evaluated on every growth attempt and idle
        tick, so pressure lifts even when no decode steps run."""
        if self._pressure and self.pressure_relief_secs is not None \
                and (time.monotonic() - self._pressure_ts
                     >= self.pressure_relief_secs):
            self._relieve_pressure()

    def _check_growth(self, target):
        """Ladder gate on cache growth — before any dispatch, so a refusal
        is contained to the triggering request. Refuses past the pressure
        cap, and while the device-memory telemetry is past the high-water
        mark (which also reports the server 'degraded' while it lasts).
        The reading is of the decoder's device alone; on the card it is
        `torch.cuda.mem_get_info`'s, where memory the caching allocator
        and the graphs' pool hold counts as used."""
        self._maybe_relieve_by_time()
        if self._rung_cap is not None and target > self._rung_cap:
            self._count_degradation("refuse_growth")
            raise MemoryPressureError(
                f"cache growth to rung {target} refused: the "
                f"memory-pressure ladder caps the cache at rung "
                f"{self._rung_cap} (pressure level {self._pressure})")
        if self.memory_high_water is None:
            return
        for stats in _mem.device_memory_stats(self.device).values():
            if not stats:
                continue
            used = stats.get("bytes_in_use")
            limit = stats.get("bytes_limit")
            if used and limit and used / limit > self.memory_high_water:
                # a telemetry refusal is a degradation too; no cap is set:
                # growth resumes the moment the telemetry clears
                self._pressure = max(self._pressure, 1)
                self._pressure_ts = time.monotonic()
                self._clean_steps = 0
                self._count_degradation("refuse_growth")
                raise MemoryPressureError(
                    f"cache growth to rung {target} refused: device "
                    f"memory at {used / limit:.0%} of limit exceeds the "
                    f"{self.memory_high_water:.0%} high-water mark")

    def _shed_queue(self, cause):
        """Ladder level 2: fail every queued (not yet admitted) request
        typed instead of admitting into a memory-starved batch."""
        shed = 0
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            err = MemoryPressureError(
                "queued admission shed under memory pressure")
            err.__cause__ = cause
            _queued_req(item)._fail(err)
            shed += 1
        if shed and _mon.enabled():
            _events.emit("generation", _events.SERVER_SHED,
                         attrs={"shed": shed}, correlation_id=self._corr)
        return shed

    def _count_degradation(self, action):
        self.stats["degradations"] += 1
        if _mon.enabled():
            _mon.get_registry().counter(
                _mon.GEN_DEGRADATIONS, labels={"action": action},
                help="memory-pressure degradation-ladder events").inc()

    # -- failure / lifecycle ----------------------------------------------
    def _fail_open_requests(self, err):
        """Fail every in-flight and replay-pending request (caller holds
        the lock; finished requests keep their results)."""
        for rec in list(self._slot_req.values()) + self._replaying:
            if not rec.req.done():
                rec.req._fail(err)
        self._slot_req.clear()
        self._replaying.clear()

    def _drain_queue(self, err):
        while True:
            try:
                _queued_req(self._queue.get_nowait())._fail(err)
            except queue.Empty:
                return

    def _die(self, cause, reason="decode loop died"):
        """Terminal: latch the typed ServerDeadError, refuse future
        submits, and fail every open request (in flight, replay-pending
        and queued) at once, so no stream consumer waits out its
        timeout."""
        err = ServerDeadError(f"GenerationServer {reason}: {cause!r}")
        err.__cause__ = cause
        if _mon.enabled():
            _events.emit("generation", _events.SERVER_DEAD,
                         attrs={"reason": reason,
                                "error": type(cause).__name__},
                         correlation_id=self._corr)
        with self._lock:
            self._dead = err
            self._fail_open_requests(err)
        self._drain_queue(err)

    def shutdown(self):
        """Idempotent: stops the decode loop; in-flight, replay-pending
        and queued requests fail with a RuntimeError."""
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
        """Compact survivability view for `GET /health`
        (resilience.health_snapshot): dead → the replica must be
        replaced; degraded → serving under the memory-pressure ladder;
        serving/cold otherwise."""
        if self._shutdown:
            # deliberate shutdown wins over an earlier death: the
            # operator already acted, /health must not keep paging
            state = "shutdown"
        elif self._dead is not None:
            state = "dead"
        elif self._pressure:
            state = "degraded"
        else:
            state = "serving" if self._warm else "cold"
        out = {"state": state, "pressure": self._pressure,
               "rung_cap": self._rung_cap,
               "active_slots": len(self._slot_req),
               "replays": self.stats["replays"],
               "restarts": self.stats["restarts"],
               "degradations": self.stats["degradations"]}
        if self._pages is not None:
            # pool occupancy and the sharing counters: the capacity signal
            # of a paged server
            out["page_pool"] = {**self._pages.occupancy(),
                                **self._pages.stats}
        return out

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
            "draft": self.draft,
            "paged": self.paged,
            "cuda_graphs": self._store is not None and self._store.capture,
            "executables": (None if self._store is None
                            else self._store.status()),
            "queued": self._queue.qsize(),
            "warm": self._warm,
            "token_fetches": self.token_fetches,
            "key_advances": self.key_advances,
            "tokens_per_dispatch": (self.stats["tokens"] / dispatches
                                    if dispatches else None),
            "host_syncs_per_token": (self.token_fetches
                                     / self.stats["tokens"]
                                     if self.stats["tokens"] else None),
            **self._latency_percentiles(),
            **self.serving_state(),
            **self.stats,
        }


def _advance_key_host(key, n):
    """`n` applications of `split_keys(k)[0]` to one key (two uint32
    words), on the host: the new key of a split is the threefry2x32 hash
    of the counter pair (0, 0). Returns np.uint32 (2,)."""
    k1, k2 = int(key[0]), int(key[1])
    for _ in range(int(n)):
        k1, k2 = threefry2x32(k1, k2, 0, 0)
    return np.array([k1, k2], np.uint32)


def status():
    """Aggregate generation status for every live server."""
    return {"servers": [s.status() for s in list(_SERVERS)]}
