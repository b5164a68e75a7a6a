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

Not in this slice, each waiting for a later slice of the port: `adopt`,
crash-replay and the supervised restart (a decode-loop failure here
latches `ServerDeadError`, and so does a pool exhausted mid-stream), the
memory-pressure ladder with its evict-cold-pages rung, monitoring, the
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

from deeplearning4j_tpu_torch.generation.paging import PageAllocator
from deeplearning4j_tpu_torch.generation.sampling import (GREEDY, method_id,
                                                          sample_step)
from deeplearning4j_tpu_torch.parallel.inference import bounded_enqueue
from deeplearning4j_tpu_torch.resilience.errors import (
    MemoryPressureError, PagePoolExhaustedError, ServerDeadError)
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


class _Record:
    """One admitted request: its admission id (the rng-key derivation) and,
    on a paged server, `disp_pos`, the host's upper bound of the KV rows
    whose writes have been dispatched. The allocator covers
    `[disp_pos, disp_pos + k)` before each block, so live writes always
    land on mapped private pages without reading the device's `pos`."""

    __slots__ = ("req", "admit_id", "disp_pos")

    def __init__(self, req, admit_id):
        self.req = req
        self.admit_id = admit_id
        self.disp_pos = 0


class _Block:
    """One dispatched block: its token fetch in flight, the slot → record
    map at dispatch (delivery never hands a token to a slot re-admitted
    since), its depth k, its dispatch time, and the per-slot draft counts
    (drafting rounds only)."""

    __slots__ = ("tokens", "recs", "k", "t0", "proposed")

    def __init__(self, tokens, recs, k, t0, proposed=None):
        self.tokens = tokens
        self.recs = recs
        self.k = k
        self.t0 = t0
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
    runs the same functions eagerly when False."""

    def __init__(self, decoder, slots=4, cache_lengths=(128,),
                 prompt_buckets=None, method="greedy", temperature=1.0,
                 top_k=0, eos_id=None, max_new_tokens=64, seed=0,
                 queue_limit=256, enqueue_timeout_ms=100.0, superstep=1,
                 draft=0, exec_cache_dir=None, cuda_graphs=True, **later):
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
        self.stats = {"tokens": 0, "steps": 0, "supersteps": 0,
                      "admissions": 0, "retirements": 0, "errors": 0,
                      "draft_accepts": 0, "draft_rejects": 0}
        self.token_fetches = 0       # host syncs: one per block/admission
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
        self._slot_req = {}          # slot -> _Record
        self._inflight = None        # _Block dispatched, not delivered
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
        each), and start the decode loop. Idempotent. Returns {compiled,
        from_disk, captures, nvcc_runs, seconds, executables}."""
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
                elif self._inflight is not None:
                    # every occupant retired, but the pipelined tail block
                    # is still in flight: deliver it (its lanes are all
                    # frozen or stale), so fetches and blocks balance
                    blk, self._inflight = self._inflight, None
                    self._deliver_block(blk)
                elif self._work.wait(timeout=0.05):
                    self._work.clear()
            except Exception as e:  # noqa: BLE001 — latch, fail, report
                self.stats["errors"] += 1
                self._die(e)
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
        next rung). A `MemoryPressureError` (an exhausted page pool) is
        raised before any dispatch: it fails only that request."""
        while self._free:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return
            self._counter += 1
            rec = _Record(req, self._counter)
            try:
                self._admit(rec)
            except MemoryPressureError as e:
                req._fail(e)        # pre-dispatch refusal: state intact
            except Exception as e:
                if not any(r is rec for r in self._slot_req.values()):
                    req._fail(e)    # not registered: nothing else fails it
                raise

    def _admit(self, rec):
        req = rec.req
        plen = int(req.prompt.size)
        pbucket = next(p for p in self.prompt_buckets if p >= plen)
        needed = plen + req.max_new_tokens
        rung = self._rung
        if needed > rung or pbucket > rung:
            rung = next(c for c in self.cache_lengths
                        if c >= needed and c >= pbucket)
        slot = self._free.pop()
        arrays = [np.zeros(self._admit_in.shape, np.int64),
                  np.array([req.temperature], np.float32)]
        dsts = [self._admit_in, self._admit_temp]
        if self._pages is not None:
            try:
                wrow = self._pages.admit_slot(slot, req.prompt, pbucket)
            except PagePoolExhaustedError:
                # refused before dispatch (allocations rolled back): the
                # slot goes back untouched and only this request fails
                self._free.append(slot)
                raise
            rec.disp_pos = plen
            arrays.append(wrow.astype(np.int64))
            dsts.append(self._wrow_in[pbucket])
        self._slot_req[slot] = rec
        if rung != self._rung:
            if self._pages is None:
                self._store.run((f"grow_to_{rung}", self._rung))
            # paged: the pool is rung-independent; growth only widens the
            # page table the next blocks read through
            self._rung = rung
        ints = arrays[0]
        ints[[_A_SLOT, _A_PLEN, _A_METHOD, _A_TOPK]] = (slot, plen,
                                                        req.method,
                                                        req.top_k)
        ints[_A_KEY:_A_KEY + 2] = self._admit_key(rec.admit_id)
        ints[_A_PROMPT:_A_PROMPT + plen] = req.prompt
        self._ring.stage(arrays, dsts)
        first = self._store.run(("admit", self._rung, pbucket))
        first = int(self._fetch(first)[0])
        self.stats["admissions"] += 1
        self.stats["tokens"] += 1     # the prefill's first sampled token
        self._deliver(slot, rec, first)

    def _admit_key(self, admit_id):
        """Per-request admission rng key: a pure function of
        (server seed, admission id) — the identity crash-replay re-derives."""
        return np.random.default_rng(
            (self.seed, admit_id)).integers(0, 2 ** 32, size=2,
                                            dtype=np.uint32)

    def _block_args(self):
        """Per-block [EOS; budget] columns from the host-side requests: -1
        for slots with no EOS (sampled ids are >= 0, so it never
        matches); budget = tokens the slot may still emit. With a block
        in flight its tokens are not counted yet, so a budget may
        over-allow by one block: the surplus is computed, never
        delivered."""
        args = np.zeros((2, self.slots), np.int64)
        args[0] = -1
        for slot, rec in self._slot_req.items():
            req = rec.req
            if req.eos_id is not None:
                args[0, slot] = req.eos_id
            args[1, slot] = max(req.max_new_tokens - len(req.tokens), 0)
        return args

    def _propose_drafts(self):
        """Host-side draft proposal (numpy over each request's history, no
        device work): a greedy slot proposes the prompt-lookup n-gram
        continuation of its own history; a non-greedy slot proposes
        nothing, so it consumes exactly one rng split per token."""
        nd = self.draft
        draft = np.zeros((self.slots, nd), np.int64)
        dlen = np.zeros((self.slots,), np.int64)
        for slot, rec in self._slot_req.items():
            req = rec.req
            if req.method != GREEDY:
                continue
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
        return self._pages.build_table(
            self.slots, self._rung // self.decoder.page_size).astype(
                np.int64)

    def _dispatch_block(self):
        """Dispatch the next block (a superstep, or a drafting round) for
        the whole batch, start the asynchronous host copy of its tokens,
        then deliver the PREVIOUS block while this one runs. A drafting
        round first delivers the round ahead of it: its drafts continue
        each slot's whole history, and a proposal made one round late
        continues a history the device has already moved past (the JAX
        server proposes that way)."""
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
        blk = _Block(self._start_fetch(self._store.run(key)),
                     dict(self._slot_req), self._block_depth, t0, proposed)
        prev, self._inflight = self._inflight, blk
        if prev is not None:
            self._deliver_block(prev)

    def _deliver_block(self, blk):
        """Fetch one block's (k, S) tokens (THE host sync of the block) and
        deliver them step-major: -1 marks a frozen/empty lane; a slot
        retired or re-admitted since the block's dispatch is skipped."""
        toks = self._fetch_tokens(blk.tokens)
        dt_ms = (time.perf_counter() - blk.t0) * 1e3
        live = 0
        ndel = np.zeros(self.slots, np.int64)
        for row in toks:
            for slot, rec in blk.recs.items():
                tok = int(row[slot])
                if tok < 0 or self._slot_req.get(slot) is not rec:
                    continue
                live += 1
                ndel[slot] += 1
                self._deliver(slot, rec, tok)
        self.stats["steps"] += 1
        self.stats["tokens"] += live
        if self.superstep > 1 or self.draft:
            self.stats["supersteps"] += 1
        # a drafting round's depth is what it delivered, not draft + 1
        k_real = (blk.k if blk.proposed is None
                  else max(1, int(ndel.max(initial=0))))
        self._latencies.append(dt_ms / k_real)
        if blk.proposed is not None:
            # only tokens that reached delivery count as accepted drafts
            accepts = int(np.minimum(np.maximum(ndel - 1, 0),
                                     blk.proposed).sum())
            self.stats["draft_accepts"] += accepts
            self.stats["draft_rejects"] += int(blk.proposed.sum()) - accepts

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

    def _deliver(self, slot, rec, tok):
        req = rec.req
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
        rec.req._finish(reason)

    # -- failure / lifecycle ----------------------------------------------
    def _fail_open_requests(self, err):
        """Fail every in-flight request (caller holds the lock)."""
        for rec in list(self._slot_req.values()):
            if not rec.req.done():
                rec.req._fail(err)
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
        out = {"state": state, "active_slots": len(self._slot_req)}
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
