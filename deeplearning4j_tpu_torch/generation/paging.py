"""Host-side paged-KV bookkeeping: page allocator, per-slot page tables,
and hash-of-prefix sharing with copy-on-write. A copy of
`deeplearning4j_tpu/generation/paging.py` (pure numpy and hashlib), its one
import re-pointed at the port's errors; the layout contract below is what
makes paged streams bit-identical to dense ones, so it is unchanged.

The device side (decode.py / kernels/flash_attention.py) stores KV in a
pooled layout `(L, P, H, ps, Dh)` — P physical pages of `ps` rows each —
and every read/write goes through a per-slot page index, so a ragged
request pays `ceil(len/ps)` pages instead of a whole cache rung
(µ-cuDNN's fixed-block decomposition applied to cache memory). THIS
module is the other half: pure-numpy/python allocation decisions made on
the host BETWEEN dispatches. Page-table updates ride the existing
dispatch/fetch boundaries — zero device syncs, zero traces (the
generation fast-path lints walk these functions).

Layout contract (mirrored by `BertDecoder` paged mode):

- physical page 0 is the NULL page: unmapped table entries point at it,
  and redundant writes (shared-prefix re-prefill, the frozen-lane
  rewrite past a request's budget) are redirected into it. Its contents
  are garbage by design and never covered by a validity mask.
- pages 1..P-1 are allocatable.

Prefix sharing: at admission each FULL page of the prompt is keyed by
`sha1(tokens[0 : (j+1)·ps])` — causal attention makes a page's KV rows a
pure function of the tokens up to its end — plus the prompt bucket (the
prefill executable that produced the bytes), so a hit maps the slot's
page-table entry at an existing read-only physical page and skips the
redundant write. The partial TAIL page (rows `m·ps..plen-1`) is keyed by
the whole prompt and shared only between identical prompts; it is the
one shared page a slot ever writes into (generation starts at `plen`),
so `ensure_range` copy-on-writes it to a fresh private page before the
first diverging dispatch. Released shared pages stay resident COLD
(refs == 0) so the next identical system prompt still hits; cold pages
are the eviction currency — freed LRU on allocation pressure and by the
memory-pressure ladder's evict-cold-pages rung.
"""
from __future__ import annotations

import hashlib

import numpy as np

from deeplearning4j_tpu_torch.resilience.errors import PagePoolExhaustedError

__all__ = ["PageAllocator", "NULL_PAGE"]

#: physical id of the write-discard / unmapped-read page
NULL_PAGE = 0


def _digest(tokens):
    """Order-exact digest of a token prefix (any int sequence)."""
    h = hashlib.sha1()
    for t in tokens:
        h.update(b"%d," % int(t))
    return h.digest()


class _Shared:
    """One shared (read-only) physical page: its dedup key, how many
    live slots reference it, and an LRU tick for cold eviction."""
    __slots__ = ("phys", "refs", "tick")

    def __init__(self, phys, tick):
        self.phys = phys
        self.refs = 1
        self.tick = tick


class _Entry:
    """One per-slot page-table entry: the physical page and, when the
    page is shared, its registry key (None ⇒ private, writable)."""
    __slots__ = ("phys", "key")

    def __init__(self, phys, key=None):
        self.phys = phys
        self.key = key


class PageAllocator:
    """Free-list allocator over `pages` physical pages of `page_size`
    rows (page 0 reserved as the null page), with a prefix-sharing
    registry. Not thread-safe by design: every caller runs on the
    decode loop thread; `stats`/`occupancy()` reads from other threads
    see monotonic ints (same contract as the server's stats dict)."""

    def __init__(self, pages, page_size):
        if pages < 2:
            raise ValueError(
                f"page pool needs >= 2 pages (null + 1), got {pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.num_pages = int(pages)
        self.page_size = int(page_size)
        self.stats = {"prefix_hits": 0, "pages_reused": 0,
                      "cow_copies": 0, "evictions": 0}
        self.reset()

    # -- lifecycle ---------------------------------------------------------
    def reset(self):
        """Forget everything (pool contents presumed lost) — the
        crash-recovery path: replay re-admissions rebuild the table and
        re-register prefixes deterministically from the journal."""
        self._free = list(range(self.num_pages - 1, NULL_PAGE, -1))
        self._slots = {}          # slot -> [_Entry]
        self._shared = {}         # key -> _Shared
        self._fresh = {}          # slot -> keys registered by its admit
        self._tick = 0

    # -- allocation core ---------------------------------------------------
    def _alloc(self):
        if not self._free:
            if not self.evict_cold(1):
                raise PagePoolExhaustedError(
                    f"no free KV pages ({self.num_pages - 1} total, "
                    f"0 cold evictable)")
        return self._free.pop()

    def evict_cold(self, want=None):
        """Free up to `want` cold shared pages (refs == 0), oldest
        first; `want=None` evicts ALL cold pages (the ladder's
        evict-cold-pages rung). Returns the number evicted."""
        cold = sorted((s.tick, k) for k, s in self._shared.items()
                      if s.refs == 0)
        if want is not None:
            cold = cold[:want]
        for _, key in cold:
            self._free.append(self._shared.pop(key).phys)
        self.stats["evictions"] += len(cold)
        return len(cold)

    # -- admission ---------------------------------------------------------
    def admit_slot(self, slot, prompt, pbucket):
        """Map `slot`'s prompt onto pages; returns the write-redirect
        row for the prefill dispatch: `wrow[j]` is the physical page
        prefill writes logical page j into — NULL_PAGE for pages whose
        bytes already exist (shared hit) or that hold only bucket
        padding. Raises `PagePoolExhaustedError` (allocations rolled
        back) when the pool cannot cover the non-shared pages."""
        ps = self.page_size
        plen = len(prompt)
        npp = -(-int(pbucket) // ps)          # prefill pages (ceil)
        need = -(-plen // ps)                 # pages holding real rows
        self.release_slot(slot)
        self._tick += 1
        entries, wrow, hits, fresh = [], np.zeros(npp, np.int32), 0, []
        try:
            for j in range(need):
                if (j + 1) * ps <= plen:      # full page
                    key = (b"p", j, _digest(prompt[:(j + 1) * ps]),
                           int(pbucket))
                else:                         # partial tail page
                    key = (b"t", plen, _digest(prompt[:plen]),
                           int(pbucket))
                shared = self._shared.get(key)
                if shared is not None:
                    shared.refs += 1
                    shared.tick = self._tick
                    entries.append(_Entry(shared.phys, key))
                    hits += 1                 # write already on device
                else:
                    phys = self._alloc()
                    self._shared[key] = _Shared(phys, self._tick)
                    entries.append(_Entry(phys, key))
                    fresh.append(key)
                    wrow[j] = phys
        except PagePoolExhaustedError:
            self._slots[slot] = entries
            self._fresh[slot] = fresh
            self.abort_admit(slot)
            raise
        self._slots[slot] = entries
        self._fresh[slot] = fresh
        if hits:
            self.stats["prefix_hits"] += 1
            self.stats["pages_reused"] += hits
        return wrow

    def abort_admit(self, slot):
        """Roll back a failed admission BEFORE its prefill dispatch
        executed: keys this admission registered point at never-written
        pages, so they are unregistered outright (a plain
        `release_slot` would leave them resident cold and serve garbage
        to the next identical prompt)."""
        for key in self._fresh.pop(slot, ()):
            shared = self._shared.pop(key, None)
            if shared is not None:
                self._free.append(shared.phys)
        for e in self._slots.pop(slot, ()):
            if e.key is None:
                self._free.append(e.phys)
            elif e.key in self._shared:
                self._deref(e.key)

    # -- steady state ------------------------------------------------------
    def ensure_range(self, slot, lo, hi):
        """Guarantee `slot` can WRITE rows `lo..hi`: allocate private
        pages through `hi // ps` and copy-on-write any shared page in
        the write window. Returns the list of `(src, dst)` physical
        page copies the caller must dispatch BEFORE the block."""
        ps = self.page_size
        entries = self._slots.setdefault(slot, [])
        cow = []
        for j in range(lo // ps, hi // ps + 1):
            while j >= len(entries):
                entries.append(_Entry(self._alloc()))
            e = entries[j]
            if e.key is not None:             # shared → private copy
                dst = self._alloc()
                cow.append((e.phys, dst))
                self._deref(e.key)
                entries[j] = _Entry(dst)
        self.stats["cow_copies"] += len(cow)
        return cow

    def _deref(self, key):
        shared = self._shared.get(key)
        if shared is not None:
            shared.refs -= 1
            shared.tick = self._tick

    def release_slot(self, slot):
        """Return `slot`'s private pages to the free list; shared pages
        just drop a reference (content stays resident for future
        prefix hits until evicted cold)."""
        self._tick += 1
        self._fresh.pop(slot, None)
        for e in self._slots.pop(slot, ()):  # noqa: B020
            if e.key is None:
                self._free.append(e.phys)
            else:
                self._deref(e.key)

    def build_table(self, slots, maxp):
        """Materialize the `(S, maxp)` int32 page table for one
        dispatch at the current rung width (`maxp = rung // ps`);
        unmapped entries read the null page (hidden by the cache
        mask)."""
        tab = np.zeros((slots, maxp), np.int32)
        for slot, entries in self._slots.items():
            for j, e in enumerate(entries):
                if j >= maxp:
                    break
                tab[slot, j] = e.phys
        return tab

    # -- observability -----------------------------------------------------
    def occupancy(self):
        """Pool occupancy snapshot for /generation and /health: how
        many allocatable pages exist, are mapped by live slots, sit
        cold-but-resident, or are free."""
        mapped = sum(len(v) for v in self._slots.values())
        shared_live = sum(1 for s in self._shared.values() if s.refs > 0)
        cold = sum(1 for s in self._shared.values() if s.refs == 0)
        total = self.num_pages - 1
        return {"pages_total": total,
                "pages_active": total - len(self._free) - cold,
                "pages_mapped": mapped,
                "pages_shared": shared_live,
                "pages_cold": cold,
                "pages_free": len(self._free),
                "page_size": self.page_size}
