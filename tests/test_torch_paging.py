"""The port's page allocator (deeplearning4j_tpu_torch/generation/paging.py)
and page gathers against the JAX package's, on the CPU: one seeded
sequence of admissions, coverage extensions, releases, evictions, table
builds and exhaustions drives both allocators, and every return value,
exception type, `stats` and `occupancy()` must be equal at every step.
The gathers must equal the reference's exactly."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.generation import paging as jpaging
from deeplearning4j_tpu.kernels import gather_kv_pages as jgather_kv
from deeplearning4j_tpu.kernels import gather_scale_pages as jgather_scale
from deeplearning4j_tpu.resilience import errors as jerrors
from deeplearning4j_tpu_torch.generation import paging as tpaging
from deeplearning4j_tpu_torch.kernels import (gather_kv_pages,
                                              gather_scale_pages)
from deeplearning4j_tpu_torch.resilience import errors as terrors


def _call(alloc, op, args):
    """(kind, value) of one allocator call: its return value as plain
    python, or the name of the exception it raised."""
    try:
        out = getattr(alloc, op)(*args)
    except (jerrors.PagePoolExhaustedError,
            terrors.PagePoolExhaustedError) as e:
        return ("raised", type(e).__name__,
                isinstance(e, (jerrors.MemoryPressureError,
                               terrors.MemoryPressureError)))
    if isinstance(out, np.ndarray):
        return ("array", out.dtype.str, out.tolist())
    return ("value", out)


def _ops(seed, slots, page_size, n):
    """A seeded op sequence: prompts drawn from a few shared prefixes (so
    that prefixes, tails and whole prompts repeat), coverage extensions
    past each slot's prompt, releases, evictions and table builds."""
    rng = np.random.default_rng(seed)
    bases = [rng.integers(1, 50, 40).tolist() for _ in range(3)]
    pos = {}
    ops = []
    for _ in range(n):
        kind = rng.choice(["admit", "admit", "ensure", "ensure", "release",
                           "evict", "table"])
        slot = int(rng.integers(0, slots))
        if kind == "admit":
            base = bases[int(rng.integers(0, len(bases)))]
            plen = int(rng.integers(1, 3 * page_size + 3))
            prompt = list(base[:plen])
            if rng.random() < 0.3:
                prompt[-1] = int(rng.integers(50, 60))     # a new tail
            pbucket = int(rng.choice([8, 16, 24, 32]))
            pbucket = max(pbucket, plen)
            ops.append(("admit_slot", (slot, prompt, pbucket)))
            pos[slot] = plen
        elif kind == "ensure" and slot in pos:
            lo = pos[slot]
            hi = lo + int(rng.integers(0, 2 * page_size))
            ops.append(("ensure_range", (slot, lo, hi)))
            pos[slot] = hi + 1
        elif kind == "release":
            ops.append(("release_slot", (slot,)))
            pos.pop(slot, None)
        elif kind == "evict":
            want = None if rng.random() < 0.3 else int(rng.integers(1, 3))
            ops.append(("evict_cold", (want,)))
        else:
            ops.append(("build_table", (slots, int(rng.integers(1, 6)))))
    return ops


@pytest.mark.parametrize("pages,page_size,seed", [(12, 4, 0), (9, 4, 1),
                                                  (20, 8, 2), (6, 2, 3)])
def test_allocator_matches_reference_over_a_seeded_sequence(pages,
                                                            page_size,
                                                            seed):
    ja = jpaging.PageAllocator(pages, page_size)
    ta = tpaging.PageAllocator(pages, page_size)
    assert tpaging.NULL_PAGE == jpaging.NULL_PAGE == 0
    raised = 0
    for step, (op, args) in enumerate(_ops(seed, 4, page_size, 300)):
        want, got = _call(ja, op, args), _call(ta, op, args)
        assert got == want, (step, op, args)
        raised += got[0] == "raised"
        assert ta.stats == ja.stats, (step, op)
        assert ta.occupancy() == ja.occupancy(), (step, op)
    # the sequence reached every kind of outcome it exists to compare
    assert raised > 0
    for key in ("prefix_hits", "pages_reused", "cow_copies", "evictions"):
        assert ta.stats[key] > 0, (key, ta.stats)


def test_exhaustion_rolls_back_and_is_a_memory_pressure_error():
    for mod, err in ((jpaging, jerrors), (tpaging, terrors)):
        a = mod.PageAllocator(4, 4)
        with pytest.raises(err.PagePoolExhaustedError) as ei:
            a.admit_slot(0, list(range(16)), 16)       # needs 4 pages
        assert isinstance(ei.value, err.MemoryPressureError)
        assert "RESOURCE_EXHAUSTED" in str(ei.value)
        assert a.occupancy()["pages_free"] == 3
    assert issubclass(terrors.PagePoolExhaustedError,
                      terrors.MemoryPressureError)
    assert terrors.__all__ == jerrors.__all__


@pytest.mark.parametrize("shape,table", [
    ((5, 2, 4, 3), [[2, 0], [1, 4]]),
    ((9, 3, 8, 16), [[3, 1, 0, 0], [8, 7, 6, 5], [0, 0, 0, 0]]),
    ((4, 12, 16, 64), [[1, 2, 3]])])
def test_gathers_equal_the_reference_exactly(shape, table):
    rng = np.random.default_rng(7)
    pool = rng.standard_normal(shape).astype(np.float32)
    spool = rng.standard_normal(shape[:3]).astype(np.float32)
    tab = np.asarray(table, np.int32)
    want = np.asarray(jgather_kv(jnp.asarray(pool),
                                          jnp.asarray(tab)))
    got = gather_kv_pages(torch.from_numpy(pool), torch.from_numpy(tab))
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    swant = np.asarray(jgather_scale(jnp.asarray(spool),
                                              jnp.asarray(tab)))
    sgot = gather_scale_pages(torch.from_numpy(spool),
                              torch.from_numpy(tab.astype(np.int64)))
    np.testing.assert_array_equal(sgot.numpy(), swant)
    # an int8 pool gathers byte for byte too
    q = rng.integers(-127, 128, shape).astype(np.int8)
    np.testing.assert_array_equal(
        gather_kv_pages(torch.from_numpy(q), torch.from_numpy(tab)).numpy(),
        np.asarray(jgather_kv(jnp.asarray(q), jnp.asarray(tab))))
