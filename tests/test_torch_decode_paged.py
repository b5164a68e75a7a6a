"""The port's BertDecoder in its int8, paged fp, paged int8 and draft-verify
modes against the JAX BertDecoder over the same bert_tiny parameters, on
the CPU. Two prompts are prefilled into slots 0 and 2 of three (slot 1
idle), then decoded for five steps on the JAX greedy tokens; paged runs
take their write-redirect rows and page tables from one `PageAllocator`,
shared by both packages. Logits agree to 1e-5 (fp) and 1e-4 (int8); cache
rows (every mapped page when paged) agree to 1e-5, and int8 bytes
exactly but for at most 1 LSB on at most 0.1 % of them (an f32 rounding
boundary may fall differently: measured 0 bytes off here)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.generation.decode import BertDecoder as JaxDecoder
from deeplearning4j_tpu.models import bert as jb
from deeplearning4j_tpu_torch.generation.decode import BertDecoder
from deeplearning4j_tpu_torch.generation.paging import NULL_PAGE, PageAllocator
from deeplearning4j_tpu_torch.models import bert as tb
from deeplearning4j_tpu_torch.models.convert import params_from_numpy

SLOTS, RUNG, PS, POOL = 3, 32, 8, 13
PROMPTS = {0: (7, 8), 2: (13, 16)}          # slot: (prompt length, bucket)
STEPS = 5
TOL = {"fp": dict(atol=1e-5, rtol=1e-5), "int8": dict(atol=1e-4, rtol=1e-4)}


@pytest.fixture(scope="module")
def params():
    cfg = jb.bert_tiny()
    jp = jb.init_bert_params(cfg, jax.random.PRNGKey(1))
    tcfg = tb.bert_tiny()
    tp = params_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return cfg, jp, tcfg, tp


def _decoders(params, kv_dtype, paged):
    cfg, jp, tcfg, tp = params
    kw = dict(kv_dtype=kv_dtype)
    if paged:
        kw.update(page_size=PS, pool_pages=POOL)
    return JaxDecoder(cfg, jp, **kw), BertDecoder(tcfg, tp, **kw)


def _prompts():
    rng = np.random.default_rng(3)
    return {s: rng.integers(1, 128, plen).astype(np.int32)
            for s, (plen, _) in PROMPTS.items()}


def _compare_cache(tc, jc, kv_dtype, pages=None, what=""):
    """Every entry of the two caches (only `pages` of a pool): f32 to 1e-5,
    int8 at most 1 LSB apart on at most 0.1 % of the bytes."""
    for name, t in tc.items():
        got, want = t.numpy(), np.asarray(jc[name])
        if pages is not None:
            got, want = got[:, pages], want[:, pages]
        if got.dtype == np.int8:
            diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1, (what, name)
            off = int((diff > 0).sum())
            assert off <= 1e-3 * got.size, (what, name, off)
        else:
            np.testing.assert_allclose(got, want, **TOL["fp"],
                                       err_msg=f"{what} {name}")


def _prefill_both(jd, td, alloc):
    """Prefill the prompts in both packages; returns the caches, the
    per-slot positions and each slot's first (JAX greedy) token."""
    jc, tc = jd.init_cache(SLOTS, RUNG), td.init_cache(SLOTS, RUNG)
    prompts = _prompts()
    pos = np.zeros(SLOTS, np.int64)
    first = {}
    for slot, prompt in prompts.items():
        plen, bucket = PROMPTS[slot]
        padded = np.pad(prompt, (0, bucket - plen))
        extra_j, extra_t = (), ()
        if alloc is not None:
            wrow = alloc.admit_slot(slot, prompt, bucket)
            extra_j = (jnp.asarray(wrow),)
            extra_t = (torch.from_numpy(wrow.astype(np.int64)),)
        jc, jl = jd.prefill(jd.model_args(), jc, jnp.int32(slot),
                            jnp.asarray(padded), jnp.int32(plen), *extra_j)
        tc, tl = td.prefill(td.model_args(), tc, slot,
                            torch.from_numpy(padded.astype(np.int64)), plen,
                            *extra_t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   **TOL[td.kv_dtype])
        pos[slot] = plen
        first[slot] = int(np.argmax(np.asarray(jl)))
    return jc, tc, pos, first


def _table(alloc, pos, k):
    for slot in PROMPTS:
        alloc.ensure_range(slot, int(pos[slot]), int(pos[slot]) + k - 1)
    return alloc.build_table(SLOTS, RUNG // PS)


def _mapped(alloc):
    tab = alloc.build_table(SLOTS, RUNG // PS)
    return sorted(set(tab.ravel().tolist()) - {NULL_PAGE})


@pytest.mark.parametrize("kv_dtype,paged", [("int8", False), ("fp", True),
                                            ("int8", True)])
def test_prefill_and_steps_match_jax(params, kv_dtype, paged):
    jd, td = _decoders(params, kv_dtype, paged)
    alloc = PageAllocator(POOL, PS) if paged else None
    jc, tc, pos, first = _prefill_both(jd, td, alloc)
    toks = np.zeros(SLOTS, np.int64)
    for slot, tok in first.items():
        toks[slot] = tok
    for t in range(STEPS):
        extra_j, extra_t = (), ()
        if paged:
            tab = _table(alloc, pos, 1)
            extra_j = (jnp.asarray(tab),)
            extra_t = (torch.from_numpy(tab.astype(np.int64)),)
        jl, jc = jd.step(jd.model_args(), jc, jnp.asarray(toks),
                         jnp.asarray(pos), *extra_j)
        tl, tc = td.step(td.model_args(), tc, torch.from_numpy(toks),
                         torch.from_numpy(pos), *extra_t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   **TOL[kv_dtype], err_msg=f"step {t}")
        _compare_cache(tc, jc, kv_dtype,
                              _mapped(alloc) if paged else None, f"step {t}")
        greedy = np.asarray(jl).argmax(axis=-1)
        for slot in PROMPTS:
            toks[slot] = greedy[slot]
            pos[slot] += 1
    if paged:
        assert len(_mapped(alloc)) >= 4


@pytest.mark.parametrize("paged", [False, True])
def test_verify_matches_jax_and_its_first_query_equals_step(params, paged):
    jd, td = _decoders(params, "fp", paged)
    alloc = PageAllocator(POOL, PS) if paged else None
    jc, tc, pos, first = _prefill_both(jd, td, alloc)
    toks = np.zeros(SLOTS, np.int64)
    for slot, tok in first.items():
        toks[slot] = tok
    draft = np.asarray([[5, 9], [0, 0], [toks[2], 3]], np.int64)
    extra_j, extra_t = (), ()
    if paged:
        tab = _table(alloc, pos, 3)
        extra_j = (jnp.asarray(tab),)
        extra_t = (torch.from_numpy(tab.astype(np.int64)),)
    step_cache = {k: v.clone() for k, v in tc.items()}
    sl, _ = td.step(td.model_args(), step_cache, torch.from_numpy(toks),
                    torch.from_numpy(pos), *extra_t)
    jl, jc = jd.verify(jd.model_args(), jc, jnp.asarray(toks),
                       jnp.asarray(pos), jnp.asarray(draft), *extra_j)
    tl, tc = td.verify(td.model_args(), tc, torch.from_numpy(toks),
                       torch.from_numpy(pos), torch.from_numpy(draft),
                       *extra_t)
    assert tl.shape == (SLOTS, 3, 128)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL["fp"])
    np.testing.assert_allclose(tl[:, 0].numpy(), sl.numpy(), **TOL["fp"])
    _compare_cache(tc, jc, "fp", _mapped(alloc) if paged else None,
                   "verify")


def test_page_copy_and_grow(params):
    _, td = _decoders(params, "int8", True)
    pool = td.init_cache(SLOTS, RUNG)
    assert pool["k"].shape == (2, POOL, 4, PS, 8)
    assert pool["ks"].shape == (2, POOL, 4, PS)
    assert (pool["ks"] == 1).all() and not pool["k"].any()
    pool["k"][:, 3] = 7
    pool["ks"][:, 3] = 0.5
    td.page_copy(pool, torch.tensor([3]), torch.tensor([5]))
    assert (pool["k"][:, 5] == 7).all() and (pool["ks"][:, 5] == 0.5).all()
    assert td.grow(pool, 64) is pool
    _, dense = _decoders(params, "int8", False)
    cache = dense.init_cache(2, 8)
    cache["ks"].fill_(0.25)
    big = dense.grow(cache, 16)
    assert big["k"].shape == (2, 2, 4, 16, 8)
    # scale rows beyond the shorter rung start at 1, as the JAX pad does
    assert (big["ks"][..., :8] == 0.25).all()
    assert (big["ks"][..., 8:] == 1).all()
