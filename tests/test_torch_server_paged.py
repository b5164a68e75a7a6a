"""The port's paged, int8 and drafting GenerationServer, on the CPU at
bert_tiny: the contracts of the JAX package's tests/test_paged.py and the
int8 server case of tests/test_quantize.py, held inside the port (paged
streams equal dense streams bit for bit, greedy and sampled; prefix
sharing and copy-on-write; a typed refusal when the pool is exhausted;
growth as a relabel; one host fetch per block plus one per admission;
drafted streams equal undrafted ones), and the port's paged streams
against the streams the JAX dense server computes on the same workload
(four of test_paged.py's own tests fail in the JAX package, so the
comparison is of outputs, not of outcomes)."""
import numpy as np
import pytest

import jax

from deeplearning4j_tpu.generation import BertDecoder as JaxDecoder
from deeplearning4j_tpu.generation import GenerationServer as JaxServer
from deeplearning4j_tpu.models import bert as jb
from deeplearning4j_tpu_torch.generation import (BertDecoder,
                                                 GenerationServer, status)
from deeplearning4j_tpu_torch.models import bert as tb
from deeplearning4j_tpu_torch.models.convert import params_from_numpy
from deeplearning4j_tpu_torch.resilience.errors import (
    MemoryPressureError, PagePoolExhaustedError)

PS = 8          # page size of every paged server here
#: test_paged.py's ragged mixed-sampling workload: page counts 1/2/3/1 at
#: ps=8; the sampled slots prove the rng streams are untouched by paging
WORKLOAD = [
    dict(prompt=[1, 4, 2], max_new_tokens=8),
    dict(prompt=[5, 6, 7, 8, 9, 10, 11, 12, 13], max_new_tokens=8,
         method="temperature", temperature=0.8),
    dict(prompt=list(range(1, 18)), max_new_tokens=10, method="top_k",
         temperature=0.9, top_k=3),
    dict(prompt=[2, 2, 5, 3], max_new_tokens=6),
]
KNOBS = dict(slots=3, cache_lengths=[16, 32], prompt_buckets=[8, 24], seed=3)


@pytest.fixture(scope="module")
def bert():
    cfg = jb.bert_tiny()
    jp = jb.init_bert_params(cfg, jax.random.PRNGKey(1))
    tcfg = tb.bert_tiny()
    tp = params_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return cfg, jp, tcfg, tp


def _server(bert, paged, kv_dtype="fp", pool_pages=40, **kw):
    _, _, tcfg, tp = bert
    dkw = dict(kv_dtype=kv_dtype)
    if paged:
        dkw.update(page_size=PS, pool_pages=pool_pages)
    srv = GenerationServer(BertDecoder(tcfg, tp, **dkw),
                           **{**KNOBS, **kw})
    srv.warmup()
    return srv


def _run(srv, workload=WORKLOAD):
    try:
        reqs = [srv.submit(**dict(w)) for w in workload]
        return [r.result(timeout=120) for r in reqs]
    finally:
        srv.shutdown()


@pytest.fixture(scope="module")
def dense_streams(bert):
    return _run(_server(bert, paged=False))


@pytest.fixture(scope="module")
def jax_dense_streams(bert):
    cfg, jp, _, _ = bert
    srv = JaxServer(JaxDecoder(cfg, jp), **KNOBS)
    srv.warmup()
    try:
        reqs = [srv.submit(**dict(w)) for w in WORKLOAD]
        return [r.result(timeout=120) for r in reqs]
    finally:
        srv.shutdown()


@pytest.mark.parametrize("superstep", [1, 3])
def test_paged_streams_equal_dense_and_the_jax_dense_server(
        bert, dense_streams, jax_dense_streams, superstep):
    srv = _server(bert, paged=True, superstep=superstep)
    got = _run(srv)
    assert got == dense_streams
    assert got == jax_dense_streams
    st = srv.status()
    occ = st["page_pool"]
    assert st["paged"] and occ["pages_total"] == 39 and occ["page_size"] == PS
    # every retired request's private pages went back to the free list;
    # its prompt pages stay resident cold
    assert occ["pages_mapped"] == 0 and occ["pages_cold"] > 0
    # ragged tails copy-on-wrote before their first generated row
    assert occ["cow_copies"] >= 1
    assert st["rung"] == 32                 # grew from 16 by a relabel
    # one host fetch per delivered block plus one per admission
    assert st["token_fetches"] == st["steps"] + st["admissions"]
    assert st["admissions"] == st["retirements"] == len(WORKLOAD)


@pytest.mark.parametrize("superstep", [1, 3])
def test_int8_paged_streams_equal_int8_dense(bert, superstep):
    """The quantized pool reads through the same gather: int8 paged
    against int8 dense is exact (the same bytes feed the same
    arithmetic)."""
    want = _run(_server(bert, paged=False, kv_dtype="int8",
                        superstep=superstep))
    got = _run(_server(bert, paged=True, kv_dtype="int8",
                       superstep=superstep))
    assert got == want


def test_int8_server_greedy_stream_equals_fp(bert):
    """tests/test_quantize.py::test_int8_generation_server_stream on the
    port: the int8-cache server serves the fp server's greedy stream."""
    _, _, tcfg, _ = bert
    prompt = list(np.random.default_rng(11).integers(1, tcfg.vocab_size, 5))
    streams = []
    for kv_dtype in ("int8", "fp"):
        srv = _server(bert, paged=False, kv_dtype=kv_dtype, slots=2,
                      cache_lengths=[32], prompt_buckets=[8],
                      max_new_tokens=5, seed=0)
        streams.append(_run(srv, [dict(prompt=prompt)])[0])
    assert streams[0] == streams[1] and len(streams[0]) == 5


def test_prefix_sharing_dedups_across_requests(bert):
    """Two identical prompts: the second admission maps the first's
    resident pages (full pages and the tail), writes nothing but its
    copy-on-write, and streams identically."""
    srv = _server(bert, paged=True, cache_lengths=[32], prompt_buckets=[24])
    try:
        p = list(range(1, 18))                 # 3 pages: 2 full + tail
        a = srv.generate(p, max_new_tokens=4, timeout=120)
        st0 = dict(srv._pages.stats)
        b = srv.generate(p, max_new_tokens=4, timeout=120)
        assert a == b
        st = srv.serving_state()["page_pool"]
        assert st["prefix_hits"] == st0["prefix_hits"] + 1
        assert st["pages_reused"] >= st0["pages_reused"] + 3
        assert st["cow_copies"] >= st0["cow_copies"] + 1
        assert any(s.get("paged") and "page_pool" in s
                   for s in status()["servers"])
    finally:
        srv.shutdown()


def test_pool_exhaustion_refuses_typed_and_contains(bert):
    """A request the pool cannot hold fails with PagePoolExhaustedError (a
    MemoryPressureError) before dispatch; the server stays up and serves
    a fitting request right after."""
    srv = _server(bert, paged=True, pool_pages=3,   # 2 pages = 16 rows
                  cache_lengths=[32], prompt_buckets=[24], slots=2)
    try:
        big = srv.submit(list(range(1, 18)), max_new_tokens=4)  # 3 pages
        with pytest.raises(PagePoolExhaustedError):
            big.result(timeout=120)
        assert isinstance(big.error, MemoryPressureError)
        assert srv.serving_state()["state"] == "serving"
        assert len(srv.generate([1, 2, 3], max_new_tokens=4,
                                timeout=120)) == 4
        assert srv.status()["admissions"] == 1
    finally:
        srv.shutdown()


def test_paged_growth_is_a_host_side_relabel(bert):
    srv = _server(bert, paged=True)
    try:
        keys = [k for k in srv._store._entries]
        assert not any(str(k[0]).startswith("grow_to") for k in keys)
        assert ("page_copy",) in keys
        assert srv._rung == 16
        toks = srv.generate(list(range(1, 18)), max_new_tokens=10,
                            timeout=120)       # needs rung 32
        assert len(toks) == 10 and srv._rung == 32
    finally:
        srv.shutdown()


#: greedy and sampled requests; the first greedy stream repeats a bigram
#: on this random init (…, 38, 115, 124, 38, 115, …), so a prompt-lookup
#: draft is accepted
DRAFT_WORKLOAD = [dict(prompt=[3, 1, 4, 1, 5, 9, 2], max_new_tokens=12),
                  dict(prompt=[1, 4, 2, 1, 4, 2], max_new_tokens=10),
                  dict(prompt=[2, 2, 5, 3], max_new_tokens=8),
                  dict(prompt=[9, 3, 1], max_new_tokens=9,
                       method="temperature", temperature=0.7)]


@pytest.mark.parametrize("paged", [False, True])
def test_drafted_streams_equal_undrafted_dense(bert, paged):
    want = _run(_server(bert, paged=False), DRAFT_WORKLOAD)
    srv = _server(bert, paged=paged, draft=2)
    got = _run(srv, DRAFT_WORKLOAD)
    assert got == want
    st = srv.status()
    assert st["draft"] == 2 and st["supersteps"] == st["steps"] > 0
    assert st["draft_accepts"] > 0
    assert st["token_fetches"] == st["steps"] + st["admissions"]
    assert ("verify", 32, 2) in srv._store._entries


def test_knob_validation(bert):
    """tests/test_paged.py::test_paged_decoder_knob_validation, and the
    drafting knobs that the JAX server refuses."""
    _, _, tcfg, tp = bert
    with pytest.raises(ValueError):
        BertDecoder(tcfg, tp, page_size=8)             # pool required
    with pytest.raises(ValueError):
        BertDecoder(tcfg, tp, pool_pages=16)           # size required
    with pytest.raises(ValueError):
        BertDecoder(tcfg, tp, page_size=8, pool_pages=1)
    with pytest.raises(ValueError, match="divisible"):
        # rungs must be whole pages
        GenerationServer(BertDecoder(tcfg, tp, page_size=8, pool_pages=16),
                         cache_lengths=[12])
    with pytest.raises(ValueError, match="pick one"):
        GenerationServer(BertDecoder(tcfg, tp), draft=2, superstep=2,
                         cache_lengths=[32])
    with pytest.raises(ValueError, match="draft-verify"):
        GenerationServer(BertDecoder(tcfg, tp, kv_dtype="int8"), draft=1,
                         cache_lengths=[32])
    with pytest.raises(ValueError, match="draft must be"):
        GenerationServer(BertDecoder(tcfg, tp), draft=-1,
                         cache_lengths=[32])
