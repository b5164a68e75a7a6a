"""The port's BertDecoder (deeplearning4j_tpu_torch/generation/decode.py)
against the JAX BertDecoder and against the port's own causal full
forward, at bert_tiny on the CPU. Tolerance 1e-5 (f32)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.generation.decode import BertDecoder as JaxDecoder
from deeplearning4j_tpu.models import bert as jb
from deeplearning4j_tpu_torch.generation.decode import BertDecoder
from deeplearning4j_tpu_torch.models import bert as tb
from deeplearning4j_tpu_torch.models.convert import params_from_numpy

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def decoders():
    cfg = jb.bert_tiny()
    jp = jb.init_bert_params(cfg, jax.random.PRNGKey(1))
    tcfg = tb.bert_tiny()
    tp = params_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return JaxDecoder(cfg, jp), BertDecoder(tcfg, tp)


def _full_forward_logits(dec, seq):
    ids = torch.as_tensor(np.asarray(seq, np.int64))[None]
    h = tb.bert_encode(dec.cfg, dec.params, ids, causal=True)
    return tb.bert_mlm_logits(dec.cfg, dec.params, h)[0, -1]


def test_prefill_and_steps_match_jax_and_full_forward(decoders):
    jd, td = decoders
    rng = np.random.default_rng(3)
    prompt = rng.integers(1, 128, 7).astype(np.int32)
    plen, slots = len(prompt), 3
    padded = np.pad(prompt, (0, 9))                 # prompt bucket 16
    jc = jd.init_cache(slots, 32)
    tc = td.init_cache(slots, 32)
    jc, jl = jd.prefill(jd.model_args(), jc, jnp.int32(1),
                        jnp.asarray(padded), jnp.int32(plen))
    tc, tl = td.prefill(td.model_args(), tc, 1,
                        torch.from_numpy(padded.astype(np.int64)), plen)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tl.numpy(),
                               _full_forward_logits(td, prompt).numpy(),
                               **TOL)
    seq = list(prompt)
    tok = int(np.argmax(np.asarray(jl)))
    for t in range(3):
        seq.append(tok)
        toks = np.zeros(slots, np.int64)
        pos = np.zeros(slots, np.int64)
        toks[1], pos[1] = tok, plen + t
        jl, jc = jd.step(jd.model_args(), jc, jnp.asarray(toks),
                         jnp.asarray(pos))
        tl, tc = td.step(td.model_args(), tc, torch.from_numpy(toks),
                         torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_allclose(
            tl[1].numpy(), _full_forward_logits(td, seq).numpy(), **TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(tc[name].numpy(),
                                       np.asarray(jc[name]), **TOL)
        tok = int(np.argmax(np.asarray(jl)[1]))


def test_grow_pads_the_cache_rung(decoders):
    _, td = decoders
    cache = td.init_cache(2, 8)
    cache["k"].normal_()
    cache["v"].normal_()
    big = td.grow(cache, 16)
    assert big["k"].shape == (2, 2, 4, 16, 8)
    for name in ("k", "v"):
        assert torch.equal(big[name][:, :, :, :8], cache[name])
        assert torch.all(big[name][:, :, :, 8:] == 0)


def test_frozen_lane_at_the_rung_end_leaves_the_cache_untouched(decoders):
    """A frozen lane may sit at pos == C; JAX drops that out-of-range
    scatter, and the port must not write anywhere either."""
    jd, td = decoders
    c, slots = 8, 2
    g = torch.Generator().manual_seed(0)
    tc = {n: torch.randn((2, slots, 4, c, 8), generator=g)
          for n in ("k", "v")}
    jc = {n: jnp.asarray(t.numpy()) for n, t in tc.items()}
    before = {n: t.clone() for n, t in tc.items()}
    toks = np.array([5, 9], np.int64)
    pos = np.array([c, 3], np.int64)                # lane 0 is frozen at C
    tl, tc = td.step(td.model_args(), tc, torch.from_numpy(toks),
                     torch.from_numpy(pos))
    jl, jc = jd.step(jd.model_args(), jc, jnp.asarray(toks),
                     jnp.asarray(pos))
    for name in ("k", "v"):
        assert torch.equal(tc[name][:, 0], before[name][:, 0])
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_decoder_rejects_what_waits_for_later_slices(decoders):
    """What the decoder still refuses: MoE layers (the expert-parallel
    slice), the TPU kernel name, an int8 cache on the fp decode kernel,
    pool sizes without a page size and the reverse, and drafting over an
    int8 cache. The int8 cache, paged mode and `verify` itself run
    (tests/test_torch_decode_paged.py)."""
    _, td = decoders
    with pytest.raises(NotImplementedError, match="MoE"):
        BertDecoder(tb.bert_tiny(moe_layers=(1,)), td.params)
    with pytest.raises(ValueError, match="attn_impl"):
        BertDecoder(td.cfg, td.params, attn_impl="pallas")
    with pytest.raises(ValueError, match="int8-cache"):
        BertDecoder(td.cfg, td.params, attn_impl="kernel", kv_dtype="int8")
    with pytest.raises(ValueError, match="pool_pages"):
        BertDecoder(td.cfg, td.params, page_size=4)
    with pytest.raises(ValueError, match="requires page_size"):
        BertDecoder(td.cfg, td.params, pool_pages=8)
    q8 = BertDecoder(td.cfg, td.params, kv_dtype="int8")
    assert not q8.supports_draft and td.supports_draft
    with pytest.raises(ValueError, match="fp cache"):
        q8.verify(q8.model_args(), q8.init_cache(1, 8), None, None, None)
    assert td.fingerprint() == BertDecoder(td.cfg, td.params).fingerprint()
    assert td.fingerprint() != BertDecoder(td.cfg, td.params,
                                           attn_impl="dense").fingerprint()
    assert td.fingerprint() != q8.fingerprint()
    assert td.fingerprint() != BertDecoder(
        td.cfg, td.params, page_size=4, pool_pages=8).fingerprint()
