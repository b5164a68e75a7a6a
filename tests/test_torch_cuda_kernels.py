"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked `cuda` and skips without a CUDA device:
the kernels have no CPU mode. The file imports nothing of JAX, so it also
runs on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_kernels.py

Tolerances: f32 2e-5 (the kernel sums in another order than the plain
version), bf16 2e-2 (the output is rounded to 8 mantissa bits); gradients,
and the epilogue GEMM and bottleneck outputs, are held to the same
tolerances scaled by max(1, max |plain|). The int8 epilogue's int32 sums
are exact, its f32 epilogue is held to rtol 1e-5."""
import importlib

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.generation.decode import BertDecoder
from deeplearning4j_tpu_torch.kernels import layernorm as tln
from deeplearning4j_tpu_torch.kernels import pointwise_conv as tpc
from deeplearning4j_tpu_torch.kernels import residual_block as trb
from deeplearning4j_tpu_torch.models import bert_tiny, init_bert_params
from deeplearning4j_tpu_torch.models.zoo import ResNet50

tfa = importlib.import_module(
    "deeplearning4j_tpu_torch.kernels.flash_attention")

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "mode (chip_smoke.py runs them on the H100)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
def test_cuda_kernels_match_plain_versions(card, dtype, atol):
    gen = torch.Generator(device=card).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=card).to(dtype)

    q, k, v = rnd(3, 4, 70, 64), rnd(3, 4, 70, 64), rnd(3, 4, 70, 64)
    mask = torch.arange(70, device=card)[None] < torch.tensor(
        [70, 33, 0], device=card)[:, None]
    for causal, km in ((False, mask), (True, None)):
        out, lse = tfa.flash_fwd(q, k, v, km, causal)
        ref, ref_lse = tfa._flash_forward_reference(q, k, v, km, causal)
        assert (out.float() - ref.float()).abs().max() <= atol
        assert (lse - ref_lse).abs().max() <= atol
        again = tfa.flash_fwd(q, k, v, km, causal)
        assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    out = tfa.flash_decode(q[:, :, :1], k, v, mask)
    ref = tfa._decode_reference(q[:, :, :1], k, v, mask)
    assert (out.float() - ref.float()).abs().max() <= atol
    assert out[2].abs().max() == 0
    # the backward pair, self-attention with a fully padded example, causal,
    # and cross-attention with a key mask
    g = rnd(3, 4, 70, 64)
    kc, vc = rnd(3, 4, 45, 64), rnd(3, 4, 45, 64)
    kvm = torch.arange(45, device=card)[None] < torch.tensor(
        [45, 20, 1], device=card)[:, None]
    for qm, km, causal, kk, vv in ((mask, mask, False, k, v),
                                   (None, None, True, k, v),
                                   (None, kvm, False, kc, vc)):
        o, lse = tfa._flash_forward(q, kk, vv, qm, km, causal)
        delta = tfa._delta(g, o)
        args = (q, kk, vv, g, lse, delta, km, causal)
        got = (tfa.flash_bwd_dq(*args), *tfa.flash_bwd_dkv(*args))
        want = (tfa._dq_reference(*args), *tfa._dkv_reference(*args))
        again = (tfa.flash_bwd_dq(*args), *tfa.flash_bwd_dkv(*args))
        for a, b, c in zip(got, want, again):
            assert a.dtype == dtype and a.shape == b.shape
            scale = max(1.0, b.float().abs().max().item())
            assert (a.float() - b.float()).abs().max() <= atol * scale
            assert torch.equal(a, c)          # no atomics: bit-identical
        if qm is not None:
            assert all(t[2].abs().max() == 0 for t in got)
    # the tensor-core tile's other paths, for flash_fwd and flash_bwd_dq:
    # head dims 16 and 32, ragged Tq and Tk, a prefill-shaped causal grid
    # (1×12×128: one warp per block) and right padding that empties whole
    # key tiles (Tk = 200, lengths 200, 70 and 0: the empty example walks
    # every tile and comes out as the mean of V)
    for (b, h, tq, tk, d), lens, causal in (
            ((3, 4, 70, 70, 16), [70, 33, 0], False),
            ((3, 4, 70, 45, 32), [45, 20, 1], False),
            ((2, 3, 45, 45, 32), None, True),
            ((1, 12, 128, 128, 64), None, True),
            ((3, 2, 200, 200, 64), [200, 70, 0], False)):
        q2, g2 = rnd(b, h, tq, d), rnd(b, h, tq, d)
        k2, v2 = rnd(b, h, tk, d), rnd(b, h, tk, d)
        km = None if lens is None else (
            torch.arange(tk, device=card)[None]
            < torch.tensor(lens, device=card)[:, None])
        out, lse = tfa.flash_fwd(q2, k2, v2, km, causal)
        ref, ref_lse = tfa._flash_forward_reference(q2, k2, v2, km, causal)
        assert (out.float() - ref.float()).abs().max() <= atol
        assert (lse - ref_lse).abs().max() <= atol
        again = tfa.flash_fwd(q2, k2, v2, km, causal)
        assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
        qm = km if tq == tk else None
        o, lse = tfa._flash_forward(q2, k2, v2, qm, km, causal)
        args = (q2, k2, v2, g2, lse, tfa._delta(g2, o), km, causal)
        dq, dq_again = tfa.flash_bwd_dq(*args), tfa.flash_bwd_dq(*args)
        want = tfa._dq_reference(*args)
        scale = max(1.0, want.float().abs().max().item())
        assert dq.dtype == dtype and dq.shape == want.shape
        assert (dq.float() - want.float()).abs().max() <= atol * scale
        assert torch.equal(dq, dq_again)
        if qm is not None and 0 in lens:
            assert dq[lens.index(0)].abs().max() == 0


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
def test_cuda_flash_bwd_dkv_matches_plain_on_the_tile_paths(card, dtype,
                                                            atol):
    """dK/dV on the tensor-core tile (a warp per 16 keys, query tiles
    walked): head dims 16/32/64, ragged Tq ≠ Tk, a causal 1×12×128 grid
    (one warp a block), Tk = 200 with lengths 200/70/0 (whole key tiles
    masked, a fully padded example) and a padded cross case; each within
    atol × max(1, max |plain|), bit-identical on a re-run, and exactly
    zero for a fully padded example."""
    gen = torch.Generator(device=card).manual_seed(3)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=card).to(dtype)

    for (b, h, tq, tk, d), lens, causal in (
            ((3, 4, 70, 70, 16), [70, 33, 0], False),
            ((3, 4, 70, 45, 32), [45, 20, 1], False),
            ((2, 3, 45, 45, 32), None, True),
            ((1, 12, 128, 128, 64), None, True),
            ((3, 2, 200, 200, 64), [200, 70, 0], False),
            ((2, 4, 100, 300, 64), [300, 0], False),
            ((4, 12, 128, 128, 64), [128, 100, 64, 17], False)):
        q, g = rnd(b, h, tq, d), rnd(b, h, tq, d)
        k, v = rnd(b, h, tk, d), rnd(b, h, tk, d)
        km = None if lens is None else (
            torch.arange(tk, device=card)[None]
            < torch.tensor(lens, device=card)[:, None])
        qm = km if tq == tk else None
        o, lse = tfa._flash_forward(q, k, v, qm, km, causal)
        args = (q, k, v, g, lse, tfa._delta(g, o), km, causal)
        before = tfa.flash_bwd_dkv.launches
        got, again = tfa.flash_bwd_dkv(*args), tfa.flash_bwd_dkv(*args)
        assert tfa.flash_bwd_dkv.launches - before == 2
        want = tfa._dkv_reference(*args)
        for a, w, c in zip(got, want, again):
            scale = max(1.0, w.float().abs().max().item())
            assert a.dtype == dtype and a.shape == w.shape
            assert (a.float() - w.float()).abs().max() <= atol * scale, (
                b, h, tq, tk, d, lens, causal)
            assert torch.equal(a, c)          # no atomics: bit-identical
            if lens is not None and 0 in lens:
                assert a[lens.index(0)].abs().max() == 0


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
def test_cuda_flash_kernels_at_padded_and_wide_head_dims(card, dtype, atol):
    """flash_fwd, flash_bwd_dq and flash_bwd_dkv at head dims the kernels
    are not built for (8 and 24: zero-padded to 16 and 32, scale 1/√D of
    the true D) and at D = 128 (its own instantiation): a self-attention
    case with ragged lengths and a fully padded example, a causal one and
    a cross-length one with a key mask (the LearnedSelfAttentionLayer
    shape). Each within atol × max(1, max |plain|) of the unpadded plain
    version, one launch a call, bit-identical on a re-run, and the
    results of the true head dim's shape."""
    gen = torch.Generator(device=card).manual_seed(5)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=card).to(dtype)

    for d in (8, 24, 128):
        for (b, h, tq, tk), lens, causal in (
                ((3, 4, 40, 40), [40, 17, 0], False),
                ((2, 2, 70, 70), None, True),
                ((3, 4, 4, 40), [40, 9, 1], False)):
            q, g = rnd(b, h, tq, d), rnd(b, h, tq, d)
            k, v = rnd(b, h, tk, d), rnd(b, h, tk, d)
            km = None if lens is None else (
                torch.arange(tk, device=card)[None]
                < torch.tensor(lens, device=card)[:, None])
            qm = km if tq == tk else None
            before = tfa.flash_fwd.launches
            out, lse = tfa.flash_fwd(q, k, v, km, causal)
            assert tfa.flash_fwd.launches - before == 1
            ref, ref_lse = tfa._flash_forward_reference(q, k, v, km, causal)
            assert out.shape == q.shape and out.dtype == dtype
            assert (out.float() - ref.float()).abs().max() <= atol, d
            assert (lse - ref_lse).abs().max() <= atol, d
            assert torch.equal(out, tfa.flash_fwd(q, k, v, km, causal)[0])
            o, lse = tfa._flash_forward(q, k, v, qm, km, causal)
            args = (q, k, v, g, lse, tfa._delta(g, o), km, causal)
            before = (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches)
            got = (tfa.flash_bwd_dq(*args), *tfa.flash_bwd_dkv(*args))
            assert (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches) \
                == (before[0] + 1, before[1] + 1)
            want = (tfa._dq_reference(*args), *tfa._dkv_reference(*args))
            again = (tfa.flash_bwd_dq(*args), *tfa.flash_bwd_dkv(*args))
            for a, w, c in zip(got, want, again):
                scale = max(1.0, w.float().abs().max().item())
                assert a.dtype == dtype and a.shape == w.shape
                assert (a.float() - w.float()).abs().max() <= atol * scale, (
                    d, b, h, tq, tk, lens, causal)
                assert torch.equal(a, c)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
def test_cuda_flash_decode_splits_the_cache_over_a_cluster(card, dtype,
                                                           atol):
    """Decode through a thread-block cluster per (b, h): C = 128, 200 and
    512 (and 1000, two passes a CTA) with lengths 1, 0, C − 1 and C/2 + 3,
    which leave whole cluster shares empty; one launch per call, within
    atol of the plain version, exact zeros for the empty row, bit-identical
    on a re-run. In f32 the shapes reach every cluster size the launch can
    pick (2, 4 and 8)."""
    gen = torch.Generator(device=card).manual_seed(4)
    sizes = set()
    for b, h, c, d in ((4, 24, 128, 64), (4, 24, 200, 64), (4, 24, 512, 64),
                       (4, 3, 1000, 64), (4, 24, 128, 32),
                       (4, 6, 512, 128)):
        lens = [1, 0, c - 1, c // 2 + 3]
        q = torch.randn((b, h, 1, d), generator=gen, device=card).to(dtype)
        k = torch.randn((b, h, c, d), generator=gen, device=card).to(dtype)
        v = torch.randn((b, h, c, d), generator=gen, device=card).to(dtype)
        mask = (torch.arange(c, device=card)[None]
                < torch.tensor(lens, device=card)[:, None])
        before = tfa.flash_decode.launches
        out = tfa.flash_decode(q, k, v, mask)
        assert tfa.flash_decode.launches - before == 1
        again = tfa.flash_decode(q, k, v, mask)
        ref = tfa._decode_reference(q, k, v, mask)
        assert out.dtype == dtype and out.shape == ref.shape
        assert (out.float() - ref.float()).abs().max() <= atol, (b, h, c, d)
        assert out[1].abs().max() == 0
        assert torch.equal(out, again)
        cs = tfa.decode_cluster_size(b, h, c, d, dtype, card)
        assert cs in (2, 4, 8)
        sizes.add(cs)
    if dtype == torch.float32:
        assert sizes == {2, 4, 8}


def _attention_cases(card, dtype, d, gen, cases):
    """flash_fwd, flash_bwd_dq and flash_bwd_dkv at head dim d over
    `cases` ((b, h, tq, tk), key lengths or None, causal): the forward's
    output and lse within atol of the plain version, the gradients within
    atol × max(1, max |plain|), one launch a call, the true head dim's
    shape and dtype, a fully padded example's gradients exactly zero,
    bit-identical on a re-run."""
    atol = {torch.float32: 2e-5, torch.bfloat16: 2e-2}[dtype]

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=card).to(dtype)

    for (b, h, tq, tk), lens, causal in cases:
        q, g = rnd(b, h, tq, d), rnd(b, h, tq, d)
        k, v = rnd(b, h, tk, d), rnd(b, h, tk, d)
        km = None if lens is None else (
            torch.arange(tk, device=card)[None]
            < torch.tensor(lens, device=card)[:, None])
        qm = km if tq == tk else None
        before = tfa.flash_fwd.launches
        out, lse = tfa.flash_fwd(q, k, v, km, causal)
        assert tfa.flash_fwd.launches - before == 1
        ref, ref_lse = tfa._flash_forward_reference(q, k, v, km, causal)
        assert out.shape == q.shape and out.dtype == dtype
        assert (out.float() - ref.float()).abs().max() <= atol, (
            d, b, h, tq, tk, lens, causal)
        assert (lse - ref_lse).abs().max() <= atol, d
        again = tfa.flash_fwd(q, k, v, km, causal)
        assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
        o, lse = tfa._flash_forward(q, k, v, qm, km, causal)
        args = (q, k, v, g, lse, tfa._delta(g, o), km, causal)
        before = (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches)
        got = (tfa.flash_bwd_dq(*args), *tfa.flash_bwd_dkv(*args))
        assert (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches) \
            == (before[0] + 1, before[1] + 1)
        want = (tfa._dq_reference(*args), *tfa._dkv_reference(*args))
        again = (tfa.flash_bwd_dq(*args), *tfa.flash_bwd_dkv(*args))
        for a, w, c in zip(got, want, again):
            scale = max(1.0, w.float().abs().max().item())
            assert a.dtype == dtype and a.shape == w.shape
            assert (a.float() - w.float()).abs().max() <= atol * scale, (
                d, b, h, tq, tk, lens, causal)
            assert torch.equal(a, c)
            if lens is not None and 0 in lens:
                assert a[lens.index(0)].abs().max() == 0


@pytest.mark.parametrize("d", [160, 256, 384, 512, 640])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_kernels_past_head_dim_128(card, dtype, d):
    """The wide kernels (D = 160 zero-padded to 256; D = 384 three
    128-column chunks, split 2 + 1 over the forward's and dQ's two
    warpgroups; D = 640 past f32's 256 output columns a block, so grid z
    splits the columns and the scores run twice, and past bf16's 512):
    self-attention with ragged lengths and a fully padded example, causal,
    and the LearnedSelfAttentionLayer's cross shape (Tq = 4) with a key
    mask, each held to its plain version."""
    gen = torch.Generator(device=card).manual_seed(7)
    _attention_cases(card, dtype, d, gen, (
        ((3, 2, 70, 70), [70, 33, 0], False),
        ((2, 1, 100, 100), None, True),
        ((3, 2, 4, 90), [90, 9, 1], False)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_kernels_at_head_dim_1024(card, dtype):
    """D = 1024 (eight 128-column chunks: four blocks of output columns in
    f32, two in bf16) once at a small shape."""
    gen = torch.Generator(device=card).manual_seed(8)
    _attention_cases(card, dtype, 1024, gen, (
        ((1, 1, 128, 128), [100], False),))


@pytest.mark.parametrize("d", [8, 16, 3, 100, 256, 512, 300, 1024])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
def test_cuda_flash_decode_at_every_head_dim(card, dtype, atol, d):
    """flash_decode at its narrow and wide instantiations (8, 16, 256, 512,
    1024) and at head dims between them (3, 100, 300: the next
    instantiation's geometry at the true row stride, nothing padded): one
    launch a call, within atol of the plain version, an empty row exactly
    zero, bit-identical on a re-run."""
    gen = torch.Generator(device=card).manual_seed(9)
    b, h, c = 4, 3, 200
    lens = [1, 0, c - 1, c // 2 + 3]
    q = torch.randn((b, h, 1, d), generator=gen, device=card).to(dtype)
    k = torch.randn((b, h, c, d), generator=gen, device=card).to(dtype)
    v = torch.randn((b, h, c, d), generator=gen, device=card).to(dtype)
    mask = (torch.arange(c, device=card)[None]
            < torch.tensor(lens, device=card)[:, None])
    before = tfa.flash_decode.launches
    out = tfa.flash_decode(q, k, v, mask)
    assert tfa.flash_decode.launches - before == 1
    ref = tfa._decode_reference(q, k, v, mask)
    assert out.dtype == dtype and out.shape == ref.shape
    assert (out.float() - ref.float()).abs().max() <= atol, d
    assert out[1].abs().max() == 0
    assert torch.equal(out, tfa.flash_decode(q, k, v, mask))
    assert tfa.decode_cluster_size(b, h, c, d, dtype, card) in (2, 4, 8)


@pytest.mark.parametrize("d", [1032, 1536])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
def test_cuda_flash_decode_past_head_dim_1024(card, dtype, atol, d):
    """Past flash_decode's widest instantiation decode runs flash_fwd with
    one query row (D = 1032 padded to 1152; 1536): one flash_fwd launch a
    call and none of flash_decode, within atol of the plain version, an
    empty row exactly zero, bit-identical on a re-run."""
    gen = torch.Generator(device=card).manual_seed(10)
    b, h, c = 4, 3, 200
    lens = [1, 0, c - 1, c // 2 + 3]
    q, k, v = (torch.randn((b, h, t, d), generator=gen, device=card)
               .to(dtype) for t in (1, c, c))
    mask = (torch.arange(c, device=card)[None]
            < torch.tensor(lens, device=card)[:, None])
    before = (tfa.flash_fwd.launches, tfa.flash_decode.launches)
    out = tfa.flash_decode(q, k, v, mask)
    assert (tfa.flash_fwd.launches, tfa.flash_decode.launches) == (
        before[0] + 1, before[1])
    ref = tfa._decode_reference(q, k, v, mask)
    assert out.dtype == dtype and out.shape == ref.shape
    assert (out.float() - ref.float()).abs().max() <= atol, d
    assert out[1].abs().max() == 0
    assert torch.equal(out, tfa.flash_decode(q, k, v, mask))
    auto = tfa.flash_attention_decode(q[:, :, 0], k, v, mask)
    assert torch.equal(auto, out[:, :, 0])


def test_cuda_wrappers_raise_on_what_the_kernels_do_not_take(card):
    x = torch.zeros((1, 2, 8, 64), device=card)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa.flash_fwd(x.half(), x.half(), x.half())
    # every head dim runs (narrow ones padded, wide ones in 128-column
    # chunks); decode past 1024 runs flash_fwd with one query row, which
    # checks what it takes as flash_decode does
    wide = torch.zeros((1, 2, 1, 1032), device=card)
    before = tfa.flash_fwd.launches
    out = tfa.flash_decode(wide, wide, wide, torch.ones(
        (1, 1), dtype=torch.bool, device=card))
    assert tfa.flash_fwd.launches == before + 1
    assert out.shape == wide.shape and out.abs().max() == 0
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa.flash_decode(wide.half(), wide.half(), wide.half(), torch.ones(
            (1, 1), dtype=torch.bool, device=card))
    with pytest.raises(ValueError, match="share one device"):
        tfa.flash_decode(x[:, :, :1], x.cpu(), x, torch.ones(
            (1, 8), dtype=torch.bool, device=card))


def test_cuda_decoder_kernel_path_matches_dense(card):
    """Prefill and three steps of BertDecoder through both kernels agree
    with the same decoder on dense attention, and launch each kernel."""
    _decoder_kernel_path(card, bert_tiny(hidden_size=128, num_heads=2,
                                         intermediate_size=256))


def test_cuda_decoder_kernel_path_matches_dense_at_head_dim_8(card):
    """The same at bert_tiny()'s D = 8: prefill through flash_fwd padded to
    16, the steps through flash_decode's D = 8 instantiation."""
    _decoder_kernel_path(card, bert_tiny())


def _decoder_kernel_path(card, cfg):
    params = init_bert_params(cfg, seed=0, device=card)
    dec, ref = BertDecoder(cfg, params), BertDecoder(cfg, params,
                                                     attn_impl="dense")
    prompt = torch.arange(1, 17, device=card)
    fwd0, dec0 = tfa.flash_fwd.launches, tfa.flash_decode.launches
    caches = [d.init_cache(2, 32) for d in (dec, ref)]
    outs = []
    for d, cache in zip((dec, ref), caches):
        cache, logits = d.prefill(d.model_args(), cache, 1, prompt, 11)
        steps = [logits]
        for t, tok in enumerate((7, 42, 99)):
            tokens = torch.tensor([0, tok], device=card)
            pos = torch.tensor([0, 11 + t], device=card)
            logits, cache = d.step(d.model_args(), cache, tokens, pos)
            steps.append(logits[1])
        outs.append(torch.stack(steps))
    assert (outs[0] - outs[1]).abs().max() <= 1e-4
    assert tfa.flash_fwd.launches - fwd0 == cfg.num_layers
    assert tfa.flash_decode.launches - dec0 == 3 * cfg.num_layers


def test_cuda_flash_attention_trains_through_the_kernels(card):
    """A CUDA tensor that requires grad runs the forward kernel and both
    backward kernels, once each, with the plain backward's gradients."""
    gen = torch.Generator(device=card).manual_seed(1)
    q, k, v = (torch.randn((2, 3, 50, 32), generator=gen, device=card)
               .requires_grad_() for _ in range(3))
    mask = torch.arange(50, device=card)[None] < torch.tensor(
        [50, 17], device=card)[:, None]
    counts = (tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches,
              tfa.flash_bwd_dkv.launches)
    out = tfa.flash_attention(q, k, v, mask=mask)
    g = torch.randn(out.shape, generator=gen, device=card)
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
    assert (tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches,
            tfa.flash_bwd_dkv.launches) == tuple(n + 1 for n in counts)
    o, lse = tfa._flash_forward(q.detach(), k.detach(), v.detach(), mask,
                                mask, False)
    want = tfa._flash_backward_reference(q.detach(), k.detach(), v.detach(),
                                         o, lse, g, mask, False)
    for a, b in zip((dq, dk, dv), want):
        assert (a - b).abs().max() <= 2e-5


def _scaled_err(a, b):
    return ((a.float() - b.float()).abs().max()
            / max(1.0, b.float().abs().max().item())).item()


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
def test_cuda_matmul_epilogue_matches_plain(card, dtype, atol):
    """Ragged M, K and N (tails of every tile), with and without a
    residual, identity and relu; one launch counted per call."""
    gen = torch.Generator(device=card).manual_seed(2)
    for m, k, n in ((70, 12, 9), (300, 64, 32), (257, 200, 130)):
        x = torch.randn((m, k), generator=gen, device=card).to(dtype)
        w = (torch.randn((k, n), generator=gen, device=card)
             / k ** 0.5).to(dtype)
        scale = torch.rand(n, generator=gen, device=card) + 0.5
        shift = torch.randn(n, generator=gen, device=card) * 0.1
        res = torch.randn((m, n), generator=gen, device=card).to(dtype)
        for r, act in ((None, "identity"), (res, "relu")):
            before = tpc.matmul_epilogue.launches
            got = tpc.matmul_epilogue(x, w, scale, shift, residual=r,
                                      act=act)
            want = tpc._epilogue_reference(x, w, scale, shift, r, act, dtype)
            assert tpc.matmul_epilogue.launches == before + 1
            assert got.dtype == dtype and got.shape == (m, n)
            assert _scaled_err(got, want) <= atol, (m, k, n, act)


@pytest.mark.parametrize("m,k,n", [(150, 70, 33), (300, 2048, 130)])
def test_cuda_int8_epilogue_accumulates_exactly(card, m, k, n):
    """The int32 sums bit-exact on the tensor cores (m16n8k32), at a ragged
    K (70: rows copied byte by byte) and N, and at K = 2,048, where the
    sums pass 2^24 and an f32 accumulator would round them; the epilogue
    in f32 and in bf16 with a residual."""
    gen = torch.Generator(device=card).manual_seed(3)
    xq = torch.randint(-128, 128, (m, k), generator=gen, device=card,
                       dtype=torch.int32).to(torch.int8)
    wq = torch.randint(-128, 128, (k, n), generator=gen, device=card,
                       dtype=torch.int32).to(torch.int8)
    if k == 2048:   # sums near the extremes: past 2^24 in magnitude
        xq[:8] = -128
        wq[:, :8] = -128
    ones = torch.ones(n, device=card)
    before = tpc.int8_matmul_epilogue.launches
    acc = tpc.int8_matmul_epilogue(xq, wq, ones, torch.zeros_like(ones))
    assert tpc.int8_matmul_epilogue.launches == before + 1
    exact = xq.double() @ wq.double()
    assert torch.equal(acc, exact.float())
    if k == 2048:
        assert exact.abs().max() > 2 ** 24
    scale = (torch.rand(n, generator=gen, device=card) + 0.5) * 1e-3
    shift = torch.randn(n, generator=gen, device=card)
    res = torch.randn((m, n), generator=gen, device=card)
    got = tpc.int8_matmul_epilogue(xq, wq, scale, shift, residual=res,
                                   act="relu")
    want = tpc._epilogue_reference(xq, wq, scale, shift, res, "relu",
                                   torch.float32)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    rb = res.to(torch.bfloat16)
    got = tpc.int8_matmul_epilogue(xq, wq, scale, shift, residual=rb,
                                   act="relu", out_dtype=torch.bfloat16)
    want = tpc._epilogue_reference(xq, wq, scale, shift, rb, "relu",
                                   torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert _scaled_err(got, want) <= 2e-2


def test_cuda_epilogue_wrappers_raise_on_what_the_kernel_does_not_take(card):
    x = torch.zeros((8, 4), device=card)
    w = torch.zeros((4, 3), device=card)
    v = torch.zeros(3, device=card)
    with pytest.raises(TypeError, match="takes x and w"):
        tpc.matmul_epilogue(x.half(), w.half(), v, v)
    with pytest.raises(ValueError, match="x \\(M, K\\) and w"):
        tpc.matmul_epilogue(x, w[:3], v, v)
    with pytest.raises(ValueError, match="scale must be"):
        tpc.matmul_epilogue(x, w, v[:2], v)
    with pytest.raises(ValueError, match="lie on"):
        tpc.matmul_epilogue(x, w, v.cpu(), v)


#: the forward GEMMs (matmul_epilogue's fp route, matmul_stats) at the edges
#: of their tiles and ring: M, N and K one off a multiple of a tile or of
#: the 32-value slice; N = 9 and K = 12 (rows of 36 and 48 bytes in f32,
#: 18 and 24 in bf16: copied element by element); K = 2,048 (res5's longest
#: contraction); and res4 _a and res5 _c. Together they reach every tile
#: the launch can pick.
FWD_EDGE_SHAPES = ((64, 12, 9), (129, 33, 65), (127, 31, 63),
                   (1000, 95, 1025), (511, 2048, 130), (200, 12, 4097),
                   (2049, 12, 511), (6272, 1024, 256), (1568, 512, 2048))
FWD_TILES = {(128, 128), (128, 64), (64, 128), (64, 64)}


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
def test_cuda_forward_gemms_match_plain_at_tile_edges(card, dtype, atol):
    """matmul_epilogue (identity, and residual + relu) and matmul_stats
    against their plain versions at FWD_EDGE_SHAPES, matmul_stats re-run
    for the same bits; the shapes cover every tile of the launch's plan."""
    gen = torch.Generator(device=card).manual_seed(7)
    assert {tpc._fwd_tile(*s) for s in FWD_EDGE_SHAPES} == FWD_TILES
    for m, k, n in FWD_EDGE_SHAPES:
        x = torch.randn((m, k), generator=gen, device=card).to(dtype)
        w = (torch.randn((k, n), generator=gen, device=card)
             / k ** 0.5).to(dtype)
        scale = torch.rand(n, generator=gen, device=card) + 0.5
        shift = torch.randn(n, generator=gen, device=card) * 0.1
        res = torch.randn((m, n), generator=gen, device=card).to(dtype)
        for r, act in ((None, "identity"), (res, "relu")):
            got = tpc.matmul_epilogue(x, w, scale, shift, residual=r,
                                      act=act)
            want = tpc._epilogue_reference(x, w, scale, shift, r, act, dtype)
            assert _scaled_err(got, want) <= atol, (m, k, n, act)
        got, again = tpc.matmul_stats(x, w), tpc.matmul_stats(x, w)
        for a, b, c in zip(got, tpc._matmul_stats_reference(x, w), again):
            assert a.shape == b.shape and a.dtype == b.dtype
            assert _scaled_err(a, b) <= atol, (m, k, n)
            assert torch.equal(a, c), (m, k, n)


@pytest.mark.parametrize("in_dtype,out_dtype,atol",
                         [(torch.float32, torch.bfloat16, 2e-2),
                          (torch.bfloat16, torch.float32, 2e-5)])
def test_cuda_matmul_epilogue_casts_its_output(card, in_dtype, out_dtype,
                                               atol):
    """The output (and the residual) in the other float type than x and
    w, with relu: the epilogue casts on the store."""
    gen = torch.Generator(device=card).manual_seed(8)
    for m, k, n in ((257, 200, 130), (6272, 1024, 256)):
        x = torch.randn((m, k), generator=gen, device=card).to(in_dtype)
        w = (torch.randn((k, n), generator=gen, device=card)
             / k ** 0.5).to(in_dtype)
        scale = torch.rand(n, generator=gen, device=card) + 0.5
        shift = torch.randn(n, generator=gen, device=card) * 0.1
        res = torch.randn((m, n), generator=gen, device=card).to(out_dtype)
        got = tpc.matmul_epilogue(x, w, scale, shift, residual=res,
                                  act="relu", out_dtype=out_dtype)
        want = tpc._epilogue_reference(x, w, scale, shift, res, "relu",
                                       out_dtype)
        assert got.dtype == out_dtype and got.shape == (m, n)
        assert _scaled_err(got, want) <= atol, (m, k, n)


def test_cuda_matmul_stats_sums_the_stored_bf16_values(card):
    """In bf16, Σy and Σy² are taken over y as stored (rounded to bf16):
    far closer to the sums of the returned y than to those of the f32
    product before rounding; and three runs give the same bits."""
    gen = torch.Generator(device=card).manual_seed(9)
    x = torch.randn((4096, 256), generator=gen, device=card).to(
        torch.bfloat16)
    w = (torch.randn((256, 192), generator=gen, device=card) / 16).to(
        torch.bfloat16)
    runs = [tpc.matmul_stats(x, w) for _ in range(3)]
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], other))
    y, s1, s2 = runs[0]
    stored = y.double()
    exact = x.double() @ w.double()
    for got, want, unrounded in ((s1, stored.sum(0), exact.sum(0)),
                                 (s2, (stored ** 2).sum(0),
                                  (exact ** 2).sum(0))):
        off = (got.double() - want).norm()
        assert off <= 1e-5 * want.abs().sum()
        assert off < 0.05 * (unrounded - want).norm()


#: bottleneck shapes (B, H, W, C, M): M = 8 and 16 (slices zero-filled past
#: M in every tap, C = 32 and 64), H odd, a res5-like whole image (7 × 7,
#: M = 64: one block per image in bf16), and 29 rows of 56 that split
#: into ragged row groups
BOTTLENECK_SHAPES = ((2, 7, 7, 64, 16), (2, 5, 6, 32, 8),
                     (1, 14, 14, 256, 64), (2, 7, 7, 256, 64),
                     (8, 29, 56, 256, 64))


def _block_args(gen, card, dtype, b, h, w, c, m):
    def rnd(*shape, scale=0.2):
        return (torch.randn(shape, generator=gen, device=card)
                * scale).to(dtype)

    return (rnd(b, h, w, c), rnd(c, m), rnd(m).float(), rnd(3, 3, m, m),
            rnd(m).float(), rnd(m, c), rnd(c).float())


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
def test_cuda_bottleneck_block_matches_plain(card, dtype, atol):
    """BOTTLENECK_SHAPES against the plain composition of the same math,
    one launch each; the res5-like shape takes a whole image per block in
    bf16, and the last shape's row groups are ragged in both dtypes."""
    gen = torch.Generator(device=card).manual_seed(4)
    for b, h, w, c, m in BOTTLENECK_SHAPES:
        args = _block_args(gen, card, dtype, b, h, w, c, m)
        before = trb.bottleneck_block.launches
        got = trb.bottleneck_block(*args, block_b=1)
        want = trb.bottleneck_block_xla(*args)
        assert trb.bottleneck_block.launches == before + 1
        assert got.dtype == dtype and got.shape == (b, h, w, c)
        assert _scaled_err(got, want) <= atol, (b, h, w, c, m)
    whole = trb._plan(torch.bfloat16, 2, 7, 7, 256, 64)
    assert whole["rows"] == 7 and whole["blocks"] == 2
    plan = trb._plan(dtype, 8, 29, 56, 256, 64)
    assert plan["blocks"] > 8 and 29 % plan["rows"] != 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_bottleneck_block_reruns_are_bit_identical(card, dtype):
    """Fixed summation order, no atomics: the same bits on every run."""
    gen = torch.Generator(device=card).manual_seed(5)
    args = _block_args(gen, card, dtype, 4, 14, 14, 256, 64)
    runs = [trb.bottleneck_block(*args, block_b=1) for _ in range(3)]
    for other in runs[1:]:
        assert torch.equal(runs[0], other)


def test_cuda_bottleneck_block_raises_beyond_its_limits(card):
    x = torch.zeros((1, 4, 4, 36), device=card)
    with pytest.raises(ValueError, match="multiples of 8"):
        trb.bottleneck_block(x, torch.zeros((36, 12), device=card),
                             torch.zeros(12, device=card),
                             torch.zeros((3, 3, 12, 12), device=card),
                             torch.zeros(12, device=card),
                             torch.zeros((12, 36), device=card),
                             torch.zeros(36, device=card), block_b=1)
    m, c, w = 2048, 64, 8       # W·(M + 8) = 16,448 > 9,536 in f32
    x = torch.zeros((1, 2, w, c), device=card)
    with pytest.raises(ValueError, match="shared memory"):
        trb.bottleneck_block(x, torch.zeros((c, m), device=card),
                             torch.zeros(m, device=card),
                             torch.zeros((3, 3, m, m), device=card),
                             torch.zeros(m, device=card),
                             torch.zeros((m, c), device=card),
                             torch.zeros(c, device=card), block_b=1)


def test_cuda_fused_resnet_launches_the_epilogue_kernel(card, monkeypatch):
    """ResNet-50 at 32×32 with the fusion on runs its 36 marked pairs
    through the kernel, and answers as the unfused graph does."""
    small = dict(numClasses=4, inputShape=(32, 32, 3))
    monkeypatch.setenv("DL4J_TPU_FUSE_CONV_BN", "1")
    fused = ResNet50(**small).init()
    monkeypatch.setenv("DL4J_TPU_FUSE_CONV_BN", "0")
    plain = fused.clone()
    plain._fused_pairs, plain._fused_convs = {}, set()
    x = np.random.default_rng(0).standard_normal((3, 32, 32, 3)).astype(
        np.float32)
    before = tpc.matmul_epilogue.launches
    a = fused.feedForward(x)
    assert tpc.matmul_epilogue.launches == before + 36
    b = plain.feedForward(x)
    for node in ("res2_0_a_bn", "res4_5_relu", "avgpool", "fc"):
        assert _scaled_err(a[node], b[node]) <= 1e-4, node


def test_cuda_quantized_layers_dot_match_their_plain_route(card):
    """quantize/infer.py's "dot" route on the card: one int8_matmul_epilogue
    launch per QuantizedConv1x1 (stride 2: the subsampled pixels) and per
    QuantizedDense (tanh: after an identity epilogue), against the same
    layer on CPU copies of its tensors (the kernel's plain version). The
    quantized inputs and the int32 sums are exact; the card's epilogue
    contracts acc·scale + shift into one FMA, so it may differ by an ulp:
    held to 1e-6 of max(1, max |plain|)."""
    from deeplearning4j_tpu_torch.quantize import (QuantizedConv1x1,
                                                   QuantizedDense)
    gen = torch.Generator().manual_seed(3)
    layers = ((QuantizedConv1x1("c", 96, 40, "relu", stride=2, impl="dot"),
               96, 40, (3, 9, 9, 96)),
              (QuantizedDense("d", 70, 33, "tanh", True, impl="dot"), 70, 33,
               (5, 70)))
    for layer, k, n, shape in layers:
        params = {"Wq": torch.randint(-127, 128, (k, n), generator=gen,
                                      dtype=torch.int32).to(torch.int8),
                  "scale": torch.rand(n, generator=gen) * 1e-3,
                  "bias": torch.randn(n, generator=gen) * 0.1,
                  "x_scale": torch.tensor(0.02)}
        x = torch.randn(shape, generator=gen)
        want, _ = layer.apply(params, {}, x)
        before = tpc.int8_matmul_epilogue.launches
        got, _ = layer.apply({k_: v.to(card) for k_, v in params.items()},
                             {}, x.to(card))
        assert tpc.int8_matmul_epilogue.launches == before + 1
        assert got.shape == want.shape
        tol = 1e-6 * max(1.0, float(want.abs().max()))
        assert float((got.cpu() - want).abs().max()) <= tol, type(layer)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
def test_cuda_bn_training_kernels_match_plain(card, dtype, atol):
    """matmul_stats, bn_grad_stats and bn_conv_grads at ragged M, K and N
    (tails of every tile and split; rows of 9 and 130 values, and of 12
    in bf16, take no 16-byte copies), one launch counted per call, and a
    re-run with
    the same bits (per-block partials, no atomics). bn_conv_grads also at
    K = 64 (the dW tile oriented by K), at a small M whose dX splits N
    (200 × 512 × 2048), and at a shape with more than two waves of dX
    tiles (each block walks several items)."""
    gen = torch.Generator(device=card).manual_seed(5)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=card)
                * scale).to(dtype)

    shapes = [(70, 12, 9, True), (300, 64, 32, True), (1000, 200, 130, True),
              (4096, 64, 256, False), (200, 512, 2048, False),
              (40000, 256, 256, False)]
    for m, k, n, every_kernel in shapes:
        x, y, dz = rnd(m, k), rnd(m, n), rnd(m, n)
        w = rnd(k, n, scale=k ** -0.5)
        mu = torch.randn(n, generator=gen, device=card) * 0.1
        r = torch.rand(n, generator=gen, device=card) + 0.5
        k1, k2, c = r, r * 1e-2, mu * 1e-2
        calls = ((tpc.matmul_stats, tpc._matmul_stats_reference, (x, w)),
                 (tpc.bn_grad_stats, tpc._bn_grad_stats_reference,
                  (y, dz, mu, r)),
                 (tpc.bn_conv_grads, tpc._bn_conv_grads_reference,
                  (x, y, dz, w, k1, k2, c, mu)))
        for kernel, plain, args in calls[0 if every_kernel else 2:]:
            before = kernel.launches
            got, again = kernel(*args), kernel(*args)
            assert kernel.launches == before + 2
            for a, b, c_ in zip(got, plain(*args), again):
                assert a.shape == b.shape and a.dtype == b.dtype
                assert _scaled_err(a, b) <= atol, (kernel.__name__, m, k, n)
                assert torch.equal(a, c_)


#: the zoo's graph models' conv1x1+BN pair shapes (M, K, N): the three of
#: InceptionResNetV1 at 160×160, B = 32 (stem3, block35's branches,
#: block17's branches), NASNet's N = 44 (44·2 bytes: no 16-byte bf16
#: copies) and EfficientNet-B0's (K, N) = (96, 24) projection, each with
#: the dtypes it runs in
ZOO_PAIR_SHAPES = [((51200, 64, 128), torch.float32),
                   ((51200, 64, 128), torch.bfloat16),
                   ((12800, 256, 32), torch.float32),
                   ((12800, 256, 32), torch.bfloat16),
                   ((3200, 512, 128), torch.float32),
                   ((3200, 512, 128), torch.bfloat16),
                   ((12544, 132, 44), torch.bfloat16),
                   ((3136, 96, 24), torch.float32)]


#: Keras MobileNetV2's narrowest and widest conv1x1+BN pairs at 224×224,
#: B = 32 (M, K, N), in f32: expanded_conv_project (N = 16),
#: block_1_expand (K = 16), block_16_project and Conv_1 (N = 1280)
MOBILENET_PAIR_SHAPES = [(401408, 32, 16), (401408, 16, 96),
                         (1568, 960, 320), (1568, 320, 1280)]


@pytest.mark.parametrize("shape,dtype", ZOO_PAIR_SHAPES)
def test_cuda_bn_kernels_at_the_zoo_graph_pair_shapes(card, shape, dtype):
    """matmul_epilogue, matmul_stats, bn_grad_stats and bn_conv_grads at
    the pair shapes the zoo's graph models give them, against their plain
    versions (f32 2e-5, bf16 2e-2, scaled by max(1, max |plain|)); one
    launch counted per call and a re-run with the same bits."""
    _pair_kernels_against_plain(card, shape, dtype)


@pytest.mark.parametrize("shape", MOBILENET_PAIR_SHAPES)
def test_cuda_bn_kernels_at_the_mobilenet_v2_pair_shapes(card, shape):
    """The four pair kernels at Keras MobileNetV2's narrowest and widest
    pairs in f32, held as the zoo's pair shapes are."""
    _pair_kernels_against_plain(card, shape, torch.float32)


def _pair_kernels_against_plain(card, shape, dtype):
    m, k, n = shape
    atol = 2e-5 if dtype == torch.float32 else 2e-2
    gen = torch.Generator(device=card).manual_seed(8)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=card)
                * scale).to(dtype)

    x, y, dz = rnd(m, k), rnd(m, n), rnd(m, n)
    w = rnd(k, n, scale=k ** -0.5)
    mu = torch.randn(n, generator=gen, device=card) * 0.1
    r = torch.rand(n, generator=gen, device=card) + 0.5
    k1, k2, c = r, r * 1e-2, mu * 1e-2
    scale = torch.rand(n, generator=gen, device=card) + 0.5
    shift = torch.randn(n, generator=gen, device=card) * 0.1
    calls = ((tpc.matmul_epilogue,
              lambda *a: (tpc._epilogue_reference(*a, None, "relu", dtype),),
              (x, w, scale, shift)),
             (tpc.matmul_stats, tpc._matmul_stats_reference, (x, w)),
             (tpc.bn_grad_stats, tpc._bn_grad_stats_reference,
              (y, dz, mu, r)),
             (tpc.bn_conv_grads, tpc._bn_conv_grads_reference,
              (x, y, dz, w, k1, k2, c, mu)))
    for kernel, plain, args in calls:
        run = ((lambda a=args: (kernel(*a, act="relu"),))
               if kernel is tpc.matmul_epilogue else
               (lambda a=args: kernel(*a)))
        before = kernel.launches
        got, again = run(), run()
        assert kernel.launches == before + 2
        for a, b, c_ in zip(got, plain(*args), again):
            assert a.shape == b.shape and a.dtype == b.dtype
            assert _scaled_err(a, b) <= atol, (kernel.__name__, shape)
            assert torch.equal(a, c_)


def test_cuda_fused_conv1x1_bn_trains_through_the_kernels(card):
    """fused_conv1x1_bn forward and backward on the card: one launch of
    each kernel, z and every gradient as the plain versions on the CPU."""
    gen = torch.Generator(device=card).manual_seed(6)
    x = torch.randn((250, 40), generator=gen, device=card)
    w = torch.randn((40, 24), generator=gen, device=card) * 0.2
    g = torch.rand(24, generator=gen, device=card) + 0.5
    b = torch.randn(24, generator=gen, device=card) * 0.1
    t = torch.randn((250, 24), generator=gen, device=card)
    kernels = (tpc.matmul_stats, tpc.bn_grad_stats, tpc.bn_conv_grads)
    before = [kern.launches for kern in kernels]
    results = []
    for dev in (card, "cpu"):
        leaves = [a.to(dev).requires_grad_() for a in (x, w, g, b)]
        z, _, _ = tpc.fused_conv1x1_bn(*leaves, 1e-5, "relu")
        grads = torch.autograd.grad((z * t.to(dev)).sum(), leaves)
        results.append([z.detach().cpu()] + [a.cpu() for a in grads])
    assert [kern.launches for kern in kernels] == [n + 1 for n in before]
    for a, b_ in zip(*results):
        assert _scaled_err(a, b_) <= 2e-5


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
def test_cuda_layernorm_matches_plain(card, dtype, atol):
    gen = torch.Generator(device=card).manual_seed(7)
    for rows, d in ((9, 24), (130, 1000), (64, 768)):
        x = (torch.randn((rows, d), generator=gen, device=card) * 2
             + 0.5).to(dtype)
        g = torch.rand(d, generator=gen, device=card) + 0.5
        b = torch.randn(d, generator=gen, device=card) * 0.1
        before = tln.fused_layernorm.launches
        got = tln.fused_layernorm(x, g, b)
        assert tln.fused_layernorm.launches == before + 1
        want = tln._layernorm_reference(x, g, b, 1e-5)[0]
        assert got.dtype == dtype and _scaled_err(got, want) <= atol
        assert torch.equal(got, tln.fused_layernorm(x, g, b))


@pytest.mark.parametrize("causal,masked", [(False, False), (True, False),
                                           (False, True)])
def test_cuda_flash_ring_matches_plain_ring_on_one_rank(card, causal,
                                                        masked):
    """The flash ring (B1 per held block, B2a/B2b under the global lse) on
    a one-rank mesh (no process group: one block, no hop) against the
    plain ring on the same inputs, forward and gradients; f32, held to
    2e-5 scaled by max(1, max |plain|). chip_smoke.py's parallel phase
    runs it over two and more ranks."""
    from deeplearning4j_tpu_torch.parallel import (DeviceMesh,
                                                   make_ring_attention)
    from deeplearning4j_tpu_torch.parallel.mesh import P, shard_map
    gen = torch.Generator(device=card).manual_seed(3)
    q, k, v, g = (torch.randn((2, 4, 96, 64), generator=gen, device=card)
                  for _ in range(4))
    mask = torch.arange(96, device=card)[None] < torch.tensor(
        [96, 40], device=card)[:, None]
    mesh = DeviceMesh(sp=1, device=card)
    spec = P(None, None, "sp", None)
    specs = (spec,) * 3 + ((P(None, "sp"),) if masked else ())
    extra = (mask,) if masked else ()
    outs = []
    for use in (True, False):
        f = shard_map(make_ring_attention(mesh, "sp", causal=causal,
                                          use_flash=use),
                      mesh=mesh, in_specs=specs, out_specs=spec)
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        before = tfa.flash_fwd.launches
        o = f(qq, kk, vv, *extra)
        if use:
            assert tfa.flash_fwd.launches - before == 1
        keep = mask[:, None, :, None] if masked else 1.0
        grads = torch.autograd.grad(o, (qq, kk, vv), g * keep)
        outs.append([(o * keep).detach()] + list(grads))
    for a, b in zip(*outs):
        tol = 2e-5 * max(1.0, b.abs().max().item())
        assert (a - b).abs().max().item() <= tol
