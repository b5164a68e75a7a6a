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


def test_cuda_wrappers_raise_on_what_the_kernels_do_not_take(card):
    x = torch.zeros((1, 2, 8, 64), device=card)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa.flash_fwd(x.half(), x.half(), x.half())
    with pytest.raises(ValueError, match="head dims"):
        tfa.flash_fwd(x[..., :8], x[..., :8], x[..., :8])
    with pytest.raises(ValueError, match="share one device"):
        tfa.flash_decode(x[:, :, :1], x.cpu(), x, torch.ones(
            (1, 8), dtype=torch.bool, device=card))


def test_cuda_decoder_kernel_path_matches_dense(card):
    """Prefill and three steps of BertDecoder through both kernels agree
    with the same decoder on dense attention, and launch each kernel."""
    cfg = bert_tiny(hidden_size=128, num_heads=2, intermediate_size=256)
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


def test_cuda_int8_epilogue_accumulates_exactly(card):
    gen = torch.Generator(device=card).manual_seed(3)
    m, k, n = 150, 70, 33
    xq = torch.randint(-127, 128, (m, k), generator=gen, device=card,
                       dtype=torch.int32).to(torch.int8)
    wq = torch.randint(-127, 128, (k, n), generator=gen, device=card,
                       dtype=torch.int32).to(torch.int8)
    ones = torch.ones(n, device=card)
    acc = tpc.int8_matmul_epilogue(xq, wq, ones, torch.zeros_like(ones))
    exact = (xq.double() @ wq.double()).float()
    assert torch.equal(acc, exact)
    scale = (torch.rand(n, generator=gen, device=card) + 0.5) * 1e-3
    shift = torch.randn(n, generator=gen, device=card)
    res = torch.randn((m, n), generator=gen, device=card)
    got = tpc.int8_matmul_epilogue(xq, wq, scale, shift, residual=res,
                                   act="relu")
    want = tpc._epilogue_reference(xq, wq, scale, shift, res, "relu",
                                   torch.float32)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


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


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
def test_cuda_bottleneck_block_matches_plain(card, dtype, atol):
    """Shapes whose row groups and tiles are ragged (H odd, W·M small and
    large), against the cuDNN composition of the same math."""
    gen = torch.Generator(device=card).manual_seed(4)

    def rnd(*shape, scale=0.2):
        return (torch.randn(shape, generator=gen, device=card)
                * scale).to(dtype)

    for b, h, w, c, m in ((2, 7, 7, 64, 16), (2, 5, 6, 32, 8),
                          (1, 14, 14, 256, 64)):
        args = (rnd(b, h, w, c), rnd(c, m), rnd(m).float(), rnd(3, 3, m, m),
                rnd(m).float(), rnd(m, c), rnd(c).float())
        before = trb.bottleneck_block.launches
        got = trb.bottleneck_block(*args, block_b=1)
        want = trb.bottleneck_block_xla(*args)
        assert trb.bottleneck_block.launches == before + 1
        assert got.dtype == dtype and got.shape == (b, h, w, c)
        assert _scaled_err(got, want) <= atol, (b, h, w, c, m)


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
