"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked `cuda` and skips without a CUDA device:
the kernels have no CPU mode. The file imports nothing of JAX, so it also
runs on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_kernels.py

Tolerances: f32 2e-5 (the kernel sums in another order than the plain
version), bf16 2e-2 (the output is rounded to 8 mantissa bits)."""
import importlib

import pytest
import torch

from deeplearning4j_tpu_torch.generation.decode import BertDecoder
from deeplearning4j_tpu_torch.models import bert_tiny, init_bert_params

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
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="training slice"):
        tfa.flash_attention(q, k, v)


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
