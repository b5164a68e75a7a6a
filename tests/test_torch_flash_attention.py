"""The port's flash attention (deeplearning4j_tpu_torch/kernels) against
the JAX package's Pallas kernel, run in interpret mode on the CPU.

On the CPU the port's wrappers run their kernels' plain PyTorch versions;
the CUDA kernels themselves are held against those versions on the card
by tests/test_torch_cuda_kernels.py and chip_smoke.py. Tolerance
1e-5 (f32; the sums run in another order)."""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

# the packages' __init__ re-export the function flash_attention under the
# module's name, so import the modules themselves
jfa = importlib.import_module("deeplearning4j_tpu.kernels.flash_attention")
tfa = importlib.import_module(
    "deeplearning4j_tpu_torch.kernels.flash_attention")

TOL = dict(atol=1e-5, rtol=1e-5)


def _qkv(seed, b, h, tq, tk, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, h, tq, d), (b, h, tk, d), (b, h, tk, d)))


def _lens_mask(lens, t):
    return (np.arange(t)[None, :] < np.asarray(lens)[:, None]).astype(
        np.int32)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


#: (b, h, tq, tk, d, causal, q lengths, kv lengths); block 8 in JAX, so
#: 20 and 13 are not multiples of the block
FORWARD_CASES = {
    "noncausal": (2, 2, 20, 20, 8, False, None, None),
    "causal": (2, 2, 20, 20, 8, True, None, None),
    "self_mask_fully_padded": (3, 2, 20, 20, 8, False, [20, 13, 0],
                               [20, 13, 0]),
    "kv_mask_cross": (2, 2, 13, 20, 8, False, None, [20, 7]),
    "cross_query_and_kv_mask": (2, 2, 13, 20, 8, False, [13, 5], [20, 7]),
}


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_flash_forward_and_lse_match_jax(case):
    b, h, tq, tk, d, causal, qlens, kvlens = FORWARD_CASES[case]
    q, k, v = _qkv(0, b, h, tq, tk, d)
    qm = None if qlens is None else _lens_mask(qlens, tq)
    km = None if kvlens is None else _lens_mask(kvlens, tk)
    jo, jl = jfa._flash_forward(_j(q), _j(k), _j(v), _j(qm), _j(km), causal,
                                8, 8, True)
    to, tl = tfa._flash_forward(_t(q), _t(k), _t(v), _t(qm), _t(km), causal)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    # the JAX lse is padded to its query tiling
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl)[:, :tq], **TOL)


def test_flash_attention_public_entry_matches_jax():
    q, k, v = _qkv(1, 3, 2, 20, 20, 8)
    m = _lens_mask([20, 9, 0], 20)
    jo = jfa.flash_attention(_j(q), _j(k), _j(v), mask=_j(m), block_q=8,
                             block_k=8, interpret=True)
    to = tfa.flash_attention(_t(q), _t(k), _t(v), mask=_t(m))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    assert np.all(to.numpy()[2] == 0)   # the fully padded example
    jc = jfa.flash_attention(_j(q), _j(k), _j(v), causal=True, block_q=8,
                             block_k=8, interpret=True)
    tc = tfa.flash_attention(_t(q), _t(k), _t(v), causal=True)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)


def test_flash_attention_validates_like_jax():
    z = torch.zeros
    with pytest.raises(ValueError, match="causal flash attention requires"):
        tfa.flash_attention(z(1, 1, 4, 8), z(1, 1, 5, 8), z(1, 1, 5, 8),
                            causal=True)
    with pytest.raises(ValueError, match="mask must be"):
        tfa.flash_attention(z(1, 1, 4, 8), z(1, 1, 4, 8), z(1, 1, 4, 8),
                            mask=z(1, 1, 4))
    with pytest.raises(ValueError, match="kv_mask must be"):
        tfa.flash_attention(z(1, 1, 4, 8), z(1, 1, 5, 8), z(1, 1, 5, 8),
                            kv_mask=z(5))
    with pytest.raises(ValueError, match="implies self-attention"):
        tfa.flash_attention(z(1, 1, 4, 8), z(1, 1, 5, 8), z(1, 1, 5, 8),
                            mask=z(1, 4))
    with pytest.raises(ValueError, match="query mask length"):
        tfa.flash_attention(z(1, 1, 4, 8), z(1, 1, 5, 8), z(1, 1, 5, 8),
                            mask=z(1, 3), kv_mask=z(1, 5))
    with pytest.raises(ValueError, match="kv_mask length"):
        tfa.flash_attention(z(1, 1, 4, 8), z(1, 1, 5, 8), z(1, 1, 5, 8),
                            kv_mask=z(1, 4))


@pytest.mark.parametrize("rank", [3, 4])
def test_flash_decode_matches_jax_pallas_and_dense(rank):
    rng = np.random.default_rng(2)
    b, h, c, d = 5, 3, 37, 16
    q = rng.standard_normal((b, h, d) if rank == 3
                            else (b, h, 1, d)).astype(np.float32)
    k = rng.standard_normal((b, h, c, d)).astype(np.float32)
    v = rng.standard_normal((b, h, c, d)).astype(np.float32)
    m = _lens_mask([1, 5, 37, 0, 20], c)            # ragged, one empty
    jp = jfa.flash_attention_decode(_j(q), _j(k), _j(v), _j(m),
                                    impl="pallas", interpret=True)
    jd = jfa.flash_attention_decode(_j(q), _j(k), _j(v), _j(m),
                                    impl="dense")
    for impl in ("auto", "kernel", "dense"):
        out = tfa.flash_attention_decode(_t(q), _t(k), _t(v), _t(m),
                                         impl=impl)
        assert out.shape == q.shape
        np.testing.assert_allclose(out.numpy(), np.asarray(jp), **TOL)
        np.testing.assert_allclose(out.numpy(), np.asarray(jd), **TOL)
        assert np.all(out.numpy()[3] == 0)          # the empty row


def test_flash_decode_validates_like_jax():
    z = torch.zeros
    with pytest.raises(ValueError, match="q1 must be"):
        tfa.flash_attention_decode(z(2, 3, 2, 8), z(2, 3, 4, 8),
                                   z(2, 3, 4, 8), z(2, 4))
    with pytest.raises(ValueError, match="k_cache/v_cache must match"):
        tfa.flash_attention_decode(z(2, 3, 8), z(2, 3, 4, 8),
                                   z(2, 3, 5, 8), z(2, 4))
    with pytest.raises(ValueError, match="cache_mask"):
        tfa.flash_attention_decode(z(2, 3, 8), z(2, 3, 4, 8),
                                   z(2, 3, 4, 8), z(2, 5))
    with pytest.raises(ValueError, match="unknown decode impl"):
        tfa.flash_attention_decode(z(2, 3, 8), z(2, 3, 4, 8),
                                   z(2, 3, 4, 8), z(2, 4), impl="nope")


def test_flash_decode_mq_matches_jax():
    rng = np.random.default_rng(3)
    b, h, tq, c, d = 2, 2, 3, 11, 8
    q = rng.standard_normal((b, h, tq, d)).astype(np.float32)
    k = rng.standard_normal((b, h, c, d)).astype(np.float32)
    v = rng.standard_normal((b, h, c, d)).astype(np.float32)
    pos = np.array([4, 0])
    qm = np.arange(c)[None, None, :] <= (pos[:, None] + np.arange(tq))[
        :, :, None]
    qm[1, 0] = False                                 # a query with no row
    jo = jfa.flash_attention_decode_mq(_j(q), _j(k), _j(v), _j(qm))
    to = tfa.flash_attention_decode_mq(_t(q), _t(k), _t(v), _t(qm))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    with pytest.raises(ValueError, match="no multi-query"):
        tfa.flash_attention_decode_mq(_t(q), _t(k), _t(v), _t(qm),
                                      impl="kernel")


def test_kernel_wrappers_count_no_launch_on_cpu():
    """On a CPU tensor the wrappers run the plain versions: no launch."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 1, 2, 6, 6, 8))
    before = (tfa.flash_fwd.launches, tfa.flash_decode.launches)
    tfa.flash_fwd(q, k, v, None, True)
    tfa.flash_decode(q[:, :, :1], k, v, torch.ones(1, 6, dtype=torch.bool))
    assert (tfa.flash_fwd.launches, tfa.flash_decode.launches) == before



def test_decode_cluster_size_checks_what_the_kernel_takes():
    """`decode_cluster_size` reports the card's launch and rejects what
    flash_decode would not launch, before it loads any library."""
    with pytest.raises(ValueError, match="CUDA device"):
        tfa.decode_cluster_size(8, 12, 512, 64, torch.float32, "cpu")
    with pytest.raises(ValueError, match="head dims"):
        tfa.decode_cluster_size(8, 12, 512, 16, torch.float32, "cuda")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tfa.decode_cluster_size(8, 12, 512, 64, torch.float16, "cuda")
