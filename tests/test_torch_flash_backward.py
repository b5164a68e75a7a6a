"""The port's flash-attention backward (deeplearning4j_tpu_torch/kernels)
against the JAX package's Pallas backward kernels, run in interpret mode
on the CPU with block_q = block_k = 8.

On the CPU the port's autograd Function runs the backward kernels' plain
PyTorch versions; the CUDA kernels themselves are held against those
versions on the card by tests/test_torch_cuda_kernels.py and
chip_smoke.py. Tolerance 1e-5 (f32; the sums run in another order)."""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_flash_attention import FORWARD_CASES, _j, _lens_mask, _qkv, _t

jfa = importlib.import_module("deeplearning4j_tpu.kernels.flash_attention")
tfa = importlib.import_module(
    "deeplearning4j_tpu_torch.kernels.flash_attention")

TOL = dict(atol=1e-5, rtol=1e-5)


def _case(case, seed=0):
    """Seeded q, k, v, the output cotangent g, and the case's masks."""
    b, h, tq, tk, d, causal, qlens, kvlens = FORWARD_CASES[case]
    q, k, v = _qkv(seed, b, h, tq, tk, d)
    g = np.random.default_rng(seed + 100).standard_normal(
        (b, h, tq, d)).astype(np.float32)
    qm = None if qlens is None else _lens_mask(qlens, tq)
    km = None if kvlens is None else _lens_mask(kvlens, tk)
    return q, k, v, g, qm, km, causal


def _port_grads(q, k, v, g, qm, km, causal, dtype=torch.float32):
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_()
              for a in (q, k, v)]
    out = tfa.flash_attention(*leaves, causal=causal, mask=_t(qm),
                              kv_mask=_t(km))
    (out * torch.from_numpy(g).to(dtype)).sum().backward()
    return [x.grad for x in leaves]


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_flash_gradients_match_jax(case):
    q, k, v, g, qm, km, causal = _case(case)

    def loss(q, k, v):
        out = jfa.flash_attention(q, k, v, causal=causal, mask=_j(qm),
                                  kv_mask=_j(km), block_q=8, block_k=8,
                                  interpret=True)
        return jnp.sum(out * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(_j(q), _j(k), _j(v))
    got = _port_grads(q, k, v, g, qm, km, causal)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_backward_reference_matches_jax_flash_backward(case):
    """`_flash_backward_reference` against the JAX `_flash_backward`, both
    given JAX's forward output and lse (the JAX lse is padded to its
    query tiling: the port takes its first Tq columns)."""
    q, k, v, g, qm, km, causal = _case(case, seed=1)
    tq = q.shape[2]
    o, lse = jfa._flash_forward(_j(q), _j(k), _j(v), _j(qm), _j(km), causal,
                                8, 8, True)
    want = jfa._flash_backward(_j(q), _j(k), _j(v), _j(qm), _j(km), o, lse,
                               _j(g), causal, 8, 8, True)
    got = tfa._flash_backward_reference(
        _t(q), _t(k), _t(v), torch.from_numpy(np.array(o)),
        torch.from_numpy(np.asarray(lse)[:, :tq].copy()), _t(g), _t(km),
        causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("case", ["causal", "cross_query_and_kv_mask",
                                  "self_mask_fully_padded"])
def test_plain_backward_passes_gradcheck_in_float64(case):
    """The autograd Function's plain backward against finite differences
    of its plain forward, in float64 at a tiny size."""
    b, h, tq, tk, d, causal, qlens, kvlens = FORWARD_CASES[case]
    tq, tk = min(tq, 6), min(tk, 7)
    qm = None if qlens is None else _t(_lens_mask(
        [min(n, tq) for n in qlens], tq))
    km = None if kvlens is None else _t(_lens_mask(
        [min(n, tk) for n in kvlens], tk))
    if causal:
        tk = tq
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal(s)).requires_grad_()
               for s in ((b, 1, tq, d), (b, 1, tk, d), (b, 1, tk, d)))
    assert torch.autograd.gradcheck(
        lambda q, k, v: tfa.flash_attention(q, k, v, causal=causal,
                                            mask=qm, kv_mask=km),
        (q, k, v), eps=1e-6, atol=1e-7)


def test_padded_positions_get_exactly_zero_gradient():
    """As tests/test_kernels.py::test_flash_masked_no_grad_leak_to_padding
    and ::test_flash_cross_length_no_grad_leak_to_padded_keys hold the JAX
    package: padded queries and keys, and the whole fully padded example,
    get gradients that are exactly 0."""
    q, k, v, g, qm, km, causal = _case("self_mask_fully_padded")
    dq, dk, dv = _port_grads(q, k, v, g, qm, km, causal)
    pad = ~torch.from_numpy(qm.astype(bool))              # (B, T)
    for grad in (dq, dk, dv):
        assert torch.all(grad.permute(0, 2, 1, 3)[pad] == 0)
        assert torch.all(grad[2] == 0)                      # fully padded
        assert torch.count_nonzero(grad[0]) == grad[0].numel()
    q, k, v, g, qm, km, causal = _case("cross_query_and_kv_mask")
    dq, dk, dv = _port_grads(q, k, v, g, qm, km, causal)
    kpad = ~torch.from_numpy(km.astype(bool))
    qpad = ~torch.from_numpy(qm.astype(bool))
    assert torch.all(dk.permute(0, 2, 1, 3)[kpad] == 0)
    assert torch.all(dv.permute(0, 2, 1, 3)[kpad] == 0)
    assert torch.all(dq.permute(0, 2, 1, 3)[qpad] == 0)


def test_masks_get_no_gradient():
    q, k, v, g, qm, km, causal = _case("cross_query_and_kv_mask")
    qmf = torch.from_numpy(qm.astype(np.float32)).requires_grad_()
    kmf = torch.from_numpy(km.astype(np.float32)).requires_grad_()
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tfa.flash_attention(*leaves, mask=qmf, kv_mask=kmf)
    (out * torch.from_numpy(g)).sum().backward()
    assert qmf.grad is None and kmf.grad is None
    assert all(x.grad is not None for x in leaves)
    want = _port_grads(q, k, v, g, qm, km, causal)
    for a, b in zip(leaves, want):
        assert torch.equal(a.grad, b)


def test_backward_wrappers_split_the_reference_and_count_no_cpu_launch():
    """On a CPU tensor `flash_bwd_dq` and `flash_bwd_dkv` run their parts of
    the plain backward and count no launch."""
    q, k, v, g, qm, km, causal = _case("kv_mask_cross", seed=3)
    out, lse = tfa._flash_forward(_t(q), _t(k), _t(v), None, _t(km), causal)
    delta = tfa._delta(_t(g), out)
    before = (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches)
    dq = tfa.flash_bwd_dq(_t(q), _t(k), _t(v), _t(g), lse, delta, _t(km))
    dk, dv = tfa.flash_bwd_dkv(_t(q), _t(k), _t(v), _t(g), lse, delta,
                               _t(km))
    assert (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches) == before
    ref = tfa._flash_backward_reference(_t(q), _t(k), _t(v), out, lse,
                                        _t(g), _t(km), causal)
    for a, b in zip((dq, dk, dv), ref):
        assert torch.equal(a, b)
