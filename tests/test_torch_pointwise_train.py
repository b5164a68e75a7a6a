"""The port's conv1x1+BN training kernels (matmul_stats, bn_grad_stats,
bn_conv_grads in deeplearning4j_tpu_torch/kernels/pointwise_conv.py), the
`fused_conv1x1_bn` autograd Function over them, and the training BatchNorm
(`_BNTrain`) against the JAX package on the CPU. The port runs each
kernel's plain version; the JAX package its Pallas kernels in interpret
mode. Inputs come from a numpy seed.

Tolerances: f32 1e-5 × max(1, max |JAX|) per output (sums in another
order); bf16 outputs 1e-2 × max(1, max |JAX|) (one rounding of an f32 sum
to 8 mantissa bits may land on either side); gradients of the fused op
2e-5 × max(1, max |JAX|) (BN's backward through sums of 250 rows)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.kernels import pointwise_conv as jpc
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu_torch.kernels import pointwise_conv as tpc
from deeplearning4j_tpu_torch.nn.conf import layers as tl

RTOL = {np.float32: 1e-5, "bf16": 1e-2}


def _close(got, want, rel=1e-5, what=""):
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    tol = rel * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, (what, err, tol)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _as(a, dtype):
    """(jax array, torch tensor) of one numpy array in `dtype` (f32 or
    "bf16"), rounded identically."""
    if dtype == "bf16":
        t = torch.from_numpy(a).to(torch.bfloat16)
        return jnp.asarray(a, jnp.bfloat16), t
    return jnp.asarray(a), torch.from_numpy(a)


def _np(j):
    return np.asarray(jnp.asarray(j, jnp.float32))


#: (M, K, N): ragged M against the JAX block of 256 (250, 1000), K that is
#: no multiple of the CUDA kernels' slices and tiles (40, 300), and one
#: shape whose K the JAX backward kernel tiles (its VMEM budget)
SHAPES = [(250, 16, 24), (1000, 40, 70), (300, 300, 130), (64, 2048, 1024)]
CASES = [(s, np.float32) for s in SHAPES] + [((250, 40, 70), "bf16")]


@pytest.mark.parametrize("shape,dtype", CASES)
def test_matmul_stats_matches_jax(shape, dtype):
    m, k, n = shape
    rng = np.random.default_rng(m + k)
    jx, tx = _as(_rand(rng, m, k), dtype)
    jw, tw = _as(_rand(rng, k, n, scale=k ** -0.5), dtype)
    want = jpc.matmul_stats(jx, jw, interpret=True)
    got = tpc.matmul_stats(tx, tw)
    assert got[0].dtype == tx.dtype and got[1].dtype == torch.float32
    for g, w, what in zip(got, want, ("y", "s1", "s2")):
        _close(g, _np(w), RTOL[dtype], what)


@pytest.mark.parametrize("shape,dtype", CASES)
def test_bn_grad_stats_matches_jax(shape, dtype):
    m, _, n = shape
    rng = np.random.default_rng(m + n)
    jy, ty = _as(_rand(rng, m, n), dtype)
    jdz, tdz = _as(_rand(rng, m, n), dtype)
    mu, r = _rand(rng, n, scale=0.1), rng.uniform(0.5, 1.5, n).astype(
        np.float32)
    want = jpc.bn_grad_stats(jy, jdz, jnp.asarray(mu), jnp.asarray(r),
                             interpret=True)
    got = tpc.bn_grad_stats(ty, tdz, torch.from_numpy(mu),
                            torch.from_numpy(r))
    for g, w, what in zip(got, want, ("dgamma", "dbeta")):
        assert g.dtype == torch.float32
        _close(g, _np(w), RTOL[dtype], what)


@pytest.mark.parametrize("shape,dtype", CASES)
def test_bn_conv_grads_matches_jax(shape, dtype):
    m, k, n = shape
    rng = np.random.default_rng(m * 3 + k)
    jx, tx = _as(_rand(rng, m, k), dtype)
    jy, ty = _as(_rand(rng, m, n), dtype)
    jdz, tdz = _as(_rand(rng, m, n), dtype)
    jw, tw = _as(_rand(rng, k, n, scale=n ** -0.5), dtype)
    vecs = [rng.uniform(0.5, 1.5, n).astype(np.float32),
            _rand(rng, n, scale=1e-2), _rand(rng, n, scale=1e-2),
            _rand(rng, n, scale=0.1)]                   # k1, k2, c, mu
    want = jpc.bn_conv_grads(jx, jy, jdz, jw, *map(jnp.asarray, vecs),
                             interpret=True)
    got = tpc.bn_conv_grads(tx, ty, tdz, tw, *map(torch.from_numpy, vecs))
    assert got[0].dtype == tx.dtype and got[1].dtype == torch.float32
    for g, w, what in zip(got, want, ("dX", "dW")):
        _close(g, _np(w), RTOL[dtype], what)


def _fused_operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    return (_rand(rng, m, k), _rand(rng, k, n, scale=0.3),
            rng.uniform(0.5, 1.5, n).astype(np.float32),
            np.linspace(-0.5, 0.5, n).astype(np.float32),
            _rand(rng, m, n))


@pytest.mark.parametrize("act", ["identity", "relu"])
@pytest.mark.parametrize("m", [256, 250])
def test_fused_conv1x1_bn_forward_matches_jax(act, m):
    x, w, g, b, _ = _fused_operands(m, 16, 24, 0)
    want = jpc.fused_conv1x1_bn(*map(jnp.asarray, (x, w, g, b)), 1e-5, act,
                                True)
    got = tpc.fused_conv1x1_bn(*map(torch.from_numpy, (x, w, g, b)), 1e-5,
                               act)
    for t, j, what in zip(got, want, ("z", "mu", "var")):
        _close(t, _np(j), what=what)


@pytest.mark.parametrize("act", ["identity", "relu"])
def test_fused_conv1x1_bn_gradients_match_jax(act):
    """Gradients to x, W, γ and β of sum(z · t) through the port's
    autograd.Function against jax.grad through the JAX custom VJP."""
    x, w, g, b, t = _fused_operands(250, 8, 12, 1)

    def jloss(*a):
        z, _, _ = jpc.fused_conv1x1_bn(*a, 1e-5, act, True)
        return jnp.sum(z * jnp.asarray(t))

    want = jax.grad(jloss, (0, 1, 2, 3))(*map(jnp.asarray, (x, w, g, b)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w, g, b)]
    z, mu, var = tpc.fused_conv1x1_bn(*leaves, 1e-5, act)
    assert not mu.requires_grad and not var.requires_grad
    (z * torch.from_numpy(t)).sum().backward()
    for leaf, j, what in zip(leaves, want, ("x", "W", "gamma", "beta")):
        _close(leaf.grad, _np(j), 2e-5, what)


def test_fused_conv1x1_bn_bf16_keeps_the_activation_type():
    x, w, g, b, _ = _fused_operands(128, 8, 16, 2)
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    tw = torch.from_numpy(w).to(torch.bfloat16).requires_grad_()
    tg, tb = (torch.from_numpy(a).requires_grad_() for a in (g, b))
    z, _, _ = tpc.fused_conv1x1_bn(tx, tw, tg, tb, 1e-5, "relu")
    assert z.dtype == torch.bfloat16
    jz, _, _ = jpc.fused_conv1x1_bn(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
        jnp.asarray(g), jnp.asarray(b), 1e-5, "relu", True)
    _close(z, _np(jz), 1e-2)
    z.float().sum().backward()
    assert tx.grad.dtype == torch.bfloat16 and tw.grad.dtype == torch.bfloat16
    assert tg.grad.dtype == torch.float32


@pytest.mark.parametrize("act", ["identity", "relu"])
def test_fused_conv1x1_bn_gradcheck_f64(act):
    rng = np.random.default_rng(3)
    args = [torch.from_numpy(a.astype(np.float64)).requires_grad_()
            for a in (_rand(rng, 40, 6), _rand(rng, 6, 5, scale=0.4),
                      rng.uniform(0.5, 1.5, 5), _rand(rng, 5, scale=0.1))]
    assert torch.autograd.gradcheck(
        lambda *a: tpc.fused_conv1x1_bn(*a, 1e-5, act)[0], args)


def test_bn_train_matches_jax_and_gradchecks():
    """The training BatchNorm's forward and closed-form backward against
    the JAX `_bn_train` custom VJP, then gradcheck in f64."""
    rng = np.random.default_rng(4)
    x = _rand(rng, 3, 5, 4, 6, scale=2.0) + 0.5
    g = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    b = _rand(rng, 6, scale=0.1)
    t = _rand(rng, 3, 5, 4, 6)

    def jloss(x_, g_, b_):
        return jnp.sum(jl._bn_train(x_, g_, b_, 1e-5) * jnp.asarray(t))

    jy = jl._bn_train(*map(jnp.asarray, (x, g, b)), 1e-5)
    want = jax.grad(jloss, (0, 1, 2))(*map(jnp.asarray, (x, g, b)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, g, b)]
    y, mu, var = tl._BNTrain.apply(*leaves, 1e-5)
    _close(y.detach(), np.asarray(jy))
    jmu, jvar = jl._bn_stats(jnp.asarray(x))
    _close(mu, np.asarray(jmu))
    _close(var, np.asarray(jvar))
    (y * torch.from_numpy(t)).sum().backward()
    for leaf, j, what in zip(leaves, want, ("x", "gamma", "beta")):
        _close(leaf.grad, np.asarray(j), 2e-5, what)
    args = [torch.from_numpy(a.astype(np.float64)).requires_grad_()
            for a in (x[:2, :3], g, b)]
    assert torch.autograd.gradcheck(
        lambda *a: tl._BNTrain.apply(*a, 1e-5)[0], args)


def test_training_wrappers_check_their_operands():
    x, w = torch.zeros(8, 4), torch.zeros(4, 6)
    with pytest.raises(ValueError, match="x \\(M, K\\) and w \\(K, N\\)"):
        tpc.matmul_stats(x, torch.zeros(5, 6))
    with pytest.raises(ValueError, match="share one"):
        tpc.bn_grad_stats(torch.zeros(8, 6), torch.zeros(8, 5),
                          torch.zeros(6), torch.ones(6))
    with pytest.raises(ValueError, match="must be 2-D"):
        tpc.bn_conv_grads(x[None], torch.zeros(8, 6), torch.zeros(8, 6), w,
                          *[torch.zeros(6)] * 4)
    with pytest.raises(ValueError, match="unsupported act"):
        tpc.fused_conv1x1_bn(x, w, torch.ones(6), torch.zeros(6),
                             act="gelu")
