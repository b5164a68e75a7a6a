"""The port's `fused_layernorm` (deeplearning4j_tpu_torch/kernels/layernorm.py)
against the JAX package's on the CPU: the port runs the kernel's plain
version, the JAX package its Pallas kernel in interpret mode, and the
gradients are the two closed-form backwards. Inputs come from a numpy
seed.

Tolerances: f32 1e-5 × max(1, max |JAX|) (sums in another order); bf16
1e-2 (the output rounded to 8 mantissa bits); gradients 2e-5."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.kernels.layernorm import fused_layernorm as jln
from deeplearning4j_tpu_torch.kernels import layernorm as tln
from deeplearning4j_tpu_torch.kernels.layernorm import fused_layernorm


def _close(got, want, rel=1e-5, what=""):
    got = np.asarray(got.detach().float(), np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape, what
    tol = rel * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, (what, err, tol)


def _operands(shape, seed):
    rng = np.random.default_rng(seed)
    d = shape[-1]
    return ((rng.standard_normal(shape) * 2 + 0.5).astype(np.float32),
            np.linspace(0.5, 1.5, d).astype(np.float32),
            np.linspace(-1.0, 1.0, d).astype(np.float32))


#: (3, 7, 24) as tests/test_kernels.py; 130 rows against the JAX block of
#: 128 rows (ragged); BERT-base's width
@pytest.mark.parametrize("shape", [(3, 7, 24), (130, 100), (4, 8, 768)])
def test_fused_layernorm_matches_jax(shape):
    x, g, b = _operands(shape, sum(shape))
    want = jln(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
               interpret=True)
    got = fused_layernorm(*map(torch.from_numpy, (x, g, b)))
    assert got.shape == x.shape and got.dtype == torch.float32
    _close(got, want)


def test_fused_layernorm_bf16_keeps_the_activation_type():
    x, g, b = _operands((33, 64), 1)
    want = jln(jnp.asarray(x, jnp.bfloat16), jnp.asarray(g), jnp.asarray(b),
               interpret=True)
    got = fused_layernorm(torch.from_numpy(x).to(torch.bfloat16),
                          torch.from_numpy(g), torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    _close(got, want, 1e-2)


def test_fused_layernorm_gradients_match_jax():
    """jax.grad of sum(sin(LN(x))) through the JAX custom VJP, against the
    port's closed-form backward (tests/test_kernels.py:78-93's loss)."""
    x, g, b = _operands((5, 16), 2)
    g = g * 1.3

    def jloss(*a):
        return jnp.sum(jnp.sin(jln(*a)))

    want = jax.grad(jloss, (0, 1, 2))(*map(jnp.asarray, (x, g, b)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, g, b)]
    torch.sin(fused_layernorm(*leaves)).sum().backward()
    for leaf, j, what in zip(leaves, want, ("x", "gamma", "beta")):
        _close(leaf.grad, j, 2e-5, what)


def test_fused_layernorm_gradcheck_f64():
    x, g, b = _operands((4, 3, 10), 3)
    args = [torch.from_numpy(a.astype(np.float64)).requires_grad_()
            for a in (x, g, b)]
    assert torch.autograd.gradcheck(lambda *a: fused_layernorm(*a), args)


def test_plain_version_returns_the_row_statistics():
    """The per-row μ and 1/√(σ² + ε) that the kernel writes for the
    backward; σ² is the mean of squared deviations."""
    x, g, b = _operands((6, 50), 4)
    out, mean, rstd = tln._layernorm_reference(
        torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b), 1e-5)
    np.testing.assert_allclose(mean.numpy(), x.mean(-1), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(rstd.numpy(),
                               1 / np.sqrt(x.var(-1) + 1e-5), rtol=1e-5)
    assert fused_layernorm.launches == 0   # the plain version counts none
