"""The port's fused bottleneck block (deeplearning4j_tpu_torch/kernels/
residual_block.py) against the JAX package on the CPU: the port runs the
kernel's plain version, JAX its Pallas kernel in interpret mode and its
XLA composition. The contracts of tests/test_kernels.py's
TestResidualBlockKernel; atol 2e-6 as there (f32 sums in another
order)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.kernels import residual_block as jrb
from deeplearning4j_tpu_torch.kernels import residual_block as trb


def _mats(rng, B, H, W, C, M):
    def mk(*s):
        return (rng.normal(size=s) * 0.2).astype(np.float32)
    return (mk(B, H, W, C), mk(C, M), mk(M), mk(3, 3, M, M), mk(M),
            mk(M, C), mk(C))


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_matches_jax_kernel_and_xla_composition():
    mats = _mats(np.random.default_rng(0), 4, 6, 6, 32, 16)
    got = trb.bottleneck_block(*_torch(mats), block_b=2).numpy()
    ja = [jnp.asarray(a) for a in mats]
    kernel = np.asarray(jrb.bottleneck_block(*ja, block_b=2,
                                             interpret=True))
    xla = np.asarray(jrb.bottleneck_block_xla(*ja))
    np.testing.assert_allclose(got, kernel, atol=2e-6)
    np.testing.assert_allclose(got, xla, atol=2e-6)
    np.testing.assert_allclose(
        trb.bottleneck_block_xla(*_torch(mats)).numpy(), xla, atol=2e-6)


def test_matches_an_unfused_numpy_composition():
    """An independent oracle: the three products written out in numpy,
    with the 3×3 SAME conv as nine shifted products."""
    x, w1, b1, w2, b2, w3, b3 = _mats(np.random.default_rng(3), 2, 5, 7,
                                      8, 4)
    h1 = np.maximum(x @ w1 + b1, 0)
    hp = np.pad(h1, ((0, 0), (1, 1), (1, 1), (0, 0)))
    acc = sum(hp[:, dy:dy + 5, dx:dx + 7] @ w2[dy, dx]
              for dy in range(3) for dx in range(3))
    h2 = np.maximum(acc + b2, 0)
    want = np.maximum(h2 @ w3 + b3 + x, 0)
    got = trb.bottleneck_block(*_torch((x, w1, b1, w2, b2, w3, b3)),
                               block_b=1).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_batch_tiling_invariant():
    mats = _torch(_mats(np.random.default_rng(1), 8, 5, 5, 16, 8))
    a = trb.bottleneck_block(*mats, block_b=8).numpy()
    b = trb.bottleneck_block(*mats, block_b=2).numpy()
    np.testing.assert_allclose(a, b, atol=2e-6)


def test_rejects_indivisible_batch():
    mats = _torch(_mats(np.random.default_rng(2), 6, 4, 4, 8, 8))
    with pytest.raises(ValueError, match="divisible"):
        trb.bottleneck_block(*mats, block_b=4)
    with pytest.raises(ValueError, match="divisible"):
        jrb.bottleneck_block(*(jnp.asarray(m.numpy()) for m in mats),
                             block_b=4, interpret=True)
