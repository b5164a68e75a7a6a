"""Seeded PRNG streams (≡ nd4j NativeRandom / Nd4j.getRandom): the port
of `deeplearning4j_tpu/ops/random.py`.

A stateful wrapper over the JAX key stream: each draw splits the key, so
host-side data and init code get ND4J-style sequential semantics. The
keys follow JAX's threefry2x32 (partitionable layout) through the port's
`generation.sampling.threefry2x32`, so `split` (into any count),
`uniform` (any `low`, `high`) and `bernoulli` equal the JAX package's
draws bit for bit, and
`normal` agrees to 1e-6 (XLA's f32 erfinv polynomial; `log1p` may differ
in the last ulp). XLA:CPU contracts `jax.random.uniform`'s
`u * (high - low) + low` into one fused multiply-add, so the port forms
it in float64 and rounds once to float32: rounding the product and the
sum apart differs by an ulp wherever `high - low` is not a power of two.
`random_bits` takes an offset into the flat index, so rows of a large
table can be drawn a chunk at a time and equal the slice of one whole
draw. `randint`, `permutation` and `shuffle` are not bit for bit: they
seed a `torch.Generator` from the split key, so they are deterministic
in the seed but draw other values than `jax.random`'s.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["RandomState", "normal", "random_bits", "seed_key", "split",
           "uniform"]

_MASK32 = 0xFFFFFFFF


def seed_key(seed):
    """≡ jax.random.PRNGKey(seed): (2,) int64 holding the uint32 words."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _MASK32, seed & _MASK32],
                        dtype=torch.int64)


def _threefry(*args):
    # imported at the call: generation/'s package imports the network
    # classes, which import this module
    from deeplearning4j_tpu_torch.generation.sampling import threefry2x32
    return threefry2x32(*args)


def split(key, num=2):
    """≡ jax.random.split(key, num) under the partitionable threefry: the
    hash of the counters (0, i) for i < num, an (num, 2) int64 tensor of
    uint32 words, one key a row."""
    lo = torch.arange(int(num), dtype=torch.int64)
    b1, b2 = _threefry(key[0], key[1], torch.zeros_like(lo), lo)
    return torch.stack([b1, b2], dim=1)


def random_bits(key, shape, device, offset=0):
    """≡ jax.random.bits(key, shape, uint32) under the partitionable
    threefry: the hash of the flat C-order index of each element, both
    words XORed. An int64 tensor of uint32 values. With `offset`, the
    elements are those from flat index `offset` on of a larger draw from
    the same key: rows [s, e) of an (R, D) table are
    `random_bits(key, (e - s, D), device, offset=s * D)`."""
    n = math.prod(shape)
    idx = torch.arange(offset, offset + n, dtype=torch.int64,
                       device=device)
    k = key.to(device)
    b1, b2 = _threefry(k[0], k[1], idx >> 32, idx & _MASK32)
    return (b1 ^ b2).reshape(shape)


def _unit(bits):
    """32 random bits → a float32 in [0, 1) (jax.random.uniform's
    mantissa trick)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def _affine(u, low, high):
    """max(u * (high - low) + low, low) in float32 with one rounding, as
    XLA's fused multiply-add gives it: the span is a float32 difference,
    the product is exact in float64, and the sum is rounded once."""
    lo = torch.tensor(low, dtype=torch.float32, device=u.device)
    span = torch.tensor(high, dtype=torch.float32, device=u.device) - lo
    y = (u.double() * span.double() + lo.double()).float()
    return torch.maximum(y, lo)


def uniform(key, shape, device, low=0.0, high=1.0, offset=0):
    """≡ jax.random.uniform(key, shape, float32, low, high), drawn from
    `key` itself (no split); `offset` as in `random_bits`."""
    return _affine(_unit(random_bits(key, tuple(shape), device, offset)),
                   low, high)


# XLA's single-precision erfinv (Giles' polynomials in w = -log1p(-x²)),
# which jax.random.normal runs: torch.special.erfinv differs by up to
# 2e-5 in the tails
_ERFINV_LO = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
              -4.39150654e-06, 0.00021858087, -0.00125372503,
              -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_HI = (-0.000200214257, 0.000100950558, 0.00134934322,
              -0.00367342844, 0.00573950773, -0.0076224613,
              0.00943887047, 1.00167406, 2.83297682)


def _erfinv(x):
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LO[0], _ERFINV_HI[0])
    for lo, hi in zip(_ERFINV_LO[1:], _ERFINV_HI[1:]):
        p = torch.where(lt, lo, hi) + p * w
    return torch.where(x.abs() == 1.0, x * torch.finfo(x.dtype).max,
                       p * x)


def normal(key, shape, device):
    """≡ jax.random.normal(key, shape) in float32, drawn from `key` itself
    (no split)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    return _erfinv(uniform(key, shape, torch.device(device), lo, 1.0)) \
        * math.sqrt(2.0)


class RandomState:
    def __init__(self, seed: int = 0, device=None):
        self._seed = int(seed)
        self._key = None
        self.device = device

    def setSeed(self, seed: int):
        self._seed = int(seed)
        self._key = None

    def _device(self):
        from deeplearning4j_tpu_torch.ops.ndarray import default_device
        return torch.device(self.device) if self.device is not None \
            else default_device()

    def split(self):
        """The next subkey: (2,) int64 of uint32 words."""
        if self._key is None:
            self._key = seed_key(self._seed)
        self._key, sub = split(self._key)
        return sub

    def uniform(self, shape=(), low=0.0, high=1.0, dtype=torch.float32):
        if dtype not in (torch.float32, None):
            raise ValueError("uniform draws float32 (the JAX package's "
                             "default); cast the result")
        return self._uniform(tuple(shape), low, high)

    def _uniform(self, shape, low, high):
        return uniform(self.split(), shape, self._device(), low, high)

    def normal(self, shape=(), mean=0.0, std=1.0, dtype=torch.float32):
        return mean + std * normal(self.split(), shape, self._device())

    def bernoulli(self, p, shape=()):
        return self.uniform(shape) < p

    def _generator(self):
        sub = self.split()
        g = torch.Generator(device="cpu")
        g.manual_seed(int(sub[0]) << 32 | int(sub[1]))
        return g

    def randint(self, low, high, shape=()):
        """Not the JAX package's draw (see the module docstring)."""
        return torch.randint(int(low), int(high), tuple(shape),
                             generator=self._generator()).to(
                                 torch.int32).to(self._device())

    def permutation(self, n):
        """Not the JAX package's draw (see the module docstring)."""
        return torch.randperm(int(n), generator=self._generator()).to(
            self._device())

    def shuffle(self, x, axis=0):
        """`x` permuted along `axis`; not the JAX package's draw."""
        t = torch.as_tensor(x)
        perm = torch.randperm(t.shape[axis], generator=self._generator())
        return t.index_select(axis, perm.to(t.device))
