"""The f32 route of csrc/bn_conv_grads.cu, emulated on the CPU.

The kernel multiplies f32 operands on the tensor cores as 3×TF32: each
operand x is split into hi (x rounded to TF32's 10 mantissa bits, to
nearest with ties away from zero) and lo (the remainder x − hi, truncated
to TF32), and a·b accumulates as a_lo·b_hi + a_hi·b_lo + a_hi·b_hi in f32.
This file repeats that split in PyTorch, bit for bit as the kernel forms
it, and holds the emulated products against an f64 product at the step's
longest contractions (N = 2,048 for dX, M = 100,352 for dW) within the
kernel's f32 gate, 2e-5 × max(1, max |plain|). One TF32 pass (a_hi·b_hi
alone) must miss the same gate: that is why the kernel takes three.
"""
import numpy as np
import pytest
import torch

ATOL = 2e-5  # the f32 gate of chip_smoke.py and tests/test_torch_cuda_kernels.py
#: (rows, contraction, columns) of the step's longest contractions:
#: dX = dy · wᵀ at res5 (N = 2,048) and dW = xᵀ · dy at res2 (M = 100,352),
#: cut to a few output rows and columns
CONTRACTIONS = {"dX N=2048": (48, 2048, 40), "dW M=100352": (24, 100352, 32)}
_MASK = -8192  # 0xffffe000 as int32: keeps sign, exponent, 10 mantissa bits


def split(x):
    """(hi, lo) of an f32 tensor as the kernel's mma_tile.cuh `split`
    forms them, on the integer view of the bits."""
    hi = ((x.view(torch.int32) + 0x1000) & _MASK).view(torch.float32)
    lo = ((x - hi).view(torch.int32) & _MASK).view(torch.float32)
    return hi, lo


def _operands(rows, inner, cols, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((rows, inner)).astype(np.float32)
    b = (rng.standard_normal((inner, cols)) / np.sqrt(inner)).astype(
        np.float32)
    if inner > 10_000:  # dW: x and dy as they come, no 1/√M scale
        b = rng.standard_normal((inner, cols)).astype(np.float32)
    return torch.from_numpy(a), torch.from_numpy(b)


def _scaled_err(got, want):
    return ((got.double() - want).abs().max()
            / max(1.0, want.abs().max().item())).item()


def test_split_rounds_to_tf32_and_keeps_f32_accuracy():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        100_000).astype(np.float32) * 10.0 ** np.random.default_rng(
            1).integers(-20, 20, 100_000).astype(np.float32))
    hi, lo = split(x)
    for part in (hi, lo):
        assert ((part.view(torch.int32) & 0x1FFF) == 0).all()
    xd = x.double()
    # hi is within half a TF32 ulp of x, hi + lo within 2^-21 of x
    assert ((xd - hi.double()).abs() <= 2.0 ** -11 * xd.abs()).all()
    assert ((xd - hi.double() - lo.double()).abs()
            <= 2.0 ** -21 * xd.abs()).all()
    # ties go away from zero: 1 + 2^-11 lies halfway between TF32 values
    tie = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11)])
    assert split(tie)[0].tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10)]


@pytest.mark.parametrize("case", sorted(CONTRACTIONS))
def test_three_tf32_products_hold_the_f32_gate(case):
    a, b = _operands(*CONTRACTIONS[case], seed=2)
    (ah, al), (bh, bl) = split(a), split(b)
    got = al @ bh + ah @ bl + ah @ bh
    assert _scaled_err(got, a.double() @ b.double()) <= ATOL


@pytest.mark.parametrize("case", sorted(CONTRACTIONS))
def test_one_tf32_product_misses_the_f32_gate(case):
    a, b = _operands(*CONTRACTIONS[case], seed=3)
    got = split(a)[0] @ split(b)[0]
    assert _scaled_err(got, a.double() @ b.double()) > ATOL
