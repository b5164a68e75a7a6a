"""The f32 route of csrc/bn_conv_grads.cu, csrc/flash_fwd.cu,
csrc/flash_bwd_dq.cu, csrc/flash_bwd_dkv.cu, csrc/matmul_epilogue.cu,
csrc/matmul_stats.cu and csrc/bottleneck_block.cu, emulated on the CPU.

The kernels multiply f32 operands on the tensor cores as 3×TF32: each
operand x is split into hi (x rounded to TF32's 10 mantissa bits, to
nearest with ties away from zero) and lo (the remainder x − hi, truncated
to TF32), and a·b accumulates as a_lo·b_hi + a_hi·b_lo + a_hi·b_hi in f32.
This file repeats that split in PyTorch, bit for bit as the kernel forms
it, and holds the emulated products against an f64 product at the step's
longest contractions (N = 2,048 for dX, M = 100,352 for dW) within the
kernel's f32 gate, 2e-5 × max(1, max |plain|). One TF32 pass (a_hi·b_hi
alone) must miss the same gate: that is why the kernel takes three. The
forward GEMMs are emulated at res5's longest contraction, K = 2,048, as
their walk forms it: each slice of 32 contraction values summed apart and
added to the accumulator in f32. So is the bottleneck block's 3×3 phase at
res5, the longest contraction in the port: depth 9·512 = 4,608, walked tap
by tap in slices of 32 (16 a tap), a non-negative h1 (after relu) against
W2 drawn as the smoke draws it.
The attention kernels' walk (key tiles of 32, online softmax, each tile's
second product summed apart) is emulated the same way at 2×4×512×64: O,
lse and dQ within the gate of f64 with three passes, outside it with one.
So is the dK/dV kernel's walk over query tiles of 32, in both orders of
its sums (each tile's Pᵀ·dO and dSᵀ·Q summed apart, or accumulated
straight into dK and dV as the mma chain adds them, 8 queries a step).
"""
import numpy as np
import pytest
import torch

ATOL = 2e-5  # the f32 gate of chip_smoke.py and tests/test_torch_cuda_kernels.py
#: (rows, contraction, columns, slice) of the longest contractions: the
#: step's dX = dy · wᵀ at res5 (N = 2,048) and dW = xᵀ · dy at res2
#: (M = 100,352), each one product, and the forward y = x @ w at res5's
#: 1,568 × 2,048 × 512 in slices of 32, and the bottleneck block's 3×3 at
#: res5 (49 pixels × 4,608 × 512) in slices of 32; cut to a few output rows
#: and columns
CONTRACTIONS = {"dX N=2048": (48, 2048, 40, None),
                "dW M=100352": (24, 100352, 32, None),
                "fwd K=2048": (64, 2048, 48, 32),
                "block3x3 K=4608": (49, 4608, 40, 32)}
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
    if inner == 4608:   # the 3×3: h1 after relu, W2 at std √(2 / (9·M))
        a = np.maximum(a, 0)
        b = b * np.float32(np.sqrt(2.0))
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


def _contraction(a, b, passes, piece):
    """a @ b through `passes` TF32 products, over the whole contraction at
    once or, as the forward GEMMs' walk does, `piece` values at a time,
    each piece's products summed apart and added to the sum in f32."""
    if piece is None:
        return _tf32_product(a, b, passes)
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k0 in range(0, a.shape[1], piece):
        acc = acc + _tf32_product(a[:, k0:k0 + piece], b[k0:k0 + piece],
                                  passes)
    return acc


@pytest.mark.parametrize("case", sorted(CONTRACTIONS))
def test_three_tf32_products_hold_the_f32_gate(case):
    *shape, piece = CONTRACTIONS[case]
    a, b = _operands(*shape, seed=2)
    got = _contraction(a, b, 3, piece)
    assert _scaled_err(got, a.double() @ b.double()) <= ATOL


@pytest.mark.parametrize("case", sorted(CONTRACTIONS))
def test_one_tf32_product_misses_the_f32_gate(case):
    *shape, piece = CONTRACTIONS[case]
    a, b = _operands(*shape, seed=3)
    got = _contraction(a, b, 1, piece)
    assert _scaled_err(got, a.double() @ b.double()) > ATOL


# -- attention: csrc/flash_fwd.cu and csrc/flash_bwd_dq.cu ---------------------
#: (B, H, T, D) of the attention case, and the f32 kernels' key tile
ATTN_SHAPE, ATTN_TILE = (2, 4, 512, 64), 32


def _tf32_product(a, b, passes):
    """a @ b as the kernels form it on the tensor cores: three TF32
    products (lo·hi + hi·lo + hi·hi) or one (hi·hi), each summed in f32."""
    (ah, al), (bh, bl) = split(a.contiguous()), split(b.contiguous())
    if passes == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def _attention_operands(seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(ATTN_SHAPE).astype(
        np.float32)) for _ in range(4)]                  # q, k, v, dO


def _attention_f64(q, k, v, g):
    """O, lse, dQ, dK and dV of unmasked attention in f64."""
    q, k, v, g = (x.double() for x in (q, k, v, g))
    scale = 1.0 / q.shape[-1] ** 0.5
    s = q @ k.transpose(-1, -2) * scale
    lse = torch.logsumexp(s, -1)
    p = torch.exp(s - lse[..., None])
    o = p @ v
    ds = p * (g @ v.transpose(-1, -2) - (g * o).sum(-1, keepdim=True))
    return (o, lse, ds @ k * scale, ds.transpose(-1, -2) @ q * scale,
            p.transpose(-1, -2) @ g)


def _forward_emulated(q, k, v, passes):
    """The f32 forward kernel's walk: key tiles of ATTN_TILE, Q carrying
    the scale, online softmax in f32, each tile's P·V summed apart and
    added as acc·alpha + pv."""
    qs = q * (1.0 / q.shape[-1] ** 0.5)
    m = torch.full(q.shape[:-1] + (1,), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(q)
    for k0 in range(0, k.shape[2], ATTN_TILE):
        kt, vt = k[:, :, k0:k0 + ATTN_TILE], v[:, :, k0:k0 + ATTN_TILE]
        s = _tf32_product(qs, kt.transpose(-1, -2), passes)
        mx = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - mx)
        p = torch.exp(s - mx)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _tf32_product(p, vt, passes)
        m = mx
    return acc / l, (m + torch.log(l))[..., 0]


def _dq_emulated(q, k, v, g, lse, delta, passes):
    """The f32 dQ kernel's walk: S = Q·scale·Kᵀ, dP = dO·Vᵀ and each key
    tile's dS·K summed apart and added to dQ in f32."""
    scale = 1.0 / q.shape[-1] ** 0.5
    qs = q * scale
    dq = torch.zeros_like(q)
    for k0 in range(0, k.shape[2], ATTN_TILE):
        kt, vt = k[:, :, k0:k0 + ATTN_TILE], v[:, :, k0:k0 + ATTN_TILE]
        p = torch.exp(_tf32_product(qs, kt.transpose(-1, -2), passes)
                      - lse[..., None])
        dp = _tf32_product(g, vt.transpose(-1, -2), passes)
        dq = dq + _tf32_product(p * (dp - delta[..., None]), kt, passes)
    return scale * dq


def _attention_errors(passes, seed):
    """(|ΔO|, |Δlse|, |ΔdQ| / max(1, max |dQ|)) of the emulated kernels
    against f64; dQ from the f64 lse and Δ rounded to f32, as the forward
    and the wrapper hand them over."""
    q, k, v, g = _attention_operands(seed)
    o64, lse64, dq64, _, _ = _attention_f64(q, k, v, g)
    o, lse = _forward_emulated(q, k, v, passes)
    delta = (g.double() * o64).sum(-1).float()
    dq = _dq_emulated(q, k, v, g, lse64.float(), delta, passes)
    return ((o.double() - o64).abs().max().item(),
            (lse.double() - lse64).abs().max().item(),
            _scaled_err(dq, dq64))


def test_three_tf32_products_hold_the_attention_gate():
    o_err, lse_err, dq_err = _attention_errors(passes=3, seed=4)
    assert o_err <= ATOL and lse_err <= ATOL and dq_err <= ATOL


def test_one_tf32_product_misses_the_attention_gate():
    o_err, lse_err, dq_err = _attention_errors(passes=1, seed=5)
    assert o_err > ATOL and dq_err > ATOL


def _chain(acc, a, b, passes):
    """acc + a @ b as an mma.sync chain adds it: 8 contraction values a
    step, and per step lo·hi, hi·lo and hi·hi (or hi·hi alone), each added
    to acc in f32."""
    (ah, al), (bh, bl) = split(a.contiguous()), split(b.contiguous())
    terms = [(ah, bh)] if passes == 1 else [(al, bh), (ah, bl), (ah, bh)]
    for k0 in range(0, a.shape[-1], 8):
        for x, y in terms:
            acc = acc + x[..., k0:k0 + 8] @ y[..., k0:k0 + 8, :]
    return acc


def _dkv_emulated(q, k, v, g, lse, delta, passes, order):
    """The f32 dK/dV kernel's walk: query tiles of ATTN_TILE, Sᵀ = K·scale·
    Qᵀ and dPᵀ = V·dOᵀ, then Pᵀ·dO and dSᵀ·Q, each tile's sums kept apart
    and added to dK and dV in f32 (`order` "apart") or chained straight
    onto them ("straight")."""
    scale = 1.0 / q.shape[-1] ** 0.5
    ks = k * scale
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for q0 in range(0, q.shape[2], ATTN_TILE):
        qt, gt = q[:, :, q0:q0 + ATTN_TILE], g[:, :, q0:q0 + ATTN_TILE]
        cols = slice(q0, q0 + ATTN_TILE)
        pt = torch.exp(_tf32_product(ks, qt.transpose(-1, -2), passes)
                       - lse[:, :, None, cols])
        dpt = _tf32_product(v, gt.transpose(-1, -2), passes)
        dst = pt * (dpt - delta[:, :, None, cols])
        if order == "apart":
            dv = dv + _chain(torch.zeros_like(dv), pt, gt, passes)
            dk = dk + _chain(torch.zeros_like(dk), dst, qt, passes)
        else:
            dv = _chain(dv, pt, gt, passes)
            dk = _chain(dk, dst, qt, passes)
    return scale * dk, dv


def _dkv_errors(passes, seed, order):
    """(|ΔdK|, |ΔdV|), each over max(1, max |f64|), of the emulated dK/dV
    kernel against f64, from the f64 lse and Δ rounded to f32."""
    q, k, v, g = _attention_operands(seed)
    o64, lse64, _, dk64, dv64 = _attention_f64(q, k, v, g)
    delta = (g.double() * o64).sum(-1).float()
    dk, dv = _dkv_emulated(q, k, v, g, lse64.float(), delta, passes, order)
    return _scaled_err(dk, dk64), _scaled_err(dv, dv64)


@pytest.mark.parametrize("order", ["apart", "straight"])
def test_three_tf32_products_hold_the_dkv_gate(order):
    dk_err, dv_err = _dkv_errors(passes=3, seed=6, order=order)
    assert dk_err <= ATOL and dv_err <= ATOL


@pytest.mark.parametrize("order", ["apart", "straight"])
def test_one_tf32_product_misses_the_dkv_gate(order):
    dk_err, dv_err = _dkv_errors(passes=1, seed=7, order=order)
    assert dk_err > ATOL and dv_err > ATOL
