"""The int8 route of csrc/matmul_epilogue.cu, emulated on the CPU in numpy.

The kernel multiplies int8 × int8 into int32 with mma.sync.m16n8k32 (csrc/
mma_tile.cuh: `FwdOps::frags`, `b_frags`, `fwd_run`). x's tile (rows of K
contiguous) gives A's registers as 32-bit words of four consecutive k; w's
tile (rows of N contiguous) has no such word, so each thread reads one
32-bit word (four adjacent columns) from each of four consecutive k rows
and transposes the 4 × 4 bytes with __byte_perm: n8 fragments 4j … 4j + 3
at fragment column g are tile columns 32j + 4g … + 3, and a thread's
accumulators are 8 adjacent output columns of a row.

This file forms those registers byte for byte as the kernel does (the
__byte_perm selectors, the threads with t ≥ 2 reading their rows in the
order 2, 3, 0, 1), multiplies them through the PTX ISA's m16n8k32 fragment
layout, maps each accumulator back to its output column as the epilogue
does, and holds the result to xq @ wq exactly, on a ragged (M, K, N) with
slices of 128 zero-filled past K. It also checks that the stage's row
strides (BK + 16 bytes for x, BN + 16 for w) give every fragment load of a
warp 32 different banks.
"""
import numpy as np
import pytest

BK = 128           # contraction values per int8 slice (mma_tile.cuh kBK8)
SX = BK + 16       # bytes per staged row of x
LANES = [(lane // 4, lane % 4) for lane in range(32)]  # (g, t)


def byte_perm(x, y, sel):
    """CUDA's __byte_perm(x, y, s): byte n of the result is byte s[n] of
    the eight bytes y:x (x's bytes 0-3, y's 4-7)."""
    src = int(x) | (int(y) << 32)
    out = 0
    for n in range(4):
        b = (sel >> (4 * n)) & 0x7
        out |= ((src >> (8 * b)) & 0xFF) << (8 * n)
    return out


def word(tile, row, col):
    """The little-endian 32-bit word of four bytes at tile[row, col:col+4]."""
    b = tile[row, col:col + 4].astype(np.uint8).astype(np.uint32)
    return int(b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24))


def a_regs(xs, rb, kk, g, t):
    """FwdOps::frags: a[h] at row g + 8h, k = kk + 4t; a[2 + h] at + 16."""
    regs = [0] * 4
    for h in range(2):
        r = rb + g + 8 * h
        regs[h] = word(xs, r, kk + 4 * t)
        regs[2 + h] = word(xs, r, kk + 16 + 4 * t)
    return regs


def b_regs(ws, kk, cb, g, t):
    """b_frags for int8: fb[4j + e][q] for j = 0, as the kernel forms them,
    including the rotated read order of the threads with t ≥ 2."""
    rot = t & 2
    fb = [[0, 0] for _ in range(4)]
    for q in range(2):
        row = kk + 16 * q + 4 * t
        v = [word(ws, row + (i ^ rot), cb + 4 * g) for i in range(4)]
        w = [v[r ^ 2] if rot else v[r] for r in range(4)]
        t0 = byte_perm(w[0], w[1], 0x5140)
        t1 = byte_perm(w[0], w[1], 0x7362)
        t2 = byte_perm(w[2], w[3], 0x5140)
        t3 = byte_perm(w[2], w[3], 0x7362)
        fb[0][q] = byte_perm(t0, t2, 0x5410)
        fb[1][q] = byte_perm(t0, t2, 0x7632)
        fb[2][q] = byte_perm(t1, t3, 0x5410)
        fb[3][q] = byte_perm(t1, t3, 0x7632)
    return fb


def _bytes(reg):
    return [np.int8(np.uint8((reg >> (8 * i)) & 0xFF)) for i in range(4)]


def mma_m16n8k32(a_of_lane, b_of_lane):
    """D (16 × 8, int64) of one mma.sync.m16n8k32.s8 from each lane's A
    registers (four) and B registers (two), placed by the PTX ISA's
    fragment layout, and D's layout back per lane: {lane: [c0..c3]}."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for lane, (g, t) in enumerate(LANES):
        for reg in range(4):
            for i, v in enumerate(_bytes(a_of_lane[lane][reg])):
                idx = 4 * reg + i
                row = g if idx < 4 or 8 <= idx < 12 else g + 8
                col = t * 4 + (idx & 3) + (16 if idx >= 8 else 0)
                A[row, col] = v
        for reg in range(2):
            for i, v in enumerate(_bytes(b_of_lane[lane][reg])):
                idx = 4 * reg + i
                B[t * 4 + (idx & 3) + (16 if idx >= 4 else 0), g] = v
    D = A @ B
    return {lane: [D[g + 8 * (i >= 2), 2 * t + (i & 1)] for i in range(4)]
            for lane, (g, t) in enumerate(LANES)}


def emulate(xq, wq):
    """xq @ wq through the kernel's registers: warp tiles of 16 rows × 32
    columns, slices of BK zero-filled past K, the accumulators mapped to
    columns by fwd_run<4>: v[4c + e] = acc[4j + e][2h + c] is tile column
    32j + 8t + 4c + e of row g + 8h."""
    m, k = xq.shape
    n = wq.shape[1]
    mp, kp, npad = -(-m // 16) * 16, -(-k // BK) * BK, -(-n // 32) * 32
    xs = np.zeros((mp, kp), np.int8)
    xs[:m, :k] = xq
    ws = np.zeros((kp, npad + 16), np.int8)   # rows of BN + 16 bytes
    ws[:k, :n] = wq
    out = np.zeros((mp, npad), np.int64)
    for rb in range(0, mp, 16):
        for cb in range(0, npad, 32):
            acc = {lane: [[0] * 4 for _ in range(4)] for lane in range(32)}
            for kk in range(0, kp, 32):
                a = {lane: a_regs(xs, rb, kk, g, t)
                     for lane, (g, t) in enumerate(LANES)}
                b = {lane: b_regs(ws, kk, cb, g, t)
                     for lane, (g, t) in enumerate(LANES)}
                for ni in range(4):
                    d = mma_m16n8k32(a, {lane: b[lane][ni]
                                         for lane in range(32)})
                    for lane in range(32):
                        for i in range(4):
                            acc[lane][ni][i] += d[lane][i]
            for lane, (g, t) in enumerate(LANES):
                for h in range(2):
                    for c in range(2):
                        for e in range(4):
                            out[rb + g + 8 * h, cb + 8 * t + 4 * c + e] = \
                                acc[lane][e][2 * h + c]
    return out[:m, :n]


@pytest.mark.parametrize("m,k,n", [(20, 70, 33), (16, 130, 64)])
def test_int8_fragments_reproduce_the_exact_product(m, k, n):
    rng = np.random.default_rng(7)
    xq = rng.integers(-128, 128, (m, k)).astype(np.int8)
    wq = rng.integers(-128, 128, (k, n)).astype(np.int8)
    got = emulate(xq, wq)
    np.testing.assert_array_equal(got, xq.astype(np.int64) @ wq)


def test_byte_transpose_puts_each_column_in_one_register():
    rows = [0x03020100, 0x13121110, 0x23222120, 0x33323130]
    t0 = byte_perm(rows[0], rows[1], 0x5140)
    t1 = byte_perm(rows[0], rows[1], 0x7362)
    t2 = byte_perm(rows[2], rows[3], 0x5140)
    t3 = byte_perm(rows[2], rows[3], 0x7362)
    cols = [byte_perm(t0, t2, 0x5410), byte_perm(t0, t2, 0x7632),
            byte_perm(t1, t3, 0x5410), byte_perm(t1, t3, 0x7632)]
    # column e: the e-th byte of rows 0..3, row 0 in the low byte
    assert cols == [0x30201000 + 0x01010101 * e for e in range(4)]


def _banks(addresses):
    return len({(a // 4) % 32 for a in addresses})


@pytest.mark.parametrize("bn", [64, 128])
def test_int8_fragment_loads_meet_no_bank_conflict(bn):
    sn = bn + 16
    for cb in range(0, bn, 32):
        for q in range(2):
            for i in range(4):        # one 32-bit load per i: w's rows
                addr = [(16 * q + 4 * t + (i ^ (t & 2))) * sn + cb + 4 * g
                        for g, t in LANES]
                assert _banks(addr) == 32, (bn, cb, q, i)
    for h in range(2):                # x's rows: a[h] and a[2 + h]
        for off in (0, 16):
            addr = [(g + 8 * h) * SX + off + 4 * t for g, t in LANES]
            assert _banks(addr) == 32
