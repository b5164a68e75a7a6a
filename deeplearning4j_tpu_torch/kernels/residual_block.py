"""The fused ResNet bottleneck block for inference: the port of
`bottleneck_block` and `bottleneck_block_xla` of
`deeplearning4j_tpu/kernels/residual_block.py`.

    h1 = relu(x @ W1 + b1)            (1x1 reduce,  C -> M)
    h2 = relu(conv3x3(h1, W2) + b2)   (SAME, M -> M)
    y  = relu(h2 @ W3 + b3 + x)       (1x1 expand,  M -> C, residual)

BN is folded into the conv weights and biases (the inference form). On a
CUDA tensor `bottleneck_block` launches the hand-written Hopper kernel
(csrc/bottleneck_block.cu), one launch whose three products run on the
tensor cores (mma.sync bf16; f32 as 3×TF32) and which keeps h1 and h2 in
shared memory: a block owns R output rows of one image with a one-row
halo, R picked per shape (`_plan`). On a CPU tensor it runs the plain
version, `bottleneck_block_xla`: the same math as three convolutions.
Launches are counted on `bottleneck_block.launches`.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.kernels import _build

__all__ = ["bottleneck_block", "bottleneck_block_xla"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
# x, w1, b1, w2, b2, w3, b3, y, dtype, B, H, W, C, M, device, stream
_ARGTYPES = [_P] * 8 + [_I] * 7 + [_P]
_bound = []
#: a block holds h1 and h2 of one image row at least (four pixel rows of
#: W·(M + 8) values) beside its ring: W·(M + 8)·size is at most this
_ROW_BYTES = 38_144


def _entry():
    if not _bound:
        fn = _build.library("bottleneck_block").dl4j_bottleneck_block
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _bound.append(fn)
    return _bound[0]


def _plan(dtype, b, h, w, c, m):
    """The launch's plan for this shape on the current card
    (csrc/bottleneck_block.cu `block_plan`): {"rows": R image rows per
    block, "pixels": R·W, "blocks", "mi": row fragments per warp (tiles of
    32·mi pixels), "smem": bytes, "bn": the tile's channels}."""
    fn = _build.library("bottleneck_block").dl4j_bottleneck_plan
    fn.argtypes, fn.restype = [_I] * 6 + [_P], _I
    out = (ctypes.c_int * 6)()
    _build.check(fn(_DTYPE_CODES[dtype], b, h, w, c, m, out),
                 "bottleneck_block plan")
    return dict(zip(("rows", "pixels", "blocks", "mi", "smem", "bn"), out))


def _conv(x, w, pad):
    """SAME conv of NHWC x with HWIO w, f32 math (f64 for f64 inputs)."""
    wide = torch.float64 if x.dtype == torch.float64 else torch.float32
    y = F.conv2d(x.to(wide).permute(0, 3, 1, 2),
                 w.to(wide).permute(3, 2, 0, 1), padding=pad)
    return y.permute(0, 2, 3, 1)


def bottleneck_block_xla(x, w1, b1, w2, b2, w3, b3):
    """The identical math as plain ops: three convolutions with the
    weights cast to x.dtype and the products summed in f32, h1 and h2
    rounded to x.dtype as the kernel rounds them (the correctness oracle
    and the yardstick of the kernel)."""
    dt = x.dtype
    wide = torch.float64 if dt == torch.float64 else torch.float32
    h1 = torch.relu(_conv(x, w1.to(dt)[None, None], 0) + b1.to(wide)).to(dt)
    h2 = torch.relu(_conv(h1, w2.to(dt), 1) + b2.to(wide)).to(dt)
    h3 = _conv(h2, w3.to(dt)[None, None], 0) + b3.to(wide)
    return torch.relu(h3 + x.to(wide)).to(dt)


def bottleneck_block(x, w1, b1, w2, b2, w3, b3, block_b=8):
    """Fused bottleneck forward. x (B,H,W,C) NHWC; w1 (C,M), w2 (3,3,M,M),
    w3 (M,C); biases (M,)/(M,)/(C,) — BN folded. B % block_b == 0, as in
    the JAX package; `block_b` does not shape the CUDA grid, which has one
    block per R output rows of each image. On the card x and the weights
    are f32 or bf16 in one dtype; biases are used in f32; M and C are
    multiples of 8, and a block keeps at least four pixel rows of h1 and
    h2 in shared memory beside its ring, so W·(M + 8) is at most 9,536 in
    f32 and 19,072 in bf16 (3,640–4,032 at ResNet-50's stages). A shape
    beyond these raises."""
    b = x.shape[0]
    if b % block_b:
        raise ValueError(f"batch {b} not divisible by block_b={block_b}")
    if not x.is_cuda:
        return bottleneck_block_xla(x, w1, b1, w2, b2, w3, b3)
    if x.ndim != 4:
        raise ValueError(f"bottleneck_block: x must be (B, H, W, C), got "
                         f"{tuple(x.shape)}")
    _, h, w, c = x.shape
    m = w1.shape[-1]
    shapes = {"w1": (w1, (c, m)), "w2": (w2, (3, 3, m, m)),
              "w3": (w3, (m, c)), "b1": (b1, (m,)), "b2": (b2, (m,)),
              "b3": (b3, (c,))}
    for what, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"bottleneck_block: {what} must be {want}, got "
                             f"{tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"bottleneck_block: {what} lies on {t.device}, "
                             f"x on {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"bottleneck_block takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if m % 8 or c % 8:
        raise ValueError(f"bottleneck_block: C = {c} and M = {m} must be "
                         f"multiples of 8 on the card")
    if w * (m + 8) * x.element_size() > _ROW_BYTES:
        raise ValueError(f"bottleneck_block: W·(M + 8) = {w * (m + 8)} "
                         f"values of {x.dtype} exceed a block's shared "
                         f"memory (at most {_ROW_BYTES} bytes a pixel "
                         f"row)")
    for what in ("w1", "w2", "w3"):
        if shapes[what][0].dtype != x.dtype:
            raise TypeError(f"bottleneck_block: {what} must be {x.dtype}, "
                            f"got {shapes[what][0].dtype}")
    x, w1, w2, w3 = (t.contiguous() for t in (x, w1, w2, w3))
    if x.data_ptr() % 16:      # the kernel reads x 16 bytes at a time
        x = x.clone()
    b1, b2, b3 = (t.to(torch.float32).contiguous() for t in (b1, b2, b3))
    y = torch.empty_like(x)
    code = _entry()(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), w3.data_ptr(), b3.data_ptr(), y.data_ptr(),
        _DTYPE_CODES[x.dtype], b, h, w, c, m, x.device.index or 0,
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    _build.check(code, "bottleneck_block")
    _build.count_launch(bottleneck_block)
    return y


bottleneck_block.launches = 0
