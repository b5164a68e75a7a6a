"""The rate of the tensor-core walk of csrc/mma_tile.cuh on the card.

    python3 -m deeplearning4j_tpu_torch.kernels.engine_rate

Times `matmul_epilogue` (bf16, f32 as 3×TF32) and `int8_matmul_epilogue`
at 8192 × 8192 × 8192, where the walk's own rate shows rather than a
shape's edges, beside one PyTorch call for the same product, and prints
TFLOP/s (TOP/s for int8) with the card's name and power limit. The
bottleneck block's tile model (csrc/bottleneck_block.cu `consider`) takes
its rate from this. Needs a CUDA card.
"""
from __future__ import annotations

import subprocess

import torch

from deeplearning4j_tpu_torch.kernels import pointwise_conv as pc

N = 8192


def _ms(fn, iters=3):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    if not torch.cuda.is_available():
        raise SystemExit("engine_rate: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    gen = torch.Generator(device="cuda").manual_seed(0)
    ones = torch.ones(N, device="cuda")
    zeros = torch.zeros(N, device="cuda")
    for dtype in (torch.bfloat16, torch.float32, torch.int8):
        if dtype == torch.int8:
            x, w = (torch.randint(-127, 128, (N, N), generator=gen,
                                  device="cuda", dtype=torch.int32)
                    .to(torch.int8) for _ in range(2))
            kernel = lambda: pc.int8_matmul_epilogue(x, w, ones, zeros)
            library = lambda: torch._int_mm(x, w)
        else:
            x, w = (torch.randn((N, N), generator=gen, device="cuda")
                    .to(dtype) for _ in range(2))
            kernel = lambda: pc.matmul_epilogue(x, w, ones, zeros)
            library = lambda: torch.matmul(x, w)
        ms, lib = _ms(kernel), _ms(library)
        rate = 2.0 * N ** 3 / 1e9
        print(f"{str(dtype)[6:]:9s} {N}^3 kernel {ms:.4f} ms "
              f"({rate / ms:.1f} T/s), library {lib:.4f} ms "
              f"({rate / lib:.1f} T/s), tile "
              f"{pc._fwd_tile(N, N, N, dtype == torch.int8)}", flush=True)


if __name__ == "__main__":
    main()
