"""Where a block of the wide forward spends its key tiles, by clock64.

    python3 -m deeplearning4j_tpu_torch.kernels.wide_trace

Builds `csrc/flash_fwd.cu` and `csrc/flash_fwd_bf16.cu` once more with
`-DDL4J_WIDE_TRACE` (into `build/kernels/`, beside the wrappers'
libraries, which are built without it), runs the wide forward at the
one-head layers' shapes (D = 256 and 512 at B·H × 512², the learned
queries' Tq = 4) and prints, for block (0, 0, 0), the cycles each
consumer warpgroup spends per key tile waiting for K's slice, in S =
Q·Kᵀ, in the exchange of the partial sums, in the softmax, waiting for
V's slice and in P·V (`csrc/attn_wide.cuh`, `WIDE_TRACE`). Needs nvcc and
a CUDA card.
"""
from __future__ import annotations

import ctypes
import importlib
import subprocess

import torch

from deeplearning4j_tpu_torch.kernels import _build

# the module (the package re-exports the function under its name)
fa = importlib.import_module("deeplearning4j_tpu_torch.kernels.flash_attention")

#: (label, (B, H, Tq, Tk, D), key lengths)
SHAPES = (("D=256", (32, 1, 512, 512, 256), [512 - 13 * i for i in range(32)]),
          ("Tq=4", (32, 1, 4, 512, 256), [512 - 13 * i for i in range(32)]),
          ("D=512", (16, 1, 512, 512, 512), [512 - 31 * i for i in range(16)]))
STEPS = ("kwait", "S", "exchange", "softmax", "vwait", "PV")


def _library(name):
    out = _build.BUILD_DIR / f"{name}-trace.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DDL4J_WIDE_TRACE",
                    "-I", str(_build.CSRC), "-o", str(out),
                    str(_build.CSRC / f"{name}.cu")], check=True)
    return ctypes.CDLL(str(out))


def trace(lib, dtype, shape, lens):
    """Per consumer warpgroup, a list of {step: cycles} per key tile."""
    sym = "dl4j_flash_fwd" + fa._DTYPE_SUFFIX[dtype]
    fn = getattr(lib, sym)
    fn.argtypes, fn.restype = fa._ENTRIES[sym][1], ctypes.c_int
    stamps = lib.dl4j_wide_trace
    stamps.argtypes, stamps.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    b, h, tq, tk, d = shape
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((b, h, t, d), generator=gen, device=dev).to(dtype)
               for t in (tq, tk, tk))
    mask = (torch.arange(tk, device=dev)[None]
            < torch.tensor(lens, device=dev)[:, None])
    out = torch.empty_like(q)
    lse = torch.empty((b * h, tq), device=dev)
    _build.check(stamps(None, 0), "dl4j_wide_trace")
    for _ in range(3):   # the last launch's stamps are read
        _build.check(fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            out.data_ptr(), lse.data_ptr(), fa._DTYPE_CODES[dtype], b * h, h,
            tq, tk, d, 0, 1.0 / d ** 0.5, 0,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)), sym)
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 4096)()
    _build.check(stamps(ctypes.cast(buf, ctypes.c_void_p), 0),
                    "dl4j_wide_trace")
    groups = []
    for wg in range(2):
        base, rows = 1024 * wg, []
        for kt in range(127):
            t = buf[base + 8 * kt: base + 8 * kt + 7]
            if t[0] < buf[base + 1020] or t[0] == 0:
                continue
            rows.append({s: t[i + 1] - t[i] for i, s in enumerate(STEPS)})
        groups.append(rows)
    return groups


def main():
    for name, dtype in (("flash_fwd_bf16", torch.bfloat16),
                        ("flash_fwd", torch.float32)):
        lib = _library(name)
        for label, shape, lens in SHAPES:
            for wg, rows in enumerate(trace(lib, dtype, shape, lens)):
                mean = {s: sum(r[s] for r in rows) / max(1, len(rows))
                        for s in STEPS}
                print(f"{name} {label} warpgroup {wg}: {len(rows)} tiles, "
                      "mean cycles a tile " + " ".join(
                          f"{s}={mean[s]:.0f}" for s in STEPS))


if __name__ == "__main__":
    main()
