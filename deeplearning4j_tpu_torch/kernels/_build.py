"""Build the port's CUDA sources at first use and load them with ctypes.

Each `csrc/<name>.cu` becomes its own shared library, compiled by `nvcc`
for `sm_90a` with a plain C interface (no PyTorch headers, so a build
takes seconds), linked against libcuda (`-lcuda`: the wide
attention kernels encode TMA tensor maps with `cuTensorMapEncodeTiled`). Libraries land in `build/kernels/` at the repository
root, named by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads straight away. `build_all` starts one
`nvcc` per source, all at once; `nvcc_runs` counts the compilers started
in this process (a warm `build/kernels/` starts none).

Every C entry point launches on the stream it is given, allocates
nothing, and returns `cudaGetLastError()`; `check` turns a non-zero code
into an exception.

Launch counts: each wrapper counts its launches on `<wrapper>.launches`
through `count_launch`, under one lock (several server threads replay at
once). While a CUDA graph is captured (`capture_tally`, one capture at a
time), a launch onto a capturing stream counts on the capture's tally
instead: a capture launches nothing. That is decided by the stream, not
the thread: autograd runs a captured backward on a thread of its own,
and other threads' launches meanwhile stay on the counters.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lcuda")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
nvcc_runs = 0


def kernel_names():
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels build on a machine "
            "with the CUDA toolkit (PATH or /usr/local/cuda/bin)")
    return path


def _target(name):
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise ValueError(f"no kernel source {src}")
    h = hashlib.sha256(repr(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [src]:
        h.update(p.read_bytes())
    return src, BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name, extra):
    """Spawn nvcc for one source unless its library exists; returns
    (target, process or None). `extra` only adds compiler reports, which
    leave the library as it is, so it is not part of the library's key."""
    global nvcc_runs
    src, out = _target(name)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *extra, "-I", str(CSRC), "-o", str(tmp),
           str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    nvcc_runs += 1
    return out, (proc, tmp)


def _finish(name, out, job):
    """Wait for one nvcc and move its library into place; returns the
    compiler's output."""
    if job is None:
        return ""
    proc, tmp = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all(verbose=False):
    """Compile every `csrc/*.cu` in parallel (one nvcc each) and load the
    libraries. `verbose` adds `-Xptxas -v` (registers, shared memory and
    spills per kernel) to the sources it compiles; a library already
    built loads with no report. Returns {"seconds": wall time, "logs": {name:
    compiler output}}."""
    extra = ("-Xptxas", "-v") if verbose else ()
    t0 = time.perf_counter()
    with _lock:
        jobs = {n: _start(n, extra) for n in kernel_names()}
        logs = {n: _finish(n, out, job) for n, (out, job) in jobs.items()}
        for n, (out, _) in jobs.items():
            _libs.setdefault(n, ctypes.CDLL(str(out)))
    return {"seconds": time.perf_counter() - t0, "logs": logs}


def library(name):
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            out, job = _start(name, ())
            _finish(name, out, job)
            _libs[name] = ctypes.CDLL(str(out))
        return _libs[name]


_count_lock = threading.Lock()
_tally = None        # the capture in progress's {wrapper: launches}


def count_launch(wrapper, n=1):
    """Count `n` launches of `wrapper`'s kernel: on the capture's tally
    when the calling thread's stream is capturing, else on
    `wrapper.launches`."""
    with _count_lock:
        if _tally is not None and torch.cuda.is_current_stream_capturing():
            _tally[wrapper] = _tally.get(wrapper, 0) + n
        else:
            wrapper.launches += n


@contextlib.contextmanager
def capture_tally():
    """For the span of one graph capture, count the launches made onto a
    capturing stream into a fresh {wrapper: n} (yielded). Captures do not
    overlap (the executable store holds its capture lock)."""
    global _tally
    with _count_lock:
        _tally = {}
        tally = _tally
    try:
        yield tally
    finally:
        with _count_lock:
            _tally = None


def check(code, what):
    """Raise if a C entry returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{what} failed to launch: CUDA error {code}")
