"""OpExecutioner facade (≡ nd4j NativeOpExecutioner / CudaExecutioner):
the port of `deeplearning4j_tpu/runtime/executioner.py`.

The reference routes every op through an executioner that picks kernels
and manages streams. In the port an op runs eagerly (PyTorch launches its
kernels on the current stream; there is no jit cache to keep), so the
executioner keeps the reference's vocabulary and its profiling: with
`setProfilingMode(True)` each `exec` counts its function and times it —
on the card with CUDA events around the call (device time), on the CPU
with the host clock. With monitoring on, every dispatch counts on
`dl4j.op.dispatches`.
"""
from __future__ import annotations

import collections
import time

import torch

from deeplearning4j_tpu_torch import monitoring as _mon

__all__ = ["OpExecutioner"]


def _devices_of(args):
    for a in args:
        t = getattr(a, "tensor", a)
        if torch.is_tensor(t):
            return t.device
    return None


class OpExecutioner:
    _instance = None

    def __init__(self):
        self.profiling = False
        self.op_counts = collections.Counter()
        self.op_times = collections.defaultdict(float)
        self._dispatches = None   # (registry, generation, counter)

    @classmethod
    def getInstance(cls):
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    # -- dispatch --------------------------------------------------------
    def exec(self, fn, *args, static_argnums=(), **kwargs):
        """Run `fn(*args, **kwargs)` now. `static_argnums` is accepted for
        the reference's signature (there is nothing to trace). Profiling
        counts and times the call under the function's name; the disabled
        path is the call alone."""
        mon_on = _mon.enabled()
        if not (self.profiling or mon_on):
            return fn(*args, **kwargs)
        if mon_on:
            reg = _mon.get_registry()
            h = self._dispatches
            if h is None or h[0] is not reg or h[1] != reg.generation:
                h = self._dispatches = (reg, reg.generation,
                                        reg.counter(_mon.OP_DISPATCHES))
            h[2].inc()
        if not self.profiling:
            return fn(*args, **kwargs)
        dev = _devices_of(list(args) + list(kwargs.values()))
        if dev is not None and dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            dt = time.perf_counter() - t0
        name = getattr(fn, "__name__", str(fn))
        self.op_counts[name] += 1
        self.op_times[name] += dt
        return out

    def commit(self):
        """≡ flushing the op queue: wait for all device work."""
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    # -- profiling (≡ OpProfiler) ---------------------------------------
    def setProfilingMode(self, enabled):
        self.profiling = bool(enabled)

    def getProfilingStats(self):
        return {name: {"count": self.op_counts[name],
                       "total_time_s": self.op_times[name]}
                for name in self.op_counts}

    def printEnvironmentInformation(self):
        cuda = torch.cuda.is_available()
        info = {
            "backend": "cuda" if cuda else "cpu",
            "devices": ([torch.cuda.get_device_name(i)
                         for i in range(torch.cuda.device_count())]
                        if cuda else ["cpu"]),
            "torch": torch.__version__,
        }
        for k, v in info.items():
            print(f"{k}: {v}")
        return info
