"""How long each kernel source takes to build, all built at once.

    python3 -m deeplearning4j_tpu_torch.kernels.build_times [LOG]

Starts one nvcc per `csrc/*.cu` in parallel, as `_build.build_all` does
(with `-Xptxas -v`), and prints each source's seconds from the start to
its library, the slowest first: the build phase lasts as long as the
slowest source, and the compilers share the machine's cores. Writes the
compilers' output (registers, spills) to LOG when given. Sources whose
library is already built are not compiled again: empty `build/kernels/`
to time them all. Needs nvcc.
"""
from __future__ import annotations

import sys
import time

from deeplearning4j_tpu_torch.kernels import _build


def build_times(log_path=None):
    t0 = time.perf_counter()
    jobs = {n: _build._start(n, ("-Xptxas", "-v"))
            for n in _build.kernel_names()}
    pending = {n: j for n, j in jobs.items() if j[1] is not None}
    seconds, logs = {}, {}
    while pending:
        for name, (out, job) in list(pending.items()):
            if job[0].poll() is not None:
                logs[name] = _build._finish(name, out, job)
                seconds[name] = time.perf_counter() - t0
                del pending[name]
        time.sleep(0.2)
    if log_path:
        with open(log_path, "w") as f:
            for name, text in logs.items():
                f.write(f"== {name}\n{text}\n")
    return dict(sorted(seconds.items(), key=lambda kv: -kv[1]))


if __name__ == "__main__":
    for name, s in build_times(sys.argv[1] if len(sys.argv) > 1
                               else None).items():
        print(f"{name:<24} {s:7.1f} s")
