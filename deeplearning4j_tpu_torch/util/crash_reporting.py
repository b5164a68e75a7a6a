"""OOM crash reporting (≡ deeplearning4j-core ::
org.deeplearning4j.util.CrashReportingUtil): the port of
`deeplearning4j_tpu/util/crash_reporting.py`.

Reference behavior: when training/inference dies with an OOM, DL4J
writes a `dl4j-memory-crash-dump-<ts>.txt` with JVM/device memory state,
network configuration, and per-layer memory use; enabled by default,
`CrashReportingUtil.crashDumpsEnabled(false)` to turn off.

The port's dump carries each CUDA device's memory (`torch.cuda.
mem_get_info` and the caching allocator's `memory_stats`, through
`monitoring/memory.py`), the per-layer parameter footprints of a tree of
tensors, the configuration, the last telemetry reading, the step
recorder, the event journal and the monitoring snapshot. `is_oom` keeps
the JAX package's pattern, which also matches `torch.cuda.
OutOfMemoryError`'s "CUDA out of memory". The dump is advisory and never
masks the original exception.
"""
from __future__ import annotations

import datetime
import os
import re
import traceback

from deeplearning4j_tpu_torch.monitoring import memory as _mem

__all__ = ["CrashReportingUtil"]

#: word-bounded so e.g. a tensor named "BLOOM_head" in a ValueError does
#: not read as an OOM
_OOM_RE = re.compile(
    r"RESOURCE_EXHAUSTED|[Oo]ut of memory|\bOOM\b|Allocation failure"
    r"|failed to allocate")


class CrashReportingUtil:
    _enabled = True
    _directory = "."

    @staticmethod
    def crashDumpsEnabled(enabled):
        CrashReportingUtil._enabled = bool(enabled)

    @staticmethod
    def crashDumpOutputDirectory(directory=None):
        if directory is not None:
            CrashReportingUtil._directory = str(directory)
        return CrashReportingUtil._directory

    @staticmethod
    def is_oom(exception):
        msg = f"{type(exception).__name__}: {exception}"
        return _OOM_RE.search(msg) is not None

    @staticmethod
    def maybe_dump(model, exception):
        """Write a crash dump if reporting is enabled and the exception
        looks like device OOM. Returns the path or None; never raises.
        Dumps once per exception object — nested decorated calls
        (output() inside a fit() listener) do not dump twice."""
        try:
            if not CrashReportingUtil._enabled or \
                    not CrashReportingUtil.is_oom(exception) or \
                    getattr(exception, "_dl4j_tpu_dumped", False):
                return None
            path = CrashReportingUtil.writeMemoryCrashDump(model, exception)
            try:
                exception._dl4j_tpu_dumped = True
            except Exception:  # noqa: BLE001 — exceptions w/o __dict__
                pass
            return path
        except Exception:  # noqa: BLE001 — never mask the original error
            return None

    @staticmethod
    def writeMemoryCrashDump(model, exception, path=None):
        ts = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
        if path is None:
            base = os.path.join(
                CrashReportingUtil._directory,
                f"dl4j-torch-memory-crash-dump-{ts}-{os.getpid()}")
            path, n = f"{base}.txt", 0
            while os.path.exists(path):   # two OOMs in one second
                n += 1
                path = f"{base}-{n}.txt"
        lines = [f"deeplearning4j_tpu_torch memory crash dump ({ts})",
                 "=" * 60, ""]
        lines.append("Exception:")
        lines.append("".join(traceback.format_exception_only(
            type(exception), exception)).strip())
        lines.append("")

        # device memory state: each CUDA device's reading
        try:
            devices = _mem.device_memory_stats()
            if not devices:
                lines.append("(no CUDA device)")
            for d, stats in devices.items():
                lines.append(f"Device {d}:")
                if stats:
                    for k in sorted(stats):
                        lines.append(f"  {k}: {stats[k]:,}")
                else:
                    lines.append("  (memory query failed)")
        except Exception as e:  # noqa: BLE001 — report what we can
            lines.append(f"(device query failed: {e})")
        lines.append("")

        # per-layer parameter footprint
        params = getattr(model, "_params", None)
        if params:
            lines.append("Parameters by layer:")
            total = 0
            for name in params:
                b = _mem._tree_bytes(params[name])
                total += b
                sub = params[name]
                shapes = ({k: tuple(v.shape) for k, v in sub.items()
                           if hasattr(v, "shape")}
                          if isinstance(sub, dict) else
                          f"{len(_mem._leaves(sub))} tensors")
                lines.append(f"  {name}: {b:,} bytes  {shapes}")
            lines.append(f"  TOTAL params: {total:,} bytes")
            opt = getattr(model, "_opt_state", None)
            if opt is not None:
                lines.append(
                    f"  updater state: {_mem._tree_bytes(opt):,} bytes")
        lines.append("")

        conf = getattr(model, "conf", None)
        if conf is not None:
            lines.append(f"Configuration: {type(conf).__name__} "
                         f"(layers: {len(getattr(conf, 'layers', []) or [])})")
        lines.append("")

        # OOM forensics: the LAST telemetry reading taken BEFORE the
        # crash (monitoring/memory.py sample()) — after an OOM the
        # allocator has often unwound, so the live post-mortem numbers
        # above under-report the spike; this is the last-known-good view
        try:
            snap = _mem.last_sample()
            if snap is not None:
                age = datetime.datetime.now().timestamp() - snap["ts"]
                lines.append(f"Device memory telemetry "
                             f"(last reading, {age:.1f}s before dump):")
                for dev, stats in snap["devices"].items():
                    if stats:
                        keep = {k: stats[k] for k in
                                ("bytes_in_use", "peak_bytes_in_use",
                                 "bytes_limit") if k in stats}
                        lines.append(f"  {dev}: " + ", ".join(
                            f"{k}={v:,}" for k, v in keep.items()))
                    else:
                        lines.append(f"  {dev}: (no memory_stats)")
                if "model" in snap:
                    lines.append("  model footprint: " + ", ".join(
                        f"{k}={v:,}" for k, v in snap["model"].items()))
                lines.append("")
        except Exception as e:  # noqa: BLE001 — dumps must never raise
            lines.append(f"(memory telemetry unavailable: {e})")
            lines.append("")

        # step-time flight recorder: percentile summary + the last few
        # per-step attribution records (monitoring/steps.py) — "what was
        # each step doing right before the OOM"
        try:
            from deeplearning4j_tpu_torch.monitoring import steps as _steps
            rec = _steps.recorder()
            if rec.records(last=1):
                lines.append("Step-time flight recorder:")
                lines.extend(rec.crash_lines())
                lines.append("")
        except Exception as e:  # noqa: BLE001
            lines.append(f"(flight recorder unavailable: {e})")
            lines.append("")

        # ops event journal tail: the SAME section stall and peer
        # reports embed (monitoring/events.py) — the ordered causal
        # record leading into this crash, plus the machine-readable
        # post-mortem bundle alongside the text dump
        try:
            from deeplearning4j_tpu_torch import monitoring as _mon
            from deeplearning4j_tpu_torch.monitoring import events as _events
            lines.extend(_events.event_tail_lines())
            lines.append("")
            if _mon.enabled():
                bundle_path = _events.write_bundle(
                    dump_dir=os.path.dirname(path) or None,
                    headline=f"memory crash dump: see {path}")
                lines.append(f"Post-mortem bundle: "
                             f"{bundle_path or '(failed)'}")
                lines.append("")
        except Exception as e:  # noqa: BLE001 — dumps must never raise
            lines.append(f"(event journal unavailable: {e})")
            lines.append("")

        # monitoring snapshot: what was the process DOING at OOM time?
        # (counters tell the story so far, the open span stack tells the
        # phase that died). Only when monitoring is on — the dump must
        # not wake the subsystem up.
        try:
            from deeplearning4j_tpu_torch import monitoring as _mon
            if _mon.enabled():
                lines.append("Monitoring at crash time:")
                stack = _mon.get_tracer().current_stack()
                lines.append("  open spans: "
                             + (" > ".join(stack) if stack else "(none)"))
                snap = _mon.get_registry().snapshot()
                for name in sorted(snap):
                    for rec in snap[name]:
                        lbl = "".join(f"[{k}={v}]"
                                      for k, v in rec["labels"].items())
                        if rec["kind"] == "histogram":
                            lines.append(
                                f"  {name}{lbl}: count={rec['count']} "
                                f"sum={rec['sum']:.6g} p99={rec['p99']}")
                        else:
                            lines.append(f"  {name}{lbl}: {rec['value']}")
                lines.append("")
        except Exception as e:  # noqa: BLE001 — dumps must never raise
            lines.append(f"(monitoring snapshot failed: {e})")
            lines.append("")
        lines.append("Mitigations (CUDA):")
        lines.append("  - reduce the batch size (device memory high-water "
                     "scales ~linearly with batch)")
        lines.append("  - recompute each encoder layer in the backward: "
                     "BertConfig(remat=True)")
        lines.append("  - train in bfloat16 (dtype='bfloat16')")
        lines.append("  - serve with fewer slots, smaller cache rungs or a "
                     "paged / int8 KV cache")
        lines.append("  - PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True "
                     "when reserved memory far exceeds allocated")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        return path


def with_crash_dump(fn):
    """Decorator for fit()/output(): on an escaping device-OOM, write the
    crash dump (when enabled), note its path on stderr, re-raise."""
    import functools
    import sys

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        try:
            return fn(self, *args, **kwargs)
        except Exception as e:
            path = CrashReportingUtil.maybe_dump(self, e)
            if path:
                print(f"[deeplearning4j_tpu_torch] device OOM — memory "
                      f"crash dump written to {path}", file=sys.stderr)
            raise
    return wrapper
