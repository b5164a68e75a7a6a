"""Device memory telemetry: device-memory gauges, live-tree footprint
estimates, and the OOM forensics snapshot. The port of
`deeplearning4j_tpu/monitoring/memory.py` with its probes redone on
`torch.cuda`.

Three consumers:
- **periodic gauges** — `sample()` refreshes the per-device
  `dl4j.device.memory_bytes` gauges (bytes-in-use / peak / limit) plus
  `dl4j.model.*_bytes` footprint estimates from a live model's
  param/optimizer/state trees. `MemoryMonitor` runs it on a background
  thread for serving processes.
- **OOM forensics** — every `sample()` keeps its reading in
  `last_sample()`; `util/crash_reporting.py` embeds that last-known-good
  reading in a memory crash dump.
- **the memory-pressure ladder** — `GenerationServer._check_growth`
  refuses cache growth while `bytes_in_use / bytes_limit` of its own
  device is past its `memory_high_water`.

On a CUDA device `bytes_limit` and `bytes_in_use` come from
`torch.cuda.mem_get_info()` (total, and total − free): the ladder guards
the device, and memory that PyTorch's caching allocator or a CUDA
graph's private pool holds in reserve is as unavailable to the next
allocation as memory in use. The caching allocator's own figures
(`torch.cuda.memory_stats()`) stand beside them as `allocated_bytes`,
`reserved_bytes`, `peak_bytes_in_use` (the allocator's peak allocated)
and `num_alloc_retries`/`num_ooms`. Without a CUDA device there is
nothing to report: `device_memory_stats()` returns {}.
"""
from __future__ import annotations

import threading
import time

import torch

from deeplearning4j_tpu_torch.monitoring import registry as _registry
from deeplearning4j_tpu_torch.monitoring.state import STATE

__all__ = ["MemoryMonitor", "device_memory_stats", "footprint",
           "last_sample", "sample"]

_lock = threading.Lock()
_last_sample = None


def _cuda_stats(index, alloc):
    free, total = torch.cuda.mem_get_info(index)
    stats = {"bytes_in_use": int(total - free), "bytes_limit": int(total),
             "bytes_free": int(free)}
    for key, name in (("allocated_bytes.all.current", "allocated_bytes"),
                      ("reserved_bytes.all.current", "reserved_bytes"),
                      ("allocated_bytes.all.peak", "peak_bytes_in_use"),
                      ("num_alloc_retries", "num_alloc_retries"),
                      ("num_ooms", "num_ooms")):
        if key in alloc:
            stats[name] = int(alloc[key])
    return stats


def device_memory_stats(device=None):
    """{device_str: stats_dict_or_None}: of `device` alone when one is
    given ({} for a CPU device), else of every CUDA device on which this
    process's caching allocator holds memory ("cuda:0", ...). A device the
    process never used is not read: `mem_get_info` would open a CUDA
    context on it. {} without a card. Never raises — a device whose query
    fails reports None."""
    out = {}
    try:
        if not torch.cuda.is_available():
            return out
        if device is None:
            indices = range(torch.cuda.device_count())
        else:
            device = torch.device(device)
            if device.type != "cuda":
                return out
            indices = [torch.cuda.current_device() if device.index is None
                       else device.index]
    except Exception:  # noqa: BLE001 — no driver / init failure
        return out
    for i in indices:
        try:
            alloc = torch.cuda.memory_stats(i)
            if device is None and not alloc.get(
                    "reserved_bytes.all.current"):
                continue
            out[f"cuda:{i}"] = _cuda_stats(i, alloc)
        except Exception:  # noqa: BLE001 — telemetry must never raise
            out[f"cuda:{i}"] = None
    return out


def _leaves(tree):
    """The tensors and arrays of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    if hasattr(tree, "shape") and hasattr(tree, "dtype"):
        return [tree]
    return []


def _nbytes(leaf):
    if torch.is_tensor(leaf):
        return leaf.numel() * leaf.element_size()
    return int(getattr(leaf, "nbytes", 0))


def _tree_bytes(tree):
    return sum(_nbytes(leaf) for leaf in _leaves(tree))


def footprint(model):
    """Byte estimates from the LIVE trees of a network / trainer-shaped
    object: {"params_bytes", "opt_state_bytes", "layer_state_bytes"}.
    Missing trees report 0 (e.g. an un-init()ed net)."""
    return {
        "params_bytes": _tree_bytes(getattr(model, "_params", None)),
        "opt_state_bytes": _tree_bytes(getattr(model, "_opt_state", None)),
        "layer_state_bytes": _tree_bytes(getattr(model, "_state", None)),
    }


def sample(registry=None, model=None):
    """One telemetry reading: refresh the device-memory + host-RSS gauges
    (via `registry.collect_device_memory`), add model footprint gauges
    when a model is given, and retain the reading for OOM forensics.
    Returns the snapshot dict."""
    reg = registry if registry is not None else _registry.get_registry()
    snap = {"ts": time.time(), "devices": device_memory_stats()}
    _registry.collect_device_memory(reg, device_stats=snap["devices"])
    if model is not None:
        fp = footprint(model)
        snap["model"] = fp
        reg.gauge(_registry.MODEL_PARAMS_BYTES,
                  help="bytes pinned by the live parameter tree") \
           .set(fp["params_bytes"])
        reg.gauge(_registry.MODEL_OPT_STATE_BYTES,
                  help="bytes pinned by the live optimizer state") \
           .set(fp["opt_state_bytes"])
        reg.gauge(_registry.MODEL_LAYER_STATE_BYTES,
                  help="bytes pinned by layer state (BN stats, ...)") \
           .set(fp["layer_state_bytes"])
    global _last_sample
    with _lock:
        _last_sample = snap
    return snap


def last_sample():
    """The most recent `sample()` reading (None before the first) — the
    OOM forensics hook crash_reporting embeds in memory crash dumps."""
    with _lock:
        return _last_sample


class MemoryMonitor:
    """Background periodic `sample()` for processes without a training
    loop (serving, notebooks): `MemoryMonitor(interval_s=10).start()`.
    Samples only while monitoring is enabled — a running monitor on a
    disabled registry costs one flag check per interval."""

    def __init__(self, interval_s=10.0, registry=None, model=None):
        self.interval_s = float(interval_s)
        self.registry = registry
        self.model = model
        self._stop = threading.Event()
        self._thread = None

    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="dl4j-memory-monitor")
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.interval_s):
            if not STATE.enabled:
                continue
            try:
                sample(self.registry, self.model)
            except Exception:  # noqa: BLE001 — telemetry must never die
                pass

    def stop(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)
        return self
