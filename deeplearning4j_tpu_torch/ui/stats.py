"""Training stats collection: the port of `deeplearning4j_tpu/ui/stats.py`
(≡ deeplearning4j-ui :: org.deeplearning4j.ui.model.stats.StatsListener +
the StatsStorage hierarchy: InMemoryStatsStorage / FileStatsStorage).

Each iteration records score, timing, and per-layer parameter/update
summaries (the mean-magnitude ratios the reference's dashboard charts for
learning-rate tuning). Storage is JSON-native; FileStatsStorage appends
JSONL so a dashboard — live server or static HTML — can tail it.

Observability cross-links: StatsListener covers LEARNING diagnostics.
For HOST-side operational metrics and span tracing (where did the step's
wall time go; Prometheus `/metrics`; Chrome-trace export), opt in with
`optimize.listeners.MetricsListener` / `deeplearning4j_tpu_torch.monitoring`;
the DEVICE-side per-op trace is `optimize.listeners.ProfilerListener` and
`monitoring.profile_next_steps`.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener


class InMemoryStatsStorage:
    """≡ InMemoryStatsStorage."""

    def __init__(self):
        self.records = []

    def put(self, record):
        self.records.append(record)

    def all(self):
        return list(self.records)

    def latest(self):
        return self.records[-1] if self.records else None


class FileStatsStorage(InMemoryStatsStorage):
    """≡ FileStatsStorage — JSONL append."""

    def __init__(self, path):
        super().__init__()
        self.path = str(path)
        if os.path.exists(self.path):
            with open(self.path) as f:
                self.records = [json.loads(ln) for ln in f if ln.strip()]

    def put(self, record):
        super().put(record)
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")


class StatsListener(TrainingListener):
    """≡ StatsListener(statsStorage, frequency).

    Round-5 depth (≡ the reference dashboard's TrainModule data): each
    record also carries per-layer-param update:parameter mean-magnitude
    RATIOS (the learning-rate-tuning chart; computed from the param delta
    since the previous record) and per-layer ACTIVATION histograms
    (forward pass over the most recent training batch, inference mode).
    Both can be disabled for minimal overhead."""

    def __init__(self, storage=None, frequency=1, collectRatios=True,
                 collectActivations=True, activationFrequency=10,
                 histogramBins=20):
        self.storage = storage if storage is not None \
            else InMemoryStatsStorage()
        self.frequency = max(1, int(frequency))
        self.collectRatios = bool(collectRatios)
        self.collectActivations = bool(collectActivations)
        # histograms cost an extra forward + host transfer: collect every
        # activationFrequency-th RECORD (first record included) so the
        # default overhead is ~1/10 of a forward pass, not 1x
        self.activationFrequency = max(1, int(activationFrequency))
        self.histogramBins = int(histogramBins)
        self._last_time = None
        self._prev_params = None
        self._record_idx = 0
        self._params_version_seen = None

    def _flat_params(self, model):
        """ONE copy of the parameter set to the host; summaries and ratios
        both derive from it.

        A copy, never a view: on the CPU `tensor.numpy()` shares the
        tensor's memory, and the training step rewrites its parameters in
        place at the next update (the graphed step on the card too) — a
        "previous" snapshot sharing them would silently change to equal
        the current parameters and every update ratio would read exactly
        0. One `torch.cat` of the flattened tensors, one transfer."""
        params = getattr(model, "_params", None) or {}
        keys = [(f"{ln}_{pn}", v) for ln, p in params.items()
                for pn, v in p.items()]
        if not keys:
            return {}
        with torch.no_grad():
            flat = torch.cat([v.detach().reshape(-1).float()
                              for _, v in keys]).cpu().numpy().copy()
        out, off = {}, 0
        for k, v in keys:
            out[k] = flat[off:off + v.numel()].reshape(tuple(v.shape))
            off += v.numel()
        return out

    @staticmethod
    def _param_summaries(flat):
        return {k: {"meanMagnitude": float(np.abs(arr).mean()),
                    "stdev": float(arr.std())}
                for k, arr in flat.items()}

    def _update_ratios(self, flat):
        """mean|Δparam| / mean|param| per layer param — the reference
        dashboard's update:parameter ratio chart (healthy ≈ 1e-3)."""
        prev, self._prev_params = self._prev_params, flat
        if prev is None:
            return {}
        out = {}
        for k, arr in flat.items():
            p0 = prev.get(k)
            if p0 is None or p0.shape != arr.shape:
                continue
            pm = float(np.abs(arr).mean())
            out[k] = float(np.abs(arr - p0).mean() / (pm + 1e-12))
        return out

    def _activation_histograms(self, model):
        x = getattr(model, "_last_features", None)
        ff = getattr(model, "feedForward", None)
        if x is None or ff is None:
            return {}
        out = {}
        try:
            acts = ff(x)
            if isinstance(acts, dict):   # ComputationGraph: node -> act
                items = list(acts.items())
            else:                        # MultiLayerNetwork: per-layer list
                items = [(f"layer{i}", a) for i, a in enumerate(acts)]
            for key, a in items:
                t = a.tensor if hasattr(a, "tensor") else a
                arr = (t.detach().float().cpu().numpy()
                       if torch.is_tensor(t)
                       else np.asarray(t, np.float32)).ravel()
                finite = arr[np.isfinite(arr)]
                if finite.size == 0:   # diverged layer: record, don't die
                    out[key] = {"min": 0.0, "max": 0.0,
                                "counts": [0] * self.histogramBins,
                                "nonFinite": int(arr.size)}
                    continue
                lo, hi = float(finite.min()), float(finite.max())
                counts, _ = np.histogram(
                    finite, bins=self.histogramBins,
                    range=(lo, hi if hi > lo else lo + 1))
                h = {"min": lo, "max": hi, "counts": counts.tolist()}
                if finite.size != arr.size:
                    h["nonFinite"] = int(arr.size - finite.size)
                out[key] = h
        except Exception:   # noqa: BLE001 — stats must never kill training
            return out
        return out

    def iterationDone(self, model, iteration, epoch):
        if iteration % self.frequency:
            return
        now = time.perf_counter()
        dt_ms = None if self._last_time is None else (
            (now - self._last_time) * 1000.0 / self.frequency)
        self._last_time = now
        flat = self._flat_params(model)
        record = {
            "iteration": int(iteration),
            "epoch": int(epoch),
            "timestamp": time.time(),
            "score": float(model.score()),
            "iterationTimeMs": dt_ms,
            "params": self._param_summaries(flat),
        }
        # scanned fit() (stepsPerDispatch=k) fires k iterationDone calls
        # after ONE real param update; _params_version marks actual
        # updates so the k-1 inner records don't log zero ratios and
        # duplicate histograms
        version = getattr(model, "_params_version", None)
        params_fresh = version is None or \
            version != self._params_version_seen
        self._params_version_seen = version
        if self.collectRatios and params_fresh:
            record["updateRatios"] = self._update_ratios(flat)
        if self.collectActivations and params_fresh:
            # count FRESH records only, so the rate stays one histogram
            # per activationFrequency real updates under scanned fit too
            if self._record_idx % self.activationFrequency == 0:
                record["activationHistograms"] = \
                    self._activation_histograms(model)
            self._record_idx += 1
        self.storage.put(record)

    # -- convenience ------------------------------------------------------
    def scores(self):
        return [r["score"] for r in self.storage.all()]
