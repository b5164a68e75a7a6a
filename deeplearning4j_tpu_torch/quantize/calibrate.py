"""Activation-scale calibration for the real int8 inference path: the
port of `deeplearning4j_tpu/quantize/calibrate.py`, which reads its
statistics as numpy and host floats, so only the absmax read changes.

A quantized layer needs ONE static number the trace can bake in: the
symmetric scale of its input activations. Two sources, in preference
order (both land on `dl4j.quant.calibrations`):

- **BN/moving statistics** (free — no data pass): a layer fed by a
  BatchNormalization's output has a known post-affine distribution —
  per channel mean≈beta, std≈gamma — so absmax ≈ max_c(|beta_c| +
  k·|gamma_c|) with k standard deviations of headroom (k=4 covers
  99.99% of a gaussian; clipping the tail is what symmetric int8 does
  anyway). This is how the ResNet-style hot path calibrates without
  ever seeing data: every 1×1 conv sits behind a BN.
- **observed absmax** (one fp forward over calibration batches):
  `observe()` runs the fp net over sample data and records each
  layer input's absmax; the classic max-calibration pass.

`resolve_scales` merges both: observed wins where present, BN-derived
fills the gaps, and anything still unknown falls back to scale-from-
weight-headroom (conservative; flagged in the result so callers can tell
a guessed scale from a calibrated one).
"""
from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch import monitoring as _mon
from deeplearning4j_tpu_torch.quantize.core import INT8_MAX

__all__ = ["bn_param_scale", "observe", "resolve_scales"]

#: standard deviations of post-BN headroom baked into the derived scale
BN_SIGMA_K = 4.0

#: scale assumed when neither statistics nor data are available —
#: generous for relu-family activations; flagged as "default" so the
#: caller can surface it
DEFAULT_ABSMAX = 8.0


def _host(v):
    """A parameter (tensor or array) as a float32 numpy array."""
    if torch.is_tensor(v):
        v = v.detach().float().cpu().numpy()
    return np.asarray(v, np.float32)


def bn_param_scale(p_bn, k=BN_SIGMA_K):
    """Input scale for a layer fed by a BatchNormalization, from the
    BN's LIVE gamma/beta (no data needed): the normalized-then-affine
    activation is per-channel ≈ N(beta_c, gamma_c²), so
    absmax ≈ max_c(|beta_c| + k·|gamma_c|). A relu after the BN only
    clips negatives — the positive absmax bound is unchanged."""
    gamma = _host(p_bn.get("gamma", np.ones(1)))
    beta = _host(p_bn.get("beta", np.zeros(1)))
    absmax = float(np.max(np.abs(beta) + k * np.abs(gamma)))
    return max(absmax, 1e-6) / INT8_MAX


def observe(forward_collect, batches):
    """Max-calibration pass: `forward_collect(x) -> {key: activation}`
    runs the fp net and returns each quantizable layer's INPUT tensor
    keyed by layer; `batches` is an iterable of feature arrays. Returns
    {key: absmax float} over all batches. One `.item()` per layer per
    batch: this runs when a network is rewritten, never while it serves."""
    absmax = {}
    for x in batches:
        with torch.no_grad():
            acts = forward_collect(x)
        for key, act in acts.items():
            m = act.detach().float().abs().amax().item()
            prev = absmax.get(key)
            absmax[key] = m if prev is None else max(prev, m)
    return absmax


def resolve_scales(keys, observed=None, bn_scales=None):
    """Merge calibration sources into {key: (scale, source)} for every
    key in `keys`. observed: {key: absmax}; bn_scales: {key: scale}.
    Priority: observed > bn-derived > DEFAULT_ABSMAX fallback."""
    observed = observed or {}
    bn_scales = bn_scales or {}
    out = {}
    calibrated = 0
    for key in keys:
        if key in observed:
            out[key] = (max(observed[key], 1e-6) / INT8_MAX, "observed")
            calibrated += 1
        elif key in bn_scales:
            out[key] = (bn_scales[key], "bn-stats")
            calibrated += 1
        else:
            out[key] = (DEFAULT_ABSMAX / INT8_MAX, "default")
    if _mon.enabled() and calibrated:
        _mon.get_registry().counter(
            _mon.QUANT_CALIBRATIONS,
            help="activation scales calibrated (observed or BN-derived)"
        ).inc(calibrated)
    return out
