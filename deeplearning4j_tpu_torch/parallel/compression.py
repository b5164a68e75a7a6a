"""Threshold-encoded gradient sharing (≡ nd4j-parameter-server's
EncodedGradientsAccumulator and the threshold encoding of
SharedTrainingMaster): the port of
`deeplearning4j_tpu/parallel/compression.py`.

Each worker quantizes its gradient to {−t, 0, +t} (the elements with
|g| ≥ t), ships only those, and keeps the unsent remainder in a residual
that is added back next step; the threshold adapts to keep the shipped
fraction in a target band. `threshold_encoding` is that rule as one of
the port's optimizer transforms (`nn/updaters.py`'s `_Transform`, over a
list of tensors), and `encoded_updater` chains it in front of an updater.

The sparse wire format is plain tensor math here: per worker per bucket
one int32 vector of `capacity + 2` slots,

    [ count | threshold_bits | tok_0 ... tok_{K-1} ]

with tok = (index + 1)·sign of each shipped element and 0 for an empty
slot. Decoding drops out-of-range tokens, and a structurally corrupt
message (bad count, nonsense threshold, index out of range) poisons the
delivered gradient to NaN so the guardian refuses the step. Its use on
the wire, between hosts, comes with the multi-host trainer.
"""
from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.updaters import Updater, _Chain, _Transform

__all__ = ["DEFAULT_INITIAL_THRESHOLD", "threshold_encoding",
           "encoded_updater", "WIRE_HEADER", "wire_capacity",
           "wire_payload_bytes", "sparse_encode", "sparse_decode",
           "check_payload", "encoder_stats"]

#: the encoder's starting threshold
DEFAULT_INITIAL_THRESHOLD = 1e-3


def _adapt(thr, frac, min_threshold, decay, boost, target_sparsity):
    """The adaptive rule: decay when fewer than `target_sparsity` of the
    elements cleared the threshold, boost when more than 50× did."""
    new = torch.where(frac < target_sparsity, thr * decay,
                      torch.where(frac > 50 * target_sparsity, thr * boost,
                                  thr))
    return torch.clamp_min(new, min_threshold)


class _ThresholdEncoding(_Transform):
    """g -> {−t, 0, +t} with residual feedback (see the module)."""

    def __init__(self, initial_threshold, min_threshold, decay, boost,
                 target_sparsity):
        self.initial_threshold = initial_threshold
        self.min_threshold = min_threshold
        self.decay, self.boost = decay, boost
        self.target_sparsity = target_sparsity

    def init(self, params):
        dev = params[0].device if params else None
        return {"residual": [torch.zeros_like(p) for p in params],
                "threshold": torch.tensor(self.initial_threshold,
                                          dtype=torch.float32, device=dev),
                # elements shipped last step (wire-cost telemetry)
                "nnz": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(self, grads, state, params):
        thr = state["threshold"]
        sent, residual = [], []
        nonzero = torch.zeros((), dtype=torch.int64, device=thr.device)
        total = 0
        for g, r in zip(grads, state["residual"]):
            acc = g + r
            mask = acc.abs() >= thr
            s = torch.where(mask, torch.sign(acc) * thr, 0.0).to(g.dtype)
            sent.append(s)
            residual.append(acc - s)
            nonzero = nonzero + (s.abs() > 0).sum()
            total += g.numel()
        frac = nonzero / total
        new_thr = _adapt(thr, frac, self.min_threshold, self.decay,
                         self.boost, self.target_sparsity)
        return sent, {"residual": residual, "threshold": new_thr,
                      "nnz": nonzero.to(torch.int32)}


def threshold_encoding(initial_threshold=DEFAULT_INITIAL_THRESHOLD,
                       min_threshold=1e-5, decay=0.95, boost=1.2,
                       target_sparsity=1e-3):
    """The threshold encoder as an optimizer transform over a list of
    gradients: init(params) -> state, update(grads, state, params) ->
    (shipped {−t, 0, +t} values, state)."""
    return _ThresholdEncoding(initial_threshold, min_threshold, decay,
                              boost, target_sparsity)


def encoded_updater(updater, **kw):
    """Threshold encoding chained in front of an updater (a config of
    `nn/updaters.py` or a transform): the EncodedGradientsAccumulator
    worker's update."""
    tx = updater.to_transform() if isinstance(updater, Updater) else updater
    return _Chain([threshold_encoding(**kw), tx])


# -- sparse ragged wire format ------------------------------------------------
#: header slots in front of the token array: [count, threshold_bits]
WIRE_HEADER = 2


def wire_capacity(elems, frac):
    """Per-bucket token capacity: `frac` of the bucket's elements, at least
    1, never more than the bucket itself."""
    return max(1, min(int(elems), int(-(-elems * frac // 1))))


def wire_payload_bytes(capacity):
    """Per-worker wire bytes for one bucket at the given capacity."""
    return (int(capacity) + WIRE_HEADER) * 4


def _bits(thr):
    return thr.to(torch.float32).reshape(1).view(torch.int32)


def sparse_encode(flat, state, capacity, min_threshold=1e-5, decay=0.95,
                  boost=1.2, target_sparsity=1e-3):
    """One worker's bucket gradient (1-D) to (payload, new state). The
    residual and threshold math is `threshold_encoding`'s, so while nnz ≤
    capacity the shipped set equals the dense one; on overflow the first
    `capacity` elements above the threshold ship and the rest stay in
    the residual."""
    elems = flat.numel()
    thr = state["threshold"]
    acc = flat + state["residual"]
    mask = acc.abs() >= thr
    dense_sent = torch.where(mask, torch.sign(acc) * thr, 0.0).to(flat.dtype)
    nnz = (dense_sent.abs() > 0).sum()
    idx = mask.nonzero().reshape(-1)[:capacity]
    idx = torch.cat([idx, torch.full((capacity - idx.numel(),), elems,
                                     dtype=idx.dtype, device=flat.device)])
    idx = idx.to(torch.int32)
    inside = idx < elems
    vals = torch.where(inside, dense_sent[idx.long().clamp_max(elems - 1)],
                       torch.zeros((), dtype=flat.dtype, device=flat.device))
    sent = torch.zeros_like(flat)
    sent.index_add_(0, idx[inside].long(), vals[inside])
    new_r = acc - sent
    frac = nnz / elems
    new_thr = _adapt(thr, frac, min_threshold, decay, boost,
                     target_sparsity)
    sgn = torch.where(vals > 0, 1, torch.where(vals < 0, -1, 0)).to(
        torch.int32)
    tok = (idx + 1) * sgn
    count = (sgn != 0).sum().to(torch.int32).reshape(1)
    payload = torch.cat([count, _bits(thr), tok])
    return payload, {"residual": new_r, "threshold": new_thr,
                     "nnz": nnz.to(torch.int32)}


def _decode_row(row, elems, dtype):
    """One worker's payload -> its dense {−t, 0, +t} contribution,
    NaN-poisoned if the message is structurally corrupt."""
    count, tok = row[0], row[WIRE_HEADER:]
    thr = row[1:2].view(torch.float32)[0]
    valid = tok != 0
    idx = torch.where(valid, tok.abs() - 1, elems).long()
    sgn = torch.sign(tok).to(torch.float32)
    vals = torch.where(valid, sgn * thr, 0.0).to(dtype)
    out = torch.zeros((elems,), dtype=dtype, device=row.device)
    keep = (idx >= 0) & (idx < elems)
    out.index_add_(0, idx[keep], vals[keep])
    ok = ((count == valid.sum()) & (count <= tok.numel())
          & torch.isfinite(thr) & (thr > 0)
          & torch.all(torch.where(valid, idx < elems, True)))
    return torch.where(ok, out, torch.full((), float("nan"), dtype=dtype,
                                           device=row.device))


def sparse_decode(gathered, elems, dtype):
    """The gathered payloads (num_workers, capacity + 2) to the mean
    delivered gradient, accumulated in worker order."""
    n = gathered.shape[0]
    acc = _decode_row(gathered[0], elems, dtype)
    for w in range(1, n):
        acc = acc + _decode_row(gathered[w], elems, dtype)
    return acc / n


def check_payload(payload, elems, capacity=None):
    """Host-side structural validation of one wire message; raises
    `WireFormatError` naming the violation. Returns (count, threshold)."""
    from deeplearning4j_tpu_torch.resilience.errors import WireFormatError

    p = np.asarray(payload.cpu() if torch.is_tensor(payload) else payload)
    if p.ndim != 1 or p.size < WIRE_HEADER:
        raise WireFormatError(
            f"truncated wire message: {p.size} slots < header {WIRE_HEADER}")
    if capacity is not None and p.size != capacity + WIRE_HEADER:
        raise WireFormatError(
            f"wire message size {p.size} != capacity {capacity} + header")
    count = int(p[0])
    thr = float(np.frombuffer(
        np.asarray(p[1], np.int32).tobytes(), np.float32)[0])
    tok = p[WIRE_HEADER:]
    nz = int(np.count_nonzero(tok))
    if count != nz:
        raise WireFormatError(
            f"wire count field {count} != {nz} non-empty tokens")
    if not np.isfinite(thr) or thr <= 0:
        raise WireFormatError(f"wire threshold {thr!r} not a positive float")
    idx = np.abs(tok[tok != 0]) - 1
    if idx.size and int(idx.max()) >= elems:
        raise WireFormatError(
            f"wire token index {int(idx.max())} out of range for "
            f"{elems}-element bucket")
    return count, thr


def encoder_stats(enc_state):
    """Device-scalar wire telemetry of a threshold-encoding state: mean
    threshold, elements shipped last step, and the unsent residual's
    global L2 norm."""
    res = enc_state["residual"]
    norm = torch.sqrt(sum((r.float() ** 2).sum() for r in res)) if res \
        else torch.zeros(())
    return {"threshold": enc_state["threshold"].float().mean(),
            "nnz": enc_state["nnz"].sum(), "residual_norm": norm}
