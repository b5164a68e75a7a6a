"""Activation-traffic estimator: how many bytes does a model's forward
(and backward) actually move, under which precision/remat policy? The port
of `deeplearning4j_tpu/quantize/traffic.py`: host arithmetic over a built
configuration, with the dtype widths read from torch.

The BENCH roofline work (BENCH_r04_local: 93.7% of the HBM bound) made
bytes the currency of this repo's perf axis — so the diet needs a
ledger. This module walks a built configuration and prices every
activation tensor at its policy-resolved width:

- ``activation_report``: per-layer/per-node activation sizes for one
  batch, split into forward traffic (every activation written once) and
  **backward saved bytes** (what autodiff keeps for the backward pass) —
  under the model's remat policy, "blocks" keeps only segment
  boundaries, "layers"/flagged layers keep only layer inputs.
- ``publish``: pushes the estimate onto the
  ``dl4j.quant.activation_traffic_bytes`` gauge (labels: model, policy)
  so `GET /metrics` shows the diet per served model.

Estimates price TENSOR TRAFFIC, not compute: elementwise passes XLA
fuses away are not modeled, so treat the numbers as a policy-relative
comparison (fp32 vs int8 vs remat), which is exactly how bench_quant.py
uses them (the remat acceptance bar is the RATIO of saved-for-backward
bytes, not an absolute).
"""
from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch import monitoring as _mon

__all__ = ["activation_report", "publish"]


def _dtype_bytes(conf, layer=None):
    from deeplearning4j_tpu_torch.nn._network import compute_dtype
    return torch.empty((), dtype=compute_dtype(conf)).element_size()


def _quantized_width(layer):
    """Bytes/element of the layer's OUTPUT under its precision state:
    rewritten int8 layers store int8 activations at memory boundaries."""
    return 1 if type(layer).__name__ in ("QuantizedConv1x1",
                                         "QuantizedDense") else None


def _type_elems(t):
    if t is None:
        return 0
    shape = t.shape() if callable(getattr(t, "shape", None)) else None
    if not shape:
        return 0
    return int(np.prod([d for d in shape if d]))


def activation_report(net, batch=1):
    """{'per_layer': [...], 'forward_bytes': n, 'saved_bytes': n,
    'saved_bytes_plain': n, 'remat_policy': p, 'policy': str} for one
    forward/backward at `batch` rows.

    saved_bytes: LAYER-OUTPUT activations kept for backward under the
    active remat policy; saved_bytes_plain: the same without remat —
    the reduction ratio is the remat diet. For "blocks" the kept set
    is `conf.remat_plan()`'s saved outputs — the SAME rule the graph
    executor saves by, so the ledger cannot drift from reality on
    interleaved/branching graphs. Per-layer remat ("layers" / .remat
    flags) is NOT a diet at this granularity: jax.checkpoint on a
    single layer still saves that layer's INPUT (= the previous
    layer's output), so every boundary tensor stays live — its wins
    are the intra-layer intermediates this output-level ledger does
    not price, and it is reported as saving nothing here rather than
    as a fictitious ~100% cut."""
    conf = net.conf
    base = _dtype_bytes(conf)
    per = []
    is_graph = hasattr(conf, "topo_order")
    policy = getattr(conf, "remat_policy", "none")
    if is_graph:
        names = [n for n in conf.topo_order
                 if conf.nodes[n].kind != "input"]
        kept = set(names)
        if policy == "blocks":
            kept = {n for _seg, outs in conf.remat_plan()
                    for n in outs}
        for name in names:
            node = conf.nodes[name]
            t = conf.node_output_types.get(name)
            elems = _type_elems(t) * int(batch)
            width = (_quantized_width(node.ref)
                     if node.kind == "layer" else None) or base
            per.append({"name": name, "elements": elems,
                        "bytes": elems * width,
                        "saved": name in kept})
    else:
        # sequential nets only carry per-layer remat flags — every
        # layer output stays saved at this granularity (see docstring)
        for i, layer in enumerate(conf.layers):
            t = conf.input_types[i] if conf.input_types else None
            t_out = layer.output_type(t) if t is not None else None
            elems = _type_elems(t_out) * int(batch)
            width = _quantized_width(layer) or base
            per.append({"name": getattr(layer, "name", str(i)),
                        "elements": elems, "bytes": elems * width,
                        "saved": True})
    fwd = sum(p["bytes"] for p in per)
    saved = sum(p["bytes"] for p in per if p["saved"])
    plain = fwd
    qp = (getattr(conf, "defaults", {}) or {}).get("precisionPolicy")
    return {"per_layer": per, "forward_bytes": int(fwd),
            "saved_bytes": int(saved), "saved_bytes_plain": int(plain),
            "remat_policy": policy,
            "policy": repr(qp) if qp is not None else "fp"}


def publish(net, batch=1, model_name=None):
    """Estimate + publish the per-model activation-traffic gauge
    (no-op when monitoring is disabled). Returns the report."""
    rep = activation_report(net, batch)
    if _mon.enabled():
        name = model_name or type(net).__name__
        _mon.get_registry().gauge(
            _mon.QUANT_ACTIVATION_BYTES,
            labels={"model": name, "policy": rep["policy"]},
            help="estimated forward activation traffic per batch, "
                 "priced at each tensor's precision-policy width"
        ).set(rep["forward_bytes"])
    return rep
