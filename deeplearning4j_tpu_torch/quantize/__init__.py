"""Quantization of the port (the counterpart of
`deeplearning4j_tpu/quantize/`):

- `core`      — symmetric int8 primitives: per-channel scales, quantize /
  dequantize, the straight-through `fake_quant` of QAT, the exact int8
  contraction and its f32 twin, the dequant epilogue.
- `policy`    — `PrecisionPolicy`: the conf-DSL knob
  (`.precisionPolicy(PrecisionPolicy.int8())`) driving QAT fake-quant and
  the eligibility of the int8 rewrite.
- `calibrate` — activation scales: observed absmax over sample batches,
  or derived from BatchNorm statistics (no data).
- `infer`     — `quantize_network(net)`: the post-training rewrite to an
  inference-only int8 twin (BN folding, one `int8_matmul_epilogue` launch
  per quantized layer on the card, the chain executor on the CPU), served
  through ExecutableStore / ParallelInference unchanged.
- `kvcache`   — the int8 KV-cache codec of the decode path: one f32 scale
  per (head, row), `quantize_rows` / `dequantize_rows`, and
  `cache_page_bytes` for pool sizing.
- `traffic`   — the bytes ledger: activation traffic and saved-for-backward
  estimates by precision and remat policy, published to
  `dl4j.quant.activation_traffic_bytes`.
"""
from deeplearning4j_tpu_torch.quantize.core import (  # noqa: F401
    INT8_MAX, dequant_epilogue, dequantize, fake_quant, fake_quant_act,
    fake_quant_weight, int8_dot, per_channel_scales, per_tensor_scale,
    quantize, scaled_int8_dot)
from deeplearning4j_tpu_torch.quantize.kvcache import (  # noqa: F401
    cache_page_bytes, dequantize_rows, quantize_rows)
from deeplearning4j_tpu_torch.quantize.policy import (  # noqa: F401
    PrecisionPolicy)
from deeplearning4j_tpu_torch.quantize.infer import (  # noqa: F401
    QuantPassthrough, QuantizedConv1x1, QuantizedDense, quantize_network)
from deeplearning4j_tpu_torch.quantize.traffic import (  # noqa: F401
    activation_report, publish)

__all__ = [
    "INT8_MAX", "PrecisionPolicy", "QuantPassthrough",
    "QuantizedConv1x1", "QuantizedDense", "activation_report",
    "dequant_epilogue", "dequantize", "fake_quant", "fake_quant_act",
    "fake_quant_weight", "int8_dot", "per_channel_scales",
    "per_tensor_scale", "publish", "quantize", "quantize_network",
    "scaled_int8_dot",
]
