"""Quantization of the port: the symmetric int8 codec and the int8
KV-cache codec of the decode path.

- `core`    — `INT8_MAX` and the elementwise codec: per-channel and
  per-tensor scales, `quantize` / `dequantize`.
- `kvcache` — the int8 KV cache: one f32 scale per (head, row),
  `quantize_rows` / `dequantize_rows`, and `cache_page_bytes` for pool
  sizing.

The JAX package's fake-quant (QAT), int8 GEMM and fused dequant epilogue
belong to its int8 inference path, which the port has not taken yet.
"""
from deeplearning4j_tpu_torch.quantize.core import (INT8_MAX, dequantize,
                                                    per_channel_scales,
                                                    per_tensor_scale,
                                                    quantize)
from deeplearning4j_tpu_torch.quantize.kvcache import (cache_page_bytes,
                                                       dequantize_rows,
                                                       quantize_rows)

__all__ = ["INT8_MAX", "cache_page_bytes", "dequantize", "dequantize_rows",
           "per_channel_scales", "per_tensor_scale", "quantize",
           "quantize_rows"]
