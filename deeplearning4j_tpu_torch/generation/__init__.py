"""Autoregressive generation of the port: KV-cache decode with
continuous-batching admission.

- `decode`   — `BertDecoder`: per-layer K/V caches, prefill through the
  flash forward kernel and single-token steps through the flash decode
  kernel.
- `sampling` — batched greedy / temperature / top-k sampling over
  explicit per-slot threefry keys, bit-compatible with the JAX package.
- `server`   — `GenerationServer`: fixed-size decode batches, cache rungs,
  decode supersteps, per-slot admission/retirement, streaming callbacks.

Quick start:

    from deeplearning4j_tpu_torch.generation import (BertDecoder,
                                                     GenerationServer)
    from deeplearning4j_tpu_torch.models import bert_base, init_bert_params
    cfg = bert_base()
    srv = GenerationServer(BertDecoder(cfg, init_bert_params(cfg)),
                           slots=8, cache_lengths=[128, 512])
    tokens = srv.generate(prompt_ids, max_new_tokens=32)
"""
from deeplearning4j_tpu_torch.generation.decode import BertDecoder
from deeplearning4j_tpu_torch.generation.sampling import (GREEDY, SAMPLE,
                                                          method_id,
                                                          sample_step,
                                                          split_keys)
from deeplearning4j_tpu_torch.generation.server import (GenerationRequest,
                                                        GenerationServer,
                                                        status)

__all__ = ["BertDecoder", "GREEDY", "SAMPLE", "method_id", "sample_step",
           "split_keys", "GenerationRequest", "GenerationServer", "status"]
