"""Autoregressive generation of the port: KV-cache decode with
continuous-batching admission.

- `decode`   — `BertDecoder`: per-layer K/V caches, prefill through the
  flash forward kernel and single-token steps through the flash decode
  kernel; `RecurrentDecoder`: the carries of a recurrent
  MultiLayerNetwork (TextGenerationLSTM) as the decode state.
- `sampling` — batched greedy / temperature / top-k sampling over
  explicit per-slot threefry keys, bit-compatible with the JAX package.
- `server`   — `GenerationServer`: fixed-size decode batches, cache rungs,
  decode supersteps, per-slot admission/retirement, streaming callbacks.
- `fleet`    — `FleetRouter`: health-driven routing across N server
  replicas, mid-stream failover through `adopt`, replica supervision.

Quick start:

    from deeplearning4j_tpu_torch.generation import (BertDecoder,
                                                     FleetRouter,
                                                     GenerationServer)
    from deeplearning4j_tpu_torch.models import bert_base, init_bert_params
    cfg = bert_base()
    params = init_bert_params(cfg)
    srv = GenerationServer(BertDecoder(cfg, params),
                           slots=8, cache_lengths=[128, 512])
    tokens = srv.generate(prompt_ids, max_new_tokens=32)

    # three replicas over one parameter set and one manifest directory;
    # the factory also builds the supervisor's replacements
    router = FleetRouter(
        factory=lambda i: GenerationServer(
            BertDecoder(cfg, params), slots=8, cache_lengths=[128, 512],
            exec_cache_dir="exec-cache"),
        num_replicas=3)
    router.warmup()
    tokens = router.generate(prompt_ids, max_new_tokens=32)

    # a char-RNN: the server wraps the network in a RecurrentDecoder
    from deeplearning4j_tpu_torch.models.zoo import TextGenerationLSTM
    srv = TextGenerationLSTM().generationServer(
        slots=8, cache_lengths=[512], method="top_k", top_k=5)
"""
from deeplearning4j_tpu_torch.generation.decode import (BertDecoder,
                                                        RecurrentDecoder)
from deeplearning4j_tpu_torch.generation.fleet import (FleetRequest,
                                                       FleetRouter)
from deeplearning4j_tpu_torch.generation.sampling import (GREEDY, SAMPLE,
                                                          method_id,
                                                          sample_step,
                                                          split_keys)
from deeplearning4j_tpu_torch.generation.server import (GenerationRequest,
                                                        GenerationServer,
                                                        status)

__all__ = ["BertDecoder", "RecurrentDecoder", "FleetRequest", "FleetRouter",
           "GREEDY", "SAMPLE",
           "method_id", "sample_step", "split_keys", "GenerationRequest",
           "GenerationServer", "status"]
