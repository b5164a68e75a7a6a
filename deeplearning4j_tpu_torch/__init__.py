"""deeplearning4j_tpu_torch — the PyTorch/CUDA port of deeplearning4j_tpu
for an NVIDIA H100.

Module paths mirror the JAX package, so each part of the port sits where
its counterpart does. The port imports torch and never jax, nor any module
of `deeplearning4j_tpu`. Every kernel that the JAX package wrote in
Pallas is a kernel written by hand for Hopper (`kernels/csrc/`), built at
first use.

Slices ported so far: BERT inference and fine-tuning (`models/bert.py`)
with the flash attention kernels (`kernels/`), KV-cache serving through
`generation.GenerationServer` over `generation.BertDecoder`, and
ResNet-50 inference through the `nn/` builder DSL, `ComputationGraph`
and `parallel.inference.ParallelInference`, with the conv1x1+BN epilogue
GEMM and the fused bottleneck block; ResNet-50 training through
`ComputationGraph.fit`; the executable store (`runtime/`), which
replays the decode block, the training step and the inference buckets as
CUDA graphs on the card; paged and int8 KV serving with drafting;
serving survivability (`resilience/`, `monitoring/`); the
`generation.FleetRouter` over server replicas, with the `ui.UIServer`
operations endpoints; the port's lints (`lint/`); and `MultiLayerNetwork`
with the rest of the nn core's training surface (every updater, schedule,
loss, dropout object, constraint and gradient accumulation, shared with
`ComputationGraph`), the `eval/` evaluators, the DataSetIterators and the
zoo's `.list()` CNNs (LeNet, SimpleCNN, AlexNet, VGG16, VGG19, Darknet19);
the recurrent and attention networks; the zoo's graph models; every layer
family of the JAX package's `nn/conf/`, the frozen wrappers among them;
the configuration JSON and model archives of `util/serde.py`,
`util/model_serializer.py` and `util/model_guesser.py`, which the JAX
package reads and writes too; training that survives faults
(`resilience/`); and the fine-tune-then-serve-int8 front end: QAT and the
int8 rewrite of `quantize/` (`quantize_network`, served through
`int8_matmul_epilogue` on the card), transfer learning (`transfer/`),
early stopping and the training listeners (`optimize/`) and
`ui.StatsListener` with its storages.
"""
from deeplearning4j_tpu_torch.device import resolve
from deeplearning4j_tpu_torch.ops import nd

__all__ = ["nd", "resolve"]
