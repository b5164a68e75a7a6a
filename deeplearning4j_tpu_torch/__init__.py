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
`ComputationGraph.fit`; and the executable store (`runtime/`), which
replays the decode block, the training step and the inference buckets as
CUDA graphs on the card.
"""
from deeplearning4j_tpu_torch.device import resolve

__all__ = ["resolve"]
