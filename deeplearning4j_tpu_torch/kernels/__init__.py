"""Hand-written Hopper kernels of the port and their wrappers."""
from deeplearning4j_tpu_torch.kernels.flash_attention import (
    flash_attention, flash_attention_decode, flash_attention_decode_mq,
    flash_bwd_dkv, flash_bwd_dq, flash_decode, flash_fwd)
from deeplearning4j_tpu_torch.kernels.layernorm import fused_layernorm
from deeplearning4j_tpu_torch.kernels.pointwise_conv import (
    bn_conv_grads, bn_grad_stats, fused_conv1x1_bn, int8_matmul_epilogue,
    matmul_epilogue, matmul_stats)
from deeplearning4j_tpu_torch.kernels.residual_block import bottleneck_block

__all__ = ["flash_attention", "flash_attention_decode",
           "flash_attention_decode_mq", "flash_bwd_dkv", "flash_bwd_dq",
           "flash_decode", "flash_fwd", "int8_matmul_epilogue",
           "matmul_epilogue", "bottleneck_block", "fused_layernorm",
           "matmul_stats", "bn_grad_stats", "bn_conv_grads",
           "fused_conv1x1_bn"]
