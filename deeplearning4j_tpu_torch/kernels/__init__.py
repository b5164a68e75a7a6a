"""Hand-written Hopper kernels of the port and their wrappers."""
from deeplearning4j_tpu_torch.kernels.flash_attention import (
    flash_attention, flash_attention_decode, flash_attention_decode_mq,
    flash_bwd_dkv, flash_bwd_dq, flash_decode, flash_fwd)

__all__ = ["flash_attention", "flash_attention_decode",
           "flash_attention_decode_mq", "flash_bwd_dkv", "flash_bwd_dq",
           "flash_decode", "flash_fwd"]
