"""Device policy of the port: the card unless the caller asks for the CPU.

Every entry point that makes tensors takes `device=None`, which means
"cuda". Without a CUDA device that raises: the port never carries on
quietly on the CPU. Tests pass `device="cpu"`, which runs each kernel's
plain PyTorch version.
"""
from __future__ import annotations

import torch

__all__ = ["resolve"]

# The f32 path is the numerics reference of the port: keep float32
# matmuls and convolutions in full float32 on the card instead of TF32
# (cuDNN convolutions default to TF32).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve(device=None):
    """`device` as a torch.device: None means "cuda". Raises RuntimeError
    if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "deeplearning4j_tpu_torch runs on a CUDA device by default and "
            "none is available; pass device='cpu' to run the plain "
            "PyTorch versions of its kernels on the CPU")
    return dev
