"""SameDiff with its TF frozen-graph and ONNX importers (≡ nd4j-api
autodiff): the port of `deeplearning4j_tpu/autodiff/`."""
from deeplearning4j_tpu_torch.autodiff import tf_import  # registers importFrozenTF
from deeplearning4j_tpu_torch.autodiff.onnx_import import (OnnxGraphMapper,
                                                           importOnnx)
from deeplearning4j_tpu_torch.autodiff.tf_import import (TFGraphMapper,
                                                         importFrozenTF)
from deeplearning4j_tpu_torch.autodiff.samediff import (SameDiff, SDVariable,
                                                        TrainingConfig,
                                                        VariableType)

__all__ = ["SameDiff", "SDVariable", "TrainingConfig", "VariableType",
           "TFGraphMapper", "importFrozenTF", "OnnxGraphMapper",
           "importOnnx"]
