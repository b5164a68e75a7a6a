"""SameDiff and the TF frozen-graph importer (≡ nd4j-api autodiff): the
port of `deeplearning4j_tpu/autodiff/`. The ONNX importer is not ported
yet (ROADMAP A17)."""
from deeplearning4j_tpu_torch.autodiff import tf_import  # registers importFrozenTF
from deeplearning4j_tpu_torch.autodiff.tf_import import (TFGraphMapper,
                                                         importFrozenTF)
from deeplearning4j_tpu_torch.autodiff.samediff import (SameDiff, SDVariable,
                                                        TrainingConfig,
                                                        VariableType)

__all__ = ["SameDiff", "SDVariable", "TrainingConfig", "VariableType",
           "TFGraphMapper", "importFrozenTF"]
