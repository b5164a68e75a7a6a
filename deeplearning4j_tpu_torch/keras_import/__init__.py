"""Keras model import (≡ deeplearning4j-modelimport): the port of
`deeplearning4j_tpu/keras_import/`."""
from deeplearning4j_tpu_torch.keras_import.keras_import import (
    InvalidKerasConfigurationException, KerasModelImport, clearLambdas,
    registerCustomLayer, registerLambda)

__all__ = ["InvalidKerasConfigurationException", "KerasModelImport",
           "registerCustomLayer", "registerLambda", "clearLambdas"]
