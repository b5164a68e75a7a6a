"""The NDArray facade of the port (≡ nd4j-api): `NDArray`, the `nd`
factory, `RandomState` and the `Transforms` op catalog, the port of
`deeplearning4j_tpu/ops/`."""
from deeplearning4j_tpu_torch.ops.ndarray import (NDArray, as_torch,
                                                  resolve_dtype)
from deeplearning4j_tpu_torch.ops.factory import nd
from deeplearning4j_tpu_torch.ops.ops import (BooleanIndexing, Conditions,
                                              Transforms)
from deeplearning4j_tpu_torch.ops.random import RandomState

__all__ = ["NDArray", "nd", "RandomState", "as_torch", "resolve_dtype",
           "BooleanIndexing", "Conditions", "Transforms"]
