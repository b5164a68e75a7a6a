"""Hyperparameter optimization (≡ arbiter): the port of
`deeplearning4j_tpu/arbiter/`."""
from deeplearning4j_tpu_torch.arbiter.spaces import (ContinuousParameterSpace,
                                               DiscreteParameterSpace,
                                               FixedValue,
                                               IntegerParameterSpace,
                                               ParameterSpace)
from deeplearning4j_tpu_torch.arbiter.runner import (CandidateGenerator,
                                               GridSearchCandidateGenerator,
                                               LocalOptimizationRunner,
                                               OptimizationResult,
                                               RandomSearchGenerator,
                                               TPEGenerator)
from deeplearning4j_tpu_torch.arbiter.network_spaces import (
    AdamSpace, ComputationGraphSpace, LayerSpace, MultiLayerSpace,
    NesterovsSpace, SgdSpace, UpdaterSpace)

__all__ = [
    "ContinuousParameterSpace", "DiscreteParameterSpace", "FixedValue",
    "IntegerParameterSpace", "ParameterSpace", "CandidateGenerator",
    "GridSearchCandidateGenerator", "LocalOptimizationRunner",
    "OptimizationResult", "RandomSearchGenerator", "TPEGenerator",
    "AdamSpace", "ComputationGraphSpace", "LayerSpace", "MultiLayerSpace",
    "NesterovsSpace", "SgdSpace", "UpdaterSpace",
]
