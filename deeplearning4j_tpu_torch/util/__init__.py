"""Utilities of the port: `crash_reporting` (the OOM crash dump), `serde`
(the configuration JSON), `model_serializer` (the model archives) and
`model_guesser`. The package exports the JAX package's four names."""
from deeplearning4j_tpu_torch.util.crash_reporting import CrashReportingUtil
from deeplearning4j_tpu_torch.util.model_guesser import (ModelGuesser,
                                                         ModelGuesserException)
from deeplearning4j_tpu_torch.util.model_serializer import ModelSerializer

__all__ = ["ModelSerializer", "ModelGuesser", "ModelGuesserException",
           "CrashReportingUtil"]
