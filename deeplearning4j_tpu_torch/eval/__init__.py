"""The port's evaluation classes (numpy; a copy of the JAX package's)."""
from deeplearning4j_tpu_torch.eval.evaluation import (Evaluation,
                                                      EvaluationBinary,
                                                      EvaluationCalibration,
                                                      RegressionEvaluation,
                                                      ROC, ROCBinary,
                                                      ROCMultiClass)

__all__ = ["Evaluation", "EvaluationBinary", "EvaluationCalibration",
           "RegressionEvaluation", "ROC", "ROCBinary", "ROCMultiClass"]
