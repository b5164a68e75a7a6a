"""Training-loop surround: listeners and early stopping (≡ deeplearning4j-nn
optimize.listeners + deeplearning4j-core earlystopping), the port of
`deeplearning4j_tpu/optimize/`, with `xplane.py`, the decoder of the
profiler's traces (torch.profiler's Kineto JSON and jax.profiler's
XSpace)."""
from deeplearning4j_tpu_torch.optimize.listeners import (  # noqa: F401
    CheckpointListener, CollectScoresListener, EvaluativeListener,
    MetricsListener, PerformanceListener, ProfilerListener,
    ScoreIterationListener, TimeIterationListener, TrainingListener)
from deeplearning4j_tpu_torch.optimize.early_stopping import (  # noqa: F401
    BestScoreEpochTerminationCondition, ClassificationScoreCalculator,
    DataSetLossCalculator, EarlyStoppingConfiguration,
    EarlyStoppingGraphTrainer, EarlyStoppingParallelTrainer,
    EarlyStoppingResult, EarlyStoppingTrainer,
    InMemoryModelSaver, InvalidScoreIterationTerminationCondition,
    LocalFileModelSaver, MaxEpochsTerminationCondition,
    MaxScoreIterationTerminationCondition,
    MaxTimeIterationTerminationCondition, ROCScoreCalculator,
    ScoreImprovementEpochTerminationCondition, TerminationReason)
