"""DataSet and MultiDataSet of the port (numpy-backed)."""
from deeplearning4j_tpu_torch.datasets.dataset import (DataSet, MultiDataSet,
                                                       SplitTestAndTrain)

__all__ = ["DataSet", "MultiDataSet", "SplitTestAndTrain"]
