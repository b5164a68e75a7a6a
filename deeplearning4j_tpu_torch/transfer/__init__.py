"""Transfer learning (≡ deeplearning4j-nn :: transferlearning): the port
of `deeplearning4j_tpu/transfer/`."""
from deeplearning4j_tpu_torch.transfer.transfer_learning import (  # noqa: F401
    FineTuneConfiguration, TransferLearning, TransferLearningHelper)
