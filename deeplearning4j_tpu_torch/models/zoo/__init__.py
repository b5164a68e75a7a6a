"""The port's model zoo: ResNet-50 so far."""
from deeplearning4j_tpu_torch.models.zoo.models import ResNet50, ZooModel

__all__ = ["ResNet50", "ZooModel"]
