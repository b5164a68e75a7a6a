"""The port's model zoo: the `.list()` CNNs (LeNet, SimpleCNN, AlexNet,
VGG16, VGG19, Darknet19), ResNet-50 and the char-RNN TextGenerationLSTM."""
from deeplearning4j_tpu_torch.models.zoo.models import (VGG16, AlexNet, LeNet,
                                                        ResNet50, SimpleCNN,
                                                        TextGenerationLSTM,
                                                        ZooModel)
from deeplearning4j_tpu_torch.models.zoo.models2 import VGG19, Darknet19

__all__ = ["AlexNet", "Darknet19", "LeNet", "ResNet50", "SimpleCNN",
           "TextGenerationLSTM", "VGG16", "VGG19", "ZooModel"]
