"""The port's model zoo, all of the JAX package's: the `.list()` CNNs
(LeNet, SimpleCNN, AlexNet, VGG16, VGG19, Darknet19), the detector
TinyYOLO, the graph models (ResNet50, UNet, SqueezeNet, Xception,
InceptionResNetV1, YOLO2, FaceNetNN4Small2, NASNet, EfficientNet) and the
char-RNN TextGenerationLSTM."""
from deeplearning4j_tpu_torch.models.zoo.models import (VGG16, AlexNet, LeNet,
                                                        ResNet50, SimpleCNN,
                                                        TextGenerationLSTM,
                                                        TinyYOLO, UNet,
                                                        ZooModel)
from deeplearning4j_tpu_torch.models.zoo.models2 import (
    VGG19, Darknet19, EfficientNet, FaceNetNN4Small2, InceptionResNetV1,
    NASNet, SqueezeNet, Xception, YOLO2)

__all__ = ["AlexNet", "Darknet19", "EfficientNet", "FaceNetNN4Small2",
           "InceptionResNetV1", "LeNet", "NASNet", "ResNet50", "SimpleCNN",
           "SqueezeNet", "TextGenerationLSTM", "TinyYOLO", "UNet", "VGG16",
           "VGG19", "Xception", "YOLO2", "ZooModel"]
