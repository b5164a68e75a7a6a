"""Model zoo, part 2: the port of Darknet19 and VGG19 of
`deeplearning4j_tpu/models/zoo/models2.py` (≡ deeplearning4j-zoo ::
org.deeplearning4j.zoo.model.Darknet19, VGG19), the `.list()` models of
that file whose layers the port has. SqueezeNet, Xception and
InceptionResNetV1 come with the zoo's graph models (ROADMAP A11).

Same conventions as models.py: NHWC, built through the public config DSL;
`init()` returns a MultiLayerNetwork.
"""
from __future__ import annotations

from deeplearning4j_tpu_torch.models.zoo.models import ZooModel
from deeplearning4j_tpu_torch.nn.conf.builders import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (BatchNormalization,
                                                     ConvolutionLayer,
                                                     DenseLayer,
                                                     GlobalPoolingLayer,
                                                     OutputLayer,
                                                     SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.updaters import Nesterovs


class Darknet19(ZooModel):
    """≡ zoo.model.Darknet19 — the YOLO9000 classifier backbone:
    3×3/1×1 conv stacks with BN+leakyrelu, five maxpools, 1×1×classes
    conv head + global average pooling."""

    DEFAULT_INPUT = (224, 224, 3)

    def conf(self):
        h, w, c = self.inputShape
        b = (NeuralNetConfiguration.Builder()
             .seed(self.seed)
             .updater(self.updater or Nesterovs(1e-3, 0.9))
             .weightInit("relu")
             .l2(5e-4)
             .dataType(self.dataType)
             .list())

        def conv_bn(n_out, k):
            b.layer(ConvolutionLayer(kernelSize=(k, k), nOut=n_out,
                                     convolutionMode="same", hasBias=False,
                                     activation="identity"))
            b.layer(BatchNormalization(activation="leakyrelu"))

        def pool():
            b.layer(SubsamplingLayer(kernelSize=(2, 2), stride=(2, 2)))

        conv_bn(32, 3); pool()
        conv_bn(64, 3); pool()
        conv_bn(128, 3); conv_bn(64, 1); conv_bn(128, 3); pool()
        conv_bn(256, 3); conv_bn(128, 1); conv_bn(256, 3); pool()
        conv_bn(512, 3); conv_bn(256, 1); conv_bn(512, 3)
        conv_bn(256, 1); conv_bn(512, 3); pool()
        conv_bn(1024, 3); conv_bn(512, 1); conv_bn(1024, 3)
        conv_bn(512, 1); conv_bn(1024, 3)
        b.layer(ConvolutionLayer(kernelSize=(1, 1), nOut=self.numClasses,
                                 convolutionMode="same",
                                 activation="identity"))
        b.layer(GlobalPoolingLayer(poolingType="avg"))
        b.layer(OutputLayer(lossFunction="mcxent", nOut=self.numClasses,
                            activation="softmax"))
        return b.setInputType(InputType.convolutional(h, w, c)).build()


class VGG19(ZooModel):
    """≡ zoo.model.VGG19 — VGG16 with the 4-conv deep stages."""

    def conf(self):
        h, w, c = self.inputShape
        b = (NeuralNetConfiguration.Builder()
             .seed(self.seed)
             .updater(self.updater or Nesterovs(1e-2, 0.9))
             .weightInit("relu")
             .activation("relu")
             .dataType(self.dataType)
             .list())
        for n_out, reps in [(64, 2), (128, 2), (256, 4), (512, 4), (512, 4)]:
            for _ in range(reps):
                b.layer(ConvolutionLayer(kernelSize=(3, 3), nOut=n_out,
                                         convolutionMode="same"))
            b.layer(SubsamplingLayer(kernelSize=(2, 2), stride=(2, 2)))
        return (b.layer(DenseLayer(nOut=4096, dropOut=0.5))
                 .layer(DenseLayer(nOut=4096, dropOut=0.5))
                 .layer(OutputLayer(lossFunction="mcxent",
                                    nOut=self.numClasses,
                                    activation="softmax"))
                 .setInputType(InputType.convolutional(h, w, c))
                 .build())
