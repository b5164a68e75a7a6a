"""Model zoo, part 2: the port of `deeplearning4j_tpu/models/zoo/models2.py`
(≡ deeplearning4j-zoo :: org.deeplearning4j.zoo.model.Darknet19, VGG19,
SqueezeNet, Xception, InceptionResNetV1, YOLO2, FaceNetNN4Small2, NASNet,
EfficientNet), the whole of that file.

Same conventions as models.py: NHWC, built through the public config DSL;
`init()` returns a MultiLayerNetwork for Darknet19 and VGG19, a
ComputationGraph for the others. With DL4J_TPU_FUSE_CONV_BN=1 at `init()`,
the graph models' 1×1 conv+BN pairs run the hand-written fused kernels
(`nn/fused.py`): 36 pairs in InceptionResNetV1, 21 in FaceNetNN4Small2,
16 in EfficientNet-B0, 8 in NASNet, 4 in Xception.
"""
from __future__ import annotations

import math

from deeplearning4j_tpu_torch.models.zoo.models import (ZooModel,
                                                        _resolve_priors)
from deeplearning4j_tpu_torch.nn.conf.builders import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph_vertices import (
    ElementWiseVertex, L2NormalizeVertex, MergeVertex, ReshapeVertex,
    ScaleVertex, SpaceToDepthVertex)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (ActivationLayer,
                                                     BatchNormalization,
                                                     ConvolutionLayer,
                                                     DenseLayer,
                                                     DepthwiseConvolution2D,
                                                     DropoutLayer,
                                                     GlobalPoolingLayer,
                                                     OutputLayer,
                                                     SeparableConvolution2D,
                                                     SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.conf.objdetect import Yolo2OutputLayer
from deeplearning4j_tpu_torch.nn.conf.special_layers import \
    CenterLossOutputLayer
from deeplearning4j_tpu_torch.nn.updaters import Adam, Nesterovs


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


class SqueezeNet(ZooModel):
    """≡ zoo.model.SqueezeNet (v1.1) — fire modules: 1×1 squeeze then
    parallel 1×1/3×3 expands concatenated (MergeVertex)."""

    def conf(self):
        h, w, c = self.inputShape
        g = (NeuralNetConfiguration.Builder()
             .seed(self.seed)
             .updater(self.updater or Adam(1e-3))
             .weightInit("relu")
             .dataType(self.dataType)
             .graphBuilder()
             .addInputs("input")
             .setInputTypes(InputType.convolutional(h, w, c)))

        def fire(name, inp, squeeze, expand):
            g.addLayer(f"{name}_sq", ConvolutionLayer(
                kernelSize=(1, 1), nOut=squeeze, activation="relu",
                convolutionMode="same"), inp)
            g.addLayer(f"{name}_e1", ConvolutionLayer(
                kernelSize=(1, 1), nOut=expand, activation="relu",
                convolutionMode="same"), f"{name}_sq")
            g.addLayer(f"{name}_e3", ConvolutionLayer(
                kernelSize=(3, 3), nOut=expand, activation="relu",
                convolutionMode="same"), f"{name}_sq")
            g.addVertex(f"{name}_cat", MergeVertex(),
                        f"{name}_e1", f"{name}_e3")
            return f"{name}_cat"

        g.addLayer("conv1", ConvolutionLayer(kernelSize=(3, 3),
                                             stride=(2, 2), nOut=64,
                                             activation="relu",
                                             convolutionMode="same"),
                   "input")
        g.addLayer("pool1", SubsamplingLayer(kernelSize=(3, 3),
                                             stride=(2, 2),
                                             convolutionMode="same"),
                   "conv1")
        x = fire("fire2", "pool1", 16, 64)
        x = fire("fire3", x, 16, 64)
        g.addLayer("pool3", SubsamplingLayer(kernelSize=(3, 3),
                                             stride=(2, 2),
                                             convolutionMode="same"), x)
        x = fire("fire4", "pool3", 32, 128)
        x = fire("fire5", x, 32, 128)
        g.addLayer("pool5", SubsamplingLayer(kernelSize=(3, 3),
                                             stride=(2, 2),
                                             convolutionMode="same"), x)
        x = fire("fire6", "pool5", 48, 192)
        x = fire("fire7", x, 48, 192)
        x = fire("fire8", x, 64, 256)
        x = fire("fire9", x, 64, 256)
        g.addLayer("drop", DropoutLayer(dropOut=0.5), x)
        g.addLayer("conv10", ConvolutionLayer(kernelSize=(1, 1),
                                              nOut=self.numClasses,
                                              activation="relu",
                                              convolutionMode="same"),
                   "drop")
        g.addLayer("gap", GlobalPoolingLayer(poolingType="avg"), "conv10")
        g.addLayer("out", OutputLayer(lossFunction="mcxent",
                                      nOut=self.numClasses,
                                      activation="softmax"), "gap")
        g.setOutputs("out")
        return g.build()


class Xception(ZooModel):
    """≡ zoo.model.Xception — depthwise-separable conv stacks with
    linear residual shortcuts (entry/middle/exit flow, middle depth
    configurable to keep CPU tests tractable)."""

    def __init__(self, middleFlowBlocks=8, **kw):
        super().__init__(**kw)
        self.middleFlowBlocks = middleFlowBlocks

    DEFAULT_INPUT = (299, 299, 3)

    def conf(self):
        h, w, c = self.inputShape
        g = (NeuralNetConfiguration.Builder()
             .seed(self.seed)
             .updater(self.updater or Nesterovs(0.045, 0.9))
             .weightInit("relu")
             .dataType(self.dataType)
             .graphBuilder()
             .addInputs("input")
             .setInputTypes(InputType.convolutional(h, w, c)))

        def conv_bn(name, inp, n_out, k, s, act="relu"):
            g.addLayer(f"{name}_c", ConvolutionLayer(
                kernelSize=k, stride=s, nOut=n_out, hasBias=False,
                convolutionMode="same", activation="identity"), inp)
            g.addLayer(f"{name}_bn", BatchNormalization(activation=act),
                       f"{name}_c")
            return f"{name}_bn"

        def sep_bn(name, inp, n_out, act="relu"):
            g.addLayer(f"{name}_s", SeparableConvolution2D(
                kernelSize=(3, 3), nOut=n_out, hasBias=False,
                convolutionMode="same", activation="identity"), inp)
            g.addLayer(f"{name}_bn", BatchNormalization(activation=act),
                       f"{name}_s")
            return f"{name}_bn"

        def xception_block(name, inp, n_out, relu_first=True):
            """two sep convs + stride-2 pool, 1×1 stride-2 residual."""
            x = inp
            if relu_first:
                g.addLayer(f"{name}_pre", ActivationLayer(
                    activation="relu"), x)
                x = f"{name}_pre"
            x = sep_bn(f"{name}_s1", x, n_out)
            x = sep_bn(f"{name}_s2", x, n_out, act="identity")
            g.addLayer(f"{name}_pool", SubsamplingLayer(
                kernelSize=(3, 3), stride=(2, 2), convolutionMode="same"), x)
            sc = conv_bn(f"{name}_sc", inp, n_out, (1, 1), (2, 2),
                         act="identity")
            g.addVertex(f"{name}_add", ElementWiseVertex("add"),
                        f"{name}_pool", sc)
            return f"{name}_add"

        x = conv_bn("stem1", "input", 32, (3, 3), (2, 2))
        x = conv_bn("stem2", x, 64, (3, 3), (1, 1))
        x = xception_block("entry1", x, 128, relu_first=False)
        x = xception_block("entry2", x, 256)
        x = xception_block("entry3", x, 728)
        for i in range(self.middleFlowBlocks):
            inp = x
            y = inp
            for j in range(3):
                g.addLayer(f"mid{i}_relu{j}", ActivationLayer(
                    activation="relu"), y)
                y = sep_bn(f"mid{i}_s{j}", f"mid{i}_relu{j}", 728,
                           act="identity")
            g.addVertex(f"mid{i}_add", ElementWiseVertex("add"), y, inp)
            x = f"mid{i}_add"
        x = xception_block("exit1", x, 1024)
        x = sep_bn("exit2", x, 1536)
        x = sep_bn("exit3", x, 2048)
        g.addLayer("gap", GlobalPoolingLayer(poolingType="avg"), x)
        g.addLayer("out", OutputLayer(lossFunction="mcxent",
                                      nOut=self.numClasses,
                                      activation="softmax"), "gap")
        g.setOutputs("out")
        return g.build()


class InceptionResNetV1(ZooModel):
    """≡ zoo.model.InceptionResNetV1 — inception branches merged then
    1×1-projected, residual-added with a ScaleVertex(0.17/0.10) exactly
    as the reference scales its residual summands. Block counts are
    configurable (defaults are the paper's 5/10/5)."""

    def __init__(self, blocks=(5, 10, 5), **kw):
        super().__init__(**kw)
        self.blocks = blocks

    DEFAULT_INPUT = (160, 160, 3)

    def conf(self):
        h, w, c = self.inputShape
        g = (NeuralNetConfiguration.Builder()
             .seed(self.seed)
             .updater(self.updater or Adam(1e-3))
             .weightInit("relu")
             .dataType(self.dataType)
             .graphBuilder()
             .addInputs("input")
             .setInputTypes(InputType.convolutional(h, w, c)))

        def conv_bn(name, inp, n_out, k, s=(1, 1), act="relu"):
            g.addLayer(f"{name}_c", ConvolutionLayer(
                kernelSize=k, stride=s, nOut=n_out, hasBias=False,
                convolutionMode="same", activation="identity"), inp)
            g.addLayer(f"{name}_bn", BatchNormalization(activation=act),
                       f"{name}_c")
            return f"{name}_bn"

        def block35(name, inp, width):
            """Inception-ResNet-A: 1×1 / 1×1-3×3 / 1×1-3×3-3×3 branches."""
            b0 = conv_bn(f"{name}_b0", inp, 32, (1, 1))
            b1 = conv_bn(f"{name}_b1a", inp, 32, (1, 1))
            b1 = conv_bn(f"{name}_b1b", b1, 32, (3, 3))
            b2 = conv_bn(f"{name}_b2a", inp, 32, (1, 1))
            b2 = conv_bn(f"{name}_b2b", b2, 32, (3, 3))
            b2 = conv_bn(f"{name}_b2c", b2, 32, (3, 3))
            g.addVertex(f"{name}_cat", MergeVertex(), b0, b1, b2)
            g.addLayer(f"{name}_proj", ConvolutionLayer(
                kernelSize=(1, 1), nOut=width, convolutionMode="same",
                activation="identity"), f"{name}_cat")
            g.addVertex(f"{name}_scale", ScaleVertex(0.17), f"{name}_proj")
            g.addVertex(f"{name}_add", ElementWiseVertex("add"), inp,
                        f"{name}_scale")
            g.addLayer(f"{name}_relu", ActivationLayer(activation="relu"),
                       f"{name}_add")
            return f"{name}_relu"

        def block17(name, inp, width):
            b0 = conv_bn(f"{name}_b0", inp, 128, (1, 1))
            b1 = conv_bn(f"{name}_b1a", inp, 128, (1, 1))
            b1 = conv_bn(f"{name}_b1b", b1, 128, (1, 7))
            b1 = conv_bn(f"{name}_b1c", b1, 128, (7, 1))
            g.addVertex(f"{name}_cat", MergeVertex(), b0, b1)
            g.addLayer(f"{name}_proj", ConvolutionLayer(
                kernelSize=(1, 1), nOut=width, convolutionMode="same",
                activation="identity"), f"{name}_cat")
            g.addVertex(f"{name}_scale", ScaleVertex(0.10), f"{name}_proj")
            g.addVertex(f"{name}_add", ElementWiseVertex("add"), inp,
                        f"{name}_scale")
            g.addLayer(f"{name}_relu", ActivationLayer(activation="relu"),
                       f"{name}_add")
            return f"{name}_relu"

        # stem
        x = conv_bn("stem1", "input", 32, (3, 3), (2, 2))
        x = conv_bn("stem2", x, 64, (3, 3))
        g.addLayer("stem_pool", SubsamplingLayer(
            kernelSize=(3, 3), stride=(2, 2), convolutionMode="same"), x)
        x = conv_bn("stem3", "stem_pool", 128, (1, 1))
        x = conv_bn("stem4", x, 192, (3, 3))
        x = conv_bn("stem5", x, 256, (3, 3), (2, 2))
        for i in range(self.blocks[0]):
            x = block35(f"a{i}", x, 256)
        x = conv_bn("redA", x, 512, (3, 3), (2, 2))
        for i in range(self.blocks[1]):
            x = block17(f"b{i}", x, 512)
        x = conv_bn("redB", x, 896, (3, 3), (2, 2))
        g.addLayer("gap", GlobalPoolingLayer(poolingType="avg"), x)
        g.addLayer("drop", DropoutLayer(dropOut=0.8), "gap")
        g.addLayer("bottleneck", DenseLayer(nOut=128,
                                            activation="identity"), "drop")
        g.addLayer("out", OutputLayer(lossFunction="mcxent",
                                      nOut=self.numClasses,
                                      activation="softmax"), "bottleneck")
        g.setOutputs("out")
        return g.build()


class YOLO2(ZooModel):
    """≡ zoo.model.YOLO2 — Darknet19 backbone + space-to-depth
    passthrough (the 'reorg' route) + Yolo2OutputLayer with the
    reference's COCO box priors."""

    DEFAULT_INPUT = (416, 416, 3)
    PRIORS = [[0.57273, 0.677385], [1.87446, 2.06253], [3.33843, 5.47434],
              [7.88282, 3.52778], [9.77052, 9.16828]]

    def __init__(self, numClasses=80, boxes=None, **kw):
        super().__init__(numClasses=numClasses, **kw)
        self.priors = _resolve_priors(boxes, self.PRIORS)

    def conf(self):
        h, w, c = self.inputShape
        g = (NeuralNetConfiguration.Builder()
             .seed(self.seed)
             .updater(self.updater or Adam(1e-3))
             .weightInit("relu")
             .l2(5e-4)
             .dataType(self.dataType)
             .graphBuilder()
             .addInputs("input")
             .setInputTypes(InputType.convolutional(h, w, c)))

        def conv_bn(name, inp, n_out, k):
            g.addLayer(f"{name}_c", ConvolutionLayer(
                kernelSize=(k, k), nOut=n_out, convolutionMode="same",
                hasBias=False, activation="identity"), inp)
            g.addLayer(f"{name}_bn",
                       BatchNormalization(activation="leakyrelu"),
                       f"{name}_c")
            return f"{name}_bn"

        def pool(name, inp):
            g.addLayer(name, SubsamplingLayer(kernelSize=(2, 2),
                                              stride=(2, 2)), inp)
            return name

        x = conv_bn("c1", "input", 32, 3); x = pool("p1", x)
        x = conv_bn("c2", x, 64, 3); x = pool("p2", x)
        x = conv_bn("c3", x, 128, 3)
        x = conv_bn("c4", x, 64, 1)
        x = conv_bn("c5", x, 128, 3); x = pool("p3", x)
        x = conv_bn("c6", x, 256, 3)
        x = conv_bn("c7", x, 128, 1)
        x = conv_bn("c8", x, 256, 3); x = pool("p4", x)
        for i, (n, k) in enumerate([(512, 3), (256, 1), (512, 3),
                                    (256, 1), (512, 3)]):
            x = conv_bn(f"c9_{i}", x, n, k)
        route = x                       # 26×26×512 passthrough source
        x = pool("p5", x)
        for i, (n, k) in enumerate([(1024, 3), (512, 1), (1024, 3),
                                    (512, 1), (1024, 3)]):
            x = conv_bn(f"c10_{i}", x, n, k)
        x = conv_bn("c11", x, 1024, 3)
        x = conv_bn("c12", x, 1024, 3)
        g.addVertex("reorg", SpaceToDepthVertex(2), route)   # → 13×13×2048
        g.addVertex("route_cat", MergeVertex(), "reorg", x)
        x = conv_bn("c13", "route_cat", 1024, 3)
        head = len(self.priors) * (5 + self.numClasses)
        g.addLayer("head", ConvolutionLayer(kernelSize=(1, 1), nOut=head,
                                            convolutionMode="same",
                                            activation="identity"), x)
        g.addLayer("out", Yolo2OutputLayer(boundingBoxes=self.priors),
                   "head")
        g.setOutputs("out")
        return g.build()


class FaceNetNN4Small2(ZooModel):
    """≡ zoo.model.FaceNetNN4Small2 — nn4.small2-style inception embedding
    net: stem + inception(3a/3b/4a/4e/5a/5b)-like modules, 128-d
    L2-bottleneck, CenterLossOutputLayer head (the reference's center-loss
    FaceNet training setup)."""

    DEFAULT_INPUT = (96, 96, 3)

    def __init__(self, numClasses=10, embeddingSize=128, **kw):
        super().__init__(numClasses=numClasses, **kw)
        self.embeddingSize = int(embeddingSize)

    def conf(self):
        h, w, c = self.inputShape
        g = (NeuralNetConfiguration.Builder()
             .seed(self.seed)
             .updater(self.updater or Adam(1e-3))
             .weightInit("relu")
             .dataType(self.dataType)
             .graphBuilder()
             .addInputs("input")
             .setInputTypes(InputType.convolutional(h, w, c)))

        def conv_bn(name, inp, n_out, k, s=(1, 1)):
            g.addLayer(f"{name}_c", ConvolutionLayer(
                kernelSize=k, stride=s, nOut=n_out, hasBias=False,
                convolutionMode="same", activation="identity"), inp)
            g.addLayer(f"{name}_bn", BatchNormalization(activation="relu"),
                       f"{name}_c")
            return f"{name}_bn"

        def inception(name, inp, n1, n3r, n3, n5r, n5, pp):
            b1 = conv_bn(f"{name}_1", inp, n1, (1, 1))
            b3 = conv_bn(f"{name}_3r", inp, n3r, (1, 1))
            b3 = conv_bn(f"{name}_3", b3, n3, (3, 3))
            b5 = conv_bn(f"{name}_5r", inp, n5r, (1, 1))
            b5 = conv_bn(f"{name}_5", b5, n5, (5, 5))
            g.addLayer(f"{name}_pool", SubsamplingLayer(
                kernelSize=(3, 3), stride=(1, 1), convolutionMode="same"),
                inp)
            bp = conv_bn(f"{name}_pp", f"{name}_pool", pp, (1, 1))
            g.addVertex(f"{name}_cat", MergeVertex(), b1, b3, b5, bp)
            return f"{name}_cat"

        x = conv_bn("stem1", "input", 64, (7, 7), (2, 2))
        g.addLayer("stem_pool", SubsamplingLayer(
            kernelSize=(3, 3), stride=(2, 2), convolutionMode="same"), x)
        x = conv_bn("stem2", "stem_pool", 64, (1, 1))
        x = conv_bn("stem3", x, 192, (3, 3))
        g.addLayer("stem_pool2", SubsamplingLayer(
            kernelSize=(3, 3), stride=(2, 2), convolutionMode="same"), x)
        x = inception("i3a", "stem_pool2", 64, 96, 128, 16, 32, 32)
        x = inception("i3b", x, 64, 96, 128, 32, 64, 64)
        g.addLayer("pool3", SubsamplingLayer(
            kernelSize=(3, 3), stride=(2, 2), convolutionMode="same"), x)
        x = inception("i4a", "pool3", 256, 96, 192, 32, 64, 128)
        x = inception("i4e", x, 256, 160, 256, 64, 128, 128)
        g.addLayer("pool4", SubsamplingLayer(
            kernelSize=(3, 3), stride=(2, 2), convolutionMode="same"), x)
        x = inception("i5a", "pool4", 256, 96, 384, 32, 64, 96)
        g.addLayer("gap", GlobalPoolingLayer(poolingType="avg"), x)
        g.addLayer("bottleneck", DenseLayer(nOut=self.embeddingSize,
                                            activation="identity"), "gap")
        g.addVertex("embeddings", L2NormalizeVertex(), "bottleneck")
        g.addLayer("out", CenterLossOutputLayer(
            lambda_=2e-4, alpha=0.9, nOut=self.numClasses,
            activation="softmax"), "embeddings")
        g.setOutputs("out")
        return g.build()


class NASNet(ZooModel):
    """≡ zoo.model.NASNet (NASNet-A mobile shape) — stem + alternating
    normal/reduction cells built from separable-conv branch combinations
    concatenated per cell. Cell counts/penultimate filters configurable
    (defaults follow the mobile variant scaled by `filters`)."""

    DEFAULT_INPUT = (224, 224, 3)

    def __init__(self, numBlocks=2, filters=44, stemFilters=32, **kw):
        super().__init__(**kw)
        self.numBlocks = int(numBlocks)
        self.filters = int(filters)
        self.stemFilters = int(stemFilters)

    def conf(self):
        h, w, c = self.inputShape
        g = (NeuralNetConfiguration.Builder()
             .seed(self.seed)
             .updater(self.updater or Adam(1e-3))
             .weightInit("relu")
             .l2(5e-5)
             .dataType(self.dataType)
             .graphBuilder()
             .addInputs("input")
             .setInputTypes(InputType.convolutional(h, w, c)))

        def conv_bn(name, inp, n_out, k, s=(1, 1), act="relu"):
            g.addLayer(f"{name}_c", ConvolutionLayer(
                kernelSize=k, stride=s, nOut=n_out, hasBias=False,
                convolutionMode="same", activation="identity"), inp)
            g.addLayer(f"{name}_bn", BatchNormalization(activation=act),
                       f"{name}_c")
            return f"{name}_bn"

        def sep_bn(name, inp, n_out, k, s=(1, 1)):
            g.addLayer(f"{name}_s", SeparableConvolution2D(
                kernelSize=k, stride=s, nOut=n_out, hasBias=False,
                convolutionMode="same", activation="identity"), inp)
            g.addLayer(f"{name}_bn", BatchNormalization(activation="relu"),
                       f"{name}_s")
            return f"{name}_bn"

        def normal_cell(name, inp, filters):
            """NASNet-A normal cell (single-input simplification of the
            two-hidden-state wiring): sep3/sep5/pool/identity branches
            summed pairwise, outputs concatenated."""
            p = conv_bn(f"{name}_sq", inp, filters, (1, 1))
            b1a = sep_bn(f"{name}_b1a", p, filters, (5, 5))
            b1b = sep_bn(f"{name}_b1b", p, filters, (3, 3))
            g.addVertex(f"{name}_a1", ElementWiseVertex("add"), b1a, b1b)
            g.addLayer(f"{name}_pool", SubsamplingLayer(
                poolingType="avg", kernelSize=(3, 3), stride=(1, 1),
                convolutionMode="same"), p)
            g.addVertex(f"{name}_a2", ElementWiseVertex("add"),
                        f"{name}_pool", p)
            b3a = sep_bn(f"{name}_b3a", p, filters, (3, 3))
            g.addVertex(f"{name}_a3", ElementWiseVertex("add"), b3a, p)
            g.addVertex(f"{name}_cat", MergeVertex(),
                        f"{name}_a1", f"{name}_a2", f"{name}_a3")
            return f"{name}_cat"

        def reduction_cell(name, inp, filters):
            p = conv_bn(f"{name}_sq", inp, filters, (1, 1))
            b1 = sep_bn(f"{name}_b1", p, filters, (5, 5), (2, 2))
            b2 = sep_bn(f"{name}_b2", p, filters, (7, 7), (2, 2))
            g.addVertex(f"{name}_a1", ElementWiseVertex("add"), b1, b2)
            g.addLayer(f"{name}_mp", SubsamplingLayer(
                poolingType="max", kernelSize=(3, 3), stride=(2, 2),
                convolutionMode="same"), p)
            b3 = sep_bn(f"{name}_b3", p, filters, (3, 3), (2, 2))
            g.addVertex(f"{name}_a2", ElementWiseVertex("add"),
                        f"{name}_mp", b3)
            g.addVertex(f"{name}_cat", MergeVertex(),
                        f"{name}_a1", f"{name}_a2")
            return f"{name}_cat"

        x = conv_bn("stem", "input", self.stemFilters, (3, 3), (2, 2))
        f = self.filters
        for i in range(self.numBlocks):
            x = normal_cell(f"n1_{i}", x, f)
        x = reduction_cell("r1", x, f * 2)
        for i in range(self.numBlocks):
            x = normal_cell(f"n2_{i}", x, f * 2)
        x = reduction_cell("r2", x, f * 4)
        for i in range(self.numBlocks):
            x = normal_cell(f"n3_{i}", x, f * 4)
        g.addLayer("relu_out", ActivationLayer(activation="relu"), x)
        g.addLayer("gap", GlobalPoolingLayer(poolingType="avg"),
                   "relu_out")
        g.addLayer("drop", DropoutLayer(dropOut=0.5), "gap")
        g.addLayer("out", OutputLayer(lossFunction="mcxent",
                                      nOut=self.numClasses,
                                      activation="softmax"), "drop")
        g.setOutputs("out")
        return g.build()


class EfficientNet(ZooModel):
    """≡ zoo.model.EfficientNet (1.0.0-M1 zoo addition) — MBConv stacks
    with squeeze-and-excitation, swish activations, and compound
    width/depth/resolution scaling (variants B0-B7).

    The depthwise convs are DepthwiseConvolution2D (a grouped cuDNN
    convolution); the SE channel gating is a broadcast
    ElementWiseVertex("product") against a (1, 1, C) ReshapeVertex
    output."""

    #: variant -> (width_mult, depth_mult, default resolution, dropout)
    VARIANTS = {"B0": (1.0, 1.0, 224, 0.2), "B1": (1.0, 1.1, 240, 0.2),
                "B2": (1.1, 1.2, 260, 0.3), "B3": (1.2, 1.4, 300, 0.3),
                "B4": (1.4, 1.8, 380, 0.4), "B5": (1.6, 2.2, 456, 0.4),
                "B6": (1.8, 2.6, 528, 0.5), "B7": (2.0, 3.1, 600, 0.5)}

    #: base (B0) stage spec: expand, channels, repeats, stride, kernel
    STAGES = ((1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5),
              (6, 80, 3, 2, 3), (6, 112, 3, 1, 5), (6, 192, 4, 2, 5),
              (6, 320, 1, 1, 3))

    def __init__(self, variant="B0", **kw):
        if variant not in self.VARIANTS:
            raise ValueError(f"unknown EfficientNet variant {variant!r}; "
                             f"pick one of {sorted(self.VARIANTS)}")
        self.variant = variant
        w, d, res, drop = self.VARIANTS[variant]
        self.width_mult, self.depth_mult = w, d
        self.dropout_rate = drop   # reference scales dropout with size
        self.DEFAULT_INPUT = (res, res, 3)
        super().__init__(**kw)

    @staticmethod
    def _round_filters(filters, width_mult, divisor=8):
        """Reference filter rounding: scale, snap to divisor, never drop
        below 90% of the scaled value."""
        f = filters * width_mult
        new = max(divisor, int(f + divisor / 2) // divisor * divisor)
        if new < 0.9 * f:
            new += divisor
        return int(new)

    @staticmethod
    def _round_repeats(repeats, depth_mult):
        return int(math.ceil(repeats * depth_mult))

    def conf(self):
        h, w, c = self.inputShape
        g = (NeuralNetConfiguration.Builder()
             .seed(self.seed)
             .updater(self.updater or Adam(1e-3))
             .weightInit("relu")
             .dataType(self.dataType)
             .graphBuilder()
             .addInputs("input")
             .setInputTypes(InputType.convolutional(h, w, c)))

        def conv_bn(name, inp, n_out, k, s, act="swish", groups_dw=False):
            layer = (DepthwiseConvolution2D(
                         kernelSize=k, stride=s, hasBias=False,
                         convolutionMode="same", activation="identity")
                     if groups_dw else
                     ConvolutionLayer(
                         kernelSize=k, stride=s, nOut=n_out, hasBias=False,
                         convolutionMode="same", activation="identity"))
            g.addLayer(f"{name}_c", layer, inp)
            g.addLayer(f"{name}_bn", BatchNormalization(activation=act),
                       f"{name}_c")
            return f"{name}_bn"

        def mbconv(name, inp, cin, cout, expand, k, stride):
            cexp = cin * expand
            x = inp
            if expand != 1:
                x = conv_bn(f"{name}_e", x, cexp, (1, 1), (1, 1))
            x = conv_bn(f"{name}_d", x, cexp, (k, k), (stride, stride),
                        groups_dw=True)
            # squeeze-and-excitation: ratio 0.25 of the block INPUT chans
            se_ch = max(1, int(cin * 0.25))
            g.addLayer(f"{name}_se_gap",
                       GlobalPoolingLayer(poolingType="avg"), x)
            g.addLayer(f"{name}_se_r", DenseLayer(
                nOut=se_ch, activation="swish"), f"{name}_se_gap")
            g.addLayer(f"{name}_se_x", DenseLayer(
                nOut=cexp, activation="sigmoid"), f"{name}_se_r")
            g.addVertex(f"{name}_se_rs", ReshapeVertex(-1, 1, 1, cexp),
                        f"{name}_se_x")
            g.addVertex(f"{name}_se_mul", ElementWiseVertex("product"),
                        x, f"{name}_se_rs")
            x = conv_bn(f"{name}_p", f"{name}_se_mul", cout, (1, 1), (1, 1),
                        act="identity")
            if stride == 1 and cin == cout:
                g.addVertex(f"{name}_add", ElementWiseVertex("add"), x, inp)
                return f"{name}_add", cout
            return x, cout

        stem_ch = self._round_filters(32, self.width_mult)
        x = conv_bn("stem", "input", stem_ch, (3, 3), (2, 2))
        cin = stem_ch
        for si, (expand, ch, reps, stride, k) in enumerate(self.STAGES):
            cout = self._round_filters(ch, self.width_mult)
            for r in range(self._round_repeats(reps, self.depth_mult)):
                x, cin = mbconv(f"s{si}r{r}", x, cin, cout, expand, k,
                                stride if r == 0 else 1)
        head_ch = self._round_filters(1280, self.width_mult)
        x = conv_bn("head", x, head_ch, (1, 1), (1, 1))
        g.addLayer("gap", GlobalPoolingLayer(poolingType="avg"), x)
        g.addLayer("drop", DropoutLayer(dropOut=1.0 - self.dropout_rate),
                   "gap")
        g.addLayer("out", OutputLayer(lossFunction="mcxent",
                                      nOut=self.numClasses,
                                      activation="softmax"), "drop")
        g.setOutputs("out")
        return g.build()
