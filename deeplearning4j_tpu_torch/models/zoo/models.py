"""Model zoo: the port of `ZooModel`, LeNet, SimpleCNN, AlexNet, VGG16,
ResNet50, UNet, TinyYOLO and TextGenerationLSTM of
`deeplearning4j_tpu/models/zoo/models.py` (≡ deeplearning4j-zoo ::
org.deeplearning4j.zoo.model.*), the whole of that file.

The models build through the same public config DSL a user would write.
`init()` returns the network on the card (or on `device`): a
MultiLayerNetwork for a `.list()` configuration, a ComputationGraph for a
graph. `initPretrained()` needs a local checkpoint, as the port fetches
nothing over a network.
"""
from __future__ import annotations

import os

from deeplearning4j_tpu_torch.nn.conf.builders import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph_builder import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph_vertices import ElementWiseVertex
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.graph_vertices import MergeVertex
from deeplearning4j_tpu_torch.nn.conf.layers import (ActivationLayer,
                                                     BatchNormalization,
                                                     ConvolutionLayer,
                                                     DenseLayer, DropoutLayer,
                                                     GlobalPoolingLayer,
                                                     LossLayer, OutputLayer,
                                                     SubsamplingLayer,
                                                     Upsampling2D)
from deeplearning4j_tpu_torch.nn.conf.objdetect import Yolo2OutputLayer
from deeplearning4j_tpu_torch.nn.conf.recurrent import LSTM, RnnOutputLayer
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updaters import Adam, Nesterovs


class ZooModel:
    """Base surface (≡ org.deeplearning4j.zoo.ZooModel)."""

    def __init__(self, numClasses=1000, seed=123, inputShape=None,
                 updater=None, dataType="float32"):
        self.numClasses = int(numClasses)
        self.seed = int(seed)
        self.inputShape = inputShape or self.DEFAULT_INPUT
        self.updater = updater
        self.dataType = dataType

    DEFAULT_INPUT = (224, 224, 3)

    def conf(self):
        raise NotImplementedError

    def init(self, device=None):
        """The network of `conf()`, initialised from the seed on `device`
        (default: the card)."""
        conf = self.conf()
        if isinstance(conf, ComputationGraphConfiguration):
            return ComputationGraph(conf).init(device)
        return MultiLayerNetwork(conf).init(device)

    #: directory scanned for local pretrained checkpoints
    PRETRAINED_DIR_ENV = "DL4J_TPU_PRETRAINED_DIR"

    def _pretrained_path(self, dataset):
        d = os.environ.get(self.PRETRAINED_DIR_ENV, "")
        if not d:
            return None
        name = type(self).__name__.lower()
        for ext in (".zip", ".h5"):
            p = os.path.join(d, f"{name}_{str(dataset).lower()}{ext}")
            if os.path.exists(p):
                return p
        return None

    def initPretrained(self, dataset="imagenet", path=None, device=None):
        """Initialize with REAL trained weights from a LOCAL checkpoint
        (≡ ZooModel.initPretrained; the reference downloads from its zoo
        bucket — this environment has no egress, so the file must already
        exist: pass `path=` or set $DL4J_TPU_PRETRAINED_DIR). A
        ModelSerializer zip (either package's) restores through
        `ModelSerializer.restoreModel` onto `device` (the card unless told
        "cpu"); a Keras .h5 weight file loads by layer name onto this zoo
        configuration's layers, initialised on `device` (conv kernels are
        HWIO in both: no layout transpose)."""
        path = path or self._pretrained_path(dataset)
        if path is None:
            raise RuntimeError(
                f"No local pretrained checkpoint for "
                f"{type(self).__name__}/{dataset}: pass path= or put "
                f"<model>_<dataset>.zip/.h5 under "
                f"${self.PRETRAINED_DIR_ENV} (no network egress).")
        if str(path).endswith(".h5"):
            net = self.init(device=device)
            from deeplearning4j_tpu_torch.keras_import.keras_import import (
                _load_h5_weights_graph, _load_h5_weights_multilayer)
            if isinstance(net, ComputationGraph):
                net = _load_h5_weights_graph(net, path)
            else:
                net = _load_h5_weights_multilayer(net, path)
            if getattr(net, "_h5_layers_loaded", 0) == 0:
                raise RuntimeError(
                    f"{path}: no layer names in the .h5 match this "
                    f"{type(self).__name__} config — refusing to return a "
                    f"random-init network as 'pretrained'. (Our layers are "
                    f"named layer0..layerN unless set explicitly.)")
            return net
        from deeplearning4j_tpu_torch.util.model_serializer import \
            ModelSerializer
        return ModelSerializer.restoreModel(str(path), device=device)

    def pretrainedAvailable(self, dataset="imagenet"):
        return self._pretrained_path(dataset) is not None


class LeNet(ZooModel):
    """≡ zoo.model.LeNet — the classic MNIST CNN."""

    DEFAULT_INPUT = (28, 28, 1)

    def conf(self):
        h, w, c = self.inputShape
        return (NeuralNetConfiguration.Builder()
                .seed(self.seed)
                .updater(self.updater or Nesterovs(0.01, 0.9))
                .weightInit("xavier")
                .dataType(self.dataType)
                .list()
                .layer(ConvolutionLayer(kernelSize=(5, 5), stride=(1, 1),
                                        nOut=20, activation="identity",
                                        convolutionMode="same"))
                .layer(SubsamplingLayer(poolingType="max", kernelSize=(2, 2),
                                        stride=(2, 2)))
                .layer(ConvolutionLayer(kernelSize=(5, 5), stride=(1, 1),
                                        nOut=50, activation="identity",
                                        convolutionMode="same"))
                .layer(SubsamplingLayer(poolingType="max", kernelSize=(2, 2),
                                        stride=(2, 2)))
                .layer(DenseLayer(nOut=500, activation="relu"))
                .layer(OutputLayer(lossFunction="negativeloglikelihood",
                                   nOut=self.numClasses,
                                   activation="softmax"))
                .setInputType(InputType.convolutional(h, w, c))
                .build())


class SimpleCNN(ZooModel):
    """≡ zoo.model.SimpleCNN."""

    DEFAULT_INPUT = (48, 48, 3)

    def conf(self):
        h, w, c = self.inputShape
        return (NeuralNetConfiguration.Builder()
                .seed(self.seed)
                .updater(self.updater or Adam(1e-3))
                .weightInit("relu")
                .activation("relu")
                .dataType(self.dataType)
                .list()
                .layer(ConvolutionLayer(kernelSize=(7, 7), nOut=16,
                                        convolutionMode="same"))
                .layer(BatchNormalization())
                .layer(SubsamplingLayer(kernelSize=(2, 2), stride=(2, 2)))
                .layer(ConvolutionLayer(kernelSize=(5, 5), nOut=32,
                                        convolutionMode="same"))
                .layer(BatchNormalization())
                .layer(SubsamplingLayer(kernelSize=(2, 2), stride=(2, 2)))
                .layer(ConvolutionLayer(kernelSize=(3, 3), nOut=64,
                                        convolutionMode="same"))
                .layer(BatchNormalization())
                .layer(SubsamplingLayer(kernelSize=(2, 2), stride=(2, 2)))
                .layer(DenseLayer(nOut=128))
                .layer(DropoutLayer(dropOut=0.5))
                .layer(OutputLayer(lossFunction="mcxent",
                                   nOut=self.numClasses,
                                   activation="softmax"))
                .setInputType(InputType.convolutional(h, w, c))
                .build())


class AlexNet(ZooModel):
    """≡ zoo.model.AlexNet (one-tower variant)."""

    def conf(self):
        h, w, c = self.inputShape
        return (NeuralNetConfiguration.Builder()
                .seed(self.seed)
                .updater(self.updater or Nesterovs(1e-2, 0.9))
                .weightInit("relu")
                .activation("relu")
                .l2(5e-4)
                .dataType(self.dataType)
                .list()
                .layer(ConvolutionLayer(kernelSize=(11, 11), stride=(4, 4),
                                        nOut=96, convolutionMode="same"))
                .layer(BatchNormalization())
                .layer(SubsamplingLayer(kernelSize=(3, 3), stride=(2, 2)))
                .layer(ConvolutionLayer(kernelSize=(5, 5), nOut=256,
                                        convolutionMode="same"))
                .layer(BatchNormalization())
                .layer(SubsamplingLayer(kernelSize=(3, 3), stride=(2, 2)))
                .layer(ConvolutionLayer(kernelSize=(3, 3), nOut=384,
                                        convolutionMode="same"))
                .layer(ConvolutionLayer(kernelSize=(3, 3), nOut=384,
                                        convolutionMode="same"))
                .layer(ConvolutionLayer(kernelSize=(3, 3), nOut=256,
                                        convolutionMode="same"))
                .layer(SubsamplingLayer(kernelSize=(3, 3), stride=(2, 2)))
                .layer(DenseLayer(nOut=4096, dropOut=0.5))
                .layer(DenseLayer(nOut=4096, dropOut=0.5))
                .layer(OutputLayer(lossFunction="mcxent",
                                   nOut=self.numClasses,
                                   activation="softmax"))
                .setInputType(InputType.convolutional(h, w, c))
                .build())


class VGG16(ZooModel):
    """≡ zoo.model.VGG16."""

    def conf(self):
        h, w, c = self.inputShape
        b = (NeuralNetConfiguration.Builder()
             .seed(self.seed)
             .updater(self.updater or Nesterovs(1e-2, 0.9))
             .weightInit("relu")
             .activation("relu")
             .dataType(self.dataType)
             .list())
        plan = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
        for n_out, reps in plan:
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


class ResNet50(ZooModel):
    """≡ zoo.model.ResNet50 — bottleneck-v1 residual graph, built on the
    ComputationGraph DSL with ElementWiseVertex(Add) shortcuts; NHWC.
    Every 1×1 conv feeds only its BN, so the fusion pass marks 36 pairs
    (the `_a` and `_c` convs of 16 blocks and 4 shortcuts)."""

    def conf(self):
        h, w, c = self.inputShape
        g = (NeuralNetConfiguration.Builder()
             .seed(self.seed)
             .updater(self.updater or Nesterovs(1e-1, 0.9))
             .weightInit("relu")
             .dataType(self.dataType)
             .l2(1e-4)
             .graphBuilder()
             .addInputs("input")
             .setInputTypes(InputType.convolutional(h, w, c)))

        def conv_bn(name, inp, n_out, k, s, act="relu", s2d=1):
            g.addLayer(f"{name}_conv",
                       ConvolutionLayer(kernelSize=k, stride=s, nOut=n_out,
                                        convolutionMode="same",
                                        hasBias=False, spaceToDepth=s2d,
                                        activation="identity"), inp)
            g.addLayer(f"{name}_bn",
                       BatchNormalization(activation=act), f"{name}_conv")
            return f"{name}_bn"

        def bottleneck(name, inp, filters, stride, downsample):
            f1, f2, f3 = filters
            x = conv_bn(f"{name}_a", inp, f1, (1, 1), stride)
            x = conv_bn(f"{name}_b", x, f2, (3, 3), (1, 1))
            x = conv_bn(f"{name}_c", x, f3, (1, 1), (1, 1), act="identity")
            if downsample:
                sc = conv_bn(f"{name}_sc", inp, f3, (1, 1), stride,
                             act="identity")
            else:
                sc = inp
            g.addVertex(f"{name}_add", ElementWiseVertex("add"), x, sc)
            g.addLayer(f"{name}_relu", ActivationLayer(activation="relu"),
                       f"{name}_add")
            return f"{name}_relu"

        # the stem keeps the JAX package's space-to-depth field (a TPU
        # form of the same conv; the port computes the plain conv)
        x = conv_bn("stem", "input", 64, (7, 7), (2, 2),
                    s2d=2 if h % 2 == 0 and w % 2 == 0 else 1)
        g.addLayer("stem_pool",
                   SubsamplingLayer(poolingType="max", kernelSize=(3, 3),
                                    stride=(2, 2), convolutionMode="same"), x)
        x = "stem_pool"
        stages = [
            ("res2", (64, 64, 256), 3, (1, 1)),
            ("res3", (128, 128, 512), 4, (2, 2)),
            ("res4", (256, 256, 1024), 6, (2, 2)),
            ("res5", (512, 512, 2048), 3, (2, 2)),
        ]
        for sname, filters, blocks, stride in stages:
            x = bottleneck(f"{sname}_0", x, filters, stride, True)
            for i in range(1, blocks):
                x = bottleneck(f"{sname}_{i}", x, filters, (1, 1), False)
        g.addLayer("avgpool", GlobalPoolingLayer(poolingType="avg"), x)
        g.addLayer("fc", OutputLayer(lossFunction="mcxent",
                                     nOut=self.numClasses,
                                     activation="softmax"), "avgpool")
        g.setOutputs("fc")
        return g.build()


class UNet(ZooModel):
    """≡ zoo.model.UNet — encoder/decoder with skip connections
    (MergeVertex concat), sigmoid pixel output."""

    DEFAULT_INPUT = (128, 128, 3)

    def conf(self):
        h, w, c = self.inputShape
        g = (NeuralNetConfiguration.Builder()
             .seed(self.seed)
             .updater(self.updater or Adam(1e-3))
             .weightInit("relu")
             .activation("relu")
             .dataType(self.dataType)
             .graphBuilder()
             .addInputs("input")
             .setInputTypes(InputType.convolutional(h, w, c)))

        def double_conv(name, inp, n_out):
            g.addLayer(f"{name}_c1", ConvolutionLayer(
                kernelSize=(3, 3), nOut=n_out, convolutionMode="same"), inp)
            g.addLayer(f"{name}_c2", ConvolutionLayer(
                kernelSize=(3, 3), nOut=n_out, convolutionMode="same"),
                f"{name}_c1")
            return f"{name}_c2"

        d1 = double_conv("down1", "input", 32)
        g.addLayer("pool1", SubsamplingLayer(kernelSize=(2, 2),
                                             stride=(2, 2)), d1)
        d2 = double_conv("down2", "pool1", 64)
        g.addLayer("pool2", SubsamplingLayer(kernelSize=(2, 2),
                                             stride=(2, 2)), d2)
        mid = double_conv("mid", "pool2", 128)
        g.addLayer("up2", Upsampling2D(size=2), mid)
        g.addVertex("cat2", MergeVertex(), "up2", d2)
        u2 = double_conv("dec2", "cat2", 64)
        g.addLayer("up1", Upsampling2D(size=2), u2)
        g.addVertex("cat1", MergeVertex(), "up1", d1)
        u1 = double_conv("dec1", "cat1", 32)
        g.addLayer("outconv", ConvolutionLayer(kernelSize=(1, 1), nOut=1,
                                               activation="identity",
                                               convolutionMode="same"), u1)
        g.addLayer("out", LossLayer(lossFunction="xent",
                                    activation="sigmoid"), "outconv")
        g.setOutputs("out")
        return g.build()


def _resolve_priors(boxes, defaults):
    """boxes: None → all default priors; int n → first n defaults;
    list of [w, h] → explicit priors."""
    if boxes is None:
        return defaults
    if isinstance(boxes, int):
        if not 1 <= boxes <= len(defaults):
            raise ValueError(
                f"boxes={boxes}: pass 1..{len(defaults)} to subset the "
                "default priors, or an explicit [[w, h], ...] list")
        return defaults[:boxes]
    return [list(map(float, b)) for b in boxes]


class TinyYOLO(ZooModel):
    """≡ zoo.model.TinyYOLO — Darknet-style backbone + Yolo2OutputLayer
    (anchor-box YOLOv2 loss) with the reference's VOC box priors; a
    `.list()` model, so `init()` gives a MultiLayerNetwork."""

    DEFAULT_INPUT = (416, 416, 3)
    PRIORS = [[1.08, 1.19], [3.42, 4.41], [6.63, 11.38],
              [9.42, 5.11], [16.62, 10.52]]

    def __init__(self, numClasses=20, boxes=None, **kw):
        super().__init__(numClasses=numClasses, **kw)
        self.priors = _resolve_priors(boxes, self.PRIORS)
        self.boxes = len(self.priors)

    def conf(self):
        h, w, c = self.inputShape
        b = (NeuralNetConfiguration.Builder()
             .seed(self.seed)
             .updater(self.updater or Adam(1e-3))
             .weightInit("relu")
             .dataType(self.dataType)
             .list())
        n_out = 16
        for _ in range(5):
            b.layer(ConvolutionLayer(kernelSize=(3, 3), nOut=n_out,
                                     convolutionMode="same", hasBias=False,
                                     activation="identity"))
            b.layer(BatchNormalization(activation="leakyrelu"))
            b.layer(SubsamplingLayer(kernelSize=(2, 2), stride=(2, 2)))
            n_out *= 2
        b.layer(ConvolutionLayer(kernelSize=(3, 3), nOut=512,
                                 convolutionMode="same", hasBias=False,
                                 activation="identity"))
        b.layer(BatchNormalization(activation="leakyrelu"))
        b.layer(ConvolutionLayer(kernelSize=(3, 3), nOut=1024,
                                 convolutionMode="same", hasBias=False,
                                 activation="identity"))
        b.layer(BatchNormalization(activation="leakyrelu"))
        head_out = self.boxes * (5 + self.numClasses)
        b.layer(ConvolutionLayer(kernelSize=(1, 1), nOut=head_out,
                                 convolutionMode="same",
                                 activation="identity"))
        b.layer(Yolo2OutputLayer(boundingBoxes=self.priors))
        return b.setInputType(InputType.convolutional(h, w, c)).build()


class TextGenerationLSTM(ZooModel):
    """≡ zoo.model.TextGenerationLSTM — char-RNN: two stacked LSTMs and a
    per-step softmax (the GravesLSTM char-modelling baseline
    configuration: 77 classes, LSTM(256) × 2, ~0.89 M parameters)."""

    def __init__(self, numClasses=77, lstmLayerSize=256, scanUnroll=1,
                 **kw):
        kw.setdefault("inputShape", (None, numClasses))
        super().__init__(numClasses=numClasses, **kw)
        self.lstmLayerSize = lstmLayerSize
        self.scanUnroll = int(scanUnroll)

    DEFAULT_INPUT = (None, 77)

    def conf(self):
        return (NeuralNetConfiguration.Builder()
                .seed(self.seed)
                .updater(self.updater or Adam(1e-2))
                .weightInit("xavier")
                .dataType(self.dataType)
                .list()
                .layer(LSTM(nOut=self.lstmLayerSize, activation="tanh",
                            scanUnroll=self.scanUnroll))
                .layer(LSTM(nOut=self.lstmLayerSize, activation="tanh",
                            scanUnroll=self.scanUnroll))
                .layer(RnnOutputLayer(lossFunction="mcxent",
                                      nOut=self.numClasses,
                                      activation="softmax"))
                .setInputType(InputType.recurrent(self.numClasses))
                .build())

    def generationServer(self, net=None, **kw):
        """Serve this char-RNN token by token through `GenerationServer`
        (a `RecurrentDecoder` over the net's carries):

            srv = TextGenerationLSTM().generationServer(
                slots=8, cache_lengths=[512], method="top_k", top_k=5)
            srv.warmup()

        `net`: a trained network (default: a fresh `init()` on the card).
        The other keywords go to GenerationServer."""
        from deeplearning4j_tpu_torch.generation.server import \
            GenerationServer
        return GenerationServer(net if net is not None else self.init(),
                                **kw)
