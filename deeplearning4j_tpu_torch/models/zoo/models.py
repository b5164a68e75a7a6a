"""Model zoo: the port of `ZooModel` and `ResNet50` of
`deeplearning4j_tpu/models/zoo/models.py` (≡ deeplearning4j-zoo ::
org.deeplearning4j.zoo.model.*).

The models build through the same public config DSL a user would write.
`ResNet50(numClasses=...).init()` returns the network on the card (or on
`device`); `initPretrained()` needs a local checkpoint, as this
environment has no network. The other zoo models come later (ROADMAP
A11).
"""
from __future__ import annotations

import os

from deeplearning4j_tpu_torch.nn.conf.builders import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph_builder import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph_vertices import ElementWiseVertex
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (ActivationLayer,
                                                     BatchNormalization,
                                                     ConvolutionLayer,
                                                     GlobalPoolingLayer,
                                                     OutputLayer,
                                                     SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.updaters import Nesterovs


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
        raise NotImplementedError(
            "MultiLayerNetwork comes with ROADMAP A10")

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

    def initPretrained(self, dataset="imagenet", path=None):
        """Initialize with REAL trained weights from a LOCAL checkpoint
        (≡ ZooModel.initPretrained; the reference downloads from its zoo
        bucket — this environment has no egress, so the file must already
        exist: pass `path=` or set $DL4J_TPU_PRETRAINED_DIR). Reading the
        checkpoint formats comes with ROADMAP A12; weights held by the
        JAX package carry across with `nn.graph_params_from_numpy`."""
        path = path or self._pretrained_path(dataset)
        if path is None:
            raise RuntimeError(
                f"No local pretrained checkpoint for "
                f"{type(self).__name__}/{dataset}: pass path= or put "
                f"<model>_<dataset>.zip/.h5 under "
                f"${self.PRETRAINED_DIR_ENV} (no network egress).")
        raise NotImplementedError(
            f"{path}: the ModelSerializer zip and Keras .h5 readers come "
            "with ROADMAP A12")

    def pretrainedAvailable(self, dataset="imagenet"):
        return self._pretrained_path(dataset) is not None


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
