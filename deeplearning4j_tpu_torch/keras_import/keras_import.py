"""Keras model import: the port of
`deeplearning4j_tpu/keras_import/keras_import.py` (≡
deeplearning4j-modelimport :: KerasModelImport, KerasSequentialModel,
KerasModel).

Parses Keras JSON configs (Sequential and Functional) into the port's
builder DSL — the import produces the SAME MultiLayerConfiguration /
ComputationGraphConfiguration a user would write by hand, so an imported
model trains and serves on the port's own path (the conv1x1+BN fusion,
the CUDA graphs). Weights load from Keras .h5 files through h5py, which
is imported only when a weights path is given. Layouts match natively:
the port's layers keep the JAX package's NHWC activations and HWIO
kernels, so a Keras kernel loads as it is, apart from the reshapes the
reference makes too (`_resolve_depthwise`, `_remap_lstm_gates`, the
transposed convolutions). Every entry point builds the network on the
card unless the caller passes `device="cpu"`.

`ModelGuesser` and `ZooModel.initPretrained` also read a whole-model .h5
(Keras's `model.save`): its architecture JSON is the file's
`model_config` attribute (`importKerasModelFromH5`).
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.conf.builders import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph_vertices import (ElementWiseVertex,
                                                       MergeVertex)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (ActivationLayer,
                                               BatchNormalization,
                                               Convolution1DLayer,
                                               ConvolutionLayer, Cropping2D,
                                               DenseLayer,
                                               DepthwiseConvolution2D,
                                               DropoutLayer, EmbeddingLayer,
                                               GlobalPoolingLayer,
                                               OutputLayer, PReLULayer,
                                               SeparableConvolution2D,
                                               Subsampling1DLayer,
                                               SubsamplingLayer, Upsampling2D,
                                               ZeroPaddingLayer)
from deeplearning4j_tpu_torch.nn.conf.recurrent import LSTM, RnnOutputLayer, SimpleRnn
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

_ACTIVATIONS = {
    "linear": "identity", "relu": "relu", "relu6": "relu6",
    "sigmoid": "sigmoid", "tanh": "tanh", "softmax": "softmax",
    "elu": "elu", "selu": "selu", "softplus": "softplus",
    "softsign": "softsign", "hard_sigmoid": "hardsigmoid",
    "swish": "swish", "silu": "swish", "gelu": "gelu",
    "leaky_relu": "leakyrelu", "exponential": "exp", "mish": "mish",
}

_INITIALIZERS = {
    "GlorotUniform": "xavier_uniform", "glorot_uniform": "xavier_uniform",
    "GlorotNormal": "xavier", "glorot_normal": "xavier",
    "HeNormal": "relu", "he_normal": "relu",
    "HeUniform": "relu_uniform", "he_uniform": "relu_uniform",
    "LecunNormal": "lecun", "lecun_normal": "lecun",
    "LecunUniform": "lecun_uniform", "lecun_uniform": "lecun_uniform",
    "RandomNormal": "normal", "random_normal": "normal",
    "RandomUniform": "uniform", "random_uniform": "uniform",
    "Zeros": "zero", "zeros": "zero", "Ones": "ones", "ones": "ones",
}


class InvalidKerasConfigurationException(ValueError):
    """≡ modelimport.keras.exceptions.InvalidKerasConfigurationException."""


def _map_activation(name):
    if name is None:
        return "identity"
    act = _ACTIVATIONS.get(name)
    if act is None:
        raise InvalidKerasConfigurationException(
            f"Unsupported Keras activation: {name!r}")
    return act


def _map_init(cfg):
    if not cfg:
        return "xavier_uniform"
    name = cfg.get("class_name", cfg) if isinstance(cfg, dict) else cfg
    return _INITIALIZERS.get(name, "xavier_uniform")


def _loss_for_activation(act):
    """No training_config in a bare architecture JSON → pick the loss the
    reference's enforceTrainingConfig=false path would allow fine-tuning
    with: softmax→MCXENT, sigmoid→XENT, else MSE."""
    return {"softmax": "mcxent", "sigmoid": "xent"}.get(act, "mse")


def _keras_input_type(batch_shape):
    dims = [d for d in batch_shape[1:]]
    if len(dims) == 4:
        # volumetric NDHWC (channels_last, like all our conv layouts)
        return InputType.convolutional3D(dims[0], dims[1], dims[2], dims[3])
    if len(dims) == 3:
        return InputType.convolutional(dims[0], dims[1], dims[2])
    if len(dims) == 2:
        # keep the static sequence length when keras declares one —
        # length-dependent layers (LocallyConnected1D) need it
        return InputType.recurrent(dims[1], dims[0])
    if len(dims) == 1:
        return InputType.feedForward(dims[0])
    raise InvalidKerasConfigurationException(
        f"Unsupported input shape: {batch_shape}")


#: custom Keras layer converters (≡ KerasLayer.registerCustomLayer): maps a
#: Keras class_name to a callable (config_dict, is_last) -> Layer — the hook
#: user-defined SameDiffLayer subclasses ride in on
_CUSTOM_LAYER_CONVERTERS = {}


def registerCustomLayer(class_name, converter):
    """Register a converter for an unsupported Keras layer type.
    `converter(cfg: dict, is_last: bool) -> Layer` (typically returning a
    user SameDiffLayer subclass from nn.conf.samediff_layers)."""
    if not callable(converter):
        raise TypeError("converter must be callable: (cfg, is_last) -> Layer")
    _CUSTOM_LAYER_CONVERTERS[str(class_name)] = converter


def clearCustomLayers():
    _CUSTOM_LAYER_CONVERTERS.clear()


#: Lambda implementations by Keras layer NAME (≡ modelimport.keras ::
#: KerasLambda): Keras JSON stores only marshaled Python for Lambda
#: layers, so the reference requires the user to register the
#: implementation before import — same contract here.
_LAMBDA_IMPLS = {}


def registerLambda(layer_name, fn):
    """Register the implementation for a Keras Lambda layer by its layer
    name: fn(x) -> tensor (a torch function). Must be called before
    importing a model whose JSON contains that Lambda."""
    if not callable(fn):
        raise TypeError("fn must be a callable (a torch function)")
    _LAMBDA_IMPLS[str(layer_name)] = fn


def clearLambdas():
    _LAMBDA_IMPLS.clear()


def _convert_layer(class_name, cfg, is_last=False):
    """One Keras layer config → our layer instance (or None to skip)."""
    if class_name in _CUSTOM_LAYER_CONVERTERS:
        return _CUSTOM_LAYER_CONVERTERS[class_name](cfg, is_last)
    act = _map_activation(cfg.get("activation", "linear"))
    init = _map_init(cfg.get("kernel_initializer"))
    bias = cfg.get("use_bias", True)

    if class_name == "Dense":
        if is_last:
            return OutputLayer(nOut=cfg["units"], activation=act,
                               lossFunction=_loss_for_activation(act),
                               weightInit=init, hasBias=bias)
        return DenseLayer(nOut=cfg["units"], activation=act,
                          weightInit=init, hasBias=bias)
    if class_name in ("Conv2D", "Convolution2D"):
        return ConvolutionLayer(
            nOut=cfg["filters"], kernelSize=tuple(cfg["kernel_size"]),
            stride=tuple(cfg.get("strides", (1, 1))),
            convolutionMode=cfg.get("padding", "valid"),
            activation=act, weightInit=init, hasBias=bias)
    if class_name == "SeparableConv2D":
        return SeparableConvolution2D(
            nOut=cfg["filters"], kernelSize=tuple(cfg["kernel_size"]),
            stride=tuple(cfg.get("strides", (1, 1))),
            convolutionMode=cfg.get("padding", "valid"),
            activation=act, weightInit=init, hasBias=bias)
    if class_name in ("MaxPooling2D", "AveragePooling2D"):
        pool = "max" if class_name.startswith("Max") else "avg"
        size = tuple(cfg.get("pool_size", (2, 2)))
        return SubsamplingLayer(
            poolingType=pool, kernelSize=size,
            stride=tuple(cfg.get("strides") or size),
            convolutionMode=cfg.get("padding", "valid"))
    if class_name in ("GlobalAveragePooling2D", "GlobalMaxPooling2D",
                      "GlobalAveragePooling1D", "GlobalMaxPooling1D"):
        return GlobalPoolingLayer(
            poolingType="avg" if "Average" in class_name else "max")
    if class_name == "BatchNormalization":
        return BatchNormalization(eps=cfg.get("epsilon", 1e-3),
                                  decay=cfg.get("momentum", 0.99))
    if class_name == "Dropout":
        return DropoutLayer(dropOut=1.0 - float(cfg.get("rate", 0.5)))
    if class_name == "Activation":
        return ActivationLayer(activation=act)
    if class_name == "ZeroPadding2D":
        pad = cfg.get("padding", 1)
        return ZeroPaddingLayer(padding=pad)
    if class_name == "UpSampling2D":
        size = cfg.get("size", (2, 2))
        return Upsampling2D(size=size[0] if isinstance(
            size, (list, tuple)) else size)
    if class_name == "Embedding":
        return EmbeddingLayer(nIn=cfg["input_dim"], nOut=cfg["output_dim"])
    if class_name == "LSTM":
        if is_last:
            return RnnOutputLayer(nOut=cfg["units"], activation=act,
                                  lossFunction=_loss_for_activation(act))
        return LSTM(nOut=cfg["units"], activation=act,
                    gateActivationFn=_map_activation(
                        cfg.get("recurrent_activation", "sigmoid")),
                    weightInit=init)
    if class_name == "SimpleRNN":
        return SimpleRnn(nOut=cfg["units"], activation=act, weightInit=init)
    if class_name == "DepthwiseConv2D":
        # keras spells the initializer 'depthwise_initializer' here
        dw_init = _map_init(cfg.get("depthwise_initializer")
                            or cfg.get("kernel_initializer"))
        return DepthwiseConvolution2D(
            depthMultiplier=int(cfg.get("depth_multiplier", 1)),
            kernelSize=tuple(cfg["kernel_size"]),
            stride=tuple(cfg.get("strides", (1, 1))),
            convolutionMode=cfg.get("padding", "valid"),
            activation=act, weightInit=dw_init, hasBias=bias)
    if class_name == "Cropping2D":
        return Cropping2D(cropping=cfg.get("cropping", ((0, 0), (0, 0))))
    if class_name == "UpSampling1D":
        from deeplearning4j_tpu_torch.nn.conf.layers import Upsampling1D
        return Upsampling1D(size=int(cfg.get("size", 2)))
    if class_name == "TimeDistributed":
        # our Dense/Output layers already broadcast over (B, T, F); unwrap
        # the inner layer (≡ KerasTimeDistributed flattening to the wrapped
        # layer with RNN format preserved)
        inner = cfg.get("layer") or {}
        return _convert_layer(inner.get("class_name"),
                              inner.get("config", {}), is_last=is_last)
    if class_name in ("SpatialDropout2D", "SpatialDropout1D"):
        # real channel-wise dropout (≡ KerasSpatialDropout): whole feature
        # maps drop together; keras rate = drop prob, ours = retain
        from deeplearning4j_tpu_torch.nn.dropout import SpatialDropout
        return DropoutLayer(
            dropOut=SpatialDropout(1.0 - float(cfg.get("rate", 0.5))))
    if class_name == "LocallyConnected2D":
        from deeplearning4j_tpu_torch.nn.conf.special_layers import \
            LocallyConnected2D
        return LocallyConnected2D(
            nOut=cfg["filters"], kernelSize=tuple(cfg["kernel_size"]),
            stride=tuple(cfg.get("strides", (1, 1))),
            convolutionMode=cfg.get("padding", "valid"),
            activation=act, weightInit=init, hasBias=bias)
    if class_name == "LocallyConnected1D":
        from deeplearning4j_tpu_torch.nn.conf.special_layers import \
            LocallyConnected1D
        ks = cfg["kernel_size"]
        st = cfg.get("strides", 1)
        return LocallyConnected1D(
            nOut=cfg["filters"],
            kernelSize=ks[0] if isinstance(ks, (list, tuple)) else ks,
            stride=st[0] if isinstance(st, (list, tuple)) else st,
            convolutionMode=cfg.get("padding", "valid"),
            activation=act, weightInit=init, hasBias=bias)
    if class_name == "Permute":
        from deeplearning4j_tpu_torch.nn.conf.special_layers import PermuteLayer
        return PermuteLayer(dims=tuple(cfg["dims"]))
    if class_name == "Lambda":
        fn = _LAMBDA_IMPLS.get(cfg.get("name"))
        if fn is None:
            raise InvalidKerasConfigurationException(
                f"Lambda layer {cfg.get('name')!r}: Keras JSON stores only "
                "marshaled Python for Lambda layers, so the implementation "
                "must be supplied at import time — call "
                "registerLambda(name, fn) first (≡ the reference's "
                "KerasLambda contract), or registerCustomLayer('Lambda', "
                "converter) for full control")
        from deeplearning4j_tpu_torch.nn.conf.samediff_layers import \
            SameDiffLambdaLayer
        return SameDiffLambdaLayer(fn=fn)
    if class_name == "Bidirectional":
        inner_cfg = cfg.get("layer") or {}
        inner = _convert_layer(inner_cfg.get("class_name"),
                               inner_cfg.get("config", {}))
        from deeplearning4j_tpu_torch.nn.conf.recurrent import Bidirectional
        mm = cfg.get("merge_mode", "concat")
        modes = {"concat": "concat", "sum": "add", "ave": "average",
                 "mul": "mul"}
        if mm not in modes:
            # merge_mode=None returns TWO sequences in Keras — structurally
            # different; refuse rather than silently concat
            raise InvalidKerasConfigurationException(
                f"Bidirectional merge_mode={mm!r} unsupported (use "
                "concat/sum/ave/mul)")
        return Bidirectional(layer=inner, mode=modes[mm])
    if class_name == "Conv1D":
        return Convolution1DLayer(
            nOut=cfg["filters"],
            kernelSize=(cfg["kernel_size"][0]
                        if isinstance(cfg.get("kernel_size"), (list, tuple))
                        else cfg.get("kernel_size", 3)),
            stride=(cfg.get("strides", [1])[0]
                    if isinstance(cfg.get("strides"), (list, tuple))
                    else cfg.get("strides", 1)),
            convolutionMode=cfg.get("padding", "valid"),
            activation=act, weightInit=init, hasBias=bias)
    if class_name in ("MaxPooling1D", "AveragePooling1D"):
        pool = "max" if class_name.startswith("Max") else "avg"
        size = cfg.get("pool_size", 2)
        size = size[0] if isinstance(size, (list, tuple)) else size
        stride = cfg.get("strides") or size
        stride = stride[0] if isinstance(stride, (list, tuple)) else stride
        return Subsampling1DLayer(poolingType=pool, kernelSize=int(size),
                                  stride=int(stride),
                                  convolutionMode=cfg.get("padding", "valid"))
    if class_name in ("Conv2DTranspose", "Conv3DTranspose"):
        # refuse silently-shape-changing options rather than approximate
        # (same policy as Bidirectional merge_mode=None)
        op = cfg.get("output_padding")
        if op is not None and any(int(v) != 0 for v in
                                  (op if isinstance(op, (list, tuple))
                                   else [op])):
            raise InvalidKerasConfigurationException(
                f"{class_name} output_padding={op!r} unsupported — output "
                "shape would silently differ from the source model")
        dil = cfg.get("dilation_rate", 1)
        if any(int(v) != 1 for v in
               (dil if isinstance(dil, (list, tuple)) else [dil])):
            raise InvalidKerasConfigurationException(
                f"{class_name} dilation_rate={dil!r} unsupported")
        if class_name == "Conv2DTranspose":
            from deeplearning4j_tpu_torch.nn.conf.layers import Deconvolution2D
            return Deconvolution2D(
                nOut=cfg["filters"], kernelSize=tuple(cfg["kernel_size"]),
                stride=tuple(cfg.get("strides", (1, 1))),
                convolutionMode=cfg.get("padding", "valid"),
                activation=act, weightInit=init, hasBias=bias)
        from deeplearning4j_tpu_torch.nn.conf.layers3d import Deconvolution3D
        return Deconvolution3D(
            nOut=cfg["filters"], kernelSize=tuple(cfg["kernel_size"]),
            stride=tuple(cfg.get("strides", (1, 1, 1))),
            convolutionMode=cfg.get("padding", "valid"),
            activation=act, weightInit=init, hasBias=bias)
    if class_name == "Conv3D":
        from deeplearning4j_tpu_torch.nn.conf.layers3d import Convolution3D
        return Convolution3D(
            nOut=cfg["filters"], kernelSize=tuple(cfg["kernel_size"]),
            stride=tuple(cfg.get("strides", (1, 1, 1))),
            convolutionMode=cfg.get("padding", "valid"),
            activation=act, weightInit=init, hasBias=bias)
    if class_name in ("MaxPooling3D", "AveragePooling3D"):
        from deeplearning4j_tpu_torch.nn.conf.layers3d import Subsampling3DLayer
        pool = "max" if class_name.startswith("Max") else "avg"
        size = tuple(cfg.get("pool_size", (2, 2, 2)))
        return Subsampling3DLayer(
            poolingType=pool, kernelSize=size,
            stride=tuple(cfg.get("strides") or size),
            convolutionMode=cfg.get("padding", "valid"))
    if class_name == "UpSampling3D":
        from deeplearning4j_tpu_torch.nn.conf.layers3d import Upsampling3D
        return Upsampling3D(size=tuple(cfg.get("size", (2, 2, 2))))
    if class_name == "ZeroPadding3D":
        # the layer constructor normalizes all three Keras spellings
        from deeplearning4j_tpu_torch.nn.conf.layers3d import ZeroPadding3DLayer
        return ZeroPadding3DLayer(padding=cfg.get("padding", 1))
    if class_name == "Cropping3D":
        from deeplearning4j_tpu_torch.nn.conf.layers3d import Cropping3D
        return Cropping3D(cropping=cfg.get("cropping", 0))
    if class_name == "LeakyReLU":
        # Keras default alpha is 0.3 (ours is 0.01) — carry it explicitly
        alpha = float(cfg.get("alpha", 0.3))
        return ActivationLayer(activation=f"leakyrelu:{alpha}")
    if class_name == "ELU":
        return ActivationLayer(activation="elu")
    if class_name == "ThresholdedReLU":
        return ActivationLayer(
            activation=f"thresholdedrelu:{float(cfg.get('theta', 1.0))}")
    if class_name == "ReLU":
        mv = cfg.get("max_value")
        neg = float(cfg.get("negative_slope", 0.0) or 0.0)
        thr = float(cfg.get("threshold", 0.0) or 0.0)
        if thr != 0.0 or (mv is not None and neg != 0.0):
            raise InvalidKerasConfigurationException(
                f"ReLU(max_value={mv}, negative_slope={neg}, "
                f"threshold={thr}) has no exact equivalent here")
        if neg != 0.0:
            return ActivationLayer(activation=f"leakyrelu:{neg}")
        if mv is not None:
            return ActivationLayer(activation=f"relucap:{float(mv)}")
        return ActivationLayer(activation="relu")
    if class_name == "PReLU":
        return PReLULayer()
    if class_name == "GaussianDropout":
        from deeplearning4j_tpu_torch.nn.dropout import GaussianDropout
        return DropoutLayer(dropOut=GaussianDropout(
            float(cfg.get("rate", 0.5))))
    if class_name == "GaussianNoise":
        from deeplearning4j_tpu_torch.nn.dropout import GaussianNoise
        return DropoutLayer(dropOut=GaussianNoise(
            float(cfg.get("stddev", 0.1))))
    if class_name in ("Flatten", "Reshape", "InputLayer"):
        return None  # shape plumbing — the builder's InputType inference
    raise InvalidKerasConfigurationException(
        f"Unsupported Keras layer: {class_name}")


def _load_json(path_or_json):
    if isinstance(path_or_json, dict):
        return path_or_json
    s = str(path_or_json)
    if os.path.exists(s):
        with open(s) as f:
            return json.load(f)
    return json.loads(s)


class KerasModelImport:
    @staticmethod
    def importKerasSequentialConfiguration(path_or_json, inputType=None):
        """Sequential architecture JSON → MultiLayerConfiguration."""
        model = _load_json(path_or_json)
        if model.get("class_name") != "Sequential":
            raise InvalidKerasConfigurationException(
                f"Not a Sequential model: {model.get('class_name')}")
        layer_cfgs = model["config"]
        if isinstance(layer_cfgs, dict):
            layer_cfgs = layer_cfgs["layers"]
        b = NeuralNetConfiguration.Builder().list()
        converted = []
        pending_mask_value = None  # from a Keras Masking layer
        for i, lc in enumerate(layer_cfgs):
            cls, cfg = lc["class_name"], lc.get("config", {})
            if inputType is None and (
                    "batch_input_shape" in cfg or "batch_shape" in cfg):
                inputType = _keras_input_type(
                    cfg.get("batch_input_shape") or cfg["batch_shape"])
            if cls == "Masking":
                # Keras Masking derives the time mask from in-band padding
                # and propagates it to downstream RNNs — our equivalent
                # wraps the NEXT recurrent layer in MaskZeroLayer
                pending_mask_value = float(cfg.get("mask_value", 0.0))
                continue
            layer = _convert_layer(cls, cfg,
                                   is_last=(i == len(layer_cfgs) - 1))
            if layer is None and pending_mask_value is not None:
                # Flatten/Reshape between Masking and the RNN would change
                # which values the derived mask keys off — refuse
                raise InvalidKerasConfigurationException(
                    "Masking must be immediately followed by a recurrent "
                    f"layer; found {cls}")
            if layer is not None:
                if pending_mask_value is not None:
                    # Masking must feed DIRECTLY into a recurrent layer —
                    # any intervening transform would change the in-band
                    # padding values the derived mask keys off
                    if not getattr(layer, "is_recurrent", False):
                        raise InvalidKerasConfigurationException(
                            "Masking must be immediately followed by a "
                            f"recurrent layer; found {cls}")
                    from deeplearning4j_tpu_torch.nn.conf.sequence_layers import \
                        MaskZeroLayer
                    layer = MaskZeroLayer(layer, pending_mask_value)
                    pending_mask_value = None
                layer.name = cfg.get("name", f"layer{i}")
                converted.append(layer)
                b.layer(layer)
        if pending_mask_value is not None:
            raise InvalidKerasConfigurationException(
                "Masking layer has no recurrent layer after it")
        if inputType is None:
            raise InvalidKerasConfigurationException(
                "No batch_input_shape in config; pass inputType=")
        return b.setInputType(inputType).build()

    @staticmethod
    def importKerasSequentialModelAndWeights(config_path, weights_path=None,
                                             inputType=None, device=None):
        """The network of a Sequential JSON, initialised on `device` (the
        card unless "cpu"), with the .h5 weights when a path is given."""
        conf = KerasModelImport.importKerasSequentialConfiguration(
            config_path, inputType)
        net = MultiLayerNetwork(conf).init(device=device)
        if weights_path is not None:
            _load_h5_weights_multilayer(net, weights_path)
        return net

    @staticmethod
    def importKerasModelConfiguration(path_or_json, inputTypes=None):
        """Functional-API JSON → ComputationGraphConfiguration."""
        model = _load_json(path_or_json)
        if model.get("class_name") not in ("Model", "Functional"):
            raise InvalidKerasConfigurationException(
                f"Not a functional model: {model.get('class_name')}")
        cfg = model["config"]
        g = NeuralNetConfiguration.Builder().graphBuilder()
        input_names, input_types = [], []
        layer_list = cfg["layers"]
        for lc in layer_list:
            cls, c, name = lc["class_name"], lc.get("config", {}), None
            name = c.get("name") or lc.get("name")
            inbound = _inbound_names(lc)
            if cls == "InputLayer":
                input_names.append(name)
                shape = c.get("batch_input_shape") or c.get("batch_shape")
                input_types.append(_keras_input_type(shape))
                continue
            is_output = any(name == (o[0] if isinstance(o, list) else o)
                            for o in _output_names(cfg))
            if cls in ("Add", "Subtract", "Multiply", "Average", "Maximum",
                       "Minimum"):
                op = {"Add": "add", "Subtract": "subtract",
                      "Multiply": "product", "Average": "average",
                      "Maximum": "max", "Minimum": "min"}[cls]
                g.addVertex(name, ElementWiseVertex(op), *inbound)
                continue
            if cls == "Concatenate":
                g.addVertex(name, MergeVertex(), *inbound)
                continue
            layer = _convert_layer(cls, c, is_last=is_output)
            if layer is None:
                if cls == "Flatten":
                    # real (B, ...) -> (B, prod) flatten: downstream
                    # layers must see a feed-forward type (a CNN input
                    # also rides the same reshape — NHWC order matches
                    # Keras channels_last)
                    g.addVertex(name, _FlattenVertex(), *inbound)
                else:   # Reshape/InputLayer: alias to input
                    g.addVertex(name, _IdentityAlias(), *inbound)
                continue
            g.addLayer(name, layer, *inbound)
        g.addInputs(*input_names)
        g.setInputTypes(*(inputTypes or input_types))
        g.setOutputs(*[o[0] if isinstance(o, list) else o
                       for o in _output_names(cfg)])
        return g.build()

    @staticmethod
    def importKerasModelAndWeights(config_path, weights_path=None,
                                   inputTypes=None, device=None):
        """The graph of a Functional JSON, initialised on `device` (the
        card unless "cpu"), with the .h5 weights when a path is given."""
        conf = KerasModelImport.importKerasModelConfiguration(
            config_path, inputTypes)
        net = ComputationGraph(conf).init(device=device)
        if weights_path is not None:
            _load_h5_weights_graph(net, weights_path)
        return net

    @staticmethod
    def importKerasModelFromH5(path, device=None):
        """A whole-model .h5 (Keras `model.save`): the architecture from
        the file's `model_config` attribute (Sequential or Functional),
        the weights from its `model_weights` group."""
        cfg = _h5_model_config(path)
        if cfg.get("class_name") == "Sequential":
            return KerasModelImport.importKerasSequentialModelAndWeights(
                cfg, path, device=device)
        return KerasModelImport.importKerasModelAndWeights(
            cfg, path, device=device)


def _inbound_names(layer_cfg):
    out = []
    for node in layer_cfg.get("inbound_nodes", []):
        if isinstance(node, dict):  # keras 3 style {"args": [...]}
            for a in node.get("args", []):
                out.extend(_extract_history(a))
        else:
            for ref in node:
                out.append(ref[0] if isinstance(ref, list) else ref)
    return out


def _extract_history(arg):
    if isinstance(arg, dict) and "config" in arg:
        kh = arg["config"].get("keras_history")
        if kh:
            return [kh[0]]
    if isinstance(arg, list):
        out = []
        for a in arg:
            out.extend(_extract_history(a))
        return out
    return []


def _output_names(cfg):
    outs = cfg.get("output_layers", [])
    return outs if isinstance(outs, list) else [outs]


class _IdentityAlias:
    """Pass-through vertex for Keras shape-only layers (Flatten/Reshape);
    our builder handles layout via input preprocessors."""

    def output_type(self, *input_types):
        return input_types[0]

    def apply(self, *xs, mask=None):
        return xs[0]

    def feed_forward_mask(self, *parent_masks):
        # the alias is a pure identity (Reshape/InputLayer): the tensor
        # and its time axis are unchanged, so the mask stays valid
        # (Flatten, which collapses the masked axis, has _FlattenVertex)
        return next((m for m in parent_masks if m is not None), None)


class _FlattenVertex:
    """Keras Flatten in the functional graph: (B, ...) -> (B, prod)."""

    def output_type(self, *input_types):
        import numpy as _np

        from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
        return InputType.feedForward(int(_np.prod(input_types[0].shape())))

    def apply(self, *xs, mask=None):
        x = xs[0]
        return x.reshape(x.shape[0], -1)

    def feed_forward_mask(self, *parent_masks):
        return None


# -- .h5 weight loading (h5py is imported here only) ----------------------
def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "reading Keras .h5 weights needs the h5py package, which is "
            "not installed") from e
    return h5py


def is_h5(path):
    """True when `path` is an HDF5 file (by its signature)."""
    try:
        with open(path, "rb") as f:
            return f.read(8) == b"\x89HDF\r\n\x1a\n"
    except (OSError, TypeError):
        return False


def _h5_model_config(path):
    """The architecture JSON (dict) a whole-model .h5 carries."""
    h5py = _h5py()
    with h5py.File(path, "r") as f:
        cfg = f.attrs.get("model_config")
    if cfg is None:
        raise InvalidKerasConfigurationException(
            f"{path!r} holds weights only (no model_config attribute): "
            "import its architecture JSON with the weights path")
    if isinstance(cfg, bytes):
        cfg = cfg.decode("utf-8")
    return json.loads(cfg)


def _h5_layer_weights(weights_path):
    """layer name → [(dataset leaf name, array), ...] in save order.

    Leaf names are Keras's canonical weight names (kernel / bias / gamma /
    beta / moving_mean / moving_variance / recurrent_kernel / embeddings /
    depthwise_kernel / pointwise_kernel), with any ":0" suffix stripped —
    the reference's KerasLayer maps by these names, never by shape.
    """
    h5py = _h5py()
    out = {}
    with h5py.File(weights_path, "r") as f:
        grp = f["model_weights"] if "model_weights" in f else f
        for lname in grp:
            sub = grp[lname]
            arrs = []

            def visit(path, obj):
                if hasattr(obj, "shape"):
                    leaf = path.split("/")[-1].split(":")[0]
                    # keep Bidirectional direction info: Keras nests the
                    # wrapped layers under forward_*/backward_* groups
                    if "forward" in path:
                        leaf = "forward/" + leaf
                    elif "backward" in path:
                        leaf = "backward/" + leaf
                    arrs.append((leaf, np.array(obj)))
            sub.visititems(visit)
            if arrs:
                out[lname] = arrs
    return out


# Keras weight dataset name → (our params key, our state key)
_KERAS_WEIGHT_NAMES = {
    "kernel": ("W", None),
    "embeddings": ("W", None),
    "recurrent_kernel": ("U", None),
    "bias": ("b", None),
    "gamma": ("gamma", None),
    "beta": ("beta", None),
    "moving_mean": (None, "mean"),
    "moving_variance": (None, "var"),
    # depthwise_kernel resolves per-layer: SeparableConv stores it as
    # 'dW', DepthwiseConvolution2D as its main 'W' — see
    # _resolve_depthwise below
    "pointwise_kernel": ("pW", None),
}


def _resolve_depthwise(layer_params, arr):
    """(key, reshaped array) for a Keras depthwise_kernel, or (None, arr).

    Keras lays the kernel out (kh, kw, C, M); ours is grouped-conv HWIO
    (kh, kw, 1, C*M) — a row-major reshape of the last two dims maps
    channel c / multiplier m to output feature c*M + m exactly."""
    key = "dW" if "dW" in layer_params else (
        "W" if "W" in layer_params else None)
    if key is None:
        return None, arr
    target = tuple(layer_params[key].shape)
    if tuple(arr.shape) == target:
        return key, arr
    if arr.ndim == 4 and target[2] == 1 \
            and arr.shape[:2] == target[:2] \
            and arr.shape[2] * arr.shape[3] == target[3]:
        return key, arr.reshape(target)
    return None, arr


def _remap_lstm_gates(arr):
    """Keras gate order i,f,g,o → ours i,f,o,g (kernel, recurrent kernel AND
    bias all share the 4*n gate axis — the reference remaps all three)."""
    n = arr.shape[-1] // 4
    i, f, g, o = (arr[..., :n], arr[..., n:2 * n],
                  arr[..., 2 * n:3 * n], arr[..., 3 * n:])
    return np.concatenate([i, f, o, g], axis=-1)


def _is_deconv(layer):
    """Transposed convs store Keras kernels as (..., OUT, IN) — the only
    kernel layout that differs from ours (HWIO); everything else imports
    natively."""
    if layer is None:
        return False
    from deeplearning4j_tpu_torch.nn.conf.layers import Deconvolution2D
    from deeplearning4j_tpu_torch.nn.conf.layers3d import Deconvolution3D
    return isinstance(layer, (Deconvolution2D, Deconvolution3D))


def _assign_keras_weights(layer_params, arrs, layer_state=None,
                          deconv=False):
    """Assign Keras .h5 arrays onto our param/state dicts BY NAME.

    Shape-only matching mis-assigns any layer whose weights share a shape
    (BatchNorm's four (C,) vectors; LSTM with nIn == nOut) — matching by
    the Keras dataset name is how the reference's KerasLayer does it.
    Arrays with unrecognized names fall back to shape matching against
    still-unused keys.
    """
    # LSTM only: U is (n_out, 4*n_out); SimpleRNN's U is square — its
    # weights must NOT be gate-remapped even when units % 4 == 0
    u = layer_params.get("U")
    is_lstm = u is not None and u.shape[-1] == 4 * u.shape[0]
    used_p, used_s = set(), set()
    leftovers = []
    for name, arr in arrs:
        if name == "depthwise_kernel":
            pkey, arr = _resolve_depthwise(layer_params, arr)
            skey = None
        else:
            pkey, skey = _KERAS_WEIGHT_NAMES.get(name, (None, None))
        if deconv and name == "kernel" and arr.ndim >= 3:
            # Keras Conv*Transpose computes the GRADIENT-style transposed
            # conv; our lax.conv_transpose(transpose_kernel=False) call
            # needs the channel axes swapped ((..., out, in) → HWIO) AND
            # every spatial axis flipped for identical outputs (verified
            # against a hand oracle in test_keras_import). Must be
            # unconditional for deconvs — a square in==out kernel would
            # otherwise pass the shape check untransposed.
            arr = arr.swapaxes(-1, -2)
            arr = arr[tuple(slice(None, None, -1)
                            for _ in range(arr.ndim - 2))]
        if pkey is not None and pkey in layer_params \
                and tuple(layer_params[pkey].shape) == tuple(arr.shape):
            if is_lstm and pkey in ("W", "U", "b") and arr.shape[-1] % 4 == 0:
                arr = _remap_lstm_gates(arr)
            layer_params[pkey] = arr
            used_p.add(pkey)
        elif skey is not None and layer_state is not None \
                and skey in layer_state \
                and tuple(layer_state[skey].shape) == tuple(arr.shape):
            layer_state[skey] = arr
            used_s.add(skey)
        else:
            leftovers.append(arr)
    for arr in leftovers:  # unknown names: shape-match unused keys only
        placed = False
        for key, val in layer_params.items():
            if key not in used_p and tuple(val.shape) == tuple(arr.shape):
                layer_params[key] = arr
                used_p.add(key)
                placed = True
                break
        if not placed and layer_state is not None:
            for key, val in layer_state.items():
                if key not in used_s and tuple(val.shape) == tuple(arr.shape):
                    layer_state[key] = arr
                    used_s.add(key)
                    break


def _assign_layer_weights(params, arrs, state, layer=None):
    """Assign one Keras layer group onto our (possibly NESTED) param dict.
    Bidirectional wrappers nest {'fwd': ..., 'bwd': ...}; their Keras
    datasets carry forward/ / backward/ prefixes from _h5_layer_weights."""
    deconv = _is_deconv(layer)
    if any(isinstance(v, dict) for v in params.values()):
        fwd = [(n.split("/", 1)[1], a) for n, a in arrs
               if n.startswith("forward/")]
        bwd = [(n.split("/", 1)[1], a) for n, a in arrs
               if n.startswith("backward/")]
        if isinstance(params.get("fwd"), dict) and fwd:
            _assign_keras_weights(params["fwd"], fwd, None)
        if isinstance(params.get("bwd"), dict) and bwd:
            _assign_keras_weights(params["bwd"], bwd, None)
        flat = [(n, a) for n, a in arrs if "/" not in n]
        flat_params = {k: v for k, v in params.items()
                       if not isinstance(v, dict)}
        if flat and flat_params:
            _assign_keras_weights(flat_params, flat, state)
            params.update(flat_params)
        return
    # plain layers never carry direction prefixes; strip any stray ones
    arrs = [(n.split("/", 1)[-1], a) for n, a in arrs]
    _assign_keras_weights(params, arrs, state, deconv=deconv)


def _layer_numpy(net, key, layer):
    """One layer's parameters as numpy, nested as the JAX package nests
    them (Bidirectional's {"fwd": {...}, "bwd": {...}}), and its state."""
    from deeplearning4j_tpu_torch.nn.convert import jax_path
    params = {}
    for k, v in net._params.get(key, {}).items():
        *heads, last = jax_path(layer, k)
        node = params
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = v.detach().cpu().numpy().copy()
    state = {k: v.detach().cpu().numpy().copy()
             for k, v in net._state.get(key, {}).items()}
    return params, state


def _install_layer(net, key, layer, params, state):
    """Copy the assigned arrays into the layer's live tensors (dtype and
    device kept: a graph captured over them stays valid)."""
    from deeplearning4j_tpu_torch.nn.convert import jax_path

    def put(dst, arr):
        with torch.no_grad():
            dst.copy_(torch.as_tensor(np.asarray(arr)).to(dst.dtype))

    for k, t in net._params.get(key, {}).items():
        node = params
        for h in jax_path(layer, k):
            node = node[h]
        put(t, node)
    for k, t in net._state.get(key, {}).items():
        put(t, state[k])


def _load_h5_weights_multilayer(net, weights_path):
    by_name = _h5_layer_weights(weights_path)
    loaded = 0
    for li, lyr in enumerate(net.conf.layers):
        name = getattr(lyr, "name", None)
        if name in by_name and str(li) in net._params:
            params, state = _layer_numpy(net, str(li), lyr)
            _assign_layer_weights(params, by_name[name], state, layer=lyr)
            _install_layer(net, str(li), lyr, params, state)
            loaded += 1
    net._h5_layers_loaded = loaded  # callers needing strictness check this
    return net


def _load_h5_weights_graph(net, weights_path):
    by_name = _h5_layer_weights(weights_path)
    loaded = 0
    for name, arrs in by_name.items():
        if name in net._params:
            layer = net.nodes[name].ref if name in net.nodes else None
            params, state = _layer_numpy(net, name, layer)
            _assign_layer_weights(params, arrs, state, layer=layer)
            _install_layer(net, name, layer, params, state)
            loaded += 1
    net._h5_layers_loaded = loaded
    return net
