"""Layer configurations: the port of the part of
`deeplearning4j_tpu/nn/conf/layers.py` that the zoo's models use
(≡ deeplearning4j-nn :: conf.layers.*).

Each config class doubles as the reference's `Layer.Builder` surface:
`DenseLayer.Builder().nIn(4).nOut(3).build()` and `DenseLayer(nIn=4,
nOut=3)` are equivalent. A layer config (a) infers its output InputType,
(b) initializes its parameters from an explicit CPU `torch.Generator`,
(c) applies itself as a plain function of tensors. Class names, fields
and defaults are the JAX package's, so each has its counterpart there.

Conventions, as in the JAX package: NHWC activations, HWIO conv kernels,
batch-major (B, T, F) sequences. A conv views its NHWC input as NCHW in
channels-last memory (no copy) and hands cuDNN the kernel permuted to
OIHW at the call. `dropOut(p)` is the RETAIN probability, inverted
dropout on the layer input at train time; `dropOut` also takes an
`nn/dropout.py` object (GaussianDropout, AlphaDropout, ...).

Every layer of the JAX package's `layers.py` is ported, the frozen
wrappers (FrozenLayer, FrozenLayerWithBackprop) among them. A layer's
`precisionPolicy` (`quantize.PrecisionPolicy`) fake-quantizes the weights
and the input of DenseLayer and ConvolutionLayer in the forward (QAT,
straight-through gradients); `.precisionPolicy(None)` opts a layer out of
an inherited one. The 2-D and 3-D transposed convolutions compute what the
JAX package's `lax.conv_transpose` computes (`conv_transpose`). The
YOLOv2 head lives in `objdetect.py`; the locally connected layers, the
autoencoders, the center loss and PermuteLayer in `special_layers.py`;
the capsules, the 3-D family, weight noise and the custom SameDiff layers
in `capsules.py`, `layers3d.py`, `weightnoise.py` and `samediff_layers.py`;
the recurrent,
sequence and attention layers in `recurrent.py`, `sequence_layers.py` and
`attention.py`. Every `apply` takes the (B, T) feature mask (`mask`,
1 = valid), and `feed_forward_mask` gives the mask the next layer sees.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import batch_sync as _batch_sync
from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf.inputs import (ConvolutionalType,
                                                     InputType,
                                                     RecurrentType)
from deeplearning4j_tpu_torch.nn.dropout import keep_mask
from deeplearning4j_tpu_torch.nn.losses import get_loss
from deeplearning4j_tpu_torch.nn.weights_init import init_weight


class _Builder:
    """Generic fluent builder: any method call records a constructor kwarg."""

    def __init__(self, cls, init_kw=None):
        self._cls = cls
        self._kw = dict(init_kw or {})

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)

        def setter(*args):
            self._kw[name] = args[0] if len(args) == 1 else tuple(args)
            return self

        return setter

    def build(self):
        return self._cls(**self._kw)


class _BuilderFactory:
    """Makes `SomeLayer.Builder(...)` work on every config class, including
    the reference's positional-arg conventions (e.g.
    `OutputLayer.Builder(LossFunction.MCXENT)`,
    `ConvolutionLayer.Builder(5, 5)` = kernel,
    `SubsamplingLayer.Builder(PoolingType.MAX)`)."""

    def __get__(self, obj, objtype=None):
        cls = objtype

        def factory(*args):
            return _Builder(cls, cls._builder_positional(args))

        return factory


def _pair(v):
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def _same_padding(size, k, s, d=1):
    """SAME padding of one spatial dim as (lo, hi), TF convention: the
    extra pad goes on the high side (the stem's 7×7/2 conv on 224 pads
    (2, 3); its 3×3/2 max pool on 112 pads (0, 1))."""
    ke = (k - 1) * d + 1
    out = -(-size // s)
    total = max((out - 1) * s + ke - size, 0)
    return total // 2, total - total // 2


def _nchw(x):
    """An NHWC tensor viewed as NCHW (channels-last memory, no copy)."""
    return x.permute(0, 3, 1, 2)


def _nhwc(y):
    return y.permute(0, 2, 3, 1)


def _qat(layer, w, x):
    """(w, x) as the layer's forward sees them under its precisionPolicy:
    where the policy applies, QAT fake-quant (straight-through) of the
    weights with per-output-channel scales on the last axis (W is (nIn,
    nOut) or HWIO) and of the input with one per-tensor scale, so the fp
    forward simulates the deployed int8 lattice."""
    qp = getattr(layer, "precisionPolicy", None)
    if qp is None or not qp.applies_to(layer):
        return w, x
    from deeplearning4j_tpu_torch.quantize.core import (fake_quant_act,
                                                        fake_quant_weight)
    if qp.weights:
        w = fake_quant_weight(w, channel_axis=-1)
    if qp.activations:
        x = fake_quant_act(x).to(x.dtype)
    return w, x


class Layer:
    """Base layer config. Fields left None inherit NeuralNetConfiguration
    globals (applied by the builder in nn.conf.builders)."""

    Builder = _BuilderFactory()

    INHERITED = ("activation", "weightInit", "biasInit", "l1", "l2",
                 "dropOut", "updater", "gradientNormalization",
                 "gradientNormalizationThreshold", "weightDecay",
                 "constraints", "weightNoise", "precisionPolicy",
                 "remat")

    @classmethod
    def _builder_positional(cls, args):
        if not args:
            return {}
        raise TypeError(f"{cls.__name__}.Builder takes no positional args")

    def __init__(self, name=None, activation=None, weightInit=None,
                 biasInit=None, l1=None, l2=None, dropOut=None, updater=None,
                 dist=None, gradientNormalization=None,
                 gradientNormalizationThreshold=None, weightDecay=None,
                 constraints=None, **kw):
        self.name = name
        self.activation = activation
        self.weightInit = weightInit
        self.biasInit = biasInit
        self.l1 = l1
        self.l2 = l2
        self.dropOut = dropOut
        self.updater = updater
        self.dist = dist
        self.gradientNormalization = gradientNormalization
        self.gradientNormalizationThreshold = gradientNormalizationThreshold
        self.weightDecay = weightDecay
        self.constraints = constraints
        self.weightNoise = kw.pop("weightNoise", None)
        if "precisionPolicy" in kw and kw["precisionPolicy"] is None:
            # the explicit per-layer opt-out: a literal None would read as
            # "unset" and inherit the global policy right back, so it
            # resolves to a disabled policy that shadows the inherited one
            from deeplearning4j_tpu_torch.quantize.policy import \
                PrecisionPolicy
            kw["precisionPolicy"] = PrecisionPolicy.off()
        cw = kw.pop("constrainWeights", None)  # builder-method spelling
        if cw is not None:
            self.constraints = (list(cw) if isinstance(cw, (list, tuple))
                                else [cw])
        for k, v in kw.items():
            setattr(self, k, v)

    # -- lifecycle -------------------------------------------------------
    def apply_defaults(self, defaults: dict):
        for field in self.INHERITED:
            if getattr(self, field, None) is None and field in defaults:
                setattr(self, field, defaults[field])
        if self.activation is None:
            self.activation = "identity"
        if self.weightInit is None:
            self.weightInit = "xavier"
        if self.biasInit is None:
            self.biasInit = 0.0
        self.validate()
        return self

    def validate(self):
        """Build-time config validation (≡ the reference failing in
        MultiLayerConfiguration.Builder#build, not mid-training): resolve
        every name now so typos raise actionable ValueErrors at build()."""
        get_activation(self.activation)
        if isinstance(self.weightInit, str):
            init_weight(torch.Generator(), (2, 2), self.weightInit,
                        self.dist)
        loss = getattr(self, "lossFunction", None)
        if isinstance(loss, str):
            get_loss(loss)

    def initialize(self, generator, input_type):
        """-> (params dict, state dict, output InputType); tensors on the
        CPU, drawn by `generator`."""
        return {}, {}, self.output_type(input_type)

    def output_type(self, input_type):
        return input_type

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        return x, state

    def feed_forward_mask(self, mask):
        """The feature mask as seen by the layers after this one (≡ the
        reference's feedForwardMaskArray): the same mask unless the layer
        reshapes or drops the time axis (None: every step valid)."""
        return mask

    # -- helpers ---------------------------------------------------------
    def regularization_terms(self):
        """(l1, l2) of the score's weight penalty (≡ the reference's
        per-layer regularization)."""
        return (self.l1 or 0.0), (self.l2 or 0.0)

    def n_params(self, input_type):
        """The number of parameters the layer holds on `input_type` (its
        state, such as BN's running statistics, not counted)."""
        from deeplearning4j_tpu_torch.runtime.executables import \
            tensor_leaves
        params, _, _ = self.initialize(torch.Generator().manual_seed(0),
                                       input_type)
        return sum(t.numel() for t in tensor_leaves(params))

    def _dropout_in(self, x, train, generator):
        """Inverted dropout on the input at train time, drawn from
        `generator` (on x's device); None means no dropout, as a None rng
        does in the JAX package."""
        p = self.dropOut
        if not train or p is None or generator is None:
            return x
        if hasattr(p, "apply"):  # an IDropout object (nn/dropout.py)
            return p.apply(x, generator)
        if p == 0.0 or p == 1.0:
            return x
        keep = keep_mask(x, p, generator=generator)
        return torch.where(keep, x / p, torch.zeros_like(x))


class DenseLayer(Layer):
    """≡ conf.layers.DenseLayer — y = act(xW + b), W:(nIn,nOut)."""

    def __init__(self, nIn=None, nOut=None, hasBias=True, **kw):
        super().__init__(**kw)
        self.nIn, self.nOut, self.hasBias = nIn, nOut, hasBias

    def output_type(self, input_type):
        if self.nOut is None:
            raise ValueError(
                f"{type(self).__name__} '{self.name}': nOut is required "
                "(set .nOut(n) on the builder)")
        if isinstance(input_type, (ConvolutionalType,)):
            raise ValueError(
                f"DenseLayer '{self.name}' got convolutional input "
                f"{input_type}; add a CnnToFeedForwardPreProcessor "
                "(setInputType does this automatically)")
        if isinstance(input_type, RecurrentType):
            return InputType.recurrent(self.nOut, input_type.timeSeriesLength)
        return InputType.feedForward(self.nOut)

    def initialize(self, generator, input_type):
        if self.nIn is None:
            self.nIn = input_type.size
        if self.nOut is None:
            raise ValueError(f"DenseLayer '{self.name}': nOut not set")
        w = init_weight(generator, (int(self.nIn), int(self.nOut)),
                        self.weightInit, self.dist)
        params = {"W": w}
        if self.hasBias:
            params["b"] = torch.full((int(self.nOut),), float(self.biasInit))
        return params, {}, self.output_type(input_type)

    def pre_activation(self, params, x):
        w, x = _qat(self, params["W"], x)
        y = x @ w.to(x.dtype)
        if self.hasBias:
            y = y + params["b"].to(x.dtype)
        return y

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        x = self._dropout_in(x, train, generator)
        return (get_activation(self.activation)(self.pre_activation(params,
                                                                    x)),
                state)


class EmbeddingLayer(Layer):
    """≡ conf.layers.EmbeddingLayer — integer indices (B,) or one-hot rows
    (B, nIn) to dense vectors by a row gather."""

    def __init__(self, nIn=None, nOut=None, hasBias=False, **kw):
        super().__init__(**kw)
        self.nIn, self.nOut, self.hasBias = nIn, nOut, hasBias

    def output_type(self, input_type):
        return InputType.feedForward(self.nOut)

    def initialize(self, generator, input_type):
        if self.nIn is None:
            self.nIn = input_type.size
        params = {"W": init_weight(generator, (int(self.nIn), int(self.nOut)),
                                   self.weightInit, self.dist)}
        if self.hasBias:
            params["b"] = torch.full((int(self.nOut),), float(self.biasInit))
        return params, {}, self.output_type(input_type)

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        w = params["W"]
        if not x.is_floating_point():
            idx = x.reshape(x.shape[0])
        elif x.ndim == 2 and x.shape[-1] == w.shape[0]:
            idx = x.argmax(dim=-1)
        else:
            idx = x.reshape(-1)
        y = w[idx.long()]
        if self.hasBias:
            y = y + params["b"].to(y.dtype)
        return get_activation(self.activation)(y), state


class EmbeddingSequenceLayer(Layer):
    """≡ EmbeddingSequenceLayer — (B, T) integer tokens (or (B, T, nIn)
    one-hot) to (B, T, nOut)."""

    def __init__(self, nIn=None, nOut=None, inputLength=None, **kw):
        super().__init__(**kw)
        self.nIn, self.nOut, self.inputLength = nIn, nOut, inputLength

    def output_type(self, input_type):
        t = getattr(input_type, "timeSeriesLength", None) or self.inputLength
        return InputType.recurrent(self.nOut, t)

    def initialize(self, generator, input_type):
        if self.nIn is None:
            self.nIn = input_type.size
        w = init_weight(generator, (int(self.nIn), int(self.nOut)),
                        self.weightInit, self.dist)
        return {"W": w}, {}, self.output_type(input_type)

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        if x.ndim == 3:  # one-hot (B, T, nIn)
            x = x.argmax(dim=-1)
        y = params["W"][x.long()]
        return get_activation(self.activation)(y), state


class TimeDistributed(Layer):
    """≡ conf.layers.recurrent.TimeDistributed — a feed-forward layer
    applied at every step of (B, T, F) by folding time into the batch."""

    @classmethod
    def _builder_positional(cls, args):
        return {"underlying": args[0]} if args else {}

    def __init__(self, underlying=None, **kw):
        super().__init__(**kw)
        if underlying is None:
            raise ValueError("TimeDistributed needs an underlying layer")
        self.underlying = underlying

    def apply_defaults(self, defaults):
        # dropout runs once, in the inner layer; an explicit wrapper
        # dropOut is handed to it, and the training hooks the networks read
        # from the outer layer mirror the inner one's
        if self.dropOut is not None and self.underlying.dropOut is None:
            self.underlying.dropOut = self.dropOut
        self.underlying.apply_defaults(defaults)
        out = super().apply_defaults(defaults)
        u = self.underlying
        if self.constraints is None:
            self.constraints = getattr(u, "constraints", None)
        if getattr(self, "weightNoise", None) is None:
            self.weightNoise = getattr(u, "weightNoise", None)
        if getattr(u, "frozen_params", False):
            self.frozen_params = True
        return out

    def regularization_terms(self):
        return self.underlying.regularization_terms()

    def output_type(self, input_type):
        inner = self.underlying.output_type(
            InputType.feedForward(input_type.size))
        return InputType.recurrent(inner.size, input_type.timeSeriesLength)

    def initialize(self, generator, input_type):
        params, state, inner_out = self.underlying.initialize(
            generator, InputType.feedForward(input_type.size))
        return params, state, InputType.recurrent(
            inner_out.size, input_type.timeSeriesLength)

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        b, t = x.shape[0], x.shape[1]
        y, state = self.underlying.apply(
            params, state, x.reshape((b * t,) + tuple(x.shape[2:])),
            train=train, generator=generator)
        return y.reshape((b, t) + tuple(y.shape[1:])), state


class ConvolutionLayer(Layer):
    """≡ conf.layers.ConvolutionLayer (2D). NHWC activations and HWIO
    kernels; cuDNN takes the NCHW view of the activation in channels-last
    memory and the kernel permuted to OIHW. SAME padding is asymmetric
    (TF convention), so an uneven pad goes through `F.pad` first.
    `spaceToDepth` is kept as a field: in the JAX package it is a TPU
    trick that computes the same conv, so here the plain conv runs."""

    @classmethod
    def _builder_positional(cls, args):
        if not args:
            return {}
        if len(args) == 1:
            return {"kernelSize": args[0]}
        return {"kernelSize": tuple(args)}

    def __init__(self, nIn=None, nOut=None, kernelSize=(3, 3), stride=(1, 1),
                 padding=(0, 0), dilation=(1, 1), convolutionMode="truncate",
                 hasBias=True, spaceToDepth=1, **kw):
        super().__init__(**kw)
        self.nIn, self.nOut = nIn, nOut
        self.kernelSize, self.stride = _pair(kernelSize), _pair(stride)
        self.padding, self.dilation = _pair(padding), _pair(dilation)
        self.convolutionMode = convolutionMode
        self.hasBias = hasBias
        self.spaceToDepth = int(spaceToDepth or 1)

    def _explicit_padding(self, h, w):
        """((lo, hi), (lo, hi)) of the two spatial dims; 'SAME' resolved
        with the extra pad on the high side."""
        if str(self.convolutionMode).lower() != "same":
            return ((self.padding[0], self.padding[0]),
                    (self.padding[1], self.padding[1]))
        return tuple(_same_padding(size, k, s, d) for size, k, s, d in zip(
            (h, w), self.kernelSize, self.stride, self.dilation))

    def output_type(self, input_type):
        if self.nOut is None:
            raise ValueError(
                f"{type(self).__name__} '{self.name}': nOut is required "
                "(set .nOut(n) on the builder)")
        if not isinstance(input_type, ConvolutionalType):
            raise ValueError(
                f"ConvolutionLayer '{self.name}' needs convolutional input, "
                f"got {input_type}")
        kh, kw = self.kernelSize
        sh, sw = self.stride
        if str(self.convolutionMode).lower() == "same":
            oh = -(-input_type.height // sh)
            ow = -(-input_type.width // sw)
        else:
            ph, pw = self.padding
            oh = (input_type.height + 2 * ph
                  - ((kh - 1) * self.dilation[0] + 1)) // sh + 1
            ow = (input_type.width + 2 * pw
                  - ((kw - 1) * self.dilation[1] + 1)) // sw + 1
        return InputType.convolutional(oh, ow, self.nOut)

    def initialize(self, generator, input_type):
        if self.nIn is None:
            self.nIn = input_type.channels
        kh, kw = self.kernelSize
        w = init_weight(generator, (kh, kw, int(self.nIn), int(self.nOut)),
                        self.weightInit, self.dist)
        params = {"W": w}
        if self.hasBias:
            params["b"] = torch.full((int(self.nOut),), float(self.biasInit))
        return params, {}, self.output_type(input_type)

    def _conv(self, x, w, groups=1):
        """The NHWC convolution of `x` by the HWIO kernel `w` (input axis
        nIn/groups) at this layer's stride, padding and dilation."""
        cl = torch.channels_last
        w = w.to(x.dtype).permute(3, 2, 0, 1).contiguous(
            memory_format=cl)                                  # OIHW
        (plh, phh), (plw, phw) = self._explicit_padding(x.shape[1],
                                                        x.shape[2])
        xc = _nchw(x)
        if plh == phh and plw == phw:
            pad = (plh, plw)
        else:
            xc = F.pad(xc, (plw, phw, plh, phh)).contiguous(memory_format=cl)
            pad = (0, 0)
        return _nhwc(F.conv2d(xc, w, stride=self.stride, padding=pad,
                              dilation=self.dilation, groups=groups))

    def pre_activation(self, params, x):
        w, x = _qat(self, params["W"], x)
        y = self._conv(x, w)
        if self.hasBias:
            y = y + params["b"].to(x.dtype)
        return y

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        x = self._dropout_in(x, train, generator)
        return (get_activation(self.activation)(self.pre_activation(params,
                                                                    x)),
                state)


class DepthwiseConvolution2D(ConvolutionLayer):
    """≡ conf.layers.DepthwiseConvolution2D — a convolution per input
    channel, no mixing across channels: a grouped convolution with nIn
    groups. nOut = nIn · depthMultiplier (nOut need not be set). The HWIO
    kernel (kh, kw, 1, nIn·m) is torch's (nIn·m, 1, kh, kw): output
    channel o belongs to input channel o // m in both packages."""

    def __init__(self, depthMultiplier=1, **kw):
        super().__init__(**kw)
        self.depthMultiplier = int(depthMultiplier)

    def output_type(self, input_type):
        if self.nIn is None:
            self.nIn = input_type.channels
        self.nOut = int(self.nIn) * self.depthMultiplier
        return super().output_type(input_type)

    def initialize(self, generator, input_type):
        if self.nIn is None:
            self.nIn = input_type.channels
        self.nOut = int(self.nIn) * self.depthMultiplier
        kh, kw = self.kernelSize
        params = {"W": init_weight(generator, (kh, kw, 1, int(self.nOut)),
                                   self.weightInit, self.dist)}
        if self.hasBias:
            params["b"] = torch.full((int(self.nOut),), float(self.biasInit))
        return params, {}, self.output_type(input_type)

    def pre_activation(self, params, x):
        y = self._conv(x, params["W"], groups=int(self.nIn))
        if self.hasBias:
            y = y + params["b"].to(x.dtype)
        return y


class SeparableConvolution2D(ConvolutionLayer):
    """≡ conf.layers.SeparableConvolution2D — a depthwise convolution
    (`dW`, (kh, kw, 1, nIn·m), this layer's stride and padding), then a
    1×1 one (`pW`, (1, 1, nIn·m, nOut)) as a product over the channels.
    `dW` and `pW` are weights under l1/l2."""

    def __init__(self, depthMultiplier=1, **kw):
        super().__init__(**kw)
        self.depthMultiplier = int(depthMultiplier)

    def initialize(self, generator, input_type):
        if self.nIn is None:
            self.nIn = input_type.channels
        kh, kw = self.kernelSize
        cm = int(self.nIn) * self.depthMultiplier
        params = {"dW": init_weight(generator, (kh, kw, 1, cm),
                                    self.weightInit, self.dist),
                  "pW": init_weight(generator, (1, 1, cm, int(self.nOut)),
                                    self.weightInit, self.dist)}
        if self.hasBias:
            params["b"] = torch.full((int(self.nOut),), float(self.biasInit))
        return params, {}, self.output_type(input_type)

    def pre_activation(self, params, x):
        y = self._conv(x, params["dW"], groups=int(self.nIn))
        pw = params["pW"]
        y = y @ pw.to(x.dtype).reshape(pw.shape[2], pw.shape[3])
        if self.hasBias:
            y = y + params["b"].to(x.dtype)
        return y


class SubsamplingLayer(Layer):
    """≡ conf.layers.SubsamplingLayer — max/avg pooling, NHWC. Padding is
    applied explicitly (−inf for max, zeros for avg), since SAME padding
    may be uneven; avg divides by the count of real (unpadded) inputs in
    each window, as the JAX package does."""

    MAX, AVG = "max", "avg"

    @classmethod
    def _builder_positional(cls, args):
        if not args:
            return {}
        if isinstance(args[0], str):
            out = {"poolingType": args[0]}
            if len(args) > 1:
                out["kernelSize"] = args[1]
            if len(args) > 2:
                out["stride"] = args[2]
            return out
        out = {"kernelSize": args[0]}
        if len(args) > 1:
            out["stride"] = args[1]
        return out

    def __init__(self, poolingType="max", kernelSize=(2, 2), stride=(2, 2),
                 padding=(0, 0), convolutionMode="truncate", **kw):
        super().__init__(**kw)
        self.poolingType = str(poolingType).lower()
        self.kernelSize = _pair(kernelSize)
        self.stride, self.padding = _pair(stride), _pair(padding)
        self.convolutionMode = convolutionMode

    def output_type(self, input_type):
        kh, kw = self.kernelSize
        sh, sw = self.stride
        if str(self.convolutionMode).lower() == "same":
            oh, ow = -(-input_type.height // sh), -(-input_type.width // sw)
        else:
            ph, pw = self.padding
            oh = (input_type.height + 2 * ph - kh) // sh + 1
            ow = (input_type.width + 2 * pw - kw) // sw + 1
        return InputType.convolutional(oh, ow, input_type.channels)

    def _pads(self, h, w):
        """F.pad's (left, right, top, bottom) for this layer."""
        if str(self.convolutionMode).lower() == "same":
            (plh, phh), (plw, phw) = (
                _same_padding(size, k, s) for size, k, s in zip(
                    (h, w), self.kernelSize, self.stride))
        else:
            (plh, phh), (plw, phw) = ((p, p) for p in self.padding)
        return (plw, phw, plh, phh)

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        pads = self._pads(x.shape[1], x.shape[2])
        xc = _nchw(x)
        if self.poolingType == "max":
            y = F.max_pool2d(F.pad(xc, pads, value=float("-inf")),
                             self.kernelSize, self.stride)
        elif self.poolingType in ("avg", "mean"):
            area = self.kernelSize[0] * self.kernelSize[1]
            s = F.avg_pool2d(F.pad(xc, pads), self.kernelSize,
                             self.stride) * area
            ones = torch.ones((1, 1) + tuple(x.shape[1:3]), dtype=x.dtype,
                              device=x.device)
            cnt = F.avg_pool2d(F.pad(ones, pads), self.kernelSize,
                               self.stride) * area
            y = s / cnt
        else:
            raise ValueError(f"Unknown poolingType {self.poolingType}")
        return _nhwc(y), state


def _bn_stats(x):
    """Per-channel batch mean and variance (E[x²] − E[x]², clipped at 0)
    over every axis but the last, in f32 (f64 for f64 inputs)."""
    axes = tuple(range(x.ndim - 1))
    xf = x.to(torch.float64 if x.dtype == torch.float64 else torch.float32)
    s1 = xf.mean(dim=axes)
    s2 = (xf * xf).mean(dim=axes)
    return s1, torch.clamp_min(s2 - s1 * s1, 0.0)


class _BNTrain(torch.autograd.Function):
    """Training BatchNorm y = x·a + b with the batch statistics, and the
    closed-form backward of the JAX `_bn_train` custom VJP
    (deeplearning4j_tpu/nn/conf/layers.py:792-829), over the global batch
    when a data-parallel step has `batch_sync.ACTIVE` set:
      dβ = Σdy, dγ = Σdy·x̂, dx = k1·dy − (x − μ)·k2 − c
    with k1 = γr, k2 = γr²·dγ/n, c = γr·dβ/n cast to x.dtype, instead of
    autograd's passes through the mean/var chain. Returns (y, μ, var); μ
    and var feed only the running averages and get no gradient."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        sync = _batch_sync.ACTIVE
        ctx.sync = sync
        if sync is None:
            mu, var = _bn_stats(x)
        else:
            # data parallel: the global batch's statistics (Σx, Σx² over
            # the dp ranks, each holding as many rows)
            axes = tuple(range(x.ndim - 1))
            xf = x.to(torch.float64 if x.dtype == torch.float64
                      else torch.float32)
            s1, s2 = sync.sum(xf.sum(dim=axes), (xf * xf).sum(dim=axes))
            n = (x.numel() // x.shape[-1]) * sync.n
            mu = s1 / n
            var = torch.clamp_min(s2 / n - mu * mu, 0.0)
        r = torch.rsqrt(var + eps)
        a = (gamma * r).to(x.dtype)
        b = (beta - gamma * mu * r).to(x.dtype)
        ctx.save_for_backward(x, mu, r, gamma)
        ctx.mark_non_differentiable(mu, var)
        return x * a + b, mu, var

    @staticmethod
    def backward(ctx, dy, _dmu, _dvar):
        x, mu, r, gamma = ctx.saved_tensors
        axes = tuple(range(x.ndim - 1))
        n = x.numel() // x.shape[-1]
        xhat = (x.to(mu.dtype) - mu) * r
        dyf = dy.to(mu.dtype)
        dbeta = dyf.sum(dim=axes)
        dgamma = (dyf * xhat).sum(dim=axes)
        sbeta, sgamma = dbeta, dgamma
        if ctx.sync is not None:
            # dX needs the global batch's sums; dγ and dβ stay this rank's
            # share (the data-parallel step sums the gradients after)
            sbeta, sgamma = ctx.sync.sum(dbeta, dgamma)
            n = n * ctx.sync.n
        k1 = (gamma * r).to(x.dtype)
        k2 = (gamma * r * r * sgamma / n).to(x.dtype)
        c = (gamma * r * (sbeta / n)).to(x.dtype)
        dx = k1 * dy - (x - mu.to(x.dtype)) * k2 - c
        return dx, dgamma, dbeta, None


class BatchNormalization(Layer):
    """≡ conf.layers.BatchNormalization — channel-last batch norm. Train
    mode normalizes with the batch statistics through `_BNTrain` (the
    JAX package's closed-form backward) and updates the running ones
    (`decay` follows the reference default). Inference folds the running
    statistics into one affine pass."""

    def __init__(self, nOut=None, decay=0.9, eps=1e-5, gamma=1.0, beta=0.0,
                 lockGammaBeta=False, **kw):
        super().__init__(**kw)
        self.nOut, self.decay, self.eps = nOut, float(decay), float(eps)
        self.gammaInit, self.betaInit = float(gamma), float(beta)
        self.lockGammaBeta = lockGammaBeta

    def output_type(self, input_type):
        return input_type

    def _nfeat(self, input_type):
        c = getattr(input_type, "channels", None)
        return c if c is not None else input_type.size

    def initialize(self, generator, input_type):
        n = int(self.nOut or self._nfeat(input_type))
        self.nOut = n
        params = {} if self.lockGammaBeta else {
            "gamma": torch.full((n,), self.gammaInit),
            "beta": torch.full((n,), self.betaInit)}
        state = {"mean": torch.zeros(n), "var": torch.ones(n)}
        return params, state, input_type

    @staticmethod
    def gamma_beta(params, like):
        """(γ, β), or (1, 0) shaped as `like` when lockGammaBeta left them
        out; the defaults are made only then, since each is a launch on
        the card."""
        if "gamma" in params:
            return params["gamma"], params["beta"]
        return torch.ones_like(like), torch.zeros_like(like)

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        gamma, beta = self.gamma_beta(params, state["mean"])
        if train:
            y, mean, var = _BNTrain.apply(x, gamma, beta, self.eps)
            new_state = {
                "mean": self.decay * state["mean"] + (1 - self.decay) * mean,
                "var": self.decay * state["var"] + (1 - self.decay) * var}
            return get_activation(self.activation)(y), new_state
        inv = torch.rsqrt(state["var"] + self.eps)
        a = (gamma * inv).to(x.dtype)
        b = (beta - gamma * state["mean"] * inv).to(x.dtype)
        return get_activation(self.activation)(x * a + b), state


class ActivationLayer(Layer):
    """≡ conf.layers.ActivationLayer."""

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        return get_activation(self.activation)(x), state


class DropoutLayer(Layer):
    """≡ conf.layers.DropoutLayer — dropOut is the RETAIN probability."""

    def __init__(self, dropOut=0.5, **kw):
        super().__init__(dropOut=dropOut, **kw)

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        return self._dropout_in(x, train, generator), state


class GlobalPoolingLayer(Layer):
    """≡ conf.layers.GlobalPoolingLayer — pools CNN (H,W) or RNN (T) dims.
    poolingType: MAX | AVG | SUM | PNORM."""

    @classmethod
    def _builder_positional(cls, args):
        return {"poolingType": args[0]} if args else {}

    def __init__(self, poolingType="max", pnorm=2, collapseDimensions=True,
                 **kw):
        super().__init__(**kw)
        self.poolingType = str(poolingType).lower()
        self.pnorm = pnorm
        self.collapseDimensions = collapseDimensions

    def output_type(self, input_type):
        if isinstance(input_type, ConvolutionalType):
            return InputType.feedForward(input_type.channels)
        if isinstance(input_type, RecurrentType):
            return InputType.feedForward(input_type.size)
        return input_type

    def feed_forward_mask(self, mask):
        return None  # the pooled output has no time axis

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        axes = (1, 2) if x.ndim == 4 else (1,)
        seq_mask = mask is not None and x.ndim == 3
        if self.poolingType == "max":
            if seq_mask:
                x = torch.where(mask[..., None] > 0, x, float("-inf"))
            y = x.amax(dim=axes)
        elif self.poolingType in ("avg", "mean"):
            if seq_mask:
                m = mask[..., None].to(x.dtype)
                y = (x * m).sum(dim=axes) / m.sum(dim=axes).clamp_min(1.0)
            else:
                y = x.mean(dim=axes)
        elif self.poolingType == "sum":
            y = x.sum(dim=axes)
        elif self.poolingType == "pnorm":
            y = (x.abs() ** self.pnorm).sum(dim=axes) ** (1.0 / self.pnorm)
        else:
            raise ValueError(f"Unknown poolingType {self.poolingType}")
        return y, state


class Upsampling2D(Layer):
    """≡ conf.layers.Upsampling2D — nearest-neighbour repeat, H then W."""

    def __init__(self, size=2, **kw):
        super().__init__(**kw)
        self.size = _pair(size)

    def output_type(self, input_type):
        return InputType.convolutional(input_type.height * self.size[0],
                                       input_type.width * self.size[1],
                                       input_type.channels)

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        y = x.repeat_interleave(self.size[0], dim=1)
        return y.repeat_interleave(self.size[1], dim=2), state


class BaseOutputLayer(Layer):
    @classmethod
    def _builder_positional(cls, args):
        return {"lossFunction": args[0]} if args else {}

    def __init__(self, lossFunction="mcxent", **kw):
        kw.setdefault("activation", None)
        super().__init__(**kw)
        self.lossFunction = lossFunction

    def apply_defaults(self, defaults):
        # an output layer whose activation was set NOWHERE gets softmax; an
        # EXPLICIT activation — including "identity" — always sticks
        if self.activation is None and "activation" not in defaults:
            self.activation = "softmax"
        super().apply_defaults(defaults)
        return self

    def compute_loss(self, labels, preact, mask=None):
        return get_loss(self.lossFunction)(labels, preact, self.activation,
                                           mask)


class OutputLayer(BaseOutputLayer, DenseLayer):
    """≡ conf.layers.OutputLayer — dense + loss head."""

    def __init__(self, lossFunction="mcxent", **kw):
        DenseLayer.__init__(self, **{k: v for k, v in kw.items()})
        self.lossFunction = lossFunction
        if kw.get("activation") is None:
            self.activation = None

    def apply_defaults(self, defaults):
        if self.activation is None and "activation" not in defaults:
            self.activation = "softmax"
        Layer.apply_defaults(self, defaults)
        return self


class LossLayer(BaseOutputLayer):
    """≡ conf.layers.LossLayer — a loss on its input, no parameters; the
    activation applies in `apply`."""

    def pre_activation(self, params, x):
        return x

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        return get_activation(self.activation)(x), state


# -- the rest of the JAX package's layers.py ----------------------------------
def conv_transpose(x, w, stride, pads):
    """The JAX package's `lax.conv_transpose(x, w, stride, pads)` without
    `transpose_kernel`, channels-last: `x` (B, *S, C) and `w` (*K, I, O)
    for 2 or 3 spatial dims. lax correlates the UNFLIPPED kernel with the
    input dilated by `stride` and padded by `pads` ((lo, hi) per dim);
    torch's transposed convolution is that with the kernel flipped, at
    full size cropped by k − 1 − lo and k − 1 − hi (a negative crop pads
    zeros)."""
    nd = w.ndim - 2
    ks = w.shape[:nd]
    wt = w.to(x.dtype).flip(list(range(nd))).permute(
        nd, nd + 1, *range(nd)).contiguous()                    # I, O, *K
    xc = x.permute(0, nd + 1, *range(1, nd + 1))                 # N, C, *S
    crops = [(k - 1 - lo, k - 1 - hi) for k, (lo, hi) in zip(ks, pads)]
    conv = F.conv_transpose2d if nd == 2 else F.conv_transpose3d
    if all(a == b and a >= 0 for a, b in crops):
        y = conv(xc, wt, stride=stride, padding=[a for a, _ in crops])
    else:
        y = conv(xc, wt, stride=stride)
        pad = []
        for a, b in reversed(crops):   # F.pad runs from the last dim
            pad += [-a, -b]
        y = F.pad(y, pad)
    return y.permute(0, *range(2, nd + 2), 1)


def conv_transpose_pads(ks, stride, padding, same):
    """lax's (lo, hi) per dim for `conv_transpose` under the JAX package's
    padding argument: 'SAME', 'VALID' (all padding 0) or (p, p) each."""
    out = []
    for k, s, p in zip(ks, stride, padding):
        if same:
            n, lo = k + s - 2, (k - 1 if s > k - 1 else -(-(k + s - 2) // 2))
        elif not any(padding):
            n, lo = k + s - 2 + max(k - s, 0), k - 1
        else:
            n, lo = 2 * p, p
        out.append((lo, n - lo))
    return out


class Cropping2D(Layer):
    """≡ conf.layers.convolutional.Cropping2D — crop (top, bottom, left,
    right) off the spatial dims, NHWC."""

    def __init__(self, cropping=(0, 0, 0, 0), **kw):
        super().__init__(**kw)
        c = cropping
        if isinstance(c, int):
            c = (c, c, c, c)
        elif len(c) == 2:
            if isinstance(c[0], (tuple, list)):  # keras ((t,b),(l,r))
                c = (c[0][0], c[0][1], c[1][0], c[1][1])
            else:
                c = (c[0], c[0], c[1], c[1])
        self.crop = tuple(int(v) for v in c)  # (top, bottom, left, right)

    def output_type(self, input_type):
        t, b, l, r = self.crop
        oh = input_type.height - t - b
        ow = input_type.width - l - r
        if oh <= 0 or ow <= 0:
            raise ValueError(
                f"Cropping2D '{self.name}': crop {self.crop} consumes the "
                f"whole {input_type.height}x{input_type.width} input")
        return InputType.convolutional(oh, ow, input_type.channels)

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        t, b, l, r = self.crop
        h, w = x.shape[1], x.shape[2]
        return x[:, t:h - b, l:w - r, :], state


class LocalResponseNormalization(Layer):
    """≡ conf.layers.LocalResponseNormalization — cross-channel LRN:
    y = x / (k + α·Σ_window x²)^β over n adjacent channels, NHWC, in f32.
    α multiplies the window's sum as it is (`F.local_response_norm`
    divides it by n, so it is not used)."""

    def __init__(self, k=2.0, n=5, alpha=1e-4, beta=0.75, **kw):
        super().__init__(**kw)
        self.k, self.n = float(k), int(n)
        self.alpha, self.beta = float(alpha), float(beta)

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        xf = x.float()
        c, half = x.shape[-1], self.n // 2
        sq = F.pad(xf * xf, (half, self.n - 1 - half))
        win = sq[..., 0:c]
        for i in range(1, self.n):
            win = win + sq[..., i:i + c]
        denom = torch.pow(self.k + self.alpha * win, self.beta)
        return (xf / denom).to(x.dtype), state


class Deconvolution2D(Layer):
    """≡ conf.layers.Deconvolution2D — transposed convolution, NHWC/HWIO,
    computing what the JAX package's `lax.conv_transpose` computes
    (`conv_transpose`). Its declared output type is the JAX package's too:
    s·(n − 1) + k − 2p, which differs from the computed size unless
    p = (k − 1)/2 or the mode is "same" (a defect of the JAX package that
    the port mirrors)."""

    def __init__(self, nIn=None, nOut=None, kernelSize=(2, 2), stride=(2, 2),
                 padding=(0, 0), convolutionMode="truncate", hasBias=True,
                 **kw):
        super().__init__(**kw)
        self.nIn, self.nOut = nIn, nOut
        self.kernelSize, self.stride = _pair(kernelSize), _pair(stride)
        self.padding = _pair(padding)
        self.convolutionMode = convolutionMode
        self.hasBias = hasBias

    def _same(self):
        return str(self.convolutionMode).lower() == "same"

    def output_type(self, input_type):
        if self.nOut is None:
            raise ValueError(
                f"Deconvolution2D '{self.name}': nOut is required")
        if not isinstance(input_type, ConvolutionalType):
            raise ValueError(
                f"Deconvolution2D '{self.name}' needs convolutional input, "
                f"got {input_type}")
        kh, kw = self.kernelSize
        sh, sw = self.stride
        if self._same():
            oh, ow = input_type.height * sh, input_type.width * sw
        else:
            ph, pw = self.padding
            oh = sh * (input_type.height - 1) + kh - 2 * ph
            ow = sw * (input_type.width - 1) + kw - 2 * pw
        return InputType.convolutional(oh, ow, self.nOut)

    def initialize(self, generator, input_type):
        if self.nIn is None:
            self.nIn = input_type.channels
        kh, kw = self.kernelSize
        params = {"W": init_weight(generator, (kh, kw, int(self.nIn),
                                               int(self.nOut)),
                                   self.weightInit, self.dist)}
        if self.hasBias:
            params["b"] = torch.full((int(self.nOut),), float(self.biasInit))
        return params, {}, self.output_type(input_type)

    def pre_activation(self, params, x):
        w = params["W"]
        y = conv_transpose(x, w, self.stride, conv_transpose_pads(
            w.shape[:2], self.stride, self.padding, self._same()))
        if self.hasBias:
            y = y + params["b"].to(x.dtype)
        return y

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        x = self._dropout_in(x, train, generator)
        return get_activation(self.activation)(
            self.pre_activation(params, x)), state


class RepeatVector(Layer):
    """≡ conf.layers.misc.RepeatVector — (B, F) -> (B, n, F)."""

    def __init__(self, repetitionFactor=1, **kw):
        super().__init__(**kw)
        self.n = int(repetitionFactor)

    def output_type(self, input_type):
        return InputType.recurrent(input_type.size, self.n)

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        return x[:, None, :].repeat(1, self.n, 1), state


class ZeroPadding1DLayer(Layer):
    """≡ conf.layers.ZeroPadding1DLayer — pads the time axis of (B,T,F)."""

    def __init__(self, padding=1, **kw):
        super().__init__(**kw)
        p = padding
        self.pad = (int(p), int(p)) if isinstance(p, int) else \
            (int(p[0]), int(p[1]))

    def output_type(self, input_type):
        return InputType.recurrent(
            input_type.size,
            None if getattr(input_type, "timeSeriesLength", None) is None
            else input_type.timeSeriesLength + sum(self.pad))

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        return F.pad(x, (0, 0) + self.pad), state


class Cropping1D(Layer):
    """≡ conf.layers.convolutional.Cropping1D — crops the time axis."""

    def __init__(self, cropping=1, **kw):
        super().__init__(**kw)
        c = cropping
        self.crop = (int(c), int(c)) if isinstance(c, int) else \
            (int(c[0]), int(c[1]))

    def output_type(self, input_type):
        return InputType.recurrent(
            input_type.size,
            None if getattr(input_type, "timeSeriesLength", None) is None
            else input_type.timeSeriesLength - sum(self.crop))

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        lo, hi = self.crop
        return x[:, lo:x.shape[1] - hi, :], state


class ZeroPaddingLayer(Layer):
    """≡ conf.layers.ZeroPaddingLayer (2D, NHWC)."""

    def __init__(self, padding=(1, 1), **kw):
        super().__init__(**kw)
        p = padding
        if isinstance(p, int):
            p = (p, p, p, p)
        elif len(p) == 2 and isinstance(p[0], (list, tuple)):
            # Keras's spelling ((top, bottom), (left, right)), which its
            # JSON always uses (the JAX package's layer refuses it)
            p = (p[0][0], p[0][1], p[1][0], p[1][1])
        elif len(p) == 2:
            p = (p[0], p[0], p[1], p[1])
        self.pad = tuple(int(v) for v in p)  # (top, bottom, left, right)

    def output_type(self, input_type):
        t, b, l, r = self.pad
        return InputType.convolutional(input_type.height + t + b,
                                       input_type.width + l + r,
                                       input_type.channels)

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        t, b, l, r = self.pad
        return F.pad(x, (0, 0, l, r, t, b)), state


class PReLULayer(Layer):
    """≡ conf.layers.PReLULayer — a learned negative slope `alpha` per
    feature of the last axis."""

    def __init__(self, alphaInit=0.0, **kw):
        super().__init__(**kw)
        self.alphaInit = float(alphaInit)

    def initialize(self, generator, input_type):
        n = input_type.shape()[-1]
        return ({"alpha": torch.full((n,), self.alphaInit)}, {},
                input_type)

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        a = params["alpha"].to(x.dtype)
        return torch.where(x >= 0, x, a * x), state


class Convolution1DLayer(Layer):
    """≡ conf.layers.Convolution1DLayer — (B, T, F) temporal convolution,
    kernel (k, nIn, nOut); SAME padding puts the odd pad at the end."""

    def __init__(self, nIn=None, nOut=None, kernelSize=3, stride=1,
                 padding=0, dilation=1, convolutionMode="same",
                 hasBias=True, **kw):
        super().__init__(**kw)
        self.nIn, self.nOut = nIn, nOut
        self.kernelSize, self.stride = int(kernelSize), int(stride)
        self.padding, self.dilation = int(padding), int(dilation)
        self.convolutionMode, self.hasBias = convolutionMode, hasBias

    def _same(self):
        return str(self.convolutionMode).lower() == "same"

    def feed_forward_mask(self, mask):
        if mask is None or self.stride == 1 and self._same():
            return mask
        m = mask[:, ::self.stride]
        if not self._same():
            t = mask.shape[1]
            out_t = (t + 2 * self.padding
                     - ((self.kernelSize - 1) * self.dilation + 1)) \
                // self.stride + 1
            m = m[:, :out_t]
        return m

    def output_type(self, input_type):
        t = input_type.timeSeriesLength
        if t is not None:
            if self._same():
                t = -(-t // self.stride)
            else:
                t = (t + 2 * self.padding - ((self.kernelSize - 1)
                                             * self.dilation + 1)) \
                    // self.stride + 1
        return InputType.recurrent(self.nOut, t)

    def initialize(self, generator, input_type):
        if self.nIn is None:
            self.nIn = input_type.size
        w = init_weight(generator, (self.kernelSize, int(self.nIn),
                                    int(self.nOut)),
                        self.weightInit, self.dist)
        params = {"W": w}
        if self.hasBias:
            params["b"] = torch.full((int(self.nOut),), float(self.biasInit))
        return params, {}, self.output_type(input_type)

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        x = self._dropout_in(x, train, generator)
        if self._same():
            lo, hi = _same_padding(x.shape[1], self.kernelSize, self.stride,
                                   self.dilation)
        else:
            lo = hi = self.padding
        xc = F.pad(x.transpose(1, 2), (lo, hi))                 # B, F, T
        w = params["W"].to(x.dtype).permute(2, 1, 0)             # O, I, k
        y = F.conv1d(xc, w, stride=self.stride,
                     dilation=self.dilation).transpose(1, 2)
        if self.hasBias:
            y = y + params["b"].to(x.dtype)
        return get_activation(self.activation)(y), state


class Upsampling1D(Layer):
    """≡ conf.layers.Upsampling1D — nearest-neighbour repeat along time,
    (B, T, F)."""

    def __init__(self, size=2, **kw):
        super().__init__(**kw)
        self.size = int(size if not isinstance(size, (list, tuple))
                        else size[0])

    def output_type(self, input_type):
        t = input_type.timeSeriesLength
        return InputType.recurrent(input_type.size,
                                   None if t is None else t * self.size)

    def feed_forward_mask(self, mask):
        return None if mask is None else mask.repeat_interleave(self.size,
                                                                dim=1)

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        return x.repeat_interleave(self.size, dim=1), state


class Subsampling1DLayer(Layer):
    """≡ conf.layers.Subsampling1DLayer — (B, T, F) max or avg pooling
    over time; avg divides by the count of real (unpadded) steps."""

    def __init__(self, poolingType="max", kernelSize=2, stride=2, padding=0,
                 **kw):
        super().__init__(**kw)
        self.poolingType = str(poolingType).lower()
        self.kernelSize, self.stride = int(kernelSize), int(stride)
        self.padding = int(padding)

    def output_type(self, input_type):
        t = input_type.timeSeriesLength
        if t is not None:
            t = (t + 2 * self.padding - self.kernelSize) // self.stride + 1
        return InputType.recurrent(input_type.size, t)

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        p, k, s = self.padding, self.kernelSize, self.stride
        xc = x.transpose(1, 2)
        if self.poolingType == "max":
            y = F.max_pool1d(F.pad(xc, (p, p), value=float("-inf")), k, s)
        else:
            y = F.avg_pool1d(F.pad(xc, (p, p)), k, s) * k
            ones = torch.ones((1, 1, x.shape[1]), dtype=x.dtype,
                              device=x.device)
            y = y / (F.avg_pool1d(F.pad(ones, (p, p)), k, s) * k)
        return y.transpose(1, 2), state


class CnnLossLayer(BaseOutputLayer):
    """≡ conf.layers.CnnLossLayer — a per-pixel loss over an NHWC output,
    no parameters; labels (B, H, W, C)."""

    def pre_activation(self, params, x):
        return x

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        return get_activation(self.activation)(x), state

    def output_type(self, input_type):
        if not isinstance(input_type, ConvolutionalType):
            raise ValueError(
                f"CnnLossLayer '{self.name}' needs convolutional input, "
                f"got {input_type} (use Cnn3DLossLayer for 5-D volumes)")
        return input_type


class ElementWiseMultiplicationLayer(Layer):
    """≡ conf.layers.misc.ElementWiseMultiplicationLayer —
    y = act(x ⊙ W + b), a learned scale and bias per feature
    (nOut == nIn)."""

    def __init__(self, nIn=None, nOut=None, **kw):
        super().__init__(**kw)
        self.nIn, self.nOut = nIn, nOut

    def output_type(self, input_type):
        if (self.nOut is not None and self.nIn is not None
                and int(self.nOut) != int(self.nIn)):
            raise ValueError(
                f"ElementWiseMultiplicationLayer '{self.name}': nIn "
                f"({self.nIn}) must equal nOut ({self.nOut}) — it scales "
                "features elementwise, it cannot resize")
        n = self.nOut or self.nIn
        if isinstance(input_type, RecurrentType):
            return InputType.recurrent(n, input_type.timeSeriesLength)
        return InputType.feedForward(n)

    def initialize(self, generator, input_type):
        if self.nIn is None:
            self.nIn = input_type.size
        if self.nOut is None:
            self.nOut = self.nIn
        out = self.output_type(input_type)
        n = int(self.nIn)
        return ({"W": torch.ones((n,)),
                 "b": torch.full((n,), float(self.biasInit))}, {}, out)

    def pre_activation(self, params, x):
        return x * params["W"].to(x.dtype) + params["b"].to(x.dtype)

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        x = self._dropout_in(x, train, generator)
        return (get_activation(self.activation)(
            self.pre_activation(params, x)), state)


def FrozenLayer(layer):
    """≡ conf.layers.misc.FrozenLayer — a frozen copy of a layer config:
    NoOp updates, no regularization, and the layer always runs in
    inference mode during training (no dropout, BN running statistics
    pinned). A flagged deep copy, so isinstance checks and preprocessor
    inference still see the wrapped layer's own type."""
    import copy

    from deeplearning4j_tpu_torch.nn.updaters import NoOp
    if isinstance(layer, _Builder):
        layer = layer.build()
    layer = copy.deepcopy(layer)
    layer.frozen = True
    layer.updater = NoOp()
    layer.l1 = 0.0
    layer.l2 = 0.0
    layer.weightDecay = 0.0
    return layer


def FrozenLayerWithBackprop(layer):
    """≡ conf.layers.misc.FrozenLayerWithBackprop — parameters frozen
    (NoOp updates, and detached in the forward, so not even
    regularization reaches them) while the layer keeps its train-time
    behaviour (dropout stays on) and gradients still flow through its
    outputs to everything upstream."""
    import copy

    from deeplearning4j_tpu_torch.nn.updaters import NoOp
    if isinstance(layer, _Builder):
        layer = layer.build()
    layer = copy.deepcopy(layer)
    layer.frozen_params = True
    layer.updater = NoOp()
    layer.l1 = 0.0
    layer.l2 = 0.0
    layer.weightDecay = 0.0
    return layer
