"""Layer configurations: the port of the part of
`deeplearning4j_tpu/nn/conf/layers.py` that ResNet-50 and its heads use
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
dropout on the layer input at train time.

Ported so far: DenseLayer, ConvolutionLayer, SubsamplingLayer,
BatchNormalization, ActivationLayer, DropoutLayer, GlobalPoolingLayer and
OutputLayer. The other layer families come with ROADMAP A12.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf.inputs import (ConvolutionalType,
                                                     InputType,
                                                     RecurrentType)
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

    def apply(self, params, state, x, train=False, generator=None):
        return x, state

    # -- helpers ---------------------------------------------------------
    def regularization_terms(self):
        """(l1, l2) of the score's weight penalty (≡ the reference's
        per-layer regularization)."""
        return (self.l1 or 0.0), (self.l2 or 0.0)

    def _dropout_in(self, x, train, generator):
        """Inverted dropout on the input at train time, drawn from
        `generator` (on x's device); None means no dropout, as a None rng
        does in the JAX package."""
        p = self.dropOut
        if not train or p is None or generator is None:
            return x
        if p == 0.0 or p == 1.0:
            return x
        keep = torch.rand(x.shape, generator=generator,
                          device=x.device) < p
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
        if getattr(self, "precisionPolicy", None) is not None:
            raise NotImplementedError(
                "precisionPolicy (QAT fake-quant) comes with the int8 "
                "slice (ROADMAP A13)")
        y = x @ params["W"].to(x.dtype)
        if self.hasBias:
            y = y + params["b"].to(x.dtype)
        return y

    def apply(self, params, state, x, train=False, generator=None):
        x = self._dropout_in(x, train, generator)
        return (get_activation(self.activation)(self.pre_activation(params,
                                                                    x)),
                state)


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

    def pre_activation(self, params, x):
        if getattr(self, "precisionPolicy", None) is not None:
            raise NotImplementedError(
                "precisionPolicy (QAT fake-quant) comes with the int8 "
                "slice (ROADMAP A13)")
        cl = torch.channels_last
        w = params["W"].to(x.dtype).permute(3, 2, 0, 1).contiguous(
            memory_format=cl)                                  # OIHW
        (plh, phh), (plw, phw) = self._explicit_padding(x.shape[1],
                                                        x.shape[2])
        xc = _nchw(x)
        if plh == phh and plw == phw:
            pad = (plh, plw)
        else:
            xc = F.pad(xc, (plw, phw, plh, phh)).contiguous(memory_format=cl)
            pad = (0, 0)
        y = _nhwc(F.conv2d(xc, w, stride=self.stride, padding=pad,
                           dilation=self.dilation))
        if self.hasBias:
            y = y + params["b"].to(x.dtype)
        return y

    def apply(self, params, state, x, train=False, generator=None):
        x = self._dropout_in(x, train, generator)
        return (get_activation(self.activation)(self.pre_activation(params,
                                                                    x)),
                state)


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

    def apply(self, params, state, x, train=False, generator=None):
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
    (deeplearning4j_tpu/nn/conf/layers.py:792-829):
      dβ = Σdy, dγ = Σdy·x̂, dx = k1·dy − (x − μ)·k2 − c
    with k1 = γr, k2 = γr²·dγ/n, c = γr·dβ/n cast to x.dtype, instead of
    autograd's passes through the mean/var chain. Returns (y, μ, var); μ
    and var feed only the running averages and get no gradient."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        mu, var = _bn_stats(x)
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
        k1 = (gamma * r).to(x.dtype)
        k2 = (gamma * r * r * dgamma / n).to(x.dtype)
        c = (gamma * r * (dbeta / n)).to(x.dtype)
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

    def apply(self, params, state, x, train=False, generator=None):
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

    def apply(self, params, state, x, train=False, generator=None):
        return get_activation(self.activation)(x), state


class DropoutLayer(Layer):
    """≡ conf.layers.DropoutLayer — dropOut is the RETAIN probability."""

    def __init__(self, dropOut=0.5, **kw):
        super().__init__(dropOut=dropOut, **kw)

    def apply(self, params, state, x, train=False, generator=None):
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

    def apply(self, params, state, x, train=False, generator=None):
        axes = (1, 2) if x.ndim == 4 else (1,)
        if self.poolingType == "max":
            y = x.amax(dim=axes)
        elif self.poolingType in ("avg", "mean"):
            y = x.mean(dim=axes)
        elif self.poolingType == "sum":
            y = x.sum(dim=axes)
        elif self.poolingType == "pnorm":
            y = (x.abs() ** self.pnorm).sum(dim=axes) ** (1.0 / self.pnorm)
        else:
            raise ValueError(f"Unknown poolingType {self.poolingType}")
        return y, state


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
