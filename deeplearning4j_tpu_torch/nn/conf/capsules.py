"""Capsule-network layers: the port of `deeplearning4j_tpu/nn/conf/capsules.py`
(≡ deeplearning4j-nn :: conf.layers.CapsuleLayer / PrimaryCapsules /
CapsuleStrengthLayer, Sabour et al. 2017, and the one-class
conf.ocnn.OCNNOutputLayer, Chalapathy et al.).

Capsule sets are (B, N, D) tensors (N capsules of dimension D) under the
recurrent InputType (size = D, timeSeriesLength = N), as in the JAX
package. Dynamic routing runs its `routings` iterations as three einsums
each, the coupling logits in f32, with the agreement reading v detached
(no gradient through the routing's updates)."""
from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import (ConvolutionalType,
                                                     InputType,
                                                     RecurrentType)
from deeplearning4j_tpu_torch.nn.conf.layers import (BaseOutputLayer, Layer,
                                                     _nchw, _nhwc)
from deeplearning4j_tpu_torch.nn.weights_init import init_weight


def squash(s, dim=-1, eps=1e-8):
    """v = (|s|²/(1+|s|²)) · s/|s|: the capsule nonlinearity."""
    n2 = (s * s).sum(dim=dim, keepdim=True)
    return (n2 / (1.0 + n2)) * s * torch.rsqrt(n2 + eps)


class PrimaryCapsules(Layer):
    """≡ conf.layers.PrimaryCapsules — a VALID convolution (HWIO kernel
    (kh, kw, C, channels·capsuleDimensions)), its NHWC output grouped into
    capsules of capsuleDimensions, squashed: (B, H, W, C) →
    (B, H'·W'·channels, capsuleDimensions). The grouping reads the
    channels-last order, as the JAX package's reshape does."""

    def __init__(self, capsuleDimensions=8, channels=8, kernelSize=(9, 9),
                 stride=(2, 2), hasBias=True, **kw):
        super().__init__(**kw)
        self.capsuleDimensions = int(capsuleDimensions)
        self.channels = int(channels)
        self.kernelSize = (kernelSize if isinstance(kernelSize, (tuple, list))
                           else (kernelSize, kernelSize))
        self.stride = (stride if isinstance(stride, (tuple, list))
                       else (stride, stride))
        self.hasBias = hasBias

    def _out_hw(self, input_type):
        kh, kw = self.kernelSize
        sh, sw = self.stride
        return ((input_type.height - kh) // sh + 1,
                (input_type.width - kw) // sw + 1)

    def output_type(self, input_type):
        if not isinstance(input_type, ConvolutionalType):
            raise ValueError(
                f"PrimaryCapsules '{self.name}' needs convolutional input, "
                f"got {input_type}")
        oh, ow = self._out_hw(input_type)
        return InputType.recurrent(self.capsuleDimensions,
                                   oh * ow * self.channels)

    def initialize(self, generator, input_type):
        kh, kw = self.kernelSize
        c_out = self.channels * self.capsuleDimensions
        params = {"W": init_weight(generator, (kh, kw, input_type.channels,
                                               c_out),
                                   self.weightInit, self.dist)}
        if self.hasBias:
            params["b"] = torch.zeros((c_out,))
        return params, {}, self.output_type(input_type)

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        x = self._dropout_in(x, train, generator)
        w = params["W"].to(x.dtype).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)                 # OIHW
        y = _nhwc(torch.nn.functional.conv2d(_nchw(x), w,
                                             stride=tuple(self.stride)))
        if self.hasBias:
            y = y + params["b"].to(x.dtype)
        caps = y.reshape(y.shape[0], -1, self.capsuleDimensions)
        return squash(caps), state


class CapsuleLayer(Layer):
    """≡ conf.layers.CapsuleLayer — fully connected capsules with dynamic
    routing by agreement: (B, N_in, D_in) → (B, capsules,
    capsuleDimensions), W (N_in, capsules, D_in, capsuleDimensions)."""

    def __init__(self, capsules=10, capsuleDimensions=16, routings=3, **kw):
        super().__init__(**kw)
        self.capsules = int(capsules)
        self.capsuleDimensions = int(capsuleDimensions)
        self.routings = int(routings)

    def output_type(self, input_type):
        if not isinstance(input_type, RecurrentType):
            raise ValueError(
                f"CapsuleLayer '{self.name}' needs capsule (B, N, D) input "
                f"(recurrent InputType), got {input_type}")
        return InputType.recurrent(self.capsuleDimensions, self.capsules)

    def initialize(self, generator, input_type):
        n_in = int(input_type.timeSeriesLength)
        d_in = int(input_type.size)
        w = init_weight(generator,
                        (n_in, self.capsules, d_in, self.capsuleDimensions),
                        self.weightInit, self.dist)
        return {"W": w}, {}, self.output_type(input_type)

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        x = self._dropout_in(x, train, generator)
        dt = x.dtype
        # the predictions û_{j|i}: (B, N_in, N_out, D_out)
        u_hat = torch.einsum("bnd,nmde->bnme", x, params["W"].to(dt))
        logits = torch.zeros(u_hat.shape[:3], dtype=torch.float32,
                             device=x.device)
        v = None
        for it in range(self.routings):
            c = torch.softmax(logits, dim=2).to(dt)
            v = squash(torch.einsum("bnm,bnme->bme", c, u_hat))
            if it + 1 < self.routings:
                agree = torch.einsum("bnme,bme->bnm", u_hat, v.detach())
                logits = logits + agree.float()
        return v, state


class CapsuleStrengthLayer(Layer):
    """≡ conf.layers.CapsuleStrengthLayer — capsule lengths, (B, N, D) →
    (B, N)."""

    def output_type(self, input_type):
        if not isinstance(input_type, RecurrentType):
            raise ValueError(
                f"CapsuleStrengthLayer '{self.name}' needs capsule input, "
                f"got {input_type}")
        return InputType.feedForward(input_type.timeSeriesLength)

    def feed_forward_mask(self, mask):
        return None

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        return torch.sqrt((x * x).sum(dim=-1) + 1e-12), state


class OCNNOutputLayer(BaseOutputLayer):
    """≡ conf.ocnn.OCNNOutputLayer — a one-class network for anomaly
    detection: score(x) = sigmoid(x·V)·w, trained with the OC-NN objective
    L = (1/ν)·mean(relu(r − score)) − r, r a trainable scalar driven to the
    ν-quantile of the scores. Labels are ignored; `output()` is the score."""

    #: the loss reads the layer's parameters (r) through the
    #: feature-dependent loss protocol
    needs_features = True

    def __init__(self, hiddenLayerSize=10, nu=0.04, initialRValue=0.1, **kw):
        kw.setdefault("lossFunction", "mcxent")  # unused; protocol filler
        kw.setdefault("activation", "identity")
        super().__init__(**kw)
        self.hiddenLayerSize = int(hiddenLayerSize)
        self.nu = float(nu)
        self.initialRValue = float(initialRValue)
        self.nIn = kw.get("nIn")
        self.nOut = 1

    def validate(self):
        Layer.validate(self)

    def apply_defaults(self, defaults):
        Layer.apply_defaults(self, defaults)
        if self.activation is None:
            self.activation = "identity"
        return self

    def output_type(self, input_type):
        return InputType.feedForward(1)

    def initialize(self, generator, input_type):
        if self.nIn is None:
            self.nIn = input_type.size
        return ({"V": init_weight(generator, (int(self.nIn),
                                              self.hiddenLayerSize),
                                  self.weightInit, self.dist),
                 "w": init_weight(generator, (self.hiddenLayerSize, 1),
                                  self.weightInit, self.dist),
                 "r": torch.tensor(self.initialRValue)},
                {}, self.output_type(input_type))

    def pre_activation(self, params, x):
        h = torch.sigmoid(x @ params["V"].to(x.dtype))
        return h @ params["w"].to(x.dtype)                   # (B, 1) score

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        return self.pre_activation(params, x), state

    def compute_loss_with_features(self, params, labels, preact, feats,
                                   mask=None):
        r = params["r"]
        score = preact[:, 0]
        return torch.relu(r - score).mean() / self.nu - r
