"""The 3-D CNN layer family: the port of `deeplearning4j_tpu/nn/conf/layers3d.py`
(≡ deeplearning4j-nn :: conf.layers.Convolution3D / Subsampling3DLayer /
Upsampling3D / Cropping3D / ZeroPadding3DLayer / Cnn3DLossLayer /
Deconvolution3D).

NDHWC activations and DHWIO kernels, as in the JAX package; cuDNN takes
the NCDHW view of the activation and the kernel permuted to OIDHW at the
call. SAME padding puts the odd pad at the end (an uneven pad goes
through `F.pad` first); pooling pads with −inf (max) or zeros (avg,
divided by the count of real inputs in the window)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf.inputs import (Convolutional3DType,
                                                     InputType)
from deeplearning4j_tpu_torch.nn.conf.layers import (BaseOutputLayer, Layer,
                                                     _same_padding,
                                                     conv_transpose,
                                                     conv_transpose_pads)
from deeplearning4j_tpu_torch.nn.weights_init import init_weight


def _triple(v):
    if isinstance(v, (tuple, list)):
        if len(v) != 3:
            raise ValueError(f"expected 3 values, got {v}")
        return tuple(int(x) for x in v)
    return (int(v),) * 3


def _out_dim(size, k, s, p, dilation, same):
    if same:
        return -(-size // s)
    return (size + 2 * p - ((k - 1) * dilation + 1)) // s + 1


def _ncdhw(x):
    return x.permute(0, 4, 1, 2, 3)


def _ndhwc(y):
    return y.permute(0, 2, 3, 4, 1)


def _needs_3d(layer, input_type):
    if not isinstance(input_type, Convolutional3DType):
        raise ValueError(
            f"{type(layer).__name__} '{layer.name}' needs convolutional3D "
            f"(D,H,W,C) input, got {input_type}")


def _pads(layer, spatial, dilation=(1, 1, 1)):
    """F.pad's list (last dim first) of the layer's padding of `spatial`
    (D, H, W): SAME with the odd pad at the end, else (p, p)."""
    if layer._same():
        pads = [_same_padding(n, k, s, d) for n, k, s, d in zip(
            spatial, layer.kernelSize, layer.stride, dilation)]
    else:
        pads = [(p, p) for p in layer.padding]
    return [v for lo_hi in reversed(pads) for v in lo_hi]


class Convolution3D(Layer):
    """≡ conf.layers.Convolution3D — NDHWC in, DHWIO kernel."""

    def __init__(self, nIn=None, nOut=None, kernelSize=(3, 3, 3),
                 stride=(1, 1, 1), padding=(0, 0, 0), dilation=(1, 1, 1),
                 convolutionMode="truncate", hasBias=True, **kw):
        super().__init__(**kw)
        self.nIn, self.nOut = nIn, nOut
        self.kernelSize, self.stride = _triple(kernelSize), _triple(stride)
        self.padding, self.dilation = _triple(padding), _triple(dilation)
        self.convolutionMode = convolutionMode
        self.hasBias = hasBias

    def _same(self):
        return str(self.convolutionMode).lower() == "same"

    def output_type(self, input_type):
        _needs_3d(self, input_type)
        if self.nOut is None:
            raise ValueError(
                f"{type(self).__name__} '{self.name}': nOut is required")
        dims = [_out_dim(s, k, st, p, d, self._same()) for s, k, st, p, d in
                zip(input_type.shape()[:3], self.kernelSize, self.stride,
                    self.padding, self.dilation)]
        return InputType.convolutional3D(*dims, self.nOut)

    def initialize(self, generator, input_type):
        _needs_3d(self, input_type)
        if self.nIn is None:
            self.nIn = input_type.channels
        kd, kh, kw = self.kernelSize
        params = {"W": init_weight(generator, (kd, kh, kw, int(self.nIn),
                                               int(self.nOut)),
                                   self.weightInit, self.dist)}
        if self.hasBias:
            params["b"] = torch.full((int(self.nOut),), float(self.biasInit))
        return params, {}, self.output_type(input_type)

    def pre_activation(self, params, x):
        w = params["W"].to(x.dtype).permute(4, 3, 0, 1, 2)       # OIDHW
        xc = F.pad(_ncdhw(x), _pads(self, x.shape[1:4], self.dilation))
        y = _ndhwc(F.conv3d(xc, w, stride=self.stride,
                            dilation=self.dilation))
        if self.hasBias:
            y = y + params["b"].to(x.dtype)
        return y

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        x = self._dropout_in(x, train, generator)
        return get_activation(self.activation)(
            self.pre_activation(params, x)), state


class Subsampling3DLayer(Layer):
    """≡ conf.layers.Subsampling3DLayer — max/avg pooling over (D, H, W)."""

    def __init__(self, poolingType="max", kernelSize=(2, 2, 2),
                 stride=(2, 2, 2), padding=(0, 0, 0),
                 convolutionMode="truncate", **kw):
        super().__init__(**kw)
        self.poolingType = str(poolingType).lower()
        self.kernelSize, self.stride = _triple(kernelSize), _triple(stride)
        self.padding = _triple(padding)
        self.convolutionMode = convolutionMode

    def _same(self):
        return str(self.convolutionMode).lower() == "same"

    def output_type(self, input_type):
        _needs_3d(self, input_type)
        dims = [_out_dim(s, k, st, p, 1, self._same()) for s, k, st, p in
                zip(input_type.shape()[:3], self.kernelSize, self.stride,
                    self.padding)]
        return InputType.convolutional3D(*dims, input_type.channels)

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        pads = _pads(self, x.shape[1:4])
        xc = _ncdhw(x)
        k, s = self.kernelSize, self.stride
        if self.poolingType == "max":
            y = F.max_pool3d(F.pad(xc, pads, value=float("-inf")), k, s)
        elif self.poolingType in ("avg", "mean"):
            vol = k[0] * k[1] * k[2]
            total = F.avg_pool3d(F.pad(xc, pads), k, s) * vol
            ones = torch.ones((1, 1) + tuple(x.shape[1:4]), dtype=x.dtype,
                              device=x.device)
            y = total / (F.avg_pool3d(F.pad(ones, pads), k, s) * vol)
        else:
            raise ValueError(f"Unknown poolingType {self.poolingType}")
        return _ndhwc(y), state


class Upsampling3D(Layer):
    """≡ conf.layers.Upsampling3D — nearest-neighbour repeat over D/H/W."""

    def __init__(self, size=2, **kw):
        super().__init__(**kw)
        self.size = _triple(size)

    def output_type(self, input_type):
        _needs_3d(self, input_type)
        d, h, w, c = input_type.shape()
        return InputType.convolutional3D(d * self.size[0], h * self.size[1],
                                         w * self.size[2], c)

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        for axis, rep in zip((1, 2, 3), self.size):
            x = x.repeat_interleave(rep, dim=axis)
        return x, state


class Cropping3D(Layer):
    """≡ conf.layers.Cropping3D — crop (front, back) per spatial dim."""

    def __init__(self, cropping=(0, 0, 0, 0, 0, 0), **kw):
        super().__init__(**kw)
        c = cropping
        if isinstance(c, int):
            c = (c,) * 6
        elif len(c) == 3 and all(isinstance(v, (tuple, list)) for v in c):
            c = tuple(int(x) for pair in c for x in pair)
        elif len(c) == 3:
            c = tuple(int(v) for v in c for _ in (0, 1))
        self.cropping = tuple(int(v) for v in c)  # (d0,d1,h0,h1,w0,w1)

    def output_type(self, input_type):
        _needs_3d(self, input_type)
        d0, d1, h0, h1, w0, w1 = self.cropping
        d, h, w, c = input_type.shape()
        return InputType.convolutional3D(d - d0 - d1, h - h0 - h1,
                                         w - w0 - w1, c)

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        d0, d1, h0, h1, w0, w1 = self.cropping
        D, H, W = x.shape[1], x.shape[2], x.shape[3]
        return x[:, d0:D - d1, h0:H - h1, w0:W - w1, :], state


class ZeroPadding3DLayer(Layer):
    """≡ conf.layers.ZeroPadding3DLayer."""

    def __init__(self, padding=(1, 1, 1, 1, 1, 1), **kw):
        super().__init__(**kw)
        p = padding
        if isinstance(p, int):
            p = (p,) * 6
        elif len(p) == 3 and all(isinstance(v, (tuple, list)) for v in p):
            p = tuple(int(x) for pair in p for x in pair)
        elif len(p) == 3:
            p = tuple(int(v) for v in p for _ in (0, 1))
        self.padding = tuple(int(v) for v in p)

    def output_type(self, input_type):
        _needs_3d(self, input_type)
        d0, d1, h0, h1, w0, w1 = self.padding
        d, h, w, c = input_type.shape()
        return InputType.convolutional3D(d + d0 + d1, h + h0 + h1,
                                         w + w0 + w1, c)

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        d0, d1, h0, h1, w0, w1 = self.padding
        return F.pad(x, (0, 0, w0, w1, h0, h1, d0, d1)), state


class Cnn3DLossLayer(BaseOutputLayer):
    """≡ conf.layers.Cnn3DLossLayer — a per-voxel loss over an NDHWC
    output, no parameters."""

    def pre_activation(self, params, x):
        return x

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        return get_activation(self.activation)(x), state

    def output_type(self, input_type):
        if not isinstance(input_type, Convolutional3DType):
            raise ValueError(
                f"Cnn3DLossLayer '{self.name}' needs convolutional3D "
                f"(D,H,W,C) input, got {input_type} (use CnnLossLayer "
                "for 2-D feature maps)")
        return input_type


class Deconvolution3D(Layer):
    """≡ conf.layers.Deconvolution3D — transposed volumetric convolution,
    NDHWC/DHWIO, computing what the JAX package's `lax.conv_transpose`
    computes (`layers.conv_transpose`); its declared output type is the JAX
    package's, as for Deconvolution2D."""

    def __init__(self, nIn=None, nOut=None, kernelSize=(2, 2, 2),
                 stride=(2, 2, 2), padding=(0, 0, 0),
                 convolutionMode="truncate", hasBias=True, **kw):
        super().__init__(**kw)
        self.nIn, self.nOut = nIn, nOut
        self.kernelSize, self.stride = _triple(kernelSize), _triple(stride)
        self.padding = _triple(padding)
        self.convolutionMode = convolutionMode
        self.hasBias = hasBias

    def _same(self):
        return str(self.convolutionMode).lower() == "same"

    def output_type(self, input_type):
        _needs_3d(self, input_type)
        if self.nOut is None:
            raise ValueError(
                f"Deconvolution3D '{self.name}': nOut is required")
        if self._same():
            dims = [n * s for n, s in zip(input_type.shape()[:3],
                                          self.stride)]
        else:
            dims = [s * (n - 1) + k - 2 * p for n, k, s, p in zip(
                input_type.shape()[:3], self.kernelSize, self.stride,
                self.padding)]
        return InputType.convolutional3D(*dims, self.nOut)

    def initialize(self, generator, input_type):
        if self.nIn is None:
            self.nIn = input_type.channels
        kd, kh, kw = self.kernelSize
        params = {"W": init_weight(generator, (kd, kh, kw, int(self.nIn),
                                               int(self.nOut)),
                                   self.weightInit, self.dist)}
        if self.hasBias:
            params["b"] = torch.full((int(self.nOut),), float(self.biasInit))
        return params, {}, self.output_type(input_type)

    def pre_activation(self, params, x):
        w = params["W"]
        y = conv_transpose(x, w, self.stride, conv_transpose_pads(
            w.shape[:3], self.stride, self.padding, self._same()))
        if self.hasBias:
            y = y + params["b"].to(x.dtype)
        return y

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        x = self._dropout_in(x, train, generator)
        return get_activation(self.activation)(
            self.pre_activation(params, x)), state
