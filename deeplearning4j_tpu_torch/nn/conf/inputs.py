"""InputType system (≡ deeplearning4j-nn :: conf.inputs.InputType), copied
from `deeplearning4j_tpu/nn/conf/inputs.py`, which has no jax in it.

Shapes are *per-example* (no batch dim). CNN activations are NHWC, as in
the JAX package (the reference is NCHW): a 1×1 conv over (B, H, W, C) is
then a (B·H·W, C) matrix with no copy.
"""
from __future__ import annotations

from dataclasses import dataclass


class InputType:
    @staticmethod
    def feedForward(size):
        return FeedForwardType(int(size))

    @staticmethod
    def convolutional(height, width, channels):
        return ConvolutionalType(int(height), int(width), int(channels))

    @staticmethod
    def convolutionalFlat(height, width, channels):
        return ConvolutionalFlatType(int(height), int(width), int(channels))

    @staticmethod
    def convolutional3D(depth, height, width, channels):
        return Convolutional3DType(int(depth), int(height), int(width),
                                   int(channels))

    @staticmethod
    def recurrent(size, timeSeriesLength=None):
        return RecurrentType(int(size), timeSeriesLength)


@dataclass(frozen=True)
class FeedForwardType(InputType):
    size: int

    def arrayElementsPerExample(self):
        return self.size

    def shape(self):
        return (self.size,)


@dataclass(frozen=True)
class ConvolutionalType(InputType):
    """NHWC activation: (height, width, channels)."""
    height: int
    width: int
    channels: int

    def arrayElementsPerExample(self):
        return self.height * self.width * self.channels

    def shape(self):
        return (self.height, self.width, self.channels)


@dataclass(frozen=True)
class ConvolutionalFlatType(InputType):
    """Flattened image rows (e.g. raw MNIST vectors): needs a
    FeedForwardToCnnPreProcessor before any conv layer."""
    height: int
    width: int
    channels: int

    def arrayElementsPerExample(self):
        return self.height * self.width * self.channels

    def shape(self):
        return (self.height * self.width * self.channels,)


@dataclass(frozen=True)
class Convolutional3DType(InputType):
    """NDHWC activation: (depth, height, width, channels) — the TPU-native
    volumetric layout (the reference's Convolution3D is NCDHW)."""
    depth: int
    height: int
    width: int
    channels: int

    def arrayElementsPerExample(self):
        return self.depth * self.height * self.width * self.channels

    def shape(self):
        return (self.depth, self.height, self.width, self.channels)


@dataclass(frozen=True)
class RecurrentType(InputType):
    """(time, size) per example — batch-major (B, T, F) arrays."""
    size: int
    timeSeriesLength: object = None

    def arrayElementsPerExample(self):
        t = self.timeSeriesLength or 1
        return self.size * t

    def shape(self):
        return (self.timeSeriesLength, self.size)
