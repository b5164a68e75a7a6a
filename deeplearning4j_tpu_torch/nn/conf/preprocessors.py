"""Input preprocessors (≡ deeplearning4j-nn :: conf.preprocessor.*), copied
from `deeplearning4j_tpu/nn/conf/preprocessors.py`, which has no jax in it.

Pure reshape/transpose adapters between layer families. NHWC throughout.
"""
from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf.inputs import (
    ConvolutionalType, FeedForwardType, InputType, RecurrentType)


class InputPreProcessor:
    def preProcess(self, x):
        raise NotImplementedError

    def getOutputType(self, input_type):
        raise NotImplementedError


class FeedForwardToCnnPreProcessor(InputPreProcessor):
    def __init__(self, height, width, channels):
        self.height, self.width, self.channels = int(height), int(width), int(channels)

    def preProcess(self, x):
        return x.reshape(x.shape[0], self.height, self.width, self.channels)

    def getOutputType(self, input_type):
        return InputType.convolutional(self.height, self.width, self.channels)


class CnnToFeedForwardPreProcessor(InputPreProcessor):
    def __init__(self, height=None, width=None, channels=None):
        self.height, self.width, self.channels = height, width, channels

    def preProcess(self, x):
        return x.reshape(x.shape[0], -1)

    def getOutputType(self, input_type):
        if isinstance(input_type, ConvolutionalType):
            return InputType.feedForward(input_type.arrayElementsPerExample())
        return input_type


class FeedForwardToRnnPreProcessor(InputPreProcessor):
    """(B*T, F) -> (B, T, F) is impossible without T; here the DL4J semantic
    is: treat FF activations as single-timestep sequences."""

    def preProcess(self, x):
        return x[:, None, :]

    def getOutputType(self, input_type):
        return InputType.recurrent(input_type.size, 1)


class RnnToFeedForwardPreProcessor(InputPreProcessor):
    """(B, T, F) -> (B*T, F) (the reference folds time into batch)."""

    def preProcess(self, x):
        b, t, f = x.shape
        return x.reshape(b * t, f)

    def getOutputType(self, input_type):
        return InputType.feedForward(input_type.size)


class RnnToCnnPreProcessor(InputPreProcessor):
    def __init__(self, height, width, channels):
        self.height, self.width, self.channels = int(height), int(width), int(channels)

    def preProcess(self, x):
        b, t, f = x.shape
        return x.reshape(b * t, self.height, self.width, self.channels)

    def getOutputType(self, input_type):
        return InputType.convolutional(self.height, self.width, self.channels)


class CnnToRnnPreProcessor(InputPreProcessor):
    """(B, H, W, C) -> (B, 1, H*W*C)."""

    def preProcess(self, x):
        return x.reshape(x.shape[0], 1, -1)

    def getOutputType(self, input_type):
        return InputType.recurrent(input_type.arrayElementsPerExample(), 1)


class Cnn3DToFeedForwardPreProcessor(InputPreProcessor):
    """≡ preprocessor.Cnn3DToFeedForwardPreProcessor — flatten NDHWC."""

    def __init__(self, depth=None, height=None, width=None, channels=None):
        self.depth, self.height = depth, height
        self.width, self.channels = width, channels

    def preProcess(self, x):
        return x.reshape(x.shape[0], -1)

    def getOutputType(self, input_type):
        from deeplearning4j_tpu_torch.nn.conf.inputs import Convolutional3DType
        if isinstance(input_type, Convolutional3DType):
            return InputType.feedForward(input_type.arrayElementsPerExample())
        return input_type
