"""Sequence utility layers: the port of
`deeplearning4j_tpu/nn/conf/sequence_layers.py` (≡ deeplearning4j-nn ::
conf.layers.util.MaskLayer / conf.layers.recurrent.MaskZeroLayer /
conf.layers.RnnLossLayer).

Feature masks are (B, T) with 1 = valid; masked steps emit zeros and
recurrent carries hold."""
from __future__ import annotations

from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf.layers import BaseOutputLayer, Layer

__all__ = ["MaskLayer", "MaskZeroLayer", "RnnLossLayer"]


class MaskLayer(Layer):
    """≡ conf.layers.util.MaskLayer — zeroes the padded steps of the
    activations under the current feature mask. No parameters."""

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        if mask is not None:
            x = x * mask.to(x.dtype)[:, :, None]
        return x, state


class MaskZeroLayer(Layer):
    """≡ conf.layers.recurrent.MaskZeroLayer — wraps a recurrent layer and
    derives the time mask from the data: a step whose every feature equals
    `maskingValue` is padding."""

    is_recurrent = True

    @classmethod
    def _builder_positional(cls, args):
        if len(args) == 1:
            return {"layer": args[0]}
        if len(args) == 2:
            return {"layer": args[0], "maskingValue": args[1]}
        return {}

    def __init__(self, layer=None, maskingValue=0.0, **kw):
        super().__init__(**kw)
        if layer is None:
            raise ValueError("MaskZeroLayer requires a wrapped layer")
        self.inner = layer
        self.maskingValue = float(maskingValue)

    def apply_defaults(self, defaults):
        super().apply_defaults(defaults)
        self.inner.apply_defaults(defaults)
        return self

    @property
    def nOut(self):
        return self.inner.nOut

    @property
    def nIn(self):
        return self.inner.nIn

    @nIn.setter
    def nIn(self, v):
        self.inner.nIn = v

    def output_type(self, input_type):
        return self.inner.output_type(input_type)

    def initialize(self, generator, input_type):
        return self.inner.initialize(generator, input_type)

    def _derived_mask(self, x):
        return (x != self.maskingValue).any(dim=-1).to(x.dtype)

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        derived = self._derived_mask(x)
        if mask is not None:
            derived = derived * mask.to(x.dtype)
        return self.inner.apply(params, state, x, train=train,
                                generator=generator, mask=derived)


class RnnLossLayer(BaseOutputLayer):
    """≡ conf.layers.RnnLossLayer — a per-step loss over (B, T, C) with no
    parameters (the layer before gives the logits); label masks as in
    RnnOutputLayer."""

    def pre_activation(self, params, x):
        return x

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        return get_activation(self.activation)(x), state

    def output_type(self, input_type):
        return input_type

