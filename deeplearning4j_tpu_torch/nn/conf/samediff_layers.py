"""User-defined custom layers: the port of
`deeplearning4j_tpu/nn/conf/samediff_layers.py` (≡ deeplearning4j-nn ::
conf.layers.samediff.SameDiffLayer / SameDiffLambdaLayer /
SameDiffOutputLayer / SameDiffVertex).

The reference lets a user define a layer by writing its forward as a
SameDiff graph. Here the user writes it as a function of torch tensors and
declares the parameters' shapes; autograd through the network's step
differentiates it, so a custom layer trains like a built-in one:

    class TimesPlus(SameDiffLayer):
        def __init__(self, nOut=None, **kw):
            super().__init__(**kw)
            self.nOut = nOut
        def defineParameters(self):
            return {"W": (self.nIn, self.nOut), "b": (self.nOut,)}
        def defineLayer(self, params, x, mask=None):
            return torch.tanh(x @ params["W"] + params["b"])

    net = ...list().layer(TimesPlus(nOut=8))...

A custom class round-trips through the port's archives
(`util/model_serializer.py`): the configuration records its defining
module, which must be imported (or trusted with
`util.serde.registerCustomModule`) when the archive is read. Custom layers
are framework code, the JAX package's written on jax arrays and the
port's on torch tensors, so an archive with one does not move between the
two packages; every built-in layer does.
"""
from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.conf.graph_vertices import GraphVertex
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType, RecurrentType
from deeplearning4j_tpu_torch.nn.conf.layers import Layer
from deeplearning4j_tpu_torch.nn.weights_init import init_weight


def _draw(layer, generator, shapes):
    """{name: tensor} of `shapes`, drawn in name order by the layer's
    initializeParameters."""
    params = {}
    for name in sorted(shapes):
        params[name] = layer.initializeParameters(
            generator, name, tuple(int(d) for d in shapes[name]))
    return params


class SameDiffLayer(Layer):
    """Base class for user-defined layers (≡ samediff.SameDiffLayer).

    Subclasses implement:
      - defineParameters() -> {name: shape tuple}  (may be empty)
      - defineLayer(params, x, mask=None) -> output tensor
      - getOutputType(input_type) -> InputType  (optional; defaults to
        feedForward(nOut) / recurrent(nOut) shape-preserving inference)
    Optional: initializeParameters(generator, name, shape) to override the
    default weightInit initializer for specific parameters.
    """

    def __init__(self, nIn=None, nOut=None, **kw):
        super().__init__(**kw)
        self.nIn, self.nOut = nIn, nOut

    # -- user surface ----------------------------------------------------
    def defineParameters(self):
        return {}

    def defineLayer(self, params, x, mask=None):
        raise NotImplementedError(
            f"{type(self).__name__} must implement defineLayer(params, x)")

    def initializeParameters(self, generator, name, shape):
        """Default: weightInit for >=2-D params, zeros for 1-D (biases)."""
        if len(shape) >= 2:
            return init_weight(generator, shape, self.weightInit, self.dist)
        return torch.zeros(shape)

    def getOutputType(self, input_type):
        n_out = self.nOut if self.nOut is not None else getattr(
            input_type, "size", None)
        if n_out is None:
            return input_type
        if isinstance(input_type, RecurrentType):
            return InputType.recurrent(n_out, input_type.timeSeriesLength)
        return InputType.feedForward(n_out)

    # -- framework bridge ------------------------------------------------
    def output_type(self, input_type):
        return self.getOutputType(input_type)

    def initialize(self, generator, input_type):
        if self.nIn is None:
            self.nIn = getattr(input_type, "size", None) or getattr(
                input_type, "channels", None)
        params = _draw(self, generator, self.defineParameters())
        return params, {}, self.output_type(input_type)

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        x = self._dropout_in(x, train, generator)
        return self.defineLayer(params, x, mask=mask), state


class SameDiffLambdaLayer(SameDiffLayer):
    """A parameter-free custom layer (≡ samediff.SameDiffLambdaLayer):
    subclass and override defineLayer(params, x), or pass a function,
    SameDiffLambdaLayer(fn=torch.tanh). A function passed by value does
    not survive serialization (as in the reference): subclass to
    round-trip."""

    def __init__(self, fn=None, **kw):
        super().__init__(**kw)
        self._fn = fn

    def defineParameters(self):
        return {}

    def defineLayer(self, params, x, mask=None):
        fn = getattr(self, "_fn", None)
        if fn is None:
            raise NotImplementedError(
                f"{type(self).__name__}: override defineLayer() or pass "
                "fn=... (note fn= does not survive serialization — "
                "subclass to round-trip)")
        return fn(x)


class SameDiffOutputLayer(SameDiffLayer):
    """A user-defined OUTPUT layer (≡ samediff.SameDiffOutputLayer).
    Subclasses implement defineParameters() / defineLayer(params, x) as a
    SameDiffLayer, and defineLoss(labels, output, mask=None) -> scalar.
    defineLayer's result is both `output()` and what defineLoss scores
    (the activation defaults to identity)."""

    def __init__(self, **kw):
        kw.setdefault("activation", "identity")
        super().__init__(**kw)

    def defineLoss(self, labels, output, mask=None):
        raise NotImplementedError(
            f"{type(self).__name__} must implement "
            "defineLoss(labels, output, mask=None) -> scalar")

    #: the network classes pass the feature mask into pre_activation, so
    #: defineLayer keeps its mask=... contract as the loss head
    pre_activation_takes_mask = True

    def pre_activation(self, params, x, mask=None):
        return self.defineLayer(params, x, mask=mask)

    def compute_loss(self, labels, preact, mask=None):
        return self.defineLoss(labels, preact, mask=mask)


class SameDiffVertex(GraphVertex):
    """A user-defined vertex of several inputs for ComputationGraph (≡
    samediff.SameDiffVertex), with parameters stored and trained like a
    layer's (as AttentionVertex's). Subclasses implement:
      - defineParameters() -> {name: shape}
      - defineVertex(params, *inputs, mask=None) -> output
      - getOutputType(*input_types) -> InputType
    """

    def __init__(self, name=None, weightInit="xavier"):
        self.name = name
        self.weightInit = weightInit
        self.updater = None

    def defineParameters(self):
        return {}

    def defineVertex(self, params, *inputs, mask=None):
        raise NotImplementedError(
            f"{type(self).__name__} must implement defineVertex")

    def getOutputType(self, *input_types):
        return input_types[0]

    def initializeParameters(self, generator, name, shape):
        if len(shape) >= 2:
            return init_weight(generator, shape, self.weightInit, None)
        return torch.zeros(shape)

    # framework bridge (the parameterized-vertex protocol)
    def regularization_terms(self):
        return 0.0, 0.0

    def output_type(self, *ts):
        self._input_types = ts
        return self.getOutputType(*ts)

    def initialize(self, generator, *ts):
        return _draw(self, generator, self.defineParameters()), {}

    def apply(self, *xs, params=None, mask=None):
        return self.defineVertex(params or {}, *xs, mask=mask)
