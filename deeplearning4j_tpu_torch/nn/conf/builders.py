"""NeuralNetConfiguration builder DSL, copied from
`deeplearning4j_tpu/nn/conf/builders.py`, which has no jax in it
(≡ deeplearning4j-nn :: conf.NeuralNetConfiguration.Builder / ListBuilder /
MultiLayerConfiguration, conf.ComputationGraphConfiguration.GraphBuilder).

The fluent surface mirrors the reference; `build()` runs the reference's
config-validation + shape-inference pass (nIn inference from InputType,
automatic preprocessor insertion between layer families). The automatic
preprocessors cover the layer families ported so far. The configuration
formats (`toJson`/`fromJson`) come with ROADMAP A12's checkpoint formats.
"""
from __future__ import annotations

import copy

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.inputs import (
    ConvolutionalFlatType, ConvolutionalType, FeedForwardType, InputType)
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    CnnToFeedForwardPreProcessor, FeedForwardToCnnPreProcessor)
from deeplearning4j_tpu_torch.nn.updaters import Sgd

_CNN_LAYERS = (L.ConvolutionLayer, L.SubsamplingLayer)

#: parameter names a weight constraint applies to (nn/constraints.py)
WEIGHT_KEYS = ("W", "U", "dW", "pW")


def serde_not_ported(what):
    return NotImplementedError(
        f"{what}: the configuration and checkpoint formats "
        "(util/serde.py, util/model_serializer.py) come with ROADMAP A12")


class BackpropType:
    Standard = "standard"
    TruncatedBPTT = "truncated_bptt"


def _check_remat_policy(policy, allowed):
    p = "none" if policy in (None, False) else \
        ("layers" if policy is True else str(policy))
    if p not in allowed:
        raise ValueError(
            f"rematPolicy must be one of {allowed}, got {policy!r}")
    return p


class WorkspaceMode:
    """Accepted for API parity."""
    ENABLED = "enabled"
    NONE = "none"
    SINGLE = "single"
    SEPARATE = "separate"


class MultiLayerConfiguration:
    def __init__(self, defaults, layer_confs, input_type=None,
                 preprocessors=None, backprop_type=BackpropType.Standard,
                 tbptt_fwd_length=20, tbptt_back_length=20,
                 data_type="float32", seed=0, remat_policy="none"):
        self.defaults = defaults
        self.layers = layer_confs
        self.input_type = input_type
        self.preprocessors = dict(preprocessors or {})
        self.backprop_type = backprop_type
        self.tbptt_fwd_length = tbptt_fwd_length
        self.tbptt_back_length = tbptt_back_length
        self.data_type = data_type
        self.seed = seed
        self.remat_policy = remat_policy
        for i, l in enumerate(self.layers):
            if getattr(l, "name", None) is None:
                l.name = f"layer{i}"
        self._infer_shapes()
        if remat_policy == "layers":
            for l in self.layers[:-1]:
                if getattr(l, "remat", None) is None:
                    l.remat = True

    def _infer_shapes(self):
        """nIn inference + automatic preprocessor insertion (≡ the
        reference's MultiLayerConfiguration.Builder#build with
        setInputType)."""
        self.input_types = []  # input type seen by each layer (post-preproc)
        cur = self.input_type
        for i, layer in enumerate(self.layers):
            layer.apply_defaults(self.defaults)
            if cur is None:
                self.input_types.append(None)
                continue
            if i not in self.preprocessors:
                auto = self._auto_preprocessor(cur, layer)
                if auto is not None:
                    self.preprocessors[i] = auto
            if i in self.preprocessors:
                cur = self.preprocessors[i].getOutputType(cur)
            if isinstance(cur, ConvolutionalFlatType):
                cur = InputType.feedForward(cur.arrayElementsPerExample())
            if getattr(layer, "nIn", "na") is None:
                layer.nIn = getattr(cur, "channels", None) or cur.size
            self.input_types.append(cur)
            cur = layer.output_type(cur)
        self.output_type = cur

    @staticmethod
    def _auto_preprocessor(cur, layer):
        if isinstance(layer, _CNN_LAYERS):
            if isinstance(cur, ConvolutionalFlatType):
                return FeedForwardToCnnPreProcessor(cur.height, cur.width,
                                                    cur.channels)
            if isinstance(cur, FeedForwardType):
                raise ValueError(
                    "Cannot feed flat FeedForward input into a CNN layer "
                    "without image dimensions; use "
                    "InputType.convolutionalFlat(h, w, c)")
        elif isinstance(cur, ConvolutionalType) and isinstance(
                layer, L.DenseLayer):
            return CnnToFeedForwardPreProcessor(cur.height, cur.width,
                                                cur.channels)
        return None

    def toJson(self):
        raise serde_not_ported("MultiLayerConfiguration.toJson")

    @staticmethod
    def fromJson(s):
        raise serde_not_ported("MultiLayerConfiguration.fromJson")


class ListBuilder:
    def __init__(self, defaults, seed, data_type):
        self._defaults = defaults
        self._seed = seed
        self._data_type = data_type
        self._layers = []
        self._input_type = None
        self._preprocessors = {}
        self._backprop_type = BackpropType.Standard
        self._tbptt_fwd = 20
        self._tbptt_back = 20
        self._remat_policy = "none"

    def layer(self, *args):
        """layer(conf) or layer(index, conf) — accepts a built config or a
        pending Builder."""
        if len(args) == 2:
            idx, conf = args
        else:
            (conf,) = args
            idx = len(self._layers)
        if isinstance(conf, L._Builder):
            conf = conf.build()
        while len(self._layers) <= idx:
            self._layers.append(None)
        self._layers[idx] = conf
        return self

    def setInputType(self, input_type):
        self._input_type = input_type
        return self

    def inputPreProcessor(self, idx, preprocessor):
        self._preprocessors[int(idx)] = preprocessor
        return self

    def backpropType(self, bp_type):
        self._backprop_type = bp_type
        return self

    def rematPolicy(self, policy):
        """Selective activation recompute for the backward pass ("layers"
        or "none")."""
        self._remat_policy = _check_remat_policy(policy, ("none", "layers"))
        return self

    def tBPTTForwardLength(self, n):
        self._tbptt_fwd = int(n)
        return self

    def tBPTTBackwardLength(self, n):
        self._tbptt_back = int(n)
        return self

    def tBPTTLength(self, n):
        self._tbptt_fwd = self._tbptt_back = int(n)
        return self

    def build(self):
        if any(l is None for l in self._layers):
            raise ValueError("Gaps in layer indices")
        return MultiLayerConfiguration(
            dict(self._defaults), list(self._layers), self._input_type,
            self._preprocessors, self._backprop_type, self._tbptt_fwd,
            self._tbptt_back, self._data_type, self._seed,
            self._remat_policy)


class NeuralNetConfiguration:
    class Builder:
        def __init__(self):
            self._defaults = {}
            self._seed = 0
            self._data_type = "float32"

        # -- global hyperparameters -------------------------------------
        def seed(self, s):
            self._seed = int(s)
            return self

        def updater(self, u):
            self._defaults["updater"] = u
            return self

        def weightInit(self, w):
            self._defaults["weightInit"] = w
            return self

        def dist(self, d):
            self._defaults["dist"] = d
            return self

        def activation(self, a):
            self._defaults["activation"] = a
            return self

        def biasInit(self, b):
            self._defaults["biasInit"] = float(b)
            return self

        def l1(self, v):
            self._defaults["l1"] = float(v)
            return self

        def l2(self, v):
            self._defaults["l2"] = float(v)
            return self

        def weightDecay(self, v):
            self._defaults["weightDecay"] = float(v)
            return self

        def dropOut(self, p):
            self._defaults["dropOut"] = float(p)
            return self

        def weightNoise(self, wn):
            self._defaults["weightNoise"] = wn
            return self

        def constrainWeights(self, *constraints):
            self._defaults["constraints"] = (
                self._defaults.get("constraints", []) + list(constraints))
            return self

        def constrainBias(self, *constraints):
            cs = []
            for c in constraints:
                c = copy.copy(c)
                c.applies_to = ("b",)
                cs.append(c)
            self._defaults["constraints"] = (
                self._defaults.get("constraints", []) + cs)
            return self

        def constrainAllParameters(self, *constraints):
            cs = []
            for c in constraints:
                c = copy.copy(c)
                c.applies_to = WEIGHT_KEYS + ("b", "gamma", "beta")
                cs.append(c)
            self._defaults["constraints"] = (
                self._defaults.get("constraints", []) + cs)
            return self

        def precisionPolicy(self, policy):
            self._defaults["precisionPolicy"] = policy
            return self

        def gradientAccumulation(self, n):
            n = int(n)
            if n < 1:
                raise ValueError("gradientAccumulation must be >= 1")
            self._defaults["gradientAccumulation"] = n
            return self

        def gradientNormalization(self, gn):
            self._defaults["gradientNormalization"] = gn
            return self

        def gradientNormalizationThreshold(self, t):
            self._defaults["gradientNormalizationThreshold"] = float(t)
            return self

        def dataType(self, dt):
            self._data_type = str(dt)
            return self

        def convolutionMode(self, mode):
            self._defaults["convolutionMode"] = mode
            return self

        # Accepted for parity; no-ops (documented):
        def optimizationAlgo(self, algo):
            return self

        def trainingWorkspaceMode(self, mode):
            return self

        def inferenceWorkspaceMode(self, mode):
            return self

        def cacheMode(self, mode):
            return self

        def cudnnAlgoMode(self, mode):
            return self

        def miniBatch(self, flag):
            return self

        # -- terminal builders ------------------------------------------
        def list(self):
            d = dict(self._defaults)
            d.setdefault("updater", Sgd(0.1))
            return ListBuilder(d, self._seed, self._data_type)

        def graphBuilder(self):
            from deeplearning4j_tpu_torch.nn.conf.graph_builder import \
                GraphBuilder
            d = dict(self._defaults)
            d.setdefault("updater", Sgd(0.1))
            return GraphBuilder(d, self._seed, self._data_type)
