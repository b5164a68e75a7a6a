"""Declarative network hyperparameter spaces: the port of
`deeplearning4j_tpu/arbiter/network_spaces.py`, over the port's network
classes (≡ arbiter-deeplearning4j ::
MultiLayerSpace / ComputationGraphSpace / layers.DenseLayerSpace etc. /
adapter.ParameterSpaceAdapter).

A `LayerSpace(LayerCls, **kw)` holds per-field ParameterSpaces; a
`MultiLayerSpace` composes them plus global spaces (updater, l2, ...)
into ONE flat leaf dict the existing candidate generators already
understand, and compiles a sampled candidate into a real
MultiLayerConfiguration through the normal builder DSL — so a search
runs end-to-end through LocalOptimizationRunner with NO hand-written
model_builder (the round-3 gap: generic spaces existed, the declarative
network surface didn't).
"""
from __future__ import annotations

import copy

import numpy as np

from deeplearning4j_tpu_torch.arbiter.spaces import ParameterSpace


def _resolve(v, cand, key):
    """Fixed value straight through; ParameterSpace leaves read their
    sampled value out of the candidate dict."""
    return cand[key] if isinstance(v, ParameterSpace) else v


class UpdaterSpace(ParameterSpace):
    """≡ arbiter :: AdamSpace / SgdSpace / NesterovsSpace — an updater
    whose learning rate is itself a space. Samples/grids the LR; the
    compiled config gets `cls(lr)`."""

    def __init__(self, updater_cls, learningRate):
        self.updater_cls = updater_cls
        self.lr = learningRate

    def sample(self, rng):
        return (self.lr.sample(rng)
                if isinstance(self.lr, ParameterSpace) else self.lr)

    def grid(self, n):
        return (self.lr.grid(n)
                if isinstance(self.lr, ParameterSpace) else [self.lr])

    def build(self, lr):
        return self.updater_cls(lr)


def AdamSpace(learningRate):
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    return UpdaterSpace(Adam, learningRate)


def SgdSpace(learningRate):
    from deeplearning4j_tpu_torch.nn.updaters import Sgd
    return UpdaterSpace(Sgd, learningRate)


def NesterovsSpace(learningRate):
    from deeplearning4j_tpu_torch.nn.updaters import Nesterovs
    return UpdaterSpace(Nesterovs, learningRate)


class LayerSpace:
    """≡ arbiter layers.*LayerSpace, generically: any constructor kwarg
    of any layer config class may be a ParameterSpace."""

    def __init__(self, layer_cls, **kw):
        self.layer_cls = layer_cls
        self.kw = kw

    def leaves(self, prefix):
        return {f"{prefix}.{k}": v for k, v in self.kw.items()
                if isinstance(v, ParameterSpace)}

    def build(self, cand, prefix):
        kw = {k: _resolve(v, cand, f"{prefix}.{k}")
              for k, v in self.kw.items()}
        return self.layer_cls(**kw)


class MultiLayerSpace:
    """≡ arbiter-deeplearning4j :: MultiLayerSpace."""

    def __init__(self, global_spaces, layer_specs, input_type, seed):
        self._globals = global_spaces      # {field: value|space}
        self._layers = layer_specs         # [(LayerSpace, repeat)]
        self._input_type = input_type
        self._seed = seed

    class Builder:
        def __init__(self):
            self._globals = {}
            self._layers = []
            self._input_type = None
            self._seed = 12345

        def seed(self, s):
            self._seed = int(s)
            return self

        def updater(self, u):
            self._globals["updater"] = u
            return self

        def weightInit(self, w):
            self._globals["weightInit"] = w
            return self

        def activation(self, a):
            self._globals["activation"] = a
            return self

        def l1(self, v):
            self._globals["l1"] = v
            return self

        def l2(self, v):
            self._globals["l2"] = v
            return self

        def dropOut(self, p):
            self._globals["dropOut"] = p
            return self

        def addLayer(self, layer_space, repeat=1):
            """repeat may be an IntegerParameterSpace (≡ the reference's
            `numLayers` arg) — every copy shares the SAME sampled
            hyperparameters, as in the reference."""
            self._layers.append((layer_space, repeat))
            return self

        def setInputType(self, t):
            self._input_type = t
            return self

        def build(self):
            if not self._layers:
                raise ValueError("MultiLayerSpace: addLayer() at least one "
                                 "layer space")
            return MultiLayerSpace(self._globals, list(self._layers),
                                   self._input_type, self._seed)

    # -- ParameterSpace protocol over the whole network ------------------
    def collectLeaves(self):
        """Flat {name: ParameterSpace} for the candidate generators."""
        leaves = {}
        for k, v in self._globals.items():
            if isinstance(v, ParameterSpace):
                leaves[f"global.{k}"] = v
        for i, (ls, repeat) in enumerate(self._layers):
            leaves.update(ls.leaves(f"layer{i}"))
            if isinstance(repeat, ParameterSpace):
                leaves[f"layer{i}.repeat"] = repeat
        return leaves

    def getValue(self, cand):
        """candidate dict → MultiLayerConfiguration (via the real DSL)."""
        from deeplearning4j_tpu_torch.nn.conf.builders import \
            NeuralNetConfiguration
        b = NeuralNetConfiguration.Builder().seed(self._seed)
        for k, v in self._globals.items():
            val = _resolve(v, cand, f"global.{k}")
            if isinstance(v, UpdaterSpace):
                val = v.build(val)
            getattr(b, k)(val)
        lb = b.list()
        for i, (ls, repeat) in enumerate(self._layers):
            n = int(_resolve(repeat, cand, f"layer{i}.repeat"))
            for _ in range(max(1, n)):
                # raw confs are deep-copied: conf building MUTATES layers
                # (nIn inference, apply_defaults) and one candidate's
                # inferred shapes must never leak into the next
                lb.layer(ls.build(cand, f"layer{i}")
                         if isinstance(ls, LayerSpace)
                         else copy.deepcopy(ls))
        if self._input_type is not None:
            lb.setInputType(self._input_type)
        return lb.build()

    def model_builder(self, device=None):
        """Drop-in `model_builder` for LocalOptimizationRunner: candidate
        → initialized MultiLayerNetwork on `device` (the card unless
        "cpu")."""
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        def build(cand):
            return MultiLayerNetwork(self.getValue(cand)).init(
                device=device)

        return build

    def randomCandidate(self, seed=0):
        rng = np.random.default_rng(seed)
        return {k: v.sample(rng) for k, v in self.collectLeaves().items()}


class ComputationGraphSpace:
    """≡ arbiter-deeplearning4j :: ComputationGraphSpace — the graph
    twin: named layer/vertex spaces over the GraphBuilder DSL."""

    def __init__(self, global_spaces, inputs, nodes, outputs, input_types,
                 seed):
        self._globals = global_spaces
        self._inputs = inputs
        self._nodes = nodes          # [(name, LayerSpace|vertex, parents,
        #                               is_layer)]
        self._outputs = outputs
        self._input_types = input_types
        self._seed = seed

    class Builder:
        def __init__(self):
            self._globals = {}
            self._inputs = []
            self._nodes = []
            self._outputs = []
            self._input_types = None
            self._seed = 12345

        def seed(self, s):
            self._seed = int(s)
            return self

        def updater(self, u):
            self._globals["updater"] = u
            return self

        def weightInit(self, w):
            self._globals["weightInit"] = w
            return self

        def l2(self, v):
            self._globals["l2"] = v
            return self

        def addInputs(self, *names):
            self._inputs.extend(names)
            return self

        def addLayer(self, name, layer_space, *parents):
            self._nodes.append((name, layer_space, parents, True))
            return self

        def addVertex(self, name, vertex, *parents):
            self._nodes.append((name, vertex, parents, False))
            return self

        def setOutputs(self, *names):
            self._outputs.extend(names)
            return self

        def setInputTypes(self, *types):
            self._input_types = types
            return self

        def build(self):
            if not self._inputs or not self._outputs:
                raise ValueError("ComputationGraphSpace: addInputs() and "
                                 "setOutputs() are required")
            return ComputationGraphSpace(
                self._globals, list(self._inputs), list(self._nodes),
                list(self._outputs), self._input_types, self._seed)

    def collectLeaves(self):
        leaves = {}
        for k, v in self._globals.items():
            if isinstance(v, ParameterSpace):
                leaves[f"global.{k}"] = v
        for name, node, _, is_layer in self._nodes:
            if is_layer and isinstance(node, LayerSpace):
                leaves.update(node.leaves(f"node.{name}"))
        return leaves

    def getValue(self, cand):
        from deeplearning4j_tpu_torch.nn.conf.builders import \
            NeuralNetConfiguration
        b = NeuralNetConfiguration.Builder().seed(self._seed)
        for k, v in self._globals.items():
            val = _resolve(v, cand, f"global.{k}")
            if isinstance(v, UpdaterSpace):
                val = v.build(val)
            getattr(b, k)(val)
        g = b.graphBuilder()
        g.addInputs(*self._inputs)
        if self._input_types is not None:
            g.setInputTypes(*self._input_types)
        for name, node, parents, is_layer in self._nodes:
            if is_layer:
                # deep-copy raw confs — see MultiLayerSpace.getValue
                layer = (node.build(cand, f"node.{name}")
                         if isinstance(node, LayerSpace)
                         else copy.deepcopy(node))
                g.addLayer(name, layer, *parents)
            else:
                g.addVertex(name, copy.deepcopy(node), *parents)
        g.setOutputs(*self._outputs)
        return g.build()

    def model_builder(self, device=None):
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

        def build(cand):
            return ComputationGraph(self.getValue(cand)).init(device=device)

        return build
