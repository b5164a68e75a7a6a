"""Transfer learning: the port of
`deeplearning4j_tpu/transfer/transfer_learning.py` (≡ deeplearning4j-nn ::
transferlearning.TransferLearning, FineTuneConfiguration,
TransferLearningHelper).

The reference edits a trained MultiLayerNetwork/ComputationGraph in place:
freeze a feature-extractor prefix (FrozenLayer wrappers), swap/replace output
layers, and fine-tune the remainder. Here, as in the JAX package, the same
surface produces a NEW network on the source's device whose retained layers
receive copies of the trained parameter tensors (real copies: both
networks' training steps write their parameters in place, so a shared
tensor would move the source whenever the new network trains). Frozen
layers get a NoOp updater of their own (one more group of the step's
optimizer), so they receive zero updates, and they run in inference mode
(no dropout, batch-norm running statistics pinned), as the reference's
FrozenLayer does. A re-initialised layer (`nOutReplace`) draws from the
new network's own generator.
"""
from __future__ import annotations

import copy

import torch

from deeplearning4j_tpu_torch.nn._network import clone_tree
from deeplearning4j_tpu_torch.nn.conf.builders import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.updaters import NoOp


class FineTuneConfiguration:
    """Hyperparameter overrides applied to every non-frozen layer
    (≡ transferlearning.FineTuneConfiguration)."""

    def __init__(self, overrides, seed=None):
        self.overrides = dict(overrides)
        self.seed = seed

    class Builder:
        def __init__(self):
            self._overrides = {}
            self._seed = None

        def seed(self, s):
            self._seed = int(s)
            return self

        def updater(self, u):
            self._overrides["updater"] = u
            return self

        def activation(self, a):
            self._overrides["activation"] = a
            return self

        def weightInit(self, w):
            self._overrides["weightInit"] = w
            return self

        def biasInit(self, b):
            self._overrides["biasInit"] = float(b)
            return self

        def l1(self, v):
            self._overrides["l1"] = float(v)
            return self

        def l2(self, v):
            self._overrides["l2"] = float(v)
            return self

        def weightDecay(self, v):
            self._overrides["weightDecay"] = float(v)
            return self

        def dropOut(self, p):
            self._overrides["dropOut"] = float(p)
            return self

        def gradientNormalization(self, gn):
            self._overrides["gradientNormalization"] = gn
            return self

        def gradientNormalizationThreshold(self, t):
            self._overrides["gradientNormalizationThreshold"] = float(t)
            return self

        def optimizationAlgo(self, algo):  # parity no-op
            return self

        def build(self):
            return FineTuneConfiguration(self._overrides, self._seed)


def _reshare_global_updater(layer, old_defaults, new_defaults):
    """Deepcopy broke updater object identity, which the optimizer uses to
    tell per-layer updaters from the global one: restore sharing when the layer's updater
    was just the old global one (same type + hyperparameters)."""
    old_updater = old_defaults.get("updater")
    if (old_updater is not None and layer.updater is not None
            and type(layer.updater) is type(old_updater)
            and vars(layer.updater) == vars(old_updater)):
        layer.updater = new_defaults["updater"]


def _freeze_layer_conf(layer):
    """Mark a deep-copied layer conf frozen: NoOp updates, no regularization,
    inference-mode forward."""
    layer.frozen = True
    layer.updater = NoOp()        # its own instance → a group of its own
    layer.l1 = 0.0
    layer.l2 = 0.0
    layer.weightDecay = 0.0
    layer.dropOut = 0.0
    return layer


class TransferLearning:
    """Namespace matching the reference: TransferLearning.Builder for
    MultiLayerNetwork, TransferLearning.GraphBuilder for ComputationGraph."""

    class Builder:
        def __init__(self, net):
            if net._params is None:
                raise ValueError("TransferLearning requires an initialized "
                                 "network (call init() / load a model first)")
            self._net = net
            self._conf = net.conf
            self._fine_tune = None
            self._frozen_till = -1           # freeze layers [0.._frozen_till]
            self._nout_replace = {}          # idx -> (nOut, wInit, wInitNext)
            self._n_keep = len(net.layers)   # layers retained from the source
            self._added = []                 # appended layer confs
            self._input_type = net.conf.input_type

        def fineTuneConfiguration(self, ftc):
            self._fine_tune = ftc
            return self

        def setFeatureExtractor(self, layer_idx):
            """Freeze layers [0..layer_idx] inclusive (≡ reference)."""
            self._frozen_till = int(layer_idx)
            return self

        def nOutReplace(self, layer_idx, n_out, weight_init=None,
                        weight_init_next=None):
            """Change layer layer_idx's nOut and re-initialize it (and the
            nIn of the next parametric layer) — ≡ reference nOutReplace."""
            self._nout_replace[int(layer_idx)] = (
                int(n_out), weight_init, weight_init_next)
            return self

        def removeOutputLayer(self):
            return self.removeLayersFromOutput(1)

        def removeLayersFromOutput(self, n):
            if self._added:
                raise ValueError("remove*() must precede addLayer()")
            self._n_keep = max(0, self._n_keep - int(n))
            return self

        def addLayer(self, layer_conf):
            from deeplearning4j_tpu_torch.nn.conf import layers as L
            if isinstance(layer_conf, L._Builder):
                layer_conf = layer_conf.build()
            self._added.append(layer_conf)
            return self

        def setInputType(self, input_type):
            self._input_type = input_type
            return self

        def build(self):
            from deeplearning4j_tpu_torch.nn.multilayer import \
                MultiLayerNetwork

            src = self._net
            old_defaults = src.conf.defaults
            n_keep = self._n_keep
            kept = [copy.deepcopy(l) for l in src.layers[:n_keep]]
            added = [copy.deepcopy(l) for l in self._added]

            # fine-tune overrides: new defaults + direct application to
            # retained non-frozen layers (their fields were already filled
            # from the OLD defaults at the original build)
            defaults = dict(old_defaults)
            ft = self._fine_tune.overrides if self._fine_tune else {}
            defaults.update(ft)
            seed = (self._fine_tune.seed
                    if self._fine_tune and self._fine_tune.seed is not None
                    else src.conf.seed)

            reinit = set()   # layer indices whose params are re-initialized
            for idx, (n_out, w_init, w_init_next) in self._nout_replace.items():
                if idx >= n_keep:
                    raise ValueError(f"nOutReplace({idx}): layer was removed")
                kept[idx].nOut = n_out
                if w_init is not None:
                    kept[idx].weightInit = w_init
                reinit.add(idx)
                # propagate the width change: layers WITHOUT an nIn attr
                # (BatchNormalization & co) are width-transparent but size
                # their params from the input — clear the size initialize()
                # pinned into the conf and re-init them; stop at the next
                # nIn-owning layer, whose nIn re-infers
                for j in range(idx + 1, n_keep):
                    lj = kept[j]
                    if getattr(lj, "nIn", None) is not None:
                        lj.nIn = None
                        if w_init_next is not None:
                            lj.weightInit = w_init_next
                        reinit.add(j)
                        break
                    if hasattr(lj, "nOut"):
                        lj.nOut = None
                        reinit.add(j)

            for i, layer in enumerate(kept):
                if i <= self._frozen_till:
                    _freeze_layer_conf(layer)
                    continue
                _reshare_global_updater(layer, old_defaults, defaults)
                for field, value in ft.items():
                    setattr(layer, field, value)

            new_layers = kept + added
            preprocessors = {i: pp for i, pp in src.conf.preprocessors.items()
                             if i < n_keep}
            conf = MultiLayerConfiguration(
                defaults, new_layers, self._input_type, preprocessors,
                src.conf.backprop_type, src.conf.tbptt_fwd_length,
                src.conf.tbptt_back_length, src.conf.data_type, seed)

            dst = MultiLayerNetwork(conf).init(src._device)
            # copy trained tensors for retained, shape-compatible layers
            # (copies: each network's step writes its own in place)
            for i in range(n_keep):
                key = str(i)
                if i in reinit or key not in src._params:
                    continue
                if key in dst._params and all(
                        src._params[key][n].shape == dst._params[key][n].shape
                        for n in dst._params[key]):
                    dst._params[key] = clone_tree(src._params[key])
                if key in src._state and key in dst._state and all(
                        src._state[key][n].shape == dst._state[key][n].shape
                        for n in dst._state[key]):
                    dst._state[key] = clone_tree(src._state[key])
            dst._build_optimizer()
            return dst

    class GraphBuilder:
        """Transfer learning over ComputationGraph (by vertex name)."""

        def __init__(self, graph):
            if graph._params is None:
                raise ValueError("TransferLearning requires an initialized "
                                 "ComputationGraph")
            self._graph = graph
            self._fine_tune = None
            self._frozen_till = None          # freeze up to + incl this vertex
            self._nout_replace = {}           # name -> (nOut, wInit, wInitNext)
            self._removed = set()
            self._added = []                  # (name, layer_conf, inputs)
            self._outputs = None

        def fineTuneConfiguration(self, ftc):
            self._fine_tune = ftc
            return self

        def setFeatureExtractor(self, *vertex_names):
            self._frozen_till = set(vertex_names)
            return self

        def nOutReplace(self, name, n_out, weight_init=None,
                        weight_init_next=None):
            self._nout_replace[name] = (int(n_out), weight_init,
                                        weight_init_next)
            return self

        def removeVertexAndConnections(self, name):
            """Remove the vertex and strip every reference to it from
            retained downstream nodes (≡ reference semantics: downstream
            consumers must be rewired explicitly via addLayer/addVertex)."""
            self._removed.add(name)
            return self

        def removeVertexKeepConnections(self, name):
            """Remove the vertex but splice its inputs into its consumers
            (downstream nodes now read directly from its parents)."""
            self._rewired = getattr(self, "_rewired", set())
            self._rewired.add(name)
            return self

        def addLayer(self, name, layer_conf, *inputs):
            from deeplearning4j_tpu_torch.nn.conf import layers as L
            if isinstance(layer_conf, L._Builder):
                layer_conf = layer_conf.build()
            if len(inputs) == 1 and isinstance(inputs[0], (list, tuple)):
                inputs = tuple(inputs[0])
            self._added.append((name, layer_conf, list(inputs)))
            return self

        def setOutputs(self, *names):
            if len(names) == 1 and isinstance(names[0], (list, tuple)):
                names = names[0]
            self._outputs = list(names)
            return self

        def build(self):
            from deeplearning4j_tpu_torch.nn.conf.graph_builder import (
                ComputationGraphConfiguration, GraphNode)
            from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

            src = self._graph
            sconf = src.conf
            ft = self._fine_tune.overrides if self._fine_tune else {}
            defaults = dict(sconf.defaults)
            defaults.update(ft)

            # frozen set: every ancestor of (and including) the named vertices
            frozen = set()
            if self._frozen_till:
                def mark(name):
                    if name in frozen or name not in sconf.nodes:
                        return
                    frozen.add(name)
                    for p in sconf.nodes[name].inputs:
                        mark(p)
                for name in self._frozen_till:
                    mark(name)

            rewired = getattr(self, "_rewired", set())

            def resolve_inputs(parents):
                """Strip removed references; splice through rewired ones."""
                out = []
                for p in parents:
                    if p in self._removed:
                        continue
                    if p in rewired:
                        out.extend(resolve_inputs(sconf.nodes[p].inputs))
                    else:
                        out.append(p)
                return out

            nodes = {}
            reinit = set()
            for name in sconf.topo_order:
                if name in self._removed or name in rewired:
                    continue
                n = sconf.nodes[name]
                ref = copy.deepcopy(n.ref)
                if n.kind == "layer":
                    if name in self._nout_replace:
                        n_out, w_init, _ = self._nout_replace[name]
                        ref.nOut = n_out
                        if w_init is not None:
                            ref.weightInit = w_init
                        reinit.add(name)
                    # a consumer's input dim changes if a replaced vertex is
                    # reachable through width-transparent paths: vertices
                    # (merge/elementwise forward dims without parameters) and
                    # nIn-less layers (BatchNormalization & co size params
                    # from the input but don't change the width)
                    def replaced_ancestors(node_name, _seen=None):
                        seen = set() if _seen is None else _seen
                        found = []
                        for p in sconf.nodes[node_name].inputs:
                            if p in seen:
                                continue
                            seen.add(p)
                            pn = sconf.nodes[p]
                            if p in self._nout_replace:
                                found.append(p)
                            elif (pn.kind == "vertex"
                                  or getattr(pn.ref, "nIn", None) is None):
                                found.extend(replaced_ancestors(p, seen))
                        return found

                    replaced_parents = replaced_ancestors(name)
                    if replaced_parents:
                        if getattr(ref, "nIn", None) is not None:
                            ref.nIn = None
                            # weight_init_next from THIS node's ancestor
                            w_next = self._nout_replace[replaced_parents[0]][2]
                            if w_next is not None:
                                ref.weightInit = w_next
                            reinit.add(name)
                        elif hasattr(ref, "nOut") and \
                                name not in self._nout_replace:
                            # width-transparent but parametric: re-infer size
                            ref.nOut = None
                            reinit.add(name)
                    if name in frozen:
                        _freeze_layer_conf(ref)
                    else:
                        _reshare_global_updater(ref, sconf.defaults, defaults)
                        for field, value in ft.items():
                            setattr(ref, field, value)
                node = GraphNode(name, n.kind, ref,
                                 resolve_inputs(n.inputs))
                node.preprocessor = copy.deepcopy(n.preprocessor)
                nodes[name] = node
            for name, layer, inputs in self._added:
                layer.name = name
                nodes[name] = GraphNode(name, "layer", layer, list(inputs))

            outputs = self._outputs or [o for o in sconf.output_names
                                        if o not in self._removed
                                        and o not in rewired]
            if not outputs:
                raise ValueError("All outputs were removed; call "
                                 "setOutputs(...) with the new output names")
            seed = (self._fine_tune.seed
                    if self._fine_tune and self._fine_tune.seed is not None
                    else sconf.seed)
            conf = ComputationGraphConfiguration(
                defaults, nodes, sconf.input_names, outputs,
                list(sconf.input_types), sconf.backprop_type,
                sconf.tbptt_fwd_length, sconf.tbptt_back_length,
                sconf.data_type, seed)
            dst = ComputationGraph(conf).init(src._device)
            # copies, not references: each network's step writes its own
            for name, p in src._params.items():
                if name in reinit or name not in dst._params:
                    continue
                if all(p[k].shape == dst._params[name][k].shape
                       for k in dst._params[name]):
                    dst._params[name] = clone_tree(p)
                if name in src._state and name in dst._state and all(
                        src._state[name][k].shape == dst._state[name][k].shape
                        for k in dst._state[name]):
                    dst._state[name] = clone_tree(src._state[name])
            dst._build_optimizer()
            return dst


class TransferLearningHelper:
    """≡ transferlearning.TransferLearningHelper: featurize a dataset at the
    frozen boundary once, then train only the unfrozen tail on the cached
    features (saves recomputing the frozen subtree every epoch)."""

    def __init__(self, net, frozen_till=None):
        self._net = net
        if frozen_till is None:
            frozen = [i for i, l in enumerate(net.layers)
                      if getattr(l, "frozen", False)]
            if not frozen:
                raise ValueError("Network has no frozen layers; pass "
                                 "frozen_till explicitly")
            frozen_till = max(frozen)
        self._boundary = int(frozen_till)
        self._sub = self._build_unfrozen()

    def _build_unfrozen(self):
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
        net, b = self._net, self._boundary
        tail = [copy.deepcopy(l) for l in net.layers[b + 1:]]
        for layer in tail:
            layer.frozen = False
        preprocessors = {i - (b + 1): pp
                         for i, pp in net.conf.preprocessors.items()
                         if i > b}
        conf = MultiLayerConfiguration(
            dict(net.conf.defaults), tail, net.conf.input_types[b + 1],
            preprocessors, net.conf.backprop_type, net.conf.tbptt_fwd_length,
            net.conf.tbptt_back_length, net.conf.data_type, net.conf.seed)
        sub = MultiLayerNetwork(conf).init(net._device)
        for i in range(b + 1, len(net.layers)):
            key, sub_key = str(i), str(i - (b + 1))
            if key in net._params:
                sub._params[sub_key] = clone_tree(net._params[key])
            if key in net._state:
                sub._state[sub_key] = clone_tree(net._state[key])
        sub._build_optimizer()
        return sub

    def featurize(self, dataset):
        from deeplearning4j_tpu_torch.datasets.dataset import DataSet
        with torch.no_grad():
            feats = self._net.activateSelectedLayers(
                0, self._boundary, dataset.features)
        return DataSet(feats.cpu().numpy(), dataset.labels,
                       dataset.featuresMask, dataset.labelsMask)

    def fitFeaturized(self, dataset_or_iter):
        self._sub.fit(dataset_or_iter)
        self._write_back()
        return self

    def outputFromFeaturized(self, features):
        return self._sub.output(features)

    def unfrozenMLN(self):
        return self._sub

    def _write_back(self):
        """The tail's trained tensors copied into the network's own, in
        place (the network keeps its tensors, so its step graphs stay
        bound)."""
        b = self._boundary
        with torch.no_grad():
            for i in range(b + 1, len(self._net.layers)):
                key, sub_key = str(i), str(i - (b + 1))
                for tree, sub in ((self._net._params, self._sub._params),
                                  (self._net._state, self._sub._state)):
                    for k, v in sub.get(sub_key, {}).items():
                        tree[key][k].copy_(v)
