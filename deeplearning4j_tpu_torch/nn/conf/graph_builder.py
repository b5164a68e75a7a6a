"""ComputationGraphConfiguration + GraphBuilder, copied from
`deeplearning4j_tpu/nn/conf/graph_builder.py`, which has no jax in it
(≡ deeplearning4j-nn :: conf.ComputationGraphConfiguration.GraphBuilder).

addInputs/addLayer/addVertex/setOutputs with a topologically-sorted DAG;
shape inference + automatic preprocessor insertion runs at build() exactly
like the MultiLayer path."""
from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.builders import (
    _CNN_LAYERS, BackpropType, serde_not_ported)
from deeplearning4j_tpu_torch.nn.conf.graph_vertices import GraphVertex
from deeplearning4j_tpu_torch.nn.conf.inputs import (ConvolutionalFlatType,
                                               ConvolutionalType,
                                               FeedForwardType, InputType)
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    CnnToFeedForwardPreProcessor, FeedForwardToCnnPreProcessor)


class GraphNode:
    def __init__(self, name, kind, ref, inputs):
        self.name = name
        self.kind = kind          # "input" | "layer" | "vertex"
        self.ref = ref            # Layer conf or GraphVertex or None
        self.inputs = list(inputs)
        self.preprocessor = None  # auto-inserted for layer nodes


class ComputationGraphConfiguration:
    def __init__(self, defaults, nodes, input_names, output_names,
                 input_types=None, backprop_type=BackpropType.Standard,
                 tbptt_fwd_length=20, tbptt_back_length=20,
                 data_type="float32", seed=0, remat_policy="none"):
        self.defaults = defaults
        self.nodes = nodes                    # dict name -> GraphNode
        self.input_names = list(input_names)
        self.output_names = list(output_names)
        self.input_types = list(input_types or [])
        self.backprop_type = backprop_type
        self.tbptt_fwd_length = tbptt_fwd_length
        self.tbptt_back_length = tbptt_back_length
        self.data_type = data_type
        self.seed = seed
        self.remat_policy = remat_policy
        self.topo_order = self._topo_sort()
        self.node_output_types = {}
        if self.input_types:
            self._infer_shapes()

    def consumers(self):
        """{node name: [consumer node names]} over the whole DAG — THE
        consumer map every graph analysis shares (remat segmentation,
        the traffic ledger via remat_plan, conv+BN fusion pairing, the
        quantized chain planner)."""
        consumers = {}
        for name in self.topo_order:
            for p in self.nodes[name].inputs:
                consumers.setdefault(p, []).append(name)
        return consumers

    def remat_segments(self):
        """Per-residual-block recompute segmentation (rematPolicy
        "blocks"): split the topo order at BLOCK BOUNDARIES — nodes
        whose activation is consumed by more than one downstream node
        (in a residual graph that is exactly the block entry/exit: the
        tensor feeding both the main path and the shortcut), plus
        output nodes. Each segment between boundaries re-runs under
        activation checkpointing in backward, so only boundary activations are
        stored — the cheap conv/BN internals of a block are recomputed
        instead of read back from HBM. Returns a list of [node names],
        one per segment (boundary node last in its segment)."""
        consumers = self.consumers()
        # parents of output nodes stay boundaries too: feature-dependent
        # losses (needs_features heads) read the head's input activation
        # directly from the acts dict
        out_parents = {p for o in self.output_names
                       for p in self.nodes[o].inputs}
        segments, cur = [], []
        for name in self.topo_order:
            if self.nodes[name].kind == "input":
                continue
            cur.append(name)
            boundary = (len(consumers.get(name, ())) != 1
                        or name in self.output_names
                        or name in out_parents)
            if boundary:
                segments.append(cur)
                cur = []
        if cur:
            segments.append(cur)
        return segments

    def remat_plan(self):
        """[(segment, saved_outputs)] — the authoritative statement of
        what block-remat KEEPS: each segment's saved outputs are the
        nodes a later segment, an output head, or the loss reads (on a
        residual chain exactly the block boundary; on interleaved
        branches possibly more). The graph executor saves exactly
        these, and the traffic ledger (quantize/traffic.py) prices
        exactly these — one rule, two consumers, no drift."""
        consumers = self.consumers()
        plan = []
        for seg in self.remat_segments():
            seg_set = set(seg)
            outs = [n for n in seg
                    if n in self.output_names
                    or any(c not in seg_set
                           for c in consumers.get(n, ()))]
            if seg[-1] not in outs:
                outs.append(seg[-1])
            plan.append((seg, outs))
        return plan

    def _topo_sort(self):
        order, seen, visiting = [], set(), set()

        def visit(name):
            if name in seen:
                return
            if name in visiting:
                raise ValueError(f"Cycle in graph at '{name}'")
            visiting.add(name)
            for parent in self.nodes[name].inputs:
                if parent not in self.nodes:
                    raise ValueError(f"Node '{name}' references unknown input "
                                     f"'{parent}'")
                visit(parent)
            visiting.discard(name)
            seen.add(name)
            order.append(name)

        for name in self.nodes:
            visit(name)
        return order

    def _infer_shapes(self):
        if len(self.input_types) != len(self.input_names):
            raise ValueError("setInputTypes arity != addInputs arity")
        types = {}
        for name, t in zip(self.input_names, self.input_types):
            if isinstance(t, ConvolutionalFlatType):
                # keep flat marker for preprocessor insertion
                types[name] = t
            else:
                types[name] = t
        for name in self.topo_order:
            node = self.nodes[name]
            if node.kind == "input":
                self.node_output_types[name] = types[name]
                continue
            in_types = [self.node_output_types[p] for p in node.inputs]
            if node.kind == "vertex":
                if hasattr(node.ref, "initialize"):
                    # parameterized vertex (e.g. AttentionVertex) — keep the
                    # resolved input types for ComputationGraph.init()
                    node.resolved_input_types = in_types
                self.node_output_types[name] = node.ref.output_type(*in_types)
                continue
            layer = node.ref
            layer.apply_defaults(self.defaults)
            cur = in_types[0]
            if node.preprocessor is None:
                node.preprocessor = self._auto_preprocessor(cur, layer)
            if node.preprocessor is not None:
                cur = node.preprocessor.getOutputType(cur)
            if isinstance(cur, ConvolutionalFlatType):
                cur = InputType.feedForward(cur.arrayElementsPerExample())
            if getattr(layer, "nIn", "na") is None:
                layer.nIn = getattr(cur, "channels", None) or cur.size
            node.resolved_input_type = cur
            self.node_output_types[name] = layer.output_type(cur)

    @staticmethod
    def _auto_preprocessor(cur, layer):
        if isinstance(layer, _CNN_LAYERS):
            if isinstance(cur, ConvolutionalFlatType):
                return FeedForwardToCnnPreProcessor(cur.height, cur.width,
                                                    cur.channels)
        elif isinstance(cur, ConvolutionalType) and isinstance(
                layer, L.DenseLayer):
            return CnnToFeedForwardPreProcessor(cur.height, cur.width,
                                                cur.channels)
        return None

    def toJson(self):
        raise serde_not_ported("ComputationGraphConfiguration.toJson")

    @staticmethod
    def fromJson(s):
        raise serde_not_ported("ComputationGraphConfiguration.fromJson")


class GraphBuilder:
    def __init__(self, defaults, seed, data_type):
        self._defaults = defaults
        self._seed = seed
        self._data_type = data_type
        self._nodes = {}
        self._inputs = []
        self._outputs = []
        self._input_types = []
        self._backprop_type = BackpropType.Standard
        self._tbptt_fwd = self._tbptt_back = 20
        self._remat_policy = "none"

    def addInputs(self, *names):
        if len(names) == 1 and isinstance(names[0], (list, tuple)):
            names = names[0]
        for n in names:
            self._inputs.append(n)
            self._nodes[n] = GraphNode(n, "input", None, [])
        return self

    def setInputTypes(self, *types):
        if len(types) == 1 and isinstance(types[0], (list, tuple)):
            types = types[0]
        self._input_types = list(types)
        return self

    def addLayer(self, name, layer, *inputs):
        if isinstance(layer, L._Builder):
            layer = layer.build()
        if len(inputs) == 1 and isinstance(inputs[0], (list, tuple)):
            inputs = inputs[0]
        layer.name = name
        self._nodes[name] = GraphNode(name, "layer", layer, inputs)
        return self

    appendLayer = addLayer

    def addVertex(self, name, vertex, *inputs):
        if len(inputs) == 1 and isinstance(inputs[0], (list, tuple)):
            inputs = inputs[0]
        self._nodes[name] = GraphNode(name, "vertex", vertex, inputs)
        return self

    def inputPreProcessor(self, layer_name, pp):
        self._pending_pp = getattr(self, "_pending_pp", {})
        self._pending_pp[layer_name] = pp
        return self

    def setOutputs(self, *names):
        if len(names) == 1 and isinstance(names[0], (list, tuple)):
            names = names[0]
        self._outputs = list(names)
        return self

    def backpropType(self, t):
        self._backprop_type = t
        return self

    def rematPolicy(self, policy):
        """Selective activation recompute. "blocks": save only
        residual-block boundary activations (nodes with >1 consumer —
        the tensors feeding both a block's main path and its shortcut)
        and recompute each block's conv/BN internals in backward via
        activation checkpointing; the DSL-level byte diet for ResNet-class graphs
        (ROADMAP item 3). "layers" falls back to per-layer remat flags;
        "none" (default) stores everything."""
        from deeplearning4j_tpu_torch.nn.conf.builders import _check_remat_policy
        self._remat_policy = _check_remat_policy(
            policy, ("none", "layers", "blocks"))
        return self

    def tBPTTForwardLength(self, n):
        self._tbptt_fwd = int(n)
        return self

    def tBPTTBackwardLength(self, n):
        self._tbptt_back = int(n)
        return self

    def build(self):
        if not self._inputs:
            raise ValueError("addInputs(...) required")
        if not self._outputs:
            raise ValueError("setOutputs(...) required")
        for name, pp in getattr(self, "_pending_pp", {}).items():
            if name in self._nodes:
                self._nodes[name].preprocessor = pp
        conf = ComputationGraphConfiguration(
            dict(self._defaults), self._nodes, self._inputs, self._outputs,
            self._input_types, self._backprop_type, self._tbptt_fwd,
            self._tbptt_back, self._data_type, self._seed,
            self._remat_policy)
        if self._remat_policy == "layers":
            for name in conf.topo_order:
                node = conf.nodes[name]
                if (node.kind == "layer"
                        and name not in conf.output_names
                        and getattr(node.ref, "remat", None) is None):
                    node.ref.remat = True
        return conf
