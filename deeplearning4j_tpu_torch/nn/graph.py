"""ComputationGraph (≡ deeplearning4j-nn :: graph.ComputationGraph): the
port of the inference half of `deeplearning4j_tpu/nn/graph.py`.

A DAG of layer and vertex nodes over the configuration's topological
order; multi-input, multi-output. Parameters and state are dicts of
tensors keyed by node name ({"W", "b", "gamma", "beta"}, {"mean",
"var"}), the JAX package's trees, so weights carry across as numpy
(`nn/convert.py`). Outputs are tensors on the graph's device.

`init(device=None)` draws the parameters from `conf.seed` on the CPU and
moves them to the card (or to `device`), and takes this instance's
conv1x1+BN fusion decision (`nn/fused.py`): with DL4J_TPU_FUSE_CONV_BN=1
every marked pair runs the hand-written epilogue GEMM at inference.

Training (`fit`, `score`, `evaluate`, remat) comes with the training
slice (ROADMAP A10/A11), stateful RNN stepping with the recurrent layers
(A12); each raises, naming its slice.
"""
from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve
from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.fused import (find_conv1x1_bn_fusions,
                                               fused_apply, fusion_enabled)

_DTYPES = {"float": torch.float32, "float32": torch.float32,
           "double": torch.float64, "float64": torch.float64,
           "half": torch.float16, "float16": torch.float16,
           "bfloat16": torch.bfloat16}


def _training_slice(what):
    return NotImplementedError(
        f"ComputationGraph.{what} comes with the training slice of the port "
        "(ResNet-50 training: ROADMAP A10/A11, kernels B5/B7/B8)")


def _to(tree, device):
    return {n: {k: v.to(device) for k, v in d.items()}
            for n, d in tree.items()}


class ComputationGraph:
    def __init__(self, conf):
        self.conf = conf
        self.nodes = conf.nodes
        self._params = None
        self._state = None
        self._device = None
        dt = str(conf.data_type).lower()
        if dt not in _DTYPES:
            raise ValueError(f"dataType {conf.data_type!r} is not a float "
                             f"type the port computes in: {sorted(_DTYPES)}")
        self._compute_dtype = _DTYPES[dt]
        self._fused_pairs = {}   # bn node -> conv node (nn/fused.py)
        self._fused_convs = set()

    # -- lifecycle -------------------------------------------------------
    def _decide_fusion(self):
        """This instance's execution decision; the shared conf is never
        mutated."""
        self._fused_pairs = (find_conv1x1_bn_fusions(self.conf)
                             if fusion_enabled() else {})
        self._fused_convs = set(self._fused_pairs.values())

    def _draw(self):
        """(params, state) on the CPU, drawn in topological order from one
        generator seeded with conf.seed."""
        gen = torch.Generator().manual_seed(int(self.conf.seed))
        ps, ss = {}, {}
        for name in self.conf.topo_order:
            node = self.nodes[name]
            if node.kind == "vertex" and hasattr(node.ref, "initialize"):
                raise NotImplementedError(
                    f"parameterized vertex '{name}' "
                    f"({type(node.ref).__name__}) comes with ROADMAP A12")
            if node.kind != "layer":
                continue
            p, s, _ = node.ref.initialize(gen, node.resolved_input_type)
            if p:
                ps[name] = p
            if s:
                ss[name] = s
        return ps, ss

    def init(self, device=None):
        """Draw the parameters and state from conf.seed and place them on
        `device` (default: the card; raises without one unless the caller
        passes device='cpu')."""
        if not self.conf.node_output_types:
            raise ValueError("setInputTypes(...) required before init()")
        dev = resolve(device)
        self._decide_fusion()
        ps, ss = self._draw()
        self._params, self._state = _to(ps, dev), _to(ss, dev)
        self._device = dev
        return self

    def clone(self):
        """A copy with its own parameter and state tensors and the same
        fusion decision."""
        m = ComputationGraph(self.conf)
        m._fused_pairs = dict(self._fused_pairs)
        m._fused_convs = set(self._fused_convs)
        m._device = self._device
        if self._params is not None:
            m._params = {n: {k: v.clone() for k, v in d.items()}
                         for n, d in self._params.items()}
            m._state = {n: {k: v.clone() for k, v in d.items()}
                        for n, d in self._state.items()}
        return m

    # -- parameters ------------------------------------------------------
    def _leaves(self):
        """Parameter tensors in the JAX package's tree order (node names
        sorted, then keys sorted)."""
        return [self._params[n][k] for n in sorted(self._params)
                for k in sorted(self._params[n])]

    def numParams(self):
        return sum(v.numel() for v in self._leaves())

    def params(self):
        """Every parameter, flattened into one vector."""
        leaves = self._leaves()
        if not leaves:
            return torch.zeros((0,), device=self._device)
        return torch.cat([v.reshape(-1) for v in leaves])

    def paramTable(self):
        return {f"{name}_{k}": v for name, p in (self._params or {}).items()
                for k, v in p.items()}

    def getLayer(self, name):
        return self.nodes[name].ref

    # -- forward ---------------------------------------------------------
    def _forward(self, params, state, inputs, train, generator=None,
                 report_conv=False):
        """inputs: dict name -> tensor. Returns (acts dict, preacts dict for
        output layers, new_state). `report_conv` also computes the conv
        output of each fused pair, for feedForward."""
        if train and getattr(self.conf, "remat_policy", "none") != "none":
            raise _training_slice("rematPolicy")
        acts, preacts = {}, {}
        new_state = dict(state)
        for name, x in inputs.items():
            acts[name] = x.to(self._compute_dtype)
        for name in self.conf.topo_order:
            node = self.nodes[name]
            if node.kind == "input":
                continue
            parents = [acts[p] for p in node.inputs]
            if node.kind == "vertex":
                acts[name] = node.ref.apply(*parents)
                continue
            layer = node.ref
            # frozen layers (transfer learning) always run inference-mode
            ltrain = train and not getattr(layer, "frozen", False)
            x = parents[0]
            if node.preprocessor is not None:
                x = node.preprocessor.preProcess(x)
            if name in self._fused_convs:
                # conv half of a fused pair: pass the input through; the BN
                # node runs the fused kernel with both parameter groups
                acts[name] = x
                continue
            p = params.get(name, {})
            s = state.get(name, {})
            fc = self._fused_pairs.get(name)
            if fc is not None:
                y, ns, y_conv = fused_apply(self.nodes[fc].ref, layer,
                                            params.get(fc, {}), p, s, x,
                                            ltrain, report_conv)
                acts[name] = y
                if report_conv:
                    acts[fc] = y_conv  # feedForward sees the real conv output
                if ns:
                    new_state[name] = ns
                continue
            if name in self.conf.output_names and hasattr(layer,
                                                          "compute_loss"):
                xd = layer._dropout_in(x, ltrain, generator)
                pre = layer.pre_activation(p, xd)
                preacts[name] = pre
                acts[name] = get_activation(layer.activation)(pre)
            else:
                y, ns = layer.apply(p, s, x, train=ltrain,
                                    generator=generator)
                acts[name] = y
                if ns:
                    new_state[name] = ns
        return acts, preacts, new_state

    def _as_input_dict(self, inputs):
        if self._params is None:
            raise ValueError("init() (or graph_params_from_numpy) first")

        def tensor(v):
            if torch.is_tensor(v):
                return v.to(self._device)
            return torch.as_tensor(np.asarray(v), device=self._device)

        if isinstance(inputs, dict):
            return {k: tensor(v) for k, v in inputs.items()}
        if not isinstance(inputs, (list, tuple)):
            inputs = [inputs]
        return {n: tensor(v) for n, v in zip(self.conf.input_names, inputs)}

    def output(self, *inputs, train=False, generator=None):
        """The output node(s) for the inputs (arrays or tensors, one per
        graph input, in the order of addInputs): one tensor, or a list
        for several outputs. `train` runs dropout (from `generator`) and
        batch-statistics BN, without touching the stored state."""
        if len(inputs) == 1:
            inputs = inputs[0]
        ins = self._as_input_dict(inputs)
        acts, _, _ = self._forward(self._params, self._state, ins, train,
                                   generator)
        outs = [acts[n] for n in self.conf.output_names]
        return outs[0] if len(outs) == 1 else outs

    def outputSingle(self, *inputs):
        out = self.output(*inputs)
        return out[0] if isinstance(out, list) else out

    def feedForward(self, inputs, train=False, generator=None):
        """Every node's activation, {name: tensor}; a fused conv node
        reports its true conv output."""
        ins = self._as_input_dict(inputs)
        acts, _, _ = self._forward(self._params, self._state, ins, train,
                                   generator, report_conv=True)
        return acts

    # -- later slices ----------------------------------------------------
    def fit(self, *args, **kwargs):
        raise _training_slice("fit")

    def score(self, *args, **kwargs):
        raise _training_slice("score")

    def evaluate(self, *args, **kwargs):
        raise _training_slice("evaluate")

    def rnnTimeStep(self, *inputs):
        raise NotImplementedError(
            "ComputationGraph.rnnTimeStep (carried recurrent state) comes "
            "with the recurrent layers, ROADMAP A12")
