"""ComputationGraph (≡ deeplearning4j-nn :: graph.ComputationGraph): the
port of `deeplearning4j_tpu/nn/graph.py`.

A DAG of layer and vertex nodes over the configuration's topological
order; multi-input, multi-output. Parameters and state are dicts of
tensors keyed by node name ({"W", "b", "gamma", "beta"}, {"mean",
"var"}), the JAX package's trees, so weights carry across as numpy
(`nn/convert.py`). Outputs are tensors on the graph's device.

`init(device=None)` draws the parameters from `conf.seed` on the CPU and
moves them to the card (or to `device`), and takes this instance's
conv1x1+BN fusion decision (`nn/fused.py`): with DL4J_TPU_FUSE_CONV_BN=1
every marked pair runs the hand-written epilogue GEMM at inference.

Training and evaluation are `nn/_network.py`'s, shared with
MultiLayerNetwork: `fit` runs, for each batch, the loss (the output
layers' losses plus the L1/L2 penalty), `backward`, the optimizer of
`build_optimizer` (any updater, a learning rate or a schedule, per-layer
updater overrides), the layers' constraints and the new BN state, with
`.gradientAccumulation(G)` grouping G batches into one update; `score`
gives the last training loss or an inference-mode loss of a batch;
`evaluate*` feed the `eval/` evaluators. With the fusion on, every marked
pair trains through `fused_conv1x1_bn`'s three kernels. A `torch.Generator`
seeded from conf.seed, on the graph's device, draws the dropout masks. Not
ported yet, each raising and naming its slice: remat, feature masks, and
stateful RNN stepping (A12).

A training step writes its results into the live parameter, optimizer
and BN-state tensors in place, so `params()`, `score()` and the listeners
read them as they are. On the card `fit` captures the step into a CUDA
graph per batch signature (`runtime.executables.FunctionStore`): the first
batch of a signature runs eagerly and is captured after, later ones copy
into the graph's static inputs and replay it (`fit_status()`). After
`init` or a weight load rebinds the tensors, the next step captures
again. `fit(prefetch=)` stages batch N+1 of an iterator that opts in onto
the device on a background thread while step N runs (`runtime.pipeline`).
"""
from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.device import resolve
from deeplearning4j_tpu_torch.nn._network import (Network, as_tensor,
                                                  compute_dtype, later,
                                                  to_device)
from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.fused import (find_conv1x1_bn_fusions,
                                               fused_apply, fusion_enabled)


def _later(what, where):
    return later("ComputationGraph", what, where)


class ComputationGraph(Network):
    def __init__(self, conf):
        self.conf = conf
        self.nodes = conf.nodes
        self._params = None
        self._state = None
        self._device = None
        self._compute_dtype = compute_dtype(conf)
        self._fused_pairs = {}   # bn node -> conv node (nn/fused.py)
        self._fused_convs = set()
        self._reset_training()

    @property
    def _layer_names(self):
        """Layer-bearing node names in topological order."""
        return [n for n in self.conf.topo_order
                if self.nodes[n].kind == "layer"]

    def _layer_items(self):
        return [(n, self.nodes[n].ref) for n in self._layer_names]

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
        self._params, self._state = to_device(ps, dev), to_device(ss, dev)
        self._device = dev
        return self

    def clone(self):
        """A copy with its own parameter and state tensors, the same fusion
        decision, and an optimizer of its own (fresh state, built at its
        first fit)."""
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

    # -- parameters (nn/_network.py) -------------------------------------
    def getLayer(self, name):
        return self.nodes[name].ref

    # -- forward ---------------------------------------------------------
    def _forward(self, params, state, inputs, train, generator=None,
                 report_conv=False):
        """inputs: dict name -> tensor. Returns (acts dict, preacts dict for
        output layers, new_state). `report_conv` also computes the conv
        output of each fused pair, for feedForward."""
        if train and getattr(self.conf, "remat_policy", "none") != "none":
            raise _later("rematPolicy", "a later slice of the nn core "
                         "(ROADMAP A10)")
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

        if isinstance(inputs, dict):
            return {k: as_tensor(v, self._device) for k, v in inputs.items()}
        if not isinstance(inputs, (list, tuple)):
            inputs = [inputs]
        return {n: as_tensor(v, self._device)
                for n, v in zip(self.conf.input_names, inputs)}

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

    # -- loss and score --------------------------------------------------
    def _loss(self, params, state, inputs, labels, lmasks=None,
              generator=None, train=True):
        """(the scalar loss, the new state): each output layer's loss on
        its pre-activation in f32, summed, plus the L1/L2 penalty."""
        acts, preacts, new_state = self._forward(params, state, inputs,
                                                 train, generator)
        total = 0.0
        for i, name in enumerate(self.conf.output_names):
            layer = self.nodes[name].ref
            if not hasattr(layer, "compute_loss"):
                raise ValueError(f"Output node '{name}' is not an output "
                                 "layer")
            lm = None if lmasks is None else lmasks[i]
            total = total + layer.compute_loss(
                labels[i].to(torch.float32), preacts[name].float(), lm)
        return total + self._penalty(params), new_state

    # -- training and evaluation (nn/_network.py) ------------------------
    @property
    def _input_names(self):
        return self.conf.input_names

    def _eval_output(self, features, fmask):
        out = self.output(features)
        return out[0] if isinstance(out, list) else out

    # -- later slices ----------------------------------------------------
    def rnnTimeStep(self, *inputs):
        raise NotImplementedError(
            "ComputationGraph.rnnTimeStep (carried recurrent state) comes "
            "with the recurrent layers, ROADMAP A12")
