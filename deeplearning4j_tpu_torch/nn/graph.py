"""ComputationGraph (≡ deeplearning4j-nn :: graph.ComputationGraph): the
port of `deeplearning4j_tpu/nn/graph.py`.

A DAG of layer and vertex nodes over the configuration's topological
order; multi-input, multi-output. Parameters and state are dicts of
tensors keyed by node name ({"W", "b", "gamma", "beta"}, {"mean",
"var"}), the JAX package's trees, so weights carry across as numpy
(`nn/convert.py`). Outputs are NDArrays (`ops/`) over tensors on the
graph's device.

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
seeded from conf.seed, on the graph's device, draws the dropout masks.
Feature masks ({input name: (B, T)}) flow through `output(fmasks=)`, `fit`
and the evaluation loop: each node sees its first parent's mask (a vertex
may name its mask input) and hands its consumers `feed_forward_mask`.
`rnnTimeStep` threads the recurrent layer nodes' carries across calls.
A vertex with parameters (`AttentionVertex`) is drawn, stored and trained
like a layer. An output layer whose loss reads its input features
(`needs_features`: CenterLossOutputLayer) gets its input node's
activation after the node's preprocessor; `getPredictedObjects` decodes
a Yolo2OutputLayer head's output into detections. `save` / `load` /
`toJson` read and write the JAX package's archive and JSON formats; a
restore takes the fusion decision again. Per-layer `remat` and
`rematPolicy("layers")` recompute a layer's activations in the backward;
`rematPolicy("blocks")` runs each segment of `conf.remat_plan()` under
activation checkpointing (not on a graph with fused pairs, feature
masks or carries, the JAX package's rule), and the recompute reads the
forward's dropout draws back (`nn._network.remat_call`).

A training step writes its results into the live parameter, optimizer
and BN-state tensors in place, so `params()`, `score()` and the listeners
read them as they are. On the card `fit` captures the step into a CUDA
graph per batch signature (`runtime.executables.FunctionStore`): the first
batch of a signature runs eagerly and is captured after, later ones copy
into the graph's static inputs and replay it (`fit_status()`). After
`init` or a weight load rebinds the tensors, the next step captures
again. `fit(prefetch=)` stages batch N+1 of an iterator that opts in onto
the device on a background thread while step N runs (`runtime.pipeline`).
With a `TrainingGuardian` installed each step runs its guarded variant
(`nn/_network.py`); the fit loop fires the `train.dispatch` and
`data.next` fault sites and beats the stall watchdog.
"""
from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.device import resolve
from deeplearning4j_tpu_torch.nn._network import (Network, apply_layer,
                                                  as_tensor, compute_dtype,
                                                  hook_params, mask_key,
                                                  remat_call,
                                                  pre_activation,
                                                  split_inputs, to_device)
from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.fused import (find_conv1x1_bn_fusions,
                                               fused_apply, fusion_enabled)
from deeplearning4j_tpu_torch.ops.ndarray import NDArray


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
        self._rnn_carries = None  # rnnTimeStep's state
        self._reset_training()

    _kind = "graph"          # the stall watchdog's heartbeat name

    def _layer_items(self):
        """Layer nodes and vertices with parameters, in topological order."""
        return [(n, self.nodes[n].ref) for n in self.conf.topo_order
                if self.nodes[n].kind == "layer"
                or (self.nodes[n].kind == "vertex"
                    and hasattr(self.nodes[n].ref, "initialize"))]

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
                p, s = node.ref.initialize(gen, *node.resolved_input_types)
            elif node.kind == "layer":
                p, s, _ = node.ref.initialize(gen, node.resolved_input_type)
            else:
                continue
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
                 report_conv=False, carries=None):
        """inputs: dict name -> tensor, feature masks under
        `mask_key(name)`. Returns (acts dict, preacts dict for output
        layers, new_state[, new carries when `carries` is given]).
        `report_conv` also computes the conv output of each fused pair, for
        feedForward. `carries` {node: carry} drives the recurrent layer
        nodes through `scan_apply` (rnnTimeStep)."""
        inputs, fmasks = split_inputs(inputs)
        if (train and carries is None and not report_conv
                and getattr(self.conf, "remat_policy", "none") == "blocks"
                and not self._fused_pairs and not fmasks):
            # the JAX package's rule: block remat runs on a graph without
            # fused pairs, feature masks or carries
            return self._forward_remat_blocks(params, state, inputs,
                                              generator)
        acts, preacts = {}, {}
        new_state = dict(state)
        new_carries = None if carries is None else {}
        mask0 = next(iter(fmasks.values()), None)
        masks = {}
        for name, x in inputs.items():
            acts[name] = x.to(self._compute_dtype)
            masks[name] = fmasks.get(name, mask0)
        for name in self.conf.topo_order:
            node = self.nodes[name]
            if node.kind == "input":
                continue
            parents = [acts[p] for p in node.inputs]
            parent_masks = [masks.get(p) for p in node.inputs]
            pmask = next((m for m in parent_masks if m is not None), None)
            if node.kind == "vertex":
                vertex = node.ref
                if getattr(vertex, "maskName", None) in fmasks:
                    pmask = fmasks[vertex.maskName]
                if hasattr(vertex, "initialize"):
                    acts[name] = vertex.apply(
                        *parents, params=params.get(name, {}), mask=pmask)
                else:
                    acts[name] = vertex.apply(*parents, mask=pmask)
                masks[name] = vertex.feed_forward_mask(*parent_masks)
                continue
            layer = node.ref
            # frozen layers (transfer learning) always run inference-mode
            ltrain = train and not getattr(layer, "frozen", False)
            x = parents[0]
            pmask = parent_masks[0]
            masks[name] = (None if pmask is None
                           else layer.feed_forward_mask(pmask))
            if node.preprocessor is not None:
                x = node.preprocessor.preProcess(x)
            if name in self._fused_convs:
                # conv half of a fused pair: pass the input through; the BN
                # node runs the fused kernel with both parameter groups
                acts[name] = x
                continue
            p = hook_params(layer, params.get(name, {}), ltrain, generator)
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
                pre = pre_activation(layer, p, xd, pmask)
                preacts[name] = pre
                acts[name] = get_activation(layer.activation)(pre)
            elif carries is not None and getattr(layer, "is_recurrent",
                                                 False):
                if not hasattr(layer, "scan_apply"):
                    raise ValueError(
                        f"rnnTimeStep: {type(layer).__name__} '{name}' "
                        "cannot run step-by-step (no carried state "
                        "protocol); use output() on whole sequences")
                x = layer._dropout_in(x, ltrain, generator)
                acts[name], new_carries[name] = layer.scan_apply(
                    p, x, carries.get(name), pmask)
            else:
                y, ns = apply_layer(layer, p, s, x, ltrain, generator,
                                    pmask)
                acts[name] = y
                if ns:
                    new_state[name] = ns
        if carries is not None:
            return acts, preacts, new_state, new_carries
        return acts, preacts, new_state

    # -- per-block selective recompute (rematPolicy "blocks") ------------
    def _run_node_plain(self, name, params, state, acts, new_state,
                        preacts, generator, train=True):
        """One node of the mask-free forward, with the general loop's
        per-node semantics (preprocessors, frozen layers, parameter hooks,
        dropout-in and pre-activation for loss heads)."""
        node = self.nodes[name]
        parents = [acts[p] for p in node.inputs]
        if node.kind == "vertex":
            if hasattr(node.ref, "initialize"):
                acts[name] = node.ref.apply(
                    *parents, params=params.get(name, {}), mask=None)
            else:
                acts[name] = node.ref.apply(*parents, mask=None)
            return
        layer = node.ref
        ltrain = train and not getattr(layer, "frozen", False)
        x = parents[0]
        if node.preprocessor is not None:
            x = node.preprocessor.preProcess(x)
        p = hook_params(layer, params.get(name, {}), ltrain, generator)
        s = state.get(name, {})
        if name in self.conf.output_names and hasattr(layer,
                                                      "compute_loss"):
            xd = layer._dropout_in(x, ltrain, generator)
            pre = pre_activation(layer, p, xd, None)
            preacts[name] = pre
            acts[name] = get_activation(layer.activation)(pre)
        else:
            y, ns = apply_layer(layer, p, s, x, ltrain, generator, None)
            acts[name] = y
            if ns:
                new_state[name] = ns

    def _forward_remat_blocks(self, params, state, inputs, generator):
        """The training forward with each segment of `conf.remat_plan()`
        under activation checkpointing: the backward keeps only each
        segment's saved outputs (on a residual chain, the block
        boundaries) and runs the segment's nodes again. Draws from the
        generator come back from the forward's record in the recompute
        (`remat_call`), so the masks equal the plain forward's."""
        acts = {n: x.to(self._compute_dtype) for n, x in inputs.items()}
        preacts = {}
        new_state = dict(state)
        for seg, outs in self.conf.remat_plan():
            seg_set = set(seg)
            ext = []
            for name in seg:
                for p in self.nodes[name].inputs:
                    if p not in seg_set and p not in ext:
                        ext.append(p)

            def seg_fn(*ext_acts, _seg=tuple(seg), _ext=tuple(ext),
                       _outs=tuple(outs)):
                a = dict(zip(_ext, ext_acts))
                ns, pre = {}, {}
                for n in _seg:
                    self._run_node_plain(n, params, state, a, ns, pre,
                                         generator)
                return tuple(a[n] for n in _outs), ns, pre

            out, ns, pre = remat_call(seg_fn, *(acts[p] for p in ext),
                                      draws=generator is not None)
            acts.update(zip(outs, out))
            new_state.update(ns)
            preacts.update(pre)
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

    def _with_masks(self, ins, fmasks):
        for n, m in (fmasks or {}).items():
            if m is not None:
                ins[mask_key(n)] = as_tensor(m, self._device)
        return ins

    def output(self, *inputs, train=False, generator=None, fmasks=None):
        """The output node(s) for the inputs (arrays, tensors or NDArrays,
        one per graph input, in the order of addInputs): one NDArray, or
        a list for several outputs. `fmasks`: {input name: (B, T) feature
        mask}. `train` runs dropout (from `generator`) and
        batch-statistics BN, without touching the stored state."""
        out = self._output(*inputs, train=train, generator=generator,
                           fmasks=fmasks)
        return [NDArray(o) for o in out] if isinstance(out, list) \
            else NDArray(out)

    def _output(self, *inputs, train=False, generator=None, fmasks=None):
        """`output` as tensors (what the port's own callers read)."""
        if len(inputs) == 1:
            inputs = inputs[0]
        ins = self._with_masks(self._as_input_dict(inputs), fmasks)
        acts, _, _ = self._forward(self._params, self._state, ins, train,
                                   generator)
        outs = [acts[n] for n in self.conf.output_names]
        return outs[0] if len(outs) == 1 else outs

    def outputSingle(self, *inputs):
        out = self.output(*inputs)
        return out[0] if isinstance(out, list) else out

    def getOutputLayer(self, index=0):
        """The configuration of the index-th output layer."""
        return self.nodes[self.conf.output_names[index]].ref

    def getPredictedObjects(self, inputs, confThreshold=0.5,
                            nmsThreshold=0.4):
        """The detections of a Yolo2OutputLayer head (≡
        YoloUtils.getPredictedObjects over this graph's output): forward,
        decode, threshold and per-class NMS. `inputs` is one array, or a
        list or dict for a graph of several inputs. Returns
        List[List[DetectedObject]], an inner list per example."""
        out_layer = self.getOutputLayer(0)
        if not hasattr(out_layer, "getPredictedObjects"):
            raise TypeError(
                f"output layer {type(out_layer).__name__} has no detection "
                "decode — getPredictedObjects needs a Yolo2OutputLayer head")
        with torch.no_grad():
            y = self._output(inputs)
        if isinstance(y, list):
            y = y[0]
        return out_layer.getPredictedObjects(y, confThreshold, nmsThreshold)

    def feedForward(self, inputs, train=False, generator=None):
        """Every node's activation, {name: NDArray}; a fused conv node
        reports its true conv output."""
        ins = self._as_input_dict(inputs)
        acts, _, _ = self._forward(self._params, self._state, ins, train,
                                   generator, report_conv=True)
        return {k: NDArray(v) for k, v in acts.items()}

    # -- loss and score --------------------------------------------------
    def _loss(self, params, state, inputs, labels, lmasks=None,
              generator=None, train=True):
        """(the scalar loss, the new state): each output layer's loss on
        its pre-activation in f32, summed, plus the L1/L2 penalty."""
        acts, preacts, new_state = self._forward(params, state, inputs,
                                                 train, generator)
        total = 0.0
        for i, name in enumerate(self.conf.output_names):
            node = self.nodes[name]
            layer = node.ref
            if not hasattr(layer, "compute_loss"):
                raise ValueError(f"Output node '{name}' is not an output "
                                 "layer")
            y = labels[i].to(torch.float32)
            lm = None if lmasks is None else lmasks[i]
            if getattr(layer, "needs_features", False):
                # the loss reads the layer's input (CenterLossOutputLayer)
                feats = acts[node.inputs[0]]
                if node.preprocessor is not None:
                    feats = node.preprocessor.preProcess(feats)
                total = total + layer.compute_loss_with_features(
                    params.get(name, {}), y, preacts[name].float(),
                    feats.float(), lm)
            else:
                total = total + layer.compute_loss(y, preacts[name].float(),
                                                   lm)
        return total + self._penalty(params), new_state

    # -- training and evaluation (nn/_network.py) ------------------------
    @property
    def _input_names(self):
        return self.conf.input_names

    def _eval_output(self, features, fmask):
        fmasks = None if fmask is None else {self.conf.input_names[0]: fmask}
        out = self._output(features, fmasks=fmasks)
        return out[0] if isinstance(out, list) else out

    # -- stateful RNN inference ------------------------------------------
    @torch.no_grad()
    def summary(self):
        """The reference's table: each node in topological order with its
        kind (the layer class for a layer), inputs and parameter count,
        then the total."""
        from deeplearning4j_tpu_torch.resilience.integrity import flatten
        lines = ["=" * 78,
                 f"{'Name':<20}{'Kind':<10}{'Inputs':<26}{'nParams':>10}",
                 "-" * 78]
        total = 0
        for name in self.conf.topo_order:
            node = self.nodes[name]
            p = (self._params or {}).get(name, {})
            n = sum(int(torch.Size(getattr(v, "shape", ())).numel())
                    for _, v in flatten(p))
            total += n
            kind = node.kind if node.kind != "layer" \
                else type(node.ref).__name__
            lines.append(f"{name:<20}{kind:<10}{','.join(node.inputs):<26}"
                         f"{n:>10,}")
        lines += ["-" * 78, f"Total params: {total:,}", "=" * 78]
        return "\n".join(lines)

    def rnnTimeStep(self, *inputs):
        """The output(s) for the next step(s), continuing from the carries
        the last call left; (B, F) inputs give (B, C) outputs."""
        if len(inputs) == 1:
            inputs = inputs[0]
        ins = self._as_input_dict(inputs)
        squeeze = any(v.ndim == 2 for v in ins.values())
        ins = {k: (v[:, None, :] if v.ndim == 2 else v)
               for k, v in ins.items()}
        acts, _, _, self._rnn_carries = self._forward(
            self._params, self._state, ins, False,
            carries=self._rnn_carries or {})
        outs = [NDArray(acts[n][:, -1, :] if squeeze and acts[n].ndim == 3
                        else acts[n]) for n in self.conf.output_names]
        return outs[0] if len(outs) == 1 else outs

    def rnnClearPreviousState(self):
        self._rnn_carries = None

    def rnnGetPreviousState(self, node_name):
        return (self._rnn_carries or {}).get(node_name)

    @staticmethod
    def load(path, loadUpdater=True, device=None):
        """A ComputationGraph restored from an archive of either package,
        on `device` (default: the card)."""
        from deeplearning4j_tpu_torch.util.model_serializer import \
            ModelSerializer
        return ModelSerializer.restoreComputationGraph(path, loadUpdater,
                                                       device)
