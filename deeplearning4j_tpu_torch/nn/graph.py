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

Training: `fit` runs, for each batch, the loss (the output layers' losses
plus the L1/L2 penalty), `backward`, the optimizer of `build_optimizer`
(per-layer updater overrides included) and the new BN state; `score`
gives the last training loss or an inference-mode loss of a batch. With
the fusion on, every marked pair trains through `fused_conv1x1_bn`'s
three kernels. A `torch.Generator` seeded from conf.seed, on the graph's
device, draws the dropout masks. Not ported yet, each raising and naming
its slice: `evaluate`, remat, gradient accumulation, constraints, feature
masks, and stateful RNN stepping (A12).
"""
from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.device import resolve
from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.fused import (find_conv1x1_bn_fusions,
                                               fused_apply, fusion_enabled)
from deeplearning4j_tpu_torch.nn.updaters import (apply_updates,
                                                  build_optimizer,
                                                  multi_transform,
                                                  same_updater)

_DTYPES = {"float": torch.float32, "float32": torch.float32,
           "double": torch.float64, "float64": torch.float64,
           "half": torch.float16, "float16": torch.float16,
           "bfloat16": torch.bfloat16}


def _later(what, where):
    return NotImplementedError(
        f"ComputationGraph: {what} is not ported yet; it comes with {where}")


def _to(tree, device):
    return {n: {k: v.to(device) for k, v in d.items()}
            for n, d in tree.items()}


def _l1l2_penalty(layers, params):
    """≡ the reference's score regularization: l1·Σ|W| + 0.5·l2·‖W‖² over
    the weight tensors of each layer (biases, β, γ excluded), in f32.
    `params` is a list parallel to `layers`."""
    total = 0.0
    for layer, p in zip(layers, params):
        l1, l2 = layer.regularization_terms()
        if not l1 and not l2:
            continue
        for name, v in p.items():
            if name in ("b", "beta", "gamma", "alpha", "centers"):
                continue
            v = v.float()
            if l1:
                total = total + l1 * v.abs().sum()
            if l2:
                total = total + 0.5 * l2 * (v * v).sum()
    return total


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
        self._tx = None          # the optimizer, built at the first fit
        self._opt_state = None
        self._generator = None   # dropout masks, from conf.seed
        self._listeners = []
        self._score = None
        self._iteration = 0
        self._epoch = 0

    @property
    def _layer_names(self):
        """Layer-bearing node names in topological order."""
        return [n for n in self.conf.topo_order
                if self.nodes[n].kind == "layer"]

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
        names = self._layer_names
        return (total + _l1l2_penalty([self.nodes[n].ref for n in names],
                                      [params.get(n, {}) for n in names]),
                new_state)

    def score(self, dataset=None):
        """The loss of the last training step (None before the first), or
        the inference-mode loss of `dataset` (≡ the reference's
        score(DataSet))."""
        if dataset is None:
            return None if self._score is None else float(self._score)
        ins, labels, lmasks = self._unpack(dataset)
        with torch.no_grad():
            loss, _ = self._loss(self._params, self._state, ins, labels,
                                 lmasks, None, train=False)
        return float(loss)

    # -- training --------------------------------------------------------
    def _build_optimizer(self):
        """The optimizer of the configuration: the global updater, and
        each layer whose own updater differs from it gets its own, all
        behind the same gradient normalization and weight decay."""
        defaults = self.conf.defaults
        if any(getattr(self.nodes[n].ref, "constraints", None)
               for n in self._layer_names):
            raise _later("constraints", "a later slice of the nn core "
                         "(ROADMAP A10)")
        glob = defaults.get("updater")
        gn = defaults.get("gradientNormalization")
        thr = defaults.get("gradientNormalizationThreshold", 1.0)
        wd = defaults.get("weightDecay", 0.0) or 0.0
        overrides = {n: self.nodes[n].ref.updater for n in self._layer_names
                     if self.nodes[n].ref.updater is not None
                     and not same_updater(self.nodes[n].ref.updater, glob)}
        tx = build_optimizer(glob, gn, thr, wd)
        if overrides:
            opts = {"__global__": tx}
            opts.update({n: build_optimizer(u, gn, thr, wd)
                         for n, u in overrides.items()})
            tx = multi_transform(opts, {n: n for n in overrides})
        self._tx = tx
        self._opt_state = tx.init(self._params)

    def _value_and_grad(self, ins, labels, lmasks=None, generator=None):
        """(loss, gradients {node: {key: tensor}}, new state) of one
        training-mode forward and backward at the current parameters. A
        parameter the loss does not reach gets a zero gradient, as
        `jax.grad` gives it."""
        leaves = {n: {k: v.detach().requires_grad_() for k, v in d.items()}
                  for n, d in self._params.items()}
        loss, new_state = self._loss(leaves, self._state, ins, labels,
                                     lmasks, generator, train=True)
        flat = [(n, k, v) for n, d in leaves.items() for k, v in d.items()]
        grads = torch.autograd.grad(loss, [v for _, _, v in flat],
                                    allow_unused=True)
        tree = {}
        for (n, k, v), g in zip(flat, grads):
            tree.setdefault(n, {})[k] = torch.zeros_like(v) if g is None \
                else g
        state = {n: {k: v.detach() for k, v in d.items()}
                 for n, d in new_state.items()}
        return loss.detach(), tree, state

    def _train_step(self, ins, labels, lmasks):
        """One step: loss, backward, optimizer update, new BN state."""
        if self._tx is None:
            self._build_optimizer()
        if self._generator is None:
            self._generator = torch.Generator(device=self._device)
            self._generator.manual_seed(int(self.conf.seed))
        loss, grads, state = self._value_and_grad(ins, labels, lmasks,
                                                  self._generator)
        updates, self._opt_state = self._tx.update(grads, self._opt_state,
                                                   self._params)
        self._params = apply_updates(self._params, updates)
        self._state = state
        self._score = loss
        self._iteration += 1
        for listener in self._listeners:
            listener.iterationDone(self, self._iteration, self._epoch)

    def _unpack(self, ds):
        """(inputs {name: tensor}, labels [tensor], label masks or None) of
        a DataSet or MultiDataSet, on the graph's device."""
        def tensor(a):
            return None if a is None else torch.as_tensor(
                np.asarray(a), device=self._device)

        if isinstance(ds, MultiDataSet):
            fmasks, lmasks = ds.featuresMasks, ds.labelsMasks
            ins = {n: tensor(f) for n, f in zip(self.conf.input_names,
                                                ds.features)}
            labels = [tensor(l) for l in ds.labels]
        elif isinstance(ds, DataSet):
            fmasks = None if ds.featuresMask is None else [ds.featuresMask]
            lmasks = None if ds.labelsMask is None else [ds.labelsMask]
            ins = {self.conf.input_names[0]: tensor(ds.features)}
            labels = [tensor(ds.labels)]
        else:
            raise TypeError(f"Cannot fit on {type(ds)}")
        if fmasks is not None and any(m is not None for m in fmasks):
            raise _later("feature masks", "the recurrent layers (ROADMAP "
                         "A12)")
        if lmasks is not None:
            lmasks = [tensor(m) for m in lmasks]
        return ins, labels, lmasks

    def _fit_batch(self, ds):
        self._train_step(*self._unpack(ds))

    def fit(self, data, labels=None, epochs=None, stepsPerDispatch=1):
        """Train on one batch — a DataSet, a MultiDataSet, fit(features,
        labels) or a (features, labels) pair — or on each batch of an
        iterable (an iterator with `reset` is reset at each epoch) for
        `epochs` epochs. `stepsPerDispatch` k groups k batches into one
        dispatch in the JAX package, numerically identical to k sequential
        steps; the port runs them sequentially."""
        if self._params is None:
            self.init()
        if int(self.conf.defaults.get("gradientAccumulation", 1) or 1) > 1:
            raise _later("gradientAccumulation", "a later slice of the nn "
                         "core (ROADMAP A10)")
        if int(stepsPerDispatch) < 1:
            raise ValueError(f"stepsPerDispatch must be >= 1, got "
                             f"{stepsPerDispatch}")
        if labels is not None:
            self._fit_batch(DataSet(data, labels))
            return self
        if isinstance(data, (DataSet, MultiDataSet)):
            self._fit_batch(data)
            return self
        if (isinstance(data, tuple) and len(data) == 2
                and not isinstance(data[0], (DataSet, MultiDataSet))):
            self._fit_batch(DataSet(*data))
            return self
        for _ in range(int(epochs) if epochs is not None else 1):
            if hasattr(data, "reset"):
                data.reset()
            for ds in data:
                self._fit_batch(ds)
            self._epoch += 1
            for listener in self._listeners:
                if hasattr(listener, "onEpochEnd"):
                    listener.onEpochEnd(self)
        return self

    # -- listeners / counters ---------------------------------------------
    def setListeners(self, *listeners):
        if len(listeners) == 1 and isinstance(listeners[0], (list, tuple)):
            listeners = listeners[0]
        self._listeners = list(listeners)
        return self

    def getIterationCount(self):
        return self._iteration

    def getEpochCount(self):
        return self._epoch

    # -- later slices ----------------------------------------------------
    def evaluate(self, *args, **kwargs):
        raise _later("evaluate", "the evaluation slice (eval/, ROADMAP "
                     "A17)")

    def rnnTimeStep(self, *inputs):
        raise NotImplementedError(
            "ComputationGraph.rnnTimeStep (carried recurrent state) comes "
            "with the recurrent layers, ROADMAP A12")
