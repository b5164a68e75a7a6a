"""SameDiff: the port of `deeplearning4j_tpu/autodiff/samediff.py` (≡
nd4j-api :: autodiff.samediff.SameDiff / SDVariable).

The graph records ops as (opname, JSON params) whose torch functions come
from `graph_serde.OP_BUILDERS`, so a graph saves and loads with no
defining source, and either package loads the other's archive. Values,
placeholders and every op run on the graph's device (the card unless the
caller passes `device="cpu"`).

Execution is eager: `output()` walks the recorded graph op by op on the
device, with no capture — the JAX package compiles the same walk into one
XLA executable per placeholder-shape key. Gradients come from
`torch.autograd` over that walk (the JAX package's `jax.grad`), and `fit`
updates the variables with the port's `nn/updaters` (optax's formulas).
Control flow is Python control flow over tensors: a predicate or loop
condition is a host read of a device value, counted by
`runtime.pipeline.record_sync` (site "samediff.<op>"); loops run their
body once per trip, so a while loop's gradient flows through every trip.
Random ops draw from a `torch.Generator` seeded with the op's seed, on the
CPU and then moved to the device, so a draw is the same on every device
and repeats on every evaluation (the JAX package's fixed-key semantics).

Variable kinds mirror the reference: PLACEHOLDER (fed at exec), VARIABLE
(trainable), CONSTANT.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve
from deeplearning4j_tpu_torch.nn.updaters import (Optimizer, Updater,
                                                  apply_updates,
                                                  build_optimizer)
from deeplearning4j_tpu_torch.ops.ndarray import NDArray, as_torch
from deeplearning4j_tpu_torch.runtime.executables import tensor_leaves

__all__ = ["SameDiff", "SDVariable", "TrainingConfig", "VariableType"]

#: the optimizer's one node over the graph's variables ({node: {name: t}})
_NODE = "samediff"


class VariableType:
    PLACEHOLDER = "placeholder"
    VARIABLE = "variable"
    CONSTANT = "constant"
    ARRAY = "array"  # op outputs


def host_bool(t, site):
    """A device scalar read on the host as a bool: one host sync, counted
    on `dl4j.pipeline.syncs` with its site."""
    from deeplearning4j_tpu_torch.runtime.pipeline import record_sync
    t0 = time.perf_counter()
    out = bool(torch.as_tensor(t).reshape(()).item())
    record_sync(site, (time.perf_counter() - t0) * 1e3)
    return out


class SDVariable:
    def __init__(self, sd, name, vtype, shape=None, fn=None, inputs=()):
        self.sd = sd
        self.name = name
        self.vtype = vtype
        self.shape = shape
        self.fn = fn                    # for ARRAY nodes: f(*input_tensors)
        self.inputs = list(inputs)      # parent variable names

    # -- fluent math (mirrors SDVariable's operator surface) -------------
    def _bin(self, other, opname):
        other = self.sd._lift(other)
        return self.sd._op(opname, None, self, other, params={})

    def add(self, o):
        return self._bin(o, "add")

    def sub(self, o):
        return self._bin(o, "sub")

    def mul(self, o):
        return self._bin(o, "mul")

    def div(self, o):
        return self._bin(o, "div")

    def rsub(self, o):
        return self.sd._lift(o)._bin(self, "sub")

    def rdiv(self, o):
        return self.sd._lift(o)._bin(self, "div")

    def mmul(self, o):
        return self._bin(o, "mmul")

    def pow(self, p):
        return self.sd._op("pow", None, self, params={"p": float(p)})

    def neg(self):
        return self.sd._op("neg", None, self, params={})

    def transpose(self, *axes):
        ax = list(axes) if axes else None
        return self.sd._op("transpose", None, self, params={"axes": ax})

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return self.sd._op("reshape", None, self,
                           params={"shape": [int(s) for s in shape]})

    def _reduce(self, opname, dims, keepdims):
        ax = None
        if dims:
            ax = int(dims[0]) if len(dims) == 1 else [int(d) for d in dims]
        return self.sd._op(opname, None, self,
                           params={"axis": ax, "keepdims": bool(keepdims)})

    def sum(self, *dims, keepdims=False):
        return self._reduce("sum", dims, keepdims)

    def mean(self, *dims, keepdims=False):
        return self._reduce("mean", dims, keepdims)

    def max(self, *dims, keepdims=False):
        return self._reduce("max", dims, keepdims)

    def min(self, *dims, keepdims=False):
        return self._reduce("min", dims, keepdims)

    def std(self, *dims, keepdims=False):
        return self._reduce("std", dims, keepdims)

    def argmax(self, dim=-1):
        return self.sd._op("argmax", None, self, params={"dim": int(dim)})

    # python operators
    __add__ = add
    __radd__ = add
    __sub__ = sub
    __mul__ = mul
    __rmul__ = mul
    __truediv__ = div
    __matmul__ = mmul

    def __rsub__(self, o):
        return self.rsub(o)

    def __rtruediv__(self, o):
        return self.rdiv(o)

    def __neg__(self):
        return self.neg()

    def __pow__(self, p):
        return self.pow(p)

    def rename(self, new_name):
        return self.sd.rename(self.name, new_name)

    def eval(self, placeholders=None):
        return self.sd.output(placeholders or {}, [self.name])[self.name]

    def getArr(self):
        if self.vtype in (VariableType.VARIABLE, VariableType.CONSTANT):
            return NDArray(self.sd._values[self.name])
        return self.eval()

    def setArray(self, arr):
        self.sd._values[self.name] = as_torch(arr, device=self.sd._device)

    def __repr__(self):
        return f"SDVariable(name={self.name!r}, type={self.vtype})"


class _MathNamespace:
    def __init__(self, sd):
        self.sd = sd

    def _u(self, opname, x, params=None):
        return self.sd._op(opname, None, self.sd._lift(x),
                           params=params or {})

    def exp(self, x):
        return self._u("exp", x)

    def log(self, x):
        return self._u("log", x)

    def sqrt(self, x):
        return self._u("sqrt", x)

    def square(self, x):
        return self._u("square", x)

    def abs(self, x):
        return self._u("abs", x)

    def sin(self, x):
        return self._u("sin", x)

    def cos(self, x):
        return self._u("cos", x)

    def tanh(self, x):
        return self._u("tanh", x)

    def sigmoid(self, x):
        return self._u("sigmoid", x)

    def clip(self, x, lo, hi):
        # open bounds (None or ±inf) travel as null: the artifact is
        # strict JSON (allow_nan=False), so ±inf must not reach params
        return self._u("clip", x, {
            "lo": None if lo is None or lo == -np.inf else float(lo),
            "hi": None if hi is None or hi == np.inf else float(hi)})


class _NNNamespace:
    def __init__(self, sd):
        self.sd = sd

    def relu(self, x):
        return self.sd._op("relu", None, self.sd._lift(x), params={})

    def gelu(self, x):
        return self.sd._op("gelu", None, self.sd._lift(x), params={})

    def softmax(self, x, axis=-1):
        return self.sd._op("softmax", None, self.sd._lift(x),
                           params={"axis": int(axis)})

    def logSoftmax(self, x, axis=-1):
        return self.sd._op("log_softmax", None, self.sd._lift(x),
                           params={"axis": int(axis)})

    def tanh(self, x):
        return self.sd._op("tanh", None, self.sd._lift(x), params={})

    def sigmoid(self, x):
        return self.sd._op("sigmoid", None, self.sd._lift(x), params={})

    def dropout(self, x, keep_prob):
        # inference identity, as in the JAX package
        return self.sd._op("dropout_id", None, self.sd._lift(x), params={})

    def linear(self, input, weights, bias=None):
        if bias is None:
            return input.mmul(weights)
        return input.mmul(weights).add(bias)

    def layerNorm(self, x, gain, bias=None, eps=1e-5, axis=-1):
        x, gain = self.sd._lift(x), self.sd._lift(gain)
        ins = (x, gain) + ((self.sd._lift(bias),) if bias is not None else ())
        return self.sd._op("layer_norm", None, *ins,
                           params={"eps": float(eps), "axis": int(axis)})

    def batchNorm(self, x, mean, var, gamma, beta, eps=1e-5):
        return self.sd._op("batch_norm", None,
                           *(self.sd._lift(v) for v in
                             (x, mean, var, gamma, beta)),
                           params={"eps": float(eps)})


class _LossNamespace:
    def __init__(self, sd):
        self.sd = sd

    def softmaxCrossEntropy(self, name, labels, logits):
        labels, logits = self.sd._lift(labels), self.sd._lift(logits)
        return self.sd._op_named(name, "softmax_xent", None, labels, logits,
                                 params={})

    def sigmoidCrossEntropy(self, name, labels, logits):
        labels, logits = self.sd._lift(labels), self.sd._lift(logits)
        return self.sd._op_named(name, "sigmoid_xent", None, labels, logits,
                                 params={})

    def meanSquaredError(self, name, labels, predictions):
        labels, predictions = self.sd._lift(labels), self.sd._lift(predictions)
        return self.sd._op_named(name, "mse", None, labels, predictions,
                                 params={})

    def l2Loss(self, name, x):
        return self.sd._op_named(name, "l2", None, self.sd._lift(x),
                                 params={})


def _pair2(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


class _CNNNamespace:
    """≡ SameDiff.cnn() — conv/pool ops over NHWC activations and HWIO
    kernels, as in the JAX package."""

    def __init__(self, sd):
        self.sd = sd

    def conv2d(self, x, weights, bias=None, stride=(1, 1), padding="SAME",
               dilation=(1, 1)):
        """x (B,H,W,Cin), weights (kh,kw,Cin,Cout) HWIO."""
        x = self.sd._lift(x)
        weights = self.sd._lift(weights)
        params = {"stride": list(_pair2(stride)),
                  "padding": padding if isinstance(padding, str)
                  else [list(p) for p in padding],
                  "dilation": list(_pair2(dilation))}
        ins = (x, weights) if bias is None else (x, weights,
                                                self.sd._lift(bias))
        return self.sd._op("conv2d", None, *ins, params=params)

    def maxPooling2d(self, x, kernel=(2, 2), stride=(2, 2), padding="VALID"):
        return self.sd._op("maxpool2d", None, self.sd._lift(x),
                           params={"kernel": list(_pair2(kernel)),
                                   "stride": list(_pair2(stride)),
                                   "padding": padding})

    def avgPooling2d(self, x, kernel=(2, 2), stride=(2, 2), padding="VALID"):
        # divides by the TRUE window population so SAME padding zeros
        # don't dilute edge averages (TF/Keras/reference semantics)
        return self.sd._op("avgpool2d", None, self.sd._lift(x),
                           params={"kernel": list(_pair2(kernel)),
                                   "stride": list(_pair2(stride)),
                                   "padding": padding})

    def upsampling2d(self, x, scale=2):
        return self.sd._op("upsampling2d", None, self.sd._lift(x),
                           params={"scale": int(scale)})


class _LinalgNamespace:
    """≡ SameDiff.linalg() — torch.linalg-backed decompositions."""

    def __init__(self, sd):
        self.sd = sd

    def mmul(self, a, b):
        return self.sd._lift(a).mmul(self.sd._lift(b))

    def cholesky(self, x):
        return self.sd._op("cholesky", None, self.sd._lift(x), params={})

    def qr(self, x):
        return self.sd._op("qr", None, self.sd._lift(x), params={})

    def svd(self, x):
        """Singular values (the reference's Svd op surface)."""
        return self.sd._op("svd", None, self.sd._lift(x), params={})

    def solve(self, a, b):
        return self.sd._op("solve", None, self.sd._lift(a),
                           self.sd._lift(b), params={})


class _RandomNamespace:
    """≡ SameDiff.random() — sampling ops. Each op node draws from a
    generator seeded at construction (the seed comes from the graph's
    deterministic RNG), so repeated eval() of the same node returns the
    SAME array, as in the JAX package. Create a new op for a fresh draw."""

    def __init__(self, sd):
        self.sd = sd

    def _draw(self, opname, shape, extra):
        seed = int(self.sd._rng.integers(0, 2 ** 31 - 1))
        params = {"seed": seed, "shape": [int(s) for s in shape], **extra}
        return self.sd._op(opname, None, params=params)

    def normal(self, mean, stddev, *shape):
        return self._draw("random_normal", shape,
                          {"mean": float(mean), "stddev": float(stddev)})

    def uniform(self, lo, hi, *shape):
        return self._draw("random_uniform", shape,
                          {"lo": float(lo), "hi": float(hi)})

    def bernoulli(self, p, *shape):
        return self._draw("random_bernoulli", shape, {"p": float(p)})


class TrainingConfig:
    """≡ org.nd4j.autodiff.samediff.TrainingConfig.Builder."""

    def __init__(self, updater=None, l1=0.0, l2=0.0,
                 dataSetFeatureMapping=None, dataSetLabelMapping=None):
        self.updater = updater
        self.l1 = float(l1)
        self.l2 = float(l2)
        self.dataSetFeatureMapping = dataSetFeatureMapping or []
        self.dataSetLabelMapping = dataSetLabelMapping or []

    class Builder:
        def __init__(self):
            self._kw = {}

        def updater(self, u):
            self._kw["updater"] = u
            return self

        def l1(self, v):
            self._kw["l1"] = v
            return self

        def l2(self, v):
            self._kw["l2"] = v
            return self

        def dataSetFeatureMapping(self, *names):
            self._kw["dataSetFeatureMapping"] = list(names)
            return self

        def dataSetLabelMapping(self, *names):
            self._kw["dataSetLabelMapping"] = list(names)
            return self

        def build(self):
            return TrainingConfig(**self._kw)


class SameDiff:
    def __init__(self, device=None):
        self._device = resolve(device)
        self._nodes = {}      # name -> SDVariable
        self._values = {}     # VARIABLE/CONSTANT name -> tensor
        self._counter = 0
        self._loss_names = []
        self._training_config = None
        self._opt_state = None
        self._tx = None
        self._pending_opt_leaves = None
        self._rng = np.random.default_rng(0)
        self.math = _MathNamespace(self)
        self.nn = _NNNamespace(self)
        self.loss = _LossNamespace(self)
        self.cnn = _CNNNamespace(self)
        self.linalg = _LinalgNamespace(self)
        self.random = _RandomNamespace(self)

    @staticmethod
    def create(device=None):
        return SameDiff(device=device)

    @property
    def device(self):
        return self._device

    def summary(self):
        """≡ SameDiff.summary(): table of variables (name, kind, shape)
        and op nodes (name, op, inputs)."""
        lines = ["--- SameDiff summary ---",
                 f"{'Name':<24} {'Kind':<12} {'Shape/Op':<20} Inputs"]
        n_vars = n_ops = 0
        for name, v in self._nodes.items():
            if v.vtype == VariableType.ARRAY:
                n_ops += 1
                op = getattr(v, "opname", None) or (
                    v.fn.__name__ if v.fn is not None else "?")
                if op in ("<lambda>", "?"):
                    op = name.rsplit("_", 1)[0]  # node names carry the op
                lines.append(f"{name:<24} {'op':<12} {op:<20} "
                             f"{', '.join(v.inputs)}")
            else:
                n_vars += 1
                shape = tuple(v.shape) if v.shape is not None else "?"
                val = self._values.get(name)
                if val is not None:
                    shape = tuple(val.shape)
                lines.append(f"{name:<24} {v.vtype:<12} {str(shape):<20}")
        lines.append(f"--- {n_vars} variables, {n_ops} ops, "
                     f"losses: {self._loss_names or '[]'} ---")
        return "\n".join(lines)

    # -- variable creation ----------------------------------------------
    def _fresh(self, base):
        self._counter += 1
        return f"{base}_{self._counter}"

    def placeHolder(self, name, *shape, dtype=None):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        v = SDVariable(self, name, VariableType.PLACEHOLDER, shape)
        self._nodes[name] = v
        return v

    def var(self, name, init=None, shape=None):
        """Trainable variable: init can be an array or a shape tuple (then
        drawn as the JAX package draws it, from the graph's numpy RNG)."""
        if init is None and shape is not None:
            init = shape
        if isinstance(init, (tuple, list)) and all(
                isinstance(i, (int, np.integer)) for i in init):
            fan_in = init[0] if len(init) > 1 else 1
            arr = (self._rng.standard_normal(tuple(init))
                   * np.sqrt(1.0 / max(1, fan_in))).astype(np.float32)
            t = torch.as_tensor(arr, device=self._device)
        else:
            t = as_torch(init, device=self._device).clone()
        v = SDVariable(self, name, VariableType.VARIABLE, tuple(t.shape))
        self._nodes[name] = v
        self._values[name] = t
        return v

    def constant(self, name, value=None):
        if value is None:
            name, value = self._fresh("const"), name
        if isinstance(value, np.ndarray) and not value.flags.writeable:
            value = value.copy()   # a view of a parsed buffer
        t = as_torch(value, device=self._device)
        v = SDVariable(self, name, VariableType.CONSTANT, tuple(t.shape))
        self._nodes[name] = v
        self._values[name] = t
        return v

    def _lift(self, x):
        if isinstance(x, SDVariable):
            return x
        return self.constant(self._fresh("lit"), x)

    # -- op recording ----------------------------------------------------
    def _op(self, opname, fn, *inputs, params=None):
        return self._op_named(self._fresh(opname), opname, fn, *inputs,
                              params=params)

    def _op_named(self, name, opname, fn, *inputs, params=None):
        """Record one op node. fn=None (the serializable form) builds the
        fn from graph_serde.OP_BUILDERS[opname](**params) — opname+params
        then fully describe the node, and save() can persist it. An
        explicit fn (control flow, ad-hoc callables) executes fine but
        marks the node non-serializable."""
        serializable = fn is None
        if fn is None:
            from deeplearning4j_tpu_torch.autodiff.graph_serde import \
                build_fn
            fn = build_fn(opname, params)
        v = SDVariable(self, name, VariableType.ARRAY, None, fn,
                       [i.name for i in inputs])
        v.opname = opname
        v.params = params
        v.serializable = serializable
        self._nodes[name] = v
        return v

    def rename(self, old, new):
        v = self._nodes.pop(old)
        v.name = new
        self._nodes[new] = v
        for node in self._nodes.values():
            node.inputs = [new if i == old else i for i in node.inputs]
        if old in self._values:
            self._values[new] = self._values.pop(old)
        if old in self._loss_names:
            self._loss_names = [new if n == old else n for n in self._loss_names]
        return v

    def getVariable(self, name):
        return self._nodes[name]

    def variables(self):
        return [v for v in self._nodes.values()
                if v.vtype == VariableType.VARIABLE]

    # -- execution -------------------------------------------------------
    def _topo(self, targets):
        order, seen = [], set()

        def visit(name):
            if name in seen:
                return
            seen.add(name)
            for p in self._nodes[name].inputs:
                visit(p)
            order.append(name)

        for t in targets:
            visit(t)
        return order

    def _make_exec(self, out_names):
        """One function (values, placeholders) -> outputs dict over the
        nodes the outputs need, in topological order."""
        order = self._topo(out_names)
        nodes = {n: self._nodes[n] for n in order}

        def run(values, placeholders):
            env = {}
            for n in order:
                node = nodes[n]
                if node.vtype == VariableType.PLACEHOLDER:
                    env[n] = placeholders[n]
                elif node.vtype in (VariableType.VARIABLE,
                                    VariableType.CONSTANT):
                    env[n] = values[n]
                elif node.inputs:
                    env[n] = node.fn(*(env[i] for i in node.inputs))
                else:   # a source op (a random draw): made on the CPU
                    env[n] = node.fn().to(self._device)
            return {n: env[n] for n in out_names}

        return run

    def _placeholders(self, placeholders):
        return {k: as_torch(v, device=self._device)
                for k, v in (placeholders or {}).items()}

    def output(self, placeholders, outputs):
        """≡ SameDiff.output(Map, String...) — returns dict name->NDArray."""
        if isinstance(outputs, str):
            outputs = [outputs]
        run = self._make_exec(tuple(outputs))
        with torch.no_grad():
            res = run(self._values, self._placeholders(placeholders))
        return {k: NDArray(v) for k, v in res.items()}

    def outputSingle(self, placeholders, output):
        return self.output(placeholders, [output])[output]

    def evaluate(self, iterator, outputVariable, evaluation=None,
                 labelIndex=None):
        """≡ SameDiff.evaluate(DataSetIterator, outputVariable,
        Evaluation): feed each DataSet through the TrainingConfig's
        dataSetFeatureMapping and accumulate predictions vs labels.

        Multi-output graphs (≡ SameDiff.evaluate(iterator,
        variableEvals, predictionLabelMapping)): pass a DICT
        {outputVariable: IEvaluation} — each variable scores against the
        label array at `labelIndex[var]` (defaults to the variable's
        position in the dict). All outputs come from ONE forward per
        batch. Returns the dict."""
        tc = self._training_config
        if tc is None or not getattr(tc, "dataSetFeatureMapping", None):
            raise ValueError(
                "evaluate() needs a TrainingConfig with "
                "dataSetFeatureMapping/dataSetLabelMapping (call "
                "setTrainingConfig first)")
        if isinstance(outputVariable, dict):
            var_evals = dict(outputVariable)
            label_idx = {v: (labelIndex or {}).get(v, i)
                         for i, v in enumerate(var_evals)}
        else:
            if evaluation is None:
                from deeplearning4j_tpu_torch.eval.evaluation import \
                    Evaluation
                evaluation = Evaluation()
            var_evals = {outputVariable: evaluation}
            label_idx = {outputVariable: 0}
        if hasattr(iterator, "reset"):
            iterator.reset()
        from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
        out_names = list(var_evals)
        for ds in iterator:
            feats = ds.features if isinstance(ds, MultiDataSet) \
                else [ds.features]
            labs = ds.labels if isinstance(ds, MultiDataSet) \
                else [ds.labels]
            if len(feats) != len(tc.dataSetFeatureMapping):
                raise ValueError(
                    f"evaluate(): {len(feats)} feature arrays vs "
                    f"{len(tc.dataSetFeatureMapping)} mapped placeholders")
            phs = dict(zip(tc.dataSetFeatureMapping, feats))
            preds = self.output(phs, out_names)
            masks = getattr(ds, "labelsMask",
                            getattr(ds, "labelsMasks", None))
            if not isinstance(masks, (list, tuple)):
                masks = [masks] * len(labs)
            for var, ev in var_evals.items():
                li = label_idx[var]
                if li >= len(labs):
                    raise ValueError(
                        f"evaluate(): output '{var}' maps to label index "
                        f"{li} but the DataSet has {len(labs)} label "
                        "arrays")
                ev.eval(labs[li], preds[var].tensor.cpu().numpy(),
                        masks[li] if li < len(masks) else None)
        return (var_evals if isinstance(outputVariable, dict)
                else var_evals[outputVariable])

    def batchOutput(self):
        sd = self

        class _B:
            def __init__(self):
                self._phs, self._outs = {}, []

            def input(self, name, arr):
                self._phs[name] = arr
                return self

            def output(self, *names):
                self._outs.extend(names)
                return self

            def outputSingle(self):
                return sd.output(self._phs, self._outs)[self._outs[0]]

            def exec(self):
                return sd.output(self._phs, self._outs)

        return _B()

    # -- training --------------------------------------------------------
    def setLossVariables(self, *names):
        self._loss_names = [n.name if isinstance(n, SDVariable) else n
                            for n in names]

    def convertConstantsToVariables(self, *names):
        """≡ SameDiff.convertToVariables — promote imported constants to
        trainable variables (the imported-model fine-tune path)."""
        for n in names:
            n = n.name if isinstance(n, SDVariable) else n
            node = self._nodes[n]
            if node.vtype == VariableType.CONSTANT:
                node.vtype = VariableType.VARIABLE
        self._tx = None  # optimizer state must re-init over the new set
        return self

    def convertVariablesToConstants(self, *names):
        """≡ SameDiff.convertToConstants — freeze variables."""
        for n in names:
            n = n.name if isinstance(n, SDVariable) else n
            node = self._nodes[n]
            if node.vtype == VariableType.VARIABLE:
                node.vtype = VariableType.CONSTANT
        self._tx = None
        return self

    def setTrainingConfig(self, tc):
        self._training_config = tc
        self._tx = None

    # -- control flow (≡ SameDiff control-flow ops: If/While/For). The JAX
    # package lowers them to lax.cond / while_loop / scan / fori_loop; here
    # they are Python control flow over the tensors, every predicate a
    # counted host read ---------------------------------------------------
    def ifCond(self, name, pred, inputs, true_fn, false_fn):
        """pred: scalar SDVariable; true_fn/false_fn: plain torch functions
        taking the input tensors and returning one tensor. Only the taken
        branch runs."""
        inputs = [self._lift(v) for v in inputs]

        def f(p, *arrs):
            return (true_fn(*arrs) if host_bool(p, "samediff.if")
                    else false_fn(*arrs))

        return self._op_named(name, "if", f, self._lift(pred), *inputs)

    def whileLoop(self, name, loop_vars, cond_fn, body_fn):
        """loop_vars: list of SDVariables (initial state). cond_fn/body_fn:
        torch functions over the state tensors; body returns the new state
        tuple. Returns one SDVariable per state slot (final values)."""
        loop_vars = [self._lift(v) for v in loop_vars]
        n = len(loop_vars)

        def f(*arrs):
            vs = tuple(arrs)
            while host_bool(cond_fn(*vs), "samediff.while"):
                vs = tuple(body_fn(*vs))
            return vs

        tup = self._op_named(f"{name}/state", "while", f, *loop_vars)
        return [self._op_named(f"{name}/out{i}", "tuple_get",
                               (lambda i_: lambda t: t[i_])(i), tup)
                for i in range(n)]

    def scanLoop(self, name, init, xs, body_fn):
        """lax.scan's surface: body_fn(carry, x) -> (carry, y) over the
        leading axis of xs. Returns (final_carry, stacked_ys)
        SDVariables."""
        init = self._lift(init)
        xs = self._lift(xs)

        def f(c0, xs_arr):
            return scan(body_fn, c0, xs_arr)

        tup = self._op_named(f"{name}/state", "scan", f, init, xs)
        carry = self._op_named(f"{name}/carry", "tuple_get",
                               lambda t: t[0], tup)
        ys = self._op_named(f"{name}/ys", "tuple_get", lambda t: t[1], tup)
        return carry, ys

    def forLoop(self, name, n_iters, loop_vars, body_fn):
        """Fixed-trip-count loop: body_fn(i, *state) -> new state, with i
        an int32 scalar tensor on the device."""
        loop_vars = [self._lift(v) for v in loop_vars]
        n = len(loop_vars)

        def f(*arrs):
            vs = tuple(arrs)
            for i in range(int(n_iters)):
                vs = tuple(body_fn(torch.tensor(i, dtype=torch.int32,
                                                device=arrs[0].device),
                                   *vs))
            return vs

        tup = self._op_named(f"{name}/state", "for", f, *loop_vars)
        return [self._op_named(f"{name}/out{i}", "tuple_get",
                               (lambda i_: lambda t: t[i_])(i), tup)
                for i in range(n)]

    # -- SERIALIZABLE control flow (≡ the reference FlatBuffers form:
    # If/While bodies persist as nested sub-graphs). Branch/body logic is
    # expressed as SameDiff GRAPHS whose placeholders are fed by this
    # graph's tensors; the sub-graphs travel inline in the node's params.
    # The plain-callable forms above stay for ad-hoc use (documented
    # non-serializable). -------------------------------------------------
    def _graph_params(self, sub):
        from deeplearning4j_tpu_torch.autodiff.graph_serde import graph_doc
        bad = [n for n, v in sub._nodes.items()
               if v.vtype == VariableType.ARRAY
               and not getattr(v, "serializable", False)]
        if bad:
            raise ValueError(
                f"control-flow sub-graph contains non-serializable ops "
                f"{bad[:5]} — sub-graphs must use registry ops only "
                "(the point of the *Graph control-flow forms)")
        return graph_doc(sub, inline_values=True)

    def ifCondGraph(self, name, pred, inputs, input_names, true_sd,
                    false_sd, output):
        """If with SameDiff sub-graph branches: `inputs` (this graph's
        SDVariables) feed both branches' placeholders `input_names`; each
        branch computes node `output`."""
        inputs = [self._lift(v) for v in inputs]
        return self._op_named(name, "samediff.if", None, self._lift(pred),
                              *inputs, params={
                                  "true_graph": self._graph_params(true_sd),
                                  "false_graph":
                                      self._graph_params(false_sd),
                                  "input_names": list(input_names),
                                  "output": output})

    def whileLoopGraph(self, name, loop_vars, state_names, cond_sd,
                       cond_out, body_sd, body_outs):
        """While with sub-graph condition/body: state slots `state_names`
        feed both graphs' placeholders; cond computes the scalar
        `cond_out`, body computes one node per slot (`body_outs`).
        Returns one SDVariable per final state slot."""
        loop_vars = [self._lift(v) for v in loop_vars]
        tup = self._op_named(f"{name}/state", "samediff.while", None,
                             *loop_vars, params={
                                 "cond_graph": self._graph_params(cond_sd),
                                 "body_graph": self._graph_params(body_sd),
                                 "state_names": list(state_names),
                                 "cond_out": cond_out,
                                 "body_outs": list(body_outs)})
        return [self._op_named(f"{name}/out{i}", "tuple_get", None, tup,
                               params={"i": i})
                for i in range(len(loop_vars))]

    def scanLoopGraph(self, name, init, xs, body_sd, carry_name, x_name,
                      carry_out, y_out):
        """Scan with a sub-graph body mapping placeholders
        (carry_name, x_name) to nodes (carry_out, y_out). Returns
        (final_carry, stacked_ys)."""
        init, xs = self._lift(init), self._lift(xs)
        tup = self._op_named(f"{name}/state", "samediff.scan", None, init,
                             xs, params={
                                 "body_graph": self._graph_params(body_sd),
                                 "carry_name": carry_name,
                                 "x_name": x_name,
                                 "carry_out": carry_out, "y_out": y_out})
        carry = self._op_named(f"{name}/carry", "tuple_get", None, tup,
                               params={"i": 0})
        ys = self._op_named(f"{name}/ys", "tuple_get", None, tup,
                            params={"i": 1})
        return carry, ys

    def forLoopGraph(self, name, n_iters, loop_vars, state_names, body_sd,
                     body_outs, index_name="i"):
        """For with a sub-graph body; the iteration index rides in as
        placeholder `index_name` (int32 scalar)."""
        loop_vars = [self._lift(v) for v in loop_vars]
        tup = self._op_named(f"{name}/state", "samediff.for", None,
                             *loop_vars, params={
                                 "body_graph": self._graph_params(body_sd),
                                 "n_iters": int(n_iters),
                                 "index_name": index_name,
                                 "state_names": list(state_names),
                                 "body_outs": list(body_outs)})
        return [self._op_named(f"{name}/out{i}", "tuple_get", None, tup,
                               params={"i": i})
                for i in range(len(loop_vars))]

    def _total_loss(self, values, placeholders):
        runner = self._make_exec(tuple(self._loss_names))
        outs = runner(values, placeholders)
        total = 0.0
        for n in self._loss_names:
            total = total + torch.sum(outs[n])
        tc = self._training_config
        if tc is not None and (tc.l1 or tc.l2):
            for v in self.variables():
                arr = values[v.name]
                if tc.l1:
                    total = total + tc.l1 * torch.sum(torch.abs(arr))
                if tc.l2:
                    total = total + 0.5 * tc.l2 * torch.sum(arr * arr)
        return total

    def _var_names(self):
        return [v.name for v in self.variables()]

    def _ensure_optimizer(self):
        if self._tx is None:
            tc = self._training_config
            if tc is None or tc.updater is None:
                raise ValueError("setTrainingConfig with an updater before fit()")
            self._tx = (build_optimizer(tc.updater)
                        if isinstance(tc.updater, Updater) else tc.updater)
            if not isinstance(self._tx, Optimizer):
                raise TypeError(f"updater {tc.updater!r} is neither an "
                                "Updater config nor an nn.updaters "
                                "optimizer")
            self._opt_state = self._tx.init(
                {_NODE: {n: self._values[n] for n in self._var_names()}})
            pending = self._pending_opt_leaves
            if pending is not None:
                # a save(save_updater=True) artifact: copy the persisted
                # optimizer-state leaves into the fresh structure
                fresh = tensor_leaves(self._opt_state)
                if len(fresh) != len(pending):
                    raise ValueError(
                        f"updater state in artifact has {len(pending)} "
                        f"leaves but this optimizer has {len(fresh)} — was "
                        "the training config changed after load?")
                for dst, src in zip(fresh, pending):
                    dst.copy_(src.to(dst.device, dst.dtype))
                self._pending_opt_leaves = None

    def _loss_and_grads(self, var_names, placeholders):
        """The total loss and its gradient with respect to each of
        `var_names` (zeros where the loss does not reach a variable)."""
        leaves = {n: self._values[n].detach().requires_grad_(True)
                  for n in var_names}
        consts = {k: v for k, v in self._values.items() if k not in leaves}
        with torch.enable_grad():
            loss = self._total_loss({**consts, **leaves}, placeholders)
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
        return loss.detach(), {
            n: torch.zeros_like(leaves[n]) if g is None else g
            for n, g in zip(leaves, grads)}

    def fit(self, dataset=None, labels=None, placeholders=None, epochs=1):
        """fit(DataSet) using TrainingConfig mappings, fit(features,
        labels) arrays through the same mappings, fit(placeholders=dict)
        feeding everything directly, or — ≡ SameDiff.fit(DataSetIterator,
        numEpochs) — fit(iterator, epochs=N): trains every batch of the
        iterator per epoch and returns the per-batch loss history (a
        plain list, ≡ the reference's History losscurve)."""
        if hasattr(dataset, "hasNext") and hasattr(dataset, "next"):
            history = []
            for _ in range(int(epochs)):
                dataset.reset()
                while dataset.hasNext():
                    history.append(self.fit(dataset.next()))
            return history
        self._ensure_optimizer()
        tc = self._training_config
        if isinstance(labels, dict):
            # fit(dataset, placeholders_dict) callers from the old
            # (dataset, placeholders) signature: a dict is never a labels
            # array — route it to placeholders.
            if placeholders is not None:
                raise TypeError(
                    "fit(): got a dict for `labels` AND `placeholders`; "
                    "pass placeholders once, as placeholders=")
            labels, placeholders = None, labels
        if labels is not None:
            from deeplearning4j_tpu_torch.datasets.dataset import DataSet
            dataset = DataSet(dataset, labels)
        if placeholders is None:
            from deeplearning4j_tpu_torch.datasets.dataset import (
                DataSet, MultiDataSet)
            if isinstance(dataset, DataSet):
                feats, labs = [dataset.features], [dataset.labels]
            elif isinstance(dataset, MultiDataSet):
                feats, labs = dataset.features, dataset.labels
            else:
                raise TypeError(f"Cannot fit on {type(dataset)}")
            placeholders = {}
            for name, arr in zip(tc.dataSetFeatureMapping, feats):
                placeholders[name] = arr
            for name, arr in zip(tc.dataSetLabelMapping, labs):
                placeholders[name] = arr
        phs = self._placeholders(placeholders)
        names = self._var_names()
        loss, grads = self._loss_and_grads(names, phs)
        params = {_NODE: {n: self._values[n] for n in names}}
        with torch.no_grad():
            updates, self._opt_state = self._tx.update(
                {_NODE: grads}, self._opt_state, params)
            new = apply_updates(params, updates)[_NODE]
        self._values.update(new)
        return float(loss)

    def calculateGradients(self, placeholders, *wrt):
        """≡ SameDiff.calculateGradients — gradients of the loss wrt the
        given variable names."""
        if not self._loss_names:
            raise ValueError("setLossVariables(...) first")
        wrt = [w.name if isinstance(w, SDVariable) else w for w in wrt]
        _, grads = self._loss_and_grads(self._var_names(),
                                        self._placeholders(placeholders))
        return {n: NDArray(grads[n]) for n in wrt}

    def grad(self, name):
        raise RuntimeError("Use calculateGradients(placeholders, names...)")

    # -- persistence (≡ SameDiff.save/load: the WHOLE graph — ops, shapes,
    # values — restores with no defining source; see graph_serde) --------
    def save(self, path, save_updater=False, values_only=False):
        """Write the self-contained zip artifact (samediff.json +
        values.npz), the JAX package's format. save_updater=True (≡
        SameDiff.save's saveUpdaterState) also persists the
        optimizer-state leaves, so a loaded graph's fit() resumes
        mid-momentum.

        values_only=True writes just the values.npz leg — the persistence
        path for graphs containing non-serializable nodes (ad-hoc
        callables): re-build the graph in code and load_values()."""
        from deeplearning4j_tpu_torch.autodiff.graph_serde import \
            save_samediff
        save_samediff(self, path, values_only=values_only,
                      save_updater=save_updater)

    @staticmethod
    def load(path, device=None):
        """Rebuild the full graph from a save() artifact (either
        package's) on `device` (the card unless "cpu") — no defining
        Python needed (op fns come from the graph_serde registry)."""
        from deeplearning4j_tpu_torch.autodiff.graph_serde import \
            load_samediff
        return load_samediff(path, device=device)

    def load_values(self, path):
        """Load ONLY the values from a save() artifact into THIS graph
        (also reads values_only=True artifacts). Artifacts written with
        save_updater=True carry `__updater__N` optimizer-state leaves;
        those are restored too — copied into a live optimizer, or kept in
        `_pending_opt_leaves` for the first fit(). The JAX package's
        legacy pickle checkpoints are not read."""
        import io
        import zipfile

        if not zipfile.is_zipfile(path):
            raise ValueError(f"{path!r} is not a samediff zip artifact")
        with zipfile.ZipFile(path) as zf:
            vals = np.load(io.BytesIO(zf.read("values.npz")))
            values = {k: vals[k] for k in vals.files}
        upd_prefix = "__updater__"
        upd_keys = sorted((k for k in values if k.startswith(upd_prefix)),
                          key=lambda k: int(k[len(upd_prefix):]))
        live = None
        if upd_keys and self._opt_state is not None:
            # validate BEFORE mutating anything: a mismatch must leave
            # the graph exactly as it was (values, optimizer)
            live = tensor_leaves(self._opt_state)
            if len(live) != len(upd_keys):
                raise ValueError(
                    f"updater state in artifact has {len(upd_keys)} "
                    f"leaves but this optimizer has {len(live)} — was "
                    "the training config changed since the checkpoint?")
        for k, v in values.items():
            if k in self._values:
                self._values[k] = torch.as_tensor(v, device=self._device)
        if upd_keys:
            leaves = [torch.as_tensor(values[k], device=self._device)
                      for k in upd_keys]
            if live is not None:
                for dst, src in zip(live, leaves):
                    dst.copy_(src.to(dst.dtype))
            else:
                self._pending_opt_leaves = leaves
        return self


def scan(body_fn, c0, xs):
    """lax.scan over the leading axis of xs: (final carry, stacked ys)."""
    c, ys = c0, []
    for i in range(xs.shape[0]):
        c, y = body_fn(c, xs[i])
        ys.append(y)
    return c, torch.stack(ys) if ys else xs[:0]
