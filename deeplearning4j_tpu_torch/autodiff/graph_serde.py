"""SameDiff FULL-GRAPH serialization: the port of
`deeplearning4j_tpu/autodiff/graph_serde.py` (≡ nd4j-api ::
SameDiff.save/load, which persists the whole graph — ops, shapes, values —
with no defining source required).

Every graph op is (opname, params) where `params` is a plain-JSON dict,
and this module's OP_BUILDERS registry maps opname -> builder(**params)
-> a torch function. A graph serializes as a zip of

  samediff.json   — node table: {name, vtype, shape, opname, params,
                    inputs}, plus loss names / name counter / training
                    config (updater via util.serde's @class encoding)
  values.npz      — every VARIABLE/CONSTANT array, keyed by node name

— the JAX package's format, so either package loads the other's archive:
the op names and params are the same, and each package's builders compute
the same function (the port's with torch on its device). Custom user ops
register a builder via registerSerializableOp(opname, builder) in both the
saving and the loading process.

Control flow serializes through the *Graph forms (SameDiff.ifCondGraph /
whileLoopGraph / scanLoopGraph / forLoopGraph): branch/body logic is a
SameDiff SUB-graph whose doc travels inline in the node's params. The
plain-callable forms (ifCond/whileLoop/...) capture arbitrary user Python
and stay non-serializable; save() raises naming them.
"""
from __future__ import annotations

import io
import json
import math
import zipfile

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.autodiff.samediff import (SameDiff, SDVariable,
                                                        TrainingConfig,
                                                        VariableType,
                                                        host_bool, scan)

GRAPH_JSON = "samediff.json"
VALUES_NPZ = "values.npz"
FORMAT_VERSION = 1

OP_BUILDERS = {}


def op_builder(opname):
    def deco(fn):
        OP_BUILDERS[opname] = fn
        return fn
    return deco


def registerSerializableOp(opname, builder):
    """Register a custom op builder: builder(**params) -> f(*input_tensors).
    Must run in the loading process too (module-level registration is the
    usual place) — params must be plain JSON values."""
    OP_BUILDERS[str(opname)] = builder


def build_fn(opname, params):
    b = OP_BUILDERS.get(opname)
    if b is None and opname.split(".")[0] in ("onnx", "tf"):
        # importer builders register at module import; pull the provider
        # in on demand (covers nested control-flow sub-graphs too)
        import importlib
        importlib.import_module(
            "deeplearning4j_tpu_torch.autodiff."
            + {"onnx": "onnx_import", "tf": "tf_import"}[
                opname.split(".")[0]])
        b = OP_BUILDERS.get(opname)
    if b is None:
        raise KeyError(
            f"no builder registered for op {opname!r} — "
            "registerSerializableOp(opname, builder) first")
    return b(**(params or {}))


def _t(v):
    """JSON round-trips tuples as lists."""
    return tuple(v) if isinstance(v, (list, tuple)) else v


def _dims(axis, ndim):
    """A reduction's axis param as torch's dim: every axis for None."""
    if axis is None:
        return tuple(range(ndim))
    return tuple(axis) if isinstance(axis, (list, tuple)) else int(axis)


# -- NHWC windows with TF/XLA padding ---------------------------------------
def same_pads(size, k, s, d=1):
    """(lo, hi) padding of one spatial dim under "SAME": XLA's and TF's
    rule, the extra row at the end."""
    eff = (k - 1) * d + 1
    out = -(-size // s)
    total = max((out - 1) * s + eff - size, 0)
    return total // 2, total - total // 2


def _pad_pairs(padding, x, k, s, d=(1, 1)):
    """[(lo, hi), (lo, hi)] for H and W of NHWC `x`."""
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return [(0, 0), (0, 0)]
        return [same_pads(x.shape[1 + i], k[i], s[i], d[i]) for i in (0, 1)]
    return [tuple(int(v) for v in p) for p in padding]


def conv2d_nhwc(x, w, stride, padding, dilation=(1, 1), groups=1):
    """lax.conv_general_dilated over NHWC/HWIO, with XLA's padding."""
    (ph0, ph1), (pw0, pw1) = _pad_pairs(padding, x, w.shape[:2], stride,
                                        dilation)
    xc = F.pad(x.permute(0, 3, 1, 2), (pw0, pw1, ph0, ph1))
    y = F.conv2d(xc, w.to(x.dtype).permute(3, 2, 0, 1), stride=tuple(stride),
                 dilation=tuple(dilation), groups=groups)
    return y.permute(0, 2, 3, 1)


def _window(x, k, s, padding, value):
    """NHWC `x` padded with `value` as XLA's reduce_window pads it, as
    NCHW for torch's pools."""
    (ph0, ph1), (pw0, pw1) = _pad_pairs(padding, x, k, s)
    return F.pad(x.permute(0, 3, 1, 2), (pw0, pw1, ph0, ph1), value=value)


def maxpool_nhwc(x, k, s, padding):
    y = F.max_pool2d(_window(x, k, s, padding, -math.inf), tuple(k),
                     tuple(s))
    return y.permute(0, 2, 3, 1)


def avgpool_nhwc(x, k, s, padding):
    """Window sums over the true window population (padding not
    counted), as the JAX package divides."""
    summed = F.avg_pool2d(_window(x, k, s, padding, 0.0), tuple(k),
                          tuple(s), divisor_override=1)
    counts = F.avg_pool2d(_window(torch.ones_like(x[:1, ..., :1]), k, s,
                                  padding, 0.0), tuple(k), tuple(s),
                          divisor_override=1)
    return (summed / counts).permute(0, 2, 3, 1)


# -- elementwise / binary -------------------------------------------------
def _gelu(a):
    # jax.nn.gelu's default: the tanh approximation
    return F.gelu(a, approximate="tanh")


for _name, _fn in [
        ("add", torch.add), ("sub", torch.sub), ("mul", torch.mul),
        ("div", torch.div), ("mmul", torch.matmul), ("neg", torch.neg),
        ("exp", torch.exp), ("log", torch.log), ("sqrt", torch.sqrt),
        ("square", torch.square), ("abs", torch.abs), ("sin", torch.sin),
        ("cos", torch.cos), ("tanh", torch.tanh), ("sigmoid", torch.sigmoid),
        ("relu", torch.relu), ("gelu", _gelu),
        ("dropout_id", lambda a: a),
        ("cholesky", torch.linalg.cholesky),
        ("qr", lambda a: torch.linalg.qr(a)[0]),
        ("svd", torch.linalg.svdvals),
        ("solve", torch.linalg.solve)]:
    OP_BUILDERS[_name] = (lambda f: lambda: f)(_fn)


@op_builder("pow")
def _b_pow(p):
    return lambda a: torch.pow(a, p)


@op_builder("transpose")
def _b_transpose(axes=None):
    def f(a):
        ax = _t(axes) if axes is not None else tuple(range(a.ndim))[::-1]
        return a.permute(*ax)
    return f


@op_builder("reshape")
def _b_reshape(shape):
    return lambda a: torch.reshape(a, _t(shape))


def _std(a, dim, keepdim):
    return torch.std(a, dim=dim, keepdim=keepdim, correction=0)


def _reduce_builder(fn):
    def build(axis=None, keepdims=False):
        return lambda a: fn(a, dim=_dims(axis, a.ndim), keepdim=keepdims)
    return build


for _name, _fn in [("sum", torch.sum), ("mean", torch.mean),
                   ("max", torch.amax), ("min", torch.amin), ("std", _std)]:
    OP_BUILDERS[_name] = _reduce_builder(_fn)


@op_builder("argmax")
def _b_argmax(dim=-1):
    # int32 indices, as jnp.argmax gives them
    return lambda a: torch.argmax(a, dim=dim).to(torch.int32)


@op_builder("clip")
def _b_clip(lo, hi):
    return lambda a: torch.clamp(a, min=lo, max=hi)


@op_builder("softmax")
def _b_softmax(axis=-1):
    return lambda a: torch.softmax(a, dim=axis)


@op_builder("log_softmax")
def _b_log_softmax(axis=-1):
    return lambda a: torch.log_softmax(a, dim=axis)


@op_builder("layer_norm")
def _b_layer_norm(eps=1e-5, axis=-1):
    def f(a, g, *b):
        mu = torch.mean(a, dim=axis, keepdim=True)
        var = torch.var(a, dim=axis, keepdim=True, correction=0)
        y = (a - mu) * torch.rsqrt(var + eps) * g
        return y + b[0] if b else y
    return f


@op_builder("batch_norm")
def _b_batch_norm(eps=1e-5):
    def f(a, m, v, g, b):
        return (a - m) * torch.rsqrt(v + eps) * g + b
    return f


# -- losses ---------------------------------------------------------------
@op_builder("softmax_xent")
def _b_softmax_xent():
    def f(y, z):
        return -torch.mean(torch.sum(y * torch.log_softmax(z, -1), -1))
    return f


@op_builder("sigmoid_xent")
def _b_sigmoid_xent():
    def f(y, z):
        per = torch.clamp(z, min=0) - z * y + torch.log1p(
            torch.exp(-torch.abs(z)))
        return torch.mean(torch.sum(per, -1))
    return f


@op_builder("mse")
def _b_mse():
    def f(y, p):
        return torch.mean((y - p) ** 2)
    return f


@op_builder("l2")
def _b_l2():
    return lambda a: 0.5 * torch.sum(a * a)


# -- cnn ------------------------------------------------------------------
@op_builder("conv2d")
def _b_conv2d(stride=(1, 1), padding="SAME", dilation=(1, 1)):
    s, d = _t(stride), _t(dilation)

    def f(a, w, *b):
        y = conv2d_nhwc(a, w, s, padding, d)
        return y + b[0] if b else y
    return f


@op_builder("maxpool2d")
def _b_maxpool2d(kernel=(2, 2), stride=(2, 2), padding="VALID"):
    return lambda a: maxpool_nhwc(a, _t(kernel), _t(stride), padding)


@op_builder("avgpool2d")
def _b_avgpool2d(kernel=(2, 2), stride=(2, 2), padding="VALID"):
    return lambda a: avgpool_nhwc(a, _t(kernel), _t(stride), padding)


@op_builder("upsampling2d")
def _b_upsampling2d(scale=2):
    s = int(scale)
    return lambda a: a.repeat_interleave(s, dim=1).repeat_interleave(s,
                                                                     dim=2)


# -- random (seed is a param: the draw stays reproducible across save/load;
# drawn on the CPU, so it is the same on every device) -----------------------
def _gen(seed):
    return torch.Generator().manual_seed(int(seed))


@op_builder("random_normal")
def _b_random_normal(seed, shape, mean=0.0, stddev=1.0):
    return lambda: mean + stddev * torch.randn(_t(shape),
                                               generator=_gen(seed))


@op_builder("random_uniform")
def _b_random_uniform(seed, shape, lo=0.0, hi=1.0):
    return lambda: lo + (hi - lo) * torch.rand(_t(shape),
                                               generator=_gen(seed))


@op_builder("random_bernoulli")
def _b_random_bernoulli(seed, shape, p=0.5):
    return lambda: (torch.rand(_t(shape), generator=_gen(seed)) < p).to(
        torch.float32)


# -- nested graph docs (serializable control flow rides on these) ---------
def graph_doc(sd, inline_values=False):
    """The JSON node table for a graph. inline_values=True embeds every
    VARIABLE/CONSTANT array as base64 (for SUB-graphs nested inside a
    control-flow node's params — the top-level artifact keeps values in
    the npz leg instead)."""
    import base64

    nodes = []
    for name, v in sd._nodes.items():
        nodes.append({
            "name": name,
            "vtype": v.vtype,
            "shape": list(v.shape) if v.shape is not None else None,
            "opname": getattr(v, "opname", None),
            "params": getattr(v, "params", None),
            "inputs": list(v.inputs),
        })
    doc = {"counter": sd._counter, "loss_names": list(sd._loss_names),
           "nodes": nodes}
    if inline_values:
        vals = {}
        for k, arr in sd._values.items():
            a = _numpy(arr)
            # dtype.str keeps byte order ('<f4'): the inline leg must
            # stay endian-safe like the npz leg
            vals[k] = {"dtype": a.dtype.str, "shape": list(a.shape),
                       "b64": base64.b64encode(a.tobytes()).decode()}
        doc["values"] = vals
    return doc


def _numpy(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def graph_from_doc(doc, device=None):
    """Rebuild a SameDiff on `device` from a graph_doc (values from the
    inline base64 leg when present)."""
    import base64

    sd = SameDiff(device=device)
    sd._counter = int(doc.get("counter", 0))
    sd._loss_names = list(doc.get("loss_names", []))
    for nd in doc["nodes"]:
        name, vtype = nd["name"], nd["vtype"]
        shape = tuple(nd["shape"]) if nd["shape"] is not None else None
        if vtype == VariableType.ARRAY:
            fn = build_fn(nd["opname"], nd.get("params"))
            v = SDVariable(sd, name, vtype, shape, fn, nd["inputs"])
            v.opname = nd["opname"]
            v.params = nd.get("params")
            v.serializable = True
        else:
            v = SDVariable(sd, name, vtype, shape)
        sd._nodes[name] = v
    for k, spec in (doc.get("values") or {}).items():
        arr = np.frombuffer(base64.b64decode(spec["b64"]),
                            np.dtype(spec["dtype"])).reshape(spec["shape"])
        sd._values[k] = torch.as_tensor(arr.copy(), device=sd._device)
    return sd


def _subgraph_runner(doc, out_names):
    """A nested graph doc as fn(input_dict) -> {out: tensor}. The
    sub-graph's values are built on the CPU and moved, once per device,
    to the device of the tensors that feed it."""
    sub = graph_from_doc(doc, device="cpu")
    run = sub._make_exec(tuple(out_names))
    by_device = {}

    def call(placeholders):
        dev = next((t.device for t in placeholders.values()
                    if torch.is_tensor(t)), torch.device("cpu"))
        values = by_device.get(dev)
        if values is None:
            values = by_device[dev] = {k: v.to(dev)
                                       for k, v in sub._values.items()}
        sub._device = dev
        return run(values, placeholders)
    return call


# -- serializable control flow: the *Graph control-flow API on SameDiff
# passes its branch/body GRAPHS here as inline docs -------------------------
@op_builder("samediff.if")
def _b_if(true_graph, false_graph, input_names, output):
    t = _subgraph_runner(true_graph, [output])
    f = _subgraph_runner(false_graph, [output])

    def fn(pred, *arrs):
        env = dict(zip(input_names, arrs))
        branch = t if host_bool(pred, "samediff.if") else f
        return branch(env)[output]
    return fn


@op_builder("samediff.while")
def _b_while(cond_graph, body_graph, state_names, cond_out, body_outs):
    c = _subgraph_runner(cond_graph, [cond_out])
    b = _subgraph_runner(body_graph, list(body_outs))

    def fn(*arrs):
        vs = tuple(arrs)
        while host_bool(c(dict(zip(state_names, vs)))[cond_out],
                         "samediff.while"):
            outs = b(dict(zip(state_names, vs)))
            vs = tuple(outs[o] for o in body_outs)
        return vs
    return fn


@op_builder("samediff.scan")
def _b_scan(body_graph, carry_name, x_name, carry_out, y_out):
    b = _subgraph_runner(body_graph, [carry_out, y_out])

    def fn(c0, xs):
        def body(c, x):
            outs = b({carry_name: c, x_name: x})
            return outs[carry_out], outs[y_out]
        return scan(body, c0, xs)
    return fn


@op_builder("samediff.for")
def _b_for(body_graph, n_iters, index_name, state_names, body_outs):
    b = _subgraph_runner(body_graph, list(body_outs))

    def fn(*arrs):
        vs = tuple(arrs)
        for i in range(int(n_iters)):
            env = dict(zip(state_names, vs))
            env[index_name] = torch.tensor(i, dtype=torch.int32,
                                           device=arrs[0].device)
            outs = b(env)
            vs = tuple(outs[o] for o in body_outs)
        return vs
    return fn


@op_builder("tuple_get")
def _b_tuple_get(i):
    return lambda t: t[i]


@op_builder("slice_axis")
def _b_slice_axis(axis, start, size):
    """Shared slice-by-axis (TF SplitV lowers onto this)."""
    return lambda x, *_r: torch.narrow(x, axis, start, size)


# -- persistence ----------------------------------------------------------
def _opt_leaves(sd):
    """Optimizer-state leaves in optax's tree_leaves order — live state if
    the optimizer ran, else the still-pending leaves a load() carried (so
    a load -> re-save repack keeps the momenta)."""
    if sd._opt_state is not None:
        from deeplearning4j_tpu_torch.runtime.executables import \
            tensor_leaves
        return tensor_leaves(sd._opt_state)
    return sd._pending_opt_leaves


def save_samediff(sd, path, values_only=False, save_updater=False):
    """Write the zip artifact. Raises on non-serializable nodes (control
    flow, unregistered custom fns) with the node list in the message;
    values_only=True skips the graph leg entirely (checkpointing for
    graphs with such nodes — re-build in code, then load_values);
    save_updater=True (≡ the reference's saveUpdaterState flag) also
    persists the optimizer-state leaves so fit() resumes mid-momentum."""
    from deeplearning4j_tpu_torch.util.serde import encode

    if values_only:
        arrays = {k: _numpy(v) for k, v in sd._values.items()}
        if save_updater:
            for i, leaf in enumerate(_opt_leaves(sd) or []):
                arrays[f"__updater__{i}"] = _numpy(leaf)
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
            zf.writestr(VALUES_NPZ, buf.getvalue(), zipfile.ZIP_STORED)
        return

    bad = [(n, getattr(v, "opname", None)) for n, v in sd._nodes.items()
           if v.vtype == VariableType.ARRAY and not getattr(
               v, "serializable", False)]
    if bad:
        raise ValueError(
            "SameDiff.save: graph contains ops with no registered "
            f"builder: {bad[:8]}{'...' if len(bad) > 8 else ''} — "
            "ad-hoc callables (including the plain ifCond/whileLoop/"
            "scanLoop/forLoop forms) are not serializable. Options: "
            "rebuild control flow with the *Graph forms (ifCondGraph/"
            "whileLoopGraph/scanLoopGraph/forLoopGraph — sub-graphs "
            "serialize inline), registerSerializableOp(opname, builder) "
            "for custom ops (in both the saving and loading process), or "
            "checkpoint the weights alone with "
            "save(path, values_only=True)")

    tc = sd._training_config
    doc = {
        "format": FORMAT_VERSION,
        **graph_doc(sd),
        "training_config": None if tc is None else {
            "updater": encode(tc.updater) if tc.updater is not None else None,
            "l1": tc.l1, "l2": tc.l2,
            "dataSetFeatureMapping": list(tc.dataSetFeatureMapping),
            "dataSetLabelMapping": list(tc.dataSetLabelMapping),
        },
    }
    arrays = {k: _numpy(v) for k, v in sd._values.items()}
    if save_updater:
        leaves = _opt_leaves(sd)
        if leaves is not None:
            doc["updater_state_leaves"] = len(leaves)
            for i, leaf in enumerate(leaves):
                arrays[f"__updater__{i}"] = _numpy(leaf)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        # allow_nan=False: the artifact must stay strict RFC-8259 JSON
        zf.writestr(GRAPH_JSON, json.dumps(doc, indent=1, allow_nan=False))
        zf.writestr(VALUES_NPZ, buf.getvalue(), zipfile.ZIP_STORED)


def load_samediff(path, device=None):
    """Rebuild a SameDiff from the zip artifact (either package's) on
    `device` (the card unless "cpu"): nodes from the table (op fns from
    OP_BUILDERS), values from the npz."""
    from deeplearning4j_tpu_torch.util.serde import decode

    with zipfile.ZipFile(path) as zf:
        doc = json.loads(zf.read(GRAPH_JSON))
        vals = np.load(io.BytesIO(zf.read(VALUES_NPZ)))
        values = {k: vals[k] for k in vals.files}
    if doc.get("format", 0) > FORMAT_VERSION:
        raise ValueError(f"samediff artifact format {doc['format']} is "
                         f"newer than this build ({FORMAT_VERSION})")
    sd = graph_from_doc(doc, device=device)
    for name in sd._nodes:
        if name in values:
            sd._values[name] = torch.as_tensor(values[name],
                                               device=sd._device)
    n_opt = doc.get("updater_state_leaves")
    if n_opt:
        # consumed by _ensure_optimizer once the optimizer exists
        sd._pending_opt_leaves = [
            torch.as_tensor(values[f"__updater__{i}"], device=sd._device)
            for i in range(n_opt)]
    tc = doc.get("training_config")
    if tc is not None:
        sd._training_config = TrainingConfig(
            updater=decode(tc["updater"]) if tc["updater"] else None,
            l1=tc["l1"], l2=tc["l2"],
            dataSetFeatureMapping=tc["dataSetFeatureMapping"],
            dataSetLabelMapping=tc["dataSetLabelMapping"])
    return sd
