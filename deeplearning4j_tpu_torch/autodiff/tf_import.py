"""TF frozen-graph → SameDiff import: the port of
`deeplearning4j_tpu/autodiff/tf_import.py` (≡ nd4j-api ::
imports.graphmapper.tf.TFGraphMapper / SameDiff.importFrozenTF — the path
the reference's BERT examples use).

Maps a GraphDef (parsed by the port's dependency-free tfproto codec) onto
the SameDiff graph: Const → constants, Placeholder → placeholders,
compute ops → ARRAY nodes whose torch functions are the "tf." builders
below (registered in `graph_serde.OP_BUILDERS`, so an imported graph saves
and loads with no .pb). The op set covers the frozen-BERT surface:
MatMul/BatchMatMul, BiasAdd, layernorm fragments (Mean,
SquaredDifference, Rsqrt), erf-based GELU, Softmax, embedding GatherV2,
shape ops, elementwise arithmetic, and the CNN ops (Conv2D, depthwise,
pools, FusedBatchNorm, Pad).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.autodiff import tfproto
from deeplearning4j_tpu_torch.autodiff.graph_serde import (avgpool_nhwc,
                                                           conv2d_nhwc,
                                                           maxpool_nhwc,
                                                           op_builder)
from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff


def _clean_ref(ref):
    """Strip a ':0' output index; KEEP ':N' for N > 0 (multi-output ops —
    Split/SplitV/Unpack register one node per output under 'name:N');
    None for '^control' deps."""
    if ref.startswith("^"):
        return None
    base, _, idx = ref.partition(":")
    return base if idx in ("", "0") else ref


class UnsupportedTFOpError(ValueError):
    pass


def _axis_from(const_inputs, idx, default=None):
    v = const_inputs[idx]
    if v is None:
        return default
    a = np.asarray(v).reshape(-1)
    return int(a[0]) if a.size == 1 else tuple(int(x) for x in a)


_TORCH_DTYPES = {"float32": torch.float32, "float64": torch.float64,
                 "int32": torch.int32, "int64": torch.int64,
                 "bool": torch.bool, "uint8": torch.uint8,
                 "int16": torch.int16, "int8": torch.int8}

# each entry: a torch function over input tensors
_ELEMENTWISE = {
    "Add": torch.add, "AddV2": torch.add, "BiasAdd": lambda x, b: x + b,
    "Sub": torch.sub, "Mul": torch.mul, "RealDiv": torch.div,
    "Div": torch.div, "Maximum": torch.maximum, "Minimum": torch.minimum,
    "Pow": torch.pow, "SquaredDifference": lambda a, b: (a - b) ** 2,
    "Relu": torch.relu, "Relu6": lambda x: torch.clamp(x, 0, 6),
    "Elu": F.elu, "Selu": F.selu, "Tanh": torch.tanh,
    "Sigmoid": torch.sigmoid, "Erf": torch.erf, "Exp": torch.exp,
    "Log": torch.log, "Sqrt": torch.sqrt, "Rsqrt": torch.rsqrt,
    "Square": torch.square, "Abs": torch.abs, "Neg": torch.neg,
    "Identity": lambda x: x, "StopGradient": lambda x: x.detach(),
    "Floor": torch.floor, "Sign": torch.sign,
}

# -- serializable op builders ("tf." namespace in the graph_serde
# registry): imported nodes carry (opname, JSON params) so a frozen-graph
# import saved via SameDiff.save restores with no .pb and no user code --
for _opn, _fn in _ELEMENTWISE.items():
    op_builder("tf." + _opn.lower())((lambda f: lambda: f)(_fn))
op_builder("tf.softmax")(lambda: lambda x: torch.softmax(x, dim=-1))
op_builder("tf.softplus")(lambda: F.softplus)
op_builder("tf.addn")(lambda: lambda *xs: sum(xs[1:], xs[0]))


@op_builder("tf.leaky_relu")
def _b_leaky_relu(alpha=0.2):
    return lambda x: torch.where(x > 0, x, alpha * x)


@op_builder("tf.split_axis")
def _b_split_axis(axis, index, num):
    # equal split: the slice size comes from the input's shape (TF Split
    # carries only num_split)
    def f(x, *_r):
        ax = axis if axis >= 0 else x.ndim + axis
        if x.shape[ax] % num:
            raise ValueError(
                f"Split: dim {ax} ({x.shape[ax]}) not divisible by "
                f"num_split={num}")
        size = x.shape[ax] // num
        return torch.narrow(x, ax, index * size, size)
    return f


@op_builder("tf.unstack_idx")
def _b_unstack_idx(axis, index, num):
    def f(x):
        ax = axis if axis >= 0 else x.ndim + axis
        if x.shape[ax] != num:
            raise ValueError(
                f"Unpack: num={num} but dim {ax} is {x.shape[ax]}")
        return torch.select(x, ax, index)
    return f


op_builder("tf.shape")(lambda: lambda x: torch.tensor(
    tuple(x.shape), dtype=torch.int32, device=x.device))
op_builder("tf.rsqrt")(lambda: torch.rsqrt)


@op_builder("tf.matmul")
def _b_matmul(ta=False, tb=False):
    def mm(a, b):
        a = a.T if ta else a
        b = b.T if tb else b
        return a @ b
    return mm


@op_builder("tf.batch_matmul")
def _b_batch_matmul(ta=False, tb=False):
    def bmm(a, b):
        a = a.transpose(-1, -2) if ta else a
        b = b.transpose(-1, -2) if tb else b
        return a @ b
    return bmm


def _tf_reduce_builder(fn):
    def build(axis=None, keep=False):
        def f(x, _a):
            dim = (tuple(range(x.ndim)) if axis is None else
                   tuple(axis) if isinstance(axis, (list, tuple)) else axis)
            return fn(x, dim=dim, keepdim=keep)
        return f
    return build


for _opn, _fn in [("mean", torch.mean), ("sum", torch.sum),
                  ("max", torch.amax), ("min", torch.amin)]:
    op_builder("tf." + _opn)(_tf_reduce_builder(_fn))


@op_builder("tf.reshape")
def _b_reshape(shape):
    return lambda x, _s: torch.reshape(x, tuple(shape))


@op_builder("tf.transpose")
def _b_transpose(perm):
    return lambda x, _p: x.permute(*perm)


@op_builder("tf.expand_dims")
def _b_expand_dims(axis=0):
    return lambda x, _a: torch.unsqueeze(x, axis if axis >= 0
                                         else x.ndim + 1 + axis)


@op_builder("tf.squeeze")
def _b_squeeze(dims=None):
    def f(x):
        if not dims:
            return torch.squeeze(x)
        return torch.squeeze(x, tuple(d % x.ndim for d in dims))
    return f


@op_builder("tf.concat")
def _b_concat(axis=0):
    return lambda *xs: torch.cat(xs, axis)


@op_builder("tf.gather")
def _b_gather(axis=0):
    def f(p, i, *rest):
        ax = axis % p.ndim
        idx = i.to(torch.int64)
        out = torch.index_select(p, ax, idx.reshape(-1))
        return out.reshape(p.shape[:ax] + idx.shape + p.shape[ax + 1:])
    return f


@op_builder("tf.cast")
def _b_cast(dtype="float32"):
    dt = _TORCH_DTYPES[np.dtype(dtype).name]
    return lambda x: x.to(dt)


@op_builder("tf.stack")
def _b_stack(axis=0):
    return lambda *xs: torch.stack(xs, dim=axis)


@op_builder("tf.tile")
def _b_tile(reps):
    return lambda x, _r: torch.tile(x, tuple(reps))


def _slice_dim(x, d, s):
    """x sliced along dim d by python slice s (any step sign)."""
    idx = range(*s.indices(x.shape[d]))
    if idx.step > 0:
        return x[(slice(None),) * d
                 + (slice(idx.start, max(idx.stop, idx.start), idx.step),)]
    return torch.index_select(x, d, torch.tensor(list(idx),
                                                 dtype=torch.int64,
                                                 device=x.device))


@op_builder("tf.strided_slice")
def _b_strided_slice(sl):
    # JSON form: int = rank-reducing index; [lo, hi, step] = slice
    # (None encoded as JSON null)
    def f(x, *_r):
        out, d = x, 0
        for s in sl:
            if isinstance(s, int):
                out = torch.select(out, d, s)
            else:
                out = _slice_dim(out, d, slice(*s))
                d += 1
        return out
    return f


@op_builder("tf.one_hot")
def _b_one_hot(depth):
    # jax.nn.one_hot: float32 rows, all zero for an index out of range
    def f(i, *_r):
        ar = torch.arange(depth, device=i.device)
        return (i.to(torch.int64)[..., None] == ar).to(torch.float32)
    return f


@op_builder("tf.conv2d")
def _b_conv2d(strides, dil, padding, depthwise=False):
    st, dl = tuple(strides), tuple(dil)
    pd = padding if isinstance(padding, str) else [tuple(p)
                                                  for p in padding]

    def conv(x, w):
        # TF weights are HWIO; depthwise weights (H, W, C, M) run as a
        # grouped conv with C groups
        groups = 1
        if depthwise:
            h_, w_, cin, mult = w.shape
            w = w.reshape(h_, w_, 1, cin * mult)
            groups = cin
        return conv2d_nhwc(x, w, st, pd, dl, groups)
    return conv


@op_builder("tf.maxpool")
def _b_maxpool(ksize, strides, padding):
    # NHWC ksize/strides: (1, kh, kw, 1)
    k, s = tuple(ksize)[1:3], tuple(strides)[1:3]
    if tuple(ksize)[::3] != (1, 1) or tuple(strides)[::3] != (1, 1):
        raise ValueError("MaxPool over the batch or channel axis "
                         "unsupported")
    return lambda x: maxpool_nhwc(x, k, s, padding)


@op_builder("tf.avgpool")
def _b_avgpool(ksize, strides, padding):
    k, s = tuple(ksize)[1:3], tuple(strides)[1:3]
    if tuple(ksize)[::3] != (1, 1) or tuple(strides)[::3] != (1, 1):
        raise ValueError("AvgPool over the batch or channel axis "
                         "unsupported")
    return lambda x: avgpool_nhwc(x, k, s, padding)


@op_builder("tf.fused_batch_norm")
def _b_fused_batch_norm(eps=1e-4):
    def fbn(x, gamma, beta, mean, var):
        return (x - mean) * torch.rsqrt(var + eps) * gamma + beta
    return fbn


@op_builder("tf.pad")
def _b_pad(width, cval=0.0):
    # F.pad lists (lo, hi) pairs from the last dim backwards
    flat = [v for row in reversed(width) for v in row]
    return lambda x, *_r: F.pad(x, flat, value=cval)


class TFGraphMapper:
    @staticmethod
    def importGraph(path_or_bytes, sd=None, device=None):
        """A frozen GraphDef (a path or its bytes) into `sd`, or into a new
        SameDiff on `device` (the card unless "cpu")."""
        data = path_or_bytes
        if not isinstance(data, (bytes, bytearray)):
            with open(data, "rb") as f:
                data = f.read()
        nodes = tfproto.parse_graphdef(bytes(data))
        sd = sd or SameDiff.create(device=device)
        consts = {}     # name -> np value (for shape/axis arguments)

        for node in nodes:
            TFGraphMapper._map_node(sd, node, consts)
        return sd

    @staticmethod
    def _map_node(sd, node, consts):
        op, name = node.op, node.name
        in_refs = [r for r in (_clean_ref(i) for i in node.inputs)
                   if r is not None]

        def const_val(i):
            return consts.get(in_refs[i])

        if op == "Const":
            value = node.attrs.get("value")
            consts[name] = np.asarray(value)
            sd.constant(name, np.asarray(value))
            return
        if op in ("Identity", "StopGradient") and in_refs \
                and in_refs[0] in consts:
            # frozen graphs routinely wrap constants in Identity; keep the
            # alias visible so axis/shape arguments still resolve
            consts[name] = consts[in_refs[0]]
        if op == "Placeholder":
            shape = node.attrs.get("shape")
            dims = shape[1] if isinstance(shape, tuple) else []
            sd.placeHolder(name, *[d if d > 0 else None for d in dims])
            return

        ins = [sd.getVariable(r) for r in in_refs]

        if op in _ELEMENTWISE:
            sd._op_named(name, "tf." + op.lower(), None, *ins, params={})
        elif op == "MatMul":
            sd._op_named(name, "tf.matmul", None, *ins, params={
                "ta": bool(node.attrs.get("transpose_a", False)),
                "tb": bool(node.attrs.get("transpose_b", False))})
        elif op in ("BatchMatMul", "BatchMatMulV2"):
            sd._op_named(name, "tf.batch_matmul", None, *ins, params={
                "ta": bool(node.attrs.get("adj_x", False)),
                "tb": bool(node.attrs.get("adj_y", False))})
        elif op == "Softmax":
            sd._op_named(name, "tf.softmax", None, *ins, params={})
        elif op in ("Mean", "Sum", "Max", "Min"):
            if const_val(1) is None:
                raise UnsupportedTFOpError(
                    f"{name}: dynamic {op} axes unsupported (axis input "
                    "must trace to a Const)")
            axis = _axis_from([const_val(1)], 0)
            sd._op_named(name, "tf." + op.lower(), None, *ins, params={
                "axis": list(axis) if isinstance(axis, tuple) else axis,
                "keep": bool(node.attrs.get("keep_dims", False))})
        elif op == "Reshape":
            shp = const_val(1)
            if shp is None:
                raise UnsupportedTFOpError(
                    f"{name}: dynamic Reshape target shape unsupported")
            sd._op_named(name, "tf.reshape", None, *ins, params={
                "shape": [int(s) for s in np.asarray(shp).reshape(-1)]})
        elif op == "Transpose":
            if const_val(1) is None:
                raise UnsupportedTFOpError(
                    f"{name}: dynamic Transpose perm unsupported")
            sd._op_named(name, "tf.transpose", None, *ins, params={
                "perm": [int(p)
                         for p in np.asarray(const_val(1)).reshape(-1)]})
        elif op == "ExpandDims":
            sd._op_named(name, "tf.expand_dims", None, *ins, params={
                "axis": _axis_from([const_val(1)], 0, 0)})
        elif op == "Squeeze":
            dims = node.attrs.get("squeeze_dims") or None
            sd._op_named(name, "tf.squeeze", None, *ins, params={
                "dims": None if not dims else [int(d) for d in dims]})
        elif op in ("ConcatV2", "Concat"):
            # ConcatV2: axis is the LAST input; v1 Concat: the FIRST
            axis_idx = len(in_refs) - 1 if op == "ConcatV2" else 0
            av = const_val(axis_idx)
            if av is None:
                raise UnsupportedTFOpError(
                    f"{name}: dynamic Concat axis unsupported")
            data_ins = (ins[:-1] if op == "ConcatV2" else ins[1:])
            sd._op_named(name, "tf.concat", None, *data_ins, params={
                "axis": int(np.asarray(av).reshape(()))})
        elif op in ("GatherV2", "Gather"):
            axis = 0
            if op == "GatherV2" and len(ins) > 2:
                axis = _axis_from([const_val(2)], 0, 0)
            sd._op_named(name, "tf.gather", None, *ins,
                         params={"axis": axis})
        elif op == "Cast":
            dst = node.attrs.get("DstT")
            np_dt = tfproto._DTYPES.get(
                dst[1] if isinstance(dst, tuple) else dst, np.float32)
            sd._op_named(name, "tf.cast", None, *ins,
                         params={"dtype": np.dtype(np_dt).name})
        elif op == "Pack":
            sd._op_named(name, "tf.stack", None, *ins, params={
                "axis": int(node.attrs.get("axis", 0) or 0)})
        elif op == "Shape":
            sd._op_named(name, "tf.shape", None, *ins, params={})
        elif op == "Rsqrt":
            sd._op_named(name, "tf.rsqrt", None, *ins, params={})
        elif op == "Softplus":
            sd._op_named(name, "tf.softplus", None, *ins, params={})
        elif op == "LeakyRelu":
            a = node.attrs.get("alpha")
            sd._op_named(name, "tf.leaky_relu", None, *ins, params={
                "alpha": 0.2 if a is None else float(a)})
        elif op == "AddN":
            sd._op_named(name, "tf.addn", None, *ins, params={})
        elif op == "Split":
            # TF v1 Split: inputs [split_dim, value], attr num_split;
            # equal split — sizes resolve from the static shape at trace
            av = const_val(0)
            if av is None:
                raise UnsupportedTFOpError(
                    f"{name}: dynamic Split axis unsupported")
            axis = int(np.asarray(av).reshape(()))
            num = int(node.attrs.get("num_split", 0) or 0)
            if num <= 0:
                raise UnsupportedTFOpError(
                    f"{name}: Split needs the num_split attribute")
            for i in range(num):
                out_name = name if i == 0 else f"{name}:{i}"
                # the VALUE is input[1] (input[0] is the axis const)
                sd._op_named(out_name, "tf.split_axis", None, ins[1],
                             params={"axis": axis, "index": i,
                                     "num": num})
        elif op == "SplitV":
            # inputs [value, size_splits, axis]
            sizes = const_val(1)
            ax_v = const_val(2)
            if sizes is None or ax_v is None:
                raise UnsupportedTFOpError(
                    f"{name}: dynamic SplitV sizes/axis unsupported")
            axis = int(np.asarray(ax_v).reshape(()))
            sizes = [int(v) for v in np.asarray(sizes).reshape(-1)]
            if any(v < 0 for v in sizes):
                raise UnsupportedTFOpError(
                    f"{name}: SplitV -1 (inferred) size unsupported")
            off = 0
            for i, sz in enumerate(sizes):
                out_name = name if i == 0 else f"{name}:{i}"
                sd._op_named(out_name, "slice_axis", None, ins[0],
                             params={"axis": axis, "start": off,
                                     "size": sz})
                off += sz
        elif op == "Unpack":
            axis = int(node.attrs.get("axis", 0) or 0)
            num = int(node.attrs.get("num", 1) or 1)
            for i in range(num):
                out_name = name if i == 0 else f"{name}:{i}"
                sd._op_named(out_name, "tf.unstack_idx", None, *ins,
                             params={"axis": axis, "index": i,
                                     "num": num})
        elif op == "Tile":
            reps = const_val(1)
            sd._op_named(name, "tf.tile", None, *ins, params={
                "reps": [int(r) for r in np.asarray(reps).reshape(-1)]})
        elif op == "StridedSlice":
            b = const_val(1)
            e = const_val(2)
            s = const_val(3)
            if b is None or e is None or s is None:
                raise UnsupportedTFOpError(
                    f"{name}: dynamic StridedSlice unsupported")
            begin_mask = int(node.attrs.get("begin_mask", 0) or 0)
            end_mask = int(node.attrs.get("end_mask", 0) or 0)
            shrink = int(node.attrs.get("shrink_axis_mask", 0) or 0)
            if node.attrs.get("ellipsis_mask") or \
                    node.attrs.get("new_axis_mask"):
                raise UnsupportedTFOpError(
                    f"{name}: StridedSlice ellipsis/new_axis masks "
                    "unsupported")
            sl = []
            for d, (bi, ei, si) in enumerate(zip(
                    np.asarray(b).reshape(-1), np.asarray(e).reshape(-1),
                    np.asarray(s).reshape(-1))):
                if shrink & (1 << d):
                    sl.append(int(bi))          # rank-reducing index
                    continue
                lo = None if begin_mask & (1 << d) else int(bi)
                hi = None if end_mask & (1 << d) else int(ei)
                sl.append([lo, hi, int(si)])    # JSON slice triple
            sd._op_named(name, "tf.strided_slice", None, *ins,
                         params={"sl": sl})
        elif op == "OneHot":
            sd._op_named(name, "tf.one_hot", None, *ins, params={
                "depth": int(np.asarray(const_val(1)).reshape(()))})
        elif op in ("Conv2D", "DepthwiseConv2dNative"):
            fmt = node.attrs.get("data_format", "NHWC")
            if fmt != "NHWC":
                raise UnsupportedTFOpError(
                    f"{name}: data_format {fmt!r} unsupported (NHWC only)")
            strides = tuple(node.attrs.get("strides") or (1, 1, 1, 1))[1:3]
            dil = tuple(node.attrs.get("dilations") or (1, 1, 1, 1))[1:3]
            padding = node.attrs.get("padding", "VALID")
            if padding == "EXPLICIT":
                ep = node.attrs.get("explicit_paddings") or []
                if len(ep) != 8:
                    raise UnsupportedTFOpError(
                        f"{name}: padding=EXPLICIT needs 8 "
                        f"explicit_paddings values, got {len(ep)}")
                if any(int(v) for v in (*ep[:2], *ep[6:])):
                    raise UnsupportedTFOpError(
                        f"{name}: EXPLICIT padding on batch/channel "
                        f"dims unsupported ({list(ep)})")
                # NHWC order: take the H and W begin/end pairs
                padding = [(int(ep[2]), int(ep[3])),
                           (int(ep[4]), int(ep[5]))]
            sd._op_named(name, "tf.conv2d", None, *ins, params={
                "strides": [int(s) for s in strides],
                "dil": [int(d) for d in dil],
                "padding": padding if isinstance(padding, str)
                else [list(p) for p in padding],
                "depthwise": op == "DepthwiseConv2dNative"})
        elif op in ("MaxPool", "AvgPool"):
            fmt = node.attrs.get("data_format", "NHWC")
            if fmt != "NHWC":
                raise UnsupportedTFOpError(
                    f"{name}: data_format {fmt!r} unsupported (NHWC only)")
            ksize = tuple(node.attrs.get("ksize") or (1, 2, 2, 1))
            strides = tuple(node.attrs.get("strides") or ksize)
            padding = node.attrs.get("padding", "VALID")
            if padding not in ("SAME", "VALID"):
                raise UnsupportedTFOpError(
                    f"{name}: pool padding {padding!r} unsupported")
            params = {"ksize": [int(k) for k in ksize],
                      "strides": [int(s) for s in strides],
                      "padding": padding}
            sd._op_named(name, "tf.maxpool" if op == "MaxPool"
                         else "tf.avgpool", None, *ins, params=params)
        elif op in ("FusedBatchNorm", "FusedBatchNormV2",
                    "FusedBatchNormV3"):
            # frozen-graph inference form: inputs x, gamma, beta, mean, var
            if node.attrs.get("is_training"):
                raise UnsupportedTFOpError(
                    f"{name}: FusedBatchNorm with is_training=True "
                    f"unsupported (freeze the graph for inference)")
            # TF OpDef default is 1e-4 — a frozen graph stripped of
            # default-valued attrs must not import with a 10x epsilon
            eps = float(node.attrs.get("epsilon", 1e-4))
            fmt = node.attrs.get("data_format", "NHWC")
            if fmt != "NHWC":
                raise UnsupportedTFOpError(
                    f"{name}: data_format {fmt!r} unsupported (NHWC only)")

            sd._op_named(name, "tf.fused_batch_norm", None, *ins,
                         params={"eps": eps})
        elif op in ("Pad", "PadV2"):
            pv = const_val(1)
            if pv is None:
                raise UnsupportedTFOpError(
                    f"{name}: dynamic Pad unsupported")
            width = [[int(v) for v in row]
                     for row in np.asarray(pv).reshape(-1, 2)]
            cval = 0.0
            if op == "PadV2" and len(in_refs) > 2:
                cv = const_val(2)
                if cv is None:
                    raise UnsupportedTFOpError(
                        f"{name}: non-constant PadV2 value unsupported")
                cval = float(np.asarray(cv).reshape(()))
            sd._op_named(name, "tf.pad", None, *ins,
                         params={"width": width, "cval": cval})
        else:
            raise UnsupportedTFOpError(
                f"TF op '{op}' (node '{name}') is not in the import op set")


def importFrozenTF(path_or_bytes, device=None):
    """≡ SameDiff.importFrozenTF(File): the graph on `device` (the card
    unless "cpu")."""
    return TFGraphMapper.importGraph(path_or_bytes, device=device)


SameDiff.importFrozenTF = staticmethod(importFrozenTF)
