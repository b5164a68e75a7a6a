"""ONNX model import → SameDiff: the port of
`deeplearning4j_tpu/autodiff/onnx_import.py` (≡ the reference's planned
nd4j onnx-import module; the same role as tf_import for the ONNX
ecosystem).

Reuses the port's dependency-free protobuf wire codec (tfproto): ONNX
ModelProto/GraphProto/NodeProto/TensorProto are other field numbers over
the same wire format (onnx/onnx.proto). Initializers become SameDiff
constants, graph inputs placeholders, nodes torch ops registered under
"onnx.<op>" in `graph_serde.OP_BUILDERS` with the JAX package's names and
JSON params, so an imported graph saved by either package loads in the
other. The graph runs on its device (the card unless the caller passes
`device="cpu"`) and can be fine-tuned after convertConstantsToVariables.

Convolutions and pools run NCHW as ONNX lays them out (`F.conv2d`,
`F.max_pool2d`, ...): the JAX package computes them with
`lax.conv_general_dilated` / `reduce_window`, outside any Pallas kernel.
"""
from __future__ import annotations

import math
import struct

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.autodiff.graph_serde import op_builder
from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
from deeplearning4j_tpu_torch.autodiff.tfproto import (_read_varint, _signed,
                                                       parse_fields)

__all__ = ["OnnxGraphMapper", "UnsupportedOnnxOpError", "importOnnx",
           "parse_onnx_model", "parse_onnx_tensor"]

# ONNX TensorProto.DataType
_ONNX_DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 5: np.int16,
                6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16,
                11: np.float64}
# what a Cast lands on: the JAX package's 32-bit defaults (x64 off)
_CAST_DTYPES = {1: torch.float32, 2: torch.uint8, 3: torch.int8,
                5: torch.int16, 6: torch.int32, 7: torch.int32,
                9: torch.bool, 10: torch.float16, 11: torch.float32}


class UnsupportedOnnxOpError(ValueError):
    pass


def _packed_int64s(vals):
    """repeated int64, packed (proto3 default: one length-delimited blob)
    or unpacked varints."""
    out = []
    for v in vals:
        if isinstance(v, bytes):
            pos = 0
            while pos < len(v):
                x, pos = _read_varint(v, pos)
                out.append(_signed(x))
        else:
            out.append(_signed(v))
    return out


def parse_onnx_tensor(buf):
    f = parse_fields(buf)
    dims = _packed_int64s(f.get(1, []))
    dtype = _ONNX_DTYPES.get(f.get(2, [1])[0], np.float32)
    if 9 in f and f[9][0]:                       # raw_data
        arr = np.frombuffer(f[9][0], dtype=dtype)
    elif 4 in f:                                 # float_data (packed f32)
        raw = b"".join(v for v in f[4] if isinstance(v, bytes))
        arr = np.frombuffer(raw, "<f4").astype(dtype) if raw else \
            np.asarray([], dtype)
    elif 7 in f:                                 # int64_data
        arr = np.asarray(_packed_int64s(f[7]), dtype)
    else:
        arr = np.zeros(dims or (), dtype)
    name = f.get(8, [b""])[0].decode()
    return name, (arr.reshape(dims) if dims else arr.reshape(()))


def _parse_attr(buf):
    f = parse_fields(buf)
    name = f.get(1, [b""])[0].decode()
    if 2 in f:
        return name, struct.unpack("<f", f[2][0])[0]
    if 3 in f:
        return name, _signed(f[3][0])
    if 4 in f:
        return name, f[4][0].decode("utf-8", "replace")
    if 5 in f:
        return name, parse_onnx_tensor(f[5][0])[1]
    if 8 in f:                                   # ints
        return name, _packed_int64s(f[8])
    if 7 in f:                                   # floats (opset-7 Upsample
        # scales live here): parse_fields stores every wire-type-5 value
        # as 4-byte chunks and packed lists as one blob
        out = []
        for v in f[7]:
            out.extend(struct.unpack(f"<{len(v) // 4}f", v))
        return name, out
    return name, None


def _attr(node, name, default):
    v = node.attrs.get(name)
    return default if v is None else v


def _pads_params(node):
    """The (auto_pad, pads) attribute pair as plain JSON values: what a
    serialized conv/pool node needs to resolve its padding when it runs."""
    auto = _attr(node, "auto_pad", "NOTSET")
    if isinstance(auto, bytes):
        auto = auto.decode()
    pads = node.attrs.get("pads")
    return auto, (None if pads is None else [int(p) for p in pads])


def _resolve_pads(auto, pads, k, s, d, spatial, name=""):
    """Effective ((lo, hi), ...) spatial padding for Conv/pools, honoring
    `auto_pad` (SAME_UPPER/SAME_LOWER/VALID) over the explicit `pads`
    attribute. `spatial` is the input's spatial shape."""
    if auto in ("NOTSET", ""):
        pads = pads or [0] * (2 * len(spatial))
        n = len(spatial)
        return [(int(pads[i]), int(pads[i + n])) for i in range(n)]
    if auto == "VALID":
        return [(0, 0)] * len(spatial)
    if auto in ("SAME_UPPER", "SAME_LOWER"):
        out = []
        for i, size in enumerate(spatial):
            eff = (int(k[i]) - 1) * int(d[i]) + 1
            o = -(-int(size) // int(s[i]))
            total = max((o - 1) * int(s[i]) + eff - int(size), 0)
            lo = total // 2
            hi = total - lo
            out.append((hi, lo) if auto == "SAME_LOWER" else (lo, hi))
        return out
    raise UnsupportedOnnxOpError(
        f"{name}: unsupported auto_pad value {auto!r}")


def _flat_pads(pairs):
    """[(lo, hi) per spatial dim] → F.pad's flat list, last dim first."""
    return [v for p in reversed(pairs) for v in p]


class OnnxNode:
    def __init__(self, name, op, inputs, outputs, attrs):
        self.name, self.op = name, op
        self.inputs, self.outputs = inputs, outputs
        self.attrs = attrs


def parse_onnx_model(data):
    """ModelProto bytes -> (nodes, initializers{name: arr},
    input_infos{name: dims}, output_names, opset)."""
    model = parse_fields(data)
    graph = parse_fields(model[7][0])            # ModelProto.graph = 7
    inits = {}
    for t in graph.get(5, []):                   # initializer = 5
        name, arr = parse_onnx_tensor(t)
        inits[name] = arr
    nodes = []
    for nb in graph.get(1, []):                  # node = 1
        f = parse_fields(nb)
        attrs = dict(_parse_attr(a) for a in f.get(5, []))
        nodes.append(OnnxNode(
            f.get(3, [b""])[0].decode(),
            f.get(4, [b""])[0].decode(),
            [i.decode() for i in f.get(1, [])],
            [o.decode() for o in f.get(2, [])],
            attrs))
    inputs = {}
    for vi in graph.get(11, []):                 # input = 11
        f = parse_fields(vi)
        nm = f.get(1, [b""])[0].decode()
        dims = []
        if 2 in f:
            tt = parse_fields(f[2][0])
            if 1 in tt:
                shp = parse_fields(tt[1][0])
                if 2 in shp:
                    for d in parse_fields(shp[2][0]).get(1, []):
                        df = parse_fields(d)
                        dims.append(_signed(df[1][0]) if 1 in df else -1)
        inputs[nm] = dims
    outputs = [parse_fields(vi).get(1, [b""])[0].decode()
               for vi in graph.get(12, [])]      # output = 12
    opset = 13                                   # modern default
    for oi in model.get(8, []):                  # opset_import = 8
        f = parse_fields(oi)
        domain = f.get(1, [b""])[0]
        if domain in (b"", b"ai.onnx"):
            opset = _signed(f.get(2, [13])[0])
    return nodes, inits, inputs, outputs, opset


_ONNX_ELEMENTWISE = {
    "Add": torch.add, "Sub": torch.sub, "Mul": torch.mul,
    "Div": torch.div, "Pow": torch.pow, "Sqrt": torch.sqrt,
    "Exp": torch.exp, "Log": torch.log, "Abs": torch.abs, "Neg": torch.neg,
    "Relu": torch.relu, "Sigmoid": torch.sigmoid, "Tanh": torch.tanh,
    "Erf": torch.erf, "Identity": lambda x: x,
    "Reciprocal": lambda x: 1.0 / x, "Floor": torch.floor,
    "Ceil": torch.ceil, "Sign": torch.sign,
}

# -- serializable op builders (graph_serde registry, "onnx." namespace):
# every imported node lowers to (opname, params) with params plain JSON,
# so an imported-then-saved graph restores with no ONNX file --
for _opn, _fn in _ONNX_ELEMENTWISE.items():
    op_builder("onnx." + _opn.lower())((lambda f: lambda: f)(_fn))
op_builder("onnx.matmul")(lambda: torch.matmul)
op_builder("onnx.softplus")(lambda: F.softplus)
op_builder("onnx.gap")(
    lambda: lambda x: torch.mean(x, dim=tuple(range(2, x.ndim)),
                                 keepdim=True))


def _mT(a):
    return a.transpose(-2, -1) if a.ndim >= 2 else a


@op_builder("onnx.gemm")
def _b_gemm(alpha=1.0, beta=1.0, ta=0, tb=0):
    def gemm(a, b, *c):
        a = _mT(a) if ta else a
        b = _mT(b) if tb else b
        y = alpha * (a @ b)
        return y + beta * c[0] if c else y
    return gemm


@op_builder("onnx.softmax")
def _b_softmax(axis=-1):
    return lambda x: torch.softmax(x, dim=axis)


@op_builder("onnx.softmax_2d")
def _b_softmax_2d(axis=1):
    # opset <13 coerce-to-2D semantics: softmax over ALL dims from `axis`
    # on, flattened together
    def softmax_2d(x):
        ax = axis if axis >= 0 else x.ndim + axis
        lead = math.prod(x.shape[:ax]) if ax else 1
        y = torch.softmax(x.reshape(lead, -1), dim=-1)
        return y.reshape(x.shape)
    return softmax_2d


@op_builder("onnx.reshape")
def _b_reshape(shape):
    return lambda x, *_r: torch.reshape(x, tuple(shape))


@op_builder("onnx.transpose")
def _b_transpose(perm=None):
    def f(x):
        p = tuple(reversed(range(x.ndim))) if perm is None else tuple(perm)
        return x.permute(p)
    return f


@op_builder("onnx.concat")
def _b_concat(axis=0):
    return lambda *xs: torch.cat(xs, dim=axis)


@op_builder("onnx.gather")
def _b_gather(axis=0):
    def gather(p, i):
        ax = axis if axis >= 0 else p.ndim + axis
        i = i.long()
        i = torch.where(i < 0, i + p.shape[ax], i)
        flat = torch.index_select(p, ax, i.reshape(-1))
        return flat.reshape(p.shape[:ax] + i.shape + p.shape[ax + 1:])
    return gather


@op_builder("onnx.flatten")
def _b_flatten(axis=1):
    return lambda x: x.reshape((math.prod(x.shape[:axis]), -1))


@op_builder("onnx.squeeze")
def _b_squeeze(axes=()):
    ax = tuple(axes)

    def squeeze(x, *_r):
        if not ax:
            return x.squeeze()
        return x.squeeze(ax)
    return squeeze


@op_builder("onnx.unsqueeze")
def _b_unsqueeze(axes=()):
    def unsq(x, *_r):
        for a in sorted(axes):
            x = torch.unsqueeze(x, a)
        return x
    return unsq


def _onnx_reduce_builder(fn):
    def build(axes=(), keep=1):
        ax = tuple(axes)

        def f(x, *_r):
            dims = ax or tuple(range(x.ndim))
            return fn(x, dim=dims, keepdim=bool(keep))
        return f
    return build


for _rop, _rfn in [("reduce_mean", torch.mean), ("reduce_sum", torch.sum),
                   ("reduce_max", torch.amax), ("reduce_min", torch.amin)]:
    op_builder("onnx." + _rop)(_onnx_reduce_builder(_rfn))
# global pools reduce every spatial dim (ONNX defines them for rank >= 3)
op_builder("onnx.gmp")(
    lambda: lambda x: torch.amax(x, dim=tuple(range(2, x.ndim)),
                                 keepdim=True))


@op_builder("onnx.slice")
def _b_slice(axes, starts, ends, steps):
    def f(x, *_r):
        for a, st, en, sp in zip(axes, starts, ends, steps):
            a = a if a >= 0 else x.ndim + a
            idx = range(*slice(st, en, sp).indices(x.shape[a]))
            if sp == 1:
                x = x.narrow(a, idx.start, len(idx))
            else:
                x = torch.index_select(x, a, torch.as_tensor(
                    list(idx), dtype=torch.long, device=x.device))
        return x
    return f


@op_builder("onnx.conv")
def _b_conv(strides=(1, 1), dil=(1, 1), groups=1, auto_pad="NOTSET",
            pads=None, name=""):
    st, dl = tuple(strides), tuple(dil)

    def conv(x, w, *b):
        # pads resolved at run time: auto_pad=SAME_* depends on the input
        # spatial shape
        pad_arg = _resolve_pads(auto_pad, pads, w.shape[2:], st, dl,
                                x.shape[2:], name)
        y = F.conv2d(F.pad(x, _flat_pads(pad_arg)), w.to(x.dtype),
                     stride=st, dilation=dl, groups=groups)
        return y + b[0].reshape(1, -1, 1, 1) if b else y
    return conv


def _pool_nd(x, fn2, fn3):
    """Run a 1-, 2- or 3-D pool: 1-D as 2-D over a unit row."""
    nd = x.ndim - 2
    if nd == 1:
        return lambda *a: fn2(x.unsqueeze(2), *a).squeeze(2)
    if nd == 2:
        return lambda *a: fn2(x, *a)
    return lambda *a: fn3(x, *a)


def _as2(k, nd):
    return (1,) + tuple(k) if nd == 1 else tuple(k)


@op_builder("onnx.maxpool")
def _b_maxpool(ksize, strides, auto_pad="NOTSET", pads=None, name=""):
    k, s = tuple(ksize), tuple(strides)
    ones = (1,) * len(k)

    def f(x):
        pad_arg = _resolve_pads(auto_pad, pads, k, s, ones, x.shape[2:],
                                name)
        xp = F.pad(x, _flat_pads(pad_arg), value=-math.inf)
        nd = len(k)
        return _pool_nd(xp, F.max_pool2d, F.max_pool3d)(_as2(k, nd),
                                                         _as2(s, nd))
    return f


@op_builder("onnx.avgpool")
def _b_avgpool(ksize, strides, auto_pad="NOTSET", pads=None,
               include_pad=False, name=""):
    k, s = tuple(ksize), tuple(strides)
    ones = (1,) * len(k)

    def window_sum(x, pad_arg):
        xp = F.pad(x, _flat_pads(pad_arg))
        nd = len(k)
        sum2 = lambda t, kk, ss: F.avg_pool2d(t, kk, ss, divisor_override=1)
        sum3 = lambda t, kk, ss: F.avg_pool3d(t, kk, ss, divisor_override=1)
        return _pool_nd(xp, sum2, sum3)(_as2(k, nd), _as2(s, nd))

    def avg(x):
        pad_arg = _resolve_pads(auto_pad, pads, k, s, ones, x.shape[2:],
                                name)
        summed = window_sum(x, pad_arg)
        if include_pad:
            # padded zeros COUNT: divide by the full kernel size
            return summed / float(math.prod(k))
        n = window_sum(torch.ones_like(x[:1, :1]), pad_arg)
        return summed / n
    return avg


@op_builder("onnx.batchnorm")
def _b_batchnorm(eps=1e-5):
    def bn(x, gamma, beta, mean, var):
        shape = (1, -1) + (1,) * (x.ndim - 2)
        return ((x - mean.reshape(shape))
                * torch.rsqrt(var.reshape(shape) + eps)
                * gamma.reshape(shape) + beta.reshape(shape))
    return bn


@op_builder("onnx.cast")
def _b_cast(to=1):
    dt = _CAST_DTYPES.get(int(to), torch.float32)
    return lambda x: x.to(dt)


@op_builder("onnx.clip")
def _b_clip(lo, hi):
    # open bounds travel as null (strict-JSON artifact), not Infinity
    l = -math.inf if lo is None else lo
    h = math.inf if hi is None else hi
    return lambda x, *_r: torch.clamp(x, l, h)


@op_builder("onnx.leakyrelu")
def _b_leakyrelu(alpha=0.01):
    return lambda x: torch.where(x > 0, x, alpha * x)


@op_builder("onnx.elu")
def _b_elu(alpha=1.0):
    return lambda x: torch.where(x > 0, x, alpha * (torch.exp(x) - 1.0))


@op_builder("onnx.hardsigmoid")
def _b_hardsigmoid(alpha=0.2, beta=0.5):
    return lambda x: torch.clamp(alpha * x + beta, 0.0, 1.0)


@op_builder("onnx.conv_transpose")
def _b_conv_transpose(strides=(1, 1), dil=(1, 1), pads=None,
                      out_pad=(0, 0)):
    st, dl, op_ = tuple(strides), tuple(dil), tuple(out_pad)

    def convt(x, w, *b):
        # ONNX weights are (Cin, Cout, kH, kW), torch's transposed layout:
        # the full output ((H - 1)·s + (k - 1)·d + 1) cropped by the pads,
        # output_padding appended as zeros at the end
        y = F.conv_transpose2d(x, w.to(x.dtype), stride=st, dilation=dl)
        p = pads or (0, 0, 0, 0)   # (top, left, bottom, right)
        y = F.pad(y, (-p[1], -p[3] + op_[1], -p[0], -p[2] + op_[0]))
        return y + b[0].reshape(1, -1, 1, 1) if b else y
    return convt


def _pad_index(n, lo, hi, mode, device):
    """Source index of each output position of one padded dim."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    period = 2 * (n - 1)                      # reflect without the edge
    j = torch.remainder(i, period) if period else torch.zeros_like(i)
    return torch.where(j >= n, period - j, j)


@op_builder("onnx.pad")
def _b_pad(pads, jmode="constant", cval=0.0, name=""):
    def pad(x, *_r):
        n = x.ndim
        if len(pads) != 2 * n:
            raise UnsupportedOnnxOpError(
                f"{name}: Pad expects {2 * n} widths for rank-{n} "
                f"input, got {len(pads)}")
        width = [(pads[i], pads[i + n]) for i in range(n)]
        if jmode == "constant":
            return F.pad(x, _flat_pads(width), value=cval)
        for d, (lo, hi) in enumerate(width):
            if lo or hi:
                x = torch.index_select(x, d, _pad_index(
                    x.shape[d], lo, hi, jmode, x.device))
        return x
    return pad


@op_builder("onnx.resize")
def _b_resize(scales=None, sizes=None, name=""):
    def resize(x, *_r):
        if scales is not None:
            sh, sw = int(scales[2]), int(scales[3])
        else:
            if sizes[0] != x.shape[0] or sizes[1] != x.shape[1]:
                raise UnsupportedOnnxOpError(
                    f"{name}: Resize sizes may not change "
                    f"batch/channel dims")
            if sizes[2] % x.shape[2] or sizes[3] % x.shape[3]:
                raise UnsupportedOnnxOpError(
                    f"{name}: Resize sizes {sizes[2:]} are not "
                    f"integer multiples of input {tuple(x.shape[2:])}")
            sh = sizes[2] // x.shape[2]
            sw = sizes[3] // x.shape[3]
        return torch.repeat_interleave(
            torch.repeat_interleave(x, sh, dim=2), sw, dim=3)
    return resize


class OnnxGraphMapper:
    @staticmethod
    def importModel(path_or_bytes, sd=None, device=None):
        """A ModelProto (a path or its bytes) into `sd`, or into a new
        SameDiff on `device` (the card unless "cpu")."""
        data = path_or_bytes
        if not isinstance(data, (bytes, bytearray)):
            with open(data, "rb") as f:
                data = f.read()
        nodes, inits, inputs, outputs, opset = parse_onnx_model(bytes(data))
        sd = sd or SameDiff.create(device=device)
        consts = {}
        for name, arr in inits.items():
            sd.constant(name, arr)
            consts[name] = arr
        for name, dims in inputs.items():
            if name in inits:
                continue
            sd.placeHolder(name, *[d if d > 0 else None for d in dims])
        for node in nodes:
            OnnxGraphMapper._map_node(sd, node, consts, opset)
        sd._onnx_outputs = outputs
        return sd

    @staticmethod
    def _map_node(sd, node, consts, opset=13):
        op = node.op
        out = node.outputs[0]
        ins = [sd.getVariable(r) for r in node.inputs if r]

        def const_val(i):
            return consts.get(node.inputs[i])

        if op == "Constant":
            val = node.attrs.get("value")
            consts[out] = np.asarray(val)
            sd.constant(out, np.asarray(val))
            return
        if op in _ONNX_ELEMENTWISE:
            sd._op_named(out, "onnx." + op.lower(), None, *ins, params={})
        elif op == "MatMul":
            sd._op_named(out, "onnx.matmul", None, *ins, params={})
        elif op == "Gemm":
            sd._op_named(out, "onnx.gemm", None, *ins, params={
                "alpha": float(_attr(node, "alpha", 1.0)),
                "beta": float(_attr(node, "beta", 1.0)),
                "ta": int(_attr(node, "transA", 0)),
                "tb": int(_attr(node, "transB", 0))})
        elif op == "Softmax":
            if opset < 13:
                sd._op_named(out, "onnx.softmax_2d", None, *ins,
                             params={"axis": int(_attr(node, "axis", 1))})
            else:
                sd._op_named(out, "onnx.softmax", None, *ins,
                             params={"axis": int(_attr(node, "axis", -1))})
        elif op == "Reshape":
            shp = const_val(1)
            if shp is None:
                raise UnsupportedOnnxOpError(
                    f"{out}: dynamic Reshape unsupported")
            shp = [int(s) for s in np.asarray(shp).reshape(-1)]
            sd._op_named(out, "onnx.reshape", None, *ins,
                         params={"shape": shp})
        elif op == "Transpose":
            perm = node.attrs.get("perm")
            perm = None if perm is None else [int(p) for p in perm]
            sd._op_named(out, "onnx.transpose", None, *ins,
                         params={"perm": perm})
        elif op == "Concat":
            sd._op_named(out, "onnx.concat", None, *ins,
                         params={"axis": int(_attr(node, "axis", 0))})
        elif op == "Gather":
            sd._op_named(out, "onnx.gather", None, *ins,
                         params={"axis": int(_attr(node, "axis", 0))})
        elif op == "Flatten":
            sd._op_named(out, "onnx.flatten", None, *ins,
                         params={"axis": int(_attr(node, "axis", 1))})
        elif op in ("Squeeze", "Unsqueeze"):
            axes = node.attrs.get("axes")
            if axes is None and len(node.inputs) > 1:
                av = const_val(1)
                axes = None if av is None else np.asarray(
                    av).reshape(-1).tolist()
            axes = [int(a) for a in (axes or [])]
            sd._op_named(out, "onnx." + op.lower(), None, *ins,
                         params={"axes": axes})
        elif op in ("ReduceMean", "ReduceSum", "ReduceMax", "ReduceMin"):
            axes = node.attrs.get("axes")
            if axes is None and len(node.inputs) > 1 and node.inputs[1]:
                av = const_val(1)   # opset-13/18+: axes as input
                if av is None:
                    raise UnsupportedOnnxOpError(
                        f"{out}: dynamic {op} axes unsupported")
                axes = np.asarray(av).reshape(-1).tolist()
            if not axes and int(_attr(node, "noop_with_empty_axes", 0)):
                # spec: empty axes + the flag == identity, NOT reduce-all
                sd._op_named(out, "onnx.identity", None, ins[0], params={})
            else:
                sd._op_named(out, "onnx.reduce_" + op[6:].lower(), None,
                             *ins, params={
                                 "axes": [int(a) for a in (axes or [])],
                                 "keep": int(_attr(node, "keepdims", 1))})
        elif op == "GlobalMaxPool":
            sd._op_named(out, "onnx.gmp", None, *ins, params={})
        elif op == "Slice":
            OnnxGraphMapper._map_slice(sd, node, out, ins, const_val)
        elif op == "Split":
            axis = int(_attr(node, "axis", 0))
            sizes = node.attrs.get("split")
            if sizes is None and len(node.inputs) > 1 and node.inputs[1]:
                av = const_val(1)   # opset-13+: split sizes as input
                if av is None:
                    raise UnsupportedOnnxOpError(
                        f"{out}: dynamic Split sizes unsupported")
                sizes = np.asarray(av).reshape(-1).tolist()
            if sizes is None:
                raise UnsupportedOnnxOpError(
                    f"{out}: Split without explicit sizes unsupported "
                    "(equal split needs a static dim — export with the "
                    "'split' attribute/input)")
            off = 0
            for i, o_name in enumerate(node.outputs):
                sd._op_named(o_name, "slice_axis", None, *ins,
                             params={"axis": axis, "start": off,
                                     "size": int(sizes[i])})
                off += int(sizes[i])
        elif op == "Conv":
            auto, pads = _pads_params(node)
            sd._op_named(out, "onnx.conv", None, *ins, params={
                "strides": [int(s) for s in
                            (node.attrs.get("strides") or (1, 1))],
                "dil": [int(d) for d in
                        (node.attrs.get("dilations") or (1, 1))],
                "groups": int(_attr(node, "group", 1)),
                "auto_pad": auto, "pads": pads, "name": out})
        elif op in ("MaxPool", "AveragePool"):
            OnnxGraphMapper._map_pool(sd, node, op, out, ins)
        elif op == "GlobalAveragePool":
            sd._op_named(out, "onnx.gap", None, *ins, params={})
        elif op == "BatchNormalization":
            sd._op_named(out, "onnx.batchnorm", None, *ins, params={
                "eps": float(_attr(node, "epsilon", 1e-5))})
        elif op == "Cast":
            sd._op_named(out, "onnx.cast", None, *ins,
                         params={"to": int(_attr(node, "to", 1))})
        elif op == "Clip":
            lo = _attr(node, "min", None)
            hi = _attr(node, "max", None)
            if lo is None and len(node.inputs) > 1 and node.inputs[1]:
                cv = const_val(1)
                if cv is None:
                    raise UnsupportedOnnxOpError(
                        f"{out}: dynamic Clip min unsupported")
                lo = float(np.asarray(cv).reshape(()))
            if hi is None and len(node.inputs) > 2 and node.inputs[2]:
                cv = const_val(2)
                if cv is None:
                    raise UnsupportedOnnxOpError(
                        f"{out}: dynamic Clip max unsupported")
                hi = float(np.asarray(cv).reshape(()))
            sd._op_named(out, "onnx.clip", None, *ins, params={
                "lo": None if lo is None else float(lo),
                "hi": None if hi is None else float(hi)})
        elif op == "LeakyRelu":
            sd._op_named(out, "onnx.leakyrelu", None, *ins,
                         params={"alpha": float(_attr(node, "alpha", 0.01))})
        elif op == "Elu":
            sd._op_named(out, "onnx.elu", None, *ins,
                         params={"alpha": float(_attr(node, "alpha", 1.0))})
        elif op == "Softplus":
            sd._op_named(out, "onnx.softplus", None, *ins, params={})
        elif op == "HardSigmoid":
            sd._op_named(out, "onnx.hardsigmoid", None, *ins, params={
                "alpha": float(_attr(node, "alpha", 0.2)),
                "beta": float(_attr(node, "beta", 0.5))})
        elif op == "ConvTranspose":
            OnnxGraphMapper._map_conv_transpose(sd, node, out, ins)
        elif op == "Pad":
            OnnxGraphMapper._map_pad(sd, node, out, ins, const_val)
        elif op in ("Resize", "Upsample"):
            OnnxGraphMapper._map_resize(sd, node, op, out, ins, const_val)
        else:
            raise UnsupportedOnnxOpError(
                f"ONNX op '{op}' (node '{out}') is not in the import set")

    @staticmethod
    def _map_slice(sd, node, out, ins, const_val):
        starts = node.attrs.get("starts")
        ends = node.attrs.get("ends")
        axes = node.attrs.get("axes")
        steps = None
        if starts is None:        # opset-10+: inputs 1..4
            def _slice_cv(i):
                if len(node.inputs) > i and node.inputs[i]:
                    av = const_val(i)
                    if av is None:
                        raise UnsupportedOnnxOpError(
                            f"{out}: dynamic Slice unsupported")
                    return np.asarray(av).reshape(-1).tolist()
                return None
            starts, ends = _slice_cv(1), _slice_cv(2)
            axes, steps = _slice_cv(3), _slice_cv(4)
        if starts is None or ends is None:
            raise UnsupportedOnnxOpError(
                f"{out}: Slice needs constant starts/ends")
        n_ = len(starts)
        axes = (list(range(n_)) if axes is None
                else [int(a) for a in axes])
        steps = ([1] * n_ if steps is None
                 else [int(x_) for x_ in steps])
        # clamp ONNX's INT64_MAX "to the end" sentinels into python
        # slice range
        big = 2 ** 31
        sd._op_named(out, "onnx.slice", None, *ins, params={
            "axes": axes,
            "starts": [int(max(-big, min(big, v))) for v in starts],
            "ends": [int(max(-big, min(big, v))) for v in ends],
            "steps": steps})

    @staticmethod
    def _map_pool(sd, node, op, out, ins):
        ksize = [int(k) for k in (node.attrs.get("kernel_shape") or (2, 2))]
        strides = [int(s) for s in (node.attrs.get("strides") or ksize)]
        # silently-wrong output is worse than a loud unsupported error:
        # ceil_mode=1 (common in torch exports) changes output SHAPES;
        # pool dilations change the window footprint
        if int(_attr(node, "ceil_mode", 0)) != 0:
            raise UnsupportedOnnxOpError(
                f"{out}: {op} ceil_mode=1 unsupported (re-export with "
                "ceil_mode=0 / torch.onnx ceil_mode=False)")
        pdil = tuple(node.attrs.get("dilations") or (1,) * len(ksize))
        if any(d != 1 for d in pdil):
            raise UnsupportedOnnxOpError(
                f"{out}: {op} dilations={pdil} unsupported")
        auto, pads = _pads_params(node)
        params = {"ksize": ksize, "strides": strides,
                  "auto_pad": auto, "pads": pads, "name": out}
        if op == "MaxPool":
            sd._op_named(out, "onnx.maxpool", None, *ins, params=params)
        else:
            # count_include_pad=1: divide by the FULL kernel size
            # everywhere; default 0 divides by the real elements under
            # each window
            params["include_pad"] = \
                int(_attr(node, "count_include_pad", 0)) != 0
            sd._op_named(out, "onnx.avgpool", None, *ins, params=params)

    @staticmethod
    def _map_conv_transpose(sd, node, out, ins):
        strides = tuple(node.attrs.get("strides") or (1, 1))
        dil = tuple(node.attrs.get("dilations") or (1, 1))
        groups = int(_attr(node, "group", 1))
        out_pad = tuple(node.attrs.get("output_padding") or (0, 0))
        if groups != 1:
            raise UnsupportedOnnxOpError(
                f"{out}: grouped ConvTranspose unsupported")
        auto_pad = node.attrs.get("auto_pad", b"NOTSET")
        auto_pad = (auto_pad.decode() if isinstance(
            auto_pad, (bytes, bytearray)) else str(auto_pad))
        if auto_pad not in ("NOTSET", ""):
            raise UnsupportedOnnxOpError(
                f"{out}: ConvTranspose auto_pad={auto_pad!r} "
                f"unsupported (export with explicit pads)")
        if node.attrs.get("output_shape") is not None:
            raise UnsupportedOnnxOpError(
                f"{out}: ConvTranspose output_shape unsupported "
                f"(export with explicit pads)")
        pads = node.attrs.get("pads")
        sd._op_named(out, "onnx.conv_transpose", None, *ins, params={
            "strides": [int(s) for s in strides],
            "dil": [int(d) for d in dil],
            "pads": None if pads is None else [int(p) for p in pads],
            "out_pad": [int(p) for p in out_pad]})

    @staticmethod
    def _map_pad(sd, node, out, ins, const_val):
        mode = node.attrs.get("mode", b"constant")
        mode = (mode.decode() if isinstance(mode, (bytes, bytearray))
                else str(mode))
        pads = node.attrs.get("pads")
        if pads is None:          # opset-11+: pads as input[1]
            pv = const_val(1)
            if pv is None:
                raise UnsupportedOnnxOpError(
                    f"{out}: dynamic Pad unsupported")
            pads = np.asarray(pv).reshape(-1).tolist()
        if len(node.inputs) > 3 and node.inputs[3]:
            raise UnsupportedOnnxOpError(
                f"{out}: opset-18 Pad axes input unsupported "
                f"(pads must cover every dimension)")
        cval = 0.0
        if len(node.inputs) > 2 and node.inputs[2]:
            cv = const_val(2)
            if cv is None:
                raise UnsupportedOnnxOpError(
                    f"{out}: non-constant Pad value unsupported")
            cval = float(np.asarray(cv).reshape(()))
        pads = [int(p) for p in pads]
        jmode = {"constant": "constant", "reflect": "reflect",
                 "edge": "edge"}.get(mode)
        if jmode is None:
            raise UnsupportedOnnxOpError(f"{out}: Pad mode {mode!r}")
        sd._op_named(out, "onnx.pad", None, *ins, params={
            "pads": pads, "jmode": jmode, "cval": cval, "name": out})

    @staticmethod
    def _map_resize(sd, node, op, out, ins, const_val):
        mode = node.attrs.get("mode", b"nearest")
        mode = (mode.decode() if isinstance(mode, (bytes, bytearray))
                else str(mode))
        if mode != "nearest":
            raise UnsupportedOnnxOpError(
                f"{out}: Resize mode {mode!r} unsupported (nearest only)")
        # input layouts differ: Upsample = [X, scales] (or a scales attr
        # at opset 7); Resize = [X, roi, scales, sizes], where scales may
        # be an EMPTY name with sizes given instead — index by position
        scales = node.attrs.get("scales")
        sizes = None
        # opset-10 Resize is [X, scales]; opset-11+ adds roi at idx 1
        scales_idx = (1 if op == "Upsample" or len(node.inputs) == 2
                      else 2)
        if scales is None and len(node.inputs) > scales_idx \
                and node.inputs[scales_idx]:
            cv = const_val(scales_idx)
            if cv is None:
                raise UnsupportedOnnxOpError(
                    f"{out}: non-constant {op} scales unsupported")
            scales = np.asarray(cv).reshape(-1).tolist()
        if scales is None and op == "Resize" and \
                len(node.inputs) > 3 and node.inputs[3]:
            cv = const_val(3)
            if cv is None:
                raise UnsupportedOnnxOpError(
                    f"{out}: non-constant Resize sizes unsupported")
            sizes = [int(s) for s in np.asarray(cv).reshape(-1)]
        if scales is None and sizes is None:
            raise UnsupportedOnnxOpError(
                f"{out}: {op} needs constant NCHW scales or sizes")
        if scales is not None:
            if float(scales[0]) != 1.0 or float(scales[1]) != 1.0:
                raise UnsupportedOnnxOpError(
                    f"{out}: {op} batch/channel scales must be 1, "
                    f"got {scales[:2]}")
            sh, sw = float(scales[2]), float(scales[3])
            if sh != int(sh) or sw != int(sw) or sh < 1 or sw < 1:
                raise UnsupportedOnnxOpError(
                    f"{out}: non-integer upsample scales ({sh}, {sw})")
        sd._op_named(out, "onnx.resize", None, *ins, params={
            "scales": None if scales is None else [float(s)
                                                  for s in scales],
            "sizes": sizes, "name": out})


def importOnnx(path_or_bytes, device=None):
    """≡ SameDiff.importOnnx: the graph on `device` (the card unless
    "cpu")."""
    return OnnxGraphMapper.importModel(path_or_bytes, device=device)


SameDiff.importOnnx = staticmethod(importOnnx)
