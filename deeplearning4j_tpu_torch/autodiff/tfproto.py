"""Minimal protobuf wire-format codec for TensorFlow GraphDef files: the
port's own copy of `deeplearning4j_tpu/autodiff/tfproto.py` (the port
imports nothing of the JAX package), unchanged in behaviour.

No tensorflow/protobuf dependency: the wire format is five primitive
shapes (varint, fixed32/64, length-delimited), and GraphDef only needs a
handful of message types (NodeDef, AttrValue, TensorProto,
TensorShapeProto). Field numbers follow tensorflow/core/framework/*.proto.
The writer lets tests (and users without TF) author frozen graphs; the
reader backs `SameDiff.importFrozenTF`, and `optimize/xplane.py` decodes
XSpace traces with `parse_fields`.
"""
from __future__ import annotations

import struct

import numpy as np

# TF DataType enum (framework/types.proto)
DT_FLOAT, DT_DOUBLE, DT_INT32, DT_UINT8 = 1, 2, 3, 4
DT_INT16, DT_INT8, DT_STRING, DT_COMPLEX64, DT_INT64, DT_BOOL = \
    5, 6, 7, 8, 9, 10

_DTYPES = {DT_FLOAT: np.float32, DT_DOUBLE: np.float64,
           DT_INT32: np.int32, DT_INT64: np.int64, DT_BOOL: np.bool_,
           DT_UINT8: np.uint8, DT_INT16: np.int16, DT_INT8: np.int8}
_DTYPES_INV = {np.dtype(v): k for k, v in _DTYPES.items()}


# -- wire primitives -----------------------------------------------------
def _read_varint(buf, pos):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(out, value):
    value &= (1 << 64) - 1  # negatives encode as 10-byte two's complement
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def parse_fields(buf):
    """bytes -> {field_number: [raw values]} (varint ints / bytes)."""
    fields = {}
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        fnum, wtype = tag >> 3, tag & 7
        if wtype == 0:
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:
            val = buf[pos:pos + 8]
            pos += 8
        elif wtype == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wtype == 5:
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        fields.setdefault(fnum, []).append(val)
    return fields


def _signed(v):
    """varint int64: values ≥ 2^63 are negative two's complement."""
    return v - (1 << 64) if v >= (1 << 63) else v


# -- GraphDef reading ----------------------------------------------------
def parse_tensor(buf):
    """TensorProto -> numpy array."""
    f = parse_fields(buf)
    dtype = _DTYPES[f[1][0]] if 1 in f else np.float32
    shape = []
    if 2 in f:
        for dim in parse_fields(f[2][0]).get(2, []):
            shape.append(_signed(parse_fields(dim).get(1, [0])[0]))
    if 4 in f and f[4][0]:                       # tensor_content bytes
        arr = np.frombuffer(f[4][0], dtype=dtype)
    elif 5 in f:                                 # float_val (packed or not)
        raw = b"".join(v if isinstance(v, bytes) else b"" for v in f[5])
        arr = np.frombuffer(raw, np.float32) if raw else np.asarray(
            [v for v in f[5] if not isinstance(v, bytes)], np.float32)
        arr = arr.astype(dtype)
    elif 6 in f:                                 # double_val (packed f64)
        raw = b"".join(v for v in f[6] if isinstance(v, bytes))
        arr = np.frombuffer(raw, "<f8").astype(dtype) if raw else \
            np.asarray([v for v in f[6] if not isinstance(v, bytes)],
                       np.float64).astype(dtype)
    elif 7 in f:                                 # int_val
        arr = _packed_ints(f[7], np.int32).astype(dtype)
    elif 10 in f:                                # int64_val
        arr = _packed_ints(f[10], np.int64).astype(dtype)
    elif 11 in f:                                # bool_val
        arr = _packed_ints(f[11], np.bool_)
    elif 8 in f or 13 in f:                      # string_val / half_val
        raise ValueError(
            "TensorProto string/half content is not supported")
    else:
        # no content fields at all is valid protobuf: an all-zeros tensor
        arr = np.zeros(shape or (), dtype)
    n = int(np.prod(shape)) if shape else arr.size
    if arr.size == 1 and n > 1:                  # splat-encoded constant
        arr = np.full(n, arr.reshape(-1)[0], dtype)
    return arr.reshape(shape) if shape else arr.reshape(())


def _packed_ints(vals, dtype):
    out = []
    for v in vals:
        if isinstance(v, bytes):                 # packed repeated
            pos = 0
            while pos < len(v):
                x, pos = _read_varint(v, pos)
                out.append(_signed(x))
        else:
            out.append(_signed(v))
    return np.asarray(out, dtype)


def parse_attr(buf):
    """AttrValue -> python value."""
    f = parse_fields(buf)
    if 2 in f:
        return f[2][0].decode("utf-8", "replace")      # s
    if 3 in f:
        return _signed(f[3][0])                        # i
    if 4 in f:
        return struct.unpack("<f", f[4][0])[0]         # f
    if 5 in f:
        return bool(f[5][0])                           # b
    if 6 in f:
        return ("dtype", f[6][0])                      # type
    if 8 in f:
        return parse_tensor(f[8][0])                   # tensor
    if 7 in f:                                         # shape
        dims = [_signed(parse_fields(d).get(1, [0])[0])
                for d in parse_fields(f[7][0]).get(2, [])]
        return ("shape", dims)
    if 1 in f:                                         # list
        lf = parse_fields(f[1][0])
        if 3 in lf:
            return _packed_ints(lf[3], np.int64).tolist()
        if 4 in lf:
            raw = b"".join(v for v in lf[4] if isinstance(v, bytes))
            return np.frombuffer(raw, "<f4").tolist()
        if 2 in lf:
            return [s.decode() for s in lf[2]]
    return None


class TFNode:
    def __init__(self, name, op, inputs, attrs):
        self.name = name
        self.op = op
        self.inputs = inputs       # raw refs (may carry ':0' / '^ctrl')
        self.attrs = attrs

    def __repr__(self):
        return f"TFNode({self.op} {self.name} <- {self.inputs})"


def parse_graphdef(data):
    """GraphDef bytes -> list[TFNode]."""
    nodes = []
    for nd in parse_fields(data).get(1, []):
        f = parse_fields(nd)
        name = f.get(1, [b""])[0].decode()
        op = f.get(2, [b""])[0].decode()
        inputs = [i.decode() for i in f.get(3, [])]
        attrs = {}
        for kv in f.get(5, []):
            kvf = parse_fields(kv)
            key = kvf.get(1, [b""])[0].decode()
            attrs[key] = parse_attr(kvf.get(2, [b""])[0])
        nodes.append(TFNode(name, op, inputs, attrs))
    return nodes


# -- GraphDef writing (for tests / TF-less authoring) --------------------
def _field(out, fnum, wtype):
    _write_varint(out, (fnum << 3) | wtype)


def _put_bytes(out, fnum, data):
    _field(out, fnum, 2)
    _write_varint(out, len(data))
    out.extend(data)


def _put_varint(out, fnum, value):
    _field(out, fnum, 0)
    _write_varint(out, value)


def encode_tensor(arr):
    arr = np.asarray(arr)
    out = bytearray()
    _put_varint(out, 1, _DTYPES_INV[arr.dtype])
    shape = bytearray()
    for d in arr.shape:
        dim = bytearray()
        _put_varint(dim, 1, d)
        _put_bytes(shape, 2, dim)
    _put_bytes(out, 2, shape)
    _put_bytes(out, 4, arr.tobytes())
    return bytes(out)


def encode_attr(value):
    out = bytearray()
    if isinstance(value, np.generic):   # 0-d numpy scalar → tensor attr
        value = np.asarray(value)
    if isinstance(value, str):
        _put_bytes(out, 2, value.encode())
    elif isinstance(value, bool):
        _put_varint(out, 5, int(value))
    elif isinstance(value, int):
        _put_varint(out, 3, value)
    elif isinstance(value, float):
        _field(out, 4, 5)
        out.extend(struct.pack("<f", value))
    elif isinstance(value, tuple) and value[0] == "dtype":
        _put_varint(out, 6, value[1])
    elif isinstance(value, (list,)):
        lst = bytearray()
        for v in value:
            _put_varint(lst, 3, int(v))
        _put_bytes(out, 1, bytes(lst))
    elif isinstance(value, np.ndarray):
        _put_bytes(out, 8, encode_tensor(value))
    else:
        raise ValueError(f"cannot encode attr {value!r}")
    return bytes(out)


def encode_graphdef(nodes):
    """nodes: list of (name, op, inputs, attrs-dict) or TFNode."""
    out = bytearray()
    for n in nodes:
        if isinstance(n, TFNode):
            name, op, inputs, attrs = n.name, n.op, n.inputs, n.attrs
        else:
            name, op, inputs, attrs = n
        nd = bytearray()
        _put_bytes(nd, 1, name.encode())
        _put_bytes(nd, 2, op.encode())
        for i in inputs:
            _put_bytes(nd, 3, i.encode())
        for k, v in attrs.items():
            kv = bytearray()
            _put_bytes(kv, 1, k.encode())
            _put_bytes(kv, 2, encode_attr(v))
            _put_bytes(nd, 5, bytes(kv))
        _put_bytes(out, 1, bytes(nd))
    return bytes(out)
