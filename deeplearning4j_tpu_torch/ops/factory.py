"""`nd` — the Nd4j-equivalent array factory and op-catalog namespace:
the port of `deeplearning4j_tpu/ops/factory.py`.

Usage mirrors the reference: `nd.zeros(3, 4)`, `nd.rand(2, 2)`,
`nd.exp(x)`, `nd.concat(0, a, b)`. New arrays land on `nd`'s device
(`nd.setDevice(...)`; by default the card, as every entry point of the
port); results of ops stay on their operands' device. `nd.rand`/`randn`
draw from the JAX key stream (`ops/random.py`): `rand` equals the JAX
package's draw bit for bit.
"""
from __future__ import annotations

import ast

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops.ndarray import (NDArray, as_torch,
                                                  default_device,
                                                  resolve_dtype,
                                                  set_default_device)
from deeplearning4j_tpu_torch.ops.random import RandomState

__all__ = ["nd"]


def _shape(args):
    if len(args) == 1 and isinstance(args[0], (tuple, list)):
        return tuple(int(a) for a in args[0])
    return tuple(int(a) for a in args)


def _num_segments(ids, num_segments):
    return int(num_segments) if num_segments is not None \
        else int(ids.max()) + 1


def _ids(segment_ids, device):
    return as_torch(segment_ids, device=device).long()


def _segment(data, segment_ids, num_segments, reduce):
    """jax.ops.segment_<reduce> along dim 0; an empty segment holds the
    reduction's identity (0 for sum, 1 for prod, ∓inf (or the integer
    extreme) for max/min), as in JAX."""
    a = as_torch(data)
    ids = _ids(segment_ids, a.device)
    n = _num_segments(ids, num_segments)
    shape = (n,) + tuple(a.shape[1:])
    if reduce == "sum":
        return torch.zeros(shape, dtype=a.dtype, device=a.device) \
            .index_add_(0, ids, a)
    if reduce == "prod":
        init = 1
    elif a.dtype.is_floating_point:
        init = float("-inf") if reduce == "amax" else float("inf")
    else:
        info = torch.iinfo(a.dtype)
        init = info.min if reduce == "amax" else info.max
    out = torch.full(shape, init, dtype=a.dtype, device=a.device)
    return out.index_reduce_(0, ids, a, reduce, include_self=True)


class _Nd:
    """Singleton factory namespace (≡ static class Nd4j)."""

    def __init__(self):
        self._random = RandomState(0)
        self.default_dtype = torch.float32

    # -- device and randomness ------------------------------------------
    def setDevice(self, device):
        """Where `nd` makes new arrays (None: the card)."""
        set_default_device(device)
        return self

    def getDevice(self):
        return default_device()

    def getRandom(self):
        return self._random

    def setSeed(self, seed):
        self._random = RandomState(int(seed))

    def _dt(self, dtype):
        return resolve_dtype(dtype) or self.default_dtype

    # -- creation --------------------------------------------------------
    def create(self, data, shape=None, dtype=None):
        arr = NDArray(data, dtype=dtype or self.default_dtype)
        if shape is not None:
            arr = arr.reshape(shape)
        return arr

    def array(self, data, dtype=None):
        return NDArray(data, dtype=dtype)

    def zeros(self, *shape, dtype=None):
        return NDArray(torch.zeros(_shape(shape), dtype=self._dt(dtype),
                                   device=default_device()))

    def ones(self, *shape, dtype=None):
        return NDArray(torch.ones(_shape(shape), dtype=self._dt(dtype),
                                  device=default_device()))

    def zerosLike(self, x):
        return NDArray(torch.zeros_like(as_torch(x)))

    def onesLike(self, x):
        return NDArray(torch.ones_like(as_torch(x)))

    def valueArrayOf(self, shape, value, dtype=None):
        shape = tuple(shape) if isinstance(shape, (tuple, list)) \
            else (int(shape),)
        return self.full(shape, value, dtype)

    def full(self, shape, value, dtype=None):
        return NDArray(torch.full(tuple(shape), value, dtype=self._dt(dtype),
                                  device=default_device()))

    def eye(self, n, dtype=None):
        return NDArray(torch.eye(int(n), dtype=self._dt(dtype),
                                 device=default_device()))

    def linspace(self, start, stop, num, dtype=None):
        return NDArray(torch.linspace(start, stop, int(num),
                                      dtype=self._dt(dtype),
                                      device=default_device()))

    def arange(self, *args, dtype=None):
        # jnp.arange: integer arguments give int32, float ones float32
        dt = resolve_dtype(dtype) or (
            torch.int32 if all(isinstance(a, (int, np.integer))
                               for a in args) else torch.float32)
        return NDArray(torch.arange(*args, dtype=dt,
                                    device=default_device()))

    def rand(self, *shape):
        return NDArray(self._random.uniform(_shape(shape)))

    def randn(self, *shape):
        return NDArray(self._random.normal(_shape(shape)))

    def randint(self, low, high, shape):
        return NDArray(self._random.randint(low, high, tuple(shape)))

    def empty(self, dtype=None):
        return NDArray(torch.zeros((0,), dtype=self._dt(dtype),
                                   device=default_device()))

    def scalar(self, value, dtype=None):
        return NDArray(value, dtype=dtype)

    # -- combination -----------------------------------------------------
    @staticmethod
    def _all(arrays):
        ts = [as_torch(a) for a in arrays]
        dev = next((t.device for t in ts), None)
        return [t.to(dev) for t in ts]

    def concat(self, dim, *arrays):
        return NDArray(torch.cat(self._all(arrays), dim=dim))

    def vstack(self, *arrays):
        return NDArray(torch.vstack(self._all(arrays)))

    def hstack(self, *arrays):
        return NDArray(torch.hstack(self._all(arrays)))

    def stack(self, dim, *arrays):
        return NDArray(torch.stack(self._all(arrays), dim=dim))

    def pile(self, *arrays):
        return self.stack(0, *arrays)

    def tile(self, x, *reps):
        return NDArray(as_torch(x).tile(_shape(reps)))

    def repeat(self, x, repeats, axis=None):
        t = as_torch(x)
        if axis is None:
            t = t.reshape(-1)
            axis = 0
        return NDArray(torch.repeat_interleave(t, repeats, dim=axis))

    def where(self, cond, x=None, y=None):
        c = as_torch(cond)
        if x is None:
            return NDArray(torch.argwhere(c))
        return NDArray(torch.where(c, as_torch(x, device=c.device),
                                   as_torch(y, device=c.device)))

    def pad(self, x, pad_width, mode="constant", value=0.0):
        t = as_torch(x)
        pw = np.broadcast_to(np.asarray(pad_width, dtype=np.int64),
                             (t.ndim, 2))
        if mode == "constant":
            flat = [int(v) for row in pw[::-1] for v in row]
            return NDArray(F.pad(t, flat, value=value))
        # other numpy modes: on the host, then back to the array's device
        a = np.pad(np.asarray(NDArray(t)), pw, mode=mode)
        return NDArray(a, dtype=t.dtype, device=t.device)

    def sortWithIndices(self, x, dim=-1, ascending=True):
        a = as_torch(x)
        idx = torch.argsort(a, dim=dim, stable=True)
        if not ascending:
            idx = torch.flip(idx, dims=(dim,))
        return NDArray(torch.take_along_dim(a, idx, dim=dim)), NDArray(idx)

    def sort(self, x, dim=-1, ascending=True):
        a = torch.sort(as_torch(x), dim=dim, stable=True).values
        return NDArray(a if ascending else torch.flip(a, dims=(dim,)))

    def flip(self, x, *dims):
        t = as_torch(x)
        return NDArray(torch.flip(t, dims=_shape(dims) if dims
                                  else tuple(range(t.ndim))))

    def gather(self, x, indices, axis=0):
        t = as_torch(x)
        idx = as_torch(indices, device=t.device).long()
        return NDArray(torch.index_select(t, axis, idx.reshape(-1)).reshape(
            t.shape[:axis % t.ndim] + tuple(idx.shape)
            + t.shape[axis % t.ndim + 1:]))

    def oneHot(self, indices, depth, dtype=None):
        """An out-of-range index gives a zero row, as jax.nn.one_hot."""
        idx = as_torch(indices).long()
        ok = (idx >= 0) & (idx < depth)
        hot = F.one_hot(idx.clamp(0, depth - 1), int(depth)) * ok[..., None]
        return NDArray(hot.to(self._dt(dtype)))

    def diag(self, x):
        return NDArray(torch.diag(as_torch(x)))

    # -- scatter ops (≡ Nd4j scatter_upd/scatter_add/...) -----------------
    def scatterUpdate(self, ref, indices, updates):
        """ref[indices[i]] = updates[i] along dim 0; a duplicate index
        takes the LAST update (the reference's ordering)."""
        a = as_torch(ref)
        ids = as_torch(indices, device=a.device).long()
        upd = as_torch(updates, device=a.device).to(a.dtype)
        n = ids.shape[0]
        last = torch.full((a.shape[0],), -1, dtype=torch.int64,
                          device=a.device)
        last.index_reduce_(0, ids, torch.arange(n, device=a.device), "amax")
        touched = (last >= 0).reshape((-1,) + (1,) * (a.ndim - 1))
        return NDArray(torch.where(touched, upd[last.clamp(0, n - 1)], a))

    def _scatter(self, ref, indices, updates, how):
        a = as_torch(ref)
        ids = as_torch(indices, device=a.device).long()
        upd = as_torch(updates, device=a.device).to(a.dtype)
        if how == "sum":
            return NDArray(a.clone().index_add_(0, ids, upd))
        return NDArray(a.clone().index_reduce_(0, ids, upd, how,
                                               include_self=True))

    def scatterAdd(self, ref, indices, updates):
        return self._scatter(ref, indices, updates, "sum")

    def scatterSub(self, ref, indices, updates):
        return self._scatter(ref, indices, -as_torch(updates), "sum")

    def scatterMax(self, ref, indices, updates):
        return self._scatter(ref, indices, updates, "amax")

    def scatterMin(self, ref, indices, updates):
        return self._scatter(ref, indices, updates, "amin")

    # -- segment reductions (≡ nd4j segment_* / unsorted_segment_* ops) ---
    def segmentSum(self, data, segment_ids, num_segments=None):
        return NDArray(_segment(data, segment_ids, num_segments, "sum"))

    def unsortedSegmentSum(self, data, segment_ids, num_segments):
        return self.segmentSum(data, segment_ids, num_segments)

    def segmentMean(self, data, segment_ids, num_segments=None):
        tot = _segment(data, segment_ids, num_segments, "sum")
        ids = _ids(segment_ids, tot.device)
        cnt = torch.zeros(tot.shape[0], dtype=torch.float32,
                          device=tot.device).index_add_(
            0, ids, torch.ones(ids.shape, dtype=torch.float32,
                               device=tot.device))
        shape = (tot.shape[0],) + (1,) * (tot.ndim - 1)
        return NDArray(tot / torch.clamp_min(cnt, 1.0).reshape(shape))

    def unsortedSegmentMean(self, data, segment_ids, num_segments):
        return self.segmentMean(data, segment_ids, num_segments)

    def segmentMax(self, data, segment_ids, num_segments=None):
        return NDArray(_segment(data, segment_ids, num_segments, "amax"))

    def unsortedSegmentMax(self, data, segment_ids, num_segments):
        return self.segmentMax(data, segment_ids, num_segments)

    def segmentMin(self, data, segment_ids, num_segments=None):
        return NDArray(_segment(data, segment_ids, num_segments, "amin"))

    def unsortedSegmentMin(self, data, segment_ids, num_segments):
        return self.segmentMin(data, segment_ids, num_segments)

    def segmentProd(self, data, segment_ids, num_segments=None):
        return NDArray(_segment(data, segment_ids, num_segments, "prod"))

    def unsortedSegmentProd(self, data, segment_ids, num_segments):
        return self.segmentProd(data, segment_ids, num_segments)

    # -- shape utilities --------------------------------------------------
    def expandDims(self, x, dim):
        return NDArray(torch.unsqueeze(as_torch(x), int(dim)))

    def squeeze(self, x, dim=None):
        t = as_torch(x)
        return NDArray(t.squeeze() if dim is None else t.squeeze(int(dim)))

    def meshgrid(self, *xs, indexing="ij"):
        return [NDArray(g) for g in
                torch.meshgrid(*self._all(xs), indexing=indexing)]

    def triu(self, x, k=0):
        return NDArray(torch.triu(as_torch(x), int(k)))

    def tril(self, x, k=0):
        return NDArray(torch.tril(as_torch(x), int(k)))

    # -- elementwise transforms -------------------------------------------
    def _unary(self, x, fn):
        return NDArray(fn(as_torch(x)))

    def exp(self, x):
        return self._unary(x, torch.exp)

    def log(self, x):
        return self._unary(x, torch.log)

    def log1p(self, x):
        return self._unary(x, torch.log1p)

    def sqrt(self, x):
        return self._unary(x, torch.sqrt)

    def square(self, x):
        return self._unary(x, torch.square)

    def abs(self, x):
        return self._unary(x, torch.abs)

    def sign(self, x):
        return self._unary(x, torch.sign)

    def floor(self, x):
        return self._unary(x, torch.floor)

    def ceil(self, x):
        return self._unary(x, torch.ceil)

    def round(self, x):
        return self._unary(x, torch.round)   # half to even, as jnp.round

    def sin(self, x):
        return self._unary(x, torch.sin)

    def cos(self, x):
        return self._unary(x, torch.cos)

    def tan(self, x):
        return self._unary(x, torch.tan)

    def tanh(self, x):
        return self._unary(x, torch.tanh)

    def sigmoid(self, x):
        return self._unary(x, torch.sigmoid)

    def relu(self, x):
        return self._unary(x, torch.relu)

    def leakyRelu(self, x, alpha=0.01):
        return NDArray(F.leaky_relu(as_torch(x), negative_slope=alpha))

    def elu(self, x):
        return self._unary(x, F.elu)

    def softmax(self, x, axis=-1):
        return NDArray(torch.softmax(as_torch(x), dim=axis))

    def logSoftmax(self, x, axis=-1):
        return NDArray(torch.log_softmax(as_torch(x), dim=axis))

    def softplus(self, x):
        # jax.nn.softplus is logaddexp(x, 0): no linear cut-over
        return self._unary(x, lambda t: torch.logaddexp(t,
                                                        torch.zeros_like(t)))

    def pow(self, x, p):
        t = as_torch(x)
        return NDArray(torch.pow(t, p.tensor if isinstance(p, NDArray)
                                 else p))

    def clip(self, x, lo, hi):
        return NDArray(torch.clamp(as_torch(x), lo, hi))

    def isNaN(self, x):
        return self._unary(x, torch.isnan)

    def isInf(self, x):
        return self._unary(x, torch.isinf)

    def maximum(self, a, b):
        ta = as_torch(a)
        return NDArray(torch.maximum(ta, as_torch(b, device=ta.device)))

    def minimum(self, a, b):
        ta = as_torch(a)
        return NDArray(torch.minimum(ta, as_torch(b, device=ta.device)))

    def cosineSim(self, a, b):
        ta = as_torch(a).reshape(-1)
        tb = as_torch(b, device=ta.device).reshape(-1)
        return float(torch.dot(ta, tb) / (torch.linalg.norm(ta)
                                          * torch.linalg.norm(tb) + 1e-12))

    def euclideanDistance(self, a, b):
        ta = as_torch(a).reshape(-1)
        return float(torch.linalg.norm(
            ta - as_torch(b, device=ta.device).reshape(-1)))

    def manhattanDistance(self, a, b):
        ta = as_torch(a).reshape(-1)
        return float((ta - as_torch(b, device=ta.device).reshape(-1))
                     .abs().sum())

    # -- linalg ----------------------------------------------------------
    def matmul(self, a, b):
        ta = as_torch(a)
        return NDArray(torch.matmul(ta, as_torch(b, device=ta.device)))

    gemm = matmul

    def dot(self, a, b):
        return NDArray(a).dot(b)

    def norm2(self, x):
        return float(torch.linalg.norm(as_torch(x)))

    # -- host/device -----------------------------------------------------
    def toNumpy(self, x):
        return np.asarray(NDArray(x))

    def fromNumpy(self, x):
        return NDArray(x)

    # -- array file IO (npy is the interchange format) -------------------
    def write(self, arr, path_or_stream):
        a = np.asarray(NDArray(arr))
        if isinstance(path_or_stream, str):
            # np.save appends .npy to a bare string path: keep the path
            with open(path_or_stream, "wb") as f:
                np.save(f, a, allow_pickle=False)
        else:
            np.save(path_or_stream, a, allow_pickle=False)

    saveBinary = write
    writeAsNumpy = write

    def read(self, path_or_stream):
        return NDArray(np.load(path_or_stream, allow_pickle=False))

    readBinary = read
    createFromNpyFile = read

    def writeTxt(self, arr, path):
        a = np.asarray(NDArray(arr))
        with open(path, "w") as f:
            f.write(f"# shape={a.shape} dtype={a.dtype.name}\n")
            flat = a.reshape(1, 1) if a.ndim == 0 else (
                a.reshape(-1, a.shape[-1]) if a.ndim > 1 else a[None, :])
            fmt = "%d" if np.issubdtype(a.dtype, np.integer) else "%.17g"
            np.savetxt(f, flat, fmt=fmt)

    def readTxt(self, path):
        with open(path) as f:
            header = f.readline()
            shape = ast.literal_eval(
                header.split("shape=")[1].split(" dtype")[0])
            dtype = np.dtype(header.split("dtype=")[1].strip())
            body = f.read()
            if np.issubdtype(dtype, np.integer):
                try:
                    data = np.loadtxt(body.splitlines(), dtype=dtype,
                                      ndmin=2)
                except ValueError:
                    data = np.loadtxt(body.splitlines(), dtype=np.float64,
                                      ndmin=2)
            else:
                data = np.loadtxt(body.splitlines(), dtype=np.float64,
                                  ndmin=2)
        return NDArray(data.reshape(shape).astype(dtype),
                       dtype=resolve_dtype(dtype))


nd = _Nd()
