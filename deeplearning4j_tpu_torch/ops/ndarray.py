"""NDArray — the INDArray-equivalent array facade: the port of
`deeplearning4j_tpu/ops/ndarray.py`.

The facade wraps a `torch.Tensor` on an explicit device. Every method
keeps the JAX package's meaning (`std`/`var` bias-corrected by default,
`sum`/`max`/... over `*dims` returning values only, `repeat(dim,
repeats)` dimension first, `transpose(*axes)` a permutation). Unlike the
JAX package, whose arrays are immutable, the in-place methods (`addi`,
`muli`, `assign`, `put`, `putScalar`, ...) write into the wrapped tensor
and return self, the reference's mutable-buffer convention: an NDArray
over a network's live parameter (`getParam`, `paramTable`) writes the
parameter.

Interop: `__torch_function__` unwraps NDArray arguments, so any torch
function takes one; `__array__`, `__float__` and `__getitem__` serve
numpy and scalar code; an attribute NDArray does not define itself is the
wrapped tensor's (`x.detach()`, `x.argmax(-1)`, `x.cpu()` return
tensors). `.tensor` is the wrapped tensor.

Where no device is given, a new array from host data lands on the
default device (`set_default_device`; None, the default, means the card,
as every entry point of the port); results of operations stay on their
operands' device.
"""
from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve

__all__ = ["NDArray", "as_torch", "default_device", "resolve_dtype",
           "set_default_device"]

_DTYPES = {
    "float": torch.float32, "float32": torch.float32,
    "double": torch.float64, "float64": torch.float64,
    "half": torch.float16, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "int": torch.int32, "int32": torch.int32,
    "long": torch.int64, "int64": torch.int64, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}

_CANONICAL = {np.dtype(np.float64): np.float32,
              np.dtype(np.int64): np.int32}

_DEFAULT_DEVICE = [None]


def set_default_device(device):
    """Where arrays made from host data land when no device is given
    (None: the card)."""
    _DEFAULT_DEVICE[0] = None if device is None else torch.device(device)


def default_device():
    return resolve(_DEFAULT_DEVICE[0])


def resolve_dtype(dtype):
    """A dtype name, numpy dtype or torch dtype as a torch dtype."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        return _DTYPES[dtype.lower()]
    return torch.from_numpy(np.zeros((), np.dtype(dtype))).dtype


def as_torch(x, device=None, dtype=None):
    """Unwrap an NDArray, or make a tensor of a python, numpy or torch
    value on `device` (default: a tensor's own device, else the default
    device)."""
    if isinstance(x, NDArray):
        x = x._t
    if torch.is_tensor(x):
        t = x if device is None else x.to(device)
    else:
        arr = np.asarray(x)
        if dtype is None and arr.dtype in _CANONICAL:
            # host data takes the JAX package's default (32-bit) types
            arr = arr.astype(_CANONICAL[arr.dtype])
        t = torch.as_tensor(arr, device=device or default_device())
    return t if dtype is None else t.to(resolve_dtype(dtype))


def _wrap(t):
    return NDArray(t)


def _axis(dims):
    if not dims:
        return None
    return dims[0] if len(dims) == 1 else tuple(dims)


def _reduce(fn, t, dims, keepdims):
    axis = _axis(dims)
    if axis is None:
        out = fn(t)
        if keepdims:
            out = out.reshape((1,) * t.ndim)
        return out
    return fn(t, dim=axis, keepdim=keepdims)


def _amax(t, dim=None, keepdim=False):
    return t.amax() if dim is None else t.amax(dim=dim, keepdim=keepdim)


def _amin(t, dim=None, keepdim=False):
    return t.amin() if dim is None else t.amin(dim=dim, keepdim=keepdim)


class NDArray:
    """N-dimensional array with the INDArray calling convention."""

    __slots__ = ("_t",)
    # numpy's reflected operators defer to ours
    __array_priority__ = 100

    def __init__(self, value, dtype=None, device=None):
        self._t = as_torch(value, device=device, dtype=dtype)

    # -- interop ---------------------------------------------------------
    @property
    def tensor(self):
        """The wrapped torch.Tensor."""
        return self._t

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        def unwrap(v):
            if isinstance(v, NDArray):
                return v._t
            if isinstance(v, (list, tuple)):
                return type(v)(unwrap(x) for x in v)
            return v
        return func(*unwrap(args), **{k: unwrap(v)
                                      for k, v in (kwargs or {}).items()})

    def __getattr__(self, name):
        # only reached for names NDArray does not define
        if name.startswith("__"):
            raise AttributeError(name)
        return getattr(self._t, name)

    # torch.as_tensor(x) and other array consumers read these, not
    # __torch_function__: a zero-copy view of the wrapped tensor
    @property
    def __cuda_array_interface__(self):
        return self._t.__cuda_array_interface__

    def __dlpack__(self, *args, **kwargs):
        return self._t.detach().__dlpack__(*args, **kwargs)

    def __dlpack_device__(self):
        return self._t.__dlpack_device__()

    def numpy(self):
        return self._t.detach().cpu().numpy()

    def toDoubleVector(self):
        return self.numpy().astype(np.float64).ravel()

    def toFloatVector(self):
        return self.numpy().astype(np.float32).ravel()

    def toIntVector(self):
        return self.numpy().astype(np.int64).ravel()

    def __array__(self, dtype=None, copy=None):
        a = self._t.detach()
        a = (a.float() if a.dtype == torch.bfloat16 else a).cpu().numpy()
        return a.astype(dtype) if dtype is not None else a

    # -- shape / dtype ---------------------------------------------------
    @property
    def shape(self):
        return tuple(self._t.shape)

    @property
    def dtype(self):
        return self._t.dtype

    @property
    def device(self):
        return self._t.device

    def rank(self):
        return self._t.ndim

    def length(self):
        return int(self._t.numel()) if self._t.ndim else 1

    def size(self, dim=None):
        """≡ INDArray.size(dim); without a dim, the shape (torch's)."""
        return self._t.size() if dim is None else self._t.shape[dim]

    def isScalar(self):
        return self._t.ndim == 0 or self.length() == 1

    def isVector(self):
        return self._t.ndim == 1 or (self._t.ndim == 2
                                     and 1 in self._t.shape)

    def isMatrix(self):
        return self._t.ndim == 2

    def rows(self):
        return self._t.shape[0]

    def columns(self):
        return self._t.shape[1]

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return _wrap(self._t.reshape(shape))

    def ravel(self):
        return _wrap(self._t.reshape(-1))

    def transpose(self, *axes):
        """No axes: all axes reversed (numpy's .T); else a permutation."""
        if not axes:
            return _wrap(self._t.permute(*reversed(range(self._t.ndim))))
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return _wrap(self._t.permute(*axes))

    def permute(self, *axes):
        return self.transpose(*axes)

    def swapAxes(self, a, b):
        return _wrap(self._t.transpose(a, b))

    def broadcast(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return _wrap(self._t.broadcast_to(shape))

    def dup(self):
        return _wrap(self._t.clone())

    def castTo(self, dtype):
        return _wrap(self._t.to(resolve_dtype(dtype)))

    def astype(self, dtype):
        return self.castTo(dtype)

    # -- elementwise arithmetic (returning copies) -----------------------
    def _other(self, other):
        return as_torch(other, device=self._t.device)

    def _binary(self, other, fn):
        return _wrap(fn(self._t, self._other(other)))

    def add(self, other):
        return self._binary(other, torch.add)

    def sub(self, other):
        return self._binary(other, torch.sub)

    def mul(self, other):
        return self._binary(other, torch.mul)

    def div(self, other):
        return self._binary(other, torch.true_divide)

    def rsub(self, other):
        return _wrap(self._other(other) - self._t)

    def rdiv(self, other):
        return _wrap(self._other(other) / self._t)

    def neg(self):
        return _wrap(-self._t)

    # -- in-place variants: write into the tensor and return self --------
    def _inplace(self, other, fn):
        with torch.no_grad():
            self._t.copy_(fn(self._t, self._other(other)))
        return self

    def addi(self, other):
        return self._inplace(other, torch.add)

    def subi(self, other):
        return self._inplace(other, torch.sub)

    def muli(self, other):
        return self._inplace(other, torch.mul)

    def divi(self, other):
        return self._inplace(other, torch.true_divide)

    def assign(self, other):
        with torch.no_grad():
            self._t.copy_(self._other(other).broadcast_to(self._t.shape))
        return self

    def negi(self):
        with torch.no_grad():
            self._t.neg_()
        return self

    # -- linalg ----------------------------------------------------------
    def mmul(self, other):
        return _wrap(torch.matmul(self._t, self._other(other)))

    def dot(self, other):
        o = self._other(other)
        if self._t.ndim == 1 and o.ndim == 1:
            return _wrap(torch.dot(self._t, o))
        return _wrap(torch.matmul(self._t, o))

    def tensorMmul(self, other, axes):
        return _wrap(torch.tensordot(self._t, self._other(other), dims=axes))

    # -- broadcast along a dimension (ND4J row/column ops) ---------------
    def _row(self, v):
        return self._other(v).reshape(1, -1)

    def _col(self, v):
        return self._other(v).reshape(-1, 1)

    def addRowVector(self, row):
        return _wrap(self._t + self._row(row))

    def addColumnVector(self, col):
        return _wrap(self._t + self._col(col))

    def subRowVector(self, row):
        return _wrap(self._t - self._row(row))

    def subColumnVector(self, col):
        return _wrap(self._t - self._col(col))

    def mulRowVector(self, row):
        return _wrap(self._t * self._row(row))

    def mulColumnVector(self, col):
        return _wrap(self._t * self._col(col))

    def divRowVector(self, row):
        return _wrap(self._t / self._row(row))

    def divColumnVector(self, col):
        return _wrap(self._t / self._col(col))

    # -- reductions ------------------------------------------------------
    def sum(self, *dims, keepdims=False):
        return _wrap(_reduce(torch.sum, self._t, dims, keepdims))

    def mean(self, *dims, keepdims=False):
        return _wrap(_reduce(torch.mean, self._t, dims, keepdims))

    def max(self, *dims, keepdims=False):
        return _wrap(_reduce(_amax, self._t, dims, keepdims))

    def min(self, *dims, keepdims=False):
        return _wrap(_reduce(_amin, self._t, dims, keepdims))

    def prod(self, *dims, keepdims=False):
        axis = _axis(dims)
        t = self._t
        if isinstance(axis, tuple):
            for d in sorted((a % t.ndim for a in axis), reverse=True):
                t = t.prod(dim=d, keepdim=keepdims)
            return _wrap(t)
        return _wrap(_reduce(torch.prod, t, dims, keepdims))

    def std(self, *dims, biasCorrected=True, keepdims=False):
        return _wrap(torch.std(self._t, dim=_axis(dims),
                               correction=1 if biasCorrected else 0,
                               keepdim=keepdims))

    def var(self, *dims, biasCorrected=True, keepdims=False):
        return _wrap(torch.var(self._t, dim=_axis(dims),
                               correction=1 if biasCorrected else 0,
                               keepdim=keepdims))

    def argMax(self, *dims):
        return _wrap(torch.argmax(self._t, dim=dims[0] if dims else None))

    def argMin(self, *dims):
        return _wrap(torch.argmin(self._t, dim=dims[0] if dims else None))

    def norm1(self, *dims):
        return _wrap(_reduce(torch.sum, self._t.abs(), dims, False))

    def norm2(self, *dims):
        return _wrap(_reduce(torch.sum, self._t * self._t, dims,
                             False).sqrt())

    def normmax(self, *dims):
        return _wrap(_reduce(_amax, self._t.abs(), dims, False))

    def cumsum(self, dim=0):
        return _wrap(torch.cumsum(self._t, dim=dim))

    def cumprod(self, dim=0):
        return _wrap(torch.cumprod(self._t, dim=dim))

    # -- absolute-value reductions (≡ INDArray.amax/amin/amean/asum) ------
    def amax(self, *dims, keepdims=False):
        return _wrap(_reduce(_amax, self._t.abs(), dims, keepdims))

    def amin(self, *dims, keepdims=False):
        return _wrap(_reduce(_amin, self._t.abs(), dims, keepdims))

    def amean(self, *dims, keepdims=False):
        return _wrap(_reduce(torch.mean, self._t.abs(), dims, keepdims))

    def asum(self, *dims, keepdims=False):
        return _wrap(_reduce(torch.sum, self._t.abs(), dims, keepdims))

    # -- entropy reductions, over the array as a probability surface -----
    def entropy(self, *dims):
        return _wrap(-_reduce(torch.sum, self._t * torch.log(self._t),
                              dims, False))

    def shannonEntropy(self, *dims):
        return _wrap(-_reduce(torch.sum, self._t * torch.log2(self._t),
                              dims, False))

    def logEntropy(self, *dims):
        return _wrap(torch.log(self.entropy(*dims)._t))

    # -- views (≡ INDArray.slice / tensorAlongDimension / repeat / tile) --
    def slice(self, i, dim=0):
        """The i-th subtensor along `dim` (≡ INDArray.slice)."""
        return _wrap(self._t.select(int(dim), int(i)))

    def tensorAlongDimension(self, index, *dims):
        """The index-th tensor when iterating over every dim NOT in
        `dims`, in C order (≡ INDArray.tensorAlongDimension)."""
        nd = self._t.ndim
        dims = sorted(d % nd for d in dims)
        iter_dims = [d for d in range(nd) if d not in dims]
        moved = self._t.permute(*(iter_dims + dims))
        lead = 1
        for d in iter_dims:
            lead *= self._t.shape[d]
        moved = moved.reshape((lead,) + tuple(self._t.shape[d]
                                              for d in dims))
        return _wrap(moved[int(index)])

    def tensorsAlongDimension(self, *dims):
        """The count of TADs for `dims`."""
        dims = {d % self._t.ndim for d in dims}
        n = 1
        for d in range(self._t.ndim):
            if d not in dims:
                n *= self._t.shape[d]
        return n

    def repeat(self, dim, repeats):
        """≡ INDArray.repeat(dimension, repeatTimes): dimension first."""
        return _wrap(torch.repeat_interleave(self._t, int(repeats),
                                             dim=int(dim)))

    def tile(self, *reps):
        return _wrap(self._t.tile(reps))

    def diag(self):
        return _wrap(torch.diag(self._t))

    # -- comparisons -----------------------------------------------------
    def gt(self, other):
        return self._binary(other, torch.gt)

    def gte(self, other):
        return self._binary(other, torch.ge)

    def lt(self, other):
        return self._binary(other, torch.lt)

    def lte(self, other):
        return self._binary(other, torch.le)

    def eq(self, other):
        return self._binary(other, torch.eq)

    def neq(self, other):
        return self._binary(other, torch.ne)

    def equalsWithEps(self, other, eps=1e-5):
        b = self._other(other)
        return (tuple(self._t.shape) == tuple(b.shape)
                and bool(((self._t - b).abs() <= eps).all()))

    def equals(self, other):
        return self.equalsWithEps(other, 1e-5)

    # -- indexing --------------------------------------------------------
    @staticmethod
    def _index(idx):
        if isinstance(idx, NDArray):
            return idx._t
        if isinstance(idx, tuple):
            return tuple(i._t if isinstance(i, NDArray) else i for i in idx)
        return idx

    def __getitem__(self, idx):
        return _wrap(self._t[self._index(idx)])

    def get(self, *idx):
        return self.__getitem__(tuple(idx))

    def getScalar(self, *idx):
        return _wrap(self._t[tuple(int(i) for i in idx)])

    def getDouble(self, *idx):
        return float(self._t[tuple(int(i) for i in idx)])

    def getInt(self, *idx):
        return int(self._t[tuple(int(i) for i in idx)])

    def getRow(self, i):
        return _wrap(self._t[i])

    def getColumn(self, i):
        return _wrap(self._t[:, i])

    def getRows(self, *rows):
        return _wrap(self._t[torch.as_tensor(rows, device=self._t.device)])

    def getColumns(self, *cols):
        return _wrap(self._t[:, torch.as_tensor(cols,
                                                device=self._t.device)])

    def put(self, idx, value):
        if isinstance(idx, list):
            idx = tuple(idx)
        with torch.no_grad():
            self._t[self._index(idx)] = self._other(value).to(self._t.dtype)
        return self

    def putScalar(self, idx, value):
        if isinstance(idx, (tuple, list)):
            idx = tuple(int(i) for i in idx)
        with torch.no_grad():
            self._t[idx] = value
        return self

    def putRow(self, i, row):
        return self.put(i, row)

    def putColumn(self, i, col):
        with torch.no_grad():
            self._t[:, i] = self._other(col).to(self._t.dtype)
        return self

    def __setitem__(self, idx, value):
        self.put(idx, value)

    # -- python protocol -------------------------------------------------
    def __add__(self, other):
        return self.add(other)

    __radd__ = __add__

    def __sub__(self, other):
        return self.sub(other)

    def __rsub__(self, other):
        return self.rsub(other)

    def __mul__(self, other):
        return self.mul(other)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self.div(other)

    def __rtruediv__(self, other):
        return self.rdiv(other)

    def __matmul__(self, other):
        return self.mmul(other)

    def __neg__(self):
        return self.neg()

    def __pow__(self, p):
        return _wrap(self._t ** (p._t if isinstance(p, NDArray) else p))

    def __abs__(self):
        return _wrap(self._t.abs())

    def __lt__(self, other):
        return self.lt(other)

    def __le__(self, other):
        return self.lte(other)

    def __gt__(self, other):
        return self.gt(other)

    def __ge__(self, other):
        return self.gte(other)

    def __len__(self):
        return self._t.shape[0]

    def __iter__(self):
        return (_wrap(t) for t in self._t)

    def __float__(self):
        return float(self._t)

    def __int__(self):
        return int(self._t)

    def __bool__(self):
        return bool(self._t)

    def __repr__(self):
        return f"NDArray{self.shape}{np.asarray(self)!r}"

    def __str__(self):
        return str(np.asarray(self))
