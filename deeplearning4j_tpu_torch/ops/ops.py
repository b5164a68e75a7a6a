"""Transforms op catalog (≡ nd4j-api :: ops.transforms.Transforms, with
BooleanIndexing and Conditions): the port of
`deeplearning4j_tpu/ops/ops.py`.

Every function takes NDArray, numpy or torch inputs and returns NDArray
(or a python number where the reference does); the activations follow
`jax.nn`'s definitions (`gelu` is the tanh approximation, `softPlus` is
logaddexp(x, 0)).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops.factory import nd
from deeplearning4j_tpu_torch.ops.ndarray import NDArray, as_torch

__all__ = ["BooleanIndexing", "Conditions", "Transforms"]


def _u(fn):
    def wrapped(x, *args, **kw):
        return NDArray(fn(as_torch(x), *args, **kw))
    return wrapped


def _b(fn):
    def wrapped(a, b, *args, **kw):
        ta = as_torch(a)
        return NDArray(fn(ta, as_torch(b, device=ta.device), *args, **kw))
    return wrapped


class Transforms:
    """≡ ops.transforms.Transforms static methods."""

    exp = staticmethod(_u(torch.exp))
    log = staticmethod(_u(torch.log))
    log1p = staticmethod(_u(torch.log1p))
    sqrt = staticmethod(_u(torch.sqrt))
    abs = staticmethod(_u(torch.abs))
    sign = staticmethod(_u(torch.sign))
    floor = staticmethod(_u(torch.floor))
    ceil = staticmethod(_u(torch.ceil))
    round = staticmethod(_u(torch.round))
    sin = staticmethod(nd.sin)
    cos = staticmethod(nd.cos)
    tan = staticmethod(nd.tan)
    asin = staticmethod(_u(torch.asin))
    acos = staticmethod(_u(torch.acos))
    atan = staticmethod(_u(torch.atan))
    sinh = staticmethod(_u(torch.sinh))
    cosh = staticmethod(_u(torch.cosh))
    tanh = staticmethod(nd.tanh)
    atanh = staticmethod(_u(torch.atanh))
    sigmoid = staticmethod(nd.sigmoid)
    sigmoidDerivative = staticmethod(_u(
        lambda x: torch.sigmoid(x) * (1 - torch.sigmoid(x))))
    hardSigmoid = staticmethod(_u(F.hardsigmoid))
    hardTanh = staticmethod(_u(lambda x: torch.clamp(x, -1.0, 1.0)))
    relu = staticmethod(nd.relu)
    relu6 = staticmethod(_u(F.relu6))
    leakyRelu = staticmethod(nd.leakyRelu)
    elu = staticmethod(nd.elu)
    softPlus = staticmethod(nd.softplus)
    softsign = staticmethod(_u(F.softsign))
    gelu = staticmethod(_u(lambda x: F.gelu(x, approximate="tanh")))
    swish = staticmethod(_u(F.silu))
    mish = staticmethod(_u(lambda x: x * torch.tanh(
        torch.logaddexp(x, torch.zeros_like(x)))))
    erf = staticmethod(_u(torch.erf))
    rsqrt = staticmethod(_u(torch.rsqrt))
    reciprocal = staticmethod(_u(lambda x: 1.0 / x))
    square = staticmethod(_u(torch.square))
    neg = staticmethod(_u(torch.neg))

    softmax = staticmethod(nd.softmax)
    logSoftmax = staticmethod(nd.logSoftmax)
    pow = staticmethod(nd.pow)
    max = staticmethod(nd.maximum)
    min = staticmethod(nd.minimum)
    clip = staticmethod(nd.clip)

    atan2 = staticmethod(_b(torch.atan2))
    floorDiv = staticmethod(_b(torch.floor_divide))
    floorMod = staticmethod(_b(torch.remainder))   # sign follows divisor
    fmod = staticmethod(_b(torch.fmod))            # sign follows dividend

    # boolean ops over condition arrays
    and_ = staticmethod(_b(torch.logical_and))
    or_ = staticmethod(_b(torch.logical_or))
    xor = staticmethod(_b(torch.logical_xor))
    not_ = staticmethod(_u(torch.logical_not))

    @staticmethod
    def unitVec(x):
        a = as_torch(x)
        return NDArray(a / torch.clamp_min(torch.linalg.norm(a), 1e-12))

    @staticmethod
    def normalizeZeroMeanAndUnitVariance(x):
        a = as_torch(x)
        # jnp's std: the population (ddof 0) deviation
        return NDArray((a - a.mean()) / torch.clamp_min(
            a.std(correction=0), 1e-12))

    cosineSim = staticmethod(nd.cosineSim)
    euclideanDistance = staticmethod(nd.euclideanDistance)
    manhattanDistance = staticmethod(nd.manhattanDistance)

    @staticmethod
    def hammingDistance(a, b):
        ta = as_torch(a).reshape(-1)
        return float((ta != as_torch(b, device=ta.device).reshape(-1))
                     .sum())

    @staticmethod
    def allEuclideanDistances(a, b, dim=1):
        """Pairwise vector distances: dim is the FEATURE axis of the 2-D
        inputs (nd4j semantics), dim=1 compares rows, dim=0 columns."""
        ta = as_torch(a)
        tb = as_torch(b, device=ta.device)
        if dim == 0:
            ta, tb = ta.T, tb.T
        d = ((ta * ta).sum(1, keepdim=True)
             + (tb * tb).sum(1, keepdim=True).T - 2 * ta @ tb.T)
        return NDArray(torch.sqrt(torch.clamp_min(d, 0.0)))

    @staticmethod
    def dot(a, b):
        ta = as_torch(a)
        return NDArray(ta @ as_torch(b, device=ta.device))

    @staticmethod
    def cross(a, b):
        ta = as_torch(a)
        return NDArray(torch.linalg.cross(ta, as_torch(b, device=ta.device)))

    eq = staticmethod(_b(torch.eq))
    neq = staticmethod(_b(torch.ne))
    greaterThan = staticmethod(_b(torch.gt))
    lessThan = staticmethod(_b(torch.lt))
    greaterThanOrEqual = staticmethod(_b(torch.ge))
    lessThanOrEqual = staticmethod(_b(torch.le))

    @staticmethod
    def isMax(x, axis=None):
        a = as_torch(x)
        if axis is None:
            return NDArray((a == a.max()).to(a.dtype))
        return NDArray((a == a.amax(dim=axis, keepdim=True)).to(a.dtype))


class BooleanIndexing:
    """≡ org.nd4j.linalg.indexing.BooleanIndexing with Conditions."""

    @staticmethod
    def replaceWhere(arr, value, condition):
        a = as_torch(arr)
        return NDArray(torch.where(condition(a),
                                   as_torch(value, device=a.device)
                                   .to(a.dtype), a))

    @staticmethod
    def applyWhere(arr, condition, fn):
        a = as_torch(arr)
        return NDArray(torch.where(condition(a), fn(a), a))

    @staticmethod
    def countWhere(arr, condition):
        return int(condition(as_torch(arr)).sum())

    @staticmethod
    def anyWhere(arr, condition):
        return bool(condition(as_torch(arr)).any())

    @staticmethod
    def allWhere(arr, condition):
        return bool(condition(as_torch(arr)).all())


class Conditions:
    """≡ indexing.conditions.Conditions factory."""

    @staticmethod
    def greaterThan(v):
        return lambda a: a > v

    @staticmethod
    def lessThan(v):
        return lambda a: a < v

    @staticmethod
    def greaterThanOrEqual(v):
        return lambda a: a >= v

    @staticmethod
    def lessThanOrEqual(v):
        return lambda a: a <= v

    @staticmethod
    def equals(v):
        return lambda a: a == v

    @staticmethod
    def notEquals(v):
        return lambda a: a != v

    @staticmethod
    def isNan():
        return torch.isnan

    @staticmethod
    def isInfinite():
        return torch.isinf

    @staticmethod
    def absGreaterThan(v):
        return lambda a: a.abs() > v

    @staticmethod
    def absLessThan(v):
        return lambda a: a.abs() < v
