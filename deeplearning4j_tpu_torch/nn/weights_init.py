"""Weight initialization: the port of `deeplearning4j_tpu/nn/weights_init.py`
(≡ deeplearning4j-nn :: weights.WeightInit enum).

Every scheme of the JAX package, drawn from an explicit `torch.Generator`
on the CPU. The two frameworks draw different numbers from one seed, so
parity with the JAX package comes from carrying weights across
(`nn/convert.py`), not from the random bits.

fan_in/fan_out follow the reference's conventions: for a dense kernel
(nIn, nOut) fan_in=nIn; for a conv kernel (kh, kw, cin, cout) (HWIO)
fan_in = kh*kw*cin, fan_out = kh*kw*cout.
"""
from __future__ import annotations

import math

import torch


def _fans(shape):
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    rf = math.prod(shape[:-2])
    return rf * shape[-2], rf * shape[-1]


def init_weight(generator, shape, scheme="xavier", distribution=None,
                dtype=torch.float32):
    """A CPU tensor of `shape` drawn by `generator` (a CPU
    `torch.Generator`, or None for the global one) under `scheme`."""
    scheme = str(scheme).lower()
    shape = tuple(int(s) for s in shape)
    fan_in, fan_out = _fans(shape)

    def uni(limit, lo=None):
        lo = -limit if lo is None else lo
        u = torch.rand(shape, generator=generator, dtype=dtype)
        return u * (limit - lo) + lo

    def norm(std):
        return std * torch.randn(shape, generator=generator, dtype=dtype)

    if scheme == "xavier":
        return norm(math.sqrt(2.0 / (fan_in + fan_out)))
    if scheme == "xavier_uniform":
        return uni(math.sqrt(6.0 / (fan_in + fan_out)))
    if scheme in ("relu", "he", "he_normal"):
        return norm(math.sqrt(2.0 / fan_in))
    if scheme in ("relu_uniform", "he_uniform"):
        return uni(math.sqrt(6.0 / fan_in))
    if scheme in ("lecun_normal", "normal"):
        # ND4J WeightInit.NORMAL is N(0, 1/sqrt(fanIn)) == LeCun normal.
        return norm(math.sqrt(1.0 / fan_in))
    if scheme == "lecun_uniform":
        return uni(math.sqrt(3.0 / fan_in))
    if scheme == "uniform":
        return uni(math.sqrt(1.0 / fan_in))
    if scheme == "zero":
        return torch.zeros(shape, dtype=dtype)
    if scheme == "ones":
        return torch.ones(shape, dtype=dtype)
    if scheme == "constant":
        value = 0.0 if distribution is None else float(distribution)
        return torch.full(shape, value, dtype=dtype)
    if scheme == "identity":
        if len(shape) != 2 or shape[0] != shape[1]:
            raise ValueError("IDENTITY init requires a square 2-D kernel")
        return torch.eye(shape[0], dtype=dtype)
    if scheme == "distribution":
        if distribution is None:
            raise ValueError("WeightInit.DISTRIBUTION requires a distribution")
        kind = distribution.get("type", "normal")
        if kind == "normal":
            return (distribution.get("mean", 0.0)
                    + norm(distribution.get("std", 1.0)))
        if kind == "uniform":
            return uni(distribution.get("upper", 1.0),
                       distribution.get("lower", -1.0))
        raise ValueError(f"Unknown distribution type {kind}")
    if scheme in ("var_scaling_normal_fan_in",):
        return norm(math.sqrt(1.0 / fan_in))
    if scheme in ("var_scaling_normal_fan_out",):
        return norm(math.sqrt(1.0 / fan_out))
    if scheme in ("var_scaling_normal_fan_avg",):
        return norm(math.sqrt(2.0 / (fan_in + fan_out)))
    if scheme in ("var_scaling_uniform_fan_in",):
        return uni(math.sqrt(3.0 / fan_in))
    if scheme in ("var_scaling_uniform_fan_out",):
        return uni(math.sqrt(3.0 / fan_out))
    if scheme in ("var_scaling_uniform_fan_avg",):
        return uni(math.sqrt(6.0 / (fan_in + fan_out)))
    raise ValueError(f"Unknown WeightInit scheme '{scheme}'")


class WeightInit:
    XAVIER = "xavier"
    XAVIER_UNIFORM = "xavier_uniform"
    RELU = "relu"
    RELU_UNIFORM = "relu_uniform"
    LECUN_NORMAL = "lecun_normal"
    LECUN_UNIFORM = "lecun_uniform"
    NORMAL = "normal"
    UNIFORM = "uniform"
    ZERO = "zero"
    ONES = "ones"
    CONSTANT = "constant"
    IDENTITY = "identity"
    DISTRIBUTION = "distribution"
    VAR_SCALING_NORMAL_FAN_IN = "var_scaling_normal_fan_in"
    VAR_SCALING_NORMAL_FAN_OUT = "var_scaling_normal_fan_out"
    VAR_SCALING_NORMAL_FAN_AVG = "var_scaling_normal_fan_avg"
    VAR_SCALING_UNIFORM_FAN_IN = "var_scaling_uniform_fan_in"
    VAR_SCALING_UNIFORM_FAN_OUT = "var_scaling_uniform_fan_out"
    VAR_SCALING_UNIFORM_FAN_AVG = "var_scaling_uniform_fan_avg"
