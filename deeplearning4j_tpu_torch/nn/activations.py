"""Activation catalog: the port of `deeplearning4j_tpu/nn/activations.py`
(≡ nd4j-api :: activations.Activation enum + impls).

Every name of the JAX catalog resolves to the same function on tensors.
`gelu` is the tanh approximation, as `jax.nn.gelu` defaults to it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _rationaltanh(x):
    # ND4J's ActivationRationalTanh: 1.7159 * softsign-style rational approx.
    a = torch.abs(x)
    return torch.sign(x) * 1.7159 * (1 - 1 / (1 + a + a * a + 1.41645 * a ** 4))


def _rectifiedtanh(x):
    return torch.clamp_min(torch.tanh(x), 0.0)


def _hardsigmoid(x):
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def _hardtanh(x):
    return torch.clamp(x, -1.0, 1.0)


def _cube(x):
    return x ** 3


def _mish(x):
    return x * torch.tanh(F.softplus(x))


def _thresholdedrelu(x, theta=1.0):
    return torch.where(x > theta, x, torch.zeros_like(x))


def _selu(x):
    # jax.nn.selu's constants
    alpha, scale = 1.6732632423543772, 1.0507009873554805
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


ACTIVATIONS = {
    "identity": lambda x: x,
    "linear": lambda x: x,
    "relu": torch.relu,
    "relu6": lambda x: torch.clamp(x, 0.0, 6.0),
    "leakyrelu": lambda x: F.leaky_relu(x, 0.01),
    "elu": F.elu,
    "selu": _selu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "swish": F.silu,
    "silu": F.silu,
    "mish": _mish,
    "sigmoid": torch.sigmoid,
    "hardsigmoid": _hardsigmoid,
    "tanh": torch.tanh,
    "rationaltanh": _rationaltanh,
    "rectifiedtanh": _rectifiedtanh,
    "hardtanh": _hardtanh,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "logsoftmax": lambda x: torch.log_softmax(x, dim=-1),
    "softplus": F.softplus,
    "softsign": F.softsign,
    "cube": _cube,
    "thresholdedrelu": _thresholdedrelu,
}


def get_activation(name):
    """Resolve an activation by ND4J enum name (case-insensitive) or
    callable. Parameterized spellings stay JSON-serializable strings:
    'leakyrelu:<alpha>', 'thresholdedrelu:<theta>', 'relucap:<max>'
    (relu clipped to [0, max])."""
    if callable(name):
        return name
    key = str(name).lower()
    if ":" in key:
        base, _, arg = key.partition(":")
        try:
            v = float(arg)
        except ValueError:
            raise ValueError(f"Bad activation parameter in '{name}'")
        if base == "leakyrelu":
            return lambda x: F.leaky_relu(x, v)
        if base == "thresholdedrelu":
            return lambda x: _thresholdedrelu(x, v)
        if base == "relucap":
            return lambda x: torch.clamp(x, 0.0, v)
        raise ValueError(
            f"Activation '{base}' does not take a ':{arg}' parameter")
    if key not in ACTIVATIONS:
        raise ValueError(
            f"Unknown activation '{name}'. Available: {sorted(ACTIVATIONS)}")
    return ACTIVATIONS[key]


class Activation:
    """Enum-style accessors: Activation.RELU etc. (≡ nd4j Activation enum)."""
    IDENTITY = "identity"
    RELU = "relu"
    RELU6 = "relu6"
    LEAKYRELU = "leakyrelu"
    ELU = "elu"
    SELU = "selu"
    GELU = "gelu"
    SWISH = "swish"
    MISH = "mish"
    SIGMOID = "sigmoid"
    HARDSIGMOID = "hardsigmoid"
    TANH = "tanh"
    RATIONALTANH = "rationaltanh"
    RECTIFIEDTANH = "rectifiedtanh"
    HARDTANH = "hardtanh"
    SOFTMAX = "softmax"
    SOFTPLUS = "softplus"
    SOFTSIGN = "softsign"
    CUBE = "cube"
    THRESHOLDEDRELU = "thresholdedrelu"
