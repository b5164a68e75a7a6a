"""Hyperparameter spaces: a copy of `deeplearning4j_tpu/arbiter/spaces.py`,
which is numpy only (≡ arbiter-core :: org.deeplearning4j.arbiter.
optimize.parameter.*: ContinuousParameterSpace, DiscreteParameterSpace,
IntegerParameterSpace, FixedValue).
"""
from __future__ import annotations

import numpy as np


class ParameterSpace:
    def sample(self, rng):
        raise NotImplementedError

    def grid(self, n):
        """Discretization for grid search."""
        raise NotImplementedError


class ContinuousParameterSpace(ParameterSpace):
    def __init__(self, minValue, maxValue, log=False):
        self.lo, self.hi = float(minValue), float(maxValue)
        self.log = log
        if log and self.lo <= 0:
            raise ValueError("log-scale space needs minValue > 0")

    def sample(self, rng):
        if self.log:
            return float(np.exp(rng.uniform(np.log(self.lo),
                                            np.log(self.hi))))
        return float(rng.uniform(self.lo, self.hi))

    def grid(self, n):
        if self.log:
            return list(np.exp(np.linspace(np.log(self.lo),
                                           np.log(self.hi), n)))
        return list(np.linspace(self.lo, self.hi, n))


class IntegerParameterSpace(ParameterSpace):
    def __init__(self, minValue, maxValue):
        self.lo, self.hi = int(minValue), int(maxValue)

    def sample(self, rng):
        return int(rng.integers(self.lo, self.hi + 1))

    def grid(self, n):
        vals = np.unique(np.linspace(self.lo, self.hi, n).round().astype(int))
        return [int(v) for v in vals]


class DiscreteParameterSpace(ParameterSpace):
    def __init__(self, *values):
        if len(values) == 1 and isinstance(values[0], (list, tuple)):
            values = tuple(values[0])
        self.values = list(values)

    def sample(self, rng):
        return self.values[int(rng.integers(len(self.values)))]

    def grid(self, n):
        return list(self.values)


class FixedValue(ParameterSpace):
    def __init__(self, value):
        self.value = value

    def sample(self, rng):
        return self.value

    def grid(self, n):
        return [self.value]
