"""Learning-rate schedules: the port of `deeplearning4j_tpu/nn/schedules.py`
(≡ nd4j-api :: schedule.ISchedule: StepSchedule, ExponentialSchedule,
InverseSchedule, PolySchedule, SigmoidSchedule, MapSchedule,
CycleSchedule).

A schedule maps the optimizer's iteration count to a rate. It is called
with the count as a tensor on the parameters' device and answers with an
f32 tensor there, computed by tensor operations alone (no value read on
the host, no tensor made from host data), so a CUDA graph of a training
step that holds it reads the live count at each replay. The formulas are
the JAX package's, in f32 as JAX computes them from its int32 count.
Any updater's `learningRate` accepts a schedule, as it accepts a number.
"""
from __future__ import annotations

import torch

__all__ = ["Schedule", "FixedSchedule", "StepSchedule",
           "ExponentialSchedule", "InverseSchedule", "PolySchedule",
           "SigmoidSchedule", "MapSchedule", "CycleSchedule", "as_schedule"]


def _f32(step):
    if not torch.is_tensor(step):
        step = torch.tensor(step)
    return step.to(torch.float32)


class Schedule:
    def __call__(self, step):
        raise NotImplementedError

    def value(self, step):
        """The rate at iteration `step` (a number), on the host."""
        return float(self(torch.tensor(int(step), dtype=torch.int32)))


class FixedSchedule(Schedule):
    def __init__(self, value):
        self.v = float(value)

    def __call__(self, step):
        return torch.full_like(_f32(step), self.v)


class StepSchedule(Schedule):
    """lr = init * decayRate^floor(iter/step)"""

    def __init__(self, initial_value, decay_rate, step):
        self.init, self.rate = float(initial_value), float(decay_rate)
        self.step = float(step)

    def __call__(self, step):
        return self.init * torch.pow(self.rate,
                                     torch.floor(_f32(step) / self.step))


class ExponentialSchedule(Schedule):
    """lr = init * gamma^iter"""

    def __init__(self, initial_value, gamma):
        self.init, self.gamma = float(initial_value), float(gamma)

    def __call__(self, step):
        return self.init * torch.pow(self.gamma, _f32(step))


class InverseSchedule(Schedule):
    """lr = init / (1 + gamma*iter)^power"""

    def __init__(self, initial_value, gamma, power):
        self.init, self.gamma = float(initial_value), float(gamma)
        self.power = float(power)

    def __call__(self, step):
        return self.init / torch.pow(1.0 + self.gamma * _f32(step),
                                     self.power)


class PolySchedule(Schedule):
    """lr = init * (1 - iter/maxIter)^power"""

    def __init__(self, initial_value, power, max_iter):
        self.init, self.power = float(initial_value), float(power)
        self.max_iter = float(max_iter)

    def __call__(self, step):
        frac = torch.clamp(_f32(step) / self.max_iter, 0.0, 1.0)
        return self.init * torch.pow(1.0 - frac, self.power)


class SigmoidSchedule(Schedule):
    """lr = init / (1 + exp(gamma*(iter-stepSize)))"""

    def __init__(self, initial_value, gamma, step_size):
        self.init, self.gamma = float(initial_value), float(gamma)
        self.step_size = float(step_size)

    def __call__(self, step):
        return self.init / (1.0 + torch.exp(
            self.gamma * (_f32(step) - self.step_size)))


class MapSchedule(Schedule):
    """Piecewise-constant mapping iteration -> lr: the value of the largest
    boundary at or below the iteration."""

    def __init__(self, values: dict):
        items = sorted((int(k), float(v)) for k, v in values.items())
        if not items or items[0][0] != 0:
            raise ValueError("MapSchedule requires a value for iteration 0")
        self.items = items

    def __call__(self, step):
        s = _f32(step)
        out = torch.full_like(s, self.items[0][1])
        for boundary, v in self.items[1:]:
            out = torch.where(s >= boundary, torch.full_like(s, v), out)
        return out


class CycleSchedule(Schedule):
    """1cycle: ramp up to max then down, with a final annealing phase."""

    def __init__(self, initial_value, max_value, cycle_length,
                 annealing_length=None, annealing_decay=0.1):
        self.init, self.max = float(initial_value), float(max_value)
        self.cycle = float(cycle_length)
        self.ann_len = float(annealing_length if annealing_length is not None
                             else 0.1 * cycle_length)
        self.ann_decay = float(annealing_decay)

    def __call__(self, step):
        up = self.cycle / 2.0
        pos = _f32(step)
        ramp_up = self.init + (self.max - self.init) * (pos / up)
        ramp_dn = self.max - (self.max - self.init) * ((pos - up) / up)
        ann = self.init * (self.ann_decay + (1 - self.ann_decay) * torch.clamp(
            1 - (pos - self.cycle) / max(self.ann_len, 1.0), 0, 1))
        return torch.where(pos < up, ramp_up,
                           torch.where(pos < self.cycle, ramp_dn, ann))


def as_schedule(value):
    """A schedule or a callable of the count as it is; a number as a
    FixedSchedule."""
    if isinstance(value, Schedule) or callable(value):
        return value
    return FixedSchedule(value)
