"""MDP environments (≡ rl4j-core :: org.deeplearning4j.rl4j.mdp.MDP,
CartpoleNative, toy MDPs): a copy of `deeplearning4j_tpu/rl/mdp.py`.

Native Python/numpy physics — environments are host-side by nature; only
the learner's network steps run on the card. The seeded trajectories are
the JAX package's bit for bit.
"""
from __future__ import annotations

import numpy as np


class ObservationSpace:
    def __init__(self, shape, low=None, high=None):
        self.shape = tuple(shape)
        self.low, self.high = low, high


class DiscreteSpace:
    def __init__(self, size):
        self.size = int(size)

    def getSize(self):
        return self.size

    def randomAction(self, rng):
        return int(rng.integers(self.size))


class MDP:
    """≡ rl4j MDP interface: reset / step / isDone / close."""

    def getObservationSpace(self):
        return self.observation_space

    def getActionSpace(self):
        return self.action_space

    def reset(self):
        raise NotImplementedError

    def step(self, action):
        """-> (observation, reward, done, info)"""
        raise NotImplementedError

    def isDone(self):
        return self.done

    def close(self):
        pass

    def newInstance(self):
        return type(self)()


class CartpoleNative(MDP):
    """≡ rl4j :: mdp.CartpoleNative — classic cart-pole balance physics
    (4-dim state, 2 actions, +1 reward per step, 200-step cap)."""

    GRAVITY = 9.8
    MASSCART = 1.0
    MASSPOLE = 0.1
    LENGTH = 0.5          # half pole length
    FORCE_MAG = 10.0
    TAU = 0.02
    THETA_THRESHOLD = 12 * 2 * np.pi / 360
    X_THRESHOLD = 2.4
    MAX_STEPS = 200

    def __init__(self, seed=0):
        self.observation_space = ObservationSpace((4,))
        self.action_space = DiscreteSpace(2)
        self._rng = np.random.default_rng(seed)
        self.done = True
        self.state = None
        self._steps = 0

    def reset(self):
        self.state = self._rng.uniform(-0.05, 0.05, size=4)
        self.done = False
        self._steps = 0
        return self.state.astype(np.float32)

    def step(self, action):
        x, x_dot, theta, theta_dot = self.state
        force = self.FORCE_MAG if action == 1 else -self.FORCE_MAG
        total_mass = self.MASSCART + self.MASSPOLE
        polemass_length = self.MASSPOLE * self.LENGTH
        costheta, sintheta = np.cos(theta), np.sin(theta)
        temp = (force + polemass_length * theta_dot ** 2 * sintheta
                ) / total_mass
        theta_acc = (self.GRAVITY * sintheta - costheta * temp) / (
            self.LENGTH * (4.0 / 3.0
                           - self.MASSPOLE * costheta ** 2 / total_mass))
        x_acc = temp - polemass_length * theta_acc * costheta / total_mass
        x += self.TAU * x_dot
        x_dot += self.TAU * x_acc
        theta += self.TAU * theta_dot
        theta_dot += self.TAU * theta_acc
        self.state = np.array([x, x_dot, theta, theta_dot])
        self._steps += 1
        self.done = bool(
            abs(x) > self.X_THRESHOLD
            or abs(theta) > self.THETA_THRESHOLD
            or self._steps >= self.MAX_STEPS)
        return self.state.astype(np.float32), 1.0, self.done, {}


class SimpleToy(MDP):
    """≡ rl4j :: mdp.toy.SimpleToy — a chain of N states where action 1
    advances (+1 reward at the end), action 0 resets. Optimal policy:
    always act 1. Deterministic → convergence is testable exactly."""

    def __init__(self, length=5):
        self.length = int(length)
        self.observation_space = ObservationSpace((self.length,))
        self.action_space = DiscreteSpace(2)
        self.done = True
        self.pos = 0

    def _obs(self):
        v = np.zeros(self.length, np.float32)
        v[self.pos] = 1.0
        return v

    def reset(self):
        self.pos = 0
        self.done = False
        return self._obs()

    def step(self, action):
        if action == 1:
            self.pos += 1
            reward = 0.1
        else:
            self.pos = 0
            reward = 0.0
        if self.pos >= self.length - 1:
            reward = 1.0
            self.done = True
            self.pos = self.length - 1
        return self._obs(), reward, self.done, {}


class PixelGridWorld(MDP):
    """Synthetic PIXEL MDP for the conv-DQN path (stands in for the
    reference's ALE screens, zero egress): the agent is a bright square
    on a 1-D track rendered as a (size·scale, size·scale) grayscale
    frame. Every move costs −0.01; reaching the right edge pays +1.0 and
    ends the episode. Optimal policy: always go right, as fast as
    possible — learnable ONLY from the pixels."""

    def __init__(self, size=6, scale=2, maxSteps=40, seed=0):
        self.size = int(size)
        self.scale = int(scale)
        self.maxSteps = int(maxSteps)
        px = self.size * self.scale
        self.observation_space = ObservationSpace((px, px))
        self.action_space = DiscreteSpace(2)
        self._rng = np.random.default_rng(seed)
        self.done = True
        self.pos = 0
        self._steps = 0

    def _frame(self):
        f = np.zeros((self.size, self.size), np.float32)
        f[self.size // 2, self.pos] = 1.0
        return np.kron(f, np.ones((self.scale, self.scale), np.float32))

    def reset(self):
        self.pos = 0
        self.done = False
        self._steps = 0
        return self._frame()

    def step(self, action):
        self._steps += 1
        reward = -0.01
        if action == 1:
            self.pos = min(self.pos + 1, self.size - 1)
        else:
            self.pos = max(self.pos - 1, 0)
        if self.pos >= self.size - 1:
            reward = 1.0
            self.done = True
        if self._steps >= self.maxSteps:
            self.done = True
        return self._frame(), reward, self.done, {}
