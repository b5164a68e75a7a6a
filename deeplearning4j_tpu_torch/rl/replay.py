"""Experience replay (≡ rl4j-core :: learning.sync.ExpReplay /
Transition): a copy of `deeplearning4j_tpu/rl/replay.py`. A
fixed-capacity ring buffer with uniform minibatch sampling into
fixed-shape numpy batches (one batch signature, so the card replays one
CUDA graph of the Q-network's fit step)."""
from __future__ import annotations

import numpy as np


class Transition:
    __slots__ = ("obs", "action", "reward", "next_obs", "done")

    def __init__(self, obs, action, reward, next_obs, done):
        self.obs = obs
        self.action = action
        self.reward = reward
        self.next_obs = next_obs
        self.done = done


class ExpReplay:
    def __init__(self, max_size=150000, batch_size=32, seed=0):
        self.max_size = int(max_size)
        self.batch_size = int(batch_size)
        self._rng = np.random.default_rng(seed)
        self._buf = []
        self._pos = 0

    def store(self, transition):
        if len(self._buf) < self.max_size:
            self._buf.append(transition)
        else:
            self._buf[self._pos] = transition
        self._pos = (self._pos + 1) % self.max_size

    def __len__(self):
        return len(self._buf)

    def getBatch(self, batch_size=None):
        """Uniform sample → (obs, actions, rewards, next_obs, dones)."""
        bs = batch_size or self.batch_size
        idx = self._rng.integers(len(self._buf), size=bs)
        trans = [self._buf[i] for i in idx]
        return (np.stack([t.obs for t in trans]).astype(np.float32),
                np.asarray([t.action for t in trans], np.int32),
                np.asarray([t.reward for t in trans], np.float32),
                np.stack([t.next_obs for t in trans]).astype(np.float32),
                np.asarray([t.done for t in trans], np.float32))
