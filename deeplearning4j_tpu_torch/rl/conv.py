"""Pixel-input DQN (≡ rl4j-core :: learning.HistoryProcessor,
network.dqn.DQNFactoryStdConv, learning.sync.qlearning.discrete.
QLearningDiscreteConv): the port of `deeplearning4j_tpu/rl/conv.py`.

The reference's Atari recipe: raw frames → grayscale → crop → downscale →
stack the last `historyLength` frames as the Q-net input, choose an
action every `skipFrame` frames (repeating it in between, summing the
reward). Frame munging is host numpy by nature (frames come from the env
on the host) and is the JAX package's code, so a processed history is
its bit for bit. The Q-network is the port's NHWC MultiLayerNetwork with
the history stack as the CHANNEL axis (`InputType.convolutional(h, w,
history)`), as in the JAX package."""
from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.nn.conf.builders import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (ConvolutionLayer,
                                                     DenseLayer, OutputLayer)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.rl.dqn import (DQNPolicy,
                                             QLearningConfiguration,
                                             _SyncDQN)
from deeplearning4j_tpu_torch.rl.replay import Transition


class HistoryProcessorConfiguration:
    """≡ learning.HistoryProcessor.Configuration."""

    def __init__(self, historyLength=4, rescaledWidth=84, rescaledHeight=84,
                 croppingWidth=None, croppingHeight=None, offsetX=0,
                 offsetY=0, skipFrame=4):
        self.historyLength = int(historyLength)
        self.rescaledWidth = int(rescaledWidth)
        self.rescaledHeight = int(rescaledHeight)
        self.croppingWidth = croppingWidth    # None = full width
        self.croppingHeight = croppingHeight
        self.offsetX = int(offsetX)
        self.offsetY = int(offsetY)
        self.skipFrame = int(skipFrame)


def _nearest_resize(img, out_h, out_w):
    """Dependency-free nearest-neighbor resize (deterministic)."""
    h, w = img.shape[:2]
    if (h, w) == (out_h, out_w):
        return img
    ri = (np.arange(out_h) * h // out_h).clip(0, h - 1)
    ci = (np.arange(out_w) * w // out_w).clip(0, w - 1)
    return img[ri][:, ci]


class HistoryProcessor:
    """≡ learning.HistoryProcessor — grayscale + crop + rescale + ring of
    the last `historyLength` processed frames."""

    def __init__(self, conf: HistoryProcessorConfiguration):
        self.conf = conf
        self._ring = None

    def preProcess(self, frame):
        """(H, W) | (H, W, C) uint8/float → (rh, rw) float32 in [0, 1]."""
        f = np.asarray(frame)
        if f.ndim == 3:                      # RGB → luminance
            f = f.astype(np.float32) @ np.array([0.299, 0.587, 0.114],
                                                np.float32)
        was_int = np.issubdtype(np.asarray(frame).dtype, np.integer)
        f = f.astype(np.float32)
        if was_int:
            # dtype-based, NOT value-based: a near-black uint8 frame must
            # get the same scale as a bright one
            f = f / 255.0
        c = self.conf
        ch = c.croppingHeight or (f.shape[0] - c.offsetY)
        cw = c.croppingWidth or (f.shape[1] - c.offsetX)
        f = f[c.offsetY:c.offsetY + ch, c.offsetX:c.offsetX + cw]
        return _nearest_resize(f, c.rescaledHeight, c.rescaledWidth)

    def record(self, frame):
        """Process a frame and push it into the history ring."""
        f = self.preProcess(frame)
        if self._ring is None:
            # cold start: fill the whole ring with the first frame so
            # getHistory() is valid from step 0 (≡ reference startMonitor)
            self._ring = [f] * self.conf.historyLength
        else:
            self._ring = self._ring[1:] + [f]

    add = record

    def getHistory(self):
        """(rescaledH, rescaledW, historyLength) float32 — NHWC-ready,
        newest frame in the LAST channel."""
        if self._ring is None:
            raise RuntimeError("HistoryProcessor: record() a frame first")
        return np.stack(self._ring, axis=-1)

    def reset(self):
        self._ring = None


class DQNConvNetworkConfiguration:
    """≡ network.configuration.NetworkConfiguration for the conv factory
    (filter/kernel/stride stacks are configurable so small test MDPs
    don't pay Atari-sized convs). The defaults are Mnih et al. 2013's
    network: 16 filters 8×8/4, 32 filters 4×4/2, 256 dense units."""

    def __init__(self, learningRate=2.5e-4, l2=0.0, updater=None,
                 filters=(16, 32), kernels=((8, 8), (4, 4)),
                 strides=((4, 4), (2, 2)), denseUnits=256):
        self.learningRate = learningRate
        self.l2 = l2
        self.updater = updater
        self.filters = tuple(filters)
        self.kernels = tuple(tuple(k) for k in kernels)
        self.strides = tuple(tuple(s) for s in strides)
        self.denseUnits = int(denseUnits)


class DQNFactoryStdConv:
    """≡ network.dqn.DQNFactoryStdConv — Atari-style conv Q-network."""

    def __init__(self, conf: DQNConvNetworkConfiguration = None):
        self.conf = conf or DQNConvNetworkConfiguration()

    def buildDQN(self, shape_hwc, num_actions, seed=123, device=None):
        c = self.conf
        h, w, ch = shape_hwc
        b = (NeuralNetConfiguration.Builder()
             .seed(seed)
             .updater(c.updater or Adam(c.learningRate))
             .weightInit("relu")
             .l2(c.l2)
             .list())
        for f, k, s in zip(c.filters, c.kernels, c.strides):
            b.layer(ConvolutionLayer(kernelSize=k, stride=s, nOut=f,
                                     convolutionMode="truncate",
                                     activation="relu"))
        b.layer(DenseLayer(nOut=c.denseUnits, activation="relu"))
        b.layer(OutputLayer(lossFunction="mse", nOut=num_actions,
                            activation="identity"))
        return MultiLayerNetwork(
            b.setInputType(InputType.convolutional(h, w, ch))
            .build()).init(device)


class QLearningDiscreteConv(_SyncDQN):
    """≡ QLearningDiscreteConv — sync (double-)DQN over a pixel MDP:
    HistoryProcessor frame pipeline + conv Q-net + frame-skip action
    repeat. Same TD machinery as QLearningDiscreteDense; observations in
    replay are the PROCESSED (h, w, history) stacks."""

    def __init__(self, mdp, net_factory=None, hp_conf=None, ql_conf=None,
                 device=None):
        self.mdp = mdp
        self.conf = ql_conf or QLearningConfiguration()
        self.hp = HistoryProcessor(hp_conf or
                                   HistoryProcessorConfiguration())
        if net_factory is None or isinstance(net_factory,
                                             DQNConvNetworkConfiguration):
            net_factory = DQNFactoryStdConv(net_factory)
        hc = self.hp.conf
        shape = (hc.rescaledHeight, hc.rescaledWidth, hc.historyLength)
        self.num_actions = mdp.getActionSpace().getSize()
        self.net = net_factory.buildDQN(shape, self.num_actions,
                                        self.conf.seed, device)
        self._init_loop()

    def getPolicy(self):
        return _ConvDQNPolicy(self.net, self.hp)

    def getHistoryProcessor(self):
        return self.hp

    def train(self):
        c = self.conf
        skip = max(1, self.hp.conf.skipFrame)
        while self.step_count < c.maxStep:
            frame = self.mdp.reset()
            self.hp.reset()
            self.hp.record(frame)
            obs = self.hp.getHistory()
            ep_reward, ep_steps = 0.0, 0
            while not self.mdp.isDone() and ep_steps < c.maxEpochStep \
                    and self.step_count < c.maxStep:
                action = self.policy.nextAction(
                    self._greedy_q(obs), self.mdp.getActionSpace())
                # frame-skip: repeat the action, accumulate reward
                reward = 0.0
                done = False
                for _ in range(skip):
                    frame, r, done, _ = self.mdp.step(action)
                    reward += r
                    if done:
                        break
                self.hp.record(frame)
                next_obs = self.hp.getHistory()
                self.replay.store(
                    Transition(obs, action, reward, next_obs, done))
                obs = next_obs
                ep_reward += reward
                ep_steps += 1
                self._after_step()
            self.epoch_rewards.append(ep_reward)
        return self.epoch_rewards


class _ConvDQNPolicy(DQNPolicy):
    """Greedy play that runs raw frames through the history pipeline."""

    def __init__(self, network, hp):
        super().__init__(network)
        self.hp = hp

    def play(self, mdp, max_steps=10000):
        frame = mdp.reset()
        self.hp.reset()
        self.hp.record(frame)
        total = 0.0
        skip = max(1, self.hp.conf.skipFrame)
        for _ in range(max_steps):
            action = self.nextAction(self.hp.getHistory())
            done = False
            for _ in range(skip):
                frame, r, done, _ = mdp.step(action)
                total += r
                if done:
                    break
            self.hp.record(frame)
            if done:
                break
        return total
