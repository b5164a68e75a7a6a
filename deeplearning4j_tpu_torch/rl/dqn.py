"""Deep Q-learning (≡ rl4j-core :: learning.sync.qlearning.discrete.
QLearningDiscrete / QLearningDiscreteDense, network.dqn.DQNFactoryStdDense,
policy.EpsGreedy / DQNPolicy): the port of `deeplearning4j_tpu/rl/dqn.py`.

The Q-network is the port's MultiLayerNetwork (MSE head) built by
DQNFactoryStdDense — the reference's wiring — so each TD update is the
network's `fit` step (one CUDA graph replay on the card); the target
network is a `clone()` (its own tensors on the same device), refreshed in
place every `targetDqnUpdateFreq` steps. Double-DQN (argmax from the
online net, value from the target net) is on by default as in the
reference.

Every environment step reads one B = 1 forward back to the host for the
ε-greedy choice: that is the algorithm, so the learners keep it and count
it (`host_reads`, with the TD batches' three reads).

A learner takes `device=None` (the card) or "cpu". Its network draws
from the port's generator, so a fresh learner starts from other weights
than the JAX package's; `rl.params_from_numpy` installs the JAX
learner's.
"""
from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.nn.conf.builders import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.rl.replay import ExpReplay, Transition


class QLearningConfiguration:
    """≡ QLearning.QLConfiguration (builder-style kwargs)."""

    def __init__(self, seed=123, maxEpochStep=200, maxStep=10000,
                 expRepMaxSize=150000, batchSize=32, targetDqnUpdateFreq=100,
                 updateStart=10, rewardFactor=1.0, gamma=0.99,
                 errorClamp=1.0, minEpsilon=0.1, epsilonNbStep=3000,
                 doubleDQN=True):
        self.seed = seed
        self.maxEpochStep = maxEpochStep
        self.maxStep = maxStep
        self.expRepMaxSize = expRepMaxSize
        self.batchSize = batchSize
        self.targetDqnUpdateFreq = targetDqnUpdateFreq
        self.updateStart = updateStart
        self.rewardFactor = rewardFactor
        self.gamma = gamma
        self.errorClamp = errorClamp
        self.minEpsilon = minEpsilon
        self.epsilonNbStep = epsilonNbStep
        self.doubleDQN = doubleDQN


class DQNDenseNetworkConfiguration:
    """≡ network.configuration.DQNDenseNetworkConfiguration."""

    def __init__(self, numLayers=2, numHiddenNodes=64, learningRate=1e-3,
                 l2=0.0, updater=None):
        self.numLayers = numLayers
        self.numHiddenNodes = numHiddenNodes
        self.learningRate = learningRate
        self.l2 = l2
        self.updater = updater


class DQNFactoryStdDense:
    """≡ network.dqn.DQNFactoryStdDense — builds the MLP Q-network."""

    def __init__(self, conf: DQNDenseNetworkConfiguration):
        self.conf = conf

    def buildDQN(self, obs_dim, num_actions, seed=123, device=None):
        c = self.conf
        b = (NeuralNetConfiguration.Builder()
             .seed(seed)
             .updater(c.updater or Adam(c.learningRate))
             .weightInit("xavier")
             .l2(c.l2)
             .list())
        for _ in range(c.numLayers):
            b.layer(DenseLayer(nOut=c.numHiddenNodes, activation="relu"))
        b.layer(OutputLayer(lossFunction="mse", nOut=num_actions,
                            activation="identity"))
        return MultiLayerNetwork(
            b.setInputType(InputType.feedForward(obs_dim)).build()).init(
                device)


class EpsGreedy:
    """≡ policy.EpsGreedy — linear ε annealing over epsilonNbStep."""

    def __init__(self, conf: QLearningConfiguration, rng):
        self.conf = conf
        self.rng = rng
        self.step = 0

    def epsilon(self):
        c = self.conf
        frac = min(1.0, self.step / max(1, c.epsilonNbStep))
        return 1.0 + frac * (c.minEpsilon - 1.0)

    def nextAction(self, q_values, action_space):
        self.step += 1
        if self.rng.random() < self.epsilon():
            return action_space.randomAction(self.rng)
        return int(np.argmax(q_values))


class DQNPolicy:
    """≡ policy.DQNPolicy — greedy play with a trained Q-network."""

    def __init__(self, network):
        self.network = network

    def nextAction(self, obs):
        q = np.asarray(self.network.output(obs[None]))[0]
        return int(np.argmax(q))

    def play(self, mdp, max_steps=10000):
        obs = mdp.reset()
        total = 0.0
        for _ in range(max_steps):
            obs, r, done, _ = mdp.step(self.nextAction(obs))
            total += r
            if done:
                break
        return total


def td_learn_batch(net, target, replay, conf):
    """One (double-)DQN TD update on a replay batch — shared by the dense
    and conv learners: bootstrap from the target net (argmax from the
    online net when doubleDQN), clamp the TD error, fit on the patched
    Q-table (the reference's QLearning.setTarget path). Returns the
    batch's clamped TD errors (host numpy)."""
    obs, actions, rewards, next_obs, dones = replay.getBatch()
    q_next_t = np.asarray(target.output(next_obs))
    if conf.doubleDQN:
        best = np.asarray(net.output(next_obs)).argmax(-1)
        boot = q_next_t[np.arange(len(best)), best]
    else:
        boot = q_next_t.max(-1)
    td_target = rewards * conf.rewardFactor \
        + conf.gamma * boot * (1 - dones)
    q = np.array(net.output(obs))   # a writable host copy
    err = td_target - q[np.arange(len(actions)), actions]
    if conf.errorClamp:
        err = np.clip(err, -conf.errorClamp, conf.errorClamp)
    q[np.arange(len(actions)), actions] += err
    net.fit(obs, q)
    return err


#: host reads of one TD update: the target's and the online net's forwards
#: on next_obs (double DQN) and the online net's on obs
_TD_READS = 3


class _SyncDQN:
    """The training loop the dense and conv learners share: the policy's
    B = 1 forward read back to the host at every agent step, a TD update
    per step from `updateStart` on, the target synced every
    `targetDqnUpdateFreq` steps."""

    def _init_loop(self):
        c = self.conf
        self.target = self.net.clone()
        self._rng = np.random.default_rng(c.seed)
        self.replay = ExpReplay(c.expRepMaxSize, c.batchSize, c.seed)
        self.policy = EpsGreedy(c, self._rng)
        self.step_count = 0
        self.epoch_rewards = []
        self.host_reads = 0       # device → host reads of the loop
        self.updates = 0
        self.target_syncs = 0

    def _greedy_q(self, obs):
        self.host_reads += 1
        return np.asarray(self.net.output(obs[None]))[0]

    def _learn_batch(self):
        td_learn_batch(self.net, self.target, self.replay, self.conf)
        self.host_reads += _TD_READS if self.conf.doubleDQN else 2
        self.updates += 1

    def _after_step(self):
        c = self.conf
        self.step_count += 1
        if (self.step_count > c.updateStart
                and len(self.replay) >= c.batchSize):
            self._learn_batch()
        if self.step_count % c.targetDqnUpdateFreq == 0:
            self.target.setParams(self.net.params())
            self.target_syncs += 1


class QLearningDiscreteDense(_SyncDQN):
    """≡ QLearningDiscreteDense — sync DQN over an MDP with dense obs."""

    def __init__(self, mdp, net_conf, ql_conf=None, device=None):
        self.mdp = mdp
        self.conf = ql_conf or QLearningConfiguration()
        if isinstance(net_conf, DQNDenseNetworkConfiguration):
            net_conf = DQNFactoryStdDense(net_conf)
        obs_dim = int(np.prod(mdp.getObservationSpace().shape))
        self.num_actions = mdp.getActionSpace().getSize()
        self.net = net_conf.buildDQN(obs_dim, self.num_actions,
                                     self.conf.seed, device)
        self._init_loop()

    def getPolicy(self):
        return DQNPolicy(self.net)

    def train(self):
        """Run until maxStep env steps; returns per-epoch reward list."""
        c = self.conf
        while self.step_count < c.maxStep:
            obs = self.mdp.reset()
            ep_reward, ep_steps = 0.0, 0
            while not self.mdp.isDone() and ep_steps < c.maxEpochStep \
                    and self.step_count < c.maxStep:
                action = self.policy.nextAction(
                    self._greedy_q(obs), self.mdp.getActionSpace())
                next_obs, reward, done, _ = self.mdp.step(action)
                self.replay.store(
                    Transition(obs, action, reward, next_obs, done))
                obs = next_obs
                ep_reward += reward
                ep_steps += 1
                self._after_step()
            self.epoch_rewards.append(ep_reward)
        return self.epoch_rewards
