"""Advantage actor-critic + n-step Q (≡ rl4j-core :: learning.async.
a3c.discrete.A3CDiscreteDense, nstep.discrete.AsyncNStepQLearningDiscreteDense,
a3c.discrete.A3CDiscreteConv): the port of `deeplearning4j_tpu/rl/a3c.py`.

As in the JAX package, the reference's many async CPU threads become
BATCHED environments: N env instances step on the host, and one update
consumes the whole (N, T) rollout (policy-gradient + value + entropy
losses, autograd over a dict of tensors, optax's RMSprop through the
port's `RmsProp` transform: ε inside the root, g / √(ν + ε), which
`torch.optim.RMSprop` is not). The n-step returns stay a host loop, and
each env's action is drawn on the host with the numpy generator from the
card's probabilities (a probability an ulp away from the JAX package's
can flip a draw only within ~1e-7 of a boundary).

Parameters are {"body", "pi", "v"[, "conv"]}: lists of {"w", "b"}
tensors, the JAX package's tree, drawn through the port's threefry
(`ops.random.split`, `normal`) on the CPU from `PRNGKey(seed)`, so a
fresh learner starts within 1e-6 of the JAX one, and then moved to the
learner's device (`device=None`: the card). The conv torso is NHWC with
HWIO kernels and VALID padding; its output flattens in (H, W, C) order,
the order the `body` weights line up with.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.device import resolve
from deeplearning4j_tpu_torch.nn.updaters import (RmsProp, apply_updates,
                                                  build_optimizer)
from deeplearning4j_tpu_torch.ops.random import normal, seed_key, split


def _he(fan_in):
    """jnp.sqrt(2.0 / fan_in): the float32 square root."""
    return torch.tensor(np.sqrt(np.float32(2.0 / fan_in)))


def _mlp_init(key, sizes):
    params = []
    for n_in, n_out in zip(sizes[:-1], sizes[1:]):
        key, k = split(key)
        w = normal(k, (n_in, n_out), "cpu") * _he(n_in)
        params.append({"w": w, "b": torch.zeros(n_out)})
    return params


def _mlp_apply(params, x):
    for i, lyr in enumerate(params):
        x = x @ lyr["w"] + lyr["b"]
        if i < len(params) - 1:
            x = torch.relu(x)
    return x


def _flat(params):
    """{"body.0": {"w", "b"}, ...}: the tree as the optimizer's nodes
    (the same tensors)."""
    return {f"{g}.{i}": lyr for g, layers in params.items()
            for i, lyr in enumerate(layers)}


def _nest(flat):
    out = {}
    for name in sorted(flat, key=lambda n: (n.split(".")[0],
                                            int(n.split(".")[1]))):
        out.setdefault(name.split(".")[0], []).append(flat[name])
    return out


def _to(tree, dev):
    return {g: [{k: v.to(dev) for k, v in lyr.items()} for lyr in layers]
            for g, layers in tree.items()}


def rms_nu(opt_state):
    """The RMSprop ν leaves of `build_optimizer(RmsProp(...))`'s state,
    in the optimizer's order (nodes sorted, then keys sorted)."""
    return opt_state["__global__"][0][0]


class A3CConfiguration:
    """≡ A3CLearningConfiguration (numThread → numEnvs)."""

    def __init__(self, seed=123, maxEpochStep=200, maxStep=20000,
                 numEnvs=8, nstep=5, gamma=0.99, learningRate=7e-4,
                 entropyCoef=0.01, valueCoef=0.5, hiddenNodes=64,
                 numLayers=2):
        self.seed = seed
        self.maxEpochStep = maxEpochStep
        self.maxStep = maxStep
        self.numEnvs = numEnvs
        self.nstep = nstep
        self.gamma = gamma
        self.learningRate = learningRate
        self.entropyCoef = entropyCoef
        self.valueCoef = valueCoef
        self.hiddenNodes = hiddenNodes
        self.numLayers = numLayers


class A3CDiscreteDense:
    """Batched-env A2C with the A3CDiscreteDense training surface."""

    def __init__(self, mdp_factory, conf=None, device=None):
        self.conf = conf or A3CConfiguration()
        c = self.conf
        self.device = resolve(device)
        self.envs = [mdp_factory() for _ in range(c.numEnvs)]
        obs_dim = int(np.prod(self.envs[0].getObservationSpace().shape))
        self.num_actions = self.envs[0].getActionSpace().getSize()
        k1, k2, k3 = split(seed_key(c.seed), 3)
        body_sizes = [obs_dim] + [c.hiddenNodes] * c.numLayers
        self.params = _to({
            "body": _mlp_init(k1, body_sizes),
            "pi": _mlp_init(k2, [c.hiddenNodes, self.num_actions]),
            "v": _mlp_init(k3, [c.hiddenNodes, 1]),
        }, self.device)
        self._init_trainer_state()

    def _init_trainer_state(self):
        """Optimizer + rollout bookkeeping — ONE definition shared by the
        dense and conv trainers (self.conf and self.params must be set)."""
        c = self.conf
        self.tx = build_optimizer(RmsProp(c.learningRate, rmsDecay=0.99,
                                          epsilon=1e-5))
        self.opt_state = self.tx.init(_flat(self.params))
        self._rng = np.random.default_rng(c.seed)
        self.step_count = 0
        self.episode_rewards = []
        self._ep_acc = np.zeros(c.numEnvs)
        self.host_reads = 0      # device → host reads of the loop
        self.updates = 0

    def _tensor(self, x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype,
                               device=self.device)

    # -- policy/value ----------------------------------------------------
    def _features(self, params, obs):
        """Shared feature extractor — the ONLY thing subclasses override
        (dense: body MLP; conv: conv torso)."""
        return _mlp_apply(params["body"], obs)

    def _logits_values(self, params, obs):
        h = self._features(params, obs)
        return _mlp_apply(params["pi"], h), _mlp_apply(params["v"], h)[..., 0]

    def _loss(self, p, obs, actions, returns):
        c = self.conf
        h = self._features(p, obs)
        logits = _mlp_apply(p["pi"], h)
        values = _mlp_apply(p["v"], h)[..., 0]
        logp = torch.log_softmax(logits, -1)
        probs = torch.softmax(logits, -1)
        adv = returns - values
        chosen = logp.gather(-1, actions[:, None])[:, 0]
        pg_loss = -(chosen * adv.detach()).mean()
        v_loss = (adv ** 2).mean()
        entropy = -(probs * logp).sum(-1).mean()
        return pg_loss + c.valueCoef * v_loss - c.entropyCoef * entropy

    def _update(self, params, opt_state, obs, actions, returns):
        """One step on an (N·T) rollout: obs (N·T, ...), the actions and
        the n-step bootstrapped returns. Returns (params, opt_state); a
        leaf the loss does not reach gets a zero gradient, so its RMSprop
        ν decays as optax's does."""
        obs = self._tensor(obs)
        actions = self._tensor(actions, torch.int64)
        returns = self._tensor(returns)
        flat = _flat(params)
        keys = [(n, k) for n in flat for k in flat[n]]
        live = {n: {k: v.detach().requires_grad_() for k, v in d.items()}
                for n, d in flat.items()}
        loss = self._loss(_nest(live), obs, actions, returns)
        grads = torch.autograd.grad(loss, [live[n][k] for n, k in keys],
                                    allow_unused=True)
        tree = {}
        for (n, k), g in zip(keys, grads):
            tree.setdefault(n, {})[k] = (torch.zeros_like(flat[n][k])
                                         if g is None else g)
        with torch.no_grad():
            updates, opt_state = self.tx.update(tree, opt_state, flat)
            return _nest(apply_updates(flat, updates)), opt_state

    def _act(self, obs_batch):
        with torch.no_grad():
            logits, values = self._logits_values(self.params,
                                                 self._tensor(obs_batch))
            host = torch.cat([torch.softmax(logits, -1), values[:, None]],
                             1).cpu().numpy()
        self.host_reads += 1
        probs, values = host[:, :-1], host[:, -1]
        actions = np.array([self._rng.choice(self.num_actions, p=p / p.sum())
                            for p in probs], np.int32)
        return actions, values

    def train(self):
        c = self.conf
        obs = np.stack([e.reset() for e in self.envs]).astype(np.float32)
        while self.step_count < c.maxStep:
            roll_obs, roll_act, roll_rew, roll_done = [], [], [], []
            for _ in range(c.nstep):
                actions, _ = self._act(obs)
                next_obs = np.empty_like(obs)
                rewards = np.zeros(c.numEnvs, np.float32)
                dones = np.zeros(c.numEnvs, np.float32)
                for i, env in enumerate(self.envs):
                    o, r, d, _ = env.step(int(actions[i]))
                    self._ep_acc[i] += r
                    if d:
                        self.episode_rewards.append(self._ep_acc[i])
                        self._ep_acc[i] = 0.0
                        o = env.reset()
                    next_obs[i], rewards[i], dones[i] = o, r, float(d)
                roll_obs.append(obs.copy())
                roll_act.append(actions)
                roll_rew.append(rewards)
                roll_done.append(dones)
                obs = next_obs
                self.step_count += c.numEnvs
            # n-step bootstrapped returns (host; tiny T loop)
            _, boot = self._act(obs)
            returns = np.zeros((c.nstep, c.numEnvs), np.float32)
            running = boot
            for t in reversed(range(c.nstep)):
                running = roll_rew[t] + c.gamma * running * (1 - roll_done[t])
                returns[t] = running
            self.params, self.opt_state = self._update(
                self.params, self.opt_state, np.concatenate(roll_obs),
                np.concatenate(roll_act), returns.reshape(-1))
            self.updates += 1
        return self.episode_rewards

    # -- play surface -----------------------------------------------------
    def nextAction(self, obs):
        with torch.no_grad():
            logits, _ = self._logits_values(self.params,
                                            self._tensor(obs[None]))
            return int(np.argmax(logits.cpu().numpy()[0]))

    def play(self, mdp, max_steps=10000):
        obs = mdp.reset()
        total = 0.0
        for _ in range(max_steps):
            obs, r, done, _ = mdp.step(self.nextAction(obs))
            total += r
            if done:
                break
        return total


class AsyncNStepQLearningDiscreteDense(A3CDiscreteDense):
    """≡ AsyncNStepQLearningDiscreteDense — same batched-env rollout
    machinery but a pure Q head trained on n-step returns (no policy
    head; ε-greedy behaviour policy). The pi head is the Q head; the v
    head gets zero gradients."""

    def __init__(self, mdp_factory, conf=None, minEpsilon=0.1,
                 epsilonNbStep=5000, device=None):
        super().__init__(mdp_factory, conf, device)
        self.minEpsilon = minEpsilon
        self.epsilonNbStep = epsilonNbStep

    def _loss(self, p, obs, actions, returns):
        q = _mlp_apply(p["pi"], _mlp_apply(p["body"], obs))
        chosen = q.gather(-1, actions[:, None])[:, 0]
        return ((returns - chosen) ** 2).mean()

    def _act(self, obs_batch):
        with torch.no_grad():
            logits, _ = self._logits_values(self.params,
                                            self._tensor(obs_batch))
            q = logits.cpu().numpy()
        self.host_reads += 1
        frac = min(1.0, self.step_count / max(1, self.epsilonNbStep))
        eps = 1.0 + frac * (self.minEpsilon - 1.0)
        actions = q.argmax(-1).astype(np.int32)
        explore = self._rng.random(len(actions)) < eps
        actions[explore] = self._rng.integers(
            self.num_actions, size=int(explore.sum()))
        return actions, q.max(-1)


class _PixelEnvAdapter:
    """Wraps a pixel MDP with the HistoryProcessor pipeline + frame-skip
    action repeat so the batched A2C rollout sees processed (H, W, hist)
    stacks — the conv twin of the dense envs."""

    def __init__(self, mdp, hp_conf=None):
        # imported at the call: conv imports dqn, and this module is
        # imported beside both
        from deeplearning4j_tpu_torch.rl.conv import (
            HistoryProcessor, HistoryProcessorConfiguration)
        self.mdp = mdp
        self.hp = HistoryProcessor(hp_conf or
                                   HistoryProcessorConfiguration())
        self.skip = max(1, self.hp.conf.skipFrame)

    def getActionSpace(self):
        return self.mdp.getActionSpace()

    def getObservationSpace(self):
        class _Space:
            shape = (self.hp.conf.rescaledHeight,
                     self.hp.conf.rescaledWidth,
                     self.hp.conf.historyLength)
        return _Space()

    def reset(self):
        frame = self.mdp.reset()
        self.hp.reset()
        self.hp.record(frame)
        return self.hp.getHistory()

    def step(self, action):
        reward, done, frame = 0.0, False, None
        for _ in range(self.skip):
            frame, r, done, _ = self.mdp.step(int(action))
            reward += r
            if done:
                break
        self.hp.record(frame)
        return self.hp.getHistory(), reward, done, {}


class A3CDiscreteConv(A3CDiscreteDense):
    """≡ rl4j :: a3c.discrete.A3CDiscreteConv +
    ActorCriticFactoryCompGraphStdConv — batched-env A2C over a PIXEL
    MDP: shared conv torso feeding policy and value heads, observations
    from the HistoryProcessor frame pipeline with frame-skip action
    repeat. Reuses the dense trainer's rollout/update machinery; only the
    network and the env adapter differ."""

    def __init__(self, mdp_factory, conf=None, hp_conf=None, net_conf=None,
                 device=None):
        from deeplearning4j_tpu_torch.rl.conv import \
            DQNConvNetworkConfiguration
        self.conf = c = conf or A3CConfiguration()
        self.net_conf = nc = net_conf or DQNConvNetworkConfiguration()
        self.device = resolve(device)
        self._hp_conf = hp_conf
        self.envs = [_PixelEnvAdapter(mdp_factory(), hp_conf)
                     for _ in range(c.numEnvs)]
        h, w, ch = self.envs[0].getObservationSpace().shape
        self.num_actions = self.envs[0].getActionSpace().getSize()
        key = seed_key(c.seed)
        conv_params, cin = [], ch
        oh, ow = h, w
        for f, khw, s in zip(nc.filters, nc.kernels, nc.strides):
            key, k = split(key)
            fan_in = khw[0] * khw[1] * cin
            conv_params.append({
                "w": normal(k, (khw[0], khw[1], cin, f), "cpu")
                * _he(fan_in),
                "b": torch.zeros(f)})
            oh = (oh - khw[0]) // s[0] + 1
            ow = (ow - khw[1]) // s[1] + 1
            cin = f
        flat = oh * ow * cin
        k1, k2, k3 = split(key, 3)
        self.params = _to({
            "conv": conv_params,
            "body": _mlp_init(k1, [flat, nc.denseUnits]),
            "pi": _mlp_init(k2, [nc.denseUnits, self.num_actions]),
            "v": _mlp_init(k3, [nc.denseUnits, 1]),
        }, self.device)
        self._init_trainer_state()

    def _features(self, params, obs):
        cl = torch.channels_last
        x = obs.permute(0, 3, 1, 2)                 # NHWC viewed as NCHW
        for lyr, s in zip(params["conv"], self.net_conf.strides):
            w = lyr["w"].permute(3, 2, 0, 1).contiguous(memory_format=cl)
            x = torch.relu(F.conv2d(x, w, lyr["b"], stride=tuple(s)))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # (H, W, C)
        return torch.relu(_mlp_apply(params["body"], x))

    def play(self, mdp, max_steps=10000):
        """Greedy play on a RAW pixel MDP: frames go through the same
        HistoryProcessor pipeline the trainer used (≡ the DQN path's
        _ConvDQNPolicy)."""
        env = _PixelEnvAdapter(mdp, self._hp_conf)
        obs = env.reset()
        total = 0.0
        for _ in range(max_steps):
            obs, r, done, _ = env.step(self.nextAction(obs))
            total += r
            if done:
                break
        return total
