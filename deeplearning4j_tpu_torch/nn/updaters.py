"""Updaters: the port of `deeplearning4j_tpu/nn/updaters.py` (≡ nd4j-api ::
learning.config.IUpdater).

The config classes hold hyperparameters; `build_optimizer` turns one into
an optimizer that computes optax's update, in optax's order: gradient
normalization (the four GradientNormalization modes), then `weightDecay`
added to the gradient, then the updater. An optimizer works like an optax
GradientTransformation on dicts {node: {key: tensor}}:

    opt = build_optimizer(Nesterovs(0.1, 0.9), None, 1.0, 0.0)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

Each update is written out as tensor code with optax's formulas and
operation order (`torch.optim` rounds Adam's bias corrections and
Nesterov's momentum differently), so the port follows optax to f32
rounding. The updaters and `apply_updates` run PyTorch's multi-tensor
(`torch._foreach_*`) ops: one launch per operation for all leaves of a
dtype, not one per leaf (ResNet-50 has 161 leaves). `multi_transform` gives layers their own updaters, as the JAX
graph does with `optax.multi_transform`.

Ported: Sgd, Nesterovs (with `momentumDtype`) and Adam, the updaters the
zoo and the ResNet-50 training path use. Schedules (a learning rate that
is not a number) and the other updaters raise, naming their slice.
"""
from __future__ import annotations

import numbers

import numpy as np
import torch

_LATER_UPDATERS = "the updaters slice of the port (ROADMAP A10)"
_DTYPES = {"float32": torch.float32, "float": torch.float32,
           "bfloat16": torch.bfloat16, "float16": torch.float16,
           "half": torch.float16, "float64": torch.float64}


def _lr(value):
    if isinstance(value, numbers.Real):
        return float(value)
    raise NotImplementedError(
        f"learning-rate schedule {value!r}: nn/schedules.py is not ported "
        f"yet; it comes with {_LATER_UPDATERS}")


class Updater:
    """Base of the updater configurations."""

    def to_transform(self):
        raise NotImplementedError(
            f"updater {type(self).__name__} is not ported yet; it comes with "
            f"{_LATER_UPDATERS}")

    def config(self):
        return {"type": type(self).__name__, **self.__dict__}


def same_updater(a, b):
    """Structural equality (identity breaks after a config round trip)."""
    return a is b or (type(a) is type(b)
                      and getattr(a, "__dict__", None) == getattr(
                          b, "__dict__", None))


class Sgd(Updater):
    def __init__(self, learningRate=0.1):
        self.learningRate = learningRate

    def to_transform(self):
        return _Scale(-_lr(self.learningRate))


class Nesterovs(Updater):
    """≡ learning.config.Nesterovs: optax.sgd with Nesterov momentum.
    `momentumDtype` (e.g. "bfloat16") stores the momentum buffer in that
    dtype; the update itself is formed before the cast, as optax does."""

    def __init__(self, learningRate=0.1, momentum=0.9, momentumDtype=None):
        self.learningRate, self.momentum = learningRate, momentum
        self.momentumDtype = momentumDtype

    def to_transform(self):
        acc = None
        if self.momentumDtype is not None:
            key = str(self.momentumDtype).lower().replace("torch.", "")
            if key not in _DTYPES:
                raise ValueError(f"momentumDtype {self.momentumDtype!r}: "
                                 f"expected one of {sorted(_DTYPES)}")
            acc = _DTYPES[key]
        return _Chain([_Trace(float(self.momentum), True, acc),
                       _Scale(-_lr(self.learningRate))])


class Adam(Updater):
    def __init__(self, learningRate=1e-3, beta1=0.9, beta2=0.999,
                 epsilon=1e-8):
        self.learningRate, self.beta1 = learningRate, beta1
        self.beta2, self.epsilon = beta2, epsilon

    def to_transform(self):
        return _Chain([_ScaleByAdam(float(self.beta1), float(self.beta2),
                                    float(self.epsilon)),
                       _Scale(-_lr(self.learningRate))])


class AdaMax(Adam):
    to_transform = Updater.to_transform


class Nadam(Adam):
    to_transform = Updater.to_transform


class AMSGrad(Adam):
    to_transform = Updater.to_transform


class RmsProp(Updater):
    def __init__(self, learningRate=1e-1, rmsDecay=0.95, epsilon=1e-8):
        self.learningRate, self.rmsDecay = learningRate, rmsDecay
        self.epsilon = epsilon


class AdaGrad(Updater):
    def __init__(self, learningRate=1e-1, epsilon=1e-6):
        self.learningRate, self.epsilon = learningRate, epsilon


class AdaDelta(Updater):
    def __init__(self, rho=0.95, epsilon=1e-6):
        self.rho, self.epsilon = rho, epsilon


class NoOp(Updater):
    pass


class GradientNormalization:
    NONE = "none"
    RENORMALIZE_L2_PER_LAYER = "renormalizel2perlayer"
    CLIP_ELEMENTWISE_ABSOLUTE_VALUE = "clipelementwiseabsolutevalue"
    CLIP_L2_PER_LAYER = "clipl2perlayer"
    CLIP_L2_PER_PARAM_TYPE = "clipl2perparamtype"


# -- transformations over flat lists of tensors -------------------------------
class _Transform:
    """optax's GradientTransformation over parallel lists of tensors: a
    stateless transform maps each gradient alone."""

    def init(self, params):
        return ()

    def update(self, grads, state, params):
        return [self.leaf(g, p) for g, p in zip(grads, params)], state

    def leaf(self, g, p):
        raise NotImplementedError


class _Chain(_Transform):
    def __init__(self, parts):
        self.parts = parts

    def init(self, params):
        return tuple(t.init(params) for t in self.parts)

    def update(self, grads, state, params):
        out = []
        for t, s in zip(self.parts, state):
            grads, s = t.update(grads, s, params)
            out.append(s)
        return grads, tuple(out)


class _Scale(_Transform):
    """optax.scale: the updater's −learning rate."""

    def __init__(self, factor):
        self.factor = factor

    def update(self, grads, state, params):
        return list(torch._foreach_mul(grads, self.factor)), state


class _ClipElementwise(_Transform):
    """optax.clip: each gradient value into [−thr, thr]."""

    def __init__(self, thr):
        self.thr = thr

    def leaf(self, g, p):
        return torch.clamp(g, -self.thr, self.thr)


class _ClipL2PerLeaf(_Transform):
    """Each leaf scaled to an L2 norm of at most thr."""

    def __init__(self, thr):
        self.thr = thr

    def leaf(self, g, p):
        n = torch.sqrt(torch.sum(g * g) + 1e-12)
        return g * torch.clamp_max(self.thr / n, 1.0)


class _RenormL2PerLeaf(_Transform):
    """Each leaf divided by its L2 norm."""

    def leaf(self, g, p):
        return g / torch.sqrt(torch.sum(g * g) + 1e-12)


class _AddDecayedWeights(_Transform):
    """optax.add_decayed_weights: g + wd·p."""

    def __init__(self, wd):
        self.wd = wd

    def leaf(self, g, p):
        return g + self.wd * p


class _Trace(_Transform):
    """optax.trace: t' = g + decay·t; the update is t' (or g + decay·t'
    with Nesterov); t' is stored in the accumulator dtype."""

    def __init__(self, decay, nesterov, dtype):
        self.decay, self.nesterov, self.dtype = decay, nesterov, dtype

    def init(self, params):
        return [torch.zeros_like(p, dtype=self.dtype or p.dtype)
                for p in params]

    def update(self, grads, state, params):
        # decay·t in t's dtype with decay rounded to it first, as JAX
        # multiplies a bf16 array by a Python float (all traces share one
        # dtype: the accumulator's, or the parameters')
        decay = (float(torch.tensor(self.decay, dtype=state[0].dtype))
                 if state else self.decay)
        new = torch._foreach_add(grads, torch._foreach_mul(state, decay))
        upd = (torch._foreach_add(grads, torch._foreach_mul(new, self.decay))
               if self.nesterov else new)
        if self.dtype is not None:
            new = [t.to(self.dtype) for t in new]
        return list(upd), list(new)


class _ScaleByAdam(_Transform):
    """optax.scale_by_adam: μ' = (1−b1)·g + b1·μ, ν' = (1−b2)·g² + b2·ν,
    the update μ̂/(√ν̂ + ε) with bias corrections 1 − b**count taken in
    f32, as optax takes them. The count is an int32 tensor on the
    parameters' device and the corrections are computed there, so a
    CUDA graph of the step reads the live count at every replay and the
    eager step computes the same bits."""

    def __init__(self, b1, b2, eps):
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        dev = params[0].device if params else None
        return (torch.zeros((), dtype=torch.int32, device=dev),
                [torch.zeros_like(p) for p in params],
                [torch.zeros_like(p) for p in params])

    def update(self, grads, state, params):
        count, mu, nu = state
        f = torch
        mu = f._foreach_add(f._foreach_mul(grads, 1 - self.b1),
                            f._foreach_mul(mu, self.b1))
        nu = f._foreach_add(f._foreach_mul(f._foreach_mul(grads, grads),
                                           1 - self.b2),
                            f._foreach_mul(nu, self.b2))
        count = count + 1
        c = count.to(torch.float32)
        bc1 = 1 - torch.pow(float(np.float32(self.b1)), c)
        bc2 = 1 - torch.pow(float(np.float32(self.b2)), c)
        denom = f._foreach_add(f._foreach_sqrt(f._foreach_div(nu, bc2)),
                               self.eps)
        upd = f._foreach_div(f._foreach_div(mu, bc1), denom)
        return list(upd), (count, list(mu), list(nu))


def build_optimizer(updater, gradient_normalization=None,
                    gradient_normalization_threshold=1.0, weight_decay=0.0):
    """Chain gradient normalization (≡ GradientNormalization), then
    weightDecay added to the gradient, then the updater, into one
    optimizer over dicts {node: {key: tensor}} (the JAX package's
    `build_optimizer`, optax's order)."""
    if updater is None:
        raise ValueError("no updater configured: set .updater(...) on the "
                         "NeuralNetConfiguration builder to train")
    chain = []
    gn = (gradient_normalization or "none").lower().replace("_", "")
    thr = float(gradient_normalization_threshold)
    if gn == "clipelementwiseabsolutevalue":
        chain.append(_ClipElementwise(thr))
    elif gn in ("clipl2perlayer", "clipl2perparamtype"):
        # per-leaf L2 clip: each leaf is one parameter tensor, matching the
        # reference's per-param-type clip
        chain.append(_ClipL2PerLeaf(thr))
    elif gn == "renormalizel2perlayer":
        chain.append(_RenormL2PerLeaf())
    elif gn != "none":
        raise ValueError(
            f"Unknown GradientNormalization '{gradient_normalization}'")
    if weight_decay:
        chain.append(_AddDecayedWeights(float(weight_decay)))
    if not isinstance(updater, Updater):
        raise NotImplementedError(
            f"updater {updater!r} is not an Updater config; optax-style "
            f"transformations come with {_LATER_UPDATERS}")
    chain.append(updater.to_transform())
    return Optimizer({_GLOBAL: _Chain(chain)})


def _flatten(tree):
    """(keys, leaves) of {node: {key: tensor}} in the JAX package's tree
    order: nodes sorted, then keys sorted."""
    keys = [(n, k) for n in sorted(tree) for k in sorted(tree[n])]
    return keys, [tree[n][k] for n, k in keys]


def _unflatten(keys, leaves):
    out = {}
    for (n, k), v in zip(keys, leaves):
        out.setdefault(n, {})[k] = v
    return out


_GLOBAL = "__global__"


class Optimizer:
    """Transforms by label over {node: {key: tensor}} trees: `labels`
    {node: label} names a node's transform, the global one for a node it
    leaves out (optax.multi_transform over the graph's top-level keys)."""

    def __init__(self, transforms, labels=None):
        self.transforms, self.labels = transforms, labels or {}

    def _groups(self, tree):
        keys, _ = _flatten(tree)
        groups = {}
        for key in keys:
            groups.setdefault(self.labels.get(key[0], _GLOBAL),
                              []).append(key)
        return groups

    def init(self, params):
        return {lab: self.transforms[lab].init([params[n][k] for n, k in ks])
                for lab, ks in self._groups(params).items()}

    def update(self, grads, state, params):
        keys, leaves = [], []
        new_state = {}
        for lab, ks in self._groups(params).items():
            upd, new_state[lab] = self.transforms[lab].update(
                [grads[n][k] for n, k in ks], state[lab],
                [params[n][k] for n, k in ks])
            keys += ks
            leaves += upd
        return _unflatten(keys, leaves), new_state


def multi_transform(optimizers, labels):
    """One optimizer of several: `optimizers` {label: an optimizer of
    build_optimizer, "__global__" among them}, `labels` {node: label}."""
    return Optimizer({lab: opt.transforms[_GLOBAL]
                      for lab, opt in optimizers.items()}, labels)


def apply_updates(params, updates):
    """optax.apply_updates: p + u, in p's dtype."""
    keys, ps = _flatten(params)
    out = torch._foreach_add(ps, [updates[n][k] for n, k in keys])
    return _unflatten(keys, [o.to(p.dtype) for o, p in zip(out, ps)])
