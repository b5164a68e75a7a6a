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

All ten updaters of the JAX package are ported: Sgd, Nesterovs (with
`momentumDtype`), Adam, AdaMax, Nadam, AMSGrad, RmsProp, AdaGrad, AdaDelta
and NoOp, each with optax's formulas. A learning rate may be a number or a
schedule (`nn/schedules.py`); a number is a FixedSchedule, as in the JAX
package, so every optimizer state is the JAX package's leaf for leaf. The
rate is computed on the device from an int32 count in the optimizer state,
which the step advances (optax.scale_by_schedule), so a CUDA graph of the
step follows it.
"""
from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.schedules import as_schedule

_DTYPES = {"float32": torch.float32, "float": torch.float32,
           "bfloat16": torch.bfloat16, "float16": torch.float16,
           "half": torch.float16, "float64": torch.float64}


def _lr(value):
    """The transform that scales by −learning rate: optax's
    scale_by_schedule of a schedule, a callable of the count or a number
    (a FixedSchedule), as the JAX package builds every updater, so the
    optimizer state holds optax's schedule count (what the model archives
    carry across)."""
    return _ScaleBySchedule(as_schedule(value))


class Updater:
    """Base of the updater configurations."""

    def to_transform(self):
        raise NotImplementedError

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
        return _lr(self.learningRate)


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
                       _lr(self.learningRate)])


class Adam(Updater):
    def __init__(self, learningRate=1e-3, beta1=0.9, beta2=0.999,
                 epsilon=1e-8):
        self.learningRate, self.beta1 = learningRate, beta1
        self.beta2, self.epsilon = beta2, epsilon

    def to_transform(self):
        return _Chain([_ScaleByAdam(float(self.beta1), float(self.beta2),
                                    float(self.epsilon)),
                       _lr(self.learningRate)])


class AdaMax(Adam):
    def to_transform(self):
        return _Chain([_ScaleByAdamax(float(self.beta1), float(self.beta2),
                                      float(self.epsilon)),
                       _lr(self.learningRate)])


class Nadam(Adam):
    def to_transform(self):
        return _Chain([_ScaleByAdam(float(self.beta1), float(self.beta2),
                                    float(self.epsilon), nesterov=True),
                       _lr(self.learningRate)])


class AMSGrad(Adam):
    def to_transform(self):
        return _Chain([_ScaleByAmsgrad(float(self.beta1), float(self.beta2),
                                       float(self.epsilon)),
                       _lr(self.learningRate)])


class RmsProp(Updater):
    def __init__(self, learningRate=1e-1, rmsDecay=0.95, epsilon=1e-8):
        self.learningRate, self.rmsDecay = learningRate, rmsDecay
        self.epsilon = epsilon

    def to_transform(self):
        return _Chain([_ScaleByRms(float(self.rmsDecay),
                                   float(self.epsilon)),
                       _lr(self.learningRate)])


class AdaGrad(Updater):
    """optax.adagrad: its accumulators start at 0.1."""

    def __init__(self, learningRate=1e-1, epsilon=1e-6):
        self.learningRate, self.epsilon = learningRate, epsilon

    def to_transform(self):
        return _Chain([_ScaleByRss(0.1, float(self.epsilon)),
                       _lr(self.learningRate)])


class AdaDelta(Updater):
    """optax.adadelta with no learning rate, as the JAX package builds it."""

    def __init__(self, rho=0.95, epsilon=1e-6):
        self.rho, self.epsilon = rho, epsilon

    def to_transform(self):
        return _ScaleByAdadelta(float(self.rho), float(self.epsilon))


class NoOp(Updater):
    """optax.set_to_zero."""

    def to_transform(self):
        return _SetToZero()


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

    def __init__(self, b1, b2, eps, nesterov=False):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.nesterov = nesterov

    def init(self, params):
        return _count_and_moments(params)

    def update(self, grads, state, params):
        count, mu, nu = state
        f = torch
        mu = _moment(grads, mu, self.b1, 1)
        nu = _moment(grads, nu, self.b2, 2)
        count = count + 1
        c = count.to(torch.float32)
        bc1 = _bias_correction(self.b1, c)
        bc2 = _bias_correction(self.b2, c)
        if self.nesterov:
            # Nadam: b1·μ̂(count+1) + (1−b1)·ĝ(count)
            mu_hat = f._foreach_add(
                f._foreach_mul(f._foreach_div(
                    mu, _bias_correction(self.b1, c + 1)), self.b1),
                f._foreach_mul(f._foreach_div(grads, bc1), 1 - self.b1))
        else:
            mu_hat = f._foreach_div(mu, bc1)
        denom = f._foreach_add(f._foreach_sqrt(f._foreach_div(nu, bc2)),
                               self.eps)
        upd = f._foreach_div(mu_hat, denom)
        return list(upd), (count, list(mu), list(nu))


def _count_and_moments(params):
    """(an int32 count on the parameters' device, μ, ν): zeros."""
    dev = params[0].device if params else None
    return (torch.zeros((), dtype=torch.int32, device=dev),
            [torch.zeros_like(p) for p in params],
            [torch.zeros_like(p) for p in params])


def _bias_correction(decay, count):
    """1 − decay**count in f32, optax's bias correction (count an f32
    tensor on the device)."""
    return 1 - torch.pow(float(np.float32(decay)), count)


def _moment(grads, state, decay, order):
    """optax.tree.update_moment: (1 − decay)·g**order + decay·t."""
    f = torch
    g = f._foreach_mul(grads, grads) if order == 2 else grads
    return f._foreach_add(f._foreach_mul(g, 1 - decay),
                          f._foreach_mul(state, decay))


class _ScaleBySchedule(_Transform):
    """optax.scale_by_schedule(−schedule): the rate at the int32 count,
    on the device, then the count advanced."""

    def __init__(self, schedule):
        self.schedule = schedule

    def init(self, params):
        dev = params[0].device if params else None
        return torch.zeros((), dtype=torch.int32, device=dev)

    def update(self, grads, count, params):
        step = -1 * self.schedule(count).to(torch.float32)
        if all(g.dtype == torch.float32 for g in grads):
            upd = list(torch._foreach_mul(grads, step))
        else:
            upd = [g * step.to(g.dtype) for g in grads]
        return upd, count + 1


class _ScaleByAdamax(_Transform):
    """optax.scale_by_adamax: μ' = (1−b1)·g + b1·μ, ν' = max(|g| + ε,
    b2·ν), the update μ̂/ν' (bias-corrected μ only)."""

    def __init__(self, b1, b2, eps):
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        return _count_and_moments(params)

    def update(self, grads, state, params):
        count, mu, nu = state
        f = torch
        count = count + 1
        mu = _moment(grads, mu, self.b1, 1)
        nu = f._foreach_maximum(f._foreach_add(f._foreach_abs(grads),
                                               self.eps),
                                f._foreach_mul(nu, self.b2))
        bc1 = _bias_correction(self.b1, count.to(torch.float32))
        upd = f._foreach_div(f._foreach_div(mu, bc1), nu)
        return list(upd), (count, list(mu), list(nu))


class _ScaleByAmsgrad(_Transform):
    """optax.scale_by_amsgrad: Adam's moments, the update μ̂ / (√max(ν̂
    so far) + ε)."""

    def __init__(self, b1, b2, eps):
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        return _count_and_moments(params) + ([torch.zeros_like(p)
                                              for p in params],)

    def update(self, grads, state, params):
        count, mu, nu, nu_max = state
        f = torch
        mu = _moment(grads, mu, self.b1, 1)
        nu = _moment(grads, nu, self.b2, 2)
        count = count + 1
        c = count.to(torch.float32)
        mu_hat = f._foreach_div(mu, _bias_correction(self.b1, c))
        nu_hat = f._foreach_div(nu, _bias_correction(self.b2, c))
        nu_max = f._foreach_maximum(nu_max, nu_hat)
        upd = f._foreach_div(mu_hat, f._foreach_add(f._foreach_sqrt(nu_max),
                                                    self.eps))
        return list(upd), (count, list(mu), list(nu), list(nu_max))


class _ScaleByRms(_Transform):
    """optax.scale_by_rms: ν' = (1−decay)·g² + decay·ν, the update
    g / √(ν' + ε)."""

    def __init__(self, decay, eps):
        self.decay, self.eps = decay, eps

    def init(self, params):
        return [torch.zeros_like(p) for p in params]

    def update(self, grads, nu, params):
        f = torch
        nu = _moment(grads, nu, self.decay, 2)
        upd = f._foreach_mul(f._foreach_rsqrt(f._foreach_add(nu, self.eps)),
                             grads)
        return list(upd), list(nu)


class _ScaleByRss(_Transform):
    """optax.scale_by_rss: s' = g² + s, the update g / √(s' + ε) where
    s' > 0, else 0."""

    def __init__(self, initial, eps):
        self.initial, self.eps = initial, eps

    def init(self, params):
        return [torch.full_like(p, self.initial) for p in params]

    def update(self, grads, sums, params):
        f = torch
        sums = f._foreach_add(f._foreach_mul(grads, grads), sums)
        upd = [torch.where(s > 0, torch.rsqrt(s + self.eps),
                           torch.zeros_like(s)) * g
               for s, g in zip(sums, grads)]
        return upd, list(sums)


class _ScaleByAdadelta(_Transform):
    """optax.scale_by_adadelta: E[g²]' = (1−ρ)·g² + ρ·E[g²], the update
    √(E[x²] + ε) / √(E[g²]' + ε) · g, then E[x²]' from the update."""

    def __init__(self, rho, eps):
        self.rho, self.eps = rho, eps

    def init(self, params):
        return ([torch.zeros_like(p) for p in params],
                [torch.zeros_like(p) for p in params])

    def update(self, grads, state, params):
        e_g, e_x = state
        f = torch
        e_g = _moment(grads, e_g, self.rho, 2)
        upd = f._foreach_mul(
            f._foreach_div(f._foreach_sqrt(f._foreach_add(e_x, self.eps)),
                           f._foreach_sqrt(f._foreach_add(e_g, self.eps))),
            grads)
        e_x = _moment(upd, e_x, self.rho, 2)
        return list(upd), (list(e_g), list(e_x))


class _SetToZero(_Transform):
    """optax.set_to_zero."""

    def leaf(self, g, p):
        return torch.zeros_like(g)


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
        raise TypeError(f"updater {updater!r} is not an Updater config "
                        "(Sgd, Adam, Nesterovs, ...)")
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
