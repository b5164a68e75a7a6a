"""Loss functions: the port of `deeplearning4j_tpu/nn/losses.py`
(≡ nd4j-api :: lossfunctions.LossFunctions.LossFunction).

Each loss takes (labels, preact, activation, mask) where `preact` is the
layer pre-activation; the loss applies the activation itself so that
softmax+MCXENT / sigmoid+XENT lower to numerically stable log-softmax /
log-sigmoid forms. `mask` broadcasts over trailing dims; the scalar loss is
the masked mean over examples of the per-example sum. Every name of the
JAX package's table is here, with the object forms (LossFMeasure,
LossMixtureDensity, LossWasserstein, LossMultiLabel and the weighted
LossMCXENT / LossBinaryXENT / LossMSE), each with the JAX formula written
as tensor code. `get_loss` resolves a name at build time, as
`Layer.validate` needs it.
"""
from __future__ import annotations

import math

import torch

from deeplearning4j_tpu_torch.nn.activations import get_activation


def _apply_mask_mean(per_elem, mask):
    """per_elem: (batch, ...) per-element loss; returns scalar masked mean
    over examples (sum over feature dims, mean over batch/time elements)."""
    # Reduce feature dims -> per-example score
    reduce_axes = tuple(range(1, per_elem.ndim))
    per_example = per_elem.sum(dim=reduce_axes) if reduce_axes else per_elem
    if mask is None:
        return per_example.mean()
    m = mask.reshape(per_example.shape).to(per_elem.dtype)
    return (per_example * m).sum() / m.sum().clamp_min(1.0)


def _flatten_time(labels, preact, mask):
    """Fold time dim of rank-3 (batch, time, feat) into batch so losses are
    uniform; mask (batch, time) flattens alongside."""
    if preact.ndim == 3:
        b, t, f = preact.shape
        preact = preact.reshape(b * t, f)
        labels = labels.reshape(b * t, -1)
        if mask is not None:
            mask = mask.reshape(b * t)
    return labels, preact, mask


def mcxent(labels, preact, activation="softmax", mask=None):
    labels, preact, mask = _flatten_time(labels, preact, mask)
    if activation in ("softmax", "logsoftmax"):
        logp = torch.log_softmax(preact, dim=-1)
    elif activation == "sigmoid":
        logp = torch.log(torch.clamp(torch.sigmoid(preact), 1e-10, 1.0))
    else:
        logp = torch.log(torch.clamp(get_activation(activation)(preact), 1e-10, 1.0))
    return _apply_mask_mean(-(labels * logp), mask)


def xent(labels, preact, activation="sigmoid", mask=None):
    """Binary cross entropy (ND4J LossFunction.XENT)."""
    labels, preact, mask = _flatten_time(labels, preact, mask)
    if activation == "sigmoid":
        # stable: max(x,0) - x*z + log(1+exp(-|x|))
        x, z = preact, labels
        per = (torch.clamp_min(x, 0) - x * z
               + torch.log1p(torch.exp(-torch.abs(x))))
    else:
        p = torch.clamp(get_activation(activation)(preact), 1e-10, 1 - 1e-10)
        per = -(labels * torch.log(p) + (1 - labels) * torch.log(1 - p))
    return _apply_mask_mean(per, mask)


def mse(labels, preact, activation="identity", mask=None):
    labels, preact, mask = _flatten_time(labels, preact, mask)
    out = get_activation(activation)(preact)
    # ND4J MSE averages over the output dimension as well.
    per = (out - labels) ** 2 / labels.shape[-1]
    return _apply_mask_mean(per, mask)


def l2(labels, preact, activation="identity", mask=None):
    labels, preact, mask = _flatten_time(labels, preact, mask)
    out = get_activation(activation)(preact)
    return _apply_mask_mean((out - labels) ** 2, mask)


def mae(labels, preact, activation="identity", mask=None):
    labels, preact, mask = _flatten_time(labels, preact, mask)
    out = get_activation(activation)(preact)
    return _apply_mask_mean(torch.abs(out - labels) / labels.shape[-1], mask)


def l1(labels, preact, activation="identity", mask=None):
    labels, preact, mask = _flatten_time(labels, preact, mask)
    out = get_activation(activation)(preact)
    return _apply_mask_mean(torch.abs(out - labels), mask)


def hinge(labels, preact, activation="identity", mask=None):
    labels, preact, mask = _flatten_time(labels, preact, mask)
    out = get_activation(activation)(preact)
    y = 2.0 * labels - 1.0  # {0,1} -> {-1,1}
    return _apply_mask_mean(torch.clamp_min(1.0 - y * out, 0.0), mask)


def squared_hinge(labels, preact, activation="identity", mask=None):
    labels, preact, mask = _flatten_time(labels, preact, mask)
    out = get_activation(activation)(preact)
    y = 2.0 * labels - 1.0
    return _apply_mask_mean(torch.clamp_min(1.0 - y * out, 0.0) ** 2, mask)


def kl_divergence(labels, preact, activation="softmax", mask=None):
    labels, preact, mask = _flatten_time(labels, preact, mask)
    out = torch.clamp(get_activation(activation)(preact), 1e-10, 1.0)
    lab = torch.clamp(labels, 1e-10, 1.0)
    return _apply_mask_mean(labels * (torch.log(lab) - torch.log(out)), mask)


def poisson(labels, preact, activation="identity", mask=None):
    labels, preact, mask = _flatten_time(labels, preact, mask)
    out = get_activation(activation)(preact)
    return _apply_mask_mean(out - labels * torch.log(torch.clamp_min(out, 1e-10)), mask)


def cosine_proximity(labels, preact, activation="identity", mask=None):
    labels, preact, mask = _flatten_time(labels, preact, mask)
    out = get_activation(activation)(preact)
    num = (labels * out).sum(dim=-1)
    den = (torch.linalg.vector_norm(labels, dim=-1)
           * torch.linalg.vector_norm(out, dim=-1) + 1e-10)
    return _apply_mask_mean((-num / den)[..., None], mask)


def mape(labels, preact, activation="identity", mask=None):
    labels, preact, mask = _flatten_time(labels, preact, mask)
    out = get_activation(activation)(preact)
    per = (100.0 * torch.abs((labels - out)
                            / torch.clamp_min(torch.abs(labels), 1e-10))
           / labels.shape[-1])
    return _apply_mask_mean(per, mask)


def wasserstein(labels, preact, activation="identity", mask=None):
    """≡ lossfunctions.impl.LossWasserstein — critic loss y·f(x) (labels
    are ±1 for real/generated in the WGAN recipe)."""
    labels, preact, mask = _flatten_time(labels, preact, mask)
    out = get_activation(activation)(preact)
    return _apply_mask_mean(labels * out / labels.shape[-1], mask)


def multilabel(labels, preact, activation="identity", mask=None):
    """≡ lossfunctions.impl.LossMultiLabel — BP-MLL pairwise ranking
    loss (Zhang & Zhou): per example, mean over (positive, negative)
    label pairs of exp(-(o_p - o_n)). Vectorized over the P×N pair grid
    — no per-pair host loop; examples lacking a positive or a negative
    contribute zero, as in the reference."""
    labels, preact, mask = _flatten_time(labels, preact, mask)
    out = get_activation(activation)(preact)
    pos = (labels > 0.5).to(out.dtype)                      # (B, L)
    neg = 1.0 - pos
    # exp(o_n - o_p) summed over the pair grid = (Σ_n e^{o_n} w_n)(Σ_p
    # e^{-o_p} w_p) — O(L) instead of O(L²) via the product factorization
    e_neg = (torch.exp(out) * neg).sum(dim=-1)
    e_pos = (torch.exp(-out) * pos).sum(dim=-1)
    n_pairs = pos.sum(-1) * neg.sum(-1)
    per_ex = torch.where(n_pairs > 0,
                         e_neg * e_pos / torch.clamp_min(n_pairs, 1.0),
                         torch.zeros_like(n_pairs))
    return _apply_mask_mean(per_ex[..., None], mask)


class LossFMeasure:
    """≡ lossfunctions.impl.LossFMeasure — differentiable 1 − F_β over
    the WHOLE minibatch (soft TP/FP/FN from probabilities). Binary only:
    one sigmoid column, or two softmax columns (positive = column 1)."""

    def __init__(self, beta=1.0):
        if beta <= 0:
            raise ValueError(f"LossFMeasure: beta must be > 0, got {beta}")
        self.beta = float(beta)

    def __call__(self, labels, preact, activation=None, mask=None):
        labels, preact, mask = _flatten_time(labels, preact, mask)
        n_col = preact.shape[-1]
        if n_col == 1:
            p = get_activation(activation or "sigmoid")(preact)[..., 0]
            y = labels[..., 0]
        elif n_col == 2:
            p = get_activation(activation or "softmax")(preact)[..., 1]
            y = labels[..., 1]
        else:
            raise ValueError(
                f"LossFMeasure supports 1 or 2 output columns, got {n_col}")
        if mask is not None:
            m = mask.reshape(y.shape).to(p.dtype)
            p, y = p * m, y * m
        tp = (y * p).sum()
        fp = ((1.0 - y) * p).sum()
        fn = (y * (1.0 - p)).sum()
        b2 = self.beta ** 2
        f = (1.0 + b2) * tp / torch.clamp_min((1.0 + b2) * tp + b2 * fn + fp,
                                              1e-8)
        return 1.0 - f


class LossMixtureDensity:
    """≡ lossfunctions.impl.LossMixtureDensity — mixture-density-network
    NLL (Bishop 1994). Network output layout per example:
    [mixture logits (K) | log σ (K) | means (K·labelWidth)], i.e.
    nOut = K·(labelWidth + 2); isotropic σ per component. The whole
    K-component log-likelihood lowers to one logsumexp — no per-component
    branching."""

    def __init__(self, gaussians, labelWidth):
        self.gaussians = int(gaussians)
        self.labelWidth = int(labelWidth)

    def nOut(self):
        return self.gaussians * (self.labelWidth + 2)

    def _split(self, preact):
        k, d = self.gaussians, self.labelWidth
        if preact.shape[-1] != k * (d + 2):
            raise ValueError(
                f"LossMixtureDensity: expected nOut = K(d+2) = {k * (d + 2)}"
                f" (K={k} gaussians, labelWidth={d}), got "
                f"{preact.shape[-1]}")
        log_alpha = torch.log_softmax(preact[..., :k], dim=-1)
        log_sigma = torch.clamp(preact[..., k:2 * k], -10.0, 10.0)
        mu = preact[..., 2 * k:].reshape(*preact.shape[:-1], k, d)
        return log_alpha, log_sigma, mu

    def log_prob(self, labels, preact):
        """Per-example log p(y) under the mixture; (B,)."""
        d = self.labelWidth
        log_alpha, log_sigma, mu = self._split(preact)
        sq = ((labels[..., None, :] - mu) ** 2).sum(-1)       # (B, K)
        log_n = (-0.5 * sq / torch.exp(2.0 * log_sigma)
                 - d * log_sigma - 0.5 * d * math.log(2 * math.pi))
        return torch.logsumexp(log_alpha + log_n, dim=-1)

    def __call__(self, labels, preact, activation=None, mask=None):
        # activation must stay identity: the loss owns its own
        # softmax/exp parameterization of the mixture
        labels, preact, mask = _flatten_time(labels, preact, mask)
        return _apply_mask_mean(-self.log_prob(labels, preact)[..., None],
                                mask)

    def sample(self, preact, generator=None):
        """Draw one y per example from the predicted mixture, from
        `generator` (on the output's device)."""
        log_alpha, log_sigma, mu = self._split(preact)
        comp = torch.multinomial(torch.softmax(log_alpha, dim=-1), 1,
                                 generator=generator)[..., 0]        # (B,)
        sel = torch.take_along_dim(mu, comp[..., None, None],
                                   dim=-2)[..., 0, :]
        sig = torch.take_along_dim(torch.exp(log_sigma), comp[..., None],
                                   dim=-1)
        eps = torch.randn(sel.shape, generator=generator, dtype=sel.dtype,
                          device=sel.device)
        return sel + sig * eps


class LossWasserstein:
    """Object form of `wasserstein` (name parity with
    lossfunctions.impl.LossWasserstein)."""

    def __call__(self, labels, preact, activation=None, mask=None):
        return wasserstein(labels, preact, activation or "identity", mask)


class LossMultiLabel:
    """Object form of `multilabel` (name parity with
    lossfunctions.impl.LossMultiLabel)."""

    def __call__(self, labels, preact, activation=None, mask=None):
        return multilabel(labels, preact, activation or "identity", mask)


LOSSES = {
    "mcxent": mcxent,
    "negativeloglikelihood": mcxent,  # ND4J aliases NLL to MCXENT semantics
    "xent": xent,
    "mse": mse,
    "squared_loss": mse,
    "l2": l2,
    "mae": mae,
    "l1": l1,
    "hinge": hinge,
    "squared_hinge": squared_hinge,
    "kl_divergence": kl_divergence,
    "reconstruction_crossentropy": xent,
    "poisson": poisson,
    "cosine_proximity": cosine_proximity,
    "mean_absolute_percentage_error": mape,
    "mape": mape,
    "wasserstein": wasserstein,
    "multilabel": multilabel,
    "fmeasure": LossFMeasure(),       # β=1; use LossFMeasure(beta=…) to tune
}


def get_loss(name):
    if callable(name):
        return name
    key = str(name).lower()
    if key not in LOSSES:
        raise ValueError(f"Unknown loss '{name}'. Available: {sorted(LOSSES)}")
    return LOSSES[key]


class LossFunction:
    MCXENT = "mcxent"
    NEGATIVELOGLIKELIHOOD = "negativeloglikelihood"
    XENT = "xent"
    MSE = "mse"
    L1 = "l1"
    L2 = "l2"
    MAE = "mae"
    HINGE = "hinge"
    SQUARED_HINGE = "squared_hinge"
    KL_DIVERGENCE = "kl_divergence"
    POISSON = "poisson"
    COSINE_PROXIMITY = "cosine_proximity"
    MEAN_ABSOLUTE_PERCENTAGE_ERROR = "mape"
    WASSERSTEIN = "wasserstein"
    MULTILABEL = "multilabel"
    FMEASURE = "fmeasure"


# -- configurable loss objects (≡ nd4j lossfunctions.impl.LossMCXENT /
# LossBinaryXENT / LossMSE with weights + label smoothing) ---------------
class _WeightedLoss:
    """Callable loss config: per-output weights and label smoothing.
    Instances pass straight through get_loss (callables are accepted) and
    survive config JSON via __dict__ round-trip."""

    def __init__(self, weights=None, labelSmoothing=0.0):
        self.weights = None if weights is None else [float(w)
                                                     for w in weights]
        self.labelSmoothing = float(labelSmoothing)

    def _smooth(self, labels):
        s = self.labelSmoothing
        if not s:
            return labels
        k = labels.shape[-1]
        return labels * (1.0 - s) + s / k

    def _w(self, like):
        return None if self.weights is None else torch.tensor(
            self.weights, dtype=like.dtype, device=like.device)


class LossMCXENT(_WeightedLoss):
    """Weights scale the labels — valid here because CE is linear in the
    label vector, so label-scaling == per-element loss scaling."""

    def __call__(self, labels, preact, activation=None, mask=None):
        labels = self._smooth(labels)
        w = self._w(labels)
        if w is not None:
            labels = labels * w
        return mcxent(labels, preact, activation=activation or "softmax",
                      mask=mask)


class LossNegativeLogLikelihood(LossMCXENT):
    pass


class LossBinaryXENT(_WeightedLoss):
    def _smooth(self, labels):
        s = self.labelSmoothing
        # binary smoothing: y*(1-s) + 0.5*s (reference LossBinaryXENT)
        return labels if not s else labels * (1.0 - s) + 0.5 * s

    def __call__(self, labels, preact, activation=None, mask=None):
        labels = self._smooth(labels)
        w = self._w(preact)
        if w is None:
            return xent(labels, preact,
                        activation=activation or "sigmoid", mask=mask)
        # weights must scale the PER-ELEMENT loss: BCE is not linear in
        # the labels, label-scaling would make the loss unbounded below
        labels2, preact2, mask2 = _flatten_time(labels, preact, mask)
        if (activation or "sigmoid") == "sigmoid":
            x, z = preact2, labels2
            per = (torch.clamp_min(x, 0) - x * z
                   + torch.log1p(torch.exp(-torch.abs(x))))
        else:
            p = torch.clamp(get_activation(activation)(preact2), 1e-7,
                            1 - 1e-7)
            per = -(labels2 * torch.log(p)
                    + (1 - labels2) * torch.log(1 - p))
        return _apply_mask_mean(w * per, mask2)


class LossMSE(_WeightedLoss):
    def __call__(self, labels, preact, activation=None, mask=None):
        labels = self._smooth(labels)
        if self.weights is None:
            return mse(labels, preact, activation=activation or "identity",
                       mask=mask)
        w = self._w(preact)
        out = get_activation(activation or "identity")(preact)
        labels2, out2, mask2 = _flatten_time(labels, out, mask)
        # same /nOut normalization as unweighted mse(): identity weights
        # must be a no-op
        per = w * (labels2 - out2) ** 2 / labels2.shape[-1]
        return _apply_mask_mean(per, mask2)
