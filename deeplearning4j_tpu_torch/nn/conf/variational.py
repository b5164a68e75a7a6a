"""VAE reconstruction distributions: the port of
`deeplearning4j_tpu/nn/conf/variational.py` (≡ deeplearning4j-nn ::
conf.layers.variational.{GaussianReconstructionDistribution,
BernoulliReconstructionDistribution, ExponentialReconstructionDistribution,
CompositeReconstructionDistribution}).

A distribution maps the decoder head's pre-activation block of
`num_params(n)` units to a log-likelihood of the `n` observed features,
and to a mean reconstruction, as tensor functions of the pre-activation;
the composite partitions the feature and parameter axes and sums the
blocks' log-probabilities (the reference iterates its component
distributions the same way).
"""
from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.activations import get_activation

_LOG_2PI = 1.8378770664093453


class ReconstructionDistribution:
    """Base contract: parameter layout along the last axis."""

    def num_params(self, n_features):
        raise NotImplementedError

    def log_prob(self, x, pre):
        """Sum of per-feature log p(x | params) over the last axis.
        x: (..., n), pre: (..., num_params(n)) → (...,)."""
        raise NotImplementedError

    def mean(self, pre):
        """Mean reconstruction from the params. (..., P) → (..., n)."""
        raise NotImplementedError


class GaussianReconstructionDistribution(ReconstructionDistribution):
    """Params [mean | log(var)], activation applied to the mean block."""

    def __init__(self, activation="identity"):
        self.activation = activation

    def num_params(self, n_features):
        return 2 * n_features

    def _split(self, pre):
        if pre.shape[-1] % 2:
            raise ValueError(
                f"Gaussian reconstruction params must have even width "
                f"[mean | logvar], got {pre.shape[-1]}")
        n = pre.shape[-1] // 2
        mu = get_activation(self.activation)(pre[..., :n])
        logvar = pre[..., n:]
        return mu, logvar

    def log_prob(self, x, pre):
        if pre.shape[-1] != 2 * x.shape[-1]:
            raise ValueError(
                f"Gaussian reconstruction: params width {pre.shape[-1]} != "
                f"2 x features {x.shape[-1]}")
        mu, logvar = self._split(pre)
        return -0.5 * (logvar + (x - mu) ** 2 / torch.exp(logvar)
                       + _LOG_2PI).sum(-1)

    def mean(self, pre):
        return self._split(pre)[0]


class BernoulliReconstructionDistribution(ReconstructionDistribution):
    """Params are logits (sigmoid activation, applied inside a stable
    log-sigmoid form when computing the likelihood)."""

    def __init__(self, activation="sigmoid"):
        self.activation = activation

    def num_params(self, n_features):
        return n_features

    def log_prob(self, x, pre):
        if self.activation == "sigmoid":
            # stable BCE on logits
            per = torch.clamp_min(pre, 0) - pre * x \
                + torch.log1p(torch.exp(-torch.abs(pre)))
            return -per.sum(-1)
        p = torch.clamp(get_activation(self.activation)(pre), 1e-7, 1 - 1e-7)
        return (x * torch.log(p) + (1 - x) * torch.log1p(-p)).sum(-1)

    def mean(self, pre):
        return get_activation(self.activation)(pre)


class ExponentialReconstructionDistribution(ReconstructionDistribution):
    """Params γ with rate λ = exp(γ): log p(x) = γ − exp(γ)·x  (x ≥ 0);
    mean reconstruction 1/λ = exp(−γ)."""

    def __init__(self, activation="identity"):
        self.activation = activation

    def num_params(self, n_features):
        return n_features

    def log_prob(self, x, pre):
        gamma = get_activation(self.activation)(pre)
        gamma = torch.clamp(gamma, -20.0, 20.0)
        return (gamma - torch.exp(gamma) * x).sum(-1)

    def mean(self, pre):
        gamma = torch.clamp(get_activation(self.activation)(pre), -20.0,
                            20.0)
        return torch.exp(-gamma)


class CompositeReconstructionDistribution(ReconstructionDistribution):
    """Per-feature-block composition: block i models `size_i` features
    with its own distribution. Feature axis is partitioned in order;
    the param axis is partitioned by each block's num_params."""

    def __init__(self, blocks=None):
        # blocks: [(size, ReconstructionDistribution), ...]
        self.blocks = [(int(s), d) for s, d in (blocks or [])]
        if not self.blocks:
            raise ValueError(
                "CompositeReconstructionDistribution needs >=1 block — use "
                ".Builder().addDistribution(size, dist).build()")

    class Builder:
        def __init__(self):
            self._blocks = []

        def addDistribution(self, size, distribution):
            self._blocks.append((int(size), distribution))
            return self

        def build(self):
            return CompositeReconstructionDistribution(self._blocks)

    def num_params(self, n_features):
        total_feat = sum(s for s, _ in self.blocks)
        if total_feat != n_features:
            raise ValueError(
                f"Composite blocks cover {total_feat} features but input "
                f"has {n_features}")
        return sum(d.num_params(s) for s, d in self.blocks)

    def _spans(self):
        f = p = 0
        for s, d in self.blocks:
            np_ = d.num_params(s)
            yield (f, f + s), (p, p + np_), d
            f += s
            p += np_

    def log_prob(self, x, pre):
        total = 0.0
        for (f0, f1), (p0, p1), d in self._spans():
            total = total + d.log_prob(x[..., f0:f1], pre[..., p0:p1])
        return total

    def mean(self, pre):
        outs = [d.mean(pre[..., p0:p1])
                for (_, _), (p0, p1), d in self._spans()]
        return torch.cat(outs, dim=-1)


_NAMED = {
    "gaussian": GaussianReconstructionDistribution,
    "bernoulli": BernoulliReconstructionDistribution,
    "exponential": ExponentialReconstructionDistribution,
}


def resolve_reconstruction_distribution(spec):
    """str name | ReconstructionDistribution instance → instance."""
    if isinstance(spec, ReconstructionDistribution):
        return spec
    key = str(spec).lower()
    if key not in _NAMED:
        raise ValueError(
            f"Unknown reconstruction distribution '{spec}'. Available: "
            f"{sorted(_NAMED)} or a ReconstructionDistribution instance")
    return _NAMED[key]()
