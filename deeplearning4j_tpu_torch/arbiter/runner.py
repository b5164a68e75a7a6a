"""Hyperparameter optimization: a copy of
`deeplearning4j_tpu/arbiter/runner.py`, which is numpy only (≡
arbiter-core ::
optimize.generator.RandomSearchGenerator / GridSearchCandidateGenerator,
optimize.runner.LocalOptimizationRunner, scoring score functions) plus a
TPE-style Bayesian generator (the reference left Bayesian strategies to
plugins; here it's built in).

Candidates are plain dicts; the user supplies `model_builder(params) →
anything` and `scorer(model) → float`. The runner is sequential by
design — each candidate's training already saturates the card; arbiter's
thread-pool parallelism maps to running candidates on separate hosts.
"""
from __future__ import annotations

import itertools
import time

import numpy as np

from deeplearning4j_tpu_torch.arbiter.spaces import ParameterSpace


class CandidateGenerator:
    def __init__(self, search_space):
        self.space = dict(search_space)

    def has_more(self):
        return True

    def next_candidate(self):
        raise NotImplementedError

    def report(self, params, score):
        """Feedback hook for adaptive generators."""


class RandomSearchGenerator(CandidateGenerator):
    """≡ RandomSearchGenerator."""

    def __init__(self, search_space, seed=42):
        super().__init__(search_space)
        self.rng = np.random.default_rng(seed)

    def next_candidate(self):
        return {k: (v.sample(self.rng) if isinstance(v, ParameterSpace)
                    else v) for k, v in self.space.items()}


class GridSearchCandidateGenerator(CandidateGenerator):
    """≡ GridSearchCandidateGenerator — cartesian product, exhausted once."""

    def __init__(self, search_space, discretizationCount=5):
        super().__init__(search_space)
        axes = []
        for k, v in self.space.items():
            vals = v.grid(discretizationCount) if isinstance(
                v, ParameterSpace) else [v]
            axes.append([(k, val) for val in vals])
        self._product = list(itertools.product(*axes))
        self._idx = 0

    def has_more(self):
        return self._idx < len(self._product)

    def next_candidate(self):
        cand = dict(self._product[self._idx])
        self._idx += 1
        return cand


class TPEGenerator(CandidateGenerator):
    """Tree-structured Parzen Estimator: after `startupTrials` random
    candidates, split observed trials into good/bad by score quantile and
    sample candidates that maximize the good/bad density ratio (kernel
    density over each continuous/integer dim; categorical frequency for
    discrete)."""

    def __init__(self, search_space, seed=42, startupTrials=10, gamma=0.25,
                 nEI=24, minimize=True):
        super().__init__(search_space)
        self.rng = np.random.default_rng(seed)
        self.startup = int(startupTrials)
        self.gamma = float(gamma)
        self.nEI = int(nEI)
        self.minimize = minimize
        self.history = []  # (params, score)

    def report(self, params, score):
        self.history.append((params, float(score)))

    def _split(self):
        scores = np.asarray([s for _, s in self.history])
        order = np.argsort(scores if self.minimize else -scores)
        n_good = max(1, int(np.ceil(self.gamma * len(order))))
        good = [self.history[i][0] for i in order[:n_good]]
        bad = [self.history[i][0] for i in order[n_good:]] or good
        return good, bad

    @staticmethod
    def _kde_logpdf(x, samples, bw):
        d = (x - np.asarray(samples)[:, None]) / bw
        return np.log(np.maximum(
            np.exp(-0.5 * d * d).mean(0) / (bw * np.sqrt(2 * np.pi)),
            1e-300))

    def next_candidate(self):
        if len(self.history) < self.startup:
            return {k: (v.sample(self.rng) if isinstance(v, ParameterSpace)
                        else v) for k, v in self.space.items()}
        good, bad = self._split()
        out = {}
        for k, sp in self.space.items():
            if not isinstance(sp, ParameterSpace):
                out[k] = sp
                continue
            if hasattr(sp, "value"):  # FixedValue
                out[k] = sp.value
                continue
            g_vals = [p[k] for p in good]
            b_vals = [p[k] for p in bad]
            if hasattr(sp, "values"):  # discrete: sample by good-frequency
                vals, counts = np.unique(
                    [sp.values.index(v) for v in g_vals],
                    return_counts=True)
                probs = np.ones(len(sp.values))
                probs[vals] += counts * len(sp.values)
                probs /= probs.sum()
                out[k] = sp.values[int(self.rng.choice(len(sp.values),
                                                       p=probs))]
                continue
            # continuous/integer: draw nEI from the good KDE, keep best ratio
            lo, hi = float(sp.lo), float(sp.hi)
            log = getattr(sp, "log", False)
            tf = np.log if log else (lambda a: np.asarray(a, float))
            inv = np.exp if log else (lambda a: a)
            g = tf(g_vals)
            b = tf(b_vals)
            span = (tf([hi])[0] - tf([lo])[0]) or 1.0
            bw = max(span * 0.1, 1e-6)
            cand = g[self.rng.integers(len(g), size=self.nEI)] + \
                self.rng.normal(0, bw, self.nEI)
            cand = np.clip(cand, tf([lo])[0], tf([hi])[0])
            ratio = (self._kde_logpdf(cand, g, bw)
                     - self._kde_logpdf(cand, b, bw))
            best = inv(cand[int(np.argmax(ratio))])
            out[k] = int(round(best)) if isinstance(
                sp.lo, int) and not log else float(best)
        return out


class OptimizationResult:
    def __init__(self, params, score, model, index, duration_s):
        self.params = params
        self.score = score
        self.model = model
        self.index = index
        self.duration_s = duration_s


class LocalOptimizationRunner:
    """≡ optimize.runner.LocalOptimizationRunner."""

    def __init__(self, generator, model_builder, scorer, maxCandidates=10,
                 minimize=True, keep_models=False):
        self.generator = generator
        # a declarative network space (MultiLayerSpace /
        # ComputationGraphSpace) IS a model builder: no hand-written fn
        if hasattr(model_builder, "model_builder"):
            model_builder = model_builder.model_builder()
        self.model_builder = model_builder
        self.scorer = scorer
        self.maxCandidates = int(maxCandidates)
        self.minimize = minimize
        self.keep_models = keep_models
        self.results = []

    def execute(self):
        for i in range(self.maxCandidates):
            if not self.generator.has_more():
                break
            params = self.generator.next_candidate()
            t0 = time.perf_counter()
            model = self.model_builder(params)
            score = float(self.scorer(model))
            self.generator.report(params, score)
            self.results.append(OptimizationResult(
                params, score, model if self.keep_models else None, i,
                time.perf_counter() - t0))
        return self.bestResult()

    def bestResult(self):
        if not self.results:
            return None
        key = (lambda r: r.score) if self.minimize else (lambda r: -r.score)
        return min(self.results, key=key)

    def bestScore(self):
        r = self.bestResult()
        return None if r is None else r.score

    def numCandidatesCompleted(self):
        return len(self.results)
