"""GloVe: the port of `deeplearning4j_tpu/nlp/glove.py` (≡
deeplearning4j-nlp :: models.glove.Glove).

Co-occurrence counting is host-side (a dict with 1/distance weighting, in
insertion order, as in the JAX package: `list(co.keys())` fixes the pair
order its seeded permutation shuffles). The weighted least-squares step —
f(X)·(wᵢ·w̃ⱼ + bᵢ + b̃ⱼ − log X)² averaged over the batch's real pairs,
with per-parameter AdaGrad (history starting at 1e-8) — runs on the
device over the rows a batch touches; a row's summed gradient updates
its history and then the row, as the JAX package's dense update does.
The starting tables are `jax.random.split` then two ranged uniforms,
equal to the JAX package's bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve
from deeplearning4j_tpu_torch.nlp.tokenization import (
    CollectionSentenceIterator, DefaultTokenizerFactory)
from deeplearning4j_tpu_torch.nlp.vocab import build_vocab
from deeplearning4j_tpu_torch.nlp.word2vec import (WordVectors,
                                                   _drop_host_copies,
                                                   _host_copy, _leaf,
                                                   _segment_sum)
from deeplearning4j_tpu_torch.ops.random import seed_key, split, uniform


def _glove_step(params, hist, lr, rows, cols, log_x, f_w, mask):
    """One AdaGrad step, in place on `params` and `hist` (both dicts of
    "w", "wc", "b", "bc"); returns the loss."""
    with torch.enable_grad():
        wi = _leaf(params["w"][rows])
        wj = _leaf(params["wc"][cols])
        bi = _leaf(params["b"][rows])
        bj = _leaf(params["bc"][cols])
        diff = (wi * wj).sum(-1) + bi + bj - log_x
        loss = ((f_w * diff * diff * mask).sum()
                / torch.clamp(mask.sum(), min=1.0))
        grads = torch.autograd.grad(loss, (wi, wj, bi, bj))
    for name, ids, g in zip(("w", "wc", "b", "bc"), (rows, cols, rows, cols),
                            grads):
        r, g = _segment_sum(ids, g)
        h = hist[name].index_select(0, r) + g * g
        hist[name].index_copy_(0, r, h)
        p = params[name]
        p.index_copy_(0, r, p.index_select(0, r) - lr * g / torch.sqrt(
            h + 1e-8))
    return loss.detach()


class Glove(WordVectors):
    class Builder:
        def __init__(self):
            self._min_count = 1
            self._layer_size = 100
            self._seed = 42
            self._window = 5
            self._lr = 0.05
            self._epochs = 25
            self._xmax = 100.0
            self._alpha = 0.75
            self._batch = 4096
            self._symmetric = True
            self._iter = None
            self._tok = DefaultTokenizerFactory()
            self._device = None

        def minWordFrequency(self, v):
            self._min_count = int(v); return self

        def layerSize(self, v):
            self._layer_size = int(v); return self

        def seed(self, v):
            self._seed = int(v); return self

        def windowSize(self, v):
            self._window = int(v); return self

        def learningRate(self, v):
            self._lr = float(v); return self

        def epochs(self, v):
            self._epochs = int(v); return self

        def xMax(self, v):
            self._xmax = float(v); return self

        def alpha(self, v):
            self._alpha = float(v); return self

        def batchSize(self, v):
            self._batch = int(v); return self

        def symmetric(self, v):
            self._symmetric = bool(v); return self

        def iterate(self, sentence_iterator):
            if isinstance(sentence_iterator, (list, tuple)):
                sentence_iterator = CollectionSentenceIterator(
                    sentence_iterator)
            self._iter = sentence_iterator
            return self

        def tokenizerFactory(self, tok):
            self._tok = tok; return self

        def device(self, device):
            """Where the tables live and the steps run: the card unless
            "cpu" (resolved at `fit`)."""
            self._device = device; return self

        def build(self):
            return Glove(self)

    def __init__(self, builder):
        self.b = builder
        self.vocab = None
        self.params = None
        self.hist = None
        self._rng = np.random.default_rng(builder._seed)

    def _table(self):
        # GloVe convention: final vectors = w + context w
        return _host_copy(self, "table",
                          lambda: self.params["w"] + self.params["wc"])

    def _cooccurrences(self, sentences_ids):
        co = {}
        for ids in sentences_ids:
            n = len(ids)
            for i in range(n):
                for j in range(max(0, i - self.b._window), i):
                    w = 1.0 / (i - j)
                    co[(ids[i], ids[j])] = co.get((ids[i], ids[j]), 0.0) + w
                    if self.b._symmetric:
                        co[(ids[j], ids[i])] = co.get(
                            (ids[j], ids[i]), 0.0) + w
        return co

    def _init_params(self, v):
        d = self.b._layer_size
        dev = resolve(self.b._device)
        k1, k2 = split(seed_key(self.b._seed))
        scale = 0.5 / d
        self.params = {
            "w": uniform(k1, (v, d), dev, -scale, scale),
            "wc": uniform(k2, (v, d), dev, -scale, scale),
            "b": torch.zeros(v, dtype=torch.float32, device=dev),
            "bc": torch.zeros(v, dtype=torch.float32, device=dev),
        }
        self.hist = {k: torch.full_like(p, 1e-8)
                     for k, p in self.params.items()}
        _drop_host_copies(self)

    def fit(self):
        toks = [self.b._tok.create(s).getTokens() for s in self.b._iter]
        self.vocab = build_vocab(toks, self.b._min_count)
        w2i = self.vocab.word2idx
        ids = [[w2i[t] for t in s if t in w2i] for s in toks]
        co = self._cooccurrences(ids)
        if not co:
            raise ValueError("no co-occurrences (corpus too small)")
        self._init_params(self.vocab.numWords())

        pairs = np.asarray(list(co.keys()), np.int32)
        xs = np.asarray(list(co.values()), np.float64)
        log_x = np.log(xs).astype(np.float32)
        f_w = np.minimum((xs / self.b._xmax) ** self.b._alpha,
                         1.0).astype(np.float32)
        B = self.b._batch
        n = len(pairs)
        pad = (-n) % B
        mask = np.concatenate([np.ones(n, np.float32),
                               np.zeros(pad, np.float32)])
        pairs = np.concatenate([pairs, np.zeros((pad, 2), np.int32)])
        log_x = np.concatenate([log_x, np.zeros(pad, np.float32)])
        f_w = np.concatenate([f_w, np.zeros(pad, np.float32)])

        dev = self.params["w"].device
        for _ in range(self.b._epochs):
            perm = self._rng.permutation(len(pairs))
            for s in range(0, len(pairs), B):
                sl = perm[s:s + B]
                rows, cols = (torch.from_numpy(pairs[sl, k].astype(np.int64))
                              .to(dev) for k in (0, 1))
                _glove_step(self.params, self.hist, self.b._lr, rows, cols,
                            *(torch.from_numpy(a[sl]).to(dev)
                              for a in (log_x, f_w, mask)))
        _drop_host_copies(self)
        return self
