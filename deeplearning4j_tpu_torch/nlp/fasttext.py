"""FastText: the port of `deeplearning4j_tpu/nlp/fasttext.py` (≡
deeplearning4j-nlp :: models.fasttext.FastText — subword skip-gram).

Each word's input vector is the mean of its own embedding plus hashed
character n-gram bucket embeddings (FNV-1a hashing into a fixed bucket
table, as fastText does). The per-word n-gram id matrix is precomputed
host-side into a (V, max_ngrams) padded table, kept on the device too, so
a step gathers its rows there: masked-mean gather + SGNS loss + update
of the rows it touched. OOV words get vectors from their n-grams alone.

The (V + buckets, D) table is drawn in row chunks from the seed key (the
partitionable threefry hashes each element's flat index, so a chunk is
the slice of one whole draw): at fastText's two million buckets and
D = 300 it is 2.49 GB, and one draw over its 621 M indices would not fit
beside it.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nlp.word2vec import (Word2Vec,
                                                   _drop_host_copies,
                                                   _host_copy, _leaf, _sgd,
                                                   _to_numpy)
from deeplearning4j_tpu_torch.ops.random import seed_key, uniform

#: elements of the table drawn at once
_INIT_CHUNK = 1 << 22


def _fnv1a(s):
    h = 2166136261
    for ch in s.encode("utf-8"):
        h = (h ^ ch) * 16777619 & 0xFFFFFFFFFFFFFFFF
    return h


def char_ngrams(word, min_n=3, max_n=6):
    w = f"<{word}>"
    out = []
    for n in range(min_n, max_n + 1):
        for i in range(len(w) - n + 1):
            g = w[i:i + n]
            if g != w:
                out.append(g)
    return out


def _ft_step(params, lr, ngram_ids, ngram_mask, context, negatives, weights):
    """ngram_ids: (B, G) rows into the combined [word | bucket] table;
    row 0 of the mask selects real entries (word id always present). The
    loss is a mean over the batch's real pairs."""
    with torch.enable_grad():
        emb = _leaf(params["syn0"][ngram_ids])        # (B, G, D)
        u_pos = _leaf(params["syn1"][context])
        u_neg = _leaf(params["syn1"][negatives])
        cnt = torch.clamp(ngram_mask.sum(-1, keepdim=True), min=1.0)
        v = (emb * ngram_mask[..., None]).sum(1) / cnt
        pos = F.logsigmoid((v * u_pos).sum(-1))
        neg = F.logsigmoid(-torch.einsum("bd,bkd->bk", v, u_neg)).sum(-1)
        loss = (-((pos + neg) * weights).sum()
                / torch.clamp(weights.sum(), min=1.0))
        g_e, g_pos, g_neg = torch.autograd.grad(loss, (emb, u_pos, u_neg))
    _sgd(params["syn0"], ngram_ids, g_e, lr)
    _sgd(params["syn1"], torch.cat([context, negatives.reshape(-1)]),
         torch.cat([g_pos, g_neg.reshape(-1, g_neg.shape[-1])]), lr)
    return loss.detach()


def _uniform_table(seed, rows, d, device):
    """(uniform(PRNGKey(seed), (rows, d)) - 0.5) / d, drawn in row
    chunks of about `_INIT_CHUNK` elements."""
    out = torch.empty((rows, d), dtype=torch.float32, device=device)
    step = max(1, _INIT_CHUNK // d)
    key = seed_key(seed)
    for s in range(0, rows, step):
        e = min(rows, s + step)
        out[s:e] = (uniform(key, (e - s, d), device, offset=s * d) - 0.5) / d
    return out


class FastText(Word2Vec):
    class Builder(Word2Vec.Builder):
        def __init__(self):
            super().__init__()
            self._min_count = 1
            self._buckets = 1 << 17
            self._min_n, self._max_n = 3, 6
            self._max_ngrams = 24

        def bucket(self, v):
            self._buckets = int(v); return self

        def minN(self, v):
            self._min_n = int(v); return self

        def maxN(self, v):
            self._max_n = int(v); return self

        def build(self):
            if getattr(self, "_hs", False):
                raise ValueError(
                    "FastText's subword step trains negative sampling; "
                    "useHierarchicSoftmax is supported on "
                    "Word2Vec/SequenceVectors (the shared SGNS pipeline)")
            return FastText(self)

    def __init__(self, builder):
        super().__init__(builder)
        self._ngram_ids = None
        self._ngram_mask = None

    def _word_ngram_row(self, word, widx=None):
        """Row of table ids: [word_id?, bucket ids...] padded to max."""
        G = self.b._max_ngrams
        v = self.vocab.numWords()
        ids, mask = [], []
        if widx is not None:
            ids.append(widx)
            mask.append(1.0)
        for g in char_ngrams(word, self.b._min_n, self.b._max_n)[:G - len(ids)]:
            ids.append(v + _fnv1a(g) % self.b._buckets)
            mask.append(1.0)
        while len(ids) < G:
            ids.append(0)
            mask.append(0.0)
        return np.asarray(ids, np.int32), np.asarray(mask, np.float32)

    def _ngram_rows(self):
        """(V, G) n-gram ids and mask of every vocabulary word."""
        rows = [self._word_ngram_row(w, i)
                for i, w in enumerate(self.vocab.idx2word)]
        return np.stack([r[0] for r in rows]), np.stack([r[1] for r in rows])

    def _init_params(self):
        v, d = self.vocab.numWords(), self.b._layer_size
        dev = self._dev()
        table = _uniform_table(self.b._seed, v + self.b._buckets, d, dev)
        self.params = {"syn0": table,
                       "syn1": torch.zeros((v, d), dtype=torch.float32,
                                           device=dev)}
        self._ngram_ids, self._ngram_mask = self._ngram_rows()
        self._ngram_dev = (
            torch.from_numpy(self._ngram_ids.astype(np.int64)).to(dev),
            torch.from_numpy(self._ngram_mask).to(dev))
        _drop_host_copies(self)

    def _run_epochs(self, pairs_fn, epochs):
        ids_t, mask_t = self._ngram_dev
        for _ in range(epochs):
            centers, contexts = pairs_fn()
            for cen, ctx, negs, w in self._batches(centers, contexts):
                cen, ctx, negs, w = self._put(cen, ctx, negs, w)
                _ft_step(self.params, self.b._lr, ids_t[cen], mask_t[cen],
                         ctx, negs, w)
        _drop_host_copies(self)

    # -- lookup: in-vocab mean(word+ngrams); OOV from ngrams alone -------
    def _table(self):
        # the (V, G, D) gather runs on the tables' device in row blocks;
        # the (V, D) means are copied to the host once and reused until
        # the tables change
        return _host_copy(self, "table", self._means)

    def _means(self):
        ids_t, mask_t = self._ngram_dev
        syn0 = self.params["syn0"]
        step = max(1, _INIT_CHUNK // (ids_t.shape[1] * syn0.shape[1]))
        parts = []
        for s in range(0, ids_t.shape[0], step):
            m = mask_t[s:s + step]
            emb = syn0[ids_t[s:s + step]]
            cnt = torch.clamp(m.sum(-1, keepdim=True), min=1.0)
            parts.append((emb * m[..., None]).sum(1) / cnt)
        return torch.cat(parts)

    def getWordVector(self, word):
        i = self.vocab.indexOf(word)
        if i >= 0:
            return self._table()[i]
        # OOV: n-grams only, from their rows of syn0 alone
        ids, mask = self._word_ngram_row(word)
        if mask.sum() == 0:
            raise KeyError(f"no n-grams for OOV word {word!r}")
        syn0 = self.params["syn0"]
        emb = _to_numpy(syn0[torch.from_numpy(ids.astype(np.int64)).to(
            syn0.device)])
        return (emb * mask[:, None]).sum(0) / max(mask.sum(), 1.0)
