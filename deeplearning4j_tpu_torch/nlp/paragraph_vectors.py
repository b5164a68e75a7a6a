"""ParagraphVectors / doc2vec: the port of
`deeplearning4j_tpu/nlp/paragraph_vectors.py` (≡ deeplearning4j-nlp ::
models.paragraphvectors.ParagraphVectors, PV-DBOW + PV-DM).

PV-DBOW: the label (document) vector plays the skip-gram center role and
predicts each word of its document — the SGNS step with the doc table as
syn0. PV-DM: mean(doc vector, context word vectors) predicts the center
word. `inferVector` gradient-descends a fresh doc vector with all trained
tables frozen. The host draws (the shuffle, the negatives, the start of
an inferred vector) come from the model's numpy generator in the JAX
package's order, so they are equal bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nlp.word2vec import (Word2Vec,
                                                   _drop_host_copies, _leaf,
                                                   _sgd, _sgns_step,
                                                   _to_numpy)
from deeplearning4j_tpu_torch.ops.random import seed_key, uniform


def _pvdm_step(params, lr, doc_ids, ctx_ids, ctx_mask, center, negatives,
               weights):
    """PV-DM: v = mean(doc vec + context word vecs) → SGNS vs center, in
    place on params["docs"], ["syn0"] and ["syn1"]; the loss is a mean
    over the batch's real rows."""
    with torch.enable_grad():
        dv = _leaf(params["docs"][doc_ids])           # (B, D)
        wv = _leaf(params["syn0"][ctx_ids])           # (B, C, D)
        u_pos = _leaf(params["syn1"][center])
        u_neg = _leaf(params["syn1"][negatives])
        cnt = ctx_mask.sum(-1, keepdim=True) + 1.0
        v = (dv + (wv * ctx_mask[..., None]).sum(1)) / cnt
        pos = F.logsigmoid((v * u_pos).sum(-1))
        neg = F.logsigmoid(-torch.einsum("bd,bkd->bk", v, u_neg)).sum(-1)
        loss = (-((pos + neg) * weights).sum()
                / torch.clamp(weights.sum(), min=1.0))
        g_d, g_w, g_pos, g_neg = torch.autograd.grad(
            loss, (dv, wv, u_pos, u_neg))
    _sgd(params["docs"], doc_ids, g_d, lr)
    _sgd(params["syn0"], ctx_ids, g_w, lr)
    _sgd(params["syn1"], torch.cat([center, negatives.reshape(-1)]),
         torch.cat([g_pos, g_neg.reshape(-1, g_neg.shape[-1])]), lr)
    return loss.detach()


#: inferVector steps the vector once per chunk of this many ids, one chunk
#: after another (the JAX package's fixed compile shape; the port keeps
#: the order of updates it gives)
_INFER_CHUNK = 128


def _infer_step(doc_vec, syn1, lr, context, negatives, mask):
    """One descent step of a document vector against frozen syn1."""
    with torch.enable_grad():
        v = _leaf(doc_vec)
        pos = F.logsigmoid(syn1[context] @ v) * mask
        neg = F.logsigmoid(-(syn1[negatives] @ v)) * mask[:, None]
        loss = -(pos.sum() + neg.sum())
        (g,) = torch.autograd.grad(loss, (v,))
    return doc_vec - lr * g


class LabelledDocument:
    """≡ text.documentiterator.LabelledDocument."""

    def __init__(self, content, labels):
        self.content = content
        self.labels = labels if isinstance(labels, (list, tuple)) else [labels]


class ParagraphVectors(Word2Vec):
    class Builder(Word2Vec.Builder):
        def __init__(self):
            super().__init__()
            self._min_count = 1
            self._docs = None
            self._dm = False
            self._train_words = True

        def iterate(self, docs):
            """Accepts LabelledDocuments, (label, text) pairs, or raw
            strings (auto-labelled DOC_i)."""
            norm = []
            for i, d in enumerate(docs):
                if isinstance(d, LabelledDocument):
                    norm.append((d.labels[0], d.content))
                elif isinstance(d, tuple):
                    norm.append(d)
                else:
                    norm.append((f"DOC_{i}", d))
            self._docs = norm
            return self

        def sequenceLearningAlgorithm(self, name):
            self._dm = "DM" in str(name).upper()
            return self

        def trainWordVectors(self, flag):
            self._train_words = bool(flag)
            return self

        def build(self):
            if getattr(self, "_hs", False):
                raise ValueError(
                    "ParagraphVectors trains PV-DBOW/PV-DM with negative "
                    "sampling; useHierarchicSoftmax is supported on "
                    "Word2Vec/SequenceVectors (the shared SGNS pipeline)")
            return ParagraphVectors(self)

    def __init__(self, builder):
        super().__init__(builder)
        self.labels = [lab for lab, _ in builder._docs]
        self.label2idx = {lab: i for i, lab in enumerate(self.labels)}

    def _tokenized(self):
        return [self.b._tok.create(text).getTokens()
                for _, text in self.b._docs]

    def fit(self):
        toks = self._tokenized()
        self.buildVocab(toks)
        self._init_params()
        d = self.b._layer_size
        self.params["docs"] = (uniform(
            seed_key(self.b._seed + 1), (len(self.labels), d),
            self.params["syn0"].device) - 0.5) / d
        w2i = self.vocab.word2idx
        docs_ids = [[w2i[t] for t in s if t in w2i] for s in toks]

        if self.b._train_words:
            self._run_epochs(lambda: self._pairs(docs_ids),
                             self.b._epochs * self.b._iterations)
        if self.b._dm:
            self._fit_dm(docs_ids)
        else:
            self._fit_dbow(docs_ids)
        _drop_host_copies(self)
        return self

    # -- PV-DBOW: doc id predicts every word in the doc ------------------
    def _fit_dbow(self, docs_ids):
        centers = np.concatenate(
            [np.full(len(ids), di, np.int32)
             for di, ids in enumerate(docs_ids) if ids] or
            [np.zeros(0, np.int32)])
        contexts = np.concatenate(
            [np.asarray(ids, np.int32)
             for ids in docs_ids if ids] or [np.zeros(0, np.int32)])
        if len(centers) == 0:
            return
        dbow = {"syn0": self.params["docs"], "syn1": self.params["syn1"]}
        for _ in range(self.b._epochs * self.b._iterations):
            for cen, ctx, negs, w in self._batches(centers, contexts):
                _sgns_step(dbow, self.b._lr, *self._put(cen, ctx, negs, w))

    # -- PV-DM -----------------------------------------------------------
    def _dm_rows(self, docs_ids):
        """(doc, center, context ids) for every token of every doc."""
        rows = []
        for di, ids in enumerate(docs_ids):
            n = len(ids)
            for i in range(n):
                ctx = [ids[j] for j in range(max(0, i - self.b._window),
                                             min(n, i + self.b._window + 1))
                       if j != i]
                rows.append((di, ids[i], ctx))
        return rows

    def _fit_dm(self, docs_ids):
        neg_p = self.vocab.negative_table()
        B, K, C = self.b._batch, max(1, self.b._negative), 2 * self.b._window
        rows = self._dm_rows(docs_ids)
        if not rows:
            return
        for _ in range(self.b._epochs * self.b._iterations):
            order = self._rng.permutation(len(rows))
            doc_a = np.zeros(len(rows), np.int32)
            cen_a = np.zeros(len(rows), np.int32)
            ctx_a = np.zeros((len(rows), C), np.int32)
            msk_a = np.zeros((len(rows), C), np.float32)
            for k, r in enumerate(order):
                di, ci, ctx = rows[r]
                doc_a[k], cen_a[k] = di, ci
                m = min(len(ctx), C)
                ctx_a[k, :m] = ctx[:m]
                msk_a[k, :m] = 1.0
            n = len(rows)
            pad = (-n) % B
            w = np.concatenate([np.ones(n, np.float32),
                                np.zeros(pad, np.float32)])
            doc_a = np.concatenate([doc_a, np.zeros(pad, np.int32)])
            cen_a = np.concatenate([cen_a, np.zeros(pad, np.int32)])
            ctx_a = np.concatenate([ctx_a, np.zeros((pad, C), np.int32)])
            msk_a = np.concatenate([msk_a, np.zeros((pad, C), np.float32)])
            negs = self._rng.choice(self.vocab.numWords(), size=(n + pad, K),
                                    p=neg_p).astype(np.int32)
            for s in range(0, n + pad, B):
                _pvdm_step(self.params, self.b._lr, *self._put(
                    doc_a[s:s + B], ctx_a[s:s + B], msk_a[s:s + B],
                    cen_a[s:s + B], negs[s:s + B], w[s:s + B]))

    # -- surface ---------------------------------------------------------
    def getLabelVector(self, label):
        return self._host("docs")[self.label2idx[label]]

    def inferVector(self, text, steps=50, lr=0.05):
        toks = self.b._tok.create(text).getTokens()
        ids = [self.vocab.indexOf(t) for t in toks]
        ids = np.asarray([i for i in ids if i >= 0], np.int32)
        d = self.b._layer_size
        vec = (self._rng.random(d).astype(np.float32) - 0.5) / d
        if len(ids) == 0:
            return vec
        # padded to whole chunks, as the JAX package pads to its compile
        # shape: the negatives are drawn for the padded length
        n = len(ids)
        pad = (-n) % _INFER_CHUNK
        mask = np.concatenate([np.ones(n, np.float32),
                               np.zeros(pad, np.float32)])
        ids = np.concatenate([ids, np.zeros(pad, np.int32)])
        neg_p = self.vocab.negative_table()
        syn1 = self.params["syn1"]
        K = max(1, self.b._negative)
        vec_t, ids_t, mask_t = self._put(vec, ids, mask)
        for _ in range(steps):
            negs = self._put(self._rng.choice(
                self.vocab.numWords(), size=(len(ids), K),
                p=neg_p).astype(np.int32))[0]
            for s in range(0, len(ids), _INFER_CHUNK):
                e = s + _INFER_CHUNK
                vec_t = _infer_step(vec_t, syn1, lr, ids_t[s:e], negs[s:e],
                                    mask_t[s:e])
        return _to_numpy(vec_t)

    def similarityToLabel(self, text, label):
        v = self.inferVector(text)
        lv = self.getLabelVector(label)
        den = max(np.linalg.norm(v) * np.linalg.norm(lv), 1e-12)
        return float(v @ lv / den)

    def nearestLabels(self, text, topN=5):
        v = self.inferVector(text)
        tab = self._host("docs")
        sims = tab @ v / np.maximum(
            np.linalg.norm(tab, axis=1) * max(np.linalg.norm(v), 1e-12),
            1e-12)
        order = np.argsort(-sims)[:topN]
        return [self.labels[i] for i in order]
