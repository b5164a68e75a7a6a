"""Word2Vec: the port of `deeplearning4j_tpu/nlp/word2vec.py` (≡
deeplearning4j-nlp :: models.word2vec.Word2Vec and
models.embeddings.wordvectors.WordVectors).

Training pairs come from the host exactly as the JAX package makes them:
one numpy generator per model, the same draws in the same order, so the
pairs, the shuffle and the negatives are equal bit for bit. Each batch is
one step on the device (the card unless the builder's `device("cpu")`):
gathers of the rows the batch touches, the log-sigmoid loss, its
gradient with respect to those rows, and an SGD update of those rows
alone. The JAX package's update `p - lr * g` is dense over the whole
table, but a row with no gradient comes out of it unchanged, so updating
only the touched rows gives the same tables.

A row gathered k times in a batch gets the sum of its k gradients before
the update (`_segment_sum`). On the card `index_add_` adds with atomics in
no fixed order, so the port sums another way: a stable sort of the ids,
then `torch.segment_reduce` over each run of equal ids, which adds a run's
rows one after another in their batch order. A step repeated from the
same tables and batch gives the same tables bit for bit, on the card as
on the CPU.

`_sgns_step` and `_hs_step` return the SUM over pairs, not the mean: the
reference applies its learning rate per training pair.
"""
from __future__ import annotations

import heapq

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.device import resolve
from deeplearning4j_tpu_torch.nlp.tokenization import (
    CollectionSentenceIterator, DefaultTokenizerFactory)
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, build_vocab
from deeplearning4j_tpu_torch.ops.random import seed_key, uniform


def _build_huffman(counts):
    """Huffman tree over word counts (≡ the reference's
    VocabConstructor/Huffman pass) -> per-word padded path tables:
    points (V, L) int32 inner-node ids root-first, codes (V, L) float32
    binary codes, mask (V, L) float32 validity. Frequent words get short
    codes (prefix-free by construction). Ties break on (count, index)
    through `heapq`, as in the JAX package, so the tables are equal."""
    v = len(counts)
    if v <= 1:
        return (np.zeros((v, 1), np.int32), np.zeros((v, 1), np.float32),
                np.zeros((v, 1), np.float32))
    heap = [(int(c), i) for i, c in enumerate(counts)]
    heapq.heapify(heap)
    parent, side = {}, {}
    nxt = v
    while len(heap) > 1:
        c1, n1 = heapq.heappop(heap)
        c2, n2 = heapq.heappop(heap)
        parent[n1], parent[n2] = nxt, nxt
        side[n1], side[n2] = 0, 1
        heapq.heappush(heap, (c1 + c2, nxt))
        nxt += 1
    root = heap[0][1]
    paths, codes = [], []
    max_len = 1
    for w in range(v):
        p, c = [], []
        node = w
        while node != root:
            c.append(side[node])
            p.append(parent[node] - v)      # inner-node id, 0..V-2
            node = parent[node]
        p.reverse()
        c.reverse()
        paths.append(p)
        codes.append(c)
        max_len = max(max_len, len(p))
    points = np.zeros((v, max_len), np.int32)
    cod = np.zeros((v, max_len), np.float32)
    mask = np.zeros((v, max_len), np.float32)
    for w in range(v):
        n = len(paths[w])
        points[w, :n] = paths[w]
        cod[w, :n] = codes[w]
        mask[w, :n] = 1.0
    return points, cod, mask


# -- the device steps ------------------------------------------------------
def _segment_sum(ids, grads):
    """(unique ids ascending, each one's summed gradient rows): a stable
    sort, then one `segment_reduce` over the runs of equal ids, so the
    rows of a run are added in batch order on every device."""
    grads = grads.reshape((ids.numel(),) + tuple(grads.shape[ids.dim():]))
    ids = ids.reshape(-1)
    order = torch.sort(ids, stable=True)
    rows, counts = torch.unique_consecutive(order.values, return_counts=True)
    sums = torch.segment_reduce(grads[order.indices], "sum", lengths=counts,
                                axis=0)
    return rows, sums


def _sgd(table, ids, grads, lr):
    """table[r] -= lr * (summed gradient of r), for each row r in `ids`."""
    rows, g = _segment_sum(ids, grads)
    table.index_copy_(0, rows, table.index_select(0, rows) - lr * g)


def _leaf(x):
    return x.detach().requires_grad_()


def _sgns_step(params, lr, center, context, negatives, weights):
    """One skip-gram-negative-sampling SGD step over a batch, in place on
    params["syn0"] and params["syn1"]; returns the loss.

    center/context: (B,) int64; negatives: (B, K) int64; weights: (B,)
    0/1 mask so padded tail pairs contribute nothing.
    """
    syn0, syn1 = params["syn0"], params["syn1"]
    with torch.enable_grad():
        v = _leaf(syn0[center])                     # (B, D)
        u_pos = _leaf(syn1[context])                # (B, D)
        u_neg = _leaf(syn1[negatives])              # (B, K, D)
        pos = F.logsigmoid((v * u_pos).sum(-1))
        neg = F.logsigmoid(-torch.einsum("bd,bkd->bk", v, u_neg)).sum(-1)
        # sum, not mean — per-pair learning-rate semantics
        loss = -((pos + neg) * weights).sum()
        g_v, g_pos, g_neg = torch.autograd.grad(loss, (v, u_pos, u_neg))
    _sgd(syn0, center, g_v, lr)
    _sgd(syn1, torch.cat([context, negatives.reshape(-1)]),
         torch.cat([g_pos, g_neg.reshape(-1, g_neg.shape[-1])]), lr)
    return loss.detach()


def _hs_step(params, lr, center, context, points, codes, mask, weights):
    """One hierarchical-softmax SGD step (≡ the reference's
    HierarchicSoftmax learning algorithm), batched: every pair touches
    only its context word's ~log2(V) Huffman inner nodes, gathered as one
    (B, L, D) read. Padded path slots gather row 0 under mask 0."""
    syn0, syn1 = params["syn0"], params["syn1"]
    pts = points[context]                           # (B, L)
    with torch.enable_grad():
        v = _leaf(syn0[center])                     # (B, D)
        u = _leaf(syn1[pts])                        # (B, L, D)
        s = torch.einsum("bd,bld->bl", v, u)
        sign = 1.0 - 2.0 * codes[context]
        ll = F.logsigmoid(sign * s) * mask[context]
        loss = -(ll.sum(-1) * weights).sum()
        g_v, g_u = torch.autograd.grad(loss, (v, u))
    _sgd(syn0, center, g_v, lr)
    _sgd(syn1, pts, g_u, lr)
    return loss.detach()


def _to_numpy(x):
    if torch.is_tensor(x):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _host_copy(obj, name, make):
    """make() as a read-only float32 numpy array, taken once and kept on
    `obj` until its tables next change (`_drop_host_copies`)."""
    cache = obj.__dict__.setdefault("_host_cache", {})
    if name not in cache:
        a = _to_numpy(make())
        a.flags.writeable = False
        cache[name] = a
    return cache[name]


def _drop_host_copies(obj):
    obj.__dict__.pop("_host_cache", None)


class WordVectors:
    """Lookup/similarity surface (≡ embeddings.wordvectors.WordVectors).
    Lookups run in numpy on a host copy of the table, taken off the
    device once and reused until the tables next change."""

    vocab: VocabCache

    def _host(self, name):
        return _host_copy(self, name, lambda: self.params[name])

    def _table(self):
        return self._host("syn0")

    def hasWord(self, word):
        return self.vocab.containsWord(word)

    def getWordVector(self, word):
        i = self.vocab.indexOf(word)
        if i < 0:
            raise KeyError(f"word not in vocab: {word!r}")
        return self._table()[i]

    def getWordVectorMatrix(self, word):
        return self.getWordVector(word)

    def similarity(self, w1, w2):
        a, b = self.getWordVector(w1), self.getWordVector(w2)
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        if na == 0 or nb == 0:
            return 0.0
        return float(a @ b / (na * nb))

    def wordsNearest(self, word_or_vec, topN=10):
        if isinstance(word_or_vec, str):
            vec = self.getWordVector(word_or_vec)
            exclude = {word_or_vec}
        else:
            vec, exclude = np.asarray(word_or_vec, np.float32), set()
        tab = self._table()
        norms = np.linalg.norm(tab, axis=1) * max(np.linalg.norm(vec), 1e-12)
        sims = tab @ vec / np.maximum(norms, 1e-12)
        order = np.argsort(-sims)
        out = []
        for i in order:
            w = self.vocab.wordAtIndex(int(i))
            if w not in exclude:
                out.append(w)
            if len(out) >= topN:
                break
        return out

    def vocabSize(self):
        return self.vocab.numWords()


class Word2Vec(WordVectors):
    """≡ models.word2vec.Word2Vec — built via the same fluent Builder."""

    class Builder:
        def __init__(self):
            self._min_count = 5
            self._iterations = 1
            self._epochs = 1
            self._layer_size = 100
            self._seed = 42
            self._window = 5
            self._lr = 0.025
            self._negative = 5
            self._hs = False
            self._sample = 1e-3
            self._batch = 1024
            self._iter = None
            self._tok = DefaultTokenizerFactory()
            self._device = None

        def minWordFrequency(self, v):
            self._min_count = int(v); return self

        def iterations(self, v):
            self._iterations = int(v); return self

        def epochs(self, v):
            self._epochs = int(v); return self

        def layerSize(self, v):
            self._layer_size = int(v); return self

        def seed(self, v):
            self._seed = int(v); return self

        def windowSize(self, v):
            self._window = int(v); return self

        def learningRate(self, v):
            self._lr = float(v); return self

        def negativeSample(self, v):
            self._negative = int(v); return self

        def useHierarchicSoftmax(self, flag=True):
            """≡ Word2Vec.Builder.useHierarchicSoftmax: train against the
            Huffman-tree output layer instead of negative sampling (each
            pair updates its context's ~log2(V) inner nodes)."""
            self._hs = bool(flag); return self

        def sampling(self, v):
            self._sample = float(v); return self

        def batchSize(self, v):
            self._batch = int(v); return self

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
            return Word2Vec(self)

    def __init__(self, builder):
        self.b = builder
        self.vocab = VocabCache()
        self.params = None
        self._rng = np.random.default_rng(builder._seed)

    def _dev(self):
        return resolve(self.b._device)

    def _put(self, *arrays):
        """Host batch arrays to the tables' device: ids as int64, the
        rest as float32."""
        dev = self.params["syn0"].device
        return [torch.from_numpy(np.ascontiguousarray(
            a, np.int64 if np.issubdtype(a.dtype, np.integer)
            else np.float32)).to(dev) for a in arrays]

    # -- corpus → ids ----------------------------------------------------
    def _tokenized(self):
        out = []
        for sent in self.b._iter:
            out.append(self.b._tok.create(sent).getTokens())
        return out

    def buildVocab(self, sentences_tokens):
        self.vocab = build_vocab(sentences_tokens, self.b._min_count)

    def _init_params(self):
        v, d = self.vocab.numWords(), self.b._layer_size
        dev = self._dev()
        # jax.random.uniform(PRNGKey(seed), (v, d)) from the seed key
        # itself, no split
        syn0 = (uniform(seed_key(self.b._seed), (v, d), dev) - 0.5) / d
        # hierarchical softmax trains V-1 inner-node vectors instead of
        # per-word output vectors
        rows = max(v - 1, 1) if self.b._hs else v
        self.params = {"syn0": syn0,
                       "syn1": torch.zeros((rows, d), dtype=torch.float32,
                                           device=dev)}
        if self.b._hs:
            pts, codes, mask = _build_huffman(self.vocab.counts)
            self._hs_tables = (torch.from_numpy(pts).long().to(dev),
                               torch.from_numpy(codes).to(dev),
                               torch.from_numpy(mask).to(dev))
        _drop_host_copies(self)

    def _pairs(self, sentences_ids):
        """Skip-gram pairs with dynamic window + subsampling (host side)."""
        keep = self.vocab.keep_probs(self.b._sample)
        centers, contexts = [], []
        for ids in sentences_ids:
            ids = np.asarray(ids, np.int64)
            if self.b._sample:
                ids = ids[self._rng.random(len(ids)) < keep[ids]]
            n = len(ids)
            if n < 2:
                continue
            for i in range(n):
                b = self._rng.integers(1, self.b._window + 1)
                lo, hi = max(0, i - b), min(n, i + b + 1)
                for j in range(lo, hi):
                    if j != i:
                        centers.append(ids[i])
                        contexts.append(ids[j])
        return (np.asarray(centers, np.int32),
                np.asarray(contexts, np.int32))

    def _batches(self, centers, contexts):
        """Shared epoch batcher: shuffle, pad to the fixed batch shape,
        sample negatives from the unigram^0.75 table, yield host-side
        (center, context, negatives, weights) slices."""
        n = len(centers)
        if n == 0:
            return
        B, K = self.b._batch, max(1, self.b._negative)
        neg_p = self.vocab.negative_table()
        perm = self._rng.permutation(n)
        centers, contexts = centers[perm], contexts[perm]
        pad = (-n) % B
        weights = np.concatenate(
            [np.ones(n, np.float32), np.zeros(pad, np.float32)])
        centers = np.concatenate([centers, np.zeros(pad, np.int32)])
        contexts = np.concatenate([contexts, np.zeros(pad, np.int32)])
        if getattr(self.b, "_hs", False):   # HS path never reads them
            negs = np.zeros((len(centers), 1), np.int32)
        else:
            negs = self._rng.choice(self.vocab.numWords(),
                                    size=(len(centers), K),
                                    p=neg_p).astype(np.int32)
        for s in range(0, len(centers), B):
            yield (centers[s:s + B], contexts[s:s + B],
                   negs[s:s + B], weights[s:s + B])

    def _run_epochs(self, centers_contexts_fn, epochs):
        hs = getattr(self.b, "_hs", False)
        for _ in range(epochs):
            centers, contexts = centers_contexts_fn()
            for cen, ctx, negs, w in self._batches(centers, contexts):
                if hs:
                    pts, codes, mask = self._hs_tables
                    cen, ctx, w = self._put(cen, ctx, w)
                    _hs_step(self.params, self.b._lr, cen, ctx, pts, codes,
                             mask, w)
                else:
                    _sgns_step(self.params, self.b._lr,
                               *self._put(cen, ctx, negs, w))
        _drop_host_copies(self)

    def fit(self):
        toks = self._tokenized()
        self.buildVocab(toks)
        if self.vocab.numWords() == 0:
            raise ValueError("empty vocabulary after min-count pruning")
        self._init_params()
        w2i = self.vocab.word2idx
        sentences_ids = [[w2i[t] for t in s if t in w2i] for s in toks]
        self._run_epochs(lambda: self._pairs(sentences_ids),
                         self.b._epochs * self.b._iterations)
        return self
