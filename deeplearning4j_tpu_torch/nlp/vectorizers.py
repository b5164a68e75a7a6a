"""Text vectorizers (≡ deeplearning4j-nlp ::
org.deeplearning4j.bagofwords.vectorizer.BagOfWordsVectorizer /
TfidfVectorizer): a copy of `deeplearning4j_tpu/nlp/vectorizers.py`
returning the port's `DataSet`.

Reference shape: Builder with a tokenizer factory + sentence iterator,
``fit()`` builds the vocabulary, ``transform(text)`` returns a row
vector, ``vectorize(text, label)`` a DataSet — fed to dense classifiers.

Host-side counting (vocabulary statistics are not a device workload);
the produced (N, V) float32 matrices flow into the same fit/evaluate
paths as every other DataSet.
"""
from __future__ import annotations

import math

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nlp.tokenization import DefaultTokenizerFactory
from deeplearning4j_tpu_torch.nlp.vocab import build_vocab

__all__ = ["BagOfWordsVectorizer", "TfidfVectorizer"]


class _BaseVectorizer:
    class Builder:
        def __init__(self):
            self._tok = DefaultTokenizerFactory()
            self._min_count = 1
            self._iter = None
            self._labels = None

        def tokenizerFactory(self, tok):
            self._tok = tok; return self

        def minWordFrequency(self, v):
            self._min_count = int(v); return self

        def iterate(self, sentences):
            self._iter = list(sentences); return self

        def labels(self, labels):
            self._labels = [str(l) for l in labels]; return self

        def build(self):
            raise NotImplementedError("use a concrete vectorizer's Builder")

    def __init__(self, b):
        self.b = b
        self.vocab = None
        # declaration order, as the reference's LabelsSource.indexOf —
        # sorting would silently permute one-hot columns
        self._labels_list = (list(dict.fromkeys(b._labels))
                             if b._labels else None)

    def _tokens(self, text):
        return self.b._tok.create(text).getTokens()

    def fit(self, sentences=None):
        sentences = sentences if sentences is not None else self.b._iter
        if sentences is None:
            raise ValueError("no corpus: pass sentences or Builder.iterate")
        self._fit_docs_impl([self._tokens(s) for s in sentences])
        return self

    def _fit_docs_impl(self, docs):
        self.vocab = build_vocab(docs, self.b._min_count)
        if self.vocab.numWords() == 0:
            raise ValueError("empty vocabulary after min-count pruning")
        self._post_fit(docs)   # docs stay local — not retained past fit

    def _post_fit(self, docs):
        pass

    def vocabSize(self):
        return self.vocab.numWords()

    def _check_fit(self):
        if self.vocab is None:
            raise ValueError("call fit() first")

    def _count(self, row, toks):
        for t in toks:
            i = self.vocab.indexOf(t)
            if i >= 0:
                row[i] += 1.0

    def transform(self, text):
        """One row vector (V,) for a text (or pre-tokenized sequence)."""
        self._check_fit()
        toks = (self._tokens(text) if isinstance(text, str)
                else [str(t) for t in text])
        row = np.zeros(self.vocab.numWords(), np.float32)
        self._fill(row, toks)
        return row

    def transformAll(self, sentences):
        return np.stack([self.transform(s) for s in sentences])

    def vectorize(self, text, label):
        """≡ vectorize(String, String) → DataSet with a one-hot label."""
        if self._labels_list is None:
            raise ValueError("Builder.labels(...) not set")
        if str(label) not in self._labels_list:
            raise ValueError(
                f"unknown label {label!r}; Builder.labels(...) declared "
                f"{self._labels_list}")
        y = np.zeros((1, len(self._labels_list)), np.float32)
        y[0, self._labels_list.index(str(label))] = 1.0
        return DataSet(self.transform(text)[None, :], y)

    def fitTransform(self, sentences):
        docs = [self._tokens(s) for s in sentences]   # tokenize ONCE
        self._fit_docs_impl(docs)
        return self.transformAll(docs)   # transform accepts token lists


class BagOfWordsVectorizer(_BaseVectorizer):
    """Raw term counts (≡ bagofwords.vectorizer.BagOfWordsVectorizer)."""

    class Builder(_BaseVectorizer.Builder):
        def build(self):
            return BagOfWordsVectorizer(self)

    def _fill(self, row, toks):
        self._count(row, toks)


class TfidfVectorizer(_BaseVectorizer):
    """tf·idf weights with the reference's smoothed idf
    (log(1 + N / df)) — fit() computes document frequencies."""

    class Builder(_BaseVectorizer.Builder):
        def build(self):
            return TfidfVectorizer(self)

    def _post_fit(self, docs):
        n_docs = len(docs)
        v = self.vocab.numWords()
        df = np.zeros(v, np.float64)
        for toks in docs:
            for i in {self.vocab.indexOf(t) for t in set(toks)}:
                if i >= 0:
                    df[i] += 1.0
        self._idf = np.array(
            [math.log(1.0 + n_docs / df[i]) if df[i] else 0.0
             for i in range(v)], np.float32)

    def _fill(self, row, toks):
        self._count(row, toks)
        row *= self._idf / max(len(toks), 1)   # tf = count/len(doc)

    def tfidfWord(self, word, doc_tokens):
        """≡ TfidfVectorizer.tfidfWord — the weight one word gets in one
        document."""
        self._check_fit()
        i = self.vocab.indexOf(word)
        if i < 0:
            return 0.0
        tf = doc_tokens.count(word) / max(len(doc_tokens), 1)
        return float(tf * self._idf[i])
