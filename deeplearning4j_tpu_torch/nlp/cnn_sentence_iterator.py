"""CnnSentenceDataSetIterator (≡ deeplearning4j-nlp ::
org.deeplearning4j.iterator.CnnSentenceDataSetIterator +
provider.LabeledSentenceProvider / CollectionLabeledSentenceProvider):
a copy of `deeplearning4j_tpu/nlp/cnn_sentence_iterator.py` over the
port's `DataSet` and `DataSetIterator`.

Sentences → word-vector tensors for CNN/RNN text classifiers:

- Format.CNN2D: features (B, 1, maxLen, vectorSize) — the "sentence as
  image" layout Kim-CNN uses (1 channel, words on the H axis)
- Format.CNN1D / RNN: features (B, vectorSize, maxLen) — channels-first
  time series, the layout Convolution1D/LSTM layers consume

Variable sentence lengths are handled the reference way: per-batch pad
to the longest sentence (capped at maxSentenceLength) + a feature mask
of shape (B, maxLen); unknown words are skipped (or mapped to
``unknownWordHandling="UseUnknown"`` → the UNK vector). Batches are
host-assembled numpy — the device consumes them through the same fit
path as every other iterator.
"""
from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import DataSetIterator

__all__ = ["CollectionLabeledSentenceProvider", "CnnSentenceDataSetIterator"]


class CollectionLabeledSentenceProvider:
    """≡ iterator.provider.CollectionLabeledSentenceProvider."""

    def __init__(self, sentences, labels):
        if len(sentences) != len(labels):
            raise ValueError("sentences and labels must align")
        self.sentences = list(sentences)
        self.labels = [str(l) for l in labels]
        self._pos = 0

    def hasNext(self):
        return self._pos < len(self.sentences)

    def nextSentence(self):
        s, l = self.sentences[self._pos], self.labels[self._pos]
        self._pos += 1
        return s, l

    def reset(self):
        self._pos = 0

    def totalNumSentences(self):
        return len(self.sentences)

    def allLabels(self):
        return sorted(set(self.labels))

    def numLabelClasses(self):
        return len(self.allLabels())


class CnnSentenceDataSetIterator(DataSetIterator):
    class Format:
        CNN2D = "CNN2D"
        CNN1D = "CNN1D"
        RNN = "RNN"

    class Builder:
        def __init__(self, format="CNN2D"):
            self._format = format
            self._provider = None
            self._wv = None
            self._max_len = 256
            self._batch = 32
            self._unknown = "RemoveWord"   # or "UseUnknown"
            self._unknown_word = None
            self._tokenizer = None
            self._min_length = 1

        def sentenceProvider(self, p):
            self._provider = p; return self

        def wordVectors(self, wv):
            self._wv = wv; return self

        def maxSentenceLength(self, v):
            self._max_len = int(v); return self

        def minibatchSize(self, v):
            self._batch = int(v); return self

        def unknownWordHandling(self, v):
            self._unknown = str(v); return self

        def useUnknown(self, word):
            self._unknown = "UseUnknown"
            self._unknown_word = word
            return self

        def tokenizerFactory(self, tok):
            self._tokenizer = tok; return self

        def build(self):
            if self._provider is None or self._wv is None:
                raise ValueError("sentenceProvider and wordVectors required")
            return CnnSentenceDataSetIterator(self)

    def __init__(self, b):
        super().__init__(b._batch)
        self.b = b
        self.provider = b._provider
        self.wv = b._wv
        self.labels_list = self.provider.allLabels()
        self._label_idx = {l: i for i, l in enumerate(self.labels_list)}
        # vector size probed from any in-vocab word (reference: lookupTable)
        self.vector_size = int(
            np.asarray(self.wv._table()).shape[1])

    # -- protocol --------------------------------------------------------
    def numExamples(self):
        return self.provider.totalNumSentences()

    def totalOutcomes(self):
        return len(self.labels_list)

    def inputColumns(self):
        return self.vector_size

    def getLabels(self):
        return self.labels_list

    def reset(self):
        super().reset()
        self.provider.reset()

    def hasNext(self):
        return self.provider.hasNext()

    def _tokens(self, sentence):
        if self.b._tokenizer is not None:
            tok = self.b._tokenizer.create(sentence)
            toks = [tok.nextToken() for _ in range(tok.countTokens())]
        else:
            toks = sentence.lower().split()
        out = []
        for t in toks:
            if self.wv.hasWord(t):
                out.append(self.wv.getWordVector(t))
            elif self.b._unknown == "UseUnknown":
                if self.b._unknown_word and self.wv.hasWord(
                        self.b._unknown_word):
                    out.append(self.wv.getWordVector(self.b._unknown_word))
                else:
                    out.append(np.zeros(self.vector_size, np.float32))
            # RemoveWord: skip
        return out[: self.b._max_len]

    def next(self, num=None):
        self._check_has_next()
        num = num or self._batch
        vecs, labels = [], []
        while self.provider.hasNext() and len(vecs) < num:
            s, lab = self.provider.nextSentence()
            tv = self._tokens(s)
            if len(tv) < self.b._min_length:
                tv = [np.zeros(self.vector_size, np.float32)]
            vecs.append(np.stack(tv))
            labels.append(self._label_idx[lab])
        bsz = len(vecs)
        max_len = max(v.shape[0] for v in vecs)
        mask = np.zeros((bsz, max_len), np.float32)
        dense = np.zeros((bsz, max_len, self.vector_size), np.float32)
        for i, v in enumerate(vecs):
            dense[i, : v.shape[0]] = v
            mask[i, : v.shape[0]] = 1.0
        y = np.eye(len(self.labels_list), dtype=np.float32)[labels]
        if self.b._format == self.Format.CNN2D:
            feats = dense[:, None, :, :]          # (B, 1, maxLen, vecSize)
        else:                                      # CNN1D / RNN layout
            feats = dense.transpose(0, 2, 1)       # (B, vecSize, maxLen)
        self._cursor += bsz
        return self._maybe_preprocess(DataSet(feats, y, featuresMask=mask))
