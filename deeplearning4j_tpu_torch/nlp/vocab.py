"""Vocabulary cache (≡ deeplearning4j-nlp :: models.word2vec.wordstore.
VocabCache / AbstractCache): word↔index maps, frequencies, the unigram^0.75
negative-sampling table, and frequent-word subsampling probabilities: a
copy of `deeplearning4j_tpu/nlp/vocab.py` (float64 numpy).
"""
from __future__ import annotations

import numpy as np


class VocabCache:
    def __init__(self):
        self.word2idx = {}
        self.idx2word = []
        self.counts = []

    # -- building --------------------------------------------------------
    def add(self, word, count=1):
        if word not in self.word2idx:
            self.word2idx[word] = len(self.idx2word)
            self.idx2word.append(word)
            self.counts.append(0)
        self.counts[self.word2idx[word]] += count

    def prune(self, min_count):
        keep = [(w, c) for w, c in zip(self.idx2word, self.counts)
                if c >= min_count]
        keep.sort(key=lambda wc: -wc[1])
        self.word2idx = {w: i for i, (w, _) in enumerate(keep)}
        self.idx2word = [w for w, _ in keep]
        self.counts = [c for _, c in keep]

    # -- queries (≡ VocabCache surface) ----------------------------------
    def numWords(self):
        return len(self.idx2word)

    def containsWord(self, word):
        return word in self.word2idx

    def indexOf(self, word):
        return self.word2idx.get(word, -1)

    def wordAtIndex(self, idx):
        return self.idx2word[idx]

    def wordFrequency(self, word):
        i = self.word2idx.get(word)
        return 0 if i is None else self.counts[i]

    def totalWordOccurrences(self):
        return int(sum(self.counts))

    def words(self):
        return list(self.idx2word)

    # -- sampling helpers ------------------------------------------------
    def negative_table(self, power=0.75):
        """Unigram^power distribution (≡ Word2Vec's negative-sampling
        table, as a probability vector rather than a 100M-slot array)."""
        p = np.asarray(self.counts, np.float64) ** power
        return p / p.sum()

    def keep_probs(self, sample=1e-3):
        """Per-word keep probability for frequent-word subsampling
        (word2vec's t-threshold formula)."""
        if not sample:
            return np.ones(len(self.counts))
        freq = np.asarray(self.counts, np.float64)
        freq = freq / max(1.0, freq.sum())
        keep = np.sqrt(sample / np.maximum(freq, 1e-12))
        return np.clip(keep, 0.0, 1.0)


def build_vocab(sentences_tokens, min_count=1):
    vocab = VocabCache()
    for toks in sentences_tokens:
        for t in toks:
            vocab.add(t)
    vocab.prune(min_count)
    return vocab
