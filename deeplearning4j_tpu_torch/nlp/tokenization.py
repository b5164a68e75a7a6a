"""Tokenization (≡ deeplearning4j-nlp :: text.tokenization.tokenizer.*,
tokenizerfactory.DefaultTokenizerFactory / NGramTokenizerFactory,
preprocessor.CommonPreprocessor): a copy of
`deeplearning4j_tpu/nlp/tokenization.py`.

Host-side text handling — tokenization never touches the device; it
feeds integer id batches into the embedding-training steps.
"""
from __future__ import annotations

import re


class TokenPreProcess:
    """≡ tokenization.tokenizer.TokenPreProcess protocol."""

    def preProcess(self, token):
        return token


class CommonPreprocessor(TokenPreProcess):
    """Lowercase + strip punctuation/digits (≡ CommonPreprocessor)."""

    _PUNCT = re.compile(r"[\d.:,\"'()\[\]|/?!;]+")

    def preProcess(self, token):
        return self._PUNCT.sub("", token).lower()


class LowCasePreProcessor(TokenPreProcess):
    def preProcess(self, token):
        return token.lower()


class Tokenizer:
    """≡ tokenization.tokenizer.Tokenizer — iterator surface over tokens."""

    def __init__(self, tokens, pre=None):
        if pre is not None:
            tokens = [pre.preProcess(t) for t in tokens]
        self._tokens = [t for t in tokens if t]
        self._idx = 0

    def hasMoreTokens(self):
        return self._idx < len(self._tokens)

    def nextToken(self):
        tok = self._tokens[self._idx]
        self._idx += 1
        return tok

    def countTokens(self):
        return len(self._tokens)

    def getTokens(self):
        return list(self._tokens)


class TokenizerFactory:
    def setTokenPreProcessor(self, pre):
        self._pre = pre
        return self

    def getTokenPreProcessor(self):
        return getattr(self, "_pre", None)


class DefaultTokenizerFactory(TokenizerFactory):
    """Whitespace tokenizer (≡ DefaultTokenizerFactory)."""

    _pre = None

    def create(self, text):
        return Tokenizer(text.split(), self._pre)


class NGramTokenizerFactory(TokenizerFactory):
    """Word n-gram tokenizer (≡ NGramTokenizerFactory): emits all n-grams
    with minN <= n <= maxN joined by spaces."""

    _pre = None

    def __init__(self, minN=1, maxN=1):
        self.minN, self.maxN = int(minN), int(maxN)

    def create(self, text):
        words = Tokenizer(text.split(), self._pre).getTokens()
        out = []
        for n in range(self.minN, self.maxN + 1):
            for i in range(len(words) - n + 1):
                out.append(" ".join(words[i:i + n]))
        return Tokenizer(out)


class SentenceIterator:
    """≡ text.sentenceiterator.SentenceIterator protocol."""

    def nextSentence(self):
        raise NotImplementedError

    def hasNext(self):
        raise NotImplementedError

    def reset(self):
        raise NotImplementedError

    def __iter__(self):
        self.reset()
        while self.hasNext():
            yield self.nextSentence()


class CollectionSentenceIterator(SentenceIterator):
    """≡ CollectionSentenceIterator — iterate an in-memory list."""

    def __init__(self, sentences):
        self._sentences = list(sentences)
        self._idx = 0

    def nextSentence(self):
        s = self._sentences[self._idx]
        self._idx += 1
        return s

    def hasNext(self):
        return self._idx < len(self._sentences)

    def reset(self):
        self._idx = 0


class BasicLineIterator(SentenceIterator):
    """≡ BasicLineIterator — one sentence per line from a file path."""

    def __init__(self, path):
        self.path = path
        self.reset()

    def reset(self):
        with open(self.path, "r", encoding="utf-8") as f:
            self._lines = [ln.strip() for ln in f if ln.strip()]
        self._idx = 0

    def nextSentence(self):
        s = self._lines[self._idx]
        self._idx += 1
        return s

    def hasNext(self):
        return self._idx < len(self._lines)
