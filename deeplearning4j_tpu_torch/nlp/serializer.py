"""WordVectorSerializer (≡ deeplearning4j-nlp ::
loader.WordVectorSerializer) — exchange embeddings with the standard
word2vec C formats: a copy of `deeplearning4j_tpu/nlp/serializer.py`.
Files written by either package read back in the other with equal
tables.

Formats:
- TEXT  (word2vec -binary 0): header "V D\\n", then "word f1 f2 ... fD\\n".
- BINARY (word2vec -binary 1): header "V D\\n", then per word the
  whitespace-terminated token followed by D little-endian float32s and a
  trailing newline.

`readWord2VecModel` auto-detects the format; `loadStaticModel` returns a
lookup-only StaticWordVectors (the reference's memory-mapped static model —
here a plain numpy table: the vectors feed lookups or an
EmbeddingLayer via `embeddingLayerWeights`)."""
from __future__ import annotations

import os

import numpy as np

from deeplearning4j_tpu_torch.nlp.vocab import VocabCache
from deeplearning4j_tpu_torch.nlp.word2vec import WordVectors


class StaticWordVectors(WordVectors):
    """Lookup-only vectors (no trainer attached)."""

    def __init__(self, table, words):
        self._np_table = np.asarray(table, np.float32)
        self.vocab = VocabCache()
        for w in words:
            self.vocab.add(w)
        # WordVectors._table reads params["syn0"]
        self.params = {"syn0": self._np_table}

    def _table(self):
        return self._np_table

    @property
    def layer_size(self):
        return self._np_table.shape[1]


class WordVectorSerializer:
    """≡ loader.WordVectorSerializer (static-method surface)."""

    # -- write -----------------------------------------------------------
    @staticmethod
    def writeWord2VecModel(vectors, path, binary=False):
        """Write vectors in word2vec C format (text by default)."""
        table = vectors._table()
        vocab = vectors.vocab
        v, d = table.shape
        if binary:
            with open(path, "wb") as f:
                f.write(f"{v} {d}\n".encode("utf-8"))
                for i in range(v):
                    word = vocab.wordAtIndex(i)
                    f.write(word.encode("utf-8") + b" ")
                    f.write(table[i].astype("<f4").tobytes())
                    f.write(b"\n")
        else:
            with open(path, "w", encoding="utf-8") as f:
                f.write(f"{v} {d}\n")
                for i in range(v):
                    word = vocab.wordAtIndex(i)
                    vals = " ".join(f"{x:.6f}" for x in table[i])
                    f.write(f"{word} {vals}\n")

    # reference-compat aliases
    writeWordVectors = writeWord2VecModel

    # -- read ------------------------------------------------------------
    @staticmethod
    def _read_text(path):
        words, rows = [], []
        with open(path, "r", encoding="utf-8") as f:
            header = f.readline().split()
            v, d = int(header[0]), int(header[1])
            for line in f:
                parts = line.rstrip("\n").split(" ")
                if len(parts) < d + 1:
                    continue
                words.append(parts[0])
                rows.append(np.asarray(parts[1:d + 1], np.float32))
        if len(words) != v:
            raise ValueError(
                f"{path}: header promises {v} words, file has {len(words)}")
        return np.stack(rows), words

    @staticmethod
    def _read_binary(path):
        with open(path, "rb") as f:
            header = f.readline().decode("utf-8").split()
            v, d = int(header[0]), int(header[1])
            words, rows = [], []
            for _ in range(v):
                chars = []
                while True:
                    c = f.read(1)
                    if not c or c == b" ":
                        break
                    if c != b"\n":
                        chars.append(c)
                words.append(b"".join(chars).decode("utf-8"))
                vec = np.frombuffer(f.read(4 * d), dtype="<f4")
                rows.append(vec.astype(np.float32))
                nl = f.read(1)
                if nl not in (b"\n", b""):
                    f.seek(-1, os.SEEK_CUR)
        return np.stack(rows), words

    @staticmethod
    def _is_binary(path):
        with open(path, "rb") as f:
            f.readline()                 # header is text either way
            chunk = f.read(512)
        try:
            chunk.decode("utf-8")
        except UnicodeDecodeError:
            return True
        # pure-ASCII float text has no NULs / control bytes
        return any(b < 9 for b in chunk)

    @staticmethod
    def readWord2VecModel(path, binary=None):
        """-> StaticWordVectors; format auto-detected unless `binary` set."""
        if binary is None:
            binary = WordVectorSerializer._is_binary(path)
        table, words = (WordVectorSerializer._read_binary(path) if binary
                        else WordVectorSerializer._read_text(path))
        return StaticWordVectors(table, words)

    # reference-compat aliases
    loadStaticModel = readWord2VecModel
    loadTxtVectors = staticmethod(lambda path: (
        WordVectorSerializer.readWord2VecModel(path, binary=False)))

    # -- embedding-layer bridge -----------------------------------------
    @staticmethod
    def embeddingLayerWeights(vectors, extra_tokens=0, seed=0):
        """(V + extra, D) float32 init matrix for EmbeddingLayer: rows 0..V-1
        are the loaded vectors (row i = vocab index i); `extra_tokens`
        appends small-random rows (e.g. OOV/PAD ids) after the vocab."""
        table = vectors._table()
        if not extra_tokens:
            return table.copy()
        rng = np.random.default_rng(seed)
        d = table.shape[1]
        extra = (rng.random((extra_tokens, d), np.float32) - 0.5) / d
        return np.concatenate([table, extra], axis=0)
