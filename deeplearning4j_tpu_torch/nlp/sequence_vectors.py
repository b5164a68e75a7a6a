"""SequenceVectors (≡ deeplearning4j-nlp ::
models.sequencevectors.SequenceVectors + AbstractSequenceIterator /
sequence.Sequence<SequenceElement>).

The reference's generic embedding trainer: Word2Vec and ParagraphVectors
are specializations of it, and users drive it directly to embed ANY
discrete-element sequences (product ids, event streams, graph walks)
with a custom sequence iterator.

A copy of `deeplearning4j_tpu/nlp/sequence_vectors.py`. It reuses the
whole Word2Vec pipeline — vocab building, dynamic windows, subsampling,
unigram^0.75 negatives, and the skip-gram step — over caller-supplied
PRE-TOKENIZED sequences (no tokenizer involved, so elements may contain
any characters). All WordVectors lookups (``getWordVector``,
``wordsNearest``, ``similarity``) work on the elements.
"""
from __future__ import annotations

from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec

__all__ = ["AbstractSequenceIterator", "SequenceVectors"]


def _elements(seq):
    if isinstance(seq, str):
        raise TypeError(
            "SequenceVectors takes sequences of ELEMENTS (lists of "
            "strings), not raw sentence strings — iterating a string "
            "would embed single characters. Use Word2Vec for text, or "
            "split the sentence first.")
    return [str(e) for e in seq]


class AbstractSequenceIterator:
    """≡ sequencevectors.iterators.AbstractSequenceIterator — iterates
    sequences (lists) of string elements. Build from any collection."""

    def __init__(self, sequences):
        self._seqs = [_elements(s) for s in sequences]

    def __iter__(self):
        return iter(self._seqs)

    def sequences(self):
        return self._seqs


class SequenceVectors(Word2Vec):
    """Built via the same fluent Builder; ``iterate`` takes an
    AbstractSequenceIterator or a plain list of element lists."""

    class Builder(Word2Vec.Builder):
        def __init__(self):
            super().__init__()
            self._min_count = 1          # reference default for sequences

        def iterate(self, sequence_iterator):
            self._iter = sequence_iterator
            return self

        def build(self):
            return SequenceVectors(self)

    def _tokenized(self):
        it = self.b._iter
        if it is None:
            raise ValueError("SequenceVectors.Builder().iterate(...) not set")
        if isinstance(it, AbstractSequenceIterator):
            return it.sequences()
        return [_elements(seq) for seq in it]
