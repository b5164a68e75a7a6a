"""NLP (≡ deeplearning4j-nlp): Word2Vec, ParagraphVectors, GloVe,
FastText, tokenizers, sentence iterators, vocabulary cache: the port of
`deeplearning4j_tpu/nlp/`, with the same public names.

Every trainer takes its device from the builder's `device(...)`: the
card unless "cpu". `params_from_numpy(model, params, ...)` sets a
model's tables from the JAX package's `params` as numpy arrays."""
from deeplearning4j_tpu_torch.models.convert import (
    embedding_params_from_numpy as params_from_numpy)
from deeplearning4j_tpu_torch.nlp.tokenization import (
    BasicLineIterator, CollectionSentenceIterator, CommonPreprocessor,
    DefaultTokenizerFactory, LowCasePreProcessor, NGramTokenizerFactory,
    SentenceIterator, Tokenizer, TokenizerFactory)
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, build_vocab
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec, WordVectors
from deeplearning4j_tpu_torch.nlp.paragraph_vectors import (
    LabelledDocument, ParagraphVectors)
from deeplearning4j_tpu_torch.nlp.glove import Glove
from deeplearning4j_tpu_torch.nlp.fasttext import FastText, char_ngrams
from deeplearning4j_tpu_torch.nlp.serializer import (StaticWordVectors,
                                                     WordVectorSerializer)
from deeplearning4j_tpu_torch.nlp.cnn_sentence_iterator import (
    CnnSentenceDataSetIterator, CollectionLabeledSentenceProvider)
from deeplearning4j_tpu_torch.nlp.sequence_vectors import (
    AbstractSequenceIterator, SequenceVectors)
from deeplearning4j_tpu_torch.nlp.vectorizers import (BagOfWordsVectorizer,
                                                      TfidfVectorizer)

__all__ = [
    "WordVectorSerializer", "StaticWordVectors",
    "BasicLineIterator", "CollectionSentenceIterator", "CommonPreprocessor",
    "DefaultTokenizerFactory", "LowCasePreProcessor", "NGramTokenizerFactory",
    "SentenceIterator", "Tokenizer", "TokenizerFactory", "VocabCache",
    "build_vocab", "Word2Vec", "WordVectors", "LabelledDocument",
    "ParagraphVectors", "Glove", "FastText", "char_ngrams",
    "CnnSentenceDataSetIterator", "CollectionLabeledSentenceProvider",
    "SequenceVectors", "AbstractSequenceIterator",
    "BagOfWordsVectorizer", "TfidfVectorizer",
]
