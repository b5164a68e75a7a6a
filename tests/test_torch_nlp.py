"""The port's nlp/ (`deeplearning4j_tpu_torch/nlp/`) against the JAX
package's, on the CPU.

- Host-side work equal bit for bit: tokens and vocabularies, the
  negative table and keep probabilities, Huffman tables, skip-gram pairs
  and negatives, GloVe co-occurrences, FastText n-gram ids, BoW and TF-IDF
  matrices, CnnSentenceDataSetIterator batches in all three formats, and
  the starting tables (syn0, the document table, GloVe's `w`/`wc` after
  the C5 repair, FastText's table drawn in chunks).
- One step of each of the six steps (SGNS, HS, PV-DM, infer, FastText,
  GloVe) from the same tables, carried across with `params_from_numpy`,
  on a batch that repeats ids: tables and loss within STEP_RTOL (the
  inferred vector within INFER_RTOL). XLA
  contracts `p - lr * g` into a fused multiply-add, so bits are not the
  bar; a port step repeated from the same state is.
- Whole small fits at the JAX tests' own settings: tables within
  FIT_RTOL; `wordsNearest` lists equal where the cosine margin exceeds
  NEAREST_MARGIN.
- The JAX tests' contracts held on the port, files written by either
  package read by the other, and the three example twins.
"""
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nlp as J
import deeplearning4j_tpu_torch.nlp as T
from deeplearning4j_tpu.nlp import fasttext as jft
from deeplearning4j_tpu.nlp import glove as jgl
from deeplearning4j_tpu.nlp import paragraph_vectors as jpv
from deeplearning4j_tpu.nlp import word2vec as jw2v
from deeplearning4j_tpu_torch.nlp import fasttext as tft
from deeplearning4j_tpu_torch.nlp import glove as tgl
from deeplearning4j_tpu_torch.nlp import paragraph_vectors as tpv
from deeplearning4j_tpu_torch.nlp import word2vec as tw2v

#: one step from the same tables, relative to the largest table entry
#: (and the loss relative to itself)
STEP_RTOL = 1e-6
#: the infer step, relative to the vector's largest entry: it sums
#: 128·(1 + K) = 768 gathered rows into one D-vector, where a table step
#: sums a few rows into each row, and XLA's and torch's CPU
#: matrix-vector products add them in other orders: the rounding of such
#: a sum grows with its length and with the vector's update, which here
#: is as large as the vector
INFER_RTOL = 5e-6
#: tables after a whole small fit, relative to the largest entry
FIT_RTOL = 1e-4
#: neighbours closer than this in cosine are ties
NEAREST_MARGIN = 1e-4

ANIMALS = ["cat", "dog", "horse", "cow", "sheep", "goat"]
TECH = ["cpu", "gpu", "ram", "disk", "cache", "bus"]


def synthetic_corpus(n=300, seed=0):
    """Two topic clusters (the JAX tests' corpus)."""
    rng = np.random.default_rng(seed)
    sents = []
    for _ in range(n):
        topic = ANIMALS if rng.random() < 0.5 else TECH
        sents.append(" ".join(rng.choice(topic, size=6)))
    return sents


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(port, ref, rtol):
    port, ref = _np(port), _np(ref)
    assert port.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(port.astype(np.float64) - ref).max()) / scale
    assert err <= rtol, err


def _build(mod, name, **settings):
    """mod.<name>.Builder() with `settings` applied in order, on the CPU
    for the port."""
    b = getattr(mod, name).Builder()
    for k, v in settings.items():
        b = getattr(b, k)(*v) if isinstance(v, tuple) else getattr(b, k)(v)
    if mod is T:
        b = b.device("cpu")
    return b.build()


def _nearest_equal(port, ref, probe, top=5):
    """port.wordsNearest(probe) equals ref's up to the first rank whose
    cosine margin to the next is within NEAREST_MARGIN."""
    got, want = port.wordsNearest(probe, top), ref.wordsNearest(probe,
                                                                top + 1)
    sims = [ref.similarity(probe, w) for w in want]
    for k in range(min(top, len(want) - 1)):
        if sims[k] - sims[k + 1] <= NEAREST_MARGIN:
            break
        assert got[k] == want[k], (probe, got, want)


W2V = dict(minWordFrequency=1, layerSize=32, seed=7, windowSize=3,
           epochs=3, negativeSample=5, sampling=0, learningRate=0.01,
           batchSize=512)


# -- host-side work, bit for bit --------------------------------------------------
def test_tokens_and_vocabularies_equal():
    for fac in ("default", "common", "ngram"):
        pair = []
        for mod in (J, T):
            f = (mod.NGramTokenizerFactory(1, 3) if fac == "ngram"
                 else mod.DefaultTokenizerFactory())
            if fac == "common":
                f.setTokenPreProcessor(mod.CommonPreprocessor())
            pair.append([f.create(s).getTokens() for s in
                         ["Hello, World! 123 test.", "a b c d", "x"]])
        assert pair[0] == pair[1]
    toks = [s.split() for s in synthetic_corpus(50)] + [["rare"]]
    for mc in (1, 2, 40):
        a, b = J.build_vocab(toks, mc), T.build_vocab(toks, mc)
        assert (a.words(), a.counts) == (b.words(), b.counts)


def test_negative_table_and_keep_probs_equal():
    toks = [s.split() for s in synthetic_corpus(80, seed=3)] + [["x"] * 500]
    a, b = J.build_vocab(toks), T.build_vocab(toks)
    np.testing.assert_array_equal(a.negative_table(), b.negative_table())
    for sample in (0, 1e-3, 1e-2):
        np.testing.assert_array_equal(a.keep_probs(sample),
                                      b.keep_probs(sample))
    assert b.negative_table().dtype == np.float64


def test_huffman_tables_equal():
    rng = np.random.default_rng(0)
    for counts in ([100, 50, 20, 10, 5, 2, 1], [5], [3, 3, 3, 3, 3],
                   list(rng.integers(1, 30, 200))):
        for a, b in zip(jw2v._build_huffman(counts),
                        tw2v._build_huffman(counts)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("sample", [0, 1e-2])
def test_skipgram_pairs_and_negatives_equal(sample):
    """The same generator draws in the same order: pairs, the shuffle,
    the negatives, and a later draw from the same generator."""
    corpus = synthetic_corpus(60, seed=5)
    models = []
    for mod in (J, T):
        m = _build(mod, "Word2Vec", **dict(W2V, sampling=sample,
                                           windowSize=4, batchSize=64))
        toks = [s.split() for s in corpus]
        m.buildVocab(toks)
        w2i = m.vocab.word2idx
        ids = [[w2i[t] for t in s] for s in toks]
        c, x = m._pairs(ids)
        models.append((c, x, list(m._batches(c, x)), m._rng.random(3)))
    (c0, x0, b0, r0), (c1, x1, b1, r1) = models
    np.testing.assert_array_equal(c0, c1)
    np.testing.assert_array_equal(x0, x1)
    assert len(b0) == len(b1) > 1
    for u, v in zip(b0, b1):
        for p, q in zip(u, v):
            assert p.dtype == q.dtype
            np.testing.assert_array_equal(p, q)
    np.testing.assert_array_equal(r0, r1)


def test_glove_cooccurrences_equal():
    corpus = synthetic_corpus(40, seed=2)
    for sym in (True, False):
        got = []
        for mod in (J, T):
            g = _build(mod, "Glove", windowSize=4, symmetric=sym)
            toks = [s.split() for s in corpus]
            v = mod.build_vocab(toks)
            got.append(g._cooccurrences(
                [[v.word2idx[t] for t in s] for s in toks]))
        assert list(got[0].items()) == list(got[1].items())


def test_fasttext_ngram_ids_equal():
    words = ["cat", "dog", "naïve", "a", "horseshoe", "x" * 40]
    ids = []
    for mod in (J, T):
        ft = _build(mod, "FastText", bucket=1000, minN=2, maxN=5)
        ft.vocab = mod.build_vocab([words])
        rows = [ft._word_ngram_row(w, i) for i, w in
                enumerate(ft.vocab.idx2word)]
        rows += [ft._word_ngram_row("cats"), ft._word_ngram_row("zz")]
        ids.append(rows)
    for (a, m), (b, n) in zip(*ids):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(m, n)
    assert [jft._fnv1a(g) for g in J.char_ngrams("naïve", 1, 8)] == \
        [tft._fnv1a(g) for g in T.char_ngrams("naïve", 1, 8)]


DOCS = ["cat dog cat", "dog mouse", "cat cat cat", "mouse mouse dog"]


def test_bag_of_words_and_tfidf_matrices_equal():
    for name in ("BagOfWordsVectorizer", "TfidfVectorizer"):
        a, b = (getattr(mod, name).Builder().minWordFrequency(1)
                .iterate(DOCS * 3).labels(["x", "y"]).build().fit()
                for mod in (J, T))
        np.testing.assert_array_equal(a.transformAll(DOCS + ["zebra cat"]),
                                      b.transformAll(DOCS + ["zebra cat"]))
        np.testing.assert_array_equal(b.fitTransform(DOCS),
                                      a.fitTransform(DOCS))
        da, db = a.vectorize("cat dog", "y"), b.vectorize("cat dog", "y")
        np.testing.assert_array_equal(da.features, db.features)
        np.testing.assert_array_equal(da.labels, db.labels)
        assert type(db).__module__ == \
            "deeplearning4j_tpu_torch.datasets.dataset"


def _sentence_iterators(fmt, **extra):
    words = ["good", "bad", "movie", "great", "awful", "unk"]
    table = np.random.RandomState(0).randn(6, 8).astype(np.float32)
    sents = ["good movie", "great movie", "awful movie zzz",
             "bad bad movie", "Good " * 6 + "movie", "zzz"]
    labels = ["pos", "pos", "neg", "neg", "pos", "neg"]
    out = []
    for mod in (J, T):
        b = (mod.CnnSentenceDataSetIterator.Builder(fmt)
             .sentenceProvider(mod.CollectionLabeledSentenceProvider(
                 sents, labels))
             .wordVectors(mod.StaticWordVectors(table, words))
             .minibatchSize(4).maxSentenceLength(5))
        if extra.get("unknown"):
            b = b.useUnknown("unk")
        out.append(b.build())
    return out


@pytest.mark.parametrize("fmt", ["CNN2D", "CNN1D", "RNN"])
@pytest.mark.parametrize("unknown", [False, True])
def test_cnn_sentence_iterator_batches_equal(fmt, unknown):
    a, b = _sentence_iterators(fmt, unknown=unknown)
    for _ in range(2):
        n = 0
        while a.hasNext():
            assert b.hasNext()
            da, db = a.next(), b.next()
            for f in ("features", "labels", "featuresMask"):
                x, y = getattr(da, f), getattr(db, f)
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
            n += 1
        assert n == 2 and not b.hasNext()
        a.reset()
        b.reset()
    assert a.getLabels() == b.getLabels()


def test_initial_tables_equal():
    """syn0 (Word2Vec, SequenceVectors), the document table, GloVe's w and
    wc (two ranged uniforms after a split: the C5 repair) and FastText's
    table, port and JAX package bit for bit."""
    corpus = synthetic_corpus(20, seed=4)
    for name, extra in (("Word2Vec", {}), ("ParagraphVectors", {}),
                        ("FastText", {"bucket": 300})):
        pair = [_build(mod, name, **dict(W2V, layerSize=30, epochs=0),
                       **extra, iterate=(corpus,)).fit().params
                for mod in (J, T)]
        for k in pair[0]:
            np.testing.assert_array_equal(_np(pair[1][k]),
                                          np.asarray(pair[0][k]))
    j = _build(J, "Glove", layerSize=30, epochs=0, seed=3,
               iterate=(corpus,)).fit()
    t = _build(T, "Glove", layerSize=30, epochs=0, seed=3,
               iterate=(corpus,)).fit()
    for k in ("w", "wc", "b", "bc"):
        np.testing.assert_array_equal(_np(t.params[k]), np.asarray(
            j.params[k]))
    np.testing.assert_array_equal(_np(t.hist["w"]),
                                  np.full((12, 30), 1e-8, np.float32))


def test_fasttext_table_in_chunks_equals_one_whole_draw(monkeypatch):
    whole = tft._uniform_table(5, 37, 9, "cpu")
    monkeypatch.setattr(tft, "_INIT_CHUNK", 40)      # 4 rows a chunk
    chunked = tft._uniform_table(5, 37, 9, "cpu")
    assert torch.equal(whole, chunked)
    import jax
    ref = (jax.random.uniform(jax.random.PRNGKey(5), (37, 9)) - 0.5) / 9
    np.testing.assert_array_equal(chunked.numpy(), np.asarray(ref))


# -- one step of each kind ----------------------------------------------------------
def _step_case(kind, seed=0):
    """(JAX call, port call, port tables) of one step of `kind` from the
    same random tables on a batch that repeats ids."""
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    V, D, B, K, C, G, ND = 20, 16, 32, 5, 4, 6, 7
    lr = 0.05

    def table(*shape):
        return (rng.standard_normal(shape) * 0.5).astype(np.float32)

    ids = lambda n, *s: rng.integers(0, n, s).astype(np.int32)
    w = np.ones(B, np.float32)
    w[-3:] = 0.0
    if kind in ("sgns", "hs"):
        params = {"syn0": table(V, D),
                  "syn1": table(V - 1 if kind == "hs" else V, D)}
        cen, ctx, negs = ids(V, B), ids(V, B), ids(V, B, K)
        if kind == "sgns":
            args = (cen, ctx, negs, w)
            jstep, tstep = jw2v._sgns_step, tw2v._sgns_step
        else:
            counts = list(rng.integers(1, 50, V))
            args = (cen, ctx) + tuple(jw2v._build_huffman(counts)) + (w,)
            jstep, tstep = jw2v._hs_step, tw2v._hs_step
        hist = None
    elif kind == "pvdm":
        params = {"syn0": table(V, D), "syn1": table(V, D),
                  "docs": table(ND, D)}
        m = (rng.random((B, C)) < 0.7).astype(np.float32)
        args = (ids(ND, B), ids(V, B, C), m, ids(V, B), ids(V, B, K), w)
        jstep, tstep, hist = jpv._pvdm_step, tpv._pvdm_step, None
    elif kind == "ft":
        params = {"syn0": table(V + 40, D), "syn1": table(V, D)}
        m = np.ones((B, G), np.float32)
        m[:, 4:] = rng.random((B, G - 4)) < 0.5
        args = (ids(V + 40, B, G), m, ids(V, B), ids(V, B, K), w)
        jstep, tstep, hist = jft._ft_step, tft._ft_step, None
    elif kind == "glove":
        params = {"w": table(V, D), "wc": table(V, D),
                  "b": table(V), "bc": table(V)}
        hist = {k: (np.abs(table(*p.shape)) + 1e-8) for k, p in
                params.items()}
        args = (ids(V, B), ids(V, B), table(B),
                np.abs(table(B)), w)
        jstep, tstep = jgl._glove_step, tgl._glove_step
    else:                                  # infer
        syn1 = table(V, D)
        vec = table(D)
        args = (ids(V, 128), ids(V, 128, K),
                (rng.random(128) < 0.8).astype(np.float32))
        j = np.asarray(jpv._infer_step(jnp.asarray(vec), jnp.asarray(syn1),
                                       lr, *map(jnp.asarray, args)))
        targs = [torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32
                                  else a) for a in args]
        t, again = (tpv._infer_step(torch.from_numpy(vec),
                                    torch.from_numpy(syn1), lr, *targs)
                    for _ in range(2))
        assert torch.equal(t, again)
        return {"vec": j}, None, {"vec": t}, None

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jargs = tuple(jnp.asarray(a) for a in args)
    if hist is None:
        jout, jloss = jstep(jp, lr, *jargs)
    else:
        jout, _, jloss = jstep(jp, {k: jnp.asarray(v) for k, v in
                                    hist.items()}, lr, *jargs)
    model = T.Word2Vec.Builder().device("cpu").build()
    T.params_from_numpy(model, params, device="cpu", hist=hist)

    def port_step():
        p = {k: v.clone() for k, v in model.params.items()}
        h = (None if hist is None else
             {k: v.clone() for k, v in model.hist.items()})
        targs = [torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32
                                  else a) for a in args]
        loss = (tstep(p, lr, *targs) if h is None
                else tstep(p, h, lr, *targs))
        return p, loss

    tout, tloss = port_step()
    again, loss2 = port_step()
    for k in tout:
        assert torch.equal(tout[k], again[k]), k
    assert torch.equal(tloss, loss2)
    return ({k: np.asarray(v) for k, v in jout.items()}, float(jloss),
            tout, float(tloss))


@pytest.mark.parametrize("kind", ["sgns", "hs", "pvdm", "infer", "ft",
                                  "glove"])
def test_one_step_matches_the_jax_package(kind):
    jout, jloss, tout, tloss = _step_case(kind)
    for k in jout:
        _close(tout[k], jout[k], INFER_RTOL if kind == "infer"
               else STEP_RTOL)
    if jloss is not None:
        assert abs(tloss - jloss) <= STEP_RTOL * abs(jloss)


def test_segment_sum_adds_repeated_ids_in_batch_order():
    ids = torch.tensor([3, 1, 3, 3, 0, 1])
    g = torch.tensor([[1e8], [1.0], [1.0], [-1e8], [2.0], [3.0]])
    rows, sums = tw2v._segment_sum(ids, g)
    assert rows.tolist() == [0, 1, 3]
    # 1e8 + 1 rounds to 1e8 in f32, then - 1e8: batch order gives 0
    assert sums[:, 0].tolist() == [2.0, 4.0, 0.0]


# -- whole fits ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def fits():
    corpus = synthetic_corpus()
    out = {}
    for name, mk in {
        "ns": lambda mod: _build(mod, "Word2Vec", **dict(
            W2V, iterate=(mod.CollectionSentenceIterator(corpus),))),
        "hs": lambda mod: _build(mod, "Word2Vec", **dict(
            W2V, epochs=4, useHierarchicSoftmax=True,
            iterate=(mod.CollectionSentenceIterator(corpus),))),
    }.items():
        out[name] = (mk(J).fit(), mk(T).fit())
    return out


@pytest.mark.parametrize("name", ["ns", "hs"])
def test_word2vec_fit_matches_the_jax_package(fits, name):
    j, t = fits[name]
    assert t.vocab.words() == j.vocab.words()
    for k in ("syn0", "syn1"):
        _close(t.params[k], j.params[k], FIT_RTOL)
    for probe in ("cat", "gpu", "sheep"):
        _nearest_equal(t, j, probe)
    # the JAX tests' topic contract
    assert t.similarity("cat", "dog") > t.similarity("cat", "gpu")
    assert t.similarity("cpu", "ram") > t.similarity("cpu", "cow")
    if name == "hs":
        assert t.params["syn1"].shape[0] == t.vocabSize() - 1
    else:
        near = t.wordsNearest("cat", topN=5)
        assert "cat" not in near
        assert len(set(near[:3]) & set(ANIMALS)) >= 2


def test_sequence_vectors_fit_matches_and_equals_word2vec():
    rng = np.random.default_rng(4)
    words = [f"w{i}" for i in range(8)]
    seqs = [list(rng.choice(words, size=5)) for _ in range(40)]
    kw = dict(layerSize=12, seed=9, windowSize=3, epochs=2, sampling=0,
              learningRate=0.05, batchSize=128)
    j = _build(J, "SequenceVectors", **kw,
               iterate=(J.AbstractSequenceIterator(seqs),)).fit()
    t = _build(T, "SequenceVectors", **kw,
               iterate=(T.AbstractSequenceIterator(seqs),)).fit()
    w = _build(T, "Word2Vec", minWordFrequency=1, **kw, iterate=(
        T.CollectionSentenceIterator([" ".join(s) for s in seqs]),)).fit()
    assert t.vocab.words() == j.vocab.words() == w.vocab.words()
    _close(t.params["syn0"], j.params["syn0"], FIT_RTOL)
    assert torch.equal(t.params["syn0"], w.params["syn0"])
    with pytest.raises(TypeError, match="ELEMENTS"):
        T.AbstractSequenceIterator(["a b c"])
    with pytest.raises(TypeError, match="ELEMENTS"):
        _build(T, "SequenceVectors", iterate=(["a b c"],)).fit()


@pytest.mark.parametrize("dm", [False, True])
def test_paragraph_vectors_fit_and_infer_match_the_jax_package(dm):
    docs = []
    for i, s in enumerate(synthetic_corpus(60, seed=1)):
        topic = "animals" if s.split()[0] in ANIMALS else "tech"
        docs.append((f"{topic}_{i}", s))
    kw = dict(minWordFrequency=1, layerSize=24, seed=3, epochs=3,
              sampling=0, batchSize=256,
              sequenceLearningAlgorithm="DM" if dm else "DBOW")
    j = _build(J, "ParagraphVectors", **kw, iterate=(docs,)).fit()
    t = _build(T, "ParagraphVectors", **kw, iterate=(docs,)).fit()
    for k in ("syn0", "syn1", "docs"):
        _close(t.params[k], j.params[k], FIT_RTOL)
    lab = docs[0][0]
    assert t.getLabelVector(lab).shape == (24,)
    _close(t.getLabelVector(lab), j.getLabelVector(lab), FIT_RTOL)
    vj, vt = j.inferVector("cat dog horse cow"), t.inferVector(
        "cat dog horse cow")
    assert vt.shape == (24,) and np.isfinite(vt).all()
    _close(vt, vj, FIT_RTOL)
    # both generators stayed in step: the next draws are equal
    np.testing.assert_array_equal(t._rng.random(4), j._rng.random(4))


def test_glove_fit_matches_the_jax_package():
    kw = dict(minWordFrequency=1, layerSize=24, seed=11, windowSize=4,
              epochs=40, learningRate=0.05)
    corpus = synthetic_corpus(200, seed=2)
    j = _build(J, "Glove", **kw, iterate=(corpus,)).fit()
    t = _build(T, "Glove", **kw, iterate=(corpus,)).fit()
    for k in ("w", "wc", "b", "bc"):
        _close(t.params[k], j.params[k], FIT_RTOL)
    assert t.getWordVector("cat").shape == (24,)
    assert t.similarity("cat", "dog") > t.similarity("cat", "gpu")
    _nearest_equal(t, j, "cat")


def test_fasttext_fit_matches_and_builds_oov_vectors():
    kw = dict(minWordFrequency=1, layerSize=16, seed=9, windowSize=3,
              epochs=2, sampling=0, batchSize=256)
    corpus = synthetic_corpus(80)
    j = _build(J, "FastText", **kw, iterate=(
        J.CollectionSentenceIterator(corpus),)).fit()
    t = _build(T, "FastText", **kw, iterate=(
        T.CollectionSentenceIterator(corpus),)).fit()
    for k in ("syn0", "syn1"):
        _close(t.params[k], j.params[k], FIT_RTOL)
    _close(t._table(), j._table(), FIT_RTOL)
    oov = t.getWordVector("cats")
    assert oov.shape == (16,) and np.isfinite(oov).all()
    _close(oov, j.getWordVector("cats"), FIT_RTOL)
    assert t.similarity("cat", "dog") == t.similarity("dog", "cat")
    tiny = _build(T, "FastText", layerSize=4, sampling=0, bucket=10,
                  minN=9, maxN=9, iterate=(["ab cd ab cd"],)).fit()
    with pytest.raises(KeyError, match="no n-grams"):
        tiny.getWordVector("xy")


def test_hierarchic_softmax_refused_on_the_negative_sampling_models():
    with pytest.raises(ValueError, match="useHierarchicSoftmax"):
        (T.ParagraphVectors.Builder().useHierarchicSoftmax(True)
         .iterate([("d0", "a b c")]).build())
    with pytest.raises(ValueError, match="useHierarchicSoftmax"):
        (T.FastText.Builder().useHierarchicSoftmax(True)
         .iterate(T.CollectionSentenceIterator(["a b c"])).build())
    points, codes, mask = tw2v._build_huffman([5])
    assert mask.sum() == 0


# -- files --------------------------------------------------------------------------------
def _static(mod):
    rng = np.random.default_rng(3)
    words = ["the", "quick", "brown", "fox", "naïve"]
    return mod.StaticWordVectors(
        rng.standard_normal((5, 8)).astype(np.float32), words)


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_word2vec_files_read_back_in_either_package(tmp_path, binary,
                                                    writer):
    w, r = (J, T) if writer == "jax" else (T, J)
    v = _static(w)
    p = str(tmp_path / ("v.bin" if binary else "v.txt"))
    w.WordVectorSerializer.writeWord2VecModel(v, p, binary=binary)
    back = r.WordVectorSerializer.readWord2VecModel(p)
    same = w.WordVectorSerializer.readWord2VecModel(p)
    assert back.vocab.words() == v.vocab.words()
    assert r.WordVectorSerializer._is_binary(p) is binary
    np.testing.assert_array_equal(back._table(), same._table())
    if binary:
        np.testing.assert_array_equal(back._table(), v._table())
    else:
        np.testing.assert_allclose(back._table(), v._table(), atol=1e-5)


def test_trained_vectors_write_the_same_file_in_both_packages(fits,
                                                              tmp_path):
    """The port's trained table written in text matches the JAX
    package's file line for line up to the last printed digit."""
    j, t = fits["ns"]
    pj, pt = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    J.WordVectorSerializer.writeWord2VecModel(j, pj)
    T.WordVectorSerializer.writeWord2VecModel(t, pt)
    a = J.WordVectorSerializer.loadStaticModel(pt)
    b = T.WordVectorSerializer.loadStaticModel(pj)
    assert a.vocab.words() == b.vocab.words()
    np.testing.assert_allclose(a._table(), b._table(), atol=2e-6)
    np.testing.assert_allclose(T.WordVectorSerializer.loadTxtVectors(pt)
                               .getWordVector("cat"),
                               t.getWordVector("cat"), atol=1e-5)


def test_embedding_layer_weights_feed_the_ports_embedding_layer(tmp_path):
    from deeplearning4j_tpu_torch.nn import (InputType, MultiLayerNetwork,
                                             NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.layers import (EmbeddingLayer,
                                                         OutputLayer)
    p = str(tmp_path / "e.txt")
    J.WordVectorSerializer.writeWord2VecModel(_static(J), p)
    back = T.WordVectorSerializer.readWord2VecModel(p)
    w = T.WordVectorSerializer.embeddingLayerWeights(back, extra_tokens=2)
    wj = J.WordVectorSerializer.embeddingLayerWeights(
        J.WordVectorSerializer.readWord2VecModel(p), extra_tokens=2)
    np.testing.assert_array_equal(w, wj)
    assert w.shape == (7, 8)
    conf = (NeuralNetConfiguration.Builder().seed(0).list()
            .layer(EmbeddingLayer(nIn=7, nOut=8))
            .layer(OutputLayer(lossFunction="mcxent", nOut=3,
                               activation="softmax"))
            .setInputType(InputType.feedForward(7)).build())
    net = MultiLayerNetwork(conf).init("cpu")
    net._params["0"]["W"] = torch.from_numpy(w)
    idx = np.array([back.vocab.indexOf("fox")], np.int32)
    emb = net.feedForward(idx)[0].numpy()[0]
    np.testing.assert_allclose(emb, back.getWordVector("fox"), atol=1e-5)


def test_params_from_numpy_checks_names_and_shapes():
    m = _build(T, "Word2Vec", layerSize=4, iterate=(["a b a b"],),
               minWordFrequency=1, sampling=0).fit()
    with pytest.raises(ValueError, match="expected"):
        T.params_from_numpy(m, {"syn0": np.zeros((2, 4))}, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        T.params_from_numpy(m, {"syn0": np.zeros((2, 5)),
                                "syn1": np.zeros((2, 4))}, device="cpu")
    before = m.getWordVector("a").copy()
    T.params_from_numpy(m, {"syn0": np.ones((2, 4)),
                            "syn1": np.zeros((2, 4))}, device="cpu")
    assert (m.getWordVector("a") == 1).all() and (before != 1).any()


# -- the example twins ---------------------------------------------------------------
def test_word2vec_text_twin():
    from deeplearning4j_tpu_torch.examples import word2vec_text
    out = word2vec_text.main(device="cpu")
    assert out["vocab"] == 12
    assert out["sim_day_night"] > out["sim_day_stars"]
    assert set(out["nearest_day"]) <= {"night", "morning", "evening",
                                       "noon", "dusk"}


def test_text_classification_tfidf_twin():
    from deeplearning4j_tpu_torch.examples import text_classification_tfidf
    out = text_classification_tfidf.main(device="cpu")
    assert out["tfidf_vocab"] == 15
    assert out["tfidf_accuracy"] >= 0.95
    assert out["cnn_accuracy"] >= 0.95
