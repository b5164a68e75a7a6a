"""Classic text classification two ways (≡ dl4j-examples' bag-of-words /
CnnSentenceDataSetIterator text pipelines): the twin of
`examples/text_classification_tfidf.py` on the port.

1. TfidfVectorizer → dense MLP (the classic sparse-features path)
2. StaticWordVectors + CnnSentenceDataSetIterator → Conv1D sentence
   classifier with padding masks (the Kim-CNN path)

Both run end-to-end on a tiny synthetic corpus. Run:
`python -m deeplearning4j_tpu_torch.examples.text_classification_tfidf`
(the card; `main(device="cpu")` runs it on the CPU).
"""
import numpy as np

from deeplearning4j_tpu_torch.nlp import (CnnSentenceDataSetIterator,
                                          CollectionLabeledSentenceProvider,
                                          StaticWordVectors, TfidfVectorizer)
from deeplearning4j_tpu_torch.nn import (Adam, InputType, MultiLayerNetwork,
                                         NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf.layers import (Convolution1DLayer,
                                                     DenseLayer,
                                                     GlobalPoolingLayer,
                                                     OutputLayer)


def corpus(n=120, seed=0):
    rng = np.random.RandomState(seed)
    pos = ["great", "wonderful", "excellent", "loved", "amazing"]
    neg = ["awful", "terrible", "boring", "hated", "dreadful"]
    fill = ["the", "movie", "plot", "acting", "film"]
    docs, labels = [], []
    for _ in range(n):
        good = rng.rand() < 0.5
        words = list(rng.choice(pos if good else neg, 3)) + \
            list(rng.choice(fill, 4))
        rng.shuffle(words)
        docs.append(" ".join(words))
        labels.append("pos" if good else "neg")
    return docs, labels


def tfidf_mlp(docs, labels, device=None):
    v = (TfidfVectorizer.Builder().minWordFrequency(1)
         .iterate(docs).labels(labels).build().fit())
    x = v.transformAll(docs)
    classes = list(dict.fromkeys(labels))
    y = np.eye(len(classes), dtype=np.float32)[
        [classes.index(l) for l in labels]]
    net = MultiLayerNetwork(
        NeuralNetConfiguration.Builder().seed(0).updater(Adam(1e-2)).list()
        .layer(DenseLayer(nOut=16, activation="relu"))
        .layer(OutputLayer(lossFunction="mcxent", nOut=len(classes),
                           activation="softmax"))
        .setInputType(InputType.feedForward(x.shape[1])).build()).init(device)
    for _ in range(40):
        net.fit(x, y)
    acc = float((np.asarray(net.output(x)).argmax(-1)
                 == y.argmax(-1)).mean())
    print(f"1. TF-IDF MLP train accuracy: {acc:.2f} "
          f"(vocab {v.vocabSize()})")
    return acc, v.vocabSize()


def cnn_sentence(docs, labels, device=None):
    vocab = sorted({w for d in docs for w in d.split()})
    rng = np.random.RandomState(1)
    wv = StaticWordVectors(rng.randn(len(vocab), 16).astype(np.float32),
                           vocab)
    it = (CnnSentenceDataSetIterator.Builder("RNN")
          .sentenceProvider(CollectionLabeledSentenceProvider(docs, labels))
          .wordVectors(wv).minibatchSize(32).maxSentenceLength(12).build())
    net = MultiLayerNetwork(
        NeuralNetConfiguration.Builder().seed(0).updater(Adam(1e-2)).list()
        .layer(Convolution1DLayer(nOut=24, kernelSize=3,
                                  convolutionMode="same",
                                  activation="relu"))
        .layer(GlobalPoolingLayer("max"))
        .layer(OutputLayer(lossFunction="mcxent", nOut=2,
                           activation="softmax"))
        .setInputType(InputType.recurrent(16)).build()).init(device)
    # iterator emits (B, vecSize, maxLen); our 1D layers take (B, T, F)
    for epoch in range(12):
        it.reset()
        for ds in iter_batches(it):
            net.fit(ds)
    it.reset()
    correct = total = 0
    for ds in iter_batches(it):
        pred = np.asarray(net.output(ds.features)).argmax(-1)
        correct += (pred == ds.labels.argmax(-1)).sum()
        total += len(pred)
    acc = float(correct / total)
    print(f"2. Conv1D sentence classifier train accuracy: {acc:.2f}")
    return acc


def iter_batches(it):
    while it.hasNext():
        ds = it.next()
        ds.features = ds.features.transpose(0, 2, 1)  # (B, T, F)
        yield ds


def main(device=None):
    docs, labels = corpus()
    tfidf_acc, vocab = tfidf_mlp(docs, labels, device)
    cnn_acc = cnn_sentence(docs, labels, device)
    return {"tfidf_accuracy": tfidf_acc, "tfidf_vocab": vocab,
            "cnn_accuracy": cnn_acc}


if __name__ == "__main__":
    main()
