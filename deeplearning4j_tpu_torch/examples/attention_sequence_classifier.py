"""Sequence classification with the first-class attention layers (≡
dl4j-examples attention usage of SelfAttentionLayer /
LearnedSelfAttentionLayer): the twin of
`examples/attention_sequence_classifier.py` on the port. A
LearnedSelfAttentionLayer pools ragged sequences into a fixed-length
representation; padding masks flow through the whole stack, and on the
card the attention runs the flash kernels (B1 forward, B2a/B2b backward)
at head dim D = 8, padded to 16. The script's `acc > 0.8` check stays.

Run: `python -m deeplearning4j_tpu_torch.examples.attention_sequence_classifier`
(the card; `main(device="cpu")` runs it on the CPU)."""
import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn import (Adam, InputType, MultiLayerNetwork,
                                         NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf.attention import (
    LearnedSelfAttentionLayer, SelfAttentionLayer)
from deeplearning4j_tpu_torch.nn.conf.layers import OutputLayer
from deeplearning4j_tpu_torch.nn.conf.recurrent import LastTimeStep, LSTM

T, F = 24, 8


def make_data(n=128, seed=0):
    """Task: does the (variable-length) sequence contain a spike > 2 ?"""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, T, F)).astype(np.float32) * 0.5
    lengths = rng.integers(8, T + 1, n)
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    labels = rng.integers(0, 2, n)
    for i in np.where(labels == 1)[0]:
        t = rng.integers(0, lengths[i])
        x[i, t] += 3.0
    x *= mask[:, :, None]
    y = np.eye(2, dtype=np.float32)[labels]
    ds = DataSet(x, y)
    ds.featuresMask = mask
    return ds


def main(device=None):
    conf = (NeuralNetConfiguration.Builder()
            .seed(7).updater(Adam(3e-3)).weightInit("xavier")
            .list()
            .layer(SelfAttentionLayer(nOut=32, nHeads=4))
            .layer(LearnedSelfAttentionLayer(nOut=32, nHeads=4, nQueries=4))
            .layer(LastTimeStep(LSTM(nOut=16)))
            .layer(OutputLayer(lossFunction="mcxent", nOut=2,
                               activation="softmax"))
            .setInputType(InputType.recurrent(F, T))
            .build())
    net = MultiLayerNetwork(conf).init(device)
    train, test = make_data(256, 0), make_data(64, 1)
    for _epoch in range(30):
        net.fit(train)
    preds = np.asarray(net.output(test.features, fmask=test.featuresMask))
    acc = float((preds.argmax(-1) == np.asarray(test.labels).argmax(-1))
                .mean())
    print(f"test accuracy: {acc:.3f}")
    if not acc > 0.8:
        raise AssertionError("attention stack failed to learn the spike "
                             f"task: accuracy {acc}")
    return {"accuracy": acc, "loss": float(net.score())}


if __name__ == "__main__":
    main()
