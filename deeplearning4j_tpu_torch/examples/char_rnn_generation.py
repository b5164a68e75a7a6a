"""Character-level text generation with an LSTM (≡ dl4j-examples ::
GravesLSTMCharModellingExample): the twin of
`examples/char_rnn_generation.py` on the port — overfit a tiny corpus,
then sample one character at a time through `rnnTimeStep`, drawing with
numpy from the card's probabilities.

Run: `python -m deeplearning4j_tpu_torch.examples.char_rnn_generation`
(the card; `main(device="cpu")` runs it on the CPU)."""
import numpy as np

from deeplearning4j_tpu_torch.nn import (Adam, InputType, MultiLayerNetwork,
                                         NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf.recurrent import LSTM, RnnOutputLayer

CORPUS = ("the quick brown fox jumps over the lazy dog. "
          "pack my box with five dozen liquor jugs. ") * 20


def main(device=None):
    chars = sorted(set(CORPUS))
    c2i = {c: i for i, c in enumerate(chars)}
    n = len(chars)
    seq_len = 32

    conf = (NeuralNetConfiguration.Builder()
            .seed(12).updater(Adam(1e-2)).weightInit("xavier")
            .list()
            .layer(LSTM(nOut=96, activation="tanh"))
            .layer(RnnOutputLayer(lossFunction="mcxent", nOut=n,
                                  activation="softmax"))
            .setInputType(InputType.recurrent(n))
            .build())
    net = MultiLayerNetwork(conf).init(device)

    # build (B, T, C) one-hot batches
    ids = np.asarray([c2i[c] for c in CORPUS])
    starts = np.arange(0, len(ids) - seq_len - 1, seq_len)
    x = np.eye(n, dtype=np.float32)[
        np.stack([ids[s:s + seq_len] for s in starts])]
    y = np.eye(n, dtype=np.float32)[
        np.stack([ids[s + 1:s + seq_len + 1] for s in starts])]

    for _epoch in range(60):
        net.fit(x, y)
    loss = float(net.score())
    print("final loss:", loss)

    # sample from a seed character
    rng = np.random.default_rng(0)
    out = "t"
    net.rnnClearPreviousState()
    for _ in range(80):
        step = np.eye(n, dtype=np.float32)[[c2i[out[-1]]]][None]
        probs = net.rnnTimeStep(step).detach().cpu().numpy()[0, 0]
        out += chars[int(rng.choice(n, p=probs / probs.sum()))]
    print("sampled:", out)
    return {"loss": loss, "sampled": out}


if __name__ == "__main__":
    main()
