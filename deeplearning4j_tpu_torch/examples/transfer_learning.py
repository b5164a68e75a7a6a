"""Transfer learning (≡ dl4j-examples :: EditLastLayerOthersFrozen): the
twin of `examples/transfer_learning.py` on the port — freeze a trained
feature extractor, swap the output head, fine-tune.

Run: `python -m deeplearning4j_tpu_torch.examples.transfer_learning` (the
card; `main(device="cpu")` runs it on the CPU)."""
import numpy as np

from deeplearning4j_tpu_torch.nn import (Adam, DenseLayer, InputType,
                                         MultiLayerNetwork,
                                         NeuralNetConfiguration, OutputLayer)
from deeplearning4j_tpu_torch.transfer.transfer_learning import (
    FineTuneConfiguration, TransferLearning)


def main(device=None):
    base = MultiLayerNetwork(
        NeuralNetConfiguration.Builder().seed(7).updater(Adam(1e-2))
        .weightInit("xavier").list()
        .layer(DenseLayer(nOut=64, activation="relu"))
        .layer(DenseLayer(nOut=32, activation="relu"))
        .layer(OutputLayer(lossFunction="mcxent", nOut=5,
                           activation="softmax"))
        .setInputType(InputType.feedForward(20)).build()).init(device)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 20)).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rng.integers(5, size=64)]
    for _ in range(10):
        base.fit(x, y)
    base_loss = float(base.score())
    print("base loss:", base_loss)

    # new 3-class task: freeze everything up to layer 1, replace the head
    transferred = (TransferLearning.Builder(base)
                   .fineTuneConfiguration(
                       FineTuneConfiguration.Builder()
                       .updater(Adam(1e-3)).build())
                   .setFeatureExtractor(1)
                   .removeOutputLayer()
                   .addLayer(OutputLayer(lossFunction="mcxent", nOut=3,
                                         activation="softmax"))
                   .build())
    y3 = np.eye(3, dtype=np.float32)[rng.integers(3, size=64)]
    for _ in range(10):
        transferred.fit(x, y3)
    tuned_loss = float(transferred.score())
    print("fine-tuned loss:", tuned_loss)
    return {"base_loss": base_loss, "fine_tuned_loss": tuned_loss,
            "frozen_equal": bool(np.array_equal(
                np.asarray(base.getParam("0_W")),
                np.asarray(transferred.getParam("0_W"))))}


if __name__ == "__main__":
    main()
