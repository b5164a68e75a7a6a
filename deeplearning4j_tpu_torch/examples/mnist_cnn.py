"""LeNet on MNIST (≡ dl4j-examples :: MnistClassifier): the twin of
`examples/mnist_cnn.py` on the port — build with the config DSL, fit,
evaluate. `MnistDataSetIterator` reads MNIST's IDX files where they are
and otherwise makes its deterministic synthetic digits (no download).

Run: `python -m deeplearning4j_tpu_torch.examples.mnist_cnn` (the card;
`main(device="cpu")` runs it on the CPU)."""
from deeplearning4j_tpu_torch.datasets.iterators import MnistDataSetIterator
from deeplearning4j_tpu_torch.nn import (Adam, ConvolutionLayer, DenseLayer,
                                         InputType, MultiLayerNetwork,
                                         NeuralNetConfiguration, OutputLayer,
                                         SubsamplingLayer)
from deeplearning4j_tpu_torch.optimize.listeners import ScoreIterationListener


def main(device=None):
    conf = (NeuralNetConfiguration.Builder()
            .seed(123)
            .updater(Adam(1e-3))
            .weightInit("xavier")
            .list()
            .layer(ConvolutionLayer(kernelSize=(5, 5), nOut=20,
                                    activation="relu",
                                    convolutionMode="same"))
            .layer(SubsamplingLayer(poolingType="max", kernelSize=(2, 2),
                                    stride=(2, 2)))
            .layer(ConvolutionLayer(kernelSize=(5, 5), nOut=50,
                                    activation="relu",
                                    convolutionMode="same"))
            .layer(SubsamplingLayer(poolingType="max", kernelSize=(2, 2),
                                    stride=(2, 2)))
            .layer(DenseLayer(nOut=500, activation="relu"))
            .layer(OutputLayer(lossFunction="negativeloglikelihood",
                               nOut=10, activation="softmax"))
            .setInputType(InputType.convolutionalFlat(28, 28, 1))
            .build())

    net = MultiLayerNetwork(conf).init(device)
    net.setListeners(ScoreIterationListener(10))
    train = MnistDataSetIterator(128, train=True)
    test = MnistDataSetIterator(128, train=False)
    net.fit(train, epochs=2)
    ev = net.evaluate(test)
    print(ev.stats())
    return {"accuracy": ev.accuracy(), "score": float(net.score())}


if __name__ == "__main__":
    main()
