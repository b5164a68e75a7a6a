"""Hyperparameter search (≡ arbiter examples): the twin of
`examples/hyperparameter_search.py` on the port — tune lr + width for a
tiny classifier with TPE (`main`), and the same search through the
declarative network-space DSL (`main_declarative`).

Run: `python -m deeplearning4j_tpu_torch.examples.hyperparameter_search`
(the card; `main(device="cpu")` runs it on the CPU)."""
import numpy as np

from deeplearning4j_tpu_torch.arbiter import (ContinuousParameterSpace,
                                              IntegerParameterSpace,
                                              LocalOptimizationRunner,
                                              TPEGenerator)
from deeplearning4j_tpu_torch.nn import (Adam, DenseLayer, InputType,
                                         MultiLayerNetwork,
                                         NeuralNetConfiguration, OutputLayer)

rng = np.random.default_rng(0)
X = rng.normal(size=(128, 10)).astype(np.float32)
W = rng.normal(size=(10, 3)).astype(np.float32)
Y = np.eye(3, dtype=np.float32)[(X @ W).argmax(-1)]


def train_and_score(net, epochs=30):
    for _ in range(epochs):
        net.fit(X, Y)
    return float(net.score())


def main(device=None):
    def build_and_score(params):
        net = MultiLayerNetwork(
            NeuralNetConfiguration.Builder().seed(1)
            .updater(Adam(params["lr"])).weightInit("xavier").list()
            .layer(DenseLayer(nOut=params["width"], activation="relu"))
            .layer(OutputLayer(lossFunction="mcxent", nOut=3,
                               activation="softmax"))
            .setInputType(InputType.feedForward(10)).build()).init(device)
        return train_and_score(net)

    space = {"lr": ContinuousParameterSpace(1e-4, 1e-1, log=True),
             "width": IntegerParameterSpace(4, 64)}
    runner = LocalOptimizationRunner(
        TPEGenerator(space, seed=5, startupTrials=6),
        model_builder=lambda p: p, scorer=build_and_score,
        maxCandidates=15)
    best = runner.execute()
    print("best:", best.params, "loss:", round(best.score, 4))
    return {"best": dict(best.params), "loss": float(best.score),
            "candidates": 15}


def main_declarative(device=None):
    """Same search through the declarative network-space DSL (≡
    arbiter-deeplearning4j :: MultiLayerSpace) — no hand-written
    model_builder: the space compiles sampled candidates into real
    configurations itself."""
    from deeplearning4j_tpu_torch.arbiter import (AdamSpace, LayerSpace,
                                                  MultiLayerSpace,
                                                  RandomSearchGenerator)

    mls = (MultiLayerSpace.Builder()
           .seed(1)
           .updater(AdamSpace(ContinuousParameterSpace(1e-4, 1e-1,
                                                       log=True)))
           .weightInit("xavier")
           .addLayer(LayerSpace(DenseLayer,
                                nOut=IntegerParameterSpace(4, 64),
                                activation="relu"))
           .addLayer(LayerSpace(OutputLayer, lossFunction="mcxent",
                                nOut=3, activation="softmax"))
           .setInputType(InputType.feedForward(10))
           .build())

    runner = LocalOptimizationRunner(
        RandomSearchGenerator(mls.collectLeaves(), seed=5),
        model_builder=mls.model_builder(device), scorer=train_and_score,
        maxCandidates=8)
    best = runner.execute()
    print("declarative best:", best.params, "loss:", round(best.score, 4))
    return {"best": dict(best.params), "loss": float(best.score),
            "candidates": 8}


if __name__ == "__main__":
    main()
    main_declarative()
