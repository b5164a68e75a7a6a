"""SameDiff graph building + training (≡ samediff-examples): the twin of
`examples/samediff_graph.py` on the port — define an MLP as a graph,
train with the TrainingConfig, inspect gradients. The script reads its
arrays with `.jax()`; the twin with `.numpy()`.

Run: `python -m deeplearning4j_tpu_torch.examples.samediff_graph` (the
card; `main(device="cpu")` runs it on the CPU)."""
import numpy as np

from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig
from deeplearning4j_tpu_torch.nn.updaters import Adam


def main(device=None):
    sd = SameDiff.create(device=device)
    x = sd.placeHolder("x", None, 4)
    labels = sd.placeHolder("labels", None, 3)
    w0 = sd.var("w0", (4, 16))
    b0 = sd.var("b0", np.zeros(16, np.float32))
    w1 = sd.var("w1", (16, 3))
    b1 = sd.var("b1", np.zeros(3, np.float32))

    h = sd.nn.relu(sd.nn.linear(x, w0, b0))
    logits = sd.nn.linear(h, w1, b1).rename("logits")
    sd.loss.softmaxCrossEntropy("loss", labels, logits)
    sd.setLossVariables("loss")
    sd.setTrainingConfig(TrainingConfig.Builder()
                         .updater(Adam(1e-2)).l2(1e-4)
                         .dataSetFeatureMapping("x")
                         .dataSetLabelMapping("labels").build())

    rng = np.random.default_rng(0)
    X = rng.normal(size=(64, 4)).astype(np.float32)
    Y = np.eye(3, dtype=np.float32)[rng.integers(3, size=64)]
    for _ in range(50):
        loss = sd.fit(X, Y)
    print("final loss:", loss)
    grads = sd.calculateGradients({"x": X, "labels": Y}, "w0", "w1")
    norms = {k: float(np.linalg.norm(np.asarray(v.numpy())))
             for k, v in grads.items()}
    print("grad norms:", norms)
    probs = sd.outputSingle({"x": X[:4]}, "logits")
    row = np.asarray(probs.numpy())[0]
    print("logits[0]:", row)
    return {"loss": float(loss), "grad_norms": norms,
            "logits0": row.tolist()}


if __name__ == "__main__":
    main()
