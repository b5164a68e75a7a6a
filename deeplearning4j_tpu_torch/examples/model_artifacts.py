"""Durable model artifacts: SameDiff full-graph save/load — the twin of
`examples/model_artifacts.py` on the port.

Shows the three persistence forms a reference user expects:
  1. SameDiff.save/load — the whole graph (ops + values + training
     config) as one self-contained zip, restored with NO defining code;
  2. save_updater=True — optimizer moments travel too, so fit() resumes
     mid-momentum;
  3. ModelGuesser — "load whatever this file is".

The script reads arrays with `.jax()`; the twin with `.numpy()`.

Run: `python -m deeplearning4j_tpu_torch.examples.model_artifacts` (the
card; `main(device="cpu")` runs it on the CPU)."""
import os
import tempfile

import numpy as np

from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff, TrainingConfig
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.util.model_guesser import ModelGuesser


def build(device=None):
    sd = SameDiff.create(device=device)
    x = sd.placeHolder("x", None, 8)
    w1 = sd.var("w1", np.random.RandomState(0).randn(8, 16).astype(
        np.float32) * 0.3)
    b1 = sd.var("b1", np.zeros(16, np.float32))
    h = sd.nn.relu(sd.nn.linear(x, w1, b1))
    w2 = sd.var("w2", np.random.RandomState(1).randn(16, 3).astype(
        np.float32) * 0.3)
    logits = h.mmul(w2).rename("logits")
    sd.nn.softmax(logits).rename("probs")
    labels = sd.placeHolder("labels", None, 3)
    sd.loss.softmaxCrossEntropy("loss", labels, logits)
    sd.setLossVariables("loss")
    sd.setTrainingConfig(TrainingConfig(updater=Adam(1e-2),
                                        dataSetFeatureMapping=["x"],
                                        dataSetLabelMapping=["labels"]))
    return sd


def main(device=None):
    rng = np.random.RandomState(2)
    xs = rng.randn(32, 8).astype(np.float32)
    ys = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 32)]

    sd = build(device)
    for _ in range(10):
        loss = sd.fit(xs, ys)
    print(f"trained 10 steps, loss={loss:.4f}")
    out = {"loss": float(loss)}

    with tempfile.TemporaryDirectory() as d:
        art = os.path.join(d, "classifier.sdz")
        # 1+2: full graph + optimizer moments, one zip, no pickle
        sd.save(art, save_updater=True)
        out["bytes"] = os.path.getsize(art)
        print(f"saved {out['bytes']} bytes -> {art}")

        restored = SameDiff.load(art, device=device)   # no build() needed
        probs = restored.outputSingle({"x": xs[:4]}, "probs")
        out["probs0"] = np.asarray(probs.numpy())[0].round(3).tolist()
        print("restored probs[0]:", np.asarray(out["probs0"]))

        out["resumed_loss"] = float(restored.fit(xs, ys))  # mid-momentum
        print(f"resumed training, loss={out['resumed_loss']:.4f}")
        # the uninterrupted graph's next step, for comparison
        out["uninterrupted_loss"] = float(sd.fit(xs, ys))

        # 3: the load-anything surface recognizes the artifact
        guessed = ModelGuesser.loadModelGuess(art, device=device)
        out["guessed"] = type(guessed).__name__
        print("ModelGuesser ->", out["guessed"])
    return out


if __name__ == "__main__":
    main()
