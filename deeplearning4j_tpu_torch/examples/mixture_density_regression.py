"""Mixture density network regression (≡ LossMixtureDensity use case):
the twin of `examples/mixture_density_regression.py` on the port. The
target is BIMODAL per input — plain MSE would predict the useless mean,
the mixture places mass on both modes and sample() draws from them.

One deviation: the samples come from a `torch.Generator` seeded 0 on the
output's device (the script draws from `jax.random.PRNGKey(0)`), so they
are other draws of the same mixture; the script's check (more than half
within 1 of ±2) stays.

Run: `python -m deeplearning4j_tpu_torch.examples.mixture_density_regression`
(the card; `main(device="cpu")` runs it on the CPU)."""
import numpy as np
import torch

from deeplearning4j_tpu_torch.nn import (Adam, DenseLayer, InputType,
                                         MultiLayerNetwork,
                                         NeuralNetConfiguration, OutputLayer)
from deeplearning4j_tpu_torch.nn.losses import LossMixtureDensity


def main(device=None):
    loss = LossMixtureDensity(gaussians=2, labelWidth=1)
    net = MultiLayerNetwork(
        NeuralNetConfiguration.Builder().seed(0).updater(Adam(1e-2))
        .weightInit("xavier").list()
        .layer(DenseLayer(nOut=32, activation="tanh"))
        .layer(OutputLayer(nOut=loss.nOut(), activation="identity",
                           lossFunction=loss))
        .setInputType(InputType.feedForward(1)).build()).init(device)

    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, size=(256, 1)).astype(np.float32)
    sign = rng.choice([-1.0, 1.0], size=(256, 1))
    y = (sign * 2.0 + 0.05 * rng.standard_normal((256, 1))
         ).astype(np.float32)

    nll = []
    for i in range(300):
        net.fit(x, y)
        if i % 100 == 99:
            nll.append(float(net.score()))
            print(f"iter {i + 1}: NLL {nll[-1]:.3f}")

    pre = net.output(x[:5]).tensor
    gen = torch.Generator(device=pre.device).manual_seed(0)
    samples = loss.sample(pre, gen).cpu().numpy()
    print("mixture samples for 5 inputs:", np.round(samples.ravel(), 2))
    # samples land near one of the two modes, not the mean (0)
    near = float((np.abs(np.abs(samples) - 2.0) < 1.0).mean())
    if not near > 0.5:
        raise AssertionError(f"MDN: {near} of the samples near ±2")
    return {"nll": nll, "samples": samples.ravel().tolist(),
            "near_modes": near}


if __name__ == "__main__":
    main()
