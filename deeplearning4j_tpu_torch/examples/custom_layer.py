"""Define a CUSTOM layer outside the framework (≡ dl4j-examples ::
CustomLayerExample on conf.layers.samediff.SameDiffLayer): the twin of
`examples/custom_layer.py` on the port — declare the parameter shapes,
write the forward in plain torch, train and serialize like any built-in
layer.

Two deviations: `MaxoutDense.defineLayer` is torch (the script's is
jax.numpy), and the archive goes to a temporary directory (the script
writes /tmp/maxout_net.zip). The restore finds the layer class by this
module's path, which the archive records.

Run: `python -m deeplearning4j_tpu_torch.examples.custom_layer` (the
card; `main(device="cpu")` runs it on the CPU)."""
import os
import tempfile

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn import (Adam, InputType, MultiLayerNetwork,
                                         NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf.layers import OutputLayer
from deeplearning4j_tpu_torch.nn.conf.samediff_layers import SameDiffLayer


class MaxoutDense(SameDiffLayer):
    """Maxout unit: y_j = max_k (x·W_k)_j — not in the built-in catalog."""

    def __init__(self, nOut=None, pieces=3, **kw):
        super().__init__(**kw)
        self.nOut = nOut
        self.pieces = int(pieces)

    def defineParameters(self):
        return {"W": (self.pieces, self.nIn, self.nOut),
                "b": (self.pieces, self.nOut)}

    def defineLayer(self, params, x, mask=None):
        z = torch.einsum("bi,pio->bpo", x, params["W"]) + params["b"]
        return z.amax(dim=1)


def main(device=None):
    conf = (NeuralNetConfiguration.Builder()
            .seed(3).updater(Adam(1e-2)).weightInit("xavier")
            .list()
            .layer(MaxoutDense(nOut=16, pieces=3))
            .layer(OutputLayer(lossFunction="mcxent", nOut=3,
                               activation="softmax"))
            .setInputType(InputType.feedForward(6))
            .build())
    net = MultiLayerNetwork(conf).init(device)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((96, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[(np.abs(x).argmax(-1) % 3)]
    for _ in range(60):
        net.fit(x, y)
    out = np.asarray(net.output(x))
    acc = float((out.argmax(-1) == y.argmax(-1)).mean())
    print(f"train accuracy: {acc:.3f}")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "maxout_net.zip")
        net.save(path)
        restored = MultiLayerNetwork.load(path, device=device)
    if not isinstance(restored.layers[0], MaxoutDense):
        raise AssertionError(f"restored {type(restored.layers[0])}")
    back = np.asarray(restored.output(x))
    if not np.allclose(back, out):
        raise AssertionError("custom layer: restored output differs by "
                             f"{np.abs(back - out).max()}")
    print("custom layer round-tripped through ModelSerializer")
    return {"accuracy": acc, "round_trip_max_diff":
            float(np.abs(back - out).max())}


if __name__ == "__main__":
    main()
