"""Variational autoencoder for anomaly scoring (≡ dl4j-examples ::
VariationalAutoEncoderExample): the twin of `examples/vae_anomaly.py` on
the port — pretrain the VAE layer unsupervised (`pretrainLayer`), score
outliers by the VAE's mean reconstruction (`reconstruct`).

Run: `python -m deeplearning4j_tpu_torch.examples.vae_anomaly` (the card;
`main(device="cpu")` runs it on the CPU)."""
import numpy as np
import torch

from deeplearning4j_tpu_torch.nn import (Adam, InputType, MultiLayerNetwork,
                                         NeuralNetConfiguration, OutputLayer,
                                         VariationalAutoencoder)


def main(device=None):
    net = MultiLayerNetwork(
        NeuralNetConfiguration.Builder().seed(3).updater(Adam(1e-3))
        .weightInit("xavier").activation("tanh").list()
        .layer(VariationalAutoencoder(
            nOut=2, encoderLayerSizes=(32,), decoderLayerSizes=(32,),
            reconstructionDistribution="gaussian"))
        .layer(OutputLayer(lossFunction="mse", nOut=1,
                           activation="identity"))
        .setInputType(InputType.feedForward(8)).build()).init(device)

    rng = np.random.default_rng(0)
    normal = rng.normal(0, 1, size=(256, 8)).astype(np.float32)
    net.pretrainLayer(0, normal, epochs=150)

    vae = net.layers[0]
    params = net._params["0"]
    inliers = rng.normal(0, 1, size=(16, 8)).astype(np.float32)
    outliers = rng.normal(6, 1, size=(16, 8)).astype(np.float32)

    def recon_error(batch):
        with torch.no_grad():
            rec = vae.reconstruct(params, torch.as_tensor(
                batch, device=net._device)).cpu().numpy()
        return float(((rec - batch) ** 2).mean())

    out = {"inlier_mse": recon_error(inliers),
           "outlier_mse": recon_error(outliers)}
    print("inlier reconstruction MSE: ", round(out["inlier_mse"], 3))
    print("outlier reconstruction MSE:", round(out["outlier_mse"], 3))
    return out


if __name__ == "__main__":
    main()
