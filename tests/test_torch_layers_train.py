"""The training side of the new layer families against the JAX package on
the CPU: the VAE's negative ELBO given the JAX package's ε, the
AutoEncoder's loss given its corruption mask, `pretrainLayer`, weight noise
(WeightNoise, DropConnect), the custom SameDiff layers, and the slice as a
whole on a small CapsNet.

Tolerances: losses, gradients and parameters after a step 1e-5 relative
to max(1, max |JAX|) (f32 sums in another order); weight noise on the
inference path exactly (up to f32 sums), and by the statistics of its
draws at train time (the two packages' generators differ)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn import ComputationGraph, MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.convert import multilayer_params_from_numpy

from test_torch_layers_rest import (FF, JCG, JMLN, TOL, J, T,
                                    _layers_and_params)
from test_torch_multilayer import _close, _np_tree


# -- the VAE's loss, its ε from the JAX package ----------------------------------
DISTS = {
    "bernoulli": lambda ns: "bernoulli",
    "gaussian": lambda ns: ns.GaussianReconstructionDistribution("tanh"),
    "exponential": lambda ns: "exponential",
    "composite": lambda ns: ns.CompositeReconstructionDistribution(
        [(2, ns.BernoulliReconstructionDistribution()),
         (3, ns.GaussianReconstructionDistribution()),
         (1, ns.ExponentialReconstructionDistribution("tanh"))]),
}


@pytest.mark.parametrize("dist", sorted(DISTS))
def test_vae_pretrain_loss_and_gradients_given_the_jax_eps(dist):
    """pretrain_loss (numSamples 2) at the JAX package's ε
    (normal(fold_in(rng, s))) and its parameter gradients; the
    reconstruction, generateAtMeanGivenZ and reconstructionLogProbability
    the same way."""
    make = lambda ns: ns.VariationalAutoencoder(  # noqa
        nOut=3, encoderLayerSizes=(5,), decoderLayerSizes=(4, 5),
        activation="leakyrelu", numSamples=2,
        reconstructionDistribution=DISTS[dist](ns))
    jl, tl, params, _, _ = _layers_and_params(make, FF(6))
    rng = np.random.default_rng(5)
    x = rng.random((4, 6)).astype(np.float32)
    if dist in ("bernoulli", "composite"):
        x[:, :2] = (x[:, :2] > 0.5)
    key = jax.random.PRNGKey(11)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jloss, jg = jax.jit(jax.value_and_grad(jl.pretrain_loss))(
        jp, jnp.asarray(x), key)
    mu = jax.jit(jl._encode)(jp, jnp.asarray(x))[0]
    eps = [np.asarray(jax.random.normal(jax.random.fold_in(key, s), mu.shape,
                                        mu.dtype)) for s in range(2)]
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tloss = tl.pretrain_loss(tp, torch.tensor(x), eps=eps)
    _close(tloss, float(jloss), TOL, "negative ELBO")
    tloss.backward()
    for k in params:
        _close(tp[k].grad, np.asarray(jg[k]), TOL, f"d{k}")
    with torch.no_grad():
        tp = {k: torch.tensor(v) for k, v in params.items()}
        _close(tl.reconstruct(tp, torch.tensor(x)),
               np.asarray(jax.jit(jl.reconstruct)(jp, jnp.asarray(x))), TOL,
               "recon")
        z = rng.standard_normal((3, 3)).astype(np.float32)
        _close(tl.generateAtMeanGivenZ(tp, z),
               np.asarray(jax.jit(jl.generateAtMeanGivenZ)(jp, z)), TOL,
               "generate")
        _close(tl.reconstructionLogProbability(tp, torch.tensor(x), eps=eps),
               np.asarray(jax.jit(jl.reconstructionLogProbability)(
                   jp, jnp.asarray(x), key)), TOL, "log p(x)")


@pytest.mark.parametrize("loss", ["mse", "xent"])
def test_autoencoder_pretrain_loss_given_the_jax_corruption(loss):
    """AutoEncoder.pretrain_loss (corruption 0.3, sparsity 0.1) with the
    JAX package's keep mask, and its gradients."""
    make = lambda ns: ns.AutoEncoder(  # noqa
        nOut=4, corruptionLevel=0.3, sparsity=0.1, lossFunction=loss,
        activation="sigmoid")
    jl, tl, params, _, _ = _layers_and_params(make, FF(6))
    x = np.random.default_rng(2).random((5, 6)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jloss, jg = jax.jit(jax.value_and_grad(jl.pretrain_loss))(
        jp, jnp.asarray(x), key)
    keep = np.asarray(jax.random.bernoulli(key, 0.7, x.shape))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tloss = tl.pretrain_loss(tp, torch.tensor(x), keep=torch.tensor(keep))
    _close(tloss, float(jloss), TOL, "loss")
    tloss.backward()
    for k in params:
        _close(tp[k].grad, np.asarray(jg[k]), TOL, f"d{k}")


def _vae_conf(ns):
    return (ns.NeuralNetConfiguration.Builder().seed(12)
            .updater(ns.RmsProp(1e-2)).weightInit("xavier").l2(1e-4)
            .list()
            .layer(ns.VariationalAutoencoder(
                nOut=2, encoderLayerSizes=(8, 8), decoderLayerSizes=(8, 8),
                activation="leakyrelu", reconstructionDistribution="bernoulli",
                pzxActivationFunction="identity"))
            .layer(ns.OutputLayer(nOut=3))
            .setInputType(ns.InputType.feedForward(10)).build())


def test_pretrain_layer_step_matches_the_jax_package():
    """One MultiLayerNetwork.pretrainLayer step of the VAE, its ε the JAX
    package's (its network key split once, as its step draws it): the new
    parameters within 1e-5. Then `pretrain` over the net lowers the
    negative ELBO in 20 steps."""
    jnet = JMLN(_vae_conf(J)).init()
    tnet = multilayer_params_from_numpy(
        MultiLayerNetwork(_vae_conf(T)), _np_tree(jnet._params),
        _np_tree(jnet._state), device="cpu")
    x = (np.random.default_rng(3).random((16, 10)) > 0.5).astype(np.float32)
    _, sub = jax.random.split(jnet._rng_key)
    layer, jlayer = tnet.layers[0], jnet.layers[0]
    mu = jlayer._encode(jnet._params["0"], jnp.asarray(x))[0]
    eps = [np.asarray(jax.random.normal(jax.random.fold_in(sub, 0),
                                        mu.shape, mu.dtype))]
    plain = layer.pretrain_loss
    layer.pretrain_loss = lambda p, xx, g: plain(p, xx, eps=eps)
    jnet.pretrainLayer(0, x)
    tnet.pretrainLayer(0, x)
    _close(tnet.score(), float(jnet._score), TOL, "loss")
    for k, v in _np_tree(jnet._params["0"]).items():
        _close(tnet._params["0"][k], v, TOL, f"0/{k}")
    layer.pretrain_loss = plain
    first = None
    for _ in range(20):
        tnet.pretrain(DataSet(x, np.zeros((16, 3), np.float32)))
        first = tnet.score() if first is None else first
    assert np.isfinite(tnet.score()) and tnet.score() < first
    assert tnet._tx is None   # the network's optimizer starts afresh


# -- weight noise ----------------------------------------------------------------
def _noise_conf(ns, noise):
    return (ns.NeuralNetConfiguration.Builder().seed(6).updater(ns.Sgd(0.1))
            .weightNoise(noise).list()
            .layer(ns.DenseLayer(nOut=64, activation="identity"))
            .layer(ns.OutputLayer(nOut=3))
            .setInputType(ns.InputType.feedForward(200)).build())


NOISES = {"dropconnect": lambda ns: ns.DropConnect(0.6),
          "additive": lambda ns: ns.WeightNoise({"type": "normal",
                                                 "std": 0.05}),
          "multiplicative": lambda ns: ns.WeightNoise(
              {"type": "normal", "mean": 1.0, "std": 0.1}, additive=False),
          "uniform, bias": lambda ns: ns.WeightNoise(
              {"type": "uniform", "lower": -0.1, "upper": 0.1},
              applyToBias=True)}


@pytest.mark.parametrize("kind", sorted(NOISES))
def test_weight_noise_eval_exact_and_train_draws_by_their_statistics(kind):
    """Inference ignores the noise (exactly the output of the same net
    without it, and the JAX package's up to f32 sums); at train time the noised parameters have the distribution's
    statistics and the bias is left alone unless applyToBias."""
    jnet = JMLN(_noise_conf(J, NOISES[kind](J))).init()
    tnet = multilayer_params_from_numpy(
        MultiLayerNetwork(_noise_conf(T, NOISES[kind](T))),
        _np_tree(jnet._params), _np_tree(jnet._state), device="cpu")
    x = np.random.default_rng(1).standard_normal((4, 200)).astype(np.float32)
    _close(tnet.output(x), np.asarray(jnet.output(x).numpy()), TOL, "eval")
    clean = multilayer_params_from_numpy(
        MultiLayerNetwork(_noise_conf(T, None)), _np_tree(jnet._params),
        {}, device="cpu")
    assert torch.equal(tnet.output(x), clean.output(x))
    layer = tnet.layers[0]
    p = tnet._params["0"]
    gen = torch.Generator().manual_seed(0)
    noised = layer.weightNoise.apply_to_params(p, gen)
    w, wn = p["W"], noised["W"]
    if kind == "dropconnect":
        kept = (wn != 0).float().mean().item()
        assert abs(kept - 0.6) < 0.01
        assert torch.allclose(wn[wn != 0], (w / 0.6)[wn != 0])
    elif kind == "additive":
        d = wn - w
        assert abs(d.mean().item()) < 2e-3 and abs(d.std().item() - 0.05) \
            < 2e-3
    elif kind == "multiplicative":
        r = wn / w
        assert abs(r.mean().item() - 1.0) < 4e-3 and abs(
            r.std().item() - 0.1) < 4e-3
    else:
        d = wn - w
        assert d.abs().max().item() <= 0.1 and abs(
            d.std().item() - 0.2 / 12 ** 0.5) < 2e-3
    assert torch.equal(noised["b"], p["b"]) == (kind != "uniform, bias")
    # the training forward draws fresh noise from the network's generator
    g = torch.Generator().manual_seed(1)
    a = tnet.output(x, train=True, generator=g)
    b = tnet.output(x, train=True, generator=g)
    assert not torch.equal(a, b)


# -- custom SameDiff layers ------------------------------------------------------
class JTimesPlus(J.SameDiffLayer):
    def defineParameters(self):
        return {"W": (self.nIn, self.nOut), "b": (self.nOut,)}

    def defineLayer(self, params, x, mask=None):
        return jnp.tanh(x @ params["W"] + params["b"])


class TTimesPlus(T.SameDiffLayer):
    def defineParameters(self):
        return {"W": (self.nIn, self.nOut), "b": (self.nOut,)}

    def defineLayer(self, params, x, mask=None):
        return torch.tanh(x @ params["W"] + params["b"])


class JSqErr(J.SameDiffOutputLayer):
    def defineParameters(self):
        return {"W": (self.nIn, self.nOut)}

    def defineLayer(self, params, x, mask=None):
        return x @ params["W"]

    def defineLoss(self, labels, output, mask=None):
        return jnp.mean((output - labels) ** 2)


class TSqErr(T.SameDiffOutputLayer):
    def defineParameters(self):
        return {"W": (self.nIn, self.nOut)}

    def defineLayer(self, params, x, mask=None):
        return x @ params["W"]

    def defineLoss(self, labels, output, mask=None):
        return ((output - labels) ** 2).mean()


class JGate(J.SameDiffVertex):
    def defineParameters(self):
        return {"g": (3, 3)}

    def defineVertex(self, params, a, b, mask=None):
        return jax.nn.sigmoid(a @ params["g"]) * b


class TGate(T.SameDiffVertex):
    def defineParameters(self):
        return {"g": (3, 3)}

    def defineVertex(self, params, a, b, mask=None):
        return torch.sigmoid(a @ params["g"]) * b


def test_samediff_layers_train_like_the_jax_package():
    """A SameDiffLayer and a SameDiffOutputLayer in a MultiLayerNetwork,
    and a SameDiffVertex in a ComputationGraph: one Sgd step each, the
    same parameters within 1e-5."""
    def mln(ns, hidden, out):
        return (ns.NeuralNetConfiguration.Builder().seed(1)
                .updater(ns.Sgd(0.1)).list().layer(hidden(nOut=4))
                .layer(out(nOut=2))
                .setInputType(ns.InputType.feedForward(3)).build())

    def graph(ns, gate):
        return (ns.NeuralNetConfiguration.Builder().seed(1)
                .updater(ns.Sgd(0.1)).graphBuilder().addInputs("a", "b")
                .setInputTypes(ns.InputType.feedForward(3),
                               ns.InputType.feedForward(3))
                .addVertex("gate", gate(), "a", "b")
                .addLayer("out", ns.OutputLayer(nOut=2, activation="softmax"),
                          "gate").setOutputs("out").build())

    rng = np.random.default_rng(0)
    x, a, b = (rng.standard_normal((5, 3)).astype(np.float32)
               for _ in range(3))
    y = rng.standard_normal((5, 2)).astype(np.float32)
    jnet = JMLN(mln(J, JTimesPlus, JSqErr)).init()
    tnet = multilayer_params_from_numpy(
        MultiLayerNetwork(mln(T, TTimesPlus, TSqErr)),
        _np_tree(jnet._params), {}, device="cpu")
    _close(tnet.output(x), np.asarray(jnet.output(x).numpy()), TOL, "mln")
    jnet.fit(JDataSet(x, y))
    tnet.fit(DataSet(x, y))
    for n, d in _np_tree(jnet._params).items():
        for k, v in d.items():
            _close(tnet._params[n][k], v, TOL, f"mln {n}/{k}")
    from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMDS
    from deeplearning4j_tpu_torch.datasets import MultiDataSet
    from deeplearning4j_tpu_torch.nn import graph_params_from_numpy
    lab = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 5)]
    jg = JCG(graph(J, JGate)).init()
    tg = graph_params_from_numpy(ComputationGraph(graph(T, TGate)),
                                 _np_tree(jg._params), {}, device="cpu")
    jg.fit(JMDS([a, b], [lab]))
    tg.fit(MultiDataSet([a, b], [lab]))
    for n, d in _np_tree(jg._params).items():
        for k, v in d.items():
            _close(tg._params[n][k], v, TOL, f"graph {n}/{k}")


# -- the slice as a whole: a small CapsNet ---------------------------------------
def _capsnet(ns):
    """Sabour et al.'s CapsNet shrunk: conv, PrimaryCapsules, CapsuleLayer
    with 3 routings, CapsuleStrengthLayer, the softmax LossLayer head of
    the JAX package's capsule test."""
    return (ns.NeuralNetConfiguration.Builder().seed(3)
            .updater(ns.Nesterovs(1e-2, 0.9)).list()
            .layer(ns.ConvolutionLayer(kernelSize=(3, 3), nOut=8,
                                       activation="relu"))
            .layer(ns.PrimaryCapsules(capsuleDimensions=4, channels=4,
                                      kernelSize=(3, 3), stride=(2, 2)))
            .layer(ns.CapsuleLayer(capsules=3, capsuleDimensions=6,
                                   routings=3))
            .layer(ns.CapsuleStrengthLayer())
            .layer(ns.LossLayer(lossFunction="mcxent", activation="softmax"))
            .setInputType(ns.InputType.convolutional(11, 11, 1)).build())


def test_capsnet_forward_and_one_step_match_the_jax_package():
    jnet = JMLN(_capsnet(J)).init()
    tnet = multilayer_params_from_numpy(
        MultiLayerNetwork(_capsnet(T)), _np_tree(jnet._params), {},
        device="cpu")
    rng = np.random.default_rng(8)
    x = rng.random((6, 11, 11, 1)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)]
    _close(tnet.output(x), np.asarray(jnet.output(x).numpy()), TOL, "out")
    jnet.fit(JDataSet(x, y))
    tnet.fit(DataSet(x, y))
    _close(tnet.score(), float(jnet.score()), TOL, "loss")
    for n, d in _np_tree(jnet._params).items():
        for k, v in d.items():
            _close(tnet._params[n][k], v, TOL, f"{n}/{k}")
