"""The rest of the layer families against the JAX package on the CPU, layer
by layer: `layers.py`'s remaining layers, `special_layers.py` (the locally
connected layers, the autoencoders, PermuteLayer), `capsules.py` and
`layers3d.py` (their training and the rest of the families:
test_torch_layers_train.py).

Each layer is built alike in both packages; the JAX layer's parameters
(biases and 1-D parameters redrawn from a seed, so they matter) carry
across as numpy, and one seeded input goes through both. Tolerance:
forward, and the gradients of Σ y·r (r seeded) with respect to the input
and every parameter, 1e-5 relative to max(1, max |JAX|) (f32 sums in
another order)."""
import importlib
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_multilayer import _close, _np_tree

TOL = 1e-5
_MODULES = ("nn.conf.layers", "nn.conf.special_layers", "nn.conf.variational",
            "nn.conf.weightnoise", "nn.conf.capsules", "nn.conf.layers3d",
            "nn.conf.recurrent", "nn.conf.graph_vertices", "nn.conf.inputs",
            "nn.conf.builders", "nn.conf.samediff_layers", "nn.updaters",
            "nn.dropout", "nn.constraints", "nn.schedules")


def _ns(package):
    ns = {}
    for mod in _MODULES:
        m = importlib.import_module(f"{package}.{mod}")
        ns.update({k: v for k, v in vars(m).items()
                   if isinstance(v, type) and not k.startswith("_")})
    return types.SimpleNamespace(**ns)


J, T = _ns("deeplearning4j_tpu"), _ns("deeplearning4j_tpu_torch")
JMLN = importlib.import_module("deeplearning4j_tpu.nn.multilayer") \
    .MultiLayerNetwork
JCG = importlib.import_module("deeplearning4j_tpu.nn.graph").ComputationGraph


def _it(ns, kind, *dims):
    return getattr(ns.InputType, kind)(*dims)


def _layers_and_params(make, it, seed=0):
    """(JAX layer, port layer, numpy params, numpy state, JAX output type)
    with the port layer sized by its own initialize."""
    jl, tl = make(J), make(T)
    jl.apply_defaults({})
    tl.apply_defaults({})
    jp, js, jout = jl.initialize(jax.random.PRNGKey(seed), it(J))
    tl.initialize(torch.Generator().manual_seed(seed), it(T))
    rng = np.random.default_rng(seed + 100)
    params = {}
    for k, v in _np_tree(jp).items():
        v = np.array(v, np.float32)
        if v.ndim <= 1 or k.startswith("b") or k in ("rb", "vb"):
            v = rng.standard_normal(v.shape).astype(np.float32) * 0.3
        params[k] = v
    return jl, tl, params, _np_tree(js), jout


def _check_layer(make, it, x_shape, seed=0, train=False, what=""):
    """Forward and gradients of one layer in both packages."""
    jl, tl, params, state, jout = _layers_and_params(make, it, seed)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal(x_shape).astype(np.float32)

    def jf(p, xx):
        return jl.apply(p, {k: jnp.asarray(v) for k, v in state.items()},
                        xx, train=train)[0]

    # jitted: the JAX package's eager apply compiles op by op
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jy = np.asarray(jax.jit(jf)(jp, jnp.asarray(x)))
    r = rng.standard_normal(jy.shape).astype(np.float32)
    jgp, jgx = jax.jit(jax.grad(lambda p, xx: jnp.sum(jf(p, xx) * r),
                                argnums=(0, 1)))(jp, jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    ty, _ = tl.apply(tp, {k: torch.tensor(v) for k, v in state.items()}, tx,
                     train=train)
    _close(ty, jy, TOL, f"{what} forward")
    (ty * torch.tensor(r)).sum().backward()
    _close(tx.grad, np.asarray(jgx), TOL, f"{what} dx")
    for k in params:   # a parameter the forward does not read: a zero
        g = tp[k].grad if tp[k].grad is not None else torch.zeros(
            params[k].shape)
        _close(g, np.asarray(jgp[k]), TOL, f"{what} d{k}")
    tout = tl.output_type(it(T))
    assert tuple(tout.shape()) == tuple(jout.shape()), what
    return jy, jout


CONV = lambda h, w, c: (lambda ns: _it(ns, "convolutional", h, w, c))  # noqa
REC = lambda f, t: (lambda ns: _it(ns, "recurrent", f, t))  # noqa
FF = lambda n: (lambda ns: _it(ns, "feedForward", n))  # noqa
C3D = lambda d, h, w, c: (  # noqa
    lambda ns: _it(ns, "convolutional3D", d, h, w, c))

#: name -> (layer maker, input type, input shape)
CASES = {
    "Cropping2D": (lambda ns: ns.Cropping2D(cropping=(1, 0, 2, 1)),
                   CONV(6, 7, 3), (2, 6, 7, 3)),
    "LRN": (lambda ns: ns.LocalResponseNormalization(k=1.0, n=5, alpha=0.3,
                                                     beta=0.75),
            CONV(3, 3, 7), (2, 3, 3, 7)),
    "Deconv2D k4 s2 p1": (lambda ns: ns.Deconvolution2D(
        nOut=3, kernelSize=(4, 4), stride=(2, 2), padding=(1, 1),
        activation="tanh"), CONV(5, 5, 2), (2, 5, 5, 2)),
    "Deconv2D k2 s2 valid": (lambda ns: ns.Deconvolution2D(nOut=3),
                             CONV(4, 3, 2), (2, 4, 3, 2)),
    "Deconv2D k3 s2 same": (lambda ns: ns.Deconvolution2D(
        nOut=2, kernelSize=(3, 3), stride=(2, 2), convolutionMode="same"),
        CONV(4, 5, 3), (2, 4, 5, 3)),
    "Deconv2D k2 s3 valid": (lambda ns: ns.Deconvolution2D(
        nOut=2, kernelSize=(2, 2), stride=(3, 3)), CONV(3, 3, 2),
        (2, 3, 3, 2)),
    "Deconv2D k3 s1 p0,1": (lambda ns: ns.Deconvolution2D(
        nOut=2, kernelSize=(3, 3), stride=(1, 1), padding=(0, 1)),
        CONV(4, 4, 2), (2, 4, 4, 2)),
    "RepeatVector": (lambda ns: ns.RepeatVector(repetitionFactor=3), FF(4),
                     (2, 4)),
    "ZeroPadding1D": (lambda ns: ns.ZeroPadding1DLayer(padding=(1, 2)),
                      REC(3, 5), (2, 5, 3)),
    "Cropping1D": (lambda ns: ns.Cropping1D(cropping=(2, 1)), REC(3, 6),
                   (2, 6, 3)),
    "ZeroPadding2D": (lambda ns: ns.ZeroPaddingLayer(padding=(1, 2, 0, 1)),
                      CONV(3, 4, 2), (2, 3, 4, 2)),
    "PReLU": (lambda ns: ns.PReLULayer(alphaInit=0.2), CONV(3, 3, 4),
              (2, 3, 3, 4)),
    "Conv1D same": (lambda ns: ns.Convolution1DLayer(
        nOut=4, kernelSize=3, activation="tanh"), REC(3, 7), (2, 7, 3)),
    "Conv1D same s2 d2": (lambda ns: ns.Convolution1DLayer(
        nOut=4, kernelSize=2, stride=2, dilation=2), REC(3, 8), (2, 8, 3)),
    "Conv1D truncate p1 s2": (lambda ns: ns.Convolution1DLayer(
        nOut=2, kernelSize=3, stride=2, padding=1, convolutionMode="truncate"),
        REC(3, 8), (2, 8, 3)),
    "Upsampling1D": (lambda ns: ns.Upsampling1D(size=3), REC(2, 4),
                     (2, 4, 2)),
    "Subsampling1D max": (lambda ns: ns.Subsampling1DLayer(
        kernelSize=3, stride=2, padding=1), REC(3, 7), (2, 7, 3)),
    "Subsampling1D avg": (lambda ns: ns.Subsampling1DLayer(
        poolingType="avg", kernelSize=3, stride=2, padding=1), REC(3, 7),
        (2, 7, 3)),
    "CnnLossLayer": (lambda ns: ns.CnnLossLayer(lossFunction="mcxent"),
                     CONV(3, 3, 4), (2, 3, 3, 4)),
    "ElementWiseMultiplication": (lambda ns: ns.ElementWiseMultiplicationLayer(
        activation="tanh"), FF(5), (3, 5)),
    "LocallyConnected2D": (lambda ns: ns.LocallyConnected2D(
        nOut=3, kernelSize=(2, 3), activation="tanh"), CONV(4, 5, 2),
        (2, 4, 5, 2)),
    "LocallyConnected2D same s2": (lambda ns: ns.LocallyConnected2D(
        nOut=2, kernelSize=(3, 3), stride=(2, 2), convolutionMode="same"),
        CONV(5, 4, 2), (2, 5, 4, 2)),
    "LocallyConnected1D": (lambda ns: ns.LocallyConnected1D(
        nOut=3, kernelSize=3, stride=2), REC(2, 7), (2, 7, 2)),
    "LocallyConnected1D same": (lambda ns: ns.LocallyConnected1D(
        nOut=2, kernelSize=2, convolutionMode="same"), REC(3, 5), (2, 5, 3)),
    "Permute": (lambda ns: ns.PermuteLayer(dims=(3, 1, 2)), CONV(2, 3, 4),
                (2, 2, 3, 4)),
    "AutoEncoder": (lambda ns: ns.AutoEncoder(nOut=3, activation="sigmoid"),
                    FF(5), (3, 5)),
    "VAE": (lambda ns: ns.VariationalAutoencoder(
        nOut=2, encoderLayerSizes=(4, 3), decoderLayerSizes=(3,),
        activation="tanh"), FF(5), (3, 5)),
    "PrimaryCapsules": (lambda ns: ns.PrimaryCapsules(
        capsuleDimensions=4, channels=3, kernelSize=(3, 3), stride=(2, 2)),
        CONV(7, 7, 2), (2, 7, 7, 2)),
    "CapsuleLayer": (lambda ns: ns.CapsuleLayer(capsules=3,
                                                capsuleDimensions=4,
                                                routings=3),
                     REC(5, 6), (2, 6, 5)),
    "CapsuleStrength": (lambda ns: ns.CapsuleStrengthLayer(), REC(4, 3),
                        (2, 3, 4)),
    "OCNN": (lambda ns: ns.OCNNOutputLayer(hiddenLayerSize=4, nIn=5), FF(5),
             (3, 5)),
    "Conv3D p1": (lambda ns: ns.Convolution3D(
        nOut=3, kernelSize=(2, 3, 2), padding=(1, 1, 0), activation="tanh"),
        C3D(3, 4, 3, 2), (2, 3, 4, 3, 2)),
    "Conv3D same s2 d2": (lambda ns: ns.Convolution3D(
        nOut=2, kernelSize=(2, 2, 2), stride=(2, 1, 2), dilation=(1, 2, 1),
        convolutionMode="same"), C3D(4, 4, 5, 2), (2, 4, 4, 5, 2)),
    "Subsampling3D max": (lambda ns: ns.Subsampling3DLayer(
        kernelSize=(2, 2, 2), stride=(1, 2, 2), padding=(1, 0, 1)),
        C3D(3, 4, 4, 2), (2, 3, 4, 4, 2)),
    "Subsampling3D avg same": (lambda ns: ns.Subsampling3DLayer(
        poolingType="avg", kernelSize=(2, 3, 2), stride=(2, 2, 2),
        convolutionMode="same"), C3D(3, 5, 4, 2), (2, 3, 5, 4, 2)),
    "Upsampling3D": (lambda ns: ns.Upsampling3D(size=(2, 1, 3)),
                     C3D(2, 2, 2, 2), (2, 2, 2, 2, 2)),
    "Cropping3D": (lambda ns: ns.Cropping3D(cropping=(1, 0, 0, 1, 1, 1)),
                   C3D(3, 3, 4, 2), (2, 3, 3, 4, 2)),
    "ZeroPadding3D": (lambda ns: ns.ZeroPadding3DLayer(padding=(1, 0, 2)),
                      C3D(2, 2, 2, 2), (2, 2, 2, 2, 2)),
    "Cnn3DLossLayer": (lambda ns: ns.Cnn3DLossLayer(lossFunction="mse",
                                                    activation="sigmoid"),
                       C3D(2, 2, 2, 3), (2, 2, 2, 2, 3)),
    "Deconv3D k2 s2": (lambda ns: ns.Deconvolution3D(nOut=2),
                       C3D(2, 3, 2, 2), (2, 2, 3, 2, 2)),
    "Deconv3D k3 s2 p1": (lambda ns: ns.Deconvolution3D(
        nOut=2, kernelSize=(3, 3, 3), stride=(2, 2, 2), padding=(1, 1, 1)),
        C3D(2, 2, 3, 2), (2, 2, 2, 3, 2)),
    "Deconv3D same": (lambda ns: ns.Deconvolution3D(
        nOut=2, kernelSize=(3, 2, 3), stride=(2, 2, 1),
        convolutionMode="same"), C3D(2, 3, 2, 2), (2, 2, 3, 2, 2)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_forward_and_gradients_match_the_jax_package(name):
    make, it, shape = CASES[name]
    _check_layer(make, it, shape, what=name)


def test_deconvolution_declared_shape_mismatch_is_reproduced():
    """The JAX package's Deconvolution2D at k = 4, s = 2, p = 1 on 5×5
    computes 8×8 (lax pads the dilated input by p) while its output_type
    declares 10×10; the port computes and declares the same. At
    p = (k − 1)/2 the two agree."""
    make, it, shape = CASES["Deconv2D k4 s2 p1"]
    jy, jout = _check_layer(make, it, shape, what="deconv")
    assert jy.shape[1:3] == (8, 8)
    assert tuple(jout.shape()) == (10, 10, 3)
    tl = make(T)
    tl.apply_defaults({})
    assert tuple(tl.output_type(it(T)).shape()) == (10, 10, 3)
    jy, jout = _check_layer(lambda ns: ns.Deconvolution2D(
        nOut=2, kernelSize=(3, 3), stride=(2, 2), padding=(1, 1)),
        CONV(5, 5, 2), (1, 5, 5, 2), what="deconv agree")
    assert jy.shape[1:3] == tuple(jout.shape()[:2]) == (9, 9)


@pytest.mark.parametrize("mask", [False, True])
def test_one_dimensional_masks_follow_the_jax_package(mask):
    """feed_forward_mask of the 1-D layers that change the time axis."""
    m = (np.arange(9)[None, :] < np.array([[9], [5]])).astype(np.float32)
    for make in (lambda ns: ns.Convolution1DLayer(nOut=2, kernelSize=3,
                                                  stride=2),
                 lambda ns: ns.Convolution1DLayer(
                     nOut=2, kernelSize=3, stride=2, padding=1,
                     convolutionMode="truncate"),
                 lambda ns: ns.Upsampling1D(size=2),
                 lambda ns: ns.LocallyConnected1D(nOut=2, kernelSize=2,
                                                  stride=2)):
        jl, tl = make(J), make(T)
        got = tl.feed_forward_mask(torch.tensor(m) if mask else None)
        want = jl.feed_forward_mask(jnp.asarray(m) if mask else None)
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
