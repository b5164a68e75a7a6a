"""Special layers: the port of `deeplearning4j_tpu/nn/conf/special_layers.py`
(≡ deeplearning4j-nn :: conf.layers.LocallyConnected1D/2D,
conf.layers.variational.VariationalAutoencoder, conf.layers.AutoEncoder,
conf.layers.misc.CenterLossOutputLayer, Keras' Permute).

LocallyConnected1D/2D keep the JAX package's kernel layout, one filter
bank per output position, and contract the unrolled patches in one
einsum (a batched product per position). The autoencoders train by
`MultiLayerNetwork.pretrain` / `pretrainLayer` (≡ the reference's
layerwise pretraining) through their `pretrain_loss`; mid-network their
`apply` is the encoder (the VAE's latent mean). The VAE's loss takes its
ε from the caller (`eps`, one (B, nOut) draw per sample) or draws it from
the network's generator.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf.inputs import (Convolutional3DType,
                                                     ConvolutionalType,
                                                     InputType,
                                                     RecurrentType)
from deeplearning4j_tpu_torch.nn.conf.layers import (BaseOutputLayer,
                                                     DenseLayer, Layer, _pair)
from deeplearning4j_tpu_torch.nn.dropout import keep_mask
from deeplearning4j_tpu_torch.nn.losses import get_loss
from deeplearning4j_tpu_torch.nn.weights_init import init_weight

_LOG_2PI = math.log(2 * math.pi)


class LocallyConnected2D(Layer):
    """≡ conf.layers.LocallyConnected2D — a convolution with UNSHARED
    weights: W (oh, ow, kh·kw·nIn, nOut), b (oh, ow, nOut)."""

    def __init__(self, nIn=None, nOut=None, kernelSize=(3, 3), stride=(1, 1),
                 convolutionMode="truncate", hasBias=True, **kw):
        super().__init__(**kw)
        self.nIn, self.nOut = nIn, nOut
        self.kernelSize, self.stride = _pair(kernelSize), _pair(stride)
        self.convolutionMode = convolutionMode
        self.hasBias = hasBias

    def _same(self):
        return str(self.convolutionMode).lower() == "same"

    def _out_hw(self, input_type):
        kh, kw = self.kernelSize
        sh, sw = self.stride
        if self._same():
            return -(-input_type.height // sh), -(-input_type.width // sw)
        return ((input_type.height - kh) // sh + 1,
                (input_type.width - kw) // sw + 1)

    def output_type(self, input_type):
        if not isinstance(input_type, ConvolutionalType):
            raise ValueError(
                f"LocallyConnected2D '{self.name}' needs convolutional "
                f"input, got {input_type}")
        oh, ow = self._out_hw(input_type)
        return InputType.convolutional(oh, ow, self.nOut)

    def initialize(self, generator, input_type):
        if self.nIn is None:
            self.nIn = input_type.channels
        if self.nOut is None:
            raise ValueError(f"LocallyConnected2D '{self.name}': nOut not set")
        oh, ow = self._out_hw(input_type)
        kh, kw = self.kernelSize
        params = {"W": init_weight(generator, (oh, ow, kh * kw * int(self.nIn),
                                               int(self.nOut)),
                                   self.weightInit, self.dist)}
        if self.hasBias:
            params["b"] = torch.full((oh, ow, int(self.nOut)),
                                     float(self.biasInit))
        return params, {}, self.output_type(input_type)

    def pre_activation(self, params, x):
        kh, kw = self.kernelSize
        sh, sw = self.stride
        oh, ow = params["W"].shape[:2]
        if self._same():
            ph = max(0, (oh - 1) * sh + kh - x.shape[1])
            pw = max(0, (ow - 1) * sw + kw - x.shape[2])
            x = F.pad(x, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        # the patches in the JAX package's order: (B, oh, ow, kh·kw·C)
        xp = torch.cat([x[:, di:di + oh * sh:sh, dj:dj + ow * sw:sw, :]
                        for di in range(kh) for dj in range(kw)], dim=-1)
        y = torch.einsum("bhwp,hwpo->bhwo", xp, params["W"].to(x.dtype))
        if self.hasBias:
            y = y + params["b"].to(x.dtype)
        return y

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        x = self._dropout_in(x, train, generator)
        return (get_activation(self.activation)(
            self.pre_activation(params, x)), state)


class LocallyConnected1D(Layer):
    """≡ conf.layers.LocallyConnected1D — a temporal convolution with
    UNSHARED weights over (B, T, F): W (ot, k·nIn, nOut), b (ot, nOut).
    Needs a static timeSeriesLength on the input type."""

    def __init__(self, nIn=None, nOut=None, kernelSize=3, stride=1,
                 convolutionMode="truncate", hasBias=True, **kw):
        super().__init__(**kw)
        self.nIn, self.nOut = nIn, nOut
        self.kernelSize, self.stride = int(kernelSize), int(stride)
        self.convolutionMode = convolutionMode
        self.hasBias = hasBias

    def _out_t(self, t):
        if str(self.convolutionMode).lower() == "same":
            return -(-t // self.stride)
        return (t - self.kernelSize) // self.stride + 1

    def output_type(self, input_type):
        t = getattr(input_type, "timeSeriesLength", None)
        if t is None:
            raise ValueError(
                f"LocallyConnected1D '{self.name}' needs recurrent input "
                f"with a known timeSeriesLength, got {input_type}")
        return InputType.recurrent(self.nOut, self._out_t(t))

    def feed_forward_mask(self, mask):
        if mask is None:
            return None
        m = mask[:, ::self.stride]
        return m[:, : self._out_t(mask.shape[1])]

    def initialize(self, generator, input_type):
        if self.nIn is None:
            self.nIn = input_type.size
        if self.nOut is None:
            raise ValueError(f"LocallyConnected1D '{self.name}': nOut not set")
        ot = self._out_t(input_type.timeSeriesLength)
        params = {"W": init_weight(generator, (ot, self.kernelSize
                                               * int(self.nIn),
                                               int(self.nOut)),
                                   self.weightInit, self.dist)}
        if self.hasBias:
            params["b"] = torch.full((ot, int(self.nOut)),
                                     float(self.biasInit))
        return params, {}, self.output_type(input_type)

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        x = self._dropout_in(x, train, generator)
        k, s = self.kernelSize, self.stride
        ot = params["W"].shape[0]
        if str(self.convolutionMode).lower() == "same":
            pad = max(0, (ot - 1) * s + k - x.shape[1])
            x = F.pad(x, (0, 0, pad // 2, pad - pad // 2))
        xp = torch.cat([x[:, d:d + ot * s:s, :] for d in range(k)], dim=-1)
        y = torch.einsum("btp,tpo->bto", xp, params["W"].to(x.dtype))
        if self.hasBias:
            y = y + params["b"].to(x.dtype)
        return get_activation(self.activation)(y), state


class VariationalAutoencoder(Layer):
    """≡ conf.layers.variational.VariationalAutoencoder.

    A Gaussian q(z|x); `reconstructionDistribution` is a name ('gaussian',
    'bernoulli', 'exponential') or a ReconstructionDistribution object,
    CompositeReconstructionDistribution included (`nn/conf/variational.py`).
    Mid-network `apply` gives the latent mean; `pretrain_loss` is the
    negative ELBO that `MultiLayerNetwork.pretrainLayer` minimises.
    Parameters: the encoder's eW<i>/eb<i>, the heads muW/mub and lvW/lvb,
    the decoder's dW<i>/db<i> and the reconstruction head rW/rb, the JAX
    package's names and shapes.
    """

    def __init__(self, nIn=None, nOut=None, encoderLayerSizes=(256,),
                 decoderLayerSizes=(256,),
                 reconstructionDistribution="gaussian",
                 pzxActivationFunction="identity", numSamples=1, **kw):
        super().__init__(**kw)
        self.nIn, self.nOut = nIn, nOut
        self.encoderLayerSizes = tuple(int(s) for s in encoderLayerSizes)
        self.decoderLayerSizes = tuple(int(s) for s in decoderLayerSizes)
        self.reconstructionDistribution = reconstructionDistribution
        self.pzxActivationFunction = pzxActivationFunction
        self.numSamples = int(numSamples)

    def output_type(self, input_type):
        return InputType.feedForward(self.nOut)

    def initialize(self, generator, input_type):
        if self.nIn is None:
            self.nIn = input_type.size
        if self.nOut is None:
            raise ValueError(
                f"VariationalAutoencoder '{self.name}': nOut not set")

        def dense(prefix, i, a, b):
            params[f"{prefix}W{i}"] = init_weight(generator, (a, b),
                                                  self.weightInit, self.dist)
            params[f"{prefix}b{i}"] = torch.zeros((b,))

        params = {}
        sizes_e = (int(self.nIn),) + self.encoderLayerSizes
        for i, (a, b) in enumerate(zip(sizes_e[:-1], sizes_e[1:])):
            dense("e", i, a, b)
        h, n_out = sizes_e[-1], int(self.nOut)
        for head in ("mu", "lv"):
            params[f"{head}W"] = init_weight(generator, (h, n_out),
                                             self.weightInit, self.dist)
            params[f"{head}b"] = torch.zeros((n_out,))
        sizes_d = (n_out,) + self.decoderLayerSizes
        for i, (a, b) in enumerate(zip(sizes_d[:-1], sizes_d[1:])):
            dense("d", i, a, b)
        n_params = self._distribution().num_params(int(self.nIn))
        params["rW"] = init_weight(generator, (sizes_d[-1], n_params),
                                   self.weightInit, self.dist)
        params["rb"] = torch.zeros((n_params,))
        return params, {}, self.output_type(input_type)

    def _distribution(self):
        from deeplearning4j_tpu_torch.nn.conf.variational import \
            resolve_reconstruction_distribution
        return resolve_reconstruction_distribution(
            self.reconstructionDistribution)

    # -- encoder/decoder pieces ------------------------------------------
    def _encode(self, params, x):
        act = get_activation(self.activation)
        h = x
        for i in range(len(self.encoderLayerSizes)):
            h = act(h @ params[f"eW{i}"].to(x.dtype)
                    + params[f"eb{i}"].to(x.dtype))
        pzx = get_activation(self.pzxActivationFunction)
        mu = pzx(h @ params["muW"].to(x.dtype) + params["mub"].to(x.dtype))
        logvar = h @ params["lvW"].to(x.dtype) + params["lvb"].to(x.dtype)
        return mu, logvar

    def _decode(self, params, z):
        act = get_activation(self.activation)
        h = z
        for i in range(len(self.decoderLayerSizes)):
            h = act(h @ params[f"dW{i}"].to(z.dtype)
                    + params[f"db{i}"].to(z.dtype))
        return h

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        x = self._dropout_in(x, train, generator)
        mu, _ = self._encode(params, x)
        return mu, state

    def _recon_params(self, params, h):
        """The decoder's output through the reconstruction head: the
        distribution's parameters."""
        expect = self._distribution().num_params(int(self.nIn))
        got = params["rW"].shape[-1]
        if got != expect:
            raise ValueError(
                f"VariationalAutoencoder '{self.name}': reconstruction "
                f"head has {got} params but distribution "
                f"'{self.reconstructionDistribution}' needs {expect} for "
                f"nIn={self.nIn}")
        return h @ params["rW"].to(h.dtype) + params["rb"].to(h.dtype)

    def reconstruct(self, params, x):
        """The mean reconstruction through the latent mean."""
        mu, _ = self._encode(params, x)
        h = self._decode(params, mu)
        return self._distribution().mean(self._recon_params(params, h))

    def generateAtMeanGivenZ(self, params, z):
        h = self._decode(params, torch.as_tensor(z))
        return self._distribution().mean(self._recon_params(params, h))

    def _eps(self, mu, generator, eps, s):
        if eps is not None:
            return torch.as_tensor(eps[s], dtype=mu.dtype, device=mu.device)
        return torch.randn(mu.shape, generator=generator, dtype=mu.dtype,
                           device=mu.device)

    def reconstructionLogProbability(self, params, x, generator=None,
                                     numSamples=None, eps=None):
        """≡ VariationalAutoencoder.reconstructionLogProbability: a Monte
        Carlo estimate of log p(x) by importance sampling from q(z|x),
        log(1/S · Σ p(x|z_s)p(z_s)/q(z_s|x)), per example (B,). `eps`:
        the S standard-normal draws (default: from `generator`)."""
        dist = self._distribution()
        mu, logvar = self._encode(params, x)
        s_count = int(numSamples or self.numSamples)
        log_ws = []
        for s in range(s_count):
            e = self._eps(mu, generator, eps, s)
            z = mu + torch.exp(0.5 * logvar) * e
            h = self._decode(params, z)
            log_px_z = dist.log_prob(x, self._recon_params(params, h))
            log_pz = -0.5 * (z ** 2 + _LOG_2PI).sum(-1)
            log_qz = -0.5 * (logvar + e ** 2 + _LOG_2PI).sum(-1)
            log_ws.append(log_px_z + log_pz - log_qz)
        return (torch.logsumexp(torch.stack(log_ws), dim=0)
                - math.log(float(s_count)))

    def pretrain_loss(self, params, x, generator=None, eps=None):
        """The negative ELBO, the mean over the batch, with numSamples
        samples of z; `eps` gives their standard-normal draws (default:
        from `generator`)."""
        dist = self._distribution()
        mu, logvar = self._encode(params, x)
        total = 0.0
        for s in range(self.numSamples):
            z = mu + torch.exp(0.5 * logvar) * self._eps(mu, generator, eps,
                                                         s)
            h = self._decode(params, z)
            total = total + dist.log_prob(x, self._recon_params(params, h))
        ll = total / self.numSamples
        kl = -0.5 * (1 + logvar - mu ** 2 - torch.exp(logvar)).sum(-1)
        return (kl - ll).mean()


class AutoEncoder(DenseLayer):
    """≡ conf.layers.AutoEncoder — a denoising autoencoder with tied
    weights: encode act(xW + b), decode act(hWᵀ + vb). Mid-network
    `apply` is the encoder; `pretrain_loss` reconstructs from an input
    whose values are dropped with probability `corruptionLevel` (the keep
    mask from the caller, `keep`, or drawn from the generator), plus an
    optional `sparsity` penalty on the mean hidden activation."""

    #: lossFunction aliases -> the two implemented reconstruction losses
    _LOSSES = {"mse": "mse", "l2": "mse", "squared_loss": "mse",
               "xent": "xent", "binaryxent": "xent",
               "reconstruction_crossentropy": "xent"}

    def __init__(self, nIn=None, nOut=None, corruptionLevel=0.3,
                 sparsity=0.0, lossFunction="mse", **kw):
        super().__init__(nIn=nIn, nOut=nOut, **kw)
        self.corruptionLevel = float(corruptionLevel)
        self.sparsity = float(sparsity)
        key = str(lossFunction).lower()
        if key not in self._LOSSES:
            raise ValueError(
                f"AutoEncoder lossFunction {lossFunction!r} not supported; "
                f"use one of {sorted(set(self._LOSSES))}")
        self.lossFunction = self._LOSSES[key]

    def initialize(self, generator, input_type):
        if self.nIn is None:
            self.nIn = input_type.size
        if self.nOut is None:
            raise ValueError(f"AutoEncoder '{self.name}': nOut not set")
        n_in, n_out = int(self.nIn), int(self.nOut)
        params = {"W": init_weight(generator, (n_in, n_out), self.weightInit,
                                   self.dist),
                  "b": torch.zeros((n_out,)), "vb": torch.zeros((n_in,))}
        return params, {}, self.output_type(input_type)

    def _encode(self, params, x):
        act = get_activation(self.activation)
        return act(x @ params["W"].to(x.dtype) + params["b"].to(x.dtype))

    def _decode(self, params, h):
        act = get_activation(self.activation)
        return act(h @ params["W"].to(h.dtype).T + params["vb"].to(h.dtype))

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        x = self._dropout_in(x, train, generator)
        return self._encode(params, x), state

    def pretrain_loss(self, params, x, generator=None, keep=None):
        if self.corruptionLevel > 0.0:
            if keep is None:
                keep = keep_mask(x, 1.0 - self.corruptionLevel,
                                 generator=generator)
            x_in = torch.where(torch.as_tensor(keep, device=x.device), x,
                               torch.zeros_like(x))
        else:
            x_in = x
        h = self._encode(params, x_in)
        recon = self._decode(params, h)
        if self.lossFunction in ("xent", "binaryxent"):
            r = torch.clamp(recon, 1e-7, 1.0 - 1e-7)
            loss = -(x * torch.log(r) + (1.0 - x) * torch.log(1.0 - r)).sum(-1)
        else:
            loss = ((recon - x) ** 2).sum(-1)
        if self.sparsity > 0.0:
            loss = loss + self.sparsity * h.abs().mean(-1)
        return loss.mean()


class CenterLossOutputLayer(BaseOutputLayer, DenseLayer):
    """≡ conf.layers.CenterLossOutputLayer — the softmax loss plus
    0.5·λ·‖f − c_y‖² pulling the features toward a center per class.

    `centers` (nOut, nIn) is a parameter, zero at init, updated by the
    network's own optimizer and left out of l1/l2. The center term splits
    into two halves with one side detached in each, so λ and α act
    independently: λ pulls the FEATURES toward the (fixed) centers, α pulls
    the CENTERS toward the (fixed) features of the batch."""

    needs_features = True

    def __init__(self, alpha=0.05, lambda_=2e-4, **kw):
        kw.setdefault("lossFunction", "mcxent")
        self.alpha = float(alpha)
        self.lambda_ = float(lambda_)
        super().__init__(**kw)

    def initialize(self, generator, input_type):
        params, state, out = super().initialize(generator, input_type)
        params = dict(params)
        params["centers"] = torch.zeros((int(self.nOut), int(self.nIn)))
        return params, state, out

    def compute_loss_with_features(self, params, labels, preact, features,
                                   mask=None):
        """The loss of `preact` plus the two center terms, `features`
        being this layer's input (after its preprocessor)."""
        base = get_loss(self.lossFunction)(labels, preact, self.activation,
                                           mask)
        centers = params["centers"].to(features.dtype)
        cy = labels @ centers                                  # (B, nIn)
        feat_pull = 0.5 * self.lambda_ * ((features - cy.detach()) ** 2
                                          ).sum(-1).mean()
        center_pull = 0.5 * self.alpha * ((features.detach() - cy) ** 2
                                          ).sum(-1).mean()
        return base + feat_pull + center_pull


class PermuteLayer(Layer):
    """≡ Keras' Permute as a layer: reorders the non-batch axes. `dims` is
    1-indexed over them, Keras-style: PermuteLayer(dims=(2, 1)) swaps the
    two non-batch axes of a (B, T, F) sequence. No parameters; a mask is
    not carried through a non-identity permutation."""

    @classmethod
    def _builder_positional(cls, args):
        if len(args) == 1:
            return {"dims": args[0]}
        return {}

    def __init__(self, dims=None, **kw):
        super().__init__(**kw)
        if dims is None:
            raise ValueError("PermuteLayer requires dims, e.g. dims=(2, 1)")
        self.dims = tuple(int(d) for d in dims)
        if sorted(self.dims) != list(range(1, len(self.dims) + 1)):
            raise ValueError(
                f"PermuteLayer dims must be a permutation of "
                f"1..{len(self.dims)} (1-indexed, batch excluded), "
                f"got {self.dims}")

    def output_type(self, input_type):
        shp = input_type.shape()
        if len(self.dims) != len(shp):
            raise ValueError(
                f"PermuteLayer '{self.name}': dims {self.dims} has "
                f"{len(self.dims)} axes but the input has {len(shp)} "
                f"non-batch axes ({input_type})")
        new = tuple(shp[d - 1] for d in self.dims)
        if isinstance(input_type, RecurrentType):
            if new[1] is None:
                raise ValueError(
                    f"PermuteLayer '{self.name}': permuting the time axis "
                    "into the feature position needs a known "
                    "timeSeriesLength — use "
                    "InputType.recurrent(size, timeSeriesLength)")
            return InputType.recurrent(new[1], new[0])
        if isinstance(input_type, Convolutional3DType):
            return InputType.convolutional3D(new[0], new[1], new[2], new[3])
        if isinstance(input_type, ConvolutionalType):
            return InputType.convolutional(new[0], new[1], new[2])
        return input_type   # feedForward: dims == (1,), identity

    def feed_forward_mask(self, mask):
        return None if self.dims != tuple(
            range(1, len(self.dims) + 1)) else mask

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        return x.permute((0,) + self.dims), state
