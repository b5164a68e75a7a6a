"""Recurrent layers: the port of `deeplearning4j_tpu/nn/conf/recurrent.py`
(≡ deeplearning4j-nn :: conf.layers.LSTM / GravesLSTM / SimpleRnn /
recurrent.Bidirectional / RnnOutputLayer / recurrent.LastTimeStep /
GravesBidirectionalLSTM).

Batch-major (B, T, F) sequences, as in the JAX package. The unroll
mirrors its `lax.scan`: the input projection x·W + b for ALL steps is one
hoisted (B·T, nIn) × (nIn, 4H) product, and only h·U and the gates run in
a loop over T. That loop is plain PyTorch: a step is a handful of small
launches, which a CUDA graph of the training step or of the decode block
replays as one (the JAX package has no Pallas kernel here either).
`torch.nn.LSTM` and cuDNN's RNN are not used: their gate order, peepholes
and masked hold differ from the reference.

Masks follow the reference: a masked step emits zeros and holds the
carry, by an exact select (`torch.where`), never a blend, so a valid step
is bit-identical to the unmasked one and a padded input can never reach a
held carry as 0·nan. `scanUnroll` is accepted and has no numerical effect.

Bidirectional keeps its two directions' parameters in one flat dict as
"fwd_<name>" / "bwd_<name>" (the JAX package nests them as {"fwd": {...},
"bwd": {...}}; `nn/convert.py` maps one onto the other, and the sorted
leaf order is the same).
"""
from __future__ import annotations

import copy

import torch

from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (BaseOutputLayer,
                                                     DenseLayer, Layer)
from deeplearning4j_tpu_torch.nn.weights_init import init_weight

__all__ = ["BaseRecurrentLayer", "LSTM", "GravesLSTM", "SimpleRnn",
           "Bidirectional", "RnnOutputLayer", "LastTimeStep",
           "GravesBidirectionalLSTM", "last_valid_step"]


def last_valid_step(y, mask):
    """(B, F): each example's last valid step of y (B, T, F) under the
    (B, T) mask (its step 0 when none is valid), or the last step."""
    if mask is None:
        return y[:, -1, :]
    idx = ((mask > 0).sum(dim=1) - 1).clamp_min(0)
    return y.gather(1, idx[:, None, None].expand(-1, 1, y.shape[-1]))[:, 0]


class BaseRecurrentLayer(Layer):
    is_recurrent = True

    def __init__(self, nIn=None, nOut=None, forgetGateBiasInit=1.0,
                 gateActivationFn="sigmoid", scanUnroll=1, **kw):
        super().__init__(**kw)
        self.nIn, self.nOut = nIn, nOut
        self.forgetGateBiasInit = float(forgetGateBiasInit)
        self.gateActivationFn = gateActivationFn
        self.scanUnroll = int(scanUnroll or 1)

    def apply_defaults(self, defaults):
        super().apply_defaults(defaults)
        if self.activation == "identity":
            self.activation = "tanh"  # reference default for LSTMs
        return self

    def output_type(self, input_type):
        t = getattr(input_type, "timeSeriesLength", None)
        return InputType.recurrent(self.nOut, t)

    def zero_carry(self, batch, dtype=torch.float32, device=None):
        n = int(self.nOut)
        return tuple(torch.zeros((batch, n), dtype=dtype, device=device)
                     for _ in range(2))

    def _carry0(self, x, carry0):
        if carry0 is None:
            return self.zero_carry(x.shape[0], x.dtype, x.device)
        return tuple(c.to(x.dtype) for c in carry0)

    @staticmethod
    def _projection(x, params):
        """x·W + b for every step at once: (B, T, G)."""
        b, t, _ = x.shape
        dt = x.dtype
        return (x.reshape(b * t, -1) @ params["W"].to(dt)
                + params["b"].to(dt)).reshape(b, t, -1)

    def _cell(self, z, carry, params):
        """One step from the pre-activation z = x·W + b + h·U: the new
        carry; its first entry is the step's output."""
        raise NotImplementedError

    def scan_apply(self, params, x, carry0=None, mask=None):
        """(outputs (B, T, nOut), the final carry) from `carry0` (zeros by
        default) under the (B, T) mask."""
        carry = self._carry0(x, carry0)
        xw = self._projection(x, params)
        u = params["U"].to(x.dtype)
        valid = None if mask is None else mask > 0
        ys = []
        for s in range(x.shape[1]):
            new = self._cell(xw[:, s] + carry[0] @ u, carry, params)
            if valid is None:
                ys.append(new[0])
            else:
                m = valid[:, s, None]
                new = tuple(torch.where(m, n, c) for n, c in zip(new, carry))
                ys.append(torch.where(m, new[0], 0))
            carry = new
        return torch.stack(ys, dim=1), carry

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        x = self._dropout_in(x, train, generator)
        y, _ = self.scan_apply(params, x, None, mask)
        return y, state


class LSTM(BaseRecurrentLayer):
    """≡ conf.layers.LSTM (no peepholes). Gate order [i, f, o, g]."""

    def initialize(self, generator, input_type):
        if self.nIn is None:
            self.nIn = input_type.size
        if self.nOut is None:
            raise ValueError(f"LSTM '{self.name}': nOut not set")
        n_in, n_out = int(self.nIn), int(self.nOut)
        w = init_weight(generator, (n_in, 4 * n_out), self.weightInit,
                        self.dist)
        u = init_weight(generator, (n_out, 4 * n_out), self.weightInit,
                        self.dist)
        b = torch.zeros((4, n_out))
        b[1] = self.forgetGateBiasInit   # the forget gate's bias
        return ({"W": w, "U": u, "b": b.reshape(4 * n_out)}, {},
                self.output_type(input_type))

    def _gates(self, z, c_prev, params):
        n = int(self.nOut)
        gate = get_activation(self.gateActivationFn)
        act = get_activation(self.activation)
        i = gate(z[:, 0 * n:1 * n])
        f = gate(z[:, 1 * n:2 * n])
        o = gate(z[:, 2 * n:3 * n])
        g = act(z[:, 3 * n:4 * n])
        c = f * c_prev + i * g
        return o * act(c), c

    def _cell(self, z, carry, params):
        return self._gates(z, carry[1], params)


class GravesLSTM(LSTM):
    """≡ conf.layers.GravesLSTM — LSTM with peephole connections (Graves
    2013): i and f peek at c_{t-1}, o at c_t."""

    def initialize(self, generator, input_type):
        params, state, out = super().initialize(generator, input_type)
        n = int(self.nOut)
        for name in ("pI", "pF", "pO"):
            params[name] = torch.zeros(n)
        return params, state, out

    def _gates(self, z, c_prev, params):
        n = int(self.nOut)
        dt = z.dtype
        gate = get_activation(self.gateActivationFn)
        act = get_activation(self.activation)
        i = gate(z[:, 0 * n:1 * n] + params["pI"].to(dt) * c_prev)
        f = gate(z[:, 1 * n:2 * n] + params["pF"].to(dt) * c_prev)
        g = act(z[:, 3 * n:4 * n])
        c = f * c_prev + i * g
        o = gate(z[:, 2 * n:3 * n] + params["pO"].to(dt) * c)
        return o * act(c), c


class SimpleRnn(BaseRecurrentLayer):
    """≡ conf.layers.recurrent.SimpleRnn — h_t = act(x·W + h·U + b)."""

    def initialize(self, generator, input_type):
        if self.nIn is None:
            self.nIn = input_type.size
        n_in, n_out = int(self.nIn), int(self.nOut)
        return ({"W": init_weight(generator, (n_in, n_out), self.weightInit,
                                  self.dist),
                 "U": init_weight(generator, (n_out, n_out), self.weightInit,
                                  self.dist),
                 "b": torch.zeros(n_out)},
                {}, self.output_type(input_type))

    def zero_carry(self, batch, dtype=torch.float32, device=None):
        return (torch.zeros((batch, int(self.nOut)), dtype=dtype,
                            device=device),)

    def _cell(self, z, carry, params):
        return (get_activation(self.activation)(z),)


def _prefixed(params, prefix):
    n = len(prefix)
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix)}


class Bidirectional(Layer):
    """≡ recurrent.Bidirectional(mode, layer) — wraps any recurrent layer;
    merge modes CONCAT / ADD / MUL / AVERAGE."""

    CONCAT, ADD, MUL, AVERAGE = "concat", "add", "mul", "average"
    is_recurrent = True
    #: the prefixes of the flat parameter names ("fwd_W") that the JAX
    #: package nests ({"fwd": {"W": ...}}; nn/convert.py maps the two)
    param_groups = ("fwd", "bwd")

    @classmethod
    def _builder_positional(cls, args):
        if len(args) == 1:
            return {"layer": args[0]}
        if len(args) == 2:
            return {"mode": args[0], "layer": args[1]}
        return {}

    def __init__(self, layer=None, mode="concat", **kw):
        super().__init__(**kw)
        if layer is None:
            raise ValueError("Bidirectional requires a wrapped recurrent "
                             "layer")
        self.mode = str(mode).lower()
        self.fwd = layer
        self.bwd = copy.deepcopy(layer)

    def apply_defaults(self, defaults):
        super().apply_defaults(defaults)
        self.fwd.apply_defaults(defaults)
        self.bwd.apply_defaults(defaults)
        return self

    @property
    def nOut(self):
        n = int(self.fwd.nOut)
        return 2 * n if self.mode == "concat" else n

    def output_type(self, input_type):
        t = getattr(input_type, "timeSeriesLength", None)
        return InputType.recurrent(self.nOut, t)

    def initialize(self, generator, input_type):
        pf, _, _ = self.fwd.initialize(generator, input_type)
        pb, _, _ = self.bwd.initialize(generator, input_type)
        params = {f"fwd_{k}": v for k, v in pf.items()}
        params.update({f"bwd_{k}": v for k, v in pb.items()})
        return params, {}, self.output_type(input_type)

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        x = self._dropout_in(x, train, generator)
        yf, _ = self.fwd.scan_apply(_prefixed(params, "fwd_"), x, None, mask)
        mr = None if mask is None else torch.flip(mask, dims=(1,))
        yb, _ = self.bwd.scan_apply(_prefixed(params, "bwd_"),
                                    torch.flip(x, dims=(1,)), None, mr)
        yb = torch.flip(yb, dims=(1,))
        if self.mode == "concat":
            y = torch.cat([yf, yb], dim=-1)
        elif self.mode == "add":
            y = yf + yb
        elif self.mode == "mul":
            y = yf * yb
        elif self.mode == "average":
            y = 0.5 * (yf + yb)
        else:
            raise ValueError(f"Unknown Bidirectional mode {self.mode}")
        return y, state


class RnnOutputLayer(BaseOutputLayer, DenseLayer):
    """≡ conf.layers.RnnOutputLayer — a per-step dense layer and loss over
    (B, T, C) with label masks."""

    def __init__(self, lossFunction="mcxent", **kw):
        DenseLayer.__init__(self, **kw)
        self.lossFunction = lossFunction
        if kw.get("activation") is None:
            self.activation = None

    def apply_defaults(self, defaults):
        Layer.apply_defaults(self, defaults)
        if self.activation == "identity":
            self.activation = "softmax"
        return self

    def output_type(self, input_type):
        t = getattr(input_type, "timeSeriesLength", None)
        return InputType.recurrent(self.nOut, t)


class LastTimeStep(Layer):
    """≡ recurrent.LastTimeStep(layer) — wraps a recurrent layer and emits
    its last valid step (by the mask) as a feed-forward activation."""

    @classmethod
    def _builder_positional(cls, args):
        return {"layer": args[0]} if args else {}

    def __init__(self, layer=None, **kw):
        super().__init__(**kw)
        if layer is None:
            raise ValueError("LastTimeStep requires a wrapped layer")
        self.inner = layer

    def apply_defaults(self, defaults):
        super().apply_defaults(defaults)
        self.inner.apply_defaults(defaults)
        return self

    def feed_forward_mask(self, mask):
        return None  # one (feed-forward) step

    def output_type(self, input_type):
        return InputType.feedForward(self.inner.output_type(input_type).size)

    def initialize(self, generator, input_type):
        p, s, _ = self.inner.initialize(generator, input_type)
        return p, s, self.output_type(input_type)

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        y, new_state = self.inner.apply(params, state, x, train=train,
                                        generator=generator, mask=mask)
        return last_valid_step(y, mask), new_state


class GravesBidirectionalLSTM(Bidirectional):
    """≡ conf.layers.GravesBidirectionalLSTM — one bidirectional peephole
    LSTM layer whose directions are summed (width nOut); mode='concat'
    gives the 2·nOut concatenation instead."""

    def __init__(self, nIn=None, nOut=None, mode="add", **kw):
        inner = GravesLSTM(nIn=nIn, nOut=nOut,
                           **{k: v for k, v in kw.items()
                              if k in ("forgetGateBiasInit",
                                       "gateActivationFn", "activation",
                                       "weightInit", "scanUnroll")})
        outer_kw = {k: v for k, v in kw.items()
                    if k not in ("forgetGateBiasInit", "gateActivationFn",
                                 "scanUnroll")}
        super().__init__(layer=inner, mode=mode, **outer_kw)

    @property
    def nIn(self):
        return self.fwd.nIn

    @nIn.setter
    def nIn(self, v):
        self.fwd.nIn = v
        self.bwd.nIn = v
