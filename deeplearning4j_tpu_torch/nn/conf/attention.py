"""Attention layers: the port of `deeplearning4j_tpu/nn/conf/attention.py`
(≡ deeplearning4j-nn :: conf.layers.SelfAttentionLayer /
LearnedSelfAttentionLayer / RecurrentAttentionLayer and
conf.graph.AttentionVertex).

The scaled dot-product core of SelfAttentionLayer, LearnedSelfAttentionLayer
and AttentionVertex is `_attend`, which runs the port's flash attention
(`kernels.flash_attention`): `flash_fwd` forward and `flash_bwd_dq` /
`flash_bwd_dkv` backward on the card, where the JAX package runs its Pallas
kernel on the TPU; their plain versions on the CPU, as every kernel of the
port does. Head dims the kernels are not built for are zero-padded by the
kernel wrappers. Self-attention passes the (B, T) feature mask as `mask`
(padded positions are neither keys nor queries, their rows come back as
zeros); cross-length attention (learned queries, AttentionVertex with its
own key input) passes it as `kv_mask`. RecurrentAttentionLayer attends one
query per step, an einsum in the JAX package too.

Layout: batch-major (B, T, F) sequences; heads are split and merged
around the core as (B, H, T, Dh).
"""
from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.kernels.flash_attention import flash_attention
from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf.graph_vertices import GraphVertex
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType, RecurrentType
from deeplearning4j_tpu_torch.nn.conf.layers import Layer
from deeplearning4j_tpu_torch.nn.weights_init import init_weight

__all__ = ["SelfAttentionLayer", "LearnedSelfAttentionLayer",
           "RecurrentAttentionLayer", "AttentionVertex"]


def _attend(q, k, v, mask=None, kv_mask=None):
    """The attention core over (B, H, Tq/Tk, Dh). Self-attention: `mask`
    (B, T) gates keys and queries. Cross-attention: `kv_mask` (B, Tk) gates
    the keys, and `mask` (B, Tq), if given, the query rows."""
    if kv_mask is None and mask is not None and q.shape[2] != k.shape[2]:
        raise ValueError(
            "a single (B, T) mask implies self-attention (Tq == Tk); "
            f"got Tq={q.shape[2]}, Tk={k.shape[2]} — pass kv_mask for "
            "cross-attention")
    return flash_attention(q, k, v, mask=mask, kv_mask=kv_mask)


def _split_heads(x, n_heads):
    b, t, f = x.shape
    return x.reshape(b, t, n_heads, f // n_heads).transpose(1, 2)


def _merge_heads(x):
    y = x.transpose(1, 2)                          # (B, T, H, Dh)
    return y.reshape(y.shape[0], y.shape[1], -1)


def _needs_recurrent(layer, input_type):
    if not isinstance(input_type, RecurrentType):
        raise ValueError(
            f"{type(layer).__name__} '{layer.name}' needs recurrent "
            f"(B, T, F) input, got {input_type}")


class SelfAttentionLayer(Layer):
    """≡ conf.layers.SelfAttentionLayer — multi-head dot-product
    self-attention: (B, T, nIn) → (B, T, nOut). projectInput=True (needed
    when nHeads > 1 or nIn != nOut) learns Q/K/V projections and the output
    projection Wo; projectInput=False attends the raw input (nHeads 1,
    nOut == nIn)."""

    is_recurrent_compatible = True

    def __init__(self, nIn=None, nOut=None, nHeads=1, projectInput=True,
                 **kw):
        super().__init__(**kw)
        self.nIn, self.nOut = nIn, nOut
        self.nHeads = int(nHeads)
        self.projectInput = bool(projectInput)

    def validate(self):
        super().validate()
        if not self.projectInput and self.nHeads != 1:
            raise ValueError(
                f"{type(self).__name__} '{self.name}': projectInput=False "
                "requires nHeads == 1")

    def output_type(self, input_type):
        _needs_recurrent(self, input_type)
        n_out = self.nOut if self.projectInput else input_type.size
        return InputType.recurrent(n_out, input_type.timeSeriesLength)

    def initialize(self, generator, input_type):
        if self.nIn is None:
            self.nIn = input_type.size
        if not self.projectInput:
            if self.nOut is not None and int(self.nOut) != int(self.nIn):
                raise ValueError(
                    f"{type(self).__name__} '{self.name}': "
                    "projectInput=False requires nOut == nIn")
            self.nOut = self.nIn
            return {}, {}, self.output_type(input_type)
        n_in, n_out = int(self.nIn), int(self.nOut)
        if n_out % self.nHeads:
            raise ValueError(
                f"{type(self).__name__} '{self.name}': nOut={n_out} not "
                f"divisible by nHeads={self.nHeads}")
        shapes = {"Wq": (n_in, n_out), "Wk": (n_in, n_out),
                  "Wv": (n_in, n_out), "Wo": (n_out, n_out)}
        params = {name: init_weight(generator, shape, self.weightInit,
                                    self.dist)
                  for name, shape in shapes.items()}
        return params, {}, self.output_type(input_type)

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        x = self._dropout_in(x, train, generator)
        dt = x.dtype
        if self.projectInput:
            q = x @ params["Wq"].to(dt)
            k = x @ params["Wk"].to(dt)
            v = x @ params["Wv"].to(dt)
        else:
            q = k = v = x
        o = _attend(_split_heads(q, self.nHeads),
                    _split_heads(k, self.nHeads),
                    _split_heads(v, self.nHeads), mask)
        y = _merge_heads(o)
        if self.projectInput:
            y = y @ params["Wo"].to(dt)
        y = get_activation(self.activation)(y)
        if mask is not None:
            # after the activation, so padded rows stay exactly zero for an
            # activation that moves 0 (sigmoid(0) = 0.5)
            y = torch.where(mask[:, :, None] > 0, y, 0).to(dt)
        return y, state


class LearnedSelfAttentionLayer(SelfAttentionLayer):
    """≡ conf.layers.LearnedSelfAttentionLayer — nQueries learned query
    vectors attend the sequence: a fixed-length (B, nQueries, nOut) summary
    of any input length."""

    def __init__(self, nQueries=None, **kw):
        super().__init__(**kw)
        self.nQueries = None if nQueries is None else int(nQueries)

    def validate(self):
        super().validate()
        if not self.nQueries:
            raise ValueError(
                f"{type(self).__name__} '{self.name}': nQueries is required")

    def output_type(self, input_type):
        _needs_recurrent(self, input_type)
        n_out = self.nOut if self.projectInput else input_type.size
        return InputType.recurrent(n_out, self.nQueries)

    def initialize(self, generator, input_type):
        params, state, out = super().initialize(generator, input_type)
        q_dim = int(self.nOut) if self.projectInput else int(self.nIn)
        # the learned queries live in the attention space (post-Wq)
        params = dict(params)
        params.pop("Wq", None)
        params["Q"] = init_weight(generator, (int(self.nQueries), q_dim),
                                  self.weightInit, self.dist)
        return params, state, out

    def feed_forward_mask(self, mask):
        return None  # nQueries outputs, every one valid

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        x = self._dropout_in(x, train, generator)
        dt = x.dtype
        if self.projectInput:
            k = x @ params["Wk"].to(dt)
            v = x @ params["Wv"].to(dt)
        else:
            k = v = x
        qp = params["Q"].to(dt)
        q = qp[None].expand((x.shape[0],) + tuple(qp.shape))
        # the learned queries are always valid; the mask gates the keys
        o = _attend(_split_heads(q, self.nHeads),
                    _split_heads(k, self.nHeads),
                    _split_heads(v, self.nHeads), kv_mask=mask)
        y = _merge_heads(o)
        if self.projectInput:
            y = y @ params["Wo"].to(dt)
        return get_activation(self.activation)(y), state


class RecurrentAttentionLayer(Layer):
    """≡ conf.layers.RecurrentAttentionLayer — a recurrent cell whose step
    input is augmented with attention over the whole input sequence, the
    query being the previous hidden state:

        a_t = MHA(q = h_{t-1}·Wq, K = x·Wk, V = x·Wv)
        h_t = act(x_t·W + h_{t-1}·R + a_t·Wo + b)

    x·W, x·Wk and x·Wv are hoisted out of the loop over T. Masked steps
    hold the carry and emit zeros."""

    is_recurrent = True

    def __init__(self, nIn=None, nOut=None, nHeads=1, **kw):
        super().__init__(**kw)
        self.nIn, self.nOut = nIn, nOut
        self.nHeads = int(nHeads)

    def apply_defaults(self, defaults):
        super().apply_defaults(defaults)
        if self.activation == "identity":
            self.activation = "tanh"
        return self

    def output_type(self, input_type):
        _needs_recurrent(self, input_type)
        return InputType.recurrent(self.nOut, input_type.timeSeriesLength)

    def initialize(self, generator, input_type):
        if self.nIn is None:
            self.nIn = input_type.size
        n_in, n_out = int(self.nIn), int(self.nOut)
        if n_out % self.nHeads:
            raise ValueError(
                f"{type(self).__name__} '{self.name}': nOut={n_out} not "
                f"divisible by nHeads={self.nHeads}")
        shapes = {"W": (n_in, n_out), "R": (n_out, n_out),
                  "Wq": (n_out, n_out), "Wk": (n_in, n_out),
                  "Wv": (n_in, n_out), "Wo": (n_out, n_out)}
        params = {name: init_weight(generator, shape, self.weightInit,
                                    self.dist)
                  for name, shape in shapes.items()}
        params["b"] = torch.zeros(n_out)
        return params, {}, self.output_type(input_type)

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        x = self._dropout_in(x, train, generator)
        dt = x.dtype
        b, t, _ = x.shape
        n_out, nh = int(self.nOut), self.nHeads
        h_dim = n_out // nh
        scale = 1.0 / (h_dim ** 0.5)
        act = get_activation(self.activation)
        xw = x @ params["W"].to(dt)                              # (B,T,nOut)
        keys = _split_heads(x @ params["Wk"].to(dt), nh)
        vals = _split_heads(x @ params["Wv"].to(dt), nh).float()
        kmask = None if mask is None else (mask > 0)             # (B,T)
        R, Wq = params["R"].to(dt), params["Wq"].to(dt)
        Wo, bias = params["Wo"].to(dt), params["b"].to(dt)
        h = torch.zeros((b, n_out), dtype=dt, device=x.device)
        ys = []
        for s in range(t):
            q = (h @ Wq).reshape(b, nh, h_dim)
            sc = torch.einsum("bhd,bhkd->bhk", q, keys).float() * scale
            if kmask is not None:
                sc = torch.where(kmask[:, None, :], sc, -1e30)
            p = torch.softmax(sc, dim=-1)
            a = torch.einsum("bhk,bhkd->bhd", p, vals).to(dt)
            a = a.reshape(b, n_out) @ Wo
            h_new = act(xw[:, s] + h @ R + a + bias)
            if kmask is not None:
                keep = kmask[:, s, None]
                h_new = torch.where(keep, h_new, h)
                ys.append(torch.where(keep, h_new, 0))
            else:
                ys.append(h_new)
            h = h_new
        return torch.stack(ys, dim=1), state


class AttentionVertex(GraphVertex):
    """≡ conf.graph.AttentionVertex — multi-head dot-product attention as a
    ComputationGraph vertex with parameters. Inputs (queries, keys,
    values), (queries, keysAndValues) or one (self-attention), each
    (B, T, F); output (B, Tq, nOut). The graph draws, stores and trains its
    parameters like a layer's."""

    def __init__(self, nInQueries=None, nInKeys=None, nInValues=None,
                 nOut=None, nHeads=1, projectInput=True, weightInit="xavier",
                 name=None):
        self.nInQueries, self.nInKeys, self.nInValues = (nInQueries, nInKeys,
                                                         nInValues)
        self.nOut, self.nHeads = nOut, int(nHeads)
        self.projectInput = bool(projectInput)
        self.weightInit = weightInit
        self.name = name
        self.updater = None

    def output_type(self, *ts):
        tq = ts[0]
        if not isinstance(tq, RecurrentType):
            raise ValueError(
                f"AttentionVertex '{self.name}' needs recurrent inputs, "
                f"got {tq}")
        n_out = self.nOut if self.projectInput else tq.size
        return InputType.recurrent(n_out, tq.timeSeriesLength)

    def _resolve_nins(self, ts):
        tq = ts[0]
        tk = ts[1] if len(ts) > 1 else tq
        tv = ts[2] if len(ts) > 2 else tk
        if self.nInQueries is None:
            self.nInQueries = tq.size
        if self.nInKeys is None:
            self.nInKeys = tk.size
        if self.nInValues is None:
            self.nInValues = tv.size

    def initialize(self, generator, *ts):
        """-> (params, state) for the input types inferred at build time."""
        self._resolve_nins(ts)
        if not self.projectInput:
            if self.nHeads != 1:
                raise ValueError(
                    f"AttentionVertex '{self.name}': projectInput=False "
                    "requires nHeads == 1")
            return {}, {}
        n_out = int(self.nOut)
        if n_out % self.nHeads:
            raise ValueError(
                f"AttentionVertex '{self.name}': nOut={n_out} not divisible "
                f"by nHeads={self.nHeads}")
        shapes = {"Wq": (int(self.nInQueries), n_out),
                  "Wk": (int(self.nInKeys), n_out),
                  "Wv": (int(self.nInValues), n_out),
                  "Wo": (n_out, n_out)}
        return {name: init_weight(generator, shape, self.weightInit, None)
                for name, shape in shapes.items()}, {}

    def regularization_terms(self):
        return 0.0, 0.0

    def apply(self, *xs, params=None, mask=None):
        q_in = xs[0]
        k_in = xs[1] if len(xs) > 1 else q_in
        v_in = xs[2] if len(xs) > 2 else k_in
        dt = q_in.dtype
        params = params or {}
        if self.projectInput:
            q = q_in @ params["Wq"].to(dt)
            k = k_in @ params["Wk"].to(dt)
            v = v_in @ params["Wv"].to(dt)
        else:
            q, k, v = q_in, k_in, v_in
        qh = _split_heads(q, self.nHeads)
        kh = _split_heads(k, self.nHeads)
        vh = _split_heads(v, self.nHeads)
        if len(xs) == 1 and q.shape == k.shape:
            o = _attend(qh, kh, vh, mask)
        else:
            # cross-attention: the feature mask gates the key sequence
            kmask = None
            if mask is not None and mask.shape[1] == k.shape[1]:
                kmask = mask
            o = _attend(qh, kh, vh, kv_mask=kmask)
        y = _merge_heads(o)
        if self.projectInput:
            y = y @ params["Wo"].to(dt)
        return y
