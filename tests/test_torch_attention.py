"""The port's attention layers (nn/conf/attention.py) against the JAX
package on the CPU: SelfAttentionLayer, LearnedSelfAttentionLayer,
RecurrentAttentionLayer and AttentionVertex, forward and every parameter's
gradient under ragged feature masks, on parameters carried across by
`multilayer_params_from_numpy` / `graph_params_from_numpy`. The JAX side
runs as on its CPU (its dense attention core); where an example has no
valid key at all, the port's core (the flash kernels' plain versions, as
on the card) zeroes its rows, and that case is held against the JAX
package's Pallas kernel in interpret mode. Then the head-dim padding of
the kernel wrappers, against the unpadded plain versions, and the
example's attention stack trained to its own accuracy gate.

Tolerance: 1e-5 relative to max(1, max |JAX|) in f32."""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu.nn.conf.attention as jatt
import deeplearning4j_tpu.nn.conf.layers as jlayers
import deeplearning4j_tpu.nn.conf.recurrent as jrec
import deeplearning4j_tpu_torch.nn as tnn
from deeplearning4j_tpu.kernels.flash_attention import \
    flash_attention as jax_flash
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf import attention as tatt

tfa = importlib.import_module(
    "deeplearning4j_tpu_torch.kernels.flash_attention")

B, T, F, C = 4, 12, 8, 3
TOL = 1e-5
LENGTHS = [12, 9, 5, 2]


class _NS:
    def __init__(self, nn, att, layers, rec):
        self.nn, self.att, self.layers, self.rec = nn, att, layers, rec


J = _NS(jnn, jatt, jlayers, jrec)
P = _NS(tnn, tatt, tnn.layers, tnn)


def _close(got, want, what="", tol=TOL):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = tol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bound, (what, err, bound)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _seq(seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, T, F)).astype(np.float32)


def _mask(lengths):
    return (np.arange(T)[None, :] < np.asarray(lengths)[:, None]).astype(
        np.float32)


def _ff_head(ns):
    return ns.layers.OutputLayer(lossFunction="mcxent", nOut=C,
                                 activation="softmax")


def _rnn_head(ns):
    return ns.rec.RnnOutputLayer(lossFunction="mcxent", nOut=C,
                                 activation="softmax")


STACKS = {
    # the stack of examples/attention_sequence_classifier.py (D = 8)
    "example stack": (lambda ns: [
        ns.att.SelfAttentionLayer(nOut=32, nHeads=4),
        ns.att.LearnedSelfAttentionLayer(nOut=32, nHeads=4, nQueries=4),
        ns.rec.LastTimeStep(ns.rec.LSTM(nOut=16)), _ff_head(ns)], "ff"),
    "self-attention, one head, sigmoid": (lambda ns: [
        ns.att.SelfAttentionLayer(nOut=16, nHeads=1, activation="sigmoid"),
        _rnn_head(ns)], "seq"),
    "self-attention, raw input": (lambda ns: [
        ns.att.SelfAttentionLayer(projectInput=False), _rnn_head(ns)],
        "seq"),
    "learned queries, 2 heads of 12": (lambda ns: [
        ns.att.LearnedSelfAttentionLayer(nOut=24, nHeads=2, nQueries=3),
        ns.layers.GlobalPoolingLayer("avg"), _ff_head(ns)], "ff"),
    "recurrent attention": (lambda ns: [
        ns.att.RecurrentAttentionLayer(nOut=8, nHeads=2), _rnn_head(ns)],
        "seq"),
}


def _stack_pair(name):
    layers, _ = STACKS[name]

    def conf(ns):
        b = (ns.nn.NeuralNetConfiguration.Builder().seed(7)
             .updater(ns.nn.Sgd(0.1)).weightInit("xavier").list())
        for layer in layers(ns):
            b.layer(layer)
        return b.setInputType(ns.nn.InputType.recurrent(F, T)).build()

    jnet = jnn.MultiLayerNetwork(conf(J)).init()
    tnet = tnn.multilayer_params_from_numpy(
        tnn.MultiLayerNetwork(conf(P)), _np_tree(jnet._params),
        _np_tree(jnet._state), device="cpu")
    return jnet, tnet


def _labels(kind, seed=1):
    rng = np.random.default_rng(seed)
    shape = (B,) if kind == "ff" else (B, T)
    return np.eye(C, dtype=np.float32)[rng.integers(0, C, shape)]


def _grads_close(tgrads, jgrads, what):
    jg = _np_tree(jgrads)
    assert set(tgrads) == set(jg), what
    for key, d in jg.items():
        assert set(tgrads[key]) == set(d), (what, key)
        for name, g in d.items():
            _close(tgrads[key][name], g, f"{what} grad {key}.{name}")


@pytest.mark.parametrize("name", sorted(STACKS))
def test_attention_layers_match_the_jax_package(name):
    """Forward unmasked and under ragged masks, and the gradients of the
    masked loss."""
    jnet, tnet = _stack_pair(name)
    kind = STACKS[name][1]
    x, m, y = _seq(), _mask(LENGTHS), _labels(kind)
    _close(tnet.output(x), np.asarray(jnet.output(x).numpy()), name)
    _close(tnet.output(x, fmask=m),
           np.asarray(jnet.output(x, fmask=m).numpy()), f"{name} masked")
    lm = m if kind == "seq" else None
    _grads_close(tnet.computeGradients(x, y, m, lm),
                 jnet.computeGradients(x, y, m, lm), name)


def _vertex_graph(ns, cross):
    g = (ns.nn.NeuralNetConfiguration.Builder().seed(5)
         .updater(ns.nn.Sgd(0.1)).graphBuilder().addInputs("in")
         .setInputTypes(ns.nn.InputType.recurrent(F, T)))
    if cross:
        # queries from a recurrent summary, keys and values from the input
        g.addLayer("q", ns.rec.LSTM(nOut=6), "in")
        g.addVertex("att", ns.att.AttentionVertex(nOut=16, nHeads=2),
                    "q", "in")
    else:
        g.addVertex("att", ns.att.AttentionVertex(nOut=16, nHeads=4), "in")
    g.addLayer("out", _rnn_head(ns), "att")
    return g.setOutputs("out").build()


@pytest.mark.parametrize("cross", [False, True])
def test_attention_vertex_matches_the_jax_package(cross):
    """AttentionVertex (a vertex with parameters) self-attending and
    cross-attending: forward under the mask, gradients, and one Sgd step."""
    jnet = JGraph(_vertex_graph(J, cross)).init()
    tnet = tnn.graph_params_from_numpy(
        tnn.ComputationGraph(_vertex_graph(P, cross)),
        _np_tree(jnet._params), _np_tree(jnet._state), device="cpu")
    assert set(tnet._params["att"]) == {"Wq", "Wk", "Wv", "Wo"}
    x, m, y = _seq(3), _mask(LENGTHS), _labels("seq", 4)
    _close(tnet.output(x, fmasks={"in": m}),
           np.asarray(jnet.output(x, fmasks={"in": m}).numpy()), "vertex")
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    jds, tds = JDataSet(x, y), DataSet(x, y)
    jds.featuresMask = tds.featuresMask = m
    jds.labelsMask = tds.labelsMask = m
    _close(tnet.score(tds), jnet.score(jds), "vertex score")
    jnet.fit(jds)
    tnet.fit(tds)
    for key, d in _np_tree(jnet._params).items():
        for k, v in d.items():
            _close(tnet._params[key][k], v, f"vertex step {key}.{k}")


def test_rows_without_a_valid_key_come_back_as_zeros():
    """LearnedSelfAttentionLayer's cross path (Tq = nQueries, kv_mask, no
    query mask) with an example whose keys are all masked: the port's core
    gives zero rows there, as the JAX package's Pallas kernel (interpret
    mode) does, and matches it on the other examples; the gradients
    reaching the fully masked example's keys are zeros."""
    rng = np.random.default_rng(9)
    q = rng.standard_normal((3, 2, 4, 8)).astype(np.float32)
    k = rng.standard_normal((3, 2, 10, 8)).astype(np.float32)
    v = rng.standard_normal((3, 2, 10, 8)).astype(np.float32)
    km = (np.arange(10)[None] < np.array([10, 0, 3])[:, None])
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     kv_mask=jnp.asarray(km), block_q=8, block_k=8,
                     interpret=True)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = tatt._attend(tq, tk, tv, kv_mask=torch.from_numpy(km))
    _close(got, np.asarray(want), "cross with an empty example")
    assert (got[1] == 0).all()
    got.sum().backward()
    assert (tk.grad[1] == 0).all() and (tv.grad[1] == 0).all()
    with pytest.raises(ValueError, match="kv_mask for cross-attention"):
        tatt._attend(tq, tk, tv, mask=torch.from_numpy(km))


@pytest.mark.parametrize("d", [8, 24, 48])
def test_head_dim_padding_matches_the_unpadded_plain_versions(d):
    """What the kernel wrappers do on the card for a head dim the kernels
    are not built for: q, k, v (and dO) zero-padded to
    `head_dim_plan(d)`, the scale 1/√d of the true head dim, the results
    sliced back. Forward, lse, dQ, dK and dV equal the unpadded plain
    versions (causal and with a ragged key mask)."""
    dp = tfa.head_dim_plan(d)
    assert dp in (16, 32, 64) and dp >= d
    gen = torch.Generator().manual_seed(d)
    q, k, v, g = (torch.randn((2, 3, 20, d), generator=gen)
                  for _ in range(4))
    km = torch.arange(20)[None] < torch.tensor([20, 7])[:, None]
    scale = 1.0 / d ** 0.5
    for mask, causal in ((km, False), (None, True)):
        out, lse = tfa._flash_forward_reference(q, k, v, mask, causal)
        pq, pk, pv, pg = tfa.pad_heads(dp, q, k, v, g)
        pout, plse = tfa._flash_forward_reference(pq, pk, pv, mask, causal,
                                                  scale)
        _close(pout[..., :d], out.numpy(), "padded forward")
        assert (pout[..., d:] == 0).all()
        _close(plse, lse.numpy(), "padded lse")
        delta = tfa._delta(g, out)
        want = (tfa._dq_reference(q, k, v, g, lse, delta, mask, causal),
                *tfa._dkv_reference(q, k, v, g, lse, delta, mask, causal))
        pargs = (pq, pk, pv, pg, plse, tfa._delta(pg, pout), mask, causal,
                 scale)
        got = (tfa._dq_reference(*pargs), *tfa._dkv_reference(*pargs))
        for a, w in zip(got, want):
            _close(a[..., :d], w.numpy(), "padded backward")
            assert (a[..., d:] == 0).all()


def test_head_dims_past_the_widest_tile_run_in_128_column_chunks():
    """The attention layers' head dims on the card: up to 128 the smallest
    tile that holds them, past it the next multiple of 128 (the wide
    kernels' chunk), so no head dim is refused."""
    assert [tfa.head_dim_plan(d) for d in (1, 16, 17, 64, 65, 128)] == [
        16, 16, 32, 64, 128, 128]
    assert [tfa.head_dim_plan(d) for d in (129, 256, 257, 512, 1024)] == [
        256, 256, 384, 512, 1024]


def test_the_example_attention_stack_learns_its_task():
    """examples/attention_sequence_classifier.py on the port (its data, its
    stack, Adam(3e-3), 30 full-batch epochs): test accuracy > 0.8, the
    example's own gate."""
    t_len, f = 24, 8

    def make_data(n, seed):
        rng = np.random.default_rng(seed)
        x = rng.standard_normal((n, t_len, f)).astype(np.float32) * 0.5
        lengths = rng.integers(8, t_len + 1, n)
        mask = (np.arange(t_len)[None, :] < lengths[:, None]).astype(
            np.float32)
        labels = rng.integers(0, 2, n)
        for i in np.where(labels == 1)[0]:
            x[i, rng.integers(0, lengths[i])] += 3.0
        x *= mask[:, :, None]
        ds = DataSet(x, np.eye(2, dtype=np.float32)[labels])
        ds.featuresMask = mask
        return ds

    conf = (tnn.NeuralNetConfiguration.Builder()
            .seed(7).updater(tnn.Adam(3e-3)).weightInit("xavier")
            .list()
            .layer(tnn.SelfAttentionLayer(nOut=32, nHeads=4))
            .layer(tnn.LearnedSelfAttentionLayer(nOut=32, nHeads=4,
                                                 nQueries=4))
            .layer(tnn.LastTimeStep(tnn.LSTM(nOut=16)))
            .layer(tnn.OutputLayer(lossFunction="mcxent", nOut=2,
                                   activation="softmax"))
            .setInputType(tnn.InputType.recurrent(f, t_len))
            .build())
    net = tnn.MultiLayerNetwork(conf).init("cpu")
    train, test = make_data(256, 0), make_data(64, 1)
    for _ in range(30):
        net.fit(train)
    preds = net.output(test.features, fmask=test.featuresMask)
    acc = float((preds.argmax(-1).numpy()
                 == test.labels.argmax(-1)).mean())
    assert acc > 0.8, acc
