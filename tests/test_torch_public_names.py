"""The public names the port added to match the JAX package's surface,
each against the reference on the CPU with the same seeded numpy inputs:
`runtime.executables.forward_fn` (both network classes, with and without
a feature mask; 1e-5 relative to max(1, max |JAX|)), `nn.accum.
accum_scan` (a least-squares model with a stateful counter, G = 4; 1e-6,
`micro_ok` included), `Layer.n_params` (exact, per layer family),
`QuantizedComputationGraph.summary()` (the same rows),
`PrefetchIterator.failed()` and `next(num)`,
`ParameterAveragingTrainer.make_step()`, the decoders' protocol
constants and the package-level exports."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeplearning4j_tpu as jpkg
import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu.nn.conf.attention as jatt
import deeplearning4j_tpu.nn.conf.capsules as jcaps
import deeplearning4j_tpu.nn.conf.recurrent as jrec
import deeplearning4j_tpu_torch as tpkg
import deeplearning4j_tpu_torch.nn as tnn
import deeplearning4j_tpu_torch.nn.conf.attention as tatt
import deeplearning4j_tpu_torch.nn.conf.capsules as tcaps
import deeplearning4j_tpu_torch.nn.conf.recurrent as trec
from deeplearning4j_tpu import quantize as jq
from deeplearning4j_tpu.generation import decode as jdecode
from deeplearning4j_tpu.nn import accum as jaccum
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.runtime import executables as jexe
from deeplearning4j_tpu_torch import quantize as tq
from deeplearning4j_tpu_torch.generation import decode as tdecode
from deeplearning4j_tpu_torch.nn import accum as taccum
from deeplearning4j_tpu_torch.parallel.mesh import DeviceMesh
from deeplearning4j_tpu_torch.parallel.sharded_trainer import \
    ParameterAveragingTrainer
from deeplearning4j_tpu_torch.runtime import executables as texe
from deeplearning4j_tpu_torch.runtime.pipeline import PrefetchIterator

from test_torch_layers_rest import J, T
from test_torch_multilayer import _close, _np_tree
from test_torch_quantize import _port_graph, _residual_conf

FWD_TOL = 1e-5
ACCUM_TOL = 1e-6
NB, NT, NF, NC = 3, 5, 4, 2


# -- forward_fn ---------------------------------------------------------------
def _conf(nn, rec, kind, recurrent):
    b = nn.NeuralNetConfiguration.Builder().seed(5).updater(nn.Sgd(0.1))
    if recurrent:
        it = nn.InputType.recurrent(NF)
        hidden = rec.LSTM(nOut=6, activation="tanh")
        out = rec.RnnOutputLayer(lossFunction="mcxent", nOut=NC,
                                activation="softmax")
    else:
        it = nn.InputType.feedForward(NF)
        hidden = nn.DenseLayer(nOut=6, activation="tanh")
        out = nn.OutputLayer(lossFunction="mcxent", nOut=NC,
                             activation="softmax")
    if kind == "multilayer":
        return b.list().layer(hidden).layer(out).setInputType(it).build()
    return (b.graphBuilder().addInputs("in").setInputTypes(it)
            .addLayer("h", hidden, "in").addLayer("out", out, "h")
            .setOutputs("out").build())


def _net_pair(kind, recurrent):
    jcls = JMLN if kind == "multilayer" else JGraph
    jnet = jcls(_conf(jnn, jrec, kind, recurrent)).init()
    params, state = _np_tree(jnet._params), _np_tree(jnet._state)
    if kind == "multilayer":
        tnet = tnn.multilayer_params_from_numpy(
            tnn.MultiLayerNetwork(_conf(tnn, trec, kind, recurrent)), params,
            state, device="cpu")
    else:
        tnet = tnn.graph_params_from_numpy(
            tnn.ComputationGraph(_conf(tnn, trec, kind, recurrent)), params,
            state, device="cpu")
    return jnet, tnet


@pytest.mark.parametrize("with_mask", [False, True], ids=["plain", "mask"])
@pytest.mark.parametrize("kind", ["multilayer", "graph"])
def test_forward_fn_matches_the_jax_packages(kind, with_mask):
    rng = np.random.default_rng(11)
    jnet, tnet = _net_pair(kind, recurrent=with_mask)
    shape = (NB, NT, NF) if with_mask else (NB, NF)
    x = rng.standard_normal(shape).astype(np.float32)
    args = [x]
    if with_mask:
        mask = np.ones((NB, NT), np.float32)
        mask[0, 3:] = 0.0
        mask[2, 1:] = 0.0
        args.append(mask)
    want = jexe.forward_fn(jnet, with_mask)(
        jnet._params, jnet._state, *[jnp.asarray(a) for a in args])
    got = texe.forward_fn(tnet, with_mask)(
        tnet._params, tnet._state, *[torch.as_tensor(a) for a in args])
    assert isinstance(got, tuple) and len(got) == len(want) == 1
    _close(got[0], want[0], FWD_TOL, "forward_fn")
    # the same function the output() path runs
    kw = {}
    if with_mask:
        kw = ({"fmask": args[1]} if kind == "multilayer"
              else {"fmasks": {"in": args[1]}})
    assert torch.equal(got[0], tnet.output(x, **kw).tensor)


# -- accum_scan ---------------------------------------------------------------
def _lsq(np_mod, where):
    """grad_fn of 0.5·mean((x@w + b - y)²) with a state counter that each
    microbatch adds its index sum to (so the threading order shows)."""
    def grad_fn(params, state, inp):
        x, y = inp["x"], inp["y"]
        r = x @ params["w"] + params["b"] - y
        loss = 0.5 * (r * r).mean()
        n = r.shape[0]
        gw = x.T @ r / n
        gb = r.mean(axis=0) if np_mod is jnp else r.mean(dim=0)
        new_state = {"count": state["count"] * 2 + inp["i"]}
        return (loss, new_state), {"w": gw, "b": gb}
    return grad_fn


def _accum_inputs(nan_at=None, g=4, n=6, d=3, k=2):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((g, n, d)).astype(np.float32)
    y = rng.standard_normal((g, n, k)).astype(np.float32)
    if nan_at is not None:
        y[nan_at, 0, 0] = np.nan
    params = {"w": rng.standard_normal((d, k)).astype(np.float32),
              "b": rng.standard_normal((k,)).astype(np.float32)}
    inputs = {"x": x, "y": y, "i": np.arange(1, g + 1, dtype=np.float32)}
    return params, inputs


@pytest.mark.parametrize("nan_at", [None, 2], ids=["finite", "nan"])
def test_accum_scan_matches_the_jax_packages(nan_at):
    params, inputs = _accum_inputs(nan_at)
    state = {"count": np.float32(0.0)}
    jg, jl, jok, js = jaccum.accum_scan(
        _lsq(jnp, "jax"), jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, state),
        jax.tree_util.tree_map(jnp.asarray, inputs))
    tt = lambda tree: {k: torch.as_tensor(v) for k, v in tree.items()}  # noqa: E731,E501
    tg, tl, tok, ts = taccum.accum_scan(_lsq(torch, "torch"), tt(params),
                                        {"count": torch.tensor(0.0)},
                                        tt(inputs))
    assert bool(tok) == bool(jok) == (nan_at is None)
    # state threads 1, 2, 3, 4 in order: ((1·2 + 2)·2 + 3)·2 + 4 = 26
    assert float(ts["count"]) == float(js["count"]) == 26.0
    if nan_at is None:
        _close(tl, jl, ACCUM_TOL, "mean loss")
        for k in ("w", "b"):
            _close(tg[k], jg[k], ACCUM_TOL, k)
    else:
        assert not np.isfinite(float(tl)) and not np.isfinite(float(jl))


def test_accum_scan_equals_an_explicit_loop():
    params, inputs = _accum_inputs()
    tp = {k: torch.as_tensor(v) for k, v in params.items()}
    ti = {k: torch.as_tensor(v) for k, v in inputs.items()}
    fn = _lsq(torch, "torch")
    grads, loss, ok, _ = taccum.accum_scan(fn, tp, {"count": torch.tensor(
        0.0)}, ti)
    state, gsum, lsum = {"count": torch.tensor(0.0)}, None, None
    for i in range(4):
        (l, state), g = fn(tp, state, {k: v[i] for k, v in ti.items()})
        gsum = g if gsum is None else {k: gsum[k] + g[k] for k in g}
        lsum = l if lsum is None else lsum + l
    assert torch.equal(loss, lsum * 0.25) and bool(ok)
    for k in gsum:
        assert torch.equal(grads[k], gsum[k] * 0.25)


# -- Layer.n_params -------------------------------------------------------------
#: (make(nn, rec, att, caps, **kw), input type(nn)); every layer gets an
#: explicit weightInit and biasInit, which a configuration's defaults give
#: otherwise
LAYERS = {
    "dense": (lambda nn, rec, att, caps, **kw: nn.DenseLayer(nOut=7, **kw),
              lambda nn: nn.InputType.feedForward(5)),
    "dense no bias": (lambda nn, rec, att, caps, **kw: nn.DenseLayer(
        nOut=7, hasBias=False, **kw), lambda nn: nn.InputType.feedForward(5)),
    "conv": (lambda nn, rec, att, caps, **kw: nn.ConvolutionLayer(
        kernelSize=(3, 3), nOut=4, **kw),
        lambda nn: nn.InputType.convolutional(8, 8, 3)),
    "batchnorm": (lambda nn, rec, att, caps, **kw: nn.BatchNormalization(
        **kw), lambda nn: nn.InputType.convolutional(8, 8, 3)),
    "lstm": (lambda nn, rec, att, caps, **kw: rec.LSTM(nOut=6, **kw),
             lambda nn: nn.InputType.recurrent(5)),
    "bidirectional lstm": (lambda nn, rec, att, caps, **kw: rec.Bidirectional(
        rec.LSTM(nOut=6, **kw)), lambda nn: nn.InputType.recurrent(5)),
    "self attention": (lambda nn, rec, att, caps, **kw: att.SelfAttentionLayer(
        nOut=8, nHeads=2, **kw), lambda nn: nn.InputType.recurrent(8)),
    "learned self attention": (
        lambda nn, rec, att, caps, **kw: att.LearnedSelfAttentionLayer(
            nOut=8, nHeads=2, nQueries=3, **kw),
        lambda nn: nn.InputType.recurrent(8)),
    "primary capsules": (lambda nn, rec, att, caps, **kw: caps.PrimaryCapsules(
        capsuleDimensions=4, channels=3, kernelSize=(3, 3), stride=(2, 2),
        **kw), lambda nn: nn.InputType.convolutional(7, 7, 2)),
    "capsule": (lambda nn, rec, att, caps, **kw: caps.CapsuleLayer(
        capsules=3, capsuleDimensions=4, routings=3, **kw),
        lambda nn: nn.InputType.recurrent(5, 6)),
    "embedding": (lambda nn, rec, att, caps, **kw: nn.EmbeddingLayer(
        nIn=10, nOut=4, **kw), lambda nn: nn.InputType.feedForward(1)),
    "output": (lambda nn, rec, att, caps, **kw: nn.OutputLayer(nOut=3, **kw),
               lambda nn: nn.InputType.feedForward(6)),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_n_params_equals_the_jax_packages(name):
    make, it = LAYERS[name]
    kw = dict(weightInit="xavier", biasInit=0.0)
    want = make(jnn, jrec, jatt, jcaps, **kw).n_params(it(jnn))
    got = make(tnn, trec, tatt, tcaps, **kw).n_params(it(tnn))
    assert got == want > 0


# -- QuantizedComputationGraph.summary ------------------------------------------
def test_quantized_graph_summary_prints_the_jax_packages_rows():
    jnet = JGraph(_residual_conf(J)).init()
    tnet = _port_graph(jnet, _residual_conf(T))
    jqn = jq.quantize_network(jnet, impl="dot")
    tqn = tq.quantize_network(tnet, impl="dot")
    got, want = tqn.summary().splitlines(), jqn.summary().splitlines()
    assert got == want
    assert any(line.startswith("r0_c1") for line in got)
    assert tnet.summary().splitlines() == jnet.summary().splitlines()


# -- PrefetchIterator -----------------------------------------------------------
class _Failing:
    def __init__(self, fail_at):
        self.fail_at, self.i = fail_at, 0

    def hasNext(self):
        return self.i < 4

    def next(self):
        if self.i == self.fail_at:
            self.i += 1
            raise OSError("read failed")
        self.i += 1
        return self.i

    def reset(self):
        self.i = 0


def test_prefetch_iterator_failed_and_next_num():
    pf = PrefetchIterator(_Failing(fail_at=1), depth=1)
    try:
        assert not pf.failed()
        assert pf.next(7) == 1          # DL4J's next(num): one batch
        with pytest.raises(OSError):
            pf.hasNext()
        assert pf.failed()
        with pytest.raises(OSError):
            pf.next()
        pf.resume_after_error()
        assert not pf.failed()
        assert [pf.next(), pf.next()] == [3, 4] and not pf.hasNext()
        pf.reset()
        assert not pf.failed() and pf.next() == 1
    finally:
        pf.close()


# -- ParameterAveragingTrainer.make_step ----------------------------------------
def test_parameter_averaging_make_step_is_fit_batchs_step():
    rng = np.random.default_rng(2)
    w0 = rng.standard_normal((4, 2)).astype(np.float32)
    batch = {"x": rng.standard_normal((8, 4)).astype(np.float32),
             "y": rng.standard_normal((8, 2)).astype(np.float32)}

    def loss_fn(p, b, generator):
        return ((b["x"] @ p["w"] - b["y"]) ** 2).mean()

    mesh = DeviceMesh(device="cpu", dp=1)
    runs = []
    for via_step in (False, True):
        tr = ParameterAveragingTrainer(loss_fn, tnn.Sgd(0.1), mesh,
                                       averaging_frequency=2)
        params, opt = tr.init({"w": torch.as_tensor(w0)})
        step = tr.make_step() if via_step else tr.fit_batch
        losses = []
        for it in range(3):
            params, opt, loss = step(params, opt, batch, None, it)
            losses.append(float(loss))
        runs.append((params["w"].clone(), losses))
    assert torch.equal(runs[0][0], runs[1][0]) and runs[0][1] == runs[1][1]
    assert runs[0][1][2] < runs[0][1][0]


# -- constants and exports --------------------------------------------------------
def test_decoder_protocol_constants_are_the_jax_packages():
    for cls in ("BertDecoder", "RecurrentDecoder"):
        for attr in ("uses_cache_rungs", "n_model_args"):
            assert getattr(getattr(tdecode, cls), attr) == getattr(
                getattr(jdecode, cls), attr), (cls, attr)


def test_package_level_names():
    from deeplearning4j_tpu import util as jutil
    from deeplearning4j_tpu_torch import util as tutil
    from deeplearning4j_tpu_torch.models import bert as tb
    from deeplearning4j_tpu_torch.models.convert import init_bert_params
    from deeplearning4j_tpu_torch.ops import nd
    assert tutil.__all__ == jutil.__all__
    assert tutil.ModelGuesser.__module__.startswith("deeplearning4j_tpu_torch")
    assert tpkg.nd is nd and type(jpkg.nd).__name__ == type(nd).__name__
    assert tb.init_bert_params is init_bert_params
