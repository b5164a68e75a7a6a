"""The rank side of the port's parallel tests (tests/test_torch_parallel*.py).

`spawn(world, cases, directory, inputs)` starts `world` gloo ranks with
`torch.multiprocessing.spawn` over a FileStore in `directory`; every rank
runs every named case of CASES on the shared `inputs` (numpy arrays, the
JAX-derived starting parameters among them) and pickles its results
(numpy) to `directory`. A case that raises records its traceback, so the
test of that contract fails and the others still run. The ranks import
torch and the port only: this module imports no JAX.

The seeded inputs both sides use are made here too (`qkv`, `mlp_data`,
...), so the tests rebuild them for the JAX side from the same seeds.
"""
from __future__ import annotations

import os
import pickle
import traceback

import numpy as np

TIMEOUT_S = 120


# -- seeded inputs (both packages) -------------------------------------------
def qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for _ in range(3))


def lengths_mask(lengths, t):
    return (np.arange(t)[None, :] < np.asarray(lengths)[:, None]).astype(
        np.float32)


def mlp_data(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


def conv_data(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 8 * 8)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


def mlp_conf(nn, seed, updater=None, lr=0.05):
    return (nn.NeuralNetConfiguration.Builder()
            .seed(seed).updater(updater or nn.Sgd(lr)).activation("relu")
            .list()
            .layer(nn.DenseLayer.Builder().nOut(16).build())
            .layer(nn.OutputLayer.Builder("mcxent").nOut(3)
                   .activation("softmax").build())
            .setInputType(nn.InputType.feedForward(6))
            .build())


def accum_conf(nn, seed=4):
    """mlp_conf's network with `.gradientAccumulation(2)`: every two
    batches make one update."""
    return (nn.NeuralNetConfiguration.Builder()
            .seed(seed).updater(nn.Sgd(0.05)).activation("relu")
            .gradientAccumulation(2)
            .list()
            .layer(nn.DenseLayer.Builder().nOut(16).build())
            .layer(nn.OutputLayer.Builder("mcxent").nOut(3)
                   .activation("softmax").build())
            .setInputType(nn.InputType.feedForward(6))
            .build())


def conv_bn_conf(nn, seed):
    """A conv + BatchNorm net: under the wrapper its BN statistics must be
    the global batch's."""
    return (nn.NeuralNetConfiguration.Builder()
            .seed(seed).updater(nn.Sgd(0.05)).activation("relu")
            .list()
            .layer(nn.ConvolutionLayer(nOut=4, kernelSize=(3, 3),
                                       activation="identity"))
            .layer(nn.BatchNormalization())
            .layer(nn.SubsamplingLayer(kernelSize=(2, 2), stride=(2, 2)))
            .layer(nn.DenseLayer(nOut=8, activation="relu"))
            .layer(nn.OutputLayer.Builder("mcxent").nOut(3)
                   .activation("softmax").build())
            .setInputType(nn.InputType.convolutionalFlat(8, 8, 1))
            .build())


def graph_conf(nn, seed=6):
    return (nn.NeuralNetConfiguration.Builder().seed(seed)
            .updater(nn.Sgd(0.05)).activation("relu").graphBuilder()
            .addInputs("in")
            .addLayer("d", nn.DenseLayer.Builder().nOut(12).build(), "in")
            .addLayer("out", nn.OutputLayer.Builder("mcxent").nOut(3)
                      .activation("softmax").build(), "d")
            .setOutputs("out")
            .setInputTypes(nn.InputType.feedForward(6)).build())


def resnetish_conf(nn, EW):
    """tests/test_torch_graph.py's bottleneck-ish graph: two conv1x1+BN
    pairs the fusion takes (B5, B7, B8 on the card), unfused BNs, a 3×3
    conv and a residual join."""
    conv, bn = nn.ConvolutionLayer, nn.BatchNormalization
    g = (nn.NeuralNetConfiguration.Builder()
         .seed(11).updater(nn.Nesterovs(0.05, 0.9)).weightInit("relu")
         .graphBuilder().addInputs("input")
         .setInputTypes(nn.InputType.convolutional(8, 8, 4)))
    g.addLayer("c1", conv(kernelSize=(1, 1), nOut=8, hasBias=False,
                          activation="identity"), "input")
    g.addLayer("bn1", bn(activation="relu"), "c1")
    g.addLayer("c2", conv(kernelSize=(3, 3), nOut=8, convolutionMode="same",
                          hasBias=False, activation="identity"), "bn1")
    g.addLayer("bn2", bn(activation="identity"), "c2")
    g.addLayer("c3", conv(kernelSize=(1, 1), nOut=8, hasBias=False,
                          activation="identity"), "bn2")
    g.addLayer("bn3", bn(activation="identity"), "c3")
    g.addVertex("add", EW("add"), "bn3", "c3")
    g.addLayer("relu", nn.ActivationLayer(activation="relu"), "add")
    g.addLayer("c4", conv(kernelSize=(1, 1), stride=(2, 2),
                          convolutionMode="same", nOut=12, hasBias=False,
                          activation="identity"), "relu")
    g.addLayer("bn4", bn(activation="relu"), "c4")
    g.addLayer("pool", nn.GlobalPoolingLayer(poolingType="avg"), "bn4")
    g.addLayer("out", nn.OutputLayer(lossFunction="mcxent", nOut=3,
                                     activation="softmax"), "pool")
    g.setOutputs("out")
    return g.build()


def resnetish_data():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((16, 8, 8, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    return x, y


def espt_data():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((64, 4)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x[:, 0] > 0).astype(int)]
    return x, y


def espt_conf(nn):
    return (nn.NeuralNetConfiguration.Builder()
            .seed(9).updater(nn.Sgd(0.1)).activation("relu")
            .list()
            .layer(nn.DenseLayer.Builder().nOut(8).build())
            .layer(nn.OutputLayer.Builder("mcxent").nOut(2)
                   .activation("softmax").build())
            .setInputType(nn.InputType.feedForward(4))
            .build())


def pipeline_inputs():
    rng = np.random.default_rng(6)
    stages = [{"W": rng.standard_normal((8, 8)).astype(np.float32) * 0.3,
               "b": rng.standard_normal((8,)).astype(np.float32) * 0.1}
              for _ in range(2)]
    x = rng.standard_normal((16, 8)).astype(np.float32)
    return stages, x


def sharded_inputs():
    rng = np.random.default_rng(1)
    W1 = rng.standard_normal((8, 32)).astype(np.float32) * 0.1
    W2 = rng.standard_normal((32, 2)).astype(np.float32) * 0.1
    x = rng.standard_normal((16, 8)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 16)]
    return {"W1": W1, "W2": W2}, x, y


def accum_inputs(g=4, b=8):
    rng = np.random.default_rng(21)
    xs = rng.standard_normal((g, b, 6)).astype(np.float32)
    ys = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (g, b))]
    p = {"W": (rng.standard_normal((6, 3)) * 0.3).astype(np.float32),
         "b": np.zeros((3,), np.float32)}
    return xs, ys, p


def averaging_inputs():
    rng = np.random.default_rng(2)
    true_w = np.array([[1.0], [2.0], [-1.0], [0.5]], np.float32)
    x = rng.standard_normal((64, 4)).astype(np.float32)
    return x, x @ true_w, true_w


# -- the rank side -----------------------------------------------------------
#: the directory the ranks share (checkpoints), set in each rank
OUT_DIR = None


def _t(a):
    import torch
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().numpy()


def _grads(out, args, weight=None):
    import torch
    loss = torch.sin(out) if weight is None else torch.square(out * weight)
    return [_np(g) for g in torch.autograd.grad(loss.sum(), args)]


def _leaves(tree):
    import torch
    out = {}
    for n in sorted(tree):
        for k in sorted(tree[n]):
            out[f"{n}/{k}"] = _np(tree[n][k]) if torch.is_tensor(
                tree[n][k]) else tree[n][k]
    return out


def case_ring(inputs):
    """The plain ring, the flash ring (plain kernel versions on the CPU),
    causal and masked, over the group's ranks as one sp axis."""
    import torch
    from deeplearning4j_tpu_torch.parallel.mesh import DeviceMesh, P, \
        shard_map
    from deeplearning4j_tpu_torch.parallel.ring_attention import (
        make_ring_attention, ring_attention)
    import torch.distributed as dist
    mesh = DeviceMesh(sp=dist.get_world_size())
    spec = P(None, None, "sp", None)
    out = {}
    q, k, v = (_t(a) for a in qkv(3, (2, 4, 64, 8)))
    out["plain"] = _np(ring_attention(q, k, v, mesh))
    q, k, v = (_t(a) for a in qkv(4, (1, 2, 32, 4)))
    out["plain_causal"] = _np(ring_attention(q, k, v, mesh, causal=True))
    # masked, plain ring
    q, k, v = (_t(a) for a in qkv(18, (2, 4, 64, 8)))
    m = _t(lengths_mask([40, 64], 64))
    out["plain_masked"] = _np(ring_attention(q, k, v, mesh, kv_mask=m))
    q, k, v = (_t(a) for a in qkv(19, (1, 2, 32, 4)))
    m = _t(lengths_mask([24], 32))
    out["plain_masked_causal"] = _np(ring_attention(q, k, v, mesh,
                                                    causal=True, kv_mask=m))
    # the flash ring, forward and gradients
    for causal in (False, True):
        q, k, v = (_t(a).requires_grad_() for a in qkv(0, (1, 2, 32, 16)))
        f = shard_map(make_ring_attention(mesh, "sp", causal=causal,
                                          use_flash=True),
                      mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec)
        o = f(q, k, v)
        tag = "flash_causal" if causal else "flash"
        out[tag] = _np(o)
        out[tag + "_grads"] = _grads(o, (q, k, v))
    # masked flash ring, with fully masked tail blocks
    q, k, v = (_t(a).requires_grad_() for a in qkv(20, (2, 4, 64, 8)))
    m = _t(lengths_mask([40, 64], 64))
    fm = shard_map(make_ring_attention(mesh, "sp", use_flash=True),
                   mesh=mesh, in_specs=(spec, spec, spec, P(None, "sp")),
                   out_specs=spec)
    o = fm(q, k, v, m)
    out["flash_masked"] = _np(o)
    out["flash_masked_grads"] = _grads(o, (q, k, v), m[:, None, :, None])
    # causal + LEFT padding
    q, k, v = (_t(a).requires_grad_() for a in qkv(22, (1, 2, 32, 4)))
    m = _t((np.arange(32)[None, :] >= 12).astype(np.float32))
    fc = shard_map(make_ring_attention(mesh, "sp", causal=True,
                                       use_flash=True),
                   mesh=mesh, in_specs=(spec, spec, spec, P(None, "sp")),
                   out_specs=spec)
    o = fc(q, k, v, m)
    out["left_pad"] = _np(o)
    out["left_pad_grads"] = _grads(o, (q, k, v), m[:, None, :, None])
    # a zero-length example (finite, zero gradients) and a bool mask
    q, k, v = (_t(a).requires_grad_() for a in qkv(21, (2, 2, 32, 4)))
    m = np.zeros((2, 32), np.float32)
    m[1, :20] = 1.0
    m = _t(m)
    o = fm(q, k, v, m)
    out["zero_len_grads"] = _grads(o, (q, k, v), m[:, None, :, None])
    o = fm(q, k, v, m > 0)
    out["bool_mask_dq"] = _grads(o, (q,), 1.0)[0]
    return out


def case_ulysses(inputs):
    import torch
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.kernels.flash_attention import \
        flash_attention
    from deeplearning4j_tpu_torch.parallel.mesh import DeviceMesh
    from deeplearning4j_tpu_torch.parallel.ring_attention import \
        dense_attention
    from deeplearning4j_tpu_torch.parallel.ulysses import \
        ulysses_attention_sharded
    mesh = DeviceMesh(sp=dist.get_world_size())
    out = {}
    q, k, v = (_t(a) for a in qkv(11, (2, 4, 64, 8)))
    out["plain"] = _np(ulysses_attention_sharded(mesh, q, k, v))
    q, k, v = (_t(a) for a in qkv(12, (1, 4, 32, 4)))
    out["causal"] = _np(ulysses_attention_sharded(mesh, q, k, v,
                                                  causal=True))
    q, k, v = (_t(a) for a in qkv(14, (2, 4, 64, 8)))
    m = _t(lengths_mask([40, 64], 64))
    out["masked"] = _np(ulysses_attention_sharded(mesh, q, k, v, mask=m))
    bad = _t(qkv(12, (1, 3, 32, 4))[0])
    try:
        ulysses_attention_sharded(mesh, bad, bad, bad)
        out["head_check"] = "no error"
    except ValueError as e:
        out["head_check"] = str(e)
    try:
        ulysses_attention_sharded(
            mesh, q, k, v, mask=m,
            attn_fn=lambda a, b, c, causal=False: dense_attention(a, b, c))
        out["guard"] = "no error"
    except ValueError as e:
        out["guard"] = str(e)
    # flash_attention as the local attention: B1, B2a and B2b
    q, k, v = (_t(a).requires_grad_() for a in qkv(15, (2, 4, 64, 16)))
    o = ulysses_attention_sharded(mesh, q, k, v, mask=m,
                                  attn_fn=flash_attention)
    out["flash"] = _np(o)
    out["flash_grads"] = _grads(o, (q, k, v), m[:, None, :, None])
    return out


def case_pipeline(inputs):
    import torch
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.parallel.mesh import DeviceMesh
    from deeplearning4j_tpu_torch.parallel.pipeline import (
        make_pipeline_fn, stack_stage_params)
    mesh = DeviceMesh(devices=[0, 1], pp=2)
    stages, x = pipeline_inputs()
    stacked = stack_stage_params([{k: _t(v) for k, v in s.items()}
                                  for s in stages])
    stacked = {k: v.requires_grad_() for k, v in stacked.items()}

    def stage_fn(p, h):
        return torch.tanh(h @ p["W"] + p["b"])

    pipe = make_pipeline_fn(stage_fn, mesh, n_microbatches=4)
    y = pipe(stacked, _t(x))
    g = torch.autograd.grad((y ** 2).sum(), [stacked["W"], stacked["b"]])
    return {"y": _np(y), "dW": _np(g[0]), "db": _np(g[1])}


def _port_mlp(nn, params, state, make, *a, **kw):
    from deeplearning4j_tpu_torch.nn import multilayer_params_from_numpy
    return multilayer_params_from_numpy(
        nn.MultiLayerNetwork(make(nn, *a, **kw)), params, state,
        device="cpu")


def case_wrapper(inputs):
    import torch.distributed as dist
    import deeplearning4j_tpu_torch.nn as nn
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ArrayDataSetIterator
    from deeplearning4j_tpu_torch.nn import graph_params_from_numpy
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    w = dist.get_world_size()
    out = {}

    def wrapped(net, it, epochs, k=1):
        ParallelWrapper.Builder(net).workers(w).build().fit(
            it, epochs=epochs, stepsPerDispatch=k)
        return net

    p, s = inputs["mlp1"]
    x, y = mlp_data(64)
    net = wrapped(_port_mlp(nn, p, s, mlp_conf, 1),
                  ArrayDataSetIterator(x, y, 32), 3)
    out["matches_single"] = _leaves(net._params)
    p, s = inputs["mlp3"]
    x, y = mlp_data(60)
    net = wrapped(_port_mlp(nn, p, s, mlp_conf, 3),
                  ArrayDataSetIterator(x, y, 32), 2)
    out["ragged"] = _leaves(net._params)
    p, s = inputs["mlp5"]
    x, y = mlp_data(80, seed=9)
    a = wrapped(_port_mlp(nn, p, s, mlp_conf, 5),
                ArrayDataSetIterator(x, y, 32), 3)
    b = wrapped(_port_mlp(nn, p, s, mlp_conf, 5),
                ArrayDataSetIterator(x, y, 32), 3, k=2)
    out["seq"], out["spd"] = _leaves(a._params), _leaves(b._params)
    out["spd_iterations"] = (a._iteration, b._iteration)
    p, s = inputs["graph"]
    x, y = mlp_data(64, seed=10)
    g1 = graph_params_from_numpy(nn.ComputationGraph(graph_conf(nn)), p, s,
                                 device="cpu")
    g2 = graph_params_from_numpy(nn.ComputationGraph(graph_conf(nn)), p, s,
                                 device="cpu")
    wrapped(g1, ArrayDataSetIterator(x, y, 32), 2)
    wrapped(g2, ArrayDataSetIterator(x, y, 32), 2, k=2)
    out["graph"], out["graph_spd"] = _leaves(g1._params), _leaves(g2._params)
    p, s = inputs["conv_bn"]
    x, y = conv_data(32)
    net = wrapped(_port_mlp(nn, p, s, conv_bn_conf, 12),
                  ArrayDataSetIterator(x, y, 16), 2)
    out["conv_bn"] = _leaves(net._params)
    out["conv_bn_state"] = _leaves(net._state)
    out["conv_bn_score"] = float(net.score())
    # after a wrapped fit whose last batch is ragged (16 + 15 rows), each
    # rank's own net.fit on its own rows runs no collective and no stale
    # share: it equals a fresh copy's plain fit
    x, y = conv_data(31)
    net = wrapped(_port_mlp(nn, p, s, conv_bn_conf, 12),
                  ArrayDataSetIterator(x, y, 16), 1)
    copy = _port_mlp(nn, _nested(net._params), _nested(net._state),
                     conv_bn_conf, 12)
    x, y = conv_data(8, seed=20 + dist.get_rank())
    for m in (net, copy):
        m.fit(DataSet(x, y))
    out["refit"] = (_leaves(net._params), _leaves(net._state),
                    float(net.score()))
    out["refit_plain"] = (_leaves(copy._params), _leaves(copy._state),
                          float(copy.score()))
    return out


def _nested(tree):
    return {n: {k: _np(v) for k, v in d.items()} for n, d in tree.items()}


def case_wrapper_fused(inputs):
    """The fused conv1x1+BN pairs under the wrapper: their Σy, Σy² and
    Σdz·x̂, Σdz summed over dp (the plain versions of B5, B7, B8 here)."""
    import torch.distributed as dist
    import deeplearning4j_tpu_torch.nn as nn
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ArrayDataSetIterator
    from deeplearning4j_tpu_torch.nn import graph_params_from_numpy
    from deeplearning4j_tpu_torch.nn.conf.graph_vertices import \
        ElementWiseVertex
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    os.environ["DL4J_TPU_FUSE_CONV_BN"] = "1"
    p, s = inputs["resnetish"]
    net = graph_params_from_numpy(
        nn.ComputationGraph(resnetish_conf(nn, ElementWiseVertex)), p, s,
        device="cpu")
    x, y = resnetish_data()
    ParallelWrapper.Builder(net).workers(dist.get_world_size()).build().fit(
        ArrayDataSetIterator(x, y, 16), epochs=2)
    return {"pairs": len(net._fused_pairs), "params": _leaves(net._params),
            "state": _leaves(net._state), "score": float(net.score())}


def case_wrapper_accum(inputs):
    """gradientAccumulation(2) inherited from the conf: two batches' rows
    on each rank, one dp update for the pair."""
    import torch.distributed as dist
    import deeplearning4j_tpu_torch.nn as nn
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ArrayDataSetIterator
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    p, s = inputs["accum"]
    net = _port_mlp(nn, p, s, accum_conf)
    x, y = mlp_data(64, seed=4)
    ParallelWrapper.Builder(net).workers(dist.get_world_size()).build().fit(
        ArrayDataSetIterator(x, y, 16), epochs=2)
    return {"params": _leaves(net._params), "iterations": net._iteration}


def case_sharded_guarded(inputs):
    """ShardedTrainer under a TrainingGuardian: a healthy step equals the
    unguarded one bit for bit; a batch with a NaN leaves the parameters
    and the optimizer state as they were, on every rank."""
    import torch
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.nn import Adam
    from deeplearning4j_tpu_torch.parallel import DeviceMesh, ShardedTrainer
    from deeplearning4j_tpu_torch.resilience.guardian import \
        TrainingGuardian

    def loss_fn(p, batch, gen):
        xb, yb = batch
        logp = torch.log_softmax(torch.relu(xb @ p["W1"]) @ p["W2"], -1)
        return -(yb * logp).sum(-1).mean()

    mesh = DeviceMesh(dp=dist.get_world_size())
    params, x, y = sharded_inputs()
    plain, guarded = (ShardedTrainer(loss_fn, Adam(0.05), mesh)
                      for _ in range(2))
    p1, s1 = plain.init(params)
    p2, s2 = guarded.init(params)
    batch = plain.shard_batch((x, y))
    bad = x.copy()
    bad[0, 0] = np.nan
    nan_batch = plain.shard_batch((bad, y))
    p1, s1, _ = plain.fit_batch(p1, s1, batch)
    with TrainingGuardian(check_every=1) as g:
        p2, s2, _ = guarded.fit_batch(p2, s2, batch)
        same = all(torch.equal(p1[k], p2[k]) for k in p1)
        before = {k: v.clone() for k, v in p2.items()}
        p2, s2, _ = guarded.fit_batch(p2, s2, nan_batch)
        kept = all(torch.equal(before[k], p2[k]) for k in p2)
    skipped = g.skipped
    return {"healthy_equal": same, "nan_kept": kept, "skipped": skipped}


def case_zero(inputs):
    import torch.distributed as dist
    import deeplearning4j_tpu_torch.nn as nn
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ArrayDataSetIterator
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.parallel.zero import (ZeroState,
                                                        state_memory_bytes)
    w = dist.get_world_size()
    p, s = inputs["adam7"]
    x, y = mlp_data(64, seed=9)
    plain = _port_mlp(nn, p, s, mlp_conf, 7, updater=nn.Adam(0.01))
    ParallelWrapper.Builder(plain).workers(w).build().fit(
        ArrayDataSetIterator(x, y, 32), epochs=2)
    zn = _port_mlp(nn, p, s, mlp_conf, 7, updater=nn.Adam(0.01))
    zw = ParallelWrapper.Builder(zn).workers(w).shardOptimizerState(
        True).build()
    zn._ensure_training()
    replicated = state_memory_bytes(zn._opt_state)
    zw.fit(ArrayDataSetIterator(x, y, 32), epochs=2)
    # outside the wrapper's fit a rank cannot update its state blocks alone
    try:
        zn.fit(ArrayDataSetIterator(x, y, 32))
        alone = None
    except RuntimeError as e:
        alone = str(e)
    return {"plain": _leaves(plain._params), "zero": _leaves(zn._params),
            "is_zero": isinstance(zn._opt_state, ZeroState),
            "bytes": (replicated, state_memory_bytes(zn._opt_state)),
            "alone": alone}


def case_espt(inputs):
    import torch.distributed as dist
    import deeplearning4j_tpu_torch.nn as nn
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ArrayDataSetIterator
    from deeplearning4j_tpu_torch.optimize.early_stopping import (
        DataSetLossCalculator, EarlyStoppingConfiguration,
        EarlyStoppingParallelTrainer, InMemoryModelSaver,
        MaxEpochsTerminationCondition)
    p, s = inputs["espt"]
    net = _port_mlp(nn, p, s, lambda nn_: espt_conf(nn_))
    x, y = espt_data()
    cfg = (EarlyStoppingConfiguration.Builder()
           .epochTerminationConditions(MaxEpochsTerminationCondition(5))
           .scoreCalculator(DataSetLossCalculator(
               ArrayDataSetIterator(x, y, batch_size=32), average=True))
           .modelSaver(InMemoryModelSaver())
           .build())
    res = EarlyStoppingParallelTrainer(
        cfg, net, ArrayDataSetIterator(x, y, batch_size=32),
        workers=dist.get_world_size()).fit()
    return {"totalEpochs": res.totalEpochs,
            "bestModelScore": res.bestModelScore,
            "scoreVsEpoch": dict(res.scoreVsEpoch),
            "params": _leaves(net._params)}


def case_averaging(inputs):
    import torch
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.nn import Sgd
    from deeplearning4j_tpu_torch.parallel import (DeviceMesh,
                                                   ParameterAveragingTrainer)
    mesh = DeviceMesh(dp=dist.get_world_size())

    def loss_fn(p, batch, gen):
        xb, yb = batch
        return torch.mean((xb @ p["w"] - yb) ** 2)

    x, y, _ = averaging_inputs()
    tr = ParameterAveragingTrainer(loss_fn, Sgd(0.1), mesh,
                                   averaging_frequency=2)
    p, s = tr.init({"w": np.zeros((4, 1), np.float32)})
    losses = []
    for i in range(40):
        p, s, loss = tr.fit_batch(p, s, (x, y), None, i)
        losses.append(float(loss))
    return {"w": _np(tr.average(p)["w"]), "losses": losses}


def case_sharded_accum(inputs):
    import torch
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.nn import Sgd
    from deeplearning4j_tpu_torch.parallel import DeviceMesh, ShardedTrainer

    def loss_fn(p, batch, gen):
        logits = batch["x"] @ p["W"] + p["b"]
        logp = torch.log_softmax(logits, -1)
        return -(batch["y"] * logp).sum(-1).mean()

    xs, ys, p0 = accum_inputs()
    mesh = DeviceMesh(dp=dist.get_world_size())
    tr = ShardedTrainer(loss_fn, Sgd(0.1), mesh, accumulation=xs.shape[0])
    p, s = tr.init(p0)
    batch = tr.shard_batch({"x": xs, "y": ys})
    p, s, loss = tr.fit_batch(p, s, batch, None)
    return {"params": {k: _np(v) for k, v in p.items()},
            "loss": float(loss)}


def case_sharded_dp_tp(inputs):
    """dp × tp = 2 × 2: W1 column-parallel, W2 row-parallel, 20 Adam
    steps (four ranks)."""
    import torch
    from deeplearning4j_tpu_torch.nn import Adam
    from deeplearning4j_tpu_torch.parallel import DeviceMesh, ShardedTrainer
    from deeplearning4j_tpu_torch.parallel.mesh import P
    mesh = DeviceMesh(dp=2, tp=2)
    params, x, y = sharded_inputs()
    specs = {"W1": mesh.sharding(None, "tp"), "W2": mesh.sharding("tp", None)}

    def loss_fn(p, batch, gen):
        xb, yb = batch
        h = torch.relu(xb @ p["W1"])
        logp = torch.log_softmax(h @ p["W2"], -1)
        return -(yb * logp).sum(-1).mean()

    tr = ShardedTrainer(loss_fn, Adam(0.05), mesh, specs)
    p, s = tr.init(params)
    batch = tr.shard_batch((x, y))
    losses = []
    for _ in range(20):
        p, s, loss = tr.fit_batch(p, s, batch, None)
        losses.append(float(loss))
    return {"losses": losses, "W1_shape": tuple(p["W1"].shape),
            "W2_shape": tuple(p["W2"].shape), "coords": mesh.coords,
            "W1": _np(p["W1"]), "W2": _np(p["W2"]),
            "spec": tuple(P(None, "tp"))}


def case_sharded_dp_tp_resume(inputs):
    """dp × tp = 2 × 2 under ElasticTrainer (four ranks): a run stopped
    after step 5 resumes from its step-4 save, which process 0 wrote
    whole, each rank taking its dp × tp block back, and ends where the
    uninterrupted 6-step run ends: tp shards and Adam moments."""
    import torch
    from deeplearning4j_tpu_torch.nn import Adam
    from deeplearning4j_tpu_torch.parallel import DeviceMesh, ShardedTrainer
    from deeplearning4j_tpu_torch.parallel.elastic import ElasticTrainer
    from deeplearning4j_tpu_torch.resilience import integrity
    mesh = DeviceMesh(dp=2, tp=2)
    params, x, y = sharded_inputs()
    specs = {"W1": mesh.sharding(None, "tp"), "W2": mesh.sharding("tp", None)}

    def loss_fn(p, batch, gen):
        xb, yb = batch
        h = torch.relu(xb @ p["W1"])
        logp = torch.log_softmax(h @ p["W2"], -1)
        return -(yb * logp).sum(-1).mean()

    def run(directory, steps):
        e = ElasticTrainer(ShardedTrainer(loss_fn, Adam(0.05), mesh, specs),
                           directory, save_every=2)
        p, s = e.resume_or_init(params)
        start = e.step_num
        batch = e.trainer.shard_batch((x, y))
        while e.step_num < steps:
            p, s, _ = e.fit_batch(p, s, batch, None)
        e.ckpt.close()
        return p, s, start

    base = os.path.join(OUT_DIR, "dp_tp_resume")
    want = run(base + "-clean", 6)
    run(base + "-cut", 5)
    p, s, start = run(base + "-cut", 6)
    flat = integrity.flatten({"p": p, "s": s})
    equal = [pa == pb and torch.equal(a, b) for (pa, a), (pb, b) in zip(
        flat, integrity.flatten({"p": want[0], "s": want[1]}))]
    return {"start": start, "equal": equal, "leaves": len(flat),
            "W1_shape": tuple(p["W1"].shape)}


def case_ring4_causal(inputs):
    """The causal flash ring at 4 ranks: diagonal, past and future blocks
    all occur."""
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.parallel.mesh import DeviceMesh, P, \
        shard_map
    from deeplearning4j_tpu_torch.parallel.ring_attention import \
        make_ring_attention
    mesh = DeviceMesh(sp=dist.get_world_size())
    spec = P(None, None, "sp", None)
    q, k, v = (_t(a).requires_grad_() for a in qkv(3, (1, 2, 64, 16)))
    f = shard_map(make_ring_attention(mesh, "sp", causal=True,
                                      use_flash=True),
                  mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec)
    o = f(q, k, v)
    return {"out": _np(o), "grads": _grads(o, (q, k, v))}


def case_recipe(inputs):
    """The long-context recipe (examples/long_context_bert.py) on
    bert_tiny: dp 2 × sp 2, T = 64·sp, the flash ring as attn_impl,
    remat, Adam under ZeRO-1, 3 steps."""
    import torch
    from deeplearning4j_tpu_torch.models.bert import (bert_tiny,
                                                      classification_loss,
                                                      sharding_rules)
    from deeplearning4j_tpu_torch.models.convert import params_from_numpy
    from deeplearning4j_tpu_torch.nn import Adam
    from deeplearning4j_tpu_torch.parallel import (DeviceMesh,
                                                   ShardedTrainer,
                                                   make_ring_attention)
    from deeplearning4j_tpu_torch.parallel.mesh import P, shard_map
    from deeplearning4j_tpu_torch.parallel.zero import shard_optimizer_state
    dp, sp = 2, 2
    mesh = DeviceMesh(dp=dp, sp=sp)
    T, B = 64 * sp, 2 * dp
    cfg = bert_tiny(max_position_embeddings=T, remat=True)
    params = params_from_numpy(cfg, inputs["recipe_params"], device="cpu")
    rules = sharding_rules(cfg, mesh, dp="dp", tp=None)
    spec = P(None, None, "sp", None)
    ring = shard_map(make_ring_attention(mesh, "sp", use_flash=True),
                     mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec)

    def loss_fn(p, batch, gen):
        return classification_loss(cfg, p, batch, train=False,
                                   attn_impl=ring)

    tr = ShardedTrainer(loss_fn, Adam(1e-4), mesh, rules)
    p, s = tr.init(params)
    s = shard_optimizer_state(s, mesh, axis="dp")
    ids, labels = inputs["recipe_batch"]
    batch = tr.shard_batch({"input_ids": ids, "labels": labels})
    losses = []
    for _ in range(3):
        p, s, loss = tr.fit_batch(p, s, batch, None)
        losses.append(float(loss))
    from deeplearning4j_tpu_torch.models.convert import params_to_numpy
    return {"losses": losses, "params": params_to_numpy(p)}


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


def _rank_main(rank, world, store_path, out_dir, cases, inputs_path):
    global OUT_DIR
    OUT_DIR = out_dir
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    import faulthandler, sys
    faulthandler.dump_traceback_later(float(os.environ.get("RANK_DUMP_S", "1e9")), exit=True, file=sys.stderr)
    store = dist.FileStore(store_path, world)
    import datetime
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    with open(inputs_path, "rb") as f:
        inputs = pickle.load(f)
    try:
        for name in cases:
            try:
                res = {"ok": CASES[name](inputs)}
            except Exception:   # the test of this contract reports it
                res = {"error": traceback.format_exc()}
            with open(os.path.join(out_dir, f"{name}.{rank}.pkl"),
                      "wb") as f:
                pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def spawn(world, cases, directory, inputs):
    """Run `cases` on `world` gloo ranks; returns {case: [each rank's
    result dict ({"ok": ...} or {"error": traceback})]}."""
    import torch.multiprocessing as mp
    directory = str(directory)
    inputs_path = os.path.join(directory, "inputs.pkl")
    with open(inputs_path, "wb") as f:
        pickle.dump(inputs, f)
    mp.spawn(_rank_main, args=(world, os.path.join(directory, "store"),
                               directory, list(cases), inputs_path),
             nprocs=world, join=True)
    out = {}
    for name in cases:
        out[name] = []
        for r in range(world):
            with open(os.path.join(directory, f"{name}.{r}.pkl"), "rb") as f:
                out[name].append(pickle.load(f))
    return out
