"""The port's SameDiff, its serialization and the TF importer
(`deeplearning4j_tpu_torch/autodiff/`) against the JAX package's, on the
CPU, on the same graphs and carried-across values
(`models.convert.samediff_values_from_numpy`).

- Every op of the graph_serde registry through the fluent API and the
  namespaces: outputs within 1e-5 of max(1, max |JAX|); gradients by
  calculateGradients within 1e-5.
- 3 Adam fit steps: losses and variables within 1e-5.
- Control flow: ifCond / whileLoop / scanLoop / forLoop and their
  serializable *Graph forms, forward and gradient; the while loop's
  gradient against the JAX package's forLoopGraph of the same trip count
  (jax.grad cannot reverse a while_loop).
- Archives: a JAX-written samediff.json loads in the port with the same
  outputs, and the reverse; updater state resumes bit for bit in the port.
- The TF importer: the test_tf_import.py GraphDefs and a two-layer narrow
  frozen BERT (both GELU forms) give the same outputs in both packages;
  the refusals raise in both; the BERT graph equals the port's encoder.
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.autodiff import SameDiff as JSD
from deeplearning4j_tpu.autodiff import TrainingConfig as JTC
from deeplearning4j_tpu.autodiff import importFrozenTF as jimport
from deeplearning4j_tpu.autodiff.tf_import import \
    UnsupportedTFOpError as JUnsupported
from deeplearning4j_tpu.nn.updaters import Adam as JAdam
from deeplearning4j_tpu_torch.autodiff import SameDiff as TSD
from deeplearning4j_tpu_torch.autodiff import TrainingConfig as TTC
from deeplearning4j_tpu_torch.autodiff import importFrozenTF as timport
from deeplearning4j_tpu_torch.autodiff import tfproto
from deeplearning4j_tpu_torch.autodiff.tf_import import \
    UnsupportedTFOpError as TUnsupported
from deeplearning4j_tpu_torch.models.convert import \
    samediff_values_from_numpy
from deeplearning4j_tpu_torch.nn.updaters import Adam as TAdam

import chip_smoke

RTOL = 1e-5


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    assert float(np.abs(got - want).max()) <= rtol * scale, \
        float(np.abs(got - want).max())


def _j(arr):
    return np.asarray(arr.jax())


def _t(arr):
    return arr.tensor.detach().cpu().numpy()


def _both(build):
    """The same graph built in both packages; the port's values carried
    across from the JAX graph's."""
    jsd = JSD.create()
    build(jsd)
    tsd = TSD.create(device="cpu")
    build(tsd)
    samediff_values_from_numpy(
        tsd, {k: np.asarray(v) for k, v in jsd._values.items()})
    return jsd, tsd


rng0 = np.random.default_rng(0)
A = rng0.standard_normal((3, 4)).astype(np.float32)
B = rng0.standard_normal((4, 5)).astype(np.float32)
SPD = (lambda m: m @ m.T + 4 * np.eye(4, dtype=np.float32))(
    rng0.standard_normal((4, 4)).astype(np.float32))
IMG = rng0.standard_normal((2, 7, 7, 3)).astype(np.float32)
KER = rng0.standard_normal((3, 3, 3, 4)).astype(np.float32)


def _ops(sd):
    """One node per registry op; returns the output names."""
    a = sd.placeHolder("a", 3, 4)
    b = sd.var("b", B)
    w = sd.var("w", shape=(4, 4))     # drawn by the graph's RNG
    pos = sd.math.abs(a) + 0.5
    outs = [
        a + 1.0, a - 2.0, a * 3.0, a / 4.0, 1.0 - a, 2.0 / pos, -a,
        a.mmul(b), a.pow(3), a.transpose(), a.reshape(4, 3),
        a.sum(1), a.mean(0, keepdims=True), a.max(), a.min(1), a.std(1),
        a.argmax(1), sd.math.exp(a), sd.math.log(pos), sd.math.sqrt(pos),
        sd.math.square(a), sd.math.sin(a), sd.math.cos(a), sd.math.tanh(a),
        sd.math.sigmoid(a), sd.math.clip(a, -0.5, None), sd.nn.relu(a),
        sd.nn.gelu(a), sd.nn.softmax(a), sd.nn.logSoftmax(a, 0),
        sd.nn.dropout(a, 0.5), sd.nn.linear(a, w, sd.constant(
            np.arange(4, dtype=np.float32))),
        sd.nn.layerNorm(a, sd.constant(np.full(4, 2.0, np.float32)),
                        sd.constant(np.ones(4, np.float32)), eps=1e-3),
        sd.nn.batchNorm(a, *(sd.constant(np.full(4, v, np.float32))
                             for v in (0.1, 2.0, 1.5, -1.0))),
        sd.linalg.cholesky(sd.constant(SPD)), sd.linalg.qr(
            sd.constant(SPD)), sd.linalg.svd(sd.constant(SPD)),
        sd.linalg.solve(sd.constant(SPD), sd.constant(B)),
        sd.cnn.conv2d(sd.constant(IMG), sd.constant(KER),
                      sd.constant(np.ones(4, np.float32)), stride=2),
        sd.cnn.conv2d(sd.constant(IMG), sd.constant(KER),
                      padding=[[1, 0], [2, 1]], dilation=2),
        sd.cnn.maxPooling2d(sd.constant(IMG), 3, 2, "SAME"),
        sd.cnn.avgPooling2d(sd.constant(IMG), 3, 2, "SAME"),
        sd.cnn.avgPooling2d(sd.constant(IMG), 2, 2),
        sd.cnn.upsampling2d(sd.constant(IMG), 2),
    ]
    y = sd.placeHolder("y", 3, 4)
    outs += [sd.loss.softmaxCrossEntropy("xent", y, a),
             sd.loss.sigmoidCrossEntropy("sxent", y, a),
             sd.loss.meanSquaredError("mse", y, a), sd.loss.l2Loss("l2", a)]
    return [o.name for o in outs]


def test_every_registry_op_matches_the_jax_package():
    names = {}

    def build(sd):
        names[id(sd)] = _ops(sd)

    jsd, tsd = _both(build)
    assert names[id(jsd)] == names[id(tsd)]
    y = np.abs(rng0.standard_normal((3, 4))).astype(np.float32)
    y /= y.sum(1, keepdims=True)
    feeds = {"a": A, "y": y}
    want = jsd.output(feeds, names[id(jsd)])
    got = tsd.output(feeds, names[id(tsd)])
    for n in names[id(jsd)]:
        if n.startswith("qr"):   # Q is unique up to column signs
            _close(np.abs(_t(got[n])), np.abs(_j(want[n])))
        else:
            _close(_t(got[n]), _j(want[n]))
    assert tsd.summary().splitlines()[-1] == jsd.summary().splitlines()[-1]


def test_random_ops_repeat_per_node_and_survive_a_roundtrip(tmp_path):
    sd = TSD.create(device="cpu")
    n = sd.random.normal(1.0, 2.0, 3, 4)
    u = sd.random.uniform(-1.0, 1.0, 5)
    b = sd.random.bernoulli(0.3, 6)
    first = {k: _t(v) for k, v in sd.output({}, [n.name, u.name,
                                                  b.name]).items()}
    again = sd.output({}, [n.name, u.name, b.name])
    for k, v in again.items():
        np.testing.assert_array_equal(_t(v), first[k])
    assert first[u.name].min() >= -1 and first[u.name].max() <= 1
    assert set(np.unique(first[b.name])) <= {0.0, 1.0}
    sd.save(str(tmp_path / "r.sdz"))
    back = TSD.load(str(tmp_path / "r.sdz"), device="cpu")
    for k, v in back.output({}, list(first)).items():
        np.testing.assert_array_equal(_t(v), first[k])


def _regression(sd, adam):
    x = sd.placeHolder("x", None, 4)
    y = sd.placeHolder("y", None, 3)
    w = sd.var("w", shape=(4, 3))
    bias = sd.var("bias", np.zeros(3, np.float32))
    h = sd.nn.tanh(x.mmul(w) + bias)
    sd.loss.meanSquaredError("loss", y, h)
    sd.setLossVariables("loss")
    sd.setTrainingConfig(adam)


def test_gradients_and_three_adam_steps_match_the_jax_package():
    jsd, tsd = JSD.create(), TSD.create(device="cpu")
    _regression(jsd, JTC.Builder().updater(JAdam(0.05)).l2(1e-3)
                .dataSetFeatureMapping("x").dataSetLabelMapping("y").build())
    _regression(tsd, TTC.Builder().updater(TAdam(0.05)).l2(1e-3)
                .dataSetFeatureMapping("x").dataSetLabelMapping("y").build())
    samediff_values_from_numpy(
        tsd, {k: np.asarray(v) for k, v in jsd._values.items()})
    rng = np.random.default_rng(1)
    x = rng.standard_normal((16, 4)).astype(np.float32)
    y = np.tanh(x @ rng.standard_normal((4, 3))).astype(np.float32)
    gj = jsd.calculateGradients({"x": x, "y": y}, "w", "bias")
    gt = tsd.calculateGradients({"x": x, "y": y}, "w", "bias")
    for k in ("w", "bias"):
        _close(_t(gt[k]), _j(gj[k]))
    lj = [jsd.fit(x, y) for _ in range(3)]
    lt = [tsd.fit(x, y) for _ in range(3)]
    np.testing.assert_allclose(lt, lj, rtol=RTOL)
    for k, v in jsd._values.items():
        _close(tsd._values[k].numpy(), np.asarray(v))


def test_saved_updater_state_resumes_bit_for_bit(tmp_path):
    def make():
        sd = TSD.create(device="cpu")
        _regression(sd, TTC.Builder().updater(TAdam(0.05))
                    .dataSetFeatureMapping("x").dataSetLabelMapping("y")
                    .build())
        return sd
    rng = np.random.default_rng(2)
    x = rng.standard_normal((8, 4)).astype(np.float32)
    y = rng.standard_normal((8, 3)).astype(np.float32)
    sd = make()
    for _ in range(2):
        sd.fit(x, y)
    sd.save(str(tmp_path / "a.sdz"), save_updater=True)
    sd.save(str(tmp_path / "v.sdz"), save_updater=True, values_only=True)
    back = TSD.load(str(tmp_path / "a.sdz"), device="cpu")
    fresh = make().load_values(str(tmp_path / "v.sdz"))
    want = [sd.fit(x, y) for _ in range(2)]
    assert [back.fit(x, y) for _ in range(2)] == want
    assert [fresh.fit(x, y) for _ in range(2)] == want
    for k, v in sd._values.items():
        assert torch.equal(back._values[k], v)


# -- control flow ---------------------------------------------------------------
def _sub_graph(mod, build):
    sd = mod.create() if mod is JSD else mod.create(device="cpu")
    build(sd)
    return sd


def _cond_graph(mod):
    return _sub_graph(mod, lambda sd: (lambda n: n.sub(5.0).mul(-1.0)
                                       .rename("keep"))(
        sd.placeHolder("n")))


def _body_graph(mod):
    def build(sd):
        n, acc = sd.placeHolder("n"), sd.placeHolder("acc")
        (n + 1.0).rename("n2")
        (acc * 1.5 + n).rename("acc2")
    return _sub_graph(mod, build)


def _flow(sd, mod, x_is_var):
    """Every control-flow form over placeholder/variable x (shape (3,))."""
    x = sd.var("x", np.asarray([0.5, -1.0, 2.0], np.float32)) \
        if x_is_var else sd.placeHolder("x", 3)
    p = sd.placeHolder("p", 1)
    lib = np if mod is None else None
    outs = {}
    outs["if"] = sd.ifCond("br", p, [x], lambda a: a * 2.0,
                           lambda a: a - 1.0)
    outs["while"] = sd.whileLoop(
        "w", [x], lambda v: (v.sum() < 40.0), lambda v: (v * 2.0 + 1.0,))[0]
    carry, ys = sd.scanLoop("s", sd.constant("c0", np.float32(0.0)), x,
                            lambda c, v: (c + v, c * v))
    outs["scan_c"], outs["scan_y"] = carry, ys
    outs["for"] = sd.forLoop("f", 3, [x], lambda i, v: (v * v * 0.5 + i,))[0]
    # serializable forms
    tb = _sub_graph(type(sd), lambda s: (s.placeHolder("a") * 2.0)
                    .rename("r"))
    fb = _sub_graph(type(sd), lambda s: (s.placeHolder("a") - 1.0)
                    .rename("r"))
    outs["ifg"] = sd.ifCondGraph("brg", p, [x], ["a"], tb, fb, "r")
    n0 = sd.constant("n0", np.float32(0.0))
    outs["whileg"] = sd.whileLoopGraph(
        "wg", [n0, x.sum()], ["n", "acc"], _cond_graph(type(sd)), "keep",
        _body_graph(type(sd)), ["n2", "acc2"])[1]

    def scan_body(s):
        c, v = s.placeHolder("c"), s.placeHolder("v")
        (c + v).rename("c2")
        (c * v).rename("y")
    carry_g, ys_g = sd.scanLoopGraph("sg", sd.constant("c1", np.float32(1.0)),
                                     x, _sub_graph(type(sd), scan_body),
                                     "c", "v", "c2", "y")
    outs["scang_c"], outs["scang_y"] = carry_g, ys_g

    def for_body(s):
        (s.placeHolder("v") * 0.5 + s.placeHolder("i")).rename("v2")
    outs["forg"] = sd.forLoopGraph("fg", 4, [x], ["v"],
                                   _sub_graph(type(sd), for_body), ["v2"])[0]
    return {k: v.name for k, v in outs.items()}


@pytest.mark.parametrize("pred", [1.0, 0.0])
def test_control_flow_forms_match_the_jax_package(pred):
    jsd, tsd = JSD.create(), TSD.create(device="cpu")
    names = _flow(jsd, JSD, False)
    assert _flow(tsd, TSD, False) == names
    x = np.asarray([0.5, -1.0, 2.0], np.float32)
    feeds = {"x": x, "p": np.asarray([pred], np.float32)}
    want = jsd.output(feeds, list(names.values()))
    got = tsd.output(feeds, list(names.values()))
    for k, n in names.items():
        _close(_t(got[n]), _j(want[n]))


def test_control_flow_gradients_and_the_while_gradient():
    """Gradients through every form (the variable x feeds each) equal the
    JAX package's; the while loops' gradients (jax.grad cannot reverse
    lax.while_loop) equal those of JAX for-loops of the trip count the
    port's loop took."""
    def with_loss(mod, forms):
        sd = mod.create() if mod is JSD else mod.create(device="cpu")
        names = _flow(sd, mod, True)
        parts = [sd.getVariable(names[f]).sum() for f in forms]
        total = parts[0]
        for q in parts[1:]:
            total = total + q
        total.rename("loss")
        sd.setLossVariables("loss")
        return sd
    feeds = {"p": np.asarray([1.0], np.float32)}
    forms = ["if", "scan_c", "scan_y", "for", "ifg", "scang_c", "scang_y",
             "forg"]
    want = with_loss(JSD, forms).calculateGradients(feeds, "x")["x"]
    got = with_loss(TSD, forms).calculateGradients(feeds, "x")["x"]
    _close(_t(got), _j(want))
    # the while loop: x -> 2x + 1 while sum < 40; from sum 1.5 it runs 4
    # trips, so d(final)/dx = 2**4 per element
    tsd = with_loss(TSD, ["while"])
    g = _t(tsd.calculateGradients(feeds, "x")["x"])
    jsd = JSD.create()
    x = jsd.var("x", np.asarray([0.5, -1.0, 2.0], np.float32))
    jsd.forLoop("f4", 4, [x], lambda i, v: (v * 2.0 + 1.0,))[0].sum() \
        .rename("loss")
    jsd.setLossVariables("loss")
    _close(g, _j(jsd.calculateGradients({}, "x")["x"]))
    np.testing.assert_array_equal(g, np.full(3, 16.0, np.float32))
    # the serializable while (acc -> 1.5 acc + n, n = 0..4): 1.5**5 per x
    tsd = with_loss(TSD, ["whileg"])
    np.testing.assert_allclose(_t(tsd.calculateGradients(feeds, "x")["x"]),
                               np.full(3, 1.5 ** 5), rtol=1e-6)


# -- archives across the two packages ----------------------------------------
def _archive_graph(sd):
    x = sd.placeHolder("x", None, 7, 7, 3)
    h = sd.cnn.conv2d(x, sd.var("k", KER), sd.var("kb", np.zeros(
        4, np.float32)), stride=1)
    h = sd.cnn.maxPooling2d(sd.nn.relu(h), 2, 2, "SAME")
    h = h.reshape(-1, 64)
    out = sd.nn.softmax(h.mmul(sd.var("w", shape=(64, 5))))
    out.rename("probs")
    p = sd.placeHolder("p", 1)
    tb = _sub_graph(type(sd), lambda s: (s.placeHolder("a") * 2.0)
                    .rename("r"))
    fb = _sub_graph(type(sd), lambda s: (s.placeHolder("a") - 1.0)
                    .rename("r"))
    sd.ifCondGraph("branch", p, [out], ["a"], tb, fb, "r")
    sd.math.clip(out, None, 0.3).rename("clipped")
    tc = JTC if isinstance(sd, JSD) else TTC
    ad = JAdam if isinstance(sd, JSD) else TAdam
    sd.setTrainingConfig(tc.Builder().updater(ad(1e-3)).l1(1e-4)
                         .dataSetFeatureMapping("x").build())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_loads_the_others_archive(tmp_path, writer):
    jsd, tsd = _both(_archive_graph)
    path = str(tmp_path / f"{writer}.sdz")
    (jsd if writer == "jax" else tsd).save(path)
    back = TSD.load(path, device="cpu") if writer == "jax" else \
        JSD.load(path)
    x = np.random.default_rng(5).standard_normal(
        (2, 7, 7, 3)).astype(np.float32)
    outs = ["probs", "branch", "clipped"]
    feeds = {"x": x, "p": np.asarray([0.0], np.float32)}
    want = jsd.output(feeds, outs)
    got = back.output(feeds, outs)
    for n in outs:
        g = _t(got[n]) if writer == "jax" else _j(got[n])
        _close(g, _j(want[n]))
    tc = back._training_config
    assert type(tc.updater).__name__ == "Adam" and tc.l1 == 1e-4
    assert tc.dataSetFeatureMapping == ["x"]


@pytest.mark.parametrize("values_only", [False, True])
def test_port_archive_stores_its_values(tmp_path, values_only):
    """The values entry is stored, the graph's JSON deflated; the JAX
    package loads the whole archive."""
    import zipfile
    jsd, tsd = _both(_archive_graph)
    path = str(tmp_path / "port.sdz")
    tsd.save(path, values_only=values_only)
    with zipfile.ZipFile(path) as zf:
        kinds = {i.filename: i.compress_type for i in zf.infolist()}
    want = {"values.npz": zipfile.ZIP_STORED}
    if not values_only:
        want["samediff.json"] = zipfile.ZIP_DEFLATED
    assert kinds == want, kinds
    if not values_only:
        back = JSD.load(path)
        for k, v in tsd._values.items():
            np.testing.assert_array_equal(np.asarray(back._values[k]),
                                          v.numpy())


def test_model_guesser_loads_either_packages_samediff_archive(tmp_path):
    from deeplearning4j_tpu_torch.util.model_guesser import ModelGuesser
    jsd, _ = _both(_archive_graph)
    path = str(tmp_path / "g.zip")
    jsd.save(path)
    got = ModelGuesser.loadModelGuess(path, device="cpu")
    assert isinstance(got, TSD)
    x = np.zeros((1, 7, 7, 3), np.float32)
    _close(_t(got.outputSingle({"x": x}, "probs")),
           _j(jsd.outputSingle({"x": x}, "probs")))


def test_non_serializable_graphs_refuse_and_values_only_restores(tmp_path):
    sd = TSD.create(device="cpu")
    a = sd.var("a", np.ones(2, np.float32))
    out = sd.forLoop("loop", 3, [a], lambda i, t: (t * 2,))[0]
    with pytest.raises(ValueError, match="not serializable"):
        sd.save(str(tmp_path / "x.sdz"))
    sd.save(str(tmp_path / "v.sdz"), values_only=True)
    again = TSD.create(device="cpu")
    again.var("a", np.zeros(2, np.float32))
    out2 = again.forLoop("loop", 3, [again.getVariable("a")],
                         lambda i, t: (t * 2,))[0]
    again.load_values(str(tmp_path / "v.sdz"))
    np.testing.assert_array_equal(_t(again.outputSingle({}, out2.name)),
                                  _t(sd.outputSingle({}, out.name)))


# -- the TF importer -------------------------------------------------------------
def _c(v, dtype=np.float32):
    return {"value": np.asarray(v, dtype)}


r = np.random.default_rng(3)
GRAPHDEFS = {
    "mlp": ([("input", "Placeholder", [], {}),
             ("w1", "Const", [], _c(r.normal(size=(4, 8)))),
             ("b1", "Const", [], _c(r.normal(size=(8,)))),
             ("w2", "Const", [], _c(r.normal(size=(8, 3)))),
             ("mm1", "MatMul", ["input", "w1"], {}),
             ("ba1", "BiasAdd", ["mm1", "b1"], {}),
             ("act1", "Relu", ["ba1"], {}),
             ("mm2", "MatMul", ["act1", "w2"], {"transpose_a": False}),
             ("probs", "Softmax", ["mm2"], {})],
            {"input": r.normal(size=(5, 4))}, "probs"),
    "layernorm_erf_gelu": ([
        ("x", "Placeholder", [], {}),
        ("axes", "Const", [], _c([-1], np.int32)),
        ("mu", "Mean", ["x", "axes"], {"keep_dims": True}),
        ("d", "SquaredDifference", ["x", "mu"], {}),
        ("var", "Mean", ["d", "axes"], {"keep_dims": True}),
        ("eps", "Const", [], _c(1e-5)),
        ("vpe", "AddV2", ["var", "eps"], {}),
        ("rstd", "Rsqrt", ["vpe"], {}),
        ("cen", "Sub", ["x", "mu"], {}),
        ("nrm", "Mul", ["cen", "rstd"], {}),
        ("h", "Const", [], _c(0.5)), ("s2", "Const", [], _c(0.7071)),
        ("xs", "Mul", ["nrm", "s2"], {}), ("erf", "Erf", ["xs"], {}),
        ("one", "Const", [], _c(1.0)), ("e1", "AddV2", ["erf", "one"], {}),
        ("xh", "Mul", ["nrm", "h"], {}),
        ("gelu", "Mul", ["xh", "e1"], {})],
        {"x": r.normal(size=(3, 6))}, "gelu"),
    "gather_transpose_concat": ([
        ("ids", "Placeholder", [], {}),
        ("table", "Const", [], _c(np.arange(20).reshape(5, 4))),
        ("ax0", "Const", [], _c(0, np.int32)),
        ("emb", "GatherV2", ["table", "ids", "ax0"], {}),
        ("perm", "Const", [], _c([0, 2, 1], np.int32)),
        ("t", "Transpose", ["emb", "perm"], {}),
        ("shp", "Const", [], _c([2, 8], np.int32)),
        ("rs", "Reshape", ["t", "shp"], {}),
        ("axis", "Const", [], _c(1, np.int32)),
        ("cat", "ConcatV2", ["rs", "rs", "axis"], {})],
        {"ids": np.asarray([[0, 3], [2, 4]], np.int32)}, "cat"),
    "conv_bn_pool": ([
        ("x", "Placeholder", [], {}),
        ("w", "Const", [], _c(r.normal(size=(3, 3, 2, 4)))),
        ("g", "Const", [], _c(r.normal(size=4))),
        ("b", "Const", [], _c(r.normal(size=4))),
        ("m", "Const", [], _c(r.normal(size=4))),
        ("v", "Const", [], _c(np.abs(r.normal(size=4)) + 0.5)),
        ("conv", "Conv2D", ["x", "w"], {"strides": [1, 2, 2, 1],
                                        "padding": "SAME"}),
        ("bn", "FusedBatchNormV3", ["conv", "g", "b", "m", "v"],
         {"epsilon": 1e-3}),
        ("act", "Relu6", ["bn"], {}),
        ("pool", "MaxPool", ["act"], {"ksize": [1, 3, 3, 1],
                                      "strides": [1, 2, 2, 1],
                                      "padding": "SAME"})],
        {"x": r.normal(size=(2, 9, 9, 2))}, "pool"),
    "depthwise_avgpool_pad": ([
        ("x", "Placeholder", [], {}),
        ("w", "Const", [], _c(r.normal(size=(3, 3, 2, 2)))),
        ("dw", "DepthwiseConv2dNative", ["x", "w"],
         {"strides": [1, 1, 1, 1], "padding": "SAME"}),
        ("ap", "AvgPool", ["dw"], {"ksize": [1, 3, 3, 1],
                                   "strides": [1, 2, 2, 1],
                                   "padding": "SAME"}),
        ("p", "Const", [], _c([[0, 0], [1, 2], [0, 1], [0, 0]], np.int32)),
        ("cv", "Const", [], _c(0.25)),
        ("out", "PadV2", ["ap", "p", "cv"], {})],
        {"x": r.normal(size=(1, 5, 5, 2))}, "out"),
    "explicit_padding_conv": ([
        ("x", "Placeholder", [], {}),
        ("w", "Const", [], _c(r.normal(size=(2, 2, 1, 3)))),
        ("conv", "Conv2D", ["x", "w"],
         {"strides": [1, 1, 1, 1], "padding": "EXPLICIT",
          "explicit_paddings": [0, 0, 1, 0, 2, 0, 0, 0],
          "dilations": [1, 2, 1, 1]})],
        {"x": r.normal(size=(1, 4, 4, 1))}, "conv"),
    "bn_default_eps_concat_v1": ([
        ("x", "Placeholder", [], {}),
        ("g", "Const", [], _c([1.2, 0.7])), ("b", "Const", [], _c([0.1, 0])),
        ("m", "Const", [], _c([0.3, -0.2])),
        ("v", "Const", [], _c([1e-4, 2e-4])),
        ("bn", "FusedBatchNorm", ["x", "g", "b", "m", "v"], {}),
        ("axis", "Const", [], _c(3, np.int32)),
        ("cat", "Concat", ["axis", "bn", "x"], {})],
        {"x": r.normal(size=(2, 3, 3, 2))}, "cat"),
    "split_unpack_addn": ([
        ("x", "Placeholder", [], {}),
        ("axis", "Const", [], _c(1, np.int32)),
        ("split", "Split", ["axis", "x"], {"num_split": 2}),
        ("sizes", "Const", [], _c([1, 3], np.int32)),
        ("sv", "SplitV", ["x", "sizes", "axis"], {}),
        ("u", "Unpack", ["split:1"], {"axis": 0, "num": 2}),
        ("s", "AddN", ["u", "u:1", "sv:1"], {}),
        ("l", "LeakyRelu", ["s"], {"alpha": 0.1}),
        ("y", "Softplus", ["l"], {})],
        {"x": r.normal(size=(2, 6))}, "y"),
    "shape_ops": ([
        ("x", "Placeholder", [], {}),
        ("ax", "Const", [], _c(-1, np.int32)),
        ("e", "ExpandDims", ["x", "ax"], {}),
        ("reps", "Const", [], _c([1, 2, 3], np.int32)),
        ("t", "Tile", ["e", "reps"], {}),
        ("b", "Const", [], _c([0, 1, 0], np.int32)),
        ("en", "Const", [], _c([0, 4, 3], np.int32)),
        ("st", "Const", [], _c([1, 2, 2], np.int32)),
        ("ss", "StridedSlice", ["t", "b", "en", "st"],
         {"begin_mask": 1, "end_mask": 1}),
        ("rb", "Const", [], _c([0, 0, 0], np.int32)),
        ("re", "Const", [], _c([0, 0, 0], np.int32)),
        ("rs", "Const", [], _c([1, -1, 1], np.int32)),
        ("rev", "StridedSlice", ["ss", "rb", "re", "rs"],
         {"begin_mask": 7, "end_mask": 7}),
        ("sq", "Squeeze", ["e"], {"squeeze_dims": [-1]}),
        ("pk", "Pack", ["sq", "sq"], {"axis": 1}),
        ("mx", "Max", ["pk", "ax"], {}),
        ("mn", "Min", ["pk", "ax"], {}),
        ("sm", "Sum", ["rev", "ax"], {}),
        ("ci", "Cast", ["mx"], {"DstT": ("dtype", tfproto.DT_INT32)}),
        ("ca", "Cast", ["ci"], {"DstT": ("dtype", tfproto.DT_FLOAT)}),
        ("mm", "Maximum", ["ca", "mn"], {}),
        ("out", "AddV2", ["mm", "sm"], {})],
        {"x": r.normal(size=(3, 4)) * 3}, "out"),
    "one_hot_shape": ([
        ("i", "Placeholder", [], {}),
        ("depth", "Const", [], _c(5, np.int32)),
        ("oh", "OneHot", ["i", "depth"], {}),
        ("shp", "Shape", ["oh"], {}),
        ("f", "Cast", ["shp"], {"DstT": ("dtype", tfproto.DT_FLOAT)}),
        ("ohs", "Sum", ["oh", "axes"], {}),
        ("axes", "Const", [], _c([0], np.int32)),
        ("out", "ConcatV2", ["ohs", "f", "zero"], {}),
        ("zero", "Const", [], _c(0, np.int32))],
        {"i": np.asarray([0, 4, 2, 2], np.int32)}, "out"),
}


def _graphdef(nodes):
    return tfproto.encode_graphdef(nodes)


@pytest.mark.parametrize("case", sorted(GRAPHDEFS))
def test_tf_graphdefs_give_the_same_outputs_in_both_packages(case):
    nodes, feeds, out = GRAPHDEFS[case]
    nodes = [n for n in nodes if n[1] == "Const"] + \
        [n for n in nodes if n[1] != "Const"]
    data = _graphdef(nodes)
    feeds = {k: np.asarray(v, np.float32 if np.asarray(v).dtype.kind == "f"
                           else np.int32) for k, v in feeds.items()}
    want = _j(jimport(data).outputSingle(feeds, out))
    got = _t(timport(data, device="cpu").outputSingle(feeds, out))
    _close(got, want)


@pytest.mark.parametrize("nodes,match", [
    ([("x", "Placeholder", [], {}), ("y", "SomeExoticOp", ["x"], {})],
     "SomeExoticOp"),
    ([("x", "Placeholder", [], {}), ("w", "Const", [], _c(np.zeros(
        (1, 1, 1, 1)))), ("c", "Conv2D", ["x", "w"], {
            "strides": [1, 1, 1, 1], "padding": "SAME",
            "data_format": "NCHW"})], "NHWC"),
    ([("x", "Placeholder", [], {})] + [(k, "Const", [], _c(np.zeros(1)))
                                       for k in "gbmv"]
     + [("bn", "FusedBatchNormV3", ["x", "g", "b", "m", "v"],
         {"is_training": True})], "is_training"),
    ([("x", "Placeholder", [], {}), ("w", "Const", [], _c(np.ones(
        (2, 2, 1, 1)))), ("c", "Conv2D", ["x", "w"], {
            "strides": [1, 1, 1, 1], "padding": "EXPLICIT",
            "explicit_paddings": [1, 0, 1, 0, 2, 0, 0, 0]})],
     "batch/channel"),
], ids=["unknown_op", "nchw", "training_bn", "batch_padding"])
def test_tf_refusals_raise_in_both_packages(nodes, match):
    data = _graphdef(nodes)
    with pytest.raises(JUnsupported, match=match):
        jimport(data)
    with pytest.raises(TUnsupported, match=match):
        timport(data, device="cpu")


@pytest.fixture(scope="module")
def narrow_bert():
    from deeplearning4j_tpu_torch.models import bert_base, init_bert_params
    cfg = bert_base(num_layers=2, hidden_size=64, num_heads=4,
                    intermediate_size=128, vocab_size=97,
                    max_position_embeddings=32)
    return cfg, init_bert_params(cfg, seed=4, device="cpu")


@pytest.mark.parametrize("gelu", ["tanh", "erf"])
def test_narrow_frozen_bert_in_both_packages_and_against_the_encoder(
        narrow_bert, gelu):
    """The chip run's frozen-BERT GraphDef builder at 2 layers, width 64:
    both importers agree (1e-5); with BERT's tanh GELU the graph's last
    hidden states equal the port's encoder on the same parameters
    (1e-5), and a fit step of its classification head runs."""
    cfg, params = narrow_bert
    b, t = 3, 16
    data = chip_smoke.frozen_bert_graphdef(cfg, params, b, t, gelu=gelu)
    rng = np.random.default_rng(6)
    mask = np.ones((b, t), np.float32)
    mask[1, 9:] = 0.0
    feeds = {"input_ids": rng.integers(0, cfg.vocab_size, (b, t))
             .astype(np.int32),
             "token_type_ids": rng.integers(0, 2, (b, t)).astype(np.int32),
             "input_mask": mask}
    outs = [chip_smoke.SEQUENCE_OUTPUT, "logits"]
    jsd, tsd = jimport(data), timport(data, device="cpu")
    want, got = jsd.output(feeds, outs), tsd.output(feeds, outs)
    for n in outs:
        _close(_t(got[n]), _j(want[n]))
    if gelu == "tanh":
        from deeplearning4j_tpu_torch.models import bert_encode
        enc = bert_encode(cfg, params, torch.as_tensor(
            feeds["input_ids"]).long(), torch.as_tensor(
            feeds["token_type_ids"]).long(),
            attn_mask=torch.as_tensor(mask)).numpy()
        _close(_t(got[chip_smoke.SEQUENCE_OUTPUT]), enc)
        tsd.convertConstantsToVariables("output/kernel", "output/bias")
        labels = tsd.placeHolder("labels", None, cfg.num_labels)
        tsd.loss.softmaxCrossEntropy("loss", labels,
                                     tsd.getVariable("logits"))
        tsd.setLossVariables("loss")
        tsd.setTrainingConfig(TTC.Builder().updater(TAdam(1e-3)).build())
        y = np.eye(cfg.num_labels, dtype=np.float32)[[0, 1, 1]]
        losses = [tsd.fit(placeholders=dict(feeds, labels=y))
                  for _ in range(3)]
        assert np.isfinite(losses).all() and losses[-1] < losses[0]
