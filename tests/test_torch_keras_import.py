"""The port's Keras importer (`deeplearning4j_tpu_torch/keras_import/`)
against the JAX package's, on the CPU.

- The reference test_keras_import.py configurations (Sequential and
  Functional: dense, CNN with BN, merges, depthwise/cropping/upsampling,
  recurrent and bidirectional, masking, 1-D and 3-D convolutions, the
  advanced activations, the transposed and locally connected
  convolutions, Permute, separable convolutions) are imported by both
  packages; the JAX network's parameters carry into the port's
  (`nn/convert.py`) and the outputs agree within 1e-5 of max(1, max |JAX|).
- Keras .h5 weights (Keras's own names and layouts, written with h5py):
  both packages read the same file, parameters and BN statistics equal
  exactly, outputs within 1e-5.
- A narrow Keras MobileNetV2 (alpha 0.35, 32×32, the first 4 blocks), the
  model the chip run imports at full width: the layer graph, the pair
  count of the conv1x1+BN fusion, .h5 weights through both packages, and
  the fused forward against the unfused one.
- ModelGuesser's Keras branch (a whole-model .h5 with its
  `model_config`, and a JSON file) and `ZooModel.initPretrained(.h5)`.
"""
import copy
import json

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.keras_import import KerasModelImport as JK
from deeplearning4j_tpu_torch.keras_import import (
    InvalidKerasConfigurationException, KerasModelImport as TK)
from deeplearning4j_tpu_torch.nn import (graph_params_from_numpy,
                                         graph_params_to_numpy,
                                         multilayer_params_from_numpy)

import chip_smoke

RTOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _seq(layers, input_shape):
    return {"class_name": "Sequential", "config": {"layers": [
        {"class_name": "InputLayer",
         "config": {"batch_input_shape": [None] + list(input_shape)}}]
        + layers}}


def _dense(units, act="softmax", **kw):
    return {"class_name": "Dense",
            "config": {"units": units, "activation": act, **kw}}


def _functional(layers, inputs, outputs):
    return {"class_name": "Functional", "config": {
        "name": "f", "layers": layers,
        "input_layers": [[i, 0, 0] for i in inputs],
        "output_layers": [[o, 0, 0] for o in outputs]}}


def _node(cls, name, cfg, *inbound):
    return {"class_name": cls, "config": dict(cfg, name=name),
            "inbound_nodes": [[[i, 0, 0, {}] for i in inbound]]
            if inbound else []}


CASES = {
    "mlp": (_seq([_dense(32, "relu", name="fc1"),
                  {"class_name": "Dropout", "config": {"rate": 0.2}},
                  _dense(3, name="out")], [10]), (4, 10)),
    "cnn_bn": (_seq([
        {"class_name": "Conv2D", "config": {
            "filters": 8, "kernel_size": [3, 3], "strides": [1, 1],
            "padding": "same", "activation": "relu"}},
        {"class_name": "BatchNormalization", "config": {
            "epsilon": 1e-3, "momentum": 0.99}},
        {"class_name": "MaxPooling2D", "config": {
            "pool_size": [2, 2], "strides": [2, 2], "padding": "valid"}},
        {"class_name": "Flatten", "config": {}}, _dense(10)],
        [12, 12, 1]), (2, 12, 12, 1)),
    "two_branch_add": (_functional([
        _node("InputLayer", "in", {"batch_input_shape": [None, 8]}),
        _node("Dense", "a", {"units": 16, "activation": "relu"}, "in"),
        _node("Dense", "b", {"units": 16, "activation": "relu"}, "in"),
        _node("Add", "add", {}, "a", "b"),
        _node("Dense", "out", {"units": 4, "activation": "softmax"}, "add")],
        ["in"], ["out"]), (3, 8)),
    "concat_min_sub": (_functional([
        _node("InputLayer", "in", {"batch_input_shape": [None, 6]}),
        _node("Dense", "a", {"units": 5, "activation": "tanh"}, "in"),
        _node("Dense", "b", {"units": 5, "activation": "sigmoid"}, "in"),
        _node("Minimum", "mn", {}, "a", "b"),
        _node("Subtract", "sb", {}, "a", "b"),
        _node("Concatenate", "cat", {"axis": -1}, "mn", "sb"),
        _node("Dense", "out", {"units": 3, "activation": "softmax"}, "cat")],
        ["in"], ["out"]), (3, 6)),
    "depthwise_crop_up": (_seq([
        {"class_name": "DepthwiseConv2D", "config": {
            "kernel_size": [3, 3], "depth_multiplier": 2, "padding": "same",
            "activation": "relu"}},
        {"class_name": "Cropping2D", "config": {"cropping": [[1, 1],
                                                             [2, 2]]}},
        {"class_name": "UpSampling2D", "config": {"size": [2, 2]}},
        {"class_name": "Flatten", "config": {}}, _dense(4)],
        [8, 8, 3]), (2, 8, 8, 3)),
    "separable_pad_gap": (_seq([
        {"class_name": "ZeroPadding2D", "config": {"padding": [1, 1]}},
        {"class_name": "SeparableConv2D", "config": {
            "filters": 6, "kernel_size": [3, 3], "strides": [2, 2],
            "padding": "valid", "activation": "relu"}},
        {"class_name": "GlobalAveragePooling2D", "config": {}},
        _dense(3)], [9, 9, 2]), (2, 9, 9, 2)),
    "lstm_rnn_timedistributed": (_seq([
        {"class_name": "LSTM", "config": {"units": 6,
                                          "return_sequences": True}},
        {"class_name": "SimpleRNN", "config": {"units": 5,
                                               "activation": "tanh"}},
        {"class_name": "TimeDistributed", "config": {
            "layer": _dense(3, "softmax")}}], [7, 4]), (2, 7, 4)),
    "bidirectional_masking": (_seq([
        {"class_name": "Masking", "config": {"mask_value": 0.0}},
        {"class_name": "Bidirectional", "config": {
            "merge_mode": "concat", "layer": {
                "class_name": "LSTM", "config": {"units": 6,
                                                 "activation": "tanh"}}}},
        _dense(3)], [10, 4]), (2, 10, 4)),
    "conv1d_pool1d": (_seq([
        {"class_name": "Conv1D", "config": {
            "filters": 8, "kernel_size": [3], "padding": "same",
            "activation": "relu"}},
        {"class_name": "MaxPooling1D", "config": {"pool_size": [2]}},
        {"class_name": "GlobalAveragePooling1D", "config": {}},
        _dense(2)], [12, 4]), (2, 12, 4)),
    "conv3d_pool3d": (_seq([
        {"class_name": "Conv3D", "config": {
            "filters": 4, "kernel_size": [3, 3, 3], "padding": "same",
            "activation": "relu"}},
        {"class_name": "MaxPooling3D", "config": {"pool_size": [2, 2, 2]}},
        {"class_name": "Flatten", "config": {}}, _dense(2)],
        [4, 6, 6, 2]), (2, 4, 6, 6, 2)),
    "advanced_activations": (_seq([
        _dense(6, "linear"), {"class_name": "LeakyReLU",
                              "config": {"alpha": 0.3}},
        {"class_name": "ReLU", "config": {"max_value": 6.0}},
        {"class_name": "ELU", "config": {}},
        {"class_name": "ThresholdedReLU", "config": {"theta": 0.2}},
        {"class_name": "PReLU", "config": {}},
        _dense(2)], [5]), (3, 5)),
    "conv2d_transpose": (_seq([
        {"class_name": "Conv2DTranspose", "config": {
            "filters": 3, "kernel_size": [3, 3], "strides": [2, 2],
            "padding": "same", "activation": "relu"}},
        {"class_name": "Flatten", "config": {}}, _dense(2)],
        [5, 5, 2]), (2, 5, 5, 2)),
    "locally_connected": (_seq([
        {"class_name": "LocallyConnected2D", "config": {
            "filters": 5, "kernel_size": [3, 3], "strides": [1, 1],
            "padding": "valid", "activation": "relu"}},
        {"class_name": "Flatten", "config": {}}, _dense(2)],
        [7, 7, 2]), (2, 7, 7, 2)),
    "locally_connected_1d": (_seq([
        {"class_name": "LocallyConnected1D", "config": {
            "filters": 6, "kernel_size": [3], "activation": "tanh"}},
        {"class_name": "GlobalAveragePooling1D", "config": {}},
        _dense(2)], [9, 4]), (2, 9, 4)),
    "permute": (_seq([
        {"class_name": "Permute", "config": {"dims": [2, 1]}},
        {"class_name": "Flatten", "config": {}}, _dense(3)],
        [4, 6]), (2, 4, 6)),
}


def _inputs(shape, case, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if case == "bidirectional_masking":
        x[1, 7:] = 0.0       # a padded tail the mask must skip
    return x


def _import(mod, cfg, **kw):
    js = json.dumps(cfg)
    if cfg["class_name"] == "Sequential":
        return mod.importKerasSequentialModelAndWeights(js, **kw)
    return mod.importKerasModelAndWeights(js, **kw)


def _out(y):
    y = y[0] if isinstance(y, list) else y
    return y.detach().cpu().numpy() if torch.is_tensor(y) else np.asarray(y)


def _close(got, want, rtol=RTOL):
    scale = max(1.0, float(np.abs(want).max()))
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= rtol * scale, \
        float(np.abs(got - want).max())


def _carry(jnet, tnet):
    if hasattr(jnet, "conf") and hasattr(jnet.conf, "layers"):
        multilayer_params_from_numpy(tnet, _np(jnet._params),
                                     _np(jnet._state), device="cpu")
    else:
        graph_params_from_numpy(tnet, _np(jnet._params), _np(jnet._state),
                                device="cpu")


@pytest.mark.parametrize("case", sorted(CASES))
def test_keras_configuration_imports_like_the_jax_package(case):
    cfg, shape = CASES[case]
    jnet = _import(JK, cfg)
    tnet = _import(TK, cfg, device="cpu")
    assert type(tnet).__name__ == type(jnet).__name__
    jlayers = [type(l).__name__ for l in getattr(jnet, "layers", [])]
    tlayers = [type(l).__name__ for l in getattr(tnet, "layers", [])]
    assert tlayers == jlayers
    _carry(jnet, tnet)
    x = _inputs(shape, case)
    _close(_out(tnet.output(x)), _out(jnet.output(x)))


def test_refusals_match_the_jax_package():
    """Configurations the reference refuses, the port refuses too."""
    bad = [
        _seq([{"class_name": "Masking", "config": {}},
              _dense(3)], [4, 2]),
        _seq([{"class_name": "Conv2DTranspose", "config": {
            "filters": 2, "kernel_size": [3, 3],
            "output_padding": [1, 1]}}], [4, 4, 1]),
        _seq([{"class_name": "Bidirectional", "config": {
            "merge_mode": None, "layer": {"class_name": "LSTM",
                                          "config": {"units": 3}}}}],
             [5, 2]),
        _seq([{"class_name": "Lambda", "config": {"name": "nope"}}], [3]),
        _seq([{"class_name": "FancyUnknown", "config": {}}], [3]),
    ]
    for cfg in bad:
        with pytest.raises(ValueError):
            _import(JK, cfg)
        with pytest.raises(InvalidKerasConfigurationException):
            _import(TK, cfg, device="cpu")


# -- .h5 weights -------------------------------------------------------------
def _write_h5(path, weights, model_config=None):
    """Keras's layout: model_weights/<layer>/<layer>/<name>:0."""
    h5py = pytest.importorskip("h5py")
    with h5py.File(path, "w") as f:
        if model_config is not None:
            f.attrs["model_config"] = json.dumps(model_config)
        g = f.create_group("model_weights")
        for layer, arrs in weights.items():
            sub = g.create_group(layer).create_group(layer)
            for name, a in arrs:
                sub.create_dataset(f"{name}:0", data=a)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _bn(rng, c):
    return [("gamma", 1 + 0.1 * _rand(rng, c)), ("beta", _rand(rng, c)),
            ("moving_mean", 0.1 * _rand(rng, c)),
            ("moving_variance", rng.uniform(0.5, 1.5, c).astype(np.float32))]


def _h5_case(rng):
    """A CNN with every weight kind the reader maps by name: conv kernel
    and bias, BN's four vectors, a depthwise kernel in Keras's (kh, kw, C,
    M) layout, a square LSTM (gate order i,f,g,o) and a dense head."""
    cfg = _functional([
        _node("InputLayer", "img", {"batch_input_shape": [None, 6, 6, 2]}),
        _node("Conv2D", "conv", {"filters": 4, "kernel_size": [3, 3],
                                 "padding": "same", "activation": "linear"},
              "img"),
        _node("BatchNormalization", "bn", {"epsilon": 1e-3}, "conv"),
        _node("DepthwiseConv2D", "dw", {"kernel_size": [3, 3],
                                        "depth_multiplier": 2,
                                        "padding": "valid",
                                        "activation": "relu"}, "bn"),
        _node("GlobalAveragePooling2D", "gap", {}, "dw"),
        _node("Dense", "out", {"units": 3, "activation": "softmax"}, "gap")],
        ["img"], ["out"])
    weights = {"conv": [("kernel", _rand(rng, 3, 3, 2, 4)),
                        ("bias", _rand(rng, 4))],
               "bn": _bn(rng, 4),
               "dw": [("depthwise_kernel", _rand(rng, 3, 3, 4, 2)),
                      ("bias", _rand(rng, 8))],
               "out": [("kernel", _rand(rng, 8, 3)),
                       ("bias", _rand(rng, 3))]}
    return cfg, weights, (2, 6, 6, 2)


def _lstm_case(rng):
    cfg = _seq([{"class_name": "LSTM", "config": {
        "name": "lstm", "units": 4, "return_sequences": True}},
        _dense(2, name="head")], [5, 4])
    weights = {"lstm": [("kernel", _rand(rng, 4, 16)),
                        ("recurrent_kernel", _rand(rng, 4, 16)),
                        ("bias", _rand(rng, 16))],
               "head": [("kernel", _rand(rng, 4, 2)),
                        ("bias", _rand(rng, 2))]}
    return cfg, weights, (2, 5, 4)


def _assert_same_params(jnet, tnet):
    tp, ts = graph_params_to_numpy(tnet)
    from deeplearning4j_tpu_torch.nn.convert import jax_tree
    for want, got in ((_np(jnet._params), jax_tree(tnet, tp)),
                      (_np(jnet._state), ts)):
        assert jax.tree_util.tree_structure(want) == \
            jax.tree_util.tree_structure(got)
        for a, b in zip(jax.tree_util.tree_leaves(want),
                        jax.tree_util.tree_leaves(got)):
            np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("make", [_h5_case, _lstm_case],
                         ids=["cnn_bn_depthwise", "square_lstm"])
def test_h5_weights_load_by_name_in_both_packages(tmp_path, make):
    cfg, weights, shape = make(np.random.default_rng(7))
    path = str(tmp_path / "w.h5")
    _write_h5(path, weights)
    js = json.dumps(cfg)
    if cfg["class_name"] == "Sequential":
        jnet = JK.importKerasSequentialModelAndWeights(js, path)
        tnet = TK.importKerasSequentialModelAndWeights(js, path,
                                                       device="cpu")
    else:
        jnet = JK.importKerasModelAndWeights(js, path)
        tnet = TK.importKerasModelAndWeights(js, path, device="cpu")
    assert tnet._h5_layers_loaded == jnet._h5_layers_loaded == len(weights)
    _assert_same_params(jnet, tnet)
    x = _inputs(shape, "h5")
    _close(_out(tnet.output(x)), _out(jnet.output(x)))


def test_h5py_is_needed_only_with_a_weights_path(monkeypatch):
    import builtins
    real = builtins.__import__

    def no_h5py(name, *a, **kw):
        if name == "h5py":
            raise ImportError("No module named 'h5py'")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    cfg, _ = CASES["mlp"]
    TK.importKerasSequentialModelAndWeights(json.dumps(cfg), device="cpu")
    with pytest.raises(ImportError, match="h5py"):
        TK.importKerasSequentialModelAndWeights(json.dumps(cfg), "w.h5",
                                                device="cpu")


# -- MobileNetV2 ---------------------------------------------------------------
NARROW = dict(alpha=0.35, size=32, classes=10, blocks=4)


def _flat_padding(cfg):
    """The same configuration with ZeroPadding2D's Keras spelling
    ((top, bottom), (left, right)) flattened to four numbers: the JAX
    package's layer refuses the nested pairs."""
    cfg = copy.deepcopy(cfg)
    for lc in cfg["config"]["layers"]:
        if lc["class_name"] == "ZeroPadding2D":
            (t, b), (l, r) = lc["config"]["padding"]
            lc["config"]["padding"] = [t, b, l, r]
    return cfg


def _keras_mobilenet_weights(cfg, rng):
    """Seeded Keras-layout weights for every layer of a MobileNetV2 JSON."""
    shapes = {}
    ch = {"input_1": 3}
    for lc in cfg["config"]["layers"]:
        c, name = lc["config"], lc["config"]["name"]
        ins = [n[0] for n in (lc["inbound_nodes"][0]
                              if lc["inbound_nodes"] else [])]
        cin = ch[ins[0]] if ins else 3
        cls = lc["class_name"]
        if cls == "Conv2D":
            k = c["kernel_size"][0]
            shapes[name] = [("kernel", (0.3 * _rand(
                rng, k, k, cin, c["filters"])))]
            ch[name] = c["filters"]
        elif cls == "DepthwiseConv2D":
            shapes[name] = [("depthwise_kernel", 0.3 * _rand(
                rng, 3, 3, cin, 1))]
            ch[name] = cin
        elif cls == "BatchNormalization":
            shapes[name] = _bn(rng, cin)
            ch[name] = cin
        elif cls == "Dense":
            shapes[name] = [("kernel", 0.1 * _rand(rng, cin, c["units"])),
                            ("bias", _rand(rng, c["units"]))]
            ch[name] = c["units"]
        else:
            ch[name] = cin
    return shapes


def test_narrow_mobilenet_v2_from_keras_json_and_h5(tmp_path, monkeypatch):
    """The chip run's model at alpha 0.35, 32×32, its first 4 blocks: both
    packages import the same JSON and .h5 (parameters and BN statistics
    equal, outputs within 1e-5); the fusion finds every expand and project
    conv and Conv_1, and the fused forward equals the unfused one."""
    cfg = chip_smoke.keras_mobilenet_v2(**NARROW)
    kinds = {lc["class_name"] for lc in cfg["config"]["layers"]}
    assert {"ReLU", "DepthwiseConv2D", "ZeroPadding2D",
            "BatchNormalization", "Conv2D", "Add"} <= kinds
    weights = _keras_mobilenet_weights(cfg, np.random.default_rng(3))
    path = str(tmp_path / "mnv2.h5")
    _write_h5(path, weights)
    jnet = JK.importKerasModelAndWeights(json.dumps(_flat_padding(cfg)),
                                         path)
    monkeypatch.setenv("DL4J_TPU_FUSE_CONV_BN", "0")
    tnet = TK.importKerasModelAndWeights(json.dumps(cfg), path,
                                         device="cpu")
    assert tnet._h5_layers_loaded == jnet._h5_layers_loaded == len(weights)
    _assert_same_params(jnet, tnet)
    x = np.random.default_rng(4).standard_normal(
        (3, NARROW["size"], NARROW["size"], 3)).astype(np.float32)
    want = _out(jnet.output(x))
    _close(_out(tnet.output(x)), want)
    monkeypatch.setenv("DL4J_TPU_FUSE_CONV_BN", "1")
    fused = TK.importKerasModelAndWeights(json.dumps(cfg), path,
                                          device="cpu")
    assert len(fused._fused_pairs) == \
        chip_smoke.mobilenet_v2_pairs(NARROW["blocks"]) == 8
    _close(_out(fused.output(x)), want)


def test_full_mobilenet_v2_json_matches_keras_counts():
    """The chip run's configuration at alpha 1.0, 224×224, 1000 classes:
    Keras's parameter count (3,538,984 with the BN statistics) and the 34
    pairs the fusion finds."""
    cfg = chip_smoke.keras_mobilenet_v2()
    conf = TK.importKerasModelConfiguration(json.dumps(cfg))
    from deeplearning4j_tpu_torch.nn.fused import find_conv1x1_bn_fusions
    assert len(find_conv1x1_bn_fusions(conf)) == 34 == \
        chip_smoke.KERAS["pairs"] == chip_smoke.mobilenet_v2_pairs()
    from deeplearning4j_tpu_torch.nn import ComputationGraph
    ps, ss = ComputationGraph(conf)._draw()
    n = sum(t.numel() for tree in (ps, ss) for d in tree.values()
            for t in d.values())
    assert n == chip_smoke.MOBILENET_V2_PARAMS == 3_538_984


# -- ModelGuesser and initPretrained ------------------------------------------
def test_model_guesser_reads_a_keras_h5_and_a_json(tmp_path):
    cfg, weights, shape = _h5_case(np.random.default_rng(9))
    whole = str(tmp_path / "model.h5")
    _write_h5(whole, weights, model_config=cfg)
    from deeplearning4j_tpu_torch.util.model_guesser import ModelGuesser
    net = ModelGuesser.loadModelGuess(whole, device="cpu")
    jnet = JK.importKerasModelAndWeights(json.dumps(cfg), whole)
    x = _inputs(shape, "guess")
    _close(_out(net.output(x)), _out(jnet.output(x)))
    js = tmp_path / "model.json"
    js.write_text(json.dumps(CASES["mlp"][0]))
    seq = ModelGuesser.loadModelGuess(str(js), device="cpu")
    assert type(seq).__name__ == "MultiLayerNetwork"


def test_init_pretrained_loads_keras_h5_weights_by_layer_name(tmp_path):
    """A zoo graph model's .h5 (its layer names, Keras's weight names):
    both packages' readers give the same arrays, and the port's
    initPretrained on the CPU holds each of them unchanged in the layer of
    its name (kernel -> W, bias -> b: HWIO in both packages). The JAX
    package's SqueezeNet is not built here: its initialisation compiles a
    sampler per weight shape, ~12 s on the CPU; its loader is held to the
    port's by the MobileNetV2 test above."""
    from deeplearning4j_tpu.keras_import.keras_import import \
        _h5_layer_weights as jax_read
    from deeplearning4j_tpu_torch.keras_import.keras_import import \
        _h5_layer_weights as port_read
    from deeplearning4j_tpu_torch.models.zoo import SqueezeNet
    from deeplearning4j_tpu_torch.nn.convert import jax_tree
    shape = dict(inputShape=(48, 48, 3), numClasses=5)
    fresh = SqueezeNet(**shape).init(device="cpu")
    rng = np.random.default_rng(11)
    weights = {}
    for name, d in jax_tree(fresh, graph_params_to_numpy(fresh)[0]).items():
        weights[name] = [(("kernel" if k == "W" else "bias"),
                          0.1 * _rand(rng, *np.shape(v)))
                         for k, v in sorted(d.items())]
    path = str(tmp_path / "squeezenet_imagenet.h5")
    _write_h5(path, weights)
    want, got = jax_read(path), port_read(path)
    assert sorted(got) == sorted(want) == sorted(weights)
    for name in weights:
        assert [k for k, _ in got[name]] == [k for k, _ in want[name]]
        for (_, a), (_, b) in zip(got[name], want[name]):
            np.testing.assert_array_equal(a, b)
    tnet = SqueezeNet(**shape).initPretrained(path=path, device="cpu")
    assert tnet._h5_layers_loaded == len(weights)
    loaded = jax_tree(tnet, graph_params_to_numpy(tnet)[0])
    for name, arrs in weights.items():
        for k, a in arrs:
            np.testing.assert_array_equal(
                loaded[name]["W" if k == "kernel" else "b"], a)
    x = np.random.default_rng(12).standard_normal(
        (2, 48, 48, 3)).astype(np.float32)
    y = _out(tnet.output(x))
    assert y.shape == (2, 5) and np.isfinite(y).all()
