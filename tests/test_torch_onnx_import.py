"""The port's ONNX importer (`deeplearning4j_tpu_torch/autodiff/
onnx_import.py`) against the JAX package's, on the CPU.

- The 35 cases of tests/test_onnx_import.py, as parametrised cases: the
  same ModelProto bytes (written with chip_smoke's ONNX writer, which
  uses the port's tfproto encoder) go through both importers; outputs
  agree within RTOL of max(1, max |JAX|); the imported-then-fine-tuned
  MatMul gives the same gradients and fit losses within RTOL; both
  packages refuse the same models with the same error type and message.
- A SameDiff archive that the JAX package wrote from an ONNX import loads
  in the port (`graph_serde.build_fn` pulls the importer in for "onnx.*"
  ops) with the JAX package's outputs within RTOL; a port archive of an
  import round-trips bit-identical.
- A narrow ResNet (the zoo's ResNet-50 blocks at widths 8–32) written as
  ONNX by chip_smoke.graph_onnx equals the port net's `output()` and the
  JAX importer's outputs within RTOL.
"""
import struct

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.autodiff import importOnnx as jimport
from deeplearning4j_tpu.autodiff.onnx_import import \
    UnsupportedOnnxOpError as JUnsupported
from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSD
from deeplearning4j_tpu.autodiff.samediff import TrainingConfig as JTC
from deeplearning4j_tpu.nn.updaters import Adam as JAdam
from deeplearning4j_tpu_torch.autodiff import importOnnx as timport
from deeplearning4j_tpu_torch.autodiff.graph_serde import (OP_BUILDERS,
                                                           build_fn,
                                                           load_samediff)
from deeplearning4j_tpu_torch.autodiff.onnx_import import \
    UnsupportedOnnxOpError as TUnsupported
from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff as TSD
from deeplearning4j_tpu_torch.autodiff.samediff import TrainingConfig as TTC
from deeplearning4j_tpu_torch.autodiff.tfproto import _field, _put_bytes
from deeplearning4j_tpu_torch.nn.updaters import Adam as TAdam

from chip_smoke import graph_onnx, onnx_model, onnx_node

#: outputs and gradients of the port against the JAX package: f32 sums in
#: another order, relative to max(1, max |JAX|)
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


def _f(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


# -- the 35 cases of tests/test_onnx_import.py -----------------------------
# each returns [(model bytes, feeds, output names)], or
# ("raises", model bytes, message pattern), or a special kind
def _gemm_mlp():
    rng = np.random.default_rng(0)
    w1, b1, w2, b2 = (_f(rng, 4, 8), _f(rng, 8), _f(rng, 8, 3), _f(rng, 3))
    model = onnx_model(
        [onnx_node("Gemm", ["x", "w1", "b1"], ["h"], transB=0),
         onnx_node("Relu", ["h"], ["a"]),
         onnx_node("Gemm", ["a", "w2", "b2"], ["logits"]),
         onnx_node("Softmax", ["logits"], ["probs"], axis=-1)],
        {"w1": w1, "b1": b1, "w2": w2, "b2": b2}, {"x": [2, 4]}, ["probs"])
    return [(model, {"x": _f(rng, 2, 4)}, ["probs", "logits"])]


def _conv_bn_pool():
    rng = np.random.default_rng(1)
    w = _f(rng, 4, 3, 3, 3)
    stats = {"gamma": rng.uniform(0.5, 1.5, 4).astype(np.float32),
             "beta": _f(rng, 4), "mean": _f(rng, 4),
             "var": rng.uniform(0.5, 1.5, 4).astype(np.float32)}
    model = onnx_model(
        [onnx_node("Conv", ["x", "w"], ["c"], strides=[1, 1],
                   pads=[1, 1, 1, 1]),
         onnx_node("BatchNormalization",
                   ["c", "gamma", "beta", "mean", "var"], ["bn"],
                   epsilon=1e-5),
         onnx_node("Relu", ["bn"], ["r"]),
         onnx_node("MaxPool", ["r"], ["p"], kernel_shape=[2, 2],
                   strides=[2, 2]),
         onnx_node("GlobalAveragePool", ["p"], ["g"]),
         onnx_node("Flatten", ["g"], ["f"], axis=1)],
        dict(w=w, **stats), {"x": [2, 3, 8, 8]}, ["f"])
    return [(model, {"x": _f(rng, 2, 3, 8, 8)}, ["f", "bn", "p"])]


def _embedding_gather_reduce():
    table = np.arange(12, dtype=np.float32).reshape(4, 3)
    model = onnx_model(
        [onnx_node("Gather", ["table", "ids"], ["emb"], axis=0),
         onnx_node("ReduceMean", ["emb"], ["pooled"], axes=[1],
                   keepdims=0)],
        {"table": table}, {"ids": [2, 5]}, ["pooled"])
    ids = np.asarray([[0, 1, 2, 3, 0], [3, 3, 3, 3, 3]], np.int32)
    return [(model, {"ids": ids}, ["pooled", "emb"])]


def _unsupported_raises():
    return ("raises", onnx_model([onnx_node("LSTM", ["x"], ["y"])], {},
                                 {"x": [1, 2]}, ["y"]), "LSTM")


def _finetune_imported():
    return ("finetune",)


def _conv_auto_pad_same_upper():
    rng = np.random.default_rng(7)
    model = onnx_model(
        [onnx_node("Conv", ["x", "w"], ["y"], auto_pad="SAME_UPPER",
                   kernel_shape=[3, 3], strides=[2, 2])],
        {"w": _f(rng, 2, 3, 3, 3)}, {"x": [1, 3, 5, 5]}, ["y"])
    model1 = onnx_model(
        [onnx_node("Conv", ["x", "w"], ["y"], auto_pad="SAME_LOWER",
                   kernel_shape=[3, 3])],
        {"w": _f(rng, 2, 3, 3, 3)}, {"x": [1, 3, 5, 5]}, ["y"])
    x = _f(rng, 1, 3, 5, 5)
    return [(model, {"x": x}, ["y"]), (model1, {"x": x}, ["y"])]


def _maxpool_auto_pad_same_upper():
    model = onnx_model(
        [onnx_node("MaxPool", ["x"], ["y"], auto_pad="SAME_UPPER",
                   kernel_shape=[2, 2], strides=[2, 2])],
        {}, {"x": [1, 1, 5, 5]}, ["y"])
    x = np.arange(25, dtype=np.float32).reshape(1, 1, 5, 5)
    return [(model, {"x": x}, ["y"])]


def _pool_ceil_mode_rejected():
    return ("raises", onnx_model(
        [onnx_node("MaxPool", ["x"], ["y"], kernel_shape=[2, 2],
                   strides=[2, 2], ceil_mode=1)],
        {}, {"x": [1, 1, 5, 5]}, ["y"]), "ceil_mode")


def _pool_dilations_rejected():
    return ("raises", onnx_model(
        [onnx_node("AveragePool", ["x"], ["y"], kernel_shape=[2, 2],
                   dilations=[2, 2])],
        {}, {"x": [1, 1, 5, 5]}, ["y"]), "dilations")


def _avgpool(include):
    def case():
        attrs = {"count_include_pad": 1} if include else {}
        model = onnx_model(
            [onnx_node("AveragePool", ["x"], ["y"], kernel_shape=[2, 2],
                       strides=[2, 2], pads=[1, 1, 0, 0], **attrs)],
            {}, {"x": [1, 1, 3, 3]}, ["y"])
        x = np.arange(9, dtype=np.float32).reshape(1, 1, 3, 3)
        return [(model, {"x": x}, ["y"])]
    return case


def _softmax(opset):
    def case():
        model = onnx_model([onnx_node("Softmax", ["x"], ["y"])], {},
                           {"x": [2, 3, 4]}, ["y"], opset=opset)
        x = _f(np.random.default_rng(9 + opset), 2, 3, 4)
        return [(model, {"x": x}, ["y"])]
    return case


def _leakyrelu_elu_softplus_hardsigmoid():
    x = np.array([[-2.0, -0.5, 0.5, 2.0]], np.float32)
    model = onnx_model(
        [onnx_node("LeakyRelu", ["x"], ["a"], alpha=0.1),
         onnx_node("Elu", ["a"], ["b"], alpha=1.0),
         onnx_node("Softplus", ["b"], ["c"]),
         onnx_node("HardSigmoid", ["c"], ["y"], alpha=0.2, beta=0.5)],
        {}, {"x": [1, 4]}, ["y"])
    return [(model, {"x": x}, ["a", "b", "c", "y"])]


def _conv_transpose_inverts_shape():
    rng = np.random.default_rng(2)
    w, bias = _f(rng, 3, 2, 3, 3), _f(rng, 2)
    model = onnx_model(
        [onnx_node("ConvTranspose", ["x", "w", "b"], ["y"],
                   strides=[2, 2], pads=[1, 1, 1, 1],
                   output_padding=[1, 1])],
        {"w": w, "b": bias}, {"x": [1, 3, 5, 5]}, ["y"])
    model2 = onnx_model(
        [onnx_node("ConvTranspose", ["x", "w"], ["y"], strides=[1, 2],
                   dilations=[2, 1], pads=[0, 1, 2, 0])],
        {"w": w}, {"x": [1, 3, 5, 5]}, ["y"])
    x = _f(rng, 1, 3, 5, 5)
    return [(model, {"x": x}, ["y"]), (model2, {"x": x}, ["y"])]


def _pad_constant_and_reflect():
    x = np.arange(12, dtype=np.float32).reshape(1, 1, 3, 4)
    pads = np.array([0, 0, 1, 2, 0, 0, 2, 1], np.int64)
    out = []
    for mode in ("constant", "reflect", "edge"):
        out.append((onnx_model(
            [onnx_node("Pad", ["x", "p"], ["y"], mode=mode)],
            {"p": pads}, {"x": [1, 1, 3, 4]}, ["y"]), {"x": x}, ["y"]))
    return out


def _resize_nearest_and_upsample():
    x = np.arange(4, dtype=np.float32).reshape(1, 1, 2, 2)
    scales = np.array([1.0, 1.0, 2.0, 2.0], np.float32)
    return [(onnx_model(
        [onnx_node("Resize", ["x", "", "s"], ["y"], mode="nearest")],
        {"s": scales}, {"x": [1, 1, 2, 2]}, ["y"]), {"x": x}, ["y"]),
        (onnx_model(
            [onnx_node("Upsample", ["x", "s"], ["y"], mode="nearest")],
            {"s": scales}, {"x": [1, 1, 2, 2]}, ["y"]), {"x": x}, ["y"])]


def _unsupported_modes_raise():
    return ("raises", onnx_model(
        [onnx_node("Resize", ["x", "", "s"], ["y"], mode="linear")],
        {"s": np.array([1, 1, 2, 2], np.float32)}, {"x": [1, 1, 2, 2]},
        ["y"]), "linear")


def _resize_sizes_input():
    x = np.arange(4, dtype=np.float32).reshape(1, 1, 2, 2)
    return [(onnx_model(
        [onnx_node("Resize", ["x", "", "", "sz"], ["y"], mode="nearest")],
        {"sz": np.array([1, 1, 6, 4], np.int64)}, {"x": [1, 1, 2, 2]},
        ["y"]), {"x": x}, ["y"])]


def _resize_channel_scale_rejected():
    return ("raises", onnx_model(
        [onnx_node("Resize", ["x", "", "s"], ["y"], mode="nearest")],
        {"s": np.array([1, 2, 2, 2], np.float32)}, {"x": [1, 1, 2, 2]},
        ["y"]), "batch/channel")


def _conv_transpose_auto_pad_rejected():
    return ("raises", onnx_model(
        [onnx_node("ConvTranspose", ["x", "w"], ["y"],
                   auto_pad="SAME_UPPER", strides=[2, 2])],
        {"w": np.zeros((1, 1, 3, 3), np.float32)}, {"x": [1, 1, 4, 4]},
        ["y"]), "auto_pad")


def _pad_axes_input_rejected():
    return ("raises", onnx_model(
        [onnx_node("Pad", ["x", "p", "", "ax"], ["y"], mode="constant")],
        {"p": np.array([1, 1, 1, 1], np.int64),
         "ax": np.array([2, 3], np.int64)}, {"x": [1, 1, 2, 2]}, ["y"]),
        "axes")


def _pad_nonconstant_value_rejected():
    return ("raises", onnx_model(
        [onnx_node("Identity", ["cv"], ["cv2"]),
         onnx_node("Pad", ["x", "p", "cv2"], ["y"], mode="constant")],
        {"p": np.array([0, 0, 1, 1, 0, 0, 1, 1], np.int64),
         "cv": np.array(5.0, np.float32)}, {"x": [1, 1, 2, 2]}, ["y"]),
        "non-constant")


def _resize_opset10_two_input_form():
    x = np.arange(4, dtype=np.float32).reshape(1, 1, 2, 2)
    return [(onnx_model(
        [onnx_node("Resize", ["x", "s"], ["y"], mode="nearest")],
        {"s": np.array([1, 1, 2, 3], np.float32)}, {"x": [1, 1, 2, 2]},
        ["y"]), {"x": x}, ["y"])]


def _upsample_opset7_scales_attr():
    attr = bytearray()
    _put_bytes(attr, 1, b"scales")
    for v in (1.0, 1.0, 2.0, 2.0):
        _field(attr, 7, 5)                  # floats, fixed32 wire
        attr.extend(struct.pack("<f", v))
    node = bytearray()
    _put_bytes(node, 1, b"x")
    _put_bytes(node, 2, b"y")
    _put_bytes(node, 4, b"Upsample")
    _put_bytes(node, 5, bytes(attr))
    x = np.arange(4, dtype=np.float32).reshape(1, 1, 2, 2)
    return [(onnx_model([bytes(node)], {}, {"x": [1, 1, 2, 2]}, ["y"]),
             {"x": x}, ["y"])]


def _split_with_sizes():
    model = onnx_model(
        [onnx_node("Split", ["x"], ["a", "b", "c"], axis=1,
                   split=[1, 2, 3])],
        {}, {"x": [2, 6]}, ["a", "b", "c"])
    x = np.arange(12, dtype=np.float32).reshape(2, 6)
    return [(model, {"x": x}, ["a", "b", "c"])]


def _split_without_sizes_rejected():
    return ("raises", onnx_model(
        [onnx_node("Split", ["x"], ["a", "b"], axis=1)], {}, {"x": [2, 6]},
        ["a", "b"]), "Split")


def _slice_opset10_inputs():
    model = onnx_model(
        [onnx_node("Slice", ["x", "s", "e", "a", "st"], ["y"])],
        {"s": np.asarray([1, 0], np.int64),
         "e": np.asarray([3, 2 ** 40], np.int64),
         "a": np.asarray([0, 2], np.int64),
         "st": np.asarray([1, 2], np.int64)}, {"x": [4, 3, 6]}, ["y"])
    return [(model, {"x": _f(np.random.default_rng(0), 4, 3, 6)}, ["y"])]


def _slice_negative_start():
    model = onnx_model(
        [onnx_node("Slice", ["x"], ["y"], starts=[-2], ends=[2 ** 30],
                   axes=[1])],
        {}, {"x": [2, 5]}, ["y"])
    x = np.arange(10, dtype=np.float32).reshape(2, 5)
    return [(model, {"x": x}, ["y"])]


def _reduce_sum_and_max():
    model = onnx_model(
        [onnx_node("ReduceSum", ["x"], ["s"], axes=[1], keepdims=0),
         onnx_node("ReduceMax", ["x"], ["m"], keepdims=1),
         onnx_node("ReduceMin", ["x"], ["n"], axes=[0, 2], keepdims=0)],
        {}, {"x": [2, 3, 4]}, ["s", "m", "n"])
    return [(model, {"x": _f(np.random.default_rng(1), 2, 3, 4)},
             ["s", "m", "n"])]


def _reduce_sum_opset13_axes_input():
    model = onnx_model(
        [onnx_node("ReduceSum", ["x", "ax"], ["y"], keepdims=0)],
        {"ax": np.asarray([0], np.int64)}, {"x": [3, 2]}, ["y"])
    return [(model, {"x": _f(np.random.default_rng(6), 3, 2)}, ["y"])]


def _global_max_pool():
    model = onnx_model([onnx_node("GlobalMaxPool", ["x"], ["y"])], {},
                       {"x": [1, 2, 4, 4]}, ["y"])
    return [(model, {"x": _f(np.random.default_rng(2), 1, 2, 4, 4)},
             ["y"])]


def _split_roundtrips_through_serde():
    return ("serde",)


def _reduce_noop_with_empty_axes():
    model = onnx_model(
        [onnx_node("ReduceSum", ["x"], ["y"], keepdims=1,
                   noop_with_empty_axes=1)],
        {}, {"x": [2, 3]}, ["y"])
    return [(model, {"x": _f(np.random.default_rng(4), 2, 3)}, ["y"])]


def _global_pools_rank3():
    model = onnx_model(
        [onnx_node("GlobalMaxPool", ["x"], ["m"]),
         onnx_node("GlobalAveragePool", ["x"], ["a"])],
        {}, {"x": [2, 3, 5]}, ["m", "a"])
    return [(model, {"x": _f(np.random.default_rng(5), 2, 3, 5)},
             ["m", "a"])]


CASES = {
    "gemm_mlp": _gemm_mlp,
    "conv_bn_pool": _conv_bn_pool,
    "embedding_gather_reduce": _embedding_gather_reduce,
    "unsupported_raises": _unsupported_raises,
    "finetune_imported": _finetune_imported,
    "conv_auto_pad_same_upper": _conv_auto_pad_same_upper,
    "maxpool_auto_pad_same_upper": _maxpool_auto_pad_same_upper,
    "pool_ceil_mode_rejected": _pool_ceil_mode_rejected,
    "pool_dilations_rejected": _pool_dilations_rejected,
    "avgpool_count_include_pad": _avgpool(True),
    "avgpool_default_excludes_pad": _avgpool(False),
    "softmax_opset12_flatten_semantics": _softmax(12),
    "softmax_opset13_last_axis": _softmax(13),
    "leakyrelu_elu_softplus_hardsigmoid":
        _leakyrelu_elu_softplus_hardsigmoid,
    "conv_transpose_inverts_shape": _conv_transpose_inverts_shape,
    "pad_constant_and_reflect": _pad_constant_and_reflect,
    "resize_nearest_and_upsample": _resize_nearest_and_upsample,
    "unsupported_modes_raise": _unsupported_modes_raise,
    "resize_sizes_input": _resize_sizes_input,
    "resize_channel_scale_rejected": _resize_channel_scale_rejected,
    "conv_transpose_auto_pad_rejected": _conv_transpose_auto_pad_rejected,
    "pad_axes_input_rejected": _pad_axes_input_rejected,
    "pad_nonconstant_value_rejected": _pad_nonconstant_value_rejected,
    "resize_opset10_two_input_form": _resize_opset10_two_input_form,
    "upsample_opset7_scales_attr": _upsample_opset7_scales_attr,
    "split_with_sizes": _split_with_sizes,
    "split_without_sizes_rejected": _split_without_sizes_rejected,
    "slice_opset10_inputs": _slice_opset10_inputs,
    "slice_negative_start": _slice_negative_start,
    "reduce_sum_and_max": _reduce_sum_and_max,
    "reduce_sum_opset13_axes_input": _reduce_sum_opset13_axes_input,
    "global_max_pool": _global_max_pool,
    "split_roundtrips_through_serde": _split_roundtrips_through_serde,
    "reduce_noop_with_empty_axes": _reduce_noop_with_empty_axes,
    "global_pools_rank3": _global_pools_rank3,
}


def _finetune_parity():
    """The imported MatMul fine-tuned in both packages: the gradient of
    the loss and 5 Adam fit steps agree."""
    rng = np.random.default_rng(3)
    model = onnx_model([onnx_node("MatMul", ["x", "w"], ["logits"])],
                       {"w": _f(rng, 4, 3)}, {"x": [8, 4]}, ["logits"])
    x = _f(rng, 8, 4)
    y = np.eye(3, dtype=np.float32)[rng.integers(3, size=8)]
    sds = []
    for imp, tc, adam in ((jimport, JTC, JAdam),
                          (lambda m: timport(m, device="cpu"), TTC, TAdam)):
        sd = imp(model)
        sd.convertConstantsToVariables("w")
        labels = sd.placeHolder("labels", None, 3)
        sd.loss.softmaxCrossEntropy("loss", labels,
                                    sd.getVariable("logits"))
        sd.setLossVariables("loss")
        sd.setTrainingConfig(tc.Builder().updater(adam(5e-2))
                             .dataSetFeatureMapping("x")
                             .dataSetLabelMapping("labels").build())
        sds.append(sd)
    jsd, tsd = sds
    feeds = {"x": x, "labels": y}
    _close(_t(tsd.calculateGradients(feeds, "w")["w"]),
           _j(jsd.calculateGradients(feeds, "w")["w"]))
    jl = [jsd.fit(x, y) for _ in range(5)]
    tl = [tsd.fit(x, y) for _ in range(5)]
    _close(tl, jl)
    assert tl[-1] < tl[0]
    _close(_t(tsd.getVariable("w").getArr()),
           _j(jsd.getVariable("w").getArr()))


def _serde_parity(tmp_path):
    """Split + Add imported by each package, saved, loaded by the other."""
    model = onnx_model(
        [onnx_node("Split", ["x"], ["a", "b"], axis=0, split=[1, 1]),
         onnx_node("Add", ["a", "b"], ["y"])],
        {}, {"x": [2, 3]}, ["y"])
    x = _f(np.random.default_rng(3), 2, 3)
    jsd, tsd = jimport(model), timport(model, device="cpu")
    want = _j(jsd.outputSingle({"x": x}, "y"))
    jsd.save(str(tmp_path / "j.sdz"))
    tsd.save(str(tmp_path / "t.sdz"))
    from_j = load_samediff(str(tmp_path / "j.sdz"), device="cpu")
    from_t = JSD.load(str(tmp_path / "t.sdz"))
    _close(_t(from_j.outputSingle({"x": x}, "y")), want)
    _close(_j(from_t.outputSingle({"x": x}, "y")), want)
    np.testing.assert_array_equal(
        _t(load_samediff(str(tmp_path / "t.sdz"), device="cpu")
           .outputSingle({"x": x}, "y")),
        _t(tsd.outputSingle({"x": x}, "y")))


@pytest.mark.parametrize("case", list(CASES))
def test_onnx_case_matches_the_jax_package(case, tmp_path):
    spec = CASES[case]()
    if spec[0] == "raises":
        _, model, match = spec
        with pytest.raises(JUnsupported, match=match) as je:
            jimport(model).output({"x": np.zeros((1, 1, 2, 2),
                                                 np.float32)}, ["y"])
        with pytest.raises(TUnsupported, match=match) as te:
            timport(model, device="cpu").output(
                {"x": np.zeros((1, 1, 2, 2), np.float32)}, ["y"])
        assert str(te.value) == str(je.value)
        return
    if spec[0] == "finetune":
        _finetune_parity()
        return
    if spec[0] == "serde":
        _serde_parity(tmp_path)
        return
    for model, feeds, outs in spec:
        want = jimport(model).output(feeds, outs)
        got = timport(model, device="cpu").output(feeds, outs)
        for n in outs:
            _close(_t(got[n]), _j(want[n]))


def test_importer_registers_every_jax_onnx_builder():
    """Every "onnx.*" op builder of the JAX package has the port's twin,
    so either package's archive of an import loads in the other."""
    from deeplearning4j_tpu.autodiff.graph_serde import \
        OP_BUILDERS as JOPS
    jax_onnx = {k for k in JOPS if k.startswith("onnx.")}
    assert jax_onnx and jax_onnx <= set(OP_BUILDERS)


def test_build_fn_pulls_the_onnx_importer_in_on_demand():
    """`build_fn` of an "onnx.*" op never raises for want of the importer:
    it imports it on demand (a fresh process loading an archive)."""
    import sys
    mod = "deeplearning4j_tpu_torch.autodiff.onnx_import"
    saved = {k: v for k, v in OP_BUILDERS.items() if k.startswith("onnx.")}
    module = sys.modules.pop(mod)
    for k in saved:
        del OP_BUILDERS[k]
    try:
        fn = build_fn("onnx.gemm", {"alpha": 2.0, "tb": 1})
        a, b = torch.ones(2, 3), torch.ones(4, 3)
        assert torch.equal(fn(a, b), torch.full((2, 4), 6.0))
        assert mod in sys.modules
    finally:
        sys.modules[mod] = module
        OP_BUILDERS.update(saved)


def _conv_net_model(rng):
    """A small CNN as exporters write it: Conv + BN + Relu + MaxPool,
    ConvTranspose, Pad, Resize, Gemm, Softmax."""
    inits = {"w1": _f(rng, 4, 3, 3, 3), "b1": _f(rng, 4),
             "g": rng.uniform(0.5, 1.5, 4).astype(np.float32),
             "be": _f(rng, 4), "m": _f(rng, 4),
             "v": rng.uniform(0.5, 1.5, 4).astype(np.float32),
             "wt": _f(rng, 4, 2, 2, 2),
             "p": np.array([0, 0, 1, 1, 0, 0, 1, 1], np.int64),
             "s": np.array([1, 1, 2, 2], np.float32),
             "shape": np.array([2, -1], np.int64),
             "wf": _f(rng, 2 * 12 * 12, 5), "bf": _f(rng, 5)}
    nodes = [onnx_node("Conv", ["x", "w1", "b1"], ["c"], pads=[1, 1, 1, 1]),
             onnx_node("BatchNormalization", ["c", "g", "be", "m", "v"],
                       ["bn"]),
             onnx_node("Relu", ["bn"], ["r"]),
             onnx_node("MaxPool", ["r"], ["mp"], kernel_shape=[2, 2],
                       strides=[2, 2]),
             onnx_node("ConvTranspose", ["mp", "wt"], ["ct"],
                       strides=[2, 2]),
             onnx_node("Pad", ["ct", "p"], ["pd"], mode="reflect"),
             onnx_node("MaxPool", ["pd"], ["pd2"], kernel_shape=[2, 2],
                       strides=[2, 2]),
             onnx_node("Resize", ["pd2", "", "s"], ["rs"], mode="nearest"),
             onnx_node("Reshape", ["rs", "shape"], ["fl"]),
             onnx_node("Gemm", ["fl", "wf", "bf"], ["logits"]),
             onnx_node("Softmax", ["logits"], ["probs"])]
    return onnx_model(nodes, inits, {"x": [2, 3, 10, 10]},
                      ["probs"], opset=13)


def test_jax_written_archive_of_an_onnx_import_loads_in_the_port(tmp_path):
    rng = np.random.default_rng(11)
    model = _conv_net_model(rng)
    x = _f(rng, 2, 3, 10, 10)
    jsd = jimport(model)
    path = str(tmp_path / "onnx_import.sdz")
    jsd.save(path)
    back = load_samediff(path, device="cpu")
    outs = ["probs", "logits", "rs", "ct"]
    want, got = jsd.output({"x": x}, outs), back.output({"x": x}, outs)
    for n in outs:
        _close(_t(got[n]), _j(want[n]))
    # and what the port imports from the same bytes
    direct = timport(model, device="cpu").output({"x": x}, outs)
    for n in outs:
        _close(_t(direct[n]), _j(want[n]))


def test_port_archive_of_an_onnx_import_round_trips_bit_identical(
        tmp_path):
    rng = np.random.default_rng(12)
    sd = timport(_conv_net_model(rng), device="cpu")
    x = _f(rng, 2, 3, 10, 10)
    path = str(tmp_path / "port.sdz")
    sd.save(path)
    back = TSD.load(path, device="cpu")
    for n in ("probs", "logits"):
        np.testing.assert_array_equal(_t(back.outputSingle({"x": x}, n)),
                                      _t(sd.outputSingle({"x": x}, n)))


def _narrow_resnet():
    """ResNet-50's blocks (stem conv + BN + max pool, a downsampling and
    an identity bottleneck, global average pool, softmax head) at widths
    8–32, 24×24×3, 5 classes."""
    from deeplearning4j_tpu_torch.nn.conf.builders import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.graph_vertices import \
        ElementWiseVertex
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import (
        ActivationLayer, BatchNormalization, ConvolutionLayer,
        GlobalPoolingLayer, OutputLayer, SubsamplingLayer)
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    g = (NeuralNetConfiguration.Builder().seed(3).weightInit("relu")
         .graphBuilder().addInputs("input")
         .setInputTypes(InputType.convolutional(24, 24, 3)))

    def conv_bn(name, inp, n, k, s, act="relu"):
        g.addLayer(f"{name}_conv", ConvolutionLayer(
            kernelSize=k, stride=s, nOut=n, convolutionMode="same",
            hasBias=False, activation="identity"), inp)
        g.addLayer(f"{name}_bn", BatchNormalization(activation=act),
                   f"{name}_conv")
        return f"{name}_bn"

    def block(name, inp, f, s, down):
        x = conv_bn(f"{name}_a", inp, f[0], (1, 1), s)
        x = conv_bn(f"{name}_b", x, f[1], (3, 3), (1, 1))
        x = conv_bn(f"{name}_c", x, f[2], (1, 1), (1, 1), "identity")
        sc = conv_bn(f"{name}_sc", inp, f[2], (1, 1), s, "identity") \
            if down else inp
        g.addVertex(f"{name}_add", ElementWiseVertex("add"), x, sc)
        g.addLayer(f"{name}_relu", ActivationLayer(activation="relu"),
                   f"{name}_add")
        return f"{name}_relu"

    x = conv_bn("stem", "input", 8, (7, 7), (2, 2))
    g.addLayer("stem_pool", SubsamplingLayer(
        poolingType="max", kernelSize=(3, 3), stride=(2, 2),
        convolutionMode="same"), x)
    x = block("res2_0", "stem_pool", (8, 8, 32), (1, 1), True)
    x = block("res2_1", x, (8, 8, 32), (1, 1), False)
    x = block("res3_0", x, (16, 16, 32), (2, 2), True)
    g.addLayer("avgpool", GlobalPoolingLayer(poolingType="avg"), x)
    g.addLayer("fc", OutputLayer(lossFunction="mcxent", nOut=5,
                                 activation="softmax"), "avgpool")
    g.setOutputs("fc")
    net = ComputationGraph(g.build()).init("cpu")
    prng = np.random.default_rng(4)
    for name in sorted(net._state):      # BN statistics not the identity
        st, p = net._state[name], net._params[name]
        n = st["mean"].shape[0]
        for t, v in ((st["mean"], prng.normal(0, 0.1, n)),
                     (st["var"], prng.uniform(0.5, 1.5, n)),
                     (p["gamma"], prng.uniform(0.5, 1.0, n)),
                     (p["beta"], prng.normal(0, 0.1, n))):
            t.copy_(torch.as_tensor(v, dtype=torch.float32))
    return net


def test_narrow_resnet_written_as_onnx_equals_the_port_net():
    net = _narrow_resnet()
    model = graph_onnx(net, 3)
    x = _f(np.random.default_rng(8), 3, 24, 24, 3)
    want = np.asarray(net.output(x).numpy())
    feeds = {"input": np.ascontiguousarray(x.transpose(0, 3, 1, 2))}
    got = timport(model, device="cpu").output(feeds, ["fc", "fc_logits"])
    _close(_t(got["fc"]), want)
    assert (_t(got["fc"]).argmax(-1) == want.argmax(-1)).all()
    jgot = jimport(model).output(feeds, ["fc", "fc_logits"])
    for n in ("fc", "fc_logits"):
        _close(_t(got[n]), _j(jgot[n]))
