"""The port's NDArray facade and `nd` factory (`ops/`): the contracts of
the JAX package's tests/test_ops.py against numpy oracles, then the port
against the JAX package on the same seeded inputs (ops to 1e-6, the
RandomState key stream bit for bit), and the entry points that return
NDArray in the JAX package returning the port's."""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops import NDArray, Transforms, nd


@pytest.fixture(autouse=True)
def _on_the_cpu():
    nd.setDevice("cpu")
    yield
    nd.setDevice(None)


def test_create_and_shape():
    a = nd.create([[1.0, 2.0], [3.0, 4.0]])
    assert a.shape == (2, 2)
    assert a.rank() == 2
    assert a.length() == 4
    assert a.rows() == 2 and a.columns() == 2
    assert a.isMatrix() and not a.isVector()


def test_factory_basics():
    assert nd.zeros(2, 3).numpy().sum() == 0
    assert nd.ones(4).numpy().sum() == 4
    np.testing.assert_allclose(nd.eye(3).numpy(), np.eye(3))
    np.testing.assert_allclose(nd.linspace(0, 1, 5).numpy(),
                               np.linspace(0, 1, 5), rtol=1e-6)
    v = nd.valueArrayOf((3,), 7.0) if False else nd.valueArrayOf(3, 7.0)
    assert v.numpy().tolist() == [7.0, 7.0, 7.0]


def test_arithmetic_matches_numpy():
    rng = np.random.default_rng(0)
    a_np = rng.standard_normal((3, 4)).astype(np.float32)
    b_np = rng.standard_normal((3, 4)).astype(np.float32)
    a, b = NDArray(a_np), NDArray(b_np)
    np.testing.assert_allclose(a.add(b).numpy(), a_np + b_np, rtol=1e-6)
    np.testing.assert_allclose(a.sub(b).numpy(), a_np - b_np, rtol=1e-6)
    np.testing.assert_allclose(a.mul(b).numpy(), a_np * b_np, rtol=1e-6)
    np.testing.assert_allclose(a.div(b).numpy(), a_np / b_np, rtol=1e-5)
    np.testing.assert_allclose((a + 1.0).numpy(), a_np + 1, rtol=1e-6)
    np.testing.assert_allclose((2.0 * a).numpy(), 2 * a_np, rtol=1e-6)
    np.testing.assert_allclose(a.rsub(1.0).numpy(), 1 - a_np, rtol=1e-6)
    np.testing.assert_allclose((-a).numpy(), -a_np, rtol=1e-6)


def test_inplace_ops_rebind():
    a = NDArray([1.0, 2.0])
    r = a.addi(1.0)
    assert r is a
    assert a.numpy().tolist() == [2.0, 3.0]
    a.muli(2.0).subi(1.0)
    assert a.numpy().tolist() == [3.0, 5.0]
    a.assign(0.0)
    assert a.numpy().tolist() == [0.0, 0.0]


def test_mmul():
    rng = np.random.default_rng(1)
    a_np = rng.standard_normal((3, 4)).astype(np.float32)
    b_np = rng.standard_normal((4, 5)).astype(np.float32)
    out = NDArray(a_np).mmul(NDArray(b_np))
    np.testing.assert_allclose(out.numpy(), a_np @ b_np, rtol=1e-5)


def test_reductions():
    a_np = np.arange(12, dtype=np.float32).reshape(3, 4)
    a = NDArray(a_np)
    assert float(a.sum()) == a_np.sum()
    np.testing.assert_allclose(a.sum(0).numpy(), a_np.sum(0))
    np.testing.assert_allclose(a.mean(1).numpy(), a_np.mean(1))
    np.testing.assert_allclose(a.std(0).numpy(), a_np.std(0, ddof=1), rtol=1e-5)
    np.testing.assert_allclose(a.var(0, biasCorrected=False).numpy(),
                               a_np.var(0), rtol=1e-5)
    assert a.argMax(1).numpy().tolist() == [3, 3, 3]
    assert float(a.norm1()) == np.abs(a_np).sum()
    np.testing.assert_allclose(float(a.norm2()), np.linalg.norm(a_np), rtol=1e-5)


def test_row_column_broadcast():
    a_np = np.ones((3, 4), np.float32)
    row = np.arange(4, dtype=np.float32)
    col = np.arange(3, dtype=np.float32)
    a = NDArray(a_np)
    np.testing.assert_allclose(a.addRowVector(row).numpy(), a_np + row)
    np.testing.assert_allclose(a.mulColumnVector(col).numpy(),
                               a_np * col[:, None])


def test_indexing_and_put():
    a = nd.zeros(3, 3)
    a.putScalar((1, 1), 5.0)
    assert a.getDouble(1, 1) == 5.0
    a.putRow(0, [1.0, 2.0, 3.0])
    assert a.getRow(0).numpy().tolist() == [1.0, 2.0, 3.0]
    a.putColumn(2, [9.0, 9.0, 9.0])
    assert a.getColumn(2).numpy().tolist() == [9.0, 9.0, 9.0]
    sub = a[0:2]
    assert sub.shape == (2, 3)


def test_transforms():
    x_np = np.linspace(-2, 2, 7).astype(np.float32)
    x = NDArray(x_np)
    np.testing.assert_allclose(nd.exp(x).numpy(), np.exp(x_np), rtol=1e-5)
    np.testing.assert_allclose(nd.tanh(x).numpy(), np.tanh(x_np), rtol=1e-4)
    np.testing.assert_allclose(nd.relu(x).numpy(), np.maximum(x_np, 0))
    sm = nd.softmax(NDArray([[1.0, 2.0, 3.0]])).numpy()
    np.testing.assert_allclose(sm.sum(), 1.0, rtol=1e-6)
    np.testing.assert_allclose(nd.clip(x, -1, 1).numpy(),
                               np.clip(x_np, -1, 1))


def test_comparisons_and_where():
    a = NDArray([1.0, -2.0, 3.0])
    assert a.gt(0).numpy().tolist() == [True, False, True]
    w = nd.where(a.gt(0), a, nd.zerosLike(a))
    assert w.numpy().tolist() == [1.0, 0.0, 3.0]


def test_concat_stack():
    a, b = nd.ones(2, 3), nd.zeros(2, 3)
    assert nd.concat(0, a, b).shape == (4, 3)
    assert nd.concat(1, a, b).shape == (2, 6)
    assert nd.stack(0, a, b).shape == (2, 2, 3)
    assert nd.vstack(a, b).shape == (4, 3)
    assert nd.hstack(a, b).shape == (2, 6)


def test_onehot_gather():
    oh = nd.oneHot([0, 2, 1], 3)
    np.testing.assert_allclose(oh.numpy(),
                               [[1, 0, 0], [0, 0, 1], [0, 1, 0]])
    g = nd.gather(nd.create([[1.0, 2], [3, 4], [5, 6]]), [2, 0], axis=0)
    np.testing.assert_allclose(g.numpy(), [[5, 6], [1, 2]])


def test_random_deterministic():
    nd.setSeed(42)
    a = nd.rand(3, 3).numpy()
    nd.setSeed(42)
    b = nd.rand(3, 3).numpy()
    np.testing.assert_allclose(a, b)
    assert 0.0 <= a.min() and a.max() <= 1.0


def test_dtype_cast():
    a = nd.ones(2, 2).castTo("bfloat16")
    assert a.dtype == torch.bfloat16
    b = a.castTo("float32")
    assert b.numpy().dtype == np.float32


def test_equals_with_eps():
    a = NDArray([1.0, 2.0])
    b = NDArray([1.0, 2.0 + 1e-7])
    assert a.equalsWithEps(b, 1e-5)
    assert not a.equalsWithEps(NDArray([1.0, 3.0]), 1e-5)


def test_cosine_and_distances():
    a, b = NDArray([1.0, 0.0]), NDArray([0.0, 1.0])
    assert abs(nd.cosineSim(a, b)) < 1e-6
    assert abs(nd.euclideanDistance(a, b) - np.sqrt(2)) < 1e-6
    assert abs(nd.manhattanDistance(a, b) - 2.0) < 1e-6


class TestTransformsCatalog:
    """≡ nd4j Transforms/BooleanIndexing op tests vs numpy oracles."""

    def test_unary_transforms(self):
        from deeplearning4j_tpu_torch.ops import Transforms as T
        x = np.linspace(-2, 2, 9).astype(np.float32)
        assert np.allclose(np.asarray(T.exp(x)), np.exp(x), atol=1e-5)
        assert np.allclose(np.asarray(T.tanh(x)), np.tanh(x), atol=1e-5)
        assert np.allclose(np.asarray(T.relu(x)), np.maximum(x, 0))
        assert np.allclose(np.asarray(T.abs(x)), np.abs(x))
        assert np.allclose(np.asarray(T.sigmoid(x)),
                           1 / (1 + np.exp(-x)), atol=1e-5)
        assert np.allclose(np.asarray(T.hardTanh(x)), np.clip(x, -1, 1))

    def test_softmax_rows_sum_one(self):
        from deeplearning4j_tpu_torch.ops import Transforms as T
        x = np.random.default_rng(0).normal(size=(4, 7)).astype(np.float32)
        sm = np.asarray(T.softmax(x))
        assert np.allclose(sm.sum(-1), 1.0, atol=1e-5)
        assert np.allclose(np.asarray(T.logSoftmax(x)),
                           np.log(sm), atol=1e-4)

    def test_distances_and_similarity(self):
        from deeplearning4j_tpu_torch.ops import Transforms as T
        a = np.asarray([1.0, 0.0], np.float32)
        b = np.asarray([0.0, 1.0], np.float32)
        assert abs(T.cosineSim(a, a) - 1.0) < 1e-6
        assert abs(T.cosineSim(a, b)) < 1e-6
        assert abs(T.euclideanDistance(a, b) - np.sqrt(2)) < 1e-5
        assert T.manhattanDistance(a, b) == 2.0
        assert T.hammingDistance(a, b) == 2

    def test_all_euclidean(self):
        from deeplearning4j_tpu_torch.ops import Transforms as T
        a = np.random.default_rng(1).normal(size=(3, 4)).astype(np.float32)
        b = np.random.default_rng(2).normal(size=(5, 4)).astype(np.float32)
        d = np.asarray(T.allEuclideanDistances(a, b))
        expect = np.linalg.norm(a[:, None] - b[None], axis=-1)
        assert np.allclose(d, expect, atol=1e-4)

    def test_is_max(self):
        from deeplearning4j_tpu_torch.ops import Transforms as T
        x = np.asarray([[1.0, 3.0], [5.0, 2.0]], np.float32)
        assert np.array_equal(np.asarray(T.isMax(x, axis=1)),
                              [[0, 1], [1, 0]])

    def test_boolean_indexing(self):
        from deeplearning4j_tpu_torch.ops import BooleanIndexing, Conditions
        x = np.asarray([-1.0, 2.0, np.nan, 4.0], np.float32)
        fixed = np.asarray(BooleanIndexing.replaceWhere(
            x, 0.0, Conditions.isNan()))
        assert np.allclose(fixed, [-1, 2, 0, 4])
        assert BooleanIndexing.countWhere(fixed,
                                          Conditions.greaterThan(0)) == 2
        assert BooleanIndexing.anyWhere(fixed, Conditions.lessThan(0))
        assert BooleanIndexing.allWhere(fixed, Conditions.greaterThan(-5))
        assert not BooleanIndexing.allWhere(fixed,
                                            Conditions.greaterThan(0))

    def test_apply_where(self):
        from deeplearning4j_tpu_torch.ops import BooleanIndexing, Conditions
        x = np.asarray([-2.0, 3.0], np.float32)
        y = np.asarray(BooleanIndexing.applyWhere(
            x, Conditions.lessThan(0), lambda a: a * -1))
        assert np.allclose(y, [2.0, 3.0])


class TestOpCatalogRound2:
    """The op catalog's scatter, segment, shape and reduction ops vs
    numpy oracles."""

    def test_scatter_ops(self):
        ref = np.zeros((5, 3), np.float32)
        idx = np.array([0, 2, 2, 4])
        upd = np.arange(12, dtype=np.float32).reshape(4, 3)
        got = nd.scatterAdd(ref, idx, upd).numpy()
        want = ref.copy()
        np.add.at(want, idx, upd)
        np.testing.assert_allclose(got, want)
        # update: last write wins on duplicate index
        got_u = nd.scatterUpdate(ref, idx, upd).numpy()
        assert np.allclose(got_u[4], upd[3]) and np.allclose(got_u[0], upd[0])
        # duplicate index 2: LAST update wins, deterministically
        assert np.allclose(got_u[2], upd[2])
        assert np.allclose(got_u[1], 0.0) and np.allclose(got_u[3], 0.0)
        # max / min / sub
        base = np.ones((5, 3), np.float32)
        np.testing.assert_allclose(
            nd.scatterMax(base, idx, upd).numpy()[2], np.maximum(
                np.maximum(base[2], upd[1]), upd[2]))
        np.testing.assert_allclose(
            nd.scatterSub(base, idx, upd).numpy()[0], base[0] - upd[0])

    def test_segment_reductions(self):
        data = np.array([[1., 2.], [3., 4.], [5., 6.], [7., 8.]], np.float32)
        ids = np.array([0, 0, 1, 1])
        np.testing.assert_allclose(nd.segmentSum(data, ids).numpy(),
                                   [[4., 6.], [12., 14.]])
        np.testing.assert_allclose(nd.segmentMean(data, ids).numpy(),
                                   [[2., 3.], [6., 7.]])
        np.testing.assert_allclose(nd.segmentMax(data, ids).numpy(),
                                   [[3., 4.], [7., 8.]])
        np.testing.assert_allclose(nd.segmentMin(data, ids).numpy(),
                                   [[1., 2.], [5., 6.]])
        np.testing.assert_allclose(nd.segmentProd(data, ids).numpy(),
                                   [[3., 8.], [35., 48.]])
        # unsorted variant with explicit segment count (empty segment 2)
        u = nd.unsortedSegmentSum(data, np.array([1, 0, 0, 1]), 3).numpy()
        np.testing.assert_allclose(u, [[8., 10.], [8., 10.], [0., 0.]])

    def test_absolute_reductions(self):
        x = np.array([[-3., 1.], [2., -4.]], np.float32)
        a = NDArray(x)
        assert float(a.amax()) == 4.0
        assert float(a.amin()) == 1.0
        assert float(a.amean()) == 2.5
        assert float(a.asum()) == 10.0
        np.testing.assert_allclose(a.amax(0).numpy(), [3., 4.])

    def test_entropy(self):
        p = np.array([0.5, 0.25, 0.25], np.float32)
        a = NDArray(p)
        np.testing.assert_allclose(float(a.entropy()),
                                   -np.sum(p * np.log(p)), rtol=1e-6)
        np.testing.assert_allclose(float(a.shannonEntropy()), 1.5, rtol=1e-6)
        np.testing.assert_allclose(float(a.logEntropy()),
                                   np.log(-np.sum(p * np.log(p))), rtol=1e-6)

    def test_slice_and_tad(self):
        x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
        a = NDArray(x)
        np.testing.assert_array_equal(a.slice(1).numpy(), x[1])
        np.testing.assert_array_equal(a.slice(2, 1).numpy(), x[:, 2, :])
        # TADs along dim 2: iterate (dim0, dim1) in C order
        assert a.tensorsAlongDimension(2) == 6
        np.testing.assert_array_equal(a.tensorAlongDimension(0, 2).numpy(),
                                      x[0, 0, :])
        np.testing.assert_array_equal(a.tensorAlongDimension(4, 2).numpy(),
                                      x[1, 1, :])
        # TADs along (1, 2): matrices per dim-0 index
        assert a.tensorsAlongDimension(1, 2) == 2
        np.testing.assert_array_equal(a.tensorAlongDimension(1, 1, 2).numpy(),
                                      x[1])

    def test_repeat_tile_diag_methods(self):
        x = np.array([[1., 2.], [3., 4.]], np.float32)
        a = NDArray(x)
        # INDArray.repeat(dimension, repeatTimes): dimension first
        np.testing.assert_array_equal(a.repeat(0, 2).numpy(),
                                      np.repeat(x, 2, 0))
        np.testing.assert_array_equal(a.tile(2, 1).numpy(), np.tile(x, (2, 1)))
        np.testing.assert_array_equal(a.diag().numpy(), np.diag(x))

    def test_shape_utilities(self):
        x = np.arange(6, dtype=np.float32).reshape(2, 3)
        np.testing.assert_array_equal(nd.expandDims(x, 1).numpy().shape,
                                      (2, 1, 3))
        np.testing.assert_array_equal(
            nd.squeeze(nd.expandDims(x, 0), 0).numpy(), x)
        gx, gy = nd.meshgrid(np.arange(2), np.arange(3))
        np.testing.assert_array_equal(gx.numpy(),
                                      np.meshgrid(np.arange(2), np.arange(3),
                                                  indexing="ij")[0])
        np.testing.assert_array_equal(nd.triu(np.ones((3, 3))).numpy(),
                                      np.triu(np.ones((3, 3))))
        np.testing.assert_array_equal(nd.tril(np.ones((3, 3)), -1).numpy(),
                                      np.tril(np.ones((3, 3)), -1))

    def test_transforms_round2(self):
        a = np.array([1.0, -1.0], np.float32)
        b = np.array([1.0, 1.0], np.float32)
        np.testing.assert_allclose(Transforms.atan2(a, b).numpy(),
                                   np.arctan2(a, b), rtol=1e-6)
        x = np.array([7., -7.], np.float32)
        y = np.array([3., 3.], np.float32)
        np.testing.assert_allclose(Transforms.floorDiv(x, y).numpy(),
                                   np.floor_divide(x, y))
        np.testing.assert_allclose(Transforms.floorMod(x, y).numpy(),
                                   np.mod(x, y))
        np.testing.assert_allclose(Transforms.fmod(x, y).numpy(),
                                   np.fmod(x, y))
        t = np.array([True, True, False, False])
        u = np.array([True, False, True, False])
        np.testing.assert_array_equal(Transforms.and_(t, u).numpy(), t & u)
        np.testing.assert_array_equal(Transforms.or_(t, u).numpy(), t | u)
        np.testing.assert_array_equal(Transforms.xor(t, u).numpy(), t ^ u)
        np.testing.assert_array_equal(Transforms.not_(t).numpy(), ~t)


def test_nd4j_array_file_io(tmp_path):
    """≡ Nd4j.write/read (npy interchange) + writeTxt/readTxt."""
    from deeplearning4j_tpu_torch.ops.factory import nd
    a = nd.rand(3, 4, 5)
    p = str(tmp_path / "a.npy")
    nd.write(a, p)
    b = nd.read(p)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    t = str(tmp_path / "a.txt")
    nd.writeTxt(a, t)
    c = nd.readTxt(t)
    assert c.shape == a.shape
    np.testing.assert_allclose(a.numpy(), c.numpy(), atol=1e-6)


def test_writetxt_scalar_roundtrip(tmp_path):
    from deeplearning4j_tpu_torch.ops.factory import nd
    p = str(tmp_path / "s.txt")
    nd.writeTxt(nd.scalar(3.5), p)
    out = nd.readTxt(p)
    assert out.shape == ()
    assert float(out.numpy()) == 3.5


# -- the port's own semantics ------------------------------------------------
def test_inplace_writes_the_tensor_and_torch_functions_unwrap():
    t = torch.zeros(3)
    a = NDArray(t)
    a.addi(2.0).putScalar(1, 5.0)
    assert t.tolist() == [2.0, 5.0, 2.0], "in-place ops write the tensor"
    assert torch.equal(torch.exp(a), torch.exp(t))
    assert float(a.max()) == 5.0 and a.size(0) == 3
    assert isinstance(a.argmax(), torch.Tensor), "forwarded to the tensor"
    np.testing.assert_array_equal(np.asarray(a), t.numpy())
    assert a.std().shape == () and isinstance(a[1:], NDArray)


def test_entry_points_return_ndarray():
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.nn import (DenseLayer, InputType,
                                             MultiLayerNetwork,
                                             NeuralNetConfiguration,
                                             OutputLayer, Sgd)
    conf = (NeuralNetConfiguration.Builder().seed(1).updater(Sgd(0.1))
            .list().layer(DenseLayer(nOut=4, activation="tanh"))
            .layer(OutputLayer(nOut=2, lossFunction="mcxent",
                               activation="softmax"))
            .setInputType(InputType.feedForward(3)).build())
    net = MultiLayerNetwork(conf).init(device="cpu")
    x = np.ones((2, 3), np.float32)
    assert isinstance(net.output(x), NDArray)
    assert all(isinstance(a, NDArray) for a in net.feedForward(x))
    assert isinstance(net.params(), NDArray)
    assert all(isinstance(v, NDArray) for v in net.paramTable().values())
    w = net.getParam("0_W")
    assert isinstance(w, NDArray)
    w.muli(0.0)                     # writes the live parameter
    assert float(net._params["0"]["W"].abs().sum()) == 0.0
    assert isinstance(net.output(NDArray(x)), NDArray)
    ds = DataSet(x, np.eye(2, dtype=np.float32))
    assert isinstance(ds.getFeatures(), NDArray)
    assert isinstance(ds.getLabels(), NDArray)
    assert ds.getFeaturesMaskArray() is None


# -- against the JAX package ------------------------------------------------
def _jax():
    from deeplearning4j_tpu.ops import NDArray as JNDArray
    from deeplearning4j_tpu.ops import Transforms as JT
    from deeplearning4j_tpu.ops import nd as jnd
    return JNDArray, JT, jnd


_UNARY = ["exp", "log1p", "sqrt", "abs", "sign", "floor", "ceil", "round",
          "sin", "cos", "tanh", "sigmoid", "relu", "relu6", "leakyRelu",
          "elu", "softPlus", "softsign", "gelu", "swish", "mish", "erf",
          "hardSigmoid", "hardTanh", "square", "neg", "atan",
          "sigmoidDerivative", "softmax", "logSoftmax"]


@pytest.mark.parametrize("name", _UNARY)
def test_transforms_match_the_jax_package(name):
    _, JT, _ = _jax()
    x = np.random.default_rng(3).standard_normal((4, 6)).astype(np.float32)
    if name in ("sqrt", "log1p"):
        x = np.abs(x)
    got = getattr(Transforms, name)(x).numpy()
    want = np.asarray(getattr(JT, name)(x))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_ndarray_methods_match_the_jax_package():
    JNDArray, _, jnd = _jax()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 4, 5)).astype(np.float32)
    y = rng.standard_normal((3, 4, 5)).astype(np.float32)
    a, ja = NDArray(x), JNDArray(x)
    cases = {
        "sum": lambda v: v.sum(1), "mean": lambda v: v.mean(0, 2),
        "max": lambda v: v.max(2), "min": lambda v: v.min(),
        "std": lambda v: v.std(1), "var": lambda v: v.var(0, 1,
                                                          biasCorrected=False),
        "norm2": lambda v: v.norm2(2), "amax": lambda v: v.amax(1),
        "argMax": lambda v: v.argMax(2), "cumsum": lambda v: v.cumsum(1),
        "transpose": lambda v: v.transpose(),
        "permute": lambda v: v.permute(2, 0, 1),
        "repeat": lambda v: v.repeat(1, 2), "tile": lambda v: v.tile(1, 2, 1),
        "tad": lambda v: v.tensorAlongDimension(5, 1),
        "slice": lambda v: v.slice(2, 1),
        "add": lambda v: v.add(y), "rdiv": lambda v: v.rdiv(2.0),
        "gt": lambda v: v.gt(0.1), "prod": lambda v: v.prod(0, 1),
        "reshape": lambda v: v.reshape(12, 5).mmul(np.ones((5, 2),
                                                           np.float32)),
    }
    for name, fn in cases.items():
        np.testing.assert_allclose(np.asarray(fn(a)), np.asarray(fn(ja)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    ids = np.array([0, 2, 2, 1])
    data = rng.standard_normal((4, 3)).astype(np.float32)
    for name in ("segmentSum", "segmentMean", "segmentMax", "segmentMin",
                 "segmentProd"):
        np.testing.assert_allclose(
            getattr(nd, name)(data, ids, 4).numpy(),
            np.asarray(getattr(jnd, name)(data, ids, 4)), rtol=1e-6,
            err_msg=name)
    ref = np.zeros((5, 3), np.float32)
    for name in ("scatterUpdate", "scatterAdd", "scatterMax", "scatterMin"):
        np.testing.assert_allclose(
            getattr(nd, name)(ref, ids, data).numpy(),
            np.asarray(getattr(jnd, name)(ref, ids, data)), rtol=1e-6,
            err_msg=name)
    np.testing.assert_allclose(nd.oneHot([0, 5, -1, 2], 3).numpy(),
                               np.asarray(jnd.oneHot([0, 5, -1, 2], 3)))
    v, i = nd.sortWithIndices(np.array([3., 1., 3., 2.]), ascending=False)
    jv, ji = jnd.sortWithIndices(np.array([3., 1., 3., 2.]),
                                 ascending=False)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


def test_random_state_follows_the_jax_key_stream():
    from deeplearning4j_tpu.ops import RandomState as JRandomState
    from deeplearning4j_tpu_torch.ops import RandomState
    r, j = RandomState(2024), JRandomState(2024)
    for _ in range(3):
        assert r.split().tolist() == np.asarray(j.split()).tolist()
    np.testing.assert_array_equal(r.uniform((7, 9), 1.0, 3.0).numpy(),
                                  np.asarray(j.uniform((7, 9), 1.0, 3.0)))
    np.testing.assert_array_equal(r.bernoulli(0.3, (64,)).numpy(),
                                  np.asarray(j.bernoulli(0.3, (64,))))
    np.testing.assert_allclose(r.normal((4096,)).numpy(),
                               np.asarray(j.normal((4096,))), atol=1e-6)
    _, _, jnd = _jax()
    nd.setSeed(5)
    jnd.setSeed(5)
    np.testing.assert_array_equal(nd.rand(3, 4).numpy(),
                                  np.asarray(jnd.rand(3, 4)))
    # not bit for bit by design: seeded, deterministic, in range
    a, b = RandomState(1), RandomState(1)
    assert torch.equal(a.randint(0, 5, (10,)), b.randint(0, 5, (10,)))
    assert sorted(a.permutation(6).tolist()) == list(range(6))


@pytest.mark.parametrize("low, high", [(0.0, 1.0), (-0.5, 0.5), (-3.0, 7.0),
                                       (1.0, 3.0), (2.5, 2.75),
                                       (-1.0 / 60, 1.0 / 60)])
def test_random_state_uniform_matches_the_jax_package_at_any_range(low,
                                                                   high):
    """XLA contracts jax.random.uniform's u * (high - low) + low into one
    fused multiply-add; the port rounds once too (in float64, then to
    float32), so every range is bit for bit, (-3, 7) among them, and so is
    GloVe's split-then-ranged draw at ±0.5/d."""
    import jax
    from deeplearning4j_tpu.ops import RandomState as JRandomState
    from deeplearning4j_tpu_torch.ops import RandomState
    from deeplearning4j_tpu_torch.ops.random import seed_key, split, uniform
    got = RandomState(5, device="cpu").uniform((64, 64), low, high)
    want = np.asarray(JRandomState(5).uniform((64, 64), low, high))
    np.testing.assert_array_equal(got.numpy(), want)
    k1, k2 = split(seed_key(42))
    j1, j2 = jax.random.split(jax.random.PRNGKey(42))
    for tk, jk in ((k1, j1), (k2, j2)):
        np.testing.assert_array_equal(
            uniform(tk, (37, 30), "cpu", low, high).numpy(),
            np.asarray(jax.random.uniform(jk, (37, 30), minval=low,
                                          maxval=high)))


def test_random_bits_offset_draws_a_slice_of_the_whole_draw():
    from deeplearning4j_tpu_torch.ops.random import random_bits, seed_key
    whole = random_bits(seed_key(3), (11, 7), "cpu")
    rows = [random_bits(seed_key(3), (e - s, 7), "cpu", offset=s * 7)
            for s, e in ((0, 4), (4, 5), (5, 11))]
    assert torch.equal(torch.cat(rows), whole)
