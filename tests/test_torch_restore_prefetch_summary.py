"""Three contracts of the JAX package the port missed, each against the
JAX package: `ZooModel.initPretrained(path=<zip>)` restores a
ModelSerializer archive the JAX package wrote (a Keras .h5 whose layer
names match none of the model's is refused); `PrefetchIterator` can be
iterated twice (a `for` pass starts the base over) and forwards the
iterator protocol to its base; `ComputationGraph.summary()` prints the
reference's table."""
import numpy as np
import pytest
import torch


def test_init_pretrained_restores_a_zip_the_jax_package_wrote(tmp_path):
    from deeplearning4j_tpu.models.zoo.models import LeNet as JLeNet
    from deeplearning4j_tpu_torch.models.zoo.models import LeNet
    jnet = JLeNet(inputShape=(12, 12, 1), numClasses=5).init()
    path = str(tmp_path / "lenet_mnist.zip")
    jnet.save(path)
    x = np.random.default_rng(0).standard_normal(
        (3, 12, 12, 1)).astype(np.float32)
    want = np.asarray(jnet.output(x))
    net = LeNet(inputShape=(12, 12, 1), numClasses=5).initPretrained(
        path=path, device="cpu")
    got = np.asarray(net.output(torch.from_numpy(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    h5py = pytest.importorskip("h5py")
    with h5py.File(tmp_path / "w.h5", "w") as f:
        f.create_group("model_weights").create_group("nomatch")
    with pytest.raises(RuntimeError, match="no layer names"):
        LeNet().initPretrained(path=str(tmp_path / "w.h5"), device="cpu")
    with pytest.raises(RuntimeError, match="No local pretrained"):
        LeNet().initPretrained(dataset="nowhere")


def _iters(n=10, batch=4):
    from deeplearning4j_tpu.datasets.iterators import \
        ArrayDataSetIterator as JIt
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ArrayDataSetIterator
    rng = np.random.default_rng(1)
    x = rng.standard_normal((n, 3)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)]
    return JIt(x, y, batch), ArrayDataSetIterator(x, y, batch)


def test_prefetch_iterator_iterates_twice_and_forwards():
    from deeplearning4j_tpu.runtime.pipeline import \
        PrefetchIterator as JPrefetch
    from deeplearning4j_tpu_torch.runtime.pipeline import PrefetchIterator
    jbase, base = _iters()
    jpf, pf = JPrefetch(jbase, depth=2), PrefetchIterator(base, depth=2)
    try:
        for _ in range(2):
            want = [np.asarray(d.features) for d in jpf]
            got = [np.asarray(d.features) for d in pf]
            assert len(got) == len(want) == 3
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
        for name in ("resetSupported", "asyncSupported", "batch",
                     "numExamples", "totalOutcomes", "inputColumns",
                     "getPreProcessor"):
            assert getattr(pf, name)() == getattr(jpf, name)(), name
        marker = object()
        pf.setPreProcessor(marker)
        assert pf.getPreProcessor() is marker
        assert base.getPreProcessor() is marker
    finally:
        jpf.close()
        pf.close()


def test_computation_graph_summary_matches_jax():
    import deeplearning4j_tpu.nn as jnn
    from deeplearning4j_tpu.nn.conf.graph_vertices import \
        ElementWiseVertex as JEW
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
    import deeplearning4j_tpu_torch.nn as tnn
    from deeplearning4j_tpu_torch.nn import ComputationGraph
    from deeplearning4j_tpu_torch.nn.conf.graph_vertices import \
        ElementWiseVertex

    def conf(nn, EW):
        return (nn.NeuralNetConfiguration.Builder().seed(6)
                .updater(nn.Sgd(0.05)).activation("relu").graphBuilder()
                .addInputs("in")
                .addLayer("a", nn.DenseLayer.Builder().nOut(12).build(),
                          "in")
                .addLayer("b", nn.DenseLayer.Builder().nOut(12).build(),
                          "in")
                .addVertex("sum", EW("add"), "a", "b")
                .addLayer("out", nn.OutputLayer.Builder("mcxent").nOut(3)
                          .activation("softmax").build(), "sum")
                .setOutputs("out")
                .setInputTypes(nn.InputType.feedForward(6)).build())

    want = JGraph(conf(jnn, JEW)).init().summary()
    got = ComputationGraph(conf(tnn, ElementWiseVertex)).init(
        device="cpu").summary()
    assert got == want
    assert "Total params: 207" in got
