"""The port's Spark surface (`deeplearning4j_tpu_torch/spark/`) against the
JAX package's, on the CPU.

- RDD plumbing and the training masters' typed builders behave the same;
  a typo'd builder option raises at `build()` in both.
- `SparkDl4jMultiLayer` and `SparkComputationGraph` at one worker, the JAX
  network's initial parameters carried across, after 2 steps (2 batches
  of 16 from 4 partitions, Nesterovs): every parameter within ATOL of the
  JAX package's; `evaluate(rdd)` gives the same accuracy.
- Spark adds only plumbing: the port's SparkComputationGraph equals
  `ParallelWrapper` over the same `ListDataSetIterator` bit for bit, under
  either training master.
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import nn as jnn
from deeplearning4j_tpu import spark as JS
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu_torch import nn as tnn
from deeplearning4j_tpu_torch import spark as TS
from deeplearning4j_tpu_torch.datasets import DataSet as TDataSet
from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper

#: parameters after 2 steps, port against JAX package (f32 sums in another
#: order through one dense layer and the update)
ATOL = 1e-5


def _data(n=64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[(x[:, :3].argmax(-1)).astype(int)]
    return x, y


def _mlp_conf(nn):
    return (nn.NeuralNetConfiguration.Builder().seed(0)
            .updater(nn.Nesterovs(0.05, 0.9)).weightInit("xavier").list()
            .layer(nn.DenseLayer(nOut=24, activation="tanh"))
            .layer(nn.OutputLayer(nOut=3, activation="softmax",
                                  lossFunction="mcxent"))
            .setInputType(nn.InputType.feedForward(6)).build())


def _graph_conf(nn):
    return (nn.NeuralNetConfiguration.Builder().seed(0)
            .updater(nn.Nesterovs(0.05, 0.9)).weightInit("xavier")
            .graphBuilder().addInputs("in")
            .addLayer("h", nn.DenseLayer(nOut=24, activation="tanh"), "in")
            .addLayer("out", nn.OutputLayer(nOut=3, activation="softmax"),
                      "h")
            .setOutputs("out")
            .setInputTypes(nn.InputType.feedForward(6)).build())


def _tree(t):
    if isinstance(t, dict):
        return {k: _tree(v) for k, v in t.items()}
    return np.asarray(t)


def test_rdd_plumbing_equals_the_jax_package():
    outs = []
    for S in (JS, TS):
        sc = S.JavaSparkContext(S.SparkConf().setMaster("local[*]")
                                .setAppName("t").set("k", 1))
        rdd = sc.parallelize(list(range(21)), numSlices=4)
        seen = []
        rdd.foreachPartition(lambda it: seen.append(list(it)))
        outs.append((rdd.getNumPartitions(), rdd.collect(), rdd.count(),
                     rdd.map(lambda v: v * 2).collect(),
                     rdd.filter(lambda v: v % 3 == 0).count(),
                     rdd.repartition(3)._parts,
                     rdd.union(sc.parallelize([99]))._parts, seen,
                     sc.parallelize(list(range(30)))._parts,
                     sc.conf.get("k"), sc.conf.get("master")))
    assert outs[1] == outs[0]


@pytest.mark.parametrize("master", ["ParameterAveragingTrainingMaster",
                                    "SharedTrainingMaster"])
def test_training_master_builders_equal_the_jax_package(master):
    got = []
    for S in (JS, TS):
        M = getattr(S, master)
        tm = (M.Builder(4, 1).batchSizePerWorker(32).averagingFrequency(5)
              .workerPrefetchNumBatches(3).collectTrainingStats(True)
              .build())
        default = M.Builder(1).build()
        got.append((vars(tm), vars(default)))
        with pytest.raises(ValueError, match="averagingFrequancy"):
            M.Builder(1).averagingFrequancy(5).build()
        with pytest.raises(TypeError):
            M.Builder(1, 2, 3)
    assert got[1] == got[0]
    if master == "SharedTrainingMaster":
        tm = TS.SharedTrainingMaster.Builder(1).updatesThreshold(1e-4) \
            .thresholdAlgorithm("adaptive").build()
        assert tm.updatesThreshold == 1e-4


def _batches(DS, seed):
    x, y = _data(64, seed)
    return [DS(x[i:i + 8], y[i:i + 8]) for i in range(0, 32, 8)]


@pytest.mark.parametrize("kind", ["multilayer", "graph"])
def test_spark_fit_at_one_worker_equals_the_jax_package(kind):
    conf = _mlp_conf if kind == "multilayer" else _graph_conf
    jcls = JS.SparkDl4jMultiLayer if kind == "multilayer" else \
        JS.SparkComputationGraph
    tcls = TS.SparkDl4jMultiLayer if kind == "multilayer" else \
        TS.SparkComputationGraph
    jtm = JS.ParameterAveragingTrainingMaster.Builder(1, 1) \
        .batchSizePerWorker(16).build()
    ttm = TS.ParameterAveragingTrainingMaster.Builder(1, 1) \
        .batchSizePerWorker(16).build()
    jsc, tsc = JS.JavaSparkContext(), TS.JavaSparkContext()
    jspark = jcls(jsc, conf(jnn), jtm)
    jnet = jspark.getNetwork()
    tnet = (tnn.MultiLayerNetwork if kind == "multilayer" else
            tnn.ComputationGraph)(conf(tnn))
    carry = (tnn.multilayer_params_from_numpy if kind == "multilayer"
             else tnn.graph_params_from_numpy)
    carry(tnet, _tree(jnet._params), _tree(jnet._state), device="cpu")
    tspark = tcls(tsc, tnet, ttm)
    jspark.fit(jsc.parallelize(_batches(JDataSet, 1), numSlices=4))
    tspark.fit(tsc.parallelize(_batches(TDataSet, 1), numSlices=4))
    for layer, leaves in jnet._params.items():
        for name, v in leaves.items():
            np.testing.assert_allclose(
                tnet._params[layer][name].detach().numpy(), np.asarray(v),
                atol=ATOL, rtol=0, err_msg=f"{layer}.{name}")
    assert np.isclose(tspark.getScore(), jspark.getScore(), atol=ATOL)
    jev = jspark.evaluate(jsc.parallelize(_batches(JDataSet, 2)))
    tev = tspark.evaluate(tsc.parallelize(_batches(TDataSet, 2)))
    assert tev.accuracy() == jev.accuracy()


@pytest.mark.parametrize("master", ["ParameterAveragingTrainingMaster",
                                    "SharedTrainingMaster"])
def test_spark_adds_only_plumbing_over_parallel_wrapper(master):
    """SparkComputationGraph == ParallelWrapper.Builder(net).workers(1) over
    the same ListDataSetIterator, bit for bit."""
    M = getattr(TS, master)
    tm = M.Builder(16).batchSizePerWorker(16).averagingFrequency(5).build()
    nets = []
    for _ in range(2):
        torch.manual_seed(0)
        nets.append(tnn.ComputationGraph(_graph_conf(tnn)).init("cpu"))
    spark = TS.SparkComputationGraph(TS.JavaSparkContext(), nets[0], tm)
    data = _batches(TDataSet, 3)
    spark.fit(spark.sc.parallelize(data, numSlices=4), epochs=2)
    pw = ParallelWrapper.Builder(nets[1]).workers(1).prefetchBuffer(2) \
        .build()
    pw.fit(ListDataSetIterator(data, 16), epochs=2)
    for layer, leaves in nets[1]._params.items():
        for name, v in leaves.items():
            assert torch.equal(nets[0]._params[layer][name], v), \
                f"{layer}.{name}"
    # the one-worker default: the dp mesh's world (one process here)
    assert spark._wrapper().mesh.size == 1


def test_spark_builds_a_configuration_on_the_given_device():
    tm = TS.SharedTrainingMaster.Builder(1).batchSizePerWorker(8).build()
    spark = TS.SparkDl4jMultiLayer(TS.JavaSparkContext(), _mlp_conf(tnn),
                                   tm, device="cpu")
    x, y = _data(32, 4)
    rdd = spark.sc.parallelize([TDataSet(x[i:i + 8], y[i:i + 8])
                                for i in range(0, 32, 8)], numSlices=2)
    before = spark.getNetwork().score(TDataSet(x, y))
    for _ in range(10):
        spark.fit(rdd)
    assert spark.getNetwork().score(TDataSet(x, y)) < before
    with pytest.raises(ValueError, match="empty RDD"):
        spark.fit(spark.sc.parallelize([]))
