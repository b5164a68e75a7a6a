"""Spark training surface, local mode: the port of
`deeplearning4j_tpu/spark/__init__.py` (≡ dl4j-spark ::
SparkDl4jMultiLayer / SparkComputationGraph, ParameterAveraging- and
SharedTrainingMaster, over an RDD of DataSet).

The reference distributes via a Spark cluster: workers pull RDD
partitions, compute on their GPU, and synchronize through the
TrainingMaster (periodic parameter averaging, or Aeron threshold-encoded
gradient sharing). Here the API stays and the execution maps onto the
port's data-parallel step: an "RDD" is a partitioned local dataset,
"workers" are the dp ranks of `ParallelWrapper` (one per device of the
port's dp mesh: one rank per card under `torchrun`, one on a single card
or the CPU), and both training masters lower to the synchronous
all-reduce step (every-step sync is the averagingFrequency=1 /
threshold=0 case of the reference, with none of its staleness).
`averagingFrequency` and `updatesThreshold` are recorded, not applied.
Multi-host scale-out uses parallel.multihost underneath the same classes;
genuine Spark-cluster RDD ingestion stays out of scope (no JVM).

Usage parity:
    sc = JavaSparkContext(SparkConf().setMaster("local[*]"))
    rdd = sc.parallelize(list_of_datasets, numSlices=8)
    tm = (ParameterAveragingTrainingMaster.Builder(32)
          .averagingFrequency(5).batchSizePerWorker(32).build())
    sparkNet = SparkDl4jMultiLayer(sc, conf, tm)
    sparkNet.fit(rdd); net = sparkNet.getNetwork()
"""
from __future__ import annotations

import numpy as np


class SparkConf:
    """≡ org.apache.spark.SparkConf (local-mode shim)."""

    def __init__(self):
        self._conf = {}

    def setMaster(self, master):
        self._conf["master"] = master
        return self

    def setAppName(self, name):
        self._conf["appName"] = name
        return self

    def set(self, key, value):
        self._conf[key] = value
        return self

    def get(self, key, default=None):
        return self._conf.get(key, default)


class RDD:
    """Minimal RDD: a partitioned local collection (enough surface for
    the reference's training examples: parallelize → map/filter →
    fit/collect)."""

    def __init__(self, partitions):
        self._parts = [list(p) for p in partitions]

    def collect(self):
        return [x for p in self._parts for x in p]

    def count(self):
        return sum(len(p) for p in self._parts)

    def getNumPartitions(self):
        return len(self._parts)

    def map(self, fn):
        return RDD([[fn(x) for x in p] for p in self._parts])

    def filter(self, fn):
        return RDD([[x for x in p if fn(x)] for p in self._parts])

    def union(self, other):
        return RDD(self._parts + other._parts)

    @staticmethod
    def _chunk(items, n):
        """CONTIGUOUS chunks — parallelize/collect must preserve element
        order, as Spark's local mode does."""
        n = max(1, int(n))
        size = -(-len(items) // n) if items else 1
        return [items[i * size:(i + 1) * size] for i in range(n)]

    def repartition(self, n):
        return RDD(self._chunk(self.collect(), n))

    def foreachPartition(self, fn):
        for p in self._parts:
            fn(iter(p))


class JavaSparkContext:
    """≡ JavaSparkContext — local-mode: partitioned in-memory RDDs."""

    def __init__(self, conf=None):
        self.conf = conf or SparkConf().setMaster("local[*]")

    def parallelize(self, data, numSlices=None):
        data = list(data)
        n = max(1, int(numSlices) if numSlices else min(8, len(data) or 1))
        return RDD(RDD._chunk(data, n))

    def stop(self):
        pass


SparkContext = JavaSparkContext


class _TrainingMaster:
    #: accepted config keys — a typo'd builder method must FAIL at
    #: build(), like the reference's typed Java builders fail to compile
    _KNOWN = {"batchSizePerWorker", "averagingFrequency",
              "workerPrefetchNumBatches", "workers",
              "rddDataSetNumExamples", "collectTrainingStats",
              "rddTrainingApproach", "storageLevel", "repartionData",
              "repartitionData", "repartitionStrategy"}

    def __init__(self, **kw):
        unknown = set(kw) - self._KNOWN
        if unknown:
            raise ValueError(
                f"{type(self).__name__}: unknown option(s) "
                f"{sorted(unknown)} — known: {sorted(self._KNOWN)}")
        # reference default batch per worker is 16; batchSizePerWorker is
        # a SETTER in dl4j-spark, never a Builder positional arg
        self.batchSizePerWorker = int(kw.get("batchSizePerWorker", 16))
        self.averagingFrequency = int(kw.get("averagingFrequency", 1))
        self.workerPrefetchNumBatches = int(
            kw.get("workerPrefetchNumBatches", 2))
        self.workers = kw.get("workers")
        self.rddDataSetNumExamples = int(
            kw.get("rddDataSetNumExamples", 1))
        self.collectTrainingStats = bool(kw.get("collectTrainingStats",
                                                False))

    class _Builder:
        _cls = None

        def __init__(self, *args):
            # reference Builder positional forms:
            #   Builder(rddDataSetNumExamples)
            #   Builder(numWorkers, rddDataSetNumExamples)
            self._kw = {}
            if len(args) == 1:
                self._kw["rddDataSetNumExamples"] = int(args[0])
            elif len(args) == 2:
                self._kw["workers"] = int(args[0])
                self._kw["rddDataSetNumExamples"] = int(args[1])
            elif args:
                raise TypeError(
                    "Builder takes (rddDataSetNumExamples) or "
                    "(numWorkers, rddDataSetNumExamples)")

        def __getattr__(self, name):
            if name.startswith("_"):
                raise AttributeError(name)

            def setter(v):
                self._kw[name] = v
                return self

            return setter

        def build(self):
            return self._cls(**self._kw)


class ParameterAveragingTrainingMaster(_TrainingMaster):
    """≡ dl4j-spark :: ParameterAveragingTrainingMaster. The sync step IS
    the averagingFrequency=1 semantics; the configured frequency is
    recorded (and handed to ParallelWrapper, which records it) rather
    than re-introducing staleness."""

    class Builder(_TrainingMaster._Builder):
        pass


ParameterAveragingTrainingMaster.Builder._cls = \
    ParameterAveragingTrainingMaster


class SharedTrainingMaster(_TrainingMaster):
    """≡ dl4j-spark-parameterserver :: SharedTrainingMaster (threshold-
    encoded gradient sharing). Thresholds are recorded; the dp step
    all-reduces exact gradients every step — the threshold=0 limit."""

    _KNOWN = _TrainingMaster._KNOWN | {"updatesThreshold",
                                       "thresholdAlgorithm",
                                       "batchSize"}

    def __init__(self, **kw):
        super().__init__(**{k: v for k, v in kw.items()
                            if k in _TrainingMaster._KNOWN})
        unknown = set(kw) - self._KNOWN
        if unknown:
            raise ValueError(
                f"SharedTrainingMaster: unknown option(s) "
                f"{sorted(unknown)}")
        self.updatesThreshold = float(kw.get("updatesThreshold", 1e-3))
        self.rddTrainingApproach = kw.get("rddTrainingApproach", "Export")

    class Builder(_TrainingMaster._Builder):
        pass


SharedTrainingMaster.Builder._cls = SharedTrainingMaster


class SparkDl4jMultiLayer:
    """≡ dl4j-spark :: SparkDl4jMultiLayer — fit a MultiLayerNetwork from
    an RDD<DataSet> through ParallelWrapper's dp step. A configuration is
    built on `device` (the card unless "cpu")."""

    _is_graph = False

    def __init__(self, sc, conf_or_net, trainingMaster, device=None):
        self.sc = sc
        self.tm = trainingMaster
        net = conf_or_net
        if not hasattr(net, "fit"):        # a configuration: build it
            if self._is_graph:
                from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
                net = ComputationGraph(net)
            else:
                from deeplearning4j_tpu_torch.nn.multilayer import \
                    MultiLayerNetwork
                net = MultiLayerNetwork(net)
        if net._params is None:
            net.init(device=device)
        self.net = net

    def getNetwork(self):
        return self.net

    def _iterator(self, rdd):
        from deeplearning4j_tpu_torch.datasets.iterators import \
            ListDataSetIterator
        data = rdd.collect() if isinstance(rdd, RDD) else list(rdd)
        if not data:
            raise ValueError("fit(): empty RDD")
        return ListDataSetIterator(data, self.tm.batchSizePerWorker)

    def _wrapper(self):
        """Built once: mesh construction + param replication must not be
        paid per fit() call (the epoch-loop idiom calls fit repeatedly)."""
        pw = getattr(self, "_pw", None)
        if pw is None:
            from deeplearning4j_tpu_torch.parallel import mesh
            from deeplearning4j_tpu_torch.parallel.wrapper import \
                ParallelWrapper
            n = self.tm.workers or mesh._world()[0]
            pw = self._pw = (
                ParallelWrapper.Builder(self.net)
                .workers(n)
                .prefetchBuffer(self.tm.workerPrefetchNumBatches)
                .averagingFrequency(self.tm.averagingFrequency)
                .build())
        return pw

    def fit(self, rdd, epochs=1):
        self._wrapper().fit(self._iterator(rdd), epochs=epochs)
        return self.net

    def evaluate(self, rdd, evaluation=None):
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
        ev = evaluation or Evaluation()
        for ds in self._iterator(rdd):
            preds = self.net.output(ds.features)
            mask = getattr(ds, "labelsMask", None)
            ev.eval(ds.labels, np.asarray(preds.numpy()), mask)
        return ev

    def getScore(self):
        return float(self.net.score())


class SparkComputationGraph(SparkDl4jMultiLayer):
    """≡ dl4j-spark :: SparkComputationGraph — the graph twin."""

    _is_graph = True


__all__ = ["SparkConf", "SparkContext", "JavaSparkContext", "RDD",
           "ParameterAveragingTrainingMaster", "SharedTrainingMaster",
           "SparkDl4jMultiLayer", "SparkComputationGraph"]
