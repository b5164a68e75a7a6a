"""`$DL4J_EXEC_CACHE` on the port, as in the JAX package: a store built
without a directory keeps its manifest under the variable, an explicit ""
keeps none, and a path is taken as given. ParallelInference and
GenerationServer built without a directory therefore warm from the
manifest a first instance wrote there, and `fit` (whose training-step
store the JAX package does not have) writes nothing there."""
import os

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.models import bert as jb
from deeplearning4j_tpu.runtime import executables as jexe
from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator
from deeplearning4j_tpu_torch.generation import BertDecoder, GenerationServer
from deeplearning4j_tpu_torch.models import bert as tb
from deeplearning4j_tpu_torch.models.convert import params_from_numpy
from deeplearning4j_tpu_torch.nn import (ComputationGraph, DenseLayer,
                                         InputType, MultiLayerNetwork,
                                         NeuralNetConfiguration,
                                         OutputLayer, Sgd)
from deeplearning4j_tpu_torch.parallel.inference import (InferenceMode,
                                                         ParallelInference)
from deeplearning4j_tpu_torch.runtime import executables as texe

ENV = "DL4J_EXEC_CACHE"


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, names in os.walk(root) for f in names)


def _graph():
    conf = (NeuralNetConfiguration.Builder()
            .seed(3).updater(Sgd(0.1)).activation("tanh")
            .graphBuilder().addInputs("in")
            .setInputTypes(InputType.feedForward(5))
            .addLayer("hidden", DenseLayer(nOut=8), "in")
            .addLayer("out", OutputLayer(lossFunction="mcxent", nOut=3,
                                         activation="softmax"), "hidden")
            .setOutputs("out").build())
    return ComputationGraph(conf).init("cpu")


@pytest.mark.parametrize("directory,env", [
    (None, "env"), ("", "env"), ("path", "env"), (None, None),
    ("path", None)], ids=["none-env", "off-env", "path-env", "none",
                          "path"])
def test_store_directory_resolves_as_the_jax_packages(directory, env,
                                                      monkeypatch, tmp_path):
    if env is None:
        monkeypatch.delenv(ENV, raising=False)
    else:
        monkeypatch.setenv(ENV, str(tmp_path / "env"))
    if directory == "path":
        directory = str(tmp_path / "given")
    assert texe.ENV_CACHE_DIR == jexe.ENV_CACHE_DIR == ENV
    want = jexe.FunctionStore("fp", directory=directory).directory
    assert texe.FunctionStore("fp", "cpu", directory=directory).directory \
        == want
    assert texe.ExecutableStore(_graph(), directory=directory).directory \
        == want
    assert want == {None: str(tmp_path / "env") if env else None, "": None
                    }.get(directory, directory)


def test_parallel_inference_warms_from_the_variables_manifest(monkeypatch,
                                                              tmp_path):
    monkeypatch.setenv(ENV, str(tmp_path))
    net = _graph()
    x = np.random.default_rng(2).standard_normal((6, 5)).astype(np.float32)
    stats, answers = [], []
    for _ in range(2):
        pi = (ParallelInference.Builder(net)
              .inferenceMode(InferenceMode.BATCHED)
              .bucketLadder([1, 2, 4, 8]).build())
        try:
            stats.append(pi.warmup())
            answers.append(pi.output(x))
            assert pi.status()["executables"]["directory"] == str(tmp_path)
        finally:
            pi.shutdown()
    assert (stats[0]["compiled"], stats[0]["from_disk"]) == (4, 0)
    assert (stats[1]["compiled"], stats[1]["from_disk"]) == (0, 4)
    (manifest,) = _files(tmp_path)
    assert manifest.endswith(os.path.join(texe.model_fingerprint(net),
                                          texe.MANIFEST))
    np.testing.assert_array_equal(answers[0], answers[1])


def test_generation_server_warms_from_the_variables_manifest(monkeypatch,
                                                             tmp_path):
    monkeypatch.setenv(ENV, str(tmp_path))
    tcfg = tb.bert_tiny()
    jp = jb.init_bert_params(jb.bert_tiny(), jax.random.PRNGKey(1))
    tp = params_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    conf = dict(slots=2, cache_lengths=[16], prompt_buckets=[8], seed=3,
                superstep=1)
    warm, streams = [], []
    for _ in range(2):
        srv = GenerationServer(BertDecoder(tcfg, tp), **conf)
        try:
            warm.append(srv.warmup())
            assert srv._store.directory == str(tmp_path)
            streams.append(srv.submit([5, 17, 99], max_new_tokens=4,
                                      method="greedy").result(timeout=120))
        finally:
            srv.shutdown()
    assert warm[0]["from_disk"] == 0
    assert warm[1]["from_disk"] == warm[1]["executables"] > 0
    assert streams[0] == streams[1]
    assert len(_files(tmp_path)) == 1


@pytest.mark.parametrize("kind", ["multilayer", "graph"])
def test_fit_writes_nothing_under_the_variable(kind, monkeypatch, tmp_path):
    monkeypatch.setenv(ENV, str(tmp_path))
    if kind == "graph":
        net = _graph()
    else:
        conf = (NeuralNetConfiguration.Builder().seed(3).updater(Sgd(0.1))
                .list().layer(DenseLayer(nOut=8, activation="tanh"))
                .layer(OutputLayer(lossFunction="mcxent", nOut=3,
                                   activation="softmax"))
                .setInputType(InputType.feedForward(5)).build())
        net = MultiLayerNetwork(conf).init("cpu")
    rng = np.random.default_rng(0)
    X = rng.standard_normal((32, 5)).astype(np.float32)
    Y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 32)]
    net.fit(ArrayDataSetIterator(X, Y, 8), epochs=2)
    # the training step's store (built at the first graphed step on the
    # card) keeps no manifest
    assert net._fit_store_for().directory is None
    assert net.getIterationCount() == 8 and np.isfinite(net.score())
    assert _files(tmp_path) == []
    # the inference store beside it takes the variable
    assert texe.ExecutableStore(net).directory == str(tmp_path)


def test_lookup_returns_a_held_signatures_inputs_and_never_captures():
    store = texe.ExecutableStore(_graph())
    sig = (((2, 5), "float32"),)
    assert store.lookup(sig) is None and len(store) == 0
    store.warmup([sig])
    (static,) = store.lookup(sig)
    assert static is store.ensure(sig)[0] and tuple(static.shape) == (2, 5)
    assert store.lookup(sig, with_mask=True) is None
    assert store.lookup((((4, 5), "float32"),)) is None and len(store) == 1
    assert torch.equal(store.run(("forward", sig)), store.model._output(
        static))
