"""The port stands alone: `deeplearning4j_tpu_torch` and `chip_smoke.py`
import neither jax nor any module of the JAX package, and the port's
entry points run on the card unless the caller asks for the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import resolve
from deeplearning4j_tpu_torch.models import bert_tiny, init_bert_params
from deeplearning4j_tpu_torch.models.convert import (param_shapes,
                                                     params_from_numpy)
from deeplearning4j_tpu_torch.generation import RecurrentDecoder
from deeplearning4j_tpu_torch.models.zoo import (VGG16, LeNet, ResNet50,
                                                 TextGenerationLSTM)
from deeplearning4j_tpu_torch.nn import (ComputationGraph, MultiLayerNetwork,
                                         graph_params_from_numpy,
                                         graph_params_to_numpy,
                                         multilayer_params_from_numpy)

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "deeplearning4j_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def _forbidden(name):
    return any(name == root or name.startswith(root + ".")
               for root in ("jax", "jaxlib", "deeplearning4j_tpu"))


def test_port_sources_import_nothing_of_jax():
    assert len(PORT_FILES) > 10
    bad = []
    for path in PORT_FILES:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(REPO)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    assert not bad, bad


#: calls that load a module by name at run time
_LOOKUPS = ("sys.modules.get", "importlib.import_module", "import_module",
            "__import__")


def _jax_package_lookups(source, where):
    """`sys.modules.get(...)` / `importlib.import_module(...)` calls whose
    string literal names a module of the JAX package (and not the port's).
    Both packages are loaded in the tests, so such a lookup would quietly
    answer with the JAX package's objects."""
    bad = []
    for node in ast.walk(ast.parse(source, where)):
        if not (isinstance(node, ast.Call)
                and ast.unparse(node.func) in _LOOKUPS):
            continue
        for arg in node.args[:1]:
            for sub in ast.walk(arg):
                if (isinstance(sub, ast.Constant)
                        and isinstance(sub.value, str)
                        and _forbidden(sub.value)):
                    bad.append(f"{where}:{node.lineno} {sub.value}")
    return bad


def test_port_sources_look_up_no_module_of_the_jax_package():
    bad = []
    for path in PORT_FILES:
        bad += _jax_package_lookups(path.read_text(),
                                    str(path.relative_to(REPO)))
    assert not bad, bad
    planted = ("import sys, importlib\n"
               "a = sys.modules.get('deeplearning4j_tpu.generation.fleet')\n"
               "b = importlib.import_module('deeplearning4j_tpu.ui')\n"
               "c = sys.modules.get('deeplearning4j_tpu_torch.ui.server')\n"
               "d = sys.modules.get('deeplearning4j_tpu')\n")
    assert [b.split()[0] for b in _jax_package_lookups(planted, "x")] \
        == ["x:2", "x:3", "x:5"]


def test_the_runtime_modules_are_among_the_checked_sources():
    """The executable store and the prefetch are port modules like any
    other: the two tests around this one hold them to the same rule."""
    names = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    for module in ("executables", "pipeline", "__init__"):
        assert f"deeplearning4j_tpu_torch/runtime/{module}.py" in names


def test_the_paged_serving_modules_are_among_the_checked_sources():
    """The page allocator, the int8 codec and the typed errors are copies
    of JAX-package modules that import no jax themselves; the port's
    copies must not import the JAX package's either."""
    names = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    for module in ("generation/paging", "generation/decode",
                   "generation/server", "quantize/__init__", "quantize/core",
                   "quantize/kvcache", "resilience/errors"):
        assert f"deeplearning4j_tpu_torch/{module}.py" in names


def test_the_survivability_modules_are_among_the_checked_sources():
    """Monitoring, fault injection, the retry policy and crash reporting
    are copies of JAX-package modules that import no jax, with their
    imports re-pointed (the lazy ones inside functions too): the rule
    above walks every import node, so it holds them all."""
    names = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    for module in ("monitoring/__init__", "monitoring/state",
                   "monitoring/registry", "monitoring/tracing",
                   "monitoring/steps", "monitoring/events",
                   "monitoring/requests", "monitoring/slo",
                   "monitoring/stragglers", "monitoring/cluster",
                   "monitoring/memory", "monitoring/profiler",
                   "resilience/__init__", "resilience/faults",
                   "resilience/policy", "util/__init__",
                   "util/crash_reporting"):
        assert f"deeplearning4j_tpu_torch/{module}.py" in names


def test_the_fleet_ui_and_lint_modules_are_among_the_checked_sources():
    names = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    for module in ("generation/fleet", "ui/__init__", "ui/server",
                   "lint/__init__", "lint/_coverage", "lint/fastpath",
                   "lint/fault_coverage", "lint/event_coverage"):
        assert f"deeplearning4j_tpu_torch/{module}.py" in names


def test_the_multilayer_slice_modules_are_among_the_checked_sources():
    """MultiLayerNetwork, the training surface it shares with
    ComputationGraph, the evaluators and the iterators (copies of
    JAX-package numpy modules, their imports re-pointed) and the zoo's
    `.list()` models."""
    names = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    for module in ("nn/multilayer", "nn/_network", "nn/schedules",
                   "nn/dropout", "nn/constraints", "nn/accum",
                   "nn/updaters", "nn/losses", "nn/convert",
                   "eval/__init__", "eval/evaluation",
                   "datasets/__init__", "datasets/iterators",
                   "models/zoo/models", "models/zoo/models2"):
        assert f"deeplearning4j_tpu_torch/{module}.py" in names


def test_the_recurrent_slice_modules_are_among_the_checked_sources():
    """The recurrent, sequence and attention layers, the recurrent
    vertices, RecurrentDecoder and the server, lengthBuckets and
    TextGenerationLSTM: the two rules above hold them like every module
    of the port."""
    names = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    for module in ("nn/conf/recurrent", "nn/conf/sequence_layers",
                   "nn/conf/attention", "nn/conf/layers",
                   "nn/conf/graph_vertices", "nn/graph", "nn/multilayer",
                   "generation/decode", "generation/server",
                   "parallel/inference", "models/zoo/models",
                   "kernels/flash_attention"):
        assert f"deeplearning4j_tpu_torch/{module}.py" in names


def test_the_zoo_graph_slice_modules_are_among_the_checked_sources():
    """The YOLOv2 head, the center loss, the new layers and vertices and
    the zoo's graph models: the two rules above hold them like every
    module of the port."""
    names = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    for module in ("nn/conf/objdetect", "nn/conf/special_layers",
                   "nn/conf/layers", "nn/conf/graph_vertices", "nn/graph",
                   "nn/multilayer", "nn/_network", "nn/convert",
                   "models/zoo/__init__", "models/zoo/models",
                   "models/zoo/models2"):
        assert f"deeplearning4j_tpu_torch/{module}.py" in names



def test_the_checkpoint_and_layer_family_modules_are_among_the_checked_sources():
    """The configuration JSON, the model archives and ModelGuesser, the
    normalizers (a copy of a JAX-package numpy module) and the rest of the
    layer families: the two rules above hold them like every module of the
    port."""
    names = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    for module in ("util/serde", "util/model_serializer",
                   "util/model_guesser", "datasets/normalizers",
                   "nn/conf/variational", "nn/conf/weightnoise",
                   "nn/conf/capsules", "nn/conf/layers3d",
                   "nn/conf/samediff_layers", "nn/conf/special_layers",
                   "nn/conf/layers", "nn/convert"):
        assert f"deeplearning4j_tpu_torch/{module}.py" in names


def test_the_int8_and_training_front_end_modules_are_among_the_checked_sources():
    """The int8 path (quantize/), transfer learning, the listeners and
    early stopping, and the training statistics: copies of JAX-package
    modules with their imports re-pointed (the lazy ones too), held by the
    two rules above like every module of the port."""
    names = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    for module in ("quantize/__init__", "quantize/core", "quantize/policy",
                   "quantize/calibrate", "quantize/infer",
                   "quantize/traffic", "transfer/__init__",
                   "transfer/transfer_learning", "optimize/__init__",
                   "optimize/listeners", "optimize/early_stopping",
                   "ui/__init__", "ui/stats", "ui/server",
                   "nn/conf/layers", "nn/conf/graph_vertices",
                   "util/serde"):
        assert f"deeplearning4j_tpu_torch/{module}.py" in names


def test_the_profiler_and_import_front_end_modules_are_among_the_checked_sources():
    """The profiler's capture and its trace decoder, the Keras importer,
    SameDiff with its serialization and the TF importer (with the port's
    own copy of the protobuf codec): held by the two rules above like
    every module of the port."""
    names = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    for module in ("monitoring/profiler", "optimize/xplane",
                   "keras_import/__init__", "keras_import/keras_import",
                   "autodiff/__init__", "autodiff/tfproto",
                   "autodiff/samediff", "autodiff/graph_serde",
                   "autodiff/tf_import", "parallel/inference",
                   "runtime/pipeline", "models/convert"):
        assert f"deeplearning4j_tpu_torch/{module}.py" in names


def test_the_embedding_modules_are_among_the_checked_sources():
    """nlp/ and graph/ (the host halves copies of JAX-package modules, the
    steps in PyTorch) and the example twins: held by the two rules above
    like every module of the port."""
    names = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    for module in ("nlp/__init__", "nlp/tokenization", "nlp/vocab",
                   "nlp/word2vec", "nlp/sequence_vectors",
                   "nlp/paragraph_vectors", "nlp/glove", "nlp/fasttext",
                   "nlp/serializer", "nlp/vectorizers",
                   "nlp/cnn_sentence_iterator", "graph/__init__",
                   "graph/graph", "graph/deepwalk", "examples/__init__",
                   "examples/word2vec_text",
                   "examples/text_classification_tfidf",
                   "examples/unsupervised_analysis", "ops/random"):
        assert f"deeplearning4j_tpu_torch/{module}.py" in names


_READ_SAMEDIFF = """
import sys
from deeplearning4j_tpu_torch.autodiff import SameDiff
from deeplearning4j_tpu_torch.util.model_guesser import ModelGuesser
sd = SameDiff.load(sys.argv[1], device="cpu")
guess = ModelGuesser.loadModelGuess(sys.argv[1], device="cpu")
out = sd.outputSingle({"x": [[1.0, 2.0]]}, "y").tensor.tolist()
bad = [m for m in sys.modules if m in ("jax", "jaxlib", "deeplearning4j_tpu")
       or m.startswith(("jax.", "jaxlib.", "deeplearning4j_tpu."))]
print(type(guess).__name__, out, bad)
sys.exit(1 if bad else 0)
"""


def test_the_rl_modules_and_example_twins_are_among_the_checked_sources():
    """rl/ (mdp.py and replay.py are copies of JAX-package modules that
    import no jax: the port keeps its own) and the twin of every script
    of examples/."""
    names = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    for module in ("rl/__init__", "rl/mdp", "rl/replay", "rl/dqn",
                   "rl/conv", "rl/a3c", "rl/convert"):
        assert f"deeplearning4j_tpu_torch/{module}.py" in names
    for script in sorted((REPO / "examples").glob("*.py")):
        assert f"deeplearning4j_tpu_torch/examples/{script.name}" in names


def test_reading_a_jax_samediff_archive_imports_nothing_of_the_jax_package(
        tmp_path):
    """A JAX-written SameDiff archive (with a TF-imported op), loaded by a
    fresh interpreter that has only the port: SameDiff.load and
    ModelGuesser load no module of jax or of the JAX package."""
    from deeplearning4j_tpu.autodiff import SameDiff as JSameDiff
    sd = JSameDiff.create()
    x = sd.placeHolder("x", None, 2)
    w = sd.var("w", np.asarray([[1.0], [2.0]], np.float32))
    sd._op_named("y", "tf.relu", None, x.mmul(w))
    path = str(tmp_path / "sd.zip")
    sd.save(path)
    res = subprocess.run([sys.executable, "-c", _READ_SAMEDIFF, path],
                         capture_output=True, text=True, timeout=120,
                         cwd=str(REPO))
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.split()[0] == "SameDiff"
    assert "[[5.0]]" in res.stdout


_WRITE_JAX_ARCHIVE = """
import sys
import numpy as np
from deeplearning4j_tpu.datasets.dataset import DataSet
from deeplearning4j_tpu.datasets.normalizers import NormalizerStandardize
from deeplearning4j_tpu.nn import (Adam, DenseLayer, InputType,
                                   MultiLayerNetwork, NeuralNetConfiguration,
                                   OutputLayer)
from deeplearning4j_tpu.util.model_serializer import ModelSerializer
conf = (NeuralNetConfiguration.Builder().seed(1).updater(Adam(1e-2)).list()
        .layer(DenseLayer(nOut=4)).layer(OutputLayer(nOut=2))
        .setInputType(InputType.feedForward(3)).build())
net = MultiLayerNetwork(conf).init()
x = np.random.default_rng(0).standard_normal((8, 3)).astype(np.float32)
net.fit(DataSet(x, np.eye(2, dtype=np.float32)[[0, 1] * 4]))
norm = NormalizerStandardize()
norm.fit(DataSet(x, np.zeros((8, 2), np.float32)))
ModelSerializer.writeModel(net, sys.argv[1], normalizer=norm)
"""

_READ_ARCHIVE = """
import sys
from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.model_guesser import ModelGuesser
from deeplearning4j_tpu_torch.util.model_serializer import ModelSerializer
net = MultiLayerNetwork.load(sys.argv[1], device="cpu")
guess = ModelGuesser.loadModelGuess(sys.argv[1], device="cpu")
norm = ModelSerializer.restoreNormalizerFromFile(sys.argv[1])
assert type(norm).__module__ == "deeplearning4j_tpu_torch.datasets.normalizers"
bad = [m for m in sys.modules if m in ("jax", "jaxlib", "deeplearning4j_tpu")
       or m.startswith(("jax.", "jaxlib.", "deeplearning4j_tpu."))]
print(type(net).__name__, type(guess).__name__, type(norm).__name__, bad)
sys.exit(1 if bad else 0)
"""


def test_reading_a_jax_archive_imports_nothing_of_the_jax_package(tmp_path):
    """A JAX-written archive with a pickled normalizer, read by a fresh
    interpreter that has only the port: the model, ModelGuesser and the
    normalizer load, and neither jax nor the JAX package is imported (the
    unpickler maps the JAX normalizer onto the port's)."""
    path = str(tmp_path / "jax.zip")
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    wrote = subprocess.run([sys.executable, "-c", _WRITE_JAX_ARCHIVE, path],
                           capture_output=True, text=True, timeout=300,
                           cwd=str(REPO), env=env)
    assert wrote.returncode == 0, wrote.stdout + wrote.stderr
    read = subprocess.run([sys.executable, "-I", "-c",
                           f"import sys; sys.path.insert(0, {str(REPO)!r})\n"
                           + _READ_ARCHIVE, path],
                          capture_output=True, text=True, timeout=120,
                          cwd=str(REPO))
    assert read.returncode == 0, read.stdout + read.stderr
    assert read.stdout.split()[:3] == ["MultiLayerNetwork",
                                      "MultiLayerNetwork",
                                      "NormalizerStandardize"]

ZOO_GRAPH_MODELS = {
    "UNet": dict(inputShape=(8, 8, 3)),
    "TinyYOLO": dict(inputShape=(32, 32, 3), numClasses=2),
    "SqueezeNet": dict(inputShape=(16, 16, 3), numClasses=2),
    "Xception": dict(inputShape=(32, 32, 3), numClasses=2,
                     middleFlowBlocks=1),
    "InceptionResNetV1": dict(inputShape=(32, 32, 3), numClasses=2,
                              blocks=(1, 1, 1)),
    "YOLO2": dict(inputShape=(32, 32, 3), numClasses=2),
    "FaceNetNN4Small2": dict(inputShape=(16, 16, 3), numClasses=2),
    "NASNet": dict(inputShape=(16, 16, 3), numClasses=2, numBlocks=1,
                   filters=8, stemFilters=8),
    "EfficientNet": dict(inputShape=(16, 16, 3), numClasses=2)}


@pytest.mark.parametrize("name", sorted(ZOO_GRAPH_MODELS))
def test_zoo_graph_models_init_on_the_card_by_default(name, monkeypatch):
    """`init()` of each new zoo model places its network on the card: with
    the device check answering "available", the placement is asked for
    CUDA (and fails only where torch has no CUDA build); without a card it
    raises, naming device='cpu', which runs it on the CPU."""
    from deeplearning4j_tpu_torch.models import zoo
    model = getattr(zoo, name)(**ZOO_GRAPH_MODELS[name])
    if torch.cuda.is_available():
        assert model.init()._device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init()
    asked = []
    real = torch.Tensor.to

    def to(t, *a, **kw):
        dev = a[0] if a else kw.get("device")
        if isinstance(dev, torch.device) and dev.type == "cuda":
            asked.append(dev)
            raise RuntimeError("placed on the card")
        return real(t, *a, **kw)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.Tensor, "to", to)
    with pytest.raises(RuntimeError, match="placed on the card"):
        model.init()
    assert asked and asked[0].type == "cuda"
    monkeypatch.undo()
    assert model.init("cpu")._device.type == "cpu"


def test_recurrent_entry_points_default_to_the_card():
    conf = TextGenerationLSTM(numClasses=11, lstmLayerSize=8).conf()
    if torch.cuda.is_available():
        assert MultiLayerNetwork(conf).init()._params["0"]["W"].is_cuda
        return
    for call in (lambda: TextGenerationLSTM().init(),
                 lambda: TextGenerationLSTM().generationServer(),
                 lambda: MultiLayerNetwork(conf).init()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    net = MultiLayerNetwork(conf).init("cpu")
    assert RecurrentDecoder(net).device.type == "cpu"
    assert net.rnnTimeStep(np.zeros((1, 11), np.float32)).shape == (1, 11)


def test_multilayer_entry_points_default_to_the_card():
    conf = LeNet(numClasses=4).conf()
    if torch.cuda.is_available():
        assert MultiLayerNetwork(conf).init()._params["0"]["W"].is_cuda
        return
    for call in (lambda: MultiLayerNetwork(conf).init(),
                 lambda: LeNet().init(), lambda: VGG16().init(),
                 lambda: multilayer_params_from_numpy(
                     MultiLayerNetwork(conf), {}, {})):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    net = MultiLayerNetwork(conf).init("cpu")
    assert net._params["0"]["W"].device.type == "cpu"
    assert net.output(np.zeros((1, 28, 28, 1), np.float32)).shape == (1, 4)


def test_importing_the_port_loads_no_jax_module():
    """A fresh interpreter (isolated: no PYTHONPATH, no user site) imports
    every module of the port and chip_smoke.py."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in PORT_FILES if p.name != "__init__.py")
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'jaxlib', "
        "'deeplearning4j_tpu') or m.startswith(('jax.', 'jaxlib.', "
        "'deeplearning4j_tpu.'))]\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-I", "-c", code],
                         capture_output=True, text=True, timeout=120,
                         cwd=str(REPO))
    assert res.returncode == 0, res.stdout + res.stderr


def test_entry_points_default_to_the_card():
    cfg = bert_tiny()
    small = dict(numClasses=4, inputShape=(32, 32, 3))
    conf = ResNet50(**small).conf()
    if torch.cuda.is_available():
        assert resolve().type == "cuda"
        p = init_bert_params(cfg, seed=0)
        assert p["embeddings"]["word"].is_cuda
        assert ComputationGraph(conf).init()._params["fc"]["W"].is_cuda
        assert ResNet50(**small).init()._device.type == "cuda"
        return
    cpu_net = ResNet50(**small).init(device="cpu")
    params, state = graph_params_to_numpy(cpu_net)
    for call in (resolve, lambda: init_bert_params(cfg, seed=0),
                 lambda: params_from_numpy(cfg, _zeros(param_shapes(cfg))),
                 lambda: ComputationGraph(conf).init(),
                 lambda: ResNet50(**small).init(),
                 lambda: graph_params_from_numpy(ComputationGraph(conf),
                                                 params, state)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert resolve("cpu").type == "cpu"
    cpu = params_from_numpy(cfg, _zeros(param_shapes(cfg)), device="cpu")
    assert cpu["layers"][1]["ffn"]["down_W"].device.type == "cpu"
    assert cpu_net._params["fc"]["W"].device.type == "cpu"
    net = graph_params_from_numpy(ComputationGraph(conf), params, state,
                                  device="cpu")
    assert net.output(np.zeros((1, 32, 32, 3), np.float32)).shape == (1, 4)


def test_embedding_trainers_default_to_the_card():
    """Word2Vec, Glove, FastText, ParagraphVectors and DeepWalk make their
    tables on the card unless the builder is given device("cpu")."""
    from deeplearning4j_tpu_torch import graph, nlp
    corpus = ["a b c a b c d"] * 4
    trainers = {
        "Word2Vec": lambda: nlp.Word2Vec.Builder().minWordFrequency(1)
        .layerSize(4).iterate(corpus),
        "Glove": lambda: nlp.Glove.Builder().layerSize(4).epochs(1)
        .iterate(corpus),
        "FastText": lambda: nlp.FastText.Builder().layerSize(4)
        .bucket(16).iterate(corpus),
        "ParagraphVectors": lambda: nlp.ParagraphVectors.Builder()
        .layerSize(4).iterate(corpus),
    }

    def deepwalk(b):
        g = graph.Graph(4)
        for i in range(3):
            g.addEdge(i, i + 1)
        return b.vectorSize(4).build().fit(g, walk_length=3)

    if torch.cuda.is_available():
        for name, mk in trainers.items():
            table = "w" if name == "Glove" else "syn0"
            assert mk().build().fit().params[table].is_cuda, name
        assert deepwalk(graph.DeepWalk.Builder()).params["syn0"].is_cuda
        return
    for name, mk in trainers.items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mk().build().fit()
        fitted = mk().device("cpu").build().fit()
        table = "w" if name == "Glove" else "syn0"
        assert fitted.params[table].device.type == "cpu", name
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deepwalk(graph.DeepWalk.Builder())
    dw = deepwalk(graph.DeepWalk.Builder().device("cpu"))
    assert dw.params["syn0"].device.type == "cpu"


def _zeros(spec):
    if isinstance(spec, dict):
        return {k: _zeros(v) for k, v in spec.items()}
    if isinstance(spec, list):
        return [_zeros(v) for v in spec]
    return np.zeros(spec, np.float32)


def _rl_learners():
    from deeplearning4j_tpu_torch import rl
    hp = rl.HistoryProcessorConfiguration(historyLength=2, rescaledWidth=8,
                                          rescaledHeight=8, skipFrame=1)
    small = rl.DQNConvNetworkConfiguration(filters=(4,), kernels=((3, 3),),
                                           strides=((2, 2),), denseUnits=8)
    a3c = rl.A3CConfiguration(numEnvs=2, hiddenNodes=4, numLayers=1)
    return {
        "QLearningDiscreteDense": lambda **kw: rl.QLearningDiscreteDense(
            rl.SimpleToy(3), rl.DQNDenseNetworkConfiguration(
                numLayers=1, numHiddenNodes=4), **kw),
        "QLearningDiscreteConv": lambda **kw: rl.QLearningDiscreteConv(
            rl.PixelGridWorld(size=4, scale=2), small, hp, **kw),
        "A3CDiscreteDense": lambda **kw: rl.A3CDiscreteDense(
            lambda: rl.SimpleToy(3), a3c, **kw),
        "AsyncNStepQLearningDiscreteDense": lambda **kw:
            rl.AsyncNStepQLearningDiscreteDense(lambda: rl.SimpleToy(3),
                                                a3c, **kw),
        "A3CDiscreteConv": lambda **kw: rl.A3CDiscreteConv(
            lambda: rl.PixelGridWorld(size=4, scale=2), a3c, hp, small,
            **kw),
    }


def _learner_device(learner):
    net = getattr(learner, "net", None)
    return net._device if net is not None else learner.params["pi"][0][
        "w"].device


def test_rl_learners_default_to_the_card():
    """Every learner builds its networks on the card unless given
    device="cpu" (the DQN target network beside its online net)."""
    learners = _rl_learners()
    if torch.cuda.is_available():
        for name, mk in learners.items():
            assert _learner_device(mk()).type == "cuda", name
        return
    for name, mk in learners.items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mk()
        learner = mk(device="cpu")
        assert _learner_device(learner).type == "cpu", name
        if hasattr(learner, "target"):
            assert learner.target._device.type == "cpu"


@pytest.mark.parametrize("name", [
    "dqn_cartpole", "pixel_dqn_gridworld", "mnist_cnn",
    "transfer_learning", "vae_anomaly", "custom_layer",
    "mixture_density_regression", "char_rnn_generation",
    "attention_sequence_classifier", "object_detection_yolo",
    "samediff_graph", "model_artifacts", "hyperparameter_search",
    "distributed_data_parallel", "long_context_bert"])
def test_example_twins_default_to_the_card(name):
    """A twin's `main()` runs on the card: without one it raises before
    it trains (`main(device="cpu")` is tests/test_torch_examples.py's)."""
    import contextlib
    import importlib
    import io
    if torch.cuda.is_available():
        pytest.skip("a card is present: the twins run there (the smoke's "
                    "examples phase)")
    mod = importlib.import_module(
        f"deeplearning4j_tpu_torch.examples.{name}")
    mains = [mod.main] + ([mod.main_declarative]
                          if name == "hyperparameter_search" else [])
    for main in mains:
        with contextlib.redirect_stdout(io.StringIO()), \
                pytest.raises(RuntimeError, match="device='cpu'"):
            main()
