"""The port stands alone: `deeplearning4j_tpu_torch` and `chip_smoke.py`
import neither jax nor any module of the JAX package, and the port's
entry points run on the card unless the caller asks for the CPU."""
import ast
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
from deeplearning4j_tpu_torch.models.zoo import ResNet50
from deeplearning4j_tpu_torch.nn import (ComputationGraph,
                                         graph_params_from_numpy,
                                         graph_params_to_numpy)

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


def _zeros(spec):
    if isinstance(spec, dict):
        return {k: _zeros(v) for k, v in spec.items()}
    if isinstance(spec, list):
        return [_zeros(v) for v in spec]
    return np.zeros(spec, np.float32)
