"""The example twins (`deeplearning4j_tpu_torch/examples/`) on the CPU:
each of the 15 new twins' `main(device="cpu")` returns the facts it
prints, and its script's checks hold (pixel DQN play > 0.9, attention
accuracy > 0.8, YOLO's first detection class 1, MDN samples near ±2 for
more than half, the custom layer's round trip equal). `dqn_cartpole`
runs 1,500 of the script's 12,000 steps here; the card runs them all.
`distributed_data_parallel` and `long_context_bert` also run under two
gloo ranks (one process per device, as the port trains across devices).
Every printed loss is finite. The twins that run longest under the
suite's parallel workers have files of their own, which `--dist
loadfile` hands to other workers: `test_torch_examples_dqn.py` (the two
DQN twins) and `test_torch_examples_char_rnn.py`."""
import contextlib
import importlib
import io
import math
from pathlib import Path

import pytest

import torch_example_ranks as R

REPO = Path(__file__).resolve().parents[1]


def _run(name, **kw):
    mod = importlib.import_module(f"deeplearning4j_tpu_torch.examples.{name}")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        out = mod.main(device="cpu", **kw)
    return out, printed.getvalue()


def _finite(*xs):
    return all(math.isfinite(float(x)) for x in xs)


def test_every_script_has_a_twin():
    scripts = {p.stem for p in (REPO / "examples").glob("*.py")}
    twins = {p.stem for p in (REPO / "deeplearning4j_tpu_torch" /
                              "examples").glob("*.py")} - {"__init__"}
    assert len(scripts) == 18
    assert scripts == twins


def _check_mnist_cnn(out, printed):
    assert out["accuracy"] > 0.9 and _finite(out["score"])
    assert "Accuracy" in printed


def _check_transfer_learning(out, printed):
    assert _finite(out["base_loss"], out["fine_tuned_loss"])
    assert out["frozen_equal"]


def _check_vae_anomaly(out, printed):
    assert out["outlier_mse"] > 10 * out["inlier_mse"]


def _check_custom_layer(out, printed):
    assert out["accuracy"] > 0.9 and out["round_trip_max_diff"] == 0.0
    assert "round-tripped" in printed


def _check_mixture_density_regression(out, printed):
    assert out["near_modes"] > 0.5 and _finite(*out["nll"])
    assert len(out["samples"]) == 5


def _check_attention_sequence_classifier(out, printed):
    assert out["accuracy"] > 0.8 and _finite(out["loss"])


def _check_object_detection_yolo(out, printed):
    assert out["first_class"] == 1 and _finite(*out["losses"])
    assert out["losses"][-1] < out["losses"][0]


def _check_samediff_graph(out, printed):
    assert _finite(out["loss"], *out["grad_norms"].values())
    assert set(out["grad_norms"]) == {"w0", "w1"}


def _check_model_artifacts(out, printed):
    # the restored graph resumes mid-momentum: its step is the
    # uninterrupted graph's next one
    assert out["resumed_loss"] == out["uninterrupted_loss"]
    assert out["guessed"] == "SameDiff" and out["bytes"] > 0


def _check_hyperparameter_search(out, printed):
    assert out["candidates"] == 15 and _finite(out["loss"])
    assert set(out["best"]) == {"lr", "width"}


def _check_distributed_data_parallel(out, printed):
    assert out["world"] == 1 and out["accuracy"] > 0.9


def _check_long_context_bert(out, printed):
    assert (out["dp"], out["sp"], out["T"]) == (1, 1, 64)
    assert _finite(*out["losses"]) and len(out["losses"]) == 3


TWINS = ["mnist_cnn", "transfer_learning", "vae_anomaly", "custom_layer",
         "mixture_density_regression", "attention_sequence_classifier",
         "object_detection_yolo", "samediff_graph", "model_artifacts",
         "hyperparameter_search", "distributed_data_parallel",
         "long_context_bert"]


@pytest.mark.parametrize("name", TWINS)
def test_twin_returns_its_facts_and_its_checks_hold(name):
    out, printed = _run(name)
    globals()[f"_check_{name}"](out, printed)


def test_declarative_search_twin():
    mod = importlib.import_module(
        "deeplearning4j_tpu_torch.examples.hyperparameter_search")
    with contextlib.redirect_stdout(io.StringIO()):
        out = mod.main_declarative(device="cpu")
    assert out["candidates"] == 8 and _finite(out["loss"])
    assert set(out["best"]) == {"global.updater", "layer0.nOut"}


def test_long_context_mesh_shape_follows_the_world():
    from deeplearning4j_tpu_torch.examples.long_context_bert import \
        mesh_shape
    assert [mesh_shape(w) for w in (1, 2, 3, 4, 8)] == [
        (1, 1), (1, 2), (1, 3), (2, 2), (2, 4)]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return R.spawn(2, ["distributed_data_parallel", "long_context_bert"],
                   tmp_path_factory.mktemp("examples2"))


def _ok(results):
    for r, res in enumerate(results):
        assert "error" not in res, f"rank {r}:\n{res['error']}"
    return [res["ok"] for res in results]


def test_data_parallel_twin_under_two_gloo_ranks(two_ranks):
    outs = _ok(two_ranks["distributed_data_parallel"])
    assert [o["rank"] for o in outs] == [0, 1]
    assert all(o["world"] == 2 for o in outs)
    # the wrapper averaged the gradients: both ranks hold one model
    assert outs[0]["accuracy"] == outs[1]["accuracy"] > 0.9
    assert outs[0]["score"] == outs[1]["score"]


def test_long_context_twin_runs_the_ring_over_two_gloo_ranks(two_ranks):
    outs = _ok(two_ranks["long_context_bert"])
    assert all((o["dp"], o["sp"], o["T"]) == (1, 2, 128) for o in outs)
    assert outs[0]["losses"] == outs[1]["losses"]
    assert _finite(*outs[0]["losses"])
    assert "T=128" in two_ranks["long_context_bert"][0]["printed"]
