"""The two DQN example twins on the CPU (the rest of the twins:
test_torch_examples.py): `dqn_cartpole` runs 1,500 of the script's 12,000
steps here, the card runs them all; `pixel_dqn_gridworld`'s greedy play
scores above 0.9."""
import pytest

from test_torch_examples import _run


def _check_dqn_cartpole(out, printed):
    assert out["steps"] == 1500 and out["updates"] == 1500 - 128
    assert out["episodes"] >= 10 and out["play"] >= 8
    assert "greedy play" in printed


def _check_pixel_dqn_gridworld(out, printed):
    assert out["play"] > 0.9 and out["episodes"] > 10


TWINS = ["dqn_cartpole", "pixel_dqn_gridworld"]


@pytest.mark.parametrize("name", TWINS)
def test_twin_returns_its_facts_and_its_checks_hold(name):
    kw = {"maxStep": 1500} if name == "dqn_cartpole" else {}
    out, printed = _run(name, **kw)
    globals()[f"_check_{name}"](out, printed)
