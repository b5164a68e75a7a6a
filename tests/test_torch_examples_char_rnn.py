"""The char-RNN example twin on the CPU (the rest of the twins:
test_torch_examples.py): its loss falls below 1.0 and it samples 81
characters."""
import pytest

from test_torch_examples import _run


def _check_char_rnn_generation(out, printed):
    assert out["loss"] < 1.0 and len(out["sampled"]) == 81


TWINS = ["char_rnn_generation"]


@pytest.mark.parametrize("name", TWINS)
def test_twin_returns_its_facts_and_its_checks_hold(name):
    out, printed = _run(name)
    globals()[f"_check_{name}"](out, printed)
