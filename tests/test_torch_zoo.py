"""The rest of the zoo's `.list()` CNNs against the JAX package on the CPU:
AlexNet, VGG19 and Darknet19 (LeNet, SimpleCNN and VGG16 are in
tests/test_torch_multilayer.py), each at a small input, 10 classes, on the
JAX network's weights carried across by `multilayer_params_from_numpy`,
with its BN running statistics drawn away from (0, 1). Tolerance: forward,
the penultimate activation and score 1e-5 relative to max(1, max |JAX|)
(f32 convolutions and sums in another order)."""
import pytest

from test_torch_multilayer import (PARITY, _zoo_forward_and_score,
                                   _zoo_pair)

ZOO_REST = {"AlexNet": dict(inputShape=(64, 64, 3)),
            "VGG19": dict(inputShape=(32, 32, 3)),
            "Darknet19": dict(inputShape=(32, 32, 3))}


@pytest.mark.parametrize("name", sorted(ZOO_REST))
def test_zoo_forward_and_score_match_the_jax_package(name, monkeypatch):
    monkeypatch.setitem(PARITY, name, ZOO_REST[name])
    _zoo_forward_and_score(*_zoo_pair(name, perturb_bn=True), name)
