"""Updater configurations: the config classes of
`deeplearning4j_tpu/nn/updaters.py` that the builders and the zoo
construct (≡ nd4j-api :: learning.config.Sgd, Nesterovs, Adam).

They only hold hyperparameters here. Turning them into an optimizer
(`build_optimizer`) comes with the training slice, which fits
ResNet-50 (ROADMAP A10).
"""
from __future__ import annotations


class Updater:
    """Base of the updater configurations."""


class Sgd(Updater):
    def __init__(self, learningRate=0.1):
        self.learningRate = learningRate


class Nesterovs(Updater):
    """≡ learning.config.Nesterovs. `momentumDtype` names the dtype of the
    momentum buffer, as in the JAX package."""

    def __init__(self, learningRate=0.1, momentum=0.9, momentumDtype=None):
        self.learningRate, self.momentum = learningRate, momentum
        self.momentumDtype = momentumDtype


class Adam(Updater):
    def __init__(self, learningRate=1e-3, beta1=0.9, beta2=0.999,
                 epsilon=1e-8):
        self.learningRate, self.beta1 = learningRate, beta1
        self.beta2, self.epsilon = beta2, epsilon
