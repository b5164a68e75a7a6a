"""Special layers: the port of `CenterLossOutputLayer` of
`deeplearning4j_tpu/nn/conf/special_layers.py` (≡ deeplearning4j-nn ::
conf.layers.misc.CenterLossOutputLayer), the FaceNetNN4Small2 training
head. LocallyConnected1D/2D, the autoencoders and the variational layers
of that module come with ROADMAP A12.
"""
from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.conf.layers import (BaseOutputLayer,
                                                     DenseLayer)
from deeplearning4j_tpu_torch.nn.losses import get_loss


class CenterLossOutputLayer(BaseOutputLayer, DenseLayer):
    """≡ conf.layers.CenterLossOutputLayer — the softmax loss plus
    0.5·λ·‖f − c_y‖² pulling the features toward a center per class.

    `centers` (nOut, nIn) is a parameter, zero at init, updated by the
    network's own optimizer and left out of l1/l2. The center term splits
    into two halves with one side detached in each, so λ and α act
    independently: λ pulls the FEATURES toward the (fixed) centers, α pulls
    the CENTERS toward the (fixed) features of the batch."""

    needs_features = True

    def __init__(self, alpha=0.05, lambda_=2e-4, **kw):
        kw.setdefault("lossFunction", "mcxent")
        self.alpha = float(alpha)
        self.lambda_ = float(lambda_)
        super().__init__(**kw)

    def initialize(self, generator, input_type):
        params, state, out = super().initialize(generator, input_type)
        params = dict(params)
        params["centers"] = torch.zeros((int(self.nOut), int(self.nIn)))
        return params, state, out

    def compute_loss_with_features(self, params, labels, preact, features,
                                   mask=None):
        """The loss of `preact` plus the two center terms, `features`
        being this layer's input (after its preprocessor)."""
        base = get_loss(self.lossFunction)(labels, preact, self.activation,
                                           mask)
        centers = params["centers"].to(features.dtype)
        cy = labels @ centers                                  # (B, nIn)
        feat_pull = 0.5 * self.lambda_ * ((features - cy.detach()) ** 2
                                          ).sum(-1).mean()
        center_pull = 0.5 * self.alpha * ((features.detach() - cy) ** 2
                                          ).sum(-1).mean()
        return base + feat_pull + center_pull
