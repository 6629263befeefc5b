"""Classical baseline classifier, the twin of `gat_tpu/models/baselines.py`:
softmax (multinomial logistic) regression, one linear layer named `out`
as in flax, so `mlp.params_from_flax` / `params_to_flax` move its weights
and the Trainer and NotePredictor take it as they take the MLP."""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["SoftmaxRegression"]


class SoftmaxRegression(nn.Module):
    """Single linear layer → logits; with CE loss this is multinomial
    logistic regression."""

    def __init__(self, num_features: int, num_classes: int):
        super().__init__()
        self.num_features = num_features
        self._init_args = {"num_features": num_features,
                          "num_classes": num_classes}
        self.out = nn.Linear(num_features, num_classes)

    @property
    def init_args(self) -> dict:
        """The constructor's arguments, as a checkpoint records them."""
        return dict(self._init_args)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(x)
