"""Feature standardization with sklearn StandardScaler semantics:
transform(x) = (x - mean) / scale, the two arrays read from the MLP
checkpoint."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["FeatureScaler"]


class FeatureScaler:
    def __init__(self, mean, scale):
        self.mean_ = np.asarray(mean, np.float32)
        self.scale_ = np.asarray(scale, np.float32)

    def transform(self, x: torch.Tensor) -> torch.Tensor:
        mean = torch.as_tensor(self.mean_, device=x.device)
        scale = torch.as_tensor(self.scale_, device=x.device)
        return (x - mean) / scale

    @classmethod
    def from_dict(cls, d) -> "FeatureScaler":
        return cls(d["mean"], d["scale"])
