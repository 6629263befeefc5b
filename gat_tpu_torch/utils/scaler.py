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
        self._on_device: dict[torch.device, tuple] = {}

    def transform(self, x: torch.Tensor) -> torch.Tensor:
        # mean and scale go to each device once: an upload in every call
        # would make each transform wait for the device's queue
        pair = self._on_device.get(x.device)
        if pair is None:
            pair = self._on_device[x.device] = (
                torch.from_numpy(self.mean_).to(x.device),
                torch.from_numpy(self.scale_).to(x.device))
        mean, scale = pair
        return (x - mean) / scale

    @classmethod
    def from_dict(cls, d) -> "FeatureScaler":
        return cls(d["mean"], d["scale"])
