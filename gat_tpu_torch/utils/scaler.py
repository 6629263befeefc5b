"""Feature standardization with sklearn StandardScaler semantics:
transform(x) = (x - mean) / scale, scale the standard deviation (ddof 0)
with zero-variance features left unscaled. Fitted on the MLP's training
features and carried in its checkpoint as two arrays."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["FeatureScaler"]


class FeatureScaler:
    def __init__(self, mean=None, scale=None):
        self.mean_ = None if mean is None else np.asarray(mean, np.float32)
        self.scale_ = None if scale is None else np.asarray(scale, np.float32)
        self._on_device: dict[torch.device, tuple] = {}

    def fit(self, x) -> "FeatureScaler":
        x = np.asarray(x, np.float64)
        self.mean_ = x.mean(axis=0).astype(np.float32)
        std = x.std(axis=0)
        std[std == 0.0] = 1.0
        self.scale_ = std.astype(np.float32)
        self._on_device.clear()
        return self

    def transform(self, x):
        """A tensor stays a tensor on its device; anything else is
        standardized as a float32 numpy array."""
        if self.mean_ is None:
            raise ValueError("[FeatureScaler] not fitted")
        if not isinstance(x, torch.Tensor):
            return (np.asarray(x, np.float32) - self.mean_) / self.scale_
        # mean and scale go to each device once: an upload in every call
        # would make each transform wait for the device's queue
        pair = self._on_device.get(x.device)
        if pair is None:
            pair = self._on_device[x.device] = (
                torch.from_numpy(self.mean_).to(x.device),
                torch.from_numpy(self.scale_).to(x.device))
        mean, scale = pair
        return (x - mean) / scale

    def fit_transform(self, x):
        return self.fit(x).transform(x)

    def to_dict(self) -> dict:
        return {"mean": self.mean_, "scale": self.scale_}

    @classmethod
    def from_dict(cls, d) -> "FeatureScaler":
        return cls(d["mean"], d["scale"])

    @classmethod
    def from_sklearn(cls, scaler) -> "FeatureScaler":
        """From any object with sklearn's fitted `mean_` and `scale_`."""
        return cls(scaler.mean_, scaler.scale_)
