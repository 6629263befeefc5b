"""Mel-spectrogram CNN classifier, the PyTorch twin of
`gat_tpu/models/cnn.py`:

    num_blocks × [Conv(k, same pad) → BatchNorm → LeakyReLU(0.01)
                  → MaxPool(2) → Dropout], channels 1 → 32 → 64 → 128
    → AdaptiveAvgPool(4, 4) → Flatten (NCHW order)
    → Linear(hidden_dim) → LeakyReLU(0.01) → Dropout → Linear(num_classes)

The public input stays NHWC (N, n_mels, T, 1), as in the JAX package; the
forward moves it to NCHW for cuDNN. `F.adaptive_avg_pool2d` uses the bins
[floor(i·n/o), ceil((i+1)·n/o)) of the JAX `_adaptive_pool_matrix`,
overlapping ones included (tested).

`dtype` is the compute type, as flax's `dtype` is: the parameters stay
float32 and are cast per layer, BatchNorm normalizes in float32 and
rounds its output, the adaptive pool runs in float32 (the JAX pool is a
float32 matmul), and the logits come back as float32.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

__all__ = ["CNN", "params_from_flax"]


class CNN(nn.Module):
    def __init__(self, num_classes: int = 47, in_channels: int = 1,
                 base_channels: int = 32, num_blocks: int = 3,
                 hidden_dim: int = 256, dropout: float = 0.1,
                 kernel_size: int = 3, use_batchnorm: bool = True,
                 use_maxpool: bool = True,
                 adaptive_pool: tuple[int, int] = (4, 4),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.num_blocks = num_blocks
        self.use_batchnorm = use_batchnorm
        self.use_maxpool = use_maxpool
        self.adaptive_pool = tuple(adaptive_pool)
        self.hidden_dim = hidden_dim
        ch_in = in_channels
        for b in range(num_blocks):
            ch_out = base_channels * (2 ** b)
            self.add_module(f"conv_{b}", nn.Conv2d(
                ch_in, ch_out, kernel_size, padding=kernel_size // 2))
            if use_batchnorm:
                self.add_module(f"bn_{b}", nn.BatchNorm2d(ch_out, eps=1e-5))
            ch_in = ch_out
        self.dropout = nn.Dropout(dropout)
        flat = ch_in * self.adaptive_pool[0] * self.adaptive_pool[1]
        if hidden_dim:
            self.fc = nn.Linear(flat, hidden_dim)
            flat = hidden_dim
        self.out = nn.Linear(flat, num_classes)

    def _layer(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """A conv or dense layer in the compute dtype. Below float32 it
        runs as flax's does: input, weight and bias in that dtype, the
        bias added to the rounded product."""
        layer = getattr(self, name)
        if self.dtype == torch.float32:
            return layer(x)
        w = layer.weight.to(self.dtype)
        y = (F.conv2d(x, w, padding=layer.padding)
             if isinstance(layer, nn.Conv2d) else F.linear(x, w))
        return y + layer.bias.to(self.dtype).view(-1, *[1] * (y.ndim - 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, H=n_mels, W=T, C) NHWC → float32 logits (N,
        num_classes)."""
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        for b in range(self.num_blocks):
            x = self._layer(f"conv_{b}", x)
            if self.use_batchnorm:
                x = getattr(self, f"bn_{b}")(x.float()).to(self.dtype)
            x = F.leaky_relu(x, 0.01)
            if self.use_maxpool:
                x = F.max_pool2d(x, 2)
            x = self.dropout(x)
        x = F.adaptive_avg_pool2d(x.float(), self.adaptive_pool).flatten(1)
        if self.hidden_dim:
            x = self.dropout(F.leaky_relu(
                self._layer("fc", x.to(self.dtype)), 0.01))
        return self._layer("out", x.to(self.dtype)).float()


def params_from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """flax CNN variables (numpy trees) → CNN state_dict: conv kernels
    HWIO → OIHW, dense kernels (in, out) → (out, in), BatchNorm
    scale/bias → weight/bias and batch_stats mean/var → running stats."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    sd = {}
    for name, p in variables["params"].items():
        if name.startswith("conv_"):
            sd[f"{name}.weight"] = t(np.transpose(p["kernel"], (3, 2, 0, 1)))
        elif name.startswith("bn_"):
            sd[f"{name}.weight"] = t(p["scale"])
            stats = variables["batch_stats"][name]
            sd[f"{name}.running_mean"] = t(stats["mean"])
            sd[f"{name}.running_var"] = t(stats["var"])
            sd[f"{name}.num_batches_tracked"] = torch.tensor(0)
        else:
            sd[f"{name}.weight"] = t(np.asarray(p["kernel"]).T)
        sd[f"{name}.bias"] = t(p["bias"])
    return sd
