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

In train mode BatchNorm follows flax, not `nn.BatchNorm2d`: it normalizes
with the batch's biased variance, E[x²] − E[x]² in float32, and moves the
running statistics by momentum 0.1 toward the batch mean and the *biased*
variance (torch would take the unbiased one): `ops/batchnorm.py`, K13 on
the card.
`bn_reduce`, set by a data-parallel step (`parallel/sharded.py`), turns
a rank's batch moments E[x], E[x²] over its rows into the global batch's
(a differentiable weighted sum over the ranks of the `data` axis): the
batch statistics are then those of the global batch.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from ..ops.batchnorm import batch_norm_train
from .mlp import Dropout

__all__ = ["CNN", "adaptive_avg_pool_2d", "params_from_flax",
           "params_to_flax"]

_BN_MOMENTUM = 0.9  # flax's: running = 0.9 · running + 0.1 · batch


def adaptive_avg_pool_2d(x: torch.Tensor, out_hw: tuple[int, int]
                         ) -> torch.Tensor:
    """NHWC adaptive average pooling, (N, H, W, C) → (N, oh, ow, C), with
    torch's bins [floor(i·n/o), ceil((i+1)·n/o))."""
    return F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2),
                                 tuple(out_hw)).permute(0, 2, 3, 1)


class CNN(nn.Module):
    def __init__(self, num_classes: int = 47, in_channels: int = 1,
                 base_channels: int = 32, num_blocks: int = 3,
                 hidden_dim: int = 256, dropout: float = 0.1,
                 kernel_size: int = 3, use_batchnorm: bool = True,
                 use_maxpool: bool = True,
                 adaptive_pool: tuple[int, int] = (4, 4),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self._init_args = {"num_classes": num_classes,
                          "in_channels": in_channels,
                          "base_channels": base_channels,
                          "num_blocks": num_blocks, "hidden_dim": hidden_dim,
                          "dropout": dropout, "kernel_size": kernel_size,
                          "use_batchnorm": use_batchnorm,
                          "use_maxpool": use_maxpool,
                          "adaptive_pool": tuple(adaptive_pool)}
        self.num_classes = num_classes
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
        self.dropout = Dropout(dropout)
        self.bn_reduce = None
        flat = ch_in * self.adaptive_pool[0] * self.adaptive_pool[1]
        if hidden_dim:
            self.fc = nn.Linear(flat, hidden_dim)
            flat = hidden_dim
        self.out = nn.Linear(flat, num_classes)

    @property
    def init_args(self) -> dict:
        """The constructor's arguments, as a checkpoint records them."""
        return dict(self._init_args)

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

    def _batch_norm(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """BatchNorm in float32, rounded to the compute dtype: the running
        statistics in eval mode (the library layer), flax's batch
        statistics in train mode (`ops/batchnorm.py`: K13 on the card, its
        plain version on the CPU), the global batch's under `bn_reduce`."""
        bn = getattr(self, name)
        if not self.training:
            return bn(x.float()).to(self.dtype)
        return batch_norm_train(x, bn.weight, bn.bias, bn.running_mean,
                                bn.running_var, bn.eps, _BN_MOMENTUM,
                                self.bn_reduce).to(self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, H=n_mels, W=T, C) NHWC → float32 logits (N,
        num_classes)."""
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        for b in range(self.num_blocks):
            x = self._layer(f"conv_{b}", x)
            if self.use_batchnorm:
                x = self._batch_norm(f"bn_{b}", x)
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
    scale/bias → weight/bias and batch_stats mean/var → running stats
    (left out when `variables` has no batch_stats, as for a tree of
    optimizer moments)."""
    def t(a):
        return torch.from_numpy(np.array(a))  # a writable copy

    sd = {}
    stats_all = variables.get("batch_stats", {})
    for name, p in variables["params"].items():
        if name.startswith("conv_"):
            sd[f"{name}.weight"] = t(np.transpose(p["kernel"], (3, 2, 0, 1)))
        elif name.startswith("bn_"):
            sd[f"{name}.weight"] = t(p["scale"])
            if name in stats_all:
                sd[f"{name}.running_mean"] = t(stats_all[name]["mean"])
                sd[f"{name}.running_var"] = t(stats_all[name]["var"])
                sd[f"{name}.num_batches_tracked"] = torch.tensor(0)
        else:
            sd[f"{name}.weight"] = t(np.asarray(p["kernel"]).T)
        sd[f"{name}.bias"] = t(p["bias"])
    return sd


def params_to_flax(state_dict: dict) -> dict:
    """CNN state_dict (or any subset of its parameters) → flax variables
    as numpy trees, the inverse of `params_from_flax`: conv weights OIHW →
    HWIO, Linear weights (out, in) → (in, out), BatchNorm weight → scale,
    running stats → batch_stats."""
    params: dict = {}
    stats: dict = {}
    for key, t in state_dict.items():
        name, field = key.rsplit(".", 1)
        if field == "num_batches_tracked":
            continue
        a = t.detach().cpu().numpy()
        if field in ("running_mean", "running_var"):
            stats.setdefault(name, {})[field.removeprefix("running_")] = a
        elif field == "bias":
            params.setdefault(name, {})["bias"] = a
        elif name.startswith("bn_"):
            params.setdefault(name, {})["scale"] = a
        elif name.startswith("conv_"):
            params.setdefault(name, {})["kernel"] = np.ascontiguousarray(
                np.transpose(a, (2, 3, 1, 0)))
        else:
            params.setdefault(name, {})["kernel"] = np.ascontiguousarray(a.T)
    return {"params": params, "batch_stats": stats} if stats else {
        "params": params}
