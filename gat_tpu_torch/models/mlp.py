"""MFCC-vector MLP classifier, the PyTorch twin of `gat_tpu/models/mlp.py`:

    Linear(num_features → dims[0]) → LayerNorm → LeakyReLU(0.1) → Dropout
    [halving hidden blocks while the next width is ≥ 8]
    Linear(dims[-1] → num_classes)

Submodules carry the flax layer names (`dense_0`, `ln_0`, …, `out`), so
`params_from_flax` and `params_to_flax` are a rename plus layout changes.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

__all__ = ["Dropout", "MLP", "mlp_dims", "params_from_flax",
           "params_to_flax"]


def mlp_dims(hidden_dim: int, num_hidden_layers: int) -> list[int]:
    """Hidden widths: halve until < 8 or the layer budget is spent."""
    dims = [hidden_dim]
    for _ in range(num_hidden_layers - 1):
        nxt = dims[-1] // 2
        if nxt < 8:
            break
        dims.append(nxt)
    return dims


class Dropout(nn.Dropout):
    """Dropout in flax's form (kept inputs divided by the keep rate, the
    rest 0), its mask drawn from `generator` when one is set: the trainer
    sets a seeded generator on its device.

    `rows` (n, start, stop), set by a data-parallel step, says that x is
    rows [start, stop) of a global batch of n: the mask of the whole
    batch is drawn, as one device would draw it, and these rows kept, so
    that every rank's generator stays in step and the masks are the
    single-device run's."""
    generator: torch.Generator | None = None
    rows: tuple[int, int, int] | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.p >= 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.p
        if self.rows is None or self.rows[0] == x.shape[0]:
            mask = torch.empty_like(x)
        else:
            n, start, stop = self.rows
            # the memory order the whole batch's activation would have
            fmt = (torch.channels_last if x.ndim == 4 and x.shape[1] > 1
                   and x.stride(1) == 1 else torch.contiguous_format)
            mask = torch.empty((n,) + tuple(x.shape[1:]), dtype=x.dtype,
                               device=x.device, memory_format=fmt)
        mask.bernoulli_(keep, generator=self.generator)
        if self.rows is not None and self.rows[0] != x.shape[0]:
            mask = mask[self.rows[1]:self.rows[2]]
        return torch.where(mask.bool(), x / keep, torch.zeros_like(x))


class MLP(nn.Module):
    def __init__(self, num_features: int, hidden_dim: int = 128,
                 num_hidden_layers: int = 2, num_classes: int = 47,
                 dropout: float = 0.1):
        super().__init__()
        self.num_features = num_features
        self._init_args = {"num_features": num_features,
                          "hidden_dim": hidden_dim,
                          "num_hidden_layers": num_hidden_layers,
                          "num_classes": num_classes, "dropout": dropout}
        self.n_hidden = 0
        width_in = num_features
        for i, width in enumerate(mlp_dims(hidden_dim, num_hidden_layers)):
            self.add_module(f"dense_{i}", nn.Linear(width_in, width))
            self.add_module(f"ln_{i}", nn.LayerNorm(width, eps=1e-5))
            self.n_hidden += 1
            width_in = width
        self.dropout = Dropout(dropout)
        self.out = nn.Linear(width_in, num_classes)

    @property
    def init_args(self) -> dict:
        """The constructor's arguments, as a checkpoint records them."""
        return dict(self._init_args)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_hidden):
            x = getattr(self, f"ln_{i}")(getattr(self, f"dense_{i}")(x))
            x = self.dropout(F.leaky_relu(x, 0.1))
        return self.out(x)


def params_from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """flax MLP variables (numpy trees) → MLP state_dict. Dense kernels
    are (in, out), Linear weights (out, in); LayerNorm scale → weight."""
    sd = {}
    for name, p in variables["params"].items():
        w = np.asarray(p["kernel"]).T if "kernel" in p else p["scale"]
        sd[f"{name}.weight"] = torch.from_numpy(np.array(w))
        sd[f"{name}.bias"] = torch.from_numpy(np.array(p["bias"]))
    return sd


def params_to_flax(state_dict: dict) -> dict:
    """MLP state_dict (or any {'<layer>.weight|bias': tensor} of its
    parameters) → flax variables as numpy trees: Linear weights
    (out, in) → kernels (in, out), LayerNorm weight → scale."""
    params: dict = {}
    for key, t in state_dict.items():
        name, field = key.rsplit(".", 1)
        a = t.detach().cpu().numpy()
        if field == "bias":
            params.setdefault(name, {})["bias"] = a
        elif name.startswith("ln_"):
            params.setdefault(name, {})["scale"] = a
        else:
            params.setdefault(name, {})["kernel"] = np.ascontiguousarray(a.T)
    return {"params": params}
