"""Import the reference project's PyTorch checkpoints, the twin of
`gat_tpu/models/torch_import.py`.

A reference `.ckpt` (the MLP's schema: `model` state_dict,
`model_init_args`, embedded `config`, a fitted sklearn StandardScaler,
label map and histories) is turned into the native checkpoint dict with
flax-layout numpy trees, the schema both packages read and write
(`train/checkpoint.py::save_checkpoint`). `module_from_native` builds the
port's MLP or CNN from such a dict.

The reference pickle holds an sklearn StandardScaler, and the port runs
where sklearn is not installed: `load_reference_ckpt` unpickles with a
restricted unpickler that maps that one class to `ReferenceScaler`, which
keeps the pickled attributes (`mean_`, `scale_`, ...), and refuses every
other sklearn class by name. It also maps `pathlib.WindowsPath` (the
reference was saved on Windows) to `pathlib.PosixPath`.
"""
from __future__ import annotations

import pathlib
import pickle
import types
from typing import Any, Mapping

import numpy as np
import torch

from ..utils.device import resolve_device
from . import cnn as cnn_mod, mlp as mlp_mod
from .mlp import mlp_dims

__all__ = ["ReferenceScaler", "load_reference_ckpt",
           "mlp_params_from_state_dict", "cnn_params_from_state_dict",
           "reference_ckpt_to_native", "module_from_native"]

_SKLEARN_SCALER = ("sklearn.preprocessing._data", "StandardScaler")


class ReferenceScaler:
    """A pickled sklearn StandardScaler, read without sklearn: its state
    (`mean_`, `scale_`, `var_`, ...) lands in `__dict__` as pickle leaves
    it, and nothing of sklearn's behaviour comes with it."""


class _ReferenceUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if (module, name) == _SKLEARN_SCALER:
            return ReferenceScaler
        if module.split(".")[0] == "sklearn":
            raise pickle.UnpicklingError(
                f"[load_reference_ckpt] the checkpoint holds {module}.{name}; "
                f"only {'.'.join(_SKLEARN_SCALER)} is read without sklearn")
        if name == "WindowsPath" and module in ("pathlib", "pathlib._local"):
            return pathlib.PosixPath
        return super().find_class(module, name)


def _restricted_pickle_module() -> types.ModuleType:
    """What torch.load takes as `pickle_module`: `Unpickler` and `load`."""
    mod = types.ModuleType("gat_tpu_torch_reference_pickle")
    mod.Unpickler = _ReferenceUnpickler
    mod.load = lambda f, **kw: _ReferenceUnpickler(f, **kw).load()
    return mod


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def load_reference_ckpt(path) -> dict:
    """Unpickle a reference `.ckpt` on the CPU, without sklearn."""
    return torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=_restricted_pickle_module())


def mlp_params_from_state_dict(state_dict: Mapping[str, Any],
                               hidden_dim: int, num_hidden_layers: int,
                               dropout: float = 0.1) -> dict:
    """torch `net.{i}.weight/bias` → flax {dense_i, ln_i, out} tree. The
    reference's Sequential spaces its layers by 4 with dropout (Linear,
    LayerNorm, LeakyReLU, Dropout), else by 3."""
    dims = mlp_dims(hidden_dim, num_hidden_layers)
    stride = 4 if dropout > 0 else 3
    params: dict[str, Any] = {}
    for j in range(len(dims)):
        base = j * stride
        params[f"dense_{j}"] = {
            "kernel": _np(state_dict[f"net.{base}.weight"]).T,
            "bias": _np(state_dict[f"net.{base}.bias"]),
        }
        params[f"ln_{j}"] = {
            "scale": _np(state_dict[f"net.{base + 1}.weight"]),
            "bias": _np(state_dict[f"net.{base + 1}.bias"]),
        }
    final = len(dims) * stride
    params["out"] = {
        "kernel": _np(state_dict[f"net.{final}.weight"]).T,
        "bias": _np(state_dict[f"net.{final}.bias"]),
    }
    return params


def cnn_params_from_state_dict(state_dict: Mapping[str, Any],
                               num_blocks: int = 3,
                               dropout: float = 0.1,
                               use_batchnorm: bool = True,
                               use_maxpool: bool = True) -> tuple[dict, dict]:
    """torch CNN state_dict → (params, batch_stats) flax trees: Conv2d
    weights OIHW → HWIO, Linear weights transposed (the flatten keeps
    torch's NCHW order)."""
    params: dict[str, Any] = {}
    batch_stats: dict[str, Any] = {}
    idx = 0
    for b in range(num_blocks):
        w = _np(state_dict[f"features.{idx}.weight"])
        params[f"conv_{b}"] = {
            "kernel": np.transpose(w, (2, 3, 1, 0)),
            "bias": _np(state_dict[f"features.{idx}.bias"]),
        }
        idx += 1
        if use_batchnorm:
            params[f"bn_{b}"] = {
                "scale": _np(state_dict[f"features.{idx}.weight"]),
                "bias": _np(state_dict[f"features.{idx}.bias"]),
            }
            batch_stats[f"bn_{b}"] = {
                "mean": _np(state_dict[f"features.{idx}.running_mean"]),
                "var": _np(state_dict[f"features.{idx}.running_var"]),
            }
            idx += 1
        idx += 1  # LeakyReLU
        if use_maxpool:
            idx += 1
        if dropout > 0:
            idx += 1
    # classifier: Flatten(0), Linear(1), LeakyReLU(2), Dropout(3),
    # Linear(4); without a hidden layer, Linear(1) is the output
    out_idx = 4 if dropout > 0 else 3
    key = f"classifier.{out_idx}.weight"
    if key not in state_dict:
        key = "classifier.1.weight"
    elif "classifier.1.weight" in state_dict:
        params["fc"] = {
            "kernel": _np(state_dict["classifier.1.weight"]).T,
            "bias": _np(state_dict["classifier.1.bias"]),
        }
    params["out"] = {
        "kernel": _np(state_dict[key]).T,
        "bias": _np(state_dict[key.replace("weight", "bias")]),
    }
    return params, batch_stats


def reference_ckpt_to_native(path) -> dict:
    """Reference `.ckpt` → the native checkpoint dict (embedded config,
    flax-layout variables, scaler arrays, label map, histories), ready for
    `train.checkpoint.save_checkpoint`."""
    ck = load_reference_ckpt(path)
    model_type = ck["meta"]["model_type"]
    init_args = dict(ck["model_init_args"])
    if model_type == "mlp":
        params = mlp_params_from_state_dict(
            ck["model"], init_args["hidden_dim"],
            init_args["num_hidden_layers"], init_args.get("dropout", 0.1))
        variables = {"params": params}
    else:
        params, batch_stats = cnn_params_from_state_dict(
            ck["model"], init_args.get("num_blocks", 3),
            init_args.get("dropout", 0.1),
            # the layout flags shift every features.N index
            use_batchnorm=bool(init_args.get("use_batchnorm", True)),
            use_maxpool=bool(init_args.get("use_maxpool", True)))
        variables = {"params": params, "batch_stats": batch_stats}

    cfg = ck.get("config", {})
    # non-JSON values (the reference embeds Windows paths) become strings
    model_params = {k: (v if isinstance(v, (int, float, bool, str,
                                            type(None))) else str(v))
                    for k, v in cfg.get("model", {}).get("params",
                                                         {}).items()}
    scaler = ck.get("scaler")
    native = {
        "meta": {
            "config_version": ck["meta"].get("config_version", "1.0.0"),
            "datetime": ck["meta"].get("datetime", ""),
            "model_type": model_type,
            "imported_from": str(path),
        },
        "config": {
            "features": cfg.get("features", {}),
            "model": {"type": model_type, "params": model_params},
            "target_sr": cfg.get("target_sr"),
            "clip_length": cfg.get("clip_length"),
        },
        "variables": variables,
        "model_init_args": init_args,
        "train_loss_history": list(ck.get("train_loss_history", [])),
        "train_accuracy_history": list(ck.get("train_accuracy_history", [])),
        "val_loss_history": list(ck.get("val_loss_history", [])),
        "val_accuracy_history": list(ck.get("val_accuracy_history", [])),
        "epoch": int(ck.get("epoch", 0)),
        "reverse_map": {int(k): str(v)
                        for k, v in ck.get("reverse_map", {}).items()},
        "num_classes": int(ck.get("num_classes", 0)),
        "class_names": [str(c) for c in ck.get("class_names", [])],
    }
    if scaler is not None:
        native["scaler"] = {
            "mean": np.asarray(scaler.mean_, np.float32),
            "scale": np.asarray(scaler.scale_, np.float32),
        }
    return native


def module_from_native(native: dict, device=None) -> torch.nn.Module:
    """The port's MLP or CNN from a native checkpoint dict (imported or
    loaded), its weights moved by `params_from_flax`, in eval mode on
    `device` (default the card)."""
    args = dict(native["model_init_args"])
    if native["meta"]["model_type"] == "mlp":
        model = mlp_mod.MLP(**args)
        state = mlp_mod.params_from_flax(native["variables"])
    else:
        model = cnn_mod.CNN(**args)
        state = cnn_mod.params_from_flax(native["variables"])
    model.load_state_dict(state)
    return model.to(resolve_device(device)).eval()
