"""Reference-checkpoint import (`gat_tpu_torch/models/torch_import.py`)
against gat_tpu's on checkpoints built here in the reference project's
layout: `torch.save` of a dict with the model's state_dict (`net.*` for
the MLP, `features.*` / `classifier.*` for the CNN), its init args, an
embedded config holding a Windows path, a fitted sklearn StandardScaler,
the label map and histories.

Tolerances: the native dicts equal gat_tpu's leaf for leaf (exact); labels
of both packages' Transcribers on the imported checkpoint identical; the
port's modules built from an import reproduce the reference-layout
modules' logits to 1e-5 (fp32, the same weights, another summation
order).
"""
import contextlib
import pathlib
import pickle
import sys

import numpy as np
import pytest
import torch
from torch import nn

from gat_tpu.infer import Transcriber as JTranscriber
from gat_tpu.models import torch_import as jimp
from gat_tpu_torch.config import MLP_CONFIG
from gat_tpu_torch.infer import Transcriber
from gat_tpu_torch.models import torch_import as timp
from gat_tpu_torch.models.mlp import mlp_dims
from gat_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from tests.test_torch_models import _assert_same_tree
from tests.test_torch_spectral import pluck_clips

SHIPPED_MLP = MLP_CONFIG.CHECKPOINTS_DIR / MLP_CONFIG.DEFAULT_CKPT_NAME
WIN_DIR = r"C:\gat\data\checkpoints"
# the real class even after gat_tpu's loader has rebound the name
WINDOWS_PATH = next(c for c in pathlib.Path.__subclasses__()
                    if c.__name__ == "WindowsPath")


class _WinPath:
    """Pickles as the pathlib.WindowsPath a checkpoint saved on Windows
    holds (this platform cannot build one)."""

    def __init__(self, text: str):
        self.text = text

    def __reduce__(self):
        return WINDOWS_PATH, (self.text,)


class RefMLP(nn.Module):
    """The reference MLP's layout: one Sequential `net`."""

    def __init__(self, n_in, hidden, layers, n_out, dropout):
        super().__init__()
        mods, width = [], n_in
        for d in mlp_dims(hidden, layers):
            mods += [nn.Linear(width, d), nn.LayerNorm(d), nn.LeakyReLU(0.1)]
            mods += [nn.Dropout(dropout)] if dropout > 0 else []
            width = d
        self.net = nn.Sequential(*mods, nn.Linear(width, n_out))

    def forward(self, x):
        return self.net(x)


class RefCNN(nn.Module):
    """The reference CNN's layout: `features`, an adaptive pool, then
    `classifier` (Flatten, Linear, LeakyReLU, Dropout, Linear)."""

    def __init__(self, n_out=47, base=32, blocks=3, hidden=256, dropout=0.1,
                 bn=True, pool=True):
        super().__init__()
        mods, ch = [], 1
        for b in range(blocks):
            out = base * 2 ** b
            mods.append(nn.Conv2d(ch, out, 3, padding=1))
            mods += [nn.BatchNorm2d(out)] if bn else []
            mods.append(nn.LeakyReLU(0.01))
            mods += [nn.MaxPool2d(2)] if pool else []
            mods += [nn.Dropout(dropout)] if dropout > 0 else []
            ch = out
        self.features = nn.Sequential(*mods)
        head = [nn.Flatten()]
        if hidden:
            head += [nn.Linear(ch * 16, hidden), nn.LeakyReLU(0.01)]
            head += [nn.Dropout(dropout)] if dropout > 0 else []
            ch = hidden // 16
        self.classifier = nn.Sequential(*head, nn.Linear(ch * 16, n_out))

    def forward(self, x):   # NCHW
        x = nn.functional.adaptive_avg_pool2d(self.features(x), (4, 4))
        return self.classifier(x)


def _randomize(model: nn.Module, seed: int) -> nn.Module:
    """Random weights and BatchNorm statistics from a seeded generator."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for t in model.parameters():
            t.copy_(torch.randn(t.shape, generator=g) * 0.1)
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(torch.randn(b.shape, generator=g) * 0.1)
            elif name.endswith("running_var"):
                b.copy_(torch.rand(b.shape, generator=g) + 0.5)
    return model.eval()


def _scaler(mean, scale):
    from sklearn.preprocessing import StandardScaler
    s = StandardScaler().fit(np.random.default_rng(0).normal(
        size=(50, len(mean))))
    s.mean_, s.scale_ = np.asarray(mean, np.float64), np.asarray(
        scale, np.float64)
    s.var_ = s.scale_ ** 2
    return s


def _save_reference(path, model_type, state_dict, init_args, scaler=None,
                    reverse_map=None, features=None, extra=None):
    ck = {"meta": {"model_type": model_type, "config_version": "1.0.0",
                   "datetime": "2025-03-01 12:00:00"},
          "model": state_dict,
          "model_init_args": init_args,
          "config": {"features": features or {},
                     "model": {"type": model_type,
                               "params": {"CHECKPOINTS_DIR": _WinPath(
                                   WIN_DIR), "HIDDEN_DIM": 128, "LR": 1e-3}},
                     "target_sr": 11025, "clip_length": 0.5},
          "reverse_map": reverse_map or {i: f"C{i}" for i in range(47)},
          "num_classes": 47, "class_names": ["a", "b"],
          "train_loss_history": [1.0, 0.5], "val_loss_history": [0.9],
          "train_accuracy_history": [0.5, 0.7],
          "val_accuracy_history": [0.6], "epoch": 2}
    if scaler is not None:
        ck["scaler"] = scaler
    ck.update(extra or {})
    with pytest.MonkeyPatch.context() as m:
        m.setattr(pathlib, "WindowsPath", WINDOWS_PATH)
        torch.save(ck, path)
    return path


@contextlib.contextmanager
def sklearn_blocked():
    """sklearn made unimportable, as on the card's machine."""
    with pytest.MonkeyPatch.context() as m:
        for name in [n for n in sys.modules if n.split(".")[0] == "sklearn"]:
            m.setitem(sys.modules, name, None)
        m.setitem(sys.modules, "sklearn", None)
        with pytest.raises(ImportError):
            import sklearn.preprocessing  # noqa: F401
        yield


@pytest.fixture(scope="module")
def reference_mlp_ckpt(tmp_path_factory):
    """The shipped synthetic MLP in the reference layout: its weights as a
    `net.*` state_dict, its scaler as a fitted StandardScaler."""
    shipped = load_checkpoint(SHIPPED_MLP)
    p = shipped["variables"]["params"]
    args = dict(shipped["model_init_args"])
    ref = RefMLP(args["num_features"], args["hidden_dim"],
                 args["num_hidden_layers"], args["num_classes"],
                 args["dropout"])
    sd = {}
    for j, base in enumerate(range(0, 8, 4)):
        sd[f"net.{base}.weight"] = torch.from_numpy(
            p[f"dense_{j}"]["kernel"].T.copy())
        sd[f"net.{base}.bias"] = torch.from_numpy(p[f"dense_{j}"]["bias"])
        sd[f"net.{base + 1}.weight"] = torch.from_numpy(p[f"ln_{j}"]["scale"])
        sd[f"net.{base + 1}.bias"] = torch.from_numpy(p[f"ln_{j}"]["bias"])
    sd["net.8.weight"] = torch.from_numpy(p["out"]["kernel"].T.copy())
    sd["net.8.bias"] = torch.from_numpy(p["out"]["bias"])
    ref.load_state_dict(sd)
    ref.eval()
    path = tmp_path_factory.mktemp("ref") / "mlp_v1.0.0.ckpt"
    return _save_reference(
        path, "mlp", ref.state_dict(), args,
        _scaler(shipped["scaler"]["mean"], shipped["scaler"]["scale"]),
        shipped["reverse_map"], shipped["config"]["features"]), ref


def test_import_without_sklearn_equals_gat_tpu(reference_mlp_ckpt):
    path, _ = reference_mlp_ckpt
    ref = jimp.reference_ckpt_to_native(path)
    with sklearn_blocked():
        ck = timp.load_reference_ckpt(path)
        native = timp.reference_ckpt_to_native(path)
    assert isinstance(ck["scaler"], timp.ReferenceScaler)
    assert type(ck["config"]["model"]["params"]["CHECKPOINTS_DIR"]) \
        is pathlib.PosixPath
    _assert_same_tree(native, ref)
    assert native["config"]["model"]["params"]["CHECKPOINTS_DIR"] == WIN_DIR
    np.testing.assert_array_equal(native["scaler"]["mean"],
                                  load_checkpoint(SHIPPED_MLP)["scaler"][
                                      "mean"])


def test_imported_checkpoint_through_both_transcribers(reference_mlp_ckpt,
                                                       tmp_path):
    path, ref_module = reference_mlp_ckpt
    native = timp.reference_ckpt_to_native(path)
    saved = save_checkpoint(tmp_path / "mlp_imported.gtckpt", native)
    clips = pluck_clips(0.1, seed=3)
    for use_cnn in (False, True):
        j = JTranscriber(mlp_ckpt=str(saved), use_cnn=use_cnn)
        t = Transcriber(mlp_ckpt=str(saved), use_cnn=use_cnn, device="cpu")
        ref, got = j.transcribe_clips(clips), t.transcribe_clips(clips)
        assert got["labels"] == ref["labels"]
        np.testing.assert_allclose(got["probs"], ref["probs"], atol=1e-2)
    # the imported weights are the reference module's: same logits
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(16, 65)).astype(np.float32))
    module = timp.module_from_native(native, device="cpu")
    with torch.no_grad():
        np.testing.assert_allclose(module(x).numpy(),
                                   ref_module(x).numpy(), atol=1e-5)


@pytest.mark.parametrize("layers,dropout", [(2, 0.1), (3, 0.0), (1, 0.2)])
def test_mlp_import_layouts(tmp_path, layers, dropout):
    ref = _randomize(RefMLP(65, 64, layers, 47, dropout), layers)
    args = {"num_features": 65, "hidden_dim": 64,
            "num_hidden_layers": layers, "num_classes": 47,
            "dropout": dropout}
    path = _save_reference(tmp_path / "m.ckpt", "mlp", ref.state_dict(),
                           args)
    with sklearn_blocked():
        native = timp.reference_ckpt_to_native(path)
    _assert_same_tree(native, jimp.reference_ckpt_to_native(path))
    x = torch.randn(8, 65, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        np.testing.assert_allclose(
            timp.module_from_native(native, "cpu")(x).numpy(),
            ref(x).numpy(), atol=1e-5)


@pytest.mark.parametrize("hidden,dropout,bn,pool", [
    (256, 0.1, True, True), (0, 0.1, True, True), (64, 0.0, True, True),
    (64, 0.1, False, True), (64, 0.1, True, False)])
def test_cnn_import_layouts(tmp_path, hidden, dropout, bn, pool):
    ref = _randomize(RefCNN(47, 8, 3, hidden, dropout, bn, pool), hidden)
    args = {"num_classes": 47, "in_channels": 1, "base_channels": 8,
            "num_blocks": 3, "hidden_dim": hidden, "dropout": dropout,
            "kernel_size": 3, "use_batchnorm": bn, "use_maxpool": pool,
            "adaptive_pool": [4, 4]}
    path = _save_reference(tmp_path / "c.ckpt", "cnn", ref.state_dict(),
                           args)
    native = timp.reference_ckpt_to_native(path)
    _assert_same_tree(native, jimp.reference_ckpt_to_native(path))
    assert "scaler" not in native
    x = torch.randn(4, 64, 22, 1, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        np.testing.assert_allclose(
            timp.module_from_native(native, "cpu")(x).numpy(),
            ref(x.permute(0, 3, 1, 2)).numpy(), atol=1e-5)


def test_other_sklearn_classes_are_refused(tmp_path):
    from sklearn.preprocessing import LabelEncoder
    ref = _randomize(RefMLP(65, 64, 2, 47, 0.1), 0)
    path = _save_reference(
        tmp_path / "m.ckpt", "mlp", ref.state_dict(),
        {"num_features": 65, "hidden_dim": 64, "num_hidden_layers": 2,
         "num_classes": 47, "dropout": 0.1},
        extra={"encoder": LabelEncoder().fit(["a", "b"])})
    with pytest.raises(pickle.UnpicklingError, match="LabelEncoder"):
        timp.load_reference_ckpt(path)
