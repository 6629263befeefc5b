"""The port's TrainingManager end to end on the CPU (a tiny synthetic
dataset), its dataset guards, and the trained checkpoints loaded by both
packages' Transcribers."""
import os
from pathlib import Path

import numpy as np
import pytest

from gat_tpu.infer import Transcriber as JTranscriber
from gat_tpu_torch import features as tfeatures
from gat_tpu_torch.config import CHECKPOINTS_ROOT
from gat_tpu_torch.data.modal import render_modal_dataset
from gat_tpu_torch.data.synth import synthesize_note_dataset
from gat_tpu_torch.infer import Transcriber
from gat_tpu_torch.train import TrainingManager
from gat_tpu_torch.train import trainer as ttrainer

CLASSES = ["E2", "A2", "D3", "G3"]


def _tree(root: Path) -> dict:
    return {str(p): (p.stat().st_mtime_ns, p.stat().st_size)
            for p in root.rglob("*") if p.is_file()}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """train_all on 4 classes x 10 variants of the shipped recipe, 3
    epochs, saved under the default names into a temporary torch root."""
    root = tmp_path_factory.mktemp("datasets")
    synthesize_note_dataset(root / "synthetic" / "tiny", class_names=CLASSES,
                            variants_per_class=10, seed=42, verbose=False,
                            noise_snr_db=(8.0, 40.0), family="all3",
                            stressor="mix", stressor_prob=0.5,
                            channel="mix", channel_prob=0.25)
    mgr = TrainingManager(datasets_root=root, target_sr=11025, device="cpu")
    shipped_before = _tree(CHECKPOINTS_ROOT)
    ckpt = tmp_path_factory.mktemp("ckpt")
    old = ttrainer.TORCH_CHECKPOINTS_ROOT
    ttrainer.TORCH_CHECKPOINTS_ROOT = ckpt / "torch"
    try:
        mlp, cnn = mgr.train_all("tiny", epochs=3, save=True, verbose=False)
    finally:
        ttrainer.TORCH_CHECKPOINTS_ROOT = old
    return dict(root=root, mgr=mgr, mlp=mlp, cnn=cnn, ckpt=ckpt / "torch",
                shipped_before=shipped_before)


def test_train_all_end_to_end(trained):
    mlp, cnn = trained["mlp"], trained["cnn"]
    for t in (mlp, cnn):
        assert t.epoch == 3 and len(t.val_loss_history) == 3
        assert np.isfinite(t.train_loss_history).all()
        assert t.reverse_map == dict(enumerate(sorted(CLASSES)))
        assert str(t.device) == "cpu"
    import torch
    assert cnn.model.dtype == torch.bfloat16  # CNN_CONFIG.USE_AMP
    assert mlp.scaler is not None and mlp.model.num_features == 65
    assert set(mlp.stage_seconds) == {"load_features", "train"}
    names = sorted(str(p.relative_to(trained["ckpt"]))
                   for p in trained["ckpt"].rglob("*.npz"))
    assert names == ["cnn/cnn_v1.0.0.gtckpt.npz",
                     "mlp/mlp_synth_v1.0.0.gtckpt.npz"]


def test_nothing_written_to_shipped_checkpoints(trained):
    assert _tree(CHECKPOINTS_ROOT) == trained["shipped_before"]
    for t, family in ((trained["mlp"], "mlp"), (trained["cnn"], "cnn")):
        assert t._ckpt_defaults()[0] == CHECKPOINTS_ROOT / "torch" / family


@pytest.mark.parametrize("package", ["torch", "jax"])
def test_checkpoints_load_in_both_transcribers(trained, package):
    """The port's checkpoints in either package's Transcriber: with all
    weight on one model, transcribe_clips gives that trainer's
    predictions."""
    mlp, cnn = trained["mlp"], trained["cnn"]
    mlp_path = trained["ckpt"] / "mlp" / "mlp_synth_v1.0.0.gtckpt.npz"
    cnn_path = trained["ckpt"] / "cnn" / "cnn_v1.0.0.gtckpt.npz"
    loader = trained["mgr"]._get_loader(trained["root"] / "synthetic" / "tiny")
    clips = np.stack(loader.load_audio_dataset()[0])[:16]
    fb = tfeatures.FeatureBuilder(device="cpu")

    class Clips:
        target_sr = 11025

        def load_audio_dataset(self, pad_to_max=True):
            return list(clips), None, ["E2"] * len(clips), None
    mf = fb.extract_mfcc_features(Clips())[0]
    mel = fb.extract_melspec_features(Clips())[0]
    want = {0.0: mlp.predict(mlp.scaler.transform(mf)),
            1.0: cnn.predict(mel)}
    for w, pred in want.items():
        if package == "torch":
            t = Transcriber(mlp_ckpt=mlp_path, cnn_ckpt=cnn_path,
                            cnn_weight=w, device="cpu")
            labels = t.transcribe_clips(clips)["labels"]
        else:
            t = JTranscriber(mlp_ckpt=str(mlp_path), cnn_ckpt=str(cnn_path),
                             cnn_weight=w)
            labels = t.transcribe_clips(clips)["labels"]
        assert t.ckpt_sr == 11025
        assert labels == [mlp.reverse_map[int(i)] for i in pred]


def test_eval_only_dataset_refused(trained, tmp_path):
    render_modal_dataset(tmp_path / "modal", class_names=CLASSES[:2],
                         variants_per_class=1, duration=0.1)
    with pytest.raises(ValueError, match="EVAL-ONLY"):
        trained["mgr"].train_mlp(dataset=tmp_path / "modal", verbose=False)


def test_regenerated_directory_is_read_again(tmp_path):
    ds = tmp_path / "ds"
    kw = dict(class_names=CLASSES[:2], variants_per_class=2, duration=0.5,
              verbose=False, family="additive")
    synthesize_note_dataset(ds, seed=1, **kw)
    mgr = TrainingManager(target_sr=11025, device="cpu")
    first = mgr._get_loader(ds)
    assert mgr._get_loader(ds) is first
    a = first.load_audio_dataset()[0][0].copy()
    synthesize_note_dataset(ds, seed=2, **kw)
    for p in ds.rglob("*.wav"):  # a regeneration in the same tick
        os.utime(p, ns=(p.stat().st_atime_ns, p.stat().st_mtime_ns + 10**6))
    second = mgr._get_loader(ds)
    assert second is not first
    assert not np.array_equal(second.load_audio_dataset()[0][0], a)


def test_choose_dataset_forms(trained):
    mgr = trained["mgr"]
    tiny = trained["root"] / "synthetic" / "tiny"
    assert mgr._choose_dataset("tiny") == tiny
    assert mgr._choose_dataset("synthetic/tiny") == tiny
    assert mgr._choose_dataset(0) == tiny
    assert mgr._choose_dataset(tiny) == tiny
    with pytest.raises(FileNotFoundError):
        mgr._choose_dataset(3)
    with pytest.raises(FileNotFoundError):
        mgr._choose_dataset("no_such_dataset")


def test_train_synthetic_entry_point(tmp_path, monkeypatch):
    """`python -m gat_tpu_torch.train.synthetic` on 4 classes: the
    dataset under DATASETS_ROOT/synthetic/<tag>, recipe-tagged checkpoint
    names under the torch root, the stage times and accuracies."""
    from gat_tpu_torch import config
    from gat_tpu_torch.data import synth
    from gat_tpu_torch.train import synthetic
    monkeypatch.setattr(synth, "DEFAULT_CLASS_NAMES", CLASSES)
    monkeypatch.setattr(config, "DATASETS_ROOT", tmp_path / "datasets")
    monkeypatch.setattr(ttrainer, "TORCH_CHECKPOINTS_ROOT", tmp_path / "torch")
    out = synthetic.main(["--model", "all", "--epochs", "2", "--variants",
                          "6", "--noise", "--device", "cpu"])
    assert (tmp_path / "datasets/synthetic/ks47_v6_noisy").is_dir()
    assert out["synthesis_s"] > 0
    for family, name in (("cnn", "cnn_noisy_v6_s42_e2.gtckpt.npz"),
                         ("mlp", "mlp_synth_noisy_v6_s42_e2.gtckpt.npz")):
        assert out[family]["epochs"] == 2
        assert 0.0 <= out[family]["val_acc"] <= 1.0
        assert out[family]["load_features"] > 0 and out[family]["train"] > 0
        assert Path(out[family]["path"]) == tmp_path / "torch" / family / name


def test_train_synthetic_canonical_names():
    from gat_tpu_torch.train import synthetic
    args = synthetic.parse_args(
        ["--model", "all", "--noise", "--variants", "48", "--family", "all3",
         "--stressor_prob", "0.5", "--channel_prob", "0.25"])
    assert synthetic._is_canonical(args)
    assert (synthetic._dataset_tag(args)
            == "ks47_v48_noisy_str0.5_all3_ch0.25")
    args.epochs = 3
    assert not synthetic._is_canonical(args)
    assert (synthetic._recipe_name(args, "cnn")
            == "cnn_noisy_v48_s42_e3_str0.5_all3_ch0.25.gtckpt.npz")
