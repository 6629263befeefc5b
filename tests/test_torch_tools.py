"""The port's twins of the JAX package's tools against those tools on the
CPU: `tools/torch_inspect_ckpt.py`, `torch_dataset_creator.py`,
`torch_eda.py`, `torch_cross_family_eval.py`, `torch_train_wall.py` and
the shims `torch_serve.py` and `torch_train_synthetic.py`.

Tolerances: inspect summaries, slice-all's onsets, file names and clip
bytes, pitch-dataset trees, counts, synthesized WAVs, eda's counts,
per-WAV stats and audio report identical (per-WAV stats within 1e-6
where a file is resampled: the two resamplers agree to that); the
feature report's statistics and the feature matrix behind it within
1e-3 (the MFCC features' bound, as in tests/test_torch_evaluate.py), its
counts, labels and classes identical; cross-family MFCC
features within 1e-3 of JAX's, before and after the scaler, mel images
within 0.1 dB where JAX's reads above -60 dB (the dataset bound of
tests/test_torch_train_data.py), and every accuracy identical, with the
JAX trainer's weights carried across.
"""
import importlib.util
import re
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from gat_tpu.data import synth as jsynth
from gat_tpu_torch.config import CHECKPOINTS_ROOT, CNN_CONFIG, MLP_CONFIG
from gat_tpu_torch.data import synth as tsynth
from gat_tpu_torch.utils.wavio import write_wav
from emulated_kernels import pluck_riff

REPO = Path(__file__).resolve().parent.parent
TOOLS = REPO / "tools"
CLASSES = ["E2", "A2", "D3", "G3"]
CKPTS = sorted(MLP_CONFIG.CHECKPOINTS_DIR.glob("*.gtckpt.npz")) + sorted(
    CNN_CONFIG.CHECKPOINTS_DIR.glob("*.gtckpt.npz"))


def _tool(name: str):
    spec = importlib.util.spec_from_file_location(f"_tool_{name}",
                                                  TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


# ---------------------------------------------------------------------------
# inspect_ckpt
# ---------------------------------------------------------------------------
jinspect, tinspect = _tool("inspect_ckpt"), _tool("torch_inspect_ckpt")


def test_five_checkpoints_shipped():
    assert len(CKPTS) == 5


@pytest.mark.parametrize("histories", [False, True])
@pytest.mark.parametrize("path", CKPTS, ids=lambda p: p.name)
def test_inspect_summary_matches(path, histories):
    assert (tinspect.summarize(path, histories)
            == jinspect.summarize(path, histories))


def test_inspect_known_values():
    mlp = MLP_CONFIG.CHECKPOINTS_DIR
    assert tinspect.summarize(mlp / "mlp_synth_v1.0.0.gtckpt.npz")[
        "n_params"] == 20143
    info = tinspect.summarize(mlp / "mlp_v1.0.0.gtckpt.npz")
    assert info["epoch"] == 7 and info["has_scaler"]


def test_inspect_main_prints_as_jax(capsys, monkeypatch):
    paths = [str(p) for p in CKPTS[:2]]
    monkeypatch.setattr(sys, "argv", ["inspect_ckpt.py", "--histories",
                                      *paths])
    assert jinspect.main() == 0
    ref = capsys.readouterr().out
    assert tinspect.main(["--histories", *paths]) == 0
    assert capsys.readouterr().out == ref


# ---------------------------------------------------------------------------
# dataset_creator
# ---------------------------------------------------------------------------
jcreator = _tool("dataset_creator")
tcreator = _tool("torch_dataset_creator")


def _raw(root: Path, sr: int) -> Path:
    """Two String_/Fret_ recordings at `sr` and one in a folder that
    slice-all's glob skips."""
    for i, (s, f) in enumerate(((6, 0), (2, 3))):
        d = root / f"String_{s}" / f"Fret_{f}"
        d.mkdir(parents=True)
        write_wav(d / "take.wav", pluck_riff(sr, 3.2 + 0.5 * i), sr)
    (root / "other").mkdir()
    write_wav(root / "other" / "x.wav", pluck_riff(sr, 2.0), sr)
    return root


@pytest.mark.parametrize("sr", [44100, 48000, 22050])
def test_slice_all_matches(tmp_path, sr, capsys):
    raw = _raw(tmp_path / "raw", sr)
    n_j = jcreator.slice_all_clips(raw, tmp_path / "j")
    out_j = capsys.readouterr().out
    n_t = tcreator.slice_all_clips(raw, tmp_path / "t", device="cpu")
    out_t = capsys.readouterr().out
    assert n_t == n_j > 0
    assert out_t.replace("/t/", "/j/") == out_j.replace("/t/", "/j/")
    got, ref = _tree(tmp_path / "t"), _tree(tmp_path / "j")
    assert list(got) == list(ref) and got == ref


def test_slice_all_cli(tmp_path):
    raw = _raw(tmp_path / "raw", 44100)
    assert tcreator.main(["slice-all", "--raw", str(raw), "--clips",
                          str(tmp_path / "t"), "--device", "cpu"]) == 0
    jcreator.main(["slice-all", "--raw", str(raw), "--clips",
                   str(tmp_path / "j")])
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")


def test_pitch_dataset_and_count_match(tmp_path, capsys):
    clips = tmp_path / "clips"
    for folder in ("String_6/Fret_0", "String_1/Fret_12", "String_3/Fret_2",
                   "String_old/Fret_1", "String_12_backup/Fret_0",
                   "String_2/Fret_x"):
        d = clips / folder
        d.mkdir(parents=True)
        for i in range(2):
            write_wav(d / f"{i:04d}_clip__{i}.000s.wav",
                      np.full(64, 0.1 * (i + 1), np.float32), 44100)
    n_j = jcreator.create_pitch_dataset(clips, tmp_path / "j")
    out_j = capsys.readouterr().out
    n_t = tcreator.create_pitch_dataset(clips, tmp_path / "t")
    out_t = capsys.readouterr().out
    assert n_t == n_j == 6
    assert out_t == out_j and "3 skipped" not in out_t
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == [
        "A3", "E2", "E5"]
    assert (tcreator.count_clips(tmp_path / "t")
            == jcreator.count_clips(tmp_path / "j"))
    assert tcreator.main(["count", "--root", str(tmp_path / "t")]) == 0


def test_synth_subcommand_matches(tmp_path, monkeypatch):
    monkeypatch.setattr(jsynth, "DEFAULT_CLASS_NAMES", CLASSES)
    monkeypatch.setattr(tsynth, "DEFAULT_CLASS_NAMES", CLASSES)
    args = ["--variants", "2", "--sr", "22050", "--seed", "3"]
    jcreator.main(["synth", "--out", str(tmp_path / "j"), *args])
    tcreator.main(["synth", "--out", str(tmp_path / "t"), *args])
    got, ref = _tree(tmp_path / "t"), _tree(tmp_path / "j")
    assert len(got) == 8 and got == ref


# ---------------------------------------------------------------------------
# eda
# ---------------------------------------------------------------------------
jeda, teda = _tool("eda"), _tool("torch_eda")


@pytest.fixture(scope="module")
def small_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("eda")
    tsynth.synthesize_note_dataset(root, class_names=CLASSES,
                                   variants_per_class=3, seed=5,
                                   verbose=False)
    return root


@pytest.mark.parametrize("resampled", [False, True])
def test_dataset_analysis_matches(small_set, tmp_path, resampled, capsys):
    root = small_set
    if resampled:  # a folder of 44100 Hz files beside the 22050 Hz ones
        root = tmp_path / "set"
        for p in small_set.rglob("*.wav"):
            (root / p.parent.name).mkdir(parents=True, exist_ok=True)
            (root / p.parent.name / p.name).write_bytes(p.read_bytes())
        (root / "B3").mkdir()
        for i in range(2):
            write_wav(root / "B3" / f"b{i}.wav", pluck_riff(44100, 0.6 + i),
                      44100)
    ref = jeda.dataset_analysis(root)
    out_j = capsys.readouterr().out
    got = teda.dataset_analysis(root, device="cpu")
    out_t = capsys.readouterr().out
    assert got["counts"] == ref["counts"]
    assert got["report"] == ref["report"]
    assert [s["path"] for s in got["stats"]] == [s["path"]
                                                 for s in ref["stats"]]
    if not resampled:
        assert got["stats"] == ref["stats"] and out_t == out_j
    for g, r in zip(got["stats"], ref["stats"]):
        for k in ("mean", "std", "var", "min", "max"):
            assert g[k] == pytest.approx(r[k], abs=1e-6), k


def test_dataset_analysis_plot(small_set, tmp_path):
    pytest.importorskip("matplotlib")
    jeda.dataset_analysis(small_set, tmp_path / "j.png")
    teda.dataset_analysis(small_set, tmp_path / "t.png", device="cpu")
    assert (tmp_path / "t.png").stat().st_size > 0
    assert (tmp_path / "j.png").is_file()


def test_slice_analysis_matches(tmp_path, monkeypatch, capsys):
    wav = tmp_path / "riff.wav"
    write_wav(wav, pluck_riff(44100, 3.9), 44100)

    class PortAudioError(Exception):
        pass

    def play(*a, **k):
        raise PortAudioError("no output device")
    monkeypatch.setitem(sys.modules, "sounddevice",
                        types.SimpleNamespace(play=play, wait=lambda: None))
    ref = jeda.slice_analysis(wav, play=True)
    out_j = capsys.readouterr().out
    got = teda.slice_analysis(wav, play=True, device="cpu")
    out_t = capsys.readouterr().out
    assert len(got) == 4 and got == ref
    assert out_t == out_j and out_t.count("audition unavailable") == 1


def test_feature_analysis_matches(small_set):
    ref = jeda.feature_analysis(small_set)
    got = teda.feature_analysis(small_set, device="cpu")
    stats = ("X_min", "X_max", "X_mean", "X_std")
    assert got.keys() == ref.keys()
    for k in ref:
        if k in stats:
            assert got[k] == pytest.approx(ref[k], abs=1e-3), k
        else:
            assert got[k] == ref[k], k
    assert got["n_samples"] == 12 and got["num_features"] == 65


def test_feature_matrix_matches(small_set):
    """The matrix behind the report, element by element: the MFCCs and
    the log10 pitch within 1e-3 of JAX's, labels and classes equal."""
    from gat_tpu.data.loader import AudioDatasetLoader
    from gat_tpu.features import FeatureBuilder
    X, y, _, rmap = FeatureBuilder().extract_mfcc_features(
        AudioDatasetLoader([small_set], target_sr=11025, duration=0.5),
        n_mfcc=64, normalize_audio_volume=True)
    got, got_y, got_rmap = teda.feature_matrix(small_set, device="cpu")
    np.testing.assert_allclose(got, np.asarray(X), rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got_y, np.asarray(y))
    assert got_rmap == rmap


def test_eda_cli(small_set, capsys):
    for cmd in ("dataset", "features"):
        assert teda.main([cmd, "--root", str(small_set), "--device",
                          "cpu"]) == 0
    assert "Label distribution" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# cross_family_eval
# ---------------------------------------------------------------------------
jcross, tcross = _tool("cross_family_eval"), _tool("torch_cross_family_eval")


def test_cross_family_constants_match():
    assert tcross.TRAIN_FAMILIES == jcross.TRAIN_FAMILIES
    assert tcross.EVAL_FAMILIES == jcross.EVAL_FAMILIES


@pytest.fixture(scope="module")
def cross_sets(tmp_path_factory):
    """A KS training set of 4 classes x 6 and one 4 x 2 evaluation set
    per family."""
    root = tmp_path_factory.mktemp("cross")
    train = tsynth.synthesize_note_dataset(
        root / "train_ks", class_names=CLASSES, family="ks",
        variants_per_class=6, seed=42, verbose=False)
    evals = {fam: tsynth.synthesize_note_dataset(
        root / f"eval_{fam}", class_names=CLASSES, family=fam,
        variants_per_class=2, seed=777, verbose=False)
        for fam in tcross.EVAL_FAMILIES}
    return train, evals


def _jax_eval(jt, kind, eval_dir):
    """The JAX tool's `eval_features` + `evaluate` for one family."""
    from gat_tpu.config import MELSPEC_CONFIG, MFCC_CONFIG
    from gat_tpu.data.loader import AudioDatasetLoader
    from gat_tpu.features import FeatureBuilder
    from gat_tpu.train import ArrayDataLoader
    loader = AudioDatasetLoader([eval_dir], target_sr=11025, duration=0.5)
    builder = FeatureBuilder()
    if kind == "mlp":
        X, y, _, rmap = builder.extract_mfcc_features(
            loader, MFCC_CONFIG.N_MFCC, MFCC_CONFIG.NORMALIZE_AUDIO_VOLUME)
    else:
        X, y, _, rmap = builder.extract_melspec_features(
            loader, MELSPEC_CONFIG.N_MELS, MELSPEC_CONFIG.N_FFT,
            MELSPEC_CONFIG.HOP_LENGTH, MELSPEC_CONFIG.NORMALIZE_AUDIO_VOLUME)
    raw = np.asarray(X)
    if kind == "mlp":
        X = np.asarray(jt.scaler.transform(X))
    acc, _ = jt.evaluate(ArrayDataLoader(X, y, 256, shuffle=False))
    return raw, np.asarray(X), rmap, round(float(acc), 4)


@pytest.mark.parametrize("kind", ["mlp", "cnn"])
def test_cross_family_scoring_matches(cross_sets, kind):
    """One epoch of each package's TrainingManager, then the port's
    trainer takes the JAX trainer's weights (and scaler): each family's
    features and every accuracy as the JAX tool computes them."""
    import jax
    from gat_tpu.train import TrainingManager as JManager
    from gat_tpu_torch.models import cnn as tcnn, mlp as tmlp
    from gat_tpu_torch.train import TrainingManager
    from gat_tpu_torch.utils.scaler import FeatureScaler
    train, evals = cross_sets
    kw = dict(dataset=train, epochs=1, seed=42, save=False, verbose=False)
    jm, tm = JManager(target_sr=11025), TrainingManager(target_sr=11025,
                                                        device="cpu")
    jt = (jm.train_mlp if kind == "mlp" else jm.train_cnn)(**kw)
    tt = (tm.train_mlp if kind == "mlp" else tm.train_cnn)(**kw)
    codec = tmlp if kind == "mlp" else tcnn
    tt.model.load_state_dict(codec.params_from_flax(
        jax.tree_util.tree_map(np.asarray, jt.variables)))
    if kind == "mlp":
        tt.scaler = FeatureScaler(jt.scaler.mean_, jt.scaler.scale_)
    assert tt.reverse_map == jt.reverse_map

    raws = {fam: tcross.raw_features(kind, evals[fam], 11025, "cpu")
            for fam in tcross.EVAL_FAMILIES}
    got = tcross.score(tt, kind, raws)
    for fam in tcross.EVAL_FAMILIES:
        j_raw, j_x, j_rmap, j_acc = _jax_eval(jt, kind, evals[fam])
        x, y, rmap = raws[fam]
        assert rmap == j_rmap
        loader = tcross.eval_loader(tt, kind, raws[fam])
        if kind == "mlp":
            np.testing.assert_allclose(x, j_raw, rtol=0, atol=1e-3)
            np.testing.assert_allclose(loader.X, j_x, rtol=0, atol=1e-3)
        else:  # mel images in dB, held as test_torch_train_data.py holds them
            mask = j_raw > -60.0
            np.testing.assert_allclose(x[mask], j_raw[mask], rtol=0, atol=0.1)
            np.testing.assert_array_equal(loader.X, x)
        assert got[fam] == j_acc, fam


def test_cross_family_report_schema(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(tsynth, "DEFAULT_CLASS_NAMES", CLASSES)
    out = tmp_path / "r.json"
    rep = tcross.main(["--variants", "5", "--eval_variants", "1",
                       "--epochs", "1", "--device", "cpu", "--out",
                       str(out)])
    assert set(rep) == {"variants", "epochs", "eval_seed", "results",
                        "wall_s"}
    assert set(rep["results"]) == {f"{m}_trained_on_{f}"
                                   for m in ("cnn", "mlp")
                                   for f in tcross.TRAIN_FAMILIES}
    for row in rep["results"].values():
        assert list(row) == list(tcross.EVAL_FAMILIES)
        assert all(0.0 <= v <= 1.0 for v in row.values())
    import json
    assert json.loads(out.read_text()) == rep
    assert "[cross_family] mlp_trained_on_ks: ks=" in capsys.readouterr().out


def test_cross_family_refuses_other_class_maps(cross_sets):
    trainer = types.SimpleNamespace(reverse_map={0: "E2"}, scaler=None)
    raw = (np.zeros((1, 65), np.float32), np.zeros(1, np.int64),
           {0: "A2"})
    with pytest.raises(ValueError, match="class maps diverged"):
        tcross.eval_loader(trainer, "mlp", raw)


# ---------------------------------------------------------------------------
# train_wall
# ---------------------------------------------------------------------------
WALL = re.compile(r"^WALL (synth|cnn|mlp|total): [0-9.]+s"
                  r"( val_acc [0-9.]+)?$")


def _wall_lines(out: str) -> list[str]:
    return [WALL.match(l).group(1) + ("+acc" if "val_acc" in l else "")
            for l in out.splitlines() if l.startswith("WALL ")]


def test_train_wall_matches_jax_lines(monkeypatch, capsys):
    """Both tools at 4 classes x 5 variants and one epoch each: the same
    WALL lines, nothing written under data/checkpoints/."""
    import jax
    monkeypatch.setattr(jsynth, "DEFAULT_CLASS_NAMES", CLASSES)
    monkeypatch.setattr(tsynth, "DEFAULT_CLASS_NAMES", CLASSES)
    before = {str(p): p.stat().st_mtime_ns
              for p in CHECKPOINTS_ROOT.rglob("*") if p.is_file()}
    cache = jax.config.jax_compilation_cache_dir
    try:
        jwall = _tool("train_wall")
    finally:
        jax.config.update("jax_compilation_cache_dir", cache)

    def small_synth(*a, **k):
        return jsynth.synthesize_note_dataset(
            *a, **{**k, "variants_per_class": 5})

    class OneEpoch(jwall.TrainingManager):
        def train_cnn(self, **k):
            return super().train_cnn(**{**k, "epochs": 1, "verbose": False})

        def train_mlp(self, **k):
            return super().train_mlp(**{**k, "epochs": 1, "verbose": False})
    monkeypatch.setattr(jwall, "synthesize_note_dataset", small_synth)
    monkeypatch.setattr(jwall, "TrainingManager", OneEpoch)
    jwall.main()
    ref = _wall_lines(capsys.readouterr().out)

    twall = _tool("torch_train_wall")
    out = twall.run(variants=5, cnn_epochs=1, mlp_epochs=1, device="cpu")
    got = _wall_lines(capsys.readouterr().out)
    assert got == ref == ["synth", "cnn+acc", "mlp+acc", "total"]
    assert out["cnn_epochs"] == out["mlp_epochs"] == 1
    assert out["total_s"] == pytest.approx(
        out["synth_s"] + out["cnn_s"] + out["mlp_s"])
    assert all(0.0 <= out[k] <= 1.0 for k in ("cnn_val_acc", "mlp_val_acc"))
    after = {str(p): p.stat().st_mtime_ns
             for p in CHECKPOINTS_ROOT.rglob("*") if p.is_file()}
    assert after == before


def test_train_wall_defaults_are_the_recipe():
    import inspect
    twall = _tool("torch_train_wall")
    params = inspect.signature(twall.run).parameters
    assert {k: params[k].default for k in ("variants", "cnn_epochs",
                                           "mlp_epochs", "device")} == {
        "variants": 48, "cnn_epochs": 40, "mlp_epochs": 20,
        "device": "cuda"}


# ---------------------------------------------------------------------------
# the shims
# ---------------------------------------------------------------------------
def test_serve_shim_reexports_the_port():
    import gat_tpu_torch.serve as serve
    shim = _tool("torch_serve")
    for name in ("main", "result_to_json", "serve", "serve_http", "warmup"):
        assert getattr(shim, name) is getattr(serve, name)


def test_train_synthetic_shim_delegates(tmp_path, monkeypatch):
    from gat_tpu_torch import config
    from gat_tpu_torch.train import synthetic
    from gat_tpu_torch.train import trainer as ttrainer
    shim = _tool("torch_train_synthetic")
    assert shim.main is synthetic.main
    assert synthetic.parse_args(["--mesh", "2"]).mesh == 2
    with pytest.raises(SystemExit):
        synthetic.parse_args(["--mesh", "two"])
    monkeypatch.setattr(tsynth, "DEFAULT_CLASS_NAMES", CLASSES)
    monkeypatch.setattr(config, "DATASETS_ROOT", tmp_path / "datasets")
    monkeypatch.setattr(ttrainer, "TORCH_CHECKPOINTS_ROOT",
                        tmp_path / "torch")
    out = shim.main(["--model", "mlp", "--variants", "5", "--epochs", "1",
                     "--device", "cpu"])
    assert out["mlp"]["epochs"] == 1
    assert Path(out["mlp"]["path"]).is_relative_to(tmp_path / "torch")


@pytest.mark.parametrize("name", ["torch_serve", "torch_train_synthetic"])
def test_shims_run_as_scripts(name):
    import subprocess
    out = subprocess.run([sys.executable, str(TOOLS / f"{name}.py"),
                          "--help"], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert out.returncode == 0 and "--device" in out.stdout
    assert "--mesh" in out.stdout
