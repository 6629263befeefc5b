"""The report and plot helpers (`gat_tpu_torch/utils/reports.py`,
`utils/display.py`) against gat_tpu's on the same datasets and features
(CPU).

Tolerances: the reports' printed text and written JSON identical; the
spectrogram image 0.1 dB where the reference reads above -60 dB (as
tests/test_torch_spectral.py holds the mel front-end on plucks).
"""
import json
import sys

import numpy as np
import pytest
import torch

from gat_tpu.data.loader import AudioDatasetLoader as JLoader
from gat_tpu.utils import display as jdisplay
from gat_tpu.utils.reports import audio_report as jaudio
from gat_tpu.utils.reports import feature_report as jfeature
from gat_tpu.utils.scaler import FeatureScaler as JScaler
from gat_tpu_torch.data.loader import AudioDatasetLoader
from gat_tpu_torch.features import FeatureBuilder
from gat_tpu_torch.utils import display
from gat_tpu_torch.utils.reports import audio_report, feature_report
from gat_tpu_torch.utils.scaler import FeatureScaler
from gat_tpu_torch.utils.wavio import write_wav
from emulated_kernels import pluck_riff


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Three SPN folders of plucks at three rates and lengths."""
    root = tmp_path_factory.mktemp("reports") / "ds"
    rng = np.random.default_rng(0)
    for label, f in (("A2", 110.0), ("D3", 146.83), ("G3", 196.0)):
        for i, (sr, dur) in enumerate(((22050, 0.5), (44100, 0.7),
                                       (16000, 0.45))):
            y = pluck_riff(sr, dur, ((0.0, f),))
            y += rng.normal(0.0, 0.001, y.shape).astype(np.float32)
            (root / label).mkdir(parents=True, exist_ok=True)
            write_wav(root / label / f"{label}_{i}.wav", y, sr)
    return root


@pytest.mark.parametrize("duration", [None, 0.5])
@pytest.mark.parametrize("sample_paths", [False, True])
def test_audio_report_equal(dataset, capsys, duration, sample_paths):
    labels = np.repeat(np.arange(3), 3)
    rmap = {0: "A2", 1: "D3", 2: "G3"}
    ref = jaudio(JLoader([dataset], target_sr=11025, duration=duration),
                 labels, rmap, sample_paths=sample_paths,
                 example_limit_per_class=2)
    ref_out = capsys.readouterr().out
    got = audio_report(AudioDatasetLoader([dataset], target_sr=11025,
                                          duration=duration, device="cpu"),
                       labels, rmap, sample_paths=sample_paths,
                       example_limit_per_class=2)
    assert capsys.readouterr().out == ref_out
    assert got == ref
    assert got["unique_srs"] == [16000, 22050, 44100]


@pytest.mark.parametrize("kind", ["mfcc", "mel", "with_nan"])
@pytest.mark.parametrize("scaled", [False, True])
def test_feature_report_equal(dataset, tmp_path, capsys, kind, scaled):
    """The port's features of the dataset, reported by both helpers: the
    same printed text and the same file."""
    fb = FeatureBuilder(device="cpu")
    loader = AudioDatasetLoader([dataset], target_sr=11025, duration=0.5,
                                device="cpu")
    X, y, _, rmap = (fb.extract_melspec_features(loader) if kind == "mel"
                     else fb.extract_mfcc_features(loader))
    if kind == "with_nan":
        X = X.copy()
        X[0, 3], X[2, 5] = np.nan, np.inf
    capsys.readouterr()
    sc = FeatureScaler().fit(X.reshape(len(X), -1)) if scaled else None
    jsc = JScaler(sc.mean_, sc.scale_) if scaled else None
    ref = jfeature(X, y, rmap, jsc, out_root=tmp_path / "j",
                   out_filename="r.json")
    ref_out = capsys.readouterr().out
    for x in (X, torch.from_numpy(X)):
        got = feature_report(x, y, rmap, sc, out_root=tmp_path / "t",
                             out_filename="r.json")
        assert capsys.readouterr().out == ref_out
        # as text: NaN entries compare unequal as floats
        assert json.dumps(got) == json.dumps(ref)
        assert ((tmp_path / "t" / "r.json").read_text()
                == (tmp_path / "j" / "r.json").read_text())
    assert json.loads((tmp_path / "t" / "r.json").read_text())[
        "n_samples"] == 9


def test_plots_match(tmp_path):
    y = pluck_riff(22050, 1.2)
    figs = {}
    for name, mod in (("jax", jdisplay), ("port", display)):
        d = tmp_path / name
        d.mkdir()
        figs[name] = mod.plot_spectrogram(y, 22050, out_path=d / "s.png")
        mod.plot_waveform(y, 22050, out_path=d / "w.png")
        mod.plot_series([y[:100], y[100:200]], ["a", "b"],
                        out_path=d / "l.png")
        assert all((d / f).stat().st_size > 1000
                   for f in ("s.png", "w.png", "l.png"))
    ref = np.asarray(figs["jax"].axes[0].images[0].get_array())
    got = np.asarray(figs["port"].axes[0].images[0].get_array())
    assert got.shape == ref.shape
    mask = ref > -60.0
    np.testing.assert_allclose(got[mask], ref[mask], atol=0.1, rtol=0)


def test_plots_without_matplotlib_raise(monkeypatch):
    """Where matplotlib is not installed (the card's machine) a plot
    raises ImportError; the module itself imports without it."""
    for name in [n for n in sys.modules if n.split(".")[0] == "matplotlib"]:
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    for fn, args in ((display.plot_waveform, (np.zeros(10), 10)),
                     (display.plot_spectrogram, (np.zeros(4096), 22050)),
                     (display.plot_series, ([1, 2],))):
        with pytest.raises(ImportError, match="matplotlib"):
            fn(*args)
