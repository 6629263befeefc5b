"""The port's dataset side of training against gat_tpu's (CPU): the WAV
loader, the FeatureBuilder at dataset scale, label encoding, the
stratified split against sklearn's, the scaler, the classification report
and the confusion matrix.

Tolerances: resampled waveforms atol 1e-5 (tests/test_torch_resample.py);
MFCC means atol 1e-3 and mel images 0.1 dB where JAX reads above -60 dB
(tests/test_torch_spectral.py); the pitch feature, log10 of the YIN
pitch, within log10(1 + 2e-3) (YIN's rtol 2e-3, tests/test_torch_yin.py);
scaler mean and scale 1e-6; split indices, labels and report text
identical."""
from pathlib import Path

import numpy as np
import pytest
import torch

from gat_tpu import features as jfeatures
from gat_tpu.data.loader import AudioDatasetLoader as JLoader
from gat_tpu.data.synth import synthesize_note_dataset
from gat_tpu.train import data as jdata, metrics as jmetrics
from gat_tpu.utils.scaler import FeatureScaler as JScaler
from gat_tpu_torch import features as tfeatures
from gat_tpu_torch.data.loader import AudioDatasetLoader as TLoader
from gat_tpu_torch.data.loader import get_available_datasets
from gat_tpu_torch.train import data as tdata, metrics as tmetrics
from gat_tpu_torch.utils.scaler import FeatureScaler

CLASSES = ["E2", "A2", "D3", "G3", "B3", "E4"]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory) -> Path:
    """6 classes x 8 variants of the shipped recipe's families and
    stressors at 22050 Hz, 0.5 s."""
    root = tmp_path_factory.mktemp("ds") / "synthetic" / "six"
    synthesize_note_dataset(root, class_names=CLASSES, variants_per_class=8,
                            seed=42, verbose=False, noise_snr_db=(8.0, 40.0),
                            family="all3", stressor="mix", stressor_prob=0.5,
                            channel="mix", channel_prob=0.25)
    return root


@pytest.fixture(scope="module")
def loaders(dataset):
    return (JLoader([dataset], target_sr=11025, duration=0.5),
            TLoader([dataset], target_sr=11025, duration=0.5, device="cpu"))


def test_loader_matches(loaders):
    jl, tl = loaders
    jw, jsr, jlab, jpaths = jl.load_audio_dataset()
    tw, tsr, tlab, tpaths = tl.load_audio_dataset()
    assert (tsr, tlab, tpaths) == (jsr, jlab, jpaths)
    assert tl.source_srs == jl.source_srs == [22050] * len(tw)
    assert all(w.shape == (5512,) and w.dtype == np.float32 for w in tw)
    np.testing.assert_allclose(np.stack(tw), np.stack(jw), atol=1e-5, rtol=0)
    # memoized and read-only, as the JAX loader
    assert tl.load_audio_dataset() is tl.load_audio_dataset()
    with pytest.raises(ValueError):
        tw[0][0] = 1.0


def test_loader_pads_without_duration(tmp_path):
    from gat_tpu_torch.utils.wavio import write_wav
    for i, n in enumerate((3000, 5000)):
        (tmp_path / "A2").mkdir(exist_ok=True)
        write_wav(tmp_path / "A2" / f"a{i}.wav",
                  np.full(n, 0.1, np.float32), 22050)
    jw = JLoader([tmp_path], target_sr=11025).load_audio_dataset()[0]
    tw = TLoader([tmp_path], target_sr=11025,
                 device="cpu").load_audio_dataset()[0]
    assert [w.shape for w in tw] == [w.shape for w in jw] == [(2500,)] * 2
    np.testing.assert_allclose(np.stack(tw), np.stack(jw), atol=1e-5)


def test_available_datasets(dataset):
    from gat_tpu.data.loader import get_available_datasets as jget
    root = dataset.parent.parent
    names, paths = get_available_datasets(root)
    assert (names, paths) == jget(root) and names == ["synthetic/six"]


def test_feature_builder_mfcc(loaders):
    jl, tl = loaders
    jX, jy, jn, jmap = jfeatures.FeatureBuilder().extract_mfcc_features(jl)
    tX, ty, tn, tmap = tfeatures.FeatureBuilder(
        device="cpu").extract_mfcc_features(tl)
    assert tX.shape == jX.shape == (48, 65) and tX.dtype == np.float32
    np.testing.assert_array_equal(ty, jy)
    assert (tn, tmap) == (jn, jmap)
    np.testing.assert_allclose(tX[:, :64], jX[:, :64], atol=1e-3, rtol=0)
    np.testing.assert_allclose(tX[:, 64], jX[:, 64], rtol=0,
                               atol=np.log10(1 + 2e-3))


def test_feature_builder_melspec(loaders):
    jl, tl = loaders
    jX, jy, jn, jmap = jfeatures.FeatureBuilder().extract_melspec_features(jl)
    tX, ty, tn, tmap = tfeatures.FeatureBuilder(
        device="cpu").extract_melspec_features(tl)
    assert tX.shape == jX.shape == (48, 64, 22, 1)
    np.testing.assert_array_equal(ty, jy)
    assert (tn, tmap) == (jn, jmap)
    mask = jX > -60.0
    np.testing.assert_allclose(tX[mask], jX[mask], atol=0.1, rtol=0)
    assert np.isfinite(tX).all() and tX.min() >= -100.0


def test_feature_builder_takes_a_60s_loader():
    """A dataset holding one 60 s recording builds its features: the loader
    pads every clip to the longest, and the card's kernels refused such
    clips (2584 frames at hop 256) before their split route. The port's
    mel and MFCC features of a 60 s riff and a 0.5 s pluck padded to it
    equal gat_tpu's."""
    from gat_tpu_torch.data.synth import karplus_strong
    sr, n = 11025, 11025 * 60
    rng = np.random.default_rng(60)
    riff = rng.normal(0.0, 0.01, n)
    for i, f0 in enumerate((110.0, 196.0, 293.66, 440.0)):
        note = karplus_strong(f0, sr, 2.0, seed=i)[0]
        riff[(1 + 15 * i) * sr:(1 + 15 * i) * sr + len(note)] += note
    # a noisy pluck padded to the riff's length: the mel's stated
    # tolerance (0.1 dB above -60 dB) is for noisy plucks
    short = np.zeros(n)
    short[:sr // 2] = (karplus_strong(146.83, sr, 0.5, seed=9)[0]
                       + rng.normal(0.0, 0.01, sr // 2))

    class Loader:
        target_sr = sr

        def load_audio_dataset(self, pad_to_max=True):
            return ([riff.astype(np.float32), short.astype(np.float32)],
                    None, ["A", "B"], None)
    builder = tfeatures.FeatureBuilder(device="cpu")
    tX, ty, tn, tmap = builder.extract_melspec_features(Loader())
    jX, jy, jn, jmap = jfeatures.FeatureBuilder().extract_melspec_features(
        Loader())
    assert tX.shape == jX.shape == (2, 64, 2584, 1)
    np.testing.assert_array_equal(ty, jy)
    assert (tn, tmap) == (jn, jmap)
    mask = jX > -60.0
    np.testing.assert_allclose(tX[mask], jX[mask], atol=0.1, rtol=0)
    tM = builder.extract_mfcc_features(Loader())[0]
    jM = jfeatures.FeatureBuilder().extract_mfcc_features(Loader())[0]
    np.testing.assert_allclose(tM[:, :64], jM[:, :64], atol=1e-3, rtol=0)
    np.testing.assert_allclose(10.0 ** (tM[:, 64] - jM[:, 64]), 1.0,
                               atol=2e-3, rtol=0)


def test_encode_labels_and_layout():
    labels = ["G3", "A2", "G3", "E2", "A2"]
    got, ref = tfeatures.encode_labels(labels), jfeatures.encode_labels(labels)
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[1:] == ref[1:]
    x = np.random.default_rng(0).normal(size=(3, 64, 22, 1)).astype(np.float32)
    np.testing.assert_array_equal(tfeatures.to_reference_layout(x),
                                  np.asarray(jfeatures.to_reference_layout(x)))
    np.testing.assert_array_equal(
        tfeatures.to_reference_layout(torch.from_numpy(x)).numpy(),
        np.asarray(jfeatures.to_reference_layout(x)))


def _labels(case: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if case == "balanced":
        return np.repeat(np.arange(6), 10)
    if case == "imbalanced":
        return rng.permutation(np.repeat(np.arange(5), [23, 4, 9, 2, 11]))
    return rng.permutation(np.repeat(np.arange(47), 48))  # 47 x 48


@pytest.mark.parametrize("case", ["balanced", "imbalanced", "47x48"])
@pytest.mark.parametrize("seed", [0, 7, 42])
def test_stratified_split_equals_sklearn(case, seed):
    from sklearn.model_selection import train_test_split
    y = _labels(case, seed)
    X = np.arange(len(y) * 2).reshape(len(y), 2)
    for val_size in (0.2, 0.33):
        got = tdata.stratified_split(X, y, val_size, seed)
        ref = train_test_split(X, y, test_size=val_size, stratify=y,
                               random_state=seed)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
        for g, r in zip(got, jdata.stratified_split(X, y, val_size, seed)):
            np.testing.assert_array_equal(g, r)


def test_stratified_split_refuses_singleton_class():
    with pytest.raises(ValueError, match="only 1 member"):
        tdata.stratified_split(np.zeros((9, 1)), np.array([0] * 8 + [1]))


def test_scaler_fit_matches():
    x = np.random.default_rng(2).normal(3.0, 2.0, (50, 65)).astype(np.float32)
    x[:, 5] = 1.5  # zero variance: scale 1
    ref, got = JScaler().fit(x), FeatureScaler().fit(x)
    np.testing.assert_allclose(got.mean_, ref.mean_, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.scale_, ref.scale_, atol=1e-6, rtol=0)
    assert got.scale_[5] == 1.0
    np.testing.assert_allclose(got.transform(x), np.asarray(ref.transform(x)),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.transform(torch.from_numpy(x)).numpy(),
                               got.transform(x), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(FeatureScaler().fit_transform(x),
                                  got.transform(x))
    d = got.to_dict()
    again = FeatureScaler.from_sklearn(FeatureScaler.from_dict(d))
    np.testing.assert_array_equal(again.scale_, got.scale_)


def test_build_loaders_match(loaders):
    jl, tl = loaders
    jout = jdata.build_mfcc_train_val(jfeatures.FeatureBuilder(), jl,
                                      batch_size=8)
    tout = tdata.build_mfcc_train_val(tfeatures.FeatureBuilder(device="cpu"),
                                      tl, batch_size=8)
    for jdl, tdl in zip(jout[:2], tout[:2]):
        np.testing.assert_array_equal(tdl.y, jdl.y)
        # the features' 1e-3 divided by the fitted scale (≥ 0.5 here)
        np.testing.assert_allclose(tdl.X, jdl.X, atol=2e-3, rtol=0)
    np.testing.assert_allclose(tout[6].mean_, jout[6].mean_, atol=1e-3)
    jm = jdata.build_melspec_train_val(jfeatures.FeatureBuilder(), jl)
    tm = tdata.build_melspec_train_val(tfeatures.FeatureBuilder(device="cpu"),
                                       tl)
    for jdl, tdl in zip(jm[:2], tm[:2]):
        np.testing.assert_array_equal(tdl.y, jdl.y)
        assert tdl.X.shape == jdl.X.shape


@pytest.mark.parametrize("names", ["full", "empty", "short"])
def test_classification_report_text_equals_sklearn(names):
    rng = np.random.default_rng(len(names))
    yt = rng.integers(0, 9, 200)
    yp = np.where(rng.random(200) < 0.6, yt, rng.integers(0, 11, 200))
    target = {"full": [f"N{i}" for i in range(11)], "empty": [],
              "short": ["a", "b"]}[names]
    assert (tmetrics.classification_report(yt, yp, target)
            == jmetrics.classification_report(yt, yp, target))


def test_confusion_matrix_equal():
    rng = np.random.default_rng(4)
    yt, yp = rng.integers(0, 7, 300), rng.integers(0, 7, 300)
    for kw in ({}, {"normalize": True}, {"num_classes": 9}):
        np.testing.assert_array_equal(tmetrics.confusion_matrix(yt, yp, **kw),
                                      jmetrics.confusion_matrix(yt, yp, **kw))


@pytest.mark.parametrize("norm", [50.0, 5.0, 0.5, 0.01, 1e-5])
def test_grad_norm_gauges_equal(norm):
    assert tmetrics.grad_norm_label(norm) == jmetrics.grad_norm_label(norm)
    assert tmetrics.grad_norm_bar(norm) == jmetrics.grad_norm_bar(norm)
