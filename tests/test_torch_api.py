"""The rest of gat_tpu's public API in the port, each piece against
gat_tpu on the same seeded inputs (CPU), and the three faults found
against the reference: the ensemble function's default return, the
Trainer's `scan_epoch` flag and the integer `val_size` of the split.

Tolerances, stated per test: exact for labels, indices, masks, counts,
onsets and pitch names; the STFT rtol 1e-4 with atol 1e-5 of its peak
(pocketfft in both frameworks, fp32); the filters 1e-6; the NHWC pool
1e-6; the inference features as tests/test_torch_spectral.py holds the
front-ends (MFCC atol 1e-3, pitch rtol 2e-3; mel atol 1e-3 dB on noisy
plucks, 0.1 dB above -60 dB on a synthesized dataset); ensemble probs
1e-2 (tests/test_torch_slice.py); the trainer's histories as
tests/test_torch_train.py holds three epochs.
"""
import ast
import dataclasses
import importlib
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gat_tpu import features as jf
from gat_tpu.infer import Transcriber as JTranscriber
from gat_tpu.ops import filters as jfilt, onset as jonset, pitch as jpitch
from gat_tpu.ops import spectral as jspec
from gat_tpu.train import data as jdata
from gat_tpu_torch import features as tf
from gat_tpu_torch.infer import Transcriber
from gat_tpu_torch.infer.pipeline import build_clip_ensemble_fn
from gat_tpu_torch.ops import filters as tfilt, onset as tonset
from gat_tpu_torch.ops import pitch as tpitch, spectral as tspec
from gat_tpu_torch.train import data as tdata
from tests.test_torch_spectral import pluck_clips
from tests.test_torch_train import _pair

REPO = Path(__file__).resolve().parent.parent
SR = 11025
FILE_SR = 22050


@pytest.fixture(scope="module")
def jax_t():
    return JTranscriber()


@pytest.fixture(scope="module")
def port_t():
    return Transcriber(device="cpu")


@pytest.fixture(scope="module")
def noisy():
    return pluck_clips(0.1)


# ---------------------------------------------------------------------------
# the three faults
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pitch_on_normalized", [False, True])
def test_clip_ensemble_default_returns_blended_probs(jax_t, port_t, noisy,
                                                     pitch_on_normalized):
    """Without `return_parts` the function gives the blended (N, C) probs,
    as gat_tpu's does; with it, the triple."""
    from gat_tpu.infer.pipeline import build_clip_ensemble_fn as jbuild
    mfcc, mel = jax_t._feature_params()
    ref = np.asarray(jbuild(jax_t.predictor, jax_t.scaler, SR, mfcc, mel,
                            pitch_on_normalized=pitch_on_normalized)(noisy))
    fn = build_clip_ensemble_fn(port_t.predictor, port_t.scaler, SR, mfcc,
                                mel, pitch_on_normalized=pitch_on_normalized)
    got = fn(torch.from_numpy(noisy))
    assert isinstance(got, torch.Tensor) and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy().argmax(1), ref.argmax(1))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-2)
    parts = build_clip_ensemble_fn(
        port_t.predictor, port_t.scaler, SR, mfcc, mel,
        pitch_on_normalized=pitch_on_normalized,
        return_parts=True)(torch.from_numpy(noisy))
    assert len(parts) == 3
    np.testing.assert_array_equal(parts[0].numpy(), got.numpy())


def test_port_callers_unpack_the_parts():
    """Every caller in the port that unpacks the ensemble's parts asks for
    them."""
    calls = []
    for path in (REPO / "gat_tpu_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and getattr(
                    node.func, "id", "") == "build_clip_ensemble_fn"):
                kw = {k.arg: k.value for k in node.keywords}
                calls.append((path.name, getattr(kw.get("return_parts"),
                                                 "value", False)))
    # parallel/sharded.py returns the blended probs, as JAX's does
    assert sorted(calls) == [("pipeline.py", True), ("scan.py", True),
                             ("sharded.py", False), ("transcriber.py", True)]


@pytest.mark.parametrize("kind", ["mlp", "cnn"])
def test_train_scan_epoch_false_matches_jax(kind, monkeypatch):
    """`scan_epoch=False` runs the per-batch loop over the loader's own
    batches, as gat_tpu's flag does; histories as
    test_three_epochs_match_jax holds them."""
    jt, tt, _, X, _ = _pair(kind)
    routes = []
    for name in ("_run_epoch_loop", "_run_epoch_resident"):
        real = getattr(tt, name)
        monkeypatch.setattr(tt, name, lambda dl, real=real, name=name:
                            routes.append(name) or real(dl))
    jt.train(epochs=3, verbose=False, scan_epoch=False)
    tt.train(epochs=3, verbose=False, scan_epoch=False)
    assert routes == ["_run_epoch_loop"] * 3
    np.testing.assert_allclose(tt.train_loss_history, jt.train_loss_history,
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(tt.train_accuracy_history,
                               jt.train_accuracy_history, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tt.val_accuracy_history,
                               jt.val_accuracy_history, atol=1e-5, rtol=0)
    loose = kind == "cnn"
    np.testing.assert_allclose(tt.val_loss_history, jt.val_loss_history,
                               rtol=5e-3 if loose else 0,
                               atol=0 if loose else 1e-4)
    tt.train(epochs=1, verbose=False)
    assert routes[-1] == "_run_epoch_resident"


def _labels(case: str) -> np.ndarray:
    rng = np.random.default_rng(5)
    if case == "balanced":
        return np.repeat(np.arange(6), 10)
    return rng.permutation(np.repeat(np.arange(5), [23, 4, 9, 2, 11]))


@pytest.mark.parametrize("case,val_size", [
    ("balanced", 12), ("balanced", 6), ("balanced", 31), ("balanced", 54),
    ("imbalanced", 5), ("imbalanced", 13), ("imbalanced", 20),
    ("imbalanced", 43), ("balanced", np.int64(12))])
@pytest.mark.parametrize("seed", [0, 42])
def test_split_integer_val_size_is_a_count(case, val_size, seed):
    """An integer `val_size` is sklearn's integer test_size: the count of
    the validation set (48/12 of 60), with sklearn's indices."""
    from sklearn.model_selection import train_test_split
    y = _labels(case)
    X = np.arange(len(y) * 2).reshape(len(y), 2)
    got = tdata.stratified_split(X, y, val_size, seed)
    assert len(got[1]) == int(val_size)
    ref = train_test_split(X, y, test_size=val_size, stratify=y,
                           random_state=seed)
    for g, r, j in zip(got, ref, jdata.stratified_split(X, y, val_size,
                                                        seed)):
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(g, j)


@pytest.mark.parametrize("val_size", [0, 60, 61, -3, 0.0, 1.0, "12"])
def test_split_refuses_what_sklearn_refuses(val_size):
    from sklearn.model_selection import train_test_split
    y = _labels("balanced")
    with pytest.raises(ValueError):
        train_test_split(y, y, test_size=val_size, stratify=y)
    with pytest.raises(ValueError, match="val_size"):
        tdata.stratified_split(y, y, val_size)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------
def test_pitch_helpers_match():
    hz = np.geomspace(30.0, 4000.0, 97)
    np.testing.assert_array_equal(tpitch.hz_to_midi(hz),
                                  jpitch.hz_to_midi(hz))
    assert tpitch.STANDARD_TUNING_MIDI == jpitch.STANDARD_TUNING_MIDI
    for string in range(1, 7):
        for fret in range(25):
            for uni in (False, True):
                assert (tpitch.string_fret_to_note(string, fret, uni)
                        == jpitch.string_fret_to_note(string, fret, uni))


@pytest.mark.parametrize("size,origin", [(5, 0), (4, 0), (7, 2), (6, -1),
                                         (3, 1), (1, 0)])
@pytest.mark.parametrize("mode", ["constant", "nearest", "reflect"])
def test_maximum_and_uniform_filters(size, origin, mode):
    x = np.random.default_rng(size).normal(size=(3, 41)).astype(np.float32)
    for jfn, tfn, kw in ((jfilt.maximum_filter1d, tfilt.maximum_filter1d,
                          {"cval": -0.5}),
                         (jfilt.uniform_filter1d, tfilt.uniform_filter1d,
                          {})):
        ref = np.asarray(jfn(jnp.asarray(x), size, origin=origin, mode=mode,
                             **kw))
        got = tfn(torch.from_numpy(x), size, origin=origin, mode=mode,
                  **kw).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_filters_match_scipy():
    from scipy import ndimage
    x = np.random.default_rng(1).normal(size=57)
    for size, origin in ((5, 0), (6, 1), (4, -2)):
        np.testing.assert_allclose(
            tfilt.maximum_filter1d(torch.from_numpy(x), size, origin).numpy(),
            ndimage.maximum_filter1d(x, size, origin=origin,
                                     mode="constant"))
        np.testing.assert_allclose(
            tfilt.uniform_filter1d(torch.from_numpy(x), size, origin).numpy(),
            ndimage.uniform_filter1d(x, size, origin=origin, mode="nearest"),
            atol=1e-12)


@pytest.mark.parametrize("pad_mode", ["constant", "reflect"])
@pytest.mark.parametrize("n_fft,hop,win", [(2048, None, None),
                                           (512, 128, 400), (256, 64, 256)])
@pytest.mark.parametrize("center", [True, False])
def test_stft_matches(noisy, pad_mode, n_fft, hop, win, center):
    x = noisy[:5]
    ref = np.asarray(jspec.stft(jnp.asarray(x), n_fft, hop, win, center,
                                pad_mode))
    got = tspec.stft(torch.from_numpy(x), n_fft, hop, win, center,
                     pad_mode).numpy()
    assert got.shape == ref.shape and got.dtype == np.complex64
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max())


def _envelopes(seed: int, n: int = 3) -> np.ndarray:
    """(n, T) onset envelopes of pluck riffs at 22050 Hz, hop 512."""
    from emulated_kernels import riffs
    y = torch.from_numpy(riffs(int(4.0 * FILE_SR), seed)[:n])
    return tonset.onset_strength_plain(y, FILE_SR).numpy()


@pytest.mark.parametrize("valid_end", [None, 120])
@pytest.mark.parametrize("wait", [0, 1, 4])
def test_peak_pick_mask_matches(valid_end, wait):
    env = _envelopes(0)
    t = env.shape[-1]
    valid = None if valid_end is None else np.arange(t) < valid_end
    params = (3, 1, 4, 5, 0.07, wait)
    for row in env:
        ref = np.asarray(jonset.peak_pick_mask(
            jnp.asarray(row), *params,
            valid=None if valid is None else jnp.asarray(valid)))
        got = tonset.peak_pick_mask(
            torch.from_numpy(row), *params,
            valid=None if valid is None else torch.from_numpy(valid))
        assert ref.any()
        np.testing.assert_array_equal(got.numpy(), ref)
    batch = tonset.peak_pick_mask(torch.from_numpy(env), *params,
                                  None if valid is None
                                  else torch.from_numpy(valid))
    assert batch.shape == env.shape


@pytest.mark.parametrize("valid_end", [None, 100])
def test_backtrack_indices_matches(valid_end):
    env = _envelopes(1)
    t = env.shape[-1]
    valid = None if valid_end is None else np.arange(t) < valid_end
    ref = np.asarray(jonset.backtrack_indices(
        jnp.asarray(env), None if valid is None else jnp.asarray(valid)))
    got = tonset.backtrack_indices(
        torch.from_numpy(env),
        None if valid is None else torch.from_numpy(valid)[None])
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("cand_budget", [None, 0, 3])
@pytest.mark.parametrize("backtrack", [True, False])
@pytest.mark.parametrize("valid_end", [None, 110])
def test_pick_onsets_from_envelope_matches(cand_budget, backtrack,
                                           valid_end):
    """The reference's signature and return tuple, per file: onsets,
    valid, overflow, cap overflow and the kept count all equal; a (B, T)
    batch gives the per-file rows."""
    env = _envelopes(2)
    t = env.shape[-1]
    valid = None if valid_end is None else np.arange(t) < valid_end
    before = tonset.pick_onsets.launches
    rows = []
    for row in env:
        ref = jonset.pick_onsets_from_envelope(
            jnp.asarray(row), FILE_SR, 512, 0.3, 4, backtrack,
            None if valid is None else jnp.asarray(valid), cand_budget)
        got = tonset.pick_onsets_from_envelope(
            torch.from_numpy(row), FILE_SR, 512, 0.3, 4, backtrack,
            None if valid is None else torch.from_numpy(valid), cand_budget)
        assert len(got) == 5
        for g, r in zip(got, ref):
            assert g.shape == np.asarray(r).shape
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        rows.append(got)
    batch = tonset.pick_onsets_from_envelope(
        torch.from_numpy(env), FILE_SR, 512, 0.3, 4, backtrack,
        None if valid is None else torch.from_numpy(valid), cand_budget)
    for i, g in enumerate(batch):
        np.testing.assert_array_equal(
            g.numpy(), np.stack([r[i].numpy() for r in rows]))
    assert tonset.pick_onsets.launches == before  # CPU: the plain version


def test_adaptive_avg_pool_2d_matches():
    from gat_tpu.models import adaptive_avg_pool_2d as jpool
    from gat_tpu_torch.models import adaptive_avg_pool_2d
    for shape, out in (((2, 8, 3, 5), (4, 4)), ((1, 7, 11, 2), (4, 4)),
                       ((3, 9, 6, 4), (2, 3))):
        x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
        np.testing.assert_allclose(
            adaptive_avg_pool_2d(torch.from_numpy(x), out).numpy(),
            np.asarray(jpool(jnp.asarray(x), out)), atol=1e-6)


def test_model_reexports_and_init_args():
    from gat_tpu.models import mlp_dims as jdims
    from gat_tpu_torch.models import CNN, MLP, SoftmaxRegression, mlp_dims
    for h in (128, 64, 15, 8):
        for n in (1, 2, 3, 5):
            assert mlp_dims(h, n) == jdims(h, n)
    for model in (MLP(65), CNN(), SoftmaxRegression(65, 47)):
        args = model.init_args
        args["num_classes"] = -1   # a copy: the model's stay as built
        assert model.init_args["num_classes"] == 47
        assert isinstance(type(model).init_args, property)


# ---------------------------------------------------------------------------
# FeatureBuilder, predictor, Transcriber
# ---------------------------------------------------------------------------
def _check_features(got, ref, scaler=None, mel_floor=None):
    """Held as tests/test_torch_spectral.py holds the front-ends: MFCC atol
    1e-3, pitch rtol 2e-3, mel atol 1e-3 dB on noisy plucks; with
    `mel_floor` (other inputs), mel atol 0.1 dB where the reference reads
    above the floor."""
    mf, ms = (None if x is None else x.numpy() for x in got)
    rmf, rms = (None if x is None else np.asarray(x) for x in ref)
    if scaler is not None:   # compare unscaled: the scale amplifies 1e-3
        mf = mf * scaler.scale_ + scaler.mean_
        rmf = rmf * scaler.scale_ + scaler.mean_
    assert mf.shape == rmf.shape
    np.testing.assert_allclose(mf[:, :64], rmf[:, :64], atol=1e-3, rtol=0)
    np.testing.assert_allclose(10.0 ** (mf[:, 64] - rmf[:, 64]), 1.0,
                               atol=2e-3, rtol=0)
    if rms is None:
        assert ms is None
    else:
        assert ms.shape == rms.shape
        if mel_floor is None:
            np.testing.assert_allclose(ms, rms, atol=1e-3, rtol=0)
        else:
            mask = rms > mel_floor
            np.testing.assert_allclose(ms[mask], rms[mask], atol=0.1, rtol=0)


@pytest.mark.parametrize("with_mel", [True, False])
@pytest.mark.parametrize("with_scaler", [True, False])
@pytest.mark.parametrize("pitch_on_normalized", [False, True])
def test_inference_features_from_clips(jax_t, port_t, noisy, with_mel,
                                       with_scaler, pitch_on_normalized):
    mfcc, mel = jax_t._feature_params()
    mel = mel if with_mel else None
    ref = jax_t.feature_builder.extract_inference_features_from_clips(
        jnp.asarray(noisy), SR, mfcc, mel,
        jax_t.scaler if with_scaler else None, pitch_on_normalized)
    got = port_t.feature_builder.extract_inference_features_from_clips(
        noisy, SR, mfcc, mel, port_t.scaler if with_scaler else None,
        pitch_on_normalized)
    _check_features(got, ref, port_t.scaler if with_scaler else None)
    if with_scaler:  # the scaler applied to the MFCC vector, exactly
        raw = port_t.feature_builder.extract_inference_features_from_clips(
            noisy, SR, mfcc, None, None, pitch_on_normalized)[0]
        np.testing.assert_array_equal(got[0].numpy(),
                                      port_t.scaler.transform(raw).numpy())


@pytest.mark.parametrize("params", ["config", "no_mel", "no_to_db_key",
                                    "to_db_false"])
def test_inference_features_from_audio(noisy, params):
    """The checkpoint's TO_DB wins; `melspec_to_db` applies only when the
    params carry none; None params are the config's."""
    mel = dict(dataclasses.asdict(tf.MELSPEC_CONFIG))
    kwargs = {"melspec_to_db": False}
    if params == "config":
        kwargs = {}
    elif params == "no_mel":
        kwargs["melspec_params"] = None
    elif params == "no_to_db_key":
        del mel["TO_DB"]
        kwargs["melspec_params"] = mel
    else:
        kwargs["melspec_params"] = dict(mel, TO_DB=False)
    jfb, tfb = jf.FeatureBuilder(), tf.FeatureBuilder(device="cpu")
    for clip in noisy[:3]:
        ref = jfb.extract_inference_features_from_audio(
            jnp.asarray(clip), SR, **kwargs)
        got = tfb.extract_inference_features_from_audio(clip, SR, **kwargs)
        if params in ("no_to_db_key", "to_db_false"):
            r, g = np.asarray(ref[1]), got[1].numpy()
            np.testing.assert_allclose(g, r, rtol=1e-4,
                                       atol=1e-6 * np.abs(r).max())
            assert r.max() > 1.0   # power, not dB
            ref, got = (ref[0], None), (got[0], None)
        _check_features(got, ref)
        assert got[0].shape == (1, 65)


def test_inference_features_from_loader(tmp_path):
    from gat_tpu.data.loader import AudioDatasetLoader as JLoader
    from gat_tpu_torch.data.loader import AudioDatasetLoader
    from gat_tpu_torch.data.synth import synthesize_note_dataset
    root = synthesize_note_dataset(tmp_path / "ds", class_names=[
        "E2", "A2", "D3", "G3"], variants_per_class=2, seed=3, verbose=False,
        noise_snr_db=(20.0, 30.0))
    ref = jf.FeatureBuilder().extract_inference_features(
        JLoader([root], target_sr=SR, duration=0.5))
    got = tf.FeatureBuilder(device="cpu").extract_inference_features(
        AudioDatasetLoader([root], target_sr=SR, duration=0.5, device="cpu"))
    _check_features(got, ref, mel_floor=-60.0)
    ref = jf.FeatureBuilder().extract_inference_features(
        JLoader([root], target_sr=SR, duration=0.5), melspec_params=None)
    got = tf.FeatureBuilder(device="cpu").extract_inference_features(
        AudioDatasetLoader([root], target_sr=SR, duration=0.5, device="cpu"),
        melspec_params=None)
    assert got[1] is None and ref[1] is None
    _check_features(got, ref)


def long_tone_clips(n: int, length: int, seed: int = 26) -> np.ndarray:
    """(n, length) from a numpy seed: decaying harmonic tones at 196 and
    330 Hz, a note every 2 s, plus noise; clips far past 2000 frames at
    the mel's hop 256."""
    rng = np.random.default_rng(seed)
    t = np.arange(length) / SR
    rows = []
    for f0 in (196.0, 329.63)[:n]:
        env = np.exp(-3.0 * (t % 2.0))
        tone = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in (1, 2, 3))
        rows.append(0.5 * env * tone + rng.normal(0.0, 0.02, length))
    return np.stack(rows).astype(np.float32)


def test_inference_features_at_long_clips():
    """The extractors take clips of any length: at 2 x (256 x 2000)
    samples (2001 frames at the mel's hop 256, 1001 at the MFCC's 512,
    which the card refused before its split route) the port's features
    equal gat_tpu's, for clips and for one clip's audio."""
    fb, jfb = tf.FeatureBuilder(device="cpu"), jf.FeatureBuilder()
    mfcc = dataclasses.asdict(tf.MFCC_CONFIG)
    mel = dataclasses.asdict(tf.MELSPEC_CONFIG)
    long = long_tone_clips(2, 256 * 2000)
    got = fb.extract_inference_features_from_clips(long, SR, mfcc, mel)
    assert got[1].shape == (2, 64, 2001, 1)
    _check_features(got, jfb.extract_inference_features_from_clips(
        jnp.asarray(long), SR, mfcc, mel), mel_floor=-60.0)
    _check_features(fb.extract_inference_features_from_audio(
        long[0], SR, mfcc, mel), jfb.extract_inference_features_from_audio(
        long[0], SR, mfcc, mel), mel_floor=-60.0)


def test_transcriber_feature_builder_and_mlp_weight(port_t, jax_t):
    assert isinstance(port_t.feature_builder, tf.FeatureBuilder)
    assert port_t.feature_builder.device == port_t.device
    p = port_t.predictor
    assert p.mlp_weight == pytest.approx(jax_t.predictor.mlp_weight)
    old = p.cnn_weight
    try:
        p.cnn_weight = 0.35
        assert p.mlp_weight == pytest.approx(0.65)
    finally:
        p.cnn_weight = old


def test_transcribe_note_matches(jax_t, port_t, noisy):
    """transcribe_note, through the feature builder as gat_tpu's goes,
    against gat_tpu's, with the pitch prior off and on."""
    old = (port_t.predictor.pitch_prior_weight,
           jax_t.predictor.pitch_prior_weight)
    try:
        for w in (0.0, 0.4):
            port_t.predictor.pitch_prior_weight = w
            jax_t.predictor.pitch_prior_weight = w
            for clip in noisy[::9]:
                ref = jax_t.transcribe_note(clip, sr_in=SR)
                got = port_t.transcribe_note(clip, sr_in=SR)
                assert got["labels"] == ref["labels"]
                np.testing.assert_allclose(got["probs"], ref["probs"],
                                           atol=1e-2)
    finally:
        port_t.predictor.pitch_prior_weight = old[0]
        jax_t.predictor.pitch_prior_weight = old[1]


# ---------------------------------------------------------------------------
# the package: config, lazy top-level names, re-exports, the name diff
# ---------------------------------------------------------------------------
def test_top_level_api_matches():
    import gat_tpu
    import gat_tpu_torch
    assert gat_tpu_torch._LAZY.keys() == gat_tpu._LAZY.keys()
    for name, mod in gat_tpu_torch._LAZY.items():
        obj = getattr(gat_tpu_torch, name)
        assert obj is getattr(importlib.import_module(
            mod, "gat_tpu_torch"), name)
        assert obj.__name__ == name
    for name in ("CONFIG_VERSION", "TARGET_SR", "CLIP_DURATION"):
        assert getattr(gat_tpu_torch, name) == getattr(gat_tpu, name)
    for name in ("MFCC_CONFIG", "MELSPEC_CONFIG", "MLP_CONFIG", "CNN_CONFIG",
                 "SLICER_CONFIG", "PARALLEL_CONFIG"):
        got, ref = getattr(gat_tpu_torch, name), getattr(gat_tpu, name)
        assert type(got).__name__ == type(ref).__name__
        for f in dataclasses.fields(got):
            assert getattr(got, f.name) == getattr(ref, f.name), (name, f)
    for name in ("MFCCConfig", "MelSpecConfig", "MLPConfig", "CNNConfig",
                 "AudioSlicerConfig"):
        assert dataclasses.is_dataclass(getattr(gat_tpu_torch, name))
    with pytest.raises(AttributeError):
        gat_tpu_torch.NoSuchName


def test_import_stays_light():
    """`import gat_tpu_torch` loads the config alone: no torch and no
    infer package until a lazy name is read."""
    code = ("import sys\n"
            "import gat_tpu_torch\n"
            "before = sorted(m for m in sys.modules\n"
            "                if m.startswith(('gat_tpu_torch', 'torch')))\n"
            "gat_tpu_torch.Transcriber\n"
            "print(before, 'gat_tpu_torch.infer' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["['gat_tpu_torch',",
                                  "'gat_tpu_torch.config']", "True"]


def test_segment_reexports():
    import gat_tpu.segment as js
    import gat_tpu_torch.segment as ts
    from gat_tpu_torch.segment import gating, slicing
    names = ("AudioSlicer", "segment_waveform", "slice_at_onsets",
             "gate_waveform", "sample_db_gate", "rms_gate")
    for name in names:
        assert hasattr(js, name)
        assert getattr(ts, name) is getattr(
            slicing if hasattr(slicing, name) else gating, name)


# public names of gat_tpu with no counterpart (none left), and the
# module that is JAX's own (utils/jaxenv.py: the kernels' build directory
# plays the compilation cache's part)
NOT_MIRRORED: dict[str, set] = {}
NOT_PORTED_MODULES = ("utils/jaxenv.py",)


def _public_names(path: Path) -> list[str]:
    """Module-level public names of a file (defs, classes, assignments,
    a package's re-exports) and each class's public methods."""
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
            if isinstance(node, ast.ClassDef):
                names += [f"{node.name}.{m.name}" for m in node.body
                          if isinstance(m, ast.FunctionDef)
                          and not m.name.startswith("_")]
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.ImportFrom) and path.name == "__init__.py":
            names += [a.asname or a.name for a in node.names]
    return [n for n in names if not n.split(".")[-1].startswith("_")]


def test_public_names_of_gat_tpu_all_exist_in_the_port():
    missing = []
    for path in sorted((REPO / "gat_tpu").rglob("*.py")):
        rel = path.relative_to(REPO / "gat_tpu").as_posix()
        if rel.startswith(NOT_PORTED_MODULES):
            continue
        parts = rel.removesuffix(".py").split("/")
        if parts[-1] == "__init__":
            parts.pop()
        mod = importlib.import_module(".".join(["gat_tpu_torch"] + parts))
        for name in _public_names(path):
            if name in NOT_MIRRORED.get(rel, ()):
                continue
            obj = mod
            for part in name.split("."):
                obj = getattr(obj, part, None)
            if obj is None:
                missing.append(f"{rel}::{name}")
    assert missing == []


# Where the port's signature may differ from gat_tpu's, and why: the
# framework's own arguments, not the reference's
SIGNATURE_EXCEPTIONS = {
    # flax.linen.Module's `parent` and `name`, which every flax module
    # takes; the port's modules are torch.nn.Modules
    "flax": ("parent", "name"),
    # JAX params and a PRNG key; the port reinitializes a module in place
    # from a torch.Generator
    "train/trainer.py::kaiming_reinit": "(model, generator)",
    # jax devices; the port's mesh takes the device kind of its ranks
    "parallel/mesh.py::make_mesh": "device=",
    "parallel/__init__.py::make_mesh": "device=",
    # shardings of a params tree; the port shards the module
    "parallel/sharded.py::mlp_tp_shardings": "(model, mesh)",
    "parallel/__init__.py::mlp_tp_shardings": "(model, mesh)",
    # a NamedSharding for a mesh; the port replicates a module's state
    "parallel/mesh.py::replicated": "(module, mesh)",
    "parallel/__init__.py::replicated": "(module, mesh)",
    # the port's logger is named after its package, and its traces go
    # under its checkout, never to /tmp
    "utils/logging.py::get_logger": "name='gat_tpu_torch'",
    "utils/profiling.py::device_trace": "log_dir=None",
}


def _same_default(ref, got) -> bool:
    """Equal defaults; two bare `object()` sentinels count as equal, and a
    JAX dtype as its torch namesake."""
    if type(ref) is object and type(got) is object:
        return True
    if isinstance(got, torch.dtype):
        return str(got) == f"torch.{np.dtype(ref).name}"
    try:
        return bool(ref == got)
    except Exception:
        return False


def _signature_faults(rel: str, name: str, ref, got) -> list[str]:
    """How the port's signature breaks the reference's: each reference
    parameter in the same place, kind and name, with the same default
    where the reference has one; the port's own extra parameters come
    after them, each with a default, so every call of the reference binds
    the same way."""
    import inspect
    ref_params = list(inspect.signature(ref).parameters.values())
    if any(p.name == "parent" and "flax" in str(p.annotation)
           for p in ref_params):
        ref_params = [p for p in ref_params
                      if p.name not in SIGNATURE_EXCEPTIONS["flax"]]
    got_params = list(inspect.signature(got).parameters.values())
    faults = []
    for i, r in enumerate(ref_params):
        g = got_params[i] if i < len(got_params) else None
        if g is None or (g.name, g.kind) != (r.name, r.kind):
            faults.append(f"{rel}::{name}: parameter {i} is "
                          f"{g and g.name!r}, gat_tpu's {r.name!r}")
        elif (r.default is not inspect.Parameter.empty
              and not _same_default(r.default, g.default)):
            faults.append(f"{rel}::{name}: {r.name}={g.default!r}, gat_tpu's "
                          f"{r.default!r}")
    for g in got_params[len(ref_params):]:
        if (g.default is inspect.Parameter.empty
                and g.kind not in (g.VAR_POSITIONAL, g.VAR_KEYWORD)):
            faults.append(f"{rel}::{name}: the port's {g.name!r} has no "
                          f"default")
    return faults


def test_public_signatures_match_gat_tpu():
    """Every public function, class and method of gat_tpu that the port
    mirrors takes the same parameters in the same order with the same
    defaults, the port's own extra parameters last and optional; the
    exceptions are the frameworks' (SIGNATURE_EXCEPTIONS, each with its
    reason)."""
    import inspect
    faults, compared = [], 0
    for path in sorted((REPO / "gat_tpu").rglob("*.py")):
        rel = path.relative_to(REPO / "gat_tpu").as_posix()
        if rel.startswith(NOT_PORTED_MODULES):
            continue
        parts = rel.removesuffix(".py").split("/")
        if parts[-1] == "__init__":
            parts.pop()
        ref_mod = importlib.import_module(".".join(["gat_tpu"] + parts))
        mod = importlib.import_module(".".join(["gat_tpu_torch"] + parts))
        for name in _public_names(path):
            if f"{rel}::{name}" in SIGNATURE_EXCEPTIONS:
                continue
            ref, got = ref_mod, mod
            for part in name.split("."):
                ref, got = getattr(ref, part, None), getattr(got, part, None)
            if not callable(ref) or not callable(got):
                continue
            try:
                inspect.signature(ref)
            except (TypeError, ValueError):
                continue
            compared += 1
            faults += _signature_faults(rel, name, ref, got)
    assert compared >= 250
    assert faults == []
