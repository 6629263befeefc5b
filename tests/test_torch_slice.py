"""The ported clip-ensemble slice vs gat_tpu end to end (CPU, the shipped
checkpoints): Transcriber.transcribe_clips and the flagship entry step.

Bounds: labels identical, ensemble probs within atol 1e-2, the YIN
baseline within rtol 2e-3 apart from the pinned near-tie of
test_torch_yin (the 880 Hz pluck, index 41 of the noise-free set)."""
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from gat_tpu.infer import Transcriber as JTranscriber
from gat_tpu_torch.entry import entry
from gat_tpu_torch.infer import Transcriber
from gat_tpu_torch.infer.pipeline import build_clip_ensemble_fn
from gat_tpu_torch.infer.predictor import apply_pitch_prior
from tests.test_torch_spectral import pluck_clips
from tests.test_torch_yin import NEAR_TIE

SR = 11025


@pytest.fixture(scope="module")
def jax_t():
    return JTranscriber()


@pytest.fixture(scope="module")
def port_t():
    return Transcriber(device="cpu")


def _compare(ref, got, skip=()):
    assert got["labels"] == ref["labels"]
    np.testing.assert_array_equal(got["indices"], ref["indices"])
    np.testing.assert_allclose(got["probs"], ref["probs"], atol=1e-2)
    for k in ("mlp", "cnn"):
        if ref["per_model_probs"][k] is None:
            assert got["per_model_probs"][k] is None
        else:
            np.testing.assert_allclose(got["per_model_probs"][k],
                                       ref["per_model_probs"][k], atol=1e-2)
    hz_ref = np.array([p for p, _ in ref["dsp_info"]])
    hz_got = np.array([p for p, _ in got["dsp_info"]])
    keep = np.ones(len(hz_ref), bool)
    keep[list(skip)] = False
    np.testing.assert_allclose(hz_got[keep], hz_ref[keep], rtol=2e-3)
    for (_, a), (_, b), k in zip(got["dsp_info"], ref["dsp_info"], keep):
        if k:
            assert a["midi"] == b["midi"] and a["note_name"] == b["note_name"]


@pytest.mark.parametrize("noise", [0.0, 0.1])
def test_transcribe_clips_matches(jax_t, port_t, noise):
    clips = pluck_clips(noise)
    ref = jax_t.transcribe_clips(clips)
    got = port_t.transcribe_clips(clips)
    _compare(ref, got, skip=(NEAR_TIE,) if noise == 0.0 else ())
    assert got["probs"].shape == (47, 47)
    np.testing.assert_allclose(got["probs"].sum(axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("cnn_weight", [0.8, 0.5])
def test_predict_on_same_features(jax_t, port_t, cnn_weight):
    """Fed JAX's own features, the port's models and blend agree to
    float32 rounding."""
    from gat_tpu.infer import NotePredictor as JNotePredictor
    from gat_tpu_torch.infer import NotePredictor
    clips = pluck_clips(0.1)[:12]
    mfcc_p, mel_p = jax_t._feature_params()
    mf, ms = jax_t.feature_builder.extract_inference_features_from_clips(
        clips, SR, mfcc_p, mel_p, jax_t.scaler)
    jp = JNotePredictor(cnn_weight=cnn_weight)
    jp.load_models(jax_t.model_ckpts["mlp"], jax_t.model_ckpts["cnn"])
    tp = NotePredictor(cnn_weight=cnn_weight, device="cpu")
    tp.load_models(port_t.model_ckpts["mlp"], port_t.model_ckpts["cnn"])
    ref = jp.predict(mf, ms)
    got = tp.predict(np.array(mf), np.array(ms))
    assert got["labels"] == ref["labels"]
    np.testing.assert_allclose(got["probs"], ref["probs"], atol=1e-5)
    np.testing.assert_allclose(got["confidences"], ref["confidences"],
                               atol=1e-5)


def test_transcribe_clips_accepts_tensor(port_t):
    clips = pluck_clips(0.1)[:5]
    a = port_t.transcribe_clips(clips)
    b = port_t.transcribe_clips(torch.from_numpy(clips))
    np.testing.assert_array_equal(a["probs"], b["probs"])


def test_entry_matches_graft_entry():
    jfn, (jclips,) = graft.entry(batch=24)
    tfn, (tclips,) = entry(batch=24, device="cpu")
    np.testing.assert_array_equal(tclips.numpy(), jclips)
    jp, jhz = (np.asarray(a) for a in jfn(jclips))
    tp, thz = (a.numpy() for a in tfn(tclips))
    assert tp.shape == (24, 47) and thz.shape == (24,)
    np.testing.assert_array_equal(tp.argmax(1), jp.argmax(1))
    np.testing.assert_allclose(tp, jp, atol=1e-2)
    np.testing.assert_allclose(thz, jhz, rtol=2e-3)


def test_mlp_only_matches():
    clips = pluck_clips(0.1)[::3]
    ref = JTranscriber(use_cnn=False).transcribe_clips(clips)
    got = Transcriber(use_cnn=False, device="cpu").transcribe_clips(clips)
    assert got["per_model_probs"]["cnn"] is None
    _compare(ref, got)


def test_pitch_prior_matches():
    clips = pluck_clips(0.1)[::2]
    ref = JTranscriber(pitch_prior_weight=0.4).transcribe_clips(clips)
    got = Transcriber(pitch_prior_weight=0.4,
                      device="cpu").transcribe_clips(clips)
    _compare(ref, got)


def test_apply_pitch_prior_matches():
    from gat_tpu.infer.predictor import apply_pitch_prior as japply
    rng = np.random.default_rng(5)
    probs = rng.dirichlet(np.ones(47), size=6).astype(np.float32)
    hz = np.array([82.4, 440.0, np.nan, 0.0, -5.0, 1174.7], np.float32)
    midi = np.arange(40, 87, dtype=np.float32)
    ref = np.asarray(japply(probs, hz, midi, weight=0.4, sigma=0.5))
    got = apply_pitch_prior(torch.from_numpy(probs), torch.from_numpy(hz),
                            midi, weight=0.4, sigma=0.5).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_checkpoint_validation(tmp_path):
    with pytest.raises(FileNotFoundError, match="MLP checkpoint"):
        Transcriber(mlp_root=tmp_path, device="cpu")
    with pytest.raises(FileNotFoundError, match="CNN checkpoint"):
        Transcriber(cnn_root=tmp_path, device="cpu")
    t = Transcriber(cnn_root=tmp_path, require_cnn=False, device="cpu")
    assert t.predictor.cnn is None and t.ckpt_sr == 11025
    assert t.clip_length == 0.5


def test_resample_branch_not_ported(jax_t, port_t):
    """The re-rate branch, now ported: clips at 22050 Hz of 0.6 s are
    re-rated to the checkpoint's 11025 Hz and cut to 5512 samples, with
    the pitch feature from the raw and from the normalized clips; probs
    as test_transcribe_clips_matches holds them."""
    from gat_tpu.infer.pipeline import build_clip_ensemble_fn as jbuild
    from gat_tpu.data.synth import karplus_strong
    from gat_tpu.ops.pitch import midi_to_hz
    clips = np.stack([karplus_strong(float(midi_to_hz(40 + 5 * i)), 22050,
                                     0.6, seed=i)[0] for i in range(9)])
    mfcc, mel = jax_t._feature_params()
    for pitch_on_normalized in (False, True):
        ref, _, _ = jbuild(jax_t.predictor, jax_t.scaler, 11025, mfcc, mel,
                           in_sr=22050, clip_len=5512,
                           pitch_on_normalized=pitch_on_normalized,
                           return_parts=True)(clips)
        fn = build_clip_ensemble_fn(port_t.predictor, port_t.scaler, 11025,
                                    mfcc, mel, in_sr=22050, clip_len=5512,
                                    pitch_on_normalized=pitch_on_normalized,
                                    return_parts=True)
        got, _, _ = fn(torch.from_numpy(clips))
        ref = np.asarray(ref)
        np.testing.assert_array_equal(got.numpy().argmax(1), ref.argmax(1))
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-2)
