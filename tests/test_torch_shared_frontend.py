"""PyTorch port vs gat_tpu: the shared MFCC and YIN front-end of the
matmul route (`features.SHARED_BLOCK_FRONTEND`), and the paths that take
it: the clip ensemble, `transcribe_clips` and the file path (CPU, the
shipped checkpoints; JAX on its matmul route, where XLA shares the block
DFT between the front-end and the prior's YIN).

Tolerances: the front-end's MFCC atol 1e-3 and its pitch rtol 2e-3 at
float32 and at bfloat16 GEMM operands (measured 7.3e-5 and 1.1e-6: both
packages form the same products of the same operands); one near-tie clip
is pinned (below). Ensemble labels and argmax identical, probs within
1e-2 (tests/test_torch_slice.py's bound); file labels, onsets and times
identical, the YIN baseline within rtol 2e-3. Every test that sets a
switch restores both packages to "auto", float32 and the shared front-end
on, in a fixture's teardown."""
import jax
import numpy as np
import pytest
import torch

from gat_tpu import features as jf
from gat_tpu.data.synth import karplus_strong
from gat_tpu.infer import Transcriber as JTranscriber
from gat_tpu.infer.pipeline import build_clip_ensemble_fn as jbuild
from gat_tpu.ops import spectral as js
from gat_tpu.utils.wavio import write_wav
from gat_tpu_torch import features as tf
from gat_tpu_torch.infer import Transcriber, pipeline
from gat_tpu_torch.infer.pipeline import build_clip_ensemble_fn
from gat_tpu_torch.ops import spectral as ts
from gat_tpu_torch.ops import yin as ty
from tests.conftest import make_pluck
from tests.test_torch_segment import riff
from tests.test_torch_spectral import pluck_clips

SR = 11025
DTYPES = {"float32": (torch.float32, "float32"),
          "bfloat16": (torch.bfloat16, "bfloat16")}


def reset_routes() -> None:
    for mod in (js, ts):
        mod.set_stft_backend("auto")
    ts.set_matmul_dtype(torch.float32)
    js.set_matmul_dtype("float32")
    tf.SHARED_BLOCK_FRONTEND = True
    if not jf.SHARED_BLOCK_FRONTEND:
        jf.SHARED_BLOCK_FRONTEND = True
        jax.clear_caches()


@pytest.fixture
def matmul():
    """Both packages on the matmul route at float32; the defaults back
    afterwards."""
    try:
        for mod in (js, ts):
            mod.set_stft_backend("matmul")
        yield
    finally:
        reset_routes()


@pytest.fixture(params=list(DTYPES))
def matmul_dtype(request, matmul):
    tdt, jdt = DTYPES[request.param]
    ts.set_matmul_dtype(tdt)
    js.set_matmul_dtype(jdt)
    return request.param


@pytest.fixture(scope="module")
def jax_t():
    return JTranscriber()


@pytest.fixture(scope="module")
def port_t():
    return Transcriber(device="cpu")


@pytest.fixture(scope="module")
def clips():
    """The three plucks of gat_tpu's shared front-end test, every third
    noisy pluck of the 47 classes, and a silent clip."""
    plucks = np.stack([make_pluck(f, SR, 0.5, seed=5)
                       for f in (110.0, 196.0, 329.63)])
    return np.concatenate([plucks, pluck_clips(0.1)[::3],
                           np.zeros((1, 5512), np.float32)])


@pytest.fixture(scope="module")
def noisy():
    return pluck_clips(0.1)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("pitch_on_normalized", [True, False])
def test_front_end_matches_jax(matmul_dtype, clips, normalize,
                               pitch_on_normalized):
    """`mfcc_feature_vectors` on the shared route: one block DFT for the
    MFCC mean and the pitch, for every flag combination."""
    ref = np.asarray(jf.mfcc_feature_vectors(
        clips, SR, normalize_audio_volume=normalize,
        pitch_on_normalized=pitch_on_normalized))
    got = tf.mfcc_feature_vectors(
        torch.from_numpy(clips), SR, normalize_audio_volume=normalize,
        pitch_on_normalized=pitch_on_normalized).numpy()
    assert got.shape == ref.shape == (len(clips), 65)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[:, :64], ref[:, :64], atol=1e-3, rtol=0)
    np.testing.assert_allclose(10.0 ** got[:, 64], 10.0 ** ref[:, 64],
                               rtol=2e-3)
    assert 10.0 ** got[-1, 64] == pytest.approx(SR / 11, rel=1e-6)


def test_near_tie_pinned_on_the_shared_route(matmul_dtype):
    """test_torch_yin's near-tie, karplus_strong(880.03, seed=41), on the
    block route: at float32 JAX's median lands on 922.60 Hz and the
    port's on 942.87 (a frame's two troughs swap under another summation
    order; a float64 YIN says 1002.27); at bfloat16 both land on 440.84,
    an octave down. Its MFCC agrees to 1e-4."""
    x = karplus_strong(880.03, SR, 0.5, seed=41)
    ref = np.asarray(jf.mfcc_feature_vectors(x, SR))[0]
    got = tf.mfcc_feature_vectors(torch.from_numpy(x), SR).numpy()[0]
    np.testing.assert_allclose(got[:64], ref[:64], atol=1e-4, rtol=0)
    pins = {"float32": (922.597, 942.867), "bfloat16": (440.842, 440.842)}
    jax_hz, port_hz = pins[matmul_dtype]
    assert 10.0 ** ref[64] == pytest.approx(jax_hz, rel=1e-4)
    assert 10.0 ** got[64] == pytest.approx(port_hz, rel=1e-4)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("pitch_on_normalized", [True, False])
def test_mfcc_pitch_features_gives_its_pitch(matmul, noisy, normalize,
                                            pitch_on_normalized):
    """The pitch beside the features is the one in their last column;
    when it reads the raw clips it is `yin_pitch`'s on the matmul route,
    the block DFT's, bit for bit (JAX shares it through CSE)."""
    x = torch.from_numpy(noisy)
    feats, hz = tf.mfcc_pitch_features(x, SR, 64, normalize,
                                       pitch_on_normalized)
    assert feats.shape == (47, 65) and hz.shape == (47,)
    torch.testing.assert_close(feats[:, 64], torch.log10(hz), rtol=0,
                               atol=0)
    assert torch.equal(feats, tf.mfcc_feature_vectors(
        x, SR, normalize_audio_volume=normalize,
        pitch_on_normalized=pitch_on_normalized))
    if tf.shared_pitch_is_raw(normalize, pitch_on_normalized):
        assert torch.equal(hz, ty.yin_pitch(x, SR))


def test_zero_rows(matmul):
    feats, hz = tf.mfcc_pitch_features(torch.zeros(0, 5512), SR)
    assert feats.shape == (0, 65) and hz.shape == (0,)


def test_shared_front_end_off_gives_the_separate_pipelines(matmul, clips,
                                                           monkeypatch):
    """With SHARED_BLOCK_FRONTEND False the matmul route runs the
    separate front-ends (frame GEMMs for the MFCC, the block YIN), in
    both packages."""
    jf.SHARED_BLOCK_FRONTEND = False
    jax.clear_caches()
    tf.SHARED_BLOCK_FRONTEND = False
    monkeypatch.setattr(tf, "mfcc_pitch_features", None)  # not reached
    assert not tf.shared_frontend()
    ref = np.asarray(jf.mfcc_feature_vectors(clips, SR))
    got = tf.mfcc_feature_vectors(torch.from_numpy(clips), SR).numpy()
    np.testing.assert_allclose(got[:, :64], ref[:, :64], atol=1e-3, rtol=0)
    np.testing.assert_allclose(10.0 ** got[:, 64], 10.0 ** ref[:, 64],
                               rtol=2e-3)


def test_shared_route_needs_the_pitch_feature(matmul, clips, monkeypatch):
    """Without the pitch feature the MFCC mean comes from the separate
    front-end, as in JAX."""
    monkeypatch.setattr(tf, "mfcc_pitch_features", None)  # not reached
    assert tf.shared_frontend() and not tf.shared_frontend(False)
    ref = np.asarray(jf.mfcc_feature_vectors(clips, SR,
                                             add_pitch_features=False))
    got = tf.mfcc_feature_vectors(torch.from_numpy(clips), SR,
                                  add_pitch_features=False).numpy()
    assert got.shape == (len(clips), 64)
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)


def _same_probs(got, ref) -> None:
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got.argmax(1), ref.argmax(1))
    np.testing.assert_allclose(got, ref, atol=1e-2)


@pytest.mark.parametrize("prior", [0.0, 0.5])
@pytest.mark.parametrize("pitch_on_normalized", [False, True])
def test_clip_ensemble_matches_jax(matmul, jax_t, port_t, noisy, prior,
                                   pitch_on_normalized, monkeypatch):
    """The ensemble, blended and in parts, with and without the pitch
    prior. The prior's pitch is the front-end's when that reads the raw
    clips (no YIN of its own), else YIN of the raw clips, as JAX's
    `yin_pitch(c)`."""
    yins = []
    monkeypatch.setattr(pipeline, "yin_pitch", lambda c, sr: (
        yins.append(1), ty.yin_pitch(c, sr))[1])
    monkeypatch.setattr(jax_t.predictor, "pitch_prior_weight", prior)
    monkeypatch.setattr(port_t.predictor, "pitch_prior_weight", prior)
    mfcc, mel = jax_t._feature_params()
    ref = jbuild(jax_t.predictor, jax_t.scaler, SR, mfcc, mel,
                 pitch_on_normalized=pitch_on_normalized,
                 return_parts=True)(noisy)
    fn = build_clip_ensemble_fn(port_t.predictor, port_t.scaler, SR, mfcc,
                                mel, pitch_on_normalized=pitch_on_normalized,
                                return_parts=True)
    got = fn(torch.from_numpy(noisy))
    for g, r in zip(got, ref):
        _same_probs(g, r)
    blended = build_clip_ensemble_fn(
        port_t.predictor, port_t.scaler, SR, mfcc, mel,
        pitch_on_normalized=pitch_on_normalized)(torch.from_numpy(noisy))
    assert torch.equal(blended, got[0])
    assert bool(yins) == (prior > 0 and pitch_on_normalized)


def test_transcribe_clips_matches_jax(matmul, jax_t, port_t, noisy,
                                      monkeypatch):
    """`transcribe_clips` on the shared route runs no YIN of its own: the
    baseline is the front-end's pitch of the raw clips."""
    monkeypatch.setattr(pipeline, "yin_pitch", None)  # not reached
    ref = jax_t.transcribe_clips(noisy)
    got = port_t.transcribe_clips(noisy)
    assert got["labels"] == ref["labels"]
    _same_probs(got["probs"], ref["probs"])
    hz = np.array([p for p, _ in got["dsp_info"]])
    np.testing.assert_allclose(hz, [p for p, _ in ref["dsp_info"]],
                               rtol=2e-3)
    _, shared_hz = tf.mfcc_pitch_features(torch.from_numpy(noisy), SR)
    np.testing.assert_array_equal(hz, shared_hz.numpy())


def test_entry_step_on_the_shared_route(matmul, port_t, noisy):
    """The entry step's pitch is the shared front-end's too."""
    from gat_tpu_torch.entry import entry
    step, _ = entry(batch=4, device="cpu")
    probs, hz = step(torch.from_numpy(noisy))
    ref = port_t.transcribe_clips(noisy)
    _same_probs(probs.numpy(), ref["probs"])
    _, shared_hz = tf.mfcc_pitch_features(torch.from_numpy(noisy), SR)
    assert torch.equal(hz, shared_hz)


@pytest.mark.parametrize("fused", [False, True])
def test_transcribe_file_matches_jax(matmul, jax_t, port_t, tmp_path, fused):
    """A riff WAV on the shared route, two-stage and fused: labels,
    onsets and times identical to JAX's matmul route."""
    path = tmp_path / "riff.wav"
    write_wav(path, riff(22050, dur=3.7), 22050)
    ref = jax_t.transcribe(path)
    got = port_t.transcribe(path, fused=fused)
    assert got["labels"] == ref["labels"] == ["A2", "D3", "G3", "B3"]
    assert got["onsets_s"] == ref["onsets_s"]
    assert got["times"] == ref["times"]
    _same_probs(got["probs"], ref["probs"])
    np.testing.assert_allclose([p for p, _ in got["dsp_info"]],
                               [p for p, _ in ref["dsp_info"]], rtol=2e-3)


def test_route_is_read_on_every_call(port_t, noisy, monkeypatch):
    """A function built on the FFT route takes the shared route once the
    switch says so, and back: the ensemble, the file body and the
    FeatureBuilder hold no route."""
    calls = []
    shared = tf.mfcc_pitch_features
    monkeypatch.setattr(pipeline, "mfcc_pitch_features", lambda *a, **k: (
        calls.append(1), shared(*a, **k))[1])
    x = torch.from_numpy(noisy)
    fn = port_t.ensemble
    run, _ = port_t._files_fn(22050, 0.5, 8, None, None)
    y = torch.from_numpy(riff(22050, dur=3.7))[None]
    nv = torch.tensor([y.shape[1]])
    fft = fn(x), port_t.feature_builder.extract_inference_features_from_clips(
        x, SR, port_t.mfcc_params, None)[0], run(y, nv)
    assert not calls
    try:
        ts.set_stft_backend("matmul")
        got = fn(x), port_t.feature_builder.\
            extract_inference_features_from_clips(
                x, SR, port_t.mfcc_params, None)[0], run(y, nv)
        assert len(calls) == 2  # the ensemble and the file body
        _same_probs(got[0][0], fft[0][0])
        torch.testing.assert_close(got[1], fft[1], atol=5e-2, rtol=0)
        assert torch.equal(got[2][5], fft[2][5])  # onsets
    finally:
        reset_routes()
    again = fn(x)
    assert len(calls) == 2
    assert torch.equal(again[0], fft[0][0])
