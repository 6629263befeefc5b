"""The port's predictor API against gat_tpu's (CPU, the shipped
checkpoints): settings changed after construction, the blend weight, the
bf16 CNN, `predict(pitch_hz=)`, `ensemble_probs(cnn_weight=, pitch_hz=)`,
`predict_debug` and the NCHW mel layout.

Bounds: labels identical; on the same features the probs within atol
1e-5 (float32 rounding, as test_torch_slice holds them); through the
front-ends within atol 1e-2 (test_torch_slice, test_torch_file_path);
the bf16 CNN within atol 1e-2, since the frameworks round to bf16 after
different operations (oneDNN's and XLA's convolutions and products
accumulate in other orders before the one rounding to 8 bits of
mantissa, about 4e-3 relative per layer)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gat_tpu.infer import NotePredictor as JNotePredictor
from gat_tpu.infer import Transcriber as JTranscriber
from gat_tpu.utils.wavio import write_wav
from gat_tpu_torch.infer import NotePredictor, Transcriber
from tests.conftest import make_pluck
from tests.test_torch_segment import riff
from tests.test_torch_spectral import pluck_clips

SR = 11025


@pytest.fixture(scope="module")
def jax_t():
    return JTranscriber()


@pytest.fixture(scope="module")
def port_t():
    return Transcriber(device="cpu")


@pytest.fixture(scope="module")
def features(jax_t):
    """JAX's scaled MFCC vectors, NHWC mel images and YIN pitches of 12
    noisy plucks."""
    from gat_tpu.ops.yin import yin_pitch
    clips = pluck_clips(0.1)[:12]
    mfcc_p, mel_p = jax_t._feature_params()
    mf, ms = jax_t.feature_builder.extract_inference_features_from_clips(
        clips, SR, mfcc_p, mel_p, jax_t.scaler)
    return (np.array(mf), np.array(ms),
            np.array(yin_pitch(jnp.asarray(clips), SR)))


@pytest.fixture(scope="module")
def predictors(jax_t, port_t):
    """A JAX and a port predictor on the shipped models, prior on."""
    jp = JNotePredictor(pitch_prior_weight=0.4)
    jp.load_models(jax_t.model_ckpts["mlp"], jax_t.model_ckpts["cnn"])
    tp = NotePredictor(pitch_prior_weight=0.4, device="cpu")
    tp.load_models(port_t.model_ckpts["mlp"], port_t.model_ckpts["cnn"])
    return jp, tp


def _close(got: dict, ref: dict, atol: float) -> None:
    assert got["labels"] == ref["labels"]
    np.testing.assert_allclose(got["probs"], ref["probs"], atol=atol)
    np.testing.assert_allclose(got["confidences"], ref["confidences"],
                               atol=atol)


@pytest.fixture(scope="module")
def riff_wav(tmp_path_factory):
    path = tmp_path_factory.mktemp("prior") / "riff.wav"
    write_wav(path, riff(22050, dur=3.7), 22050)
    return path


@pytest.mark.parametrize("weight, sigma", [(0.9, 0.5), (0.4, 2.0)])
@pytest.mark.parametrize("route", ["clips", "two_stage", "fused"])
def test_prior_changed_after_construction(jax_t, port_t, riff_wav, route,
                                          weight, sigma):
    """Both Transcribers are built and have run with the prior off; the
    prior's weight and sigma then change on the built objects. The port's
    probs move as JAX's do (each route has cached its function by then)."""
    def run(t):
        if route == "clips":
            return t.transcribe_clips(pluck_clips(0.1)[::4])
        return t.transcribe(riff_wav, fused=route == "fused")

    before = run(port_t)
    try:
        for t in (jax_t, port_t):
            t.predictor.pitch_prior_weight = weight
            t.predictor.pitch_prior_sigma = sigma
        ref, got = run(jax_t), run(port_t)
    finally:
        for t in (jax_t, port_t):
            t.predictor.pitch_prior_weight = 0.0
            t.predictor.pitch_prior_sigma = 0.5
    _close(got, ref, 1e-2)
    assert float(np.abs(got["probs"] - before["probs"]).max()) > 0.1
    np.testing.assert_allclose(run(port_t)["probs"], before["probs"],
                               atol=1e-6)  # and back off


def test_cnn_weight_changed_after_construction(jax_t, port_t):
    clips = pluck_clips(0.1)[1::4]
    port_t.transcribe_clips(clips)
    try:
        for t in (jax_t, port_t):
            t.predictor.cnn_weight = 0.3
        _close(port_t.transcribe_clips(clips), jax_t.transcribe_clips(clips),
               1e-2)
    finally:
        for t in (jax_t, port_t):
            t.predictor.cnn_weight = 0.8


@pytest.mark.parametrize("cnn_weight", [0.5, 0.0])
def test_transcriber_cnn_weight(cnn_weight):
    clips = pluck_clips(0.1)[::3]
    t = Transcriber(cnn_weight=cnn_weight, device="cpu")
    assert t.predictor.cnn_weight == cnn_weight
    _close(t.transcribe_clips(clips),
           JTranscriber(cnn_weight=cnn_weight).transcribe_clips(clips), 1e-2)


@pytest.fixture(scope="module")
def bf16_pair():
    return (JTranscriber(cnn_dtype=jnp.bfloat16),
            Transcriber(cnn_dtype=torch.bfloat16, device="cpu"))


@pytest.mark.parametrize("f, note", [(110.0, "A2"), (196.0, "G3"),
                                     (329.63, "E4")])
def test_cnn_bf16_plucks(bf16_pair, port_t, f, note):
    """The three plucks of tests/test_infer.py's bf16 parity test: the
    port's bf16 CNN gives JAX's bf16 labels and the float32 labels."""
    jax16, port16 = bf16_pair
    assert port16.predictor.cnn.dtype == torch.bfloat16
    assert port_t.predictor.cnn.dtype == torch.float32
    clip = make_pluck(f, 22050, 0.5, seed=11)
    ref = jax16.transcribe_note(clip, sr_in=22050)
    got = port16.transcribe_note(clip, sr_in=22050)
    assert got["labels"] == ref["labels"] == [note]
    assert port_t.transcribe_note(clip, sr_in=22050)["labels"] == [note]
    assert got["probs"].dtype == np.float32
    np.testing.assert_allclose(got["probs"], ref["probs"], atol=1e-2)
    np.testing.assert_allclose(got["per_model_probs"]["cnn"],
                               ref["per_model_probs"]["cnn"], atol=1e-2)


def test_cnn_bf16_clips(bf16_pair):
    """47 noisy plucks through the bf16 CNN: labels identical to JAX's."""
    jax16, port16 = bf16_pair
    clips = pluck_clips(0.1)
    _close(port16.transcribe_clips(clips), jax16.transcribe_clips(clips),
           1e-2)


@pytest.mark.parametrize("cnn_weight", [None, 0.3])
def test_ensemble_probs_weight_and_pitch(predictors, features, cnn_weight):
    """A per-call blend weight and the pitch prior, on JAX's features."""
    jp, tp = predictors
    mf, ms, hz = features
    ref = [np.asarray(x) for x in jp.ensemble_probs(
        mf, ms, cnn_weight=cnn_weight, pitch_hz=hz)]
    got = [x.numpy() for x in tp.ensemble_probs(
        mf, ms, cnn_weight=cnn_weight, pitch_hz=hz)]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, atol=1e-5)
    assert tp.cnn_weight == 0.8
    no_prior = tp.ensemble_probs(mf, ms, cnn_weight=cnn_weight)[0].numpy()
    assert float(np.abs(no_prior - got[0]).max()) > 0.05


def test_predict_pitch_hz(predictors, features):
    jp, tp = predictors
    mf, ms, hz = features
    _close(tp.predict(mf, ms, pitch_hz=hz), jp.predict(mf, ms, pitch_hz=hz),
           1e-5)
    _close(tp.predict(mf, ms), jp.predict(mf, ms), 1e-5)


def test_prior_follows_label_map(predictors, features):
    """The class-MIDI table follows a changed label map."""
    jp, tp = predictors
    mf, ms, hz = features
    rm = dict(tp.reverse_map)
    shifted = {i: rm[(i + 12) % len(rm)] for i in rm}
    before = tp.predict(mf, ms, pitch_hz=hz)
    try:
        jp.reverse_map = tp.reverse_map = shifted
        _close(tp.predict(mf, ms, pitch_hz=hz),
               jp.predict(mf, ms, pitch_hz=hz), 1e-5)
    finally:
        jp.reverse_map = tp.reverse_map = rm
    _close(tp.predict(mf, ms, pitch_hz=hz), before, 0.0)


@pytest.mark.parametrize("mel", [True, False])
def test_predict_debug(predictors, features, mel, capsys):
    """One forward, each weight re-blended on the host; `cnn_weight`
    untouched. Without the mel features the weight has no effect."""
    jp, tp = predictors
    mf, ms, _ = features
    weights = [1.0, 0.5, 0.0]
    ref = jp.predict_debug(weights, mf, ms if mel else None)
    got = tp.predict_debug(weights, mf, ms if mel else None)
    assert tp.cnn_weight == 0.8
    assert [w for w, _ in got] == weights
    for (_, g), (_, r) in zip(got, ref):
        _close(g, r, 1e-5)
    assert "weight:" in capsys.readouterr().out


def test_nchw_mel_equals_nhwc(predictors, features):
    """The reference's NCHW (N, 1, M, T) mel layout gives the NHWC
    result; a mel input that is not 4-D is refused."""
    _, tp = predictors
    mf, ms, _ = features
    nchw = np.ascontiguousarray(np.transpose(ms, (0, 3, 1, 2)))
    assert nchw.shape[1] == 1 and nchw.shape[-1] != 1
    a = tp.ensemble_probs(mf, ms)
    b = tp.ensemble_probs(mf, nchw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="4-D"):
        tp.ensemble_probs(mf, ms[..., 0])
