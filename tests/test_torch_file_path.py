"""PyTorch port vs gat_tpu: the whole-file path, from a WAV on disk to
labels with onsets (CPU, the shipped checkpoints, plain versions of the
kernels).

Bounds: labels, onsets, kept masks, flags, `onsets_s` and `times`
identical; ensemble probs within atol 1e-2 and the YIN baseline within
rtol 2e-3, as test_torch_slice holds the clip path."""
import numpy as np
import pytest
import torch

from gat_tpu.infer import Transcriber as JTranscriber
from gat_tpu.infer import transcriber as jtr
from gat_tpu.utils.wavio import write_wav
from gat_tpu_torch.infer import Transcriber
from gat_tpu_torch.infer import transcriber as ttr
from gat_tpu_torch.infer.pipeline import build_files_fn
from tests.test_torch_segment import riff

SR = 22050
LABELS = ["A2", "D3", "G3", "B3"]  # the riff's notes but the dropped last


@pytest.fixture(scope="module")
def jax_t():
    return JTranscriber()


@pytest.fixture(scope="module")
def port_t():
    return Transcriber(device="cpu")


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("riffs")
    paths = {}
    for sr in (22050, 44100, 48000):
        paths[sr] = d / f"riff_{sr}.wav"
        write_wav(paths[sr], riff(sr, dur=3.7), sr)
    paths["silent"] = d / "silent.wav"
    write_wav(paths["silent"], np.zeros(SR, np.float32), SR)
    return paths


def _same(got: dict, ref: dict) -> None:
    assert got["labels"] == ref["labels"]
    assert got["onsets_s"] == ref["onsets_s"]
    assert got["times"] == ref["times"]
    assert got["onset_overflow"] == ref["onset_overflow"]
    np.testing.assert_allclose(got["probs"], ref["probs"], atol=1e-2)
    np.testing.assert_allclose([p for p, _ in got["dsp_info"]],
                               [p for p, _ in ref["dsp_info"]], rtol=2e-3)


@pytest.mark.parametrize("sr", [22050, 44100, 48000])
def test_transcribe_matches(jax_t, port_t, wavs, sr):
    """Both resample branches (44100: decimation, 48000: phases), the
    two-stage default and the fused route."""
    ref = jax_t.transcribe(wavs[sr])
    got = port_t.transcribe(wavs[sr])
    _same(got, ref)
    assert got["labels"] == LABELS
    fused = port_t.transcribe(wavs[sr], fused=True)
    _same(fused, got)
    assert set(fused) == set(got)


def test_exact_fallback(jax_t, port_t, wavs):
    """A two-candidate budget truncates and flags; the exact fallback
    re-segments with the full walk and gives the default result."""
    p = wavs[SR]
    base = port_t.transcribe(p)
    raw = port_t.transcribe(p, cand_budget=2, exact_fallback=False)
    _same(raw, jax_t.transcribe(p, cand_budget=2, exact_fallback=False))
    assert raw["onset_overflow"] and len(raw["labels"]) < len(base["labels"])
    for fused in (False, True):
        _same(port_t.transcribe(p, cand_budget=2, fused=fused), base)


def test_cap_auto_scaling(jax_t, port_t, wavs):
    """max_onsets 2 truncates; the re-run at the power of two that fits
    (8, the ceiling) repairs it; without a ceiling the flag stays."""
    p = wavs[SR]
    base = port_t.transcribe(p)
    for fused in (False, True):
        _same(port_t.transcribe(p, max_onsets=2, max_onsets_ceiling=8,
                                fused=fused), base)
    capped = port_t.transcribe(p, max_onsets=2, max_onsets_ceiling=None)
    _same(capped, jax_t.transcribe(p, max_onsets=2, max_onsets_ceiling=None))
    assert capped["onset_overflow"] and capped["labels"] == LABELS[:1]


@pytest.mark.parametrize("fused", [False, True])
def test_silent_file_raises(port_t, wavs, fused):
    with pytest.raises(ValueError, match="No clips survived"):
        port_t.transcribe(wavs["silent"], fused=fused)


def test_save_clips(port_t, wavs, tmp_path):
    got = port_t.transcribe(wavs[SR], out_root=tmp_path, audio_name="riff",
                            save_clips=True)
    files = sorted(tmp_path.rglob("*.wav"))
    assert len(files) == len(got["labels"])
    assert files[0].name == f"0000_clip__{got['onsets_s'][0]:.3f}s.wav"


@pytest.mark.parametrize("sr_in", [22050, 11025])
def test_transcribe_note_matches(jax_t, port_t, sr_in):
    note = riff(sr_in, dur=0.5, notes=((0.0, 196.0),))
    ref = jax_t.transcribe_note(note, sr_in=sr_in)
    got = port_t.transcribe_note(note, sr_in=sr_in)
    assert got["labels"] == ref["labels"] == ["G3"]
    np.testing.assert_allclose(got["probs"], ref["probs"], atol=1e-2)


@pytest.mark.parametrize("budget", [None, 4])
def test_build_files_fn_matches(jax_t, port_t, budget):
    """Three files at B=3, one of them padded and one silent, 8 onset
    slots each; a clip budget of 4 of the 24 slots keeps two clips of
    each sounding file (slot-major) and flags the file that lost one."""
    ys = np.stack([riff(dur=3.0), np.pad(riff(dur=2.0), (0, SR)),
                   np.zeros(3 * SR, np.float32)])
    nv = np.array([3 * SR, 2 * SR, 0])
    mfcc, mel = jax_t._feature_params()
    run, _ = jax_t._fused_files_fn(SR, 0.5, 8, wave_clip_budget=budget)
    ref = [np.asarray(x) if x is not None else None
           for x in run(ys, nv.astype(np.int32))]
    fn = build_files_fn(port_t.predictor, port_t.scaler, port_t.ckpt_sr,
                        mfcc, mel, SR, 0.5, 8, wave_clip_budget=budget)
    got = [x.numpy() if x is not None else None
           for x in fn(torch.from_numpy(ys), torch.from_numpy(nv))]
    probs, kept = got[0], got[4]
    for i in range(4, 10):  # kept, onsets, times, overflow, fixable, n_det
        np.testing.assert_array_equal(got[i], ref[i])
    np.testing.assert_array_equal(probs.argmax(-1)[kept],
                                  ref[0].argmax(-1)[kept])
    for i in range(3):  # blended, mlp and cnn probs, also in empty slots
        np.testing.assert_allclose(got[i], ref[i], atol=1e-2)
    np.testing.assert_allclose(got[3][kept], ref[3][kept], rtol=2e-3)
    if budget is not None:
        assert kept.sum() == 4 and got[7][0] and got[8][0]


def test_host_helpers_match():
    for d in (0.2, 1.0, 1.01, 3.7, 17.0):
        assert ttr.bucket_seconds(d) == jtr.bucket_seconds(d)
    for args in ((3, 2, 8), (40, 2, 1024), (9, 8, 8), (5, 4, None),
                 (5, 4, 0), (100, 64, 100)):
        assert ttr._next_onset_cap(*args) == jtr._next_onset_cap(*args)
