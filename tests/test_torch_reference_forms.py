"""PyTorch port vs gat_tpu: the reference's calling forms that the port
refused (CPU, plain versions), and the whole-file path at a clip length
the card refused before its clip kernels took any length.

* `slice_at_onsets` at onsets that are not multiples of the onset hop,
  with `onset_hop=None` (the reference's default: a per-sample gather)
  and 512 (the row gather, for aligned onsets);
* the mel filterbanks' `fmin`, `fmax`, `htk` and `norm`;
* one signal (n,) and the reference's keywords (`n_valid_samples`,
  `valid_frames`) at `detect_onsets`, `onset_strength`, `gate_waveform`,
  `rms_gate`, `rms_db_envelope`, `slice_at_onsets` and
  `segment_waveform`, and the five `AudioSlicer` methods called on the
  class;
* `transcribe(clip_duration=4.0)` of a 12 s riff.

Bounds, each with its reason: clips atol 1e-6 (gathered samples; the
float32 RMS of the loudness gate aside, nothing is computed); kept,
times, onsets, masks, flags and counts identical; the filterbanks 1e-7
(the same float64 formulas, rounded to float32 once); the onset envelope
atol 1e-3 and the frame RMS in dB atol 1e-4 (sums in another order, as
tests/test_torch_segment.py holds them); labels, onsets and times of the
file path identical and probs within 1e-2 (tests/test_torch_file_path.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gat_tpu.ops import mel as jmel, onset as jo
from gat_tpu.segment import gating as jg, slicing as js
from gat_tpu_torch.ops import mel as tmel, onset as to
from gat_tpu_torch.segment import gating as tg, slicing as ts
from tests.test_torch_segment import riff

SR = 22050
UNALIGNED = [1000, 23456, 50001]  # not multiples of 512


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_slices(got, ref) -> None:
    clips, kept, times = (_np(x) for x in got)
    np.testing.assert_allclose(clips, np.asarray(ref[0]), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(kept, np.asarray(ref[1]))
    np.testing.assert_array_equal(times, np.asarray(ref[2]))


def _signal_and_onsets():
    y = riff(dur=4.0) + np.random.default_rng(16).normal(
        0, 0.01, int(4.0 * SR)).astype(np.float32)
    onsets = np.array(UNALIGNED + [0], np.int32)
    valid = np.array([True, True, True, False])
    return y, onsets, valid


@pytest.mark.parametrize("strict", [True, False])
def test_slice_at_onsets_unaligned_default(strict):
    """The default `onset_hop=None` gathers each clip sample by sample, as
    the reference's default does: onsets [1000, 23456, 50001] give the
    reference's clips (the row gather rounded each start down to a hop
    row, up to 1.82 away)."""
    y, onsets, valid = _signal_and_onsets()
    ref = js.slice_at_onsets(jnp.asarray(y), jnp.asarray(onsets),
                             jnp.asarray(valid), sr=SR,
                             strict_reference_compat=strict)
    got = ts.slice_at_onsets(torch.from_numpy(y)[None],
                             torch.from_numpy(onsets)[None],
                             torch.from_numpy(valid)[None], sr=SR,
                             strict_reference_compat=strict)
    _same_slices([x[0] for x in got], ref)
    assert bool(got[1].any())
    got_none = ts.slice_at_onsets(torch.from_numpy(y)[None],
                                  torch.from_numpy(onsets)[None],
                                  torch.from_numpy(valid)[None], sr=SR,
                                  strict_reference_compat=strict,
                                  onset_hop=None)
    for a, b in zip(got, got_none):
        assert torch.equal(a, b)


def test_slice_at_onsets_hop_512_on_aligned_onsets():
    """`onset_hop=512` keeps the row gather for onsets that are multiples
    of the hop (the caller's contract in both packages), and equals the
    per-sample gather there."""
    y, _, valid = _signal_and_onsets()
    onsets = np.array([1024, 23552, 50176, 0], np.int32)
    ref = js.slice_at_onsets(jnp.asarray(y), jnp.asarray(onsets),
                             jnp.asarray(valid), sr=SR, onset_hop=512)
    args = (torch.from_numpy(y)[None], torch.from_numpy(onsets)[None],
            torch.from_numpy(valid)[None])
    rows = ts.slice_at_onsets(*args, sr=SR, onset_hop=512)
    _same_slices([x[0] for x in rows], ref)
    samples = ts.slice_at_onsets(*args, sr=SR)
    for a, b in zip(rows, samples):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_slice_at_onsets_one_signal_and_n_valid_samples():
    """One signal (n,), (K,), (K,) gives the reference's (K, L), (K,),
    (K, 2), and its `n_valid_samples` counts as `n_valid`."""
    y, onsets, valid = _signal_and_onsets()
    nv = 60000
    ref = js.slice_at_onsets(jnp.asarray(y), jnp.asarray(onsets),
                             jnp.asarray(valid), sr=SR,
                             n_valid_samples=jnp.asarray(nv))
    got = ts.slice_at_onsets(torch.from_numpy(y), torch.from_numpy(onsets),
                             torch.from_numpy(valid), sr=SR,
                             n_valid_samples=nv)
    assert got[0].ndim == 2 and got[1].ndim == 1 and got[2].ndim == 2
    _same_slices(got, ref)
    with pytest.raises(TypeError, match="not both"):
        ts.slice_at_onsets(torch.from_numpy(y), torch.from_numpy(onsets),
                           torch.from_numpy(valid), sr=SR,
                           n_valid_samples=nv, n_valid=nv)


@pytest.mark.parametrize("kw", [{}, {"htk": True}, {"norm": None},
                                {"fmin": 30.0, "fmax": 4000.0},
                                {"fmin": 80.0, "fmax": 8000.0, "htk": True,
                                 "norm": None}])
@pytest.mark.parametrize("sr, n_fft, n_mels", [(22050, 2048, 128),
                                               (11025, 1024, 64)])
def test_mel_filterbank_librosa_parameters(kw, sr, n_fft, n_mels):
    ref = jmel.mel_filterbank_librosa(sr, n_fft, n_mels, **kw)
    got = tmel.mel_filterbank_librosa(sr, n_fft, n_mels, **kw)
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-7, rtol=0)


@pytest.mark.parametrize("kw", [{}, {"fmin": 20.0},
                                {"fmin": 40.0, "fmax": 5000.0}])
def test_mel_filterbank_torchaudio_parameters(kw):
    ref = jmel.mel_filterbank_torchaudio(11025, 2048, 64, **kw)
    got = tmel.mel_filterbank_torchaudio(11025, 2048, 64, **kw)
    np.testing.assert_allclose(got, ref, atol=1e-7, rtol=0)


def test_mel_filterbanks_positional_as_the_reference():
    """The parameters in the reference's order, and the cache keeps one
    table per set of arguments."""
    args = (22050, 2048, 128, 30.0, 4000.0, True, None)
    np.testing.assert_allclose(tmel.mel_filterbank_librosa(*args),
                               jmel.mel_filterbank_librosa(*args),
                               atol=1e-7, rtol=0)
    assert (tmel.mel_filterbank_librosa(*args)
            is tmel.mel_filterbank_librosa(*args))
    assert not np.array_equal(tmel.mel_filterbank_librosa(22050, 2048, 128),
                              tmel.mel_filterbank_librosa(*args))


@pytest.mark.parametrize("nv", [None, 60001])
def test_gates_one_signal_and_n_valid_samples(nv):
    """`rms_db_envelope`, `rms_gate` and `gate_waveform` of one signal,
    with and without the reference's `n_valid_samples`."""
    y = riff(dur=3.5) + np.random.default_rng(3).normal(
        0, 0.003, int(3.5 * SR)).astype(np.float32)
    jnv = None if nv is None else jnp.asarray(nv)
    t = torch.from_numpy(y)
    env = tg.rms_db_envelope(t, n_valid_samples=nv)
    assert env.ndim == 1
    np.testing.assert_allclose(
        env.numpy(), np.asarray(jg.rms_db_envelope(jnp.asarray(y),
                                                   n_valid_samples=jnv)),
        atol=1e-4, rtol=0)
    for port, ref in ((tg.rms_gate(t, n_valid_samples=nv),
                       jg.rms_gate(jnp.asarray(y), n_valid_samples=jnv)),
                      (tg.gate_waveform(t, -32.5, n_valid_samples=nv),
                       jg.gate_waveform(jnp.asarray(y), -32.5,
                                        n_valid_samples=jnv))):
        assert port.shape == y.shape
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    batch = tg.gate_waveform(t[None], -32.5,
                             n_valid=None if nv is None
                             else torch.tensor([nv]))
    assert torch.equal(batch[0], tg.gate_waveform(t, -32.5,
                                                  n_valid_samples=nv))


@pytest.mark.parametrize("padded", [False, True])
def test_onset_strength_one_signal_and_valid_frames(padded):
    """One signal gives (T,); the reference's `valid_frames` prefix mask
    counts as `n_valid_frames`, for one signal and for a batch."""
    y = riff(dur=3.0)
    t = 1 + len(y) // 512
    valid = (np.arange(t) < 70) if padded else None
    ref = np.asarray(jo.onset_strength(
        jnp.asarray(y), SR,
        valid_frames=None if valid is None else jnp.asarray(valid)))
    got = to.onset_strength(torch.from_numpy(y), SR,
                            valid_frames=None if valid is None
                            else torch.from_numpy(valid))
    assert got.shape == (t,)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-3, rtol=0)
    if padded:
        batch = to.onset_strength(torch.from_numpy(y)[None], SR,
                                  valid_frames=torch.from_numpy(valid)[None])
        assert torch.equal(batch[0], to.onset_strength(
            torch.from_numpy(y)[None], SR,
            n_valid_frames=torch.tensor([70]))[0])


@pytest.mark.parametrize("nv", [None, 66150])
def test_detect_onsets_one_signal_and_n_valid_samples(nv):
    """One signal gives the reference's (max_onsets,) onsets and mask and
    its () flags and count, identical."""
    y = np.pad(riff(dur=3.0), (0, SR))
    ref = jo.detect_onsets(jnp.asarray(y), sr=SR, max_onsets=8,
                           n_valid_samples=None if nv is None
                           else jnp.asarray(nv))
    got = to.detect_onsets(torch.from_numpy(y), sr=SR, max_onsets=8,
                           n_valid_samples=nv)
    assert got[0].shape == (8,) and got[2].ndim == 0 and got[4].ndim == 0
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert int(got[1].sum()) >= 3


def test_segment_waveform_one_signal_and_n_valid_samples():
    """One signal, with the reference's `n_valid_samples`: the reference's
    eight outputs, unbatched."""
    y = np.pad(riff(dur=3.0), (0, SR))
    ref = js.segment_waveform(jnp.asarray(y), sr=SR,
                              n_valid_samples=jnp.asarray(3 * SR))
    got = ts.segment_waveform(torch.from_numpy(y), sr=SR,
                              n_valid_samples=3 * SR)
    assert got[0].ndim == 2 and got[5].ndim == 0
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-6,
                               rtol=0)
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert int(got[1].sum()) >= 2


def test_audio_slicer_methods_on_the_class(monkeypatch, tmp_path):
    """The reference's five static methods called on the class compute on
    `AudioSlicer.default_device` (here the CPU: the default is the card)
    and give the reference's results; on an instance they still run on
    its device."""
    from gat_tpu_torch.utils.wavio import write_wav
    monkeypatch.setattr(ts.AudioSlicer, "default_device", "cpu")
    path = tmp_path / "riff.wav"
    write_wav(path, riff(dur=3.0), SR)
    port, ref = ts.AudioSlicer, js.AudioSlicer
    y, sr = port.load_wav(path)
    y_ref, sr_ref = ref.load_wav(path)
    assert sr == sr_ref
    np.testing.assert_allclose(y, y_ref, atol=1e-5)
    np.testing.assert_allclose(port.apply_db_threshold(y),
                               ref.apply_db_threshold(y), atol=1e-6)
    np.testing.assert_allclose(port.apply_rms_threshold(y, 256),
                               ref.apply_rms_threshold(y, 256), atol=1e-6)
    assert port.detect_onsets(y, sr) == ref.detect_onsets(y, sr)
    assert (port.is_slice_loud_enough(y[:5512], -40.0)
            == ref.is_slice_loud_enough(y[:5512], -40.0))
    inst = ts.AudioSlicer(device="cpu")
    assert inst.detect_onsets(y, sr) == port.detect_onsets(y, sr)
    monkeypatch.setattr(ts.AudioSlicer, "default_device", None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port.apply_db_threshold(y)


@pytest.fixture(scope="module")
def transcribers():
    from gat_tpu.infer import Transcriber as JTranscriber
    from gat_tpu_torch.infer import Transcriber
    return JTranscriber(), Transcriber(device="cpu")


def test_transcribe_clip_duration_4(transcribers, tmp_path):
    """`transcribe(clip_duration=4.0)` of a 12 s riff, clips of 87 frames
    at the MFCC's hop (the card's kernels refused 71 or more before): the
    reference's labels, onsets and times on the port's CPU path (the last
    onset dropped, as the reference's slicer drops it)."""
    from gat_tpu_torch.utils.wavio import write_wav
    jax_t, port_t = transcribers
    notes = ((0.4, 110.0), (4.6, 196.0), (8.8, 329.63))
    path = tmp_path / "riff.wav"
    write_wav(path, riff(dur=12.0, notes=notes), SR)
    ref = jax_t.transcribe(path, clip_duration=4.0)
    got = port_t.transcribe(path, clip_duration=4.0)
    # the models saw clips of 0.5 s: a 4 s clip's label is not the note's,
    # but it is the reference's
    assert got["labels"] == ref["labels"] and len(got["labels"]) == 2
    assert got["onsets_s"] == ref["onsets_s"]
    assert got["times"] == ref["times"]
    np.testing.assert_allclose(got["probs"], ref["probs"], atol=1e-2)
