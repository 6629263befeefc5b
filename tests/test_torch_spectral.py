"""PyTorch port vs gat_tpu: spectral helpers and the two feature
front-ends' plain versions, on Karplus-Strong plucks over the 47 classes
(E2..D6) with and without noise (CPU; JAX takes its FFT route).

The mel image is held to 0.1 dB only where JAX reads above -60 dB: far
below that, fp32 rounding of near-zero power legitimately moves the log
by several dB (the power sits at the float floor of the frame's peak), and
such bins carry no weight in the CNN's decision."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gat_tpu import features as jf
from gat_tpu.data.synth import karplus_strong
from gat_tpu.ops import spectral as js
from gat_tpu.ops.mel import mel_filterbank_librosa, mel_filterbank_torchaudio
from gat_tpu.ops.pitch import midi_to_hz
from gat_tpu_torch import features as tf
from gat_tpu_torch.ops import spectral as ts

SR = 11025


def pluck_clips(noise: float, seed: int = 0) -> np.ndarray:
    """(47, 5512) plucks at MIDI 40..86, plus Gaussian noise of σ
    `noise`."""
    clips = np.stack([karplus_strong(float(midi_to_hz(40 + i)), SR, 0.5,
                                     seed=i)[0] for i in range(47)])
    rng = np.random.default_rng(seed)
    return (clips + rng.normal(0.0, noise, clips.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def plucks():
    return pluck_clips(0.0)


@pytest.fixture(scope="module")
def noisy():
    return pluck_clips(0.1)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("to_db", [True, False])
def test_melspec_plucks(plucks, normalize, to_db):
    ref = np.asarray(jf.melspec_features(plucks, SR,
                                         normalize_audio_volume=normalize,
                                         to_db=to_db))
    got = tf.melspec_features(torch.from_numpy(plucks), SR,
                              normalize_audio_volume=normalize,
                              to_db=to_db).numpy()
    assert got.shape == ref.shape == (47, 64, 22, 1)
    assert np.isfinite(got).all()
    if to_db:
        mask = ref > -60.0
        assert mask.mean() > 0.5
        np.testing.assert_allclose(got[mask], ref[mask], atol=0.1, rtol=0)
        assert got.min() >= -100.0
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-4,
                                   atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("normalize", [True, False])
def test_melspec_noise_tight(noisy, normalize):
    ref = np.asarray(jf.melspec_features(noisy, SR,
                                         normalize_audio_volume=normalize))
    got = tf.melspec_features(torch.from_numpy(noisy), SR,
                              normalize_audio_volume=normalize).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)


@pytest.mark.parametrize("noise", [0.0, 0.1])
@pytest.mark.parametrize("normalize", [True, False])
def test_mfcc_mean(noise, normalize):
    clips = pluck_clips(noise)
    ref = np.asarray(jf.mfcc_feature_vectors(
        clips, SR, normalize_audio_volume=normalize,
        add_pitch_features=False))
    got = tf.mfcc_feature_vectors(torch.from_numpy(clips), SR,
                                  normalize_audio_volume=normalize,
                                  add_pitch_features=False).numpy()
    assert got.shape == (47, 64)
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)


def test_mfcc_feature_vector_with_pitch(noisy):
    ref = np.asarray(jf.mfcc_feature_vectors(noisy, SR))
    got = tf.mfcc_feature_vectors(torch.from_numpy(noisy), SR).numpy()
    assert got.shape == (47, 65)
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)


def test_pitch_on_normalized_matches(noisy):
    ref = np.asarray(jf.mfcc_feature_vectors(noisy, SR,
                                             pitch_on_normalized=True))
    got = tf.mfcc_feature_vectors(torch.from_numpy(noisy), SR,
                                  pitch_on_normalized=True).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)


def test_raw_pitch_reused_for_feature(noisy):
    """A given raw pitch becomes the 65th feature as log10(hz)."""
    hz = torch.full((47,), 440.0)
    got = tf.mfcc_feature_vectors(torch.from_numpy(noisy), SR,
                                  raw_pitch_hz=hz)
    np.testing.assert_allclose(got[:, 64].numpy(), np.log10(440.0),
                               rtol=1e-6)


def test_normalize_volume(noisy):
    ref = np.asarray(jf.normalize_volume(noisy))
    got = tf.normalize_volume(torch.from_numpy(noisy)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["constant", "reflect"])
def test_pad_center(mode):
    y = np.random.default_rng(0).normal(size=(2, 3, 50)).astype(np.float32)
    ref = np.asarray(js._pad_center(jnp.asarray(y), 20, mode))
    got = ts._pad_center(torch.from_numpy(y), 20, mode).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("frame_length,hop", [(2048, 512), (2048, 256),
                                              (64, 24)])
def test_frame_and_n_frames(frame_length, hop):
    y = np.random.default_rng(1).normal(size=(2, 5000)).astype(np.float32)
    ref = np.asarray(js.frame(jnp.asarray(y), frame_length, hop))
    got = ts.frame(torch.from_numpy(y), frame_length, hop).numpy()
    np.testing.assert_array_equal(got, ref)
    for center in (True, False):
        assert (ts.n_frames(5000, frame_length, hop, center)
                == js.n_frames(5000, frame_length, hop, center))


def test_hann_and_dct_tables_equal():
    np.testing.assert_array_equal(ts.hann_window(2048).numpy(),
                                  np.asarray(js.hann_window(2048)))
    np.testing.assert_array_equal(ts.dct_ii_matrix(128, 64).numpy(),
                                  np.asarray(js.dct_ii_matrix(128, 64)))


@pytest.mark.parametrize("pad_mode", ["constant", "reflect"])
@pytest.mark.parametrize("power", [1.0, 2.0])
def test_power_spectrogram(noisy, pad_mode, power):
    ref = np.asarray(js.power_spectrogram(noisy[:4], 2048, 512,
                                          pad_mode=pad_mode, power=power,
                                          n_freqs=1024))
    got = ts.power_spectrogram(torch.from_numpy(noisy[:4]), 2048, 512,
                               pad_mode=pad_mode, power=power,
                               n_freqs=1024).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max())


def test_db_conversions():
    S = np.abs(np.random.default_rng(2).normal(size=(3, 11, 128))
               ).astype(np.float32) ** 4
    S[0, 0, :5] = 0.0
    for top_db in (80.0, None):
        ref = np.asarray(js.power_to_db_librosa(S, top_db=top_db))
        got = ts.power_to_db_librosa(torch.from_numpy(S),
                                     top_db=top_db).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-4)
    for stype in ("power", "magnitude"):
        ref = np.asarray(js.amplitude_to_db_torchaudio(S, stype=stype))
        got = ts.amplitude_to_db_torchaudio(torch.from_numpy(S),
                                            stype=stype).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-4)


def test_nyquist_bin_trim():
    """Both filterbanks carry zero weight at the Nyquist bin at 11025 Hz,
    so the spectra keep 1024 of 1025 bins."""
    for fb in (mel_filterbank_librosa(SR, 2048, 128),
               mel_filterbank_torchaudio(SR, 2048, 64)):
        assert fb[:, 1024].max() == 0.0
        assert ts._last_nonzero_bin(fb) == js._last_nonzero_bin(fb) == 1023


def test_power_one_melspec_uses_magnitude_db(noisy):
    ref = np.asarray(js.melspectrogram_torchaudio(noisy[:3], SR, power=1.0))
    got = ts.melspectrogram_torchaudio(torch.from_numpy(noisy[:3]), SR,
                                       power=1.0).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-3)


def test_kernel_tables_cover_every_weight():
    """The kernels' per-band bin ranges [lo, hi) hold every nonzero
    weight of both filterbanks, and the twiddle table holds the two
    Stockham pass tables of `csrc/fft_stockham.cuh`, in that order."""
    for n_mels, htk, fb in ((64, True, mel_filterbank_torchaudio(SR, 2048,
                                                                 64)),
                            (128, False, mel_filterbank_librosa(SR, 2048,
                                                                128))):
        _, tw, fbt, lo, hi = tf._kernel_tables(SR, n_mels, htk,
                                               torch.device("cpu"))
        np.testing.assert_array_equal(fbt.numpy(), fb)
        for m in range(n_mels):
            nz = np.nonzero(fb[m])[0]
            assert lo[m] == nz.min() and hi[m] == nz.max() + 1
        t = tw.numpy()
        assert t.shape == (2 * 256 + 2 * 2048,)
        rm = np.outer(np.arange(16), np.arange(16)).ravel()
        np.testing.assert_allclose(t[:256] + 1j * t[256:512],
                                   np.exp(-2j * np.pi * rm / 256), atol=1e-7)
        rb = np.outer(np.arange(8), np.arange(256)).ravel()
        np.testing.assert_allclose(t[512:2560] + 1j * t[2560:],
                                   np.exp(-2j * np.pi * rb / 2048), atol=1e-7)
