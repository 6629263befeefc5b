"""Mel scales and triangular filterbanks, both conventions of the model.

* MFCC path: librosa's Slaney scale with 'slaney' area normalization
  (by default; `fmin`, `fmax`, `htk` and `norm` as librosa takes them).
* CNN path: torchaudio's HTK scale, no normalization, with the frequency
  grid spanned by `linspace(0, sr // 2, n_freqs)` (integer Nyquist) and
  the bands over [fmin, fmax].

Filterbanks are built in float64 on the host and cast to float32.
"""
from __future__ import annotations

import functools

import numpy as np

__all__ = ["hz_to_mel", "mel_to_hz", "mel_frequencies",
           "mel_filterbank_librosa", "mel_filterbank_torchaudio"]


def hz_to_mel(f, htk: bool = False):
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # Slaney: linear below 1 kHz, log above
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-30) / min_log_hz)
                    / logstep,
                    mels)


def mel_to_hz(m, htk: bool = False):
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_sp = 200.0 / 3
    freqs = m * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    freqs)


def mel_frequencies(n_mels: int, fmin: float, fmax: float, htk: bool = False):
    mels = np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels)
    return mel_to_hz(mels, htk)


def _triangles(fft_freqs: np.ndarray, band_freqs: np.ndarray) -> np.ndarray:
    """Triangular weights (n_mels, n_freqs) from the band edges
    (n_mels + 2,)."""
    fdiff = np.diff(band_freqs)
    ramps = band_freqs[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    return np.maximum(0.0, np.minimum(lower, upper))


@functools.lru_cache(maxsize=32)
def mel_filterbank_librosa(sr: int, n_fft: int, n_mels: int = 128,
                           fmin: float = 0.0, fmax: float | None = None,
                           htk: bool = False, norm: str | None = "slaney"
                           ) -> np.ndarray:
    """librosa.filters.mel semantics: the Slaney scale (HTK with `htk`)
    over [fmin, fmax] (None: sr / 2) and the Slaney area norm (none with
    `norm=None`). (n_mels, 1 + n_fft // 2) float32."""
    if fmax is None:
        fmax = sr / 2.0
    fft_freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    band = mel_frequencies(n_mels + 2, fmin, fmax, htk)
    weights = _triangles(fft_freqs, band)
    if norm == "slaney":
        weights *= (2.0 / (band[2:n_mels + 2] - band[:n_mels]))[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=32)
def mel_filterbank_torchaudio(sr: int, n_fft: int, n_mels: int = 128,
                              fmin: float = 0.0, fmax: float | None = None
                              ) -> np.ndarray:
    """torchaudio.functional.melscale_fbanks as MelSpectrogram uses it:
    HTK, no norm, the frequency grid spanned by `sr // 2`, bands over
    [fmin, fmax] (None: `sr // 2`). (n_mels, 1 + n_fft // 2) float32."""
    if fmax is None:
        fmax = float(sr // 2)
    fft_freqs = np.linspace(0.0, float(sr // 2), 1 + n_fft // 2)
    band = mel_frequencies(n_mels + 2, fmin, fmax, htk=True)
    return _triangles(fft_freqs, band).astype(np.float32)
