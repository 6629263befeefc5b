"""Plain PyTorch spectral ops: framing, STFT power, mel spectrograms, MFCC.

The twins of `gat_tpu/ops/spectral.py`, batched over leading axes and
time-major inside: spectrograms are (..., n_frames, n_bins). Two
conventions are kept apart on purpose:

* `melspectrogram_librosa` / `mfcc`: librosa semantics, constant center
  pad, Slaney mel with 'slaney' norm, power_to_db with ref 1.0 and a
  per-clip top_db 80 clamp.
* `melspectrogram_torchaudio`: torchaudio semantics, reflect center pad,
  HTK mel without norm, AmplitudeToDB without top_db.

These are the CPU path and the yardstick of the CUDA front-end kernels in
`features.py`; on the card the main path runs those kernels instead.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .mel import mel_filterbank_librosa, mel_filterbank_torchaudio

__all__ = ["TINY32", "hann_window", "n_frames", "frame", "stft",
           "power_spectrogram",
           "power_to_db_librosa", "amplitude_to_db_torchaudio",
           "dct_ii_matrix", "melspectrogram_librosa",
           "melspectrogram_torchaudio", "mfcc"]

# np.finfo(np.float32).tiny: librosa's denominator guard, shared with YIN
TINY32 = 1.1754944e-38


@functools.lru_cache(maxsize=16)
def _hann_np(n: int) -> np.ndarray:
    """Periodic Hann window, built in float64 and cast to float32."""
    k = np.arange(n, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * k / n)).astype(np.float32)


def hann_window(n: int, device=None) -> torch.Tensor:
    return torch.from_numpy(_hann_np(n)).to(device)


def n_frames(n_samples: int, frame_length: int, hop_length: int,
             center: bool = True) -> int:
    """Frame count of a signal of `n_samples`."""
    if center:
        n_samples += 2 * (frame_length // 2)
    return 1 + (n_samples - frame_length) // hop_length


def frame(y: torch.Tensor, frame_length: int, hop_length: int
          ) -> torch.Tensor:
    """(..., n) → (..., n_frames, frame_length), no padding (a view)."""
    return y.unfold(-1, frame_length, hop_length)


def _pad_center(y: torch.Tensor, pad: int, pad_mode: str) -> torch.Tensor:
    """Pad the last axis by `pad` on both sides; 'reflect' excludes the
    edge sample (numpy 'reflect')."""
    if pad_mode == "constant":
        return F.pad(y, (pad, pad))
    shape = y.shape
    return F.pad(y.reshape(-1, 1, shape[-1]), (pad, pad),
                 mode=pad_mode).reshape(shape[:-1] + (shape[-1] + 2 * pad,))


def stft(y: torch.Tensor, n_fft: int = 2048, hop_length: int | None = None,
         win_length: int | None = None, center: bool = True,
         pad_mode: str = "constant") -> torch.Tensor:
    """Complex STFT, time-major: (..., n_frames, 1 + n_fft // 2), complex64.
    pad_mode 'constant' is librosa.stft's default, 'reflect' torch.stft's.
    A window shorter than n_fft is zero-padded to it on both sides, as
    librosa does."""
    if win_length is None:
        win_length = n_fft
    if hop_length is None:
        hop_length = win_length // 4
    if center:
        y = _pad_center(y, n_fft // 2, pad_mode)
    win = hann_window(win_length, y.device)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        win = F.pad(win, (lpad, n_fft - win_length - lpad))
    return torch.fft.rfft(frame(y, n_fft, hop_length) * win, n=n_fft, dim=-1)


def power_spectrogram(y: torch.Tensor, n_fft: int, hop_length: int,
                      center: bool = True, pad_mode: str = "constant",
                      power: float = 2.0,
                      n_freqs: int | None = None) -> torch.Tensor:
    """|rfft(frame · hann)|^power over the first `n_freqs` bins (default
    all 1 + n_fft // 2)."""
    if n_freqs is None:
        n_freqs = 1 + n_fft // 2
    if center:
        y = _pad_center(y, n_fft // 2, pad_mode)
    frames = frame(y, n_fft, hop_length)
    z = torch.fft.rfft(frames * hann_window(n_fft, y.device), n=n_fft,
                       dim=-1)[..., :n_freqs]
    mag = z.abs()
    return mag if power == 1.0 else mag ** power


def power_to_db_librosa(S: torch.Tensor, ref: float = 1.0,
                        amin: float = 1e-10, top_db: float | None = 80.0,
                        spec_axes: int = 2,
                        peak_mask: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """librosa.power_to_db: 10·log10 with a top_db clamp below the peak
    over the trailing `spec_axes` axes (one clip's spectrogram).
    `peak_mask` (broadcastable to S, True = takes part) restricts the
    peak to those entries: the frames of a zero-padded batch slot that
    straddle its valid end must not move the clamp of the valid ones."""
    log_spec = 10.0 * torch.log10(torch.clamp(S, min=amin))
    log_spec = log_spec - 10.0 * np.log10(max(amin, ref))
    if top_db is not None:
        ls = (log_spec if peak_mask is None
              else torch.where(peak_mask, log_spec, -torch.inf))
        peak = torch.amax(ls, dim=tuple(range(-spec_axes, 0)),
                          keepdim=True)
        log_spec = torch.maximum(log_spec, peak - top_db)
    return log_spec


def amplitude_to_db_torchaudio(S: torch.Tensor, stype: str = "power",
                               amin: float = 1e-10) -> torch.Tensor:
    """torchaudio AmplitudeToDB with its default top_db=None (no clamp)."""
    mult = 10.0 if stype == "power" else 20.0
    return mult * torch.log10(torch.clamp(S, min=amin))


def _last_nonzero_bin(fb_np: np.ndarray) -> int:
    """Index of the last frequency bin with any mel weight. Both mel
    conventions end their top triangle at Nyquist, so the Nyquist bin has
    zero weight and 1024 of 1025 bins are kept at n_fft 2048."""
    nz = np.nonzero(np.abs(fb_np).sum(axis=0))[0]
    return int(nz.max()) if nz.size else fb_np.shape[1] - 1


@functools.lru_cache(maxsize=16)
def _dct_ii_np(n_in: int, n_out: int) -> np.ndarray:
    """Orthonormal DCT-II matrix (n_in, n_out): X @ D equals
    scipy.fftpack.dct(X, type=2, norm='ortho')[..., :n_out]."""
    n = np.arange(n_in, dtype=np.float64)
    k = np.arange(n_out, dtype=np.float64)
    D = 2.0 * np.cos(np.pi * k[None, :] * (2.0 * n[:, None] + 1.0)
                     / (2.0 * n_in))
    scale = np.full(n_out, np.sqrt(1.0 / (2.0 * n_in)))
    scale[0] = np.sqrt(1.0 / (4.0 * n_in))
    return (D * scale[None, :]).astype(np.float32)


def dct_ii_matrix(n_in: int, n_out: int, device=None) -> torch.Tensor:
    return torch.from_numpy(_dct_ii_np(n_in, n_out)).to(device)


def melspectrogram_librosa(y: torch.Tensor, sr: int, n_fft: int = 2048,
                           hop_length: int = 512, n_mels: int = 128,
                           power: float = 2.0) -> torch.Tensor:
    """(..., n) → (..., n_frames, n_mels), librosa.feature.melspectrogram
    defaults."""
    fb_np = mel_filterbank_librosa(sr, n_fft, n_mels)
    f_keep = _last_nonzero_bin(fb_np) + 1
    S = power_spectrogram(y, n_fft, hop_length, pad_mode="constant",
                          power=power, n_freqs=f_keep)
    fb = torch.from_numpy(fb_np[:, :f_keep]).to(y.device)
    return torch.einsum("...tf,mf->...tm", S, fb)


def melspectrogram_torchaudio(y: torch.Tensor, sr: int, n_fft: int = 2048,
                              hop_length: int = 256, n_mels: int = 64,
                              power: float = 2.0, to_db: bool = True
                              ) -> torch.Tensor:
    """(..., n) → (..., n_frames, n_mels), torchaudio MelSpectrogram
    semantics plus AmplitudeToDB (10·log10 for power spectra, 20·log10
    for magnitude spectra)."""
    fb_np = mel_filterbank_torchaudio(sr, n_fft, n_mels)
    f_keep = _last_nonzero_bin(fb_np) + 1
    S = power_spectrogram(y, n_fft, hop_length, pad_mode="reflect",
                          power=power, n_freqs=f_keep)
    fb = torch.from_numpy(fb_np[:, :f_keep]).to(y.device)
    out = torch.einsum("...tf,mf->...tm", S, fb)
    if to_db:
        out = amplitude_to_db_torchaudio(
            out, stype="power" if power == 2.0 else "magnitude")
    return out


def mfcc(y: torch.Tensor, sr: int, n_mfcc: int = 20, n_fft: int = 2048,
         hop_length: int = 512, n_mels: int = 128) -> torch.Tensor:
    """(..., n) → (..., n_frames, n_mfcc), librosa.feature.mfcc defaults:
    mel power → power_to_db (top_db 80 per clip) → ortho DCT-II."""
    S = melspectrogram_librosa(y, sr, n_fft=n_fft, hop_length=hop_length,
                               n_mels=n_mels)
    S_db = power_to_db_librosa(S, spec_axes=2)
    return torch.einsum("...tm,mk->...tk", S_db,
                        dct_ii_matrix(n_mels, n_mfcc, y.device))
