"""Batched feature front-ends of the ensemble, the twins of
`gat_tpu/features.py`:

* MFCC path (MLP input): per-clip RMS volume normalization → librosa-
  semantics MFCC (64) → mean over frames → append log10(YIN pitch Hz).
* Mel path (CNN input): torchaudio-semantics MelSpectrogram +
  AmplitudeToDB, as an NHWC image (N, n_mels, T, 1).

Each front-end is one hand-written CUDA kernel on the card
(`csrc/melspec_frontend.cu`, `csrc/mfcc_frontend.cu`) with its plain
PyTorch version beside it here: a wrapper runs the kernel for a CUDA tensor
and the plain version for a CPU tensor. The YIN pitch feature is computed
on the raw clip unless `pitch_on_normalized` is set (YIN's CMND is
amplitude-invariant, so both agree up to rounding).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import kernels
from .ops import spectral
from .ops.mel import mel_filterbank_librosa, mel_filterbank_torchaudio
from .ops.yin import yin_pitch

__all__ = ["normalize_volume", "mfcc_feature_vectors", "melspec_features",
           "melspec_features_plain", "mfcc_frontend", "mfcc_frontend_plain"]

_VOLUME_EPS = 1e-9
_KERNEL_N_FFT = 2048   # the FFT size compiled into both front-end kernels
_MFCC_HOP, _MFCC_N_MELS, _TOP_DB = 512, 128, 80.0  # spectral.mfcc defaults


def normalize_volume(y: torch.Tensor, eps: float = _VOLUME_EPS
                     ) -> torch.Tensor:
    """Per-clip RMS volume normalization."""
    rms = torch.sqrt(torch.mean(y * y, dim=-1, keepdim=True))
    return y / (rms + eps)


# ---------------------------------------------------------------------------
# Constant tables of the kernels, on the kernel's device
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=16)
def _kernel_tables(sr: int, n_mels: int, htk: bool, device: torch.device
                   ) -> tuple[torch.Tensor, ...]:
    """(hann, twiddles, filterbank, lo, hi) for a front-end kernel: the
    periodic Hann window, the twiddle table of `csrc/fft_stockham.cuh`
    (its Stockham pass tables W_256^(r·m), r, m < 16, and W_2048^(r·b),
    r < 8, b < 256, each as [re | im]), the dense (n_mels, n_fft/2 + 1)
    filterbank and each band's nonzero bin range [lo, hi). Computed in
    float64, rounded to float32."""
    n = _KERNEL_N_FFT
    fb = (mel_filterbank_torchaudio(sr, n, n_mels) if htk
          else mel_filterbank_librosa(sr, n, n_mels))
    nz = fb != 0
    any_nz = nz.any(axis=1)
    lo = np.where(any_nz, nz.argmax(axis=1), 0).astype(np.int32)
    hi = np.where(any_nz, fb.shape[1] - nz[:, ::-1].argmax(axis=1),
                  0).astype(np.int32)
    ang = [2.0 * np.pi * np.outer(np.arange(16), np.arange(16)).ravel() / 256,
           2.0 * np.pi * np.outer(np.arange(8), np.arange(256)).ravel() / n]
    tw = np.concatenate([x for a in ang for x in (np.cos(a), -np.sin(a))]
                        ).astype(np.float32)
    hann = spectral._hann_np(n)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (hann, tw, fb, lo, hi))


@functools.lru_cache(maxsize=16)
def _dct_table(n_mfcc: int, device: torch.device) -> torch.Tensor:
    """K2's (128, n_mfcc) orthonormal DCT-II matrix, on its device once."""
    return spectral.dct_ii_matrix(_MFCC_N_MELS, n_mfcc, device)


# ---------------------------------------------------------------------------
# K1: mel front-end (CNN input)
# ---------------------------------------------------------------------------
def melspec_features_plain(clips: torch.Tensor, sr: int, n_mels: int = 64,
                           n_fft: int = 2048, hop_length: int = 256,
                           normalize_audio_volume: bool = True,
                           to_db: bool = True) -> torch.Tensor:
    """(N, L) → (N, n_mels, T, 1) NHWC mel image. Plain PyTorch."""
    y = normalize_volume(clips) if normalize_audio_volume else clips
    S = spectral.melspectrogram_torchaudio(y, sr, n_fft=n_fft,
                                           hop_length=hop_length,
                                           n_mels=n_mels, to_db=to_db)
    return S.transpose(-1, -2)[..., None]


_MELSPEC_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
    ctypes.c_void_p]


def melspec_features(clips: torch.Tensor, sr: int, n_mels: int = 64,
                     n_fft: int = 2048, hop_length: int = 256,
                     normalize_audio_volume: bool = True,
                     to_db: bool = True) -> torch.Tensor:
    """(N, L) → (N, n_mels, T, 1) NHWC mel image.

    CUDA tensor: the kernel `csrc/melspec_frontend.cu` (K1), which
    replaces the TPU kernel `gat_tpu/ops/pallas/melspec_frontend.py::
    melspec_pallas` (deleted in 1951c8f; live reference
    `gat_tpu/features.py::melspec_features`). Its roofline bound is the
    fp32 rate of its FFTs (1.24 M flops per clip for real-input FFTs,
    against 28 KB moved). One block owns one clip and runs two adjacent
    frames per complex FFT (register Stockham passes, four frames in
    flight), then power, mel and dB in shared memory, so the spectrum
    never reaches device memory. CPU tensor: `melspec_features_plain`."""
    if clips.device.type == "cpu":
        return melspec_features_plain(clips, sr, n_mels, n_fft, hop_length,
                                      normalize_audio_volume, to_db)
    if clips.device.type != "cuda":
        raise ValueError(f"[melspec_features] unsupported device "
                         f"{clips.device}")
    kernels.check_input(clips, "melspec_features")
    if n_fft != _KERNEL_N_FFT:
        raise ValueError(f"[melspec_features] kernel is built for n_fft "
                         f"{_KERNEL_N_FFT}, got {n_fft}")
    if clips.shape[1] <= n_fft // 2:  # reflect padding needs pad < length
        raise ValueError(f"[melspec_features] clips must be longer than "
                         f"{n_fft // 2} samples")
    n, length = clips.shape
    n_fr = spectral.n_frames(length, n_fft, hop_length)
    out = torch.empty((n, n_mels, n_fr, 1), dtype=torch.float32,
                      device=clips.device)
    if n == 0:
        return out
    hann, tw, fb, lo, hi = _kernel_tables(sr, n_mels, True, clips.device)
    fn = kernels.function("melspec_frontend", "gat_melspec_frontend",
                          _MELSPEC_ARGS)
    with kernels.device_guard(clips.device):
        status = fn(clips.data_ptr(), out.data_ptr(), hann.data_ptr(),
                    tw.data_ptr(), fb.data_ptr(), lo.data_ptr(),
                    hi.data_ptr(), n, length, hop_length, n_fr, n_mels,
                    int(normalize_audio_volume), int(to_db),
                    kernels.stream(clips.device))
    kernels.check(status, "melspec_frontend")
    melspec_features.launches += 1
    return out


melspec_features.launches = 0


# ---------------------------------------------------------------------------
# K2: MFCC front-end (MLP input)
# ---------------------------------------------------------------------------
def mfcc_frontend_plain(clips: torch.Tensor, sr: int, n_mfcc: int = 64,
                        normalize_audio_volume: bool = True
                        ) -> torch.Tensor:
    """(N, L) → (N, n_mfcc): the MFCC averaged over frames. Plain
    PyTorch."""
    y = normalize_volume(clips) if normalize_audio_volume else clips
    return torch.mean(spectral.mfcc(y, sr, n_mfcc=n_mfcc), dim=-2)


_MFCC_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_void_p]


def mfcc_frontend(clips: torch.Tensor, sr: int, n_mfcc: int = 64,
                  normalize_audio_volume: bool = True) -> torch.Tensor:
    """(N, L) → (N, n_mfcc): the MFCC averaged over frames.

    CUDA tensor: the kernel `csrc/mfcc_frontend.cu` (K2), which replaces
    the TPU kernel `gat_tpu/ops/pallas/mfcc_frontend.py::mfcc_mean_pallas`
    (deleted in 1951c8f; live reference
    `gat_tpu/features.py::mfcc_feature_vectors`). The per-clip top_db
    clamp needs the clip's whole mel image, so one block owns one clip;
    the roofline bound is the fp32 rate of its 11 FFTs (0.62 M flops per
    clip for real-input FFTs, against 22 KB read). It runs K1's round
    loop (`csrc/mel_rounds.cuh`: two adjacent frames per complex FFT,
    register Stockham passes, four frames in flight) over a zero pad, then
    the clamp, the mean over frames and the DCT, which commutes with the
    mean. CPU tensor: `mfcc_frontend_plain`."""
    if clips.device.type == "cpu":
        return mfcc_frontend_plain(clips, sr, n_mfcc, normalize_audio_volume)
    if clips.device.type != "cuda":
        raise ValueError(f"[mfcc_frontend] unsupported device {clips.device}")
    kernels.check_input(clips, "mfcc_frontend")
    n, length = clips.shape
    n_fr = spectral.n_frames(length, _KERNEL_N_FFT, _MFCC_HOP)
    out = torch.empty((n, n_mfcc), dtype=torch.float32, device=clips.device)
    if n == 0:
        return out
    hann, tw, fb, lo, hi = _kernel_tables(sr, _MFCC_N_MELS, False,
                                          clips.device)
    dct = _dct_table(n_mfcc, clips.device)
    fn = kernels.function("mfcc_frontend", "gat_mfcc_frontend", _MFCC_ARGS)
    with kernels.device_guard(clips.device):
        status = fn(clips.data_ptr(), out.data_ptr(), hann.data_ptr(),
                    tw.data_ptr(), fb.data_ptr(), lo.data_ptr(),
                    hi.data_ptr(), dct.data_ptr(), n, length, _MFCC_HOP,
                    n_fr, _MFCC_N_MELS, n_mfcc, int(normalize_audio_volume),
                    _TOP_DB, kernels.stream(clips.device))
    kernels.check(status, "mfcc_frontend")
    mfcc_frontend.launches += 1
    return out


mfcc_frontend.launches = 0


def mfcc_feature_vectors(clips: torch.Tensor, sr: int, n_mfcc: int = 64,
                         normalize_audio_volume: bool = True,
                         add_pitch_features: bool = True,
                         pitch_on_normalized: bool = False,
                         raw_pitch_hz: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """(N, L) → (N, n_mfcc [+1]): MFCC mean with the optional log10-pitch
    feature appended. `raw_pitch_hz`, the YIN pitch of the raw clips when
    the caller already has it, is used whenever the pitch feature reads
    the raw clips, so YIN runs once for the feature and the baseline."""
    vec = mfcc_frontend(clips, sr, n_mfcc, normalize_audio_volume)
    if not add_pitch_features:
        return vec
    if pitch_on_normalized and normalize_audio_volume:
        hz = yin_pitch(normalize_volume(clips), sr)
    elif raw_pitch_hz is not None:
        hz = raw_pitch_hz
    else:
        hz = yin_pitch(clips, sr)
    return torch.cat([vec, torch.log10(hz)[..., None]], dim=-1)
