"""Batched YIN fundamental-frequency estimation (librosa.yin's algorithm).

Plain PyTorch twins of `gat_tpu/ops/yin.py` (its FFT route):

  1. frames (center, constant pad) → (..., n_frames, frame_length);
  2. d(τ) = Σ_{i=1..W} (x[i] − x[i+τ])² from an FFT autocorrelation and
     cumulative energies;
  3. the cumulative-mean-normalized difference (CMND);
  4. the first trough below `trough_threshold`, else the global minimum,
     refined by a parabolic shift.

`yin_pitch` is the wrapper of the CUDA kernel `csrc/yin_pitch.cu` (K3): it
launches the kernel for a CUDA tensor and runs `yin_pitch_plain` for a CPU
tensor.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .. import kernels
from .pitch import midi_to_note
from .spectral import TINY32, _pad_center, frame, n_frames

__all__ = ["yin", "yin_pitch", "yin_pitch_plain", "yin_periods",
           "estimate_note"]

_TROUGH_THRESHOLD = 0.1  # librosa.yin's default


def yin_periods(sr: int, fmin: float, fmax: float, frame_length: int,
                win_length: int) -> tuple[int, int]:
    """(min_period, max_period) in samples: 11 and 221 at 11025 Hz."""
    min_period = max(int(math.floor(sr / fmax)), 1)
    max_period = min(int(math.ceil(sr / fmin)),
                     frame_length - win_length - 1)
    return min_period, max_period


def _autocorr_lags(frames: torch.Tensor, frame_length: int, win_length: int,
                   n_lags: int) -> torch.Tensor:
    """acf(τ) = Σ_{i=1..W} x[i] x[i+τ], τ < n_lags, as
    irfft(rfft(x)·rfft(x[W..1]))[W : W + n_lags]."""
    rev = torch.flip(frames[..., 1:win_length + 1], dims=(-1,))
    a = torch.fft.rfft(frames, frame_length, dim=-1)
    b = torch.fft.rfft(rev, frame_length, dim=-1)
    full = torch.fft.irfft(a * b, frame_length, dim=-1)
    return full[..., win_length:win_length + n_lags]


def _cmnd(frames: torch.Tensor, frame_length: int, win_length: int,
          min_period: int, max_period: int) -> torch.Tensor:
    """Cumulative-mean-normalized difference over τ ∈ [min_p, max_p]."""
    acf = _autocorr_lags(frames, frame_length, win_length, max_period + 1)
    acf = torch.where(acf.abs() < 1e-6, 0.0, acf)
    # sliding energies e(τ) = Σ_{i=τ+1..τ+W} x[i]², τ ≤ max_period
    csum = torch.cumsum(frames ** 2, dim=-1)
    energy = (csum[..., win_length:win_length + max_period + 1]
              - csum[..., :max_period + 1])
    energy = torch.where(energy.abs() < 1e-6, 0.0, energy)
    diff = energy[..., :1] + energy - 2.0 * acf
    numerator = diff[..., min_period:max_period + 1]
    tau = torch.arange(1, max_period + 1, dtype=diff.dtype,
                       device=diff.device)
    cum_mean = torch.cumsum(diff[..., 1:max_period + 1], dim=-1) / tau
    denominator = cum_mean[..., min_period - 1:max_period]
    return numerator / (denominator + TINY32)


def _parabolic_shifts(x: torch.Tensor) -> torch.Tensor:
    """Vertex offset of the parabola through each point and its
    neighbours; 0 at the edges and where |shift| > 1."""
    a = (x[..., :-2] + x[..., 2:] - 2.0 * x[..., 1:-1]) / 2.0
    b = (x[..., 2:] - x[..., :-2]) / 2.0
    inner = -b / (2.0 * a + TINY32)
    inner = torch.where(inner.abs() > 1.0, 0.0, inner)
    zeros = torch.zeros_like(x[..., :1])
    return torch.cat([zeros, inner, zeros], dim=-1)


def _f0_from_cmnd(cmnd: torch.Tensor, min_period: int,
                  trough_threshold: float, sr: int) -> torch.Tensor:
    """Frame f0 in Hz from the CMND (..., n_periods)."""
    shifts = _parabolic_shifts(cmnd)
    # troughs: left-strict, right-non-strict with edge replication, and
    # position 0 a trough iff c0 < c1
    left = torch.cat([cmnd[..., :1], cmnd[..., :-1]], dim=-1)
    right = torch.cat([cmnd[..., 1:], cmnd[..., -1:]], dim=-1)
    is_trough = (cmnd < left) & (cmnd <= right)
    first = (cmnd[..., 0] < cmnd[..., 1])[..., None]
    is_trough = torch.cat([first, is_trough[..., 1:]], dim=-1)
    below = is_trough & (cmnd < trough_threshold)
    # argmax/argmin return the first extremum, as jnp's do
    first_trough = torch.argmax(below.to(torch.uint8), dim=-1)
    idx = torch.where(below.any(dim=-1), first_trough,
                      torch.argmin(cmnd, dim=-1))
    shift = torch.take_along_dim(shifts, idx[..., None], dim=-1)[..., 0]
    period = min_period + idx.to(torch.float32) + shift
    return sr / period


def _median(x: torch.Tensor) -> torch.Tensor:
    """jnp.median over the last axis: the mean of the two middle values
    when the count is even (torch.median returns the lower one)."""
    s = torch.sort(x, dim=-1).values
    h = x.shape[-1] // 2
    if x.shape[-1] % 2:
        return s[..., h]
    return (s[..., h - 1] + s[..., h]) * 0.5


def yin(y: torch.Tensor, fmin: float = 50.0, fmax: float = 1000.0,
        sr: int = 22050, frame_length: int = 2048) -> torch.Tensor:
    """Frame-wise f0 in Hz: (..., n) → (..., n_frames), librosa.yin
    defaults (window frame_length/2, hop frame_length/4, constant center
    pad, trough threshold 0.1). Plain PyTorch."""
    win, hop = frame_length // 2, frame_length // 4
    y = _pad_center(y, frame_length // 2, "constant")
    min_p, max_p = yin_periods(sr, fmin, fmax, frame_length, win)
    frames = frame(y, frame_length, hop).to(torch.float32)
    cmnd = _cmnd(frames, frame_length, win, min_p, max_p)
    return _f0_from_cmnd(cmnd, min_p, _TROUGH_THRESHOLD, sr)


def yin_pitch_plain(clips: torch.Tensor, sr: int, fmin: float = 50.0,
                    fmax: float = 1000.0, frame_length: int = 2048
                    ) -> torch.Tensor:
    """Per-clip pitch: the median of the frame f0. (..., n) → (...,) Hz."""
    return _median(yin(clips, fmin=fmin, fmax=fmax, sr=sr,
                       frame_length=frame_length))


_YIN_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_void_p]


def yin_pitch(clips: torch.Tensor, sr: int, fmin: float = 50.0,
              fmax: float = 1000.0, frame_length: int = 2048
              ) -> torch.Tensor:
    """Per-clip YIN pitch (N, L) → (N,) Hz.

    CUDA tensor: the kernel `csrc/yin_pitch.cu` (K3), which replaces the
    JAX package's XLA YIN (`gat_tpu/ops/yin.py::yin_pitch`). It is bound
    by operations: the direct time-domain ACF is n_frames·(max_p+1)·W
    multiply-adds per clip (2.5 M at 11025 Hz) against 22 KB read. It
    keeps each padded clip in shared memory and tiles the ACF in
    registers: a thread sums 7 lags of one frame over one of 8 segments
    of the window, with the 7 window samples in registers (2 loads per 7
    multiply-adds); the sliding energies are a running fp64 sum of the
    entering minus the leaving square, O(W + max_p) per frame.
    CPU tensor: `yin_pitch_plain`."""
    if clips.device.type == "cpu":
        return yin_pitch_plain(clips, sr, fmin=fmin, fmax=fmax,
                               frame_length=frame_length)
    if clips.device.type != "cuda":
        raise ValueError(f"[yin_pitch] unsupported device {clips.device}")
    kernels.check_input(clips, "yin_pitch")
    win, hop = frame_length // 2, frame_length // 4
    min_p, max_p = yin_periods(sr, fmin, fmax, frame_length, win)
    n, length = clips.shape
    n_fr = n_frames(length, frame_length, hop)
    if max_p - min_p < 1:
        raise ValueError(f"[yin_pitch] period range [{min_p}, {max_p}] "
                         "needs at least two periods")
    out = torch.empty(n, dtype=torch.float32, device=clips.device)
    if n == 0:
        return out
    fn = kernels.function("yin_pitch", "gat_yin_pitch", _YIN_ARGS)
    with kernels.device_guard(clips.device):
        stream = kernels.stream(clips.device)
        status = fn(clips.data_ptr(), out.data_ptr(), n, length,
                    frame_length, win, hop, n_fr, min_p, max_p,
                    _TROUGH_THRESHOLD, float(sr), stream)
    kernels.check(status, "yin_pitch")
    yin_pitch.launches += 1
    return out


yin_pitch.launches = 0


def estimate_note(pitch_hz: float, unicode: bool = True):
    """Hz → (midi, note name, fractional midi) on the host; (None, None,
    None) for a non-finite or non-positive pitch."""
    if pitch_hz is None or not np.isfinite(pitch_hz) or pitch_hz <= 0:
        return None, None, None
    midi_float = 12.0 * (np.log2(pitch_hz) - np.log2(440.0)) + 69.0
    midi = int(np.round(midi_float))
    return midi, midi_to_note(midi, unicode=unicode), float(midi_float)
