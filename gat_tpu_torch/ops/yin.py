"""Batched YIN fundamental-frequency estimation (librosa.yin's algorithm).

Plain PyTorch twins of `gat_tpu/ops/yin.py`:

  1. frames (center, constant pad) → (..., n_frames, frame_length);
  2. d(τ) = Σ_{i=1..W} (x[i] − x[i+τ])² from an autocorrelation and
     cumulative energies: FFTs on the "fft" route; on the "matmul" route
     real-DFT GEMMs of the frames, or, for librosa's window and hop, the
     hop-block DFT of the padded clip, which frames nothing
     (`_cmnd_block`);
  3. the cumulative-mean-normalized difference (CMND);
  4. the first trough below `trough_threshold`, else the global minimum,
     refined by a parabolic shift.

`yin_pitch` is the wrapper of the CUDA kernel `csrc/yin_pitch.cu` (K3): it
launches the kernel for a CUDA tensor and runs `yin_pitch_plain` for a CPU
tensor.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from .. import kernels
from .pitch import midi_to_note
from .spectral import (TINY32, _gemm, _pad_center, _rdft_np,
                       block_coeffs, combine_blocks, frame, kernel_signal,
                       n_frames, stft_backend)

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


def _irdft_lags_np(n_fft: int, lag_start: int, n_lags: int):
    """Restricted inverse real DFT: matrices (1 + n_fft // 2, n_lags) such
    that Re @ IC - Im @ IS == irfft(X)[lag_start : lag_start + n_lags]."""
    f = np.arange(1 + n_fft // 2)[:, None]
    n = (lag_start + np.arange(n_lags))[None, :]
    w = np.full((1 + n_fft // 2, 1), 2.0)
    w[0, 0] = 1.0
    w[-1, 0] = 1.0
    ang = 2.0 * np.pi * f * n / n_fft
    ic = (w * np.cos(ang) / n_fft).astype(np.float32)
    isin = (w * np.sin(ang) / n_fft).astype(np.float32)
    return ic, isin


@functools.lru_cache(maxsize=16)
def _lag_tables(n_fft: int, win_length: int, n_lags: int,
                device: torch.device) -> tuple[torch.Tensor, ...]:
    """(C, S, IC, IS) of the matmul route's ACF on `device`: the real-DFT
    matrices of n_fft and the restricted inverse over lags W..W+n_lags."""
    return tuple(torch.from_numpy(m).to(device)
                 for m in (*_rdft_np(n_fft),
                           *_irdft_lags_np(n_fft, win_length, n_lags)))


def _acf_from_spectra(re: torch.Tensor, im: torch.Tensor, ic: torch.Tensor,
                      isin: torch.Tensor) -> torch.Tensor:
    """Lags of the inverse real DFT of (re, im), as two GEMMs."""
    return _gemm(re, ic) - _gemm(im, isin)


def _autocorr_lags(frames: torch.Tensor, frame_length: int, win_length: int,
                   n_lags: int) -> torch.Tensor:
    """acf(τ) = Σ_{i=1..W} x[i] x[i+τ], τ < n_lags, as
    irfft(rfft(x)·rfft(x[W..1]))[W : W + n_lags]: FFTs, or on the matmul
    route float32 GEMMs against the real-DFT matrices."""
    rev = torch.flip(frames[..., 1:win_length + 1], dims=(-1,))
    if stft_backend() == "matmul":
        cj, sj, ic, isin = _lag_tables(frame_length, win_length, n_lags,
                                       frames.device)
        ra, ia = _gemm(frames, cj), _gemm(frames, sj)
        rb, ib = _gemm(rev, cj[:win_length]), _gemm(rev, sj[:win_length])
        return _acf_from_spectra(ra * rb - ia * ib, ra * ib + ia * rb, ic,
                                 isin)
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


def _cmnd_block(y_padded: torch.Tensor, frame_length: int, hop_length: int,
                n_frames: int, win_length: int, min_period: int,
                max_period: int, coeffs=None) -> torch.Tensor:
    """The CMND from the hop-block DFT of the padded signal, no frame
    materialized. Each frame x of length N needs A = rfft(x) and B, the
    rfft of the reversed window x[W..1]; both come from the same block
    coefficients: A is the full K-block combine, and

      B[k] = e^(-2πiWk/N) · conj(G[k]),
      G[k] = (first W/hop blocks combined) - x[0] + x[W]·e^(-2πiWk/N),

    where with W = N/2 the phase e^(-2πiWk/N) is (-1)^k. The sliding
    energies come from hop-block sums and per-frame cumulative sums of
    the squares (one cumulative sum over the whole signal when max_period
    exceeds the hop). Needs hop | W and W == N/2 (librosa's defaults).

    `coeffs`, the block coefficients of `y_padded` when the caller has
    them (the shared MFCC and YIN front-end), saves the block DFT; they
    must be scaled as `y_padded` is."""
    if coeffs is not None:
        cre, cim = coeffs
    else:
        cre, cim = block_coeffs(y_padded, frame_length, hop_length,
                                n_frames)
    are, aim = combine_blocks(cre, cim, frame_length, hop_length, n_frames)
    kb = win_length // hop_length
    hre, him = combine_blocks(cre, cim, frame_length, hop_length, n_frames,
                              n_blocks=kb)

    last = (n_frames - 1) * hop_length
    x0 = y_padded[..., 0:last + 1:hop_length]
    xw = y_padded[..., win_length:win_length + last + 1:hop_length]
    sign = torch.from_numpy(np.where(
        np.arange(1 + frame_length // 2) % 2 == 0, 1.0, -1.0
    ).astype(np.float32)).to(y_padded.device)
    gre = hre - x0[..., None] + xw[..., None] * sign
    bre = sign * gre
    bim = -sign * him
    _, _, ic, isin = _lag_tables(frame_length, win_length, max_period + 1,
                                 y_padded.device)
    acf = _acf_from_spectra(are * bre - aim * bim, are * bim + aim * bre,
                            ic, isin)
    acf = torch.where(acf.abs() < 1e-6, 0.0, acf)

    # sliding energies e_t(τ) = Σ_{i=τ+1..τ+W} x_t[i]², τ = 0..max_p:
    # e_t(0) from hop-block sums (the window spans W/hop blocks shifted
    # one sample: − x_t[0]² + x_t[W]²), then e_t(τ) = e_t(0) +
    # cum(x_t[W+1..W+τ]²) − cum(x_t[1..τ]²) over at most hop samples
    y2 = y_padded.to(torch.float32) ** 2
    lead = y2.shape[:-1]
    if max_period <= hop_length:
        nb = n_frames + kb - 1
        bsum = y2[..., :nb * hop_length].reshape(
            lead + (nb, hop_length)).sum(-1)
        e0 = bsum[..., 0:n_frames]
        for j in range(1, kb):
            e0 = e0 + bsum[..., j:j + n_frames]
        e0 = (e0 - y2[..., 0:last + 1:hop_length]
              + y2[..., win_length:win_length + last + 1:hop_length])
        span = n_frames * hop_length
        rows1 = y2[..., 1:1 + span].reshape(
            lead + (n_frames, hop_length))[..., :max_period]
        rows2 = y2[..., win_length + 1:win_length + 1 + span].reshape(
            lead + (n_frames, hop_length))[..., :max_period]
        delta = torch.cumsum(rows2 - rows1, dim=-1)
        energy = torch.cat([e0[..., None], e0[..., None] + delta], dim=-1)
    else:
        csum = torch.cumsum(y2, dim=-1)
        csum = torch.cat([torch.zeros(lead + (1,), dtype=torch.float32,
                                      device=y2.device), csum], dim=-1)
        g = csum[..., win_length:] - csum[..., :-win_length]
        idx = torch.from_numpy(
            np.arange(n_frames)[:, None] * hop_length
            + np.arange(max_period + 1)[None, :] + 1).to(y2.device)
        energy = g[..., idx]
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
        sr: int = 22050, frame_length: int = 2048,
        win_length: int | None = None, hop_length: int | None = None,
        trough_threshold: float = _TROUGH_THRESHOLD,
        center: bool = True) -> torch.Tensor:
    """Frame-wise f0 in Hz: (..., n) → (..., n_frames), librosa.yin
    (window default frame_length/2, hop frame_length/4, constant center
    pad). On the matmul route with librosa's window and a hop that
    divides it, the CMND comes from the block DFT (`_cmnd_block`), else
    from frames. Plain PyTorch."""
    if win_length is None:
        win_length = frame_length // 2
    if hop_length is None:
        hop_length = frame_length // 4
    if center:
        y = _pad_center(y, frame_length // 2, "constant")
    min_p, max_p = yin_periods(sr, fmin, fmax, frame_length, win_length)
    # hop < win: the block route's energy rows need win + 1 + n_frames·hop
    # samples, one hop more than the signal has when hop == win
    if (stft_backend() == "matmul" and win_length == frame_length // 2
            and win_length % hop_length == 0 and hop_length < win_length):
        n_fr = 1 + (y.shape[-1] - frame_length) // hop_length
        cmnd = _cmnd_block(y.to(torch.float32), frame_length, hop_length,
                           n_fr, win_length, min_p, max_p)
    else:
        frames = frame(y, frame_length, hop_length).to(torch.float32)
        cmnd = _cmnd(frames, frame_length, win_length, min_p, max_p)
    return _f0_from_cmnd(cmnd, min_p, trough_threshold, sr)


def yin_pitch_plain(clips: torch.Tensor, sr: int, fmin: float = 50.0,
                    fmax: float = 1000.0, frame_length: int = 2048
                    ) -> torch.Tensor:
    """Per-clip pitch: the median of the frame f0. (..., n) → (...,) Hz."""
    return _median(yin(clips, fmin=fmin, fmax=fmax, sr=sr,
                       frame_length=frame_length))


_YIN_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
_YIN_SPLIT_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def yin_pitch(clips: torch.Tensor, sr: int, fmin: float = 50.0,
              fmax: float = 1000.0, frame_length: int = 2048
              ) -> torch.Tensor:
    """Per-clip YIN pitch (N, L) → (N,) Hz.

    CUDA tensor: the kernel `csrc/yin_pitch.cu` (K3), which replaces the
    JAX package's XLA YIN (`gat_tpu/ops/yin.py::yin_pitch`). It is bound
    by operations: the function's least work, the ACF from FFTs, is 1.9 M
    flops per clip at 11025 Hz against 22 KB read, and the kernel's direct
    time-domain ACF does n_frames·(max_p+1)·W multiply-adds (2.5 M). It
    stages each padded clip in shared memory, in groups of frames where
    the whole clip does not fit, and tiles the ACF in registers: a thread
    sums 7 lags of one frame over one of 8 segments of the window, with
    the 7 window samples in registers (2 loads per 7 multiply-adds); the sliding energies are a running fp64 sum of the
    entering minus the leaving square, O(W + max_p) per frame. Clips of
    any length: where one block a clip would leave the card under-filled,
    or a clip has more frames than one block should take alone
    (`kernels.plan`), the split route cuts each clip's frames into tiles,
    one block a tile, every frame's f0 into a scratch this wrapper
    allocates, then takes each clip's median by a radix selection over
    them; the same floats as the one-block route. The
    kernel computes the same function on both routes; on the matmul route
    with bfloat16 operands it is handed the clips rounded to bfloat16
    (`spectral.kernel_signal`). CPU tensor: `yin_pitch_plain`."""
    if clips.device.type == "cpu":
        return yin_pitch_plain(clips, sr, fmin=fmin, fmax=fmax,
                               frame_length=frame_length)
    if clips.device.type != "cuda":
        raise ValueError(f"[yin_pitch] unsupported device {clips.device}")
    kernels.check_input(clips, "yin_pitch")
    clips = kernel_signal(clips)
    win, hop = frame_length // 2, frame_length // 4
    min_p, max_p = yin_periods(sr, fmin, fmax, frame_length, win)
    n, length = clips.shape
    kernels.check_samples(length, "yin_pitch")
    n_fr = n_frames(length, frame_length, hop)
    if max_p - min_p < 1:
        raise ValueError(f"[yin_pitch] period range [{min_p}, {max_p}] "
                         "needs at least two periods")
    out = torch.empty(n, dtype=torch.float32, device=clips.device)
    if n == 0:
        return out
    tile, _, _, floats = kernels.plan("yin_pitch", "gat_yin_plan",
                                      clips.device, n, win, hop, n_fr, max_p)
    sizes = (n, length, frame_length, win, hop, n_fr, min_p, max_p,
             _TROUGH_THRESHOLD, float(sr))
    with kernels.device_guard(clips.device):
        stream = kernels.stream(clips.device)
        if tile:
            f0 = torch.empty((n, floats), dtype=torch.float32,
                             device=clips.device)
            fn = kernels.function("yin_pitch", "gat_yin_split",
                                  _YIN_SPLIT_ARGS)
            status = fn(clips.data_ptr(), out.data_ptr(), f0.data_ptr(),
                        *sizes, tile, stream)
        else:
            fn = kernels.function("yin_pitch", "gat_yin_pitch", _YIN_ARGS)
            status = fn(clips.data_ptr(), out.data_ptr(), *sizes, stream)
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
