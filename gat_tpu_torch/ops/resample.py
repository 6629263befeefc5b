"""Polyphase sample-rate conversion, the twin of `gat_tpu/ops/resample.py`.

The anti-aliasing FIR (Kaiser-windowed sinc, 24 zero crossings, β 9.58)
is designed once on the host with scipy and applied on the tensor's
device in full float32:

* pure decimation (`up == 1`: the 22050 → 11025 clip re-rate, 44100 →
  22050) groups the outputs into super-frames of 128 and multiplies each
  against a banded filter matrix, one `torch.matmul`;
* otherwise (48000 or 16000 → 22050) one `F.conv1d` computes the `up`
  phase correlations, and output j = t·up + s is phase s at position
  pos_s + t·down, so the outputs are `up` strided slices of it.

Both run with TF32 off whatever the caller has set: a TF32 convolution
keeps about three decimal digits.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import tf32_off

__all__ = ["resample", "resample_filter", "fix_length"]

_SUPER_FRAME = 128  # outputs per super-frame of the decimation matmul


@functools.lru_cache(maxsize=64)
def resample_filter(up: int, down: int, zeros: int = 24,
                    beta: float = 9.58) -> np.ndarray:
    """Lowpass at the tighter of the two Nyquists relative to the
    up-sampled rate, gain `up` to keep the pass-band amplitude. scipy.signal
    is imported here, at the first design: its import takes seconds, which
    every process that only imports the package would pay."""
    from scipy.signal import firwin
    max_rate = max(up, down)
    half_len = zeros * max_rate
    h = firwin(2 * half_len + 1, 1.0 / max_rate, window=("kaiser", beta))
    return (h * up).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _polyphase_plan(n: int, up: int, down: int, zeros: int, beta: float):
    """Phase taps and output positions. Output j reads the up-sampled
    position u = j·down − half, i.e. the input samples i0 + k with
    i0 = ceil(u / up) against the taps h[delta + k·up], delta = i0·up − u;
    with z[p, t] = Σ_k x[t + k]·h[p + k·up], y[j] = z[delta_j, i0_j].
    Returns (hp (up, K), delta, pos, lpad, rpad, m)."""
    h = resample_filter(up, down, zeros, beta)
    half = (h.shape[0] - 1) // 2
    k_taps = -(-h.shape[0] // up)
    hp = np.zeros((up, k_taps), dtype=np.float32)
    for p in range(up):
        taps = h[p::up]
        hp[p, :len(taps)] = taps
    m = int(math.ceil(n * up / down))
    j = np.arange(m, dtype=np.int64)
    u = j * down - half
    i0 = -(-u // up)
    delta = (i0 * up - u).astype(np.int64)
    lpad = int(max(0, -i0.min()))             # so that i0 >= 0
    rpad = int(max(0, (i0.max() + k_taps) - n))  # so that every window fits
    pos = (i0 + lpad).astype(np.int32)
    return hp, delta.astype(np.int32), pos, lpad, rpad, m


@functools.lru_cache(maxsize=64)
def _decimation_band_np(up: int, down: int, zeros: int, beta: float,
                        g: int) -> np.ndarray:
    """M[i, r] = h[i − r·down] (0 elsewhere): a super-frame F[t, i] =
    x'[t·g·down + i] gives (F @ M)[t, r] = y[t·g + r]."""
    h = resample_filter(up, down, zeros, beta)
    taps = h.shape[0]
    mband = np.zeros(((g - 1) * down + taps, g), dtype=np.float32)
    for r in range(g):
        mband[r * down:r * down + taps, r] = h
    return mband


@functools.lru_cache(maxsize=64)
def _decimation_band(up: int, down: int, zeros: int, beta: float, g: int,
                     device: torch.device) -> torch.Tensor:
    """`_decimation_band_np` on `device`, uploaded once: an upload in
    every call would make each resample wait for the device's queue."""
    return torch.from_numpy(_decimation_band_np(up, down, zeros, beta,
                                                g)).to(device)


@functools.lru_cache(maxsize=64)
def _phase_taps(up: int, down: int, zeros: int, beta: float,
                device: torch.device) -> torch.Tensor:
    """The (up, 1, K) phase taps of `_polyphase_plan` on `device`,
    uploaded once (they do not depend on the signal's length)."""
    hp = _polyphase_plan(1, up, down, zeros, beta)[0]
    return torch.from_numpy(hp)[:, None, :].to(device)


def resample(y: torch.Tensor, orig_sr: int, target_sr: int,
             zeros: int = 24, beta: float = 9.58) -> torch.Tensor:
    """Resample the last axis: (..., n) → (..., m), m = ceil(n·target /
    orig) (librosa.resample's fix=True length). The same tensor when the
    rates match."""
    if orig_sr == target_sr:
        return y
    g = math.gcd(int(orig_sr), int(target_sr))
    up, down = target_sr // g, orig_sr // g
    batch_shape = y.shape[:-1]
    n = y.shape[-1]
    if n == 0:
        return torch.zeros(batch_shape + (0,), dtype=torch.float32,
                           device=y.device)
    hp, delta, pos, lpad, rpad, m = _polyphase_plan(n, up, down, zeros, beta)
    x = y.reshape(-1, n).to(torch.float32)
    dev = y.device

    if up == 1:
        sf = _SUPER_FRAME
        taps = hp.shape[1]
        flen = (sf - 1) * down + taps        # samples one super-frame reads
        n_g = -(-m // sf)                    # super-frames
        hopg = sf * down
        k_blocks = -(-flen // hopg)          # hop-long pieces per frame
        need = (n_g + k_blocks - 1) * hopg
        x2 = F.pad(x, (lpad, max(rpad, need - n - lpad)))
        frames = torch.cat(
            [x2[:, b * hopg:b * hopg + n_g * hopg].reshape(-1, n_g, hopg)
             for b in range(k_blocks)], dim=-1)[..., :flen]
        mband = _decimation_band(up, down, zeros, beta, sf, dev)
        with tf32_off(dev, convolutions=True):
            out = torch.matmul(frames, mband)
        return out.reshape(-1, n_g * sf)[:, :m].reshape(batch_shape + (m,))

    t_len = -(-m // up)          # outputs per phase
    phases = min(up, m)          # m < up: the later phases are unused
    need_z = max(int(pos[s]) for s in range(phases)) + (t_len - 1) * down + 1
    need = need_z + hp.shape[1] - 1
    x = F.pad(x[:, None, :], (lpad, max(rpad, need - n - lpad)))
    with tf32_off(dev, convolutions=True):
        z = F.conv1d(x, _phase_taps(up, down, zeros, beta, dev))
    stop = (t_len - 1) * down + 1
    out = torch.stack([z[:, int(delta[s]), int(pos[s]):int(pos[s]) + stop:down]
                       for s in range(phases)], dim=-1)
    return out.reshape(z.shape[0], t_len * phases)[:, :m].reshape(
        batch_shape + (m,))


def fix_length(y: torch.Tensor, size: int) -> torch.Tensor:
    """Trailing zeros or a trim of the last axis to exactly `size`."""
    n = y.shape[-1]
    if n > size:
        return y[..., :size]
    if n < size:
        return F.pad(y, (0, size - n))
    return y
