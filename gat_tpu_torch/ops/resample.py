"""Polyphase sample-rate conversion, the twin of `gat_tpu/ops/resample.py`.

The anti-aliasing FIR (Kaiser-windowed sinc, 24 zero crossings, β 9.58)
is designed once on the host with scipy; output j of a row of n samples
is sum_k x[i0 + k]·hp[delta][k], i0 = ceil((j·down − half) / up), delta =
i0·up − (j·down − half), over the phase table hp of `_polyphase_plan`.

On the card, `resample` and `resample_rows` launch the hand-written
kernel `csrc/resample.cu` (K9), which computes only the taps each output
needs and writes only the outputs; `resample_rows` also reads the rows it
is given and cuts or zero-pads them, `fix_length(resample(x[rows]))` in
one launch. On the CPU both take the plain versions, the reference's
routes in full float32:

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

import ctypes
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels
from ..utils.device import tf32_off

__all__ = ["resample", "resample_rows", "resample_plain",
           "resample_rows_plain", "resample_filter", "fix_length",
           "resample_blocks_per_sm", "polyphase_bank", "conv_input",
           "resample_conv"]

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


@functools.lru_cache(maxsize=64)
def polyphase_bank(up: int, down: int, zeros: int = 24,
                   beta: float = 9.58) -> tuple[np.ndarray, int]:
    """The filter as one convolution bank, the form torchaudio's resampler
    uses: (up, 1, W) float32, channel s holding hp[delta_s] at offset
    i0_s − i0_0 in a window of W = K + i0_{up−1} − i0_0 (i0_s = ceil((s·down
    − half) / up), delta_s = i0_s·up − (s·down − half)), and the left pad
    −i0_0. Output t·up + s is channel s of `F.conv1d` at stride `down`
    over the padded row, position t. The library's single call beside K9
    (`resample_conv`); K9 never uses it."""
    h = resample_filter(up, down, zeros, beta)
    half = (h.shape[0] - 1) // 2
    hp = _polyphase_plan(1, up, down, zeros, beta)[0]
    k_taps = hp.shape[1]
    u = np.arange(up, dtype=np.int64) * down - half
    i0 = -(-u // up)
    delta = i0 * up - u
    bank = np.zeros((up, 1, k_taps + int(i0[-1] - i0[0])), np.float32)
    for s in range(up):
        off = int(i0[s] - i0[0])
        bank[s, 0, off:off + k_taps] = hp[delta[s]]
    return bank, int(-i0[0])


def conv_input(x: torch.Tensor, orig_sr: int, target_sr: int,
               zeros: int = 24, beta: float = 9.58) -> torch.Tensor:
    """Rows x (N, n), n >= 1, as `polyphase_bank`'s convolution reads them:
    (N, 1, L) float32, padded left by −i0_0 and right as far as the last
    output's window reaches."""
    up, down = _ratio(orig_sr, target_sr)
    bank, lpad = polyphase_bank(up, down, zeros, beta)
    n = x.shape[-1]
    need = (-(-(-(-n * up // down)) // up) - 1) * down + bank.shape[-1]
    return F.pad(x[:, None].to(torch.float32),
                 (lpad, max(0, need - n - lpad)))


def resample_conv(x: torch.Tensor, orig_sr: int, target_sr: int,
                  zeros: int = 24, beta: float = 9.58,
                  bank: torch.Tensor | None = None) -> torch.Tensor:
    """`resample` of rows x (N, n), n >= 1, by one `F.conv1d` of
    `polyphase_bank` at stride `down` over `conv_input(x)` (TF32 off), its
    up channels then interleaved: (N, m). The library's call that K9 is
    timed against, at every rate pair; `bank` is the bank on x's device,
    uploaded by the caller to keep the upload out of a timing."""
    up, down = _ratio(orig_sr, target_sr)
    if bank is None:
        bank = torch.from_numpy(polyphase_bank(up, down, zeros, beta)[0]
                                ).to(x.device)
    m = -(-x.shape[-1] * up // down)
    with tf32_off(x.device, convolutions=True):
        z = F.conv1d(conv_input(x, orig_sr, target_sr, zeros, beta), bank,
                     stride=down)
    return z.transpose(1, 2).reshape(x.shape[0], -1)[:, :m]


def _ratio(orig_sr: int, target_sr: int) -> tuple[int, int]:
    g = math.gcd(int(orig_sr), int(target_sr))
    return int(target_sr) // g, int(orig_sr) // g


def resample_plain(y: torch.Tensor, orig_sr: int, target_sr: int,
                   zeros: int = 24, beta: float = 9.58) -> torch.Tensor:
    """`resample` by the reference's routes (the module's docstring), on
    any device: the CPU path, and K9's yardstick on the card."""
    if orig_sr == target_sr:
        return y
    up, down = _ratio(orig_sr, target_sr)
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


def resample_rows_plain(x: torch.Tensor, rows, orig_sr: int,
                        target_sr: int, out_len: int, zeros: int = 24,
                        beta: float = 9.58) -> torch.Tensor:
    """`resample_rows` as the reference composes it:
    fix_length(resample(x[rows]), out_len)."""
    x = _as_rows(x)
    if rows is not None:
        x = x[torch.as_tensor(rows, dtype=torch.int64, device=x.device)]
    return fix_length(resample_plain(x, orig_sr, target_sr, zeros, beta),
                      out_len)


_RESAMPLE_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def _k9(x: torch.Tensor, rows: torch.Tensor | None, up: int, down: int,
        zeros: int, beta: float, out_len: int) -> torch.Tensor:
    """K9 on contiguous float32 rows x (N, n), n >= 1, on the card: the
    (len(rows) or N, out_len) outputs."""
    dev = x.device
    n_src, n = x.shape
    taps = _phase_taps(up, down, zeros, beta, dev)
    half = (resample_filter(up, down, zeros, beta).shape[0] - 1) // 2
    n_rows = n_src if rows is None else rows.numel()
    out = torch.empty((n_rows, out_len), dtype=torch.float32, device=dev)
    if n_rows == 0 or out_len == 0:
        return out
    if max(n_src, n, out_len) > 0x7fffffff:
        raise ValueError(f"[resample] {n_src} rows of {n} samples to "
                         f"{out_len}: the kernel takes int32 sizes")
    fn = kernels.function("resample", "gat_resample", _RESAMPLE_ARGS)
    with kernels.device_guard(dev):
        status = fn(x.data_ptr(), None if rows is None else rows.data_ptr(),
                    taps.data_ptr(), out.data_ptr(), n_src, n, n_rows,
                    out_len, up, down, taps.shape[-1], half,
                    kernels.stream(dev))
    kernels.check(status, "resample")
    resample.launches += 1
    return out


def _as_rows(x: torch.Tensor) -> torch.Tensor:
    """x (..., n) as (N, n) rows, n = 0 included."""
    return x.reshape(math.prod(x.shape[:-1]), x.shape[-1])


def _rows_on(x: torch.Tensor) -> torch.Tensor:
    """(N, n) contiguous float32 rows of x (..., n), cast once."""
    return _as_rows(x).to(torch.float32).contiguous()


def resample(y: torch.Tensor, orig_sr: int, target_sr: int,
             zeros: int = 24, beta: float = 9.58) -> torch.Tensor:
    """Resample the last axis: (..., n) → (..., m), m = ceil(n·target /
    orig) (librosa.resample's fix=True length), in float32. The same
    tensor when the rates match.

    CUDA tensor: the kernel `csrc/resample.cu` (K9), one launch over the
    rows (stereo (2, n) is two rows); none for n = 0. CPU tensor:
    `resample_plain`. K9's launches, from this and `resample_rows`, are
    counted on `resample.launches`."""
    if orig_sr == target_sr:
        return y
    if y.device.type == "cpu":
        return resample_plain(y, orig_sr, target_sr, zeros, beta)
    if y.device.type != "cuda":
        raise ValueError(f"[resample] unsupported device {y.device}")
    up, down = _ratio(orig_sr, target_sr)
    n = y.shape[-1]
    m = -(-n * up // down)
    if n == 0:
        return torch.zeros(y.shape[:-1] + (0,), dtype=torch.float32,
                           device=y.device)
    return _k9(_rows_on(y), None, up, down, zeros, beta, m).reshape(
        y.shape[:-1] + (m,))


resample.launches = 0


def resample_rows(x: torch.Tensor, rows, orig_sr: int, target_sr: int,
                  out_len: int, zeros: int = 24,
                  beta: float = 9.58) -> torch.Tensor:
    """fix_length(resample(x[rows], orig_sr, target_sr), out_len): the rows
    `rows` (int indices into the rows of x (..., n); None for all of them,
    in order) re-rated and cut or zero-padded to `out_len` samples,
    (len(rows), out_len) float32.

    CUDA tensor: one launch of K9 that reads the rows where they lie (no
    gathered copy) and writes exactly `out_len` outputs a row; a row index
    outside the rows of x gives a row of NaN. The rates equal: the gather
    and the cut alone. CPU tensor: `resample_rows_plain`."""
    if x.device.type == "cpu":
        return resample_rows_plain(x, rows, orig_sr, target_sr, out_len,
                                   zeros, beta)
    if x.device.type != "cuda":
        raise ValueError(f"[resample_rows] unsupported device {x.device}")
    if out_len < 0:
        raise ValueError(f"[resample_rows] out_len must be >= 0, got "
                         f"{out_len}")
    if rows is not None:
        rows = torch.as_tensor(rows, device=x.device).to(
            torch.int32).reshape(-1).contiguous()
    if orig_sr == target_sr:
        x = _as_rows(x)
        return fix_length(x if rows is None else x[rows.long()], out_len)
    up, down = _ratio(orig_sr, target_sr)
    x = _rows_on(x)
    if x.shape[-1] == 0:
        n_rows = x.shape[0] if rows is None else rows.numel()
        return torch.zeros((n_rows, out_len), dtype=torch.float32,
                           device=x.device)
    return _k9(x, rows, up, down, zeros, beta, out_len)


def resample_blocks_per_sm(orig_sr: int, target_sr: int, zeros: int = 24,
                           beta: float = 9.58) -> int:
    """K9's resident blocks per SM at these rates, as the CUDA runtime
    computes it on the current device (raising its shared-memory
    attribute as a launch does)."""
    up, down = _ratio(orig_sr, target_sr)
    k_taps = -(-resample_filter(up, down, zeros, beta).shape[0] // up)
    blocks = ctypes.c_int(0)
    fn = kernels.function("resample", "gat_resample_blocks_per_sm",
                          [ctypes.c_int] * 3 + [ctypes.c_void_p])
    kernels.check(fn(up, down, k_taps, ctypes.addressof(blocks)),
                  "resample occupancy")
    return blocks.value


def fix_length(y: torch.Tensor, size: int) -> torch.Tensor:
    """Trailing zeros or a trim of the last axis to exactly `size`."""
    n = y.shape[-1]
    if n > size:
        return y[..., :size]
    if n < size:
        return F.pad(y, (0, size - n))
    return y
