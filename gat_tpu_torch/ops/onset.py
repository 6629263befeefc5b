"""Spectral-flux onset detection of the file path, the twin of
`gat_tpu/ops/onset.py` with the batch written out: envelopes are (B, T)
with an optional (B,) count of valid frames, `n_valid_frames`, for
zero-padded batch slots. `onset_strength` and `detect_onsets` also take
one signal (n,), as the reference does, and the reference's keywords
(`valid_frames`, a prefix mask of the frames; `n_valid_samples`).

Two hand-written CUDA kernels, each with its plain PyTorch version here:

* `onset_strength` (K4, `csrc/onset_envelope.cu`): the mel-dB flux
  envelope of whole files; its two passes are also entry points of their
  own, `onset_mel_db` (the pre-clamp mel dB and each file's peak, frame 0
  at any sample) and `onset_flux` (the clamped flux of given dB rows),
  which the time-sharded envelope (`parallel/timeshard.py`) runs;
* `pick_onsets` (K5, `csrc/onset_pick.cu`): normalization, librosa's peak
  pick, energy-minimum backtracking, the greedy wait and min-separation
  walk, and compaction into a fixed onset budget.

A wrapper launches its kernel for a CUDA tensor and runs the plain
version for a CPU tensor. The plain pick walks its candidates in a Python
loop on the host, so on the card it is a yardstick, not a path.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels
from ..features import _kernel_tables
from ..utils.signals import as_count_rows, as_rows, either
from .mel import mel_filterbank_librosa
from .spectral import (TINY32, _last_nonzero_bin, kernel_signal,
                       melspectrogram_librosa, n_frames, power_spectrogram,
                       power_to_db_librosa)

__all__ = ["onset_strength", "onset_strength_plain", "onset_mel_db",
           "onset_mel_db_plain", "onset_flux", "onset_flux_plain",
           "order_key", "key_value", "backtrack_indices",
           "peak_pick_mask", "greedy_walk", "pick_onsets",
           "pick_onsets_plain", "pick_onsets_from_envelope",
           "detect_onsets", "peak_pick_params", "candidate_limit"]

_N_FFT = 2048      # the FFT size compiled into K4
_TOP_DB = 80.0     # power_to_db's clamp below the file's peak
_DELTA = 0.07      # librosa onset_detect's peak-pick threshold
_THREADS = 256     # threads per block of K4 (kThreads in dsp_common.cuh)
_MEL_RUN = 8       # most mel weights a thread of K4 sums (kMelRun)
# the order-preserving int key of -inf (order_key in onset_envelope.cu),
# which K4's peak buffer starts from
_NEG_INF_KEY = int(np.float32(-np.inf).view(np.int32)) ^ 0x7FFFFFFF
_PICK_TILE = 1024  # frames K5 loads per tile (kTile in onset_pick.cu)
_PICK_HALO = 64    # frames of halo K5 keeps each side (kHalo)


def _valid_mask(n_valid_frames: torch.Tensor | None, b: int, t: int,
                device) -> torch.Tensor:
    """(B, T) prefix mask of the valid frames (all when None)."""
    frames = torch.arange(t, device=device)[None, :]
    if n_valid_frames is None:
        return frames.expand(b, t) < t
    return frames < n_valid_frames.to(device=device)[:, None]


def _frame_counts(n_valid_frames: torch.Tensor | None, device
                  ) -> torch.Tensor | None:
    """The (B,) valid counts as the file kernels take them (of frames for
    K4 and K5, of samples for K7 and K8), contiguous int32 on `device`; a
    tensor that is so already is passed as it is."""
    if n_valid_frames is None or (n_valid_frames.dtype == torch.int32
                                  and n_valid_frames.device == device
                                  and n_valid_frames.is_contiguous()):
        return n_valid_frames
    return n_valid_frames.to(device=device, dtype=torch.int32).contiguous()


# ---------------------------------------------------------------------------
# K4: onset envelope
# ---------------------------------------------------------------------------
def onset_strength_plain(y: torch.Tensor, sr: int, hop_length: int = 512,
                         n_fft: int = 2048, n_mels: int = 128, lag: int = 1,
                         n_valid_frames: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """(B, n) → (B, T) mel-spectral flux, librosa.onset.onset_strength:
    mel power → power_to_db → positive lag difference → mean over mels →
    shifted right by lag + n_fft // (2·hop) frames and cut to T. The
    top_db peak is taken over the valid frames only. Plain PyTorch."""
    S = melspectrogram_librosa(y, sr, n_fft=n_fft, hop_length=hop_length,
                               n_mels=n_mels)
    b, t = S.shape[0], S.shape[-2]
    mask = (None if n_valid_frames is None
            else _valid_mask(n_valid_frames, b, t, y.device)[..., None])
    S = power_to_db_librosa(S, top_db=_TOP_DB, spec_axes=2, peak_mask=mask)
    env = torch.clamp(S[..., lag:, :] - S[..., :-lag, :], min=0.0).mean(-1)
    return F.pad(env, (lag + n_fft // (2 * hop_length), 0))[
        ..., :t].contiguous()


@functools.lru_cache(maxsize=16)
def _mel_items(sr: int, n_mels: int, device: torch.device
               ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """K4's mel stage balanced by nonzeros: (table int32, weights float32,
    item count). The Slaney filterbank's nonzero weights, band after band,
    are cut into `_THREADS` runs of ceil(nnz / _THREADS) <= `_MEL_RUN`;
    a run's partial sums close where a band ends and where the run ends,
    and each such piece is an item, with one partial sum per frame.
    Table: each thread's first item (_THREADS + 1 entries), each band's
    first item (n_mels + 1), then per nonzero weight its bin, plus 2^16
    where its band ends."""
    fb = mel_filterbank_librosa(sr, _N_FFT, n_mels)
    nnz = int((fb != 0).sum())
    run = -(-nnz // _THREADS)
    if run > _MEL_RUN:
        raise ValueError(f"[onset_strength] {nnz} mel weights need runs of "
                         f"{run} > {_MEL_RUN}")
    codes, weights, band_first, thread_first = [], [], [], []
    n_items = 0
    for m in range(n_mels):
        band_first.append(n_items)
        (nz,) = np.nonzero(fb[m])
        lo, hi = (int(nz[0]), int(nz[-1]) + 1) if len(nz) else (0, 0)
        for k in range(lo, hi):
            e = len(codes)
            if e % run == 0:
                thread_first.append(n_items)
            last = k == hi - 1
            codes.append(k | (last << 16))
            weights.append(fb[m, k])
            n_items += last or e % run == run - 1 or e == nnz - 1
    band_first.append(n_items)
    thread_first += [n_items] * (_THREADS + 1 - len(thread_first))
    tab = np.asarray(thread_first + band_first + codes, np.int32)
    return (torch.from_numpy(tab).to(device),
            torch.from_numpy(np.asarray(weights, np.float32)).to(device),
            n_items)


@functools.lru_cache(maxsize=16)
def _envelope_grid(device: torch.device, n_items: int, hop: int) -> int:
    """K4's first-pass grid that fills the card once: its SMs times the
    blocks of the pass resident on one SM. The occupancy query also raises
    the pass's shared-memory attribute to this hop's bytes and never
    lowers it, so every launch calls this first: the query runs once per
    process, device, item count and hop, before the first launch there,
    and a cached hop finds the attribute at least its bytes whatever
    hops were queried since."""
    blocks = ctypes.c_int(0)
    fn = kernels.function("onset_envelope", "gat_onset_envelope_blocks_per_sm",
                          [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(device):
        kernels.check(fn(n_items, hop, ctypes.addressof(blocks)),
                      "onset_envelope occupancy")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * max(1, blocks.value)


_ENVELOPE_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 2
                  + [ctypes.c_void_p] + [ctypes.c_int] * 7
                  + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def onset_strength(y: torch.Tensor, sr: int, hop_length: int = 512,
                   n_fft: int = 2048, n_mels: int = 128, lag: int = 1,
                   valid_frames: torch.Tensor | None = None,
                   n_valid_frames: torch.Tensor | None = None,
                   grid: int | None = None) -> torch.Tensor:
    """(B, n) → (B, T = 1 + n // hop) onset envelope; one signal (n,) →
    (T,). `valid_frames`, the reference's prefix mask of the frames ((B,
    T) or (T,) bool), is taken as its count `n_valid_frames`.

    CUDA tensor: the kernel `csrc/onset_envelope.cu` (K4), which replaces
    the JAX package's XLA `gat_tpu/ops/onset.py::onset_strength`. Bound by
    the fp32 rate of its FFTs (one real 2048-point FFT and a sparse mel
    per frame). Its first pass spreads rounds of four frames of a file
    over a grid sized to the card (`grid` blocks, default the SMs times
    the resident blocks per SM; the envelope does not depend on it),
    writes the pre-clamp mel dB to a (B, T, n_mels) scratch and folds
    each file's peak over its valid frames into a (B,) buffer; a second
    pass clamps, differences and averages, so the (B, T, 1025) spectrum
    never reaches device memory. On the matmul route with bfloat16
    operands it is handed the signal rounded to bfloat16
    (`spectral.kernel_signal`; its twiddles stay float32). CPU tensor:
    `onset_strength_plain`."""
    if valid_frames is not None:
        valid_frames = valid_frames.to(y.device).sum(-1, dtype=torch.int32)
    n_valid_frames = either("onset_strength", "valid_frames", valid_frames,
                            "n_valid_frames", n_valid_frames)
    y, one = as_rows(y)
    if one:
        return onset_strength(y, sr, hop_length, n_fft, n_mels, lag,
                              n_valid_frames=as_count_rows(
                                  n_valid_frames, True, y.device),
                              grid=grid)[0]
    if y.device.type == "cpu":
        return onset_strength_plain(y, sr, hop_length, n_fft, n_mels, lag,
                                    n_valid_frames)
    if y.device.type != "cuda":
        raise ValueError(f"[onset_strength] unsupported device {y.device}")
    kernels.check_input(y, "onset_strength")
    y = kernel_signal(y)
    if n_fft != _N_FFT:
        raise ValueError(f"[onset_strength] kernel is built for n_fft "
                         f"{_N_FFT}, got {n_fft}")
    b, n = y.shape
    t = n_frames(n, n_fft, hop_length)
    if lag < 1 or lag >= t:
        raise ValueError(f"[onset_strength] lag {lag} needs 1 <= lag < "
                         f"{t} frames")
    dev = y.device
    env = torch.empty((b, t), dtype=torch.float32, device=dev)
    if b == 0:
        return env
    nvf = _frame_counts(n_valid_frames, dev)
    hann, tw, *_ = _kernel_tables(sr, n_mels, False, dev)
    tab, weights, n_items = _mel_items(sr, n_mels, dev)
    card_grid = _envelope_grid(dev, n_items, hop_length)
    if grid is None:
        grid = card_grid
    db = torch.empty((b, t, n_mels), dtype=torch.float32, device=dev)
    peak = torch.full((b,), _NEG_INF_KEY, dtype=torch.int32, device=dev)
    fn = kernels.function("onset_envelope", "gat_onset_envelope",
                          _ENVELOPE_ARGS)
    with kernels.device_guard(dev):
        status = fn(y.data_ptr(), env.data_ptr(), db.data_ptr(),
                    peak.data_ptr(), hann.data_ptr(), tw.data_ptr(),
                    tab.data_ptr(), weights.data_ptr(), weights.numel(),
                    n_items,
                    None if nvf is None else nvf.data_ptr(), b, n,
                    hop_length, t, n_mels, lag,
                    lag + n_fft // (2 * hop_length), _TOP_DB, grid,
                    kernels.stream(dev))
    kernels.check(status, "onset_envelope")
    onset_strength.launches += 1
    return env


onset_strength.launches = 0


def order_key(v: torch.Tensor) -> torch.Tensor:
    """float32 → int32 whose signed order is the float's (K4's
    `order_key`): a max over keys is the max over the floats."""
    i = v.to(torch.float32).contiguous().view(torch.int32)
    return torch.where(i >= 0, i, i ^ 0x7FFFFFFF)


def key_value(k: torch.Tensor) -> torch.Tensor:
    """The float32 of an `order_key` (K4's `key_value`)."""
    k = k.to(torch.int32).contiguous()
    return torch.where(k >= 0, k, k ^ 0x7FFFFFFF).view(torch.float32)


def _mel_db_frames(n: int, hop_length: int, origin: int | None,
                   frames: int | None) -> tuple[int, int]:
    """(origin, frames) of `onset_mel_db`: a centred file by default,
    1 + n // hop frames from sample -n_fft / 2; from another origin, the
    frames that fit in the row unless `frames` says."""
    if origin is None:
        origin = -(_N_FFT // 2)
    if frames is None:
        frames = (1 + n // hop_length if origin == -(_N_FFT // 2)
                  else 1 + (n - origin - _N_FFT) // hop_length)
    if frames < 1:
        raise ValueError(f"[onset_mel_db] no frame of {_N_FFT} samples "
                         f"from sample {origin} of a row of {n}")
    return origin, frames


def onset_mel_db_plain(y: torch.Tensor, sr: int, hop_length: int = 512,
                       n_mels: int = 128, origin: int | None = None,
                       frames: int | None = None,
                       n_valid_frames: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, n) → (db (B, T, n_mels), peak_key (B,) int32): the first half
    of `onset_strength_plain`. Frame t of a row covers samples origin +
    t·hop + [0, n_fft), zeros outside the row (origin -n_fft / 2 by
    default: librosa's centre pad); db is 10·log10(max(mel power,
    1e-10)) before the top_db clamp, and peak_key the `order_key` of each
    row's largest dB over its valid frames (the key of -inf without
    one). Plain PyTorch."""
    b, n = y.shape
    origin, t = _mel_db_frames(n, hop_length, origin, frames)
    left = max(0, -origin)
    span = (t - 1) * hop_length + _N_FFT
    right = max(0, origin + span - n)
    yp = F.pad(y, (left, right))[:, origin + left:origin + left + span]
    fb_np = mel_filterbank_librosa(sr, _N_FFT, n_mels)
    f_keep = _last_nonzero_bin(fb_np) + 1
    power = power_spectrogram(yp, _N_FFT, hop_length, center=False,
                              n_freqs=f_keep)
    mel = torch.einsum("btf,mf->btm", power,
                       torch.from_numpy(fb_np[:, :f_keep]).to(y.device))
    db = 10.0 * torch.log10(torch.clamp(mel, min=1e-10))
    valid = _valid_mask(n_valid_frames, b, t, y.device)
    peak = torch.where(valid[..., None], db, -torch.inf).amax(dim=(1, 2))
    return db, order_key(peak)


def onset_flux_plain(db: torch.Tensor, peak_key: torch.Tensor,
                     hop_length: int = 512, lag: int = 1) -> torch.Tensor:
    """(db (B, T, n_mels), peak_key (B,)) → (B, T) envelope: the second
    half of `onset_strength_plain`. Each row's dB clamped at its peak
    minus top_db, the positive lag difference averaged over the bands,
    shifted right by lag + n_fft // (2·hop) frames and cut to T. Plain
    PyTorch."""
    floor = (key_value(peak_key) - _TOP_DB)[:, None, None]
    s = torch.maximum(db, floor)
    env = torch.clamp(s[:, lag:] - s[:, :-lag], min=0.0).mean(-1)
    return F.pad(env, (lag + _N_FFT // (2 * hop_length), 0))[
        :, :db.shape[1]].contiguous()


_MEL_DB_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 2
                + [ctypes.c_void_p] + [ctypes.c_int] * 7
                + [ctypes.c_void_p])
_FLUX_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
              + [ctypes.c_float, ctypes.c_void_p])


def onset_mel_db(y: torch.Tensor, sr: int, hop_length: int = 512,
                 n_mels: int = 128, origin: int | None = None,
                 frames: int | None = None,
                 n_valid_frames: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, n) → (db (B, T, n_mels), peak_key (B,) int32), as
    `onset_mel_db_plain` defines them.

    CUDA tensor: K4's first pass alone, the C entry point
    `gat_onset_mel_db` of `csrc/onset_envelope.cu`, with frame 0 at
    sample `origin` of each row (0 for a time shard that carries its own
    context, `parallel/timeshard.py`); it replaces the framing, DFT and
    mel of the JAX package's `gat_tpu/parallel/timeshard.py::
    _local_log_mel` and the peak of its `power_to_db_librosa`. Same grid
    and occupancy as `onset_strength`, and its bfloat16 rounding of the
    signal on the matmul route. CPU tensor: `onset_mel_db_plain`."""
    if y.device.type == "cpu":
        return onset_mel_db_plain(y, sr, hop_length, n_mels, origin, frames,
                                  n_valid_frames)
    if y.device.type != "cuda":
        raise ValueError(f"[onset_mel_db] unsupported device {y.device}")
    kernels.check_input(y, "onset_mel_db")
    y = kernel_signal(y)
    b, n = y.shape
    origin, t = _mel_db_frames(n, hop_length, origin, frames)
    dev = y.device
    db = torch.empty((b, t, n_mels), dtype=torch.float32, device=dev)
    peak = torch.full((b,), _NEG_INF_KEY, dtype=torch.int32, device=dev)
    if b == 0:
        return db, peak
    nvf = _frame_counts(n_valid_frames, dev)
    hann, tw, *_ = _kernel_tables(sr, n_mels, False, dev)
    tab, weights, n_items = _mel_items(sr, n_mels, dev)
    grid = _envelope_grid(dev, n_items, hop_length)
    fn = kernels.function("onset_envelope", "gat_onset_mel_db", _MEL_DB_ARGS)
    with kernels.device_guard(dev):
        status = fn(y.data_ptr(), db.data_ptr(), peak.data_ptr(),
                    hann.data_ptr(), tw.data_ptr(), tab.data_ptr(),
                    weights.data_ptr(), weights.numel(), n_items,
                    None if nvf is None else nvf.data_ptr(), b, n,
                    hop_length, t, n_mels, origin, grid, kernels.stream(dev))
    kernels.check(status, "onset_mel_db")
    onset_mel_db.launches += 1
    return db, peak


onset_mel_db.launches = 0


def onset_flux(db: torch.Tensor, peak_key: torch.Tensor,
               hop_length: int = 512, lag: int = 1) -> torch.Tensor:
    """(db (B, T, n_mels), peak_key (B,)) → (B, T) envelope, as
    `onset_flux_plain` defines it.

    CUDA tensor: K4's second pass alone, the C entry point
    `gat_onset_flux` of `csrc/onset_envelope.cu` (one warp per output
    frame); it replaces the clamp, lag difference and band mean of the
    JAX package's `gat_tpu/parallel/timeshard.py::
    onset_envelope_timesharded`. CPU tensor: `onset_flux_plain`."""
    if db.device.type == "cpu":
        return onset_flux_plain(db, peak_key, hop_length, lag)
    if db.device.type != "cuda":
        raise ValueError(f"[onset_flux] unsupported device {db.device}")
    if db.dtype != torch.float32 or db.ndim != 3 or not db.is_contiguous():
        raise ValueError(f"[onset_flux] kernel takes contiguous float32 dB "
                         f"rows (B, T, n_mels), got {db.dtype} "
                         f"{tuple(db.shape)}")
    b, t, n_mels = db.shape
    if lag < 1 or lag >= t:
        raise ValueError(f"[onset_flux] lag {lag} needs 1 <= lag < {t} "
                         f"frames")
    dev = db.device
    env = torch.empty((b, t), dtype=torch.float32, device=dev)
    if b == 0:
        return env
    keys = peak_key.to(device=dev, dtype=torch.int32).contiguous()
    fn = kernels.function("onset_envelope", "gat_onset_flux", _FLUX_ARGS)
    with kernels.device_guard(dev):
        status = fn(db.data_ptr(), keys.data_ptr(), env.data_ptr(), b, t,
                    n_mels, lag, lag + _N_FFT // (2 * hop_length), _TOP_DB,
                    kernels.stream(dev))
    kernels.check(status, "onset_flux")
    onset_flux.launches += 1
    return env


onset_flux.launches = 0


# ---------------------------------------------------------------------------
# K5: onset pick
# ---------------------------------------------------------------------------
def peak_pick_params(sr: int, hop_length: int) -> tuple[int, ...]:
    """librosa onset_detect's peak-pick windows in frames: (pre_max,
    post_max, pre_avg, post_avg, wait)."""
    return (int(0.03 * sr // hop_length), int(0.00 * sr // hop_length + 1),
            int(0.10 * sr // hop_length), int(0.10 * sr // hop_length + 1),
            int(0.03 * sr // hop_length))


def candidate_limit(t: int, max_onsets: int, cand_budget: int | None) -> int:
    """How many of the earliest raw candidates the greedy walk reads: all
    for cand_budget 0, else cand_budget, or max(4·max_onsets, T/4) for
    None, capped at T."""
    if cand_budget is not None and cand_budget < 0:
        raise ValueError(f"cand_budget must be >= 0 (0 = full-length scan, "
                         f"None = proportional default); got {cand_budget}")
    if cand_budget == 0:
        return t
    return min(t, cand_budget or max(4 * max_onsets, t // 4))


def _max_window(pre_max: int, post_max: int) -> tuple[int, int]:
    """(size, left) of librosa's moving max: output i is the max over
    x[i - left : i - left + size]."""
    size = int(pre_max + post_max)
    left = size // 2 + int(math.ceil(0.5 * (pre_max - post_max)))
    if left < 0 or size - 1 - left < 0:
        raise ValueError(f"[peak_pick] unsupported windows pre_max "
                         f"{pre_max}, post_max {post_max}")
    return size, left


def _peak_candidates(env: torch.Tensor, pre_max: int, post_max: int,
                     pre_avg: int, post_avg: int, delta: float,
                     valid: torch.Tensor) -> torch.Tensor:
    """(B, T) candidate mask, the data-parallel half of
    librosa.util.peak_pick: a frame equals the moving max (padded with
    the valid minimum), is at least the moving average (librosa's
    truncated window, from one prefix sum of the mean-centred envelope)
    plus delta, and is nonzero. The valid end acts as the array's end."""
    b, t = env.shape
    nvf = valid.sum(-1)
    x_min = torch.where(valid, env, torch.inf).amin(-1, keepdim=True)
    x_sub = torch.where(valid, env, x_min)
    x_sum = torch.where(valid, env, 0.0)
    size, left = _max_window(pre_max, post_max)
    x_ext = torch.cat([x_min.expand(b, left), x_sub,
                       x_min.expand(b, size - 1 - left)], dim=-1)
    mov_max = x_ext.unfold(-1, size, 1).amax(-1)
    # centred, the prefix sum stays near zero however long the file
    x_mean = x_sum.sum(-1, keepdim=True) / torch.clamp(nvf, min=1).to(
        env.dtype)[:, None]
    x_c = torch.where(valid, x_sum - x_mean, 0.0)
    csum = torch.cat([torch.zeros_like(x_c[:, :1]),
                      torch.cumsum(x_c, dim=-1)], dim=-1)
    idx = torch.arange(t, device=env.device)[None, :]
    hi = nvf[:, None]
    a = torch.minimum(torch.clamp(idx - pre_avg, min=0), hi)
    bb = torch.minimum(torch.clamp(idx + post_avg, min=0), hi)
    mov_avg = x_mean + (torch.gather(csum, 1, bb) - torch.gather(csum, 1, a)
                        ) / torch.clamp(bb - a, min=1).to(env.dtype)
    det = torch.where(env == mov_max, env, 0.0)
    return (det != 0.0) & (det >= mov_avg + delta) & valid


def peak_pick_mask(env: torch.Tensor, pre_max: int, post_max: int,
                   pre_avg: int, post_avg: int, delta: float, wait: int,
                   valid: torch.Tensor | None = None) -> torch.Tensor:
    """librosa.util.peak_pick as a boolean frame mask, (..., T) → (...,
    T): a frame is a peak iff it equals the moving max, is at least the
    moving average plus delta, and comes more than `wait` frames after
    the previous peak. `valid` (a prefix mask of the frames, None for
    all) makes the valid end act as the array's end. The greedy `wait`
    walk runs on the host; plain PyTorch."""
    t = env.shape[-1]
    env2 = env.reshape(-1, t)
    valid2 = (torch.ones_like(env2, dtype=torch.bool) if valid is None
              else valid.to(device=env.device, dtype=torch.bool)
              .expand(env.shape).reshape(-1, t))
    cand = _peak_candidates(env2, pre_max, post_max, pre_avg, post_avg,
                            delta, valid2).cpu().numpy()
    keep = np.zeros_like(cand)
    for row, c in zip(keep, cand):
        last = -(10 ** 9)
        for i in np.flatnonzero(c):
            if i > last + wait:
                row[i] = True
                last = i
    return torch.from_numpy(keep).to(env.device).reshape(env.shape)


def backtrack_indices(energy: torch.Tensor,
                      valid: torch.Tensor | None = None) -> torch.Tensor:
    """(..., T) → (..., T) int32: for each frame the nearest energy
    minimum at or before it (librosa.onset.onset_backtrack: e[i] <=
    e[i-1] and e[i] < e[i+1], frame 0 always a minimum). With `valid`, a
    prefix mask of the frames (None: all), the last valid frame cannot be
    a minimum, as the last frame of an unpadded array cannot."""
    inner = ((energy[..., 1:-1] <= energy[..., :-2])
             & (energy[..., 1:-1] < energy[..., 2:]))
    if valid is not None:
        inner = inner & valid[..., 2:]
    ones = torch.ones_like(energy[..., :1], dtype=torch.bool)
    mask = torch.cat([ones, inner, ~ones], dim=-1)
    idx = torch.arange(energy.shape[-1], device=energy.device)
    cand = torch.where(mask, idx, -1)
    return torch.cummax(cand, dim=-1).values.to(torch.int32)


def greedy_walk(cand_frames, samples, wait: int, min_samples: int):
    """The greedy `wait` spacing and min-separation over candidate frames
    in time order. Returns (kept samples in walk order, last kept frame,
    last kept sample)."""
    last_frame, last_sample = -(10 ** 9), -999999
    kept = []
    for i, s in zip(cand_frames, samples):
        if i > last_frame + wait:
            last_frame = i
            if s - last_sample >= min_samples:
                kept.append(s)
                last_sample = s
    return kept, last_frame, last_sample


def _normalized(env: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Min-max normalization over the valid frames."""
    emin = torch.where(valid, env, torch.inf).amin(-1, keepdim=True)
    emax = torch.where(valid, env, -torch.inf).amax(-1, keepdim=True)
    return (env - emin) / (emax - emin + TINY32)


def pick_onsets_plain(env: torch.Tensor, sr: int, hop_length: int,
                      min_sep: float, max_onsets: int,
                      backtrack: bool = True,
                      n_valid_frames: torch.Tensor | None = None,
                      cand_budget: int | None = None):
    """(B, T) envelopes → (onsets (B, max_onsets) int32 samples, valid
    (B, max_onsets) bool, overflow (B,) bool, cap_overflow (B,) bool,
    n_kept (B,) int32), as `gat_tpu/ops/onset.py::
    pick_onsets_from_envelope` computes them per file.

    The greedy walk reads the earliest `candidate_limit` raw candidates.
    `overflow` is set when a budget truncated the result and could have
    changed it: more kept onsets than `max_onsets` (`cap_overflow`), or
    more raw candidates than the limit with the latest of them not
    provably rejected by the walk's final state. `n_kept` counts the
    onsets the walk accepted before the cap. Plain PyTorch, with the walk
    a Python loop over host copies."""
    b, t = env.shape
    c = candidate_limit(t, max_onsets, cand_budget)
    valid = _valid_mask(n_valid_frames, b, t, env.device)
    env_n = _normalized(env, valid)
    pre_max, post_max, pre_avg, post_avg, wait = peak_pick_params(
        sr, hop_length)
    cand = _peak_candidates(env_n, pre_max, post_max, pre_avg, post_avg,
                            _DELTA, valid)
    bt = (backtrack_indices(env_n, valid) if backtrack
          else torch.arange(t, dtype=torch.int32,
                            device=env.device).expand(b, t))
    cand_h, bt_h = cand.cpu().numpy(), bt.cpu().numpy().astype(np.int64)
    min_samples = int(min_sep * sr)
    onsets = np.zeros((b, max_onsets), np.int32)
    n_kept = np.zeros(b, np.int32)
    overflow = np.zeros(b, bool)
    for f in range(b):
        frames = np.flatnonzero(cand_h[f])
        scan = frames[:c]
        kept, last_frame, last_sample = greedy_walk(
            scan.tolist(), (bt_h[f, scan] * hop_length).tolist(), wait,
            min_samples)
        n_kept[f] = len(kept)
        onsets[f, :min(len(kept), max_onsets)] = kept[:max_onsets]
        # the latest raw candidate dominates every dropped one: if it
        # fails the walk's final state, so do they all
        i_max = int(frames[-1]) if len(frames) else -1
        s_max = int(bt_h[f, max(i_max, 0)]) * hop_length
        could_differ = (i_max > last_frame + wait
                        and s_max - last_sample >= min_samples)
        overflow[f] = len(frames) > c and could_differ
    cap = n_kept > max_onsets
    valid_out = np.arange(max_onsets)[None, :] < n_kept[:, None]
    dev = env.device
    return (torch.from_numpy(onsets).to(dev),
            torch.from_numpy(valid_out).to(dev),
            torch.from_numpy(overflow | cap).to(dev),
            torch.from_numpy(cap).to(dev),
            torch.from_numpy(n_kept).to(dev))


_PICK_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
    ctypes.c_float] + [ctypes.c_int] * 6 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=16)
def _pick_windows(sr: int, hop_length: int) -> tuple[int, ...]:
    """K5's windows (size, left, pre_avg, post_avg, wait); raises when
    they reach past the halo compiled into the kernel."""
    pre_max, post_max, pre_avg, post_avg, wait = peak_pick_params(
        sr, hop_length)
    size, left = _max_window(pre_max, post_max)
    if max(left, size - 1 - left, pre_avg + 1, post_avg - 1) > _PICK_HALO:
        raise ValueError(f"[pick_onsets] the peak-pick windows at sr {sr}, "
                         f"hop {hop_length} (max {left}+{size - 1 - left}, "
                         f"avg {pre_avg}+{post_avg} frames) exceed the "
                         f"kernel's halo of {_PICK_HALO} frames")
    return size, left, pre_avg, post_avg, wait


def _pick_outputs(b: int, max_onsets: int, device) -> tuple:
    """K5's five outputs: onsets (B, M) int32, valid (B, M), overflow
    (B,) and cap (B,) bool, n_kept (B,) int32. Five allocations cost less
    host time than one carved into five views (PERF.md, K5)."""
    return (torch.empty((b, max_onsets), dtype=torch.int32, device=device),
            torch.empty((b, max_onsets), dtype=torch.bool, device=device),
            torch.empty(b, dtype=torch.bool, device=device),
            torch.empty(b, dtype=torch.bool, device=device),
            torch.empty(b, dtype=torch.int32, device=device))


def pick_onsets(env: torch.Tensor, sr: int, hop_length: int, min_sep: float,
                max_onsets: int, backtrack: bool = True,
                n_valid_frames: torch.Tensor | None = None,
                cand_budget: int | None = None):
    """(B, T) envelopes → (onsets, valid, overflow, cap_overflow, n_kept),
    as `pick_onsets_plain` defines them.

    CUDA tensor: the kernel `csrc/onset_pick.cu` (K5), which replaces the
    JAX package's XLA `gat_tpu/ops/onset.py::pick_onsets_from_envelope`
    (a `lax.scan` over the candidates). One block per file walks it in
    tiles of `_PICK_TILE` frames with a halo of `_PICK_HALO`, so any
    length fits its fixed shared memory: warp-level scans for the prefix
    sum, the backtrack cummax and the candidate ranks, then one thread
    walks the tile's compacted candidates. Bound by latency, not by the
    card's rates. `n_valid_frames` None means all T frames, and int32
    counts on the card are passed as they are. CPU tensor:
    `pick_onsets_plain`."""
    if not env.is_cuda:
        if env.device.type != "cpu":
            raise ValueError(f"[pick_onsets] unsupported device {env.device}")
        return pick_onsets_plain(env, sr, hop_length, min_sep, max_onsets,
                                 backtrack, n_valid_frames, cand_budget)
    kernels.check_input(env, "pick_onsets")
    b, t = env.shape
    if t < 2:
        raise ValueError(f"[pick_onsets] needs 2 or more frames, got {t}")
    c = candidate_limit(t, max_onsets, cand_budget)
    size, left, pre_avg, post_avg, wait = _pick_windows(sr, hop_length)
    dev = env.device
    outs = _pick_outputs(b, max_onsets, dev)
    if b == 0:
        return outs
    onsets, valid, overflow, cap, n_kept = outs
    nvf = _frame_counts(n_valid_frames, dev)
    fn = kernels.function("onset_pick", "gat_onset_pick", _PICK_ARGS)
    with kernels.device_guard(dev):
        status = fn(env.data_ptr(), None if nvf is None else nvf.data_ptr(),
                    onsets.data_ptr(), valid.data_ptr(), overflow.data_ptr(),
                    cap.data_ptr(), n_kept.data_ptr(), b, t, size, left,
                    pre_avg, post_avg, _DELTA, wait, hop_length,
                    int(min_sep * sr), max_onsets, c, int(backtrack),
                    kernels.stream(dev))
    kernels.check(status, "onset_pick")
    pick_onsets.launches += 1
    return outs


pick_onsets.launches = 0


def pick_onsets_from_envelope(env: torch.Tensor, sr: int, hop_length: int,
                              min_sep: float, max_onsets: int,
                              backtrack: bool = True,
                              valid_frames: torch.Tensor | None = None,
                              cand_budget: int | None = None):
    """The reference's signature of the onset pick: env (T,) → (onsets
    (max_onsets,) int32 samples, valid (max_onsets,) bool, overflow ()
    bool, cap_overflow () bool, n_kept () int32), as `pick_onsets`
    defines them; a batch (B, T) gives (B, ...) outputs. `valid_frames`
    is a prefix mask of the frames (None: all valid), taken as its count.
    Goes through `pick_onsets`: K5 on a CUDA tensor, `pick_onsets_plain`
    on a CPU tensor."""
    batch = env if env.ndim == 2 else env[None]
    nvf = (None if valid_frames is None
           else valid_frames.to(batch.device).expand(batch.shape)
           .sum(-1, dtype=torch.int32))
    outs = pick_onsets(batch.contiguous(), sr, hop_length, min_sep,
                       max_onsets, backtrack, nvf, cand_budget)
    return outs if env.ndim == 2 else tuple(x[0] for x in outs)


def detect_onsets(y: torch.Tensor, sr: int = 22050, hop_length: int = 512,
                  min_sep: float = 0.3, max_onsets: int = 64,
                  backtrack: bool = True,
                  n_valid_samples: torch.Tensor | None = None,
                  cand_budget: int | None = None,
                  n_valid: torch.Tensor | None = None):
    """(B, n) → (onset samples (B, max_onsets) int32, valid, overflow,
    cap_overflow, n_kept): onset_strength → pick_onsets; one signal (n,)
    gives the reference's (max_onsets,) and () outputs. `n_valid` (B,)
    (the reference's `n_valid_samples`; one signal's a count) masks each
    row's zero-padded tail: its frames are 1 + nv // hop, computed once
    as the int32 counts both kernels take."""
    n_valid = either("detect_onsets", "n_valid_samples", n_valid_samples,
                     "n_valid", n_valid)
    y, one = as_rows(y)
    if one:
        outs = detect_onsets(y, sr, hop_length, min_sep, max_onsets,
                             backtrack, cand_budget=cand_budget,
                             n_valid=as_count_rows(n_valid, True, y.device))
        return tuple(x[0] for x in outs)
    nvf = (None if n_valid is None
           else n_valid.to(device=y.device, dtype=torch.int32)
           // hop_length + 1)
    env = onset_strength(y, sr, hop_length=hop_length, n_valid_frames=nvf)
    return pick_onsets(env, sr, hop_length, min_sep, max_onsets, backtrack,
                       nvf, cand_budget)
