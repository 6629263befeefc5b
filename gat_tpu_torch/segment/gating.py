"""Noise gating of the file path, the twin of `gat_tpu/segment/gating.py`
with the batch written out: signals are (B, n) with an optional (B,)
count of valid samples, `n_valid`, for zero-padded batch slots; as in the
reference, one signal (n,) with a count, and the reference's keyword
`n_valid_samples`, are taken too.

* `sample_db_gate` zeroes samples whose 20·log10|y| is below min_db;
* `rms_gate` computes the frame RMS in dB, median-smooths it over 5
  frames, and zeroes the frames below the file's 20th-percentile level
  plus 6 dB, expanded to samples by repetition, and every sample past
  `n_valid`;
* `gate_waveform` applies both in turn.

`rms_gate` and `gate_waveform` launch the hand-written CUDA kernel
`csrc/noise_gate.cu` (K7, `noise_gate`) for a CUDA tensor and run their
plain PyTorch twins, `rms_gate_plain` and `gate_waveform_plain`, for a
CPU tensor. The plain twins are unfold and sum, a sort of 5 for the
median and one sort per file for the percentiles; `gate_parts_plain`
gives their intermediate values, as K7 leaves them in its workspaces.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import kernels
from ..ops.filters import masked_percentile, median_filter1d, rms_frames
from ..ops.onset import _frame_counts
from ..utils.signals import as_count_rows, as_rows, either

__all__ = ["sample_db_gate", "rms_db_envelope", "dynamic_thresholds",
           "rms_gate", "rms_gate_plain", "slice_rms_db", "gate_waveform",
           "gate_waveform_plain", "gate_parts_plain", "noise_gate",
           "GATE_STAGED_FRAMES"]

_EPS = 1e-10
# the longest row K7 takes (its C entry point's int32 sample positions)
_MAX_GATE_SAMPLES = 2 ** 31 - 1 - 2 * 2048
# K7's threshold pass stages a file's envelope and median in shared memory
# up to this many frames (`kThresholdFrames` in csrc/noise_gate.cu, 192
# KB: 570 s at hop 512 and 22050 Hz); longer files keep them in device
# memory
GATE_STAGED_FRAMES = 24576


def sample_db_gate(y: torch.Tensor, min_db: float = -45.0) -> torch.Tensor:
    """Zero the samples below an absolute dB-FS amplitude."""
    amp_db = 20.0 * torch.log10(torch.abs(y) + _EPS)
    return y * (amp_db > min_db).to(y.dtype)


def _shift_gather(x: torch.Tensor, start: torch.Tensor, size: int
                  ) -> torch.Tensor:
    """x[b, start[b] : start[b] + size] for every row b."""
    idx = start[:, None] + torch.arange(size, device=x.device)[None, :]
    return torch.gather(x, 1, idx)


def rms_db_envelope(y: torch.Tensor, frame_length: int = 2048,
                    hop_length: int = 512, smooth: bool = True,
                    n_valid_samples: torch.Tensor | None = None,
                    n_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Median-smoothed frame RMS in dB, (B, n) → (B, 1 + n // hop), or
    (n,) → (1 + n // hop,). `n_valid_samples` is `n_valid`.

    With `n_valid`, a zero-padded row gives the same values on its valid
    frames as its exact-length signal alone: (a) the frame RMS reflects
    at the signal's end, so the true signal's mirror is written into
    [nv, nv + frame/2) before framing; (b) the median reflects at the
    envelope's end, so frames nvf and nvf + 1 take the envelope's last two
    valid values. Both mirrors are read from zero-left-padded copies, so a
    valid region shorter than the frame reads zeros instead of a clamped
    slice of unrelated audio."""
    n_valid = either("rms_db_envelope", "n_valid_samples", n_valid_samples,
                     "n_valid", n_valid)
    y, one = as_rows(y)
    if one:
        return rms_db_envelope(y, frame_length, hop_length, smooth,
                               n_valid=as_count_rows(n_valid, True,
                                                     y.device))[0]
    if n_valid is None:
        rms_db = 20.0 * torch.log10(
            rms_frames(y, frame_length, hop_length, pad_mode="reflect") + _EPS)
        return median_filter1d(rms_db, 5) if smooth else rms_db
    half = frame_length // 2
    b, n = y.shape
    nv = n_valid.to(device=y.device, dtype=torch.int64)
    y = y * (torch.arange(n, device=y.device)[None, :] < nv[:, None])
    # (a) ye[nv + j] = y[nv - 2 - j], y[< 0] = 0 (numpy 'reflect')
    yz = torch.cat([y.new_zeros(b, half), y], dim=1)
    seg = _shift_gather(yz, torch.clamp(nv - 1, 0, n), half)
    ye = torch.cat([y, y.new_zeros(b, half)], dim=1)
    ye = ye.scatter(1, nv[:, None] + torch.arange(half, device=y.device),
                    torch.flip(seg, dims=(1,)))
    t_out = 1 + n // hop_length
    rms = rms_frames(ye, frame_length, hop_length,
                     pad_mode="reflect")[:, :t_out]
    rms_db = 20.0 * torch.log10(rms + _EPS)
    if not smooth:
        return rms_db
    # (b) positions nvf, nvf + 1 take env[nvf - 1], env[nvf - 2]
    nvf = 1 + nv // hop_length
    ez = torch.cat([rms_db.new_zeros(b, 2), rms_db], dim=1)
    seg2 = _shift_gather(ez, nvf, 2)
    ee = torch.cat([rms_db, rms_db.new_zeros(b, 2)], dim=1)
    ee = ee.scatter(1, nvf[:, None] + torch.arange(2, device=y.device),
                    torch.flip(seg2, dims=(1,)))
    return median_filter1d(ee, 5)[:, :t_out]


def dynamic_thresholds(rms_db: torch.Tensor, valid: torch.Tensor,
                       noise_pct: float = 20.0, signal_pct: float = 75.0,
                       gate_offset_db: float = 6.0,
                       slice_offset_db: float = 10.0):
    """Percentile thresholds per row → (gate_db, slice_min_db,
    (noise_floor, signal_floor))."""
    noise_floor = masked_percentile(rms_db, noise_pct, valid)
    signal_floor = masked_percentile(rms_db, signal_pct, valid)
    gate_db = noise_floor + gate_offset_db
    slice_min_db = torch.maximum(noise_floor + slice_offset_db,
                                 noise_floor + 5.0)
    slice_min_db = torch.minimum(slice_min_db, signal_floor - 3.0)
    return gate_db, slice_min_db, (noise_floor, signal_floor)


def rms_gate_plain(y: torch.Tensor, hop_length: int = 512,
                   n_valid_samples: torch.Tensor | None = None,
                   n_valid: torch.Tensor | None = None) -> torch.Tensor:
    """The dynamic frame-RMS gate of each row of (B, n), or of one signal
    (n,), thresholds from the row's own valid frames. `n_valid_samples`
    is `n_valid`. Plain PyTorch."""
    n_valid = either("rms_gate", "n_valid_samples", n_valid_samples,
                     "n_valid", n_valid)
    y, one = as_rows(y)
    if one:
        return rms_gate_plain(y, hop_length, n_valid=as_count_rows(
            n_valid, True, y.device))[0]
    rms_db = rms_db_envelope(y, hop_length=hop_length, n_valid=n_valid)
    t = rms_db.shape[-1]
    frames = torch.arange(t, device=y.device)[None, :]
    if n_valid is None:
        valid = torch.ones_like(rms_db, dtype=torch.bool)
    else:
        nv = n_valid.to(device=y.device, dtype=torch.int64)
        valid = frames < (1 + nv // hop_length)[:, None]
    gate_db, _, _ = dynamic_thresholds(rms_db, valid)
    frame_mask = rms_db > gate_db[:, None]
    mask = torch.repeat_interleave(frame_mask, hop_length, dim=1)
    mask = mask[:, :y.shape[-1]]
    if n_valid is not None:
        # invalid frames may read loud reconstructed mirrors: the tail
        # stays silent whatever the caller padded with
        mask = mask & (torch.arange(y.shape[-1], device=y.device)[None, :]
                       < nv[:, None])
    return y * mask.to(y.dtype)


def slice_rms_db(clips: torch.Tensor) -> torch.Tensor:
    """Whole-clip RMS in dB, (..., L) → (...)."""
    rms = torch.sqrt(torch.mean(clips * clips, dim=-1))
    return 20.0 * torch.log10(rms + _EPS)


def gate_waveform_plain(y: torch.Tensor, min_db: float,
                        hop_length: int = 512,
                        n_valid_samples: torch.Tensor | None = None,
                        n_valid: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """Both gates in sequence, as the slicer applies them, to (B, n) or
    (n,). `n_valid_samples` is `n_valid`. Plain PyTorch."""
    n_valid = either("gate_waveform", "n_valid_samples", n_valid_samples,
                     "n_valid", n_valid)
    return rms_gate_plain(sample_db_gate(y, min_db), hop_length=hop_length,
                          n_valid=n_valid)


def gate_parts_plain(y: torch.Tensor, min_db: float | None,
                     hop_length: int = 512,
                     n_valid: torch.Tensor | None = None) -> dict:
    """The plain gate of rows (B, n) with its intermediate values, those
    K7 leaves in its workspaces: `env` the frame RMS in dB and `med` the
    smoothed one (B, 1 + n // hop), `gate_db` (B,), `frame_mask` (B, T)
    and `out` the gated rows; `min_db` None leaves out the sample gate
    (`rms_gate`)."""
    ys = y if min_db is None else sample_db_gate(y, min_db)
    env = rms_db_envelope(ys, hop_length=hop_length, smooth=False,
                          n_valid=n_valid)
    med = rms_db_envelope(ys, hop_length=hop_length, n_valid=n_valid)
    frames = torch.arange(med.shape[-1], device=y.device)[None, :]
    valid = (torch.ones_like(med, dtype=torch.bool) if n_valid is None
             else frames < (1 + n_valid.to(device=y.device,
                                           dtype=torch.int64)
                            // hop_length)[:, None])
    gate_db, _, _ = dynamic_thresholds(med, valid)
    return dict(env=env, med=med, gate_db=gate_db,
                frame_mask=med > gate_db[:, None],
                out=rms_gate_plain(ys, hop_length, n_valid=n_valid))


# K7's rms pass runs this many waves of its resident blocks: a block that
# has summed its runs gives its SM to one that starts copying, which on
# an H100 beat one wave at the serving wave and at 400 s (PERF.md §6)
_GATE_WAVES = 2


@functools.lru_cache(maxsize=16)
def _gate_grid(device: torch.device) -> int:
    """K7's grid: the card's SMs times the resident blocks of its rms pass
    on one SM at hop 512, the file path's (three; fewer at hops with a
    hop block below 8, where the grid is only a count of blocks), times
    `_GATE_WAVES`, queried once per process and device."""
    blocks = ctypes.c_int(0)
    fn = kernels.function("noise_gate", "gat_noise_gate_blocks_per_sm",
                          [ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(device):
        kernels.check(fn(512, ctypes.addressof(blocks)),
                      "noise_gate occupancy")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return _GATE_WAVES * sms * max(1, blocks.value)


def check_gate(n: int, hop_length: int, counted: bool) -> None:
    """Raise where K7 refuses rows of n samples at `hop_length`: a hop
    below 1 (the C entry point refuses it too), and rows of 1024 samples
    or fewer without valid counts (`counted`), where the plain gate's
    reflect pad of 1024 has no signal to mirror."""
    if hop_length < 1:
        raise ValueError(f"[noise_gate] hop_length must be >= 1, got "
                         f"{hop_length}")
    if n > _MAX_GATE_SAMPLES:
        raise ValueError(f"[noise_gate] rows of {n} samples; the kernel "
                         f"takes at most {_MAX_GATE_SAMPLES}")
    if not counted and n <= 1024:
        raise ValueError(f"[noise_gate] rows of {n} samples without "
                         f"n_valid: the frame RMS's reflect pad of 1024 "
                         f"needs more than 1024 samples")


_GATE_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
              + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def noise_gate(y: torch.Tensor, min_db: float | None, hop_length: int = 512,
               n_valid: torch.Tensor | None = None, grid: int | None = None,
               parts: bool = False):
    """K7, `csrc/noise_gate.cu`, on CUDA rows (B, n): `gate_waveform` of
    them with `min_db`, `rms_gate` with None; `n_valid` (B,) counts, any
    value 0 … n, or None for whole rows (n > 1024, as the plain gate's
    reflect pad needs). Returns the gated rows, and with `parts` the
    dict of `gate_parts_plain` from K7's workspaces. Three launches in one
    C entry point: the frame RMS in dB over a grid sized to the card
    (`grid` blocks, default two waves of SMs x resident blocks per SM,
    each block walking runs of frames; the result does not depend on it),
    the median and thresholds one block per file (the envelope in shared
    memory up to `GATE_STAGED_FRAMES` frames), and the gated samples, a
    warp per frame. Raises on what the kernel does not take; CPU rows are
    refused (the wrappers run the plain twins there)."""
    if y.device.type != "cuda":
        raise ValueError(f"[noise_gate] kernel takes CUDA rows, got "
                         f"{y.device}")
    kernels.check_input(y, "noise_gate")
    b, n = y.shape
    check_gate(n, hop_length, n_valid is not None)
    dev = y.device
    t = 1 + n // hop_length
    out = torch.empty_like(y)
    work = torch.empty(b * (2 * t + 1), dtype=torch.float32, device=dev)
    env, med = work[:b * t].view(b, t), work[b * t:2 * b * t].view(b, t)
    gate_db = work[2 * b * t:]
    frame_mask = torch.empty((b, t), dtype=torch.bool, device=dev)
    if b > 0:
        nv = _frame_counts(n_valid, dev)
        if grid is None:
            grid = _gate_grid(dev)
        fn = kernels.function("noise_gate", "gat_noise_gate", _GATE_ARGS)
        with kernels.device_guard(dev):
            status = fn(y.data_ptr(), out.data_ptr(),
                        None if nv is None else nv.data_ptr(),
                        env.data_ptr(), med.data_ptr(),
                        frame_mask.data_ptr(), gate_db.data_ptr(), b, n,
                        hop_length, int(min_db is not None),
                        0.0 if min_db is None else min_db, grid,
                        kernels.stream(dev))
        kernels.check(status, "noise_gate")
        noise_gate.launches += 1
    if not parts:
        return out
    return out, dict(env=env, med=med, gate_db=gate_db,
                     frame_mask=frame_mask, out=out)


noise_gate.launches = 0


def rms_gate(y: torch.Tensor, hop_length: int = 512,
             n_valid_samples: torch.Tensor | None = None,
             n_valid: torch.Tensor | None = None) -> torch.Tensor:
    """The dynamic frame-RMS gate of each row of (B, n), or of one signal
    (n,), thresholds from the row's own valid frames. `n_valid_samples`
    is `n_valid`. CUDA tensor: K7 (`noise_gate`) without the sample
    gate; CPU tensor: `rms_gate_plain`."""
    n_valid = either("rms_gate", "n_valid_samples", n_valid_samples,
                     "n_valid", n_valid)
    if y.device.type == "cpu":
        return rms_gate_plain(y, hop_length, n_valid=n_valid)
    y, one = as_rows(y)
    out = noise_gate(y, None, hop_length,
                     as_count_rows(n_valid, one, y.device))
    return out[0] if one else out


def gate_waveform(y: torch.Tensor, min_db: float, hop_length: int = 512,
                  n_valid_samples: torch.Tensor | None = None,
                  n_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Both gates in sequence, as the slicer applies them, to (B, n) or
    (n,). `n_valid_samples` is `n_valid`. CUDA tensor: K7 (`noise_gate`),
    which replaces the JAX package's XLA `gat_tpu/segment/gating.py::
    gate_waveform`; CPU tensor: `gate_waveform_plain`."""
    n_valid = either("gate_waveform", "n_valid_samples", n_valid_samples,
                     "n_valid", n_valid)
    if y.device.type == "cpu":
        return gate_waveform_plain(y, min_db, hop_length, n_valid=n_valid)
    y, one = as_rows(y)
    out = noise_gate(y, min_db, hop_length,
                     as_count_rows(n_valid, one, y.device))
    return out[0] if one else out
