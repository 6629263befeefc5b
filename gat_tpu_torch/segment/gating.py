"""Noise gating of the file path, the twin of `gat_tpu/segment/gating.py`
with the batch written out: signals are (B, n) with an optional (B,)
count of valid samples, `n_valid`, for zero-padded batch slots; as in the
reference, one signal (n,) with a count, and the reference's keyword
`n_valid_samples`, are taken too.

* `sample_db_gate` zeroes samples whose 20·log10|y| is below min_db;
* `rms_gate` computes the frame RMS in dB, median-smooths it over 5
  frames, and zeroes the frames below the file's 20th-percentile level
  plus 6 dB, expanded to samples by repetition.

Plain PyTorch ops on the tensor's device (unfold and sum, a sort of 5 for
the median, one sort per file for the percentiles).
"""
from __future__ import annotations

import torch

from ..ops.filters import masked_percentile, median_filter1d, rms_frames
from ..utils.signals import as_count_rows, as_rows, either

__all__ = ["sample_db_gate", "rms_db_envelope", "dynamic_thresholds",
           "rms_gate", "slice_rms_db", "gate_waveform"]

_EPS = 1e-10


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


def rms_gate(y: torch.Tensor, hop_length: int = 512,
             n_valid_samples: torch.Tensor | None = None,
             n_valid: torch.Tensor | None = None) -> torch.Tensor:
    """The dynamic frame-RMS gate of each row of (B, n), or of one signal
    (n,), thresholds from the row's own valid frames. `n_valid_samples`
    is `n_valid`."""
    n_valid = either("rms_gate", "n_valid_samples", n_valid_samples,
                     "n_valid", n_valid)
    y, one = as_rows(y)
    if one:
        return rms_gate(y, hop_length, n_valid=as_count_rows(
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


def gate_waveform(y: torch.Tensor, min_db: float, hop_length: int = 512,
                  n_valid_samples: torch.Tensor | None = None,
                  n_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Both gates in sequence, as the slicer applies them, to (B, n) or
    (n,). `n_valid_samples` is `n_valid`."""
    n_valid = either("gate_waveform", "n_valid_samples", n_valid_samples,
                     "n_valid", n_valid)
    return rms_gate(sample_db_gate(y, min_db), hop_length=hop_length,
                    n_valid=n_valid)
