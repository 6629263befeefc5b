"""Windowed reductions of the gating path, the twins of
`gat_tpu/ops/filters.py`, batched over leading axes:

* `rms_frames`        — librosa.feature.rms (center, reflect pad);
* `median_filter1d`   — scipy.ndimage.median_filter (mode 'reflect', which
  is numpy's 'symmetric': the edge sample repeats);
* `maximum_filter1d`  — scipy.ndimage.maximum_filter1d (mode 'constant');
* `uniform_filter1d`  — scipy.ndimage.uniform_filter1d (mode 'nearest');
* `masked_percentile` — np.percentile (linear) over a masked prefix.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .spectral import _pad_center, frame

__all__ = ["rms_frames", "median_filter1d", "maximum_filter1d",
           "uniform_filter1d", "masked_percentile"]


def rms_frames(y: torch.Tensor, frame_length: int = 2048,
               hop_length: int = 512, center: bool = True,
               pad_mode: str = "reflect") -> torch.Tensor:
    """Frame-wise root-mean-square, (..., n) → (..., n_frames)."""
    if center:
        y = _pad_center(y, frame_length // 2, pad_mode)
    f = frame(y, frame_length, hop_length)
    return torch.sqrt(torch.mean(f * f, dim=-1))


def _pad_symmetric(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """numpy 'symmetric' padding of the last axis (F.pad has no such
    mode): the signal mirrored with its edge samples repeated, with
    period 2n for pads longer than the signal."""
    n = x.shape[-1]
    idx = torch.arange(-left, n + right, device=x.device) % (2 * n)
    idx = torch.where(idx >= n, 2 * n - 1 - idx, idx)
    return x[..., idx]


def _window_view(x: torch.Tensor, size: int, left: int, right: int,
                 mode: str, cval: float = 0.0) -> torch.Tensor:
    """The last axis padded by (left, right) in scipy's `mode`, as
    size-windows at every original position: (..., n) → (..., n, size)."""
    if mode == "constant":
        xp = F.pad(x, (left, right), value=cval)
    elif mode == "nearest":
        n = x.shape[-1]
        idx = torch.clamp(torch.arange(-left, n + right, device=x.device),
                          0, n - 1)
        xp = x[..., idx]
    elif mode == "reflect":
        xp = _pad_symmetric(x, left, right)
    else:
        raise ValueError(mode)
    return frame(xp, size, 1)


def median_filter1d(x: torch.Tensor, size: int = 5) -> torch.Tensor:
    """scipy.ndimage.median_filter with mode 'reflect'. An even size takes
    the upper-middle order statistic, as scipy's rank filter does
    (torch.median would take the lower one)."""
    left = size // 2
    w = frame(_pad_symmetric(x, left, size - 1 - left), size, 1)
    return torch.sort(w, dim=-1).values[..., size // 2]


def maximum_filter1d(x: torch.Tensor, size: int, origin: int = 0,
                     mode: str = "constant", cval: float = 0.0
                     ) -> torch.Tensor:
    """scipy.ndimage.maximum_filter1d: output i is the max over
    input[i - size//2 - origin : i - size//2 - origin + size]."""
    left = size // 2 + origin
    return _window_view(x, size, left, size - 1 - left, mode,
                        cval).amax(dim=-1)


def uniform_filter1d(x: torch.Tensor, size: int, origin: int = 0,
                     mode: str = "nearest") -> torch.Tensor:
    """scipy.ndimage.uniform_filter1d, the moving average over the same
    window as `maximum_filter1d`."""
    left = size // 2 + origin
    return _window_view(x, size, left, size - 1 - left, mode).mean(dim=-1)


def masked_percentile(x: torch.Tensor, q: float, mask: torch.Tensor
                      ) -> torch.Tensor:
    """np.percentile(x[mask], q) with linear interpolation, per row:
    (..., n) → (...). Masked-out entries sort to the float32 maximum and
    are never interpolated into; an empty mask gives NaN."""
    big = torch.finfo(x.dtype).max
    xs = torch.sort(torch.where(mask, x, big), dim=-1).values
    count = mask.sum(dim=-1)
    pos = (q / 100.0) * (count.to(x.dtype) - 1.0)
    n = x.shape[-1]
    lo = torch.clamp(torch.floor(pos).to(torch.int64), 0, n - 1)
    hi = torch.clamp(lo + 1, 0, n - 1)
    frac = pos - lo.to(x.dtype)
    xlo = torch.gather(xs, -1, lo[..., None])[..., 0]
    xhi = torch.gather(xs, -1, hi[..., None])[..., 0]
    xhi = torch.where(hi >= count, xlo, xhi)
    out = xlo + frac * (xhi - xlo)
    return torch.where(count > 0, out, torch.full_like(out, float("nan")))
