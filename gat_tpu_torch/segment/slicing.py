"""Onset-based note slicing with fixed budgets and masks, the twin of
`gat_tpu/segment/slicing.py` with the batch written out.

* slice window = [onset + attack_skip, min(start + clip_len, next onset)];
* the last detected onset's next onset is itself, so its slice is empty,
  hence silent and dropped: the reference's slicer always loses a file's
  last note. `strict_reference_compat=True` (the default) keeps that;
  False slices the last note to the end of the audio;
* windows outside the audio give zero clips, which are dropped;
* clips quieter than min_slice_rms_db are dropped.

Every clip of the onset budget is gathered at once as whole hop-long
rows (onsets are multiples of the onset hop), with a `kept` mask in place
of the reference's per-clip drop logic.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ..config import CLIP_DURATION, SLICER_CONFIG, TARGET_SR
from ..ops.onset import detect_onsets
from ..utils.wavio import write_wav
from . import gating

__all__ = ["slice_at_onsets", "segment_waveform", "save_clip"]

_ONSET_HOP = 512  # onset detection's own hop (the reference's default)


def slice_at_onsets(y: torch.Tensor, onsets: torch.Tensor,
                    onsets_valid: torch.Tensor, sr: int,
                    length_sec: float = CLIP_DURATION,
                    attack_skip_sec: float = SLICER_CONFIG.ATTACK_SKIP_SEC,
                    min_slice_rms_db: float = SLICER_CONFIG.MIN_SLICE_RMS_DB,
                    strict_reference_compat: bool = True,
                    n_valid: torch.Tensor | None = None,
                    onset_hop: int = _ONSET_HOP):
    """(B, n), (B, K), (B, K) → clips (B, K, L), kept (B, K), times
    (B, K, 2) in seconds. Every onset must be a multiple of `onset_hop`:
    clip k is then the rows onsets[k] / hop onwards of the skip-shifted
    waveform cut into hop-long rows."""
    b, n_total = y.shape
    k = onsets.shape[1]
    dev = y.device
    length = int(length_sec * sr)
    skip = int(attack_skip_sec * sr)
    n = (torch.full((b,), n_total, device=dev) if n_valid is None
         else n_valid.to(device=dev, dtype=torch.int64))[:, None]
    onsets = onsets.to(torch.int64)

    count = onsets_valid.sum(-1, keepdim=True)
    slot = torch.arange(k, device=dev)[None, :]
    last_onset = torch.gather(onsets, 1, torch.clamp(count - 1, min=0))
    after = n if not strict_reference_compat else last_onset
    nxt = torch.where(slot + 1 < count, torch.roll(onsets, -1, dims=1),
                      after)
    start = onsets + skip
    end = torch.minimum(start + length, nxt)
    in_bounds = (start < n) & (end <= n)
    pos = start[..., None] + torch.arange(length, device=dev)
    window_ok = (pos < end[..., None]) & (in_bounds & onsets_valid)[..., None]

    hop = int(onset_hop)
    blocks_per_clip = -(-length // hop)
    avail = max(0, n_total - skip)       # y[:, skip:] is empty for skip > n
    n_blocks = max(1, -(-avail // hop))
    blocks = F.pad(y[:, skip:], (0, n_blocks * hop - avail)).reshape(
        b, n_blocks, hop)
    first = torch.clamp(onsets // hop, 0, n_blocks - 1)
    idx = torch.clamp(first[..., None] + torch.arange(blocks_per_clip,
                                                      device=dev),
                      0, n_blocks - 1)
    rows = torch.gather(blocks, 1, idx.reshape(b, -1)[..., None].expand(
        -1, -1, hop))
    rows = rows.reshape(b, k, blocks_per_clip * hop)[..., :length]
    clips = torch.where(window_ok, rows, 0.0)

    kept = onsets_valid & (gating.slice_rms_db(clips) > min_slice_rms_db)
    # times in float32 as x · fl(1/sr), the form XLA compiles x / sr to,
    # so that both packages report the same seconds
    inv_sr = 1.0 / sr
    times = torch.stack([start.to(torch.float32) * inv_sr,
                         end.to(torch.float32) * inv_sr], dim=-1)
    return clips, kept, times


def segment_waveform(y: torch.Tensor, sr: int = TARGET_SR,
                     hop_length: int = SLICER_CONFIG.HOP_LEN,
                     length_sec: float = CLIP_DURATION,
                     min_sep: float = SLICER_CONFIG.MIN_SEP,
                     min_db: float = SLICER_CONFIG.MIN_IN_DB_THRESHOLD,
                     min_slice_rms_db: float = SLICER_CONFIG.MIN_SLICE_RMS_DB,
                     attack_skip_sec: float = SLICER_CONFIG.ATTACK_SKIP_SEC,
                     max_onsets: int = 64,
                     strict_reference_compat: bool = True,
                     n_valid: torch.Tensor | None = None,
                     cand_budget: int | None = None):
    """Whole-file segmentation of (B, n): gate → detect onsets → slice.
    Returns (clips (B, K, L), kept, onsets, onsets_valid, times, overflow
    (B,), cap_overflow (B,), n_detected (B,)); the flags and count are
    `ops.onset.pick_onsets_plain`'s."""
    # the gates take the slicer's hop; onset detection keeps its own 512
    y_gated = gating.gate_waveform(y, min_db, hop_length=hop_length,
                                   n_valid=n_valid)
    onsets, ovalid, overflow, cap, n_detected = detect_onsets(
        y_gated, sr=sr, hop_length=_ONSET_HOP, min_sep=min_sep,
        max_onsets=max_onsets, n_valid=n_valid, cand_budget=cand_budget)
    clips, kept, times = slice_at_onsets(
        y, onsets, ovalid, sr=sr, length_sec=length_sec,
        attack_skip_sec=attack_skip_sec, min_slice_rms_db=min_slice_rms_db,
        strict_reference_compat=strict_reference_compat, n_valid=n_valid,
        onset_hop=_ONSET_HOP)
    return clips, kept, onsets, ovalid, times, overflow, cap, n_detected


def save_clip(clip, sr: int, out_dir, idx: int, onset_s: float,
              audio_name: str = "clip") -> None:
    """Write one clip as `<idx:04d>_<audio_name>__<onset:.3f>s.wav`, the
    reference slicer's file name."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if isinstance(clip, torch.Tensor):
        clip = clip.detach().cpu().numpy()
    write_wav(out_dir / f"{idx:04d}_{audio_name}__{onset_s:.3f}s.wav",
              np.asarray(clip), sr)
