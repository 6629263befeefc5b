"""Onset-based note slicing with fixed budgets and masks, the twin of
`gat_tpu/segment/slicing.py` with the batch written out.

* slice window = [onset + attack_skip, min(start + clip_len, next onset)];
* the last detected onset's next onset is itself, so its slice is empty,
  hence silent and dropped: the reference's slicer always loses a file's
  last note. `strict_reference_compat=True` (the default) keeps that;
  False slices the last note to the end of the audio;
* windows outside the audio give zero clips, which are dropped;
* clips quieter than min_slice_rms_db are dropped.

Every clip of the onset budget is gathered at once, with a `kept` mask
in place of the reference's per-clip drop logic: sample by sample for any
onsets, or as whole hop-long rows when the caller vouches that every
onset is a multiple of `onset_hop` (`segment_waveform` does). Both take a
batch (B, n) or, as the reference, one signal (n,), and the reference's
keyword `n_valid_samples` beside the port's `n_valid`. `slice_at_onsets`
launches the hand-written CUDA kernel `csrc/slice_clips.cu` (K8) for a
CUDA tensor and runs its plain PyTorch twin, `slice_at_onsets_plain`,
for a CPU tensor.

`AudioSlicer` keeps the reference class's surface (load_wav,
apply_db_threshold, apply_rms_threshold, detect_onsets,
is_slice_loud_enough, save_clip, slice_and_save and its alias sliceNsave)
on top of these ops, on the card unless it is given device="cpu". The
five methods the reference defines as static also work on the class, on
`AudioSlicer.default_device` (None: the card).
"""
from __future__ import annotations

import ctypes
import functools
import inspect
import types
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels
from ..config import CLIP_DURATION, SLICER_CONFIG, TARGET_SR
from ..ops.onset import _frame_counts, detect_onsets
from ..ops.resample import resample
from ..utils.device import resolve_device, to_host
from ..utils.profiling import annotate
from ..utils.signals import as_count_rows, as_rows, either
from ..utils.wavio import read_wav, write_wav
from . import gating

__all__ = ["slice_at_onsets", "slice_at_onsets_plain", "segment_waveform",
           "save_clip", "AudioSlicer"]

_ONSET_HOP = 512  # onset detection's own hop (the reference's default)


def slice_at_onsets_plain(y: torch.Tensor, onsets: torch.Tensor,
                          onsets_valid: torch.Tensor, sr: int,
                          length_sec: float = CLIP_DURATION,
                          attack_skip_sec: float =
                          SLICER_CONFIG.ATTACK_SKIP_SEC,
                          min_slice_rms_db: float =
                          SLICER_CONFIG.MIN_SLICE_RMS_DB,
                          strict_reference_compat: bool = True,
                          n_valid_samples: torch.Tensor | None = None,
                          onset_hop: int | None = None,
                          n_valid: torch.Tensor | None = None):
    """(B, n), (B, K), (B, K) → clips (B, K, L), kept (B, K), times
    (B, K, 2) in seconds; one signal (n,), (K,), (K,) → (K, L), (K,),
    (K, 2). `n_valid_samples` is `n_valid`. With `onset_hop` None each
    clip is gathered sample by sample (positions clamped into the signal,
    then masked to the window), for any onsets; with a hop, every onset
    must be a multiple of it, and clip k is then the rows onsets[k] / hop
    onwards of the skip-shifted waveform cut into hop-long rows."""
    n_valid = either("slice_at_onsets", "n_valid_samples", n_valid_samples,
                     "n_valid", n_valid)
    y, one = as_rows(y)
    if one:
        outs = slice_at_onsets(
            y, onsets[None], onsets_valid[None], sr, length_sec,
            attack_skip_sec, min_slice_rms_db, strict_reference_compat,
            onset_hop=onset_hop,
            n_valid=as_count_rows(n_valid, True, y.device))
        return tuple(x[0] for x in outs)
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

    if onset_hop is None:
        idx = torch.clamp(pos, 0, n_total - 1).reshape(b, k * length)
        rows = torch.gather(y, 1, idx).reshape(b, k, length)
    else:
        hop = int(onset_hop)
        blocks_per_clip = -(-length // hop)
        avail = max(0, n_total - skip)   # y[:, skip:] is empty for skip > n
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


def check_slice(b: int, k: int, length: int, skip: int,
                onset_hop: int | None) -> None:
    """Raise where K8 refuses a call (its C entry point refuses the same):
    clips shorter than 1 sample, a negative attack skip, an onset hop
    below 1, or more than 2^31 - 1 (file, slot) blocks."""
    if length < 1 or skip < 0:
        raise ValueError(f"[slice_at_onsets] the kernel takes clips of 1 or "
                         f"more samples and a skip of 0 or more, got "
                         f"{length} and {skip}")
    if onset_hop is not None and int(onset_hop) < 1:
        raise ValueError(f"[slice_at_onsets] onset_hop must be >= 1 or "
                         f"None, got {onset_hop}")
    if b * k > 2 ** 31 - 1:
        raise ValueError(f"[slice_at_onsets] {b} x {k} slots; the kernel "
                         f"takes at most 2^31 - 1")


_SLICE_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
               + [ctypes.c_float] * 2 + [ctypes.c_void_p])


def slice_at_onsets(y: torch.Tensor, onsets: torch.Tensor,
                    onsets_valid: torch.Tensor, sr: int,
                    length_sec: float = CLIP_DURATION,
                    attack_skip_sec: float = SLICER_CONFIG.ATTACK_SKIP_SEC,
                    min_slice_rms_db: float = SLICER_CONFIG.MIN_SLICE_RMS_DB,
                    strict_reference_compat: bool = True,
                    n_valid_samples: torch.Tensor | None = None,
                    onset_hop: int | None = None,
                    n_valid: torch.Tensor | None = None):
    """(B, n), (B, K), (B, K) → clips (B, K, L), kept (B, K), times
    (B, K, 2) in seconds, as `slice_at_onsets_plain` defines them; one
    signal (n,), (K,), (K,) → (K, L), (K,), (K, 2).

    CUDA tensor: the kernel `csrc/slice_clips.cu` (K8), which replaces the
    JAX package's XLA `gat_tpu/segment/slicing.py::slice_at_onsets`: one
    block per (file, slot) writes its clip with 16-byte stores, reading
    only inside its window, sums its squares for `kept` and writes its
    times; one launch. A window whose samples are y[start + j] (any
    onset without `onset_hop`, one on the hop's grid with it, start >= 0,
    end within the row) is staged by bulk copies through a ring in shared
    memory (`gat_slice_clips_ring` reports its shape); any other (the
    reference's hop-long rows of an onset off the grid, a negative start,
    an end past the row under a valid count past it) is gathered a sample
    at a time.
    CPU tensor: `slice_at_onsets_plain`."""
    n_valid = either("slice_at_onsets", "n_valid_samples", n_valid_samples,
                     "n_valid", n_valid)
    if y.device.type == "cpu":
        return slice_at_onsets_plain(
            y, onsets, onsets_valid, sr, length_sec, attack_skip_sec,
            min_slice_rms_db, strict_reference_compat, onset_hop=onset_hop,
            n_valid=n_valid)
    if y.device.type != "cuda":
        raise ValueError(f"[slice_at_onsets] unsupported device {y.device}")
    y, one = as_rows(y)
    if one:
        onsets, onsets_valid = onsets[None], onsets_valid[None]
        n_valid = as_count_rows(n_valid, True, y.device)
    kernels.check_input(y, "slice_at_onsets")
    b, n = y.shape
    k = onsets.shape[-1]
    if tuple(onsets.shape) != (b, k) or tuple(onsets_valid.shape) != (b, k):
        raise ValueError(f"[slice_at_onsets] onsets and onsets_valid must be "
                         f"({b}, K), got {tuple(onsets.shape)} and "
                         f"{tuple(onsets_valid.shape)}")
    length = int(length_sec * sr)
    skip = int(attack_skip_sec * sr)
    check_slice(b, k, length, skip, onset_hop)
    hop = 0 if onset_hop is None else int(onset_hop)
    dev = y.device
    clips = torch.empty((b, k, length), dtype=torch.float32, device=dev)
    kept = torch.empty((b, k), dtype=torch.bool, device=dev)
    times = torch.empty((b, k, 2), dtype=torch.float32, device=dev)
    if b * k > 0:
        # no copy for K5's outputs, which are so already
        ons = onsets.to(device=dev, dtype=torch.int32).contiguous()
        valid = onsets_valid.to(device=dev, dtype=torch.bool).contiguous()
        nv = _frame_counts(n_valid, dev)
        fn = kernels.function("slice_clips", "gat_slice_clips", _SLICE_ARGS)
        with kernels.device_guard(dev):
            status = fn(y.data_ptr(), ons.data_ptr(), valid.data_ptr(),
                        None if nv is None else nv.data_ptr(),
                        clips.data_ptr(), kept.data_ptr(), times.data_ptr(),
                        b, n, k, length, skip, hop,
                        int(strict_reference_compat), min_slice_rms_db,
                        1.0 / sr, kernels.stream(dev))
        kernels.check(status, "slice_at_onsets")
        slice_at_onsets.launches += 1
    if one:
        return clips[0], kept[0], times[0]
    return clips, kept, times


slice_at_onsets.launches = 0


def segment_waveform(y: torch.Tensor, sr: int = TARGET_SR,
                     hop_length: int = SLICER_CONFIG.HOP_LEN,
                     length_sec: float = CLIP_DURATION,
                     min_sep: float = SLICER_CONFIG.MIN_SEP,
                     min_db: float = SLICER_CONFIG.MIN_IN_DB_THRESHOLD,
                     min_slice_rms_db: float = SLICER_CONFIG.MIN_SLICE_RMS_DB,
                     attack_skip_sec: float = SLICER_CONFIG.ATTACK_SKIP_SEC,
                     max_onsets: int = 64,
                     strict_reference_compat: bool = True,
                     n_valid_samples: torch.Tensor | None = None,
                     cand_budget: int | None = None,
                     n_valid: torch.Tensor | None = None):
    """Whole-file segmentation of (B, n), or of one signal (n,): gate →
    detect onsets → slice. Returns (clips (B, K, L), kept, onsets,
    onsets_valid, times, overflow (B,), cap_overflow (B,), n_detected
    (B,)), without the batch axis for one signal; the flags and count are
    `ops.onset.pick_onsets_plain`'s. `n_valid_samples` is `n_valid`."""
    n_valid = either("segment_waveform", "n_valid_samples", n_valid_samples,
                     "n_valid", n_valid)
    y, one = as_rows(y)
    if one:
        outs = segment_waveform(
            y, sr, hop_length, length_sec, min_sep, min_db,
            min_slice_rms_db, attack_skip_sec, max_onsets,
            strict_reference_compat, cand_budget=cand_budget,
            n_valid=as_count_rows(n_valid, True, y.device))
        return tuple(x[0] for x in outs)
    # the gates take the slicer's hop; onset detection keeps its own 512.
    # The ranges name the stages of a profiler trace (infer/pipeline.py)
    with annotate("segmentation_other"):
        y_gated = gating.gate_waveform(y, min_db, hop_length=hop_length,
                                       n_valid=n_valid)
    with annotate("onset_detect"):
        onsets, ovalid, overflow, cap, n_detected = detect_onsets(
            y_gated, sr=sr, hop_length=_ONSET_HOP, min_sep=min_sep,
            max_onsets=max_onsets, n_valid=n_valid, cand_budget=cand_budget)
    with annotate("slicing"):
        clips, kept, times = slice_at_onsets(
            y, onsets, ovalid, sr=sr, length_sec=length_sec,
            attack_skip_sec=attack_skip_sec,
            min_slice_rms_db=min_slice_rms_db,
            strict_reference_compat=strict_reference_compat,
            n_valid=n_valid, onset_hop=_ONSET_HOP)
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


class _static_or_bound:
    """A method the reference defines as static: called on an instance it
    computes on the instance's device; called on the class, on a new
    instance on the class's `default_device`, with the reference's
    signature (no `self`)."""

    def __init__(self, fn):
        self.fn = fn
        functools.update_wrapper(self, fn)
        sig = inspect.signature(fn)
        self.signature = sig.replace(
            parameters=list(sig.parameters.values())[1:])

    def __get__(self, obj, cls=None):
        if obj is not None:
            return types.MethodType(self.fn, obj)
        fn = self.fn

        @functools.wraps(fn)
        def on_default_device(*args, **kwargs):
            return fn(cls(device=cls.default_device), *args, **kwargs)
        on_default_device.__signature__ = self.signature
        return on_default_device


class AudioSlicer:
    """File-level slicer with the reference class's surface, computing on
    `device` (default the card; 'cpu' runs the plain PyTorch path). Each
    method takes and returns numpy, with one transfer from the device per
    call. `load_wav`, `apply_db_threshold`, `apply_rms_threshold`,
    `detect_onsets` and `is_slice_loud_enough` may also be called on the
    class, as the reference's static methods are: they then compute on
    `default_device` (None: the card)."""

    default_device = None

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def _tensor(self, y) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(y, np.float32)).to(
            self.device)

    @_static_or_bound
    def load_wav(self, path, sr: int = 11025):
        """(mono float32 samples, rate), resampled to `sr` unless it is
        None."""
        wav, sr_in = read_wav(path)
        if sr is not None and sr_in != sr:
            (wav,) = to_host((resample(self._tensor(wav), sr_in, sr),))
            sr_in = sr
        return np.asarray(wav, np.float32), sr_in

    @_static_or_bound
    def apply_db_threshold(self, y, min_db: float = -45.0):
        return to_host((gating.sample_db_gate(self._tensor(y), min_db),))[0]

    @_static_or_bound
    def apply_rms_threshold(self, y, hop_len: int = 512):
        return to_host((gating.rms_gate(self._tensor(y)[None],
                                        hop_length=hop_len)[0],))[0]

    @_static_or_bound
    def detect_onsets(self, y, sr: int = 11025, hop_len: int = 512,
                      min_sep: float = 0.25, max_onsets: int = 64):
        """Onset samples of one signal, its three outputs in one transfer;
        warns when the onset budget truncated the detections."""
        onsets, valid, overflow, *_ = to_host(detect_onsets(
            self._tensor(y)[None], sr=sr, hop_length=hop_len,
            min_sep=min_sep, max_onsets=max_onsets))
        if overflow[0]:
            warnings.warn(
                f"[detect_onsets] onset budget truncated detections "
                f"(max_onsets={max_onsets}; earliest kept) — raise the "
                f"budget for exhaustive results", stacklevel=2)
        return [int(s) for s in onsets[0][valid[0]]]

    @_static_or_bound
    def is_slice_loud_enough(self, clip, min_rms_db: float = -40.0) -> bool:
        (db,) = to_host((gating.slice_rms_db(self._tensor(clip)),))
        return bool(db > min_rms_db)

    @staticmethod
    def save_clip(clip, sr, out_dir, idx, onset_s, audio_name="clip"):
        save_clip(clip, sr, out_dir, idx, onset_s, audio_name)

    def slice_and_save(self, audio_path, out_dir,
                       target_sr: int = TARGET_SR,
                       hop_len: int = SLICER_CONFIG.HOP_LEN,
                       length_sec: float = CLIP_DURATION,
                       min_sep: float = SLICER_CONFIG.MIN_SEP,
                       min_db_threshold: float =
                       SLICER_CONFIG.MIN_IN_DB_THRESHOLD,
                       min_slice_rms_db: float =
                       SLICER_CONFIG.MIN_SLICE_RMS_DB,
                       attack_skip_sec: float =
                       SLICER_CONFIG.ATTACK_SKIP_SEC,
                       max_onsets: int = 64, verbose: bool = True):
        """Segment a file and write its kept clips to out_dir as
        `<i:04d>_clip__<onset:.3f>s.wav`, the reference's names; returns
        the detected onset samples. One transfer brings the segmentation
        to the host."""
        y, sr = self.load_wav(audio_path, target_sr)
        clips, kept, onsets, ovalid, times, overflow, *_ = (
            x[0] for x in to_host(segment_waveform(
                self._tensor(y)[None], sr=sr, hop_length=hop_len,
                length_sec=length_sec, min_sep=min_sep,
                min_db=min_db_threshold, min_slice_rms_db=min_slice_rms_db,
                attack_skip_sec=attack_skip_sec, max_onsets=max_onsets)))
        if overflow:
            warnings.warn(
                f"[slice_and_save] onset budget truncated detections for "
                f"{audio_path} (max_onsets={max_onsets}; earliest kept) — "
                f"later notes were NOT sliced", stacklevel=2)
        total = 0
        for i in range(len(onsets)):
            if not ovalid[i]:
                break
            onset_s = onsets[i] / sr
            if not kept[i]:
                if verbose:
                    print(f"[slice_and_save] dropped clip at {onset_s:.2f}s;"
                          " [is_slice_loud_enough]")
                continue
            self.save_clip(clips[i], sr, out_dir, i, onset_s)
            total += 1
            if verbose:
                print(f"[slice_and_save] saved clip from: {times[i][0]:.3f}s"
                      f" to {times[i][1]:.3f}s")
        if verbose:
            print(f"[slice_and_save] total clips saved: {total}")
            print(f"audio sr: {sr}")
        return [int(s) for s in onsets[ovalid]]

    # the reference's spelling
    sliceNsave = slice_and_save
