"""Offline streaming transcription over fixed chunks, the twin of
`gat_tpu/stream/scan.py::ScanStreamer`.

The JAX engine is one `lax.scan` over chunks of 0.5 s. Each step slides a
ring of context + chunk samples, detects onsets in it (8 slots,
min_sep 0), cuts a clip at every slot, gates the clips by loudness, keeps
the onsets in the commit window [0, chunk) that have a whole clip of ring
after them, takes them greedily at least min_sep after the last emitted
onset (carried from chunk to chunk), and runs the ensemble on all 8 slots.

The ring of step i does not depend on the carry: it is samples
[i·chunk, i·chunk + ring_n) of the stream with `context` zeros in front
and zeros after it up to whole chunks. So here every ring of a window of
`_WINDOW_CHUNKS` chunks is segmented in one batched pass on the device
(K4 and K5 launch once for the window), and the window's onsets,
eligibility and overflow flags come to the host in one transfer.

Only the greedy min-separation walk is sequential, and it runs on the
host, in ring-relative ints exactly as the JAX step computes it: at most
8 integer comparisons a chunk. The JAX engine reads every slot on the
host anyway; a kernel would only move a loop-carried chain of a few
thousand comparisons onto one GPU thread, behind a launch and a transfer.

The ensemble (K1-K3) then runs on the taken clips only, gathered from the
stream at their absolute positions, and their probabilities come back in
a second transfer; a window with no note runs no ensemble. The notes'
results do not depend on the other slots: the features, YIN and the
eval-mode models work clip by clip.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import CLIP_DURATION, SLICER_CONFIG
from ..infer.pipeline import build_clip_ensemble_fn
from ..ops.onset import detect_onsets
from ..segment.gating import slice_rms_db
from ..utils.device import to_host as _to_host

__all__ = ["ScanStreamer"]

# chunks segmented in one batched pass: 256 rings of 33,075 samples at
# 22050 Hz are 34 MB
_WINDOW_CHUNKS = 256
# the walk's "no onset emitted yet", and the floor its carry never falls
# below (the JAX carry is int32)
_NO_ONSET = -(2 ** 30)


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on `device`; to the card from pinned memory, so the
    copy does not wait for the device."""
    x = torch.from_numpy(a)
    if device.type == "cuda":
        return x.pin_memory().to(device, non_blocking=True)
    return x


class ScanStreamer:
    """Chunked streaming over a Transcriber's models: the JAX engine's
    emission policy, one batched segmentation per window of chunks."""

    def __init__(self, transcriber, sr: int = 22050, chunk_s: float = 0.5,
                 context_s: float = 1.0,
                 clip_duration: float | None = None,
                 min_sep: float = SLICER_CONFIG.MIN_SEP,
                 min_slice_rms_db: float = SLICER_CONFIG.MIN_SLICE_RMS_DB,
                 max_notes_per_chunk: int = 8):
        if clip_duration is None:
            # the checkpoint's clip duration, as on every inference path
            clip_duration = getattr(transcriber, "clip_length",
                                    CLIP_DURATION)
        self.transcriber = transcriber
        self.device = transcriber.device
        self.sr = sr
        self.chunk = int(chunk_s * sr)
        self.context = int(context_s * sr)
        self.ring_n = self.chunk + self.context
        self.clip_n = int(clip_duration * sr)
        self.min_sep_n = int(min_sep * sr)
        self.min_slice_rms_db = min_slice_rms_db
        self.max_notes_per_chunk = int(max_notes_per_chunk)
        assert self.ring_n >= self.chunk + self.clip_n, \
            "context must cover a full clip beyond the commit window"
        t = transcriber
        # clip_len from Python's round, as the reference: round(5512.5)
        # is 5512
        self._ensemble = build_clip_ensemble_fn(
            t.predictor, t.scaler, t.ckpt_sr, t.mfcc_params,
            t.melspec_params, in_sr=sr,
            clip_len=round(self.clip_n * t.ckpt_sr / sr),
            pitch_on_normalized=True, return_parts=True)

    def _stream(self, y) -> tuple[torch.Tensor, int]:
        """(the padded stream on the device: `context` zeros, y, zeros up
        to whole chunks; its number of chunks). A finite waveform needs
        the `context` zeros after it too, or its last notes never reach
        a commit window."""
        if not isinstance(y, torch.Tensor):
            y = torch.from_numpy(np.ascontiguousarray(y, np.float32))
        y = y.to(device=self.device, dtype=torch.float32).reshape(-1)
        n = y.shape[0]
        n_chunks = -(-(n + self.context) // self.chunk)
        stream = torch.nn.functional.pad(
            y, (self.context, n_chunks * self.chunk - n))
        return stream, n_chunks

    def _windows(self, stream: torch.Tensor, n_chunks: int):
        """Per window of chunks, (its first chunk, onsets (w, K) int64
        ring-relative, takes (w, K) bool, overflow (w,) bool) on the host,
        the walk's carry passed from window to window."""
        chunk, ring_n, clip_n = self.chunk, self.ring_n, self.clip_n
        last = _NO_ONSET  # the last emitted onset, relative to the ring
        for c0 in range(0, n_chunks, _WINDOW_CHUNKS):
            w = min(_WINDOW_CHUNKS, n_chunks - c0)
            rings = stream[c0 * chunk:(c0 + w - 1) * chunk + ring_n].unfold(
                0, ring_n, chunk).contiguous()
            onsets, valid, overflow, *_ = detect_onsets(
                rings, sr=self.sr, min_sep=0.0,
                max_onsets=self.max_notes_per_chunk)
            # a clip at every slot, its start clamped into the ring as
            # lax.dynamic_slice clamps it
            starts = torch.clamp(onsets.long(), 0, ring_n - clip_n)
            rows = torch.arange(w, device=rings.device)[:, None]
            clips = rings.unfold(1, clip_n, 1)[rows, starts]
            loud = slice_rms_db(clips) > self.min_slice_rms_db
            eligible = (valid & loud & (onsets < chunk)
                        & (onsets + clip_n <= ring_n))
            onsets, eligible, overflow = _to_host((onsets, eligible,
                                                   overflow))
            onsets = onsets.astype(np.int64)
            takes = np.zeros_like(eligible)
            for i in range(w):
                last = max(last - chunk, _NO_ONSET)
                for j in np.flatnonzero(eligible[i]):
                    if onsets[i, j] - last >= self.min_sep_n:
                        takes[i, j] = True
                        last = int(onsets[i, j])
            yield c0, onsets, takes, overflow

    @torch.no_grad()
    def segment_stream(self, y) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The per-chunk slots of a waveform: (onsets (n_chunks, K) int64,
        relative to each chunk's ring; takes (n_chunks, K) bool; overflow
        (n_chunks,) bool), the (onsets, emits, ovf) of the JAX engine's
        scan."""
        parts = list(self._windows(*self._stream(y)))
        return tuple(np.concatenate([p[i] for p in parts]) for i in (1, 2, 3))

    @torch.no_grad()
    def transcribe_stream(self, y) -> list[dict]:
        """Stream a whole waveform (numpy or a 1-D tensor at `sr`) chunk by
        chunk; returns one result dict per emitted note, in time order:
        onset_s, labels, confidences, probs, onset_overflow (the chunk's
        onset budget truncated its detections)."""
        stream, n_chunks = self._stream(y)
        rm = self.transcriber.predictor.reverse_map
        clip_rows = stream.unfold(0, self.clip_n, 1)
        out = []
        for c0, onsets, takes, overflow in self._windows(stream, n_chunks):
            steps, slots = np.nonzero(takes)
            if not len(steps):
                continue
            rel = onsets[steps, slots]
            pos = (c0 + steps) * self.chunk + rel  # in the padded stream
            clips = clip_rows[_upload(pos, self.device)]
            (probs,) = _to_host((self._ensemble(clips)[0],))
            for p, step, o in zip(probs, c0 + steps, rel):
                idx = int(p.argmax())
                out.append({
                    "onset_s": (int(step) * self.chunk - self.context
                                + int(o)) / self.sr,
                    "labels": [rm[idx] if rm else idx],
                    "confidences": np.asarray([p[idx]]),
                    "probs": p[None],
                    "onset_overflow": bool(overflow[step - c0]),
                })
        return out
