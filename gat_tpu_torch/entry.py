"""Entry point of the port: the flagship clip-batch step at the shipped
checkpoints, the twin of `__graft_entry__.entry`.

`entry(batch, device)` returns (step, example_args): step(clips (N, L)) →
(ensemble probs (N, 47), YIN pitch (N,) Hz), where clips are 0.5 s at the
checkpoints' 11025 Hz. The YIN pitch of the raw clips feeds both the MLP's
pitch feature and the second output, so it is computed once.
"""
from __future__ import annotations

import numpy as np
import torch

from .infer.transcriber import Transcriber
from .ops.yin import yin_pitch

__all__ = ["entry"]


def entry(batch: int = 32, device=None):
    """(step, (clips,)) on `device` (default the card)."""
    t = Transcriber(device=device)
    clip_len = int(t.ckpt_sr * t.clip_length)

    @torch.no_grad()
    def transcribe_step(clips: torch.Tensor):
        pitch = yin_pitch(clips, t.ckpt_sr)
        probs, _, _ = t.ensemble(clips, raw_pitch_hz=pitch)
        return probs, pitch

    rng = np.random.default_rng(0)
    clips = rng.normal(0, 0.1, (batch, clip_len)).astype(np.float32)
    return transcribe_step, (torch.from_numpy(clips).to(t.device),)
