"""Time-axis sequence parallelism for long-audio onset detection, the
twin of `gat_tpu/parallel/timeshard.py`.

One long recording's time axis is split over the mesh's `data` axis.
Each rank frames its own chunk of the centre-padded waveform, extended by
a halo of the next n_fft − hop samples from its right neighbour (the
last rank takes the file's real tail instead), so frames that straddle a
boundary are exact; the halo travels as an all-gather of every rank's
head, which every backend supports. Then:

1. the chunk's pre-clamp mel dB and its peak over the file's real frames
   come from K4's first pass alone (`ops/onset.py::onset_mel_db`, origin
   0: the chunk carries its own context);
2. the file's peak is an all-reduce MAX over `data` of K4's int32 order
   keys (a max of keys is the max of the floats): the top_db clamp of
   every frame is the single-device one, budget frames past the end
   never moving it;
3. the dB rows are gathered and K4's second pass alone
   (`ops/onset.py::onset_flux`) gives the envelope on every rank;
4. K5 picks on the replicated envelope.

On the CPU the plain versions of both passes and of the pick run.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..ops.onset import onset_flux, onset_mel_db, pick_onsets
from .mesh import DATA, axis_group, axis_rank, axis_size, mesh_device

__all__ = ["onset_envelope_timesharded", "detect_onsets_timesharded",
           "TimeShards"]

_ROUND = 4  # frames in one round of K4's first pass (kInFlight)


def _chunk(y: torch.Tensor, start: int, length: int) -> torch.Tensor:
    """Samples [start, start + length) of y, zeros outside it."""
    out = y.new_zeros(length)
    lo, hi = max(start, 0), min(start + length, y.shape[0])
    if hi > lo:
        out[lo - start:hi - start] = y[lo:hi]
    return out


@dataclass(frozen=True)
class TimeShards:
    """How one file of n samples is cut over d ranks. Each shard owns
    `frames` frames, a whole number of K4's rounds of four: every
    shard's rounds are the single-device pass's, so each frame shares
    its FFT with the same partner frame (the two-for-one split's rounding
    of a quiet bin depends on the partner) and the shards stitch to it
    bit for bit. Shard r is samples [start(r), start(r) + owned + halo)
    of the centre-padded file: its own frames' samples, from its first
    frame's first sample (K4's origin 0), and a right halo of the next
    n_fft − hop samples, the next shard's head."""
    n: int
    d: int
    hop: int = 512
    n_fft: int = 2048

    @property
    def t_global(self) -> int:
        return 1 + self.n // self.hop

    @property
    def frames(self) -> int:
        return -(-self.t_global // (self.d * _ROUND)) * _ROUND

    @property
    def owned(self) -> int:
        return self.frames * self.hop

    @property
    def halo(self) -> int:
        return self.n_fft - self.hop

    def start(self, r: int) -> int:
        """Shard r's first sample, in the unpadded file's samples."""
        return r * self.owned - self.n_fft // 2

    def real(self, r: int) -> int:
        """Shard r's frames inside the file (the peak mask's count)."""
        return min(max(self.t_global - r * self.frames, 0), self.frames)

    def shard(self, y: torch.Tensor, r: int) -> torch.Tensor:
        """Shard r of y (n,) with its halo, (owned + halo,), zeros past
        the file."""
        return _chunk(y, self.start(r), self.owned + self.halo)


@torch.no_grad()
def onset_envelope_timesharded(y, mesh, sr: int, hop_length: int = 512,
                               n_fft: int = 2048, n_mels: int = 128
                               ) -> torch.Tensor:
    """Mel-flux onset envelope (T,) of ONE waveform y (n,), time-sharded
    over `data` (`TimeShards`); every rank passes the same y and gets the
    envelope `ops.onset.onset_strength(y[None])[0]` gives,
    T = 1 + n // hop."""
    if n_fft != 2048:
        raise ValueError(f"[onset_envelope_timesharded] K4 is built for "
                         f"n_fft 2048, got {n_fft}")
    dev = mesh_device(mesh)
    y = torch.as_tensor(y, dtype=torch.float32).reshape(-1).to(dev)
    d, r = axis_size(mesh, DATA), axis_rank(mesh, DATA)
    group = axis_group(mesh, DATA)
    cut = TimeShards(y.shape[0], d, hop_length, n_fft)
    # this rank's owned samples; its halo is the next rank's head, and
    # the last rank's the samples past its own
    body = _chunk(y, cut.start(r), cut.owned)
    heads = [torch.empty(cut.halo, device=dev) for _ in range(d)]
    dist.all_gather(heads, body[:cut.halo].contiguous(), group=group)
    halo = (heads[r + 1] if r + 1 < d
            else _chunk(y, cut.start(d), cut.halo))
    ext = torch.cat([body, halo])[None].contiguous()
    db, key = onset_mel_db(ext, sr, hop_length, n_mels, origin=0,
                           frames=cut.frames,
                           n_valid_frames=torch.tensor([cut.real(r)],
                                                       dtype=torch.int32))
    dist.all_reduce(key, op=dist.ReduceOp.MAX, group=group)
    rows = [torch.empty_like(db[0]) for _ in range(d)]
    dist.all_gather(rows, db[0].contiguous(), group=group)
    db_all = torch.cat(rows)[:cut.t_global][None].contiguous()
    return onset_flux(db_all, key, hop_length)[0]


def detect_onsets_timesharded(y, mesh, sr: int = 22050,
                              hop_length: int = 512, min_sep: float = 0.3,
                              max_onsets: int = 256):
    """Long-audio onset detection with the envelope computed
    sequence-parallel and the pick (K5) run on the replicated envelope.
    Returns (onsets, valid, overflow, cap_overflow, n_kept) for the one
    file, as `ops.onset.pick_onsets_from_envelope` does."""
    env = onset_envelope_timesharded(y, mesh, sr, hop_length)
    outs = pick_onsets(env[None].contiguous(), sr, hop_length, min_sep,
                       max_onsets)
    return tuple(x[0] for x in outs)
