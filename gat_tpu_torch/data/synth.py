"""Plucked-string synthesis, the port's copy of
`gat_tpu/data/synth.py::karplus_strong` (numpy only). The server's warmup
makes its plucks with it."""
from __future__ import annotations

import numpy as np

__all__ = ["karplus_strong"]


def karplus_strong(freq_hz: float, sr: int, duration: float,
                   n_variants: int = 1, damping: float = 0.996,
                   blend: float = 0.5, seed: int = 0) -> np.ndarray:
    """(n_variants, n) plucked strings at one pitch: a noise burst through
    a damped delay line, all variants as one vector lane, each normalized
    to peak 1."""
    n = int(duration * sr)
    period = max(2, int(round(sr / freq_hz)))
    rng = np.random.default_rng(seed)
    buf = rng.uniform(-1.0, 1.0, (n_variants, period))
    out = np.empty((n_variants, n), dtype=np.float64)
    idx = 0
    for i in range(n):
        out[:, i] = buf[:, idx]
        nxt = (idx + 1) % period
        buf[:, idx] = damping * (blend * buf[:, idx]
                                 + (1.0 - blend) * buf[:, nxt])
        idx = nxt
    peak = np.abs(out).max(axis=1, keepdims=True) + 1e-12
    return (out / peak).astype(np.float32)
