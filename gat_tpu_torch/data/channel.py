"""Acquisition-channel stressors, the port's copy of
`gat_tpu/data/channel.py` (numpy and `scipy.signal`): distribution shifts
a microphone or pickup chain adds, applied after rendering to evaluation
sets and, with a probability, as training augmentation:

  * room_ir     — convolution with a synthetic small-room impulse
                  response (sparse early reflections + exponentially
                  decaying diffuse noise tail, RT60 0.15-0.5 s).
  * pickup_eq   — magnetic-pickup tone shaping: resonant low-pass peak
                  (2-5 kHz, the pickup LC resonance) plus a mild low
                  shelf, via biquads.
  * bg_noise    — pink background noise plus mains hum (50/60 Hz and one
                  harmonic) at an SNR drawn from 12-25 dB.

Every draw comes from the caller's generator in the reference's order, so
a seeded dataset is the same bytes from either package.
"""
from __future__ import annotations

import numpy as np
from scipy import signal

__all__ = ["synth_room_ir", "apply_room_ir", "apply_pickup_eq",
           "apply_bg_noise", "apply_channel", "CHANNELS"]


def synth_room_ir(sr: int, rt60: float, rng: np.random.Generator,
                  n_early: int = 8) -> np.ndarray:
    """Synthetic room impulse response: direct path, `n_early` sparse
    early reflections inside 25 ms, then a Gaussian tail decaying at
    60 dB per `rt60` seconds."""
    n = int(rt60 * sr)
    ir = np.zeros(max(n, int(0.03 * sr)))
    ir[0] = 1.0
    for _ in range(n_early):
        d = int(rng.uniform(0.002, 0.025) * sr)
        if d < len(ir):
            ir[d] += rng.uniform(-0.5, 0.5)
    t = np.arange(len(ir)) / sr
    tail = rng.normal(0.0, 1.0, len(ir)) * 10.0 ** (-3.0 * t / rt60)
    ir += 0.3 * tail * (t > 0.005)
    return (ir / (np.abs(ir).sum() ** 0.5 + 1e-12)).astype(np.float64)


def apply_room_ir(sig: np.ndarray, sr: int,
                  rng: np.random.Generator) -> np.ndarray:
    rt60 = rng.uniform(0.15, 0.5)
    wet = rng.uniform(0.25, 0.6)
    ir = synth_room_ir(sr, rt60, rng)
    rev = signal.fftconvolve(sig, ir)[: len(sig)]
    out = (1.0 - wet) * sig + wet * rev
    peak = np.abs(out).max() + 1e-12
    return (out / peak * np.abs(sig).max()).astype(sig.dtype)


def _peaking_sos(f0: float, q: float, gain_db: float,
                 sr: int) -> np.ndarray:
    a = 10.0 ** (gain_db / 40.0)
    w0 = 2.0 * np.pi * f0 / sr
    alpha = np.sin(w0) / (2.0 * q)
    b = [1 + alpha * a, -2 * np.cos(w0), 1 - alpha * a]
    ax = [1 + alpha / a, -2 * np.cos(w0), 1 - alpha / a]
    return np.array([[b[0] / ax[0], b[1] / ax[0], b[2] / ax[0],
                      1.0, ax[1] / ax[0], ax[2] / ax[0]]])


def apply_pickup_eq(sig: np.ndarray, sr: int,
                    rng: np.random.Generator) -> np.ndarray:
    res_f = rng.uniform(2000.0, 5000.0)     # pickup LC resonance
    res_q = rng.uniform(1.5, 4.0)
    res_db = rng.uniform(4.0, 10.0)
    nyq = sr / 2.0
    sos = np.concatenate([
        _peaking_sos(min(res_f, nyq * 0.9), res_q, res_db, sr),
        signal.butter(2, min(res_f * 1.4 / nyq, 0.99), "lowpass",
                      output="sos"),
        _peaking_sos(120.0, 0.8, rng.uniform(-3.0, 3.0), sr),
    ])
    out = signal.sosfilt(sos, sig.astype(np.float64))
    peak = np.abs(out).max() + 1e-12
    return (out / peak * np.abs(sig).max()).astype(sig.dtype)


def apply_bg_noise(sig: np.ndarray, sr: int,
                   rng: np.random.Generator) -> np.ndarray:
    n = len(sig)
    # pink noise: shape white noise by 1/sqrt(f) in the frequency domain
    spec = np.fft.rfft(rng.normal(0.0, 1.0, n))
    f = np.fft.rfftfreq(n, 1.0 / sr)
    spec[1:] /= np.sqrt(f[1:])
    spec[0] = 0.0
    pink = np.fft.irfft(spec, n)
    hum_f = float(rng.choice([50.0, 60.0]))
    t = np.arange(n) / sr
    hum = (np.sin(2 * np.pi * hum_f * t + rng.uniform(0, 2 * np.pi))
           + 0.4 * np.sin(2 * np.pi * 2 * hum_f * t
                          + rng.uniform(0, 2 * np.pi)))
    noise = pink / (np.std(pink) + 1e-12) + 0.5 * hum
    noise /= np.sqrt(np.mean(noise ** 2)) + 1e-12
    snr_db = rng.uniform(12.0, 25.0)
    sig_rms = np.sqrt(np.mean(sig.astype(np.float64) ** 2)) + 1e-12
    out = sig + (noise * sig_rms * 10.0 ** (-snr_db / 20.0)).astype(
        sig.dtype)
    return out.astype(sig.dtype)


CHANNELS = {
    "room_ir": apply_room_ir,
    "pickup_eq": apply_pickup_eq,
    "bg_noise": apply_bg_noise,
}


def apply_channel(sig: np.ndarray, sr: int, which: str,
                  rng: np.random.Generator) -> np.ndarray:
    """Apply one named channel stressor, 'mix' for a random single one,
    'full_chain' for pickup EQ → room IR → background noise in order, or
    'mix_chain' for a random choice that includes the full chain (the
    training-augmentation draw)."""
    if which == "mix":
        which = list(CHANNELS)[int(rng.integers(len(CHANNELS)))]
    elif which == "mix_chain":
        opts = list(CHANNELS) + ["full_chain"]
        which = opts[int(rng.integers(len(opts)))]
    if which == "full_chain":
        for fn in (apply_pickup_eq, apply_room_ir, apply_bg_noise):
            sig = fn(sig, sr, rng)
        return sig
    if which not in CHANNELS:
        raise ValueError(f"unknown channel stressor {which!r}; choose "
                         f"from {tuple(CHANNELS)} or "
                         f"'mix'/'full_chain'/'mix_chain'")
    return CHANNELS[which](sig, sr, rng)
