"""Synthetic guitar notes and the training dataset writer, the port's
copy of `gat_tpu/data/synth.py` (numpy and scipy only).

Three synthesizers of plucked notes:

  * karplus_strong — the plucked-string physical model (a noise burst
    through a damped delay line), all variants of a pitch as one vector
    lane;
  * additive_pluck — a harmonic stack with per-partial decay;
  * fm_pluck — a carrier modulated at an integer ratio with a decaying
    index.

`synthesize_note_dataset` writes `<root>/<label>/<label>_<i>.wav` (labels
are the ASCII SPN folder names) with per-variant augmentation, optional
noise, playing-style stressors and acquisition-channel stressors. Every
random draw is made in the reference's order from the same seeds, so a
seeded dataset written by either package is the same bytes; the shipped
checkpoints were trained from the recipe `all3`, noise SNR 8-40 dB,
stressor 0.5, channel 0.25, seed 42.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..ops.pitch import midi_to_hz, note_to_midi
from ..utils.native_wav import write_wav_batch

__all__ = ["karplus_strong", "additive_pluck", "fm_pluck",
           "apply_vibrato", "apply_pitch_bend", "apply_tremolo",
           "apply_palm_mute", "synthesize_note_dataset",
           "DEFAULT_CLASS_NAMES"]

# the 47 SPN classes of the shipped checkpoints (A#2…G5)
DEFAULT_CLASS_NAMES = [
    "A#2", "A#3", "A#4", "A#5", "A2", "A3", "A4", "A5", "B2", "B3", "B4",
    "B5", "C#3", "C#4", "C#5", "C#6", "C3", "C4", "C5", "C6", "D#3", "D#4",
    "D#5", "D3", "D4", "D5", "D6", "E2", "E3", "E4", "E5", "F#2", "F#3",
    "F#4", "F#5", "F2", "F3", "F4", "F5", "G#2", "G#3", "G#4", "G#5", "G2",
    "G3", "G4", "G5",
]


def karplus_strong(freq_hz: float, sr: int, duration: float,
                   n_variants: int = 1, damping: float = 0.996,
                   blend: float = 0.5, seed: int = 0) -> np.ndarray:
    """(n_variants, n) plucked strings at one pitch — the delay-line loop
    runs once over time with all variants as a vector lane."""
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


def additive_pluck(freq_hz: float, sr: int, duration: float,
                   n_variants: int = 1, n_partials: int = 20,
                   brightness: float = 1.0, decay: float = 3.0,
                   inharmonicity: float = 1e-4, seed: int = 0) -> np.ndarray:
    """(n_variants, n) harmonic plucks: partial k at k·f with amplitude
    ~ brightness^k / k and decay rate growing with k."""
    n = int(duration * sr)
    t = np.arange(n) / sr
    rng = np.random.default_rng(seed)
    nyq = sr / 2.0
    out = np.zeros((n_variants, n))
    for v in range(n_variants):
        sig = np.zeros(n)
        for k in range(1, n_partials + 1):
            fk = freq_hz * k * np.sqrt(1.0 + inharmonicity * k * k)
            if fk >= nyq * 0.99:
                break
            amp = (brightness ** (k - 1)) / k
            amp *= rng.uniform(0.6, 1.4)
            dk = decay * (1.0 + 0.3 * (k - 1))
            phase = rng.uniform(0, 2 * np.pi)
            sig += amp * np.exp(-dk * t) * np.sin(2 * np.pi * fk * t + phase)
        # short attack transient: filtered noise burst
        atk = int(0.01 * sr)
        noise = rng.normal(0, 0.3, atk) * np.linspace(1, 0, atk)
        sig[:atk] += noise
        out[v] = sig
    peak = np.abs(out).max(axis=1, keepdims=True) + 1e-12
    return (out / peak).astype(np.float32)


def fm_pluck(freq_hz: float, sr: int, duration: float,
             n_variants: int = 1, mod_ratio: float = 3.0,
             mod_index: float = 2.0, decay: float = 4.0,
             seed: int = 0) -> np.ndarray:
    """(n_variants, n) FM plucks: carrier at f modulated at mod_ratio·f
    with an exponentially decaying modulation index — a bell-ish plucked
    timbre that neither KS nor additive produces; the `all3` recipe
    renders a third of each class with it."""
    n = int(duration * sr)
    t = np.arange(n) / sr
    rng = np.random.default_rng(seed)
    out = np.zeros((n_variants, n))
    for v in range(n_variants):
        # integer carrier:modulator ratio keeps every sideband ON the f0
        # harmonic grid — the timbre is unseen but the pitch label stays
        # unambiguous (non-integer ratios make inharmonic audio whose
        # "true" pitch is genuinely undefined)
        ratio = float(round(mod_ratio))
        idx = mod_index * rng.uniform(0.7, 1.3)
        dk = decay * rng.uniform(0.8, 1.2)
        phase = rng.uniform(0, 2 * np.pi)
        mod = idx * np.exp(-2.0 * dk * t) * np.sin(
            2 * np.pi * freq_hz * ratio * t)
        out[v] = np.exp(-dk * t) * np.sin(
            2 * np.pi * freq_hz * t + mod + phase)
        atk = int(0.005 * sr)
        out[v, :atk] *= np.linspace(0, 1, atk)
    peak = np.abs(out).max(axis=1, keepdims=True) + 1e-12
    return (out / peak).astype(np.float32)


def _time_warp(sig: np.ndarray, sr: int, cents: np.ndarray) -> np.ndarray:
    """Resample `sig` along a time-varying pitch trajectory: reading the
    signal faster by ratio r(t) = 2^(cents(t)/1200) raises the pitch by
    that many cents at time t (linear interpolation; clips are short so
    the cumulative warp stays well inside the signal)."""
    rate = 2.0 ** (np.asarray(cents, np.float64) / 1200.0)
    pos = np.concatenate([[0.0], np.cumsum(rate)[:-1]])
    pos = np.clip(pos, 0, len(sig) - 1)
    return np.interp(pos, np.arange(len(sig)), sig).astype(sig.dtype)


def apply_vibrato(sig: np.ndarray, sr: int, depth_cents: float = 25.0,
                  rate_hz: float = 5.5, seed: int = 0) -> np.ndarray:
    """Sinusoidal pitch modulation (fretting-hand vibrato)."""
    rng = np.random.default_rng(seed)
    t = np.arange(len(sig)) / sr
    phase = rng.uniform(0, 2 * np.pi)
    return _time_warp(sig, sr, depth_cents * np.sin(
        2 * np.pi * rate_hz * t + phase))


def apply_pitch_bend(sig: np.ndarray, sr: int, bend_cents: float = 40.0,
                     settle_s: float = 0.15) -> np.ndarray:
    """Start `bend_cents` off pitch and glide to the target over
    `settle_s` (string settling / bend release). Positive = start sharp."""
    t = np.arange(len(sig)) / sr
    env = np.clip(1.0 - t / max(settle_s, 1e-6), 0.0, 1.0)
    return _time_warp(sig, sr, bend_cents * env)


def apply_tremolo(sig: np.ndarray, sr: int, depth: float = 0.5,
                  rate_hz: float = 6.0, seed: int = 0) -> np.ndarray:
    """Amplitude modulation (tremolo / uneven pick dynamics)."""
    rng = np.random.default_rng(seed)
    t = np.arange(len(sig)) / sr
    phase = rng.uniform(0, 2 * np.pi)
    env = 1.0 - depth * 0.5 * (1 + np.sin(2 * np.pi * rate_hz * t + phase))
    return (sig * env).astype(sig.dtype)


def apply_palm_mute(sig: np.ndarray, sr: int, decay_s: float = 0.12,
                    tone: float = 0.35) -> np.ndarray:
    """Palm-muted / staccato articulation: the picking-hand palm damps
    the string, so the note both decays fast and loses high partials.
    Exponential gain with time constant `decay_s` into a second-order
    lowpass (two cascaded one-poles; `tone` in (0, 1], smaller =
    darker — one pole alone barely dents the attack transient's
    high-frequency share)."""
    from scipy.signal import lfilter
    t = np.arange(len(sig)) / sr
    y = sig * np.exp(-t / max(decay_s, 1e-3))
    for _ in range(2):
        y = lfilter([tone], [1.0, tone - 1.0], y)
    return y.astype(sig.dtype)


_STRESSORS = {
    "vibrato": lambda s, sr, rng: apply_vibrato(
        s, sr, depth_cents=rng.uniform(15, 35),
        rate_hz=rng.uniform(4, 7), seed=rng.integers(1 << 31)),
    "bend": lambda s, sr, rng: apply_pitch_bend(
        s, sr, bend_cents=rng.uniform(-45, 45),
        settle_s=rng.uniform(0.08, 0.2)),
    "detune": lambda s, sr, rng: _time_warp(
        s, sr, np.full(len(s), rng.uniform(-25, 25))),
    "tremolo": lambda s, sr, rng: apply_tremolo(
        s, sr, depth=rng.uniform(0.3, 0.7),
        rate_hz=rng.uniform(4, 8), seed=rng.integers(1 << 31)),
    "palm_mute": lambda s, sr, rng: apply_palm_mute(
        s, sr, decay_s=rng.uniform(0.08, 0.18),
        tone=rng.uniform(0.2, 0.4)),
}

# 'mix' draws from this FROZEN tuple, not _STRESSORS' keys: published
# seeded mix streams (the canonical training recipe) must not move when
# an eval-only stressor is added later
_MIX_KEYS = ("vibrato", "bend", "detune", "tremolo")

_FAMILIES = ("ks", "additive", "fm", "all3")


def _variant_seed(seed: int, ci: int, i: int,
                  variants_per_class: int) -> int:
    """Injective per-(class, variant) rng seed for the dataset writers
    (synth + modal). stride=100 reproduces the historical
    `seed*100000 + ci*100 + i` streams for variants_per_class <= 100
    (the shipped checkpoints and every published eval set); larger
    runs widen the stride — and the per-seed block with it — so
    (class, variant) pairs can never alias across classes or seeds.

    Scope: the guarantee covers THIS scheme's outputs. The KS renderer
    uses a separate legacy stream (`seed*1000 + ci`, see
    synthesize_note_dataset) whose values can coincide with this
    scheme's at small seeds (seed=0: KS class ci vs class 0's variant
    ci) — kept verbatim because the shipped checkpoints were trained
    from it; the coincidence seeds two DIFFERENT synthesis algorithms
    (delay-line burst vs FM/additive parameter draws), so the shared
    bitstream produces unrelated audio, not duplicate samples."""
    stride = max(100, variants_per_class)
    return seed * stride * 1000 + ci * stride + i


def synthesize_note_dataset(out_root, class_names=None, sr: int = 22050,
                            duration: float = 0.5,
                            variants_per_class: int = 24,
                            seed: int = 0, verbose: bool = True,
                            noise_snr_db: tuple[float, float] | None = None,
                            family: str = "mixed",
                            stressor: str | None = None,
                            stressor_prob: float = 1.0,
                            channel: str | None = None,
                            channel_prob: float = 1.0) -> Path:
    """Write `<out_root>/<label>/<label>_<i>.wav` for each SPN class.

    Per-variant augmentation: synth engine, amplitude 0.1–0.9, and a low
    noise floor for every variant; ±10-cent detune plus per-variant
    brightness/decay (additive) or mod ratio/index (FM) draws for the
    spectral engines. Karplus-Strong variants instead differ in their
    noise-burst excitation and share one damping/blend draw per class:
    the delay line quantizes pitch to an integer period, so a ±10-cent
    detune would mostly round away — KS pitch spread comes from the
    period quantization itself, timbre spread from the burst.

    noise_snr_db=(lo, hi): additionally mix white noise into a random
    half of the variants at an SNR drawn uniformly from [lo, hi] dB —
    noise-robustness augmentation for the classifiers.

    family: 'mixed' (half KS, half additive), a single engine — 'ks',
    'additive', or 'fm' — for generator-disjoint train/eval splits, or
    'all3' (one third each of KS, FM, additive — the shipped training
    recipe; the held-out evaluation family is the code-disjoint modal
    renderer in data/modal.py).

    stressor: None, a key of {vibrato, bend, detune, tremolo,
    palm_mute}, or 'mix' (mix draws from the frozen _MIX_KEYS four)
    (random stressor per variant) — playing-style perturbations for
    off-distribution evaluation, or (with stressor_prob < 1) training
    augmentation that keeps a clean fraction of the variants.

    channel: None, a key of data/channel.py's CHANNELS (room_ir,
    pickup_eq, bg_noise), 'mix', or 'full_chain' — acquisition-chain
    stressors applied after the playing-style stressor. rng draws are
    consumed only when set, so seeded no-channel sets reproduce exactly
    across versions."""
    out_root = Path(out_root)
    class_names = class_names or DEFAULT_CLASS_NAMES
    if family not in _FAMILIES + ("mixed",):
        raise ValueError(f"unknown family {family!r}; "
                         f"choose from {('mixed',) + _FAMILIES}")
    if stressor is not None and stressor != "mix" \
            and stressor not in _STRESSORS:
        raise ValueError(f"unknown stressor {stressor!r}; choose from "
                         f"{tuple(_STRESSORS)} or 'mix'")
    if not 0.0 <= stressor_prob <= 1.0:
        raise ValueError(f"stressor_prob must be in [0, 1], "
                         f"got {stressor_prob}")
    if not 0.0 <= channel_prob <= 1.0:
        raise ValueError(f"channel_prob must be in [0, 1], "
                         f"got {channel_prob}")
    if channel is not None:
        # validate upfront like stressor: a typo'd name must not surface
        # mid-generation and leave a partially written dataset dir
        from .channel import CHANNELS
        valid = tuple(CHANNELS) + ("mix", "mix_chain", "full_chain")
        if channel not in valid:
            raise ValueError(f"unknown channel {channel!r}; "
                             f"choose from {valid}")
    if stressor_prob == 0.0:
        stressor = None  # identical output AND rng stream to no-stressor
    if channel_prob == 0.0:
        channel = None
    rng = np.random.default_rng(seed)
    pending = []  # (path, sig, sr) per class, batch-encoded
    for ci, name in enumerate(class_names):
        f0 = float(midi_to_hz(note_to_midi(name)))
        folder = out_root / name
        folder.mkdir(parents=True, exist_ok=True)
        n_ks = (variants_per_class // 2 if family == "mixed"
                else variants_per_class // 3 if family == "all3"
                else variants_per_class if family == "ks" else 0)
        # all3: the third after the KS block renders FM, the rest additive
        n_fm_end = (2 * variants_per_class // 3 if family == "all3"
                    else variants_per_class if family == "fm" else 0)
        detune = 2.0 ** (rng.uniform(-10, 10, variants_per_class) / 1200.0)
        # draw KS params unconditionally (keeps the rng stream identical
        # across families), but only pay the delay-line loop when used
        damping = float(rng.uniform(0.992, 0.999))
        blend = float(rng.uniform(0.45, 0.55))
        ks = (karplus_strong(f0, sr, duration, n_variants=n_ks,
                             damping=damping, blend=blend,
                             seed=seed * 1000 + ci)
              if n_ks > 0 else None)
        for i in range(variants_per_class):
            if i < n_ks:
                sig = ks[i]
            elif i < n_fm_end:
                sig = fm_pluck(f0 * detune[i], sr, duration, n_variants=1,
                               mod_ratio=float(rng.uniform(2.0, 4.0)),
                               mod_index=float(rng.uniform(1.0, 3.0)),
                               seed=_variant_seed(seed, ci, i,
                                                  variants_per_class))[0]
            else:
                sig = additive_pluck(
                    f0 * detune[i], sr, duration, n_variants=1,
                    brightness=float(rng.uniform(0.55, 0.9)),
                    decay=float(rng.uniform(1.5, 5.0)),
                    seed=_variant_seed(seed, ci, i, variants_per_class))[0]
            # short-circuit: prob=1.0 must not consume an rng draw, so
            # seeded stressor eval sets reproduce across versions
            if stressor is not None and (stressor_prob >= 1.0
                                         or rng.random() < stressor_prob):
                which = (stressor if stressor != "mix" else
                         _MIX_KEYS[int(rng.integers(len(_MIX_KEYS)))])
                sig = _STRESSORS[which](sig, sr, rng)
            if channel is not None and (channel_prob >= 1.0
                                        or rng.random() < channel_prob):
                from .channel import apply_channel
                sig = apply_channel(sig, sr, channel, rng)
            amp = rng.uniform(0.1, 0.9)
            sig = sig * amp + rng.normal(0, 1e-4, len(sig))
            if noise_snr_db is not None and rng.random() < 0.5:
                snr = rng.uniform(*noise_snr_db)
                sig_rms = np.sqrt(np.mean(sig ** 2)) + 1e-12
                noise = rng.normal(0, 1.0, len(sig))
                noise *= sig_rms / (np.sqrt(np.mean(noise ** 2)) + 1e-12)
                sig = sig + noise * 10.0 ** (-snr / 20.0)
            pending.append((folder / f"{name.replace('#', 's')}_{i:03d}.wav",
                            sig.astype(np.float32), sr))
        write_wav_batch(pending)
        pending.clear()
        if verbose and ci % 10 == 0:
            print(f"[synthesize_note_dataset] {ci + 1}/{len(class_names)} "
                  f"classes done")
    if verbose:
        print(f"[synthesize_note_dataset] wrote "
              f"{len(class_names) * variants_per_class} clips to {out_root}")
    return out_root
