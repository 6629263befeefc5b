"""Eval-only modal-string renderer, the port's copy of
`gat_tpu/data/modal.py`: the held-out synthesis family.

The shipped models train on the three `data/synth.py` families (KS,
additive, FM), so an unseen-timbre evaluation needs a fourth family that
is code-disjoint from the training synthesizer. This module is it, and it
must never be used to make training data: `render_modal_dataset` drops an
`EVAL_ONLY.json` marker into every dataset it writes, before any audio,
and `TrainingManager._choose_dataset` refuses any dataset carrying it.

A short noise-burst excitation, shaped by pick hardness and comb-filtered
by pick position, drives a bank of two-pole resonator filters (one per
string mode, on the harmonic grid k·f0), and the summed output passes a
fixed guitar-body filter (Helmholtz and plate resonances, a low cut).
Every draw is made in the reference's order, so a seeded evaluation set
is the same bytes from either package.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
from scipy import signal

from ..ops.pitch import midi_to_hz, note_to_midi

__all__ = ["modal_pluck", "render_modal_dataset", "EVAL_ONLY_MARKER"]

# written into every rendered dataset dir; TrainingManager refuses to
# train on a dataset carrying it (the runtime guard behind the
# "must NEVER be used to generate training data" contract above)
EVAL_ONLY_MARKER = "EVAL_ONLY.json"


def _resonator_sos(freq_hz: float, decay_s: float, sr: int) -> np.ndarray:
    """One second-order section whose impulse response decays to 1/e in
    `decay_s` seconds while ringing at `freq_hz`."""
    r = float(np.exp(-1.0 / (max(decay_s, 1e-3) * sr)))
    th = 2.0 * np.pi * freq_hz / sr
    # unity-ish peak gain normalization: scale by (1 - r)
    b0 = (1.0 - r) * np.sin(th)
    return np.array([[b0, 0.0, 0.0, 1.0, -2.0 * r * np.cos(th), r * r]])


def _body_sos(sr: int) -> np.ndarray:
    """Fixed acoustic-body coloration: 70 Hz high-pass, Helmholtz air
    resonance ~105 Hz, top-plate resonances ~210 and ~420 Hz."""
    sections = [signal.butter(2, 70.0 / (sr / 2), "highpass",
                              output="sos")]
    # RBJ peaking biquads via the channel module's helper — filter
    # plumbing is shareable under the disjointness contract (only the
    # training-synth ENGINES are forbidden)
    from .channel import _peaking_sos
    for f0, q, gain_db in ((105.0, 9.0, 8.0), (210.0, 7.0, 5.0),
                           (420.0, 5.0, 3.0)):
        sections.append(_peaking_sos(f0, q, gain_db, sr))
    return np.concatenate(sections, axis=0)


def modal_pluck(freq_hz: float, sr: int, duration: float,
                n_variants: int = 1, n_modes: int = 36,
                seed: int = 0) -> np.ndarray:
    """(n_variants, n) modal plucks at one pitch.

    Per variant: draw pick position, pick hardness, and a string decay
    profile; synthesize a shaped noise-burst excitation; run it through
    every mode's resonator; sum with comb-position weights; apply the
    body filter; normalize."""
    n = int(duration * sr)
    rng = np.random.default_rng(seed)
    nyq = sr / 2.0
    k_max = int(min(n_modes, np.floor(nyq * 0.95 / freq_hz)))
    k_max = max(k_max, 1)
    out = np.zeros((n_variants, n))
    body = _body_sos(sr)
    t = np.arange(n) / sr

    for v in range(n_variants):
        pick_pos = rng.uniform(0.10, 0.35)       # fraction of string length
        hardness = rng.uniform(0.3, 1.0)         # 1 = hard pick (bright)
        tau0 = rng.uniform(0.25, 0.8)            # fundamental decay (s)
        damp_slope = rng.uniform(0.5, 1.5)       # how fast highs die

        # excitation: 4-8 ms noise burst, low-passed by pick softness
        burst_n = int(rng.uniform(0.004, 0.008) * sr)
        exc = np.zeros(n)
        exc[:burst_n] = (rng.normal(0.0, 1.0, burst_n)
                         * np.hanning(2 * burst_n)[burst_n:])
        lp_cut = 1500.0 + 6000.0 * hardness
        lp = signal.butter(2, min(lp_cut / nyq, 0.99), "lowpass",
                           output="sos")
        exc = signal.sosfilt(lp, exc)

        sig = np.zeros(n)
        for k in range(1, k_max + 1):
            fk = freq_hz * k
            # comb weighting from the pluck point + mild spectral tilt
            w = abs(np.sin(np.pi * k * pick_pos)) / k ** 0.5
            w *= rng.uniform(0.75, 1.25)
            tau_k = tau0 / (1.0 + damp_slope * (k - 1) * 0.3)
            sos = _resonator_sos(fk, tau_k, sr)
            sig += w * signal.sosfilt(sos, exc)[..., :n]
        sig = signal.sosfilt(body, sig)
        # faint sympathetic shimmer: amplitude-modulate highs slightly
        sig *= 1.0 + 0.02 * np.sin(2 * np.pi * rng.uniform(0.5, 2.0) * t)
        out[v] = sig
    peak = np.abs(out).max(axis=1, keepdims=True) + 1e-12
    return (out / peak).astype(np.float32)


def render_modal_dataset(out_root, class_names=None, sr: int = 22050,
                         duration: float = 0.5,
                         variants_per_class: int = 8, seed: int = 0,
                         stressor: str | None = None,
                         channel: str | None = None,
                         verbose: bool = False) -> Path:
    """Write `<out_root>/<label>/<label>_<i>.wav` — same dataset layout as
    the training writer, but rendered exclusively
    by the modal engine. `stressor` reuses synth.py's playing-style
    perturbations (they are post-render warps, not renderers);
    `channel` applies data/channel.py acquisition stressors (room IR,
    pickup EQ, background noise)."""
    from .synth import (_MIX_KEYS, _STRESSORS, DEFAULT_CLASS_NAMES,
                        _variant_seed)
    from ..utils.native_wav import write_wav_batch

    out_root = Path(out_root)
    class_names = class_names or DEFAULT_CLASS_NAMES
    if stressor is not None and stressor != "mix" \
            and stressor not in _STRESSORS:
        raise ValueError(f"unknown stressor {stressor!r}")
    if channel is not None:
        # validate upfront like stressor (and like synth.py's writer): a
        # typo'd channel name must not surface mid-generation and leave
        # a partially written, marker-bearing dataset dir on disk
        from .channel import CHANNELS
        valid = tuple(CHANNELS) + ("mix", "mix_chain", "full_chain")
        if channel not in valid:
            raise ValueError(f"unknown channel {channel!r}; "
                             f"choose from {valid}")
    rng = np.random.default_rng(seed)
    # held-out-family marker FIRST, before any audio exists: an
    # interrupted render must never leave a valid-looking but unmarked
    # dataset that TrainingManager._refuse_eval_only would accept —
    # the marker's whole job is to make that leak impossible
    out_root.mkdir(parents=True, exist_ok=True)
    (out_root / EVAL_ONLY_MARKER).write_text(
        '{"eval_only": true, "renderer": "modal", "reason": '
        '"held-out evaluation family - see gat_tpu/data/modal.py"}\n')
    pending = []
    for ci, name in enumerate(class_names):
        f0 = float(midi_to_hz(note_to_midi(name)))
        folder = out_root / name
        folder.mkdir(parents=True, exist_ok=True)
        detune = 2.0 ** (rng.uniform(-10, 10, variants_per_class) / 1200.0)
        for i in range(variants_per_class):
            sig = modal_pluck(f0 * detune[i], sr, duration, n_variants=1,
                              seed=_variant_seed(seed, ci, i,
                                                 variants_per_class))[0]
            if stressor is not None:
                # 'mix' draws from synth.py's FROZEN _MIX_KEYS tuple, not
                # _STRESSORS' live keys: published seeded modal eval sets
                # must not move when a stressor is added later, and the
                # mix population must match synth 'mix' (no palm_mute)
                which = (stressor if stressor != "mix" else
                         _MIX_KEYS[int(rng.integers(len(_MIX_KEYS)))])
                sig = _STRESSORS[which](sig, sr, rng)
            if channel is not None:
                from .channel import apply_channel
                sig = apply_channel(sig, sr, channel, rng)
            amp = rng.uniform(0.1, 0.9)
            sig = (sig * amp + rng.normal(0, 1e-4, len(sig))).astype(
                np.float32)
            pending.append(
                (folder / f"{name.replace('#', 's')}_{i:03d}.wav", sig, sr))
        write_wav_batch(pending)
        pending.clear()
        if verbose and ci % 10 == 0:
            print(f"[render_modal_dataset] {ci + 1}/{len(class_names)}")
    return out_root
