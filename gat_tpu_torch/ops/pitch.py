"""Pitch unit conversions and Scientific Pitch Notation names.

Dataset labels use the ASCII '#'; `midi_to_note` gives librosa's Unicode
'♯' by default, as the reference's DSP baseline does.
"""
from __future__ import annotations

import numpy as np

__all__ = ["hz_to_midi", "midi_to_hz", "midi_to_note", "note_to_midi",
           "STANDARD_TUNING_MIDI", "string_fret_to_note"]

_PITCH_CLASSES_UNICODE = ["C", "C♯", "D", "D♯", "E", "F", "F♯", "G", "G♯",
                          "A", "A♯", "B"]
_PITCH_CLASSES_ASCII = ["C", "C#", "D", "D#", "E", "F", "F#", "G", "G#",
                        "A", "A#", "B"]

# standard-tuning guitar: open-string MIDI numbers, string 1 = high E
STANDARD_TUNING_MIDI = {1: 64, 2: 59, 3: 55, 4: 50, 5: 45, 6: 40}


def hz_to_midi(hz):
    """12 · log2(hz / 440) + 69, on the host in numpy."""
    return 12.0 * (np.log2(np.asarray(hz)) - np.log2(440.0)) + 69.0


def midi_to_hz(midi):
    """440 · 2^((midi − 69) / 12), in float64 (the synthesizers' pitch)."""
    return 440.0 * 2.0 ** ((np.asarray(midi, dtype=np.float64) - 69.0)
                           / 12.0)


def midi_to_note(midi: int, unicode: bool = True) -> str:
    """MIDI number → SPN name, e.g. 40 → 'E2' (octave, no cents)."""
    midi = int(round(midi))
    table = _PITCH_CLASSES_UNICODE if unicode else _PITCH_CLASSES_ASCII
    return f"{table[midi % 12]}{midi // 12 - 1}"


def note_to_midi(name: str) -> int:
    """SPN name → MIDI number. Accepts '#'/'♯' and 'b'/'♭'; accidentals
    carry across the octave boundary ('Cb4' is 59, 'B#3' is 60)."""
    s = name.strip()
    idx = _PITCH_CLASSES_ASCII.index(s[0].upper())
    rest = s[1:]
    while rest and rest[0] in "#♯b♭":
        idx += 1 if rest[0] in "#♯" else -1
        rest = rest[1:]
    return (int(rest) + 1) * 12 + idx


def string_fret_to_note(string: int, fret: int, unicode: bool = False) -> str:
    """Guitar (string, fret) → SPN label under standard tuning."""
    return midi_to_note(STANDARD_TUNING_MIDI[string] + fret, unicode=unicode)
