"""Segmentation of the file path: gating and onset slicing."""
from .gating import gate_waveform, rms_gate, sample_db_gate  # noqa: F401
from .slicing import (AudioSlicer, segment_waveform,  # noqa: F401
                      slice_at_onsets)
