"""Dataset discovery and batched audio loading, the twin of
`gat_tpu/data/loader.py`.

Labels come from folder names (`<dataset>/<label>/*.wav`). The WAVs are
decoded on host threads (`utils/native_wav.read_wav_batch`), then
resampled to `target_sr` and pad/trimmed to a fixed length on the
loader's device, one batched `ops/resample.resample` per (source rate,
shape) group, so each distinct rate ratio is one call.
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from ..ops.resample import fix_length, resample
from ..utils.device import resolve_device
from ..utils.wavio import read_wav

__all__ = ["get_available_datasets", "AudioDatasetLoader"]


def get_available_datasets(datasets_root):
    """Two-level walk: datasets_root/<subroot>/<dataset> → names, paths."""
    datasets_root = Path(datasets_root)
    if not datasets_root.exists():
        print(f"[get_available_datasets] Dataset directory not found: "
              f"{datasets_root}")
        return [], []
    names, paths = [], []
    for subroot in sorted(datasets_root.iterdir()):
        if not subroot.is_dir() or subroot.name.startswith("."):
            continue
        for ds in sorted(subroot.iterdir()):
            if ds.is_dir() and not ds.name.startswith("."):
                names.append(f"{subroot.name}/{ds.name}")
                paths.append(ds)
    if not names:
        print(f"[get_available_datasets] No datasets found under "
              f"{datasets_root}")
    return names, paths


class AudioDatasetLoader:
    """Loads `<root>/<label-folder>/*.wav` with label = folder name.
    Returns float32 arrays at `target_sr`. `device` (default the card)
    runs the resampling; 'cpu' runs it on the host."""

    def __init__(self, dataset_roots, target_sr: int = 11025,
                 mono: bool = True, duration: float | None = None,
                 device=None):
        self.dataset_roots = [Path(r) for r in dataset_roots]
        self.target_sr = int(target_sr)
        self.mono = mono
        self.fixed_len = (int(self.target_sr * duration)
                          if duration is not None else None)
        self.device = resolve_device(device)
        self._load_cache: dict[bool, tuple] = {}
        # per-file SOURCE sample rates, recorded by load_audio_dataset (the
        # returned rates are all target_sr)
        self.source_srs: list[int] | None = None

    def iter_paths(self):
        for root in self.dataset_roots:
            for folder in sorted(os.listdir(root)):
                folder_path = root / folder
                if not folder_path.is_dir():
                    continue
                for fname in sorted(os.listdir(folder_path)):
                    if fname.endswith(".wav"):
                        yield folder_path / fname, folder

    def load_audio_dataset(self, pad_to_max: bool = True):
        """Returns (wavs, srs, labels, paths): wavs is a list of float32
        arrays (all target_sr); pad_to_max zero-pads to the longest.

        Memoized per instance (training both models on one dataset reads
        it once), and the returned arrays are read-only, since every
        consumer shares them. Build a new loader to re-read a changed
        directory; TrainingManager does so by a walk signature."""
        if pad_to_max in self._load_cache:
            return self._load_cache[pad_to_max]
        pairs = list(self.iter_paths())
        if not pairs:
            raise FileNotFoundError(
                "load_audio_dataset: No audio files found.")
        labels = [label for _, label in pairs]
        paths = [str(p) for p, _ in pairs]
        if self.mono:
            from ..utils.native_wav import read_wav_batch
            decoded = read_wav_batch([p for p, _ in pairs])
        else:
            # read_wav(mono=False) gives (n, channels); resample and
            # fix_length act on the last axis, and the reference's layout
            # is channels-first, so time goes last
            decoded = [(x.T if x.ndim == 2 else x, sr)
                       for x, sr in (read_wav(p, mono=False)
                                     for p, _ in pairs)]
        raw = [x for x, _ in decoded]
        srs_in = [sr for _, sr in decoded]
        self.source_srs = list(srs_in)

        # one resample per (source rate, shape): stereo files with other
        # channel counts do not stack
        wavs: list[np.ndarray | None] = [None] * len(raw)
        groups: dict[tuple, list[int]] = {}
        for i, (x, sr) in enumerate(zip(raw, srs_in)):
            groups.setdefault((sr,) + tuple(x.shape), []).append(i)
        for (sr, *_shape), idxs in groups.items():
            batch = torch.from_numpy(np.stack([raw[i] for i in idxs])
                                     .astype(np.float32, copy=False))
            out = resample(batch.to(self.device), sr, self.target_sr)
            if self.fixed_len is not None:
                out = fix_length(out, self.fixed_len)
            out = out.cpu().numpy()
            for j, i in enumerate(idxs):
                wavs[i] = np.array(out[j], dtype=np.float32)

        if pad_to_max:
            # pad the time axis only (mono arrays are 1-D, stereo
            # (channels, n))
            max_len = max(int(w.shape[-1]) for w in wavs)
            wavs = [np.pad(w, [(0, 0)] * (w.ndim - 1)
                           + [(0, max_len - int(w.shape[-1]))])
                    for w in wavs]
        for w in wavs:
            w.setflags(write=False)
        srs = [self.target_sr] * len(wavs)
        self._load_cache[pad_to_max] = (wavs, srs, labels, paths)
        return self._load_cache[pad_to_max]
