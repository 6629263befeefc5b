#!/usr/bin/env python
"""Exploratory data analysis tools of the PyTorch port, the twin of
`tools/eda.py`. Three analyses, each on `--device` (`cuda`, the default,
raises without a card; `cpu` runs the plain PyTorch versions):

  * dataset:  label distribution (bar chart to PNG when matplotlib is
    available) + per-wav amplitude stats; the loader resamples on the
    device
  * slices:   slice one file into a temp dir and report per-slice stats
    (the onset kernels K4 and K5 on the card); auditioning through
    speakers is gated on sounddevice
  * features: extract MFCC features for a dataset (the front-end kernels
    K2 and K3 on the card) and print the feature report

On the CPU the counts, per-WAV stats and audio report equal the JAX
tool's and the feature report's numbers are within the MFCC features'
1e-3 of it (tests/test_torch_tools.py).

Usage:
  python tools/torch_eda.py dataset --root <dataset> [--device cpu]
  python tools/torch_eda.py slices --audio <wav> [--play]
  python tools/torch_eda.py features --root <dataset>
"""
from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def dataset_analysis(root: Path, plot_path: Path | None = None,
                     device: str = "cuda") -> dict:
    from gat_tpu_torch.data.loader import AudioDatasetLoader
    from gat_tpu_torch.features import encode_labels
    from gat_tpu_torch.utils.reports import audio_report

    loader = AudioDatasetLoader([root], target_sr=22050, device=device)
    wavs, srs, labels, paths = loader.load_audio_dataset(pad_to_max=False)
    y, num_classes, reverse_map = encode_labels(labels)
    report = audio_report(loader, y, reverse_map, sample_paths=True)

    counts: dict[str, int] = {}
    for l in labels:
        counts[l] = counts.get(l, 0) + 1
    print("\nLabel distribution:")
    for name in sorted(counts):
        print(f"  {name:>4}: {'█' * counts[name]} {counts[name]}")

    stats = []
    for w, p in zip(wavs, paths):
        stats.append({"path": p, "mean": float(np.mean(w)),
                      "std": float(np.std(w)), "var": float(np.var(w)),
                      "min": float(np.min(w)), "max": float(np.max(w))})
    print(f"\nPer-wav stats (first 5 of {len(stats)}):")
    for s in stats[:5]:
        print(f"  {Path(s['path']).name}: std={s['std']:.4f} "
              f"min={s['min']:.3f} max={s['max']:.3f}")

    if plot_path is not None:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            fig, ax = plt.subplots(figsize=(12, 4))
            names = sorted(counts)
            ax.bar(names, [counts[n] for n in names])
            ax.set_title("Label distribution")
            ax.tick_params(axis="x", rotation=45)
            fig.savefig(plot_path, dpi=100, bbox_inches="tight")
            plt.close(fig)
            print(f"label distribution chart → {plot_path}")
        except Exception as e:
            print(f"(no chart: {e})")
    return {"report": report, "counts": counts, "stats": stats}


def slice_analysis(audio_path: Path, play: bool = False,
                   device: str = "cuda") -> list[dict]:
    from gat_tpu_torch.segment.slicing import AudioSlicer
    from gat_tpu_torch.utils.wavio import read_wav

    slicer = AudioSlicer(device=device)
    out: list[dict] = []
    with tempfile.TemporaryDirectory() as tmp:
        slicer.slice_and_save(audio_path, tmp, verbose=True)
        for clip_path in sorted(Path(tmp).glob("*.wav")):
            clip, sr = read_wav(clip_path)
            info = {"clip": clip_path.name, "sr": sr,
                    "duration": len(clip) / sr,
                    "rms": float(np.sqrt(np.mean(clip ** 2))),
                    "peak": float(np.abs(clip).max())}
            out.append(info)
            print(info)
            if play:
                try:
                    import sounddevice as sd
                    sd.play(clip, sr)
                    sd.wait()
                except Exception as e:
                    # not just ImportError: a present-but-unusable
                    # sounddevice (headless box → PortAudioError) must
                    # degrade to stats-only, not abort the analysis loop
                    print(f"(audition unavailable: {e}; skipping)")
                    play = False
    return out


def feature_matrix(root: Path, device: str = "cuda") -> tuple:
    """(X, y, reverse_map): the dataset's 65-dim MFCC-and-pitch vectors."""
    from gat_tpu_torch.data.loader import AudioDatasetLoader
    from gat_tpu_torch.features import FeatureBuilder

    loader = AudioDatasetLoader([root], target_sr=11025, duration=0.5,
                                device=device)
    builder = FeatureBuilder(device=device)
    X, y, num_classes, reverse_map = builder.extract_mfcc_features(
        loader, n_mfcc=64, normalize_audio_volume=True)
    return X, y, reverse_map


def feature_analysis(root: Path, device: str = "cuda") -> dict:
    from gat_tpu_torch.utils.reports import feature_report

    return feature_report(*feature_matrix(root, device))


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("dataset")
    p.add_argument("--root", type=Path, required=True)
    p.add_argument("--plot", type=Path, default=None)
    p = sub.add_parser("slices")
    p.add_argument("--audio", type=Path, required=True)
    p.add_argument("--play", action="store_true")
    p = sub.add_parser("features")
    p.add_argument("--root", type=Path, required=True)
    for p in sub.choices.values():
        p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                       help="cuda (the default) needs a card and raises "
                            "without one; cpu runs the plain PyTorch path")
    args = ap.parse_args(argv)

    if args.cmd == "dataset":
        dataset_analysis(args.root, args.plot, device=args.device)
    elif args.cmd == "slices":
        slice_analysis(args.audio, args.play, device=args.device)
    elif args.cmd == "features":
        feature_analysis(args.root, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
