#!/usr/bin/env python
"""Dataset creation tool of the PyTorch port, the twin of
`tools/dataset_creator.py`. Workflow:

  1. slice-all:  walk `<raw_root>/String_<s>/Fret_<f>/*.wav` recordings,
     slice each into note clips (44.1 kHz, 1.0 s, no attack skip, the
     tool's older slicing profile), writing
     `<clips_root>/String_<s>/Fret_<f>/` clip folders. The slicer
     (`gat_tpu_torch.segment.slicing.AudioSlicer`) runs on `--device`:
     the onset kernels K4 and K5 on the card (`cuda`, the default, which
     raises without a card), their plain versions with `cpu`.
  2. pitch-dataset: map (string, fret) → SPN pitch under standard tuning
     (E2=40 on string 6) and copy clips into `<dataset_root>/<pitch>/`
     folders with traceable names.
  3. count: tally clips per folder.
  4. synth: generate a fully synthetic labeled dataset (no recordings
     needed) via gat_tpu_torch.data.synth.

On the CPU the onsets, file names and clip bytes equal the JAX tool's
(tests/test_torch_tools.py).

Usage:
  python tools/torch_dataset_creator.py slice-all --raw raw/ --clips clips/ [--device cpu]
  python tools/torch_dataset_creator.py pitch-dataset --clips clips/ --out ds/
  python tools/torch_dataset_creator.py count --root ds/
  python tools/torch_dataset_creator.py synth --out ds/ [--variants 24]
"""
from __future__ import annotations

import argparse
import re
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def slice_all_clips(raw_root: Path, clips_root: Path, sr: int = 44100,
                    clip_len: float = 1.0, max_onsets: int = 128,
                    device: str = "cuda") -> int:
    """Slice every String_*/Fret_* recording into clips."""
    from gat_tpu_torch.segment.slicing import AudioSlicer
    slicer = AudioSlicer(device=device)
    total = 0
    for rec in sorted(raw_root.glob("String_*/Fret_*/*.wav")):
        out_dir = clips_root / rec.parent.parent.name / rec.parent.name
        onsets = slicer.slice_and_save(
            rec, out_dir, target_sr=sr, length_sec=clip_len,
            attack_skip_sec=0.0, max_onsets=max_onsets, verbose=False)
        total += len(onsets)
        print(f"[slice_all_clips] {rec} → {len(onsets)} onsets")
    print(f"[slice_all_clips] total onsets: {total}")
    return total


def create_pitch_dataset(clips_root: Path, out_root: Path) -> int:
    """Copy String_s/Fret_f clips into `<pitch>/` label folders."""
    from gat_tpu_torch.ops.pitch import string_fret_to_note
    n = 0
    skipped = 0
    for clip in sorted(clips_root.glob("String_*/Fret_*/*.wav")):
        # parse the two LABEL path components, never the full path: an
        # ancestor dir named e.g. String_12_sessions above clips_root
        # would otherwise poison every clip's (s, f). fullmatch, not
        # match: the glob also admits String_old/ (crash on int()) and
        # String_12_backup/ (silently mislabeled as string 12); skip
        # such folders loudly instead
        ms = re.fullmatch(r"String_(\d+)", clip.parts[-3])
        mf = re.fullmatch(r"Fret_(\d+)", clip.parts[-2])
        if ms is None or mf is None:
            print(f"[create_pitch_dataset] skipping {clip}: "
                  f"non-numeric String_/Fret_ folder name")
            skipped += 1
            continue
        s, f = int(ms.group(1)), int(mf.group(1))
        pitch = string_fret_to_note(s, f)
        dest = out_root / pitch
        dest.mkdir(parents=True, exist_ok=True)
        # traceable provenance in the filename
        shutil.copy2(clip, dest / f"s{s}_f{f}__{clip.name}")
        n += 1
    print(f"[create_pitch_dataset] copied {n} clips into "
          f"{len(list(out_root.iterdir()))} pitch folders"
          + (f" ({skipped} skipped: unparseable folder names)"
             if skipped else ""))
    return n


def count_clips(root: Path) -> dict[str, int]:
    counts = {p.name: len(list(p.glob("*.wav")))
              for p in sorted(root.iterdir()) if p.is_dir()}
    for name, c in counts.items():
        print(f"{name}: {c}")
    print(f"total: {sum(counts.values())}")
    return counts


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("slice-all")
    p.add_argument("--raw", type=Path, required=True)
    p.add_argument("--clips", type=Path, required=True)
    p.add_argument("--sr", type=int, default=44100)
    p.add_argument("--clip_len", type=float, default=1.0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (the default) needs a card and raises "
                        "without one; cpu runs the plain PyTorch path")

    p = sub.add_parser("pitch-dataset")
    p.add_argument("--clips", type=Path, required=True)
    p.add_argument("--out", type=Path, required=True)

    p = sub.add_parser("count")
    p.add_argument("--root", type=Path, required=True)

    p = sub.add_parser("synth")
    p.add_argument("--out", type=Path, required=True)
    p.add_argument("--variants", type=int, default=24)
    p.add_argument("--sr", type=int, default=22050)
    p.add_argument("--seed", type=int, default=0)

    args = ap.parse_args(argv)
    if args.cmd == "slice-all":
        slice_all_clips(args.raw, args.clips, args.sr, args.clip_len,
                        device=args.device)
    elif args.cmd == "pitch-dataset":
        create_pitch_dataset(args.clips, args.out)
    elif args.cmd == "count":
        count_clips(args.root)
    elif args.cmd == "synth":
        from gat_tpu_torch.data.synth import synthesize_note_dataset
        synthesize_note_dataset(args.out, sr=args.sr,
                                variants_per_class=args.variants,
                                seed=args.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
