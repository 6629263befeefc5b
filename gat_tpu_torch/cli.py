"""Transcription CLI of the port, the twin of `gat_tpu/cli.py`.

The reference's surface: `--audio --out --save_clips --save_results`, a
results table with YIN estimates and an optional results file; `--live`
(the microphone through `LiveTranscriber`), `--stream` (a file through
`ScanStreamer`), `--mlp_ckpt/--cnn_ckpt`, `--cnn_weight`, `--model` and
`--pitch_prior`. Several `--audio` files go through `transcribe_files`
in one batched call. The tkinter file dialog is imported only when no
`--audio` is given. `--device` picks the Transcriber's device: the CUDA
card by default, `cpu` for the plain PyTorch path; without a card and
without `--device cpu` it raises instead of running on the CPU.

Run: python -m gat_tpu_torch.cli --audio my.wav
     python -m gat_tpu_torch.cli --audio my.wav --stream --save_results
     python -m gat_tpu_torch.cli --audio my.wav --device cpu
     python -m gat_tpu_torch.cli --live
"""
from __future__ import annotations

import argparse
import tempfile
from pathlib import Path
from pprint import pformat

from .config import INFERENCE_OUTPUT_ROOT


def _pick_file_dialog() -> Path | None:
    try:
        import tkinter as tk
        from tkinter import filedialog
        root = tk.Tk()
        root.withdraw()
        file_path = filedialog.askopenfilename(
            title="Select guitar audio file",
            filetypes=(("WAV files", "*.wav"), ("All files", "*.*")))
    except Exception:  # headless: no tkinter or no display
        return None
    return Path(file_path) if file_path else None


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Guitar Audio Transcriber — PyTorch port")
    from . import __version__
    parser.add_argument("--version", action="version",
                        version=f"gat_tpu_torch {__version__}")
    parser.add_argument("--audio", type=str, nargs="+", default=None,
                        help="Path(s) to input .wav file(s); several "
                             "paths go through one batched call "
                             "(Transcriber.transcribe_files)")
    parser.add_argument("--out", type=str, default=None,
                        help="Directory for output files")
    parser.add_argument("--save_clips", action="store_true",
                        help="Write sliced clips to disk")
    parser.add_argument("--save_results", action="store_true",
                        help="Write transcription text file")
    parser.add_argument("--mlp_ckpt", type=str, default=None)
    parser.add_argument("--cnn_ckpt", type=str, default=None)
    parser.add_argument("--cnn_weight", type=float, default=0.80,
                        help="Ensemble weight on the CNN softmax in the "
                             "blend (the CNN is still loaded and run; "
                             "for true MLP-only operation without the "
                             "CNN checkpoint use --model mlp)")
    parser.add_argument("--model", choices=["ensemble", "mlp"],
                        default="ensemble",
                        help="Run the full ensemble or the MLP alone "
                             "(the v0 CLI's model choice)")
    parser.add_argument("--live", action="store_true",
                        help="Stream from the microphone instead of a file")
    parser.add_argument("--stream", action="store_true",
                        help="Transcribe --audio through the streaming "
                             "chunk engine (0.5 s chunks, segmented in "
                             "batched windows on the device, with per-chunk "
                             "note emission)")
    parser.add_argument("--pitch_prior", type=float, default=0.0,
                        help="YIN pitch-prior mixture weight (0 disables;"
                             " 0.4 recommended for unseen-timbre "
                             "robustness)")
    parser.add_argument("--device", type=str, default=None,
                        help="the Transcriber's device: the CUDA card by "
                             "default, 'cpu' for the plain PyTorch path")
    args = parser.parse_args(argv)

    if args.live and args.stream:
        # flag-only validation comes before the checkpoint loads below
        parser.error("--live (microphone) and --stream (offline file "
                     "streaming) are mutually exclusive")

    if not args.live and args.audio is not None:
        # cheap input checks before the checkpoints load: a mistyped path
        # errors at once, and explicit --audio paths never fall through
        # to the file dialog
        audio_paths = [Path(a) for a in args.audio]
        for p in audio_paths:
            if not p.is_file():
                raise FileNotFoundError(f"Audio file not found: {p}")
            if p.suffix.lower() != ".wav":
                raise ValueError(f"Input file must be a .wav file: {p}")

    from .infer import Transcriber
    # --model mlp: skip the CNN checkpoint entirely (use_cnn=False), so
    # its weights never reach the device
    transcriber = Transcriber(mlp_ckpt=args.mlp_ckpt,
                              cnn_ckpt=args.cnn_ckpt,
                              cnn_weight=args.cnn_weight,
                              require_cnn=(args.model == "ensemble"),
                              use_cnn=(args.model != "mlp"),
                              pitch_prior_weight=args.pitch_prior,
                              device=args.device)

    if args.live:
        from .stream import LiveTranscriber
        LiveTranscriber(transcriber).live()
        return 0

    if args.audio is None:
        picked = _pick_file_dialog()
        if picked is None:
            parser.error("no --audio given and no file dialog available")
        audio_paths = [picked]

    out_dir = Path(args.out) if args.out else INFERENCE_OUTPUT_ROOT
    out_dir.mkdir(parents=True, exist_ok=True)

    used_stems: dict[str, int] = {}

    def _out_name(audio_path: Path, kind: str = "transcription") -> Path:
        """Stem-keyed output path, disambiguated when two inputs share
        a stem (a/take.wav + b/take.wav must not clobber each other)."""
        n = used_stems.get(audio_path.stem, 0)
        used_stems[audio_path.stem] = n + 1
        suffix = "" if n == 0 else f"_{n}"
        return out_dir / f"{audio_path.stem}{suffix}_{kind}.txt"

    if args.stream:
        import torch

        from .ops.resample import resample
        from .stream import ScanStreamer
        from .utils.wavio import read_wav

        streamer = ScanStreamer(transcriber)
        for p in audio_paths:
            y, sr_in = read_wav(p)
            y = resample(torch.from_numpy(y).to(transcriber.device), sr_in,
                         streamer.sr)
            notes = streamer.transcribe_stream(y)
            print(f"\nStreamed Transcription — {p.name}:")
            print("Onset(s) |  Label |  Confidence")
            for r in notes:
                flag = "  [onset budget hit]" if r["onset_overflow"] else ""
                print(f"{r['onset_s']:8.3f}  {r['labels'][0]:>5}  "
                      f"(conf={float(r['confidences'][0]):.2f}){flag}")
            if not notes:
                print("(no notes emitted)")
            if args.save_results:
                out_file = _out_name(p, kind="stream_transcription")
                with out_file.open("w", encoding="utf-8") as f:
                    for r in notes:
                        f.write(f"{r['onset_s']:.4f},{r['labels'][0]},"
                                f"{float(r['confidences'][0]):.4f}\n")
                print(f"Saved streamed transcription to {out_file}")
        return 0

    def _emit(audio_path: Path, result: dict, header: str = "") -> None:
        labels = result["labels"]
        confs = result["confidences"]
        yin_info = result["dsp_info"]
        print(f"\nTranscription Results{header}:")
        if not labels:
            print("(no notes: no clips survived slicing)")
        print("Idx |  Label |  Confidence | (YIN Note Estimate)")
        for i, (lab, conf, y_info) in enumerate(zip(labels, confs,
                                                    yin_info)):
            print(f"{i:03d}  {lab:>4}  (conf={conf:.2f})  "
                  f"{y_info[1]['note_name']}")
        if args.save_results:
            out_file = _out_name(audio_path)
            with out_file.open("w", encoding="utf-8") as f:
                for i, (lab, conf) in enumerate(zip(labels, confs)):
                    f.write(f"{i},{lab},{conf:.4f}\n")
                f.write("\nFull result dict:\n")
                f.write(pformat(result))
            print(f"\nSaved transcription to {out_file}")

    if len(audio_paths) > 1 and not args.save_clips:
        # many files: one batched call (an empty result is per file, not
        # fatal)
        results = transcriber.transcribe_files(audio_paths)
        for p, result in zip(audio_paths, results):
            _emit(p, result, header=f" — {p.name}")
        return 0

    for audio_path in audio_paths:
        if args.save_clips:
            result = transcriber.transcribe(audio_path, out_root=out_dir,
                                            audio_name=audio_path.stem,
                                            save_clips=True)
        else:
            with tempfile.TemporaryDirectory() as tmpdir:
                result = transcriber.transcribe(
                    audio_path, out_root=Path(tmpdir),
                    audio_name=audio_path.stem)
        _emit(audio_path, result,
              header=f" — {audio_path.name}" if len(audio_paths) > 1
              else "")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
