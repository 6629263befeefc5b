#!/usr/bin/env python3
"""K4 and K5, the PyTorch port's onset-envelope and onset-pick kernels,
checked and timed at the file path's shapes for one checkout of the port,
on one CUDA card; with `clip`, K2, K3 and (where the checkout has it) K6
at the clip path's 1024 clips; with `gate`, the noise gate K7 at the
serving wave and a 400 s riff, per pass; with `slice`, the clip slicer K8
at the same wave and riff and at 4.0 s clips; with `resample`, the
polyphase resampler K9 at the serving wave's clip re-rate, four user
files and one note (or, in a checkout without K9, its plain route at the
same calls); with `compact`, the file body's clip-budget compaction
stage in situ at the serving wave, and (where the checkout has K10) K10
at the `[compact]` cases; with `train`, the steady-state training epoch
of the shipped MLP and bf16 CNN at `[train]`'s sizes, with the host time
and the CUDA runtime's launches of a step; with `batchnorm`, the
train-mode BatchNorm K13 at the shipped CNN's three layers; with
`clip_adamw`, the clip and AdamW K12 at both models' parameter counts;
with `xent`, the label-smoothed loss K11 at a training step and an eval
chunk; with `long`, the clip front-ends K1, K2, K3 and K6 at 256 clips
of 4.0 s, one of 120 s and 64 of 60 s (a checkout that caps the frames
refuses the last two).

    python3 tools/torch_onset_timing.py TREE [envelope] [pick] [clip] [gate]
                                             [slice] [resample] [compact]
                                             [train] [batchnorm] [clip_adamw]
                                             [xent] [long]

TREE is the root of a checkout that holds `gat_tpu_torch/`: this one, or
another commit unpacked with `git archive`; its kernels are built there.
Without a kernel named, K4 and K5 are timed. Shapes, inputs, checks and
timings are `chip_smoke.py`'s own (`time_envelope`: one 4 s file, 4 files
of 4 s, 64 riffs of 8 s; `time_pick`: the same and one 400 s file, with
the wrapper's host time split into its parts; `time_clip_kernels`: the
clip path's 1024 clips of 0.5 s at 11025 Hz, `make_clips`; `time_gate`:
4 files of 60 s and one of 400 s at 22050 Hz, `gate_riffs`, device time
per pass by the kernel names of this checkout's roofline; `time_slice`:
the onsets that checkout's gate and detection find in them, the file
path's arguments, 0.5 s clips and 4.0 s clips at every 8th onset, with
K8's resident blocks per SM and its ring; `time_resample`: the wave's
384 budgeted clips of 0.5 s at 22050 Hz re-rated and cut to 5,512
samples, 60 s and 400 s at 48 kHz, 60 s at 16 kHz and at 44.1 kHz to
22050 Hz, one 0.5 s note to 11025 Hz, with the whole call's device time
beside K9's and one `F.conv1d` of the filter bank as the library's
time; `time_compact`: the serving wave's body (4 files x 60 s, 112
onsets, budget 384) on the gate's riffs and on the roofline tool's noise
wave under the profiler, the `compaction` stage's device ms and kernels
and the body's synchronising calls, then K10 against its plain twins at
`compact_data`'s cases; `time_train`: 601 training and 151 validation
examples of random features, batch 32, two warm epochs, then the median
of three, and `step_launches` over ten steps; `time_bn`: K13 forward and backward
at (32, 32, 64, 22), (32, 64, 32, 11) and (32, 128, 16, 5) in bfloat16
and float32, device ms per kernel and layer, with the grid where the
checkout reports it; `time_clip_adamw`: K12's two passes at 629,743 and
20,143 parameters, device ms per pass and the library's; `time_xent`:
K11 at 32 x 47 with its gradient and at 65,536 x 47 with the argmaxes,
device ms, the whole call's and `F.cross_entropy`'s, two runs' bits and
the launch's grid where the checkout reports it; `time_long_clips`:
`[long-clips]`' riffs at each shape, every kernel against its plain
version, device ms over every device function of its route, its tiles
and blocks per SM), so two
checkouts timed in turns within one run compare like with like. Prints one JSON line per
kernel and shape, then the card's name and power limit; exits 1 without
a card, when a check fails or when a kernel refuses a shape. Imports
nothing of JAX.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

TIMINGS = {"envelope": ("onset_envelope", "time_envelope"),
           "pick": ("onset_pick", "time_pick"),
           "clip": ("clip_kernels", "time_clip_kernels"),
           "gate": ("noise_gate", "time_gate"),
           "slice": ("slice_clips", "time_slice"),
           "resample": ("resample", "time_resample"),
           "compact": ("wave_compact", "time_compact"),
           "train": ("train_step", "time_train"),
           "batchnorm": ("batchnorm_train", "time_bn"),
           "clip_adamw": ("clip_adamw", "time_clip_adamw"),
           "xent": ("softmax_xent", "time_xent"),
           "long": ("clip_kernels_long", "time_long_clips")}


def main(argv: list[str]) -> int:
    names = argv[2:] or ["envelope", "pick"]
    if len(argv) < 2 or any(n not in TIMINGS for n in names):
        print(__doc__, file=sys.stderr)
        return 2
    tree = Path(argv[1]).resolve()
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch
    if not torch.cuda.is_available():
        print("torch_onset_timing: torch.cuda is not available",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(tree))
    from gat_tpu_torch import features, kernels
    from gat_tpu_torch.ops import onset, resample, yin
    from gat_tpu_torch.segment import gating, slicing
    if not Path(onset.__file__).resolve().is_relative_to(tree):
        print(f"torch_onset_timing: gat_tpu_torch came from "
              f"{onset.__file__}, not {tree}", file=sys.stderr)
        return 1
    kernels.build(kernels.KERNELS)  # K5 reads K4's output
    dev = torch.device("cuda")
    failures: list = []
    for n in names:
        kernel, timing = TIMINGS[n]
        if n == "clip":
            clips = torch.from_numpy(
                smoke.make_clips(smoke.N_CLIPS, smoke.SEED)[0]).to(dev)
            args = (features, yin, clips)
        elif n == "long":
            args = (features, yin, dev)
        elif n == "gate":
            args = (gating, dev)
        elif n == "slice":
            args = (slicing, dev)
        elif n == "resample":
            args = (resample, dev)
        elif n in ("compact", "train", "batchnorm", "clip_adamw", "xent"):
            args = (dev,)
        else:
            args = (onset, dev)
        rows = getattr(smoke, timing)(*args, failures)
        for row in [rows] if isinstance(rows, dict) else rows:
            print(json.dumps({"tree": str(tree), "kernel": kernel, **row}),
                  flush=True)
    print(smoke.card_line(), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
