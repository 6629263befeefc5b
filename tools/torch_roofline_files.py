#!/usr/bin/env python
"""Roofline accounting of the PyTorch port's batched file-serving wave,
the twin of `tools/roofline_files.py`: where the wave's operations,
memory bytes and device time go, stage by stage, against the card's
peaks.

The wave is the shipped serving body (`Transcriber._files_fn`'s `run`:
B files × the bucket's seconds at 22050 Hz, the onset, wave-clip and
candidate budgets of the serve defaults). The port has no compiler cost
model, so each stage's operations and bytes are counted from the wave's
shapes (`gat_tpu_torch/utils/roofline.py`, whose K1-K9 counts are also
the kernels line's bounds in `chip_smoke.py`). Bytes are the least
traffic, each input of a stage read once and each output written once,
so every count is a floor: the wave's floor is the sum of its stages'.
The slicer's reads depend on the onsets: on the card they are the
windows the measured inputs open (`wave_windows`), on the CPU the most
they could be. A stage measured below its floor is a fault of the
count, and the tool raises. (The bytes floor takes every byte at the
HBM rate; a stage whose inputs stay in the 50 MB L2 could beat it, and
is then raised too, to be looked at rather than reported.)

On the card (`--device cuda`, the default; it raises without a card)
the wave runs ITERS times over 4 distinct inputs: its time per call
in CUDA events, and under torch.profiler each kernel's device time,
attributed to the innermost stage range (`record_function`, named as
STAGE_TAGS in `infer/pipeline.py` and what it calls) of the host thread
that launched it, and the kernels each stage launched (`measured`'s
`stage_kernels`; `sort_kernels` lists any sort among them: the
compaction counts a partition, K10, and sorts nothing).
`--measured_wave_ms` takes the place of the events' time in the
`measured` section, as in the JAX tool. `--device cpu`
counts only: every device time is "not measured". `--stft_backend matmul`
runs and counts the matmul route, where the MFCC front-end gives the
YIN pitch too (K6) and the yin_baseline stage does no work.

Usage: python tools/torch_roofline_files.py [--files 4] [--seconds 60]
           [--onsets 112] [--budget 384] [--cand 448] [--clip_batch 256]
           [--measured_wave_ms MS] [--device cuda|cpu]
           [--stft_backend auto|fft|matmul]
"""
from __future__ import annotations

import argparse
import collections
import json
import math
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

# the JAX tool's stages, each with what it covers in the port: the
# record_function ranges of the wave body carry these names
STAGE_TAGS = (
    ("onset_detect", "detect_onsets: K4 envelope, K5 pick"),
    ("slicing", "slice_at_onsets (K8): the clips, their gate, times"),
    ("clip_rerate", "resample_rows (K9): the budget's clips re-rated to the "
                    "checkpoint rate and clip length"),
    ("mfcc_yin_frontend", "mfcc_feature_vectors (K2, or K6 on the shared "
                          "route) and the scaler"),
    ("melspec_frontend", "melspec_features (K1)"),
    ("yin_baseline", "yin_pitch (K3) of the re-rated clips (none on the "
                     "shared route)"),
    ("cnn_forward", "CNN forward and softmax"),
    ("mlp_forward", "MLP forward and softmax"),
    ("compaction", "the kept-clip budget's selection and the scatter back"),
    ("segmentation_other", "both gates and the length mask (K7)"),
)
STAGES = tuple(name for name, _ in STAGE_TAGS) + ("other",)
# calls per measurement on the card
ITERS = 8
# the blend, softmax and pitch prior per class and clip
BLEND_OPS_PER_CLASS = 12


def _attributed(events: list, stages=STAGES):
    """(stage, event) of every kernel, memcpy and memset of a torch Chrome
    trace's events: each is matched to its launching runtime call by
    correlation id and attributed to the innermost range named in
    `stages` on that host thread; work outside every range is 'other'."""
    from gat_tpu_torch.utils.profiling import DEVICE_CATEGORIES
    ranges = collections.defaultdict(list)
    launches = {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat")
        if cat == "user_annotation" and e.get("name") in stages:
            ranges[(e.get("pid"), e.get("tid"))].append(
                (e["ts"], e["ts"] + e["dur"], e["name"]))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = e
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        launch = launches.get((e.get("args") or {}).get("correlation"))
        name = "other"
        if launch is not None:
            ts = launch["ts"]
            inside = [(end - start, n) for start, end, n in
                      ranges[(launch.get("pid"), launch.get("tid"))]
                      if start <= ts <= end]
            if inside:
                name = min(inside)[1]
        yield name, e


def stage_device_us(events: list, stages=STAGES) -> collections.Counter:
    """Device µs per stage from a torch Chrome trace's events, attributed
    as `_attributed` does."""
    out = collections.Counter()
    for name, e in _attributed(events, stages):
        out[name] += e["dur"]
    return out


def stage_kernels(events: list, stages=STAGES) -> dict:
    """{stage: sorted names of the kernels it launched} from a torch
    Chrome trace's events (memcpy and memset left out), attributed as
    `_attributed` does."""
    out = collections.defaultdict(set)
    for name, e in _attributed(events, stages):
        if e.get("cat") == "kernel":
            out[name].add(e.get("name", ""))
    return {k: sorted(v) for k, v in out.items()}


def _add(*costs) -> tuple[int, int]:
    return (sum(c[0] for c in costs), sum(c[1] for c in costs))


def clip_costs(t, n_clips: int) -> dict:
    """(flops, bytes) of each stage of the ensemble over `n_clips` clips
    at the checkpoint rate: K3, K2 and the scaler, K1, the two models,
    the blend; on the shared route K6 and the scaler, and no K3."""
    from gat_tpu_torch.features import shared_frontend
    from gat_tpu_torch.ops import spectral
    from gat_tpu_torch.utils import roofline
    sr = t.ckpt_sr
    length = int(sr * t.clip_length)
    mel = t.melspec_params
    n_feat = t.mfcc_params["N_MFCC"] + 1
    frames = spectral.n_frames(length, mel["N_FFT"], mel["HOP_LENGTH"])
    classes = len(t.predictor.reverse_map)
    shared = shared_frontend(t.mfcc_params["ADD_PITCH_FEATURES"])
    return {
        "yin_baseline": ((0, 0) if shared
                         else roofline.yin_cost(n_clips, length, sr)),
        "mfcc_yin_frontend": _add(
            (roofline.mfcc_pitch_cost if shared
             else roofline.mfcc_cost)(n_clips, length, sr),
            (2 * n_feat * n_clips, 8 * n_feat * n_clips)),
        "melspec_frontend": roofline.melspec_cost(n_clips, length, sr),
        "mlp_forward": roofline.module_cost(t.predictor.mlp,
                                            (n_clips, n_feat)),
        "cnn_forward": roofline.module_cost(
            t.predictor.cnn, (n_clips, mel["N_MELS"], frames, 1)),
        "other": (BLEND_OPS_PER_CLASS * classes * n_clips,
                  4 * n_clips * (3 * classes + 1)),
    }


def wave_costs(t, files: int, n: int, max_onsets: int,
               budget: int | None, windows: int | None = None) -> dict:
    """(flops, bytes) of each stage of one wave of `files` files of `n`
    samples at 22050 Hz, in STAGES order; `windows`, the samples the
    slicer's windows read in the run measured (`wave_windows`), or None
    for the most they could."""
    from gat_tpu_torch.config import CLIP_DURATION, TARGET_SR
    from gat_tpu_torch.utils import roofline
    slots = files * max_onsets
    clips = slots if budget is None else min(budget, slots)
    length = int(TARGET_SR * CLIP_DURATION)
    frames = 1 + n // 512
    classes = len(t.predictor.reverse_map)
    per_clip = 4 * (3 * classes + 1)  # the three probs and the pitch
    costs = clip_costs(t, clips)
    costs.update({
        "onset_detect": _add(
            roofline.envelope_cost(files, n, TARGET_SR),
            roofline.pick_cost(files, frames, TARGET_SR, 512, max_onsets)),
        "slicing": roofline.slice_cost(files, n, slots, length, windows),
        # K9 reads the picked clips where they lie, by the budget's
        # int32 index (its gather is no copy of the compaction's), and
        # writes the checkpoint's clip length
        "clip_rerate": _add(roofline.resample_cost(
            clips, length, TARGET_SR, t.ckpt_sr,
            int(t.ckpt_sr * CLIP_DURATION)),
            (0, 4 * clips if clips < slots else 0)),
        "compaction": ((slots * math.ceil(math.log2(slots)), slots
                        + clips * per_clip + slots * per_clip)
                       if clips < slots else (0, 0)),
        "segmentation_other": roofline.gate_cost(files, n),
    })
    return {k: costs[k] for k in STAGES}


def wave_windows(run, ys, n_valids) -> int:
    """The samples the slicer's windows read in one wave of the body
    `run` on (ys, n_valids): its valid slots are each file's first
    n_detected (capped at the budget), their windows its times."""
    import torch
    from gat_tpu_torch.config import TARGET_SR
    from gat_tpu_torch.utils import roofline
    with torch.no_grad():
        outs = run(ys, n_valids)
    times, n_detected = outs[6], outs[9]
    k = times.shape[1]
    valid = (torch.arange(k)[None, :]
             < n_detected.detach().cpu().clamp(max=k)[:, None])
    return roofline.window_samples(times, valid, n_valids, TARGET_SR)


def _floors(flops: float, nbytes: float) -> dict:
    from gat_tpu_torch.utils.roofline import (PEAK_BYTES_PER_S,
                                              PEAK_FP32_FLOPS)
    return {"t_flops_ms_floor": flops / PEAK_FP32_FLOPS * 1e3,
            "t_bytes_ms_floor": nbytes / PEAK_BYTES_PER_S * 1e3}


def check_floors(stages: dict) -> None:
    """Raise when a stage was measured below its floor: the count, not
    the card, is then wrong."""
    below = [k for k, r in stages.items()
             if r["measured_ms"] is not None
             and r["measured_ms"] < r["floor_ms"]]
    if below:
        raise RuntimeError(
            "[roofline] stages measured below their floor: "
            + ", ".join(f"{k} {stages[k]['measured_ms']:.5f} ms < "
                        f"{stages[k]['floor_ms']:.5f} ms" for k in below)
            + "; the count is wrong")


def measure(run, pool) -> tuple[float, dict, dict]:
    """(ms per call in CUDA events, device ms per call of each stage from
    torch.profiler, the kernels each stage launched) of `run` over the
    pool."""
    import glob
    import gzip
    import statistics

    import torch
    from gat_tpu_torch.utils.profiling import device_trace
    with torch.no_grad(), tempfile.TemporaryDirectory() as d:
        for args in pool:
            run(*args)
        torch.cuda.synchronize()
        times = []
        for _ in range(max(1, ITERS // len(pool))):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for args in pool:
                run(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / len(pool))
        with device_trace(d):
            for i in range(ITERS):
                run(*pool[i % len(pool)])
            torch.cuda.synchronize()
        (path,) = glob.glob(f"{d}/*.trace.json.gz")
        with gzip.open(path, "rt") as fh:
            events = json.load(fh)["traceEvents"]
    us = stage_device_us(events)
    return (statistics.median(times),
            {k: us.get(k, 0.0) / 1e3 / ITERS for k in STAGES},
            stage_kernels(events))


def report(args) -> dict:
    """The report of one run of the tool (see the module docstring)."""
    import numpy as np
    import torch
    from gat_tpu_torch.config import CLIP_DURATION, TARGET_SR
    from gat_tpu_torch.infer import Transcriber
    from gat_tpu_torch.ops import spectral
    from gat_tpu_torch.utils import roofline

    spectral.set_stft_backend(args.stft_backend)
    t = Transcriber(device=args.device)
    on_card = t.device.type == "cuda"
    n = int(args.seconds * TARGET_SR)
    # whole seconds, as transcribe_files pads each file on the host
    bucket = -(-n // TARGET_SR) * TARGET_SR
    audio_s = args.files * args.seconds
    card = None
    if on_card:
        import subprocess
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]

    stage_ms = windows = kernels = None
    wave_ms = args.measured_wave_ms
    if on_card:
        run, _ = t._files_fn(TARGET_SR, CLIP_DURATION, args.onsets,
                             args.budget, args.cand)
        rng = np.random.default_rng(0)
        nv = torch.full((args.files,), n, device=t.device)
        pool = [(torch.from_numpy(rng.normal(0, 0.05, (args.files, bucket))
                                  .astype(np.float32)).to(t.device), nv)
                for _ in range(4)]
        events_ms, stage_ms, kernels = measure(run, pool)
        wave_ms = wave_ms or events_ms
        # the slicer reads what the onsets open: its floor is counted
        # over the inputs measured
        windows = round(sum(wave_windows(run, *args_) for args_ in pool)
                        / len(pool))
    costs = wave_costs(t, args.files, bucket, args.onsets, args.budget,
                       windows)
    flops = sum(f for f, _ in costs.values())
    nbytes = sum(b for _, b in costs.values())

    stages = {}
    for name in STAGES:
        f, b = costs[name]
        floor_ms, by = roofline.bound(f, b)
        row = {"flops": f, "bytes": b, "floor_ms": floor_ms,
               "bound_by": by, "measured_ms": None, "share": None}
        if stage_ms is not None:
            row["measured_ms"] = stage_ms[name]
            row["share"] = stage_ms[name] / (sum(stage_ms.values()) or 1)
        stages[name] = row
    check_floors(stages)

    floor_ms, bound_by = roofline.bound(flops, nbytes)
    out = {
        "program": {
            "files": args.files, "seconds": args.seconds,
            "bucket_samples": bucket, "max_onsets": args.onsets,
            "wave_clip_budget": args.budget, "cand_budget": args.cand,
            "audio_s_per_wave": audio_s,
            "stft_backend": spectral.stft_backend(),
        },
        "card": {"name_power_limit": card,
                 "peak_fp32_flops": roofline.PEAK_FP32_FLOPS,
                 "peak_bytes_per_s": roofline.PEAK_BYTES_PER_S},
        "wave": {
            "flops": flops, "bytes": nbytes, **_floors(flops, nbytes),
            "floor_ms": floor_ms, "bound_by": bound_by,
            "arithmetic_intensity_flop_per_byte": (flops / nbytes
                                                   if nbytes else None),
        },
        "measured": None,
        "stages": stages,
    }
    if wave_ms:
        if wave_ms < floor_ms:
            raise RuntimeError(f"[roofline] wave measured at {wave_ms} ms, "
                               f"below its floor {floor_ms} ms")
        w = out["wave"]
        out["measured"] = {
            "wave_ms": wave_ms,
            "audio_s_per_s": audio_s / wave_ms * 1e3,
            "mfu": w["t_flops_ms_floor"] / wave_ms,
            "bw_util": w["t_bytes_ms_floor"] / wave_ms,
            "roofline_share": floor_ms / wave_ms,
            "device_busy_ms": (sum(stage_ms.values())
                               if stage_ms is not None else None),
            # the kernels each stage launched, and any sort among them
            # (the compaction is a partition count, K10, not a sort)
            "stage_kernels": kernels,
            "sort_kernels": (None if kernels is None else sorted(
                {n for ks in kernels.values() for n in ks
                 if "sort" in n.lower()})),
            "verdict": (f"{bound_by}-bound at the floor; the wave takes "
                        f"{wave_ms / floor_ms:.1f}x its floor"),
        }

    if args.clip_batch:
        ccosts = clip_costs(t, args.clip_batch)
        cf = sum(f for f, _ in ccosts.values())
        cb = sum(b for _, b in ccosts.values())
        clip = {"batch": args.clip_batch, "flops": cf, "bytes": cb,
                **_floors(cf, cb), "measured_ms": None}
        clip["floor_ms"], clip["bound_by"] = roofline.bound(cf, cb)
        if on_card:
            from gat_tpu_torch.entry import entry
            step, (ex,) = entry(batch=args.clip_batch, device=args.device)
            cpool = [(torch.from_numpy(np.random.default_rng(i).normal(
                0, 0.1, tuple(ex.shape)).astype(np.float32)).to(t.device),)
                for i in range(4)]
            clip["measured_ms"], _, _ = measure(step, cpool)
        out["clip_step"] = clip
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--files", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--onsets", type=int, default=112)
    ap.add_argument("--budget", type=int, default=384)
    ap.add_argument("--cand", type=int, default=448)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (the default) needs a card and raises "
                         "without one; cpu counts without measuring")
    ap.add_argument("--clip_batch", type=int, default=256,
                    help="also report the clip-path step at this batch "
                         "for side-by-side comparison (0 disables)")
    ap.add_argument("--measured_wave_ms", type=float, default=None,
                    help="a per-wave time measured elsewhere, in place "
                         "of this run's own in the `measured` section")
    ap.add_argument("--stft_backend", default="auto",
                    choices=["auto", "fft", "matmul"],
                    help="the DFT route the wave takes and is counted on")
    return ap.parse_args(argv)


def main(argv=None):
    out = report(parse_args(argv))
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
