#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`gat_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each ending in torch.cuda.synchronize(); any failure exits
non-zero:

1. the card: name and power limit (nvidia-smi);
2. build the thirteen CUDA kernels from `gat_tpu_torch/csrc/` (one nvcc per
   source, in parallel), print nvcc's register/spill report and each
   kernel's resident blocks per SM as the CUDA runtime computes them;
3. hold each kernel against its plain PyTorch version on the card, at its
   path's shapes, and time both with CUDA events over distinct input
   buffers: the clip kernels K1-K3 at 1024 clips of 0.5 s at 11025 Hz
   (Karplus-Strong plucks over the 47 classes plus noise, from a seed;
   the mel kernel also at 1100 samples, the MFCC kernel also at 4608 and
   1100, so odd and even frame counts; K2 and K3 with their device time
   from the profiler, by `time_clip_kernels`, which `[shared]` and
   `tools/torch_onset_timing.py clip` share), the file kernels K4 (onset
   envelope) and K5 (onset pick) at 64 riffs of 8 s at 22050 Hz (plucks
   from 0.4 s, 0.7 s apart, over the 47 classes, plus noise; one file
   with a zero tail), K5 also from K4's envelopes and with three
   candidate budgets; K4 and K5 also at the file path's own shapes, one
   4 s file and a wave of 4, and K5 at one 400 s file (17,227 frames),
   with their device time from the profiler beside the CUDA-event time,
   and K5's wrapper host time split into its parts; then `[gate]`: the
   noise gate K7 (`csrc/noise_gate.cu`) and the clip slicer K8
   (`csrc/slice_clips.cu`) against their plain twins at the serving wave
   (4 files x 60 s at 22050 Hz, 112 onsets a file, 448 slots of 11,025
   samples) and a 400 s riff (at hop 512 and at hop 128, past K7's
   threshold pass's shared-memory limit), with rows of n_valid 0, 1500
   and off the 512 grid, a batch without counts, hop 256 and the RMS
   gate alone (K7: envelope, median and gate_db within 1e-4 dB, frame
   masks equal but within 1e-3 dB of gate_db, gated samples bit-equal
   where both decisions agree; K8: clips and times bit-equal, kept equal
   but within 1e-4 dB of its threshold), both gathers and both last-note
   rules for K8, also at clips of 4.0 s and with a valid count past the
   row's end, and both timed with their bound,
   plain time and blocks per SM (K7's device time and blocks per SM also
   per pass; K8 also at 4.0 s clips, with its ring's stages); then
   `[resample]`: the polyphase resampler K9 (`csrc/resample.cu`) against
   the plain route (`resample_plain`, atol 1e-5) at the serving wave's
   clip re-rate (`resample_rows` of the budget's 384 of 448 slots of 0.5 s,
   22050 -> 11025 Hz, cut to 5,512 samples), one 60 s and one 400 s file
   at 48 kHz and one 60 s file at 16 kHz (to 22050 Hz), each with its
   device time, the whole call's, the plain route's, the bound, resident
   blocks per SM and shared memory, and at the wave `library_ms`, one
   `F.conv1d(x, h, stride=2)` with TF32 off; then `[compact]`: the
   wave's clip-budget compaction K10 (`csrc/wave_compact.cu`, its
   selection `wave_select` and its scatter `wave_scatter`) against the
   plain twins (`ops/compaction.py`: the selection equal field by field,
   sel in the reference's order, the scatter bit-equal) at the serving
   wave (4 files x 112 slots, budget 384) with random kept bits, with the
   kept bits of `[gate]`'s riffs and of torch_roofline_files.py's noise
   wave (none kept), with bits that overflow the budget, at a 64-file
   wave of 7,168 slots (budget 5,376), and every rank's (first, n_local)
   of the riffs' and the 64-file wave's bits for 2 and 4 ranks, each
   timed in CUDA events and in the profiler with the plain route's device
   ms and the bound; and the file body's `compaction` stage in situ on
   the riffs and the noise wave (`time_compact_stage`: its device ms and
   kernels, no sort kernel in the wave, no synchronising call of the
   compaction);
4. drive the clip path, `Transcriber(device="cuda").transcribe_clips`, at
   the shipped checkpoints: K1-K3's launch counts must rise, the labels
   must equal those of the plain versions fed to the same models, and a
   small batch must agree with the plain path on the CPU;
5. drive the file path, `Transcriber(device="cuda").transcribe(path)` on
   riff WAVs at 22050, 44100 and 48000 Hz, two-stage and fused: all five
   kernels must launch, the labels must be the planted notes but the last
   (the reference slicer drops it), and labels, onsets and times must
   equal the CPU plain path's; per-file wall time and the device's busy
   share of one call; at 48000 Hz the time per file also in turns with
   both re-rates bound to their plain versions (`plain_rerate`, the
   parent's route);
6. `[long]`: `transcribe` of a 400 s riff WAV at 22050 Hz, a pluck every
   2.5 s, on the card and on the CPU: K4 and K5 must launch, the labels
   must be the planted notes but the last, and labels, onsets and times
   must be equal;
7. `[files]`: the many-file path, `transcribe_files`, over 25 WAVs in four
   duration buckets (16 riffs of 3.9 s at 22050 Hz, 4 of 9.5 s at 44100,
   3 of 1.9 s at 48000, one of 300 s and one silent file), in a shuffled
   order: all five kernels must launch, labels, onsets and times must
   equal the CPU plain path's, and an exact-fallback call must equal the
   exact run; first the kernels against their plain versions at the
   waves' shapes, padding rows of n_valid 0 among them (which must give
   no onset); then ms per call, files/s, audio-s/s, the device's busy
   share, host transfers and launches per call, and the threaded WAV
   decode timed on its own;
8. `[serve]`: the watch folder, `serve(once=True, batch=4)`, and the HTTP
   endpoint, `serve_http(port=0, batch=4)` answering 8 concurrent POSTs
   on localhost, both with the card's Transcriber: every file's labels
   must be the CPU's, and all five kernels must launch in each;
9. streaming: `[stream-kernels]`, K4 and K5 against their plain versions
   at the live engine's ring (1 x 33,075 samples, hop 1024) and the scan
   engine's window (256 rings, hop 512, 8 slots) in the order hop 1024,
   512, 1024 from a cold grid cache, and timed at both; `[stream]`,
   `ScanStreamer.transcribe_stream` of a 20 s riff (a pluck every 0.55
   s) on the card and the CPU: the same per-chunk slots and notes, every
   planted note found, all five kernels launched and two host transfers
   per window; then a 300 s riff (602 chunks, 3 windows), equal to the
   CPU's and timed; `[live]`, `LiveTranscriber.run_on_source` of the 20 s
   riff on the card and the CPU, the same notes, K4/K5 once per detecting
   poll;
10. `[cli]`: `gat_tpu_torch.cli.main` in-process on the card and with
   `--device cpu`, for one WAV, two WAVs and `--stream`: the saved
   results must agree;
11. `[train]`: the training path on a dataset synthesized with the
   shipped recipe (all3, noise, stressors 0.5, channel 0.25, seed 42) at
   16 variants per class, 752 clips: K1-K3 against their plain versions
   at that shape, the training step's kernels against their plain
   versions and timed (`train_kernel_rows`: K11 the label-smoothed loss
   at a step of 32 x 47 and an eval chunk of 65,536 x 47, K12 the clip
   and AdamW at the CNN's and the MLP's parameter counts, K13 the
   train-mode BatchNorm at the CNN's three layers, bf16 and fp32, in the
   layout its convolutions give), the FeatureBuilder's features against
   the CPU plain path's, one dropout-0 step on the card against the CPU
   (fp32 MLP and CNN, bf16 CNN), `TrainingManager(device="cuda")
   .train_all` for 3 epochs at full width (K1-K3 launched, K11 once a
   step and an eval chunk, K12 once a step, K13 three times a CNN step,
   finite losses, one host transfer per epoch), ms per epoch, steps/s,
   examples/s and busy share per family, a step's `cudaLaunchKernel`
   calls, host µs and device ms (`step_launches`), and the saved
   checkpoints through `Transcriber`;
12. `[api]`: the public API added over the main path, on the card:
   `pick_onsets_from_envelope` at the 64-riff shape (K5 launched, its
   outputs identical to `pick_onsets_plain`'s), the FeatureBuilder's
   three inference extractors at the 1024 clips (K1-K3 launched, against
   the CPU's at K1-K3's tolerances) and the lazy top-level names;
13. `[shared]`: the matmul route (`ops.spectral.set_stft_backend
   ("matmul")`, back to "auto" and float32 at the phase's end whatever
   happens) and its shared MFCC and YIN front-end, K6
   (`csrc/mfcc_pitch_frontend.cu`), on `[main]`'s 1024 clips: K6 against
   the plain shared front-end (the fp32 block DFT; MFCC atol 1e-3 and
   rtol 2e-6, pitch rtol 2e-3) and against the FFT route's K2 + K3
   (features atol 5e-3, the JAX package's bound between its routes), for
   all four flag combinations; `transcribe_clips` driven with every
   count at 0 (K6 and K1 once, K2 and K3 never; labels equal to the FFT
   route's, probs within 1e-2); `transcribe` of the 3.9 s riff (two-stage
   and fused) and `transcribe_files` on the `[files]` set equal to the
   FFT route's (labels, onsets, times); at bfloat16 operands, for all
   four flag combinations, K6 equal bit for bit to K6 of the clips
   rounded to bfloat16 and within the float32 bounds above of the plain
   float32 front-end of them; K6 checked and timed by
   `time_clip_kernels`, as K2 and K3 are, its time logged beside K2 +
   K3's of phase 3, and its blocks per SM, which must be at least four;
14. `[eval]`: the note-accuracy harness, `tools/torch_evaluate.py`, with
   the shipped pair and the witness checkpoint, on the card and on the
   CPU: `evaluate_set` on `mixed` at 8 variants (376 clips) and on
   `modal_unseen_family`, `fm_vibrato` and `modal_full_chain` at 4
   (188 each), per-system correct counts equal (a label flipped by a
   near-tie passes only with a top-2 margin below 1e-3, printed), and
   `evaluate_wav_dir` over SPN-named riff WAVs, reports equal; K1-K5
   launched; each set's stages timed on the card, synthesis apart;
15. `[tools]`: the twins of the JAX package's tools on the card:
   `torch_inspect_ckpt` on the five shipped checkpoints; `slice-all` of
   `torch_dataset_creator` on four riff recordings at 44100 Hz, and
   `torch_eda`'s `dataset`, `slices` and `features`, each against the
   CPU (names and onsets equal, samples within 1e-5, the MFCC matrix
   element by element within 1e-3, pitch 2e-3 relative, feature-report
   numbers within 1e-3; K4/K5 and K2/K3 launched);
   `torch_cross_family_eval` at 5 variants and 2 epochs for both models
   (K1-K3 launched, the report's schema, finite accuracies), and the
   raw features of its fm evaluation set, card against CPU (MFCC as
   eda's, mel 0.1 dB where above -60 dB);
   `torch_train_wall` at 16 variants; `torch_profile_trace` on the clip
   batch and the serving wave (the top table names every kernel
   launched); `torch_roofline_files` on the serving wave (no stage
   measured below its floor);
16. `[parallel]`: multi-device (`gat_tpu_torch/parallel/`) at world 1
   on NCCL (cuda:0, a FileStore rendezvous, torn down at the phase's
   end): K4's two passes as entry points of their own,
   `gat_onset_mel_db` and `gat_onset_flux`, against their plain versions
   and timed at the 400 s riff's shape, and a 4-shard stitch in one
   process (the shards' first passes with their halos from origin 0,
   stitched, then the second pass) against `gat_onset_envelope` on the
   whole file, dB and envelope within 1e-3; then, driven with every
   count at 0: `make_sharded_transcribe` on the 1024 clips against the
   single-device `entry` step (probs and pitch within 1e-5; both timed),
   `Transcriber(mesh=).transcribe_files` on the `[files]` set against the
   single-device call (labels, onsets, times and flags equal), and
   `detect_onsets_timesharded` on the 400 s riff against `detect_onsets`
   (onsets equal): K1-K5 and both passes must launch; then
   `TrainingManager(mesh=)` against the single-device manager, 2 epochs
   of each family at the shipped widths on a 16-variant dataset
   (histories and parameters), and `dryrun_multichip(1)`;
17. `[long-clips]`: K1, K2, K3 and K6 at 256 clips of 4.0 s, one of 120 s
   and 64 of 60 s at 11025 Hz (87, 2,584 and 1,292 frames at hop 512;
   173, 5,168 and 2,584 at hop 256; the card refused the last two before
   the split route, `csrc/dsp_common.cuh`) against their plain versions
   (K1 0.1 dB above -60 dB, MFCC atol 1e-3 and rtol 2e-6, pitch rtol
   2e-3), K6's MFCC K2's and its pitch K3's bit for bit, each timed in
   CUDA events and device ms with its bound, its tiles and blocks per SM
   (`time_long_clips`, which `tools/torch_onset_timing.py long` shares;
   `long_clips` in its kernels-line row, a row a shape); then `[file]` at
   `clip_duration=4.0`: `transcribe` of a 12 s riff on the card and the
   CPU, on the FFT route (K1-K5 launched) and the matmul route (K1, K6,
   K4, K5): labels, onsets and times equal; then `transcribe` and
   `transcribe_note` at `clip_duration=60.0` of a 2 min riff on the card
   and the CPU (labels, onsets and times equal), and
   `FeatureBuilder.extract_melspec_features` and `extract_mfcc_features`
   on a loader of 16 files with one of 60 s, card against CPU;
18. `[numpy]`: the numpy baseline's twin,
   `tools/torch_numpy_reference_pipeline.py`, on 32 of `[main]`'s clips:
   its argmax equal to the card's `transcribe_clips`, its rate logged;
19. print the `{"kernels": [...]}` line, the card line, and last
   `{"ok": true, "device": {...}}`.

Each path's kernel launches, K1..K13, are counted from zero just before
it is driven and read just after (`launches_by_path` in the kernels
line: clips, file, long, files, serve, http, stream, live, cli, train,
shared, eval, tools, parallel, file_4s, file_4s_shared, file_60s,
note_60s, loader_60s; K6's row from
`shared` on; the two K4 pass rows launch on `parallel` only, K6 on
`shared` and `file_4s_shared` only); every path that segments a file
(file, long, files, serve, http, cli, eval, tools, parallel, both
file_4s paths and file_60s) must launch K7, K8 and K9 (its clips re-rated to the
checkpoint's rate), and stream, live and train, which re-rate their
clips or files, K9. Each wave through the file body's budget branch
(more slots than the budget: `transcribe_files` waves of 4 under the
"auto" budget) is counted too, apart from K10 (`compaction_branch`):
K10's two kernels must launch once a compacted wave on every path and so
never on a path that does not compact, and at least once on files,
serve, http and parallel. `launches` stays the clip path's count for
K1-K3, the file path's for K4, K5, K7, K8 and K9, the shared clip path's
for K6, the many-file path's for K10 and the training path's for K11-K13
(their rows from `[train]` on).

Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import ctypes
import functools
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

SR = 11025
N_CLIPS = 1024            # MAX_CLIPS_PER_BATCH of the serving path
CLIP_LEN = SR // 2        # 5512 samples, 0.5 s
FILE_SR = 22050           # slicing rate of the file path
N_RIFFS, RIFF_SECONDS = 64, 8.0
FILE_MIDI = [45, 50, 55, 59, 64]  # A2 D3 G3 B3 E4: the file phase's riff
SEED = 0
# K4's shapes as (files, seconds): one 4 s file, as `transcribe` runs it
# (173 frames); a wave of 4 such files (the many-file path's default
# wave); the 64 riffs of 8 s of the timing phase
ENVELOPE_SHAPES = ((1, 4.0), (4, 4.0), (N_RIFFS, RIFF_SECONDS))
# K5's: the same, and one file of 400 s (17,227 frames), which the first
# K5 refused
LONG_SECONDS = 400.0
PICK_SHAPES = ENVELOPE_SHAPES + ((1, LONG_SECONDS),)
# the [files] phase's WAVs as (files, seconds, rate, pluck spacing), one
# group per duration bucket of `transcribe_files` (max_batch 4)
FILES_SET = ((16, 3.9, 22050, 0.7),   # bucket 4: one chunk of K = 4 waves
             (4, 9.5, 44100, 0.7),    # bucket 16: one wave of 4
             (3, 1.9, 48000, 0.7),    # bucket 2: 3 files padded to B = 4
             (1, 300.0, 22050, 2.5))  # bucket 512: B = 2, 120 plucks
SILENT_SECONDS = 2.5  # bucket 4's 17th file: a wave of one, B = 2
K6_BLOCKS_PER_SM = 4  # K6's least resident blocks per SM at 1024 x 5512
SERVE_FILES = 8       # riffs of 3.9 s for the [serve] phase
# the streaming phases' riffs: a pluck every 0.55 s, one or two notes per
# 0.5 s chunk of the scan engine
STREAM_SPACING = 0.55
STREAM_SECONDS = 20.0        # [stream] and [live], card against the CPU
STREAM_LONG_SECONDS = 300.0  # [stream] timing: 602 chunks, 3 windows
LIVE_RING = 33075            # the live engine's 1.5 s ring at 22050 Hz
# the [train] phase: the shipped recipe with 16 variants per class (752
# clips), 3 epochs of each family
TRAIN_VARIANTS, TRAIN_EPOCHS = 16, 3
# [eval]: tools/torch_evaluate.py's sets (name, variants per class) and seed
EVAL_SETS = (("mixed", 8), ("modal_unseen_family", 4), ("fm_vibrato", 4),
             ("modal_full_chain", 4))
EVAL_SEED = 777
# the model columns of evaluate_set, whose labels come from probabilities
MODEL_SYSTEMS = ("default", "ensemble", "ensemble_prior", "mlp", "cnn")
# [tools]: the slicer's recordings as (string, fret), at 44100 Hz; the
# cross-family run's training variants (the least that leaves every one
# of the 47 classes in the 20 % validation split); the profile's top rows
TOOLS_FRETS = ((6, 0), (5, 2), (3, 4), (1, 5))
TOOLS_SR = 44100
CROSS_VARIANTS = 5
PROFILE_TOP = 60
POOL = 6                  # distinct input buffers per timing repetition
PROFILE_TRIES = 3         # traces at most, while a trace loses launches


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def karplus_strong_batch(midi: np.ndarray, rng: np.random.Generator,
                         n: int, damping: float = 0.996,
                         sr: int = SR) -> np.ndarray:
    """(len(midi), n) plucked strings, one delay line per lane, each
    normalized to peak 1."""
    periods = np.maximum(2, np.round(
        sr / (440.0 * 2.0 ** ((midi - 69.0) / 12.0)))).astype(np.int64)
    lanes = np.arange(len(midi))
    buf = rng.uniform(-1.0, 1.0, (len(midi), periods.max()))
    out = np.empty((len(midi), n))
    idx = np.zeros(len(midi), np.int64)
    for i in range(n):
        cur = buf[lanes, idx]
        out[:, i] = cur
        nxt = (idx + 1) % periods
        buf[lanes, idx] = damping * 0.5 * (cur + buf[lanes, nxt])
        idx = nxt
    return out / (np.abs(out).max(axis=1, keepdims=True) + 1e-12)


def make_clips(n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """n clips cycling over the 47 classes E2..D6 (MIDI 40..86), plus
    Gaussian noise of sigma 0.1. Returns (clips float32, midi)."""
    rng = np.random.default_rng(seed)
    midi = 40 + np.arange(n) % 47
    clips = karplus_strong_batch(midi.astype(np.float64), rng, CLIP_LEN)
    clips += rng.normal(0.0, 0.1, clips.shape)
    return clips.astype(np.float32), midi


def make_riffs(midi: np.ndarray, seconds: float, sr: int, seed: int,
               noise: float, spacing: float = 0.7) -> np.ndarray:
    """(files, seconds·sr) riffs: row f plays midi[f, j] from 0.4 +
    spacing·j s, plucks of 0.45 s at peak 0.5 with the last 30 % faded out
    (an abrupt cut reads as an onset), plus Gaussian noise of sigma
    `noise`."""
    rng = np.random.default_rng(seed)
    n_files, k = midi.shape
    note_len = int(0.45 * sr)
    notes = 0.5 * karplus_strong_batch(midi.ravel().astype(np.float64), rng,
                                       note_len, sr=sr)
    fade = int(0.3 * note_len)
    notes[:, -fade:] *= np.linspace(1.0, 0.0, fade)
    notes = notes.reshape(n_files, k, note_len)
    y = rng.normal(0.0, noise, (n_files, int(seconds * sr)))
    for j in range(k):
        s = int((0.4 + spacing * j) * sr)
        y[:, s:s + note_len] += notes[:, j, :y.shape[1] - s]
    return y.astype(np.float32)


def time_ms(fn, pool, reps: int) -> float:
    """Median per-call device time: each repetition launches fn once on
    every buffer of the pool between two CUDA events."""
    import torch
    for x in pool:
        fn(x)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for x in pool:
            fn(x)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(pool))
    return statistics.median(times)


def kernel_device_ms(fn, pool, kernel: str, names=None) -> float | None:
    """Device time per call of the device functions of `kernel` (K1..K13,
    `load_roofline().KERNEL_SYMBOLS`, or those of `names` among them),
    each launched once a call: the sum of `symbol_device_ms`. None when
    the profiler saw no device time."""
    per_call = sum(ms or 0.0 for ms in symbol_device_ms(
        fn, pool, names or load_roofline().KERNEL_SYMBOLS[kernel]).values())
    return per_call if per_call > 0 else None


def symbol_device_ms(fn, pool, names) -> dict:
    """Device ms per call of each device function in `names` (the
    functions the profiler's kernel names are of,
    `utils/roofline.py::device_function`, templates included), from
    torch.profiler over one call on
    every buffer of the pool: each function's mean over the launches the
    profiler kept (a trace late in a long process has been seen to keep 4
    of 6 launches, which a sum over the pool would read as a faster
    kernel; such a loss is logged). A trace that lost launches of a
    function is taken again, up to PROFILE_TRIES traces in all, and each
    function keeps the trace that kept most of its launches. None for a
    function no trace saw device time of."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    of = load_roofline().device_function
    for x in pool:
        fn(x)
    torch.cuda.synchronize()
    best = {name: (0, None) for name in names}
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for x in pool:
                fn(x)
            torch.cuda.synchronize()
        events = prof.key_averages()
        for name in names:
            kept = [e for e in events if of(e.key) == name]
            n = sum(e.count for e in kept)
            total = sum(e.self_device_time_total for e in kept)
            if n > best[name][0] and total > 0:
                best[name] = (n, total / n / 1e3)
        if all(n == len(pool) for n, _ in best.values()):
            break
    for name, (n, _) in best.items():
        if n != len(pool):
            log(f"[profile] {name}: the best of {PROFILE_TRIES} traces kept "
                f"{n} of {len(pool)} launches")
    return {name: ms for name, (_, ms) in best.items()}


def fmt_ms(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def host_us(fn, pool, reps: int) -> float:
    """Host time per call of a wrapper, in µs: the median over `reps`
    repetitions of one call on every buffer of the pool, enqueued with no
    synchronisation, so this is its Python, allocations and launches, not
    the device's work (the median keeps a stall of the shared host out)."""
    import torch
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for x in pool:
            fn(x)
        times.append((time.perf_counter() - t0) / len(pool) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def noisy_pool(x, seed: int, sigma: float) -> list:
    """x and POOL - 1 copies of it with Gaussian noise of `sigma` added,
    copy i from the seed `seed + i`, on x's device."""
    import torch
    return [x] + [
        (x + sigma * torch.randn(x.shape, device=x.device,
                                 generator=torch.Generator(x.device)
                                 .manual_seed(seed + i))).contiguous()
        for i in range(1, POOL)]


def file_inputs(dev, files: int, seconds: float):
    """(files, seconds·FILE_SR) riffs on the card and their valid frames
    (B,): plucks from 0.4 s, 0.7 s apart, over the 47 classes, noise of
    sigma 0.01; with several files, the last is zero past 75 % of its
    length (6 s of 8 s)."""
    import torch
    k = len(np.arange(0.4, seconds - 0.45, 0.7))  # notes per riff
    midi = 40 + np.arange(files * k).reshape(files, k) % 47
    riffs = make_riffs(midi, seconds, FILE_SR, SEED + 1, noise=0.01)
    n = riffs.shape[1]
    nv = np.full(files, n)
    if files > 1:
        nv[-1] = int(0.75 * n)
        riffs[-1, nv[-1]:] = 0.0
    return (torch.from_numpy(riffs).to(dev),
            (1 + torch.from_numpy(nv) // 512).to(dev))


def envelope_bound(files: int, n: int, dev, hop: int = 512
                   ) -> tuple[float, str]:
    """K4's bound (`utils/roofline.py::envelope_cost`)."""
    roofline = load_roofline()
    return roofline.bound(*roofline.envelope_cost(files, n, FILE_SR, dev,
                                                  hop))


def time_envelope(onset, dev, failures: list) -> list[dict]:
    """K4 (`onset.onset_strength` of the package imported as `onset`)
    against its plain version at each of ENVELOPE_SHAPES: max abs error
    (atol 1e-3), kernel ms in CUDA events over POOL distinct buffers, its
    two kernels' device ms per call in the profiler, plain ms, bound."""
    import torch
    rows = []
    for files, seconds in ENVELOPE_SHAPES:
        y, nvf = file_inputs(dev, files, seconds)
        n = y.shape[1]
        pool = noisy_pool(y, SEED + 10, 0.001)

        def fn(x):
            return onset.onset_strength(x, FILE_SR, n_valid_frames=nvf)

        def plain(x):
            return onset.onset_strength_plain(x, FILE_SR, n_valid_frames=nvf)

        got, ref = fn(y), plain(y)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        ok = err <= 1e-3 and bool(torch.isfinite(got).all())
        if not ok:
            failures.append(f"onset_envelope at {files} x {seconds:g} s")
        row = dict(files=files, frames=1 + n // 512, max_abs_err=err,
                   ms=time_ms(fn, pool, reps=10),
                   device_ms=kernel_device_ms(fn, pool, "K4"),
                   plain_ms=time_ms(plain, pool, reps=10))
        row["bound_ms"], row["bound_by"] = envelope_bound(files, n, dev)
        log(f"[time] onset_envelope at {files} x {seconds:g} s "
            f"({row['frames']} frames): kernel {row['ms']:.4f} ms (events), "
            f"{fmt_ms(row['device_ms'])} device (profiler), plain "
            f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}); max abs err {err:.3g} (atol 1e-3) -> "
            f"{'ok' if ok else 'FAIL'}")
        rows.append(row)
    return rows


SHARED_FLAGS = ((True, False), (True, True), (False, True), (False, False))

# K2, K3 and K6: kernel, source, the TPU kernel or XLA program replaced,
# and the tolerance `time_clip_kernels` holds each to
CLIP_KERNELS = {
    "mfcc_frontend": (
        "K2", "gat_tpu_torch/csrc/mfcc_frontend.cu",
        "gat_tpu/ops/pallas/mfcc_frontend.py:87",
        "atol 1e-3 on the 64 coefficients, also at 10 and 3 frames"),
    "yin_pitch": (
        "K3", "gat_tpu_torch/csrc/yin_pitch.cu", "gat_tpu/ops/yin.py:267",
        "rtol 2e-3 on the pitch of every clip"),
    "mfcc_pitch_frontend": (
        "K6", "gat_tpu_torch/csrc/mfcc_pitch_frontend.cu",
        "gat_tpu/features.py:67",
        "MFCC atol 1e-3 and rtol 2e-6, pitch rtol 2e-3 on every clip, "
        "against the plain shared front-end at the four flag "
        "combinations"),
}


def check_clip_kernel(name: str, features, yin, clips) -> tuple[float, bool]:
    """(max abs error, ok) of one of CLIP_KERNELS on `clips` against its
    plain version, at the tolerance CLIP_KERNELS states; logged."""
    import torch
    if name == "mfcc_frontend":
        def err_of(x):
            d = features.mfcc_frontend(x, SR) - features.mfcc_frontend_plain(
                x, SR)
            return float(d.abs().max())
        err = err_of(clips)
        ok = err <= 1e-3
        # 10 frames, and 3: an odd count runs with a zero partner
        for short_len in (4608, 1100):
            e = err_of(clips[:, :short_len].contiguous())
            log(f"[check] mfcc_frontend at {short_len} samples "
                f"({1 + short_len // 512} frames): max abs err {e:.6g}")
            ok = ok and e <= 1e-3
    elif name == "yin_pitch":
        got, ref = yin.yin_pitch(clips, SR), yin.yin_pitch_plain(clips, SR)
        rel = (got - ref).abs() / ref.abs()
        err = float((got - ref).abs().max())
        ok = float(rel.max()) <= 2e-3 and bool(torch.isfinite(got).all())
        log(f"[check] yin_pitch max rel err {float(rel.max()):.3g}, clips "
            f"over rtol 2e-3: {int((rel > 2e-3).sum())}")
    else:
        err, ok = 0.0, True
        for norm, pon in SHARED_FLAGS:
            got, hz = features.mfcc_pitch_features(clips, SR, 64, norm, pon)
            ref, ref_hz = features.mfcc_pitch_features_plain(clips, SR, 64,
                                                             norm, pon)
            d = (got[:, :64] - ref[:, :64]).abs()
            rel = (hz / ref_hz - 1).abs()
            n_over = int((rel > 2e-3).sum())
            err = max(err, float(d.max()))
            ok = (ok and bool((d <= 1e-3 + 2e-6 * ref[:, :64].abs()).all())
                  and n_over == 0 and bool(torch.isfinite(got).all()))
            log(f"[check] mfcc_pitch_frontend normalize={norm} "
                f"pitch_on_normalized={pon}: MFCC max abs err "
                f"{float(d.max()):.3g}, pitch max rel {float(rel.max()):.3g}"
                f", clips over rtol 2e-3: {n_over}")
    log(f"[check] {name}: max abs err {err:.6g} ({CLIP_KERNELS[name][3]}) "
        f"-> {'ok' if ok else 'FAIL'}")
    return err, ok


def time_clip_kernels(features, yin, clips, failures: list,
                      names=tuple(CLIP_KERNELS)) -> list[dict]:
    """The kernels-line rows of `names` among K2, K3 and K6 (CLIP_KERNELS;
    of the package whose `features` and `yin` are passed, K6 left out
    where it has none) at `clips`, the clip path's 1024 clips of 0.5 s:
    each checked against its plain version (`check_clip_kernel`), then
    timed: kernel ms in CUDA events over POOL distinct buffers, device
    ms in the profiler, plain ms, and the bound of `utils/roofline.py`.
    `launches` is 0: the path that drives a kernel fills it in."""
    import torch
    roofline = load_roofline()
    n, length = clips.shape
    pool = noisy_pool(clips, SEED, 0.01)
    specs = {"mfcc_frontend": (lambda x: features.mfcc_frontend(x, SR),
                               lambda x: features.mfcc_frontend_plain(x, SR),
                               lambda: roofline.mfcc_cost(n, length, SR,
                                                          clips.device)),
             "yin_pitch": (lambda x: yin.yin_pitch(x, SR),
                           lambda x: yin.yin_pitch_plain(x, SR),
                           lambda: roofline.yin_cost(n, length, SR))}
    if hasattr(features, "mfcc_pitch_features"):
        specs["mfcc_pitch_frontend"] = (
            lambda x: features.mfcc_pitch_features(x, SR),
            lambda x: features.mfcc_pitch_features_plain(x, SR),
            lambda: roofline.mfcc_pitch_cost(n, length, SR, clips.device))
    rows = []
    for name in (m for m in names if m in specs):
        fn, plain, cost = specs[name]
        kernel, source, replaces, tolerance = CLIP_KERNELS[name]
        err, ok = check_clip_kernel(name, features, yin, clips)
        if not ok:
            failures.append(f"{name} against its plain version")
        bound_ms, bound_by = roofline.bound(*cost())
        row = dict(name=name, route="cuda", source=source, replaces=replaces,
                   launches=0, max_abs_err=err, tolerance=tolerance,
                   ms=time_ms(fn, pool, reps=10), plain_ms=time_ms(
                       plain, pool, reps=10), bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=None,
                   device_ms=kernel_device_ms(
                       fn, pool, kernel,
                       roofline.KERNEL_SYMBOLS[kernel][:1]))
        log(f"[time] {name} at {n} x {length}: kernel {row['ms']:.4f} ms "
            f"(events), {fmt_ms(row['device_ms'])} device (profiler), plain "
            f"{row['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        rows.append(row)
        torch.cuda.synchronize()
    return rows


def pick_steps(onset, env, counts) -> dict:
    """The steps of one K5 wrapper call at max_onsets 64, as the tree of
    the package imported as `onset` takes them, each a callable: `alloc`
    the outputs, `cast` the valid counts, `call` the entry point's
    resolve and the ctypes call (the launch). A tree without the lean
    launch path (no `_pick_outputs`) takes five torch.empty, a cast to
    int32 and a resolve that sets the argument types on every call."""
    import torch
    b, t = env.shape
    dev = env.device
    if hasattr(onset, "_pick_outputs"):
        def alloc():
            return onset._pick_outputs(b, 64, dev)

        def cast():
            return onset._frame_counts(counts, dev)
    else:
        def alloc():
            return tuple(torch.empty(shape, dtype=dtype, device=dev)
                         for shape, dtype in (((b, 64), torch.int32),
                                              ((b, 64), torch.bool),
                                              (b, torch.bool), (b, torch.bool),
                                              (b, torch.int32)))

        def cast():
            return counts.to(device=dev, dtype=torch.int32).contiguous()
    outs, nvf = alloc(), cast()
    pre_max, post_max, pre_avg, post_avg, wait = onset.peak_pick_params(
        FILE_SR, 512)
    size, left = onset._max_window(pre_max, post_max)
    args = (env.data_ptr(), nvf.data_ptr(), *(o.data_ptr() for o in outs),
            b, t, size, left, pre_avg, post_avg, 0.07, wait, 512,
            int(0.3 * FILE_SR), 64, onset.candidate_limit(t, 64, None), 1,
            torch.cuda.current_stream().cuda_stream)

    def call(keep=(outs, nvf)):  # the pointers' tensors live with it
        return onset.kernels.function("onset_pick", "gat_onset_pick",
                                      onset._PICK_ARGS)(*args)
    return dict(alloc=alloc, cast=cast, call=call)


def pick_bound(files: int, t: int, hop: int = 512,
               max_onsets: int = 64) -> tuple[float, str]:
    """K5's bound (`utils/roofline.py::pick_cost`)."""
    roofline = load_roofline()
    return roofline.bound(*roofline.pick_cost(files, t, FILE_SR, hop,
                                              max_onsets))


def time_pick(onset, dev, failures: list) -> list[dict]:
    """K5 (`onset.pick_onsets` of the package imported as `onset`) at each
    of PICK_SHAPES, on K4's envelopes of the riffs: all five outputs
    identical to the plain version's for cand_budget None, 0 and 4; then
    kernel ms in CUDA events over POOL distinct envelopes, device ms in
    the profiler, plain ms, the wrapper's host µs per call and its parts,
    bound. The valid counts are what the tree's `detect_onsets` hands
    K5: int32 with the lean launch path, int64 before it. A shape the
    kernel refuses is a row with `refused` and a failure."""
    import torch
    counts_dtype = (torch.int32 if hasattr(onset, "_frame_counts")
                    else torch.int64)
    rows = []
    for files, seconds in PICK_SHAPES:
        y, nvf = file_inputs(dev, files, seconds)
        counts = nvf.to(counts_dtype)
        env_pool = [onset.onset_strength(x, FILE_SR, n_valid_frames=nvf)
                    for x in noisy_pool(y, SEED + 10, 0.001)]
        t = env_pool[0].shape[1]
        row = dict(files=files, frames=t)
        tag = f"onset_pick at {files} x {seconds:g} s ({t} frames)"

        def pick(e, cand_budget=None):
            return onset.pick_onsets(e, FILE_SR, 512, 0.3, 64,
                                     n_valid_frames=counts,
                                     cand_budget=cand_budget)

        def pick_plain(e, cand_budget=None):
            return onset.pick_onsets_plain(e, FILE_SR, 512, 0.3, 64,
                                           n_valid_frames=counts,
                                           cand_budget=cand_budget)
        try:
            same, err, kept = True, 0.0, None
            for cand_budget in (None, 0, 4):
                got = pick(env_pool[0], cand_budget)
                ref = pick_plain(env_pool[0], cand_budget)
                torch.cuda.synchronize()
                same = same and all(torch.equal(a, b) for a, b in zip(got, ref))
                err = max(err, float((got[0] - ref[0]).abs().max()))
                kept = int(ref[4].sum()) if kept is None else kept
        except RuntimeError as exc:
            row["refused"] = str(exc)
            failures.append(f"{tag}: {exc}")
            log(f"[time] {tag}: refused ({exc})")
            rows.append(row)
            continue
        if not same:
            failures.append(tag)
        steps = pick_steps(onset, env_pool[0], counts)
        parts = {k: host_us(lambda _, f=f: f(), env_pool, reps=30)
                 for k, f in steps.items()}
        row.update(identical=same, max_abs_err=err,
                   onsets_kept=kept,
                   ms=time_ms(pick, env_pool, reps=10),
                   device_ms=kernel_device_ms(pick, env_pool, "K5"),
                   plain_ms=time_ms(pick_plain, env_pool, reps=3),
                   host_us=host_us(pick, env_pool, reps=30))
        parts["rest"] = row["host_us"] - sum(parts.values())
        row["host_parts_us"] = parts
        row["bound_ms"], row["bound_by"] = pick_bound(files, t)
        log(f"[time] {tag}: kernel {row['ms']:.4f} ms (events), "
            f"{fmt_ms(row['device_ms'])} device (profiler), wrapper host "
            f"{row['host_us']:.1f} us per call (alloc {parts['alloc']:.1f}, "
            f"cast {parts['cast']:.1f}, call {parts['call']:.1f}, rest "
            f"{parts['rest']:.1f}), plain {row['plain_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.5f} ms ({row['bound_by']}); outputs "
            f"identical {same} for cand_budget None, 0, 4 "
            f"({row['onsets_kept']} onsets) -> {'ok' if same else 'FAIL'}")
        rows.append(row)
    return rows


def profile_call(fn, wall_ms: float, host_ops: int = 0) -> float | None:
    """Device time by kernel over one call under torch.profiler, and the
    device's busy share of the call's unprofiled wall time; returns the
    busy ms, None when the profiler saw no device time. User annotations
    on the device (a `record_function` range such as the optimizer's
    step) span kernels already counted and are left out. `host_ops` > 0
    also prints that many host ops by their self CPU time (profiled, so
    inflated by the profiler's own cost per op)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kern = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    host = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CPU]
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:host_ops]:
        log(f"[profile] host {e.self_cpu_time_total / 1e3:9.3f} ms "
            f"x{e.count:<4d} {e.key[:90]}")
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    if busy <= 0:
        log("[profile] device time not measured (no kernel events)")
        return None
    log(f"[profile] device busy {busy:.3f} ms of {wall_ms:.3f} ms per call "
        f"({100 * busy / wall_ms:.1f}%)")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[profile] {e.self_device_time_total / 1e3:9.3f} ms "
            f"x{e.count:<3d} {e.key[:100]}")
    return busy


def mel_error(got, ref) -> tuple[float, bool]:
    """K1's max error in dB where the plain image is above -60 dB, and
    whether the image is within K1's tolerance."""
    import torch
    err = float((got - ref).abs()[ref > -60.0].max())
    return err, (err <= 0.1 and bool(torch.isfinite(got).all())
                 and float(got.min()) >= -100.0)


def check_file_kernels(dev, failures: list) -> list[dict]:
    """K4 and K5 against their plain versions at 64 riffs of 8 s, and
    both timed at the file path's shapes; returns their rows of the
    kernels line (launches filled in later)."""
    import torch
    from gat_tpu_torch.ops import onset
    t0 = time.perf_counter()
    y, nvf = file_inputs(dev, N_RIFFS, RIFF_SECONDS)
    log(f"[data] {N_RIFFS} riffs x {y.shape[1]} samples at {FILE_SR} Hz "
        f"({y.numel() * 4 / 1e6:.1f} MB) in {time.perf_counter() - t0:.1f} s")

    def envelope(x):
        return onset.onset_strength(x, FILE_SR, n_valid_frames=nvf)

    def envelope_plain(x):
        return onset.onset_strength_plain(x, FILE_SR, n_valid_frames=nvf)

    def pick(e):
        return onset.pick_onsets(e, FILE_SR, 512, 0.3, 64, n_valid_frames=nvf)

    # K4, and the onsets K5 picks from each envelope
    env, env_ref = envelope(y), envelope_plain(y)
    torch.cuda.synchronize()
    err4 = float((env - env_ref).abs().max())
    from_kernel, from_plain = pick(env), pick(env_ref)
    files_differ = int((from_kernel[0] != from_plain[0]).any(-1).sum()
                       + (from_kernel[1] != from_plain[1]).any(-1).sum())
    ok4 = (err4 <= 1e-3 and bool(torch.isfinite(env).all())
           and files_differ == 0)
    log(f"[check] onset_envelope: shape {tuple(env.shape)} max abs err "
        f"{err4:.6g} (atol 1e-3); files whose K5 onsets differ between the "
        f"kernel's and the plain envelope: {files_differ} -> "
        f"{'ok' if ok4 else 'FAIL'}")
    if not ok4:
        failures.append("onset_envelope")
    # the envelope must not depend on the first pass's grid
    same = all(torch.equal(onset.onset_strength(y, FILE_SR, n_valid_frames=nvf,
                                                grid=g), env)
               for g in (1, 97, 10 ** 6))
    log(f"[check] onset_envelope with grids 1, 97 and one above the rounds: "
        f"bit-identical {same}")
    if not same:
        failures.append("onset_envelope depends on its grid")

    # K4 and K5 at every shape, K5 checked there (their 64-riff numbers
    # make their kernels-line rows)
    shapes = time_envelope(onset, dev, failures)
    k5_shapes = time_pick(onset, dev, failures)
    k5 = next(r for r in k5_shapes
              if r["files"] == N_RIFFS and "refused" not in r)
    big = shapes[-1]
    rows = [dict(name="onset_envelope", route="cuda",
                 source="gat_tpu_torch/csrc/onset_envelope.cu",
                 replaces="gat_tpu/ops/onset.py:34", launches=0,
                 max_abs_err=err4,
                 tolerance="atol 1e-3 on the envelope; K5's onsets from it "
                           "identical",
                 ms=big["ms"], plain_ms=big["plain_ms"],
                 bound_ms=big["bound_ms"], bound_by=big["bound_by"],
                 library_ms=None, device_ms=big["device_ms"],
                 shapes=shapes),
            dict(name="onset_pick", route="cuda",
                 source="gat_tpu_torch/csrc/onset_pick.cu",
                 replaces="gat_tpu/ops/onset.py:178", launches=0,
                 max_abs_err=max(r.get("max_abs_err", 0.0)
                                 for r in k5_shapes),
                 tolerance="all five outputs identical",
                 ms=k5["ms"], plain_ms=k5["plain_ms"],
                 bound_ms=k5["bound_ms"], bound_by=k5["bound_by"],
                 library_ms=None, device_ms=k5["device_ms"],
                 host_us=k5["host_us"], host_parts_us=k5["host_parts_us"],
                 shapes=k5_shapes)]
    torch.cuda.synchronize()
    return rows


GATE_FILES = 4        # [gate]: the serving wave, 4 files x 60 s at 22050 Hz
GATE_SECONDS = 60.0
GATE_ONSETS = 112     # its onset budget: 448 slots of 11,025 samples
GATE_SPACING = 0.55   # a pluck every 0.55 s: 108 per file


def gate_errors(got: dict, ref: dict, y, min_db: float | None,
                hop: int) -> tuple[dict, bool]:
    """K7's parts (`gating.noise_gate(parts=True)`) against the plain
    gate's (`gating.gate_parts_plain`), at the bounds of
    `tests/emulated_kernels.py::check_gate`: envelope, median
    and gate_db within 1e-4 dB; frame masks equal except at frames within
    1e-3 dB of gate_db; gated samples bit-equal where the frame decision
    agrees and the sample's dB is not within 1e-4 dB of min_db. Returns
    the errors and the counts let through, and whether all hold."""
    import torch
    err = {k: float((got[k] - ref[k]).abs().max())
           for k in ("env", "med", "gate_db")}
    near = (ref["med"] - ref["gate_db"][:, None]).abs() < 1e-3
    flipped = got["frame_mask"] != ref["frame_mask"]
    n = y.shape[1]
    agree = ~flipped.repeat_interleave(hop, dim=1)[:, :n]
    if min_db is not None:
        amp_db = 20.0 * torch.log10(y.abs() + 1e-10)
        agree &= (amp_db - min_db).abs() >= 1e-4
    same = got["out"].view(torch.int32) == ref["out"].view(torch.int32)
    out = dict(err, frames_flipped=int(flipped.sum()),
               frames_flipped_far=int((flipped & ~near).sum()),
               samples_excused=int((~agree).sum()),
               samples_differing=int((~same & agree).sum()),
               gated_max_abs_err=float((got["out"] - ref["out"]).abs().max()))
    ok = (max(err.values()) <= 1e-4 and out["frames_flipped_far"] == 0
          and out["samples_differing"] == 0
          and bool(torch.isfinite(got["out"]).all()))
    return out, ok


def slice_errors(got: tuple, ref: tuple, min_db: float) -> tuple[dict, bool]:
    """K8 against the plain slicer: clips and times bit-equal, kept equal
    except where the clip's dB is within 1e-4 dB of min_db."""
    import torch
    from gat_tpu_torch.segment.gating import slice_rms_db
    near = (slice_rms_db(ref[0]) - min_db).abs() < 1e-4
    out = dict(clips_max_abs_err=float((got[0] - ref[0]).abs().max()),
               clips_bits_equal=bool(torch.equal(got[0].view(torch.int32),
                                                 ref[0].view(torch.int32))),
               times_equal=bool(torch.equal(got[2], ref[2])),
               kept_differing=int((got[1] != ref[1]).sum()),
               kept_differing_far=int(((got[1] != ref[1]) & ~near).sum()),
               kept=int(ref[1].sum()))
    ok = (out["clips_bits_equal"] and out["times_equal"]
          and out["kept_differing_far"] == 0)
    return out, ok


def gate_riffs(dev) -> tuple:
    """`[gate]`'s inputs on `dev`: the serving wave (GATE_FILES riffs of
    GATE_SECONDS at FILE_SR, a pluck every GATE_SPACING s, noise 0.01)
    with valid counts of the whole row and one not a multiple of 512, and
    one LONG_SECONDS riff with its count."""
    import torch

    def riffs(files: int, seconds: float, seed: int):
        k = len(np.arange(0.4, seconds - 0.45, GATE_SPACING))
        midi = 40 + np.arange(files * k).reshape(files, k) % 47
        return torch.from_numpy(make_riffs(midi, seconds, FILE_SR, seed,
                                           noise=0.01,
                                           spacing=GATE_SPACING)).to(dev)
    y_wave = riffs(GATE_FILES, GATE_SECONDS, SEED + 20)
    y_long = riffs(1, LONG_SECONDS, SEED + 21)
    n = y_wave.shape[1]
    nv_wave = torch.tensor([n, n, n - 12345, n], dtype=torch.int32,
                           device=dev)
    nv_long = torch.tensor([y_long.shape[1]], dtype=torch.int32, device=dev)
    return y_wave, nv_wave, y_long, nv_long


def time_gate(gating, dev, failures: list, data: tuple | None = None
              ) -> list[dict]:
    """K7 (`gating.noise_gate`, under `gate_waveform`) checked against the
    plain gate (`gate_errors`) and timed at the serving wave and the 400 s
    riff (`gate_riffs`, or `data`) with the file path's arguments: kernel
    ms in CUDA events over POOL distinct buffers, device ms in the
    profiler, in all and per pass (its device functions,
    `utils/roofline.py`'s KERNEL_SYMBOLS["K7"]), plain ms, and the bound
    (gate_cost). `tools/torch_onset_timing.py TREE gate` times another
    checkout's K7 with it, so two trees timed in turns compare like with
    like. Returns one row per shape."""
    from gat_tpu_torch.config import SLICER_CONFIG
    roofline = load_roofline()
    min_db = SLICER_CONFIG.MIN_IN_DB_THRESHOLD
    y_wave, nv_wave, y_long, nv_long = data or gate_riffs(dev)
    passes = roofline.KERNEL_SYMBOLS["K7"]
    rows = []
    for y, nv in ((y_wave, nv_wave), (y_long, nv_long)):
        files, rows_n = y.shape
        pool = noisy_pool(y, SEED + 22, 0.001)

        def gate(x):
            return gating.gate_waveform(x, min_db, n_valid=nv)

        def gate_plain(x):
            return gating.gate_waveform_plain(x, min_db, n_valid=nv)
        ok = gate_errors(gating.noise_gate(y, min_db, 512, nv, parts=True)[1],
                         gating.gate_parts_plain(y, min_db, 512, nv), y,
                         min_db, 512)[1]
        if not ok:
            failures.append(f"[gate] K7 at {files} x {rows_n} against the "
                            f"plain gate")
        by_pass = symbol_device_ms(gate, pool, passes)
        device = sum(ms or 0.0 for ms in by_pass.values()) or None
        row = dict(files=files, samples=rows_n, ms=time_ms(gate, pool, 10),
                   device_ms=device,
                   pass_device_ms={
                       p.removeprefix("noise_gate_").removesuffix(
                           "_kernel"): ms for p, ms in by_pass.items()},
                   plain_ms=time_ms(gate_plain, pool, reps=3))
        row["bound_ms"], row["bound_by"] = roofline.bound(
            *roofline.gate_cost(files, rows_n))
        log(f"[time] noise_gate at {files} x {rows_n}: kernel "
            f"{row['ms']:.4f} ms (events), {fmt_ms(device)} device "
            f"(profiler; "
            + ", ".join(f"{p} {fmt_ms(ms)}"
                        for p, ms in row["pass_device_ms"].items())
            + f"), plain {row['plain_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.5f} ms ({row['bound_by']})")
        if device is None:
            failures.append(f"[gate] K7 at {files} x {rows_n}: no device "
                            f"time in the profiler")
        rows.append(row)
    return rows


def gate_pass_blocks(kernels, n: int, hop: int) -> dict:
    """K7's passes at rows of n samples and this hop
    (`gat_noise_gate_pass_blocks`): resident blocks per SM of each, the
    threshold block's threads and whether it stages the envelope in
    shared memory."""
    out = (ctypes.c_int * 5)()
    kernels.check(kernels.function(
        "noise_gate", "gat_noise_gate_pass_blocks",
        [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])(
            n, hop, ctypes.addressof(out)), "noise_gate pass occupancy")
    return dict(rms=out[0], threshold=out[1], apply=out[2],
                threshold_threads=out[3], threshold_staged=bool(out[4]))


SLICE_LONG_CLIP = 4.0  # [gate]'s long clips: transcribe(clip_duration=4.0)
SLICE_LONG_EVERY = 8   # their onsets: every 8th of the wave's, 4.4 s apart


def long_clip_onsets(ons, valid) -> tuple:
    """Every SLICE_LONG_EVERY-th onset of each file and its flag, so that a
    window holds a whole SLICE_LONG_CLIP s clip."""
    return (ons[:, ::SLICE_LONG_EVERY].contiguous(),
            valid[:, ::SLICE_LONG_EVERY].contiguous())


def slice_data(slicing, dev) -> tuple:
    """K8's inputs as `[gate]` makes them: the serving wave and the 400 s
    riff (`gate_riffs`) with their counts, each with the onsets K4/K5 find
    in K7's output (`slicing`'s own gate and detection)."""
    from gat_tpu_torch.config import SLICER_CONFIG
    y_wave, nv_wave, y_long, nv_long = gate_riffs(dev)
    out = []
    for y, nv in ((y_wave, nv_wave), (y_long, nv_long)):
        gated = slicing.gating.gate_waveform(
            y, SLICER_CONFIG.MIN_IN_DB_THRESHOLD, n_valid=nv)
        ons, valid, *_ = slicing.detect_onsets(
            gated, sr=FILE_SR, min_sep=0.25, max_onsets=GATE_ONSETS,
            n_valid=nv)
        out += [y, nv, ons, valid]
    return tuple(out)


def time_slice(slicing, dev, failures: list, data: tuple | None = None
               ) -> list[dict]:
    """K8 (`slicing.slice_at_onsets`) checked against the plain slicer
    (`slice_errors`) and timed with the file path's arguments (the hop-512
    gather, the reference's last-note rule) at the serving wave (448 slots
    of 0.5 s), the 400 s riff (112 slots) and the wave's
    SLICE_LONG_CLIP s clips (`long_clip_onsets`, 56 slots of 88,200
    samples), on `slice_data`'s inputs or `data` (y_wave, nv_wave, ons,
    valid, y_long, nv_long, ons_l, valid_l): kernel ms in CUDA events over
    POOL distinct buffers, device ms in the profiler, plain ms, the bound
    (slice_cost at the samples these onsets' windows read), resident
    blocks per SM and the ring's stages and samples a stage (K8's
    `gat_slice_clips_ring`; None for a checkout without a ring).
    `tools/torch_onset_timing.py TREE slice` times another checkout's K8
    with it. Returns one row per shape."""
    from gat_tpu_torch.config import CLIP_DURATION, SLICER_CONFIG
    roofline = load_roofline()
    kernels = slicing.kernels
    y_wave, nv_wave, ons, valid, y_long, nv_long, ons_l, valid_l = (
        data or slice_data(slicing, dev))
    b = ctypes.c_int(0)
    kernels.check(kernels.function(
        "slice_clips", "gat_slice_clips_blocks_per_sm", [ctypes.c_void_p])(
            ctypes.addressof(b)), "slice_clips occupancy")
    stages = chunk = None
    try:
        shape = [ctypes.c_int(0) for _ in range(3)]
        kernels.check(kernels.function(
            "slice_clips", "gat_slice_clips_ring", [ctypes.c_void_p] * 3)(
                *map(ctypes.addressof, shape)), "slice_clips ring")
        stages, chunk, smem = (v.value for v in shape)
        ring = (f"a ring of {stages} stages of {chunk} samples, {smem} "
                f"bytes of shared memory a block")
    except AttributeError:  # a checkout whose K8 has no ring
        ring = "no ring"
    log(f"[occupancy] slice_clips: {b.value} resident blocks of 256 threads "
        f"per SM, {ring}")
    ons4, valid4 = long_clip_onsets(ons, valid)
    rows = []
    for y, nv, o, v, secs in (
            (y_wave, nv_wave, ons, valid, CLIP_DURATION),
            (y_long, nv_long, ons_l, valid_l, CLIP_DURATION),
            (y_wave, nv_wave, ons4, valid4, SLICE_LONG_CLIP)):
        files, rows_n = y.shape
        length = int(FILE_SR * secs)
        pool = noisy_pool(y, SEED + 22, 0.001)

        def cut(x):
            return slicing.slice_at_onsets(x, o, v, FILE_SR, secs,
                                           n_valid=nv, onset_hop=512)

        def cut_plain(x):
            return slicing.slice_at_onsets_plain(x, o, v, FILE_SR, secs,
                                                 n_valid=nv, onset_hop=512)
        ref = cut_plain(y)
        ok = slice_errors(cut(y), ref, SLICER_CONFIG.MIN_SLICE_RMS_DB)[1]
        slots = o.numel()
        tag = f"{files} x {rows_n} ({slots} slots of {length} samples)"
        if not ok:
            failures.append(f"[gate] K8 at {tag} against the plain slicer")
        # the samples K8's windows read: what these onsets open
        windows = roofline.window_samples(ref[2], v, nv, FILE_SR)
        row = dict(files=files, samples=rows_n, slots=slots,
                   clip_samples=length, window_samples=windows,
                   ms=time_ms(cut, pool, reps=10),
                   device_ms=kernel_device_ms(cut, pool, "K8"),
                   plain_ms=time_ms(cut_plain, pool, reps=3),
                   blocks_per_sm=b.value, stages=stages,
                   stage_samples=chunk, checked=ok)
        row["bound_ms"], row["bound_by"] = roofline.bound(
            *roofline.slice_cost(files, rows_n, slots, length, windows))
        log(f"[time] slice_clips at {tag}: kernel {row['ms']:.4f} ms "
            f"(events), {fmt_ms(row['device_ms'])} device (profiler), plain "
            f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms "
            f"({row['bound_by']}); {b.value} blocks/SM, {ring}; checked "
            f"{'ok' if ok else 'FAIL'}")
        if row["device_ms"] is None:
            failures.append(f"[gate] K8 at {tag}: no device time in the "
                            f"profiler")
        rows.append(row)
    return rows


def gate_phase(failures: list, device: str = "cuda") -> list[dict]:
    """`[gate]`: K7 (`csrc/noise_gate.cu`) and K8 (`csrc/slice_clips.cu`)
    against their plain twins on the card, at the serving wave (4 files x
    60 s at 22050 Hz, a pluck every 0.55 s, noise 0.01; 112 onsets a
    file, 448 slots of 11,025 samples) and at one 400 s riff (17,227
    frames at hop 512, 68,907 at hop 128, past the threshold pass's
    shared-memory limit): K7 with valid counts of the whole row and one
    not a multiple of 512, then rows of n_valid 0, 1500 and a third of the
    row off the 512 grid beside a whole one, a batch without counts, hop
    256 and `rms_gate` alone (the bounds of `gate_errors`); K8 on the
    onsets K4/K5 find in K7's output, by the hop-512 row gather and the
    per-sample gather, with both last-note rules (`slice_errors`), and at
    SLICE_LONG_CLIP s clips (88,200 samples, through K8's ring many
    times; the per-sample gather with slot j's onset moved by j samples,
    every source phase), and with a valid count past the last row's end
    (its last window crosses the row's end, both gathers). Then both
    timed at the wave and the riff, K8 also
    at the long clips (`time_gate`, `time_slice`): kernel ms in CUDA
    events over POOL distinct buffers, device ms in the profiler (K7's
    per pass), plain ms, bound (`utils/roofline.py`'s gate_cost, and
    slice_cost at the samples these onsets' windows read), blocks per SM
    (K7's per pass; K8's with its ring's stages); `library ms` null: no
    single PyTorch call computes either. Returns their kernels-line
    rows."""
    import torch
    from gat_tpu_torch import kernels
    from gat_tpu_torch.config import CLIP_DURATION, SLICER_CONFIG
    from gat_tpu_torch.ops import onset
    from gat_tpu_torch.segment import gating, slicing
    dev = torch.device(device)
    min_db = SLICER_CONFIG.MIN_IN_DB_THRESHOLD
    min_rms_db = SLICER_CONFIG.MIN_SLICE_RMS_DB

    def check_gate(tag, y, nv, mdb, hop=512):
        got = gating.noise_gate(y, mdb, hop, nv, parts=True)[1]
        ref = gating.gate_parts_plain(y, mdb, hop, nv)
        torch.cuda.synchronize()
        e, ok = gate_errors(got, ref, y, mdb, hop)
        log(f"[gate] K7 {tag}: env max abs err {e['env']:.3g} dB, median "
            f"{e['med']:.3g}, gate_db {e['gate_db']:.3g} (1e-4 dB); frames "
            f"flipped {e['frames_flipped']} (far from gate_db "
            f"{e['frames_flipped_far']}); samples excused by a flip or "
            f"min_db {e['samples_excused']}, differing elsewhere "
            f"{e['samples_differing']} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"[gate] K7 {tag}")
        return got["out"], e

    def check_slice(tag, y, ons, valid, nv, hop, strict,
                    length_sec=CLIP_DURATION):
        got = slicing.slice_at_onsets(y, ons, valid, FILE_SR, length_sec,
                                      strict_reference_compat=strict,
                                      n_valid=nv, onset_hop=hop)
        ref = slicing.slice_at_onsets_plain(y, ons, valid, FILE_SR,
                                            length_sec,
                                            strict_reference_compat=strict,
                                            n_valid=nv, onset_hop=hop)
        torch.cuda.synchronize()
        e, ok = slice_errors(got, ref, min_rms_db)
        log(f"[gate] K8 {tag} (onset_hop {hop}, strict {strict}): clips "
            f"bit-equal {e['clips_bits_equal']}, times equal "
            f"{e['times_equal']}, kept {e['kept']} of {ons.numel()} slots, "
            f"kept differing {e['kept_differing']} (far from min_db "
            f"{e['kept_differing_far']}) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"[gate] K8 {tag} onset_hop {hop} strict "
                            f"{strict}")
        return e

    t0 = time.perf_counter()
    data = gate_riffs(dev)
    y_wave, nv_wave, y_long, nv_long = data
    log(f"[data] [gate] {GATE_FILES} x {GATE_SECONDS:g} s and 1 x "
        f"{LONG_SECONDS:g} s riffs at {FILE_SR} Hz in "
        f"{time.perf_counter() - t0:.1f} s")
    n = y_wave.shape[1]
    # none, under a frame, a third of the row off the 512 grid, the row
    nv_edges = torch.tensor([0, 1500, n // 3 // 512 * 512 + 77, n],
                            dtype=torch.int32, device=dev)
    gated, e7 = check_gate(f"at the wave ({GATE_FILES} x {n})", y_wave,
                           nv_wave, min_db)
    errs7 = [e7]
    for tag, y, nv, mdb, hop in (
            (f"at n_valid {nv_edges.tolist()}", y_wave, nv_edges, min_db,
             512),
            ("without counts", y_wave, None, min_db, 512),
            ("at hop 256", y_wave, nv_wave, min_db, 256),
            ("rms_gate alone", y_wave, nv_wave, None, 512),
            (f"at 1 x {y_long.shape[1]} (400 s) hop 128, "
             f"{1 + y_long.shape[1] // 128} frames in device memory",
             y_long, nv_long, min_db, 128)):
        errs7.append(check_gate(tag, y, nv, mdb, hop)[1])
    gated_long, e = check_gate(f"at 1 x {y_long.shape[1]} (400 s)", y_long,
                               nv_long, min_db)
    errs7.append(e)

    def onsets_of(g, nv):
        ons, valid, *_ = onset.detect_onsets(g, sr=FILE_SR, min_sep=0.25,
                                             max_onsets=GATE_ONSETS,
                                             n_valid=nv)
        return ons, valid
    ons, valid = onsets_of(gated, nv_wave)
    errs8 = []
    for hop in (512, None):
        for strict in (True, False):
            errs8.append(check_slice("at the wave", y_wave, ons, valid,
                                     nv_wave, hop, strict))
    g_edges = gating.gate_waveform(y_wave, min_db, n_valid=nv_edges)
    ons_e, valid_e = onsets_of(g_edges, nv_edges)
    if bool(valid_e[:2].any()):
        failures.append("[gate] onsets found in rows of n_valid 0 or 1500")
    errs8.append(check_slice(f"at n_valid {nv_edges.tolist()}", y_wave,
                             ons_e, valid_e, nv_edges, 512, True))
    ons_l, valid_l = onsets_of(gated_long, nv_long)
    errs8.append(check_slice("at the 400 s riff", y_long, ons_l, valid_l,
                             nv_long, 512, True))
    # clips of transcribe(clip_duration=4.0), 88,200 samples, through K8's
    # ring many times: the hop-512 gather, and the per-sample one with
    # slot j's onset moved by j samples (every phase of the row)
    ons4, valid4 = long_clip_onsets(ons, valid)
    shift = torch.arange(ons4.shape[1], dtype=ons4.dtype, device=dev)
    for hop, o in ((512, ons4), (None, ons4 + shift)):
        for strict in (True, False):
            errs8.append(check_slice(
                f"at the wave, {SLICE_LONG_CLIP:g} s clips", y_wave, o,
                valid4, nv_wave, hop, strict, SLICE_LONG_CLIP))
    # a valid count past the last row's end: the 4.0 s window of its last
    # onset (strict False: cut by the count) crosses the row's end and the
    # tensor's, which the kernel reads as the plain slicer does, clamped,
    # and never past the row
    nv_past = nv_wave.clone()
    nv_past[-1] = n + int(SLICE_LONG_CLIP * FILE_SR)
    last = int(ons[-1][valid[-1]].max())
    crossing = (last + int(SLICER_CONFIG.ATTACK_SKIP_SEC * FILE_SR)
                + int(SLICE_LONG_CLIP * FILE_SR)) > n
    if not crossing:
        failures.append("[gate] K8 past the row: no window crosses the "
                        "row's end")
    for hop in (512, None):
        errs8.append(check_slice(
            f"at n_valid {nv_past.tolist()} (past the row of {n}), "
            f"{SLICE_LONG_CLIP:g} s clips, last onset {last}", y_wave, ons,
            valid, nv_past, hop, False, SLICE_LONG_CLIP))
    log(f"[gate] onsets at the wave {valid.sum(-1).tolist()} of "
        f"{GATE_ONSETS} slots a file; at the 400 s riff "
        f"{int(valid_l.sum())}")

    # timing at the wave and the 400 s riff, the path's arguments
    shapes7 = time_gate(gating, dev, failures, data)
    shapes8 = time_slice(slicing, dev, failures,
                         (y_wave, nv_wave, ons, valid, y_long, nv_long,
                          ons_l, valid_l))
    k7_blocks = {}
    for tag, rows_n, hop in (("wave", n, 512),
                             ("400 s", y_long.shape[1], 512),
                             ("400 s hop 128", y_long.shape[1], 128)):
        b = k7_blocks[tag] = gate_pass_blocks(kernels, rows_n, hop)
        log(f"[occupancy] noise_gate {tag}: rms {b['rms']}, threshold "
            f"{b['threshold']} ({b['threshold_threads']} threads, "
            f"envelope in {'shared' if b['threshold_staged'] else 'device'}"
            f" memory), apply {b['apply']} resident blocks per SM")
    shapes7[0]["pass_blocks_per_sm"] = k7_blocks["wave"]
    shapes7[1]["pass_blocks_per_sm"] = k7_blocks["400 s"]
    blocks = {"noise_gate": k7_blocks["wave"]["rms"],
              "slice_clips": shapes8[0]["blocks_per_sm"]}
    rows = []
    for name, source, replaces, errs, shapes, tol in (
            ("noise_gate", "gat_tpu_torch/csrc/noise_gate.cu",
             "gat_tpu/segment/gating.py:154", errs7, shapes7,
             "envelope, median and gate_db atol 1e-4 dB; frame masks equal "
             "but within 1e-3 dB of gate_db; gated samples bit-equal where "
             "the frame and sample decisions agree (samples within 1e-4 dB "
             "of min_db excused)"),
            ("slice_clips", "gat_tpu_torch/csrc/slice_clips.cu",
             "gat_tpu/segment/slicing.py:48", errs8, shapes8,
             "clips and times bit-equal; kept equal but within 1e-4 dB of "
             "min_slice_rms_db")):
        wave_row = shapes[0]
        if name == "noise_gate":
            err = max(max(e["env"], e["med"], e["gate_db"]) for e in errs)
            extra = dict(
                gated_max_abs_err=max(e["gated_max_abs_err"] for e in errs),
                frames_flipped=sum(e["frames_flipped"] for e in errs),
                samples_excused=sum(e["samples_excused"] for e in errs),
                threshold_staged_frames=gating.GATE_STAGED_FRAMES)
        else:
            err = max(e["clips_max_abs_err"] for e in errs)
            extra = dict(kept_differing=sum(e["kept_differing"]
                                            for e in errs))
        rows.append(dict(name=name, route="cuda", source=source,
                         replaces=replaces, launches=0, max_abs_err=err,
                         tolerance=tol, ms=wave_row["ms"],
                         plain_ms=wave_row["plain_ms"],
                         bound_ms=wave_row["bound_ms"],
                         bound_by=wave_row["bound_by"], library_ms=None,
                         device_ms=wave_row["device_ms"],
                         blocks_per_sm=blocks[name], shapes=shapes, **extra))
        log(f"[occupancy] {name}: {blocks[name]} resident blocks of 256 "
            f"threads per SM")
    torch.cuda.synchronize()
    return rows


# [resample]: K9 at the serving wave's clip re-rate (the budget's 384 of
# 448 slots of 0.5 s at 22050 Hz, cut to the checkpoint's clip length),
# at four files a user loads: 60 s and 400 s at 48 kHz (m = 8.82 M:
# j·down passes 2^31), 60 s at 16 kHz and 60 s at 44.1 kHz (a CD-rate
# WAV, up == 1 on one long row), and at one note of 0.5 s at 22050 Hz to
# the checkpoint rate (`transcribe_note`'s re-rate, one a note in
# `LiveTranscriber`: a launch of few tiles); (tag, rows, seconds, from, to)
RESAMPLE_SHAPES = (("wave", 448, 0.5, FILE_SR, SR),
                   ("60 s at 48 kHz", 1, 60.0, 48000, FILE_SR),
                   ("400 s at 48 kHz", 1, LONG_SECONDS, 48000, FILE_SR),
                   ("60 s at 16 kHz", 1, 60.0, 16000, FILE_SR),
                   ("60 s at 44.1 kHz", 1, 60.0, 44100, FILE_SR),
                   ("0.5 s note", 1, 0.5, FILE_SR, SR))
RESAMPLE_BUDGET = 384  # the serving wave's clip budget (serve's default)


def resample_data(dev) -> list:
    """[resample]'s inputs on `dev`, one (x, rows) per RESAMPLE_SHAPES
    entry: the wave's 448 slots cut from `gate_riffs`' four 60 s riffs,
    0.5 s each, with the budget's slot-major selection of 384 of them (as
    `build_files_fn` picks them when every slot is kept; rows None
    elsewhere), riffs of a pluck every GATE_SPACING s at the file rates,
    and the note: a pluck from its onset, 0.5 s of a 1 s riff."""
    import torch
    out = []
    for i, (tag, rows, seconds, orig, _) in enumerate(RESAMPLE_SHAPES):
        files = GATE_FILES if tag == "wave" else rows
        secs = (GATE_SECONDS if tag == "wave" else
                max(seconds, 1.0))
        k = len(np.arange(0.4, secs - 0.45, GATE_SPACING))
        midi = 40 + np.arange(files * k).reshape(files, k) % 47
        y = make_riffs(midi, secs, orig, SEED + 20 + i, noise=0.01,
                       spacing=GATE_SPACING)
        sel = None
        if secs > seconds and tag != "wave":  # the note, from its onset
            y = y[:, int(0.4 * orig):int(0.4 * orig) + int(seconds * orig)]
        if tag == "wave":
            length = int(seconds * orig)
            y = y[:, :rows // files * length].reshape(rows, length)
            p = np.arange(RESAMPLE_BUDGET)
            sel = torch.from_numpy((p % files) * (rows // files)
                                   + p // files).to(dev)
        out.append((torch.from_numpy(np.ascontiguousarray(y)).to(dev), sel))
    return out


def call_device_ms(fn, pool) -> float | None:
    """Device time per call of every kernel, copy and fill fn launches,
    from torch.profiler over one call on every buffer of the pool; None
    when the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for x in pool:
        fn(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for x in pool:
            fn(x)
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False))
    return total / len(pool) / 1e3 if total > 0 else None


# gat_resample_layout's fields, in order (csrc/resample.cu)
RESAMPLE_LAYOUT = ("tile", "buf", "taps", "bytes", "rows", "frames",
                   "groups", "lag", "steps", "phases", "per_lane")


def resample_layout(resample, up: int, down: int) -> dict:
    """K9's layout at these rates (`gat_resample_layout`), by name; for
    K9's first design (a checkout without `polyphase_bank`, timed by
    `tools/torch_onset_timing.py`), its four fields: outputs a block,
    span floats, table floats, bytes."""
    k_taps = -(-resample.resample_filter(up, down).shape[0] // up)
    names = (RESAMPLE_LAYOUT if hasattr(resample, "polyphase_bank")
             else RESAMPLE_LAYOUT[:4])
    vals = (ctypes.c_int * len(names))()
    args = ([vals] if len(names) > 4 else
            [ctypes.addressof(vals) + 4 * i for i in range(4)])
    resample.kernels.check(resample.kernels.function(
        "resample", "gat_resample_layout",
        [ctypes.c_int] * 3 + [ctypes.c_void_p] * len(args))(
            up, down, k_taps, *args), "resample layout")
    return dict(zip(names, vals))


def time_resample(resample, dev, failures: list, data: list | None = None
                  ) -> list[dict]:
    """K9 (`resample.resample_rows` at the wave, `resample.resample` at
    the files) checked against the plain route (`resample_plain`, the
    reference's matmul or convolution route; atol 1e-5) and timed at
    RESAMPLE_SHAPES on `resample_data`'s inputs or `data`: kernel ms in
    CUDA events over POOL distinct buffers, K9's device ms and the whole
    call's (every kernel it launches) in the profiler, the plain route's
    ms (at the wave with its gather and fix_length: the parent's
    `compaction` gather and `clip_rerate`), the bound
    (`utils/roofline.py`'s resample_cost at the outputs written, with the
    wave's int32 index), resident blocks per SM and K9's layout (shared
    memory a block, rows or span, frames and groups a tile), and
    `library_ms`, one `F.conv1d` of the same rows with TF32 off at every
    rate pair: `resample.polyphase_bank`'s up channels at stride down over
    the rows padded beforehand (torchaudio's form; at up == 1 the filter
    itself), its largest difference from the plain route logged; the
    pad and the channels' interleave are outside the timed call. A
    checkout without K9
    (`tools/torch_onset_timing.py TREE resample` on the parent) has no
    `resample_plain`: its `resample` is the plain route, timed as the
    kernel, with no device ms of K9 and no blocks. Returns one row per
    shape."""
    import torch
    import torch.nn.functional as F
    from gat_tpu_torch.config import CLIP_DURATION
    from gat_tpu_torch.utils.device import tf32_off
    roofline = load_roofline()
    data = data or resample_data(dev)
    k9 = hasattr(resample, "resample_plain")
    plain_resample = resample.resample_plain if k9 else resample.resample
    rows = []
    for (tag, _, _, orig, target), (x, sel) in zip(RESAMPLE_SHAPES, data):
        g = int(np.gcd(orig, target))
        up, down = target // g, orig // g
        n_src, n = x.shape
        m = -(-n * up // down)
        if sel is None:
            out_len, picked = m, n_src

            def fn(z):
                return resample.resample(z, orig, target)

            def plain(z):
                return plain_resample(z, orig, target)
        else:
            out_len, picked = int(target * CLIP_DURATION), sel.numel()
            if k9:
                def fn(z):
                    return resample.resample_rows(z, sel, orig, target,
                                                  out_len)
            else:
                def fn(z):
                    return resample.fix_length(
                        resample.resample(z[sel], orig, target), out_len)

            def plain(z):
                return resample.fix_length(plain_resample(z[sel], orig,
                                                          target), out_len)
        pool = noisy_pool(x, SEED + 23, 0.001)
        before = resample.resample.launches if k9 else 0
        got = fn(x)
        launched = (resample.resample.launches - before) if k9 else None
        ref = plain(x)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        ok = (got.shape == ref.shape == (picked, out_len)
              and bool(torch.isfinite(got).all()) and err <= 1e-5
              and launched in (None, 1))
        library_ms = lib_err = None
        if hasattr(resample, "polyphase_bank"):
            bank = torch.from_numpy(resample.polyphase_bank(up, down)[0]
                                    ).to(dev)
            lib_pool = [resample.conv_input(z if sel is None else z[sel],
                                            orig, target) for z in pool]

            def lib(z):
                return F.conv1d(z, bank, stride=down)
            with tf32_off(dev, convolutions=True):
                lib_out = resample.fix_length(resample.resample_conv(
                    x if sel is None else x[sel], orig, target,
                    bank=bank), out_len)
                lib_err = float((lib_out - ref).abs().max())
                library_ms = time_ms(lib, lib_pool, reps=10)
            del lib_out, lib_pool
        del got, ref
        cost = roofline.resample_cost(picked, n, orig, target, out_len)
        if sel is not None:
            cost = (cost[0], cost[1] + 4 * picked)
        row = dict(shape=tag, rows=picked, samples=n, orig_sr=orig,
                   target_sr=target, out_len=out_len, up=up, down=down,
                   route="K9" if k9 else "plain", max_abs_err=err,
                   launches=launched, ms=time_ms(fn, pool, reps=10),
                   device_ms=kernel_device_ms(fn, pool, "K9") if k9 else None,
                   call_device_ms=call_device_ms(fn, pool),
                   plain_ms=time_ms(plain, pool, reps=3),
                   library_ms=library_ms, library_max_abs_err=lib_err,
                   checked=ok)
        row["bound_ms"], row["bound_by"] = roofline.bound(*cost)
        row["blocks_per_sm"] = (resample.resample_blocks_per_sm(orig, target)
                                if k9 else None)
        layout = ""
        if k9:
            lay = resample_layout(resample, up, down)
            row.update(smem_bytes=lay["bytes"], taps_in_smem=lay["taps"] > 0,
                       layout=lay)
            table = lay["taps"] or "through the read-only cache"
            layout = (f", {lay['tile']} outputs a tile "
                      f"({'rows' if lay['rows'] else 'span'} of "
                      f"{lay['frames']} frames x {lay['groups']} groups, "
                      f"{lay['per_lane']} frames a lane, lag {lay['lag']}, "
                      f"{lay['steps']} steps), "
                      f"{lay['bytes']} bytes of shared memory (buffers 2 x "
                      f"{lay['buf']} floats, table {table})"
                      if "rows" in lay else
                      f", {lay['tile']} outputs a block, {lay['bytes']} "
                      f"bytes of shared memory (span {lay['buf']} floats, "
                      f"table {table})")
        log(f"[time] resample {tag} ({picked} x {n} at {orig} -> {target} "
            f"Hz, up {up} down {down}, {out_len} outputs a row): "
            f"{row['route']} {row['ms']:.4f} ms (events), "
            f"{fmt_ms(row['device_ms'])} device (profiler), the call "
            f"{fmt_ms(row['call_device_ms'])} device; plain "
            f"{row['plain_ms']:.4f} ms, library "
            f"{fmt_ms(library_ms)} (max abs err {lib_err}), bound "
            f"{row['bound_ms']:.5f} ms "
            f"({row['bound_by']}); max abs err {err:.3g} (atol 1e-5); "
            f"{row['blocks_per_sm']} blocks/SM{layout} -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"[resample] {tag}: against the plain route "
                            f"(err {err:.3g}, launches {launched})")
        if k9 and row["device_ms"] is None:
            failures.append(f"[resample] {tag}: no device time of K9 in "
                            f"the profiler")
        rows.append(row)
        del pool
    torch.cuda.synchronize()
    return rows


def resample_phase(failures: list, device: str = "cuda") -> list[dict]:
    """`[resample]`: K9 (`csrc/resample.cu`) against the plain route at
    RESAMPLE_SHAPES, timed (`time_resample`); returns its kernels-line
    row, the wave's numbers with every shape's in `shapes`."""
    import torch
    from gat_tpu_torch.ops import resample
    shapes = time_resample(resample, torch.device(device), failures)
    wave = shapes[0]
    torch.cuda.synchronize()
    return [dict(name="resample", route="cuda",
                 source="gat_tpu_torch/csrc/resample.cu",
                 replaces="gat_tpu/ops/resample.py:89", launches=0,
                 max_abs_err=max(s["max_abs_err"] for s in shapes),
                 tolerance="atol 1e-5 against the plain route "
                           "(resample_plain: the reference's matmul or "
                           "convolution route, TF32 off)",
                 ms=wave["ms"], plain_ms=wave["plain_ms"],
                 bound_ms=wave["bound_ms"], bound_by=wave["bound_by"],
                 library_ms=wave["library_ms"], device_ms=wave["device_ms"],
                 blocks_per_sm=wave["blocks_per_sm"], shapes=shapes)]


# [compact]: K10 at the serving wave (4 files x 112 slots, budget 384 as
# [resample] and torch_roofline_files.py take it), with the kept bits of
# [gate]'s riffs and of torch_roofline_files.py's default (noise) wave,
# random bits that overflow the budget, a 64-file wave of 7,168 slots and
# the mesh's (first, n_local) for 2 and 4 ranks
COMPACT_FILES, COMPACT_SLOTS, COMPACT_BUDGET = 4, 112, 384
COMPACT_BIG = (64, 112, 5376)   # 3/4 of its slots
COMPACT_CLASSES = 47
COMPACT_CAND = 448     # the serve defaults' candidate budget (the roofline's)
COMPACT_WORLDS = (2, 4)


def wave_segment(y, nv, dev):
    """The serving wave's kept bits (files, 112) of the riffs y with valid
    counts nv, segmented as the file body segments them on `dev`."""
    from gat_tpu_torch.segment.slicing import segment_waveform
    return segment_waveform(y, sr=FILE_SR, length_sec=0.5,
                            max_onsets=COMPACT_SLOTS, n_valid=nv,
                            cand_budget=COMPACT_CAND)[1]


def noise_wave(dev):
    """torch_roofline_files.py's default wave, its first input: 4 files of
    60 s of Gaussian noise (sigma 0.05, numpy seed 0) and their counts."""
    import torch
    n = int(60.0 * FILE_SR)
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.normal(0, 0.05, (COMPACT_FILES, n))
                         .astype(np.float32)).to(dev)
    return y, torch.full((COMPACT_FILES,), n, dtype=torch.int32, device=dev)


def compact_data(dev) -> list:
    """[compact]'s cases on `dev`: (tag, kept bits (files, K) bool, budget,
    world) with world 1 for one device, else every rank's (first,
    n_local) of it is checked."""
    import torch
    gen = torch.Generator("cpu").manual_seed(SEED + 30)

    def bits(files, k, density):
        return (torch.rand((files, k), generator=gen) < density).to(dev)
    y, nv, _, _ = gate_riffs(dev)
    riffs = wave_segment(y, nv, dev)
    noise = wave_segment(*noise_wave(dev), dev)
    files, k, budget = COMPACT_BIG
    cases = [("wave", bits(COMPACT_FILES, COMPACT_SLOTS, 0.5),
              COMPACT_BUDGET, 1),
             ("wave_riffs", riffs, COMPACT_BUDGET, 1),
             ("wave_noise", noise, COMPACT_BUDGET, 1),
             ("overflow", bits(COMPACT_FILES, COMPACT_SLOTS, 0.97),
              COMPACT_BUDGET, 1),
             ("wave64", bits(files, k, 0.6), budget, 1)]
    cases += [(f"wave_riffs_mesh{w}", riffs, COMPACT_BUDGET, w)
              for w in COMPACT_WORLDS]
    cases += [(f"wave64_mesh{w}", cases[4][1], budget, w)
              for w in COMPACT_WORLDS]
    return cases


def compact_parts(rows: int, dev, seed: int) -> tuple:
    """Compact outputs of `rows` rows as the file body's classify gives
    them: blended, MLP and CNN probs (rows, 47) and the pitch (rows,)."""
    import torch
    gen = torch.Generator("cpu").manual_seed(seed)
    mats = [torch.softmax(torch.randn((rows, COMPACT_CLASSES), generator=gen),
                          -1).to(dev) for _ in range(3)]
    return (*mats, (80.0 + 900.0 * torch.rand(rows, generator=gen)).to(dev))


def same_selection(got, ref) -> bool:
    """K10's selection equal to the plain one, field by field (sel in the
    same order)."""
    return got.n_sel == ref.n_sel and all(
        getattr(got, f).dtype == getattr(ref, f).dtype
        and bool((getattr(got, f) == getattr(ref, f)).all())
        and getattr(got, f).shape == getattr(ref, f).shape
        for f in ("sel", "pos", "kept", "dropped", "overflow", "fixable"))


def time_compact_cases(compaction, dev, failures: list,
                       data: list | None = None) -> list[dict]:
    """K10 (`compaction.wave_select` and `wave_scatter`) against the plain
    twins on `compact_data`'s cases or `data`: the selection equal field
    by field on every rank of a mesh case, the scatter of `compact_parts`
    bit-equal (a copy); each timed in CUDA events over POOL distinct
    buffers (rank 0's call for a mesh case), with each kernel's device ms
    and the plain route's (every kernel of `wave_select_plain` and
    `wave_scatter_plain`) from the profiler, and its bound
    (`utils/roofline.py`'s select_cost and scatter_cost). One row per
    case."""
    import torch
    roofline = load_roofline()
    syms = roofline.KERNEL_SYMBOLS["K10"]
    rows = []
    for tag, kept, budget, world in data or compact_data(dev):
        files, k = kept.shape
        local = files // world
        ok, n_sel0, launched = True, None, 0
        for rank in range(world):
            first = rank * local
            ovf = torch.arange(local, device=dev) % 3 == 0
            fix = torch.arange(local, device=dev) % 5 == 0
            before = (compaction.wave_select.launches,
                      compaction.wave_scatter.launches)
            got = compaction.wave_select(kept, budget, first, local, ovf,
                                         fix)
            ref = compaction.wave_select_plain(kept, budget, first, local,
                                               ovf, fix)
            parts = compact_parts(max(got.n_sel, 1), dev, SEED + rank)
            out = compaction.wave_scatter(got.pos, parts)
            ref_out = compaction.wave_scatter_plain(ref.pos, parts)
            torch.cuda.synchronize()
            launched += (compaction.wave_select.launches - before[0]
                         + compaction.wave_scatter.launches - before[1])
            ok = ok and same_selection(got, ref) and all(
                torch.equal(a, b) for a, b in zip(out, ref_out))
            if rank == 0:
                n_sel0 = got.n_sel
        # timing: rank 0's call on POOL distinct copies of its inputs
        ovf = torch.zeros(local, dtype=torch.bool, device=dev)
        pool = [kept.clone() for _ in range(POOL)]
        sel0 = compaction.wave_select(kept, budget, 0, local, ovf, ovf)
        parts = compact_parts(max(sel0.n_sel, 1), dev, SEED)
        pos_pool = [sel0.pos.clone() for _ in range(POOL)]

        def select(x):
            return compaction.wave_select(x, budget, 0, local, ovf, ovf)

        def select_plain(x):
            return compaction.wave_select_plain(x, budget, 0, local, ovf,
                                                ovf)

        def scatter(p):
            return compaction.wave_scatter(p, parts)

        def scatter_plain(p):
            return compaction.wave_scatter_plain(p, parts)
        widths = 3 * COMPACT_CLASSES + 1
        grid = (list(compaction.compact_grid(files, k, dev))
                if hasattr(compaction, "compact_grid") else None)
        if grid is not None and world == 1:
            log(f"[occupancy] wave_compact at {files} x {k} slots: select "
                f"{grid[0]} tile(s), one block of {grid[1]} threads; "
                f"scatter {grid[2]} blocks of 256 threads over the slots, "
                f"{grid[3]} resident a SM")
        row = dict(case=tag, files=files, slots=k, budget=budget,
                   world=world, n_local=local, n_kept=int(kept.sum()),
                   n_sel=n_sel0, launches=launched, checked=ok, grid=grid,
                   select_ms=time_ms(select, pool, reps=20),
                   scatter_ms=time_ms(scatter, pos_pool, reps=20),
                   select_plain_ms=time_ms(select_plain, pool, reps=5),
                   scatter_plain_ms=time_ms(scatter_plain, pos_pool, reps=5))
        dev_ms = symbol_device_ms(select, pool, syms[:1])
        dev_ms.update(symbol_device_ms(scatter, pos_pool, syms[1:]))
        row.update(select_device_ms=dev_ms[syms[0]],
                   scatter_device_ms=dev_ms[syms[1]],
                   plain_device_ms=call_device_ms(
                       lambda x: scatter_plain(select_plain(x).pos), pool))
        row["select_bound_ms"], row["select_bound_by"] = roofline.bound(
            *roofline.select_cost(files, k, local, sel0.n_sel))
        row["scatter_bound_ms"], row["scatter_bound_by"] = roofline.bound(
            *roofline.scatter_cost(local * k, sel0.n_sel, widths))
        log(f"[compact] {tag} ({files} x {k} slots, {row['n_kept']} kept, "
            f"budget {budget}, {world} rank(s), rank 0 n_sel {n_sel0}): "
            f"select {row['select_ms']:.4f} ms (events), "
            f"{fmt_ms(row['select_device_ms'])} device, bound "
            f"{row['select_bound_ms']:.6f} ms; scatter "
            f"{row['scatter_ms']:.4f} ms (events), "
            f"{fmt_ms(row['scatter_device_ms'])} device, bound "
            f"{row['scatter_bound_ms']:.6f} ms; plain select "
            f"{row['select_plain_ms']:.4f} ms, scatter "
            f"{row['scatter_plain_ms']:.4f} ms (events), the plain route "
            f"{fmt_ms(row['plain_device_ms'])} device; {launched} launches "
            f"for {2 * world} calls; selection equal and outputs bit-equal "
            f"on every rank {ok} -> "
            f"{'ok' if ok and launched == 2 * world else 'FAIL'}")
        if not ok or launched != 2 * world:
            failures.append(f"[compact] {tag}: K10 against the plain twins "
                            f"(launches {launched})")
        if row["select_device_ms"] is None or row["scatter_device_ms"] is None:
            failures.append(f"[compact] {tag}: no device time of K10 in the "
                            f"profiler")
        rows.append(row)
    torch.cuda.synchronize()
    return rows


def time_compact_stage(dev, failures: list) -> list[dict]:
    """The file body's `compaction` stage in situ, for whichever checkout's
    package is imported: the serving wave's body (`Transcriber._files_fn`
    at 4 files x 60 s, 112 onsets, budget 384, candidates 448) on [gate]'s
    riffs (their kept slots overflow the budget) and on
    torch_roofline_files.py's noise wave (none kept), run ITERS times
    under the profiler by this checkout's `tools/torch_roofline_files.py`
    (`measure`): the wave's ms in CUDA events, the compaction stage's and
    the whole wave's device ms per call and the kernels the stage
    launched, and the synchronising calls of one call of the body (torch's
    sync debug mode). One row per wave."""
    import torch
    from gat_tpu_torch.infer import Transcriber
    roof = load_tool("torch_roofline_files")
    t = Transcriber(device=str(dev))
    run, _ = t._files_fn(FILE_SR, 0.5, COMPACT_SLOTS, COMPACT_BUDGET,
                         COMPACT_CAND)
    y, nv, _, _ = gate_riffs(dev)
    y_noise, nv_noise = noise_wave(dev)
    rows = []
    for tag, (ys, nvs) in (("riffs", (y, nv)), ("noise", (y_noise,
                                                          nv_noise))):
        pool = [(ys, nvs)] + [((ys + 1e-4 * torch.randn(
            ys.shape, device=dev, generator=torch.Generator(dev)
            .manual_seed(SEED + i))).contiguous(), nvs) for i in range(1, 4)]
        events_ms, stage_ms, kernels = roof.measure(run, pool)
        _, syncs = sync_warnings(lambda: run(*pool[0]))
        torch.cuda.synchronize()
        row = dict(wave=tag, events_ms=events_ms,
                   compaction_ms=stage_ms["compaction"],
                   device_ms=sum(stage_ms.values()),
                   stage_ms=stage_ms,
                   compaction_kernels=kernels.get("compaction", []),
                   sort_kernels=sorted({n for ks in kernels.values()
                                        for n in ks if "sort" in n.lower()}),
                   syncs=sum(syncs.values()),
                   compaction_syncs=sum(n for at, n in syncs.items()
                                        if at.startswith("compaction.py")))
        log(f"[compact] stage, {tag} wave: compaction "
            f"{row['compaction_ms']:.4f} ms device of the wave's "
            f"{row['device_ms']:.4f} ms ({events_ms:.4f} ms events); its "
            f"kernels {row['compaction_kernels']}; sort kernels in the wave "
            f"{row['sort_kernels']}; {row['syncs']} synchronising calls a "
            f"body call {dict(syncs)}")
        rows.append(row)
        del pool
    return rows


def time_compact(dev, failures: list) -> list[dict]:
    """`tools/torch_onset_timing.py TREE compact`: the compaction stage in
    situ (`time_compact_stage`) for any checkout, then K10's cases
    (`time_compact_cases`) where the checkout has `ops/compaction.py`."""
    import importlib.util
    rows = time_compact_stage(dev, failures)
    if importlib.util.find_spec("gat_tpu_torch.ops.compaction") is not None:
        from gat_tpu_torch.ops import compaction
        rows += time_compact_cases(compaction, dev, failures)
    return rows


def compact_phase(failures: list, device: str = "cuda") -> list[dict]:
    """`[compact]`: K10 (`csrc/wave_compact.cu`) against its plain twins at
    `compact_data`'s cases, timed, and the body's compaction stage in situ
    (no sort kernel in the wave, a kernel launched in the stage, no
    synchronising call of the compaction on one device);
    returns the kernels-line rows of its two kernels, the serving wave's
    numbers, with every case's in `cases` and the stage's in `stage` of
    the selection's row."""
    import torch
    from gat_tpu_torch.ops import compaction
    dev = torch.device(device)
    stages = time_compact_stage(dev, failures)
    roofline = load_roofline()
    for st in stages:
        ran = {roofline.device_function(n) for n in st["compaction_kernels"]}
        if (st["sort_kernels"] or st["compaction_syncs"]
                or not ran >= set(roofline.KERNEL_SYMBOLS["K10"])):
            failures.append(f"[compact] {st['wave']} wave: sort kernels "
                            f"{st['sort_kernels']}, compaction kernels "
                            f"{st['compaction_kernels']}, "
                            f"{st['compaction_syncs']} syncs of the "
                            f"compaction on one device")
    cases = time_compact_cases(compaction, dev, failures)
    wave = cases[0]
    tolerance = ("equal: sel (values and order), pos, kept, dropped, "
                 "overflow, fixable and n_sel; scattered outputs bit-equal")
    common = dict(route="cuda", source="gat_tpu_torch/csrc/wave_compact.cu",
                  replaces="gat_tpu/infer/pipeline.py:171", launches=0,
                  max_abs_err=0.0 if all(c["checked"] for c in cases)
                  else None, tolerance=tolerance, library_ms=None,
                  plain_device_ms=wave["plain_device_ms"], grid=wave["grid"])
    # every case's and the stage's numbers (both kernels') once, in the
    # selection's row
    return [dict(name="wave_select", ms=wave["select_ms"],
                 plain_ms=wave["select_plain_ms"],
                 bound_ms=wave["select_bound_ms"],
                 bound_by=wave["select_bound_by"],
                 device_ms=wave["select_device_ms"], cases=cases,
                 stage=stages, **common),
            dict(name="wave_scatter", ms=wave["scatter_ms"],
                 plain_ms=wave["scatter_plain_ms"],
                 bound_ms=wave["scatter_bound_ms"],
                 bound_by=wave["scatter_bound_by"],
                 device_ms=wave["scatter_device_ms"], **common)]


# the kernels every path's launches are counted for, K1..K13 in the order
# of `utils/roofline.py`'s KERNEL_SYMBOLS (K10's two kernels, the
# compaction's selection and scatter, a row each, and so K12's two passes
# and K13's four kernels), by their kernels-line rows' names; the indices
# of K1..K13 in a `driven` count; and those that every path that segments
# a file launches on the FFT route (all but K6 and K10-K13)
KERNEL_ROWS = ("melspec_frontend", "mfcc_frontend", "yin_pitch",
               "onset_envelope", "onset_pick", "mfcc_pitch_frontend",
               "noise_gate", "slice_clips", "resample", "wave_select",
               "wave_scatter", "softmax_xent", "clip_norm", "adamw_update",
               "bn_moments", "bn_apply", "bn_apply_grad", "bn_moments_grad")
(K1, K2, K3, K4, K5, K6, K7, K8, K9, K10S, K10C, K11, K12N, K12U, K13M, K13A,
 K13G, K13B) = range(18)
# every training step launches K11 and K12's two passes; a CNN step K13's
# four kernels once a BatchNorm layer
TRAINING = (K11, K12N, K12U)
BATCHNORM = (K13M, K13A, K13G, K13B)
# a path that segments a file re-rates its clips to the checkpoint's rate
# (K9) too
SEGMENTING = (K1, K2, K3, K4, K5, K7, K8, K9)
# K10 launches once a wave that goes through the file body's budget
# branch, which a `driven` count also counts apart, at BRANCH after the
# kernels; the paths that must take that branch (waves of more slots than
# the budget); and each path's K10 faults, which main() fails on
COMPACTING = (K10S, K10C)
BRANCH = len(KERNEL_ROWS)
MUST_COMPACT = ("files", "serve", "http", "parallel")
PATH_FAULTS: list = []


def compaction_branch():
    """The file body's budget branch, counted: `infer.pipeline`'s
    `wave_select`, which the branch calls once a wave, wrapped once a
    process so that its `launches` counts the waves that took the branch,
    whatever K10's own counts say."""
    from gat_tpu_torch.infer import pipeline
    if not getattr(pipeline.wave_select, "branch", False):
        inner = pipeline.wave_select

        def counted(*args, **kwargs):
            counted.launches += 1
            return inner(*args, **kwargs)
        counted.launches, counted.branch = 0, True
        pipeline.wave_select = counted
    return pipeline.wave_select


def kernel_wrappers() -> list:
    """The wrappers of K1..K13, each counting the launches of its kernel
    (K7's is `gating.noise_gate`, which `rms_gate` and `gate_waveform`
    call; K9's count is on `resample.resample`, which `resample_rows`
    adds to; K10's on `compaction.wave_select` and `wave_scatter`; K11's
    on `loss.softmax_xent`, K12's on `optim.clip_norm` and
    `optim.adamw_update`, K13's on `batchnorm.bn_moments`, `bn_apply`,
    `bn_apply_grad` and `bn_moments_grad`), and last the budget branch's
    count (`compaction_branch`)."""
    from gat_tpu_torch import features
    from gat_tpu_torch.ops import (batchnorm, compaction, loss, onset,
                                   resample, yin)
    from gat_tpu_torch.segment import gating, slicing
    from gat_tpu_torch.train import optim
    return [features.melspec_features, features.mfcc_frontend,
            yin.yin_pitch, onset.onset_strength, onset.pick_onsets,
            features.mfcc_pitch_features, gating.noise_gate,
            slicing.slice_at_onsets, resample.resample,
            compaction.wave_select, compaction.wave_scatter,
            loss.softmax_xent, optim.clip_norm, optim.adamw_update,
            batchnorm.bn_moments, batchnorm.bn_apply,
            batchnorm.bn_apply_grad, batchnorm.bn_moments_grad,
            compaction_branch()]


def not_launched(launches: list, need=SEGMENTING) -> list:
    """The names of the kernels of `need` (indices K1..K13) that a
    `driven` count shows were not launched."""
    return [KERNEL_ROWS[i] for i in need if launches[i] < 1]


def driven(fn) -> tuple:
    """fn() run once with every kernel's launch count set to 0 just before
    and read just after, once the card is idle: (its result, launches
    K1..K13 and the budget branch's count at BRANCH, wall seconds)."""
    import torch
    wrappers = kernel_wrappers()
    torch.cuda.synchronize()
    for w in wrappers:
        w.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, [w.launches for w in wrappers], wall


def record_launches(rows: list, path: str, launches: list) -> None:
    """Each kernel's launches on one path (K1..K13, a `driven` count), into
    its kernels-line row, found by name (K6's row exists from `[shared]`
    on, K10's from `[compact]` on); and K10's check: each of its kernels
    launched once for every wave that took the budget branch, so none on
    a path that does not compact, and at least once on MUST_COMPACT's
    paths (a fault goes to PATH_FAULTS)."""
    by_name = {row["name"]: row for row in rows}
    for name, n in zip(KERNEL_ROWS, launches):
        if name in by_name:
            by_name[name].setdefault("launches_by_path", {})[path] = n
    branch = launches[BRANCH]
    k10 = [launches[i] for i in COMPACTING]
    ok = k10 == [branch, branch] and (branch >= 1
                                      or path not in MUST_COMPACT)
    log(f"[compact] {path}: {branch} waves through the budget branch, K10 "
        f"launches {k10} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        PATH_FAULTS.append(f"[{path}] K10 launched {k10} for {branch} "
                           f"compacted waves")


def same_result(got: dict, ref: dict) -> tuple[bool, float]:
    """Labels, onsets, times and the overflow flag identical and probs
    within 1e-2 (the tests' bounds); returns (same, max prob error)."""
    if got["probs"].shape != ref["probs"].shape:
        return False, float("inf")
    err = (float(np.abs(got["probs"] - ref["probs"]).max())
           if got["probs"].size else 0.0)
    return (got["labels"] == ref["labels"]
            and got["onsets_s"] == ref["onsets_s"]
            and got["times"] == ref["times"]
            and got["onset_overflow"] == ref["onset_overflow"]
            and err <= 1e-2), err


def file_phase(rows: list, card: str, failures: list) -> None:
    """`transcribe` on riff WAVs at three rates, on the card (two-stage
    and fused) and on the CPU; fills in K4's and K5's launches per call."""
    import torch
    from gat_tpu_torch.infer import Transcriber
    from gat_tpu_torch.ops.pitch import midi_to_note
    from gat_tpu_torch.utils.wavio import write_wav
    expected = [midi_to_note(m, unicode=False) for m in FILE_MIDI[:-1]]
    card_t, cpu_t = Transcriber(device="cuda"), Transcriber(device="cpu")
    with tempfile.TemporaryDirectory() as d:
        paths = {}
        for sr in (22050, 44100, 48000):
            paths[sr] = Path(d) / f"riff_{sr}.wav"
            write_wav(paths[sr], make_riffs(np.array([FILE_MIDI]), 3.9, sr,
                                            SEED + 2, noise=0.0)[0], sr)
        card_t.transcribe(paths[FILE_SR])  # first call: library handles
        for fused in (False, True):
            _, launches, _ = driven(
                lambda: card_t.transcribe(paths[FILE_SR], fused=fused))
            log(f"[file] launches per transcribe(fused={fused}) call, "
                f"K1..K13 and the budget branch: {launches}")
            if not_launched(launches) or launches[K4] != 1:
                failures.append(f"a kernel was not launched on the file "
                                f"path, or K4 more than once "
                                f"(fused={fused}): {launches}")
            if not fused:
                for i in (K4, K5, K7, K8, K9):
                    row = next(r for r in rows
                               if r["name"] == KERNEL_ROWS[i])
                    row["launches"] = launches[i]
                record_launches(rows, "file", launches)
        for sr, path in paths.items():
            ref = cpu_t.transcribe(path)
            for fused in (False, True):
                got = card_t.transcribe(path, fused=fused)
                same, err = same_result(got, ref)
                same = same and got["labels"] == expected
                log(f"[file] {sr} Hz fused={fused}: labels {got['labels']}, "
                    f"onsets {got['onsets_s']}; equal to the CPU plain path "
                    f"{same} (max prob err {err:.3g})")
                if not same:
                    failures.append(f"file path at {sr} Hz (fused={fused})")
            for fused in (False, True):
                def call():
                    return card_t.transcribe(path, fused=fused)
                dt = wall_per_call(call, reps=5)
                log(f"[file] transcribe(3.9 s at {sr} Hz, fused={fused}): "
                    f"{dt * 1e3:.3f} ms/file on {card}")
                if sr == FILE_SR:
                    profile_call(call, dt * 1e3)
                if sr == 48000:
                    # in turns with both re-rates (the load to 22050 Hz and
                    # the clips' to the checkpoint's rate) on the plain
                    # route, as the parent tree ran them
                    turns = [wall_per_call(
                        (lambda: plain_rerate(call)) if plain else call, 5)
                        for plain in (True, False, False, True)]
                    log(f"[file] transcribe(3.9 s at {sr} Hz, fused={fused})"
                        f" in turns: K9 {turns[1] * 1e3:.3f}, "
                        f"{turns[2] * 1e3:.3f} ms/file, the plain re-rate "
                        f"(the parent's) {turns[0] * 1e3:.3f}, "
                        f"{turns[3] * 1e3:.3f} ms/file on {card}")


def wall_per_call(fn, reps: int) -> float:
    """Host seconds per call of fn over `reps` calls, from an idle card to
    an idle card."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def plain_rerate(fn):
    """fn() with the Transcriber's and the file body's re-rates bound to
    the plain versions (`resample_plain`, `resample_rows_plain`): the
    parent tree's route, for a comparison in one process. Restored on
    return."""
    from gat_tpu_torch.infer import pipeline, transcriber
    from gat_tpu_torch.ops import resample
    saved = (transcriber.resample, transcriber.resample_rows,
             pipeline.resample_rows)
    transcriber.resample = resample.resample_plain
    transcriber.resample_rows = pipeline.resample_rows = (
        resample.resample_rows_plain)
    try:
        return fn()
    finally:
        (transcriber.resample, transcriber.resample_rows,
         pipeline.resample_rows) = saved


def long_phase(rows: list, card: str, failures: list) -> None:
    """`[long]`: `transcribe` of a 400 s riff WAV at 22050 Hz, a pluck of
    the file phase's five notes in turn every 2.5 s from 0.4 s, on the
    card and on the CPU: the labels must be the planted notes but the
    last, labels, onsets and times must be equal, and K4
    and K5 must launch in the card's call (with 160 plucks over the 64
    default onset slots, `transcribe` re-runs the segmentation at a
    larger cap, so each launches more than once)."""
    from gat_tpu_torch.infer import Transcriber
    from gat_tpu_torch.ops.pitch import midi_to_note
    from gat_tpu_torch.utils.wavio import write_wav
    spacing = 2.5
    k = len(np.arange(0.4, LONG_SECONDS - 0.45, spacing))
    midi = np.resize(FILE_MIDI, k)[None]
    planted = [midi_to_note(int(m), unicode=False) for m in midi[0][:-1]]
    card_t, cpu_t = Transcriber(device="cuda"), Transcriber(device="cpu")
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "riff_400s.wav"
        write_wav(path, make_riffs(midi, LONG_SECONDS, FILE_SR, SEED + 3,
                                   noise=0.0, spacing=spacing)[0], FILE_SR)
        card_t.transcribe(path)  # first call at this length
        got, launches, wall = driven(lambda: card_t.transcribe(path))
        record_launches(rows, "long", launches)
        launches = [launches[i] for i in (K4, K5, K7, K8, K9)]
        t0 = time.perf_counter()
        ref = cpu_t.transcribe(path)
        cpu_wall = time.perf_counter() - t0
    same, err = same_result(got, ref)
    same = same and got["labels"] == planted
    log(f"[long] transcribe({LONG_SECONDS:g} s at {FILE_SR} Hz, {k} plucks): "
        f"{len(got['labels'])} labels, {wall * 1e3:.3f} ms on {card} "
        f"(CPU plain path {cpu_wall:.1f} s); K4, K5, K7, K8, K9 launches "
        f"{launches}; "
        f"labels the planted notes but the last, and labels, onsets and "
        f"times equal to the CPU's: {same} (max prob err {err:.3g})")
    if not same:
        failures.append("[long] card and CPU disagree on the 400 s file")
    if min(launches) < 1:
        failures.append(f"[long] K4, K5, K7, K8 or K9 not launched: "
                        f"{launches}")


def wave(rows_s: list, seconds: float, spacing: float, seed: int):
    """A wave as `transcribe_files` pads it, on the card: one riff of
    FILE_MIDI's notes in turn per entry of `rows_s` (its valid seconds; 0
    is a padding row of zeros), each zero past its valid end and
    `seconds` long; with the valid frames `detect_onsets` hands K4 and K5
    (n_valid // 512 + 1, int32: one frame for a padding row)."""
    import torch
    n = int(seconds * FILE_SR)
    y = np.zeros((len(rows_s), n), np.float32)
    n_valid = np.array([int(s * FILE_SR) for s in rows_s])
    for i, s in enumerate(rows_s):
        if s:
            k = len(np.arange(0.4, s - 0.45, spacing))
            midi = np.roll(np.resize(FILE_MIDI, k), -i)[None]
            y[i, :n_valid[i]] = make_riffs(midi, s, FILE_SR, seed + i,
                                           noise=0.0, spacing=spacing)[0]
    nvf = torch.from_numpy(n_valid // 512 + 1).to(torch.int32)
    return torch.from_numpy(y).cuda(), nvf.cuda()


def check_wave_kernels(clips, failures: list) -> None:
    """The kernels at the shapes the many-file path gives them, against
    their plain versions on the card: K1-K3 at the 192 clips of a wave of
    4 under its automatic clip budget (3/4 of 4 files x 64 slots); K4 and
    K5 on a wave of 4 in the 4 s bucket whose last row is padding, and on
    the 512 s bucket's B = 2, a 300 s riff and a padding row. A padding
    row must give no onset and no flag."""
    import torch
    from gat_tpu_torch import features
    from gat_tpu_torch.ops import onset, yin
    x = clips[:192].contiguous()
    err1, ok1 = mel_error(features.melspec_features(x, SR),
                          features.melspec_features_plain(x, SR))
    err2 = float((features.mfcc_frontend(x, SR)
                  - features.mfcc_frontend_plain(x, SR)).abs().max())
    hz, hz_ref = yin.yin_pitch(x, SR), yin.yin_pitch_plain(x, SR)
    rel3 = float(((hz - hz_ref).abs() / hz_ref.abs()).max())
    ok = ok1 and err2 <= 1e-3 and rel3 <= 2e-3
    log(f"[wave] K1-K3 at 192 clips: mel max abs err {err1:.3g} dB, MFCC "
        f"{err2:.3g} (atol 1e-3), YIN max rel err {rel3:.3g} (rtol 2e-3) "
        f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("K1-K3 at the wave's 192 clips")
    for rows_s, seconds, spacing in (([3.9, 3.9, 3.9, 0.0], 4.0, 0.7),
                                     ([300.0, 0.0], 512.0, 2.5)):
        y, nvf = wave(rows_s, seconds, spacing, SEED + 7)
        pad = torch.tensor([s == 0 for s in rows_s], device=y.device)
        env = onset.onset_strength(y, FILE_SR, n_valid_frames=nvf)
        ref = onset.onset_strength_plain(y, FILE_SR, n_valid_frames=nvf)
        err4 = float((env - ref).abs().max())
        ok = err4 <= 1e-3 and bool(torch.isfinite(env).all())
        for cand_budget in (None, 0):
            got = onset.pick_onsets(env, FILE_SR, 512, 0.3, 64,
                                    n_valid_frames=nvf,
                                    cand_budget=cand_budget)
            want = onset.pick_onsets_plain(env, FILE_SR, 512, 0.3, 64,
                                           n_valid_frames=nvf,
                                           cand_budget=cand_budget)
            _, valid, overflow, _, n_kept = got
            ok = (ok and all(torch.equal(a, b) for a, b in zip(got, want))
                  and not bool(valid[pad].any())
                  and not bool(overflow[pad].any())
                  and not bool(n_kept[pad].any())
                  and bool(valid[~pad].any(-1).all()))
        torch.cuda.synchronize()
        tag = f"{len(rows_s)} x {seconds:g} s (valid {rows_s} s)"
        log(f"[wave] K4 at {tag}: max abs err {err4:.3g} (atol 1e-3); K5 "
            f"outputs identical for cand_budget None, 0; the padding row: "
            f"no onset, no flag -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"K4/K5 on the wave {tag}")


def write_files_set(d: Path) -> tuple[list, Path, float]:
    """FILES_SET's riffs and the silent file as 16-bit WAVs under d: file
    i of a group plays FILE_MIDI in turn from its (i+1)-th note, from 0.4
    s at the group's spacing. Returns ([[(path, planted labels but the
    last)] per group], the silent file, audio seconds)."""
    from gat_tpu_torch.ops.pitch import midi_to_note
    from gat_tpu_torch.utils.wavio import write_wav
    groups, audio_s = [], SILENT_SECONDS
    for g, (files, seconds, sr, spacing) in enumerate(FILES_SET):
        k = len(np.arange(0.4, seconds - 0.45, spacing))
        midi = np.stack([np.roll(np.resize(FILE_MIDI, k), -i)
                         for i in range(files)])
        riffs = make_riffs(midi, seconds, sr, SEED + 4 + g, noise=0.0,
                           spacing=spacing)
        group = []
        for i, y in enumerate(riffs):
            path = d / f"g{g}_{i}.wav"
            write_wav(path, y, sr)
            group.append((path, [midi_to_note(int(m), unicode=False)
                                 for m in midi[i][:-1]]))
        groups.append(group)
        audio_s += files * seconds
    silent = d / "silent.wav"
    write_wav(silent, np.zeros(int(SILENT_SECONDS * FILE_SR), np.float32),
              FILE_SR)
    return groups, silent, audio_s


def files_phase(rows: list, card: str, failures: list,
                device: str = "cuda") -> None:
    """`[files]`: `transcribe_files` over FILES_SET and the silent file in
    a shuffled order, on the card and on the CPU: labels, onsets and times
    equal, the riffs labelled with their planted notes but the last, the
    silent file empty, all five kernels launched; the host transfers
    (`_to_host` calls) per call counted; an exact-fallback call on the 16
    riffs (clip budget 3, candidate budget 1) equal to their exact run.
    Then wall ms per call of one wave of 4 riffs, of the 16 (one chunk of
    K = 4 waves), of the whole set, and of `transcribe` per riff; the
    device's busy share of the chunk and of the set; the threaded WAV
    decode of the set on its own, and all of these numbers as one JSON
    line."""
    import torch
    from gat_tpu_torch.infer import Transcriber
    from gat_tpu_torch.infer import transcriber as ttr
    from gat_tpu_torch.utils import native_wav
    card_t, cpu_t = Transcriber(device=device), Transcriber(device="cpu")
    transfers = [0]
    to_host = ttr._to_host

    def counted(outs):
        transfers[0] += 1
        return to_host(outs)

    def call(fn) -> tuple:
        """driven(fn), and the host transfers it made."""
        transfers[0] = 0
        return (*driven(fn), transfers[0])

    def wall_ms(fn, reps: int) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    out = {}
    ttr._to_host = counted
    try:
        with tempfile.TemporaryDirectory() as d:
            groups, silent, audio_s = write_files_set(Path(d))
            entries = [e for g in groups for e in g] + [(silent, [])]
            order = np.random.default_rng(SEED).permutation(len(entries))
            paths = [entries[i][0] for i in order]
            planted = [entries[i][1] for i in order]
            riffs = [p for p, _ in groups[0]]
            t0 = time.perf_counter()
            ref = cpu_t.transcribe_files(paths)
            cpu_s = time.perf_counter() - t0
            card_t.transcribe_files(paths)  # first call at these shapes
            got, launches, wall, n_host = call(
                lambda: card_t.transcribe_files(paths))
            record_launches(rows, "files", launches)
            # K10's `launches`: the many-file path's, the path it serves
            for row in rows:
                if row["name"] in ("wave_select", "wave_scatter"):
                    row["launches"] = launches[KERNEL_ROWS.index(
                        row["name"])]
            checks = [same_result(g, r) for g, r in zip(got, ref)]
            n_same = sum(s for s, _ in checks)
            n_planted = sum(g["labels"] == p for g, p in zip(got, planted))
            empty = got[paths.index(silent)]
            ok = (n_same == len(paths) == len(got)
                  and n_planted == len(paths)
                  and empty["probs"].shape == (0, 47))
            log(f"[files] transcribe_files({len(paths)} files, "
                f"{audio_s:g} audio-s, buckets 2/4/16/512 s): {wall * 1e3:.3f} "
                f"ms on {card} (CPU plain path {cpu_s:.1f} s); launches "
                f"K1..K13, branch {launches}, host transfers {n_host}; equal to the "
                f"CPU's {n_same}/{len(paths)} (max prob err "
                f"{max(e for _, e in checks):.3g}), planted labels "
                f"{n_planted}/{len(paths)}, silent file empty "
                f"{empty['probs'].shape == (0, 47)} -> "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append("[files] card and CPU disagree, or a file "
                                "lost its planted labels")
            if not_launched(launches):
                failures.append(f"[files] a kernel was not launched: "
                                f"{launches}")

            fb, _, _, fb_host = call(lambda: card_t.transcribe_files(
                riffs, wave_clip_budget=3, cand_budget=1))
            raw = card_t.transcribe_files(riffs, wave_clip_budget=3,
                                          cand_budget=1, exact_fallback=False)
            exact = card_t.transcribe_files(riffs, wave_clip_budget=None,
                                            cand_budget=0,
                                            exact_fallback=False)
            ok = (all(same_result(a, b)[0] for a, b in zip(fb, exact))
                  and all(r["onset_overflow"] for r in raw)
                  and not any(r["onset_overflow"] for r in fb))
            log(f"[files] exact fallback (16 riffs, clip budget 3, "
                f"candidate budget 1; host transfers {fb_host}): every "
                f"file flagged without it, and with it equal to the exact "
                f"run, no flag -> {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append("[files] the exact fallback differs from "
                                "the exact run")

            # wall time per call, host work included
            for name, fn, n_files, reps in (
                    ("1 wave of 4 riffs", lambda: card_t.transcribe_files(
                        riffs[:4]), 4, 5),
                    ("16 riffs, one chunk of K = 4 waves",
                     lambda: card_t.transcribe_files(riffs), 16, 5),
                    ("the set", lambda: card_t.transcribe_files(paths),
                     len(paths), 3)):
                _, launches, _, n_host = call(fn)
                ms = wall_ms(fn, reps)
                secs = (audio_s if n_files == len(paths)
                        else n_files * FILES_SET[0][1])
                out[name] = dict(ms=ms, files=n_files, audio_s=secs,
                                 launches=launches, host_transfers=n_host)
                log(f"[files] transcribe_files({name}): {ms:.3f} ms/call, "
                    f"{ms / n_files:.3f} ms/file, {n_files / ms * 1e3:.1f} "
                    f"files/s, {secs / ms * 1e3:.1f} audio-s/s; launches "
                    f"K1..K13, branch {launches}, host transfers {n_host}; on {card}")
                if n_files >= 16:
                    out[name]["busy_ms"] = profile_call(fn, ms)
            ms = wall_ms(lambda: [card_t.transcribe(p) for p in riffs], 1)
            out["transcribe per riff"] = dict(ms=ms / len(riffs))
            log(f"[files] transcribe() of each of the 16 riffs: "
                f"{ms / len(riffs):.3f} ms/file on {card}")
            decode = [wall_ms(lambda: native_wav.read_wav_batch(paths), 1)
                      for _ in range(5)]
            out["decode_ms"] = statistics.median(decode)
            log(f"[files] read_wav_batch({len(paths)} files) alone: median "
                f"{out['decode_ms']:.3f} ms of 5 (native codec "
                f"{native_wav.native_available()})")
    finally:
        ttr._to_host = to_host
    log(f"[files] numbers {json.dumps(out)}")


def serve_phase(rows: list, card: str, failures: list,
                device: str = "cuda") -> None:
    """`[serve]`: SERVE_FILES riffs through the watch folder,
    `serve(once=True, batch=4)`, and through the HTTP endpoint,
    `serve_http(port=0, batch=4)` on localhost with one dispatcher, all
    posted at once; both with the card's Transcriber. Every file's labels
    must equal the CPU's `transcribe_files`, and all five kernels must
    launch in each."""
    import http.client
    import threading
    from gat_tpu_torch import serve
    from gat_tpu_torch.infer import Transcriber
    from gat_tpu_torch.utils.wavio import write_wav
    card_t, cpu_t = Transcriber(device=device), Transcriber(device="cpu")
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        in_dir = d / "in"
        in_dir.mkdir()
        midi = np.stack([np.roll(FILE_MIDI, -i) for i in range(SERVE_FILES)])
        paths = []
        for i, y in enumerate(make_riffs(midi, 3.9, FILE_SR, SEED + 9,
                                         noise=0.0)):
            paths.append(in_dir / f"riff{i}.wav")
            write_wav(paths[-1], y, FILE_SR)
        want = {p.stem: r["labels"]
                for p, r in zip(paths, cpu_t.transcribe_files(paths))}
        bodies = {p.stem: p.read_bytes() for p in paths}

        n, launches, wall = driven(lambda: serve.serve(
            in_dir, d / "out", once=True, transcriber=card_t, batch=4,
            verbose=False))
        record_launches(rows, "serve", launches)
        got = {s: json.loads((d / "out" / f"{s}.json").read_text())["labels"]
               for s in want}
        ok = n == SERVE_FILES and got == want and not not_launched(launches)
        log(f"[serve] serve(once=True, batch=4) over {SERVE_FILES} riffs: "
            f"{wall * 1e3:.3f} ms, launches K1..K13, branch {launches}; labels equal "
            f"to the CPU's {got == want} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append("[serve] the watch folder's labels or launches")

        holder: list = []
        server = threading.Thread(target=serve.serve_http, kwargs=dict(
            port=0, transcriber=card_t, batch=4, window_s=0.5,
            verbose=False, server_holder=holder), daemon=True)
        server.start()
        for _ in range(600):
            if holder:
                break
            time.sleep(0.05)
        port = holder[0].server_address[1]
        answers: dict = {}

        def request(method: str, path: str, body: bytes | None = None):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
            try:
                conn.request(method, path, body=body)
                resp = conn.getresponse()
                return resp.status, resp.read()
            finally:
                conn.close()

        def post(stem: str) -> None:
            status, body = request("POST", "/transcribe", bodies[stem])
            answers[stem] = (status, json.loads(body))

        def burst() -> None:
            threads = [threading.Thread(target=post, args=(s,)) for s in want]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=300)

        try:
            _, launches, wall = driven(burst)
            metrics = dict(
                ln.rsplit(" ", 1)
                for ln in request("GET", "/metrics")[1].decode().splitlines()
                if ln and not ln.startswith("#"))
        finally:
            holder[0].shutdown()
            server.join(timeout=120)
        record_launches(rows, "http", launches)
        same = all(answers.get(s, (0, {}))[0] == 200
                   and answers[s][1]["labels"] == want[s] for s in want)
        ok = same and not not_launched(launches) and not server.is_alive()
        log(f"[serve] serve_http(batch=4): {SERVE_FILES} concurrent POSTs in "
            f"{wall * 1e3:.3f} ms, {metrics['gat_device_dispatches_total']} "
            f"dispatches carrying {metrics['gat_dispatch_files_sum']} files, "
            f"launches K1..K13, branch {launches}; every answer 200 with the CPU's "
            f"labels {same}; server stopped {not server.is_alive()} -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append("[serve] the HTTP endpoint's answers or launches")


def stream_riff(seconds: float, seed: int) -> tuple[np.ndarray, list]:
    """One riff at FILE_SR of FILE_MIDI's notes in turn, a pluck every
    STREAM_SPACING s from 0.4 s, no noise; and its planted (onset s,
    label) pairs."""
    from gat_tpu_torch.ops.pitch import midi_to_note
    k = len(np.arange(0.4, seconds - 0.45, STREAM_SPACING))
    midi = np.resize(FILE_MIDI, k)[None]
    y = make_riffs(midi, seconds, FILE_SR, seed, noise=0.0,
                   spacing=STREAM_SPACING)[0]
    return y, [(0.4 + STREAM_SPACING * j, midi_to_note(int(m), unicode=False))
               for j, m in enumerate(midi[0])]


def stream_kernels_phase(rows: list, failures: list,
                         device: str = "cuda") -> None:
    """`[stream-kernels]`: K4 and K5 against their plain versions at the
    stream engines' shapes, in the order hop 1024, 512, 1024 from a cold
    grid cache (the order in which the parent's K4 failed its third
    launch): the live engine's ring (1 x 33,075 samples at hop 1024, 33
    frames; 64 slots at its min separation), the scan engine's window
    (256 rings x 33,075 at hop 512, 65 frames; 8 slots, min_sep 0), the
    live ring again. Then each kernel timed at both shapes (CUDA events
    over POOL inputs, the profiler's device ms, the plain version, the
    bound), into `stream_shapes` of its kernels-line row."""
    import types

    import torch
    from gat_tpu_torch.ops import onset
    from gat_tpu_torch.stream import LiveTranscriber, scan
    dev = torch.device(device)
    live_sep = LiveTranscriber(types.SimpleNamespace(clip_length=0.5),
                               verbose=False)._min_sep_s
    w, chunk = scan._WINDOW_CHUNKS, FILE_SR // 2
    y, _ = stream_riff(w * 0.5 + 1.0, SEED + 13)
    stream = torch.from_numpy(np.pad(y, (FILE_SR, 0))).to(dev)
    rings = stream[:(w - 1) * chunk + LIVE_RING].unfold(
        0, LIVE_RING, chunk).contiguous()
    shapes = {"live": (rings[40:41].contiguous(), 1024, live_sep, 64),
              "scan": (rings, 512, 0.0, 8)}
    onset._envelope_grid.cache_clear()
    for name in ("live", "scan", "live"):
        x, hop, sep, slots = shapes[name]
        tag = (f"{x.shape[0]} x {x.shape[1]} samples at hop {hop}, "
               f"{slots} slots, min_sep {sep:.4f} s")
        try:
            env = onset.onset_strength(x, FILE_SR, hop_length=hop)
            ref = onset.onset_strength_plain(x, FILE_SR, hop_length=hop)
            got = onset.pick_onsets(env, FILE_SR, hop, sep, slots)
            want = onset.pick_onsets_plain(env, FILE_SR, hop, sep, slots)
            torch.cuda.synchronize()
        except RuntimeError as exc:
            log(f"[stream-kernels] {name} ({tag}): launch failed ({exc})")
            failures.append(f"[stream-kernels] {name} at hop {hop}: {exc}")
            continue
        err = float((env - ref).abs().max())
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        n_on = int(want[1].sum())
        ok = (err <= 1e-3 and same and n_on > 0
              and bool(torch.isfinite(env).all()))
        log(f"[stream-kernels] {name} ({tag}): K4 {tuple(env.shape)} max "
            f"abs err {err:.3g} (atol 1e-3); K5 outputs identical {same} "
            f"({n_on} onsets, {int(want[2].sum())} rows flagged) -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"[stream-kernels] {name} at hop {hop}")
    for name, (x, hop, sep, slots) in shapes.items():
        files, n = x.shape
        pool = noisy_pool(x, SEED + 14, 0.001)

        def env_fn(z, hop=hop):
            return onset.onset_strength(z, FILE_SR, hop_length=hop)

        def env_plain(z, hop=hop):
            return onset.onset_strength_plain(z, FILE_SR, hop_length=hop)

        def pick(e, hop=hop, sep=sep, slots=slots):
            return onset.pick_onsets(e, FILE_SR, hop, sep, slots)

        def pick_plain(e, hop=hop, sep=sep, slots=slots):
            return onset.pick_onsets_plain(e, FILE_SR, hop, sep, slots)

        t = 1 + n // hop
        k4 = dict(shape=name, files=files, hop=hop, frames=t,
                  ms=time_ms(env_fn, pool, reps=10),
                  device_ms=kernel_device_ms(env_fn, pool, "K4"),
                  plain_ms=time_ms(env_plain, pool, reps=3))
        k4["bound_ms"], k4["bound_by"] = envelope_bound(files, n, dev, hop)
        envs = [env_fn(z) for z in pool]
        k5 = dict(shape=name, files=files, hop=hop, frames=t,
                  max_onsets=slots, ms=time_ms(pick, envs, reps=10),
                  device_ms=kernel_device_ms(pick, envs, "K5"),
                  plain_ms=time_ms(pick_plain, envs, reps=3),
                  host_us=host_us(pick, envs, reps=30))
        k5["bound_ms"], k5["bound_by"] = pick_bound(files, t, hop, slots)
        for row, r, what in ((rows[3], k4, "onset_envelope"),
                             (rows[4], k5, "onset_pick")):
            row.setdefault("stream_shapes", []).append(r)
            log(f"[stream-kernels] {what} at the {name} shape ({files} x "
                f"{t} frames, hop {hop}): kernel {r['ms']:.4f} ms (events), "
                f"{fmt_ms(r['device_ms'])} device (profiler), plain "
                f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
                f"({r['bound_by']})"
                + (f", wrapper host {r['host_us']:.1f} us" if "host_us" in r
                   else ""))


def same_notes(got: list, ref: list) -> tuple[bool, float]:
    """Onset times, labels and overflow flags of two note lists identical
    and probs within 1e-2; returns (same, max prob error)."""
    def key(notes):
        return [(r.get("onset_s"), r["labels"], r.get("onset_overflow"))
                for r in notes]
    if key(got) != key(ref):
        return False, float("inf")
    err = max((float(np.abs(g["probs"] - r["probs"]).max())
               for g, r in zip(got, ref)), default=0.0)
    return err <= 1e-2, err


def counting(module, counts: list):
    """`module._to_host` wrapped to add one to counts[0] per transfer;
    returns the original, to put back."""
    original = module._to_host

    def counted(outs):
        counts[0] += 1
        return original(outs)
    module._to_host = counted
    return original


def sync_warnings(fn) -> tuple:
    """fn() under torch's sync debug mode "warn": (its result, the
    synchronizing CUDA calls it made as torch warns of them, counted by
    the file:line of the Python call that made each)."""
    import collections
    import warnings

    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, collections.Counter(
        f"{Path(w.filename).name}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))


def stream_phase(rows: list, card: str, failures: list,
                 device: str = "cuda") -> None:
    """`[stream]`: `ScanStreamer.transcribe_stream` on the card and on the
    CPU over a STREAM_SECONDS riff (a pluck every STREAM_SPACING s): the
    per-chunk slots identical, the notes identical (onsets, labels,
    flags; probs within 1e-2), every planted note found within 0.1 s;
    K1-K5 launched, two host transfers per window. Then the
    STREAM_LONG_SECONDS riff (602 chunks, 3 windows): equal to the CPU's,
    ms per call (median of 3), audio-s/s, transfers, launches and
    synchronizing calls per call, the device's busy share, and the taken
    notes against the 8 slots a chunk that the JAX engine computes."""
    import torch
    from gat_tpu_torch.infer import Transcriber
    from gat_tpu_torch.stream import ScanStreamer, scan
    card_st = ScanStreamer(Transcriber(device=device))
    cpu_st = ScanStreamer(Transcriber(device="cpu"))
    transfers = [0]
    original = counting(scan, transfers)
    try:
        for seconds, seed in ((STREAM_SECONDS, SEED + 11),
                              (STREAM_LONG_SECONDS, SEED + 12)):
            y, planted = stream_riff(seconds, seed)
            n_chunks = -(-(len(y) + FILE_SR) // (FILE_SR // 2))
            windows = -(-n_chunks // scan._WINDOW_CHUNKS)
            card_st.transcribe_stream(y)  # first call at these shapes
            transfers[0] = 0
            got, launches, wall = driven(lambda: card_st.transcribe_stream(y))
            n_host = transfers[0]
            # before the CPU's run, which inserts its own keys into the
            # device-table caches
            _, n_sync = sync_warnings(lambda: card_st.transcribe_stream(y))
            t0 = time.perf_counter()
            ref = cpu_st.transcribe_stream(y)
            cpu_s = time.perf_counter() - t0
            slots_same = all(np.array_equal(a, b) for a, b in zip(
                card_st.segment_stream(y), cpu_st.segment_stream(y)))
            same, err = same_notes(got, ref)
            found = sum(any(abs(r["onset_s"] - t) <= 0.1
                            and r["labels"][0] == lab for r in got)
                        for t, lab in planted)
            ok = (slots_same and same and found == len(planted)
                  and not not_launched(launches, (K1, K2, K3, K4, K5, K9))
                  and n_host == 2 * windows)
            tag = f"transcribe_stream({seconds:g} s, {n_chunks} chunks, " \
                  f"{windows} windows)"
            log(f"[stream] {tag}: {len(got)} notes, planted found "
                f"{found}/{len(planted)}; slots identical to the CPU's "
                f"{slots_same}, notes equal {same} (max prob err "
                f"{err:.3g}); launches K1..K13, branch {launches}, host transfers "
                f"{n_host} (2 per window), synchronizing calls "
                f"{sum(n_sync.values())} {dict(n_sync)}; "
                f"{wall * 1e3:.3f} ms on {card} (CPU plain path "
                f"{cpu_s:.1f} s) -> {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"[stream] {tag}")
            if seconds == STREAM_SECONDS:
                record_launches(rows, "stream", launches)
                continue
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                card_st.transcribe_stream(y)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            ms = statistics.median(walls)
            busy = profile_call(lambda: card_st.transcribe_stream(y), ms)
            numbers = dict(ms=ms, ms_each=walls, audio_s_per_s=seconds / ms
                           * 1e3, host_transfers=n_host, launches=launches,
                           sync_calls=sum(n_sync.values()), busy_ms=busy,
                           notes=len(got), slots=n_chunks * 8,
                           chunks=n_chunks, windows=windows)
            log(f"[stream] {tag}: median {ms:.3f} ms of 3 ({walls}), "
                f"{numbers['audio_s_per_s']:.1f} audio-s/s, {len(got)} "
                f"taken notes through the ensemble against the "
                f"{n_chunks * 8} slots the JAX engine computes; on {card}")
            log(f"[stream] numbers {json.dumps(numbers)}")
    finally:
        scan._to_host = original


def live_phase(rows: list, card: str, failures: list,
               device: str = "cuda") -> None:
    """`[live]`: `LiveTranscriber.run_on_source` over the STREAM_SECONDS
    riff in blocks of 1024, on the card and on the CPU: the same labels
    (probs within 1e-2), the planted sequence once same-label echoes are
    collapsed; K4 and K5 launched once per detecting poll (hop 1024);
    wall ms per poll (process_buffer + drain_queue), host transfers per
    detecting poll, and the synchronizing calls of a run by source
    line."""
    from gat_tpu_torch.infer import Transcriber
    from gat_tpu_torch.stream import ArraySource, LiveTranscriber, live
    card_t, cpu_t = Transcriber(device=device), Transcriber(device="cpu")
    y, planted = stream_riff(STREAM_SECONDS, SEED + 11)
    polls = len(range(0, len(y), 1024)) + 1  # the blocks and the flush
    LiveTranscriber(card_t, verbose=False).run_on_source(ArraySource(y))
    transfers = [0]
    original = counting(live, transfers)
    try:
        got, launches, wall = driven(lambda: LiveTranscriber(
            card_t, verbose=False).run_on_source(ArraySource(y)))
    finally:
        live._to_host = original
    record_launches(rows, "live", launches)
    _, n_sync = sync_warnings(lambda: LiveTranscriber(
        card_t, verbose=False).run_on_source(ArraySource(y)))
    ref = LiveTranscriber(cpu_t, verbose=False).run_on_source(
        ArraySource(y))
    same, err = same_notes(got, ref)
    labels = [r["labels"][0] for r in got]
    seq = [lab for i, lab in enumerate(labels)
           if not i or labels[i - 1] != lab]  # same-label echoes collapsed
    detecting = launches[3]
    ok = (same and seq == [lab for _, lab in planted]
          and detecting == launches[4] > 0 and transfers[0] == detecting
          and launches[K9] >= 1)
    log(f"[live] run_on_source({STREAM_SECONDS:g} s riff, {len(planted)} "
        f"plucks, {polls} polls): {len(got)} notes transcribed, labels "
        f"equal to the CPU's {same} (max prob err {err:.3g}), the planted "
        f"sequence {seq == [lab for _, lab in planted]}; launches K1..K13, branch "
        f"{launches} ({detecting} detecting polls, K4/K5 once each), onset "
        f"transfers {transfers[0]}, synchronizing calls "
        f"{sum(n_sync.values())} {dict(n_sync)}; {wall * 1e3:.3f} ms, "
        f"{wall * 1e3 / polls:.3f} ms per poll, "
        f"{wall * 1e3 / max(detecting, 1):.3f} ms per detecting poll on "
        f"{card} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("[live] card and CPU disagree, or a planted note or "
                        "a launch is missing")


def cli_phase(rows: list, card: str, failures: list,
              device: str = "cuda") -> None:
    """`[cli]`: `gat_tpu_torch.cli.main` in-process on the card and with
    `--device cpu`, for one WAV, two WAVs (one `transcribe_files` call)
    and `--stream`, each with `--save_results`: the same result files,
    their rows the same indices or onsets and labels, confidences within
    1e-2; all five kernels launch in the card's runs."""
    import contextlib
    import io

    from gat_tpu_torch import cli
    from gat_tpu_torch.utils.wavio import write_wav
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        a, b = d / "riff.wav", d / "riff44.wav"
        write_wav(a, make_riffs(np.array([FILE_MIDI]), 3.9, FILE_SR,
                                SEED + 15, noise=0.0)[0], FILE_SR)
        write_wav(b, make_riffs(np.array([np.roll(FILE_MIDI, -1)]), 3.9,
                                44100, SEED + 16, noise=0.0)[0], 44100)
        cases = {"one WAV": [str(a)], "two WAVs": [str(a), str(b)],
                 "--stream": [str(a), "--stream"]}

        def run_all(out: Path, device_args: list) -> None:
            for i, args in enumerate(cases.values()):
                cli.main(["--audio", *args, "--save_results", "--out",
                          str(out / str(i)), *device_args])

        with contextlib.redirect_stdout(io.StringIO()):  # the CLI's tables
            _, launches, wall = driven(lambda: run_all(
                d / "card", [] if device == "cuda" else ["--device", device]))
            run_all(d / "cpu", ["--device", "cpu"])
        record_launches(rows, "cli", launches)
        for i, name in enumerate(cases):
            files = sorted(p.name for p in (d / "card" / str(i)).glob("*"))
            ok = files == sorted(p.name for p in
                                 (d / "cpu" / str(i)).glob("*")) and files
            n_rows = 0
            for f in files:
                rows_card, rows_cpu = (
                    [ln.split(",") for ln in
                     (d / side / str(i) / f).read_text().split("\n\n")[0]
                     .splitlines()] for side in ("card", "cpu"))
                n_rows += len(rows_card)
                ok = (ok and len(rows_card) == len(rows_cpu) > 0
                      and all(g[:2] == r[:2]
                              and abs(float(g[2]) - float(r[2])) <= 1e-2
                              for g, r in zip(rows_card, rows_cpu)))
            log(f"[cli] {name}: {files}, {n_rows} result rows equal to "
                f"--device cpu's -> {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"[cli] {name}: the card's results differ")
    log(f"[cli] the three card runs: {wall * 1e3:.3f} ms with checkpoint "
        f"loads, launches K1..K13, branch {launches} on {card}")
    if not_launched(launches):
        failures.append(f"[cli] a kernel was not launched: {launches}")


def grad_errors(a, b) -> dict:
    """Per parameter, max |card − CPU| over max |CPU| of two trainers'
    gradients after one step; the conv biases ahead of BatchNorm are left
    out (their true gradient is 0, so both hold rounding noise)."""
    out = {}
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        if name.startswith("conv_") and name.endswith(".bias"):
            continue
        ref = q.grad.float()
        out[name] = float((p.grad.float().cpu() - ref).abs().max()
                          / ref.abs().max().clamp_min(1e-30))
    return out


def host_parts(t) -> dict:
    """One epoch of `t.train` with its optimizer steps and its `_step`
    calls wrapped in host clocks: µs per step, µs per AdamW.step, and the
    epoch's ms outside the steps. The card is host-bound here, so host
    time is wall time."""
    import torch
    acc = {"step": 0.0, "optimizer": 0.0, "n": 0}

    def clocked(fn, key):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            acc[key] += time.perf_counter() - t0
            acc["n"] += key == "step"
            return out
        return run
    t._step = clocked(t._step, "step")
    t.optimizer.step = clocked(t.optimizer.step, "optimizer")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t.train(epochs=1, verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del t._step, t.optimizer.step
    n = max(acc["n"], 1)
    return {"step": acc["step"] / n * 1e6,
            "optimizer": acc["optimizer"] / n * 1e6,
            "rest_ms": (wall - acc["step"]) * 1e3}


# K11-K13, the training step's kernels, at the shipped models' step: a
# batch of TRAIN_BATCH clips, 47 classes, the CNN's three BatchNorm layers
# on (64 mels x 22 frames) inputs, and K11 also at an eval chunk
# (`Trainer._EVAL_CHUNK` rows); TRAIN_STEPS steps profiled for the launches
# a step
TRAIN_BATCH, TRAIN_CLASSES, EVAL_CHUNK = 32, 47, 65536
BN_LAYERS = ((32, 32, 64, 22), (32, 64, 32, 11), (32, 128, 16, 5))
SMOOTHING = 0.05
TRAIN_STEPS = 10
# cudaLaunchKernel calls a step in a profile of a training epoch when the
# loss, the optimizer and BatchNorm were library calls (PERF.md §5)
LIBRARY_STEP_LAUNCHES = {"mlp": 95, "cnn": 308}
BN_KERNELS = ("bn_moments", "bn_apply", "bn_apply_grad", "bn_moments_grad")


def xent_pool(b: int, seed: int, dev) -> list:
    """POOL (logits (b, 47) float32, labels (b,) int64) on the card."""
    import torch
    rng = np.random.default_rng(seed)
    return [(torch.from_numpy(rng.normal(0.0, 3.0, (b, TRAIN_CLASSES))
                              .astype(np.float32)).to(dev),
             torch.from_numpy(rng.integers(0, TRAIN_CLASSES, b)).to(dev))
            for _ in range(POOL)]


def time_xent(dev, failures: list) -> dict:
    """K11 (`ops/loss.py::softmax_xent`) against its plain version at a
    step (32 x 47: the loss and its gradient, through autograd) and at an
    eval chunk (65,536 x 47: the loss sum, the count and the argmaxes, no
    gradient): loss within 1e-5 relative, gradient within 1e-6 of its
    largest value, counts and argmaxes equal; a second run on the same
    inputs the same bits (a failure where not); K11's launch (blocks,
    resident blocks per SM, rows a tile, lanes a row, shared bytes) where
    the checkout reports it; each timed in CUDA events (the step's loss
    and gradient, `torch.autograd.grad`), the kernel's device ms and the
    whole call's in the profiler, the plain version's ms, one
    `F.cross_entropy(label_smoothing=0.05)` forward and backward (at the
    eval chunk its forward, reduction "sum") in events and in device ms,
    the bound and an empty kernel's launch (`empty_launch_ms`). Returns
    the kernels-line row."""
    import torch
    import torch.nn.functional as F
    from gat_tpu_torch.ops import loss as loss_mod
    roofline = load_roofline()

    def with_grad(f):
        def run(xy):
            x = xy[0].detach().requires_grad_(True)
            loss = f(x, xy[1])
            return loss, torch.autograd.grad(loss, x)[0]
        return run
    scale = 1.0 / TRAIN_BATCH
    step = {"kernel": with_grad(lambda x, y: loss_mod.softmax_xent(
                x, y, SMOOTHING, scale)[0]),
            "plain": with_grad(lambda x, y: loss_mod.softmax_xent_plain(
                x, y, SMOOTHING, scale)[0]),
            "library": with_grad(lambda x, y: F.cross_entropy(
                x, y, label_smoothing=SMOOTHING))}
    evals = {"kernel": lambda xy: loss_mod.softmax_xent(
                 xy[0], xy[1], SMOOTHING, 1.0, preds=True),
             "plain": lambda xy: loss_mod.softmax_xent_plain(
                 xy[0], xy[1], SMOOTHING, 1.0, preds=True),
             "library": lambda xy: F.cross_entropy(
                 xy[0], xy[1], label_smoothing=SMOOTHING, reduction="sum")}
    out = {}
    for tag, fns, b, grad in (("step", step, TRAIN_BATCH, True),
                              ("eval", evals, EVAL_CHUNK, False)):
        pool = xent_pool(b, SEED + b, dev)
        got, ref = fns["kernel"](pool[0]), fns["plain"](pool[0])
        again = fns["kernel"](pool[0])
        same = all(bool(torch.equal(u, v)) for u, v in zip(got, again))
        counts = [int(loss_mod.softmax_xent(*pool[0], SMOOTHING, 1.0)[1]),
                  int(loss_mod.softmax_xent_plain(*pool[0], SMOOTHING)[1])]
        rel = float((got[0] - ref[0]).detach().abs() / ref[0].detach().abs())
        if grad:
            err = float((got[1] - ref[1]).abs().max())
            ok = err <= 1e-6 * float(ref[1].abs().max())
        else:
            err = 0.0
            ok = bool(torch.equal(got[2], ref[2]))
        ok = ok and rel <= 1e-5 and counts[0] == counts[1]
        err = max(err, float((got[0] - ref[0]).abs()))
        grid = (loss_mod.xent_grid(b, TRAIN_CLASSES, dev)
                if hasattr(loss_mod, "xent_grid") else None)
        if grid is not None:
            log(f"[occupancy] softmax_xent at {b} x {TRAIN_CLASSES} ({tag}): "
                f"{grid[0]} block(s) of 256 threads, {grid[1]} resident a "
                f"SM, {grid[2]} rows a tile, {grid[3]} lane(s) a row, "
                f"{grid[4]} shared bytes")
        cost = roofline.xent_cost(b, TRAIN_CLASSES, grad, preds=not grad)
        bound_ms, bound_by = roofline.bound(*cost)
        out[tag] = dict(
            rows=b, max_abs_err=err, deterministic=same,
            grid=None if grid is None else list(grid),
            ms=time_ms(fns["kernel"], pool, 10),
            device_ms=symbol_device_ms(fns["kernel"], pool, [
                "softmax_xent_kernel"])["softmax_xent_kernel"],
            call_device_ms=call_device_ms(fns["kernel"], pool),
            plain_ms=time_ms(fns["plain"], pool, 10),
            library_ms=time_ms(fns["library"], pool, 10),
            library_device_ms=call_device_ms(fns["library"], pool),
            bound_ms=bound_ms, bound_by=bound_by)
        o = out[tag]
        log(f"[train] softmax_xent at {b} x {TRAIN_CLASSES} ({tag}): loss "
            f"rel err {rel:.3g} (1e-5), max abs err {err:.3g}, correct "
            f"{counts}, {'gradient' if grad else 'argmaxes'}, two runs the "
            f"same bits {same} -> {'ok' if ok and same else 'FAIL'}; kernel "
            f"{o['ms']:.4f} ms (events), {fmt_ms(o['device_ms'])} device "
            f"({fmt_ms(o['call_device_ms'])} the whole call), plain "
            f"{o['plain_ms']:.4f} ms, F.cross_entropy {o['library_ms']:.4f} "
            f"ms (events), {fmt_ms(o['library_device_ms'])} device, bound "
            f"{bound_ms:.6f} ms ({bound_by})")
        if not ok:
            failures.append(f"[train] softmax_xent ({tag}) against its "
                            f"plain version")
        if not same:
            failures.append(f"[train] softmax_xent ({tag}): two runs differ")
        del pool
    floor = empty_launch_ms()
    log(f"[time] an empty kernel's launch: {fmt_ms(floor)} device")
    s = out["step"]
    return dict(name="softmax_xent", route="cuda",
                source="gat_tpu_torch/csrc/softmax_xent.cu",
                replaces="gat_tpu/train/trainer.py:250", launches=0,
                max_abs_err=max(o["max_abs_err"] for o in out.values()),
                tolerance="loss 1e-5 relative; gradient 1e-6 of its largest "
                          "value; counts and argmaxes equal; two runs the "
                          "same bits",
                ms=s["ms"], device_ms=s["device_ms"], plain_ms=s["plain_ms"],
                bound_ms=s["bound_ms"], bound_by=s["bound_by"],
                library_ms=s["library_ms"],
                library_device_ms=s["library_device_ms"],
                call_device_ms=s["call_device_ms"], grid=s["grid"],
                deterministic=all(o["deterministic"] for o in out.values()),
                empty_launch_ms=floor, eval_chunk=out["eval"])


def model_params(kind: str) -> int:
    """The shipped MLP's or CNN's parameter count."""
    from gat_tpu_torch.models import CNN, MLP
    model = MLP(65, 128, 2, TRAIN_CLASSES) if kind == "mlp" else CNN(
        TRAIN_CLASSES)
    return sum(p.numel() for p in model.parameters())


def empty_launch_ms() -> float | None:
    """The device time of an empty kernel's launch, the latency floor that
    K12's and K13's times read against: `torch.cuda._sleep(0)` (a kernel
    that spins for 0 cycles), the mean over 4 x POOL launches in the
    profiler, which sees no other kernel then. None where it saw no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(POOL):
        torch.cuda._sleep(0)
    torch.cuda.synchronize()
    best = None
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(4 * POOL):
                torch.cuda._sleep(0)
            torch.cuda.synchronize()
        kept = [e for e in prof.key_averages()
                if e.self_device_time_total > 0]
        n = sum(e.count for e in kept)
        if n:
            best = sum(e.self_device_time_total for e in kept) / n / 1e3
        if n == 4 * POOL:
            break
    return best


def time_clip_adamw(dev, failures: list) -> list[dict]:
    """K12 (`train/optim.py`: `clip_norm`, then `adamw_update`) at the
    shipped CNN's and MLP's parameter counts with gradients above the clip
    threshold (the step clips): one step against the plain versions on
    copies of the same buffers (norm within 1e-5 relative, parameters,
    moments and clipped gradients within 1e-6 of their largest value, the
    count equal) and against a second run on the same buffers (the same
    bits), the passes' grids (`optim.clip_adamw_grid`, where the checkout
    has it), then each pass timed over POOL optimizers in CUDA
    events, its device ms, its plain version's ms, the library's (pass
    1: `torch._foreach_norm`; pass 2: the `_foreach_mul_` clip, the step
    count's `_foreach_add_` and `torch._fused_adamw_`) in events and in
    device ms (every kernel it launches), its bound, and an empty
    kernel's launch (`empty_launch_ms`).
    Returns the two kernels-line rows (the CNN's numbers; the MLP's under
    `mlp`)."""
    import torch
    from gat_tpu_torch.train import optim
    roofline = load_roofline()
    rng = np.random.default_rng(SEED)
    per = {}
    for kind in ("cnn", "mlp"):
        n = model_params(kind)

        def make():
            p = torch.nn.Parameter(torch.from_numpy(
                rng.normal(0.0, 0.05, n).astype(np.float32)).to(dev))
            opt = optim.ClipAdamW([p], lr=1e-3, max_norm=1.0)
            opt.flat_grad.copy_(torch.from_numpy(
                rng.normal(0.0, 0.02, n).astype(np.float32)))
            return opt
        a = make()
        b, a2 = (optim.ClipAdamW([torch.nn.Parameter(a._flat_p.clone())],
                                 lr=1e-3, max_norm=1.0) for _ in range(2))
        b.flat_grad.copy_(a.flat_grad)
        a2.flat_grad.copy_(a.flat_grad)
        a.step()
        a2.step()
        same = all(torch.equal(getattr(a, f), getattr(a2, f)) for f in (
            "_flat_p", "mu", "nu", "flat_grad", "norm", "count"))
        log(f"[train] clip_adamw at {n} parameters ({kind}): two runs on "
            f"the same buffers give the same bits: {same}")
        if not same:
            failures.append(f"[train] clip_adamw ({kind}): two runs differ")
        del a2
        grid = (optim.clip_adamw_grid(n, dev)
                if hasattr(optim, "clip_adamw_grid") else None)
        if grid is not None:
            log(f"[occupancy] clip_adamw at {n} parameters ({kind}): pass 1 "
                f"{grid[0]} blocks of 256 threads, {grid[1]} resident a SM; "
                f"pass 2 {grid[2]} blocks, {grid[3]} resident a SM")
        optim.clip_norm_plain(b.flat_grad, b.norm, b.count)
        optim.adamw_update_plain(b._flat_p, b.flat_grad, b.mu, b.nu, b.norm,
                                 b.count, b.lr, 1.0, b.b1, b.b2, b.c1, b.c2,
                                 b.eps, b.weight_decay)
        rel = float((a.norm - b.norm).abs() / b.norm)
        errs = {k: float((getattr(a, f) - getattr(b, f)).abs().max())
                for k, f in (("p", "_flat_p"), ("mu", "mu"), ("nu", "nu"),
                             ("g", "flat_grad"))}
        ok = (rel <= 1e-5 and int(a.count) == int(b.count) == 1
              and all(errs[k] <= 1e-6 * float(getattr(b, f).abs().max())
                      for k, f in (("p", "_flat_p"), ("mu", "mu"),
                                   ("nu", "nu"), ("g", "flat_grad"))))
        clipped = float(b.norm) >= 1.0
        log(f"[train] clip_adamw at {n} parameters ({kind}): norm "
            f"{float(b.norm):.4f} rel err {rel:.3g} (1e-5), max abs err "
            f"{errs} (1e-6 of each buffer's largest), clipped {clipped} -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"[train] clip_adamw ({kind}) against its plain "
                            f"version")
        pool = [a] + [make() for _ in range(POOL - 1)]
        steps = [torch.zeros((), device=dev) for _ in pool]
        lib_of = {id(o): s for o, s in zip(pool, steps)}

        def norm_kernel(o):
            optim.clip_norm(o.flat_grad, o.norm, o.count, o._part)

        def update_kernel(o):
            optim.adamw_update(o._flat_p, o.flat_grad, o.mu, o.nu, o.norm,
                               o.count, o.lr, 1.0, o.b1, o.b2, o.c1, o.c2,
                               o.eps, o.weight_decay)

        def norm_plain(o):
            optim.clip_norm_plain(o.flat_grad, o.norm, o.count)

        def update_plain(o):
            optim.adamw_update_plain(o._flat_p, o.flat_grad, o.mu, o.nu,
                                     o.norm, o.count, o.lr, 1.0, o.b1, o.b2,
                                     o.c1, o.c2, o.eps, o.weight_decay)

        def norm_library(o):
            o.norm.copy_(torch._foreach_norm([o.flat_grad])[0])

        def update_library(o):
            coef = torch.clamp(1.0 / (o.norm + 1e-6), max=1.0)
            torch._foreach_mul_([o.flat_grad], coef)
            torch._foreach_add_([lib_of[id(o)]], 1)
            torch._fused_adamw_([o._flat_p], [o.flat_grad], [o.mu], [o.nu],
                                [], [lib_of[id(o)]], lr=1e-3, beta1=o.b1,
                                beta2=o.b2, weight_decay=o.weight_decay,
                                eps=o.eps, amsgrad=False, maximize=False)
        has_fused = hasattr(torch, "_fused_adamw_")
        per[kind] = {}
        for name, kern, plain, lib, cost, sym in (
                ("clip_norm", norm_kernel, norm_plain, norm_library,
                 roofline.clip_norm_cost(n), "clip_norm_kernel"),
                ("adamw_update", update_kernel, update_plain,
                 update_library if has_fused else None,
                 roofline.adamw_cost(n, clipped), "adamw_update_kernel")):
            bound_ms, bound_by = roofline.bound(*cost)
            o = dict(params=n, ms=time_ms(kern, pool, 10), deterministic=same,
                     host_us=host_us(kern, pool, 10),
                     grid=None if grid is None else grid[
                         0 if name == "clip_norm" else 2],
                     blocks_per_sm=None if grid is None else grid[
                         1 if name == "clip_norm" else 3],
                     device_ms=symbol_device_ms(kern, pool, [sym])[sym],
                     plain_ms=time_ms(plain, pool, 10),
                     library_ms=None if lib is None else time_ms(lib, pool,
                                                                 10),
                     library_device_ms=None if lib is None
                     else call_device_ms(lib, pool),
                     bound_ms=bound_ms, bound_by=bound_by,
                     max_abs_err=max(errs.values()))
            per[kind][name] = o
            log(f"[time] {name} at {n} parameters ({kind}): kernel "
                f"{o['ms']:.4f} ms (events), {fmt_ms(o['device_ms'])} "
                f"device, {o['host_us']:.1f} µs host a call, plain "
                f"{o['plain_ms']:.4f} ms, library "
                f"{fmt_ms(o['library_ms'])} (events), "
                f"{fmt_ms(o['library_device_ms'])} device, bound "
                f"{bound_ms:.6f} ms ({bound_by})")
        del pool
        torch.cuda.synchronize()
    floor = empty_launch_ms()
    log(f"[time] an empty kernel's launch: {fmt_ms(floor)} device")
    rows = []
    for name, replaces in (("clip_norm", "gat_tpu/train/trainer.py:263"),
                           ("adamw_update", "gat_tpu/train/trainer.py:264")):
        c = per["cnn"][name]
        rows.append(dict(
            name=name, route="cuda", source="gat_tpu_torch/csrc/clip_adamw.cu",
            replaces=replaces, launches=0,
            max_abs_err=max(per[k][name]["max_abs_err"] for k in per),
            tolerance="norm 1e-5 relative; p, mu, nu, clipped g 1e-6 of each "
                      "buffer's largest value; count equal",
            ms=c["ms"], device_ms=c["device_ms"], plain_ms=c["plain_ms"],
            bound_ms=c["bound_ms"], bound_by=c["bound_by"],
            library_ms=c["library_ms"],
            library_device_ms=c["library_device_ms"], params=c["params"],
            grid=c["grid"], blocks_per_sm=c["blocks_per_sm"],
            empty_launch_ms=floor,
            deterministic=all(per[k][name]["deterministic"] for k in per),
            mlp=per["mlp"][name]))
    return rows


def bn_layouts(dev) -> list:
    """(shape, strides, dtype, dy's strides) of x and of its incoming
    gradient at each BatchNorm of the shipped bf16 CNN's train-mode
    forward and backward on the card, as cuDNN's convolutions give them."""
    import torch
    from gat_tpu_torch.models import CNN
    from gat_tpu_torch.models import cnn as cnn_mod
    seen, grads = [], []
    inner = cnn_mod.batch_norm_train

    def spy(x, *args, **kwargs):
        seen.append((tuple(x.shape), x.stride(), x.dtype))
        y = inner(x, *args, **kwargs)
        y.register_hook(lambda g, i=len(seen) - 1: grads.append((i,
                                                                 g.stride())))
        return y
    model = CNN(TRAIN_CLASSES, dtype=torch.bfloat16).to(dev).train()
    x = torch.randn(TRAIN_BATCH, 64, 22, 1, device=dev)
    cnn_mod.batch_norm_train = spy
    try:
        model(x).float().sum().backward()
    finally:
        cnn_mod.batch_norm_train = inner
    dy = dict(grads)
    return [(*s, dy.get(i)) for i, s in enumerate(seen)]


def bn_grid(kernels, shape: tuple, last: bool, bf16: bool) -> dict | None:
    """K13's grids at an x of `shape` on the card (`gat_bn_splits`: blocks
    in the rows map, C·splits in the runs map; the two kernels that sum
    over the positions have their own), per kernel, and each kernel's
    resident blocks per SM (`gat_bn_blocks_per_sm`); None in a checkout
    whose K13 has neither."""
    import ctypes
    try:
        per_sm = kernels.function("batchnorm_train", "gat_bn_blocks_per_sm",
                                  [ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p])
    except AttributeError:
        return None
    splits = kernels.function("batchnorm_train", "gat_bn_splits",
                              [ctypes.c_int, ctypes.c_longlong]
                              + [ctypes.c_int] * 3)
    n, c, h, w = shape
    blocks = (ctypes.c_int * 4)()
    kernels.check(per_sm(int(bf16), int(last), blocks), "bn_blocks_per_sm")
    grid = {}
    for name in BN_KERNELS:
        s = splits(c, n * h * w, int(last), int(bf16),
                   int(name in ("bn_moments", "bn_apply_grad")))
        grid[name] = s if last else c * s
    return {"grid": grid, "blocks_per_sm": dict(zip(BN_KERNELS, blocks))}


def time_bn(dev, failures: list) -> list[dict]:
    """K13 (`ops/batchnorm.py`: moments and apply forward, apply-backward
    and moments-backward) at the shipped CNN's three layers at a step of
    32 clips, bfloat16 (the shipped CNN) and float32, in the layout the
    card's convolutions give (`bn_layouts`): forward and backward against
    the plain version and its autograd (float32 y and dx within 1e-4 of
    their largest value, bfloat16 within two of their ulps plus 1e-5 of
    it, dw and db 1e-4, running statistics 1e-5), then each kernel's
    device ms a layer in the profiler over a forward and backward, the
    whole forward and backward in CUDA events, the plain version's
    forward and its backward in CUDA events, and each kernel's bound;
    also two runs on the same inputs (the same bits, or a failure), each
    kernel's grid and resident blocks per SM (`bn_grid`, where the
    checkout has them), an empty kernel's launch (`empty_launch_ms`) and
    `F.batch_norm(training=True)` forward and backward in CUDA events
    (`nearest_library_ms`) and in the profiler's device time
    (`nearest_library_device_ms`), the same in all four rows: one call
    does the four kernels' work. Returns the four kernels-line rows: the bfloat16
    layers' sums, the float32 ones under `fp32`, per layer under
    `layers`; library_ms is null (F.batch_norm in training mode moves the
    running variance toward the unbiased variance, another function)."""
    import torch
    import torch.nn.functional as F
    from gat_tpu_torch import kernels
    from gat_tpu_torch.ops import batchnorm
    roofline = load_roofline()
    seen = bn_layouts(dev)
    last = [s[1][1] == 1 for s in seen]
    log(f"[train] BatchNorm inputs of the bf16 CNN on the card: "
        f"{[(s[0], s[1]) for s in seen]} (channels-last {last}); their "
        f"incoming gradients' strides {[s[3] for s in seen]}")
    channels_last = all(last)
    floor = empty_launch_ms()
    log(f"[time] an empty kernel's launch: {fmt_ms(floor)} device")
    syms = dict(zip(BN_KERNELS, load_roofline().KERNEL_SYMBOLS["K13"]))
    per = {name: {"bf16": [], "fp32": []} for name in BN_KERNELS}
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        elem = torch.tensor([], dtype=dtype).element_size()
        for shape in BN_LAYERS:
            rng = np.random.default_rng(sum(shape))
            fmt = (torch.channels_last if channels_last
                   else torch.contiguous_format)

            def t(*s):
                return torch.from_numpy(rng.normal(0.3, 1.5, s).astype(
                    np.float32)).to(dev)
            pool = [dict(x=t(*shape).to(dtype).contiguous(memory_format=fmt),
                         dy=t(*shape).to(dtype).contiguous(memory_format=fmt),
                         w=t(shape[1]), b=t(shape[1]), rm=t(shape[1]),
                         rv=t(shape[1]).abs()) for _ in range(POOL)]

            def run(fn, backward=True):
                def go(d):
                    x = d["x"].detach().requires_grad_(True)
                    w = d["w"].detach().requires_grad_(True)
                    b = d["b"].detach().requires_grad_(True)
                    rm, rv = d["rm"].clone(), d["rv"].clone()
                    y = fn(x, w, b, rm, rv, 1e-5, 0.9)
                    if not backward:
                        return y
                    return (y, rm, rv) + torch.autograd.grad(
                        y, (x, w, b), d["dy"])
                return go
            kern = run(batchnorm.batch_norm_train)
            plain = run(batchnorm.batch_norm_train_plain)
            library = run(lambda x, w, b, rm, rv, eps, mom: F.batch_norm(
                x, rm, rv, w, b, True, 1.0 - mom, eps))
            got, ref = kern(pool[0]), plain(pool[0])
            same = all(torch.equal(a, b) for a, b in zip(got, kern(pool[0])))
            grid = bn_grid(kernels, shape, channels_last, tag == "bf16")
            log(f"[train] batch_norm {tag} at {shape}: two runs on the same "
                f"inputs give the same bits: {same}")
            if not same:
                failures.append(f"[train] batch_norm {tag} {shape}: two "
                                f"runs differ")
            if grid is not None:
                log(f"[occupancy] batch_norm {tag} at {shape}: blocks of "
                    f"256 threads {grid['grid']} "
                    f"({'rows' if channels_last else 'runs'} map), resident "
                    f"blocks a SM {grid['blocks_per_sm']}")
            errs, ok = {}, True
            for name, g, r in zip(("y", "rm", "rv", "dx", "dw", "db"), got,
                                  ref):
                g, r = g.float(), r.float()
                scale = float(r.abs().max())
                diff = (g - r).abs()
                errs[name] = float(diff.max())
                if dtype == torch.bfloat16 and name in ("y", "dx"):
                    bound = 2.0 * 2.0 ** (torch.floor(torch.log2(
                        r.abs().clamp_min(1e-30))) - 7) + 1e-5 * scale
                    ok = ok and bool((diff <= bound).all())
                else:
                    tol = 1e-5 if name in ("rm", "rv") else 1e-4
                    ok = ok and errs[name] <= tol * scale
            log(f"[train] batch_norm {tag} at {shape}: max abs err {errs} "
                f"-> {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"[train] batch_norm {tag} {shape} against "
                                f"its plain version")
            device = symbol_device_ms(kern, pool, list(syms.values()))
            events = time_ms(kern, pool, 10)
            host = host_us(kern, pool, 10)
            plain_fwd = time_ms(run(batchnorm.batch_norm_train_plain, False),
                                pool, 10)
            plain_all = time_ms(plain, pool, 10)
            lib_all = time_ms(library, pool, 10)
            lib_device = call_device_ms(library, pool)
            n, c, h, w = shape
            for name in BN_KERNELS:
                bound_ms, bound_by = roofline.bound(*roofline.bn_cost(
                    name.removeprefix("bn_"), n, c, h * w, elem))
                forward = name in ("bn_moments", "bn_apply")
                per[name][tag].append(dict(
                    shape=list(shape), device_ms=device[syms[name]],
                    events_ms=events, bound_ms=bound_ms, bound_by=bound_by,
                    plain_ms=plain_fwd if forward else plain_all - plain_fwd,
                    nearest_library_ms=lib_all,
                    nearest_library_device_ms=lib_device, deterministic=same,
                    host_us=host,
                    grid=None if grid is None else grid["grid"][name],
                    blocks_per_sm=None if grid is None else grid[
                        "blocks_per_sm"][name],
                    max_abs_err=max(errs[k] for k in (
                        ("y", "rm", "rv") if forward else
                        ("dx", "dw", "db")))))
            shown = {k: None if v is None else round(v, 5)
                     for k, v in device.items()}
            log(f"[time] batch_norm {tag} at {shape}: device ms {shown}, "
                f"forward and backward {events:.4f} ms (events), "
                f"{host:.1f} µs host; plain "
                f"forward {plain_fwd:.4f} ms, backward "
                f"{plain_all - plain_fwd:.4f} ms; F.batch_norm(training="
                f"True) forward and backward {lib_all:.4f} ms (events), "
                f"{fmt_ms(lib_device)} device")
            del pool
            torch.cuda.synchronize()
    rows = []
    for name in BN_KERNELS:
        layers = per[name]

        def total(tag, key):
            vals = [o[key] for o in layers[tag]]
            return None if any(v is None for v in vals) else sum(vals)
        rows.append(dict(
            name=name, route="cuda",
            source="gat_tpu_torch/csrc/batchnorm_train.cu",
            replaces="gat_tpu/models/cnn.py:84", launches=0,
            max_abs_err=max(o["max_abs_err"] for t in layers.values()
                            for o in t),
            tolerance="float32 y, dx 1e-4 of the largest; bfloat16 two ulps "
                      "+ 1e-5 of the largest; dw, db 1e-4; running stats "
                      "1e-5",
            ms=total("bf16", "device_ms"), device_ms=total("bf16",
                                                           "device_ms"),
            plain_ms=total("bf16", "plain_ms"),
            bound_ms=total("bf16", "bound_ms"), bound_by="bytes",
            library_ms=None,
            library_note="F.batch_norm in training mode moves the running "
                         "variance toward the unbiased variance: another "
                         "function",
            nearest_library_ms=total("bf16", "nearest_library_ms"),
            nearest_library_device_ms=total("bf16",
                                            "nearest_library_device_ms"),
            empty_launch_ms=floor,
            grid=[o["grid"] for o in layers["bf16"]],
            blocks_per_sm=layers["bf16"][0]["blocks_per_sm"],
            deterministic=all(o["deterministic"] for t in layers.values()
                              for o in t),
            layers=layers["bf16"], fp32=dict(
                ms=total("fp32", "device_ms"),
                plain_ms=total("fp32", "plain_ms"),
                bound_ms=total("fp32", "bound_ms"), layers=layers["fp32"])))
    return rows


def train_kernel_rows(failures: list, device: str = "cuda") -> list[dict]:
    """`[train]`'s kernels K11-K13 against their plain versions and timed
    at the step's shapes (`time_xent`, `time_clip_adamw`, `time_bn`): the
    kernels line's rows softmax_xent, clip_norm, adamw_update and the four
    bn_* rows, each with launches 0 until `train_all` fills them in."""
    import torch
    dev = torch.device(device)
    rows = [time_xent(dev, failures)]
    rows += time_clip_adamw(dev, failures)
    rows += time_bn(dev, failures)
    return rows


def step_launches(t, steps: int = TRAIN_STEPS) -> dict:
    """`steps` optimizer steps of trainer t on its first batch, after one
    warm step: host µs a step (the host clock over the steps, synchronised
    at the end; the card is idle for most of a step, so this is the wall)
    and, from a profiler over as many steps, the `cudaLaunchKernel` calls
    a step (the CUDA runtime's launches: PyTorch's kernels and the port's
    alike) and the device ms a step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    xb = t._upload(t.train_dl.X[:TRAIN_BATCH])
    yb = t._upload(t.train_dl.y[:TRAIN_BATCH], torch.int64)
    t._step(xb, yb)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        t._step(xb, yb)
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) / steps * 1e6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            t._step(xb, yb)
        torch.cuda.synchronize()
    events = prof.key_averages()
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC"))
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)) / 1e3
    return {"host_us": host, "launches": launches / steps,
            "device_ms": busy / steps}


def time_train(dev, failures: list) -> list[dict]:
    """`tools/torch_onset_timing.py TREE train`: the steady-state epoch of
    the shipped MLP (fp32) and CNN (bf16) at `[train]`'s sizes (601
    training and 151 validation examples of random features from SEED,
    batch 32, 47 classes), for whichever checkout's package is imported:
    ms an epoch (validation included; the median of 3 after 2 warm
    epochs) and `step_launches`. One row per family."""
    import torch
    from gat_tpu_torch.models import CNN, MLP
    from gat_tpu_torch.train import ArrayDataLoader, Trainer
    rng = np.random.default_rng(SEED)
    y = rng.integers(0, TRAIN_CLASSES, 752)
    rows = []
    for fam in ("mlp", "cnn"):
        if fam == "mlp":
            X = rng.normal(size=(752, 65)).astype(np.float32)
            model = MLP(65, 128, 2, TRAIN_CLASSES)
        else:
            X = rng.normal(-40.0, 15.0, (752, 64, 22, 1)).astype(np.float32)
            model = CNN(TRAIN_CLASSES, dtype=torch.bfloat16)
        t = Trainer(model, ArrayDataLoader(X[:601], y[:601], seed=SEED),
                    ArrayDataLoader(X[601:], y[601:], shuffle=False),
                    reverse_map={i: str(i) for i in range(TRAIN_CLASSES)},
                    seed=SEED, device=str(dev))
        t.train(epochs=2, verbose=False)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t.train(epochs=1, verbose=False)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        step = step_launches(t)
        rows.append(dict(family=fam, ms_per_epoch=statistics.median(times),
                         epoch_ms=times, steps_per_epoch=-(-601 // 32),
                         **{f"step_{k}": v for k, v in step.items()}))
        log(f"[train] {fam}: {statistics.median(times):.3f} ms an epoch "
            f"(median of {[round(x, 3) for x in times]}), a step "
            f"{step['host_us']:.0f} µs host, {step['launches']:.1f} "
            f"cudaLaunchKernel, {step['device_ms']:.4f} ms device")
        if not np.isfinite(t.train_loss_history).all():
            failures.append(f"[train] {fam}: losses not finite")
    return rows


def train_phase(rows: list, card: str, failures: list,
                device: str = "cuda") -> None:
    """`[train]`: the training path at the shipped recipe's settings with
    TRAIN_VARIANTS variants per class (752 clips at 11025 Hz, 601 train /
    151 val), full width (MLP 65→128→64→47, bf16 CNN 32/64/128, hidden
    256): K1-K3 against their plain versions at the dataset's shape, the
    FeatureBuilder's features on the card against the CPU plain path's,
    one dropout-0 step on the card against the CPU (fp32 MLP and CNN, bf16
    CNN), `TrainingManager.train_all` for TRAIN_EPOCHS epochs (K1-K3
    launched, losses finite, one host transfer per epoch), ms per epoch,
    optimizer steps/s, examples/s and the device's busy share per family,
    and a saved pair of checkpoints through `Transcriber`: labels equal to
    the trainers' predictions, arrays of the shipped files' keys and
    shapes."""
    import torch
    from gat_tpu_torch import features
    from gat_tpu_torch.config import CHECKPOINTS_ROOT
    from gat_tpu_torch.data.loader import AudioDatasetLoader
    from gat_tpu_torch.data.synth import synthesize_note_dataset
    from gat_tpu_torch.infer import Transcriber
    from gat_tpu_torch.models import CNN, MLP
    from gat_tpu_torch.ops import yin
    from gat_tpu_torch.train import ArrayDataLoader, TrainingManager
    from gat_tpu_torch.train import trainer as trainer_mod
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        ds = d / "synthetic" / "recipe"
        t0 = time.perf_counter()
        synthesize_note_dataset(ds, variants_per_class=TRAIN_VARIANTS,
                                seed=42, verbose=False,
                                noise_snr_db=(8.0, 40.0), family="all3",
                                stressor="mix", stressor_prob=0.5,
                                channel="mix", channel_prob=0.25)
        synth_s = time.perf_counter() - t0

        # K1-K3 at the dataset's shape, and the FeatureBuilder on the card
        # against the CPU plain path
        loader = AudioDatasetLoader([ds], target_sr=SR, duration=0.5,
                                    device=device)
        wavs = np.stack(loader.load_audio_dataset()[0])
        clips = torch.as_tensor(wavs).to(device)
        err_mel, ok_mel = mel_error(features.melspec_features(clips, SR),
                                    features.melspec_features_plain(clips,
                                                                    SR))
        err_mfcc = float((features.mfcc_frontend(clips, SR)
                          - features.mfcc_frontend_plain(clips, SR))
                         .abs().max())
        hz, hz_ref = yin.yin_pitch(clips, SR), yin.yin_pitch_plain(clips, SR)
        rel_yin = float(((hz - hz_ref).abs() / hz_ref).max())
        ok = ok_mel and err_mfcc <= 1e-3 and rel_yin <= 2e-3
        log(f"[train] kernels at {tuple(clips.shape)}: melspec_frontend max "
            f"abs err {err_mel:.6g} dB (0.1 where > -60 dB), mfcc_frontend "
            f"{err_mfcc:.6g} (1e-3), yin_pitch max rel err {rel_yin:.3g} "
            f"(2e-3) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append("[train] a kernel disagrees at the dataset shape")
        # K11-K13 against their plain versions at the step's shapes, timed
        train_rows = train_kernel_rows(failures, device)
        rows += train_rows
        fb = features.FeatureBuilder(device=device)
        (mf, y, _, _), l_mf, _ = driven(lambda: fb.extract_mfcc_features(
            loader))
        (mel, _, _, _), l_mel, _ = driven(
            lambda: fb.extract_melspec_features(loader))
        cpu_loader = AudioDatasetLoader([ds], target_sr=SR, duration=0.5,
                                        device="cpu")
        cpu_fb = features.FeatureBuilder(device="cpu")
        t0 = time.perf_counter()
        mf_ref = cpu_fb.extract_mfcc_features(cpu_loader)[0]
        mel_ref = cpu_fb.extract_melspec_features(cpu_loader)[0]
        cpu_s = time.perf_counter() - t0
        e_mfcc = float(np.abs(mf[:, :64] - mf_ref[:, :64]).max())
        e_pitch = float(np.abs(10.0 ** (mf[:, 64] - mf_ref[:, 64]) - 1).max())
        e_mel = float(np.abs(mel - mel_ref)[mel_ref > -60.0].max())
        ok = (l_mf[1:3] == [1, 1] and l_mel[0] == 1 and e_mfcc <= 1e-3
              and e_pitch <= 2e-3 and e_mel <= 0.1
              and np.isfinite(mf).all() and np.isfinite(mel).all())
        log(f"[train] FeatureBuilder on {len(y)} clips: X {mf.shape} and "
            f"{mel.shape}; launches K1..K13, branch {l_mf} (MFCC) and {l_mel} (mel); "
            f"vs the CPU plain path ({cpu_s:.1f} s): MFCC max abs err "
            f"{e_mfcc:.3g} (1e-3), pitch rel {e_pitch:.3g} (2e-3), mel "
            f"{e_mel:.3g} dB (0.1 where > -60 dB) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append("[train] FeatureBuilder: launches or features")

        # one dropout-0 step from the same weights on the card and the CPU
        xb_mf = (mf[:32] - mf[:32].mean(0)) / (mf[:32].std(0) + 1e-6)
        for name, make, xb, bound_rel in (
                ("MLP fp32", lambda: MLP(65, 128, 2, 47, 0.0), xb_mf, 1e-3),
                ("CNN fp32", lambda: CNN(47, dropout=0.0), mel[:32], 1e-3),
                ("CNN bf16", lambda: CNN(47, dropout=0.0,
                                         dtype=torch.bfloat16), mel[:32],
                 5e-2)):
            pair = [trainer_mod.Trainer(make(), ArrayDataLoader(xb, y[:32]),
                                        seed=0, device=dev)
                    for dev in (device, "cpu")]
            losses = [float(t._step(torch.as_tensor(xb).to(t.device),
                                    torch.as_tensor(y[:32]).long()
                                    .to(t.device))[0]) for t in pair]
            errs = grad_errors(*pair)
            worst = max(errs, key=errs.get)
            ok = (errs[worst] <= bound_rel
                  and abs(losses[0] - losses[1]) <= bound_rel * losses[1])
            log(f"[train] one step, {name}: loss card {losses[0]:.6f} CPU "
                f"{losses[1]:.6f}; gradients max |card - CPU| / max |CPU| "
                f"{errs[worst]:.3g} ({worst}; bound {bound_rel:g}) -> "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"[train] one step {name}: card and CPU")

        # train_all at full width, then the steady-state epoch
        mgr = TrainingManager(datasets_root=d, target_sr=SR, device=device)
        transfers = [0]
        original = counting(trainer_mod, transfers)
        # the trainer's K11 calls, a step's (with the gradient) apart from
        # an evaluation's (with the argmaxes)
        xent_calls = {"step": 0, "eval": 0}
        inner_xent = trainer_mod.softmax_xent

        def counted_xent(*args, preds=False, **kwargs):
            xent_calls["eval" if preds else "step"] += 1
            return inner_xent(*args, preds=preds, **kwargs)
        trainer_mod.softmax_xent = counted_xent
        try:
            (mlp_t, cnn_t), launches, wall = driven(lambda: mgr.train_all(
                ds, epochs=TRAIN_EPOCHS, save=False, verbose=False))
            n_host = transfers[0]
        finally:
            trainer_mod._to_host = original
            trainer_mod.softmax_xent = inner_xent
        record_launches(rows, "train", launches)
        finite = all(np.isfinite(t.train_loss_history + t.val_loss_history)
                     .all() for t in (mlp_t, cnn_t))
        ok = (min(launches[:3]) >= 1 and launches[K9] >= 1 and finite
              and mlp_t.epoch == cnn_t.epoch == TRAIN_EPOCHS
              and n_host == 2 * TRAIN_EPOCHS)
        log(f"[train] train_all({len(y)} clips, {TRAIN_EPOCHS} epochs) in "
            f"{wall:.2f} s (synthesis {synth_s:.1f} s before it): launches "
            f"K1..K13, branch {launches}, host transfers {n_host} (one per epoch), "
            f"losses finite {finite} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append("[train] train_all: launches, transfers or "
                            "losses")
        # K11 once a step and once an evaluation chunk, K12's passes once a
        # step, K13's kernels once a CNN step and BatchNorm layer (three)
        steps = sum(t.epoch * len(t.train_dl) for t in (mlp_t, cnn_t))
        cnn_steps = cnn_t.epoch * len(cnn_t.train_dl)
        want = {K11: steps + xent_calls["eval"], K12N: steps, K12U: steps,
                **{k: 3 * cnn_steps for k in BATCHNORM}}
        ok = (xent_calls["step"] == steps
              and all(launches[k] == n for k, n in want.items()))
        log(f"[train] K11-K13 on train_all: {steps} steps ({cnn_steps} of "
            f"the CNN), {xent_calls['eval']} evaluation chunks; launches "
            f"{ {KERNEL_ROWS[k]: launches[k] for k in want} }, expected "
            f"{ {KERNEL_ROWS[k]: n for k, n in want.items()} } -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append("[train] K11-K13 launches on train_all")
        for row in train_rows:
            row["launches"] = launches[KERNEL_ROWS.index(row["name"])]
        numbers = {}
        for fam, t in (("mlp", mlp_t), ("cnn", cnn_t)):
            n_tr = len(t.train_dl.y)
            steps = -(-n_tr // t.train_dl.batch_size)
            t.train(epochs=1, verbose=False)  # warm: cuDNN plans, caches
            _, n_sync = sync_warnings(lambda: t.train(epochs=1,
                                                      verbose=False))
            host = host_parts(t)
            step = step_launches(t)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t.train(epochs=TRAIN_EPOCHS, verbose=False)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / TRAIN_EPOCHS
            busy = profile_call(lambda: t.train(epochs=1, verbose=False), ms,
                                host_ops=10)
            numbers[fam] = dict(
                ms_per_epoch=ms, steps_per_s=steps / ms * 1e3,
                examples_per_s=n_tr / ms * 1e3, busy_ms=busy,
                sync_calls=sum(n_sync.values()), host_us=host, step=step,
                stage_seconds=t.stage_seconds,
                val_acc=t.val_accuracy_history[-1])
            log(f"[train] {fam}: {ms:.3f} ms per epoch ({steps} steps of "
                f"{t.train_dl.batch_size}, {n_tr} examples, validation "
                f"included), {steps / ms * 1e3:.1f} optimizer steps/s, "
                f"{n_tr / ms * 1e3:.1f} examples/s; host µs per step "
                f"{host['step']:.0f}, of which the optimizer's step "
                f"{host['optimizer']:.0f}, and {host['rest_ms']:.3f} ms an "
                f"epoch outside the steps (validation, the transfer); "
                f"synchronizing calls in a 1-epoch train() "
                f"{sum(n_sync.values())} {dict(n_sync)}, val acc "
                f"{t.val_accuracy_history[-1]:.4f} after "
                f"{t.epoch} epochs, on {card}")
            log(f"[train] {fam} step on its first batch: "
                f"{step['launches']:.1f} cudaLaunchKernel a step (with "
                f"library calls: {LIBRARY_STEP_LAUNCHES[fam]}), "
                f"{step['host_us']:.0f} µs "
                f"host a step over {TRAIN_STEPS} steps, "
                f"{step['device_ms']:.4f} ms device a step, on {card}")
        log(f"[train] numbers {json.dumps(numbers)}")

        # the checkpoints through the Transcriber
        paths = {fam: t.save(root=d / "ckpt" / fam, target_sr=SR)
                 for fam, t in (("mlp", mlp_t), ("cnn", cnn_t))}
        x_mlp = mlp_t.scaler.transform(mf)
        for w, t, x in ((0.0, mlp_t, x_mlp), (1.0, cnn_t, mel)):
            tr = Transcriber(mlp_ckpt=paths["mlp"], cnn_ckpt=paths["cnn"],
                             cnn_weight=w, cnn_dtype=torch.bfloat16,
                             device=device)
            got = tr.transcribe_clips(wavs)["labels"]
            want = [t.reverse_map[int(i)] for i in t.predict(x)]
            n_diff = sum(a != b for a, b in zip(got, want))
            log(f"[train] Transcriber(cnn_weight={w:g}) on the saved "
                f"checkpoints: {n_diff} of {len(want)} labels differ from "
                f"the {t.model_type} trainer's predict")
            if n_diff or len(got) != len(want):
                failures.append(f"[train] {t.model_type} checkpoint labels")
        for fam, shipped in (("mlp", CHECKPOINTS_ROOT / "mlp" /
                              "mlp_synth_v1.0.0.gtckpt.npz"),
                             ("cnn", CHECKPOINTS_ROOT / "cnn" /
                              "cnn_v1.0.0.gtckpt.npz")):
            with np.load(paths[fam]) as a, np.load(shipped) as b:
                shapes = [{k: z[k].shape for k in z.files if k != "__meta__"}
                          for z in (a, b)]
            same = shapes[0] == shapes[1]
            log(f"[train] {paths[fam].name}: {len(shapes[0])} arrays, keys "
                f"and shapes equal to the shipped file's {same}")
            if not same:
                failures.append(f"[train] {fam} checkpoint layout")


def api_phase(rows: list, clips_np: np.ndarray, midi: np.ndarray,
              failures: list, device: str = "cuda") -> None:
    """`[api]`: the public API this port adds over the main path, on the
    card: `pick_onsets_from_envelope` at the 64-riff shape (K5, outputs
    identical to `pick_onsets_plain`'s), the FeatureBuilder's three
    inference extractors at 1024 clips (K1-K3, against the CPU's at
    K1-K3's tolerances) and the lazy top-level names."""
    import torch
    import gat_tpu_torch
    from gat_tpu_torch import features
    from gat_tpu_torch.data.loader import AudioDatasetLoader
    from gat_tpu_torch.infer import Transcriber
    from gat_tpu_torch.ops import onset
    from gat_tpu_torch.ops.pitch import midi_to_note
    from gat_tpu_torch.utils.native_wav import write_wav_batch

    lazy = {n: getattr(gat_tpu_torch, n) for n in gat_tpu_torch._LAZY}
    ok = len(lazy) == 11 and lazy["Transcriber"] is Transcriber
    t = gat_tpu_torch.Transcriber(device=device)
    log(f"[api] gat_tpu_torch's {len(lazy)} lazy names resolve, "
        f"gat_tpu_torch.Transcriber is infer.Transcriber: {ok}")
    if not ok:
        failures.append("[api] lazy top-level names")

    y, nvf = file_inputs(device, N_RIFFS, RIFF_SECONDS)
    env = onset.onset_strength(y, FILE_SR, n_valid_frames=nvf)
    valid = torch.arange(env.shape[-1], device=env.device)[None] < nvf[:, None]
    got, launches, _ = driven(lambda: onset.pick_onsets_from_envelope(
        env, FILE_SR, 512, 0.3, 64, True, valid))
    ref = onset.pick_onsets_plain(env, FILE_SR, 512, 0.3, 64, True, nvf)
    same = all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(got, ref))
    one = onset.pick_onsets_from_envelope(env[0], FILE_SR, 512, 0.3, 64)
    same = same and all(torch.equal(a.cpu(), b[0].cpu())
                        for a, b in zip(one, ref))
    ok = same and launches[4] == 1
    log(f"[api] pick_onsets_from_envelope at {tuple(env.shape)}: launches "
        f"K1..K13, branch {launches}; outputs identical to pick_onsets_plain's "
        f"{same} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("[api] pick_onsets_from_envelope")

    fb, cpu_fb = t.feature_builder, features.FeatureBuilder(device="cpu")
    mfcc, mel, sc = t.mfcc_params, t.melspec_params, t.scaler
    clips = torch.from_numpy(clips_np).to(fb.device)
    with tempfile.TemporaryDirectory() as d:
        items = [(Path(d) / midi_to_note(int(m), unicode=False) / f"{i}.wav",
                  clip, SR) for i, (clip, m) in enumerate(zip(clips_np,
                                                              midi))]
        for path, _, _ in items:
            path.parent.mkdir(exist_ok=True)
        write_wav_batch(items)
        loaders = [AudioDatasetLoader([d], target_sr=SR, duration=0.5,
                                      device=dev) for dev in (device, "cpu")]
        calls = (("extract_inference_features", (loaders[0],),
                  (loaders[1],), False),
                 ("extract_inference_features_from_clips",
                  (clips, SR, mfcc, mel, sc), (clips_np, SR, mfcc, mel, sc),
                  True),
                 ("extract_inference_features_from_audio",
                  (clips[7], SR, mfcc, mel, sc), (clips_np[7], SR, mfcc, mel,
                                                  sc), True))
        for name, args, cpu_args, scaled in calls:
            (mf, ms), launches, _ = driven(
                lambda: getattr(fb, name)(*args))
            rmf, rms = getattr(cpu_fb, name)(*cpu_args)
            mf, ms, rmf, rms = (x.cpu().numpy() for x in (mf, ms, rmf, rms))
            if scaled:  # compare unscaled: the scale amplifies the error
                mf, rmf = (x * sc.scale_ + sc.mean_ for x in (mf, rmf))
            e_mfcc = float(np.abs(mf[:, :64] - rmf[:, :64]).max())
            e_pitch = float(np.abs(10.0 ** (mf[:, 64] - rmf[:, 64]) - 1).max())
            e_mel = float(np.abs(ms - rms)[rms > -60.0].max())
            ok = (launches[:3] == [1, 1, 1] and e_mfcc <= 1e-3
                  and e_pitch <= 2e-3 and e_mel <= 0.1
                  and np.isfinite(mf).all() and np.isfinite(ms).all())
            log(f"[api] {name}: {mf.shape} and {ms.shape}; launches K1..K13, branch "
                f"{launches}; vs the CPU: MFCC max abs err {e_mfcc:.3g} "
                f"(1e-3), pitch rel {e_pitch:.3g} (2e-3), mel {e_mel:.3g} dB "
                f"(0.1 where > -60 dB) -> {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"[api] {name}")


@functools.cache
def load_roofline():
    """`gat_tpu_torch/utils/roofline.py` of this script's checkout, loaded
    by path: the peaks, kernel symbols and cost formulas behind every
    bound and kernel device time here, also when another checkout's
    package is the one on sys.path (`tools/torch_onset_timing.py`)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_roofline", Path(__file__).resolve().parent
        / "gat_tpu_torch" / "utils" / "roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_tool(name: str):
    """tools/<name>.py as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, Path(__file__).resolve().parent / "tools" / f"{name}.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def write_eval_wavs(root: Path) -> Path:
    """The folder harness's input: SPN-named folders (A2, D3, G3) each
    with a riff of four plucks of its note at 22050 Hz, and a riff of A2
    D3 G3 B3 E4 at 44100 Hz in an unlabeled folder."""
    from gat_tpu_torch.ops.pitch import midi_to_note
    from gat_tpu_torch.utils.wavio import write_wav
    for i, m in enumerate(FILE_MIDI[:3]):
        folder = root / midi_to_note(m, unicode=False)
        folder.mkdir(parents=True)
        write_wav(folder / "riff.wav", make_riffs(
            np.full((1, 4), m), 3.5, FILE_SR, SEED + 10 + i, noise=0.0)[0],
            FILE_SR)
    (root / "mixed").mkdir()
    write_wav(root / "mixed" / "riff.wav", make_riffs(
        np.array([FILE_MIDI]), 3.9, 44100, SEED + 13, noise=0.0)[0], 44100)
    return root


def flipped_clips(card: dict, cpu: dict) -> list[tuple]:
    """(system, clip, top-2 margin on the card, on the CPU) of every clip
    whose label differs between the card and the CPU, for the systems
    whose labels come from the models' probabilities."""
    out = []
    for system, get in (("default", lambda r: r["probs"]),
                        ("mlp", lambda r: r["per_model_probs"]["mlp"]),
                        ("cnn", lambda r: r["per_model_probs"]["cnn"])):
        a, b = get(card["_result"]), get(cpu["_result"])
        for i in np.flatnonzero(a.argmax(1) != b.argmax(1)):
            margins = [float(np.diff(np.sort(p[i])[-2:])[0]) for p in (a, b)]
            out.append((system, int(i), *margins))
    return out


def same_wav_reports(got: dict, ref: dict) -> bool:
    """The folder harness's reports equal, per-clip confidences within
    1e-2 (the probs' bound)."""
    if {k: v for k, v in got.items() if k != "files"} != \
            {k: v for k, v in ref.items() if k != "files"}:
        return False
    for g, r in zip(got["files"], ref["files"], strict=True):
        if "error" in r or "error" in g:
            if g != r:
                return False
            continue
        strip = [[{k: v for k, v in c.items() if k != "confidence"}
                  for c in f["clips"]] for f in (g, r)]
        if strip[0] != strip[1] or any(
                abs(a["confidence"] - b["confidence"]) > 1e-2
                for a, b in zip(g["clips"], r["clips"])):
            return False
    return True


def eval_phase(rows: list, card: str, failures: list,
               device: str = "cuda") -> None:
    """`[eval]`: the note-accuracy harness, tools/torch_evaluate.py, with
    the shipped pair and the witness on the card and on the CPU: its
    `evaluate_set` on EVAL_SETS and its `evaluate_wav_dir` over
    SPN-named riff WAVs. Per-system correct counts equal between card and
    CPU (a label flipped by a near-tie passes only with a top-2 margin
    below 1e-3, printed), the folder reports equal, K1-K5 launched; each
    set's stages timed on the card, synthesis apart from the card's
    work."""
    from gat_tpu_torch.config import MLP_CONFIG
    from gat_tpu_torch.infer import Transcriber
    from gat_tpu_torch.utils.profiling import StageTimer
    tool = load_tool("torch_evaluate")
    witness = str(MLP_CONFIG.CHECKPOINTS_DIR / MLP_CONFIG.REFERENCE_CKPT_NAME)
    pairs = {dev: (Transcriber(device=dev),
                   Transcriber(mlp_ckpt=witness, use_cnn=False, device=dev))
             for dev in (device, "cpu")}
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        wav_dir = write_eval_wavs(d / "wavs")
        timers = {name: StageTimer() for name, _ in EVAL_SETS}

        def run(dev, timed):
            t, w = pairs[dev]
            sets = {name: tool.evaluate_set(
                t, d / dev / name, variants, EVAL_SEED, witness=w,
                timer=timers[name] if timed else None,
                **dict(tool.FULL_SUITE[name])) for name, variants in EVAL_SETS}
            return sets, tool.evaluate_wav_dir(t, wav_dir)

        (card_sets, card_wav), launches, wall = driven(
            lambda: run(device, True))
        record_launches(rows, "eval", launches)
        t0 = time.perf_counter()
        cpu_sets, cpu_wav = run("cpu", False)
        cpu_s = time.perf_counter() - t0
    synth_s = sum(tm.totals["synthesis"] for tm in timers.values())
    log(f"[eval] evaluate_set on {len(EVAL_SETS)} sets and evaluate_wav_dir "
        f"on {card_wav['n_files']} files: {wall:.2f} s on the card side, of "
        f"which synthesis {synth_s:.2f} s (host); CPU plain path {cpu_s:.1f} "
        f"s; launches K1..K13, branch {launches} on {card}")
    if not_launched(launches):
        failures.append(f"[eval] a kernel was not launched: {launches}")
    for name, _ in EVAL_SETS:
        got, ref = card_sets[name], cpu_sets[name]
        tm = timers[name]
        ms = {k: v * 1e3 for k, v in tm.totals.items()}
        same = got["_correct"] == ref["_correct"]
        flips = [] if same else flipped_clips(got, ref)
        explained = (bool(flips) and all(
            k in MODEL_SYSTEMS for k in got["_correct"]
            if got["_correct"][k] != ref["_correct"][k])
            and all(max(m_card, m_cpu) < 1e-3
                    for _, _, m_card, m_cpu in flips))
        ok = same or explained
        log(f"[eval] {name} ({got['n_clips']} clips): correct on the card "
            f"{got['_correct']}, equal to the CPU's {same}"
            + ("" if same else f" (CPU {ref['_correct']}; flipped clips "
               f"(system, clip, top-2 margin card, CPU) {flips})")
            + f"; accuracy default {got['default_accuracy']}, mlp "
            f"{got['mlp_accuracy']}, cnn {got['cnn_accuracy']}, yin "
            f"{got['yin_accuracy']}, witness {got['witness_accuracy']}; "
            f"synthesis {ms['synthesis']:.1f} ms, load {ms['load']:.1f} ms, "
            f"transcribe_clips {ms['transcribe_clips']:.3f} ms, yin "
            f"{ms['yin']:.3f} ms, witness {ms['witness']:.3f} ms, domain_z "
            f"{ms['domain_z']:.3f} ms -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"[eval] {name}: card and CPU correct counts")
    ok = same_wav_reports(card_wav, cpu_wav)
    log(f"[eval] evaluate_wav_dir: {card_wav['n_clips']} clips, folder "
        f"accuracy {card_wav.get('folder_label_accuracy')}, YIN agreement "
        f"{card_wav['yin_agreement']}; equal to the CPU's {ok} -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("[eval] evaluate_wav_dir: card and CPU reports")


def write_raw_recordings(root: Path) -> Path:
    """`String_<s>/Fret_<f>/take.wav` recordings at TOOLS_SR: for each
    (string, fret) a riff of five plucks of its note."""
    from gat_tpu_torch.ops.pitch import STANDARD_TUNING_MIDI
    from gat_tpu_torch.utils.wavio import write_wav
    for i, (string, fret) in enumerate(TOOLS_FRETS):
        folder = root / f"String_{string}" / f"Fret_{fret}"
        folder.mkdir(parents=True)
        midi = np.full((1, 5), STANDARD_TUNING_MIDI[string] + fret)
        write_wav(folder / "take.wav", make_riffs(
            midi, 4.5, TOOLS_SR, SEED + 20 + i, noise=0.001)[0], TOOLS_SR)
    return root


def same_wav_trees(card: Path, cpu: Path) -> tuple[bool, float, int]:
    """(the same relative file names, max abs sample difference, files
    whose bytes are identical) of two trees of WAVs."""
    from gat_tpu_torch.utils.wavio import read_wav
    names = sorted(p.relative_to(card) for p in card.rglob("*.wav"))
    if names != sorted(p.relative_to(cpu) for p in cpu.rglob("*.wav")):
        return False, float("inf"), 0
    err, same_bytes = 0.0, 0
    for name in names:
        a, b = read_wav(card / name)[0], read_wav(cpu / name)[0]
        err = max(err, float(np.abs(a - b).max()) if a.size else 0.0)
        same_bytes += (card / name).read_bytes() == (cpu / name).read_bytes()
    return True, err, same_bytes


def same_features(kind: str, x, ref) -> tuple[bool, str]:
    """(within bounds, what was held) for a feature matrix of the card
    against the CPU's, element by element: the MLP's 64 MFCCs within 1e-3
    and its pitch column (log10 Hz) within 2e-3 relative, the CNN's mel
    images within 0.1 dB where the CPU's read above -60 dB."""
    if x.shape != ref.shape or not np.isfinite(x).all():
        return False, f"shape {x.shape} against {ref.shape} or not finite"
    if kind == "mlp":
        e_mfcc = float(np.abs(x[:, :64] - ref[:, :64]).max())
        e_pitch = float(np.abs(10.0 ** (x[:, 64] - ref[:, 64]) - 1).max())
        return (e_mfcc <= 1e-3 and e_pitch <= 2e-3,
                f"MFCC max abs err {e_mfcc:.3g} (1e-3), pitch max rel err "
                f"{e_pitch:.3g} (2e-3)")
    e_mel = float(np.abs(x - ref)[ref > -60.0].max())
    return e_mel <= 0.1, f"mel max abs err {e_mel:.3g} dB (0.1 where > -60 dB)"


def tools_phase(rows: list, card: str, failures: list,
                device: str = "cuda") -> None:
    """`[tools]`: the twins of the JAX package's tools on the card:
    `torch_inspect_ckpt` on the five shipped checkpoints;
    `torch_dataset_creator slice-all` on `String_<s>/Fret_<f>` riffs at
    44100 Hz and `torch_eda dataset`, `slices` and `features` on a
    synthesized set, each against the CPU (onsets and names equal,
    samples within 1e-5, the feature matrix element by element within
    `same_features`' bounds, the report's numbers within 1e-3);
    `torch_cross_family_eval` at a smoke size, and its raw features of
    the fm evaluation set (K1 for the CNN, K2 and K3 for the MLP) against
    the CPU's as eda's; `torch_train_wall` at TRAIN_VARIANTS;
    `torch_profile_trace` on the clip batch and the serving wave (its
    top table must name every kernel launched); `torch_roofline_files`
    on the serving wave (no stage below its floor). Each tool's launches
    are counted; their sum is the `tools` path's."""
    from gat_tpu_torch.config import CNN_CONFIG, MLP_CONFIG
    from gat_tpu_torch.data.synth import synthesize_note_dataset
    from gat_tpu_torch.ops.pitch import string_fret_to_note
    from gat_tpu_torch.utils.reports import feature_report
    tool = {name: load_tool(f"torch_{name}") for name in (
        "inspect_ckpt", "dataset_creator", "eda", "cross_family_eval",
        "train_wall", "profile_trace", "roofline_files")}
    total = [0] * (BRANCH + 1)

    def run(what, fn, need=()):
        """fn() driven; fails unless each kernel index in `need`
        launched."""
        out, launches, wall = driven(fn)
        for i, n in enumerate(launches):
            total[i] += n
        ok = all(launches[i] >= 1 for i in need)
        log(f"[tools] {what}: {wall:.2f} s, launches K1..K13, branch {launches}"
            + ("" if ok else " -> FAIL (a kernel was not launched)"))
        if not ok:
            failures.append(f"[tools] {what}: launches {launches}")
        return out

    # inspect: host only
    ckpts = sorted(MLP_CONFIG.CHECKPOINTS_DIR.glob("*.gtckpt.npz")) + sorted(
        CNN_CONFIG.CHECKPOINTS_DIR.glob("*.gtckpt.npz"))
    infos = {p.name: tool["inspect_ckpt"].summarize(p, histories=h)
             for h in (False, True) for p in ckpts}
    for name, info in infos.items():
        log(f"[tools] inspect {name}: {info['n_params']} params, "
            f"{info['num_classes']} classes, epoch {info['epoch']}, "
            f"opt state {info['has_opt_state']}, scaler "
            f"{info['has_scaler']}")
    ok = (len(ckpts) == 5
          and infos["mlp_synth_v1.0.0.gtckpt.npz"]["n_params"] == 20143
          and infos["mlp_v1.0.0.gtckpt.npz"]["epoch"] == 7)
    if not ok:
        failures.append("[tools] inspect_ckpt")

    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        raw = write_raw_recordings(d / "raw")
        creator = tool["dataset_creator"]
        totals = {dev: run(f"dataset_creator slice-all ({dev})",
                           lambda dev=dev: creator.slice_all_clips(
                               raw, d / f"clips_{dev}", device=dev),
                           need=(K4, K5, K7, K8) if dev == device else ())
                  for dev in (device, "cpu")}
        same, err, same_bytes = same_wav_trees(d / f"clips_{device}",
                                               d / "clips_cpu")
        n_clips = len(list((d / "clips_cpu").rglob("*.wav")))
        ok = same and totals[device] == totals["cpu"] and err <= 1e-5
        log(f"[tools] slice-all of {len(TOOLS_FRETS)} recordings at "
            f"{TOOLS_SR} Hz: {totals[device]} onsets, {n_clips} clips; "
            f"names equal to the CPU's {same}, max sample err {err:.3g} "
            f"(1e-5), byte-identical files {same_bytes} of {n_clips} -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append("[tools] dataset_creator slice-all")
        creator.create_pitch_dataset(d / f"clips_{device}", d / "pitch")
        counts = creator.count_clips(d / "pitch")
        expect = sorted(string_fret_to_note(s, f) for s, f in TOOLS_FRETS)
        if sorted(counts) != expect or sum(counts.values()) != n_clips:
            failures.append(f"[tools] pitch-dataset folders {counts}")

        eda = tool["eda"]
        ds = synthesize_note_dataset(d / "eda", variants_per_class=4,
                                     seed=SEED, verbose=False)
        got = {dev: run(f"eda dataset ({dev})",
                        lambda dev=dev: eda.dataset_analysis(ds, device=dev))
               for dev in (device, "cpu")}
        ok = (got[device]["counts"] == got["cpu"]["counts"]
              and got[device]["report"] == got["cpu"]["report"]
              and got[device]["stats"] == got["cpu"]["stats"])
        log(f"[tools] eda dataset: {sum(got['cpu']['counts'].values())} "
            f"WAVs, counts, report and per-WAV stats equal to the CPU's "
            f"{ok}")
        if not ok:
            failures.append("[tools] eda dataset")
        wav = next(raw.rglob("*.wav"))
        got = {dev: run(f"eda slices ({dev})",
                        lambda dev=dev: eda.slice_analysis(wav, device=dev),
                        need=(K4, K5, K7, K8) if dev == device else ())
               for dev in (device, "cpu")}
        ok = ([c["clip"] for c in got[device]]
              == [c["clip"] for c in got["cpu"]]
              and all(abs(a[k] - b[k]) <= 1e-5 for a, b in
                      zip(got[device], got["cpu"]) for k in ("rms", "peak")))
        log(f"[tools] eda slices: {len(got['cpu'])} clips, names equal and "
            f"rms/peak within 1e-5 of the CPU's {ok}")
        if not ok:
            failures.append("[tools] eda slices")
        mats = {dev: run(f"eda features ({dev})",
                         lambda dev=dev: eda.feature_matrix(ds, device=dev),
                         need=(1, 2) if dev == device else ())
                for dev in (device, "cpu")}
        (x, y, rmap), (x_ref, y_ref, rmap_ref) = mats[device], mats["cpu"]
        ok_x, errs = same_features("mlp", x, x_ref)
        a, b = (feature_report(*mats[dev]) for dev in (device, "cpu"))
        keys = ("X_min", "X_max", "X_mean", "X_std")
        err = max(abs(a[k] - b[k]) for k in keys)
        ok = (ok_x and np.array_equal(y, y_ref) and rmap == rmap_ref
              and err <= 1e-3
              and all(a[k] == b[k] for k in a if k not in keys))
        log(f"[tools] eda features: X {x.shape} against the CPU's element "
            f"by element: {errs}; labels and classes equal; report numbers "
            f"within {err:.3g} (1e-3), the rest equal -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append("[tools] eda features")

    rep = run("cross_family_eval", lambda: tool["cross_family_eval"].main(
        ["--variants", str(CROSS_VARIANTS), "--eval_variants", "2",
         "--epochs", "2", "--device", device]), need=(0, 1, 2))
    accs = [v for r in rep["results"].values() for v in r.values()]
    ok = (set(rep) == {"variants", "epochs", "eval_seed", "results",
                       "wall_s"}
          and set(rep["results"]) == {f"{m}_trained_on_{f}"
                                      for m in ("cnn", "mlp")
                                      for f in ("ks", "additive")}
          and all(set(r) == {"ks", "additive", "fm"}
                  for r in rep["results"].values())
          and all(np.isfinite(accs)) and all(0.0 <= x <= 1.0 for x in accs))
    log(f"[tools] cross_family_eval at {CROSS_VARIANTS} variants, 2 epochs: "
        f"{rep['results']}; schema and finite accuracies {ok}")
    if not ok:
        failures.append("[tools] cross_family_eval report")
    cross = tool["cross_family_eval"]
    with tempfile.TemporaryDirectory() as d:
        fm = synthesize_note_dataset(Path(d) / "eval_fm", family="fm",
                                     variants_per_class=2, seed=EVAL_SEED,
                                     verbose=False)
        for kind, need in (("mlp", (1, 2)), ("cnn", (0,))):
            raws = {dev: run(f"cross_family_eval {kind} features of the fm "
                             f"evaluation set ({dev})",
                             lambda dev=dev: cross.raw_features(
                                 kind, fm, SR, dev),
                             need=need if dev == device else ())
                    for dev in (device, "cpu")}
            (x, y, rmap), (x_ref, y_ref, rmap_ref) = raws[device], raws["cpu"]
            ok_x, errs = same_features(kind, x, x_ref)
            ok = ok_x and np.array_equal(y, y_ref) and rmap == rmap_ref
            log(f"[tools] cross_family_eval {kind} features of fm: X "
                f"{x.shape} against the CPU's element by element: {errs}; "
                f"labels and classes equal -> {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"[tools] cross_family_eval {kind} features")

    wall = run(f"train_wall at {TRAIN_VARIANTS} variants",
               lambda: tool["train_wall"].run(variants=TRAIN_VARIANTS,
                                              device=device),
               need=(0, 1, 2))
    ok = all(np.isfinite(wall[k]) for k in ("cnn_val_acc", "mlp_val_acc"))
    log(f"[tools] train_wall: synth {wall['synth_s']:.2f} s, cnn "
        f"{wall['cnn_s']:.2f} s ({wall['cnn_epochs']} epochs, val acc "
        f"{wall['cnn_val_acc']:.4f}), mlp {wall['mlp_s']:.2f} s "
        f"({wall['mlp_epochs']} epochs, val acc {wall['mlp_val_acc']:.4f}),"
        f" total {wall['total_s']:.2f} s on {card}")
    if not ok:
        failures.append("[tools] train_wall")

    roofline = load_roofline()
    KERNEL_SYMBOLS, device_function = (roofline.KERNEL_SYMBOLS,
                                       roofline.device_function)
    prof = tool["profile_trace"]
    for graph, need in (("clip", (K1, K2, K3)), ("files", SEGMENTING)):
        with tempfile.TemporaryDirectory() as d:
            fn, pool = prof.trace_inputs(graph, N_CLIPS, 60.0, 4, 384, 1,
                                         112, 448, device)
            run(f"profile_trace {graph}",
                lambda: prof.trace(fn, pool, 8, d), need=need)
            (_, top, shares), = prof.parse_trace(d, PROFILE_TOP)
        names = {device_function(name) for name, _ in top}
        missing = [k for i, k in enumerate(KERNEL_SYMBOLS) if i in need
                   and not names & set(KERNEL_SYMBOLS[k])]
        log(f"[tools] profile_trace {graph}: the port's kernels' device us "
            f"over 8 calls {({k: round(v, 1) for k, v in shares.items()})}; "
            f"launched kernels missing from the top {PROFILE_TOP}: "
            f"{missing} -> {'ok' if not missing else 'FAIL'}")
        if missing:
            failures.append(f"[tools] profile_trace {graph}: {missing}")

    roof = tool["roofline_files"]
    out = run("roofline_files", lambda: roof.report(roof.parse_args(
        ["--device", device])), need=SEGMENTING)
    record_launches(rows, "tools", total)
    m = out["measured"]
    if m is None:
        failures.append("[tools] roofline: the wave was not measured")
        return
    log(f"[tools] roofline {out['program']}: wave {m['wave_ms']:.4f} ms "
        f"(events), floor {out['wave']['floor_ms']:.5f} ms "
        f"({out['wave']['bound_by']}), roofline share "
        f"{m['roofline_share']:.4f}, mfu {m['mfu']:.4f}, device busy "
        f"{m['device_busy_ms']:.4f} ms; clip step at "
        f"{out['clip_step']['batch']}: {out['clip_step']['measured_ms']:.4f}"
        f" ms, floor {out['clip_step']['floor_ms']:.5f} ms on {card}")
    sorts = m["sort_kernels"]
    staged = m["stage_kernels"].get("compaction", [])
    log(f"[tools] roofline: the compaction stage's kernels "
        f"{sorted({device_function(n) for n in staged})}; sort kernels in "
        f"the wave {sorts} -> {'ok' if not sorts else 'FAIL'}")
    if sorts:
        failures.append(f"[tools] roofline: sort kernels in the wave {sorts}")
    for name, r in out["stages"].items():
        log(f"[tools] roofline stage {name}: measured {r['measured_ms']:.4f}"
            f" ms ({r['share']:.1%} of device time), floor "
            f"{r['floor_ms']:.5f} ms ({r['bound_by']}; {r['flops']:.4g} "
            f"flops, {r['bytes']:.4g} bytes)")


PARALLEL_EPOCHS = 2


def k4_entry_envelope(onset, y):
    """`gat_onset_envelope` called as `onset.onset_strength` calls it, with
    a dB scratch of our own: (env, pre-clamp dB (B, T, 128), peak keys)."""
    import torch
    from gat_tpu_torch import features, kernels
    dev = y.device
    b, n = y.shape
    t = 1 + n // 512
    env = torch.empty((b, t), device=dev)
    db = torch.empty((b, t, 128), device=dev)
    peak = torch.full((b,), onset._NEG_INF_KEY, dtype=torch.int32,
                      device=dev)
    hann, tw, *_ = features._kernel_tables(FILE_SR, 128, False, dev)
    tab, weights, n_items = onset._mel_items(FILE_SR, 128, dev)
    grid = onset._envelope_grid(dev, n_items, 512)
    fn = kernels.function("onset_envelope", "gat_onset_envelope",
                          onset._ENVELOPE_ARGS)
    kernels.check(fn(y.data_ptr(), env.data_ptr(), db.data_ptr(),
                     peak.data_ptr(), hann.data_ptr(), tw.data_ptr(),
                     tab.data_ptr(), weights.data_ptr(), weights.numel(),
                     n_items, None, b, n, 512, t, 128, 1, 1 + 2048 // 1024,
                     80.0, grid, kernels.stream(dev)), "onset_envelope")
    return env, db, peak


def shard_inputs(y: np.ndarray, d: int, dev) -> list:
    """One file cut over d ranks as the time-sharded envelope cuts it
    (`parallel.timeshard.TimeShards`): [(shard (1, owned + halo), frames,
    real frames)] on the card."""
    import torch
    from gat_tpu_torch.parallel.timeshard import TimeShards
    cut = TimeShards(len(y), d)
    yt = torch.from_numpy(np.asarray(y, np.float32)).to(dev)
    return [(cut.shard(yt, r)[None].contiguous(), cut.frames,
             torch.tensor([cut.real(r)], dtype=torch.int32, device=dev))
            for r in range(d)]


def parallel_phase(rows: list, card: str, failures: list,
                   clips_np: np.ndarray) -> None:
    """`[parallel]`: the multi-device path at world 1 on NCCL (module
    docstring, phase 16). Appends the kernels-line rows of K4's two
    passes and records `launches_by_path["parallel"]` for all seven."""
    import datetime
    import os

    import torch
    import torch.distributed as dist
    from gat_tpu_torch.entry import dryrun_multichip, entry
    from gat_tpu_torch.infer import Transcriber
    from gat_tpu_torch.ops import onset
    from gat_tpu_torch.parallel import make_mesh, make_sharded_transcribe
    from gat_tpu_torch.parallel.timeshard import detect_onsets_timesharded
    roofline = load_roofline()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    d = tempfile.mkdtemp()
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(d, "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_mesh(1)
        log(f"[parallel] NCCL world {dist.get_world_size()} "
            f"({dist.get_backend()}), mesh {tuple(mesh.shape)} "
            f"{mesh.mesh_dim_names} on {mesh.device_type}")

        # K4's two passes alone, and the 4-shard stitch, on the 400 s riff
        spacing = 2.5
        k = len(np.arange(0.4, LONG_SECONDS - 0.45, spacing))
        ylong = make_riffs(np.resize(FILE_MIDI, k)[None], LONG_SECONDS,
                           FILE_SR, SEED + 3, noise=0.0, spacing=spacing)[0]
        whole = torch.from_numpy(ylong)[None].to(dev)
        t = 1 + len(ylong) // 512
        env_ref, db_ref, key_ref = k4_entry_envelope(onset, whole)
        parts = [onset.onset_mel_db(ext, FILE_SR, origin=0, frames=fr,
                                    n_valid_frames=nv)
                 for ext, fr, nv in shard_inputs(ylong, 4, dev)]
        db_st = torch.cat([p[0] for p in parts], dim=1)[:, :t].contiguous()
        key_st = torch.stack([p[1] for p in parts]).amax(0)
        env_st = onset.onset_flux(db_st, key_st)
        torch.cuda.synchronize()
        e_db = float((db_st - db_ref).abs().max())
        e_env = float((env_st - env_ref).abs().max())
        ok = (e_db <= 1e-3 and e_env <= 1e-3
              and torch.equal(key_st, key_ref))
        log(f"[parallel] 4-shard stitch of the {LONG_SECONDS:g} s riff ({t} "
            f"frames, shards of {parts[0][0].shape[1]}): gat_onset_mel_db "
            f"(origin 0) stitched vs gat_onset_envelope's dB max abs err "
            f"{e_db:.3g}, peak keys equal {torch.equal(key_st, key_ref)}; "
            f"gat_onset_flux vs its envelope {e_env:.3g} (1e-3) -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append("[parallel] the 4-shard stitch")

        # each pass against its plain version at the path's shape (one
        # shard of the whole file at world 1), and timed
        ext = shard_inputs(ylong, 1, dev)[0]
        pool = noisy_pool(ext[0], SEED + 20, 0.001)

        def mel_db(x):
            return onset.onset_mel_db(x, FILE_SR, origin=0, frames=t,
                                      n_valid_frames=ext[2])

        def mel_db_plain(x):
            return onset.onset_mel_db_plain(x, FILE_SR, origin=0, frames=t,
                                            n_valid_frames=ext[2])
        (db, key), (db_p, key_p) = mel_db(ext[0]), mel_db_plain(ext[0])
        loud = db_p > -60.0
        err_db = float((db - db_p)[loud].abs().max())
        err_key = abs(float(onset.key_value(key)[0])
                      - float(onset.key_value(key_p)[0]))
        ok_db = (err_db <= 0.1 and err_key <= 1e-3
                 and bool(torch.isfinite(db).all()))
        db_pool = [mel_db_plain(x)[0] for x in pool]
        key_pool = [onset.order_key(x.amax(dim=(1, 2))) for x in db_pool]
        flux_in = list(zip(db_pool, key_pool))
        env_k = onset.onset_flux(*flux_in[0])
        env_p = onset.onset_flux_plain(*flux_in[0])
        err_env = float((env_k - env_p).abs().max())
        ok_env = err_env <= 1e-4
        torch.cuda.synchronize()
        costs = {"onset_mel_db": roofline.mel_db_cost(
                     1, ext[0].shape[1], t, FILE_SR, dev),
                 "onset_flux": roofline.flux_cost(1, t)}
        times = {"onset_mel_db": (time_ms(lambda x: mel_db(x), pool, 10),
                                  time_ms(lambda x: mel_db_plain(x), pool,
                                          10)),
                 "onset_flux": (time_ms(lambda a: onset.onset_flux(*a),
                                        flux_in, 10),
                                time_ms(lambda a: onset.onset_flux_plain(*a),
                                        flux_in, 10))}
        new_rows = []
        for name, err, ok_k, tol, replaces in (
                ("onset_mel_db", err_db, ok_db,
                 "atol 0.1 dB where the plain dB > -60 (the mel bound of "
                 "the front-ends), peak 1e-3 dB",
                 "gat_tpu/parallel/timeshard.py:34"),
                ("onset_flux", err_env, ok_env,
                 "atol 1e-4 (the same dB rows; a band mean in another "
                 "order)", "gat_tpu/parallel/timeshard.py:103")):
            bound_ms, bound_by = roofline.bound(*costs[name])
            ms, plain_ms = times[name]
            log(f"[time] {name} (K4 pass {1 if name == 'onset_mel_db' else 2}"
                f" alone) at 1 x {t} frames: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
                f"max abs err {err:.3g} ({tol}) -> "
                f"{'ok' if ok_k else 'FAIL'} on {card}")
            if not ok_k:
                failures.append(f"[parallel] {name} vs its plain version")
            new_rows.append(dict(
                name=name, route="cuda",
                source="gat_tpu_torch/csrc/onset_envelope.cu",
                replaces=replaces, launches=0, max_abs_err=err,
                tolerance=tol, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None,
                shapes=[dict(files=1, frames=t)]))

        # the path, driven: every count at 0 before, read after
        clips = torch.from_numpy(clips_np).to(dev)
        t_single = Transcriber(device="cuda")
        run = make_sharded_transcribe(t_single.predictor, t_single.scaler,
                                      mesh, t_single.ckpt_sr,
                                      t_single.mfcc_params,
                                      t_single.melspec_params)
        step, _ = entry(batch=32, device="cuda")
        tm = Transcriber(mesh=mesh)
        with tempfile.TemporaryDirectory() as fd:
            groups, silent, _ = write_files_set(Path(fd))
            paths = [p for g in groups for p, _ in g] + [silent]
            ref_files = t_single.transcribe_files(paths)
            tm.transcribe_files(paths)  # first call at these shapes
            run(clips)
            detect_onsets_timesharded(ylong, mesh, sr=FILE_SR)
            wrappers = kernel_wrappers() + [onset.onset_mel_db,
                                            onset.onset_flux]
            n_k = BRANCH + 1
            torch.cuda.synchronize()
            for w in wrappers:
                w.launches = 0
            (probs, pitch) = run(clips)
            got_files = tm.transcribe_files(paths)
            o_sp, v_sp, *_ = detect_onsets_timesharded(ylong, mesh,
                                                       sr=FILE_SR)
            torch.cuda.synchronize()
            launches = [w.launches for w in wrappers]
        record_launches(rows, "parallel", launches[:n_k])
        for row, n in zip(new_rows, launches[n_k:]):
            row["launches"] = n
            row["launches_by_path"] = {"parallel": n}
        rows += new_rows
        log(f"[parallel] launches K1..K13 and compactions "
            f"{launches[:n_k]}, onset_mel_db "
            f"{launches[n_k]}, onset_flux {launches[n_k + 1]}")
        if not_launched(launches) or min(launches[n_k:]) < 1:
            failures.append(f"[parallel] a kernel was not launched: "
                            f"{launches}")

        probs_1, pitch_1 = step(clips)
        e_p = float((probs - probs_1).abs().max())
        e_h = float(((pitch - pitch_1).abs() / pitch_1).max())
        ok = e_p <= 1e-5 and e_h <= 1e-5
        log(f"[parallel] make_sharded_transcribe({N_CLIPS}) vs the entry "
            f"step: probs max abs err {e_p:.3g}, pitch max rel err "
            f"{e_h:.3g} (1e-5) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append("[parallel] sharded clips differ from entry")
        pool_c = noisy_pool(clips, SEED + 30, 0.01)
        for name, fn in (("make_sharded_transcribe (world 1)", run),
                         ("entry step (single device)", step)):
            reps = 10
            fn(pool_c[0])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(reps):
                fn(pool_c[i % POOL])
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / reps
            log(f"[parallel] {name} on {N_CLIPS} clips: {dt * 1e3:.3f} "
                f"ms/call, {N_CLIPS / dt:.1f} clips/s on {card}")

        same = all(
            g["labels"] == r["labels"] and g["onsets_s"] == r["onsets_s"]
            and g["times"] == r["times"]
            and g["onset_overflow"] == r["onset_overflow"]
            for g, r in zip(got_files, ref_files))
        conf = max((float(np.abs(np.asarray(g["confidences"])
                                 - np.asarray(r["confidences"])).max())
                    for g, r in zip(got_files, ref_files)
                    if len(r["labels"])), default=0.0)
        log(f"[parallel] Transcriber(mesh=).transcribe_files on the "
            f"{len(paths)} files of [files]: labels, onsets, times and flags "
            f"equal to the single-device call {same} (max confidence diff "
            f"{conf:.3g})")
        if not same or len(got_files) != len(ref_files):
            failures.append("[parallel] Transcriber(mesh=) files differ")
        o_1, v_1, *_ = onset.detect_onsets(whole, sr=FILE_SR,
                                           max_onsets=256)
        got_o, ref_o = o_sp[v_sp].cpu(), o_1[0][v_1[0]].cpu()
        ok = torch.equal(got_o, ref_o)
        log(f"[parallel] detect_onsets_timesharded({LONG_SECONDS:g} s): "
            f"{len(got_o)} onsets, equal to detect_onsets' {len(ref_o)}: "
            f"{ok}")
        if not ok:
            failures.append("[parallel] time-sharded onsets differ")

        parallel_train(mesh, failures)
        line = dryrun_multichip(1)
        if "ok on 1 devices" not in line:
            failures.append("[parallel] dryrun_multichip(1)")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(d, ignore_errors=True)
    torch.cuda.synchronize()


def log_against_k2_k3(k6: dict, rows: list) -> None:
    """Logs K6's kernels-line times beside the sum of K2's and K3's rows
    in `rows`, which this run timed on the same clips."""
    k2_k3 = [r for r in rows if r["name"] in ("mfcc_frontend", "yin_pitch")
             and r.get("ms") is not None]
    if len(k2_k3) != 2:
        log("[shared] K2 + K3: not timed in this run")
        return
    ms = sum(r["ms"] for r in k2_k3)
    dev = [r.get("device_ms") for r in k2_k3]
    dev_ms = None if None in dev else sum(dev)
    log(f"[shared] K6 {k6['ms']:.4f} ms (device {fmt_ms(k6['device_ms'])}) "
        f"against K2 + K3 {ms:.4f} ms (device {fmt_ms(dev_ms)}) in this run:"
        f" K6 / (K2 + K3) {k6['ms'] / ms:.3f}")


def shared_phase(rows: list, card: str, failures: list,
                 clips_np: np.ndarray, device: str = "cuda") -> None:
    """`[shared]`: the matmul route's shared MFCC and YIN front-end, K6
    (module docstring, phase 13). Appends K6's kernels-line row and
    records `launches_by_path["shared"]` for K1-K6."""
    import torch
    from gat_tpu_torch import features, kernels
    from gat_tpu_torch.infer import Transcriber
    from gat_tpu_torch.ops import spectral, yin
    from gat_tpu_torch.utils.wavio import write_wav
    clips = torch.from_numpy(clips_np).to(torch.device(device))
    n, length = clips.shape
    t = Transcriber(device=device)
    try:
        with tempfile.TemporaryDirectory() as d:
            riff = Path(d) / "riff.wav"
            write_wav(riff, make_riffs(np.array([FILE_MIDI]), 3.9, FILE_SR,
                                       SEED + 2, noise=0.0)[0], FILE_SR)
            groups, silent, _ = write_files_set(Path(d))
            paths = [p for g in groups for p, _ in g] + [silent]

            def path_results():
                return ([t.transcribe(riff, fused=f) for f in (False, True)],
                        t.transcribe_files(paths))

            # the FFT route's results and its K2 + K3 features first
            fft_clips = t.transcribe_clips(clips)
            fft_riff, fft_files = path_results()
            fft_feats = {}
            for norm, pon in SHARED_FLAGS:
                hz = yin.yin_pitch(features.normalize_volume(clips)
                                   if norm and pon else clips, SR)
                fft_feats[norm, pon] = torch.cat(
                    [features.mfcc_frontend(clips, SR, 64, norm),
                     torch.log10(hz)[:, None]], dim=1)

            spectral.set_stft_backend("matmul")
            # K6 against the plain shared front-end, and timed
            k6 = time_clip_kernels(features, yin, clips, failures,
                                   ("mfcc_pitch_frontend",))[0]
            log_against_k2_k3(k6, rows)
            for norm, pon in SHARED_FLAGS:
                got, _ = features.mfcc_pitch_features(clips, SR, 64, norm,
                                                      pon)
                e_route = float((got - fft_feats[norm, pon]).abs().max())
                ok = e_route <= 5e-3
                log(f"[shared] K6 normalize={norm} pitch_on_normalized="
                    f"{pon}: vs the FFT route's K2 + K3 max abs err "
                    f"{e_route:.3g} (5e-3) -> {'ok' if ok else 'FAIL'}")
                if not ok:
                    failures.append(f"[shared] K6 flags {norm}/{pon}")

            # the clip path, driven: every count at 0 before, read after
            wrappers = kernel_wrappers()
            t.transcribe_clips(clips)
            torch.cuda.synchronize()
            for w in wrappers:
                w.launches = 0
            res = t.transcribe_clips(clips)
            torch.cuda.synchronize()
            launches = [w.launches for w in wrappers]
            shared_launches = launches
            err = float(np.abs(res["probs"] - fft_clips["probs"]).max())
            same = res["labels"] == fft_clips["labels"] and err <= 1e-2
            ok = (same and launches[:K4] == [1, 0, 0]
                  and launches[K6] == 1)
            log(f"[shared] transcribe_clips({n}) on the shared route: "
                f"launches K1..K13, branch {launches}; labels "
                f"equal to the FFT route's {res['labels'] == fft_clips['labels']}"
                f", max prob diff {err:.3g} (1e-2) -> "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append("[shared] transcribe_clips")

            got_riff, got_files = path_results()
            same = all(same_result(g, r)[0]
                       for g, r in zip(got_riff + got_files,
                                       fft_riff + fft_files))
            log(f"[shared] transcribe (3.9 s riff, two-stage and fused) and "
                f"transcribe_files ({len(paths)} files) on the matmul route: "
                f"labels, onsets and times equal to the FFT route's {same}; "
                f"riff labels {got_riff[0]['labels']}")
            if not same or len(got_files) != len(fft_files):
                failures.append("[shared] file paths differ from the FFT "
                                "route")

            # bfloat16 operands: the wrapper hands K6 the clips rounded to
            # bfloat16, so its result is K6's of the rounded clips bit for
            # bit, and the fp32 plain front-end's of them at fp32's bounds
            spectral.set_matmul_dtype(torch.bfloat16)
            xr = clips.to(torch.bfloat16).float()
            for norm, pon in SHARED_FLAGS:
                got16, hz16 = features.mfcc_pitch_features(clips, SR, 64,
                                                           norm, pon)
                same, same_hz = features.mfcc_pitch_features(
                    xr, SR, 64, norm, pon, bf16=False)
                ref, ref_hz = features.mfcc_pitch_features_plain(
                    xr, SR, 64, norm, pon, bf16=False)
                bitwise = (torch.equal(got16, same)
                           and torch.equal(hz16, same_hz))
                d = (got16[:, :64] - ref[:, :64]).abs()
                n_over = int(((hz16 / ref_hz - 1).abs() > 2e-3).sum())
                ok = (bitwise and n_over == 0
                      and bool((d <= 1e-3 + 2e-6 * ref[:, :64].abs()).all()))
                log(f"[shared] bfloat16 operands, normalize={norm} "
                    f"pitch_on_normalized={pon}: K6 equal to K6 of the "
                    f"clips rounded to bfloat16 {bitwise}; vs the float32 "
                    f"plain front-end of them MFCC max abs err "
                    f"{float(d.max()):.3g} (atol 1e-3, rtol 2e-6), clips over "
                    f"pitch rtol 2e-3: {n_over} -> {'ok' if ok else 'FAIL'}")
                if not ok:
                    failures.append(f"[shared] K6 at bfloat16 flags "
                                    f"{norm}/{pon}")
            spectral.set_matmul_dtype(torch.float32)

        max_p = yin.yin_periods(SR, 50.0, 1000.0, 2048, 1024)[1]
        blocks = ctypes.c_int(0)
        args = (length, 512, spectral.n_frames(length, 2048, 512), 128,
                1024, max_p)
        kernels.check(kernels.function(
            "mfcc_pitch_frontend", "gat_mfcc_pitch_frontend_blocks_per_sm",
            [ctypes.c_int] * len(args) + [ctypes.c_void_p])(
                *args, ctypes.addressof(blocks)), "mfcc_pitch_frontend")
        ok = blocks.value >= K6_BLOCKS_PER_SM
        log(f"[occupancy] mfcc_pitch_frontend_kernel: {blocks.value} "
            f"resident blocks of 256 threads per SM at {n} x {length} on "
            f"{card} (at least {K6_BLOCKS_PER_SM}) -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"[occupancy] K6 at {blocks.value} blocks per SM")
        rows.append(dict(k6, launches=shared_launches[K6],
                         blocks_per_sm=blocks.value))
        record_launches(rows, "shared", shared_launches)
    finally:
        spectral.set_stft_backend("auto")
        spectral.set_matmul_dtype(torch.float32)
    torch.cuda.synchronize()


def parallel_train(mesh, failures: list) -> None:
    """`TrainingManager(mesh=)` against the single-device manager:
    PARALLEL_EPOCHS epochs of each family at the shipped widths (the MLP
    fp32, the CNN bf16) on TRAIN_VARIANTS variants per class, the same
    seed. Bounds: the MLP's histories rtol 1e-4, accuracies equal and
    parameters atol 1e-4; the bf16 CNN's histories rtol 5e-3 and
    parameters atol 2e-2 but the conv biases ahead of BatchNorm (true
    gradient 0, Adam's ±lr steps), as tests/test_torch_train.py bounds
    the bf16 CNN (its accuracies are printed, not held: a bf16 near-tie
    may flip a clip). The mesh's training, counted as `driven` counts a
    path, must launch K11 and K12's two passes, and the CNN's K13's four
    kernels."""
    from gat_tpu_torch.data.synth import synthesize_note_dataset
    from gat_tpu_torch.train import TrainingManager
    with tempfile.TemporaryDirectory() as d:
        ds = Path(d) / "synthetic" / "recipe"
        synthesize_note_dataset(ds, variants_per_class=TRAIN_VARIANTS,
                                seed=42, verbose=False,
                                noise_snr_db=(8.0, 40.0), family="all3",
                                stressor="mix", stressor_prob=0.5,
                                channel="mix", channel_prob=0.25)
        single = TrainingManager(target_sr=SR, device="cuda")
        meshed = TrainingManager(target_sr=SR, mesh=mesh)
        for family, rtol, atol in (("mlp", 1e-4, 1e-4),
                                   ("cnn", 5e-3, 2e-2)):
            a, (b, launches, _) = (getattr(single, f"train_{family}")(
                dataset=ds, epochs=PARALLEL_EPOCHS, save=False,
                verbose=False), driven(lambda: getattr(
                    meshed, f"train_{family}")(
                        dataset=ds, epochs=PARALLEL_EPOCHS, save=False,
                        verbose=False)))
            need = TRAINING + (BATCHNORM if family == "cnn" else ())
            missing = not_launched(launches, need)
            err_h = max(float(np.max(np.abs(np.subtract(x, y))
                                     / np.maximum(np.abs(y), 1e-12)))
                        for x, y in ((b.train_loss_history,
                                      a.train_loss_history),
                                     (b.val_loss_history,
                                      a.val_loss_history)))
            sa, sb = a.model.state_dict(), b.model.state_dict()
            err_p = max(float((sb[k].float() - sa[k].float()).abs().max())
                        for k in sa if not k.endswith("num_batches_tracked")
                        and not (k.startswith("conv_")
                                 and k.endswith(".bias")))
            acc_ok = (a.train_accuracy_history == b.train_accuracy_history
                      and a.val_accuracy_history == b.val_accuracy_history)
            ok = err_h <= rtol and err_p <= atol and (
                acc_ok or family == "cnn") and not missing
            log(f"[parallel] Trainer(mesh=) {family} {PARALLEL_EPOCHS} "
                f"epochs vs single device: histories max rel err "
                f"{err_h:.3g} ({rtol:g}), accuracies equal {acc_ok}, "
                f"parameters max abs err {err_p:.3g} ({atol:g}); launches "
                f"K11..K13 {[launches[k] for k in TRAINING + BATCHNORM]}, "
                f"not launched {missing} -> {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"[parallel] Trainer(mesh=) {family}")


# [long-clips]: the clip kernels at 256 clips of 4.0 s (87 frames at hop
# 512, 173 at hop 256), one of 120 s (2,584 and 5,168) and 64 of 60 s
# (1,292 and 2,584), at 11025 Hz; the last two the card refused before
# the split route (`csrc/dsp_common.cuh`)
LONG_CLIP_SHAPES = ((256, 4.0), (1, 120.0), (64, 60.0))
LONG_KERNELS = {"melspec_frontend": "K1", "mfcc_frontend": "K2",
                "yin_pitch": "K3", "mfcc_pitch_frontend": "K6"}
FILE_4S_MIDI = [45, 55, 64]  # A2 G3 E4 from 0.4 s, 4.2 s apart, 12 s
# a 2 min riff at 22050 Hz, a held note every 20 s from 0.4 s
# (`sustained_riff`), through transcribe and transcribe_note at
# clip_duration=60.0
LONG_RIFF_MIDI = [45, 50, 55, 59, 64, 69]
LONG_RIFF_SECONDS, LONG_RIFF_CLIP = 120.0, 60.0
LOADER_FILES = 16         # [long-clips]' loader: 15 plucks and one 60 s file
NUMPY_CLIPS = 32          # [numpy]: the twin's clips, as its main's count


def long_clip_kernels(features, yin, n: int, length: int) -> dict:
    """K1, K2, K3 and K6 at (n, length) as (kernel, plain version,
    roofline cost, frames, the plan's symbol and sizes, the occupancy
    query's symbol and sizes) by name."""
    roofline = load_roofline()
    from gat_tpu_torch.ops import spectral
    t_mel = spectral.n_frames(length, 2048, 256)
    t_mfcc = spectral.n_frames(length, 2048, 512)
    max_p = yin.yin_periods(SR, 50.0, 1000.0, 2048, 1024)[1]
    return {
        "melspec_frontend": (
            lambda x: features.melspec_features(x, SR),
            lambda x: features.melspec_features_plain(x, SR),
            lambda dev: roofline.melspec_cost(n, length, SR, dev), t_mel,
            ("gat_melspec_plan", (n, length, t_mel, 64, 1)),
            ("gat_melspec_blocks_per_sm", (64, t_mel))),
        "mfcc_frontend": (
            lambda x: features.mfcc_frontend(x, SR),
            lambda x: features.mfcc_frontend_plain(x, SR),
            lambda dev: roofline.mfcc_cost(n, length, SR, dev), t_mfcc,
            ("gat_mfcc_plan", (n, length, t_mfcc, 128)),
            ("gat_mfcc_blocks_per_sm", (128, t_mfcc))),
        "yin_pitch": (
            lambda x: yin.yin_pitch(x, SR),
            lambda x: yin.yin_pitch_plain(x, SR),
            lambda dev: roofline.yin_cost(n, length, SR), t_mfcc,
            ("gat_yin_plan", (n, 1024, 512, t_mfcc, max_p)),
            ("gat_yin_blocks_per_sm", (1024, 512, t_mfcc, max_p))),
        "mfcc_pitch_frontend": (
            lambda x: features.mfcc_pitch_features(x, SR),
            lambda x: features.mfcc_pitch_features_plain(x, SR),
            lambda dev: roofline.mfcc_pitch_cost(n, length, SR, dev),
            t_mfcc, ("gat_mfcc_pitch_plan",
                     (n, length, t_mfcc, 128, 64, 1024, 512, max_p)),
            ("gat_mfcc_pitch_frontend_blocks_per_sm",
             (length, 512, t_mfcc, 128, 1024, max_p))),
    }


def clip_launch(kernels, name: str, plan: tuple, query: tuple) -> dict:
    """How a clip front-end runs a shape: its plan's frames a tile (0: one
    block a clip), tiles a clip and resident blocks per SM of the kernel
    that runs the frames (`kernels.plan`); in a checkout without the
    split route, one block a clip and its occupancy query's blocks."""
    import torch
    if hasattr(kernels, "plan"):
        tile, tiles, per_sm, _ = kernels.plan(name, plan[0],
                                              torch.device("cuda", 0),
                                              *plan[1])
        return dict(tile=tile, tiles=tiles, blocks_per_sm=per_sm)
    symbol, sizes = query
    blocks = ctypes.c_int(0)
    kernels.check(kernels.function(
        name, symbol, [ctypes.c_int] * len(sizes) + [ctypes.c_void_p])(
            *sizes, ctypes.addressof(blocks)), f"{name} occupancy")
    return dict(tile=0, tiles=1, blocks_per_sm=blocks.value)


def long_clip_error(name: str, got, ref) -> tuple[float, bool]:
    """(max abs error, ok) of a long-clip kernel against its plain
    version, at the tolerance of its clip-path check: K1 0.1 dB where the
    plain image is above -60 dB; K2 and K6's MFCC atol 1e-3 and rtol
    2e-6 (a mean over frames); K3's and K6's pitch rtol 2e-3."""
    import torch
    if name == "melspec_frontend":
        return mel_error(got, ref)
    if name == "yin_pitch":
        rel = (got / ref - 1).abs()
        return (float((got - ref).abs().max()),
                float(rel.max()) <= 2e-3 and bool(torch.isfinite(got).all()))
    hz_ok = True
    if name == "mfcc_pitch_frontend":
        (got, hz), (ref, ref_hz) = got, ref
        got, ref = got[:, :64], ref[:, :64]
        hz_ok = float((hz / ref_hz - 1).abs().max()) <= 2e-3
    d = (got - ref).abs()
    return float(d.max()), (hz_ok and bool(torch.isfinite(got).all())
                            and bool((d <= 1e-3 + 2e-6 * ref.abs()).all()))


def long_clip_batch(n: int, seconds: float, dev):
    """(n, seconds x SR) riffs on `dev`: a pluck every 0.7 s from 0.4 s
    over the 47 classes in turn, plus noise of sigma 0.1 (`make_riffs`;
    at 256 x 4.0 s the inputs of PR 16's phase)."""
    import torch
    k = max(5, int((seconds - 0.5) / 0.7))
    midi = (40 + np.arange(n * k) % 47).reshape(n, k)
    return torch.from_numpy(make_riffs(midi, seconds, SR, SEED + 16,
                                       noise=0.1)).to(dev)


def time_long_clips(features, yin, dev, failures: list,
                    shapes=LONG_CLIP_SHAPES) -> list[dict]:
    """K1, K2, K3 and K6 at each of `shapes` (clips, seconds): each
    against its plain version (`long_clip_error`), K6's MFCC K2's and its
    pitch K3's bit for bit, each timed in CUDA events over POOL buffers,
    in device ms (the profiler, every device function of its route) with
    its bound, its plain version's time and its launch (`clip_launch`).
    A checkout that caps the frames (`kernels.MAX_FRAMES`, before the
    split route) gives a `refused` row where it raises."""
    import torch
    from gat_tpu_torch import kernels
    roofline = load_roofline()
    out = []
    for n, seconds in shapes:
        length = int(seconds * SR)
        x = long_clip_batch(n, seconds, dev)
        pool = noisy_pool(x, SEED, 0.01)
        got = {}
        for name, (fn, plain, cost, frames, plan, query) in (
                long_clip_kernels(features, yin, n, length).items()):
            row = dict(kernel=name, shape=[n, length], frames=frames)
            try:
                got[name] = fn(x)
            except ValueError as e:
                if not hasattr(kernels, "MAX_FRAMES"):
                    raise
                out.append(dict(row, refused=str(e)))
                log(f"[long-clips] {name} at {n} x {length}: refused")
                continue
            err, ok = long_clip_error(name, got[name], plain(x))
            bound_ms, bound_by = roofline.bound(*cost(dev))
            row.update(clip_launch(kernels, name, plan, query))
            # the route's device functions: the one-block kernel, or the
            # split route's launches
            symbols = roofline.KERNEL_SYMBOLS[LONG_KERNELS[name]]
            parts = symbol_device_ms(fn, pool, symbols[1:] if row["tile"]
                                     else symbols[:1])
            row.update(max_abs_err=err, ms=time_ms(fn, pool, reps=10),
                       device_ms=sum(ms or 0.0 for ms in parts.values())
                       or None, device_parts=parts,
                       plain_ms=time_ms(plain, pool, reps=3),
                       bound_ms=bound_ms, bound_by=bound_by)
            out.append(row)
            log(f"[long-clips] {name} at {n} x {length} ({frames} frames, "
                f"tile {row['tile']} x {row['tiles']}): max abs err "
                f"{err:.6g} -> {'ok' if ok else 'FAIL'}; kernel "
                f"{row['ms']:.4f} ms, {fmt_ms(row['device_ms'])} device, "
                f"plain {row['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by}), {row['blocks_per_sm']} blocks per SM")
            if not ok:
                failures.append(f"[long-clips] {name} at {n} x {length} "
                                f"against its plain version")
        if len(got) == len(LONG_KERNELS):
            k6, hz = got["mfcc_pitch_frontend"]
            same = (torch.equal(k6[:, :64], got["mfcc_frontend"])
                    and torch.equal(hz, got["yin_pitch"]))
            log(f"[long-clips] at {n} x {length} K6's MFCC K2's and its "
                f"pitch K3's bit for bit: {same}")
            if not same:
                failures.append(f"[long-clips] K6 differs from K2 and K3 at "
                                f"{n} x {length}")
        del x, pool, got
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return out


def long_clips_phase(rows: list, card: str, failures: list,
                     device: str = "cuda") -> None:
    """`[long-clips]`: K1, K2, K3 and K6 at LONG_CLIP_SHAPES
    (`time_long_clips`), each shape's row into its kernels-line row's
    `long_clips`; then `[file]` at `clip_duration=4.0`, `transcribe` and
    `transcribe_note` at `clip_duration=60.0`, and a loader holding one
    60 s file (module docstring, phase 17)."""
    import torch
    from gat_tpu_torch import features
    from gat_tpu_torch.ops import yin
    by_name = {r["name"]: r for r in rows}
    for row in time_long_clips(features, yin, torch.device(device),
                               failures):
        name = row.pop("kernel")
        if name in by_name:
            by_name[name].setdefault("long_clips", []).append(row)
    log(f"[long-clips] on {card}")
    file_4s_phase(rows, card, failures, device)
    long_file_phase(rows, card, failures, device)
    long_loader_phase(rows, card, failures, device)


def file_4s_phase(rows: list, card: str, failures: list,
                  device: str = "cuda") -> None:
    """`[file]` at `clip_duration=4.0`: a 12 s riff (A2 G3 E4, 4.2 s
    apart) at 22050 Hz through `transcribe`, on the card and the CPU, on
    the FFT route (K1-K5, K7, K8 launched) and on the matmul route (K1,
    K6, K4, K5, K7, K8; no K2 or K3): labels, onsets and times equal to
    the CPU's."""
    import torch
    from gat_tpu_torch.infer import Transcriber
    from gat_tpu_torch.ops import spectral
    from gat_tpu_torch.utils.wavio import write_wav
    card_t, cpu_t = Transcriber(device=device), Transcriber(device="cpu")
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "riff_12s.wav"
        write_wav(path, make_riffs(np.array([FILE_4S_MIDI]), 12.0, FILE_SR,
                                   SEED + 6, noise=0.0, spacing=4.2)[0],
                  FILE_SR)
        try:
            for route in ("fft", "matmul"):
                spectral.set_stft_backend(route)
                call = functools.partial(card_t.transcribe, path,
                                         clip_duration=4.0)
                call()  # first call: library handles
                got, launches, wall = driven(call)
                ref = cpu_t.transcribe(path, clip_duration=4.0)
                same, err = same_result(got, ref)
                # K1..K13 launched or not: K6 in place of K2 and K3 on the
                # matmul route, the segmentation's K4, K5, K7, K8 and the
                # clip re-rate's K9 on both; no compaction (B = 1, no
                # budget): no K10, no wave through the budget branch and
                # no training kernel (K11-K13)
                want = ([1, 1, 1, 1, 1, 0, 1, 1, 1] if route == "fft"
                        else [1, 0, 0, 1, 1, 1, 1, 1, 1]) + [0] * (BRANCH - 8)
                ok = (same and bool(got["labels"])
                      and [min(k, 1) for k in launches] == want)
                log(f"[file] transcribe(12 s riff, clip_duration=4.0) on "
                    f"the {route} route: labels {got['labels']}, onsets "
                    f"{got['onsets_s']}; equal to the CPU plain path {same} "
                    f"(max prob err {err:.3g}); launches K1..K13, branch {launches}; "
                    f"{wall * 1e3:.3f} ms on {card} -> "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    failures.append(f"[file] clip_duration=4.0 on the "
                                    f"{route} route")
                path_name = "file_4s" if route == "fft" else "file_4s_shared"
                record_launches(rows, path_name, launches)
        finally:
            spectral.set_stft_backend("auto")
    torch.cuda.synchronize()


def sustained_riff(midi: list, seconds: float, sr: int, seed: int
                   ) -> np.ndarray:
    """(seconds·sr,) float32: note j of `midi` from 0.4 + j·seconds/len(midi)
    s, held until 0.5 s before the next, four harmonics decaying over 6 s
    with a 10 ms attack and the last 30 % faded out, plus noise of sigma
    0.003. A slice holds one note up to the next onset, so a note of a
    60 s clip must sound for seconds to pass the slicer's loudness gate,
    which a pluck of 0.45 s does not."""
    rng = np.random.default_rng(seed)
    y = rng.normal(0.0, 0.003, int(seconds * sr))
    spacing = seconds / len(midi)
    n = int((spacing - 0.5) * sr)
    t = np.arange(n) / sr
    env = np.exp(-t / 6.0) * np.minimum(1.0, t / 0.01)
    env[-int(0.3 * n):] *= np.linspace(1.0, 0.0, int(0.3 * n))
    for j, m in enumerate(midi):
        f = 440.0 * 2.0 ** ((m - 69) / 12.0)
        tone = sum(np.sin(2 * np.pi * k * f * t) / k for k in range(1, 5))
        s = int((0.4 + spacing * j) * sr)
        y[s:s + n] += (0.3 * env * tone)[:len(y) - s]
    return y.astype(np.float32)


def long_file_phase(rows: list, card: str, failures: list,
                    device: str = "cuda") -> None:
    """`transcribe(clip_duration=60.0)` and `transcribe_note(audio,
    clip_duration=60.0)` of a 2 min riff at 22050 Hz (LONG_RIFF_MIDI, a
    held note every 20 s from 0.4 s, `sustained_riff`), on the card and on the CPU: labels (and
    the file's onsets and times) equal, probs within 1e-2. Its clips of 60
    s give 2,584 frames at the mel's hop 256 and 1,292 at 512, which the
    card refused before the split route: the card's calls launch K1, the
    MFCC and pitch front-ends (K2 and K3, or K6) and the re-rate K9, and
    `transcribe` the segmentation's K4, K5, K7 and K8 (paths `file_60s`
    and `note_60s`)."""
    import torch
    from gat_tpu_torch.infer import Transcriber
    from gat_tpu_torch.utils.wavio import write_wav
    card_t, cpu_t = Transcriber(device=device), Transcriber(device="cpu")
    riff = sustained_riff(LONG_RIFF_MIDI, LONG_RIFF_SECONDS, FILE_SR,
                          SEED + 26)
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "riff_120s.wav"
        write_wav(path, riff, FILE_SR)
        calls = (
            ("file_60s", lambda t: t.transcribe(
                path, clip_duration=LONG_RIFF_CLIP), (K1, K4, K5, K7, K8, K9)),
            ("note_60s", lambda t: t.transcribe_note(
                riff, clip_duration=LONG_RIFF_CLIP, sr_in=FILE_SR), (K1, K9)))
        for path_name, call, need in calls:
            got, launches, wall = driven(lambda: call(card_t))
            ref = call(cpu_t)
            if path_name == "file_60s":
                same, err = same_result(got, ref)
            else:
                err = float(np.abs(got["probs"] - ref["probs"]).max())
                same = got["labels"] == ref["labels"] and err <= 1e-2
            missing = not_launched(launches, need)
            front = (min(launches[K2], launches[K3]) >= 1
                     or launches[K6] >= 1)
            ok = same and bool(got["labels"]) and not missing and front
            log(f"[long-clips] {path_name}: labels {got['labels']}; equal to "
                f"the CPU plain path {same} (max prob err {err:.3g}); "
                f"launches K1..K13, branch {launches}, not launched "
                f"{missing}, MFCC and pitch front-ends {front}; "
                f"{wall * 1e3:.3f} ms on {card} -> {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"[long-clips] {path_name} at clip_duration="
                                f"{LONG_RIFF_CLIP}")
            record_launches(rows, path_name, launches)
    torch.cuda.synchronize()


def long_loader_phase(rows: list, card: str, failures: list,
                      device: str = "cuda") -> None:
    """`FeatureBuilder.extract_melspec_features` and
    `extract_mfcc_features` on a loader of LOADER_FILES files at 11025 Hz:
    15 plucks of 0.5 s and one 60 s riff, which the loader pads every
    clip to (16 clips of 2,584 frames at hop 256, which the card refused
    before the split route), on the card and on the CPU: labels equal,
    the mel image within 0.1 dB where the CPU's is above -60 dB, the MFCC
    within 1e-3 and the pitch feature within 2e-3 relative (path
    `loader_60s`)."""
    import torch
    from gat_tpu_torch.data.loader import AudioDatasetLoader
    from gat_tpu_torch.features import FeatureBuilder
    from gat_tpu_torch.ops import spectral
    from gat_tpu_torch.ops.pitch import midi_to_note
    from gat_tpu_torch.utils.wavio import write_wav
    plucks, midi = make_clips(LOADER_FILES, SEED + 27)
    riff = long_clip_batch(1, 60.0, "cpu")[0].numpy()
    with tempfile.TemporaryDirectory() as d:
        for i, m in enumerate(midi):
            folder = Path(d) / midi_to_note(int(m), unicode=False)
            folder.mkdir(exist_ok=True)
            write_wav(folder / f"take_{i}.wav",
                      riff if i == 0 else plucks[i], SR)
        card_b, cpu_b = FeatureBuilder(device=device), FeatureBuilder(
            device="cpu")
        card_l = AudioDatasetLoader([d], target_sr=SR, device=device)
        cpu_l = AudioDatasetLoader([d], target_sr=SR, device="cpu")
        (mel, ms_labels), launches, wall = driven(
            lambda: card_b.extract_melspec_features(card_l)[:2])
        mf, mf_labels = card_b.extract_mfcc_features(card_l)[:2]
        ref_mel, ref_labels = cpu_b.extract_melspec_features(cpu_l)[:2]
        ref_mf = cpu_b.extract_mfcc_features(cpu_l)[0]
    mel_err, mel_ok = mel_error(torch.as_tensor(np.asarray(mel)),
                                torch.as_tensor(np.asarray(ref_mel)))
    mf, ref_mf = np.asarray(mf), np.asarray(ref_mf)
    mf_err = float(np.abs(mf[:, :64] - ref_mf[:, :64]).max())
    hz_err = float(np.abs(10.0 ** (mf[:, 64] - ref_mf[:, 64]) - 1.0).max())
    labels_ok = (np.array_equal(ms_labels, ref_labels)
                 and np.array_equal(mf_labels, ref_labels))
    ok = (mel_ok and mf_err <= 1e-3 and hz_err <= 2e-3 and labels_ok
          and np.shape(mel)[2] == spectral.n_frames(int(60.0 * SR), 2048,
                                                    256)
          and launches[K1] >= 1)
    log(f"[long-clips] loader of {LOADER_FILES} files with one 60 s file: "
        f"mel {tuple(np.shape(mel))} max abs err {mel_err:.6g}, MFCC "
        f"{mf_err:.3g}, pitch rel {hz_err:.3g}, labels equal {labels_ok}; "
        f"K1 launches {launches[K1]}; {wall * 1e3:.3f} ms on {card} -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("[long-clips] a loader with one 60 s file")
    record_launches(rows, "loader_60s", launches)
    torch.cuda.synchronize()


def numpy_phase(rows: list, card: str, failures: list, clips_np: np.ndarray,
                device: str = "cuda") -> None:
    """`[numpy]`: the numpy baseline's twin,
    `tools/torch_numpy_reference_pipeline.py`, on the first NUMPY_CLIPS of
    `[main]`'s clips with the shipped checkpoints: its argmax equals the
    card's `transcribe_clips`'s on every clip; its rate in audio-s/s on
    this host is logged (the CPU floor of the port's bench)."""
    from gat_tpu_torch.config import CNN_CONFIG, MLP_CONFIG
    from gat_tpu_torch.infer import Transcriber
    from gat_tpu_torch.train.checkpoint import load_checkpoint
    twin = load_tool("torch_numpy_reference_pipeline")
    pipe = twin.NumpyReferencePipeline(
        load_checkpoint(MLP_CONFIG.CHECKPOINTS_DIR
                        / MLP_CONFIG.DEFAULT_CKPT_NAME),
        load_checkpoint(CNN_CONFIG.CHECKPOINTS_DIR
                        / CNN_CONFIG.DEFAULT_CKPT_NAME))
    clips = clips_np[:NUMPY_CLIPS]
    pipe.transcribe_clip(clips[0])  # numpy's own first-call costs
    t0 = time.perf_counter()
    probs = np.concatenate([pipe.transcribe_clip(c) for c in clips])
    dt = time.perf_counter() - t0
    card = Transcriber(device=device).transcribe_clips(clips)
    same = probs.argmax(1).tolist() == np.asarray(
        card["probs"]).argmax(1).tolist()
    err = float(np.abs(probs - np.asarray(card["probs"])).max())
    log(f"[numpy] the twin's argmax over {len(clips)} clips equal to the "
        f"card's transcribe_clips {same} (max prob diff {err:.3g}); the "
        f"twin at {len(clips) * 0.5 / dt:.2f} audio-s/s on this host -> "
        f"{'ok' if same else 'FAIL'}")
    if not same:
        failures.append("[numpy] the twin's argmax differs from the card's")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this script runs "
              "the port on a CUDA card", file=sys.stderr)
        return 1
    repo = Path(__file__).resolve().parent
    if not (repo / "gat_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no gat_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(repo))

    from gat_tpu_torch import features, kernels
    from gat_tpu_torch.entry import entry
    from gat_tpu_torch.infer import Transcriber
    from gat_tpu_torch.ops import onset, spectral, yin
    from gat_tpu_torch.ops.pitch import midi_to_note
    roofline = load_roofline()

    # ---- 1. the card ------------------------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[card] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {kind}")

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    reports = kernels.build()
    log(f"[build] {len(reports)} kernels built in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    # ---- 3. kernels against their plain versions --------------------------
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    clips_np, midi = make_clips(N_CLIPS, SEED)
    log(f"[data] {N_CLIPS} clips x {CLIP_LEN} in "
        f"{time.perf_counter() - t0:.1f} s")
    clips = torch.from_numpy(clips_np).to(dev)
    pool = noisy_pool(clips, SEED, 0.01)
    torch.cuda.synchronize()

    n, length = clips.shape
    t_mel = spectral.n_frames(length, 2048, 256)
    t_mfcc = spectral.n_frames(length, 2048, 512)
    min_p, max_p = yin.yin_periods(SR, 50.0, 1000.0, 2048, 1024)
    n_items = onset._mel_items(FILE_SR, 128, dev)[2]
    for name, symbol, args, at in (
            ("melspec_frontend", "gat_melspec_blocks_per_sm", (64, t_mel),
             f"64 mels x {t_mel} frames"),
            ("mfcc_frontend", "gat_mfcc_blocks_per_sm", (128, t_mfcc),
             f"128 mels x {t_mfcc} frames"),
            ("yin_pitch", "gat_yin_blocks_per_sm", (1024, 512, t_mfcc, max_p),
             f"{t_mfcc} frames x {max_p + 1} lags"),
            ("onset_envelope", "gat_onset_envelope_blocks_per_sm",
             (n_items, 512), f"128 mels ({n_items} mel items), hop 512, "
             f"pass 1"),
            ("onset_pick", "gat_onset_pick_blocks_per_sm", (),
             "any envelope length (fixed shared memory)")):
        blocks = ctypes.c_int(0)
        status = kernels.function(
            name, symbol, [ctypes.c_int] * len(args) + [ctypes.c_void_p])(
                *args, ctypes.addressof(blocks))
        kernels.check(status, f"{name} occupancy")
        log(f"[occupancy] {name}_kernel: {blocks.value} resident blocks of "
            f"256 threads per SM at {at}")

    def melspec(x):
        return features.melspec_features(x, SR)

    def melspec_plain(x):
        return features.melspec_features_plain(x, SR)

    failures = []
    err, ok = mel_error(melspec(clips), melspec_plain(clips))
    # an odd frame count: the last frame's FFT has a zero partner
    short = clips[:, :1100].contiguous()
    err_odd, ok_odd = mel_error(melspec(short), melspec_plain(short))
    log(f"[check] melspec_frontend at 1100 samples "
        f"({spectral.n_frames(1100, 2048, 256)} frames): max abs "
        f"err {err_odd:.6g} -> {'ok' if ok_odd else 'FAIL'}")
    tolerance = ("atol 0.1 dB where the plain image > -60 dB; finite and "
                 ">= -100 dB everywhere")
    log(f"[check] melspec_frontend: max abs err {err:.6g} ({tolerance}) -> "
        f"{'ok' if ok and ok_odd else 'FAIL'}")
    if not (ok and ok_odd):
        failures.append("melspec_frontend")
    ms = time_ms(melspec, pool, reps=10)
    plain_ms = time_ms(melspec_plain, pool, reps=10)
    bound_ms, bound_by = roofline.bound(*roofline.melspec_cost(n, length, SR,
                                                               dev))
    log(f"[time] melspec_frontend: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms, bound {bound_ms:.4f} ms ({bound_by})")
    rows = [dict(name="melspec_frontend", route="cuda",
                 source="gat_tpu_torch/csrc/melspec_frontend.cu",
                 replaces="gat_tpu/ops/pallas/melspec_frontend.py:71",
                 launches=0, max_abs_err=err, tolerance=tolerance, ms=ms,
                 plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                 library_ms=None)]
    torch.cuda.synchronize()
    # K2 and K3, checked and timed as tools/torch_onset_timing.py does
    rows += time_clip_kernels(features, yin, clips, failures,
                              ("mfcc_frontend", "yin_pitch"))

    rows += check_file_kernels(dev, failures)
    rows += gate_phase(failures)
    rows += resample_phase(failures)
    rows += compact_phase(failures)

    # ---- 4. the clip path -------------------------------------------------
    t = Transcriber(device="cuda")
    res, launches, first_s = driven(lambda: t.transcribe_clips(clips))
    record_launches(rows, "clips", launches)
    for row, k in zip(rows[:3], launches):
        row["launches"] = k
        if k < 1:
            failures.append(f"{row['name']} not launched on the main path")
    log(f"[main] transcribe_clips({N_CLIPS}) first call {first_s:.3f} s, "
        f"launches {[r['launches'] for r in rows[:3]]}")

    probs = np.asarray(res["probs"])
    pitch = np.asarray([p for p, _ in res["dsp_info"]])
    if (probs.shape != (N_CLIPS, 47) or not np.isfinite(probs).all()
            or not np.allclose(probs.sum(axis=1), 1.0, atol=1e-4)
            or not np.isfinite(pitch).all()):
        failures.append("main path output malformed")

    # labels against the plain versions on the card, fed to the same models
    with torch.no_grad():
        hz = yin.yin_pitch_plain(clips, SR)
        mf = torch.cat([features.mfcc_frontend_plain(clips, SR, 64),
                        torch.log10(hz)[:, None]], dim=1)
        ms_img = features.melspec_features_plain(clips, SR)
        plain_probs, _, _ = t.predictor.ensemble_probs(
            t.scaler.transform(mf), ms_img)
    plain_labels = [t.predictor.reverse_map[int(i)]
                    for i in plain_probs.argmax(dim=1).cpu()]
    n_diff = sum(a != b for a, b in zip(res["labels"], plain_labels))
    prob_err = float(np.abs(probs - plain_probs.cpu().numpy()).max())
    log(f"[main] labels differing from the plain path on the card: {n_diff}"
        f"; max |probs - plain probs| {prob_err:.3g}")
    if n_diff:
        failures.append(f"{n_diff} labels differ from the plain path")
    truth = [midi_to_note(int(m), unicode=False) for m in midi]
    acc = float(np.mean([a == b for a, b in zip(res["labels"], truth)]))
    log(f"[main] label accuracy on the noisy plucks: {acc:.4f}")

    # a small batch against the plain path on the CPU
    k = 64
    cpu = Transcriber(device="cpu").transcribe_clips(clips_np[:k])
    cpu_pitch = np.asarray([p for p, _ in cpu["dsp_info"]])
    cpu_prob_err = float(np.abs(cpu["probs"] - probs[:k]).max())
    cpu_pitch_rel = float(np.max(np.abs(cpu_pitch - pitch[:k]) / cpu_pitch))
    log(f"[main] vs CPU plain path on {k} clips: labels equal "
        f"{cpu['labels'] == res['labels'][:k]}, max prob err "
        f"{cpu_prob_err:.3g}, max pitch rel err {cpu_pitch_rel:.3g}")
    if (cpu["labels"] != res["labels"][:k] or cpu_prob_err > 1e-2
            or cpu_pitch_rel > 2e-3):
        failures.append("card path disagrees with the CPU plain path")

    # throughput of the user-facing call, host work included
    reps = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        t.transcribe_clips(pool[i % POOL])
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / reps
    log(f"[main] transcribe_clips({N_CLIPS}): {dt * 1e3:.3f} ms/call, "
        f"{N_CLIPS / dt:.1f} clips/s, {N_CLIPS * 0.5 / dt:.1f} audio-s/s "
        f"on {card}")
    profile_call(lambda: t.transcribe_clips(pool[1]), dt * 1e3)

    # the flagship step through the port's entry point
    step, (ex,) = entry(batch=32, device="cuda")
    p_out, hz_out = step(ex)
    torch.cuda.synchronize()
    if (tuple(p_out.shape) != (32, 47) or tuple(hz_out.shape) != (32,)
            or not bool(torch.isfinite(p_out).all())
            or not bool(torch.isfinite(hz_out).all())):
        failures.append("entry step output malformed")
    log(f"[entry] step(32 clips) -> probs {tuple(p_out.shape)}, "
        f"pitch {tuple(hz_out.shape)}")

    # ---- 5. the file path -------------------------------------------------
    file_phase(rows, card, failures)

    # ---- 6. a long file --------------------------------------------------
    long_phase(rows, card, failures)

    # ---- 7. the many-file path --------------------------------------------
    check_wave_kernels(clips, failures)
    files_phase(rows, card, failures)

    # ---- 8. the server ----------------------------------------------------
    serve_phase(rows, card, failures)

    # ---- 9. streaming -----------------------------------------------------
    stream_kernels_phase(rows, failures)
    stream_phase(rows, card, failures)
    live_phase(rows, card, failures)

    # ---- 10. the CLI ------------------------------------------------------
    cli_phase(rows, card, failures)

    # ---- 11. training -----------------------------------------------------
    train_phase(rows, card, failures)

    # ---- 12. the rest of the public API -----------------------------------
    api_phase(rows, clips_np, midi, failures)

    # ---- 13. the matmul route's shared front-end --------------------------
    shared_phase(rows, card, failures, clips_np)

    # ---- 14. the note-accuracy harness ------------------------------------
    eval_phase(rows, card, failures)

    # ---- 15. the tools ----------------------------------------------------
    tools_phase(rows, card, failures)

    # ---- 16. multi-device at world 1 --------------------------------------
    parallel_phase(rows, card, failures, clips_np)

    # ---- 17. the clip kernels at 4 s, and the file path at clip 4 s -------
    long_clips_phase(rows, card, failures)

    # ---- 18. the numpy baseline's twin ------------------------------------
    numpy_phase(rows, card, failures, clips_np)

    failures += PATH_FAULTS
    if failures:
        log(f"[fail] {failures}")
        # also on standard error, whose end a caller that keeps only that
        # shows: the reasons, not only the exit code
        print(f"chip_smoke: {len(failures)} failed: {failures}",
              file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
