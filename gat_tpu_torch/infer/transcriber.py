"""Transcriber: the inference API of the port, the twin of
`gat_tpu/infer/transcriber.py`. Checkpoints are the source of truth:
feature params, scaler, target rate and clip length all come from their
embedded config.

* `transcribe(path)`: one WAV file → slicing at 22050 Hz → clips
  re-rated to the checkpoint rate → ensemble and YIN baseline per note,
  two-stage by default, or as the batched file body at B=1
  (`fused=True`);
* `transcribe_files(paths)`: many WAV files, the serving path: a
  threaded decode, power-of-two duration buckets, waves of `max_batch`
  files through the batched file body, the exact fallback and the
  onset-cap auto-scaling;
* `transcribe_clips(clips)`: clips already cut and at the checkpoint
  rate;
* `transcribe_note(audio)`: one in-memory note.
"""
from __future__ import annotations

import threading
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from ..config import (CLIP_DURATION, CNN_CONFIG, DEFAULT_MAX_BATCH,
                      DEFAULT_MAX_ONSETS, INFERENCE_OUTPUT_ROOT, MLP_CONFIG,
                      TARGET_SR)
from ..features import FeatureBuilder
from ..ops.resample import fix_length, resample, resample_rows
from ..ops.yin import estimate_note, yin_pitch
from ..segment.slicing import save_clip, segment_waveform
from ..train.checkpoint import load_checkpoint
from ..utils.device import to_host as _to_host
from ..utils.scaler import FeatureScaler
from ..utils.wavio import read_wav
from .pipeline import build_clip_ensemble_fn, build_files_fn
from .predictor import NotePredictor

__all__ = ["Transcriber", "bucket_seconds", "DEFAULT_MAX_BATCH",
           "DEFAULT_MAX_ONSETS"]


class WaveReadError(RuntimeError):
    """Under a mesh, a wave's files failed to decode on some rank. Raised
    on every rank alike before any of the wave's collectives, so the
    ranks may go on to the next call."""


def bucket_seconds(duration_s: float) -> int:
    """The power-of-two duration bucket, in whole seconds, of a file:
    the one definition `transcribe_files` and the server's warmup share."""
    sec = max(1, int(-(-float(duration_s) // 1)))
    return 1 << (sec - 1).bit_length()


def _next_onset_cap(n_detected: int, prev_cap: int,
                    ceiling: int | None) -> int | None:
    """The next `max_onsets` of a cap auto-scaling re-run: the power of
    two that fits the detected count (strictly above the previous cap),
    clamped to the ceiling; None when no larger cap is allowed."""
    if not ceiling:
        return None
    m = 1 << (max(int(n_detected), prev_cap + 1) - 1).bit_length()
    m = min(m, int(ceiling))
    return m if m > prev_cap else None


def _stack_outputs(outs: list[tuple]) -> tuple:
    """K output tuples of the file body, stacked on the device into one
    tuple of (K, ...) tensors (None stays None)."""
    return tuple(None if parts[0] is None else torch.stack(parts)
                 for parts in zip(*outs))


class Transcriber:
    def __init__(self, mlp_ckpt=None, cnn_ckpt=None, mlp_root=None,
                 cnn_root=None, cnn_weight: float = 0.80,
                 require_cnn: bool = True,
                 pitch_prior_weight: float = 0.0,
                 cnn_dtype: torch.dtype | None = None,
                 use_cnn: bool = True, mesh=None, device=None):
        """Resolve and load both checkpoints, check that their embedded
        configs agree, and build the ensemble on `device` (default the
        card; 'cpu' runs the plain PyTorch path). `cnn_weight` is the
        CNN's share of the blend. `require_cnn=False` permits MLP-only
        operation when the CNN checkpoint is missing; `use_cnn=False`
        skips the CNN altogether. `pitch_prior_weight` > 0 mixes the YIN
        pitch prior into the blend. `cnn_dtype=torch.bfloat16` runs the
        CNN's forward in bf16 with its weights kept in float32; the
        default float32 route runs without TF32. The predictor's
        settings may be changed after construction: every call reads
        them.

        `mesh` (a DeviceMesh from `parallel.make_mesh`, every rank making
        the same calls) runs the batch serving path, `transcribe_files`
        (so `serve --mesh N`), data-parallel over its `data` axis: the
        weights are broadcast from rank 0 once, each wave's files split
        over `data` (each rank segments and transcribes its own files
        through the file body, K1-K5 on the card), `max_batch` rounds up
        to the data size and every wave pads to a multiple of it, and the
        outputs are gathered, so every rank returns the single-device
        results. The device is then the rank's. `transcribe` of one file
        ignores the mesh: one file has no batch axis to split."""
        self.mesh = mesh
        self._data_par = 1
        if mesh is not None:
            from ..parallel.mesh import axis_size, mesh_device
            device = mesh_device(mesh) if device is None else device
            self._data_par = axis_size(mesh)
        self.predictor = NotePredictor(cnn_weight=cnn_weight,
                                       pitch_prior_weight=pitch_prior_weight,
                                       cnn_dtype=cnn_dtype, device=device)
        self.device = self.predictor.device
        self.feature_builder = FeatureBuilder(device=self.device)

        mlp_root = Path(mlp_root) if mlp_root else MLP_CONFIG.CHECKPOINTS_DIR
        cnn_root = Path(cnn_root) if cnn_root else CNN_CONFIG.CHECKPOINTS_DIR
        mlp_path = (Path(mlp_ckpt) if mlp_ckpt and Path(mlp_ckpt).is_file()
                    else mlp_root / (mlp_ckpt or MLP_CONFIG.DEFAULT_CKPT_NAME))
        cnn_path = (Path(cnn_ckpt) if cnn_ckpt and Path(cnn_ckpt).is_file()
                    else cnn_root / (cnn_ckpt or CNN_CONFIG.DEFAULT_CKPT_NAME))
        hint = ("; shipped checkpoints live in a repo checkout's data/ — "
                "run from a checkout or set GAT_TPU_DATA_ROOT to its data/")
        if not mlp_path.is_file():
            raise FileNotFoundError(
                f"[Transcriber] Missing MLP checkpoint: {mlp_path}{hint}")
        if use_cnn and require_cnn and not cnn_path.is_file():
            raise FileNotFoundError(
                f"[Transcriber] Missing CNN checkpoint: {cnn_path}{hint}")

        self.model_ckpts = {"mlp": load_checkpoint(mlp_path)}
        if use_cnn and cnn_path.is_file():
            self.model_ckpts["cnn"] = load_checkpoint(cnn_path)
        self.model_configs = {k: v.get("config")
                              for k, v in self.model_ckpts.items()}
        if any(not c for c in self.model_configs.values()):
            raise ValueError("[Transcriber] Checkpoints missing 'config' "
                             "field.")
        srs = {c["target_sr"] for c in self.model_configs.values()}
        if len(srs) > 1:
            raise ValueError("[Transcriber] Target SR mismatch.")
        self.ckpt_sr = int(srs.pop())
        cls = {float(c.get("clip_length", CLIP_DURATION))
               for c in self.model_configs.values()}
        if len(cls) > 1:
            raise ValueError("[Transcriber] Checkpoint clip_length mismatch: "
                             f"{sorted(cls)} — these models saw different "
                             "clip durations in training.")
        self.clip_length = cls.pop()

        sc = self.model_ckpts["mlp"].get("scaler")
        self.scaler = FeatureScaler.from_dict(sc) if sc is not None else None
        self.predictor.load_models(self.model_ckpts.get("mlp"),
                                   self.model_ckpts.get("cnn"))
        if mesh is not None:
            from ..parallel.sharded import replicate_predictor
            replicate_predictor(self.predictor, mesh)
        self.mfcc_params = self.model_configs["mlp"]["features"]["params"]
        cnn_cfg = self.model_configs.get("cnn")
        self.melspec_params = (cnn_cfg["features"]["params"] if cnn_cfg
                               else None)
        # clips → (probs, mlp_probs, cnn_probs), shared with entry.entry
        self.ensemble = build_clip_ensemble_fn(
            self.predictor, self.scaler, self.ckpt_sr, self.mfcc_params,
            self.melspec_params, return_parts=True)
        # check-then-build under a lock: the HTTP server's dispatcher
        # threads share one Transcriber
        self._files_fns: dict = {}
        self._files_lock = threading.Lock()

    # ------------------------------------------------------------------
    def _files_fn(self, target_sr: int, clip_duration: float,
                  max_onsets: int, wave_clip_budget: int | None = None,
                  cand_budget: int | None = None, sharded: bool = True):
        """(run, run_scan) of the batched file body for one parameter
        set, built once (it holds no predictor state:
        `build_clip_ensemble_fn`). `run(ys (B, n), n_valids (B,))` is the
        body (`pipeline.build_files_fn`); `run_scan(ys (K, B, n),
        n_valids (K, B))` runs it on the K waves in turn with no host
        synchronisation between them and stacks the outputs on the device,
        (K, B, ...). Under a mesh each wave splits B over its `data`
        axis and gathers its outputs (`pipeline.build_files_fn`'s `rows`)
        unless `sharded` is False."""
        sharded = sharded and self.mesh is not None
        key = (target_sr, clip_duration, max_onsets, wave_clip_budget,
               cand_budget, sharded)
        with self._files_lock:
            if key not in self._files_fns:
                rows = None
                if sharded:
                    from ..parallel.mesh import data_sharding
                    rows = data_sharding(self.mesh)
                run = build_files_fn(
                    self.predictor, self.scaler, self.ckpt_sr,
                    self.mfcc_params, self.melspec_params, target_sr,
                    clip_duration, max_onsets,
                    wave_clip_budget=wave_clip_budget,
                    cand_budget=cand_budget, rows=rows)

                def run_scan(yss, nvss, run=run):
                    return _stack_outputs([run(ys, nvs)
                                           for ys, nvs in zip(yss, nvss)])
                self._files_fns[key] = (run, run_scan)
            return self._files_fns[key]

    @staticmethod
    def _dispatch_pow2_wave(run, entries, n_bucket: int,
                            b_floor: int = 1) -> tuple:
        """One wave of (y (n_bucket,), n_valid) entries through the file
        body: stacked, padded to a power of two B >= 2 with zero rows of
        n_valid 0 (no onsets, so padding never changes a result), and
        brought to the host in one transfer. The floor of 2 keeps a lone
        file on the B = 2 shape the server's warmup runs; `b_floor` (the
        mesh's data size) rounds B up to a multiple of it."""
        b = max(2, 1 << (len(entries) - 1).bit_length())
        b = -(-b // b_floor) * b_floor
        y0 = entries[0][0]
        ys = torch.stack([y for y, _ in entries]
                         + [y0.new_zeros(n_bucket)] * (b - len(entries)))
        nv = torch.tensor([n for _, n in entries] + [0] * (b - len(entries)),
                          dtype=torch.int32, device=y0.device)
        return _to_host(run(ys, nv))

    def _dsp_info(self, pitch) -> list:
        out = []
        for hz in np.asarray(pitch):
            midi, name, midi_f = estimate_note(float(hz))
            out.append((float(hz), {"midi": midi, "note_name": name,
                                    "midi_float": midi_f}))
        return out

    def _build_result(self, probs, mlp_p, cnn_p, pitch, kept, onsets,
                      times, target_sr: int, empty_ok: bool = False,
                      overflow=False) -> dict:
        """The per-file result dict from the file body's host outputs
        (budget-slot arrays and the kept mask), in transcribe_clips'
        schema plus `onsets_s`, `times` and `onset_overflow`."""
        overflow = bool(overflow)
        kept = np.asarray(kept)
        if not kept.any():
            if not empty_ok:
                raise ValueError("[transcribe] No clips survived slicing.")
            c = np.asarray(probs).shape[1:]
            return {"indices": np.zeros(0, np.int64), "labels": [],
                    "confidences": np.zeros(0, np.float32),
                    "probs": np.zeros((0,) + c, np.float32),
                    "per_model_probs": {
                        "mlp": np.zeros((0,) + c, np.float32),
                        "cnn": (np.zeros((0,) + c, np.float32)
                                if cnn_p is not None else None)},
                    "dsp_info": [], "onsets_s": [], "times": [],
                    "onset_overflow": overflow}
        probs = np.asarray(probs)[kept]
        idx = probs.argmax(axis=1)
        rm = self.predictor.reverse_map
        result = {
            "indices": idx,
            "labels": ([rm[int(i)] for i in idx] if rm
                       else [int(i) for i in idx]),
            "confidences": probs[np.arange(len(idx)), idx],
            "probs": probs,
            "per_model_probs": {
                "mlp": np.asarray(mlp_p)[kept],
                "cnn": np.asarray(cnn_p)[kept] if cnn_p is not None
                else None},
            "dsp_info": self._dsp_info(np.asarray(pitch)[kept]),
        }
        result["onsets_s"] = (np.asarray(onsets)[kept]
                              / float(target_sr)).tolist()
        result["times"] = np.asarray(times)[kept].tolist()
        result["onset_overflow"] = overflow
        return result

    @torch.no_grad()
    def transcribe_files(self, paths, target_sr: int = TARGET_SR,
                         clip_duration: float | None = None,
                         max_onsets: int = DEFAULT_MAX_ONSETS,
                         max_batch: int = DEFAULT_MAX_BATCH,
                         wave_clip_budget: int | None | str = "auto",
                         cand_budget: int | None | str = "auto",
                         exact_fallback: bool = True,
                         max_onsets_ceiling: int | None = 1024
                         ) -> list[dict]:
        """Transcription of many WAV files, the serving path. Returns one
        result dict per path, in input order; a file with no surviving
        clip gets an empty result instead of raising.

        The files are decoded in parallel threads (`read_wav_batch`),
        padded on the host to whole seconds, resampled on the device to
        `target_sr` and grouped into power-of-two duration buckets (1, 2,
        4, ... s), so a long file never pads a wave of short ones and the
        (B, n) shapes stay a small family. Each bucket runs in waves of
        `max_batch` files through the batched file body: full waves in
        power-of-two chunks of K waves, each chunk run back to back on the
        device and brought to the host in one transfer, and the rest as
        one wave padded to a power of two B with silent rows.

        `wave_clip_budget` caps the clip slots per wave that run the
        ensemble (the kept slots first, slot-major; a file that loses one
        is flagged); None computes every slot. `cand_budget` sizes the
        onset candidate walk (`ops.onset.candidate_limit`). Both default
        to "auto": 3/4 of the wave's `max_batch · max_onsets` slots, and
        the proportional candidate default.

        `exact_fallback`: every file whose truncation an exact run could
        change (the body's `fixable` flag) runs again through the exact
        body (full candidate walk, every slot computed), regrouped per
        bucket through the same waves; a cap-only truncation skips that
        run, since the exact walk returns the same first `max_onsets`
        onsets. A file still flagged then runs once more at the power of
        two `max_onsets` that fits its detected count, grouped per cap,
        up to `max_onsets_ceiling` (None or 0 keeps the flag), so a flag
        that survives means more onsets than the ceiling.
        `exact_fallback=False` keeps the raw budget semantics."""
        if clip_duration is None:
            clip_duration = self.clip_length
        if self._data_par > 1 and max_batch % self._data_par:
            # each wave's files split over the data axis: waves of a
            # multiple of its size
            max_batch = -(-max_batch // self._data_par) * self._data_par
        if isinstance(wave_clip_budget, str):
            if wave_clip_budget != "auto":
                raise ValueError(f"wave_clip_budget must be an int, None, "
                                 f"or 'auto'; got {wave_clip_budget!r}")
            wave_clip_budget = max(1, (max_batch * max_onsets * 3) // 4)
        if isinstance(cand_budget, str):
            if cand_budget != "auto":
                raise ValueError(f"cand_budget must be an int, None, or "
                                 f"'auto'; got {cand_budget!r}")
            cand_budget = None
        paths = list(paths)
        if not paths:
            return []
        from ..utils.native_wav import read_wav_batch
        buckets: dict[int, list[tuple[int, torch.Tensor, int]]] = {}

        def decode():
            for idx, (y_raw, sr_in) in enumerate(read_wav_batch(paths)):
                y_np = np.asarray(y_raw, np.float32)
                n_raw = int(y_np.shape[-1])
                sec = max(1, -(-n_raw // sr_in))
                bsec = bucket_seconds(sec)
                # whole seconds on the host, so the resampler sees one
                # length per (seconds, rate); n_valid masks the pad
                if n_raw < sec * sr_in:
                    y_np = np.pad(y_np, (0, sec * sr_in - n_raw))
                y = resample(torch.from_numpy(y_np).to(self.device), sr_in,
                             target_sr)
                y = fix_length(y, bsec * target_sr)
                nv = -(-n_raw * target_sr // sr_in)
                buckets.setdefault(bsec, []).append((idx, y, nv))
        if self.mesh is None:
            decode()
        else:
            # the ranks agree that every one decoded the files before the
            # first collective: a bad file raises on all of them alike
            from ..parallel.mesh import all_ranks_ok
            err = None
            try:
                decode()
            except Exception as e:  # noqa: BLE001 - raised below
                err = e
            if not all_ranks_ok(err is None, self.mesh):
                raise WaveReadError(
                    f"[Transcriber] the wave's files failed to decode on a "
                    f"rank of the mesh: {err!r}") from err

        results: list[dict | None] = [None] * len(paths)
        fixable = [False] * len(paths)
        n_det = [0] * len(paths)

        def emit(idx, o):
            # o: one file's (probs, mlp, cnn | None, pitch, kept, onsets,
            # times, overflow, fixable, n_detected) on the host
            results[idx] = self._build_result(
                o[0], o[1], o[2], o[3], o[4], o[5], o[6], target_sr,
                empty_ok=True, overflow=o[7])
            fixable[idx] = bool(o[8])
            n_det[idx] = int(o[9])

        def run_bucket(fns, group, n_bucket):
            """One bucket's files through a (run, run_scan) pair: full
            waves in power-of-two chunks of K waves (one host transfer a
            chunk), then the rest as one padded wave each."""
            run, run_scan = fns
            k_full = len(group) // max_batch
            off = 0
            while k_full >= 2:
                kc = 1 << (k_full.bit_length() - 1)
                chunk = group[off:off + kc * max_batch]
                ys = torch.stack([y for _, y, _ in chunk]).reshape(
                    kc, max_batch, n_bucket)
                nvs = torch.tensor([nv for _, _, nv in chunk],
                                   dtype=torch.int32,
                                   device=self.device).reshape(kc, max_batch)
                outs = _to_host(run_scan(ys, nvs))
                for j, (idx, _, _) in enumerate(chunk):
                    kk, jj = divmod(j, max_batch)
                    emit(idx, tuple(None if o is None else o[kk][jj]
                                    for o in outs))
                off += kc * max_batch
                k_full -= kc
            for w0 in range(off, len(group), max_batch):
                wave = group[w0:w0 + max_batch]
                outs = self._dispatch_pow2_wave(
                    run, [(y, nv) for _, y, nv in wave], n_bucket,
                    self._data_par)
                for j, (idx, _, _) in enumerate(wave):
                    emit(idx, tuple(None if o is None else o[j]
                                    for o in outs))

        def rerun(fns, chosen):
            for bsec, group in buckets.items():
                again = [e for e in group if e[0] in chosen]
                if again:
                    run_bucket(fns, again, bsec * target_sr)

        fns = self._files_fn(target_sr, clip_duration, max_onsets,
                             wave_clip_budget, cand_budget)
        for bsec in sorted(buckets):
            run_bucket(fns, buckets[bsec], bsec * target_sr)

        if exact_fallback:
            flagged = {i for i, f in enumerate(fixable) if f}
            if flagged:
                rerun(self._files_fn(target_sr, clip_duration, max_onsets,
                                     None, 0), flagged)
            if max_onsets_ceiling:
                caps = [max_onsets] * len(paths)
                while True:
                    todo: dict[int, set[int]] = {}
                    for i, r in enumerate(results):
                        if not r["onset_overflow"]:
                            continue
                        m = _next_onset_cap(n_det[i], caps[i],
                                            max_onsets_ceiling)
                        if m is not None:
                            todo.setdefault(m, set()).add(i)
                    if not todo:
                        break
                    for m, chosen in sorted(todo.items()):
                        rerun(self._files_fn(target_sr, clip_duration, m,
                                             None, 0), chosen)
                        for i in chosen:
                            caps[i] = m
        return results

    @torch.no_grad()
    def transcribe_clips(self, clips_ckpt_sr) -> dict:
        """Clips at the checkpoint rate, (N, L) numpy or tensor →
        prediction dict plus the YIN baseline per clip (`dsp_info`).
        The pitch feature and the baseline both read the raw clips, so
        YIN runs once and serves both: K2 + K3 and K1 on the card, or on
        the shared route (`features.shared_frontend`) K6 and K1."""
        clips = torch.as_tensor(clips_ckpt_sr, dtype=torch.float32,
                                device=self.device).contiguous()
        (probs, mlp_p, cnn_p), pitch = self.ensemble(clips, with_pitch=True)
        result = self.predictor._result_dict(probs, mlp_p, cnn_p)
        result["dsp_info"] = self._dsp_info(pitch.cpu().numpy())
        return result

    @torch.no_grad()
    def transcribe(self, audio_path, out_root=INFERENCE_OUTPUT_ROOT,
                   audio_name: str = "transcribe_audio",
                   target_sr: int = TARGET_SR,
                   clip_duration: float | None = None,
                   save_clips: bool = False,
                   max_onsets: int = DEFAULT_MAX_ONSETS,
                   fused: bool = False,
                   exact_fallback: bool = True,
                   cand_budget: int | None = None,
                   max_onsets_ceiling: int | None = 1024) -> dict:
        """Transcription of one WAV file: slice at `target_sr`, re-rate
        the clips to the checkpoint rate, features with the checkpoint's
        params, ensemble, YIN baseline.

        Two stages by default: segmentation, then the kept clips only.
        `fused=True` runs the batched file body at B=1 instead, which
        computes every one of the `max_onsets` slots; `save_clips` always
        takes the two-stage path (the clips go to the host anyway).

        `exact_fallback`: when the candidate budget truncated the onsets
        and could have changed them, the file is segmented again with the
        full-length walk (cand_budget 0); a flag that survives is a
        `max_onsets` truncation, repaired by one re-run at the power of
        two that fits the detected count, up to `max_onsets_ceiling`
        (None or 0 keeps the flag). Raises ValueError when no clip
        survives slicing."""
        if clip_duration is None:
            clip_duration = self.clip_length
        y, sr_in = read_wav(audio_path)
        # whole seconds on the host before resampling; n is the true
        # resampled length, and everything past it is masked
        y_np = np.asarray(y, np.float32)
        n_raw = int(y_np.shape[-1])
        sec = max(1, -(-n_raw // sr_in))
        if n_raw < sec * sr_in:
            y_np = np.pad(y_np, (0, sec * sr_in - n_raw))
        n = -(-n_raw * target_sr // sr_in)
        y_dev = resample(torch.from_numpy(y_np).to(self.device), sr_in,
                         target_sr).contiguous()
        nv = torch.tensor([n], dtype=torch.int32, device=self.device)

        if fused and not save_clips:
            def run(m, cb):
                run_m, _ = self._files_fn(target_sr, clip_duration, m,
                                          None, cb, sharded=False)
                outs = run_m(y_dev[None], nv)
                return tuple(None if x is None else x[0]
                             for x in _to_host(outs))
            (probs, mlp_p, cnn_p, pitch, kept, onsets, times, ovf, fix,
             nd) = run(max_onsets, cand_budget)
            if exact_fallback and fix:
                (probs, mlp_p, cnn_p, pitch, kept, onsets, times, ovf, _,
                 nd) = run(max_onsets, 0)
            m_prev = max_onsets
            while exact_fallback and ovf:
                m = _next_onset_cap(int(nd), m_prev, max_onsets_ceiling)
                if m is None:
                    break
                (probs, mlp_p, cnn_p, pitch, kept, onsets, times, ovf, _,
                 nd) = run(m, 0)
                m_prev = m
            return self._build_result(probs, mlp_p, cnn_p, pitch, kept,
                                      onsets, times, target_sr,
                                      overflow=ovf)

        def segment(m, cb):
            clips, *small = segment_waveform(
                y_dev[None], sr=target_sr, length_sec=clip_duration,
                max_onsets=m, n_valid=nv, cand_budget=cb)
            kept, onsets, _, times, ovf, cap, nd = (
                x[0] for x in _to_host(tuple(small)))
            return clips[0], kept, onsets, times, ovf, cap, nd

        clips, kept, onsets, times, overflow, cap, nd = segment(
            max_onsets, cand_budget)
        if exact_fallback and overflow and not cap:
            clips, kept, onsets, times, overflow, _, nd = segment(
                max_onsets, 0)
        m_prev = max_onsets
        while exact_fallback and overflow:
            m = _next_onset_cap(int(nd), m_prev, max_onsets_ceiling)
            if m is None:
                break
            clips, kept, onsets, times, overflow, _, nd = segment(m, 0)
            m_prev = m
        idx_kept = np.flatnonzero(kept)
        if idx_kept.size == 0:
            raise ValueError("[transcribe] No clips survived slicing.")
        rows = torch.from_numpy(idx_kept).to(clips.device)

        if save_clips:
            stamp = datetime.now().strftime("%m-%d_%H-%M-%S")
            out_dir = Path(out_root) / f"{audio_name}_{stamp}" / audio_name
            for i, clip in zip(idx_kept, clips[rows].cpu().numpy()):
                save_clip(clip, target_sr, out_dir, int(i),
                          onsets[i] / target_sr)

        # the kept clips at the checkpoint's sample rate and clip length
        clips_ckpt = resample_rows(clips, rows, target_sr, self.ckpt_sr,
                                   int(self.ckpt_sr * clip_duration))
        result = self.transcribe_clips(clips_ckpt)
        result["onsets_s"] = (onsets[kept] / float(target_sr)).tolist()
        result["times"] = times[kept].tolist()
        result["onset_overflow"] = bool(overflow)
        return result

    @torch.no_grad()
    def transcribe_note(self, audio, clip_duration: float | None = None,
                        sr_in: int = TARGET_SR) -> dict:
        """One in-memory note: re-rated to the checkpoint rate, cut or
        zero-padded to the clip length, then the feature builder's
        batch-of-one features (pitch feature from the normalized note)
        through the ensemble; the pitch prior, when on, reads the raw
        note's pitch."""
        if clip_duration is None:
            clip_duration = self.clip_length
        audio = torch.as_tensor(np.asarray(audio, np.float32),
                                device=self.device)
        audio = fix_length(resample(audio, sr_in, self.ckpt_sr),
                           int(clip_duration * self.ckpt_sr))
        mf, ms = self.feature_builder.extract_inference_features_from_audio(
            audio, self.ckpt_sr, self.mfcc_params, self.melspec_params,
            self.scaler)
        hz = (yin_pitch(audio[None].contiguous(), self.ckpt_sr)
              if self.predictor.pitch_prior_weight > 0 else None)
        return self.predictor.predict(mf, ms, pitch_hz=hz)
