"""The ensemble forward and the batched file body, the twins of
`gat_tpu/infer/pipeline.py`. The entry point, the Transcriber's clip and
file paths all build their functions here, so the recipe (feature params
from the checkpoints, scaler, softmax blend, pitch prior, re-rating)
exists once.

The file body and what it calls mark their stages with
`utils/profiling.annotate` ranges (`torch.profiler.record_function`
while a profiler records) named as
`tools/torch_roofline_files.py`'s STAGE_TAGS (segmentation_other,
onset_detect, slicing, compaction, clip_rerate, yin_baseline,
mfcc_yin_frontend, melspec_frontend, mlp_forward, cnn_forward), so a
trace attributes each kernel to its stage; they are instrumentation
only."""
from __future__ import annotations

import torch

from ..features import (melspec_features, mfcc_feature_vectors,
                        mfcc_pitch_features, shared_frontend,
                        shared_pitch_is_raw)
from ..ops.compaction import wave_scatter, wave_select
from ..ops.resample import fix_length, resample, resample_rows
from ..ops.yin import yin_pitch
from ..utils.profiling import annotate

__all__ = ["build_clip_ensemble_fn", "build_files_fn"]


def build_clip_ensemble_fn(predictor, scaler, ckpt_sr: int,
                           mfcc_params: dict, melspec_params: dict | None,
                           in_sr: int | None = None,
                           clip_len: int | None = None,
                           pitch_on_normalized: bool = False,
                           return_parts: bool = False):
    """Returns fn(clips (N, L), raw_pitch_hz=None, with_pitch=False) →
    blended probs (N, C), or (blended, mlp_probs, cnn_probs | None) when
    `return_parts`; with `with_pitch`, (that, the YIN pitch (N,) of the
    re-rated raw clips).

    Clips arrive at `in_sr` (default: the checkpoint rate) and are
    re-rated to the checkpoint rate, then cut or zero-padded to `clip_len`
    samples when it is given. `raw_pitch_hz`, the YIN pitch of the
    (re-rated) raw clips when the caller has it for its own output, is
    reused for the pitch feature and the pitch prior;
    `pitch_on_normalized` takes the pitch feature from the volume-
    normalized clips instead. With `melspec_params` None (no CNN) the mel
    front-end and the CNN are skipped.

    The route is read on every call. On the shared route
    (`features.shared_frontend`) the MFCC front-end gives the pitch too
    (`mfcc_pitch_features`, K6 on the card), and that pitch is the
    baseline and the prior's whenever it is the raw clips'; else YIN runs
    on the raw clips for them (K3), as on the FFT route.

    Nothing of the predictor is read here: each call reads its models,
    blend weight and prior settings (`NotePredictor.ensemble_probs`), so
    a function built once never serves a stale one."""

    @torch.no_grad()
    def run(clips: torch.Tensor, raw_pitch_hz: torch.Tensor | None = None,
            with_pitch: bool = False):
        if in_sr is not None and in_sr != ckpt_sr:
            clips = resample(clips, in_sr, ckpt_sr)
        if clip_len is not None:
            clips = fix_length(clips, clip_len)
        clips = clips.contiguous()
        normalize = mfcc_params["NORMALIZE_AUDIO_VOLUME"]
        shared = shared_frontend(mfcc_params["ADD_PITCH_FEATURES"])
        shared_raw = shared and shared_pitch_is_raw(normalize,
                                                    pitch_on_normalized)
        hz = raw_pitch_hz
        if hz is None and with_pitch and not shared_raw:
            with annotate("yin_baseline"):
                hz = yin_pitch(clips, ckpt_sr)
        with annotate("mfcc_yin_frontend"):
            if shared:
                mf, shared_hz = mfcc_pitch_features(
                    clips, ckpt_sr, mfcc_params["N_MFCC"], normalize,
                    pitch_on_normalized)
                if hz is None and shared_raw:
                    hz = shared_hz
            else:
                mf = mfcc_feature_vectors(
                    clips, ckpt_sr, n_mfcc=mfcc_params["N_MFCC"],
                    normalize_audio_volume=normalize,
                    add_pitch_features=mfcc_params["ADD_PITCH_FEATURES"],
                    pitch_on_normalized=pitch_on_normalized,
                    raw_pitch_hz=hz)
            if scaler is not None:
                mf = scaler.transform(mf)
        ms = None
        if melspec_params is not None and predictor.cnn is not None:
            with annotate("melspec_frontend"):
                ms = melspec_features(
                    clips, ckpt_sr, n_mels=melspec_params["N_MELS"],
                    n_fft=melspec_params["N_FFT"],
                    hop_length=melspec_params["HOP_LENGTH"],
                    normalize_audio_volume=melspec_params[
                        "NORMALIZE_AUDIO_VOLUME"],
                    # checkpoint-embedded TO_DB wins (absent key = legacy
                    # checkpoint, dB on)
                    to_db=bool(melspec_params.get("TO_DB", True)))
        if (hz is None and predictor.pitch_prior_weight > 0
                and predictor.reverse_map):
            with annotate("yin_baseline"):
                hz = yin_pitch(clips, ckpt_sr)
        parts = predictor.ensemble_probs(mf, ms, pitch_hz=hz)
        out = parts if return_parts else parts[0]
        return (out, hz) if with_pitch else out

    return run


def build_files_fn(predictor, scaler, ckpt_sr: int, mfcc_params: dict,
                   melspec_params: dict | None, target_sr: int,
                   clip_duration: float, max_onsets: int,
                   wave_clip_budget: int | None = None,
                   cand_budget: int | None = None, rows=None):
    """The batched file body: fn(ys (B, n), n_valids (B,)) → per-file
    (probs (B, K, C), mlp_probs, cnn_probs | None, pitch (B, K), kept
    (B, K), onsets (B, K), times (B, K, 2), overflow (B,), fixable (B,),
    n_detected (B,)), K = max_onsets.

    Segmentation runs over the B files at once; the B·K budget slots then
    go through re-rating, the ensemble and YIN as one flat clip batch.

    `wave_clip_budget` (< B·K) computes only that many slots: the kept
    slots first, in slot-major order (every file's slot 0, then slot 1,
    ...), so under overflow each file keeps its earliest clips and the
    files degrade together; results scatter back to their (file, slot)
    places, and a file that lost a kept clip is flagged. None computes
    every slot. `cand_budget` sizes the onset candidate walk
    (`ops.onset.candidate_limit`).

    `overflow`: a budget truncated the file's results. `fixable`: an
    exact re-run (cand_budget 0, wave_clip_budget None) could change
    them; the two differ on a `max_onsets`-only truncation, which no
    larger candidate walk repairs. `n_detected`: the onsets the walk
    accepted before the cap (exact when the candidate bits are clean).

    `rows` (a `parallel.mesh.RowSharding` over the mesh's `data` axis):
    every rank passes the whole wave, runs its own block of the files and
    gets the whole wave's gathered outputs. The budget's slot-major order
    is taken over the whole wave's kept slots, so each rank computes the
    slots of its files that the single-device body computes."""
    from ..segment.slicing import segment_waveform

    if wave_clip_budget is not None and wave_clip_budget < 1:
        raise ValueError(f"wave_clip_budget must be >= 1 (None = every "
                         f"slot computed); got {wave_clip_budget}")
    ensemble = build_clip_ensemble_fn(predictor, scaler, ckpt_sr,
                                      mfcc_params, melspec_params,
                                      return_parts=True)
    clip_len = int(ckpt_sr * clip_duration)

    def classify(clips, rows=None):
        # rows `rows` of the clips (None: all), re-rated and cut to the
        # checkpoint's clip length in one step (on the card one launch of
        # K9, which reads the picked rows where they lie)
        with annotate("clip_rerate"):
            comp = resample_rows(clips, rows, target_sr, ckpt_sr,
                                 clip_len).contiguous()
        parts, pitch = ensemble(comp, with_pitch=True)
        return (*parts, pitch)

    @torch.no_grad()
    def run(ys: torch.Tensor, n_valids: torch.Tensor):
        if rows is None:
            return body(ys, n_valids, ys.shape[0], 0)
        n_files = ys.shape[0]
        outs = body(rows.local(ys), rows.local(n_valids), n_files,
                    rows.span(n_files)[0])
        return tuple(None if o is None else rows.gather(o, n_files)
                     for o in outs)

    def body(ys, n_valids, n_files: int, first: int):
        # files [first, first + len(ys)) of a wave of n_files
        with annotate("segmentation_other"):
            # the counts as K7 and K8 take them. The samples past each
            # file's true length (the whole-second host pad, which the
            # resampler's edge leaks into) need no mask of their own: the
            # gate zeroes every sample past n_valid, onset detection reads
            # the gated rows, and a clip reads only inside [start, end),
            # which lies in [0, n_valid)
            n_valids = n_valids.to(device=ys.device, dtype=torch.int32)
        (clips, kept, onsets, _, times, overflow, cap,
         n_detected) = segment_waveform(
            ys, sr=target_sr, length_sec=clip_duration,
            max_onsets=max_onsets, n_valid=n_valids, cand_budget=cand_budget)
        fixable = overflow & ~cap
        b, k, length = clips.shape
        flat = clips.reshape(b * k, length)
        budget = wave_clip_budget
        if budget is not None and budget < n_files * k:
            # kept slots first, slot-major over the whole wave, picked and
            # put back by `ops.compaction` (on the card K10's two launches)
            with annotate("compaction"):
                kept_all = (kept if rows is None
                            else rows.gather(kept, n_files))
                s = wave_select(kept_all, budget, first, b, overflow,
                                fixable)
                # a rank none of whose slots is picked classifies one
                # slot that nothing reads, so no kernel sees 0 clips
                picked = s.sel if s.n_sel else s.sel.new_zeros(1)
            parts = classify(flat, picked)
            with annotate("compaction"):
                probs, mlp_p, cnn_p, pitch = wave_scatter(s.pos, parts)
            kept, overflow, fixable = s.kept, s.overflow, s.fixable
        else:
            probs, mlp_p, cnn_p, pitch = classify(flat)

        def perfile(x):
            return None if x is None else x.reshape((b, k) + x.shape[1:])
        return (perfile(probs), perfile(mlp_p), perfile(cnn_p),
                perfile(pitch), kept, onsets, times, overflow, fixable,
                n_detected)

    return run
