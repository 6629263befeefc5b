"""The one ensemble forward: clips → blended class probabilities, the twin
of `gat_tpu/infer/pipeline.py::build_clip_ensemble_fn`. The entry point
and the Transcriber both build their function here, so the recipe
(feature params from the checkpoints, scaler, softmax blend, pitch prior)
exists once."""
from __future__ import annotations

import torch

from ..features import mfcc_feature_vectors, melspec_features
from ..ops.yin import yin_pitch
from .predictor import apply_pitch_prior, class_midi_values

__all__ = ["build_clip_ensemble_fn"]


def build_clip_ensemble_fn(predictor, scaler, ckpt_sr: int,
                           mfcc_params: dict, melspec_params: dict | None,
                           in_sr: int | None = None):
    """Returns fn(clips (N, L), raw_pitch_hz=None) → (blended probs (N, C),
    mlp_probs, cnn_probs | None).

    Clips arrive at the checkpoint rate. `raw_pitch_hz`, the YIN pitch of
    the raw clips when the caller has computed it for its own output, is
    reused for the pitch feature and the pitch prior. With
    `melspec_params` None (no CNN) the mel front-end and the CNN are
    skipped."""
    if in_sr is not None and in_sr != ckpt_sr:
        raise NotImplementedError(
            f"[build_clip_ensemble_fn] clips at {in_sr} Hz need resampling "
            f"to {ckpt_sr} Hz, which the PyTorch port does not have yet")
    use_cnn = melspec_params is not None and predictor.cnn is not None
    use_prior = predictor.pitch_prior_weight > 0 and predictor.reverse_map
    class_midi = (class_midi_values(predictor.reverse_map) if use_prior
                  else None)

    @torch.no_grad()
    def run(clips: torch.Tensor, raw_pitch_hz: torch.Tensor | None = None):
        mf = mfcc_feature_vectors(
            clips, ckpt_sr, n_mfcc=mfcc_params["N_MFCC"],
            normalize_audio_volume=mfcc_params["NORMALIZE_AUDIO_VOLUME"],
            add_pitch_features=mfcc_params["ADD_PITCH_FEATURES"],
            raw_pitch_hz=raw_pitch_hz)
        if scaler is not None:
            mf = scaler.transform(mf)
        ms = None
        if use_cnn:
            ms = melspec_features(
                clips, ckpt_sr, n_mels=melspec_params["N_MELS"],
                n_fft=melspec_params["N_FFT"],
                hop_length=melspec_params["HOP_LENGTH"],
                normalize_audio_volume=melspec_params[
                    "NORMALIZE_AUDIO_VOLUME"],
                # checkpoint-embedded TO_DB wins (absent key = legacy
                # checkpoint, dB on)
                to_db=bool(melspec_params.get("TO_DB", True)))
        probs, mlp_probs, cnn_probs = predictor.ensemble_probs(mf, ms)
        if use_prior:
            hz = raw_pitch_hz if raw_pitch_hz is not None else yin_pitch(
                clips, ckpt_sr)
            probs = apply_pitch_prior(probs, hz, class_midi,
                                      weight=predictor.pitch_prior_weight,
                                      sigma=predictor.pitch_prior_sigma)
        return probs, mlp_probs, cnn_probs

    return run
