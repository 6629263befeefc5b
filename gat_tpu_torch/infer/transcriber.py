"""Transcriber: the array-level inference API of the port, the twin of
`gat_tpu/infer/transcriber.py` for clips already cut and at the
checkpoint rate. Checkpoints are the source of truth: feature params,
scaler, target rate and clip length all come from their embedded config.
The file-level paths (slicing, resampling) are not ported yet.
"""
from __future__ import annotations

from pathlib import Path

import torch

from ..config import CLIP_DURATION, CNN_CONFIG, MLP_CONFIG
from ..ops.yin import estimate_note, yin_pitch
from ..train.checkpoint import load_checkpoint
from ..utils.scaler import FeatureScaler
from .pipeline import build_clip_ensemble_fn
from .predictor import NotePredictor

__all__ = ["Transcriber"]


class Transcriber:
    def __init__(self, mlp_ckpt=None, cnn_ckpt=None, mlp_root=None,
                 cnn_root=None, require_cnn: bool = True,
                 pitch_prior_weight: float = 0.0,
                 use_cnn: bool = True, device=None):
        """Resolve and load both checkpoints, check that their embedded
        configs agree, and build the ensemble on `device` (default the
        card; 'cpu' runs the plain PyTorch path). `require_cnn=False`
        permits MLP-only operation when the CNN checkpoint is missing;
        `use_cnn=False` skips the CNN altogether."""
        self.predictor = NotePredictor(pitch_prior_weight=pitch_prior_weight,
                                       device=device)
        self.device = self.predictor.device

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
        mfcc_params = self.model_configs["mlp"]["features"]["params"]
        cnn_cfg = self.model_configs.get("cnn")
        melspec_params = cnn_cfg["features"]["params"] if cnn_cfg else None
        # clips → (probs, mlp_probs, cnn_probs), shared with entry.entry
        self.ensemble = build_clip_ensemble_fn(
            self.predictor, self.scaler, self.ckpt_sr, mfcc_params,
            melspec_params)

    @torch.no_grad()
    def transcribe_clips(self, clips_ckpt_sr) -> dict:
        """Clips at the checkpoint rate, (N, L) numpy or tensor →
        prediction dict plus the YIN baseline per clip (`dsp_info`).
        The pitch feature and the baseline both read the raw clips, so
        YIN runs once and serves both."""
        clips = torch.as_tensor(clips_ckpt_sr, dtype=torch.float32,
                                device=self.device).contiguous()
        pitch = yin_pitch(clips, self.ckpt_sr)
        probs, mlp_p, cnn_p = self.ensemble(clips, raw_pitch_hz=pitch)
        result = self.predictor._result_dict(probs, mlp_p, cnn_p)
        result["dsp_info"] = []
        for hz in pitch.cpu().numpy():
            midi, name, midi_f = estimate_note(float(hz))
            result["dsp_info"].append((float(hz), {
                "midi": midi, "note_name": name, "midi_float": midi_f}))
        return result
