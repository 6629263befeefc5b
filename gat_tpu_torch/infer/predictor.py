"""Ensemble note predictor: weighted MLP + CNN softmax voting, the twin of
`gat_tpu/infer/predictor.py`.

Models are rebuilt from each checkpoint's `model_init_args`, their
weights carried over from the flax variables by `params_from_flax`, and
the prediction blends the softmax probabilities 0.2·MLP + 0.8·CNN before
the argmax → `reverse_map` label. `apply_pitch_prior`, off by default
and applied by the pipeline, mixes a Gaussian over semitone distance from
the YIN pitch into the blend.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models import cnn as cnn_mod
from ..models import mlp as mlp_mod
from ..ops.pitch import note_to_midi
from ..utils.device import resolve_device

__all__ = ["NotePredictor", "class_midi_values", "apply_pitch_prior"]


def class_midi_values(reverse_map: dict[int, str]) -> np.ndarray:
    """(C,) MIDI number per class index, from the SPN label map."""
    return np.asarray([float(note_to_midi(reverse_map[i]))
                       for i in range(len(reverse_map))], np.float32)


def apply_pitch_prior(probs: torch.Tensor, pitch_hz: torch.Tensor,
                      class_midi: np.ndarray, weight: float = 0.4,
                      sigma: float = 0.5) -> torch.Tensor:
    """(1-w)·probs + w·softmax(-(Δsemitones)²/(2σ²)); clips whose pitch is
    not finite and positive keep their probs."""
    hz = pitch_hz.to(torch.float32)
    valid = torch.isfinite(hz) & (hz > 0)
    midi_f = 12.0 * torch.log2(torch.where(valid, hz, 440.0) / 440.0) + 69.0
    d = midi_f[..., None] - torch.as_tensor(class_midi, device=hz.device)
    p_yin = torch.softmax(-0.5 * (d / sigma) ** 2, dim=-1)
    post = (1.0 - weight) * probs + weight * p_yin
    return torch.where(valid[..., None], post, probs)


def _fp32_reference_math() -> None:
    """The reference is fp32. cuDNN's default TF32 on the CNN's
    convolutions would keep about three decimal digits, so TF32 is off for
    both matmuls and convolutions wherever the models run."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class NotePredictor:
    def __init__(self, cnn_weight: float = 0.80,
                 pitch_prior_weight: float = 0.0,
                 pitch_prior_sigma: float = 0.5, device=None):
        self.device = resolve_device(device)
        self.mlp: mlp_mod.MLP | None = None
        self.cnn: cnn_mod.CNN | None = None
        self.reverse_map: dict[int, str] | None = None
        self.cnn_weight = cnn_weight
        self.pitch_prior_weight = pitch_prior_weight
        self.pitch_prior_sigma = pitch_prior_sigma

    # ----- loading -------------------------------------------------------
    def _build(self, module_cls, params_from_flax, args, variables):
        model = module_cls(**args)
        model.load_state_dict(params_from_flax(variables))
        return model.to(self.device).eval()

    def load_models(self, mlp_ckpt_data: dict | None = None,
                    cnn_ckpt_data: dict | None = None) -> None:
        """Build the models from checkpoint init args and variables. The
        two checkpoints must agree on the class label map: the ensemble
        adds the softmax vectors by position."""
        if mlp_ckpt_data is not None:
            if "variables" not in mlp_ckpt_data:
                raise KeyError(
                    "[load_models] MLP checkpoint missing 'variables' field")
            self.mlp = self._build(mlp_mod.MLP, mlp_mod.params_from_flax,
                                   dict(mlp_ckpt_data["model_init_args"]),
                                   mlp_ckpt_data["variables"])
            rm = mlp_ckpt_data.get("reverse_map")
            if self.reverse_map is None and rm is not None:
                self.reverse_map = {int(k): v for k, v in rm.items()}
        if cnn_ckpt_data is not None:
            if "variables" not in cnn_ckpt_data:
                raise KeyError(
                    "[load_models] CNN checkpoint missing 'variables' field")
            self.cnn = self._build(cnn_mod.CNN, cnn_mod.params_from_flax,
                                   dict(cnn_ckpt_data["model_init_args"]),
                                   cnn_ckpt_data["variables"])
            rm = cnn_ckpt_data.get("reverse_map")
            if rm is not None:
                rm = {int(k): v for k, v in rm.items()}
                if self.reverse_map is None:
                    self.reverse_map = rm
                elif rm != self.reverse_map:
                    raise ValueError(
                        "[load_models] MLP and CNN checkpoints disagree on "
                        "the class label map (reverse_map); these models "
                        "cannot be ensembled. MLP-only operation: "
                        "Transcriber(require_cnn=False) with no cnn_ckpt.")

    # ----- forward -------------------------------------------------------
    @torch.no_grad()
    def ensemble_probs(self, mfcc_features=None, melspec_features=None):
        """(blended, mlp_probs, cnn_probs) on the predictor's device; a
        missing model's probs are None. The mel features are NHWC
        (N, n_mels, T, 1). The pitch prior is applied by the pipeline."""
        has_mlp = mfcc_features is not None
        has_cnn = melspec_features is not None
        if has_mlp and self.mlp is None:
            raise RuntimeError("[predict] MLP not loaded")
        if has_cnn and self.cnn is None:
            raise RuntimeError("[predict] CNN not loaded")
        if not has_mlp and not has_cnn:
            raise ValueError("[predict] Must provide either mfcc_features "
                             "or melspec_features")
        _fp32_reference_math()
        mlp_probs = cnn_probs = None
        if has_mlp:
            x = torch.as_tensor(mfcc_features, dtype=torch.float32,
                                device=self.device)
            mlp_probs = torch.softmax(self.mlp(x), dim=-1)
        if has_cnn:
            x = torch.as_tensor(melspec_features, dtype=torch.float32,
                                device=self.device)
            cnn_probs = torch.softmax(self.cnn(x), dim=-1)
        if has_mlp and has_cnn:
            w = self.cnn_weight
            probs = (1.0 - w) * mlp_probs + w * cnn_probs
        else:
            probs = cnn_probs if has_cnn else mlp_probs
        return probs, mlp_probs, cnn_probs

    # ----- public prediction API -----------------------------------------
    def _result_dict(self, probs, mlp_probs, cnn_probs) -> dict:
        """indices, labels, confidences, blended probs and per-model probs,
        as numpy on the host."""
        def host(x):
            return None if x is None else x.detach().cpu().numpy()
        probs = host(probs)
        idx = probs.argmax(axis=1)
        labels = ([self.reverse_map[int(i)] for i in idx]
                  if self.reverse_map else [int(i) for i in idx])
        return {
            "indices": idx,
            "labels": labels,
            "confidences": probs[np.arange(len(idx)), idx],
            "probs": probs,
            "per_model_probs": {"mlp": host(mlp_probs),
                                "cnn": host(cnn_probs)},
        }

    def predict(self, mfcc_features=None, melspec_features=None) -> dict:
        """Result dict of one ensemble forward on given features."""
        return self._result_dict(*self.ensemble_probs(mfcc_features,
                                                      melspec_features))
