"""Ensemble note predictor: weighted MLP + CNN softmax voting, the twin of
`gat_tpu/infer/predictor.py`.

Models are rebuilt from each checkpoint's `model_init_args`, their
weights carried over from the flax variables by `params_from_flax`, and
the prediction blends the softmax probabilities 0.2·MLP + 0.8·CNN before
the argmax → `reverse_map` label. `apply_pitch_prior`, off by default,
mixes a Gaussian over semitone distance from the YIN pitch into the
blend. Every call reads the blend weight, the prior's weight and sigma,
the label map and the models as they are then, so a change after
construction takes effect at the next call, as in the reference.
`predict_debug` sweeps blend weights from one forward.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models import cnn as cnn_mod
from ..models import mlp as mlp_mod
from ..ops.pitch import note_to_midi
from ..utils.device import fp32_reference_math, resolve_device, to_host
from ..utils.profiling import annotate

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


class NotePredictor:
    def __init__(self, cnn_weight: float = 0.80,
                 pitch_prior_weight: float = 0.0,
                 pitch_prior_sigma: float = 0.5,
                 cnn_dtype: torch.dtype | None = None, device=None):
        """`cnn_dtype` (e.g. torch.bfloat16) is the CNN's compute type;
        its weights stay float32 (models/cnn.py)."""
        self.device = resolve_device(device)
        self.mlp: mlp_mod.MLP | None = None
        self.cnn: cnn_mod.CNN | None = None
        self.reverse_map: dict[int, str] | None = None
        self.cnn_weight = cnn_weight
        self.pitch_prior_weight = pitch_prior_weight
        self.pitch_prior_sigma = pitch_prior_sigma
        self.cnn_dtype = cnn_dtype
        self._class_midi: tuple | None = None  # (label map items, tensor)

    @property
    def mlp_weight(self) -> float:
        """The MLP's share of the blend, always 1 - `cnn_weight`."""
        return 1.0 - self.cnn_weight

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
            args = dict(cnn_ckpt_data["model_init_args"])
            if self.cnn_dtype is not None:
                args["dtype"] = self.cnn_dtype
            self.cnn = self._build(cnn_mod.CNN, cnn_mod.params_from_flax,
                                   args, cnn_ckpt_data["variables"])
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
    def _class_midi_table(self) -> torch.Tensor:
        """(C,) MIDI per class on the device, cached per label map."""
        key = tuple(sorted(self.reverse_map.items()))
        if self._class_midi is None or self._class_midi[0] != key:
            self._class_midi = (key, torch.from_numpy(class_midi_values(
                self.reverse_map)).to(self.device))
        return self._class_midi[1]

    @staticmethod
    def _to_nhwc(x: torch.Tensor) -> torch.Tensor:
        """The mel features as NHWC (N, M, T, 1), from that layout or the
        reference's NCHW (N, 1, M, T)."""
        if x.ndim != 4:
            raise ValueError(f"[predict] melspec must be 4-D, got "
                             f"{tuple(x.shape)}")
        if x.shape[1] == 1 and x.shape[-1] != 1:
            return x.permute(0, 2, 3, 1)
        return x

    @torch.no_grad()
    def ensemble_probs(self, mfcc_features=None, melspec_features=None,
                       cnn_weight: float | None = None, pitch_hz=None):
        """(blended, mlp_probs, cnn_probs) on the predictor's device; a
        missing model's probs are None. The mel features are NHWC (N,
        n_mels, T, 1) or NCHW (N, 1, n_mels, T). `cnn_weight` overrides
        the predictor's blend weight for this call. With `pitch_hz` (N,)
        given, a prior weight > 0 and a label map, the pitch prior is
        mixed into the blend."""
        has_mlp = mfcc_features is not None
        has_cnn = melspec_features is not None
        if has_mlp and self.mlp is None:
            raise RuntimeError("[predict] MLP not loaded")
        if has_cnn and self.cnn is None:
            raise RuntimeError("[predict] CNN not loaded")
        if not has_mlp and not has_cnn:
            raise ValueError("[predict] Must provide either mfcc_features "
                             "or melspec_features")
        fp32_reference_math()
        mlp_probs = cnn_probs = None
        if has_mlp:
            x = torch.as_tensor(mfcc_features, dtype=torch.float32,
                                device=self.device)
            with annotate("mlp_forward"):
                mlp_probs = torch.softmax(self.mlp(x), dim=-1)
        if has_cnn:
            x = torch.as_tensor(melspec_features, dtype=torch.float32,
                                device=self.device)
            with annotate("cnn_forward"):
                cnn_probs = torch.softmax(self.cnn(self._to_nhwc(x)),
                                          dim=-1)
        if has_mlp and has_cnn:
            w = self.cnn_weight if cnn_weight is None else cnn_weight
            probs = (1.0 - w) * mlp_probs + w * cnn_probs
        else:
            probs = cnn_probs if has_cnn else mlp_probs
        if (pitch_hz is not None and self.pitch_prior_weight > 0
                and self.reverse_map):
            probs = apply_pitch_prior(
                probs, torch.as_tensor(pitch_hz, device=self.device),
                self._class_midi_table(), weight=self.pitch_prior_weight,
                sigma=self.pitch_prior_sigma)
        return probs, mlp_probs, cnn_probs

    # ----- public prediction API -----------------------------------------
    def _result_dict(self, probs, mlp_probs, cnn_probs) -> dict:
        """indices, labels, confidences, blended probs and per-model probs,
        as numpy on the host (tensors or numpy arrays in); the tensors
        come over in one transfer."""
        parts = (probs, mlp_probs, cnn_probs)
        moved = to_host(tuple(x.detach() if isinstance(x, torch.Tensor)
                              else None for x in parts))
        probs, mlp_probs, cnn_probs = (x if m is None else m
                                       for x, m in zip(parts, moved))
        idx = probs.argmax(axis=1)
        labels = ([self.reverse_map[int(i)] for i in idx]
                  if self.reverse_map else [int(i) for i in idx])
        return {
            "indices": idx,
            "labels": labels,
            "confidences": probs[np.arange(len(idx)), idx],
            "probs": probs,
            "per_model_probs": {"mlp": mlp_probs, "cnn": cnn_probs},
        }

    def predict(self, mfcc_features=None, melspec_features=None,
                pitch_hz=None) -> dict:
        """Result dict of one ensemble forward on given features."""
        return self._result_dict(*self.ensemble_probs(
            mfcc_features, melspec_features, pitch_hz=pitch_hz))

    def predict_debug(self, test_weights, mfcc_features=None,
                      melspec_features=None) -> list:
        """[(w, result dict)] for each CNN blend weight w. The forwards
        run once; each weight re-blends the per-model probs on the host,
        and `cnn_weight` is left as it was."""
        probs, mlp_probs, cnn_probs = (
            None if x is None else x.cpu().numpy()
            for x in self.ensemble_probs(mfcc_features, melspec_features))
        out = []
        for w in test_weights:
            if mlp_probs is not None and cnn_probs is not None:
                blended = (1.0 - float(w)) * mlp_probs + float(w) * cnn_probs
            else:
                blended = probs  # one model: the weight has no effect
            pred = self._result_dict(blended, mlp_probs, cnn_probs)
            out.append((w, pred))
            print("weight: ", w)
            print(pred["labels"], pred["confidences"])
            print()
        return out
