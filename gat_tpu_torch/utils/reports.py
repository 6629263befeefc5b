"""Data sanity reports, the twins of `gat_tpu/utils/reports.py`: JSON
reports over a dataset's durations and sample rates and over a feature
matrix's statistics (NaN and Inf fractions, ranges, per-class counts,
scaler params), printed and optionally written to disk."""
from __future__ import annotations

import json
import os

import numpy as np
import torch

__all__ = ["audio_report", "feature_report"]


def audio_report(audio_loader, y_encoded=None, reverse_map=None,
                 sample_paths: bool = False,
                 example_limit_per_class: int = 3,
                 print_report: bool = True) -> dict:
    """Duration and sample-rate statistics over a loader's dataset, read
    unpadded (`pad_to_max=False`) so the durations are the real ones.
    `unique_srs` are the files' source rates, which the loader records
    (its returned rates are all its target rate)."""
    report: dict = {}
    wavs, srs, labels, paths = audio_loader.load_audio_dataset(
        pad_to_max=False)
    if wavs:
        # time is the last axis (channels-first when not mono)
        lengths = [int(w.shape[-1]) / sr for w, sr in zip(wavs, srs)]
        report["target_sr"] = audio_loader.target_sr
        report["duration_min"] = float(np.min(lengths))
        report["duration_mean"] = float(np.mean(lengths))
        report["duration_max"] = float(np.max(lengths))
        src = getattr(audio_loader, "source_srs", None) or srs
        report["unique_srs"] = sorted({int(s) for s in src})
    else:
        report.update(target_sr=audio_loader.target_sr, duration_min=None,
                      duration_mean=None, duration_max=None, unique_srs=[])

    if sample_paths and y_encoded is not None and reverse_map is not None:
        report["example_paths"] = {}
        for c in np.unique(y_encoded):
            idxs = np.flatnonzero(np.asarray(y_encoded) == c)
            idxs = idxs[:example_limit_per_class]
            report["example_paths"][reverse_map[int(c)]] = \
                [paths[i] for i in idxs]

    if print_report:
        print("--- Audio Data Report ---")
        print(json.dumps(report, indent=4, sort_keys=True))
    return report


def feature_report(X, y_encoded, reverse_map=None, scaler=None,
                   out_root=None, out_filename=None,
                   print_report: bool = True) -> dict:
    """Feature matrix statistics (numpy or a tensor on any device):
    shapes, NaN and Inf fractions, NaN-ignoring min, max, mean and std,
    per-class counts, and the scaler's params."""
    X_np = X.detach().cpu().numpy() if isinstance(X, torch.Tensor) \
        else np.asarray(X)
    report: dict = {
        "n_samples": int(X_np.shape[0]),
        "feature_shape": list(X_np.shape[1:]),
        "num_features": int(np.prod(X_np.shape[1:])),
    }
    classes, counts = np.unique(np.asarray(y_encoded), return_counts=True)
    report["num_classes"] = int(len(classes))
    if reverse_map is not None:
        report["per_class_counts"] = {
            reverse_map[int(c)]: int(n) for c, n in zip(classes, counts)}

    report["X_nan_frac"] = float(np.isnan(X_np).mean())
    report["X_inf_frac"] = float(np.isinf(X_np).mean())
    report["X_min"] = float(np.nanmin(X_np))
    report["X_max"] = float(np.nanmax(X_np))
    report["X_mean"] = float(np.nanmean(X_np))
    report["X_std"] = float(np.nanstd(X_np))

    if scaler is not None and getattr(scaler, "mean_", None) is not None:
        report["scaler_mean"] = np.asarray(scaler.mean_).tolist()
        report["scaler_scale"] = np.asarray(scaler.scale_).tolist()

    if out_root is not None and out_filename is not None:
        os.makedirs(out_root, exist_ok=True)
        with open(os.path.join(out_root, out_filename), "w") as f:
            json.dump(report, f, indent=2)

    if print_report:
        print("--- Feature Data Report (MFCC or Mel-spec) ---")
        print(json.dumps(report, indent=4, sort_keys=True))
    return report
