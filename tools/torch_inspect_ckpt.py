#!/usr/bin/env python
"""Checkpoint inspector of the PyTorch port, the twin of
`tools/inspect_ckpt.py`: print a `.gtckpt.npz` checkpoint's
self-describing schema without loading any model.

Meta, embedded config, model init args, class/label map summary,
training histories and the optimizer-state fingerprint that guards
resume compatibility, read with `gat_tpu_torch.train.checkpoint`. Host
only: no device is touched.

Usage:
    python tools/torch_inspect_ckpt.py data/checkpoints/mlp/mlp_synth_v1.0.0.gtckpt.npz
    python tools/torch_inspect_ckpt.py --histories path.gtckpt.npz   # full curves
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def summarize(path: Path, histories: bool = False) -> dict:
    import numpy as np
    from gat_tpu_torch.train.checkpoint import flatten_tree, load_checkpoint

    ckpt = load_checkpoint(path)
    n_params = int(sum(
        np.asarray(v).size
        for v in flatten_tree(ckpt.get("variables", {}) or {}).values()))
    info = {
        "path": str(path),
        "meta": ckpt.get("meta", {}),
        "config": ckpt.get("config", {}),
        "model_init_args": ckpt.get("model_init_args", {}),
        "num_classes": ckpt.get("num_classes"),
        "n_params": n_params,
        "epoch": ckpt.get("epoch"),
        "has_opt_state": "opt_state" in ckpt,
        "opt_state_fingerprint": ckpt.get("opt_state_fingerprint"),
        "has_scaler": "scaler" in ckpt,
    }
    names = ckpt.get("class_names") or list(
        (ckpt.get("reverse_map") or {}).values())
    if names:
        info["classes"] = f"{len(names)}: {names[0]} … {names[-1]}"
    for k in ("train_loss_history", "train_accuracy_history",
              "val_loss_history", "val_accuracy_history"):
        h = ckpt.get(k)
        if h:
            info[k] = [round(float(x), 5) for x in h] if histories \
                else f"{len(h)} epochs, final {float(h[-1]):.5f}"
    return info


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt", type=Path, nargs="+")
    ap.add_argument("--histories", action="store_true",
                    help="print full per-epoch curves, not just finals")
    args = ap.parse_args(argv)
    for p in args.ckpt:
        info = summarize(p, histories=args.histories)
        print(f"== {p}")
        for k, v in info.items():
            if k == "path":
                continue
            print(f"  {k}: {v}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
