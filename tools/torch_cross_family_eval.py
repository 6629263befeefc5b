#!/usr/bin/env python
"""Generator-disjoint training and evaluation of the PyTorch port, the
twin of `tools/cross_family_eval.py`.

Trains each model family on ONE synthesizer family and scores it on the
others (train-on-KS → eval-on-additive/FM and the reverse), so the
accuracy claim is not circular in the synthesis engine. The FM family is
never trained on by any shipped checkpoint: it is the unseen-timbre
column everywhere.

Training is `gat_tpu_torch.train.TrainingManager(device=...)`; scoring
is the evaluation sets' features (the front-end kernels K1-K3 on the
card) through `ArrayDataLoader` and `Trainer.evaluate`. `--device cuda`
(the default) raises without a card; `--device cpu` runs the plain
PyTorch versions. The port's weight initialisation draws from a torch
generator, not from `jax.random`, so the trained accuracies are not the
JAX tool's; with the weights carried across, each family's features are
within 1e-3 of JAX's and each accuracy is identical
(tests/test_torch_tools.py).

Usage: python tools/torch_cross_family_eval.py [--variants 12] [--epochs 15]
       [--model cnn|mlp|all] [--device cuda|cpu] [--out report.json]
"""
import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

TRAIN_FAMILIES = ("ks", "additive")
EVAL_FAMILIES = ("ks", "additive", "fm")


def raw_features(model_kind: str, eval_dir: Path, target_sr: int,
                 device: str) -> tuple:
    """(X, y, reverse_map) of one evaluation set: the MLP's 65-dim MFCC
    vectors or the CNN's mel images, unscaled."""
    from gat_tpu_torch.config import MELSPEC_CONFIG, MFCC_CONFIG
    from gat_tpu_torch.data.loader import AudioDatasetLoader
    from gat_tpu_torch.features import FeatureBuilder

    loader = AudioDatasetLoader([eval_dir], target_sr=target_sr,
                                duration=0.5, device=device)
    builder = FeatureBuilder(device=device)
    if model_kind == "mlp":
        X, y, _, rmap = builder.extract_mfcc_features(
            loader, MFCC_CONFIG.N_MFCC, MFCC_CONFIG.NORMALIZE_AUDIO_VOLUME)
    else:
        X, y, _, rmap = builder.extract_melspec_features(
            loader, MELSPEC_CONFIG.N_MELS, MELSPEC_CONFIG.N_FFT,
            MELSPEC_CONFIG.HOP_LENGTH, MELSPEC_CONFIG.NORMALIZE_AUDIO_VOLUME)
    return X, y, rmap


def eval_loader(trainer, model_kind: str, raw: tuple):
    """The trainer's evaluation loader over one set's raw features: only
    the MLP's scaler transform is trainer-specific."""
    import numpy as np
    from gat_tpu_torch.train import ArrayDataLoader

    X, y, rmap = raw
    if rmap != trainer.reverse_map:
        raise ValueError("class maps diverged between train and eval "
                         "datasets")
    if model_kind == "mlp" and trainer.scaler is not None:
        X = np.asarray(trainer.scaler.transform(X))
    return ArrayDataLoader(X, y, 256, shuffle=False)


def score(trainer, model_kind: str, raws: dict) -> dict:
    """{family: accuracy rounded to 4 places} of one trained model."""
    row = {}
    for fam in EVAL_FAMILIES:
        acc, _ = trainer.evaluate(eval_loader(trainer, model_kind,
                                              raws[fam]))
        row[fam] = round(float(acc), 4)
    return row


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", type=int, default=12)
    ap.add_argument("--eval_variants", type=int, default=6)
    ap.add_argument("--epochs", type=int, default=15)
    ap.add_argument("--model", default="all", choices=["cnn", "mlp", "all"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (the default) needs a card and raises "
                         "without one; cpu runs the plain PyTorch path")
    ap.add_argument("--train_seed", type=int, default=42)
    ap.add_argument("--eval_seed", type=int, default=777)
    ap.add_argument("--target_sr", type=int, default=11025)
    ap.add_argument("--out", type=Path, default=None)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from gat_tpu_torch.data.synth import synthesize_note_dataset
    from gat_tpu_torch.train import TrainingManager
    from gat_tpu_torch.utils.device import resolve_device

    resolve_device(args.device)  # no card: raise before any synthesis
    tmp = Path(tempfile.mkdtemp())
    models = ["cnn", "mlp"] if args.model == "all" else [args.model]
    t0 = time.time()

    # one eval set per family, shared across all trained models
    eval_dirs = {fam: synthesize_note_dataset(
        tmp / f"eval_{fam}", family=fam,
        variants_per_class=args.eval_variants, seed=args.eval_seed,
        verbose=False) for fam in EVAL_FAMILIES}
    # one training set per family, shared by both model kinds
    train_dirs = {fam: synthesize_note_dataset(
        tmp / f"train_{fam}", family=fam,
        variants_per_class=args.variants, seed=args.train_seed,
        verbose=False) for fam in TRAIN_FAMILIES}

    report = {"variants": args.variants, "epochs": args.epochs,
              "eval_seed": args.eval_seed, "results": {}}
    for model_kind in models:
        # raw features once per (model kind, family)
        raws = {fam: raw_features(model_kind, eval_dirs[fam],
                                  args.target_sr, args.device)
                for fam in EVAL_FAMILIES}
        for train_fam in TRAIN_FAMILIES:
            mgr = TrainingManager(target_sr=args.target_sr,
                                  device=args.device)
            train = (mgr.train_cnn if model_kind == "cnn"
                     else mgr.train_mlp)
            trainer = train(dataset=train_dirs[train_fam],
                            epochs=args.epochs, seed=args.train_seed,
                            save=False, verbose=False)
            row = score(trainer, model_kind, raws)
            key = f"{model_kind}_trained_on_{train_fam}"
            report["results"][key] = row
            print(f"[cross_family] {key}: " + "  ".join(
                f"{f}={row[f]:.4f}" for f in EVAL_FAMILIES))

    report["wall_s"] = round(time.time() - t0, 1)
    print(json.dumps(report, indent=2))
    if args.out:
        args.out.write_text(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
