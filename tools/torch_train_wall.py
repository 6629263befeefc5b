#!/usr/bin/env python
"""End-to-end wall-clock of the shipped training recipe on the PyTorch
port, the twin of `tools/train_wall.py`.

Times synth -> load -> features -> epochs for BOTH models: the shipped
recipe of `python -m gat_tpu_torch.train.synthetic --model all --noise
--variants 48 --family all3 --stressor_prob 0.5 --channel_prob 0.25`
(all3 families, mixed stressors + channel augmentation), reproduced
inline below, in a temporary dataset directory and with save=False, so
no checkpoint is written anywhere. `run(variants, cnn_epochs,
mlp_epochs)` takes the recipe's scale as parameters (defaults: the
recipe's 48 variants, CNN 40 epochs, MLP 20); the command line runs the
recipe. Measured numbers: PERF.md §5 ("Training").

Usage: python tools/torch_train_wall.py [--device cuda|cpu]
"""
import argparse
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def run(variants: int = 48, cnn_epochs: int = 40, mlp_epochs: int = 20,
        device: str = "cuda") -> dict:
    """The recipe at `variants` per class; prints the WALL lines and
    returns their seconds and val accuracies."""
    from gat_tpu_torch.data.synth import synthesize_note_dataset
    from gat_tpu_torch.train import TrainingManager

    mgr = TrainingManager(target_sr=11025, device=device)
    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="train_wall_") as tmp:
        ds = Path(tmp) / "all3_shipped"

        t0 = time.perf_counter()
        synthesize_note_dataset(ds, variants_per_class=variants, seed=42,
                                noise_snr_db=(8.0, 40.0), family="all3",
                                stressor="mix", stressor_prob=0.5,
                                channel="mix", channel_prob=0.25)
        out["synth_s"] = time.perf_counter() - t0
        print(f"WALL synth: {out['synth_s']:.1f}s", flush=True)

        for family, train, epochs in (("cnn", mgr.train_cnn, cnn_epochs),
                                      ("mlp", mgr.train_mlp, mlp_epochs)):
            t1 = time.perf_counter()
            tr = train(dataset=ds, epochs=epochs, seed=42, save=False)
            out[f"{family}_s"] = time.perf_counter() - t1
            acc, _ = tr.evaluate(report=False)
            out[f"{family}_val_acc"] = acc
            out[f"{family}_epochs"] = tr.epoch
            out[f"{family}_stages_s"] = dict(tr.stage_seconds)
            print(f"WALL {family}: {out[f'{family}_s']:.1f}s val_acc "
                  f"{acc:.4f}", flush=True)

    out["total_s"] = out["synth_s"] + out["cnn_s"] + out["mlp_s"]
    print(f"WALL total: {out['total_s']:.1f}s", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (the default) needs a card and raises "
                         "without one; cpu runs the plain PyTorch path")
    args = ap.parse_args(argv)
    return run(device=args.device)


if __name__ == "__main__":
    main()
