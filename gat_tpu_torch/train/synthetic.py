"""Generate the synthetic 47-class note dataset and train the models on
it, the twin of `tools/train_synthetic.py`:

    python -m gat_tpu_torch.train.synthetic [--model cnn|mlp|all]
        [--epochs N] [--variants N] [--noise] [--family all3]
        [--stressor_prob P] [--channel_prob P] [--device cpu]

The shipped checkpoints' recipe is `--model all --noise --variants 48
--family all3 --stressor_prob 0.5 --channel_prob 0.25`. The dataset is
written under `DATASETS_ROOT/synthetic/<tag>` (reused when it exists),
the checkpoints under the port's own root, data/checkpoints/torch/
<family>/: the exact shipped recipe takes the shipped file names there,
any other recipe a recipe-tagged name. Without `--device` it runs on the
card. The CNN trains first (40 epochs by default), then the MLP (20).
`--mesh N` trains data-parallel over N ranks (`torchrun --nproc-per-node
N -m gat_tpu_torch.train.synthetic --mesh N ...`, or N ranks started
here), with the single-device run's results.
"""
from __future__ import annotations

import argparse
import time

__all__ = ["main"]


def _dataset_tag(args) -> str:
    return (f"ks47_v{args.variants}" + ("_noisy" if args.noise else "")
            + (f"_str{args.stressor_prob:g}" if args.stressor_prob > 0
               else "")
            + (f"_{args.family}" if args.family != "mixed" else "")
            + ((f"_ch{args.channel_prob:g}" if args.channel_draw == "mix"
                else f"_chc{args.channel_prob:g}")
               if args.channel_prob > 0 else "")
            # the seed is part of the dataset's identity
            + (f"_s{args.seed}" if args.seed != 42 else ""))


def _is_canonical(args) -> bool:
    """The exact shipped recipe, the only one that takes the shipped
    file names."""
    return (args.noise and args.variants == 48 and args.seed == 42
            and args.family == "all3" and args.stressor_prob == 0.5
            and args.channel_prob == 0.25 and args.channel_draw == "mix"
            and args.epochs is None and args.target_sr == 11025)


def _recipe_name(args, prefix: str) -> str:
    return (f"{prefix}_{'noisy' if args.noise else 'clean'}"
            f"_v{args.variants}_s{args.seed}"
            + (f"_e{args.epochs}" if args.epochs is not None else "")
            + (f"_sr{args.target_sr}" if args.target_sr != 11025 else "")
            + (f"_str{args.stressor_prob:g}" if args.stressor_prob > 0
               else "")
            + (f"_{args.family}" if args.family != "mixed" else "")
            + ((f"_ch{args.channel_prob:g}" if args.channel_draw == "mix"
                else f"_chc{args.channel_prob:g}")
               if args.channel_prob > 0 else "")
            + ".gtckpt.npz")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="cnn", choices=["cnn", "mlp", "all"])
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--variants", type=int, default=40)
    ap.add_argument("--noise", action="store_true",
                    help="noise-augment half the variants (SNR 8-40 dB)")
    ap.add_argument("--stressor_prob", type=float, default=0.0,
                    help="apply a random playing-style stressor (vibrato/"
                         "bend/detune/tremolo) to this fraction of variants")
    ap.add_argument("--family", default="mixed",
                    choices=["mixed", "ks", "additive", "fm", "all3"],
                    help="synthesis families in the training set; all3 = "
                         "one third each KS/FM/additive (the shipped "
                         "recipe)")
    ap.add_argument("--channel_prob", type=float, default=0.0,
                    help="apply a random acquisition-channel stressor "
                         "(room IR / pickup EQ / background noise) to this "
                         "fraction of variants")
    ap.add_argument("--channel_draw", default="mix",
                    choices=["mix", "mix_chain"],
                    help="channel-augmentation draw: single stressors (mix, "
                         "the shipped recipe) or including the full "
                         "pickup->room->noise chain (mix_chain)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--target_sr", type=int, default=11025)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="train data-parallel over N ranks, one per device "
                         "(Trainer(mesh=)): under torchrun it joins the "
                         "world torchrun started, otherwise it starts N "
                         "ranks itself; on the card at most one per card")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the recipe; returns the wall seconds of each stage and each
    family's epochs and final val accuracy and loss (rank 0's under
    `--mesh`)."""
    args = parse_args(argv)
    if not args.mesh:
        return _run(args)
    from ..parallel import launch
    device = args.device or "cuda"
    if launch.under_torchrun():
        launch.init_from_env(device)
        return _run(args)
    return launch.spawn(_run, args.mesh, args, device=device,
                        timeout_s=None)[0]


def _run(args) -> dict:
    from ..config import DATASETS_ROOT
    from ..data.synth import synthesize_note_dataset
    from .manager import TrainingManager

    rank = 0
    if args.mesh:
        import torch.distributed as dist
        rank = dist.get_rank()
    mgr = TrainingManager(target_sr=args.target_sr, device=args.device,
                          mesh_devices=args.mesh)
    if rank == 0:
        print("device:", mgr.device, f"(mesh of {args.mesh})" if args.mesh
              else "")
    out: dict = {"synthesis_s": 0.0}
    ds = DATASETS_ROOT / "synthetic" / _dataset_tag(args)
    if rank == 0 and not ds.exists():
        t0 = time.time()
        synthesize_note_dataset(
            ds, variants_per_class=args.variants, seed=args.seed,
            noise_snr_db=(8.0, 40.0) if args.noise else None,
            family=args.family,
            stressor="mix" if args.stressor_prob > 0 else None,
            stressor_prob=args.stressor_prob,
            channel=args.channel_draw if args.channel_prob > 0 else None,
            channel_prob=args.channel_prob)
        out["synthesis_s"] = time.time() - t0
        print(f"dataset synthesis: {out['synthesis_s']:.1f}s")
    if args.mesh:  # the other ranks read what rank 0 wrote
        dist.barrier()

    canonical = _is_canonical(args)
    runs = []
    if args.model in ("cnn", "all"):
        runs.append(("cnn", mgr.train_cnn, args.epochs or 40,
                     None if canonical else _recipe_name(args, "cnn")))
    if args.model in ("mlp", "all"):
        # the canonical MLP name is mlp_synth_*, as the shipped file's
        runs.append(("mlp", mgr.train_mlp, args.epochs or 20,
                     "mlp_synth_v1.0.0.gtckpt.npz" if canonical
                     else _recipe_name(args, "mlp_synth")))
    for family, train, epochs, fname in runs:
        t0 = time.time()
        tr = train(dataset=ds, epochs=epochs, seed=args.seed, save=False,
                   verbose=rank == 0)
        acc, loss = tr.evaluate(report=rank == 0)
        if rank == 0:
            print(f"{family.upper()} final: val acc {acc:.4f}, val loss "
                  f"{loss:.4f}")
        path = tr.save(filename=fname, target_sr=args.target_sr)
        out[family] = {"wall_s": time.time() - t0, **tr.stage_seconds,
                       "epochs": tr.epoch, "val_acc": acc,
                       "val_loss": loss, "path": str(path)}
    return out


if __name__ == "__main__":
    print(main())
