#!/usr/bin/env python
"""Shim of the port's synthetic-dataset trainer, the twin of
`tools/train_synthetic.py`: generate the synthetic 47-class note dataset
and train the models through `gat_tpu_torch.train.synthetic.main` (its
arguments, on the card unless `--device cpu` is given). The shipped
recipe:

    python tools/torch_train_synthetic.py --model all --noise --variants 48 \\
        --family all3 --stressor_prob 0.5 --channel_prob 0.25

Checkpoints go under data/checkpoints/torch/<family>/. `--mesh N`
trains data-parallel over N ranks, one per card (or `--device cpu`),
under torchrun or started here.
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from gat_tpu_torch.train.synthetic import main  # noqa: E402

if __name__ == "__main__":
    print(main())
