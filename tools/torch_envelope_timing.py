#!/usr/bin/env python3
"""K4, the PyTorch port's onset-envelope kernel, checked and timed at the
file path's shapes for one checkout of the port, on one CUDA card.

    python3 tools/torch_envelope_timing.py TREE

TREE is the root of a checkout that holds `gat_tpu_torch/`: this one, or
another commit unpacked with `git archive`; its kernel is built there.
Shapes, inputs, checks and timings are `chip_smoke.py`'s own
(`time_envelope`: one 4 s file, 4 files of 4 s, 64 riffs of 8 s), so two
checkouts timed in turns within one run compare like with like. Prints
one JSON line per shape, then the card's name and power limit; exits 1
without a card or when a check fails. Imports nothing of JAX.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path


def main(argv: list[str]) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    tree = Path(argv[1]).resolve()
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch
    if not torch.cuda.is_available():
        print("torch_envelope_timing: torch.cuda is not available",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(tree))
    from gat_tpu_torch import kernels
    from gat_tpu_torch.ops import onset
    if not Path(onset.__file__).resolve().is_relative_to(tree):
        print(f"torch_envelope_timing: gat_tpu_torch came from "
              f"{onset.__file__}, not {tree}", file=sys.stderr)
        return 1
    kernels.build(["onset_envelope"])
    failures: list = []
    for row in smoke.time_envelope(onset, torch.device("cuda"), failures):
        print(json.dumps({"tree": str(tree), **row}), flush=True)
    print(smoke.card_line(), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
