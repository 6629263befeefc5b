"""Reader of the `.gtckpt.npz` checkpoint schema.

A checkpoint is one npz file: a `__meta__` entry holding a JSON header
(config, model init args, label map, histories) and one array per
`/`-joined keypath of the array-bearing subtrees (`variables`, `scaler`,
`opt_state`). JSON turns the integer keys of `reverse_map` into strings;
the reader turns them back. Reference `.ckpt` files (torch zip archives)
are not read here yet.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

__all__ = ["load_checkpoint", "unflatten_tree"]

_SEP = "/"


def unflatten_tree(flat: dict[str, np.ndarray]) -> dict:
    """{'a/b/c': x} → {'a': {'b': {'c': x}}}."""
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def load_checkpoint(path) -> dict:
    """Read a native `.gtckpt.npz` checkpoint into a dict of header fields
    and numpy array trees."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"[load_checkpoint] No file named: {path}")
    with np.load(path, allow_pickle=False) as z:
        if "__meta__" not in z.files:
            raise NotImplementedError(
                f"[load_checkpoint] {path} has no __meta__ header; reference "
                "torch .ckpt files are not read by the PyTorch port yet")
        header = json.loads(str(z["__meta__"]))
        flat = {k: z[k] for k in z.files if k != "__meta__"}
    ckpt = dict(header)
    ckpt.update(unflatten_tree(flat))
    if isinstance(ckpt.get("reverse_map"), dict):
        ckpt["reverse_map"] = {int(k): v
                               for k, v in ckpt["reverse_map"].items()}
    return ckpt
