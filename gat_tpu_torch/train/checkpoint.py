"""Reader and writer of the `.gtckpt.npz` checkpoint schema, which both
packages read and write.

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

__all__ = ["save_checkpoint", "load_checkpoint", "flatten_tree",
           "unflatten_tree"]

_SEP = "/"
_ARRAY_FIELDS = ("variables", "scaler", "opt_state")


def flatten_tree(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    """{'a': {'b': {'c': x}}} → {'a/b/c': np.asarray(x)}."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}{_SEP}{k}" if prefix else str(k)
        if isinstance(v, dict):
            flat.update(flatten_tree(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


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


def save_checkpoint(path, ckpt: dict) -> Path:
    """Write a checkpoint dict: the array subtrees (variables, scaler,
    opt_state) as npz entries, everything else in the JSON header.
    Returns the path written: np.savez appends '.npz' to any other
    suffix, so the name is normalized first."""
    path = Path(path)
    if path.suffix != ".npz":
        path = path.with_name(path.name + ".npz")
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays: dict[str, np.ndarray] = {}
    header: dict = {}
    for k, v in ckpt.items():
        if k in _ARRAY_FIELDS and v is not None:
            arrays.update(flatten_tree({k: v}))
        else:
            header[k] = v
    payload = {"__meta__": json.dumps(header, default=str)}
    payload.update(arrays)
    np.savez_compressed(path, **payload)
    print(f"[save_checkpoint] Checkpoint saved to {path}")
    return path


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
