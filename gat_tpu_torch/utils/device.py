"""Device selection of the port's entry points: the card unless the caller
asks for the CPU, and never the CPU on its own."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """None → 'cuda'. Raises when CUDA is asked for and no card is
    visible, instead of running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "[gat_tpu_torch] CUDA device requested but torch.cuda is not "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"[gat_tpu_torch] unsupported device {dev}")
    return dev
