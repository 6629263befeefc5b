"""The reference's calling forms at the port's batched segmentation
functions: one signal (n,) beside a batch (B, n), and the reference's
keyword names beside the port's."""
from __future__ import annotations

import torch

__all__ = ["either", "as_rows", "as_count_rows"]


def either(func: str, ref_name: str, ref_value, port_name: str,
           port_value):
    """The value of whichever of the reference's keyword and the port's
    was given (None when neither was); raises when both were."""
    if ref_value is not None and port_value is not None:
        raise TypeError(f"[{func}] pass {ref_name} or {port_name}, not both")
    return port_value if port_value is not None else ref_value


def as_rows(y: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """(a batch of rows, whether `y` was one signal): one signal (n,)
    becomes the batch of one (1, n); a batch (B, n) is kept."""
    if y.ndim == 1:
        return y[None], True
    if y.ndim != 2:
        raise ValueError(f"[gat_tpu_torch] signals are (n,) or (B, n), got "
                         f"{tuple(y.shape)}")
    return y, False


def as_count_rows(n, one: bool, device) -> torch.Tensor | None:
    """Per-row counts: a batch's (B,) counts as they are, one signal's
    count (an int or a 0-d tensor) as a (1,) tensor on `device`; None
    stays None."""
    if n is None or not one:
        return n
    return torch.as_tensor(n, device=device).reshape(1)
