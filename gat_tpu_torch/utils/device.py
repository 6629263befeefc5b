"""Device selection of the port's entry points (the card unless the caller
asks for the CPU, and never the CPU on its own), and the one way results
come back to the host."""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["fp32_reference_math", "resolve_device", "tf32_off", "to_host"]

_TF32_LOCK = threading.RLock()


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


def fp32_reference_math() -> None:
    """The reference is fp32. cuDNN's default TF32 on the CNN's
    convolutions would keep about three decimal digits, so TF32 is off for
    both matmuls and convolutions wherever the models run (inference and
    training alike)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def tf32_off(device: torch.device, convolutions: bool = False):
    """TF32 off on the card for the matmuls inside (and cuDNN's
    convolutions with `convolutions`), the caller's settings back on exit.

    PyTorch has no per-call control: the flags are process-global, so
    while the block runs another thread's matmuls run without TF32 too.
    The block holds a lock, so two threads inside never restore each
    other's flags. The port's entry points keep TF32 off anyway
    (`fp32_reference_math`), and then this changes nothing. Nothing is
    touched for the CPU."""
    if device.type != "cuda":
        yield
        return
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    with _TF32_LOCK:
        saved = matmul.allow_tf32, cudnn.allow_tf32
        matmul.allow_tf32 = False
        if convolutions:
            cudnn.allow_tf32 = False
        try:
            yield
        finally:
            matmul.allow_tf32, cudnn.allow_tf32 = saved


def to_host(outs: tuple) -> tuple:
    """Every tensor of `outs` on the host after one synchronisation of
    the device (a bool() or .item() per flag would each wait).

    It waits on the calling thread's current stream, which is the
    default stream in every thread that sets none: two threads serving
    waves on one Transcriber enqueue on that one stream, so the wait
    covers all of this thread's work, and each thread reads only its own
    outputs."""
    host = tuple(None if x is None else x.to("cpu", non_blocking=True)
                 for x in outs)
    if any(x is not None and x.is_cuda for x in outs):
        torch.cuda.current_stream().synchronize()
    return tuple(None if x is None else x.numpy() for x in host)
