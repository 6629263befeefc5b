"""The label-smoothed softmax cross entropy of the training and eval steps,
the twin of `gat_tpu/train/trainer.py::Trainer._loss` (optax.smooth_labels
then softmax_cross_entropy) with the step's correct count (`argmax == y`,
the first of equal maxima as `jnp.argmax` takes it).

`softmax_xent(logits, labels, smoothing, scale)` returns the rows' losses
summed times `scale` and the correct count: the mean with `scale = 1/B`,
the eval's sum with 1, a data-parallel rank's share of the global mean
with 1/n. On the card it is one launch of K11 (`csrc/softmax_xent.cu`),
which writes the gradient `(softmax - target)·scale` in the same pass
when the logits need one; the loss's backward multiplies that saved
gradient by the incoming scalar. On the CPU it takes the plain version,
`softmax_xent_plain`, whose autograd gives the same gradient.
"""
from __future__ import annotations

import ctypes

import torch

from .. import kernels

__all__ = ["softmax_xent", "softmax_xent_plain", "check_kernel", "xent_grid",
           "MAX_CLASSES"]


def _check(logits: torch.Tensor, labels: torch.Tensor) -> None:
    if logits.ndim != 2 or logits.shape[1] < 1 or labels.ndim != 1 \
            or labels.shape[0] != logits.shape[0]:
        raise ValueError(f"[softmax_xent] logits (B, C) and labels (B,) "
                         f"expected, got {tuple(logits.shape)} and "
                         f"{tuple(labels.shape)}")


def softmax_xent_plain(logits: torch.Tensor, labels: torch.Tensor,
                       smoothing: float, scale: float = 1.0,
                       preds: bool = False):
    """(loss, correct[, preds]): sum over rows of -sum_j t_j·log_softmax_j
    with t = (1 - smoothing)·onehot(y) + smoothing / C (a label outside
    [0, C) has no one, as in jax.nn.one_hot), times `scale`; the count of
    rows whose first argmax is y (int64); with `preds`, the argmaxes."""
    _check(logits, labels)
    c, dev = logits.shape[1], logits.device
    onehot = labels[:, None] == torch.arange(c, device=dev)
    alpha = torch.tensor(smoothing, dtype=torch.float32, device=dev)
    off = alpha / c
    target = torch.where(onehot, (1.0 - alpha) + off, off)
    logp = torch.log_softmax(logits.float(), dim=-1)
    loss = -(target * logp).sum(-1).sum() * scale
    arg = logits.argmax(dim=-1)
    correct = (arg == labels).sum()
    return (loss, correct, arg) if preds else (loss, correct)


_ARGS = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 2 + [ctypes.c_float] * 2
         + [ctypes.c_int] * 3 + [ctypes.c_void_p])
_GRID_ARGS = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
# the most classes the kernel takes (`kMaxClasses` in `csrc/softmax_xent.cu`:
# 32 lanes a row, each holding 32 classes in registers)
MAX_CLASSES = 1024
_grids: dict[tuple, tuple] = {}


def check_kernel(logits: torch.Tensor, labels: torch.Tensor) -> None:
    """Raise where K11 refuses a call (its C entry points refuse the same
    class counts): logits that are not contiguous float32 (B, C) with B >=
    1 and 1 <= C <= MAX_CLASSES, or labels that are not contiguous int64
    (B,)."""
    _check(logits, labels)
    if logits.dtype != torch.float32 or labels.dtype != torch.int64:
        raise ValueError(f"[softmax_xent] the kernel takes float32 logits "
                         f"and int64 labels, got {logits.dtype} and "
                         f"{labels.dtype}")
    if not (logits.is_contiguous() and labels.is_contiguous()):
        raise ValueError("[softmax_xent] the kernel takes contiguous logits "
                         "and labels")
    if logits.shape[0] == 0:
        raise ValueError("[softmax_xent] no rows")
    if logits.shape[1] > MAX_CLASSES:
        raise ValueError(f"[softmax_xent] {logits.shape[1]} classes; the "
                         f"kernel takes at most {MAX_CLASSES}")


def xent_grid(b: int, c: int, device: torch.device) -> tuple:
    """K11's launch over b rows of c classes on `device`, as
    `gat_softmax_xent_grid` sizes it: (blocks, resident blocks per SM, rows
    a tile, lanes a row, shared bytes); one block for a batch of at most
    two tiles, else a grid sized to the card. Remembered per (device, b,
    c)."""
    key = (device.index, b, c)
    grid = _grids.get(key)
    if grid is None:
        out = (ctypes.c_int * 5)()
        fn = kernels.function("softmax_xent", "gat_softmax_xent_grid",
                              _GRID_ARGS)
        with kernels.device_guard(device):
            kernels.check(fn(b, c, ctypes.addressof(out)),
                          "softmax_xent grid")
        grid = _grids[key] = tuple(out)
    return grid


def _launch(logits, labels, smoothing, scale, grad, pred):
    b, c = logits.shape
    dev = logits.device
    blocks, _, rows, lanes, _ = xent_grid(b, c, dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    correct = torch.empty((), dtype=torch.int64, device=dev)
    part = ticket = None
    if blocks > 1:  # the grid form's partial slots: losses, then counts
        part = torch.empty(2 * blocks, dtype=torch.int32, device=dev)
        ticket = kernels.ticket(dev).data_ptr()
    fn = kernels.function("softmax_xent", "gat_softmax_xent", _ARGS)
    with kernels.device_guard(dev):
        status = fn(logits.data_ptr(), labels.data_ptr(),
                    None if grad is None else grad.data_ptr(),
                    None if pred is None else pred.data_ptr(),
                    None if part is None else part.data_ptr(),
                    None if part is None else part.data_ptr() + 4 * blocks,
                    ticket, loss.data_ptr(), correct.data_ptr(), b, c,
                    smoothing, scale, blocks, rows, lanes,
                    kernels.stream(dev))
    kernels.check(status, "softmax_xent")
    softmax_xent.launches += 1
    return loss, correct


class _SoftmaxXent(torch.autograd.Function):
    """K11 forward with its gradient written in the same launch; backward
    = the saved gradient times the incoming scalar."""

    @staticmethod
    def forward(ctx, logits, labels, smoothing, scale):
        grad = torch.empty_like(logits)
        loss, correct = _launch(logits, labels, smoothing, scale, grad, None)
        ctx.save_for_backward(grad)
        ctx.mark_non_differentiable(correct)
        return loss, correct

    @staticmethod
    def backward(ctx, g_loss, _g_correct):
        (grad,) = ctx.saved_tensors
        return grad * g_loss, None, None, None


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 smoothing: float, scale: float = 1.0, preds: bool = False):
    """(loss, correct[, preds]) of `softmax_xent_plain`, device scalars.

    CUDA tensor: one launch of K11 (`check_kernel` says what it takes).
    Where the logits need a gradient the launch writes it and the loss's
    backward scales it; otherwise (an eval step) no gradient is written,
    and with `preds` the launch also writes the argmaxes. CPU tensor:
    `softmax_xent_plain`."""
    if logits.device.type == "cpu":
        return softmax_xent_plain(logits, labels, smoothing, scale, preds)
    if logits.device.type != "cuda":
        raise ValueError(f"[softmax_xent] unsupported device {logits.device}")
    check_kernel(logits, labels)
    if logits.requires_grad and torch.is_grad_enabled():
        loss, correct = _SoftmaxXent.apply(logits, labels, float(smoothing),
                                           float(scale))
        if preds:
            return loss, correct, logits.detach().argmax(dim=-1)
        return loss, correct
    pred = (torch.empty(logits.shape[0], dtype=torch.int64,
                        device=logits.device) if preds else None)
    loss, correct = _launch(logits, labels, float(smoothing), float(scale),
                            None, pred)
    return (loss, correct, pred) if preds else (loss, correct)


softmax_xent.launches = 0
