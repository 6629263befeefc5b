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

__all__ = ["softmax_xent", "softmax_xent_plain"]


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
         + [ctypes.c_void_p])


def blocks(b: int) -> int:
    """K11's blocks (and partial slots) over b rows, eight a block, as
    `gat_softmax_xent_blocks` counts them."""
    return -(-b // 8)


def _launch(logits, labels, smoothing, scale, grad, pred):
    b, c = logits.shape
    dev = logits.device
    n_blocks = blocks(b)
    part_loss = torch.empty(n_blocks, dtype=torch.float32, device=dev)
    part_correct = torch.empty(n_blocks, dtype=torch.int32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    correct = torch.empty((), dtype=torch.int64, device=dev)
    fn = kernels.function("softmax_xent", "gat_softmax_xent", _ARGS)
    with kernels.device_guard(dev):
        status = fn(logits.data_ptr(), labels.data_ptr(),
                    None if grad is None else grad.data_ptr(),
                    None if pred is None else pred.data_ptr(),
                    part_loss.data_ptr(), part_correct.data_ptr(),
                    kernels.ticket(dev).data_ptr(), loss.data_ptr(),
                    correct.data_ptr(), b, c, smoothing, scale,
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

    CUDA tensor: one launch of K11 (logits float32 (B, C), labels int64
    (B,), both contiguous). Where the logits need a gradient the launch
    writes it and the loss's backward scales it; otherwise (an eval step)
    no gradient is written, and with `preds` the launch also writes the
    argmaxes. CPU tensor: `softmax_xent_plain`."""
    if logits.device.type == "cpu":
        return softmax_xent_plain(logits, labels, smoothing, scale, preds)
    if logits.device.type != "cuda":
        raise ValueError(f"[softmax_xent] unsupported device {logits.device}")
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
