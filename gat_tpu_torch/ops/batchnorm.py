"""flax's train-mode BatchNorm, the twin of `nn.BatchNorm(
use_running_average=False, momentum=0.9, epsilon=1e-5)` in
`gat_tpu/models/cnn.py` (and of what jax.grad makes of it).

`batch_norm_train(x, weight, bias, running_mean, running_var, eps,
momentum, reduce=None)`: x (N, C, H, W) in its compute dtype; the batch's
moments E[x] and E[x²] in float32 over (N, H, W), handed to `reduce`
(a data-parallel step's all-reduce of them, `parallel/sharded.py`) when
given; var = max(E[x²] - E[x]², 0); y = (x - mean)·rsqrt(var + eps)·w + b
in float32, rounded to x's dtype; the running statistics moved by
`momentum` toward the batch mean and the *biased* variance, in place.

On the card it is two `torch.autograd.Function`s around K13
(`csrc/batchnorm_train.cu`), with `reduce` between them: `bn_moments`
(one launch) and `bn_apply` (one launch, the running statistics too)
forward; backward `bn_apply_grad` (one launch: the per-channel sums, dw,
db and the moments' gradients) and `bn_moments_grad` (one launch: dx,
the apply's direct term and the moments' backward together, rounded once
to x's dtype, as the plain version's float32 sum is rounded once). The
kernels read x, dy and write y, dx with the strides they are given
(contiguous NCHW or channels-last, which cuDNN's convolutions give here);
any other layout is refused, not copied. On the CPU it takes the plain
version, `batch_norm_train_plain`.
"""
from __future__ import annotations

import ctypes

import torch

from .. import kernels

__all__ = ["batch_norm_train", "batch_norm_train_plain", "bn_moments",
           "bn_apply", "bn_apply_grad", "bn_moments_grad", "layout"]


def batch_norm_train_plain(x, weight, bias, running_mean, running_var,
                           eps: float, momentum: float, reduce=None):
    """flax's train-mode BatchNorm in PyTorch ops (autograd gives its
    backward); the running statistics are moved in place."""
    xf = x.float()
    if xf.shape[0]:
        mean, sq = xf.mean(dim=(0, 2, 3)), (xf * xf).mean(dim=(0, 2, 3))
    else:  # a data-parallel rank without rows
        mean = sq = xf.new_zeros(xf.shape[1])
    if reduce is not None:
        mean, sq = reduce(mean, sq, xf.shape[0])
    var = torch.clamp(sq - mean * mean, min=0.0)
    with torch.no_grad():
        running_mean.copy_(momentum * running_mean + (1.0 - momentum) * mean)
        running_var.copy_(momentum * running_var + (1.0 - momentum) * var)
    mul = torch.rsqrt(var + eps) * weight
    y = (xf - mean[:, None, None]) * mul[:, None, None]
    return (y + bias[:, None, None]).to(x.dtype)


def layout(t: torch.Tensor, name: str = "batch_norm",
           read_only: bool = False) -> tuple:
    """(strides (N, C, position), channels-last) of a 4-D tensor whose
    (H, W) positions are p·stride(W) apart (stride(H) = W·stride(W)), and
    unless `read_only` (an incoming gradient, which may be expanded)
    contiguous NCHW or channels-last, the layouts a kernel writes its
    outputs in (`empty_like`); anything else is refused, not copied."""
    if t.ndim != 4:
        raise ValueError(f"[{name}] (N, C, H, W) expected, got "
                         f"{tuple(t.shape)}")
    sn, sc, sh, sw = t.stride()
    _, c, h, w = t.shape
    if h > 1 and w > 1 and sh != w * sw:
        raise ValueError(f"[{name}] positions must be p·stride(W) apart, "
                         f"got strides {t.stride()} for {tuple(t.shape)}")
    if not (read_only or t.is_contiguous() or t.is_contiguous(
            memory_format=torch.channels_last)):
        raise ValueError(f"[{name}] the kernel takes contiguous NCHW or "
                         f"channels-last, got strides {t.stride()}")
    last = c > 1 and sc == 1 and 256 % c == 0
    return (sn, sc, sw if w > 1 else sh), last


_SPLITS: dict = {}


def _splits(x: torch.Tensor, last: bool, sums: bool) -> int:
    """K13's splits of the positions for x's launches on its card
    (`gat_bn_splits`: the grid sized to the card's SMs for C channels, M
    positions, the map and the dtype; `sums` for the kernels that sum over
    the positions, whose partial buffers hold 2·C·splits floats), 1 where
    there are no positions."""
    n, c, p = _dims(x)
    m = n * p
    if m < 1:
        return 1
    bf16 = _bf16(x)
    key = (x.device.index, c, m, last, bf16, sums)
    s = _SPLITS.get(key)
    if s is None:
        fn = kernels.function("batchnorm_train", "gat_bn_splits",
                              [ctypes.c_int, ctypes.c_longlong] +
                              [ctypes.c_int] * 3)
        with kernels.device_guard(x.device):
            s = int(fn(c, m, int(last), bf16, int(sums)))
        if s < 1:
            raise ValueError(f"[batch_norm] {c} channels, {m} positions "
                             f"refused")
        _SPLITS[key] = s
    return s


def _dims(x):
    n, c, h, w = x.shape
    return n, c, h * w


def _bf16(x) -> int:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"[batch_norm] the kernel takes float32 or "
                         f"bfloat16, got {x.dtype}")
    return int(x.dtype == torch.bfloat16)


def _same(dy, x) -> None:
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"[batch_norm] dy {dy.dtype} {tuple(dy.shape)} "
                         f"must match x {x.dtype} {tuple(x.shape)}")


_L = [ctypes.c_longlong] * 3
_MOMENTS_ARGS = ([ctypes.c_void_p] + [ctypes.c_int] * 3 + _L + [ctypes.c_int]
                 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                 + [ctypes.c_void_p])
_APPLY_ARGS = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + _L
               + [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_float]
               + [ctypes.c_void_p] * 2 + [ctypes.c_float] * 2
               + [ctypes.c_int] * 2 + [ctypes.c_void_p])
_APPLY_GRAD_ARGS = ([ctypes.c_void_p] + _L + [ctypes.c_void_p]
                    + [ctypes.c_int] * 3 + _L + [ctypes.c_int]
                    + [ctypes.c_void_p] * 3 + [ctypes.c_float]
                    + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2
                    + [ctypes.c_void_p])
_MOMENTS_GRAD_ARGS = ([ctypes.c_void_p] + _L + [ctypes.c_void_p] * 2
                      + [ctypes.c_int] * 3 + _L + [ctypes.c_int]
                      + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                      + [ctypes.c_void_p])


def bn_moments(x: torch.Tensor) -> tuple:
    """(mean, sq) (C,) float32 of x over (N, H, W): one launch of K13's
    moments kernel (CUDA x with N >= 1)."""
    (sn, sc, sp), last = layout(x)
    n, c, p = _dims(x)
    if n < 1:
        raise ValueError("[bn_moments] no rows")
    dev = x.device
    splits = _splits(x, last, True)
    part = torch.empty(2 * c * splits, dtype=torch.float32, device=dev)
    out = torch.empty((2, c), dtype=torch.float32, device=dev)
    fn = kernels.function("batchnorm_train", "gat_bn_moments", _MOMENTS_ARGS)
    with kernels.device_guard(dev):
        status = fn(x.data_ptr(), n, c, p, sn, sc, sp, splits,
                    part.data_ptr(), kernels.ticket(dev).data_ptr(),
                    out[0].data_ptr(), out[1].data_ptr(), _bf16(x), int(last),
                    kernels.stream(dev))
    kernels.check(status, "bn_moments")
    bn_moments.launches += 1
    return out[0], out[1]


bn_moments.launches = 0


def bn_apply(x, mean, sq, weight, bias, running_mean, running_var,
             eps: float, momentum: float) -> torch.Tensor:
    """y in x's dtype and strides, and the running statistics moved in
    place: one launch of K13's apply kernel (with N = 0 it only moves the
    running statistics)."""
    (sn, sc, sp), last = layout(x)
    n, c, p = _dims(x)
    dev = x.device
    y = torch.empty_like(x)
    fn = kernels.function("batchnorm_train", "gat_bn_apply", _APPLY_ARGS)
    with kernels.device_guard(dev):
        status = fn(x.data_ptr(), y.data_ptr(), n, c, p, sn, sc, sp,
                    _splits(x, last, False), mean.data_ptr(), sq.data_ptr(),
                    weight.data_ptr(), bias.data_ptr(), eps,
                    running_mean.data_ptr(), running_var.data_ptr(),
                    momentum, 1.0 - momentum, _bf16(x), int(last),
                    kernels.stream(dev))
    kernels.check(status, "bn_apply")
    bn_apply.launches += 1
    return y


bn_apply.launches = 0


def bn_apply_grad(dy, x, mean, sq, weight, eps: float) -> tuple:
    """(dweight, dbias, dmean, dsq, mul) (C,) float32 from dy: one launch
    of K13's apply-backward kernel."""
    (gsn, gsc, gsp), _ = layout(dy, read_only=True)
    (sn, sc, sp), last = layout(x)
    _same(dy, x)
    n, c, p = _dims(x)
    dev = x.device
    splits = _splits(x, last, True)
    part = torch.empty(2 * c * splits, dtype=torch.float32, device=dev)
    out = torch.empty((5, c), dtype=torch.float32, device=dev)
    fn = kernels.function("batchnorm_train", "gat_bn_apply_grad",
                          _APPLY_GRAD_ARGS)
    with kernels.device_guard(dev):
        status = fn(dy.data_ptr(), gsn, gsc, gsp, x.data_ptr(), n, c, p, sn,
                    sc, sp, splits, mean.data_ptr(), sq.data_ptr(),
                    weight.data_ptr(), eps, part.data_ptr(),
                    kernels.ticket(dev).data_ptr(),
                    *(out[i].data_ptr() for i in range(5)), _bf16(x),
                    int(last), kernels.stream(dev))
    kernels.check(status, "bn_apply_grad")
    bn_apply_grad.launches += 1
    return tuple(out)


bn_apply_grad.launches = 0


def bn_moments_grad(dy, x, mul, dmean, dsq) -> torch.Tensor:
    """dx = dy·mul + dmean / M + 2·x·dsq / M in x's dtype and strides: one
    launch of K13's moments-backward kernel."""
    (gsn, gsc, gsp), _ = layout(dy, read_only=True)
    (sn, sc, sp), last = layout(x)
    _same(dy, x)
    n, c, p = _dims(x)
    dev = x.device
    dx = torch.empty_like(x)
    fn = kernels.function("batchnorm_train", "gat_bn_moments_grad",
                          _MOMENTS_GRAD_ARGS)
    with kernels.device_guard(dev):
        status = fn(dy.data_ptr(), gsn, gsc, gsp, x.data_ptr(), dx.data_ptr(),
                    n, c, p, sn, sc, sp, _splits(x, last, False),
                    mul.data_ptr(), dmean.data_ptr(), dsq.data_ptr(),
                    _bf16(x), int(last), kernels.stream(dev))
    kernels.check(status, "bn_moments_grad")
    bn_moments_grad.launches += 1
    return dx


bn_moments_grad.launches = 0


class _Link:
    """What the apply's backward hands the moments' backward: dy and the
    per-channel multiplier, so that dx is written once."""
    dy = None
    mul = None


class _Moments(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, link):
        mean, sq = bn_moments(x)
        ctx.save_for_backward(x)
        ctx.link = link
        return mean, sq

    @staticmethod
    def backward(ctx, dmean, dsq):
        (x,) = ctx.saved_tensors
        link = ctx.link
        dx = bn_moments_grad(link.dy, x, link.mul, dmean.contiguous(),
                             dsq.contiguous())
        link.dy = link.mul = None
        return dx, None


class _Apply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mean, sq, weight, bias, running_mean, running_var,
                eps, momentum, link):
        y = bn_apply(x, mean, sq, weight, bias, running_mean, running_var,
                     eps, momentum)
        ctx.save_for_backward(x, mean, sq, weight)
        ctx.eps, ctx.link = eps, link
        return y

    @staticmethod
    def backward(ctx, dy):
        x, mean, sq, weight = ctx.saved_tensors
        dw, db, dmean, dsq, mul = bn_apply_grad(dy, x, mean, sq, weight,
                                                ctx.eps)
        # dx is written by the moments' backward, which runs after this
        # one (the moments feed the apply), from dy and mul
        ctx.link.dy, ctx.link.mul = dy, mul
        return None, dmean, dsq, dw, db, None, None, None, None, None


def batch_norm_train(x, weight, bias, running_mean, running_var,
                     eps: float, momentum: float, reduce=None):
    """`batch_norm_train_plain` of x (N, C, H, W), float32 or bfloat16.
    CUDA tensor: K13's moments and apply kernels forward (with `reduce`
    between them), its two backward kernels behind autograd. CPU tensor:
    `batch_norm_train_plain`."""
    if x.device.type == "cpu":
        return batch_norm_train_plain(x, weight, bias, running_mean,
                                      running_var, eps, momentum, reduce)
    if x.device.type != "cuda":
        raise ValueError(f"[batch_norm_train] unsupported device {x.device}")
    layout(x)
    link = _Link()
    if x.shape[0]:
        mean, sq = _Moments.apply(x, link)
    else:  # a data-parallel rank without rows
        mean = sq = torch.zeros(x.shape[1], dtype=torch.float32,
                                device=x.device)
    if reduce is not None:
        mean, sq = reduce(mean, sq, x.shape[0])
    return _Apply.apply(x, mean.contiguous(), sq.contiguous(), weight, bias,
                        running_mean, running_var, float(eps),
                        float(momentum), link)
