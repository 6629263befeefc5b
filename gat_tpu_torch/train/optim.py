"""AdamW with optax's global-norm clip, the twin of the JAX trainer's
`optax.chain(clip_by_global_norm(max_norm), inject_hyperparams(adamw)(lr,
wd))` and of the data-parallel step's `optax.adamw` (no clip).

`ClipAdamW(params, ...)` owns flat float32 buffers of the parameters, the
gradients and the two moments; each parameter's `.data` and `.grad` become
views into them, once, at construction (after the model is on its device
and replicated). Autograd then accumulates into the gradient views, so
`zero_grad()` is one `zero_()` of the flat buffer, and a data-parallel
all-reduce takes the flat gradients whole (`grad_and_stats`: the gradients
and two spare slots for a step's loss sum and correct count). The step
count (int32) and the learning rate are device tensors, so a step reads
nothing back to the host.

A step is two launches on the card, K12's two passes
(`csrc/clip_adamw.cu`): `clip_norm`, the pre-clip global norm and the count
+ 1, then `adamw_update`, the clip, the moments, the bias corrections and
the decoupled decay. On the CPU both take their plain versions,
`clip_norm_plain` and `adamw_update_plain`, the same arithmetic in
PyTorch.
"""
from __future__ import annotations

import ctypes

import torch

from .. import kernels

__all__ = ["ClipAdamW", "clip_norm", "clip_norm_plain", "adamw_update",
           "adamw_update_plain", "complements"]

_STATS = 2  # the spare slots after the gradients


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def clip_norm_plain(g: torch.Tensor, norm: torch.Tensor,
                    count: torch.Tensor) -> None:
    """norm = sqrt(sum g²) of the flat gradients, count += 1 (saturating at
    int32's max, optax's safe_int32_increment), both in place."""
    norm.copy_(torch.sqrt((g * g).sum()))
    count.add_((count < torch.iinfo(torch.int32).max).to(torch.int32))


def complements(b1: float, b2: float, hyper_f32: bool) -> tuple:
    """(1 - b1, 1 - b2) as float32 values, as optax rounds them: taken in
    float32 of float32 hyperparameters (`inject_hyperparams`, the JAX
    trainer's chain), or taken of the Python floats and then rounded
    (plain `optax.adamw`)."""
    if hyper_f32:
        return tuple(float(_f32(1.0) - _f32(b)) for b in (b1, b2))
    return tuple(float(_f32(1.0 - b)) for b in (b1, b2))


def adamw_update_plain(p, g, mu, nu, norm, count, lr, max_norm,
                       b1: float, b2: float, c1: float, c2: float,
                       eps: float, wd: float) -> None:
    """One optax step on the flat buffers, in place: the clip (g kept when
    norm < max_norm, else g / norm · max_norm, written back to g; none when
    max_norm is None), mu = c1·g + b1·mu, nu = c2·g² + b2·nu (c the
    `complements` of b), the bias corrections 1 - b^count, and
    p = p + (-lr)·(mu_hat / (sqrt(nu_hat) + eps) + wd·p), in float32."""
    dev = p.device
    b1t, b2t = _f32(b1).to(dev), _f32(b2).to(dev)
    if max_norm is not None:
        g.copy_(torch.where(norm < max_norm, g,
                            g / norm * _f32(max_norm).to(dev)))
    m = _f32(c1).to(dev) * g + b1t * mu
    v = _f32(c2).to(dev) * (g * g) + b2t * nu
    k = count.to(torch.float32)
    u = (m / (1.0 - b1t ** k)) / (torch.sqrt(v / (1.0 - b2t ** k))
                                  + _f32(eps).to(dev))
    p.add_(-lr * (u + _f32(wd).to(dev) * p))
    mu.copy_(m)
    nu.copy_(v)


_NORM_ARGS = ([ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 3
              + [ctypes.c_longlong, ctypes.c_void_p])
_UPDATE_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_int] * 2
                + [ctypes.c_float] * 7 + [ctypes.c_void_p])
_GRIDS: dict = {}


def clip_adamw_grid(n: int, device: torch.device) -> tuple:
    """K12's grids over n parameters on the card `device`, as
    `gat_clip_adamw_grid` sizes them to its SMs: (pass 1's blocks, which
    is also its partial slots, its resident blocks per SM, pass 2's
    blocks, its resident blocks per SM); read once per device and n."""
    key = (device.index, n)
    grid = _GRIDS.get(key)
    if grid is None:
        fn = kernels.function("clip_adamw", "gat_clip_adamw_grid",
                              [ctypes.c_longlong, ctypes.c_void_p])
        out = (ctypes.c_int * 4)()
        with kernels.device_guard(device):
            kernels.check(fn(n, out), "clip_adamw_grid")
        grid = _GRIDS[key] = tuple(out)
    return grid


def clip_norm(g: torch.Tensor, norm: torch.Tensor, count: torch.Tensor,
              part: torch.Tensor) -> None:
    """`clip_norm_plain` of the flat float32 gradients g into the device
    scalars norm (float32) and count (int32). CUDA tensor: one launch of
    K12's pass 1, `part` (at least `clip_adamw_grid(n)[0]` floats) its
    partial sums, the device's ticket (`kernels.ticket`) the last
    block's. CPU tensor: `clip_norm_plain`."""
    if g.device.type == "cpu":
        return clip_norm_plain(g, norm, count)
    n, dev = g.numel(), g.device
    blocks = clip_adamw_grid(n, dev)[0] if n > 0 else 0
    if blocks < 1 or part.numel() < blocks:
        raise ValueError(f"[clip_norm] {n} gradients, {part.numel()} "
                         f"partial slots")
    fn = kernels.function("clip_adamw", "gat_clip_norm", _NORM_ARGS)
    with kernels.device_guard(dev):
        status = fn(g.data_ptr(), part.data_ptr(), blocks,
                    kernels.ticket(dev).data_ptr(), norm.data_ptr(),
                    count.data_ptr(), n, kernels.stream(dev))
    kernels.check(status, "clip_norm")
    clip_norm.launches += 1


clip_norm.launches = 0


def adamw_update(p, g, mu, nu, norm, count, lr, max_norm,
                 b1: float, b2: float, c1: float, c2: float, eps: float,
                 wd: float) -> None:
    """`adamw_update_plain` on flat float32 buffers, reading norm, count
    and lr from the device. CUDA tensor: one launch of K12's pass 2. CPU
    tensor: `adamw_update_plain`."""
    if p.device.type == "cpu":
        return adamw_update_plain(p, g, mu, nu, norm, count, lr, max_norm,
                                  b1, b2, c1, c2, eps, wd)
    dev = p.device
    fn = kernels.function("clip_adamw", "gat_adamw_update", _UPDATE_ARGS)
    with kernels.device_guard(dev):
        status = fn(p.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(),
                    norm.data_ptr(), count.data_ptr(), lr.data_ptr(),
                    p.numel(), clip_adamw_grid(p.numel(), dev)[2],
                    int(max_norm is not None),
                    0.0 if max_norm is None else max_norm, b1, b2, c1, c2,
                    eps, wd, kernels.stream(dev))
    kernels.check(status, "adamw_update")
    adamw_update.launches += 1


adamw_update.launches = 0


class ClipAdamW:
    """AdamW (optax's: betas, eps, the decay on every parameter) after a
    clip of the gradients' global norm at `max_norm` (None: no clip), on
    flat buffers of `params`, which must be float32 and on one device.
    `hyper_f32`: 1 - beta as `inject_hyperparams(adamw)` takes it (the JAX
    trainer's chain), else as plain `optax.adamw` (`complements`)."""

    def __init__(self, params, lr: float = 1e-3,
                 betas: tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-4, max_norm: float | None = None,
                 hyper_f32: bool = True):
        self.params = list(params)
        if not self.params:
            raise ValueError("[ClipAdamW] no parameters")
        dev = self.params[0].device
        for p in self.params:
            if p.dtype != torch.float32 or p.device != dev:
                raise ValueError(f"[ClipAdamW] parameters must be float32 on "
                                 f"one device, got {p.dtype} on {p.device}")
        self.b1, self.b2 = float(betas[0]), float(betas[1])
        self.c1, self.c2 = complements(self.b1, self.b2, hyper_f32)
        self.eps, self.weight_decay = float(eps), float(weight_decay)
        self.max_norm = None if max_norm is None else float(max_norm)
        self.n = sum(p.numel() for p in self.params)
        self._flat_p = torch.empty(self.n, dtype=torch.float32, device=dev)
        self.grad_and_stats = torch.zeros(self.n + _STATS,
                                          dtype=torch.float32, device=dev)
        self.flat_grad = self.grad_and_stats[:self.n]
        self.mu = torch.zeros(self.n, dtype=torch.float32, device=dev)
        self.nu = torch.zeros(self.n, dtype=torch.float32, device=dev)
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        self.norm = torch.zeros((), dtype=torch.float32, device=dev)
        self.lr_value = float(lr)
        self.lr = torch.full((), self.lr_value, dtype=torch.float32,
                             device=dev)
        slots = clip_adamw_grid(self.n, dev)[0] if dev.type == "cuda" else 0
        self._part = torch.empty(slots, dtype=torch.float32, device=dev)
        with torch.no_grad():
            for p, view in zip(self.params, self.views(self._flat_p)):
                view.copy_(p)
                p.data = view
            for p, view in zip(self.params, self.views(self.flat_grad)):
                p.grad = view

    def views(self, flat: torch.Tensor) -> list:
        """`flat` (n,) cut into one view a parameter, in its shape."""
        out, off = [], 0
        for p in self.params:
            out.append(flat[off:off + p.numel()].view(p.shape))
            off += p.numel()
        return out

    def zero_grad(self) -> None:
        """The flat gradients (and the spare slots) zeroed in place: the
        gradients stay views of the flat buffer."""
        self.grad_and_stats.zero_()

    def set_lr(self, lr: float) -> None:
        self.lr_value = float(lr)
        self.lr.fill_(self.lr_value)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One update from the gradients in the flat buffer; returns the
        pre-clip global norm, a device scalar (overwritten by the next
        step)."""
        clip_norm(self.flat_grad, self.norm, self.count, self._part)
        adamw_update(self._flat_p, self.flat_grad, self.mu, self.nu,
                     self.norm, self.count, self.lr, self.max_norm, self.b1,
                     self.b2, self.c1, self.c2, self.eps, self.weight_decay)
        return self.norm

    @torch.no_grad()
    def load_state(self, count: int, mu: list, nu: list) -> None:
        """The step count and the moments (one tensor a parameter, in the
        parameters' order) of a restored optimizer state."""
        self.count.fill_(int(count))
        for dst, src in ((self.mu, mu), (self.nu, nu)):
            for view, t in zip(self.views(dst), src):
                view.copy_(t)

    @property
    def param_groups(self) -> list[dict]:
        """torch.optim's view of the hyperparameters (read-only: set the
        learning rate with `set_lr`)."""
        return [{"params": self.params, "lr": self.lr_value,
                 "betas": (self.b1, self.b2), "eps": self.eps,
                 "weight_decay": self.weight_decay}]

    @property
    def state(self) -> dict:
        """torch.optim.AdamW's view of the state (reads the count from the
        device): {} before the first step, else per parameter its "step",
        "exp_avg" and "exp_avg_sq" (views of the flat moments)."""
        k = int(self.count)
        if k == 0:
            return {}
        return {p: {"step": torch.tensor(float(k)), "exp_avg": m,
                    "exp_avg_sq": v}
                for p, m, v in zip(self.params, self.views(self.mu),
                                   self.views(self.nu))}
