"""The wave's clip-budget compaction, the twin of the budget branch of
`gat_tpu/infer/pipeline.py::build_files_fn`.

The file body computes only `budget` of a wave's B·K onset slots: the
kept slots first, in slot-major order (every file's slot 0, then slot 1,
...), then the slots that are not kept, in the same order, as the
reference's `jnp.argsort(~kept.T.reshape(B·K), stable=True)[:budget]`
orders them. `wave_select` picks those slots and flags each file that lost
a kept slot to the budget; `wave_scatter` puts the budget's outputs back
at their (file, slot) places, zero elsewhere.

Under a mesh every rank passes the whole wave's kept bits and its own
files [first, first + n_local): it keeps its own picked slots, in the
order the whole wave's selection gives them.

On the card both launch the hand-written kernels of
`csrc/wave_compact.cu` (K10): `gat_wave_select`, one block that stages
the kept bits in shared memory, counts the partition with warp ballots
and writes the selection and the flags, and `gat_wave_scatter`, one
launch for the four outputs, a warp an output row. On the CPU they
take the plain versions, `wave_select_plain` and `wave_scatter_plain`,
the reference's argsort and scatter written in PyTorch.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import kernels

__all__ = ["Selection", "wave_select", "wave_select_plain", "wave_scatter",
           "wave_scatter_plain", "check_select", "check_scatter",
           "compact_grid", "MAX_SLOTS"]

# the most slots a wave may have: int32 positions, walked in tiles of
# 8,192 slot-major positions staged in shared memory (`kTile` in
# `csrc/wave_compact.cu`)
MAX_SLOTS = 2 ** 31 - 1 - 8192


class Selection(NamedTuple):
    """One wave's compaction, for this rank's n_local files of K slots:
    `sel` (n_sel,) int32, the local file-major slots to compute, in the
    selection's order; `pos` (n_local·K,) int32, each slot's row in `sel`
    or -1; `kept` (n_local, K), kept and picked; `dropped` (n_local,), the
    file lost a kept slot; `overflow` and `fixable` (n_local,), the given
    flags or'ed with `dropped`; `n_sel`, the rows of `sel` (a Python int)."""
    sel: torch.Tensor
    pos: torch.Tensor
    kept: torch.Tensor
    dropped: torch.Tensor
    overflow: torch.Tensor
    fixable: torch.Tensor
    n_sel: int


def check_select(kept_all: torch.Tensor, budget: int, first: int,
                 n_local: int) -> None:
    """Raise where K10's selection refuses a call (its C entry point
    refuses the same): kept bits that are not (files, K) with K >= 1, a
    budget below 1, this rank's files outside the wave, or more slots
    than MAX_SLOTS."""
    if kept_all.ndim != 2 or min(kept_all.shape) < 1:
        raise ValueError(f"[wave_select] kept bits must be (files, K), "
                         f"files and K >= 1, got {tuple(kept_all.shape)}")
    n_files, k = kept_all.shape
    if budget < 1:
        raise ValueError(f"[wave_select] budget must be >= 1, got {budget}")
    if first < 0 or n_local < 1 or first + n_local > n_files:
        raise ValueError(f"[wave_select] files [{first}, {first + n_local})"
                         f" are not within the wave's {n_files}")
    if n_files * k > MAX_SLOTS:
        raise ValueError(f"[wave_select] {n_files} x {k} slots; the kernel "
                         f"takes at most {MAX_SLOTS}")


def _flags(flag, n_local: int, dev) -> torch.Tensor:
    if flag is None:
        return torch.zeros(n_local, dtype=torch.bool, device=dev)
    flag = torch.as_tensor(flag, device=dev).reshape(-1)
    if flag.numel() != n_local:
        raise ValueError(f"[wave_select] flags of {n_local} files expected, "
                         f"got {flag.numel()}")
    return flag.to(torch.bool)


def wave_select_plain(kept_all: torch.Tensor, budget: int, first: int = 0,
                      n_local: int | None = None, overflow=None,
                      fixable=None) -> Selection:
    """The selection as the reference computes it: a stable argsort of
    the slot-major kept bits, cut at `budget`, mapped to file-major slots;
    under a mesh this rank's slots of it, in its order. Flags default to
    none raised."""
    n_files, k = kept_all.shape
    n_local = n_files if n_local is None else n_local
    check_select(kept_all, budget, first, n_local)
    dev = kept_all.device
    kept_all = kept_all.to(torch.bool)
    keptt = kept_all.T.reshape(n_files * k)
    ordert = torch.argsort((~keptt).to(torch.uint8), stable=True)[:budget]
    sel = (ordert % n_files) * k + ordert // n_files
    if first != 0 or n_local != n_files:  # this rank's files' slots
        sel = sel[(sel >= first * k) & (sel < (first + n_local) * k)] \
            - first * k
    n_sel = sel.numel()
    pos = torch.full((n_local * k,), -1, dtype=torch.int32, device=dev)
    pos[sel] = torch.arange(n_sel, dtype=torch.int32, device=dev)
    computed = (pos >= 0).reshape(n_local, k)
    kept_local = kept_all[first:first + n_local]
    dropped = (kept_local & ~computed).any(-1)
    return Selection(sel.to(torch.int32), pos, kept_local & computed,
                     dropped, _flags(overflow, n_local, dev) | dropped,
                     _flags(fixable, n_local, dev) | dropped, n_sel)


_SELECT_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_SCATTER_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
_GRID_ARGS = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def compact_grid(n_files: int, k: int, device: torch.device) -> tuple:
    """K10's launches over a wave of n_files x K slots on `device`, from
    `gat_wave_compact_grid`: (the selection's tiles, its threads, the
    scatter's blocks over the wave's slots, its resident blocks per
    SM)."""
    out = (ctypes.c_int * 4)()
    fn = kernels.function("wave_compact", "gat_wave_compact_grid",
                          _GRID_ARGS)
    with kernels.device_guard(device):
        kernels.check(fn(n_files, k, ctypes.addressof(out)),
                      "wave_compact grid")
    return tuple(out)


def wave_select(kept_all: torch.Tensor, budget: int, first: int = 0,
                n_local: int | None = None, overflow=None,
                fixable=None) -> Selection:
    """The budget's selection of one wave: `kept_all` (files, K), the whole
    wave's kept bits; this rank's files [first, first + n_local) (None:
    all); `overflow` and `fixable` this rank's (n_local,) flags (None:
    none raised). Returns a `Selection` equal to `wave_select_plain`'s.

    CUDA tensor: one launch of K10's `gat_wave_select`. On one device
    (first 0, every file local) `n_sel` is min(budget, files·K) and the
    host reads nothing; under a mesh it reads the kernel's count once.
    CPU tensor: `wave_select_plain`."""
    if kept_all.device.type == "cpu":
        return wave_select_plain(kept_all, budget, first, n_local, overflow,
                                 fixable)
    if kept_all.device.type != "cuda":
        raise ValueError(f"[wave_select] unsupported device "
                         f"{kept_all.device}")
    n_files, k = kept_all.shape
    n_local = n_files if n_local is None else n_local
    check_select(kept_all, budget, first, n_local)
    dev = kept_all.device
    bits = kept_all.to(torch.bool).contiguous()
    ovf_in = _flags(overflow, n_local, dev).contiguous()
    fix_in = _flags(fixable, n_local, dev).contiguous()
    whole = first == 0 and n_local == n_files
    cap = min(budget, n_local * k)
    ints = torch.empty(cap + n_local * k + 1, dtype=torch.int32, device=dev)
    sel, pos, count = ints[:cap], ints[cap:cap + n_local * k], ints[-1:]
    flags = torch.empty(n_local * (k + 3), dtype=torch.bool, device=dev)
    kept = flags[:n_local * k].view(n_local, k)
    dropped, ovf, fix = flags[n_local * k:].view(3, n_local)
    fn = kernels.function("wave_compact", "gat_wave_select", _SELECT_ARGS)
    with kernels.device_guard(dev):
        status = fn(bits.data_ptr(), ovf_in.data_ptr(), fix_in.data_ptr(),
                    sel.data_ptr(), pos.data_ptr(), kept.data_ptr(),
                    dropped.data_ptr(), ovf.data_ptr(), fix.data_ptr(),
                    count.data_ptr(), n_files, k, budget, first, n_local,
                    kernels.stream(dev))
    kernels.check(status, "wave_select")
    wave_select.launches += 1
    n_sel = cap if whole else int(count.item())
    return Selection(sel[:n_sel], pos, kept, dropped, ovf, fix, n_sel)


wave_select.launches = 0


def _parts(pos: torch.Tensor, parts) -> tuple[int, int]:
    """(compact rows, classes) of the scatter's parts (blend, MLP, CNN
    probs (rows, C) or None, pitch (rows,) or None); raises unless they
    agree."""
    if len(parts) != 4:
        raise ValueError(f"[wave_scatter] parts are (probs, mlp, cnn, "
                         f"pitch), got {len(parts)}")
    present = [x for x in parts if x is not None]
    if not present:
        raise ValueError("[wave_scatter] every part is None")
    rows = present[0].shape[0]
    mats = [x for x in parts[:3] if x is not None]
    c = mats[0].shape[1] if mats else 1
    for x in mats:
        if x.ndim != 2 or tuple(x.shape) != (rows, c):
            raise ValueError(f"[wave_scatter] probs must be ({rows}, {c}), "
                             f"got {tuple(x.shape)}")
    if parts[3] is not None and tuple(parts[3].shape) != (rows,):
        raise ValueError(f"[wave_scatter] pitch must be ({rows},), got "
                         f"{tuple(parts[3].shape)}")
    if rows < 1 or pos.ndim != 1 or pos.numel() < 1:
        raise ValueError(f"[wave_scatter] {rows} compact rows to "
                         f"{tuple(pos.shape)} slots")
    return rows, c


def check_scatter(pos: torch.Tensor, parts) -> tuple[int, int]:
    """Raise where K10's scatter refuses a call: parts that are not (rows,
    C) probs and (rows,) pitch (any of them None, not all), no rows, a pos
    that is not (n,) int32 with n >= 1, or parts that are not float32
    (the kernel copies float32 only). Returns (rows, C)."""
    rows, c = _parts(pos, parts)
    if pos.dtype != torch.int32:
        raise ValueError(f"[wave_scatter] pos must be int32, got {pos.dtype}")
    for x in parts:
        if x is not None and x.dtype != torch.float32:
            raise ValueError(f"[wave_scatter] the kernel copies float32, "
                             f"got {x.dtype}")
    return rows, c


def wave_scatter_plain(pos: torch.Tensor, parts) -> tuple:
    """The budget's compact outputs back at their slots: part x (rows,
    ...) → (len(pos), ...), row i = x[pos[i]] where pos[i] >= 0, else 0,
    the reference's `zeros(...).at[sel].set(x)`. None stays None."""
    _parts(pos, parts)
    idx = pos.to(torch.int64)
    hit = idx >= 0
    idx = idx.clamp(min=0)

    def one(x):
        if x is None:
            return None
        mask = hit.reshape((-1,) + (1,) * (x.ndim - 1))
        return torch.where(mask, x[idx], x.new_zeros(()))
    return tuple(one(x) for x in parts)


def wave_scatter(pos: torch.Tensor, parts) -> tuple:
    """`wave_scatter_plain` of `parts` (probs, mlp_probs, cnn_probs,
    pitch; any of them None) by `pos` (n,) int32, the selection's rows.

    CUDA tensor: one launch of K10's `gat_wave_scatter`, which writes all
    four outputs. CPU tensor: `wave_scatter_plain`."""
    if pos.device.type == "cpu":
        return wave_scatter_plain(pos, parts)
    if pos.device.type != "cuda":
        raise ValueError(f"[wave_scatter] unsupported device {pos.device}")
    _, c = check_scatter(pos, parts)
    n = pos.numel()
    dev = pos.device
    pos = pos.contiguous()
    src = [None if x is None else x.contiguous() for x in parts]
    out = [None if x is None else
           torch.empty((n,) + tuple(x.shape[1:]), dtype=torch.float32,
                       device=dev) for x in parts]
    fn = kernels.function("wave_compact", "gat_wave_scatter", _SCATTER_ARGS)
    with kernels.device_guard(dev):
        status = fn(pos.data_ptr(),
                    *(None if x is None else x.data_ptr() for x in src),
                    *(None if x is None else x.data_ptr() for x in out),
                    n, c, kernels.stream(dev))
    kernels.check(status, "wave_scatter")
    wave_scatter.launches += 1
    return tuple(out)


wave_scatter.launches = 0
