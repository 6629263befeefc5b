"""The device mesh and the row layout of a data-parallel batch, the twin
of `gat_tpu/parallel/mesh.py`.

The mesh is a `torch.distributed.device_mesh.DeviceMesh` of shape
(data, model) with the JAX package's axis names (`PARALLEL_CONFIG`), one
process per device (`parallel/launch.py`). Where JAX annotates shardings
and lets XLA insert the collectives, the port writes them: every rank
makes the same call with the same full arguments, computes its own block
of rows along `data` (rank r of d holds rows [r·B/d, (r+1)·B/d), as
`P(DATA)` lays them out), and the rows are gathered so that every rank
returns the full result the single-device call returns. Ranks that share
a data index (the `model` axis) hold the same rows.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..config import PARALLEL_CONFIG

__all__ = ["DATA", "MODEL", "make_mesh", "mesh_device", "axis_size",
           "axis_rank", "axis_group", "row_range", "RowSharding",
           "data_sharding", "data_sharding_axis", "shard_batch",
           "gather_batch", "replicated", "pad_to_multiple", "all_ranks_ok"]

DATA = PARALLEL_CONFIG.DATA_AXIS
MODEL = PARALLEL_CONFIG.MODEL_AXIS


def make_mesh(n_devices: int | None = None, model_parallel: int = 1,
              device=None):
    """(data × model) DeviceMesh over the world's ranks: n_devices //
    model_parallel rows of model_parallel ranks. `device` None is the
    card ('cuda', NCCL); 'cpu' runs the ranks on gloo. Must be called by
    every rank of an initialised process group (`launch.spawn`,
    `torchrun`); n_devices, when given, must be the world size.
    model_parallel=1 is pure data parallelism."""
    from torch.distributed.device_mesh import DeviceMesh
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "[gat_tpu_torch.parallel] CUDA device requested but torch.cuda "
            "is not available; pass device='cpu' to build a CPU mesh")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"[make_mesh] unsupported device {dev}")
    if not dist.is_initialized():
        raise RuntimeError(
            "[make_mesh] no process group: run the ranks with "
            "gat_tpu_torch.parallel.launch.spawn or torchrun")
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"[make_mesh] {n} devices asked for in a world of "
                         f"{world} ranks (one rank per device)")
    if n % model_parallel:
        raise ValueError(f"[make_mesh] {n} devices not divisible by "
                         f"model_parallel={model_parallel}")
    grid = torch.arange(n).reshape(n // model_parallel, model_parallel)
    return DeviceMesh(dev.type, grid, mesh_dim_names=(DATA, MODEL))


def mesh_device(mesh) -> torch.device:
    """This rank's device: its card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def axis_size(mesh, axis: str = DATA) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str = DATA) -> int:
    return mesh.get_local_rank(axis)


def axis_group(mesh, axis: str = DATA):
    return mesh.get_group(axis)


def row_range(n: int, mesh, axis: str = DATA) -> tuple[int, int]:
    """[start, stop) of this rank's block of n rows along `axis`."""
    d, r = axis_size(mesh, axis), axis_rank(mesh, axis)
    return r * n // d, (r + 1) * n // d


def _as_wire(x: torch.Tensor) -> torch.Tensor:
    """bool travels as uint8 (every backend carries bytes)."""
    return x.to(torch.uint8) if x.dtype == torch.bool else x


def all_gather_rows(x: torch.Tensor, n: int, mesh, dim: int = 0,
                    axis: str = DATA) -> torch.Tensor:
    """The full n rows along `dim` from each rank's block of them
    (`row_range`), on every rank of the `axis` group. Blocks differ by at
    most one row; each is padded to the largest for the gather."""
    d = axis_size(mesh, axis)
    if d == 1:
        return x
    sizes = [(r + 1) * n // d - r * n // d for r in range(d)]
    width = max(sizes)
    y = _as_wire(x).movedim(dim, 0).contiguous()
    if y.shape[0] < width:
        y = torch.cat([y, y.new_zeros((width - y.shape[0],)
                                      + tuple(y.shape[1:]))])
    parts = [torch.empty_like(y) for _ in range(d)]
    dist.all_gather(parts, y, group=axis_group(mesh, axis))
    out = torch.cat([p[:s] for p, s in zip(parts, sizes)])
    out = out.movedim(0, dim)
    return out.to(torch.bool) if x.dtype == torch.bool else out


@dataclass(frozen=True)
class RowSharding:
    """Axis `axis` of an array split over the mesh's `data` axis in
    contiguous blocks, the rest replicated: the port's NamedSharding of
    `P(DATA)` (axis 0) or of the scanned waves' `P(None, DATA)` (axis 1)."""
    mesh: object
    axis: int = 0

    def span(self, n: int) -> tuple[int, int]:
        """[start, stop) of this rank's block of n rows."""
        return row_range(n, self.mesh)

    def local(self, x) -> torch.Tensor:
        """This rank's block of a full array, on its device."""
        x = torch.as_tensor(x)
        s, e = self.span(x.shape[self.axis])
        return x.narrow(self.axis, s, e - s).to(
            mesh_device(self.mesh)).contiguous()

    def gather(self, x_local: torch.Tensor, n: int) -> torch.Tensor:
        """The full array from each rank's block, on every rank."""
        return all_gather_rows(x_local, n, self.mesh, self.axis)


def data_sharding(mesh, ndim: int = 2) -> RowSharding:
    """Batch axis split over `data`, rest replicated (`ndim`, the JAX
    signature's rank, sets nothing here)."""
    return RowSharding(mesh, 0)


def data_sharding_axis(mesh, axis: int, ndim: int) -> RowSharding:
    """`axis` split over `data`, rest replicated: the JAX package's layout
    of its scanned (K, B, n) waves, which split B, axis 1 (`ndim` sets
    nothing here)."""
    return RowSharding(mesh, axis)


def shard_batch(x, mesh) -> torch.Tensor:
    """This rank's rows of a full host or device batch, on its device."""
    return data_sharding(mesh).local(x)


def gather_batch(x_local: torch.Tensor, n: int, mesh) -> torch.Tensor:
    """The full batch of n rows from each rank's `shard_batch` rows."""
    return all_gather_rows(x_local, n, mesh)


@torch.no_grad()
def replicated(module: torch.nn.Module, mesh) -> torch.nn.Module:
    """The module's parameters and buffers broadcast from global rank 0 to
    every rank, in place (it must already be on this rank's device);
    returns the module."""
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=0)
    return module


def all_ranks_ok(ok: bool, mesh) -> bool:
    """True on every rank when `ok` is true on every rank of the mesh."""
    flag = torch.tensor([int(ok)], dtype=torch.int32,
                        device=mesh_device(mesh))
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag.item())


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0):
    """Zero-pad so a batch divides the data axis; returns (padded, n_real).
    Callers mask with n_real."""
    n = x.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return x, n
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths), n
