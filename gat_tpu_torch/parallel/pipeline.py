"""GPipe-style pipeline parallelism over the mesh's `model` axis, the twin
of `gat_tpu/parallel/pipeline.py`: a demonstration that the parallel
layer covers pipeline stages too (the models are far too small to need
them).

Each rank of the `model` axis owns one stage's weights; M microbatches
march through the S stages in M + S − 1 ticks, stage 0 injecting
microbatch t at tick t and every other stage computing on what the
previous stage sent it the tick before. The hop between stages is
`_Hop`, an autograd function: forward, every stage's output goes to the
next stage (an all-gather over `model`, which every backend supports);
backward, the gradient goes back to the stage it came from (the inverse
permutation), so one backward trains the whole pipeline. The last
stage's outputs are broadcast to every rank (a sum with zeros from the
others, whose adjoint passes each rank its own gradient).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import MODEL, axis_group, axis_rank, axis_size

__all__ = ["pipeline_apply", "stage_forward", "init_pipeline_params",
           "sequential_apply"]


def stage_forward(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor
                  ) -> torch.Tensor:
    """One pipeline stage: dense + tanh, (B, F) @ (F, F) + (F,) → (B, F)."""
    return torch.tanh(x @ w + b)


def init_pipeline_params(rng, n_stages: int, feat: int):
    """Stacked stage params w (S, F, F), b (S, F), drawn from `rng` (a
    torch.Generator or an int seed) on the host."""
    if not isinstance(rng, torch.Generator):
        rng = torch.Generator().manual_seed(int(rng))
    w = torch.randn((n_stages, feat, feat), generator=rng) / feat ** 0.5
    b = 0.01 * torch.randn((n_stages, feat), generator=rng)
    return w.float(), b.float()


def _gather(x: torch.Tensor, group) -> list:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


class _Hop(torch.autograd.Function):
    """Stage s receives stage s − 1's tensor (mod S); the gradient goes
    from stage s + 1 back to stage s."""

    @staticmethod
    def forward(ctx, y, group, stage, n_stages):
        ctx.group, ctx.stage, ctx.n_stages = group, stage, n_stages
        return _gather(y, group)[(stage - 1) % n_stages].clone()

    @staticmethod
    def backward(ctx, g):
        return (_gather(g, ctx.group)[(ctx.stage + 1) % ctx.n_stages]
                .clone(), None, None, None)


class _FromLast(torch.autograd.Function):
    """The last stage's tensor on every rank; each rank's gradient flows
    to its own contribution (the loss is the same on every rank)."""

    @staticmethod
    def forward(ctx, y, group):
        y = y.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def pipeline_apply(w: torch.Tensor, b: torch.Tensor, xs: torch.Tensor,
                   mesh) -> torch.Tensor:
    """(M, B, F) microbatches through the S-stage pipeline laid over the
    mesh's `model` axis (S = its size); returns the (M, B, F) last-stage
    outputs on every rank. Every rank passes the same stacked w (S, F,
    F), b (S, F) and xs and uses stage w[s], b[s] for its model index s,
    so a backward leaves gradients in row s only (sum them over `model`
    for the full gradient); they equal those of `sequential_apply`."""
    n_stages = axis_size(mesh, MODEL)
    if w.shape[0] != n_stages:
        raise ValueError(f"[pipeline_apply] {w.shape[0]} stages on a model "
                         f"axis of {n_stages}")
    stage = axis_rank(mesh, MODEL)
    group = axis_group(mesh, MODEL)
    m = xs.shape[0]
    # the same graph on every rank (selects, not branches), so that every
    # rank's backward meets the hops' collectives in the same order
    first = torch.tensor(stage == 0, device=xs.device)
    last = torch.tensor(stage == n_stages - 1, device=xs.device)
    act = xs.new_zeros(xs.shape[1:])
    outs = []
    for t in range(m + n_stages - 1):
        x_in = torch.where(first, xs[min(t, m - 1)], act)
        y = stage_forward(w[stage], b[stage], x_in)
        if t >= n_stages - 1:
            outs.append(torch.where(last, y, torch.zeros_like(y)))
        if t < m + n_stages - 2:
            act = _Hop.apply(y, group, stage, n_stages)
    return _FromLast.apply(torch.stack(outs), group)


def sequential_apply(w: torch.Tensor, b: torch.Tensor, xs: torch.Tensor
                     ) -> torch.Tensor:
    """Reference: the same stages composed in a plain loop."""
    x = xs
    for s in range(w.shape[0]):
        x = stage_forward(w[s], b[s], x)
    return x
