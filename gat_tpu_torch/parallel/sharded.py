"""Sharded programs over a device mesh, the twin of
`gat_tpu/parallel/sharded.py`: clip-batch inference, YIN and file
inference data-parallel over `data`, the training step with global-batch
semantics, and the MLP's tensor-parallel layout over `model`.

XLA inserts these collectives from sharding annotations; here they are
written out (`torch.distributed`, NCCL on the card, gloo on the CPU):

* inference: each rank runs its rows of the batch through the port's
  single-device functions (K1-K5 on the card) and the rows are gathered;
* training: the loss is the mean over the global batch (each rank's loss
  sum over the global count), gradients are summed over `data` in one
  all-reduce with the loss sum and the correct count, the CNN's
  train-mode BatchNorm takes the global batch's statistics (a
  differentiable all-reduce of its sums), and dropout draws the global
  batch's mask on every rank from one identically seeded generator, so a
  data-parallel run is the single-device run up to summation order,
  whatever the split (a trailing batch smaller than the world leaves some
  ranks no rows);
* tensor parallelism: written with explicit collectives, not DTensor,
  because LayerNorm reads the whole hidden vector, so its statistics are
  a sum over `model`, and a row-sharded product ends in a sum over
  `model` (`TensorParallelMLP`).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..models import cnn as cnn_mod
from ..models import mlp as mlp_mod
from ..ops.loss import softmax_xent
from ..train.optim import ClipAdamW
from .mesh import (DATA, MODEL, axis_group, axis_rank, axis_size,
                   data_sharding, mesh_device, replicated, row_range)

__all__ = ["make_sharded_transcribe", "make_sharded_transcribe_files",
           "mlp_tp_shardings", "make_sharded_train_step",
           "sharded_batch_pitch", "TensorParallelMLP", "ShardedTrainState",
           "adamw", "allreduce_sum", "data_parallel_rows",
           "data_parallel_backward"]


class _AllReduceSum(torch.autograd.Function):
    """y = Σ_ranks x on every rank of `group`; its adjoint sums the
    ranks' output gradients the same way (each rank's loss depends on
    every rank's x through y)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def allreduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of x over the ranks of `group`."""
    return _AllReduceSum.apply(x, group)


@contextlib.contextmanager
def data_parallel_rows(model: nn.Module, n: int, start: int, stop: int,
                       mesh):
    """Within it, the model's forward on rows [start, stop) of a global
    batch of n behaves as part of the global batch's forward: its dropout
    masks are the global batch's rows, and a CNN's train-mode BatchNorm
    takes the global batch's statistics over `data`."""
    drops = [m for m in model.modules() if isinstance(m, mlp_mod.Dropout)]
    cnns = [m for m in model.modules() if isinstance(m, cnn_mod.CNN)]
    group = axis_group(mesh, DATA)

    def moments(mean, sq, rows):
        # each rank's moments weighted by its share of the rows; a world
        # of one multiplies by 1.0, the single-device statistics exactly
        w = rows / n
        both = allreduce_sum(torch.stack([mean * w, sq * w]), group)
        return both[0], both[1]
    for m in drops:
        m.rows = (n, start, stop)
    for m in cnns:
        m.bn_reduce = moments
    try:
        yield
    finally:
        for m in drops:
            m.rows = None
        for m in cnns:
            m.bn_reduce = None


def _allreduce_flat(tensors: list, group) -> None:
    """Sum each tensor over `group`, in place, in one collective."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()


def data_parallel_backward(model: nn.Module, optimizer: ClipAdamW,
                           xb: torch.Tensor, yb: torch.Tensor, n: int,
                           start: int, mesh, label_smoothing: float = 0.05):
    """Forward and backward of this rank's rows (xb, yb) = rows [start,
    start + len(yb)) of a global batch of n, with the loss the mean over
    the global batch (K11 on the card, at scale 1/n: this rank's share);
    then the optimizer's flat gradients, the loss sum and the correct
    count summed over `data` in one all-reduce of its `grad_and_stats`.
    Returns (loss sum, correct count) of the global batch, device
    scalars; the gradients are left in the optimizer's flat buffer (each
    `p.grad` a view of it), equal on every rank."""
    model.train()
    k = len(yb)
    optimizer.zero_grad()
    with data_parallel_rows(model, n, start, start + k, mesh):
        logits = model(xb)
    stats = optimizer.grad_and_stats[optimizer.n:]
    if k:
        loss, correct = softmax_xent(logits, yb, label_smoothing, 1.0 / n)
        stats[0] = loss.detach() * n
        stats[1] = correct
    else:  # no rows: still in the graph, for the collectives' backward
        loss = logits.sum() * 0.0
    loss.backward()
    dist.all_reduce(optimizer.grad_and_stats, group=axis_group(mesh, DATA))
    return stats[0], stats[1].round().to(torch.int64)


# ---------------------------------------------------------------------------
# inference
# ---------------------------------------------------------------------------
def replicate_predictor(predictor, mesh) -> None:
    """The predictor's MLP and CNN weights broadcast from rank 0."""
    for m in (predictor.mlp, predictor.cnn):
        if m is not None:
            replicated(m, mesh)


def make_sharded_transcribe(predictor, scaler, mesh, sr: int,
                            mfcc_params: dict,
                            melspec_params: dict | None,
                            gather: bool = True):
    """run(clips (B, L)) → (ensemble probs (B, C), YIN pitch (B,)), the
    clip batch split over `data`: every rank passes the same full batch,
    runs its rows through the port's ensemble (`infer/pipeline.py::
    build_clip_ensemble_fn`: K1, K2 and K3 on the card, or K1 and K6 on
    the shared route), and gets the gathered full outputs; `gather=False` returns this rank's
    rows only. The predictor lives on this rank's device; its weights
    are broadcast from rank 0 here."""
    from ..infer.pipeline import build_clip_ensemble_fn
    replicate_predictor(predictor, mesh)
    ensemble = build_clip_ensemble_fn(predictor, scaler, sr, mfcc_params,
                                      melspec_params)
    rows = data_sharding(mesh, 2)

    @torch.no_grad()
    def run(clips):
        n = clips.shape[0]
        local = rows.local(clips).to(torch.float32)
        probs, pitch = ensemble(local, with_pitch=True)
        if not gather:
            return probs, pitch
        return rows.gather(probs, n), rows.gather(pitch, n)

    return run


def sharded_batch_pitch(mesh, sr: int):
    """run(clips (B, L)) → YIN pitch (B,), the clips split over `data`
    (K3 on each rank's rows), gathered on every rank."""
    from ..ops.yin import yin_pitch
    rows = data_sharding(mesh, 2)

    @torch.no_grad()
    def run(clips):
        local = rows.local(clips).to(torch.float32)
        return rows.gather(yin_pitch(local, sr), clips.shape[0])

    return run


def make_sharded_transcribe_files(transcriber, mesh, target_sr: int,
                                  clip_duration: float, max_onsets: int):
    """fn(ys (B, n), n_valids (B,)) → per-file (B, K, ...) outputs of the
    batched file body (`infer/pipeline.py::build_files_fn`: gating,
    onsets, slicing, re-rating, ensemble, YIN; K1-K5 on the card), the
    files split over `data`: each rank segments and transcribes its own
    files and the outputs are gathered. The predictor's weights are
    broadcast from rank 0 here."""
    from ..infer.pipeline import build_files_fn
    replicate_predictor(transcriber.predictor, mesh)
    melspec = (transcriber.melspec_params if "cnn" in transcriber.model_ckpts
               else None)
    return build_files_fn(transcriber.predictor, transcriber.scaler,
                          transcriber.ckpt_sr, transcriber.mfcc_params,
                          melspec, target_sr, clip_duration, max_onsets,
                          rows=data_sharding(mesh, 2))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def adamw(lr: float = 1e-3, weight_decay: float = 1e-4):
    """The optimizer factory params → the port's AdamW (K12 on the card)
    with optax.adamw's defaults (betas 0.9/0.999, eps 1e-8, weight decay
    1e-4 on every parameter) and no clip."""
    def make(params):
        return ClipAdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                         weight_decay=weight_decay, hyper_f32=False)
    return make


def mlp_tp_shardings(model, mesh) -> dict:
    """Tensor-parallel layout of the MLP, in the MLP's state_dict layout
    (Linear weights (out, in)): {name: one axis name or None per dim}.
    The hidden activations are sharded over `model`: dense_0 column-
    sharded (its kernel's output columns, the weight's rows), every later
    dense kernel and `out` row-sharded (their input rows, the weight's
    columns), the hidden biases and the ln_* parameters sharded, `out`'s
    bias replicated."""
    specs = {}
    for name, p in model.named_parameters():
        layer = name.split(".")[0]
        if p.ndim == 2:
            specs[name] = ((MODEL, None) if layer == "dense_0"
                           else (None, MODEL))
        elif layer.startswith(("dense_", "ln_")):
            specs[name] = (MODEL,)
        else:
            specs[name] = (None,)
    return specs


class _Shard(nn.Module):
    def __init__(self, weight: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        self.weight = nn.Parameter(weight.detach().clone())
        self.bias = nn.Parameter(bias.detach().clone())


class TensorParallelMLP(nn.Module):
    """This rank's shard of an MLP under `mlp_tp_shardings`: the hidden
    units [k·w/m, (k+1)·w/m) of every hidden layer for model index k of
    m. Parameter names are the MLP's. forward(x) takes this rank's rows
    (all features) and returns their full logits on every rank of the
    `model` group; as the loss is then the same on all m of them, a step
    divides it by m and sums the replicated parameters' gradients over
    the whole mesh and the sharded ones over `data`."""

    def __init__(self, mlp: mlp_mod.MLP, mesh):
        super().__init__()
        self.mesh = mesh
        self.n_hidden = mlp.n_hidden
        self.init_args = mlp.init_args
        self.p = float(mlp.dropout.p)
        self.generator: torch.Generator | None = mlp.dropout.generator
        self.rows: tuple[int, int, int] | None = None
        self.eps = mlp.ln_0.eps
        m, k = axis_size(mesh, MODEL), axis_rank(mesh, MODEL)
        specs = mlp_tp_shardings(mlp, mesh)
        self.widths = []
        for i in range(self.n_hidden):
            w = mlp.get_submodule(f"dense_{i}").out_features
            if w % m:
                raise ValueError(f"[TensorParallelMLP] hidden width {w} of "
                                 f"dense_{i} not divisible by model={m}")
            self.widths.append(w)
        sd = dict(mlp.named_parameters())

        def shard(name):
            t = sd[name]
            for dim, ax in enumerate(specs[name]):
                if ax == MODEL:
                    size = t.shape[dim] // m
                    t = t.narrow(dim, k * size, size)
            return t
        for layer in [f"dense_{i}" for i in range(self.n_hidden)] + [
                f"ln_{i}" for i in range(self.n_hidden)] + ["out"]:
            self.add_module(layer, _Shard(shard(f"{layer}.weight"),
                                          shard(f"{layer}.bias")))
        self.sharded = {name for name, s in specs.items() if MODEL in s}

    def _cols(self, i: int) -> tuple[int, int]:
        m, k = axis_size(self.mesh, MODEL), axis_rank(self.mesh, MODEL)
        w = self.widths[i] // m
        return k * w, (k + 1) * w

    def _dropout(self, h: torch.Tensor, i: int) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return h
        keep = 1.0 - self.p
        n = self.rows[0] if self.rows else h.shape[0]
        mask = torch.empty((n, self.widths[i]), dtype=h.dtype,
                           device=h.device).bernoulli_(
                               keep, generator=self.generator)
        s, e = (self.rows[1], self.rows[2]) if self.rows else (0, n)
        c0, c1 = self._cols(i)
        mask = mask[s:e, c0:c1]
        return torch.where(mask.bool(), h / keep, torch.zeros_like(h))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        group = axis_group(self.mesh, MODEL)
        d0 = self.get_submodule("dense_0")
        h = F.linear(x, d0.weight, d0.bias)
        for i in range(self.n_hidden):
            if i > 0:
                di = self.get_submodule(f"dense_{i}")
                full = allreduce_sum(F.linear(h, di.weight), group)
                c0, c1 = self._cols(i)
                h = full[:, c0:c1] + di.bias
            ln = self.get_submodule(f"ln_{i}")
            w = float(self.widths[i])
            sums = allreduce_sum(torch.stack([h.sum(-1), (h * h).sum(-1)]),
                                 group)
            mean = (sums[0] / w)[:, None]
            var = torch.clamp(sums[1] / w - (sums[0] / w) ** 2,
                              min=0.0)[:, None]
            h = (h - mean) * torch.rsqrt(var + self.eps) * ln.weight + ln.bias
            h = self._dropout(F.leaky_relu(h, 0.1), i)
        out = self.get_submodule("out")
        return allreduce_sum(F.linear(h, out.weight), group) + out.bias


@dataclass
class ShardedTrainState:
    """A model on this rank's device (replicated, or this rank's
    TensorParallelMLP shard) and its optimizer."""
    module: nn.Module
    optimizer: ClipAdamW


def make_sharded_train_step(model, tx=None, mesh=None,
                            label_smoothing: float = 0.05,
                            tp_mlp: bool = False):
    """(step, prepare) of a training step over the mesh with global-batch
    semantics: every rank passes the same full batch, computes its rows
    along `data`, and the gradients are summed before `tx`'s update, so
    each step is the single-device step. `tx` is an optimizer factory
    params → optimizer (default `adamw()`, optax.adamw(1e-3)'s).

    prepare() → ShardedTrainState: the model moved to this rank's device
    with its parameters and buffers broadcast from rank 0, or, with
    `tp_mlp` and an MLP, this rank's TensorParallelMLP shard; and its
    optimizer. step(state, xb, yb, generator=None) → the global batch's
    mean loss (device scalar), the state updated in place; `generator`
    draws the dropout masks."""
    tx = tx or adamw()
    use_tp = tp_mlp and isinstance(model, mlp_mod.MLP)

    def prepare() -> ShardedTrainState:
        module = model.to(mesh_device(mesh))
        replicated(module, mesh)
        if use_tp:
            module = TensorParallelMLP(module, mesh)
        return ShardedTrainState(module, tx(list(module.parameters())))

    def step(state: ShardedTrainState, xb, yb, generator=None):
        module = state.module
        rows = data_sharding(mesh)
        n = len(yb)
        start, _ = row_range(n, mesh)
        xl = rows.local(xb).to(torch.float32)
        yl = rows.local(yb).to(torch.int64)
        if not use_tp:
            for m in module.modules():
                if isinstance(m, mlp_mod.Dropout) and generator is not None:
                    m.generator = generator
            loss_sum, _ = data_parallel_backward(module, state.optimizer, xl,
                                                 yl, n, start, mesh,
                                                 label_smoothing)
        else:
            if generator is not None:
                module.generator = generator
            module.train()
            module.rows = (n, start, start + len(yl))
            try:
                logits = module(xl)
            finally:
                module.rows = None
            loss_sum, _ = softmax_xent(logits, yl, label_smoothing, 1.0)
            state.optimizer.zero_grad()
            (loss_sum / (n * axis_size(mesh, MODEL))).backward()
            sharded = [p for name, p in module.named_parameters()
                       if name in module.sharded]
            whole = [p for name, p in module.named_parameters()
                     if name not in module.sharded]
            stats = loss_sum.detach()[None]
            _allreduce_flat([p.grad for p in sharded] + [stats],
                            axis_group(mesh, DATA))
            _allreduce_flat([p.grad for p in whole], None)
            loss_sum = stats[0]
        state.optimizer.step()
        return loss_sum / n

    return step, prepare
