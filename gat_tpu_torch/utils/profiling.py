"""Stage timing and device traces of the port, the twin of
`gat_tpu/utils/profiling.py` on `torch.profiler`.

`StageTimer` accumulates named stage durations on the host clock and
waits for the card's work only where the caller says which results to
wait for (`block_on`): PyTorch returns before the device finishes, so a
stage timed without it records the enqueue only. `device_trace` records
the CPU and, with a card, the CUDA activity of a block into a gzipped
Chrome trace (`*.pt.trace.json.gz`, as jax.profiler writes its traces)
that TensorBoard or ui.perfetto.dev opens; `annotate` labels a region in
it. DEVICE_CATEGORIES are the categories of the card's work in such a
trace.
"""
from __future__ import annotations

import contextlib
import tempfile
import time
from pathlib import Path

import torch

__all__ = ["StageTimer", "stage", "device_trace", "annotate",
           "DEVICE_CATEGORIES"]

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _wait_for(x) -> None:
    """Wait on the current CUDA stream of every card that holds a tensor
    of x (a tensor, or a tuple or list of them, nested); CPU tensors and
    anything else need no wait."""
    stack, devices = [x], set()
    while stack:
        item = stack.pop()
        if isinstance(item, torch.Tensor):
            if item.is_cuda:
                devices.add(item.device)
        elif isinstance(item, (tuple, list)):
            stack.extend(item)
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()


class StageTimer:
    """Accumulates named stage durations; print() for a summary table."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        """Time a block. `block_on` (a tensor, a tuple or list of them, or
        a zero-argument callable returning one) is waited for before the
        timer stops, so the stage includes the card's work. It is
        evaluated at exit, and tensors made inside the block do not exist
        at entry, so pass a callable for them:

            with timer.stage("fwd", block_on=lambda: out):
                out = model(x)

        A tensor passed directly covers only work enqueued before the
        block."""
        t0 = time.perf_counter()
        try:
            yield
            # only on the path without an exception: when the block raised
            # before making its tensors, `lambda: out` would raise a
            # NameError here and replace the caller's exception
            if block_on is not None:
                _wait_for(block_on() if callable(block_on) else block_on)
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        lines = [f"{'stage':<28}{'calls':>7}{'total_s':>10}{'mean_ms':>10}"]
        for name, tot in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:<28}{n:>7}{tot:>10.3f}"
                         f"{1000.0 * tot / n:>10.2f}")
        return "\n".join(lines)

    def print(self):
        print(self.summary())


@contextlib.contextmanager
def stage(name: str):
    """One-off stage timer: prints '[stage] name: X.XXXs' on exit."""
    t0 = time.perf_counter()
    yield
    print(f"[stage] {name}: {time.perf_counter() - t0:.3f}s")


@contextlib.contextmanager
def device_trace(log_dir=None):
    """torch.profiler trace of a block, CPU and (with a card) CUDA
    activity, written under `log_dir` (default: gat_tpu_torch_trace in
    the temporary directory) when the block ends; yields the directory."""
    log_dir = str(log_dir or Path(tempfile.gettempdir())
                  / "gat_tpu_torch_trace")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir, use_gzip=True)):
        yield log_dir


def annotate(name: str):
    """A labelled region inside a trace (torch.profiler.record_function)
    while a profiler records, and nothing otherwise: a range costs
    microseconds of host time even with no profiler running, and the
    wave body enters a dozen on every call."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()
