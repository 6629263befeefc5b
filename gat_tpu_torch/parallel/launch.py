"""Starting the ranks of a multi-device run: one process per device, SPMD
on `torch.distributed`, the counterpart of the JAX package's single
controller over a virtual or real device mesh.

* `spawn(fn, world, *args, device=...)` starts `world` processes with
  `torch.multiprocessing` (the spawn method), each initialised into one
  process group (NCCL on the card, gloo on the CPU) through a `FileStore`
  in a temporary directory, so that concurrent worlds on one machine
  never meet on a port. Rank r runs on `cuda:(r % device_count)` or the
  CPU. Every rank calls `fn(*args)`; `spawn` returns their results in
  rank order. The join has a deadline: when a rank fails or the deadline
  passes, every rank is ended and `spawn` raises with the failing rank's
  traceback, so a rank that raised never leaves the others waiting in a
  collective.
* `init_from_env()` joins a world that `torchrun` started.
* `abort_rank()` ends this rank at once, from any thread, after a fault
  that may leave the other ranks waiting in a collective it will not
  join; `spawn` (or torchrun's agent) then ends the world.
"""
from __future__ import annotations

import datetime
import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

__all__ = ["spawn", "init_from_env", "under_torchrun", "backend_for",
           "check_world", "abort_rank"]

# (result directory, rank) of a rank that `spawn` started
_REPORT: tuple[Path, int] | None = None


def backend_for(device: str) -> str:
    """NCCL for the card, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_world(world: int, device: str) -> None:
    """Refuse a world the device cannot hold: a card world needs CUDA and
    at most one rank per card."""
    if world < 1:
        raise ValueError(f"[parallel] a world needs 1 or more ranks, got "
                         f"{world}")
    if torch.device(device).type != "cuda":
        return
    if not torch.cuda.is_available():
        raise RuntimeError(
            "[gat_tpu_torch.parallel] CUDA device requested but torch.cuda "
            "is not available; pass device='cpu' to run the ranks on the "
            "CPU (gloo)")
    if world > torch.cuda.device_count():
        raise ValueError(f"[parallel] {world} ranks need {world} cards; "
                         f"this machine has {torch.cuda.device_count()}")


def _init(rank: int, world: int, device: str, store_path: str,
          timeout_s: float) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:  # the CPU's cores shared among the ranks, not each taking all
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(
        backend_for(device), store=dist.FileStore(store_path, world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    # every rank has joined before any runs fn: gloo's init connects each
    # pair of ranks, and a rank that finished fn and left the group while a
    # peer was still connecting to it failed that peer's init ("Connection
    # closed by peer")
    dist.barrier()


def _write_error(out: Path, rank: int) -> None:
    """The exception being handled, for the launcher. The time first: the
    rank that failed first is the cause, the others' errors (a peer gone
    from a collective) its effects."""
    tmp = out / f"error_{rank}.tmp"
    tmp.write_text(f"{time.time():.6f}\n{traceback.format_exc()}")
    os.replace(tmp, out / f"error_{rank}.txt")


def _rank_main(rank: int, world: int, device: str, store_path: str,
               timeout_s: float, out_dir: str, fn, args) -> None:
    """One rank: join the group, run fn, write its result (or its
    traceback) to out_dir, leave the group."""
    global _REPORT
    out = Path(out_dir)
    _REPORT = (out, rank)
    code = 0
    try:
        _init(rank, world, device, store_path, timeout_s)
        result = fn(*args)
        tmp = out / f"result_{rank}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(result, f)
        os.replace(tmp, out / f"result_{rank}.pkl")
    except BaseException:  # noqa: BLE001 - reported to the launcher
        _write_error(out, rank)
        code = 1
    finally:
        if dist.is_initialized():
            try:
                dist.destroy_process_group()
            except Exception:  # noqa: BLE001 - the rank is ending anyway
                pass
    if code:
        os._exit(code)


def _first_failure(procs, out: Path) -> tuple[int, str]:
    """(rank, traceback) of the rank whose error came first; a rank that
    died without writing one (killed) counts after those that did."""
    time.sleep(0.5)  # the others' errors, if they are on their way
    found = []
    for r, p in enumerate(procs):
        err = out / f"error_{r}.txt"
        if err.is_file():
            stamp, _, tb = err.read_text().partition("\n")
            found.append((float(stamp), r, tb))
        elif p.exitcode not in (None, 0):
            found.append((float("inf"), r, f"exit code {p.exitcode}"))
    _, r, detail = min(found)
    return r, detail


def _end_all(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5.0)
        if p.is_alive():
            p.kill()
            p.join()


def spawn(fn, world: int, *args, device: str = "cuda",
          timeout_s: float | None = 600.0) -> list:
    """fn(*args) on `world` ranks of one process group; returns each
    rank's result, rank 0 first. `fn` and its arguments and results must
    pickle (a module-level function). `timeout_s` is the whole run's
    deadline and the process group's timeout (None: no deadline, for a
    server or a long training, and a hung collective ends at a group
    timeout of 600 s). Raises RuntimeError naming the first rank that
    failed, with its traceback, or TimeoutError at the deadline; either
    way every rank has ended."""
    check_world(world, device)
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="gat_world_")
    try:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(
            target=_rank_main,
            args=(r, world, device, store,
                  timeout_s or 600.0, tmp, fn, args),
            daemon=False) for r in range(world)]
        for p in procs:
            p.start()
        deadline = (float("inf") if timeout_s is None
                    else time.monotonic() + timeout_s)
        try:
            while True:
                if any(p.exitcode not in (None, 0) for p in procs):
                    r, detail = _first_failure(procs, Path(tmp))
                    raise RuntimeError(f"[parallel.spawn] rank {r} of "
                                       f"{world} failed:\n{detail}")
                if all(p.exitcode == 0 for p in procs):
                    break
                if time.monotonic() > deadline:
                    alive = [r for r, p in enumerate(procs) if p.is_alive()]
                    raise TimeoutError(f"[parallel.spawn] ranks {alive} of "
                                       f"{world} still running after "
                                       f"{timeout_s:g} s")
                time.sleep(0.05)
        finally:
            _end_all(procs)
        results = []
        for r in range(world):
            with open(Path(tmp) / f"result_{r}.pkl", "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def under_torchrun() -> bool:
    """True in a process that `torchrun` started (its rank variables are
    set)."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE",
                                         "LOCAL_RANK", "MASTER_ADDR"))


def init_from_env(device: str = "cuda",
                  timeout_s: float = 600.0) -> tuple[int, int]:
    """Join the world `torchrun` started (env:// rendezvous), on
    `cuda:LOCAL_RANK` or the CPU; returns (rank, world size). Does
    nothing when the group is already initialised."""
    if not dist.is_initialized():
        if torch.device(device).type == "cuda":
            check_world(1, device)  # the cards of this node are enough
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"])
                                  % torch.cuda.device_count())
        dist.init_process_group(
            backend_for(device), init_method="env://",
            timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_rank(), dist.get_world_size()


def abort_rank() -> None:
    """End this process at once, from any thread, with the exception being
    handled: for a fault after which the other ranks may wait in a
    collective this rank will not join. The traceback goes to stderr and,
    in a rank of `spawn`, to the launcher, which ends every rank and names
    this one; under torchrun the agent ends the world on the exit code."""
    traceback.print_exc()
    if _REPORT is not None:
        _write_error(*_REPORT)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(1)
