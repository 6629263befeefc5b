#!/usr/bin/env python
"""Device-op profiling of the PyTorch port, the twin of
`tools/profile_trace.py`: trace one graph of the port and print the top
device kernels by total time.

Runs `torch.profiler` (CPU and CUDA activities) around `--iters` runs of
the chosen graph, on inputs distinct per iteration (a pool of 4) after
two warm-up calls, writes a gzipped Chrome trace under `--trace_dir`,
then parses it directly (no TensorBoard needed) and prints a per-kernel
duration table, a rollup by event category (its time and its number of
events: kernels launched over the traced calls) and the share of device time
of the port's kernels K1-K10 (`gat_tpu_torch/utils/roofline.py`'s
KERNEL_SYMBOLS).

Graphs: `clip`, the flagship clip batch (`gat_tpu_torch.entry.entry`);
`file`, the fused single-file body (`Transcriber._files_fn` at one
file); `files`, the batched multi-file wave (`Transcriber._files_fn`'s
`run`, or `run_scan` over `--scan` waves). `--device cuda` (the default)
raises without a card; `--device cpu` traces the plain PyTorch path
(host lanes only).

Usage: python tools/torch_profile_trace.py [--graph clip|file|files]
       [--batch 1024] [--iters 8] [--trace_dir DIR] [--top 25]
       [--device cuda|cpu] [--parse_only]
"""
import argparse
import collections
import glob
import gzip
import json
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def kernel_shares(dur: dict) -> dict:
    """{K1..K10: total µs of that kernel's device functions} from a
    name → µs table, each name read by `roofline.device_function`."""
    from gat_tpu_torch.utils.roofline import KERNEL_SYMBOLS, device_function
    return {k: sum(us for name, us in dur.items()
                   if device_function(name) in syms)
            for k, syms in KERNEL_SYMBOLS.items()}


def parse_trace(trace_dir: str, top: int = 25):
    """[(file, top rows [(name, µs)], K1-K10 µs)] for every
    `*.trace.json.gz` under `trace_dir`. Only device lanes are summed
    (host Python and launch events would otherwise dominate and
    misattribute the time); a trace with none keeps all lanes, and says
    so."""
    from gat_tpu_torch.utils.profiling import DEVICE_CATEGORIES
    files = sorted(glob.glob(f"{trace_dir}/**/*.trace.json.gz",
                             recursive=True))
    tables = []
    for f in files:
        with gzip.open(f, "rt") as fh:
            data = json.load(fh)
        events = [e for e in data.get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
        device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
        lanes = device or events
        dur = collections.Counter()
        by_cat = collections.Counter()
        n_cat = collections.Counter()
        for e in lanes:
            dur[e.get("name", "?")] += e["dur"]
            by_cat[e.get("cat") or "(uncategorized)"] += e["dur"]
            n_cat[e.get("cat") or "(uncategorized)"] += 1
        rows = dur.most_common(top)
        shares = kernel_shares(dur)
        tables.append((f, rows, shares))
        scope = ("device lanes" if device
                 else "all lanes (no device lane found)")
        print(f"--- {Path(f).name}: top {top} by total us ({scope}) ---")
        for name, us in rows:
            print(f"{us:>12.1f} us  {name[:90]}")
        total = sum(by_cat.values()) or 1
        print(f"--- by category ({total / 1e3:.3f} ms) ---")
        for c, us in by_cat.most_common():
            print(f"{us:>12.1f} us  {us / total:6.1%}  {c} ({n_cat[c]} "
                  f"events)")
        if device:
            print("--- the port's kernels (share of device time) ---")
            for k, us in shares.items():
                print(f"{us:>12.1f} us  {us / total:6.1%}  {k}")
    return tables


def trace_inputs(graph: str, batch: int, file_s: float, n_files: int,
                 budget: int | None = None, scan: int = 1,
                 max_onsets: int = 128, cand: int | None = None,
                 device: str = "cuda"):
    """(fn, list of distinct device-resident input tuples) for the chosen
    graph."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)

    def put(shape, sigma):
        return torch.from_numpy(
            rng.normal(0, sigma, shape).astype(np.float32)).to(device)

    if graph == "clip":
        from gat_tpu_torch.entry import entry
        fn, (ex,) = entry(batch=batch, device=device)
        return fn, [(put((batch, ex.shape[1]), 0.1),) for _ in range(4)]

    from gat_tpu_torch.config import CLIP_DURATION, TARGET_SR
    from gat_tpu_torch.infer import Transcriber
    t = Transcriber(device=device)
    n = int(file_s * TARGET_SR)
    if graph == "file":
        run, _ = t._files_fn(TARGET_SR, CLIP_DURATION, 128)
        nv = torch.tensor([n], device=device)
        return run, [(put((1, n), 0.05), nv) for _ in range(4)]
    if graph == "files":
        run, run_scan = t._files_fn(TARGET_SR, CLIP_DURATION, max_onsets,
                                    wave_clip_budget=budget,
                                    cand_budget=cand)
        if scan > 1:  # the chunk of K waves with no host sync between
            nv = torch.full((scan, n_files), n, device=device)
            return run_scan, [(put((scan, n_files, n), 0.05), nv)
                              for _ in range(4)]
        nv = torch.full((n_files,), n, device=device)
        return run, [(put((n_files, n), 0.05), nv) for _ in range(4)]
    raise SystemExit(f"unknown --graph {graph!r}")


def trace(fn, pool, iters: int, trace_dir) -> None:
    """Two warm-up calls, then `iters` calls over the pool under
    torch.profiler (`utils/profiling.py::device_trace`), written as a
    gzipped Chrome trace to `trace_dir`."""
    import torch
    from gat_tpu_torch.utils.profiling import device_trace

    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    with torch.no_grad():
        for _ in range(2):
            fn(*pool[0])
        sync()
        with device_trace(trace_dir):
            for i in range(iters):
                fn(*pool[i % len(pool)])
            sync()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", choices=("clip", "file", "files"),
                    default="clip",
                    help="which graph to trace: the flagship clip batch, "
                         "the single-file path, or the batched multi-file "
                         "path")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--file_s", type=float, default=60.0)
    ap.add_argument("--n_files", type=int, default=8)
    ap.add_argument("--budget", type=int, default=None,
                    help="wave_clip_budget for --graph files")
    ap.add_argument("--onsets", type=int, default=128,
                    help="max_onsets for --graph files (shipped serving "
                         "config: 112)")
    ap.add_argument("--cand", type=int, default=None,
                    help="cand_budget for --graph files (shipped: 448)")
    ap.add_argument("--scan", type=int, default=1,
                    help="K file-batches per dispatch for --graph files "
                         "(traces the chunk of K waves)")
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--trace_dir",
                    default=str(Path(tempfile.gettempdir())
                                / "gat_torch_trace"))
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (the default) needs a card and raises "
                         "without one; cpu traces the plain PyTorch path")
    ap.add_argument("--parse_only", action="store_true",
                    help="only parse an existing trace dir")
    args = ap.parse_args(argv)

    if not args.parse_only:
        fn, pool = trace_inputs(args.graph, args.batch, args.file_s,
                                args.n_files, args.budget, args.scan,
                                args.onsets, args.cand, args.device)
        trace(fn, pool, args.iters, args.trace_dir)
    return parse_trace(args.trace_dir, args.top)


if __name__ == "__main__":
    main()
