"""Build and load the hand-written CUDA kernels of `csrc/`.

Each `csrc/<name>.cu` is compiled on its own by nvcc for Hopper
(`sm_90a`) into a shared library with a plain C interface, which is loaded
with ctypes. Nothing is compiled at import: a kernel is built at its first
launch, or ahead of time by `build()`, which runs one nvcc per source, all
at once. A library's file name carries a hash of its sources and flags, so
an edited source is rebuilt and an unchanged one is reused.

Every C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `check` raises on anything but 0. A wrapper's
launch costs little host time: `function` resolves an entry point and
sets its argument types once, `device_guard` switches the current device
only when the tensor is on another one, and `stream` reads the current
stream's handle without building a `torch.cuda.Stream`.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import torch

from .config import KERNEL_BUILD_DIR

__all__ = ["KERNELS", "build", "function", "device_guard", "stream",
           "ticket", "plan", "check_input", "check_samples", "check",
           "nvcc_path"]

CSRC = Path(__file__).resolve().parent / "csrc"
KERNELS = ("melspec_frontend", "mfcc_frontend", "yin_pitch", "onset_envelope",
           "onset_pick", "mfcc_pitch_frontend", "noise_gate", "slice_clips",
           "resample", "wave_compact", "softmax_xent", "clip_adamw",
           "batchnorm_train")
# The clip kernels index a clip's samples as int, and reach up to a
# frame's half (1024 samples) and a stride of loads (2048) past its end:
# a clip of more samples than this cannot be addressed by them.
MAX_SAMPLES = 2**31 - 2**16
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_functions: dict[tuple[str, str], ctypes._CFuncPtr] = {}
_tickets: dict[tuple[int, int], torch.Tensor] = {}
_plans: dict[tuple, tuple[int, int, int, int]] = {}


def nvcc_path() -> str:
    """nvcc of the CUDA toolkit that PyTorch finds (CUDA_HOME, PATH or the
    default install); raises when there is none."""
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = Path(CUDA_HOME or "") / "bin" / "nvcc"
    if not CUDA_HOME or not nvcc.is_file():
        raise RuntimeError("[gat_tpu_torch.kernels] nvcc not found: the CUDA "
                           "kernels are built on a machine with the CUDA "
                           "toolkit (set CUDA_HOME)")
    return str(nvcc)


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return KERNEL_BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict[str, str]:
    """Compile the named kernels that are not built yet, one nvcc process
    per source, all started together. Returns nvcc's report (registers,
    shared memory, spills) per kernel compiled in this call."""
    todo = {n: _library_path(n) for n in names}
    todo = {n: p for n, p in todo.items() if not p.is_file()}
    if not todo:
        return {}
    nvcc = nvcc_path()
    KERNEL_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, lib in todo.items():
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    reports, failed = {}, []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("[gat_tpu_torch.kernels] build failed: "
                           + "\n".join(failed))
    return reports


def function(name: str, symbol: str, argtypes: list):
    """The C entry point `symbol` of kernel `name`, building and loading
    its library on first use. Its argument types are set at the first
    resolve and the entry point is cached, so every later call is one
    dict lookup. Pointers and the stream are c_void_p."""
    fn = _functions.get((name, symbol))
    if fn is not None:
        return fn
    with _lock:
        fn = _functions.get((name, symbol))
        if fn is None:
            lib = _libs.get(name)
            if lib is None:
                build([name])
                lib = _libs[name] = ctypes.CDLL(str(_library_path(name)))
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _functions[(name, symbol)] = fn
    return fn


def device_guard(device: torch.device):
    """`torch.cuda.device(device)` when `device` is not the current CUDA
    device, else a context that does nothing."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def stream(device: torch.device) -> int:
    """The handle of `device`'s current CUDA stream, as PyTorch's own
    generated kernels read it (`torch.cuda.current_stream().cuda_stream`
    builds a Stream object on every call)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def ticket(device: torch.device) -> torch.Tensor:
    """The int32 ticket of the kernels that finish a reduction in their
    last block (K11, K13): 0 before a launch and reset to 0 by its last
    block. One a (device, stream), made once, so launches that share it
    run one after another."""
    key = (device.index, stream(device))
    t = _tickets.get(key)
    if t is None:
        t = _tickets[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return t


def check_input(clips, name: str) -> None:
    """Raise unless `clips` is what every kernel here takes: contiguous
    float32 of shape (N, L)."""
    if clips.dtype != torch.float32 or clips.ndim != 2:
        raise ValueError(f"[{name}] kernel takes float32 clips (N, L), got "
                         f"{clips.dtype} {tuple(clips.shape)}")
    if not clips.is_contiguous():
        raise ValueError(f"[{name}] kernel takes contiguous clips")


def plan(name: str, symbol: str, device: torch.device, *sizes: int
         ) -> tuple[int, int, int, int]:
    """How a clip front-end (K1, K2, K3, K6) runs these sizes on `device`,
    as its C entry point `symbol` (`gat_*_plan`) plans it from the card's
    SMs and the kernel's resident blocks: (frames a tile, 0 for one block
    a clip; tiles a clip; resident blocks per SM of the kernel that runs
    the frames; floats of device-memory scratch a clip). The split route
    (`csrc/dsp_common.cuh`) is taken past a frame count where one block a
    clip leaves the card under-filled. Remembered per (device, symbol,
    sizes)."""
    key = (device.index, symbol, sizes)
    got = _plans.get(key)
    if got is None:
        out = (ctypes.c_int * 4)()
        fn = function(name, symbol,
                      [ctypes.c_int] * len(sizes) + [ctypes.c_void_p])
        with device_guard(device):
            check(fn(*sizes, ctypes.addressof(out)), f"{name} plan")
        got = _plans[key] = tuple(out)
    return got


def check_samples(length: int, name: str) -> None:
    """Raise where a clip of `length` samples cannot be addressed by the
    clip kernels' C entry points (more than MAX_SAMPLES samples)."""
    if length > MAX_SAMPLES:
        raise ValueError(f"[{name}] clips of {length} samples: the kernel "
                         f"addresses at most {MAX_SAMPLES} samples a clip")


def check(status: int, name: str) -> None:
    """Raise on a non-zero cudaError_t from a launch."""
    if status != 0:
        raise RuntimeError(f"[gat_tpu_torch.kernels] {name} launch failed: "
                           f"cudaError {status}")
