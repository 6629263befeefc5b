"""ctypes bindings for the port's native WAV codec (`native/wav_codec.cpp`).

The codec is compiled by g++ at first use, never at import, into the
build directory (`config.KERNEL_BUILD_DIR`), under a file name that
carries a hash of its source and flags, so an edited source is rebuilt.
Without the toolchain every entry point degrades to the pure-Python codec
of `utils/wavio.py`, and says why once. ctypes releases the GIL during
the C call, so `read_wav_batch` decodes many files in parallel threads.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from ..config import KERNEL_BUILD_DIR

__all__ = ["native_available", "read_wav_native", "read_wav_batch",
           "write_wav_native", "write_wav_batch"]

_SRC = Path(__file__).resolve().parent.parent / "native" / "wav_codec.cpp"
_FLAGS = ("-O2", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_tried = False

# subtypes the native encoder implements (bits per sample), consulted by
# write_wav_native and by the batch writer's pre-check alike
_NATIVE_SUBTYPES = {"PCM_16": 16, "FLOAT": 32}


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return KERNEL_BUILD_DIR / f"libwavcodec-{h.hexdigest()[:16]}.so"


def _map_batch(fn, items, max_workers: int | None):
    """Order-preserving thread-pool map; sequential for one item."""
    items = list(items)
    workers = max_workers or min(16, (os.cpu_count() or 4))
    if len(items) <= 1 or workers == 1:
        return [fn(it) for it in items]
    with ThreadPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(fn, items))


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib_path = _library_path()
            if not lib_path.is_file():
                lib_path.parent.mkdir(parents=True, exist_ok=True)
                # compile to a per-process name and publish by an atomic
                # rename: another process must never load a half-written
                # library
                tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
                try:
                    subprocess.run(["g++", *_FLAGS, "-o", str(tmp),
                                    str(_SRC)],
                                   check=True, capture_output=True,
                                   timeout=120)
                    os.replace(tmp, lib_path)
                finally:
                    tmp.unlink(missing_ok=True)
            lib = ctypes.CDLL(str(lib_path))
            lib.wav_probe.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_long)]
            lib.wav_probe.restype = ctypes.c_int
            lib.wav_decode.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                ctypes.c_long, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_long)]
            lib.wav_decode.restype = ctypes.c_int
            lib.wav_encode.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                ctypes.c_long, ctypes.c_int, ctypes.c_int]
            lib.wav_encode.restype = ctypes.c_int
            _lib = lib
        except (OSError, subprocess.SubprocessError) as e:
            # the failure is kept for the life of the process and the
            # decode stage becomes much slower, so say why, once
            detail = (e.stderr.decode(errors="replace").strip()
                      if getattr(e, "stderr", None) else str(e))
            print("[native_wav] native codec unavailable, falling back to "
                  f"the pure-Python WAV codec ({type(e).__name__}: "
                  f"{detail[:500]})")
            _lib = None
        return _lib


def native_available() -> bool:
    return _load() is not None


def read_wav_native(path) -> tuple[np.ndarray, int]:
    """Decode one file to mono float32 with the native codec. A missing
    file raises FileNotFoundError; any other failure raises ValueError
    (callers fall back to the Python decoder)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("[read_wav_native] native codec unavailable")
    p = os.fsencode(path)  # not .encode(): surrogate-escaped names exist
    sr = ctypes.c_int()
    ch = ctypes.c_int()
    frames = ctypes.c_long()
    rc = lib.wav_probe(p, ctypes.byref(sr), ctypes.byref(ch),
                       ctypes.byref(frames))
    if rc == -1:
        # an open failure is not always a missing file (EACCES, EISDIR,
        # EMFILE): those raise ValueError, so the per-file fallback reports
        # the real error from the Python decoder
        if not os.path.exists(path):
            raise FileNotFoundError(f"[read_wav_native] no such file: "
                                    f"{path}")
        raise ValueError(f"[read_wav_native] cannot open: {path}")
    if rc:
        raise ValueError(f"[read_wav_native] bad wav ({rc}): {path}")
    out = np.empty(frames.value, np.float32)
    got = ctypes.c_long()
    rc = lib.wav_decode(p, out.ctypes.data_as(
        ctypes.POINTER(ctypes.c_float)), frames.value, ctypes.byref(sr),
        ctypes.byref(got))
    if rc:
        raise ValueError(f"[read_wav_native] decode failed ({rc}): {path}")
    return out[:got.value], sr.value


def write_wav_native(path, audio: np.ndarray, sr: int,
                     subtype: str = "PCM_16") -> None:
    """Encode one mono float32 array with the native codec (PCM_16 or
    FLOAT), quantized as `utils/wavio.write_wav` does (×32768,
    round-half-even, clipped); raises on failure."""
    lib = _load()
    if lib is None:
        raise RuntimeError("[write_wav_native] native codec unavailable")
    bits = _NATIVE_SUBTYPES.get(subtype)
    if bits is None:
        raise ValueError(f"[write_wav_native] unsupported subtype "
                         f"{subtype!r} (native: "
                         f"{', '.join(_NATIVE_SUBTYPES)})")
    audio = np.ascontiguousarray(np.asarray(audio), dtype=np.float32)
    if audio.ndim != 1:
        raise ValueError("[write_wav_native] mono (1-D) audio only")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    rc = lib.wav_encode(
        os.fsencode(path),
        audio.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        audio.size, int(sr), bits)
    if rc:
        raise ValueError(f"[write_wav_native] encode failed ({rc}): {path}")


def write_wav_batch(items, max_workers: int | None = None,
                    subtype: str = "PCM_16") -> None:
    """Encode many (path, audio, sr) clips in parallel threads, each with
    the native codec where it applies, else the Python encoder."""
    from .wavio import write_wav

    def one(item):
        path, audio, sr = item
        if native_available() and np.asarray(audio).ndim == 1 \
                and subtype in _NATIVE_SUBTYPES:
            try:
                write_wav_native(path, audio, sr, subtype)
                return
            except ValueError:
                pass
        write_wav(path, audio, sr, subtype)

    _map_batch(one, items, max_workers)


def read_wav_batch(paths, max_workers: int | None = None):
    """Decode many files in parallel threads (native codec, the GIL
    released in C), each falling back to the Python decoder on its own.
    Returns a list of (mono float32 audio, sr) in input order."""
    from .wavio import read_wav

    def one(p):
        if native_available():
            try:
                return read_wav_native(p)
            except ValueError:
                pass  # an unusual subtype or an unreadable file
        return read_wav(p)

    return _map_batch(one, paths, max_workers)
