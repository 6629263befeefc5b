"""WAV decode and encode on numpy and the standard library.

PCM 8/16/24/32-bit and IEEE float 32/64, any channel count. Decoding
returns float32 with integer PCM divided by 2^(bits-1), as libsndfile
does; several channels are averaged to mono (librosa.load(mono=True)), or
returned channels-first, (channels, n), with `mono=False`.
"""
from __future__ import annotations

import os
import struct
from pathlib import Path

import numpy as np

__all__ = ["read_wav", "write_wav"]

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def _parse_chunks(data: bytes):
    """Yield (chunk_id, payload) for each RIFF chunk."""
    if len(data) < 12 or data[0:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("[read_wav] Not a RIFF/WAVE file")
    pos = 12
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        yield cid, data[pos + 8:pos + 8 + size]
        pos += 8 + size + (size & 1)  # chunks are word-aligned


def _decode_samples(raw: bytes, audio_format: int, bits: int) -> np.ndarray:
    if audio_format == _WAVE_FORMAT_PCM:
        if bits == 8:
            return (np.frombuffer(raw, np.uint8).astype(np.float32)
                    - 128.0) / 128.0
        if bits == 16:
            return np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
        if bits == 24:
            b = np.frombuffer(raw, np.uint8).reshape(-1, 3).astype(np.int32)
            x32 = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
            x32 = np.where(x32 >= (1 << 23), x32 - (1 << 24), x32)
            return x32.astype(np.float32) / float(1 << 23)
        if bits == 32:
            return np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
        raise ValueError(f"[read_wav] Unsupported PCM depth: {bits}")
    if audio_format == _WAVE_FORMAT_IEEE_FLOAT:
        if bits == 32:
            return np.frombuffer(raw, "<f4").astype(np.float32)
        if bits == 64:
            return np.frombuffer(raw, "<f8").astype(np.float32)
        raise ValueError(f"[read_wav] Unsupported float depth: {bits}")
    raise ValueError(f"[read_wav] Unsupported WAV format code: {audio_format}")


def read_wav(path: str | os.PathLike, mono: bool = True
             ) -> tuple[np.ndarray, int]:
    """Decode a .wav file → (audio float32, sample rate). The audio is (n,)
    with `mono`, else (channels, n)."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"[read_wav] File not found at: {path}")
    fmt = raw = None
    for cid, payload in _parse_chunks(path.read_bytes()):
        # the last fmt chunk before the data and the first data chunk
        if cid == b"fmt ":
            fmt = payload
        elif cid == b"data" and raw is None:
            raw = payload
        if fmt is not None and raw is not None:
            break
    if fmt is None or raw is None:
        raise ValueError(f"[read_wav] Missing fmt/data chunk in {path}")
    if len(fmt) < 16:
        raise ValueError(f"[read_wav] Truncated fmt chunk ({len(fmt)} bytes) "
                         f"in {path}")
    audio_format, n_channels, sample_rate, _, _, bits = struct.unpack_from(
        "<HHIIHH", fmt, 0)
    if audio_format == _WAVE_FORMAT_EXTENSIBLE:
        # the true format is the head of the SubFormat GUID
        if len(fmt) < 26:
            raise ValueError(f"[read_wav] EXTENSIBLE fmt chunk missing "
                             f"SubFormat GUID ({len(fmt)} bytes) in {path}")
        (audio_format,) = struct.unpack_from("<H", fmt, 24)
    # a truncated data chunk: decode the whole samples only
    width = max(bits // 8, 1)
    x = _decode_samples(raw[:(len(raw) // width) * width], audio_format, bits)
    if n_channels > 1:
        x = x[:(len(x) // n_channels) * n_channels].reshape(-1, n_channels)
        x = x.mean(axis=1) if mono else x.T
    return np.ascontiguousarray(x, dtype=np.float32), int(sample_rate)


def write_wav(path: str | os.PathLike, audio: np.ndarray, sr: int,
              subtype: str = "PCM_16") -> None:
    """Encode a .wav file from (n,) or (n, channels) audio. `subtype`:
    "PCM_16" (soundfile's default for float input), "PCM_24", "PCM_32"
    or "FLOAT"."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    audio = np.asarray(audio)
    if audio.ndim not in (1, 2):
        raise ValueError("[write_wav] audio must be 1-D or 2-D (n, channels)")
    n_channels = 1 if audio.ndim == 1 else audio.shape[1]
    a64 = audio.astype(np.float64)
    if subtype == "FLOAT":
        fmt_code, bits = _WAVE_FORMAT_IEEE_FLOAT, 32
        payload = audio.astype("<f4").tobytes()
    elif subtype == "PCM_16":
        fmt_code, bits = _WAVE_FORMAT_PCM, 16
        payload = np.clip(np.round(a64 * 32768.0), -32768, 32767
                          ).astype("<i2").tobytes()
    elif subtype == "PCM_24":
        fmt_code, bits = _WAVE_FORMAT_PCM, 24
        q = np.clip(np.round(a64 * float(1 << 23)), -(1 << 23),
                    (1 << 23) - 1).astype(np.int32).reshape(-1)
        payload = np.stack([q & 0xFF, (q >> 8) & 0xFF, (q >> 16) & 0xFF],
                           axis=1).astype(np.uint8).tobytes()
    elif subtype == "PCM_32":
        fmt_code, bits = _WAVE_FORMAT_PCM, 32
        payload = np.clip(np.round(a64 * 2147483648.0), -2147483648,
                          2147483647).astype("<i4").tobytes()
    else:
        raise ValueError(f"[write_wav] Unsupported subtype: {subtype}")

    block_align = n_channels * bits // 8
    fmt = struct.pack("<HHIIHH", fmt_code, n_channels, sr, sr * block_align,
                      block_align, bits)
    extra = []
    if fmt_code == _WAVE_FORMAT_IEEE_FLOAT:
        # a non-PCM format: an 18-byte fmt (cbSize 0) and a fact chunk
        # with the frame count, which strict readers require
        fmt += struct.pack("<H", 0)
        extra = [b"fact", struct.pack("<I", 4),
                 struct.pack("<I", len(payload) // block_align)]
    chunks = b"".join([
        b"fmt ", struct.pack("<I", len(fmt)), fmt, *extra,
        b"data", struct.pack("<I", len(payload)), payload,
        b"" if len(payload) % 2 == 0 else b"\x00"])
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE"
                + chunks)
