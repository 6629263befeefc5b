"""Batched feature front-ends of the ensemble, the twins of
`gat_tpu/features.py`:

* MFCC path (MLP input): per-clip RMS volume normalization → librosa-
  semantics MFCC (64) → mean over frames → append log10(YIN pitch Hz).
* Mel path (CNN input): torchaudio-semantics MelSpectrogram +
  AmplitudeToDB, as an NHWC image (N, n_mels, T, 1).
* `FeatureBuilder`: both front-ends over a whole dataset, each in one
  call on the builder's device, with the labels encoded as the sorted
  folder names; and the inference extractors, which take their params
  from a checkpoint's embedded config.

Each front-end is one hand-written CUDA kernel on the card
(`csrc/melspec_frontend.cu`, `csrc/mfcc_frontend.cu`) with its plain
PyTorch version beside it here: a wrapper runs the kernel for a CUDA tensor
and the plain version for a CPU tensor. The YIN pitch feature is computed
on the raw clip unless `pitch_on_normalized` is set (YIN's CMND is
amplitude-invariant, so both agree up to rounding).

On the matmul route (`ops.spectral.set_stft_backend("matmul")`) with the
pitch feature on and `SHARED_BLOCK_FRONTEND` true, the MFCC mean and the
YIN pitch come from one transform of the raw clips
(`mfcc_pitch_features`): one block DFT in the plain version, one kernel
launch for both on the card (`csrc/mfcc_pitch_frontend.cu`).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from . import kernels
from .config import MELSPEC_CONFIG, MFCC_CONFIG
from .ops import spectral
from .ops.mel import mel_filterbank_librosa, mel_filterbank_torchaudio
from .ops.yin import (_TROUGH_THRESHOLD, _cmnd_block, _f0_from_cmnd,
                      _median, yin_periods, yin_pitch)
from .utils.device import resolve_device

__all__ = ["encode_labels", "normalize_volume", "mfcc_feature_vectors",
           "melspec_features", "melspec_features_plain", "mfcc_frontend",
           "mfcc_frontend_plain", "mfcc_pitch_features",
           "mfcc_pitch_features_plain", "shared_frontend",
           "SHARED_BLOCK_FRONTEND", "to_reference_layout", "FeatureBuilder"]

# On the matmul route, the MFCC mean and the YIN pitch feature share one
# transform of the raw clips (`mfcc_pitch_features`); False gives the
# separate front-ends there too. Read on every call.
SHARED_BLOCK_FRONTEND = True

_VOLUME_EPS = 1e-9
_KERNEL_N_FFT = 2048   # the FFT size compiled into both front-end kernels
_MFCC_HOP, _MFCC_N_MELS, _TOP_DB = 512, 128, 80.0  # spectral.mfcc defaults
# "the caller gave nothing: use the config's params", apart from an
# explicit None, which skips the mel branch (MLP-only operation)
_USE_CONFIG = object()


def encode_labels(labels):
    """Sorted-unique string labels → int codes. Returns (encoded,
    num_classes, reverse_map)."""
    classes = sorted(set(labels))
    label_to_idx = {c: i for i, c in enumerate(classes)}
    encoded = np.array([label_to_idx[l] for l in labels], dtype=np.int32)
    reverse_map = {i: c for i, c in enumerate(classes)}
    return encoded, len(classes), reverse_map


def normalize_volume(y: torch.Tensor, eps: float = _VOLUME_EPS
                     ) -> torch.Tensor:
    """Per-clip RMS volume normalization."""
    rms = torch.sqrt(torch.mean(y * y, dim=-1, keepdim=True))
    return y / (rms + eps)


def kernel_frames(length: int, hop: int, name: str) -> int:
    """The frame count of a clip of `length` samples at `hop`; any length
    the kernels' C entry points can address (`kernels.check_samples`)."""
    kernels.check_samples(length, name)
    return spectral.n_frames(length, _KERNEL_N_FFT, hop)


# ---------------------------------------------------------------------------
# Constant tables of the kernels, on the kernel's device
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=16)
def _kernel_tables(sr: int, n_mels: int, htk: bool, device: torch.device
                   ) -> tuple[torch.Tensor, ...]:
    """(hann, twiddles, filterbank, lo, hi) for a front-end kernel: the
    periodic Hann window, the twiddle table of `csrc/fft_stockham.cuh`
    (its Stockham pass tables W_256^(r·m), r, m < 16, and W_2048^(r·b),
    r < 8, b < 256, each as [re | im]), the dense (n_mels, n_fft/2 + 1)
    filterbank and each band's nonzero bin range [lo, hi). Computed in
    float64, rounded to float32."""
    n = _KERNEL_N_FFT
    fb = (mel_filterbank_torchaudio(sr, n, n_mels) if htk
          else mel_filterbank_librosa(sr, n, n_mels))
    nz = fb != 0
    any_nz = nz.any(axis=1)
    lo = np.where(any_nz, nz.argmax(axis=1), 0).astype(np.int32)
    hi = np.where(any_nz, fb.shape[1] - nz[:, ::-1].argmax(axis=1),
                  0).astype(np.int32)
    ang = [2.0 * np.pi * np.outer(np.arange(16), np.arange(16)).ravel() / 256,
           2.0 * np.pi * np.outer(np.arange(8), np.arange(256)).ravel() / n]
    tw = np.concatenate([x for a in ang for x in (np.cos(a), -np.sin(a))]
                        ).astype(np.float32)
    hann = spectral._hann_np(n)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (hann, tw, fb, lo, hi))


@functools.lru_cache(maxsize=16)
def _dct_table(n_mfcc: int, device: torch.device) -> torch.Tensor:
    """K2's (128, n_mfcc) orthonormal DCT-II matrix, on its device once."""
    return spectral.dct_ii_matrix(_MFCC_N_MELS, n_mfcc, device)


# ---------------------------------------------------------------------------
# K1: mel front-end (CNN input)
# ---------------------------------------------------------------------------
def melspec_features_plain(clips: torch.Tensor, sr: int, n_mels: int = 64,
                           n_fft: int = 2048, hop_length: int = 256,
                           normalize_audio_volume: bool = True,
                           to_db: bool = True) -> torch.Tensor:
    """(N, L) → (N, n_mels, T, 1) NHWC mel image. Plain PyTorch."""
    y = normalize_volume(clips) if normalize_audio_volume else clips
    S = spectral.melspectrogram_torchaudio(y, sr, n_fft=n_fft,
                                           hop_length=hop_length,
                                           n_mels=n_mels, to_db=to_db)
    return S.transpose(-1, -2)[..., None]


_MELSPEC_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
    ctypes.c_void_p]
_MELSPEC_SPLIT_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [
    ctypes.c_void_p]


def melspec_features(clips: torch.Tensor, sr: int, n_mels: int = 64,
                     n_fft: int = 2048, hop_length: int = 256,
                     normalize_audio_volume: bool = True,
                     to_db: bool = True) -> torch.Tensor:
    """(N, L) → (N, n_mels, T, 1) NHWC mel image.

    CUDA tensor: the kernel `csrc/melspec_frontend.cu` (K1), which
    replaces the TPU kernel `gat_tpu/ops/pallas/melspec_frontend.py::
    melspec_pallas` (deleted in 1951c8f; live reference
    `gat_tpu/features.py::melspec_features`). Its roofline bound is the
    fp32 rate of its FFTs (1.24 M flops per clip for real-input FFTs,
    against 28 KB moved). One block owns one clip and runs two adjacent
    frames per complex FFT (register Stockham passes, four frames in
    flight), then power, mel and dB in shared memory, so the spectrum
    never reaches device memory; an image too large for shared memory
    (745 frames or more at 64 mels) is written straight to the output.
    Clips of any length: where one block a clip would leave the card
    under-filled (`kernels.plan`), the split route cuts each clip's frames
    into tiles, one block a tile, after a pre-pass that sums the squares
    of each chunk of a clip's samples in a block of its own into a scratch
    (each tile adds them up into the clip's volume scale); its image is
    the one-block route's bit for bit.
    On the matmul route with bfloat16
    operands it is handed the clips rounded to bfloat16
    (`spectral.kernel_signal`; its twiddles stay float32). CPU tensor:
    `melspec_features_plain`."""
    if clips.device.type == "cpu":
        return melspec_features_plain(clips, sr, n_mels, n_fft, hop_length,
                                      normalize_audio_volume, to_db)
    if clips.device.type != "cuda":
        raise ValueError(f"[melspec_features] unsupported device "
                         f"{clips.device}")
    kernels.check_input(clips, "melspec_features")
    clips = spectral.kernel_signal(clips)
    if n_fft != _KERNEL_N_FFT:
        raise ValueError(f"[melspec_features] kernel is built for n_fft "
                         f"{_KERNEL_N_FFT}, got {n_fft}")
    if clips.shape[1] <= n_fft // 2:  # reflect padding needs pad < length
        raise ValueError(f"[melspec_features] clips must be longer than "
                         f"{n_fft // 2} samples")
    n, length = clips.shape
    n_fr = kernel_frames(length, hop_length, "melspec_features")
    out = torch.empty((n, n_mels, n_fr, 1), dtype=torch.float32,
                      device=clips.device)
    if n == 0:
        return out
    hann, tw, fb, lo, hi = _kernel_tables(sr, n_mels, True, clips.device)
    tile, _, _, floats = kernels.plan(
        "melspec_frontend", "gat_melspec_plan", clips.device, n, length,
        n_fr, n_mels, int(normalize_audio_volume))
    tables = (hann.data_ptr(), tw.data_ptr(), fb.data_ptr(), lo.data_ptr(),
              hi.data_ptr())
    sizes = (n, length, hop_length, n_fr, n_mels,
             int(normalize_audio_volume), int(to_db))
    with kernels.device_guard(clips.device):
        if tile:
            ws = _workspace(n, floats, clips.device)
            fn = kernels.function("melspec_frontend", "gat_melspec_split",
                                  _MELSPEC_SPLIT_ARGS)
            status = fn(clips.data_ptr(), out.data_ptr(), _ptr(ws), *tables,
                        *sizes, tile, kernels.stream(clips.device))
        else:
            fn = kernels.function("melspec_frontend", "gat_melspec_frontend",
                                  _MELSPEC_ARGS)
            status = fn(clips.data_ptr(), out.data_ptr(), *tables, *sizes,
                        kernels.stream(clips.device))
    kernels.check(status, "melspec_frontend")
    melspec_features.launches += 1
    return out


melspec_features.launches = 0


# ---------------------------------------------------------------------------
# K2: MFCC front-end (MLP input)
# ---------------------------------------------------------------------------
def mfcc_frontend_plain(clips: torch.Tensor, sr: int, n_mfcc: int = 64,
                        normalize_audio_volume: bool = True
                        ) -> torch.Tensor:
    """(N, L) → (N, n_mfcc): the MFCC averaged over frames. Plain
    PyTorch."""
    y = normalize_volume(clips) if normalize_audio_volume else clips
    return torch.mean(spectral.mfcc(y, sr, n_mfcc=n_mfcc), dim=-2)


_MFCC_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_void_p]
_MFCC_SPLIT_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def _workspace(n: int, floats: int, device: torch.device
               ) -> torch.Tensor | None:
    """A kernel's (n, floats) scratch in device memory (`kernels.plan`'s
    floats a clip), or None when it needs none."""
    return (torch.empty((n, floats), dtype=torch.float32, device=device)
            if floats else None)


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def mfcc_frontend(clips: torch.Tensor, sr: int, n_mfcc: int = 64,
                  normalize_audio_volume: bool = True) -> torch.Tensor:
    """(N, L) → (N, n_mfcc): the MFCC averaged over frames.

    CUDA tensor: the kernel `csrc/mfcc_frontend.cu` (K2), which replaces
    the TPU kernel `gat_tpu/ops/pallas/mfcc_frontend.py::mfcc_mean_pallas`
    (deleted in 1951c8f; live reference
    `gat_tpu/features.py::mfcc_feature_vectors`). The per-clip top_db
    clamp needs the clip's whole mel image, so one block owns one clip;
    the roofline bound is the fp32 rate of its 11 FFTs (0.62 M flops per
    clip for real-input FFTs, against 22 KB read). It runs K1's round
    loop (`csrc/mel_rounds.cuh`: two adjacent frames per complex FFT,
    register Stockham passes, four frames in flight) over a zero pad, then
    the clamp, the mean over frames and the DCT, which commutes with the
    mean. A dB image too large for shared memory (355 frames or more)
    goes to a workspace in device memory that this wrapper allocates.
    Clips of any length: where one block a clip would leave the card
    under-filled (`kernels.plan`), the split route cuts each clip's frames
    into tiles, one block a tile, in four launches (the volume scale's
    chunk sums, the tiles' dB and peaks, their clamped sums, the means),
    the image in the scratch this wrapper allocates; its mean is the
    one-block route's bit for bit (both sum the frames in chunks of 128
    in order). The same
    bfloat16 rounding of the clips as K1's on the matmul route. CPU
    tensor: `mfcc_frontend_plain`."""
    if clips.device.type == "cpu":
        return mfcc_frontend_plain(clips, sr, n_mfcc, normalize_audio_volume)
    if clips.device.type != "cuda":
        raise ValueError(f"[mfcc_frontend] unsupported device {clips.device}")
    kernels.check_input(clips, "mfcc_frontend")
    clips = spectral.kernel_signal(clips)
    n, length = clips.shape
    n_fr = kernel_frames(length, _MFCC_HOP, "mfcc_frontend")
    out = torch.empty((n, n_mfcc), dtype=torch.float32, device=clips.device)
    if n == 0:
        return out
    hann, tw, fb, lo, hi = _kernel_tables(sr, _MFCC_N_MELS, False,
                                          clips.device)
    dct = _dct_table(n_mfcc, clips.device)
    tile, _, _, floats = kernels.plan("mfcc_frontend", "gat_mfcc_plan",
                                      clips.device, n, length, n_fr,
                                      _MFCC_N_MELS)
    ws = _workspace(n, floats, clips.device)
    tables = (hann.data_ptr(), tw.data_ptr(), fb.data_ptr(), lo.data_ptr(),
              hi.data_ptr(), dct.data_ptr())
    sizes = (n, length, _MFCC_HOP, n_fr, _MFCC_N_MELS, n_mfcc,
             int(normalize_audio_volume), _TOP_DB)
    with kernels.device_guard(clips.device):
        if tile:
            fn = kernels.function("mfcc_frontend", "gat_mfcc_split",
                                  _MFCC_SPLIT_ARGS)
            status = fn(clips.data_ptr(), out.data_ptr(), ws.data_ptr(),
                        *tables, *sizes, tile, kernels.stream(clips.device))
        else:
            fn = kernels.function("mfcc_frontend", "gat_mfcc_frontend",
                                  _MFCC_ARGS)
            status = fn(clips.data_ptr(), out.data_ptr(), *tables, _ptr(ws),
                        *sizes, kernels.stream(clips.device))
    kernels.check(status, "mfcc_frontend")
    mfcc_frontend.launches += 1
    return out


mfcc_frontend.launches = 0


# ---------------------------------------------------------------------------
# K6: the shared MFCC and YIN front-end of the matmul route
# ---------------------------------------------------------------------------
def shared_frontend(add_pitch_features: bool = True) -> bool:
    """Whether `mfcc_feature_vectors` takes the shared MFCC and YIN
    front-end: the matmul route, the pitch feature on and
    `SHARED_BLOCK_FRONTEND` true, as the JAX package decides it."""
    return (SHARED_BLOCK_FRONTEND and add_pitch_features
            and spectral.stft_backend() == "matmul")


def shared_pitch_is_raw(normalize_audio_volume: bool,
                        pitch_on_normalized: bool) -> bool:
    """Whether the shared front-end's pitch is that of the raw clips (it
    reads the normalized clips only when both flags ask for it)."""
    return not (pitch_on_normalized and normalize_audio_volume)


def mfcc_pitch_features_plain(clips: torch.Tensor, sr: int,
                              n_mfcc: int = 64,
                              normalize_audio_volume: bool = True,
                              pitch_on_normalized: bool = False,
                              bf16: bool | None = None
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, L) → (features (N, n_mfcc + 1), hz (N,)): the MFCC mean and
    the YIN pitch from one hop-block DFT of the raw clips, the feature's
    last column log10(hz). The volume scale 1 / (rms + eps) is applied to
    the shared coefficients by linearity: the MFCC branch's when
    `normalize_audio_volume`, the YIN branch's only when both flags are
    on. The block DFT's operands are bfloat16 when `bf16` (None: when
    `spectral.matmul_dtype()` is). Plain PyTorch, the twin of
    `gat_tpu/features.py::_fused_mfcc_mean_and_pitch`."""
    n_fft, hop, n_mels = _KERNEL_N_FFT, _MFCC_HOP, _MFCC_N_MELS
    win = n_fft // 2                           # librosa yin defaults
    if bf16 is None:
        bf16 = spectral.matmul_dtype() == torch.bfloat16
    dtype = torch.bfloat16 if bf16 else torch.float32

    clips = clips.to(torch.float32)
    pad = spectral._pad_center(clips, n_fft // 2, "constant")
    t = 1 + (pad.shape[-1] - n_fft) // hop
    cre, cim = spectral._block_coeffs(pad, n_fft, hop, t, dtype)
    rms = torch.sqrt(torch.mean(clips * clips, dim=-1, keepdim=True))
    s = 1.0 / (rms + _VOLUME_EPS)

    sm = s if normalize_audio_volume else torch.ones_like(s)
    are, aim = spectral.combine_blocks(cre, cim, n_fft, hop, t)
    wre, wim = spectral.hann_in_frequency(are * sm[..., None],
                                          aim * sm[..., None])
    spec = wre * wre + wim * wim
    fb = torch.from_numpy(mel_filterbank_librosa(sr, n_fft, n_mels)).to(
        clips.device)
    mel = torch.einsum("...tf,mf->...tm", spec, fb)
    s_db = spectral.power_to_db_librosa(mel, spec_axes=2)
    dct = spectral.dct_ii_matrix(n_mels, n_mfcc, clips.device)
    vec = torch.mean(torch.einsum("...tm,mk->...tk", s_db, dct), dim=-2)

    sy = (torch.ones_like(s)
          if shared_pitch_is_raw(normalize_audio_volume, pitch_on_normalized)
          else s)
    min_p, max_p = yin_periods(sr, 50.0, 1000.0, n_fft, win)
    cmnd = _cmnd_block(pad * sy, n_fft, hop, t, win, min_p, max_p,
                       coeffs=(cre * sy[..., None], cim * sy[..., None]))
    hz = _median(_f0_from_cmnd(cmnd, min_p, _TROUGH_THRESHOLD, sr))
    return torch.cat([vec, torch.log10(hz)[..., None]], dim=-1), hz


_MFCC_PITCH_ARGS = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 11
                    + [ctypes.c_float] * 3 + [ctypes.c_void_p])
_MFCC_PITCH_SPLIT_ARGS = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 11
                          + [ctypes.c_float] * 3
                          + [ctypes.c_int, ctypes.c_void_p])


def mfcc_pitch_features(clips: torch.Tensor, sr: int, n_mfcc: int = 64,
                        normalize_audio_volume: bool = True,
                        pitch_on_normalized: bool = False,
                        bf16: bool | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, L) → (features (N, n_mfcc + 1), hz (N,)): the MFCC mean with
    log10(YIN pitch) appended, and the pitch itself, from one transform.

    CUDA tensor: the kernel `csrc/mfcc_pitch_frontend.cu` (K6), which
    replaces the JAX package's XLA `gat_tpu/features.py::
    _fused_mfcc_mean_and_pitch`. One block owns one clip; the volume
    scale is reduced once. The MFCC branch runs K2's rounds
    (`csrc/mfcc_mean.cuh`) on the clip read from device memory, as K2
    does; as they end, the clip is copied again, with its zero centre pad,
    into the shared memory the MFCC epilogue leaves free, and the YIN
    branch runs K3's direct ACF (`csrc/yin_acf.cuh`) over that copy, each
    ACF chain that overlapping frames share computed once, scaled by
    1 / (rms + eps) only when both flags are on, in groups of frames that
    fit in shared memory. Its MFCC is K2's and its raw pitch K3's bit for
    bit. A dB image too large for shared memory goes to a workspace in
    device memory that this wrapper allocates. Clips of any length: where
    one block a clip would leave the card under-filled, or a clip has
    more frames than one block should take alone (`kernels.plan`), the
    split route cuts each clip's frames into tiles, one block a tile, in
    four launches (the volume scale's chunk sums; each tile's MFCC dB,
    peak and YIN f0; the tiles' clamped sums; the means and the medians,
    the latter by a radix selection over every frame's f0), its MFCC K2's
    and its raw pitch K3's bit for bit. Its twiddles stay float32;
    with `bf16` (None: `spectral.matmul_dtype()` is bfloat16) it is handed
    the clips rounded to bfloat16. Bound by operations: one shared FFT
    per frame and the ACF from FFTs (`utils/roofline.py::
    mfcc_pitch_cost`), where the kernel does K2's work and the direct
    ACF. CPU tensor: `mfcc_pitch_features_plain`."""
    if clips.device.type == "cpu":
        return mfcc_pitch_features_plain(clips, sr, n_mfcc,
                                         normalize_audio_volume,
                                         pitch_on_normalized, bf16)
    if clips.device.type != "cuda":
        raise ValueError(f"[mfcc_pitch_features] unsupported device "
                         f"{clips.device}")
    kernels.check_input(clips, "mfcc_pitch_features")
    if bf16 is None:
        bf16 = spectral.matmul_dtype() == torch.bfloat16
    if bf16:
        clips = clips.to(torch.bfloat16).to(torch.float32)
    n, length = clips.shape
    n_fr = kernel_frames(length, _MFCC_HOP, "mfcc_pitch_features")
    win = _KERNEL_N_FFT // 2
    min_p, max_p = yin_periods(sr, 50.0, 1000.0, _KERNEL_N_FFT, win)
    if max_p - min_p < 1:
        raise ValueError(f"[mfcc_pitch_features] period range [{min_p}, "
                         f"{max_p}] needs at least two periods")
    out = torch.empty((n, n_mfcc + 1), dtype=torch.float32,
                      device=clips.device)
    hz = torch.empty(n, dtype=torch.float32, device=clips.device)
    if n == 0:
        return out, hz
    hann, tw, fb, lo, hi = _kernel_tables(sr, _MFCC_N_MELS, False,
                                          clips.device)
    dct = _dct_table(n_mfcc, clips.device)
    tile, _, _, floats = kernels.plan(
        "mfcc_pitch_frontend", "gat_mfcc_pitch_plan", clips.device, n,
        length, n_fr, _MFCC_N_MELS, n_mfcc, win, _MFCC_HOP, max_p)
    ws = _workspace(n, floats, clips.device)
    tables = (hann.data_ptr(), tw.data_ptr(), fb.data_ptr(), lo.data_ptr(),
              hi.data_ptr(), dct.data_ptr())
    sizes = (n, length, _MFCC_HOP, n_fr, _MFCC_N_MELS, n_mfcc, win, min_p,
             max_p, int(normalize_audio_volume), int(pitch_on_normalized),
             _TOP_DB, _TROUGH_THRESHOLD, float(sr))
    with kernels.device_guard(clips.device):
        if tile:
            fn = kernels.function("mfcc_pitch_frontend",
                                  "gat_mfcc_pitch_split",
                                  _MFCC_PITCH_SPLIT_ARGS)
            status = fn(clips.data_ptr(), out.data_ptr(), hz.data_ptr(),
                        ws.data_ptr(), *tables, *sizes, tile,
                        kernels.stream(clips.device))
        else:
            fn = kernels.function("mfcc_pitch_frontend",
                                  "gat_mfcc_pitch_frontend",
                                  _MFCC_PITCH_ARGS)
            status = fn(clips.data_ptr(), out.data_ptr(), hz.data_ptr(),
                        *tables, _ptr(ws), *sizes,
                        kernels.stream(clips.device))
    kernels.check(status, "mfcc_pitch_frontend")
    mfcc_pitch_features.launches += 1
    return out, hz


mfcc_pitch_features.launches = 0


def mfcc_feature_vectors(clips: torch.Tensor, sr: int, n_mfcc: int = 64,
                         normalize_audio_volume: bool = True,
                         add_pitch_features: bool = True,
                         pitch_on_normalized: bool = False,
                         raw_pitch_hz: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """(N, L) → (N, n_mfcc [+1]): MFCC mean with the optional log10-pitch
    feature appended. On the shared route (`shared_frontend`) both come
    from `mfcc_pitch_features` and `raw_pitch_hz` is not read. Else
    `raw_pitch_hz`, the YIN pitch of the raw clips when the caller already
    has it, is used whenever the pitch feature reads the raw clips, so
    YIN runs once for the feature and the baseline."""
    if shared_frontend(add_pitch_features):
        return mfcc_pitch_features(clips, sr, n_mfcc, normalize_audio_volume,
                                   pitch_on_normalized)[0]
    vec = mfcc_frontend(clips, sr, n_mfcc, normalize_audio_volume)
    if not add_pitch_features:
        return vec
    if pitch_on_normalized and normalize_audio_volume:
        hz = yin_pitch(normalize_volume(clips), sr)
    elif raw_pitch_hz is not None:
        hz = raw_pitch_hz
    else:
        hz = yin_pitch(clips, sr)
    return torch.cat([vec, torch.log10(hz)[..., None]], dim=-1)


def to_reference_layout(x):
    """NHWC (N, M, T, 1) → the reference's NCHW (N, 1, M, T), numpy or
    tensor."""
    if isinstance(x, torch.Tensor):
        return x.permute(0, 3, 1, 2)
    return np.transpose(np.asarray(x), (0, 3, 1, 2))


class FeatureBuilder:
    """Dataset-level feature extraction, the twin of
    `gat_tpu/features.py::FeatureBuilder`'s dataset extractors. Every
    clip of the dataset goes through one front-end call on `device`
    (default the card, where that call is the kernels K2 + K3, or K1);
    'cpu' runs the plain versions. None defaults resolve to
    MFCC_CONFIG / MELSPEC_CONFIG."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.scaler = None

    def _on_device(self, clips) -> torch.Tensor:
        """Clips as a contiguous float32 tensor on the builder's device.
        On the card, clips the kernels cannot address (not (N, L), or more
        samples than `kernels.MAX_SAMPLES`) raise here, before any upload
        or launch, instead of running another version; clips of any other
        length run on the kernels."""
        clips = torch.as_tensor(clips, dtype=torch.float32)
        if self.device.type == "cuda":
            if clips.ndim != 2:
                raise ValueError(
                    f"[FeatureBuilder] clips of shape {tuple(clips.shape)}: "
                    f"the card's front-end kernels take mono clips (N, L)")
            kernels.check_samples(clips.shape[-1], "FeatureBuilder")
        return clips.to(self.device).contiguous()

    def _clips(self, audio_loader):
        """(the loader's clips on the device, labels)."""
        wavs, _, labels, _ = audio_loader.load_audio_dataset(pad_to_max=True)
        return self._on_device(np.stack(wavs)), labels

    def extract_mfcc_features(self, audio_loader, n_mfcc: int | None = None,
                              normalize_audio_volume: bool | None = None,
                              add_pitch_features: bool | None = None):
        """Returns (X (N, D) np, y_encoded, num_classes, reverse_map)."""
        if n_mfcc is None:
            n_mfcc = MFCC_CONFIG.N_MFCC
        if normalize_audio_volume is None:
            normalize_audio_volume = MFCC_CONFIG.NORMALIZE_AUDIO_VOLUME
        if add_pitch_features is None:
            add_pitch_features = MFCC_CONFIG.ADD_PITCH_FEATURES
        clips, labels = self._clips(audio_loader)
        X = mfcc_feature_vectors(
            clips, audio_loader.target_sr, n_mfcc=n_mfcc,
            normalize_audio_volume=normalize_audio_volume,
            add_pitch_features=add_pitch_features).cpu().numpy()
        y_encoded, num_classes, reverse_map = encode_labels(labels)
        print(f"Extracted MFCC features for {len(X)} samples.")
        return X, y_encoded, num_classes, reverse_map

    def extract_melspec_features(self, audio_loader, n_mels: int | None = None,
                                 n_fft: int | None = None,
                                 hop_length: int | None = None,
                                 normalize_audio_volume: bool | None = None,
                                 to_db: bool | None = None):
        """Returns (X (N, M, T, 1) np NHWC, y_encoded, num_classes,
        reverse_map)."""
        if n_mels is None:
            n_mels = MELSPEC_CONFIG.N_MELS
        if n_fft is None:
            n_fft = MELSPEC_CONFIG.N_FFT
        if hop_length is None:
            hop_length = MELSPEC_CONFIG.HOP_LENGTH
        if normalize_audio_volume is None:
            normalize_audio_volume = MELSPEC_CONFIG.NORMALIZE_AUDIO_VOLUME
        if to_db is None:
            to_db = MELSPEC_CONFIG.TO_DB
        clips, labels = self._clips(audio_loader)
        X = melspec_features(
            clips, audio_loader.target_sr, n_mels=n_mels, n_fft=n_fft,
            hop_length=hop_length,
            normalize_audio_volume=normalize_audio_volume,
            to_db=to_db).cpu().numpy()
        y_encoded, num_classes, reverse_map = encode_labels(labels)
        print(f"Extracted Mel-spectrogram features for {X.shape[0]} "
              f"samples. X shape: {tuple(X.shape)}")
        return X, y_encoded, num_classes, reverse_map

    # ----- inference paths ----------------------------------------------
    def extract_inference_features(self, audio_loader, mfcc_params=None,
                                   melspec_params=_USE_CONFIG, scaler=None):
        """A directory of clips with a checkpoint's params → (mfcc (N, D),
        mel NHWC (N, M, T, 1) or None), tensors on the builder's device.
        None params resolve to MFCC_CONFIG / MELSPEC_CONFIG, but an
        explicit `melspec_params=None` skips the mel branch."""
        mfcc_params = mfcc_params or dataclasses.asdict(MFCC_CONFIG)
        if melspec_params is _USE_CONFIG:
            melspec_params = dataclasses.asdict(MELSPEC_CONFIG)
        wavs, _, _, _ = audio_loader.load_audio_dataset(pad_to_max=True)
        return self.extract_inference_features_from_clips(
            np.stack(wavs), audio_loader.target_sr, mfcc_params,
            melspec_params, scaler)

    def extract_inference_features_from_clips(self, clips, sr,
                                              mfcc_params, melspec_params,
                                              scaler=None,
                                              pitch_on_normalized=False):
        """Clips (N, L), numpy or tensor → (mfcc (N, D), mel NHWC or
        None) on the builder's device: K2 + K3 and K1 on the card.
        `scaler` standardizes the MFCC vector; `melspec_params` None
        skips the mel branch; the params' TO_DB wins when present
        (absent: a legacy checkpoint, dB on)."""
        return self._inference_features(clips, sr, mfcc_params,
                                         melspec_params, scaler,
                                         pitch_on_normalized, True)

    def extract_inference_features_from_audio(self, audio, target_sr,
                                              mfcc_params=None,
                                              melspec_params=_USE_CONFIG,
                                              scaler=None,
                                              melspec_to_db: bool = True):
        """One clip (L,) → batch-of-one features, as
        `extract_inference_features_from_clips` gives them, with the pitch
        feature from the normalized clip. `melspec_to_db` applies only
        when the mel params carry no TO_DB."""
        mfcc_params = mfcc_params or dataclasses.asdict(MFCC_CONFIG)
        if melspec_params is _USE_CONFIG:
            melspec_params = dataclasses.asdict(MELSPEC_CONFIG)
        clips = torch.as_tensor(audio, dtype=torch.float32)[None]
        return self._inference_features(clips, target_sr, mfcc_params,
                                        melspec_params, scaler, True,
                                        melspec_to_db)

    def _inference_features(self, clips, sr, mfcc_params, melspec_params,
                            scaler, pitch_on_normalized, default_to_db):
        clips = self._on_device(clips)
        mf = mfcc_feature_vectors(
            clips, sr, n_mfcc=mfcc_params["N_MFCC"],
            normalize_audio_volume=mfcc_params["NORMALIZE_AUDIO_VOLUME"],
            add_pitch_features=mfcc_params["ADD_PITCH_FEATURES"],
            pitch_on_normalized=pitch_on_normalized)
        if scaler is not None:
            mf = scaler.transform(mf)
        if melspec_params is None:
            return mf, None
        ms = melspec_features(
            clips, sr, n_mels=melspec_params["N_MELS"],
            n_fft=melspec_params["N_FFT"],
            hop_length=melspec_params["HOP_LENGTH"],
            normalize_audio_volume=melspec_params["NORMALIZE_AUDIO_VOLUME"],
            to_db=bool(melspec_params.get("TO_DB", default_to_db)))
        return mf, ms
