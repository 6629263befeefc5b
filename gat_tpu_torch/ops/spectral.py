"""Plain PyTorch spectral ops: framing, STFT power, mel spectrograms, MFCC.

The twins of `gat_tpu/ops/spectral.py`, batched over leading axes and
time-major inside: spectrograms are (..., n_frames, n_bins). Two
conventions are kept apart on purpose:

* `melspectrogram_librosa` / `mfcc`: librosa semantics, constant center
  pad, Slaney mel with 'slaney' norm, power_to_db with ref 1.0 and a
  per-clip top_db 80 clamp.
* `melspectrogram_torchaudio`: torchaudio semantics, reflect center pad,
  HTK mel without norm, AmplitudeToDB without top_db.

These are the CPU path and the yardstick of the CUDA front-end kernels in
`features.py`; on the card the main path runs those kernels instead.

Two routes compute the DFTs, as in the JAX package: "fft" (torch.fft) and
"matmul" (real-DFT GEMMs with operands in `matmul_dtype()`, float32 or
bfloat16, accumulated in float32), chosen by `set_stft_backend`; "auto"
is "fft" on the CPU and on CUDA. The block DFT (`block_coeffs`,
`combine_blocks`, `block_spectra`, `hann_in_frequency`) is the matmul
route's shared transform of the MFCC and YIN front-end. Both switches are
read on every call: nothing built earlier holds a route.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .mel import mel_filterbank_librosa, mel_filterbank_torchaudio
from ..utils.device import tf32_off

__all__ = ["TINY32", "hann_window", "n_frames", "frame", "stft",
           "power_spectrogram",
           "power_to_db_librosa", "amplitude_to_db_torchaudio",
           "dct_ii_matrix", "melspectrogram_librosa",
           "melspectrogram_torchaudio", "mfcc", "set_stft_backend",
           "stft_backend", "set_matmul_dtype", "matmul_dtype",
           "block_coeffs", "combine_blocks", "block_spectra",
           "hann_in_frequency", "kernel_signal"]

# np.finfo(np.float32).tiny: librosa's denominator guard, shared with YIN
TINY32 = 1.1754944e-38

_STFT_BACKEND = "auto"
_MATMUL_DTYPE = torch.float32
_MATMUL_DTYPES = {torch.float32: torch.float32, "float32": torch.float32,
                  torch.bfloat16: torch.bfloat16, "bfloat16": torch.bfloat16}


def set_stft_backend(name: str) -> None:
    """Select the DFT route: "auto", "fft" or "matmul"."""
    global _STFT_BACKEND
    assert name in ("auto", "fft", "matmul")
    _STFT_BACKEND = name


def stft_backend() -> str:
    """The route in force: "auto" is "fft" on the CPU and on CUDA, where
    an FFT library does n / log n fewer operations than a DFT GEMM."""
    return "fft" if _STFT_BACKEND == "auto" else _STFT_BACKEND


def set_matmul_dtype(dtype) -> None:
    """Operand dtype of the matmul route's DFT GEMMs: torch.float32 or
    torch.bfloat16 (or their names); the products accumulate in float32."""
    global _MATMUL_DTYPE
    if dtype not in _MATMUL_DTYPES:
        raise ValueError(f"[set_matmul_dtype] float32 or bfloat16, got "
                         f"{dtype!r}")
    _MATMUL_DTYPE = _MATMUL_DTYPES[dtype]


def matmul_dtype() -> torch.dtype:
    return _MATMUL_DTYPE


def _operand(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to `dtype` and back to float32: a float32 product of
    such operands is what a bfloat16 GEMM with a float32 result computes,
    unrounded (a bfloat16 matmul would round its output too)."""
    x = x.to(torch.float32)
    return x if dtype == torch.float32 else x.to(dtype).to(torch.float32)


def kernel_signal(x: torch.Tensor) -> torch.Tensor:
    """The signal a front-end kernel is handed: on the matmul route with
    bfloat16 operands, rounded to bfloat16 (the operand the JAX route
    rounds on the signal side; the kernels' twiddles stay float32); else
    x itself."""
    if stft_backend() == "matmul" and _MATMUL_DTYPE == torch.bfloat16:
        return x.to(torch.bfloat16).to(torch.float32)
    return x


def _gemm(x: torch.Tensor, m: torch.Tensor,
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x (..., n) @ m (n, f) as a float32 product of operands rounded to
    `dtype`, TF32 off (`utils.device.tf32_off`: a process-global flag
    while it runs)."""
    with tf32_off(x.device):
        return torch.matmul(_operand(x, dtype), _operand(m, dtype))


@functools.lru_cache(maxsize=8)
def _rdft_np(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Real-DFT matrices: X @ C + i·(X @ S) == rfft(X) for real X.
    Shapes (n_fft, 1 + n_fft // 2), float32."""
    n = np.arange(n_fft)[:, None]
    f = np.arange(1 + n_fft // 2)[None, :]
    ang = 2.0 * np.pi * n * f / n_fft
    return (np.cos(ang).astype(np.float32),
            (-np.sin(ang)).astype(np.float32))


@functools.lru_cache(maxsize=32)
def _table(kind: str, a: int, b: int, c: int, device: torch.device
           ) -> torch.Tensor:
    """A constant matrix of the matmul route on its device, once:
    "cw"/"sw" the first c columns of the DFT matrices of n_fft a times
    the Hann window; "c"/"s" the plain DFT matrices; "bc"/"bs" the block
    DFT's first b rows of them; "twr"/"twi" the block combine twiddles of
    (n_fft a, hop b)."""
    if kind in ("twr", "twi"):
        m = _block_twiddles_np(a, b)[kind == "twi"]
    else:
        m = _rdft_np(a)["s" in kind]
        if kind.startswith("b"):
            m = m[:b]
        elif kind.endswith("w"):
            m = m[:, :c] * _hann_np(a)[:, None]
    return torch.from_numpy(np.ascontiguousarray(m)).to(device)


@functools.lru_cache(maxsize=16)
def _hann_np(n: int) -> np.ndarray:
    """Periodic Hann window, built in float64 and cast to float32."""
    k = np.arange(n, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * k / n)).astype(np.float32)


def hann_window(n: int, device=None) -> torch.Tensor:
    return torch.from_numpy(_hann_np(n)).to(device)


def n_frames(n_samples: int, frame_length: int, hop_length: int,
             center: bool = True) -> int:
    """Frame count of a signal of `n_samples`."""
    if center:
        n_samples += 2 * (frame_length // 2)
    return 1 + (n_samples - frame_length) // hop_length


def frame(y: torch.Tensor, frame_length: int, hop_length: int
          ) -> torch.Tensor:
    """(..., n) → (..., n_frames, frame_length), no padding (a view)."""
    return y.unfold(-1, frame_length, hop_length)


def _pad_center(y: torch.Tensor, pad: int, pad_mode: str) -> torch.Tensor:
    """Pad the last axis by `pad` on both sides; 'reflect' excludes the
    edge sample (numpy 'reflect')."""
    if pad_mode == "constant":
        return F.pad(y, (pad, pad))
    shape = y.shape
    return F.pad(y.reshape(-1, 1, shape[-1]), (pad, pad),
                 mode=pad_mode).reshape(shape[:-1] + (shape[-1] + 2 * pad,))


# ---------------------------------------------------------------------------
# The block DFT: each frame's spectrum from the DFTs of its hop-sized
# blocks. With K = n_fft / hop,
#
#   X_t[k] = Σ_{j<K} e^(-2πi·k·j/K) · C_{t+j}[k],
#   C_b[k] = Σ_{n<hop} y[b·hop + n] · e^(-2πi·k·n/n_fft),
#
# exact, since the frame at t·hop is blocks t..t+K-1 and block j of it
# carries the phase e^(-2πi·k·j·hop/n_fft). The Hann window is applied
# afterwards in frequency (`hann_in_frequency`), so one block DFT serves
# windowed (MFCC) and unwindowed (YIN) consumers.
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=8)
def _block_dft_np(hop: int, n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Block real-DFT matrices (hop, 1 + n_fft // 2): the first `hop`
    rows of the framed-DFT matrices."""
    return tuple(m[:hop].copy() for m in _rdft_np(n_fft))


@functools.lru_cache(maxsize=8)
def _block_twiddles_np(n_fft: int, hop: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-offset combine twiddles (K, F): e^(-2πi·k·j/K)."""
    k_ratio = n_fft // hop
    j = np.arange(k_ratio)[:, None]
    k = np.arange(1 + n_fft // 2)[None, :]
    ang = 2.0 * np.pi * j * k / k_ratio
    return (np.cos(ang).astype(np.float32),
            (-np.sin(ang)).astype(np.float32))


def _block_coeffs(y_padded: torch.Tensor, n_fft: int, hop_length: int,
                  n_frames_out: int, dtype: torch.dtype
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """`block_coeffs` with its GEMM operands in `dtype`."""
    assert n_fft % hop_length == 0
    nb = n_frames_out + n_fft // hop_length - 1
    need = nb * hop_length
    if y_padded.shape[-1] < need:
        y_padded = F.pad(y_padded, (0, need - y_padded.shape[-1]))
    blocks = y_padded[..., :need].reshape(y_padded.shape[:-1]
                                          + (nb, hop_length))
    dev = y_padded.device
    return (_gemm(blocks, _table("bc", n_fft, hop_length, 0, dev), dtype),
            _gemm(blocks, _table("bs", n_fft, hop_length, 0, dev), dtype))


def block_coeffs(y_padded: torch.Tensor, n_fft: int, hop_length: int,
                 n_frames_out: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., P) padded signal → per-block DFT coefficients (re, im), each
    (..., n_frames_out + n_fft / hop - 1, F), float32, the GEMM's
    operands in `matmul_dtype()`: the shared operand every
    overlapping-frame consumer combines from."""
    return _block_coeffs(y_padded, n_fft, hop_length, n_frames_out,
                         _MATMUL_DTYPE)


def combine_blocks(cre: torch.Tensor, cim: torch.Tensor, n_fft: int,
                   hop_length: int, n_frames_out: int,
                   n_blocks: int | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Twiddle-combine block coefficients into frame spectra: frame t over
    blocks t..t+n_blocks-1 (default n_fft / hop, the whole frame; fewer
    gives the DFT of the frame's first n_blocks·hop samples)."""
    if n_blocks is None:
        n_blocks = n_fft // hop_length
    dev = cre.device
    twr = _table("twr", n_fft, hop_length, 0, dev)
    twi = _table("twi", n_fft, hop_length, 0, dev)
    xre = cre[..., 0:n_frames_out, :]
    xim = cim[..., 0:n_frames_out, :]
    for j in range(1, n_blocks):
        rj = cre[..., j:j + n_frames_out, :]
        ij = cim[..., j:j + n_frames_out, :]
        tr, ti = twr[j], twi[j]
        xre = xre + tr * rj - ti * ij
        xim = xim + tr * ij + ti * rj
    return xre, xim


def block_spectra(y_padded: torch.Tensor, n_fft: int, hop_length: int,
                  n_frames_out: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., P) padded signal → unwindowed frame spectra (re, im), each
    (..., n_frames_out, 1 + n_fft // 2), via the block DFT. Needs
    hop_length | n_fft."""
    cre, cim = block_coeffs(y_padded, n_fft, hop_length, n_frames_out)
    return combine_blocks(cre, cim, n_fft, hop_length, n_frames_out)


def hann_in_frequency(xre: torch.Tensor, xim: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The periodic-Hann-windowed spectrum from the unwindowed one:
    X_w[k] = 0.5·X[k] - 0.25·(X[k-1] + X[k+1]), the neighbours past
    either end from the conjugate symmetry of a real signal's spectrum
    (X[-1] = conj(X[1]), X[N/2+1] = conj(X[N/2-1]))."""
    rm1 = torch.cat([xre[..., 1:2], xre[..., :-1]], dim=-1)
    im1 = torch.cat([-xim[..., 1:2], xim[..., :-1]], dim=-1)
    rp1 = torch.cat([xre[..., 1:], xre[..., -2:-1]], dim=-1)
    ip1 = torch.cat([xim[..., 1:], -xim[..., -2:-1]], dim=-1)
    return (0.5 * xre - 0.25 * (rm1 + rp1),
            0.5 * xim - 0.25 * (im1 + ip1))


def stft(y: torch.Tensor, n_fft: int = 2048, hop_length: int | None = None,
         win_length: int | None = None, center: bool = True,
         pad_mode: str = "constant") -> torch.Tensor:
    """Complex STFT, time-major: (..., n_frames, 1 + n_fft // 2), complex64.
    pad_mode 'constant' is librosa.stft's default, 'reflect' torch.stft's.
    A window shorter than n_fft is zero-padded to it on both sides, as
    librosa does."""
    if win_length is None:
        win_length = n_fft
    if hop_length is None:
        hop_length = win_length // 4
    if center:
        y = _pad_center(y, n_fft // 2, pad_mode)
    win = hann_window(win_length, y.device)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        win = F.pad(win, (lpad, n_fft - win_length - lpad))
    frames = frame(y, n_fft, hop_length) * win
    if stft_backend() == "matmul":
        c_m = _table("c", n_fft, 0, 0, y.device)
        s_m = _table("s", n_fft, 0, 0, y.device)
        return torch.complex(_gemm(frames, c_m, _MATMUL_DTYPE),
                             _gemm(frames, s_m, _MATMUL_DTYPE))
    return torch.fft.rfft(frames, n=n_fft, dim=-1)


def power_spectrogram(y: torch.Tensor, n_fft: int, hop_length: int,
                      center: bool = True, pad_mode: str = "constant",
                      power: float = 2.0,
                      n_freqs: int | None = None) -> torch.Tensor:
    """|rfft(frame · hann)|^power over the first `n_freqs` bins (default
    all 1 + n_fft // 2). On the matmul route: two GEMMs of the frames
    against the DFT matrices with the window folded in."""
    if n_freqs is None:
        n_freqs = 1 + n_fft // 2
    if center:
        y = _pad_center(y, n_fft // 2, pad_mode)
    frames = frame(y, n_fft, hop_length)
    if stft_backend() == "matmul":
        re = _gemm(frames, _table("cw", n_fft, 0, n_freqs, y.device),
                   _MATMUL_DTYPE)
        im = _gemm(frames, _table("sw", n_fft, 0, n_freqs, y.device),
                   _MATMUL_DTYPE)
        p = re * re + im * im
        if power == 2.0:
            return p
        return torch.sqrt(p) if power == 1.0 else p ** (power / 2.0)
    z = torch.fft.rfft(frames * hann_window(n_fft, y.device), n=n_fft,
                       dim=-1)[..., :n_freqs]
    mag = z.abs()
    return mag if power == 1.0 else mag ** power


def power_to_db_librosa(S: torch.Tensor, ref: float = 1.0,
                        amin: float = 1e-10, top_db: float | None = 80.0,
                        spec_axes: int = 2,
                        peak_mask: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """librosa.power_to_db: 10·log10 with a top_db clamp below the peak
    over the trailing `spec_axes` axes (one clip's spectrogram).
    `peak_mask` (broadcastable to S, True = takes part) restricts the
    peak to those entries: the frames of a zero-padded batch slot that
    straddle its valid end must not move the clamp of the valid ones."""
    log_spec = 10.0 * torch.log10(torch.clamp(S, min=amin))
    log_spec = log_spec - 10.0 * np.log10(max(amin, ref))
    if top_db is not None:
        ls = (log_spec if peak_mask is None
              else torch.where(peak_mask, log_spec, -torch.inf))
        peak = torch.amax(ls, dim=tuple(range(-spec_axes, 0)),
                          keepdim=True)
        log_spec = torch.maximum(log_spec, peak - top_db)
    return log_spec


def amplitude_to_db_torchaudio(S: torch.Tensor, stype: str = "power",
                               amin: float = 1e-10) -> torch.Tensor:
    """torchaudio AmplitudeToDB with its default top_db=None (no clamp)."""
    mult = 10.0 if stype == "power" else 20.0
    return mult * torch.log10(torch.clamp(S, min=amin))


def _last_nonzero_bin(fb_np: np.ndarray) -> int:
    """Index of the last frequency bin with any mel weight. Both mel
    conventions end their top triangle at Nyquist, so the Nyquist bin has
    zero weight and 1024 of 1025 bins are kept at n_fft 2048."""
    nz = np.nonzero(np.abs(fb_np).sum(axis=0))[0]
    return int(nz.max()) if nz.size else fb_np.shape[1] - 1


@functools.lru_cache(maxsize=16)
def _dct_ii_np(n_in: int, n_out: int) -> np.ndarray:
    """Orthonormal DCT-II matrix (n_in, n_out): X @ D equals
    scipy.fftpack.dct(X, type=2, norm='ortho')[..., :n_out]."""
    n = np.arange(n_in, dtype=np.float64)
    k = np.arange(n_out, dtype=np.float64)
    D = 2.0 * np.cos(np.pi * k[None, :] * (2.0 * n[:, None] + 1.0)
                     / (2.0 * n_in))
    scale = np.full(n_out, np.sqrt(1.0 / (2.0 * n_in)))
    scale[0] = np.sqrt(1.0 / (4.0 * n_in))
    return (D * scale[None, :]).astype(np.float32)


def dct_ii_matrix(n_in: int, n_out: int, device=None) -> torch.Tensor:
    return torch.from_numpy(_dct_ii_np(n_in, n_out)).to(device)


def melspectrogram_librosa(y: torch.Tensor, sr: int, n_fft: int = 2048,
                           hop_length: int = 512, n_mels: int = 128,
                           power: float = 2.0) -> torch.Tensor:
    """(..., n) → (..., n_frames, n_mels), librosa.feature.melspectrogram
    defaults."""
    fb_np = mel_filterbank_librosa(sr, n_fft, n_mels)
    f_keep = _last_nonzero_bin(fb_np) + 1
    S = power_spectrogram(y, n_fft, hop_length, pad_mode="constant",
                          power=power, n_freqs=f_keep)
    fb = torch.from_numpy(fb_np[:, :f_keep]).to(y.device)
    return torch.einsum("...tf,mf->...tm", S, fb)


def melspectrogram_torchaudio(y: torch.Tensor, sr: int, n_fft: int = 2048,
                              hop_length: int = 256, n_mels: int = 64,
                              power: float = 2.0, to_db: bool = True
                              ) -> torch.Tensor:
    """(..., n) → (..., n_frames, n_mels), torchaudio MelSpectrogram
    semantics plus AmplitudeToDB (10·log10 for power spectra, 20·log10
    for magnitude spectra)."""
    fb_np = mel_filterbank_torchaudio(sr, n_fft, n_mels)
    f_keep = _last_nonzero_bin(fb_np) + 1
    S = power_spectrogram(y, n_fft, hop_length, pad_mode="reflect",
                          power=power, n_freqs=f_keep)
    fb = torch.from_numpy(fb_np[:, :f_keep]).to(y.device)
    out = torch.einsum("...tf,mf->...tm", S, fb)
    if to_db:
        out = amplitude_to_db_torchaudio(
            out, stype="power" if power == 2.0 else "magnitude")
    return out


def mfcc(y: torch.Tensor, sr: int, n_mfcc: int = 20, n_fft: int = 2048,
         hop_length: int = 512, n_mels: int = 128) -> torch.Tensor:
    """(..., n) → (..., n_frames, n_mfcc), librosa.feature.mfcc defaults:
    mel power → power_to_db (top_db 80 per clip) → ortho DCT-II."""
    S = melspectrogram_librosa(y, sr, n_fft=n_fft, hop_length=hop_length,
                               n_mels=n_mels)
    S_db = power_to_db_librosa(S, spec_axes=2)
    return torch.einsum("...tm,mk->...tk", S_db,
                        dct_ii_matrix(n_mels, n_mfcc, y.device))
