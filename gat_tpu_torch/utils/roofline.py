"""Roofline accounting of the port on one H100: the card's published
peaks and the least work of each kernel and stage, counted from shapes.

A cost is (flops, bytes): the operations the function needs on these
inputs and the least memory traffic, each input read once and each output
written once. `bound` turns a cost into the least time the card could
take, the larger of bytes over the memory rate and flops over the fp32
rate, and says which of the two bounds it. `chip_smoke.py` (the kernels
line's `bound_ms`) and `tools/torch_roofline_files.py` (the per-stage
floors of the serving wave) count with these functions, so the two share
one denominator.

K1-K3 and K6 are counted per clip batch (N clips of `length` samples at
`sr`), K4 and K7 per batch of files (B files of n samples), K5 per batch
of envelopes (B envelopes of T frames), K8 per batch of slots (B files of
n samples, K slots each, of `length` samples), K9 per batch of rows.

`chip_smoke.py` loads this file by path from its own checkout, so that
another checkout timed by it (`tools/torch_onset_timing.py`) is held to
the same formulas; the package's helpers it counts with (frame counts,
the kernels' tables) are imported absolutely, from whichever
`gat_tpu_torch` is on `sys.path`.
"""
from __future__ import annotations

import math

__all__ = ["PEAK_FP32_FLOPS", "PEAK_BYTES_PER_S", "KERNEL_SYMBOLS",
           "device_function", "bound",
           "fft_flops", "melspec_cost", "mfcc_cost", "yin_cost",
           "mfcc_pitch_cost",
           "envelope_cost", "mel_db_cost", "flux_cost", "pick_cost",
           "gate_cost", "slice_cost", "window_samples", "resample_cost",
           "select_cost", "scatter_cost", "xent_cost", "clip_norm_cost",
           "adamw_cost", "bn_cost", "module_cost",
           "GATE_OPS_PER_SAMPLE"]

# H100 SXM published peaks (dense, no sparsity) at a 700 W limit
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# the device functions of K1-K13 (`device_function` of the profiler's
# names); K1, K2, K3 and K6 first their one-block route's, then their
# split route's (`csrc/dsp_common.cuh`)
KERNEL_SYMBOLS = {
    "K1": ("melspec_frontend_kernel", "melspec_divisor_kernel",
           "melspec_tile_kernel"),
    "K2": ("mfcc_frontend_kernel", "mfcc_divisor_kernel", "mfcc_tile_kernel",
           "mfcc_sums_kernel", "mfcc_mean_kernel"),
    "K3": ("yin_pitch_kernel", "yin_tile_kernel", "yin_median_kernel"),
    "K4": ("onset_mel_db_kernel", "onset_flux_kernel"),
    "K5": ("onset_pick_kernel",),
    "K6": ("mfcc_pitch_frontend_kernel", "mfcc_pitch_divisor_kernel",
           "mfcc_pitch_tile_kernel", "mfcc_pitch_sums_kernel",
           "mfcc_pitch_mean_kernel"),
    "K7": ("noise_gate_rms_kernel", "noise_gate_threshold_kernel",
           "noise_gate_apply_kernel"),
    "K8": ("slice_clips_kernel",),
    "K9": ("resample_kernel",),
    "K10": ("wave_select_kernel", "wave_scatter_kernel"),
    "K11": ("softmax_xent_kernel",),
    "K12": ("clip_norm_kernel", "adamw_update_kernel"),
    "K13": ("bn_moments_kernel", "bn_apply_kernel", "bn_apply_grad_kernel",
            "bn_moments_grad_kernel"),
}


def device_function(name: str) -> str:
    """The device function a profiler's kernel name is of: the name up to
    its template arguments or parameter list, without the `void` that a
    template's name starts with (`void melspec_frontend_kernel<true>(float
    const*, ...)` and `slice_clips_kernel(float const*, ...)` are
    melspec_frontend_kernel and slice_clips_kernel)."""
    name = name.removeprefix("void ")
    for stop in "<(":
        name = name.split(stop, 1)[0]
    return name.strip()


# the gates' least work per sample: the dB gate (abs, log, scale,
# compare, multiply), the frame RMS as a running sum (square, add), the
# frame mask and the length mask
GATE_OPS_PER_SAMPLE = 10

_N_FFT = 2048
_RFFT_FLOPS = 5 * _N_FFT * 11 // 2  # a real-input FFT of 2048 points


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """(least ms, "operations" or "bytes") of a cost on the card."""
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_mem = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def fft_flops(n_mels_nnz: int, n_mels: int) -> int:
    """Flops one frame of the front-ends needs: window, a real-input FFT
    of 2048 points (2.5·N·log2 N, half a complex one), power of 1025
    bins, sparse mel, log."""
    return _N_FFT + _RFFT_FLOPS + 3 * 1025 + 2 * n_mels_nnz + n_mels


def _tables(sr: int, n_mels: int, htk: bool, device) -> tuple[int, int]:
    """(nonzero filterbank weights, bytes of the tables) of a front-end
    kernel: window, twiddles, dense filterbank and its bin ranges."""
    import torch
    from gat_tpu_torch.features import _kernel_tables
    tables = _kernel_tables(sr, n_mels, htk, torch.device(device))
    *_, lo, hi = tables
    return (int((hi - lo).sum()),
            sum(a.numel() * a.element_size() for a in tables))


def melspec_cost(n: int, length: int, sr: int, device="cpu"
                 ) -> tuple[int, int]:
    """K1 at (n, length): every frame's FFT and 64-band mel, the volume
    normalization; the clips read once, the image and tables once."""
    from gat_tpu_torch.ops import spectral
    t = spectral.n_frames(length, _N_FFT, 256)
    nnz, table_bytes = _tables(sr, 64, True, device)
    return (n * (t * fft_flops(nnz, 64) + 3 * length),
            n * length * 4 + n * 64 * t * 4 + table_bytes)


def mfcc_cost(n: int, length: int, sr: int, device="cpu"
              ) -> tuple[int, int]:
    """K2 at (n, length): every frame's FFT, 128-band mel and dB, the
    64-coefficient DCT of the mean, the volume normalization; the clips
    read once, the 64 means written once, the tables and the DCT matrix
    read once."""
    from gat_tpu_torch.ops import spectral
    t = spectral.n_frames(length, _N_FFT, 512)
    nnz, table_bytes = _tables(sr, 128, False, device)
    return (n * (t * (fft_flops(nnz, 128) + 2 * 128) + 2 * 128 * 64
                 + 3 * length),
            n * length * 4 + n * 64 * 4 + table_bytes + 4 * 128 * 64)


def _acf_flops(max_p: int) -> int:
    """Flops one YIN frame needs beyond its own FFT: the ACF from FFTs of
    2048 points (the reversed window's real FFT, the cross spectrum at 6
    flops per bin, the inverse real FFT), then O(max_p) for the sliding
    energies and the CMND."""
    return 2 * _RFFT_FLOPS + 6 * 1025 + 9 * max_p


def yin_cost(n: int, length: int, sr: int) -> tuple[int, int]:
    """K3 at (n, length): each frame's real FFT and its ACF at the FFT
    cost, the least work of the function (the kernel's direct sums, 2·W
    flops per lag, do about 2.6x more at 11025 Hz); the clips read once,
    one pitch written per clip."""
    from gat_tpu_torch.ops import spectral
    from gat_tpu_torch.ops.yin import yin_periods
    t = spectral.n_frames(length, _N_FFT, 512)
    _, max_p = yin_periods(sr, 50.0, 1000.0, _N_FFT, 1024)
    return (n * t * (_RFFT_FLOPS + _acf_flops(max_p)),
            n * length * 4 + n * 4)


def mfcc_pitch_cost(n: int, length: int, sr: int, device="cpu"
                    ) -> tuple[int, int]:
    """K6 at (n, length): K2's work with one unwindowed FFT per frame
    that both branches share, the Hann window applied in frequency (three
    taps, 8 flops per bin, for K2's 2048 window products), and the YIN
    ACF from that FFT (`_acf_flops`); the clips read once, the n_mfcc + 1
    features and the pitch written once, K2's tables and DCT matrix read
    once."""
    from gat_tpu_torch.ops import spectral
    from gat_tpu_torch.ops.yin import yin_periods
    mfcc_flops, mfcc_bytes = mfcc_cost(n, length, sr, device)
    t = spectral.n_frames(length, _N_FFT, 512)
    _, max_p = yin_periods(sr, 50.0, 1000.0, _N_FFT, 1024)
    return (mfcc_flops + n * t * (_acf_flops(max_p) + 8 * 1025 - _N_FFT),
            mfcc_bytes + n * (1 + 1) * 4)


def envelope_cost(files: int, n: int, sr: int, device="cpu",
                  hop: int = 512) -> tuple[int, int]:
    """K4 at (files, n): the FFT and 128-band mel of every frame, the
    flux; each sample read and each envelope value written once, with
    the valid counts, the window, the twiddles and the filterbank's
    nonzero weights and their bin ranges."""
    import torch
    from gat_tpu_torch.features import _kernel_tables
    t = 1 + n // hop
    hann, tw, _, lo, hi = _kernel_tables(sr, 128, False,
                                         torch.device(device))
    nnz = int((hi - lo).sum())
    tables = 4 * (hann.numel() + tw.numel() + nnz + 2 * 128)
    return (files * t * (fft_flops(nnz, 128) + 4 * 128),
            4 * files * (n + t + 1) + tables)


def _envelope_tables(sr: int, device) -> tuple[int, int]:
    """(nonzero mel weights, bytes of K4's tables)."""
    import torch
    from gat_tpu_torch.features import _kernel_tables
    hann, tw, _, lo, hi = _kernel_tables(sr, 128, False,
                                         torch.device(device))
    nnz = int((hi - lo).sum())
    return nnz, 4 * (hann.numel() + tw.numel() + nnz + 2 * 128)


def mel_db_cost(files: int, n: int, frames: int, sr: int, device="cpu"
                ) -> tuple[int, int]:
    """K4's first pass alone (`gat_onset_mel_db`) over (files, n) rows of
    `frames` frames: every frame's FFT, 128-band mel and dB; each sample
    read once, the dB rows and the peak keys written once, with the valid
    counts and the tables."""
    nnz, tables = _envelope_tables(sr, device)
    return (files * frames * fft_flops(nnz, 128),
            4 * files * (n + frames * 128 + 2) + tables)


def flux_cost(files: int, frames: int) -> tuple[int, int]:
    """K4's second pass alone (`gat_onset_flux`) over (files, frames, 128)
    dB rows: a clamp of both frames, a difference, a max and a sum per
    band and frame; the rows and peak keys read once, the envelope
    written once."""
    return (files * frames * 4 * 128,
            4 * files * (frames * 128 + 1 + frames))


def pick_cost(files: int, t: int, sr: int, hop: int = 512,
              max_onsets: int = 64) -> tuple[int, int]:
    """K5 at (files, t): the peak pick's compares; one read of the
    envelopes and the valid counts, one write of the outputs at
    `max_onsets` onsets."""
    from gat_tpu_torch.ops.onset import peak_pick_params
    pre_max, post_max, _, _, _ = peak_pick_params(sr, hop)
    return (files * t * (pre_max + post_max + 16),
            4 * files * (t + 1) + files * (max_onsets * 5 + 6))


def gate_cost(files: int, n: int) -> tuple[int, int]:
    """K7 (and the serving wave's `segmentation_other` stage, the length
    mask and both gates, which it replaces) at (files, n):
    `GATE_OPS_PER_SAMPLE` operations a sample; each sample read and each
    gated sample written once, with one 8-byte count a file."""
    return (GATE_OPS_PER_SAMPLE * files * n, 8 * files * n + 8 * files)


def slice_cost(files: int, n: int, slots: int, length: int,
               windows: int | None = None) -> tuple[int, int]:
    """K8 (and the serving wave's `slicing` stage) at `slots` clips of
    `length` samples over (files, n): a square and an add per clip sample
    for the loudness; the samples the windows read, the onsets, the clips
    written, the kept flags and the times, and the valid flags, once.
    The samples read depend on the onsets: `windows`, this run's count
    (`window_samples`), or by default the most they could be, every
    slot's whole clip and at most the files' samples."""
    if windows is None:
        windows = min(files * n, slots * length)
    return (2 * slots * length,
            4 * windows + 4 * slots + 4 * slots * length + 9 * slots)


def window_samples(times, valid, n_valid, sr: int) -> int:
    """The samples the slicer's windows read: end - start over the valid
    slots whose window lies in the file (start < n_valid, end <=
    n_valid), from its times (B, K, 2) in float32 seconds (x · fl(1/sr),
    rounded back to samples; past about 2^22 samples a window may be a
    sample off), the valid slots (B, K) and the (B,) valid counts."""
    import torch
    t = torch.round(times.detach().cpu().double() * sr).to(torch.int64)
    start, end = t[..., 0], t[..., 1]
    nv = n_valid.detach().cpu().to(torch.int64)[:, None]
    inside = valid.detach().cpu() & (start < nv) & (end <= nv)
    return int(torch.where(inside, (end - start).clamp(min=0), 0).sum())


def resample_cost(rows: int, n_in: int, sr_in: int, sr_out: int,
                  out_len: int | None = None) -> tuple[int, int]:
    """The polyphase Kaiser filter from `sr_in` to `sr_out` over `rows`
    signals of `n_in` samples (K9): a multiply-add per tap of each output
    sample's phase; the signals read and the outputs written once. With
    `out_len` the outputs are cut or zero-padded to that many
    (`resample_rows`): min(m, out_len) computed, out_len written."""
    if sr_in == sr_out:
        return 0, 0
    from gat_tpu_torch.ops.resample import resample_filter
    g = math.gcd(sr_in, sr_out)
    up, down = sr_out // g, sr_in // g
    n_out = -(-n_in * up // down)
    written = n_out if out_len is None else out_len
    taps = -(-resample_filter(up, down).size // up)
    return (2 * taps * rows * min(n_out, written),
            4 * rows * (n_in + written))


def select_cost(n_files: int, k: int, n_local: int, n_sel: int
                ) -> tuple[int, int]:
    """K10's selection of a wave of n_files x K slots for n_local files
    that picks n_sel: a count and a compare a slot; the kept bits and
    the two input flags read once, sel, pos, the new kept bits, the three
    output flags and the count written once."""
    slots = n_files * k
    return (2 * slots, slots + 2 * n_local + 4 * n_sel + 5 * n_local * k
            + 3 * n_local + 4)


def scatter_cost(n: int, rows: int, widths: int) -> tuple[int, int]:
    """K10's scatter of `rows` compact rows back to n slots, `widths`
    floats a row over its parts (3·C + 1 for three probability matrices
    and the pitch): no arithmetic; pos and the rows read once, the
    outputs written once."""
    return 0, 4 * n + 4 * rows * widths + 4 * n * widths


def xent_cost(b: int, c: int, grad: bool, preds: bool = False
              ) -> tuple[int, int]:
    """K11 over (b, c) float32 logits: per logit a compare, a subtraction,
    an exponent, a sum and the loss term's three operations, and with the
    gradient a division, a product and a difference more; the logits and
    the int64 labels read once, the loss (4 bytes) and the count (8)
    written, and the gradient (4·b·c) and the argmaxes (8·b) where asked
    for."""
    return ((7 + 3 * grad) * b * c,
            4 * b * c + 8 * b + 12 + 4 * b * c * grad + 8 * b * preds)


def clip_norm_cost(n: int) -> tuple[int, int]:
    """K12's pass 1 over n float32 gradients: a square and a sum each;
    the gradients read once, the norm and the count written."""
    return 2 * n, 4 * n + 8


def adamw_cost(n: int, clipped: bool) -> tuple[int, int]:
    """K12's pass 2 over n parameters: the clip (2), the moments (6), the
    bias corrections, root and quotient (5) and the decayed update (4) a
    parameter; p, g, mu, nu read and p, mu, nu written (28 bytes a
    parameter), and g written back where the step clips (4 more)."""
    return 17 * n, (28 + 4 * clipped) * n + 12


def bn_cost(kernel: str, n: int, c: int, p: int, elem: int
            ) -> tuple[int, int]:
    """One of K13's kernels over x (n, c, p positions) of `elem` bytes an
    element: "moments" reads x (sum and sum of squares, 3 operations an
    element) and writes 2·C floats; "apply" reads x and writes y (3 an
    element) with the C-sized parameters and statistics; "apply_grad"
    reads dy and x (4 an element) and writes 5·C floats; "moments_grad"
    reads dy and x and writes dx (5 an element)."""
    e = n * c * p
    per = {"moments": (3, 1, 8 * c), "apply": (3, 2, 32 * c),
           "apply_grad": (4, 2, 32 * c), "moments_grad": (5, 3, 12 * c)}
    ops, tensors, small = per[kernel]
    return ops * e, tensors * e * elem + small


def module_cost(module, example_shape: tuple) -> tuple[int, int]:
    """A model's forward on a batch of `example_shape`: the flops of its
    matmuls and convolutions (torch's shape formulas, run on the meta
    device, so nothing is computed), the parameters and buffers read
    once, the input read and the logits written once."""
    import copy

    import torch
    from torch.utils.flop_counter import FlopCounterMode
    meta = copy.deepcopy(module).to("meta").eval()
    x = torch.empty(example_shape, device="meta")
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        out = meta(x)
    weights = sum(p.numel() * p.element_size()
                  for p in (*module.parameters(), *module.buffers()))
    return (int(counter.get_total_flops()),
            weights + 4 * math.prod(example_shape) + 4 * out.numel())
