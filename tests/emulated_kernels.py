"""The CUDA kernels' own source, run on the CPU under an emulation of the
CUDA subset they use, against their plain PyTorch versions.

There is no nvcc on a CPU-only machine, but the kernels of
`gat_tpu_torch/csrc/` use only thread/block indices, shared memory,
register arrays, device lambdas, `__syncthreads`, warp shuffles, ballots,
`__popc` and `__ffs`, integer atomicMax, atomicAdd and atomicOr, `__threadfence`
and `__ldcg` (a fence and a plain load: the blocks run one after
another), the float/int bit casts, the float32 steps rounded one by one (`__fadd_rn`, `__fsub_rn`,
`__fmul_rn`) and `fmaf` (libm's, fused as the card's), `__ldg`, `float4`, asynchronous copies into shared memory
(`cp.async`, and `csrc/bulk_copy.cuh`'s bulk copies on an mbarrier) and
the dynamic shared-memory attribute. The header below maps those onto
C++: one std::thread per CUDA thread, the blocks of a launch one after
another, a barrier for `__syncthreads`, a barrier per warp and an
exchange slot per lane for the warp intrinsics, a compare-and-swap or a
fetch-and-add for the atomics, a plain copy for the asynchronous ones,
and for an mbarrier a word of its phase, arrivals and bytes, so that a
wait holds its threads until the copies it waits for have landed. Each `.cu` is compiled by g++ with the header forced in (it stands
in for `cuda_runtime.h`, `cuda_pipeline.h` and `bulk_copy.cuh`) and its
`<<<grid, block, smem, stream>>>` launch turned into a call of
`emu_launch`; the C entry points are then called through ctypes with CPU
pointers, with the argument lists the wrappers use. This checks the
kernels' arithmetic and indexing, not the GPU compiler or the card:
`chip_smoke.py` does that.

This module holds what the emulated-kernel tests share: the header,
the launch rewrite, the `libs` fixture of each test file (it compiles
only the kernels its file names, `libs_fixture`), and the helpers and
inputs the tests of each kernel use, some of which the card's tests
(`tests/test_torch_cuda.py`) and the port's CPU tests import too. The
tests are `tests/test_torch_kernels_emulated_*.py`, one or two kernels
a file, so that `--dist loadfile` spreads them over the workers.
"""
import contextlib
import ctypes
import functools
import hashlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gat_tpu_torch import features, kernels
from gat_tpu_torch.ops import (batchnorm, compaction, onset, resample,
                               spectral, yin)
from gat_tpu_torch.ops import loss as loss_mod
from gat_tpu_torch.segment import gating, slicing
from gat_tpu_torch.train import optim

SR = 11025
CPU = torch.device("cpu")

EMULATION_HEADER = r"""
#pragma once
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <functional>
#include <pthread.h>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct dim3 { unsigned x = 1, y = 1, z = 1; };
inline thread_local dim3 threadIdx, blockIdx, blockDim;
inline dim3 gridDim;
inline pthread_barrier_t emu_barrier;
inline void __syncthreads() { pthread_barrier_wait(&emu_barrier); }
#define __shared__ static
// warps: a barrier and an exchange slot per lane; a shuffle stores, waits,
// loads its source lane's slot and waits again before the slot is reused
inline pthread_barrier_t emu_warp_barrier[32];
alignas(8) inline unsigned char emu_lane_slot[1024][8];
inline void __syncwarp(unsigned = 0xffffffffu) {
  pthread_barrier_wait(&emu_warp_barrier[threadIdx.x / 32]);
}
template <class T> T emu_from_lane(T v, unsigned src) {
  static_assert(sizeof(T) <= 8, "a lane slot holds 8 bytes");
  std::memcpy(emu_lane_slot[threadIdx.x], &v, sizeof(T));
  __syncwarp();
  T r;
  std::memcpy(&r, emu_lane_slot[(threadIdx.x & ~31u) + (src & 31u)],
              sizeof(T));
  __syncwarp();
  return r;
}
template <class T> T __shfl_sync(unsigned, T v, int src, int = 32) {
  return emu_from_lane(v, src);
}
template <class T> T __shfl_up_sync(unsigned, T v, unsigned d, int = 32) {
  const unsigned lane = threadIdx.x & 31u;
  return emu_from_lane(v, lane >= d ? lane - d : lane);
}
template <class T> T __shfl_xor_sync(unsigned, T v, int mask, int = 32) {
  return emu_from_lane(v, (threadIdx.x & 31u) ^ mask);
}
inline unsigned __ballot_sync(unsigned, int pred) {
  emu_lane_slot[threadIdx.x][0] = pred != 0;
  __syncwarp();
  unsigned m = 0;
  for (unsigned l = 0; l < 32; ++l)
    m |= (unsigned)emu_lane_slot[(threadIdx.x & ~31u) + l][0] << l;
  __syncwarp();
  return m;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline unsigned atomicOr(unsigned* p, unsigned v) {
  return __atomic_fetch_or(p, v, __ATOMIC_SEQ_CST);
}
inline int atomicMax(int* p, int v) {
  int old = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (old < v && !__atomic_compare_exchange_n(
             p, &old, v, false, __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST)) {
  }
  return old;
}
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n) {
  std::memcpy(dst, src, n);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}
// csrc/bulk_copy.cuh (Hopper's bulk copy on an mbarrier): a barrier is one
// word of its phase (bits 56-63), its arrival count (48-55), the arrivals
// (32-47) and bytes (0-31) its phase still waits for; a copy lands at once
// and then completes its bytes, a phase completes when neither is left,
// and a wait spins until the phase of its parity has completed
inline void emu_bar_update(uint64_t* bar, unsigned arrivals, unsigned tx) {
  uint64_t old = __atomic_load_n(bar, __ATOMIC_SEQ_CST), now;
  do {
    unsigned phase = (unsigned)(old >> 56), count = (old >> 48) & 0xffu;
    unsigned left = ((old >> 32) & 0xffffu) - arrivals;
    const unsigned bytes = (unsigned)old + tx;
    if (left == 0 && bytes == 0) {
      ++phase;
      left = count;
    }
    now = (uint64_t)(phase & 0xffu) << 56 | (uint64_t)count << 48 |
          (uint64_t)(left & 0xffffu) << 32 | bytes;
  } while (!__atomic_compare_exchange_n(bar, &old, now, false,
                                        __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST));
}
inline void mbar_init(uint64_t* bar, unsigned count) {
  __atomic_store_n(bar, (uint64_t)count << 48 | (uint64_t)count << 32,
                   __ATOMIC_SEQ_CST);
}
inline void mbar_arrive_expect(uint64_t* bar, unsigned bytes) {
  emu_bar_update(bar, 1, bytes);
}
inline void bulk_load(void* dst, const void* src, unsigned bytes,
                      uint64_t* bar) {
  std::memcpy(dst, src, bytes);
  emu_bar_update(bar, 0, 0u - bytes);
}
inline void mbar_wait(uint64_t* bar, unsigned parity) {
  while ((__atomic_load_n(bar, __ATOMIC_SEQ_CST) >> 56 & 1u) == parity)
    std::this_thread::yield();
}
struct int2 { int x, y; };
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
// float32 steps rounded one by one (g++ here contracts no FMA)
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline int2 make_int2(int x, int y) { return {x, y}; }
template <class T> T __ldg(const T* p) { return *p; }
template <class T> T __ldcg(const T* p) { return *p; }
inline void __threadfence() { __atomic_thread_fence(__ATOMIC_SEQ_CST); }
inline int __float_as_int(float f) { int i; std::memcpy(&i, &f, 4); return i; }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
typedef void* cudaStream_t;
typedef int cudaError_t;
constexpr int cudaSuccess = 0;
constexpr int cudaErrorInvalidValue = 1;
constexpr int cudaFuncAttributeMaxDynamicSharedMemorySize = 8;
// the dynamic shared-memory attribute, one per library (each holds one
// kernel that sets it), readable from the test
extern "C" { inline int emu_smem_attr = 48 * 1024; }
template <class F> int cudaFuncSetAttribute(F, int, int bytes) {
  if (bytes > 232448) return 1;  // an H100 block's shared-memory limit
  emu_smem_attr = bytes;
  return 0;
}
struct cudaFuncAttributes { int maxDynamicSharedSizeBytes; };
template <class F> int cudaFuncGetAttributes(cudaFuncAttributes* a, F) {
  a->maxDynamicSharedSizeBytes = emu_smem_attr;
  return 0;
}
template <class F>
int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) {
  *n = 0;  // no occupancy without a card
  return 0;
}
inline int cudaGetLastError() { return 0; }
// the card's SMs (K9 sizes its grid by them with the occupancy above, read
// as 1 block an SM), readable and settable from the test
extern "C" { inline int emu_sm_count = 4; }
constexpr int cudaDevAttrMultiProcessorCount = 16;
inline int cudaGetDevice(int* device) { *device = 0; return 0; }
inline int cudaDeviceGetAttribute(int* value, int, int) {
  *value = emu_sm_count;
  return 0;
}
alignas(16) inline float smem[232448 / sizeof(float)];
inline void emu_launch(int grid, int block, std::function<void()> fn) {
  gridDim.x = grid;
  for (int b = 0; b < grid; ++b) {
    pthread_barrier_init(&emu_barrier, nullptr, block);
    for (int w = 0; w < block / 32; ++w)
      pthread_barrier_init(&emu_warp_barrier[w], nullptr, 32);
    std::vector<std::thread> ts;
    for (int t = 0; t < block; ++t)
      ts.emplace_back([=]() {
        threadIdx.x = t; blockIdx.x = b; blockDim.x = block; fn();
      });
    for (auto& th : ts) th.join();
    pthread_barrier_destroy(&emu_barrier);
    for (int w = 0; w < block / 32; ++w)
      pthread_barrier_destroy(&emu_warp_barrier[w]);
  }
}
"""

_LAUNCH = re.compile(r"(\w+)<<<([^,]+),\s*([^,]+),[^>]*>>>\((.*?)\);",
                     re.S)
LAUNCHES = {"onset_envelope": 2,  # kernel launches per C entry point
            "noise_gate": 3,
            "wave_compact": 2,  # (per source: two entry points of one)
            "clip_adamw": 2,    # (two entry points of one)
            "batchnorm_train": 4,  # (four entry points of one)
            # (per source: the one-block route, then the split route's
            # divisors, tiles, sums and means, or tiles and medians)
            "melspec_frontend": 3, "mfcc_frontend": 5, "yin_pitch": 3,
            "mfcc_pitch_frontend": 5}


class EmulatedLibs(dict):
    """The emulated libraries of a test file by kernel name; only the
    kernels named at construction are compiled (by g++, one process per
    source, all at once)."""

    def __init__(self, names, out):
        super().__init__()
        gxx = shutil.which("g++")
        (out / "cuda_runtime.h").write_text(EMULATION_HEADER)
        for header in ("cuda_pipeline.h", "bulk_copy.cuh"):  # in the header
            (out / header).write_text("#pragma once\n")
        procs = {}
        for name in names:
            src = (kernels.CSRC / f"{name}.cu").read_text()
            src = src.replace("extern __shared__ float smem[];", "")
            src, n = _LAUNCH.subn(
                lambda m: (f"emu_launch({m[2]}, {m[3]}, [&]() "
                           f"{{ {m[1]}({m[4]}); }});"), src)
            assert n == LAUNCHES.get(name, 1), name
            (out / f"{name}.cpp").write_text(src)
            procs[name] = subprocess.Popen(
                [gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-pthread",
                 "-include", str(out / "cuda_runtime.h"), "-I", str(out),
                 "-I", str(kernels.CSRC), "-o", str(out / f"lib{name}.so"),
                 str(out / f"{name}.cpp")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, proc in procs.items():
            log, _ = proc.communicate(timeout=300)
            assert proc.returncode == 0, log
            self[name] = ctypes.CDLL(str(out / f"lib{name}.so"))


def libs_fixture(names):
    """The module-scoped `libs` fixture of a test file: the kernels
    `names` compiled by g++ under the emulation header."""
    @pytest.fixture(scope="module")
    def libs(tmp_path_factory):
        if shutil.which("g++") is None:
            pytest.skip("needs g++")
        return EmulatedLibs(names, tmp_path_factory.mktemp("emulated_kernels"))
    return libs


def _fn(lib, symbol, argtypes):
    fn = getattr(lib, symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def _clips(length: int) -> torch.Tensor:
    """A decaying 110 Hz tone, the same with noise, and a 660 Hz pluck-like
    tone with noise."""
    rng = np.random.default_rng(11)
    t = np.arange(length) / SR
    x = np.stack([np.sin(2 * np.pi * 110.0 * t) * np.exp(-3 * t),
                  np.sin(2 * np.pi * 110.0 * t) * np.exp(-3 * t)
                  + rng.normal(0, 0.05, length),
                  0.3 * np.sign(np.sin(2 * np.pi * 660.0 * t))
                  * np.exp(-6 * t) + rng.normal(0, 0.1, length)])
    return torch.from_numpy(x.astype(np.float32))


def level_step_clip(length: int = 5512, onset: int = 2560) -> np.ndarray:
    """(1, length): 1e-4 noise, then from `onset` a Karplus-Strong pluck of
    peak 2. With the onset at 1024 + hop t for an even t, frame t is all
    noise and frame t + 1, its partner in one FFT of K1 (hop 256) or K2
    (hop 512), holds the pluck: their mel bands differ by up to about 60
    dB (K1, onset 2560) or 77 dB (K2, onset 3072)."""
    rng = np.random.default_rng(5)
    x = rng.normal(0.0, 1e-4, length)
    period = round(SR / 196.0)
    buf = rng.uniform(-1.0, 1.0, period)
    for i in range(length - onset):
        x[onset + i] += 2.0 * buf[i % period]
        buf[i % period] = 0.498 * (buf[i % period] + buf[(i + 1) % period])
    return x[None].astype(np.float32)


def check_mel_image(got: torch.Tensor, ref: torch.Tensor, to_db: bool
                    ) -> None:
    """K1's tolerance against its plain version: 0.1 dB where the plain
    image is above -60 dB, finite and >= -100 dB everywhere; without dB,
    rtol 1e-3 and atol 1e-5 of the image's peak."""
    assert got.shape == ref.shape
    if to_db:
        mask = ref > -60
        assert float((got - ref).abs()[mask].max()) <= 0.1
        assert float(got.min()) >= -100.0 and bool(torch.isfinite(got).all())
    else:
        torch.testing.assert_close(got, ref, rtol=1e-3,
                                   atol=1e-5 * float(ref.abs().max()))


def _melspec_emulated(libs, x: torch.Tensor, normalize: bool, to_db: bool
                      ) -> torch.Tensor:
    n, length = x.shape
    n_fr = spectral.n_frames(length, 2048, 256)
    out = torch.empty((n, 64, n_fr, 1))
    hann, tw, fb, lo, hi = features._kernel_tables(SR, 64, True, CPU)
    fn = _fn(libs["melspec_frontend"], "gat_melspec_frontend",
             features._MELSPEC_ARGS)
    assert fn(x.data_ptr(), out.data_ptr(), hann.data_ptr(), tw.data_ptr(),
              fb.data_ptr(), lo.data_ptr(), hi.data_ptr(), n, length, 256,
              n_fr, 64, int(normalize), int(to_db), None) == 0
    return out


def workspace(libs, kernel: str, symbol: str, n: int, *sizes: int):
    """The (n, floats) workspace a kernel's launch at these sizes needs,
    as its C entry point `symbol` counts it, or None when it needs none
    or refuses the sizes (-1; the wrappers' `features._workspace`)."""
    floats = _fn(libs[kernel], symbol, [ctypes.c_int] * len(sizes))(*sizes)
    return torch.full((n, floats), float("nan")) if floats > 0 else None


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _mfcc_emulated(libs, x: torch.Tensor, normalize: bool) -> torch.Tensor:
    n, length = x.shape
    n_fr = spectral.n_frames(length, 2048, 512)
    out = torch.empty((n, 64))
    hann, tw, fb, lo, hi = features._kernel_tables(SR, 128, False, CPU)
    dct = spectral.dct_ii_matrix(128, 64)
    ws = workspace(libs, "mfcc_frontend", "gat_mfcc_workspace_floats", n,
                   128, n_fr)
    fn = _fn(libs["mfcc_frontend"], "gat_mfcc_frontend",
             features._MFCC_ARGS)
    assert fn(x.data_ptr(), out.data_ptr(), hann.data_ptr(), tw.data_ptr(),
              fb.data_ptr(), lo.data_ptr(), hi.data_ptr(), dct.data_ptr(),
              _ptr(ws), n, length, 512, n_fr, 128, 64, int(normalize), 80.0,
              None) == 0
    return out


def mfcc_level_step_clip() -> np.ndarray:
    """`level_step_clip` with its onset at 3072: frames 4 (noise) and 5
    (the pluck) share one FFT of K2."""
    return level_step_clip(onset=3072)


def check_mfcc_level_step(x: torch.Tensor) -> None:
    """The level step is as steep as `mfcc_level_step_clip` says, and the
    clip's clamp at peak - 80 dB binds."""
    S = spectral.melspectrogram_librosa(features.normalize_volume(x.cpu()),
                                        SR)[0]
    db = 10.0 * torch.log10(torch.clamp(S, min=1e-10))
    assert float((db[5] - db[4]).max()) >= 55.0
    assert bool((db < db.max() - 80.0).any())


def mfcc_pitch_emulated(libs, x: torch.Tensor, sr: int, normalize: bool,
                        pitch_normalized: bool, hop: int = 512,
                        win: int = 1024, periods=None
                        ) -> tuple[int, torch.Tensor, torch.Tensor]:
    """K6's C entry point with the arguments `features.mfcc_pitch_features`
    passes (hop 512, win 1024, the periods of 50-1000 Hz unless given) and
    the workspace its query asks for: (status, features (N, 65), hz
    (N,))."""
    n, length = x.shape
    n_fr = spectral.n_frames(length, 2048, hop)
    out = torch.full((n, 65), float("nan"))
    hz = torch.full((n,), float("nan"))
    hann, tw, fb, lo, hi = features._kernel_tables(sr, 128, False, CPU)
    dct = spectral.dct_ii_matrix(128, 64)
    min_p, max_p = periods or yin.yin_periods(sr, 50.0, 1000.0, 2048, 1024)
    ws = workspace(libs, "mfcc_pitch_frontend",
                   "gat_mfcc_pitch_workspace_floats", n, n_fr, 128, 64, win,
                   hop, max_p)
    fn = _fn(libs["mfcc_pitch_frontend"], "gat_mfcc_pitch_frontend",
             features._MFCC_PITCH_ARGS)
    status = fn(x.data_ptr(), out.data_ptr(), hz.data_ptr(), hann.data_ptr(),
                tw.data_ptr(), fb.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                dct.data_ptr(), _ptr(ws), n, length, hop, n_fr, 128, 64, win,
                min_p, max_p, int(normalize), int(pitch_normalized), 80.0,
                0.1, float(sr), None)
    return status, out, hz


# the index of test_torch_yin's pinned near-tie in `port_pluck_clips`
PLUCK_NEAR_TIE = 41


def port_pluck_clips(noise: float, seed: int = 0) -> np.ndarray:
    """tests/test_torch_spectral.py's `pluck_clips` from the port's own
    synthesizer (byte-identical to gat_tpu's, and free of JAX for the
    card's tests): (47, 5512) plucks at MIDI 40..86 plus Gaussian noise
    of sigma `noise`."""
    from gat_tpu_torch.data.synth import karplus_strong
    from gat_tpu_torch.ops.pitch import midi_to_hz
    clips = np.stack([karplus_strong(float(midi_to_hz(40 + i)), SR, 0.5,
                                     seed=i)[0] for i in range(47)])
    rng = np.random.default_rng(seed)
    return (clips + rng.normal(0.0, noise, clips.shape)).astype(np.float32)


def shared_frontend_clips(sr: int) -> torch.Tensor:
    """(8, sr / 2): `_clips`' three tones, four noisy plucks (E2, A3, E4,
    A5) and a silent clip, at `sr`."""
    length = sr // 2
    plucks = port_pluck_clips(0.1)[[0, 17, 24, 41]]
    if sr != SR:  # each sample held twice, the last one padded with 0
        plucks = np.pad(np.repeat(plucks, sr // SR, axis=1),
                        ((0, 0), (0, 1)))
    t = np.arange(length) / sr
    tones = np.stack([np.sin(2 * np.pi * 110.0 * t) * np.exp(-3 * t),
                      np.sin(2 * np.pi * 196.0 * t) * np.exp(-3 * t)
                      + np.random.default_rng(11).normal(0, 0.05, length),
                      0.3 * np.sign(np.sin(2 * np.pi * 660.0 * t))
                      * np.exp(-6 * t)
                      + np.random.default_rng(12).normal(0, 0.1, length)])
    x = np.concatenate([tones, plucks[:, :length],
                        np.zeros((1, length))]).astype(np.float32)
    return torch.from_numpy(x)


@pytest.fixture
def matmul_route():
    """The matmul route in fp32 for one test, the defaults back after."""
    spectral.set_stft_backend("matmul")
    yield
    spectral.set_stft_backend("auto")
    spectral.set_matmul_dtype(torch.float32)


def yin_float64(x: torch.Tensor, sr: int) -> torch.Tensor:
    """The median YIN pitch of each clip with every sum in float64 and the
    direct ACF: librosa's algorithm without rounding to speak of."""
    frames = torch.nn.functional.pad(x.double(), (1024, 1024)).unfold(
        -1, 2048, 512)
    min_p, max_p = yin.yin_periods(sr, 50.0, 1000.0, 2048, 1024)
    acf = torch.stack([(frames[..., 1:1025] * frames[..., 1 + t:1025 + t])
                       .sum(-1) for t in range(max_p + 1)], dim=-1)
    csum = torch.cumsum(frames ** 2, dim=-1)
    energy = csum[..., 1024:1024 + max_p + 1] - csum[..., :max_p + 1]
    acf = torch.where(acf.abs() < 1e-6, 0.0, acf)
    energy = torch.where(energy.abs() < 1e-6, 0.0, energy)
    diff = energy[..., :1] + energy - 2.0 * acf
    tau = torch.arange(1, max_p + 1, dtype=torch.float64)
    cum_mean = torch.cumsum(diff[..., 1:], dim=-1) / tau
    cmnd = diff[..., min_p:] / (cum_mean[..., min_p - 1:] + 1.1754944e-38)
    return yin._median(yin._f0_from_cmnd(cmnd, min_p, 0.1, sr)).float()


def k2_k3_emulated(libs, x: torch.Tensor, sr: int, normalize: bool,
                   hop: int = 512) -> tuple[torch.Tensor, torch.Tensor]:
    """K2's MFCC mean (N, 64) and K3's raw pitch (N,) of `x` at hop
    `hop`, through their C entry points."""
    n, length = x.shape
    n_fr = spectral.n_frames(length, 2048, hop)
    hann, tw, fb, lo, hi = features._kernel_tables(sr, 128, False, CPU)
    k2 = torch.full((n, 64), float("nan"))
    ws = workspace(libs, "mfcc_frontend", "gat_mfcc_workspace_floats", n,
                   128, n_fr)
    fn = _fn(libs["mfcc_frontend"], "gat_mfcc_frontend", features._MFCC_ARGS)
    assert fn(x.data_ptr(), k2.data_ptr(), hann.data_ptr(), tw.data_ptr(),
              fb.data_ptr(), lo.data_ptr(), hi.data_ptr(),
              spectral.dct_ii_matrix(128, 64).data_ptr(), _ptr(ws), n,
              length, hop, n_fr, 128, 64, int(normalize), 80.0, None) == 0
    k3 = torch.full((n,), float("nan"))
    min_p, max_p = yin.yin_periods(sr, 50.0, 1000.0, 2048, 1024)
    fn = _fn(libs["yin_pitch"], "gat_yin_pitch", yin._YIN_ARGS)
    assert fn(x.data_ptr(), k3.data_ptr(), n, length, 2048, 1024, hop, n_fr,
              min_p, max_p, 0.1, float(sr), None) == 0
    return k2, k3


def frame_count_clips(length: int) -> torch.Tensor:
    """(4, length): `_clips`' three tones and the noisy A3 pluck of
    `port_pluck_clips`, cut or zero-padded to `length`."""
    pluck = np.zeros((1, length), np.float32)
    src = port_pluck_clips(0.1)[17:18, :length]
    pluck[:, :src.shape[1]] = src
    return torch.cat([_clips(length), torch.from_numpy(pluck)])


# Clips past what one block held at once before groups and workspaces:
# K3 refused 71 frames or more at hop 512 (11025 Hz: 3.25 s), K6 70, K2
# 355 and K1 745 at hop 256.
CLIP_LONG_FRAMES = (71, 100, 200)


def frames_clips(n_frames: int, hop: int = 512) -> torch.Tensor:
    """`frame_count_clips` of exactly n_frames frames at `hop`."""
    return frame_count_clips((n_frames - 1) * hop)


@functools.lru_cache(maxsize=None)
def long_pluck(midi: int) -> np.ndarray:
    """A 2.5 s Karplus-Strong pluck at `midi` and 11025 Hz, seeded by
    it."""
    from gat_tpu_torch.data.synth import karplus_strong
    from gat_tpu_torch.ops.pitch import midi_to_hz
    return karplus_strong(float(midi_to_hz(midi)), SR, 2.5, seed=midi)[0]


def long_riff(seconds: float, seed: int = 120) -> np.ndarray:
    """(1, seconds x 11025) from a numpy seed: a pluck every 3 s from 0.4 s
    (MIDI 40 upward in fifths from the seed's note, folded into the 47
    classes) over noise of sigma 0.01; the long clips of the CPU, card and
    emulated tests."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    x = rng.normal(0.0, 0.01, n)
    for i in range(int((seconds - 0.4) // 3.0)):
        note = long_pluck(40 + (7 * (i + seed)) % 47)
        start = int((0.4 + 3.0 * i) * SR)
        end = min(n, start + len(note))
        x[start:end] += note[:end - start]
    return x[None].astype(np.float32)


def golden_clips(length: int) -> torch.Tensor:
    """(3, length) from a numpy seed: a 196 Hz tone and a 523 Hz square
    wave, decaying, with noise, and white noise."""
    rng = np.random.default_rng(1616)
    t = np.arange(length) / SR
    x = np.stack([np.sin(2 * np.pi * 196.0 * t) * np.exp(-2 * t)
                  + rng.normal(0, 0.02, length),
                  0.3 * np.sign(np.sin(2 * np.pi * 523.25 * t))
                  * np.exp(-3 * t) + rng.normal(0, 0.05, length),
                  rng.normal(0, 0.1, length)])
    return torch.from_numpy(x.astype(np.float32))


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()[:16]


# sha256 of each kernel's output bytes on `golden_clips`, as the kernels
# gave them before YIN ran in groups of frames and the dB images could
# leave shared memory (d475e9f): 11 and 69 frames at hop 512 (22 and 137
# at K1's 256) at 11025 Hz, 22 frames at 22050 Hz
GOLDEN = {
    (11025, 5512): {"K1": "8e2312e8b8faad74", "K2": "74f9d76596777f74",
                    "K3": "0d0eb0babeb8b824", "K6": "ac0e3439b311cae8"},
    (11025, 34816): {"K1": "dabfd4f77719e688", "K2": "989e23b0e37ed547",
                     "K3": "798e1c9212a55696", "K6": "52848fab332a1f9a"},
    (22050, 11025): {"K3": "5e02cedfb1f15469", "K6": "71e1d19be1fcef2f"},
}


FILE_SR = 22050


def riffs(n: int, seed: int = 0) -> np.ndarray:
    """(3, n) at 22050 Hz: decaying tones every 0.35 s from 0.2 s plus
    noise; the third row is silent past 60 % of its length."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FILE_SR
    y = rng.normal(0.0, 0.01, (3, n))
    for row, f0 in enumerate((110.0, 196.0, 330.0)):
        for k, t0 in enumerate(np.arange(0.2, n / FILE_SR, 0.35)):
            env = np.where(t >= t0, np.exp(-8.0 * (t - t0)), 0.0)
            y[row] += env * np.sin(2 * np.pi * f0 * (1 + 0.1 * k) * t)
    y[2, int(0.6 * n):] = 0.0
    return y.astype(np.float32)


RIFF_NOTES = ((0.4, 110.0), (1.1, 146.83), (1.8, 196.0), (2.5, 246.94),
              (3.2, 329.63))  # A2 D3 G3 B3 E4


def pluck_riff(sr: int, dur: float, notes=RIFF_NOTES) -> np.ndarray:
    """Karplus-Strong plucks (start s, Hz), 0.45 s long at peak 0.5 with
    the last 30 % faded out (an abrupt cut reads as an onset); numpy only,
    for the card's tests too."""
    y = np.zeros(int(dur * sr), np.float32)
    for t0, f in notes:
        if t0 >= dur:
            continue
        period = max(2, int(round(sr / f)))
        buf = np.random.default_rng(int(f)).uniform(-1.0, 1.0, period)
        n = np.empty(int(0.45 * sr))
        for i in range(len(n)):
            n[i] = buf[i % period]
            buf[i % period] = 0.498 * (buf[i % period]
                                       + buf[(i + 1) % period])
        n *= 0.5 / np.abs(n).max()
        fade = int(0.3 * len(n))
        n[-fade:] *= np.linspace(1, 0, fade)
        s = int(t0 * sr)
        y[s:s + len(n)] += n[:len(y) - s].astype(np.float32)
    return y


def onset_envelope_emulated(libs, y: torch.Tensor, nvf: torch.Tensor | None,
                            grid: int = 5, hop: int = 512) -> torch.Tensor:
    """K4's C entry point with the arguments `onset.onset_strength`
    passes, and `grid` first-pass blocks (the emulation has no occupancy
    to size it from)."""
    b, n = y.shape
    t = spectral.n_frames(n, 2048, hop)
    env = torch.empty(b, t)
    db = torch.empty(b, t, 128)
    peak = torch.full((b,), onset._NEG_INF_KEY, dtype=torch.int32)
    hann, tw, *_ = features._kernel_tables(FILE_SR, 128, False, CPU)
    tab, weights, n_items = onset._mel_items(FILE_SR, 128, CPU)
    if nvf is not None:
        nvf = nvf.to(torch.int32).contiguous()
    fn = _fn(libs["onset_envelope"], "gat_onset_envelope",
             onset._ENVELOPE_ARGS)
    assert fn(y.data_ptr(), env.data_ptr(), db.data_ptr(), peak.data_ptr(),
              hann.data_ptr(), tw.data_ptr(), tab.data_ptr(),
              weights.data_ptr(), weights.numel(), n_items,
              None if nvf is None else nvf.data_ptr(), b, n, hop, t, 128, 1,
              1 + 2048 // (2 * hop), 80.0, grid, None) == 0
    return env


def file_batch(n: int, b: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(b, n) files and their valid frames, b <= 4: `riffs` (the third
    zero past 60 % of its length) and a fourth file zero past 75 %, each
    with a valid end that the top_db peak must respect."""
    y = np.concatenate([riffs(n), riffs(n, seed=1)[:1]])[:b]
    y[3:, int(0.75 * n):] = 0.0
    t = spectral.n_frames(n, 2048, 512)
    nvf = torch.tensor([t, t - 5, 1 + int(0.6 * n) // 512,
                        1 + int(0.75 * n) // 512][:b])
    return torch.from_numpy(y), nvf


def padded_wave(n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A wave as `transcribe_files` pads it: two riffs (the second valid
    to 60 %) and a zero row of n_valid 0, with the valid frames
    `detect_onsets` gives them (the zero row: 0 // 512 + 1 = 1)."""
    y = np.concatenate([riffs(n)[:2], np.zeros((1, n), np.float32)])
    n_valid = torch.tensor([n, int(0.6 * n), 0], dtype=torch.int32)
    return torch.from_numpy(y), n_valid // 512 + 1


def check_zero_row(y, nvf, env, pick) -> None:
    """K4's envelope `env` of a `padded_wave` (y, nvf) against the plain
    one, and K5's onsets from it (`pick(env, nvf, cand_budget)`)
    identical to the plain pick's, with no onset and no flag in the zero
    row."""
    ref = onset.onset_strength_plain(y.cpu(), FILE_SR,
                                     n_valid_frames=nvf.cpu())
    assert bool(torch.isfinite(env).all())
    torch.testing.assert_close(env.cpu(), ref, atol=1e-3, rtol=0)
    for cand_budget in (None, 0):
        got = pick(env, nvf, cand_budget)
        _, valid, overflow, _, n_kept = check_pick(got, env, nvf, 64,
                                                   cand_budget, True)
        assert bool(valid[0].any()) and bool(valid[1].any())
        assert not bool(valid[2].any()) and not bool(overflow[2])
        assert int(n_kept[2]) == 0


def onset_passes_emulated(libs, y: torch.Tensor, nvf: torch.Tensor | None,
                          grid: int = 5) -> tuple:
    """K4's `gat_onset_envelope` on centred files: (env, its pre-clamp dB
    scratch (B, T, 128), its peak keys (B,))."""
    b, n = y.shape
    t = spectral.n_frames(n, 2048, 512)
    env, db = torch.empty(b, t), torch.empty(b, t, 128)
    peak = torch.full((b,), onset._NEG_INF_KEY, dtype=torch.int32)
    hann, tw, *_ = features._kernel_tables(FILE_SR, 128, False, CPU)
    tab, weights, n_items = onset._mel_items(FILE_SR, 128, CPU)
    nvf = None if nvf is None else nvf.to(torch.int32).contiguous()
    fn = _fn(libs["onset_envelope"], "gat_onset_envelope",
             onset._ENVELOPE_ARGS)
    assert fn(y.data_ptr(), env.data_ptr(), db.data_ptr(), peak.data_ptr(),
              hann.data_ptr(), tw.data_ptr(), tab.data_ptr(),
              weights.data_ptr(), weights.numel(), n_items,
              None if nvf is None else nvf.data_ptr(), b, n, 512, t, 128, 1,
              1 + 2048 // (2 * 512), 80.0, grid, None) == 0
    return env, db, peak


def mel_db_emulated(libs, y: torch.Tensor, frames: int, origin: int,
                    nvf: torch.Tensor | None, grid: int = 3) -> tuple:
    """`gat_onset_mel_db` with the arguments `onset.onset_mel_db` passes:
    (db (B, frames, 128), peak keys (B,))."""
    b, n = y.shape
    db = torch.empty(b, frames, 128)
    peak = torch.full((b,), onset._NEG_INF_KEY, dtype=torch.int32)
    hann, tw, *_ = features._kernel_tables(FILE_SR, 128, False, CPU)
    tab, weights, n_items = onset._mel_items(FILE_SR, 128, CPU)
    nvf = None if nvf is None else nvf.to(torch.int32).contiguous()
    fn = _fn(libs["onset_envelope"], "gat_onset_mel_db", onset._MEL_DB_ARGS)
    assert fn(y.data_ptr(), db.data_ptr(), peak.data_ptr(), hann.data_ptr(),
              tw.data_ptr(), tab.data_ptr(), weights.data_ptr(),
              weights.numel(), n_items,
              None if nvf is None else nvf.data_ptr(), b, n, 512, frames,
              128, origin, grid, None) == 0
    return db, peak


def flux_emulated(libs, db: torch.Tensor, peak: torch.Tensor
                  ) -> torch.Tensor:
    """`gat_onset_flux` with the arguments `onset.onset_flux` passes."""
    b, t, m = db.shape
    env = torch.empty(b, t)
    fn = _fn(libs["onset_envelope"], "gat_onset_flux", onset._FLUX_ARGS)
    assert fn(db.contiguous().data_ptr(), peak.contiguous().data_ptr(),
              env.data_ptr(), b, t, m, 1, 1 + 2048 // (2 * 512), 80.0,
              None) == 0
    return env


def time_shards(y: np.ndarray, d: int):
    """One file cut over d ranks as the time-sharded envelope cuts it
    (`parallel.timeshard.TimeShards`): [(shard (1, owned + halo), frames,
    real frames)]."""
    from gat_tpu_torch.parallel.timeshard import TimeShards
    cut = TimeShards(len(y), d)
    yt = torch.from_numpy(np.asarray(y, np.float32))
    return [(cut.shard(yt, r)[None], cut.frames, torch.tensor([cut.real(r)]))
            for r in range(d)]


def stitch(parts: list, t: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Shards' (db, peak key) → the file's (db (1, t, 128), peak key)."""
    db = torch.cat([p[0] for p in parts], dim=1)[:, :t].contiguous()
    return db, torch.stack([p[1] for p in parts]).amax(0)


LIVE_RING = 33075  # the live engine's 1.5 s ring at 22050 Hz


def onset_pick_emulated(libs, env: torch.Tensor, nvf: torch.Tensor | None,
                        max_onsets: int, cand_budget, backtrack: bool = True,
                        hop: int = 512, min_sep: float = 0.3):
    """K5's C entry point with the arguments `onset.pick_onsets` passes
    (no counts for None)."""
    b, t = env.shape
    size, left, pre_avg, post_avg, wait = onset._pick_windows(FILE_SR, hop)
    outs = onset._pick_outputs(b, max_onsets, CPU)
    nvf = onset._frame_counts(nvf, CPU)
    fn = _fn(libs["onset_pick"], "gat_onset_pick", onset._PICK_ARGS)
    assert fn(env.data_ptr(), None if nvf is None else nvf.data_ptr(),
              *(o.data_ptr() for o in outs), b, t, size, left, pre_avg,
              post_avg, 0.07, wait, hop, int(min_sep * FILE_SR), max_onsets,
              onset.candidate_limit(t, max_onsets, cand_budget),
              int(backtrack), None) == 0
    return outs


def check_pick(got, env, nvf, max_onsets, cand_budget, backtrack,
               hop: int = 512, min_sep: float = 0.3) -> tuple:
    """All five outputs identical to the plain version's; returns those."""
    ref = onset.pick_onsets_plain(env, FILE_SR, hop, min_sep, max_onsets,
                                  backtrack, nvf, cand_budget)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g.cpu(), r.cpu())
    return ref


def random_envelopes(t: int, seed: int) -> np.ndarray:
    """(3, t) onset-envelope-like rows: sparse bursts with decays on a
    noise floor."""
    rng = np.random.default_rng(seed)
    x = rng.exponential(0.05, (3, t))
    for row in range(3):
        for i in rng.choice(t, size=max(1, t // 12), replace=False):
            x[row, i:i + 4] += rng.uniform(0.5, 3.0) * np.array(
                [1.0, 0.5, 0.25, 0.1])[:t - i]
    return x.astype(np.float32)


PICK_LONG_FRAMES = 1 + 400 * FILE_SR // 512  # a 400 s file: 17,227 frames


# the live engine's min separation at 22050 Hz: its 0.3 s floor lifted
# to min_slice_t plus one hop of 1024 (stream/live.py)
LIVE_MIN_SEP = 0.3 + 1024 / FILE_SR


def scan_envelopes() -> np.ndarray:
    """(4, 65) envelopes of the scan engine's rings (33,075 samples at
    hop 512): three random rows, and a row of (0, 1, 1) repeats whose 43
    candidates pass the 32 that the scan's budget walks."""
    dense = np.tile(np.array([0.0, 1.0, 1.0], np.float32), 22)[:65]
    return np.concatenate([random_envelopes(65, 6), dense[None]])


def edge_envelopes(t: int) -> np.ndarray:
    """(3, t) envelopes with planted onsets at K5's tile edges, over a
    noise floor with a burst about every 30 frames. E = tile - halo is the
    first frame the second tile evaluates. Row 0: a backtrack minimum at
    E - 1, a burst at E. Row 1: the minimum at E - 140, in another warp's
    frames, then a slow rise with no minimum to a burst at E + 1, so its
    backtrack is carried across warps and tiles. Row 2: the minimum at
    t - 4 and a burst at t - 3, whose moving average reads across the
    first tile's load edge. Each sits in a flat stretch."""
    rng = np.random.default_rng(t)
    x = rng.exponential(0.05, (3, t))
    for row in range(3):
        for i in rng.choice(t, size=t // 30, replace=False):
            x[row, i:i + 3] += rng.uniform(0.5, 3.0) * np.array(
                [1.0, 0.5, 0.25])[:t - i]
    for row, (dip, burst) in enumerate(edge_onsets(t)):
        x[row, dip - 15:burst + 15] = 0.01
        x[row, dip] = 0.0
        x[row, dip + 1:burst] = np.linspace(0.011, 0.03, burst - dip - 1)
        x[row, burst] = 5.0
    return x.astype(np.float32)


def edge_onsets(t: int) -> tuple:
    """(backtrack minimum, burst) frames that `edge_envelopes` plants."""
    edge = onset._PICK_TILE - onset._PICK_HALO
    return (edge - 1, edge), (edge - 140, edge + 1), (t - 4, t - 3)


# ---------------------------------------------------------------------------
# K7 (noise gate) and K8 (clip slicer)
# ---------------------------------------------------------------------------
GATE_MIN_DB = -32.5


def gate_rows(n: int, seed: int = 0) -> np.ndarray:
    """Six rows of n samples at 22050 Hz: the plucked riff at six levels
    plus noise of sigma 0.003, each with its own noise."""
    rng = np.random.default_rng(seed)
    riff = pluck_riff(FILE_SR, n / FILE_SR)
    return np.stack([(0.4 + 0.2 * i) * riff + rng.normal(0, 0.003, n)
                     for i in range(6)]).astype(np.float32)


def gate_counts(n: int) -> np.ndarray:
    """The valid counts of `gate_rows`' six rows: none, below a frame,
    one short of a frame, a frame, not a multiple of 512, the whole row."""
    return np.array([0, 1000, 2047, 2048, 5000, n])


def noise_gate_emulated(libs, y: torch.Tensor, nv: torch.Tensor | None,
                        min_db: float | None, hop: int = 512,
                        grid: int = 3) -> dict:
    """K7's C entry point with the arguments `gating.noise_gate` passes,
    and `grid` blocks (the emulation has no occupancy to size it from);
    the gated rows and the workspaces, named as `gate_parts_plain`'s."""
    b, n = y.shape
    t = 1 + n // hop
    parts = dict(out=torch.empty_like(y), env=torch.empty(b, t),
                 med=torch.empty(b, t), gate_db=torch.empty(b),
                 frame_mask=torch.empty((b, t), dtype=torch.bool))
    nv = onset._frame_counts(nv, CPU)
    fn = _fn(libs["noise_gate"], "gat_noise_gate", gating._GATE_ARGS)
    assert fn(y.data_ptr(), parts["out"].data_ptr(),
              None if nv is None else nv.data_ptr(), parts["env"].data_ptr(),
              parts["med"].data_ptr(), parts["frame_mask"].data_ptr(),
              parts["gate_db"].data_ptr(), b, n, hop,
              int(min_db is not None), 0.0 if min_db is None else min_db,
              grid, None) == 0
    return parts


def check_gate(got: dict, ref: dict, y: torch.Tensor, min_db: float | None,
               hop: int) -> tuple[int, int]:
    """K7's outputs against the plain gate's, at the bounds both the
    emulated and the card tests hold (each with its reason):
    * the frame RMS in dB and its median within 1e-4 dB (means of 2048
      squares summed in another order, fp64 in the kernel);
    * gate_db within 1e-4 dB (bit-equal percentile arithmetic on an
      envelope within that bound);
    * the frame masks equal, except at frames within 1e-3 dB of gate_db;
    * the gated samples bit-equal wherever the frame decision agrees and
      the sample's dB is not within 1e-4 dB of min_db (log10 of the card
      or the C library against PyTorch's, a last bit apart at most).
    Returns the counts of frames and samples let through by the last two
    exceptions."""
    for key in ("env", "med", "gate_db"):
        err = float((got[key] - ref[key]).abs().max())
        assert err <= 1e-4, (key, err)
    near = (ref["med"] - ref["gate_db"][:, None]).abs() < 1e-3
    flipped = got["frame_mask"] != ref["frame_mask"]
    assert not bool((flipped & ~near).any())
    n = y.shape[1]
    agree = ~flipped.repeat_interleave(hop, dim=1)[:, :n]
    if min_db is not None:
        amp_db = 20.0 * torch.log10(y.abs() + 1e-10)
        agree &= (amp_db - min_db).abs() >= 1e-4
    same = got["out"].view(torch.int32) == ref["out"].view(torch.int32)
    assert bool(same[agree].all())
    return int(flipped.sum()), int((~agree).sum())


# sha256 of K7's outputs on `test_noise_gate_emulated`'s rows and counts, as
# its first design gave them (db4b038: a 48 KB stage filled a sample at a
# time, a warp per frame summing its 2048 squares, the threshold pass's
# frames in device memory, a grid-stride apply): (hop, counted, min_db)
# -> digests of gate_db, frame_mask, out, env and med
GATE_PINS = {
    (512, True, GATE_MIN_DB): ("8634dc2904e1ed35", "cdf33983ad35b7c8",
                               "2ea824bb4ef2020e", "3c39cc73ccce745c",
                               "f9f721aab928542c"),
    (512, True, None): ("78e025ef44c0c93a", "4db7f285392b6814",
                        "4ce0a806f045ad90", "c784832a864d2349",
                        "f7b288c8b872be91"),
    (512, False, GATE_MIN_DB): ("8634dc2904e1ed35", "ddc06d0902d59c81",
                                "79fff294b62fc7ec", "bebb9b72270b3aa3",
                                "813d34d50ebbc098"),
    (512, False, None): ("ec3429661f904543", "f05a553ef2842145",
                         "ec828715a551784c", "070a51dc4631cbbf",
                         "1e74d67313d8ec27"),
    (256, True, GATE_MIN_DB): ("8634dc2904e1ed35", "cd54908aba386cab",
                               "2ea824bb4ef2020e", "145ff423780a3fac",
                               "b0672c2bd7ce190a"),
    (256, True, None): ("7096a56cf47ef855", "e6f7c8ae8c07404a",
                        "9ce0d0a6eac2059b", "790e7fe1753bd2ae",
                        "558b7db64a8a51e5"),
    (256, False, GATE_MIN_DB): ("8634dc2904e1ed35", "019cd2ec40db11d6",
                                "79fff294b62fc7ec", "059356478f2b6330",
                                "de0a01c2b3b10f66"),
    (256, False, None): ("697e62ecb369f44f", "fec57121a74f3431",
                         "5604ca80395d312a", "8d87bfcd01377bdd",
                         "c9628777eefcdd92"),
}


def pass_blocks(libs, n: int, hop: int) -> list:
    """K7's `gat_noise_gate_pass_blocks`: each pass's resident blocks per
    SM (0 under the emulation), the threshold block's threads, and
    whether it stages the envelope in shared memory."""
    out = (ctypes.c_int * 5)(*[-1] * 5)
    fn = _fn(libs["noise_gate"], "gat_noise_gate_pass_blocks",
             [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    assert fn(n, hop, ctypes.addressof(out)) == 0
    return list(out)


def slice_clips_emulated(libs, y: torch.Tensor, onsets: torch.Tensor,
                         valid: torch.Tensor, nv: torch.Tensor | None,
                         strict: bool, onset_hop: int | None,
                         length_sec: float = 0.5, skip_sec: float = 0.01,
                         min_db: float = -40.0) -> tuple:
    """K8's C entry point with the arguments `slicing.slice_at_onsets`
    passes: (clips, kept, times)."""
    b, n = y.shape
    k = onsets.shape[1]
    length, skip = int(length_sec * FILE_SR), int(skip_sec * FILE_SR)
    clips = torch.empty(b, k, length)
    kept = torch.empty((b, k), dtype=torch.bool)
    times = torch.empty(b, k, 2)
    onsets = onsets.to(torch.int32).contiguous()
    nv = onset._frame_counts(nv, CPU)
    fn = _fn(libs["slice_clips"], "gat_slice_clips", slicing._SLICE_ARGS)
    assert fn(y.data_ptr(), onsets.data_ptr(), valid.data_ptr(),
              None if nv is None else nv.data_ptr(), clips.data_ptr(),
              kept.data_ptr(), times.data_ptr(), b, n, k, length, skip,
              0 if onset_hop is None else onset_hop, int(strict), min_db,
              1.0 / FILE_SR, None) == 0
    return clips, kept, times


def check_slice(got: tuple, ref: tuple, min_db: float = -40.0) -> None:
    """K8 against the plain slicer: clips and times bit-equal (gathered
    samples; the same float32 product for the times); kept equal except
    where the clip's dB is within 1e-4 dB of min_db (its mean of squares
    summed in another order, fp64 in the kernel)."""
    clips, kept, times = got
    assert torch.equal(clips.view(torch.int32), ref[0].view(torch.int32))
    assert torch.equal(times, ref[2])
    near = (gating.slice_rms_db(ref[0]) - min_db).abs() < 1e-4
    assert bool((kept == ref[1])[~near].all())


def onset_rows(n: int, aligned: bool) -> tuple:
    """Onsets (3, 8) of three rows of n samples: from 0, sorted, one 100
    samples from a row's end, aligned to 512 or not; the valid slots a
    prefix in the first row, not one in the last."""
    rng = np.random.default_rng(5)
    onsets = np.sort(rng.integers(0, n, (3, 8)), axis=1)
    onsets[:, 0] = 0
    onsets[1, -1] = n - 100
    if aligned:
        onsets = onsets // 512 * 512
    valid = np.ones((3, 8), bool)
    valid[0, 6:] = False
    valid[2, [1, 4]] = False
    return torch.from_numpy(onsets.astype(np.int32)), torch.from_numpy(valid)


def pin_inputs(length_sec: float, onset_hop: int | None) -> tuple:
    """`test_slice_clips_emulated_pins`' inputs: six rows of 4 clips' length
    + 1 samples (each row one float past the last: row r starts at 16-byte
    phase r mod 4) at levels from -48 to -6 dB, 6 onsets a row. Rows 0-3
    and 5 take the staged route at every source phase and, at an odd
    clip length, every destination phase: windows whole, cut short by the
    next onset (512 samples on), past a row's valid count, and in row 5
    up to the tensor's last sample (strict False). Row 1 starts at a
    negative onset, row 3 has an onset off the 512 grid (the general
    route with a hop), row 4 has no valid slot. Without a hop slot j's onset
    moves by j samples, so the source phases mix."""
    length = int(length_sec * FILE_SR)
    n = 4 * length + 1
    rng = np.random.default_rng(19)
    level = np.array([0.3, 0.1, 0.02, 0.004, 0.5, 0.05])[:, None]
    y = (level * rng.normal(0.0, 1.0, (6, n))).astype(np.float32)
    unit = -(-length // 512) * 512  # one clip, rounded up to the grid
    base = np.array([0, unit + 512, unit + 1024, 2 * unit + 1024,
                     3 * unit, 3 * unit + 1536])
    onsets = np.stack([base + 512 * r for r in range(6)])
    onsets[1, 0] = -512
    onsets[3, 1] += 5
    onsets[5, 5] = n - length // 2 - 512
    if onset_hop is None:
        onsets = onsets + np.arange(6)[None, :]
    valid = np.ones((6, 6), bool)
    valid[4] = False
    valid[2, 4] = False
    nv = np.full(6, n)
    nv[0] = onsets[0, 5] + length // 3
    nv[3] = onsets[3, 4] + 100
    return (torch.from_numpy(y), torch.from_numpy(onsets.astype(np.int32)),
            torch.from_numpy(valid), torch.from_numpy(nv.astype(np.int32)))


# sha256 of K8's outputs on `pin_inputs`, as its first design gave them
# (d5fe321: one block per slot gathering a sample at a time through
# `Window::at`): (clip seconds, onset_hop, strict) -> digests of clips,
# kept and times
SLICE_PINS = {
    (0.5, 512, True): ("c215c18344ce414a", "e5adf878e9c606e1",
                       "1d7b8d969831ebc2"),
    (4.0, 512, True): ("84dd682d626328e7", "8d5b72349d244af9",
                       "ca8b8585579c549c"),
    (0.5, None, True): ("ddca4e1a71ff8705", "e5adf878e9c606e1",
                        "73810cf09ee10cd2"),
    (4.0, None, True): ("7e51b7c94d9e73f4", "8d5b72349d244af9",
                        "4ac5c6cb2981d01a"),
    (0.5, 512, False): ("a959e58c0798505f", "0502b13dcc723145",
                        "b48da4344ff7057a"),
    (4.0, 512, False): ("e9d29d0c57538519", "056cd0e052195f13",
                        "94915f74c7fba22c"),
    (0.5, None, False): ("8b47341147255617", "0502b13dcc723145",
                         "a1c6eae8b8dd606d"),
    (4.0, None, False): ("02502f03f9c7fe11", "056cd0e052195f13",
                         "9a74ef0e29b740aa"),
}


def past_row_inputs(onset_hop: int | None) -> tuple:
    """`test_slice_clips_emulated_pins_past_the_row`'s inputs: three rows
    of 5001 samples, 4 onsets a row on the 512 grid, 0.1 s clips. Row 0
    counts its whole row; rows 1 and 2 count 3000 and 4000 samples past
    it, so that slot 2's window crosses the row's end (in row 1 into the
    next row's samples, in row 2, the last, into no sample of the tensor)
    and, without the reference's last-note rule, row 2's slot 3 opens a
    window wholly past it. The plain slicer reads those positions clamped
    to the row's last sample, or (with a hop) rows clamped and zero past
    the row."""
    n = 5001
    rng = np.random.default_rng(23)
    y = (0.1 * rng.normal(0.0, 1.0, (3, n))).astype(np.float32)
    onsets = np.array([[0, 1024, 2048, 3072], [0, 1536, 4608, 9216],
                       [512, 2560, 4608, 8192]], np.int32)
    valid = np.ones((3, 4), bool)
    nv = np.array([n, n + 3000, n + 4000], np.int32)
    return (torch.from_numpy(y), torch.from_numpy(onsets),
            torch.from_numpy(valid), torch.from_numpy(nv))


# sha256 of K8's outputs on `past_row_inputs`, as its first design gave
# them (d5fe321): (onset_hop, strict) -> digests of clips, kept and times
SLICE_PINS_PAST_ROW = {
    (512, True): ("8bc1c0b9328bc873", "d69618d1b8617e61",
                  "50f8201d643d4418"),
    (512, False): ("278c0407cef49fcb", "573dcf77c369f92b",
                   "f72639093b92c014"),
    (None, True): ("66a82b81f864d900", "d69618d1b8617e61",
                   "50f8201d643d4418"),
    (None, False): ("426552b67481ce4f", "573dcf77c369f92b",
                    "f72639093b92c014"),
}


# ---------------------------------------------------------------------------
# K9 (polyphase resampler)
# ---------------------------------------------------------------------------
# tests/test_torch_resample.py's rate pairs, and 96000, 8000 and 44100 Hz
# to the file and clip rates: up == 1 at down 2 and 4, and phase tables
# of 147 x 105, 441 x 49 and 147 x 209 floats
RESAMPLE_RATES = [(44100, 22050), (22050, 11025), (48000, 22050),
                  (16000, 22050), (96000, 22050), (8000, 22050),
                  (44100, 11025)]


def resample_emulated(libs, x: torch.Tensor, orig: int, target: int,
                      rows=None, out_len: int | None = None) -> torch.Tensor:
    """K9's C entry point with the arguments `resample._k9` passes: the
    (len(rows) or N, out_len) outputs, out_len m by default."""
    up, down = resample._ratio(orig, target)
    n_src, n = x.shape
    out_len = -(-n * up // down) if out_len is None else out_len
    taps = resample._phase_taps(up, down, 24, 9.58, CPU)
    half = (resample.resample_filter(up, down).shape[0] - 1) // 2
    rows_t = None if rows is None else torch.tensor(rows, dtype=torch.int32)
    n_rows = n_src if rows is None else len(rows)
    out = torch.full((n_rows, out_len), -7.0)
    fn = _fn(libs["resample"], "gat_resample", resample._RESAMPLE_ARGS)
    assert fn(x.data_ptr(), _ptr(rows_t), taps.data_ptr(), out.data_ptr(),
              n_src, n, n_rows, out_len, up, down, taps.shape[-1], half,
              None) == 0
    return out


def resample_rows_np(length: int, rows: int = 2, seed: int = 0
                     ) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed + length).normal(
        0, 0.3, (rows, length)).astype(np.float32))


# gat_resample_layout's fields, in order
RESAMPLE_LAYOUT = ("tile", "buf", "taps", "bytes", "rows", "frames",
                   "groups", "lag", "steps", "phases", "per_lane")


def resample_layout(libs, up: int, down: int, k_taps: int) -> dict:
    """K9's layout at these rates, `gat_resample_layout`'s fields by
    name."""
    vals = (ctypes.c_int * len(RESAMPLE_LAYOUT))()
    fn = _fn(libs["resample"], "gat_resample_layout",
             [ctypes.c_int] * 3 + [ctypes.c_void_p])
    assert fn(up, down, k_taps, vals) == 0
    return dict(zip(RESAMPLE_LAYOUT, vals))


def resample_taps(orig: int, target: int) -> tuple:
    """(up, down, K) at these rates."""
    up, down = resample._ratio(orig, target)
    return up, down, resample._phase_taps(up, down, 24, 9.58, CPU).shape[-1]


@contextlib.contextmanager
def emulated_sms(libs, sms: int, name: str = "resample"):
    """The emulated card's SMs in kernel `name`'s library, restored after:
    under the emulation K9's grid is min(tiles, SMs) (one resident block
    an SM), K12's and K13's at most SMs."""
    count = ctypes.c_int.in_dll(libs[name], "emu_sm_count")
    saved, count.value = count.value, sms
    try:
        yield
    finally:
        count.value = saved


def resample_tiles(libs, orig: int, target: int, n: int, n_rows: int,
                   out_len: int | None = None) -> int:
    """The tiles of K9's launch, counted as `gat_resample` counts them:
    parts of GB groups x rows x tiles of TF frames (only the groups below
    out_len when one frame holds every output)."""
    up, down, k = resample_taps(orig, target)
    lay = resample_layout(libs, up, down, k)
    out_len = -(-n * up // down) if out_len is None else out_len
    frames = -(-out_len // lay["phases"])
    groups = lay["phases"] // 4 if frames > 1 else min(
        lay["phases"] // 4, -(-out_len // 4))
    return (-(-groups // lay["groups"]) * n_rows
            * -(-frames // lay["frames"]))


# sha256 (first 16 hex digits) of K9's outputs on `resample_pin_digest`'s
# inputs, as its first design gave them (4914cd3: one block per 1024
# outputs, each output's taps from its own phase row)
RESAMPLE_PINS = {(44100, 22050): "7f8ebf902c3dd3d5",
                 (22050, 11025): "7f8ebf902c3dd3d5",
                 (48000, 22050): "364dc453a6f11a20",
                 (16000, 22050): "74e8014af51b9ffd",
                 (96000, 22050): "fc57bb8df11f8c86",
                 (8000, 22050): "03fdc1baff8bb76a",
                 (44100, 11025): "0e2f2c1e090c3c53",
                 (7999, 22050): "543f71415352df80"}


def resample_pin_digest(run, orig: int, target: int) -> str:
    """The digest of K9's outputs, `run(x, rows, out_len)` its launch
    (rows None: every row; out_len None: m), on fixed inputs: 3 rows of
    4099 samples (301 at 7999 Hz) whole, 4 of them selected and cut 5
    short of m, one padded 300 past it, and one row of 40,000 samples."""
    x = resample_rows_np(4099 if orig != 7999 else 301, rows=3, seed=17)
    up, down = resample._ratio(orig, target)
    m = -(-x.shape[1] * up // down)
    outs = [run(x, None, None), run(x, [2, 0, 2, 1], m - 5),
            run(x, [1], m + 300),
            run(resample_rows_np(40000, rows=1, seed=5), None, None)]
    return hashlib.sha256(b"".join(t.numpy().tobytes() for t in outs)
                          ).hexdigest()[:16]


# ---- K10: the wave's clip-budget compaction (csrc/wave_compact.cu) --------

def wave_select_emulated(libs, kept_all: torch.Tensor, budget: int,
                         first: int = 0, n_local: int | None = None,
                         overflow=None, fixable=None):
    """`gat_wave_select` called as `compaction.wave_select` calls it, on CPU
    pointers: the same `Selection` (n_sel read from the kernel's word, on
    one device too). Outputs start as garbage, so a field the kernel leaves
    unwritten shows."""
    n_files, k = kept_all.shape
    n_local = n_files if n_local is None else n_local
    compaction.check_select(kept_all, budget, first, n_local)
    bits = kept_all.to(torch.bool).contiguous()
    ovf_in = compaction._flags(overflow, n_local, CPU).contiguous()
    fix_in = compaction._flags(fixable, n_local, CPU).contiguous()
    cap = min(budget, n_local * k)
    ints = torch.full((cap + n_local * k + 1,), -7, dtype=torch.int32)
    sel, pos, count = ints[:cap], ints[cap:cap + n_local * k], ints[-1:]
    flags = torch.full((n_local * (k + 3),), 0xAB, dtype=torch.uint8)
    fn = _fn(libs["wave_compact"], "gat_wave_select",
             compaction._SELECT_ARGS)
    assert fn(bits.data_ptr(), ovf_in.data_ptr(), fix_in.data_ptr(),
              sel.data_ptr(), pos.data_ptr(), flags.data_ptr(),
              flags[n_local * k:].data_ptr(),
              flags[n_local * k + n_local:].data_ptr(),
              flags[n_local * k + 2 * n_local:].data_ptr(),
              count.data_ptr(), n_files, k, budget, first, n_local,
              None) == 0
    assert set(flags.tolist()) <= {0, 1}  # every byte written, 0 or 1
    n_sel = int(count)
    kept = flags[:n_local * k].view(n_local, k).to(torch.bool)
    dropped, ovf, fix = flags[n_local * k:].to(torch.bool).view(3, n_local)
    return compaction.Selection(sel[:n_sel], pos, kept, dropped, ovf, fix,
                                n_sel)


def check_selection(got, ref) -> None:
    """Every field equal: sel in the same order, n_sel the same count."""
    assert got.n_sel == ref.n_sel
    for name in ("sel", "pos", "kept", "dropped", "overflow", "fixable"):
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name


def wave_kept(n_files: int, k: int, density: float, seed: int
              ) -> torch.Tensor:
    """(n_files, K) kept bits: each slot kept with probability `density`,
    from a seed; a file's kept slots need not be a prefix."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random((n_files, k)) < density)


def wave_flags(n_files: int, seed: int) -> tuple:
    rng = np.random.default_rng(seed + 1000)
    return (torch.from_numpy(rng.random(n_files) < 0.3),
            torch.from_numpy(rng.random(n_files) < 0.3))


# (files, K): 1, 31, 448 (the serving wave), 4,100 and 8,300 slots (past
# one tile of the selection's 8,192 positions: 98 slots a tile)
WAVE_SHAPES = ((1, 1), (1, 31), (31, 1), (4, 112), (41, 100), (83, 100))
COMPACT_TILE = 8192
# the 64-file wave of 7,168 slots (one tile), 64 x 129 (a tile of 128
# slots and one of 1), and 8,200 files (past a tile's files: tiles of one
# slot of 8,192 files and of 8)
WAVE_SHAPES_PAST = ((64, 112), (64, 129), (8200, 2))


def scatter_parts(rows: int, c: int, seed: int, cnn: bool = True,
                  mlp: bool = True) -> tuple:
    rng = np.random.default_rng(seed)

    def mat():
        return torch.from_numpy(rng.random((rows, c), dtype=np.float32))
    return (mat(), mat() if mlp else None, mat() if cnn else None,
            torch.from_numpy(rng.random(rows, dtype=np.float32) * 900))


def wave_scatter_emulated(libs, pos: torch.Tensor, parts) -> tuple:
    """`gat_wave_scatter` called as `compaction.wave_scatter` calls it, on
    CPU pointers; outputs start as NaN, so an element left unwritten
    shows."""
    _, c = compaction.check_scatter(pos, parts)
    n = pos.numel()
    out = [None if x is None else
           torch.full((n,) + tuple(x.shape[1:]), float("nan"))
           for x in parts]
    fn = _fn(libs["wave_compact"], "gat_wave_scatter",
             compaction._SCATTER_ARGS)
    assert fn(pos.data_ptr(), *(_ptr(x) for x in parts),
              *(_ptr(x) for x in out), n, c, None) == 0
    return tuple(out)


def compact_grid_rule(n_files: int, k: int, sms: int, per_sm: int) -> list:
    """K10's launches by the rule its source states: the selection's tiles
    (every file and kTile // files slots, or past kTile files one slot of
    kTile files) of one block of 512 threads; the scatter a warp a row,
    at most the SMs' resident blocks of 256 threads."""
    if n_files <= COMPACT_TILE:
        tiles = -(-k // min(k, COMPACT_TILE // n_files))
    else:
        tiles = k * -(-n_files // COMPACT_TILE)
    return [tiles, 512, min(-(-n_files * k // 8), sms * per_sm), per_sm]


# ---------------------------------------------------------------------------
# K11-K13, the training step's kernels
# ---------------------------------------------------------------------------
def xent_inputs(b: int, c: int, seed: int) -> tuple:
    """(logits (b, c) float32, labels (b,) int64) from a numpy seed: row 0
    ties its maximum at two classes (the first wins), row 1's label is its
    argmax, row 2's label lies outside [0, c) (no one-hot, as in
    jax.nn.one_hot), the rest random."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 2.0, (b, c)).astype(np.float32)
    y = rng.integers(0, c, b)
    x[0, [1 % c, c - 1]] = x[0].max() + 1.0
    y[1] = int(np.argmax(x[1]))
    if b > 2:
        y[2] = c + 3
    return torch.from_numpy(x), torch.from_numpy(y.astype(np.int64))


def xent_grid_emulated(libs, b: int, c: int) -> list:
    """`gat_softmax_xent_grid` under the emulation: blocks, resident blocks
    per SM (1), rows a tile, lanes a row, shared bytes."""
    out = (ctypes.c_int * 5)()
    assert _fn(libs["softmax_xent"], "gat_softmax_xent_grid",
               loss_mod._GRID_ARGS)(b, c, ctypes.addressof(out)) == 0
    return list(out)


XENT_THREADS, XENT_ONE_BLOCK_TILES = 256, 2
XENT_STAGES = int(re.search(r"kStages = (\d+);", (
    kernels.CSRC / "softmax_xent.cu").read_text())[1])


def xent_grid_rule(b: int, c: int, sms: int, per_sm: int) -> list:
    """K11's launch by the rule its source states: as many lanes a row as
    keep a lane to 8 classes (a power of two, at most 32), a group of
    lanes a row of the tile; one block for at most two tiles, its lanes
    widened while the batch fills under half the groups; else min(tiles,
    SMs x resident blocks)."""
    lanes = 1
    while lanes < 32 and lanes * 8 < c:
        lanes *= 2
    tiles = -(-b // (XENT_THREADS // lanes))
    blocks = 1
    if tiles <= XENT_ONE_BLOCK_TILES:
        while lanes < 32 and XENT_THREADS // lanes >= 2 * b:
            lanes *= 2
    else:
        blocks = min(tiles, sms * per_sm, XENT_THREADS * 8)
    return [blocks, XENT_THREADS // lanes, lanes]


def xent_emulated(libs, logits, labels, smoothing: float, scale: float,
                  grad: bool = True) -> tuple:
    """K11 through its C entry points, as `ops/loss.py::_launch` calls
    them: (loss, correct, grad or None, preds, the ticket after the launch,
    the grid). The grid follows the rule at the emulated SMs (one resident
    block an SM); outputs start as NaN or -1, so an unwritten one shows."""
    b, c = logits.shape
    grid = xent_grid_emulated(libs, b, c)
    sms = ctypes.c_int.in_dll(libs["softmax_xent"], "emu_sm_count").value
    assert [grid[0], grid[2], grid[3]] == xent_grid_rule(b, c, sms, 1)
    assert grid[1] == 1 and grid[4] == 4 * XENT_STAGES * (
        -(-grid[2] * c // 4) * 4 + 2 * grid[2])
    blocks = grid[0]
    part_loss = torch.full((blocks,), float("nan"))
    part_correct = torch.zeros(blocks, dtype=torch.int32)
    ticket = torch.zeros(1, dtype=torch.int32)
    out = torch.full((), float("nan"))
    correct = torch.full((), -1, dtype=torch.int64)
    g = torch.full_like(logits, float("nan")) if grad else None
    pred = torch.full((b,), -1, dtype=torch.int64)
    fn = _fn(libs["softmax_xent"], "gat_softmax_xent", loss_mod._ARGS)
    assert fn(logits.data_ptr(), labels.data_ptr(), _ptr(g), pred.data_ptr(),
              part_loss.data_ptr(), part_correct.data_ptr(),
              ticket.data_ptr(), out.data_ptr(), correct.data_ptr(), b, c,
              smoothing, scale, blocks, grid[2], grid[3], None) == 0
    return out, correct, g, pred, ticket, grid


def check_xent(libs, logits, labels, scale: float, grad: bool = True
               ) -> list:
    """K11 against the plain version and its autograd: the loss within
    2e-6 relative (other summation orders), the gradient within 1e-6
    absolute (a softmax less a target times scale, each term rounded once
    either way), count and argmaxes exact, the first of tied maxima; a
    second run the same bits; the ticket back at 0. Returns the grid."""
    got, correct, g, pred, ticket, grid = xent_emulated(
        libs, logits, labels, 0.05, scale, grad)
    x = logits.clone().requires_grad_(True)
    ref, ref_correct, ref_pred = loss_mod.softmax_xent_plain(
        x, labels, 0.05, scale, preds=True)
    ref.backward()
    torch.testing.assert_close(got, ref.detach(), rtol=2e-6, atol=0)
    assert int(correct) == int(ref_correct)
    assert torch.equal(pred, ref_pred)
    assert int(pred[0]) == 1 % logits.shape[1]  # the first of the maxima
    if grad:
        torch.testing.assert_close(g, x.grad, rtol=0, atol=1e-6)
    assert int(ticket) == 0
    again = xent_emulated(libs, logits, labels, 0.05, scale, grad)
    assert torch.equal(again[0], got) and torch.equal(again[1], correct)
    assert torch.equal(again[3], pred)
    assert not grad or torch.equal(again[2], g)
    return grid


def adamw_inputs(n: int, seed: int, g_scale: float) -> dict:
    """Flat p, g, mu, nu of n parameters from a numpy seed; the gradients'
    global norm is about g_scale·sqrt(n)·0.1."""
    rng = np.random.default_rng(seed)
    f = lambda s: torch.from_numpy(rng.normal(0.0, s, n).astype(np.float32))
    return {"p": f(1.0), "g": f(0.1 * g_scale), "mu": f(0.01),
            "nu": f(0.01).abs()}


def grid_rule(items: int, unroll: int, sms: int, per_sm: int) -> int:
    """K12's and K13's grid over `items` 16-byte loads of 256 threads
    (`clip_blocks`, `bn_blocks`): enough blocks that each thread issues
    `unroll` loads once, at least one an SM while each thread still has a
    load, at most the SMs' resident blocks."""
    once, each = -(-items // (256 * unroll)), -(-items // 256)
    blocks = once if once > sms else min(each, sms)
    return max(1, min(blocks, sms * per_sm))


def clip_adamw_grid_emulated(libs, n: int) -> list:
    """`gat_clip_adamw_grid` under the emulation: pass 1's blocks and
    resident blocks per SM, pass 2's (one resident block an SM)."""
    out = (ctypes.c_int * 4)()
    assert _fn(libs["clip_adamw"], "gat_clip_adamw_grid",
               [ctypes.c_longlong, ctypes.c_void_p])(n, out) == 0
    return list(out)


def adamw_emulated(libs, st: dict, count, lr, max_norm) -> torch.Tensor:
    """K12's two passes through their C entry points, as `train/optim.py`
    calls them, on the flat CPU buffers of `st` (updated in place; a view
    not on 16 bytes takes the kernels' element route); returns the norm,
    and checks the grids follow the rule and the ticket came back to 0."""
    n = st["p"].numel()
    grid = clip_adamw_grid_emulated(libs, n)
    sms = ctypes.c_int.in_dll(libs["clip_adamw"], "emu_sm_count").value
    assert grid == [grid_rule(-(-n // 4), 4, sms, 1), 1,
                    grid_rule(-(-n // 4), 2, sms, 1), 1]
    part = torch.full((grid[0],), float("nan"))
    ticket = torch.zeros(1, dtype=torch.int32)
    norm = torch.full((), float("nan"))
    fn = _fn(libs["clip_adamw"], "gat_clip_norm", optim._NORM_ARGS)
    assert fn(st["g"].data_ptr(), part.data_ptr(), grid[0],
              ticket.data_ptr(), norm.data_ptr(), count.data_ptr(), n,
              None) == 0
    assert int(ticket) == 0
    fn = _fn(libs["clip_adamw"], "gat_adamw_update", optim._UPDATE_ARGS)
    assert fn(st["p"].data_ptr(), st["g"].data_ptr(), st["mu"].data_ptr(),
              st["nu"].data_ptr(), norm.data_ptr(), count.data_ptr(),
              lr.data_ptr(), n, grid[2], int(max_norm is not None),
              0.0 if max_norm is None else max_norm, 0.9, 0.999,
              *optim.complements(0.9, 0.999, True), 1e-8, 1e-4, None) == 0
    return norm


def adamw_plain_step(st: dict, count, lr, max_norm, norm=None):
    """`clip_norm_plain` (unless `norm`, the norm to clip by, is given)
    and `adamw_update_plain` on the buffers of `st`, in place; returns
    the norm."""
    if norm is None:
        norm = torch.zeros(())
        optim.clip_norm_plain(st["g"], norm, count)
    else:
        count.add_(1)
    optim.adamw_update_plain(st["p"], st["g"], st["mu"], st["nu"], norm,
                             count, lr, max_norm, 0.9, 0.999,
                             *optim.complements(0.9, 0.999, True), 1e-8,
                             1e-4)
    return norm


def unaligned(st: dict) -> dict:
    """The buffers of `st` as views one float past a 16-byte boundary."""
    out = {}
    for k, v in st.items():
        base = torch.zeros(v.numel() + 1)
        base[1:].copy_(v)
        out[k] = base[1:]
        assert out[k].data_ptr() % 16 == 4
    return out


def bn_inputs(shape: tuple, seed: int, dtype, channels_last: bool) -> dict:
    """x, dy (N, C, H, W) in `dtype` and layout, weight, bias and running
    statistics (C,) float32, from a numpy seed; channel 0 is constant, so
    its E[x²] - E[x]² is rounding noise that the clamp at 0 may hold."""
    rng = np.random.default_rng(seed)
    n, c, h, w = shape
    x = rng.normal(0.5, 2.0, shape).astype(np.float32)
    x[:, 0] = 1.25
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    t = lambda a: torch.from_numpy(a).to(dtype).contiguous(memory_format=fmt)
    f = lambda *s: torch.from_numpy(rng.normal(0.0, 1.0, s).astype(np.float32))
    return {"x": t(x), "dy": t(rng.normal(0.0, 1.0, shape).astype(np.float32)),
            "w": f(c) + 1.0, "b": f(c), "rm": f(c), "rv": f(c).abs()}


def bn_emulated(libs, d: dict, eps: float = 1e-5, momentum: float = 0.9):
    """K13's four kernels through their C entry points, as
    `ops/batchnorm.py` calls them, on CPU tensors: (y, mean, sq, running
    mean, running var, dx, dw, db, dmean, dsq, mul)."""
    lib = libs["batchnorm_train"]
    x, dy = d["x"], d["dy"]
    (sn, sc, sp), last = batchnorm.layout(x)
    (gsn, gsc, gsp), _ = batchnorm.layout(dy, read_only=True)
    n, c, h, w = x.shape
    p = h * w
    bf16 = int(x.dtype == torch.bfloat16)
    sms = ctypes.c_int.in_dll(lib, "emu_sm_count").value
    fn = _fn(lib, "gat_bn_splits", [ctypes.c_int, ctypes.c_longlong]
             + [ctypes.c_int] * 3)
    splits, each = (fn(c, n * p, int(last), bf16, sums) for sums in (1, 0))
    assert [splits, each] == [bn_splits_rule(c, n * p, last, bf16, sms, 1,
                                             sums) for sums in (True, False)]
    part = torch.full((2 * c * splits,), float("nan"))
    ticket = torch.zeros(1, dtype=torch.int32)
    mean, sq = torch.full((c,), float("nan")), torch.full((c,), float("nan"))
    rm, rv = d["rm"].clone(), d["rv"].clone()
    assert _fn(lib, "gat_bn_moments", batchnorm._MOMENTS_ARGS)(
        x.data_ptr(), n, c, p, sn, sc, sp, splits, part.data_ptr(),
        ticket.data_ptr(), mean.data_ptr(), sq.data_ptr(), bf16, int(last),
        None) == 0
    assert int(ticket) == 0
    y = torch.empty_like(x)
    assert _fn(lib, "gat_bn_apply", batchnorm._APPLY_ARGS)(
        x.data_ptr(), y.data_ptr(), n, c, p, sn, sc, sp, each,
        mean.data_ptr(), sq.data_ptr(), d["w"].data_ptr(), d["b"].data_ptr(),
        eps, rm.data_ptr(), rv.data_ptr(), momentum, 1.0 - momentum, bf16,
        int(last), None) == 0
    outs = torch.full((5, c), float("nan"))
    assert _fn(lib, "gat_bn_apply_grad", batchnorm._APPLY_GRAD_ARGS)(
        dy.data_ptr(), gsn, gsc, gsp, x.data_ptr(), n, c, p, sn, sc, sp,
        splits, mean.data_ptr(), sq.data_ptr(), d["w"].data_ptr(), eps,
        part.data_ptr(), ticket.data_ptr(),
        *(outs[i].data_ptr() for i in range(5)), bf16, int(last), None) == 0
    assert int(ticket) == 0
    dw, db, dmean, dsq, mul = outs
    dx = torch.empty_like(x)
    assert _fn(lib, "gat_bn_moments_grad", batchnorm._MOMENTS_GRAD_ARGS)(
        dy.data_ptr(), gsn, gsc, gsp, x.data_ptr(), dx.data_ptr(), n, c, p,
        sn, sc, sp, each, mul.data_ptr(), dmean.data_ptr(), dsq.data_ptr(),
        bf16, int(last), None) == 0
    return y, mean, sq, rm, rv, dx, dw, db, dmean, dsq, mul


def bn_splits_rule(c: int, m: int, last: bool, bf16: int, sms: int,
                   per_sm: int, sums: bool) -> int:
    """`gat_bn_splits`: the rule's grid over the layer's 16-byte loads
    (8 bfloat16 or 4 float32 elements), all of it in the rows map, split
    C ways in the runs map (at most one split per 256 positions); for the
    kernels that sum (`sums`), at most 256 x 8 x 4 / C splits (256 x 8 /
    C where C is not a multiple of 4): one round of the last block's
    loads."""
    blocks = grid_rule(-(-m * c // (8 if bf16 else 4)), 4, sms, per_sm)
    cap = max(1, 256 * 8 * (4 if c % 4 == 0 else 1) // c) if sums else blocks
    s = blocks if last else min(-(-blocks // c), -(-m // 256))
    return min(s, cap)


def bn_elementwise(d: dict, got: tuple):
    """y and dx from the kernels' own statistics (mean, and dmean, dsq,
    mul from the apply-backward, whose mul is the apply's, `norm_of`),
    each step a float32 PyTorch operation in the kernels' order, rounded
    once to x's dtype: the bits the elementwise kernels must give. (mul
    is taken as the kernels give it: torch's own 1 / sqrt(var + eps) has
    been seen an ulp off the correctly rounded one.)"""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    x, dy = d["x"].float(), d["dy"].float()
    mean, dmean, dsq, mul = got[1], got[8], got[9], got[10]
    ch = lambda v: v[:, None, None]
    y = (x - ch(mean)) * ch(mul) + ch(d["b"])
    count = f32(float(x.numel() // x.shape[1]))
    dx = (dy * ch(mul) + ch(dmean / count)) + x * ch(f32(2.0) * (dsq / count))
    return y.to(d["x"].dtype), dx.to(d["x"].dtype)


def bn_reference(d: dict, eps: float = 1e-5, momentum: float = 0.9):
    """The plain version and its autograd on the same inputs: (y, mean,
    sq, running mean, running var, dx, dw, db)."""
    x = d["x"].clone().requires_grad_(True)
    w = d["w"].clone().requires_grad_(True)
    b = d["b"].clone().requires_grad_(True)
    rm, rv = d["rm"].clone(), d["rv"].clone()
    y = batchnorm.batch_norm_train_plain(x, w, b, rm, rv, eps, momentum)
    y.backward(d["dy"])
    xf = d["x"].float()
    return (y.detach(), xf.mean(dim=(0, 2, 3)), (xf * xf).mean(dim=(0, 2, 3)),
            rm, rv, x.grad, w.grad, b.grad)


def check_bn(got: tuple, ref: tuple, d: dict, dtype) -> None:
    """K13's outputs against the plain version's: float32 moments and
    per-channel gradients within 1e-5 relative of their scale (other
    summation orders), y and dx within 2e-5 of theirs; bfloat16 y and dx
    within 2 of their ulps (the float32 values they round differ in their
    last bits); the running statistics within 1e-6 relative; y and dx in
    x's strides."""
    names = ("y", "mean", "sq", "running_mean", "running_var", "dx", "dw",
             "db")
    for name, g, r in zip(names, got, ref):
        g, r = g.float(), r.float()
        scale = float(r.abs().max())
        if name in ("y", "dx"):
            assert got[names.index(name)].stride() == d["x"].stride(), name
            tol = 2e-5 * scale if dtype == torch.float32 else None
        else:
            tol = 1e-6 * scale if name.startswith("running") else 1e-5 * scale
        if tol is None:  # bfloat16: two ulps of each value (8 bits)
            bound = 2.0 * 2.0 ** (torch.floor(torch.log2(r.abs().clamp_min(
                1e-30))) - 7)
            assert bool(((g - r).abs() <= bound + 1e-6 * scale).all()), name
        else:
            torch.testing.assert_close(g, r, rtol=0, atol=tol, msg=name)


def check_bn_runs(libs, d: dict, dtype) -> tuple:
    """Two runs of K13 on the same inputs: the same bits, y and dx the
    bits of `bn_elementwise` from the run's own statistics, and within
    `check_bn`'s tolerances of the plain version. Returns the run."""
    got = bn_emulated(libs, d)
    again = bn_emulated(libs, d)
    for a, b in zip(got, again):
        assert torch.equal(a, b) or (a.isnan().all() and b.isnan().all())
    y, dx = bn_elementwise(d, got)
    assert torch.equal(got[0], y) and torch.equal(got[5], dx)
    check_bn(got, bn_reference(d), d, dtype)
    return got


# the shipped CNN's three BatchNorm layers at a batch of 2
BN_CNN_LAYERS = ((2, 32, 64, 22), (2, 64, 32, 11), (2, 128, 16, 5))


BN_LAYOUT_CASES = ("nchw", "expanded_dy", "expanded_dy_nchw", "unaligned")


def bn_layout_case(case: str, dtype) -> dict:
    """`bn_inputs` off the rows map's 16-byte route: NCHW at the CNN's
    first layer's image size with 8 channels, dy expanded along N from one
    image beside channels-last or NCHW x at the same size, or
    channels-last x and dy one element past a 16-byte boundary at the
    second layer."""
    shape = (2, 64, 32, 11) if case == "unaligned" else (2, 8, 64, 22)
    d = bn_inputs(shape, seed=7, dtype=dtype,
                  channels_last=case in ("expanded_dy", "unaligned"))
    if case.startswith("expanded_dy"):
        rng = np.random.default_rng(8)
        fmt = (torch.channels_last if case == "expanded_dy"
               else torch.contiguous_format)
        d["dy"] = torch.from_numpy(rng.normal(0.0, 1.0, (1, *shape[1:]))
                                   .astype(np.float32)).to(dtype).contiguous(
            memory_format=fmt).expand(shape)
    elif case == "unaligned":
        for k in ("x", "dy"):
            t = d[k]
            base = torch.empty(t.numel() + 1, dtype=dtype)
            view = base[1:].as_strided(t.shape, t.stride())
            view.copy_(t)
            assert view.data_ptr() % 16 != 0
            d[k] = view
    return d


# ---------------------------------------------------------------------------
# The clip front-ends' split route (K1, K2, K3, K6): the plan's rule, the
# scratch it carves, and the C split entry points called at a given tile
# (`test_torch_kernels_emulated_clips.py`, `_shared_split.py`)
# ---------------------------------------------------------------------------
def split_tile_rule(n_clips: int, n_frames: int, slots: int, quantum: int,
                    max_tile: int | None) -> int:
    """`csrc/dsp_common.cuh::split_tile`: the frames a tile (0: one block
    a clip) for n_clips clips of n_frames frames on `slots` resident
    blocks."""
    if n_clips < 1 or n_frames < 2 * MIN_TILE:
        return 0
    tiles = -(-slots // n_clips)
    if max_tile is not None:
        tiles = max(tiles, -(-n_frames // max_tile))
    tiles = min(tiles, n_frames // MIN_TILE)
    if tiles <= 1:
        return 0
    return -(-(-(-n_frames // tiles)) // quantum) * quantum


MIN_TILE = 32
MEAN_CHUNK = 128  # frames of a chunk of the MFCC mean's sum
DIVISOR_CHUNK = 256 * 256  # samples of a chunk of the volume divisor's sum


def chunks(t: int) -> int:
    return -(-t // MEAN_CHUNK)


def lanes(length: int) -> int:
    """Floats of a clip's volume-divisor lane sums on the split route: 256
    lanes a chunk of samples."""
    return 256 * -(-length // DIVISOR_CHUNK)


def samples(name: str, t: int) -> int:
    """Samples of a clip of t frames at the kernel's hop."""
    return (t - 1) * (256 if name == "melspec_frontend" else 512)


# per kernel: its plan's sizes at (clips, samples, frames), the tile's
# quantum, the frames one block takes alone at most (None: any), and the
# split route's scratch floats a clip at (samples, frames, tiles): the
# volume divisor's lane sums (K1, K2, K6), the tiles' peaks, the chunks'
# sums and the dB image (K2, K6), every frame's f0 (K3, K6)
PLANS = {
    "melspec_frontend": (lambda n, L, t: (n, L, t, 64, 1), 4, None,
                         lambda L, t, k: lanes(L)),
    "mfcc_frontend": (lambda n, L, t: (n, L, t, 128), 4, None,
                      lambda L, t, k: lanes(L) + k + 128 * chunks(t)
                      + 128 * t),
    "yin_pitch": (lambda n, L, t: (n, 1024, 512, t, 221), 1, 512,
                  lambda L, t, k: t),
    "mfcc_pitch_frontend": (lambda n, L, t: (n, L, t, 128, 64, 1024, 512,
                                             221), 4, 512,
                            lambda L, t, k: lanes(L) + k + 128 * chunks(t)
                            + t + 128 * t),
}
PLAN_SYMBOLS = {"melspec_frontend": "gat_melspec_plan",
                "mfcc_frontend": "gat_mfcc_plan", "yin_pitch": "gat_yin_plan",
                "mfcc_pitch_frontend": "gat_mfcc_pitch_plan"}


def plan(libs, name: str, sizes: tuple) -> list:
    """The kernel's plan at these sizes, as `kernels.plan` reads it."""
    out = (ctypes.c_int * 4)()
    fn = _fn(libs[name], PLAN_SYMBOLS[name],
             [ctypes.c_int] * len(sizes) + [ctypes.c_void_p])
    assert fn(*sizes, ctypes.addressof(out)) == 0
    return list(out)


def split_clips(n_frames: int, hop: int) -> torch.Tensor:
    """`frames_clips`' noisy rows (two tones and the A3 pluck) of
    n_frames frames at `hop`."""
    return frames_clips(n_frames, hop)[[1, 2, 3]]


def melspec_split(libs, x: torch.Tensor, normalize: bool, to_db: bool,
                  tile: int) -> torch.Tensor:
    """K1's split route at `tile` frames a tile, as the wrapper calls it."""
    n, length = x.shape
    n_fr = spectral.n_frames(length, 2048, 256)
    out = torch.full((n, 64, n_fr, 1), float("nan"))
    scratch = torch.full((n, lanes(length)), float("nan"))
    hann, tw, fb, lo, hi = features._kernel_tables(SR, 64, True, CPU)
    fn = _fn(libs["melspec_frontend"], "gat_melspec_split",
             features._MELSPEC_SPLIT_ARGS)
    assert fn(x.data_ptr(), out.data_ptr(), scratch.data_ptr(),
              hann.data_ptr(), tw.data_ptr(), fb.data_ptr(), lo.data_ptr(),
              hi.data_ptr(), n, length, 256, n_fr, 64, int(normalize),
              int(to_db), tile, None) == 0
    return out


def mfcc_split(libs, x: torch.Tensor, normalize: bool, tile: int
               ) -> torch.Tensor:
    """K2's split route at `tile` frames a tile, with the scratch its
    plan counts (NaN-filled, so that a float it fails to write shows)."""
    n, length = x.shape
    n_fr = spectral.n_frames(length, 2048, 512)
    floats = PLANS["mfcc_frontend"][3](length, n_fr, -(-n_fr // tile))
    scratch = torch.full((n, floats), float("nan"))
    out = torch.full((n, 64), float("nan"))
    hann, tw, fb, lo, hi = features._kernel_tables(SR, 128, False, CPU)
    dct = spectral.dct_ii_matrix(128, 64)
    fn = _fn(libs["mfcc_frontend"], "gat_mfcc_split",
             features._MFCC_SPLIT_ARGS)
    assert fn(x.data_ptr(), out.data_ptr(), scratch.data_ptr(),
              hann.data_ptr(), tw.data_ptr(), fb.data_ptr(), lo.data_ptr(),
              hi.data_ptr(), dct.data_ptr(), n, length, 512, n_fr, 128, 64,
              int(normalize), 80.0, tile, None) == 0
    return out


def yin_split(libs, x: torch.Tensor, tile: int) -> torch.Tensor:
    """K3's split route at `tile` frames a tile."""
    n, length = x.shape
    n_fr = spectral.n_frames(length, 2048, 512)
    scratch = torch.full((n, n_fr), float("nan"))
    out = torch.full((n,), float("nan"))
    min_p, max_p = yin.yin_periods(SR, 50.0, 1000.0, 2048, 1024)
    fn = _fn(libs["yin_pitch"], "gat_yin_split", yin._YIN_SPLIT_ARGS)
    assert fn(x.data_ptr(), out.data_ptr(), scratch.data_ptr(), n, length,
              2048, 1024, 512, n_fr, min_p, max_p, 0.1, float(SR), tile,
              None) == 0
    return out


def mfcc_pitch_split(libs, x: torch.Tensor, normalize: bool,
                     pitch_normalized: bool, tile: int) -> tuple:
    """K6's split route at `tile` frames a tile: (features, hz)."""
    n, length = x.shape
    n_fr = spectral.n_frames(length, 2048, 512)
    floats = PLANS["mfcc_pitch_frontend"][3](length, n_fr, -(-n_fr // tile))
    scratch = torch.full((n, floats), float("nan"))
    out = torch.full((n, 65), float("nan"))
    hz = torch.full((n,), float("nan"))
    hann, tw, fb, lo, hi = features._kernel_tables(SR, 128, False, CPU)
    dct = spectral.dct_ii_matrix(128, 64)
    min_p, max_p = yin.yin_periods(SR, 50.0, 1000.0, 2048, 1024)
    fn = _fn(libs["mfcc_pitch_frontend"], "gat_mfcc_pitch_split",
             features._MFCC_PITCH_SPLIT_ARGS)
    assert fn(x.data_ptr(), out.data_ptr(), hz.data_ptr(), scratch.data_ptr(),
              hann.data_ptr(), tw.data_ptr(), fb.data_ptr(), lo.data_ptr(),
              hi.data_ptr(), dct.data_ptr(), n, length, 512, n_fr, 128, 64,
              1024, min_p, max_p, int(normalize), int(pitch_normalized),
              80.0, 0.1, float(SR), tile, None) == 0
    return out, hz
