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
"""
import contextlib
import ctypes
import hashlib
import itertools
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
            "batchnorm_train": 4}  # (four entry points of one)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """The kernels compiled by g++ under the emulation header."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("emulated_kernels")
    (out / "cuda_runtime.h").write_text(EMULATION_HEADER)
    for header in ("cuda_pipeline.h", "bulk_copy.cuh"):  # in the header
        (out / header).write_text("#pragma once\n")
    procs = {}
    for name in kernels.KERNELS:
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
    return {name: ctypes.CDLL(str(out / f"lib{name}.so"))
            for name in kernels.KERNELS}


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


@pytest.mark.parametrize("length", [5512, 5300, 1100])
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("to_db", [True, False])
def test_melspec_kernel_emulated(libs, normalize, to_db, length):
    """22, 21 and 5 frames: the odd counts run the last frame of a clip
    with a zero partner in its FFT."""
    x = _clips(length)
    out = _melspec_emulated(libs, x, normalize, to_db)
    ref = features.melspec_features_plain(x, SR,
                                          normalize_audio_volume=normalize,
                                          to_db=to_db)
    check_mel_image(out, ref, to_db)


def test_melspec_kernel_emulated_level_step(libs):
    """A silent frame sharing its FFT with a loud one keeps its level."""
    x = torch.from_numpy(level_step_clip())
    ref = features.melspec_features_plain(x, SR)
    step = ref[0, :, 7, 0] - ref[0, :, 6, 0]  # onset 2560: frames 6 and 7
    assert float(step.max()) >= 55.0
    check_mel_image(_melspec_emulated(libs, x, True, True), ref, True)


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


@pytest.mark.parametrize("length", [5512, 4608, 1100])
@pytest.mark.parametrize("normalize", [True, False])
def test_mfcc_kernel_emulated(libs, normalize, length):
    """11, 10 and 3 frames: the odd counts run the last frame with a zero
    partner in its FFT."""
    x = _clips(length)
    ref = features.mfcc_frontend_plain(x, SR, 64, normalize)
    torch.testing.assert_close(_mfcc_emulated(libs, x, normalize), ref,
                               atol=1e-3, rtol=0)


def test_mfcc_kernel_emulated_level_step(libs):
    """A near-silent frame sharing its FFT with a loud one, below the
    clip's top_db clamp."""
    x = torch.from_numpy(mfcc_level_step_clip())
    check_mfcc_level_step(x)
    torch.testing.assert_close(_mfcc_emulated(libs, x, True),
                               features.mfcc_frontend_plain(x, SR),
                               atol=1e-3, rtol=0)


@pytest.mark.parametrize("sr", [11025, 22050])
@pytest.mark.parametrize("length", [5512, 4608, 1500])
def test_yin_kernel_emulated(libs, length, sr):
    """11, 10 and 3 frames: odd and even medians. At 22050 Hz the lags
    0..441 take two lag blocks of the ACF, the second one partly."""
    x = _clips(length)
    n = x.shape[0]
    min_p, max_p = yin.yin_periods(sr, 50.0, 1000.0, 2048, 1024)
    out = torch.empty(n)
    fn = _fn(libs["yin_pitch"], "gat_yin_pitch", yin._YIN_ARGS)
    assert fn(x.data_ptr(), out.data_ptr(), n, length, 2048, 1024, 512,
              spectral.n_frames(length, 2048, 512), min_p, max_p, 0.1,
              float(sr), None) == 0
    torch.testing.assert_close(out, yin.yin_pitch_plain(x, sr), rtol=2e-3,
                               atol=0)


@pytest.mark.parametrize("noise", [0.0, 0.1])
def test_yin_kernel_emulated_plucks(libs, noise):
    """On the 47 plucks K3 agrees with the plain version to rtol 2e-3,
    the pinned near-tie of test_torch_yin apart. A single running fp32
    sum per lag failed this on the clean 1174.7 Hz pluck (9.6%); the
    kernel's interleaved partial sums pass."""
    from tests.test_torch_spectral import pluck_clips
    from tests.test_torch_yin import NEAR_TIE
    x = torch.from_numpy(pluck_clips(noise))
    n, length = x.shape
    out = torch.empty(n)
    fn = _fn(libs["yin_pitch"], "gat_yin_pitch", yin._YIN_ARGS)
    assert fn(x.data_ptr(), out.data_ptr(), n, length, 2048, 1024, 512,
              spectral.n_frames(length, 2048, 512), 11, 221, 0.1,
              float(SR), None) == 0
    keep = torch.ones(n, dtype=torch.bool)
    if noise == 0.0:
        keep[NEAR_TIE] = False
    torch.testing.assert_close(out[keep], yin.yin_pitch_plain(x, SR)[keep],
                               rtol=2e-3, atol=0)


def test_shared_memory_limit_refused(libs):
    """A launch K3 cannot hold is refused with a nonzero status, which the
    wrappers raise on: a clip of 2000 frames (1,023,488 samples, the frame
    limit) and a period range whose single frame exceeds a block's shared
    memory. Longer clips than one block holds at once run in groups of
    frames (`test_yin_kernel_emulated_long`)."""
    fn = _fn(libs["yin_pitch"], "gat_yin_pitch", yin._YIN_ARGS)
    for length, max_p in ((2000 * 512, 221), (5512, 60000)):
        x = torch.zeros(1, length)
        out = torch.empty(1)
        assert fn(x.data_ptr(), out.data_ptr(), 1, length, 2048, 1024, 512,
                  spectral.n_frames(length, 2048, 512), 11, max_p, 0.1,
                  float(SR), None) != 0


@pytest.mark.parametrize("name, symbol, args, too_big", [
    ("melspec_frontend", "gat_melspec_blocks_per_sm", (64, 22), (64, 2000)),
    ("mfcc_frontend", "gat_mfcc_blocks_per_sm", (128, 11), (128, 2000)),
    ("yin_pitch", "gat_yin_blocks_per_sm", (1024, 512, 11, 221),
     (1024, 512, 2000, 221)),
    ("onset_envelope", "gat_onset_envelope_blocks_per_sm", (365, 512),
     (60000, 512)),
    ("mfcc_pitch_frontend", "gat_mfcc_pitch_frontend_blocks_per_sm",
     (5512, 512, 11, 128, 1024, 221), (1023488, 512, 2000, 128, 1024, 221)),
])
def test_occupancy_entry_points(libs, name, symbol, args, too_big):
    """Each kernel's occupancy query takes the main path's sizes (the
    emulation has no occupancy to report, so it writes 0), and refuses
    what its launch refuses: 2000 frames, the clip front-ends' frame limit
    (`test_frame_limit_is_the_wrappers_guard`), and 60000 mel items, more
    shared memory than a block has, for K4. K5's shared memory does not
    depend on the length: `test_onset_pick_emulated_any_length`."""
    fn = _fn(libs[name], symbol, [ctypes.c_int] * len(args)
             + [ctypes.c_void_p])
    blocks = ctypes.c_int(-1)
    assert fn(*args, ctypes.addressof(blocks)) == 0 and blocks.value == 0
    assert fn(*too_big, ctypes.addressof(blocks)) != 0


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


@pytest.mark.parametrize("sr", [11025, 22050])
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("pitch_normalized", [True, False])
def test_mfcc_pitch_kernel_emulated(libs, matmul_route, sr, normalize,
                                    pitch_normalized):
    """K6 against the plain shared front-end (one block DFT): MFCC atol
    1e-3 and rtol 2e-6 (the silent clip's c0 is -1131, where one fp32
    ulp is 1.2e-4 and the two summation orders differ by 1.5e-3), pitch
    rtol 2e-3, the log column log10 of the pitch; the silent clip's pitch
    is sr / min_p in both. Its MFCC is K2's bit for bit (the
    same rounds over the same samples), its pitch K3's bit for bit
    whenever it reads the raw clip. At 22050 Hz the lags 0..441 take two
    lag blocks of the ACF and the 22 frames 6 rounds."""
    x = shared_frontend_clips(sr)
    status, out, hz = mfcc_pitch_emulated(libs, x, sr, normalize,
                                          pitch_normalized)
    assert status == 0
    ref, ref_hz = features.mfcc_pitch_features_plain(
        x, sr, 64, normalize, pitch_normalized)
    torch.testing.assert_close(out[:, :64], ref[:, :64], atol=1e-3,
                               rtol=2e-6)
    torch.testing.assert_close(hz, ref_hz, rtol=2e-3, atol=0)
    torch.testing.assert_close(out[:, 64], torch.log10(hz), rtol=0,
                               atol=1e-6)
    min_p = yin.yin_periods(sr, 50.0, 1000.0, 2048, 1024)[0]
    assert float(hz[-1]) == pytest.approx(sr / min_p, rel=1e-6)
    hann, tw, fb, lo, hi = features._kernel_tables(sr, 128, False, CPU)
    k2 = torch.empty((x.shape[0], 64))
    fn = _fn(libs["mfcc_frontend"], "gat_mfcc_frontend",
             features._MFCC_ARGS)
    assert fn(x.data_ptr(), k2.data_ptr(), hann.data_ptr(), tw.data_ptr(),
              fb.data_ptr(), lo.data_ptr(), hi.data_ptr(),
              spectral.dct_ii_matrix(128, 64).data_ptr(), None, x.shape[0],
              x.shape[1], 512, spectral.n_frames(x.shape[1], 2048, 512), 128,
              64, int(normalize), 80.0, None) == 0
    assert torch.equal(out[:, :64], k2)
    if features.shared_pitch_is_raw(normalize, pitch_normalized):
        k3 = torch.empty(x.shape[0])
        fn = _fn(libs["yin_pitch"], "gat_yin_pitch", yin._YIN_ARGS)
        min_p, max_p = yin.yin_periods(sr, 50.0, 1000.0, 2048, 1024)
        assert fn(x.data_ptr(), k3.data_ptr(), x.shape[0], x.shape[1], 2048,
                  1024, 512, spectral.n_frames(x.shape[1], 2048, 512), min_p,
                  max_p, 0.1, float(sr), None) == 0
        assert torch.equal(hz, k3)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("pitch_normalized", [True, False])
def test_mfcc_pitch_kernel_emulated_bf16(libs, matmul_route, normalize,
                                         pitch_normalized):
    """With bfloat16 operands the wrapper hands K6 the clips rounded to
    bfloat16 (`spectral.kernel_signal`'s rounding) and K6's twiddles stay
    float32: K6 then computes the float32 shared front-end of the rounded
    clips, to the fp32 tolerances. The plain bfloat16 route rounds its
    DFT matrices too, which on the clean tones here lifts the spectrum's
    floor and moves c0 by up to 5.6: that gap is the route's, not the
    kernel's (`chip_smoke.py` holds the two on noisy clips)."""
    spectral.set_matmul_dtype(torch.bfloat16)
    x = shared_frontend_clips(SR)
    xr = x.to(torch.bfloat16).float()
    status, out, hz = mfcc_pitch_emulated(libs, xr, SR, normalize,
                                          pitch_normalized)
    assert status == 0
    ref, ref_hz = features.mfcc_pitch_features_plain(
        xr, SR, 64, normalize, pitch_normalized, bf16=False)
    torch.testing.assert_close(out[:, :64], ref[:, :64], atol=1e-3,
                               rtol=2e-6)
    torch.testing.assert_close(hz, ref_hz, rtol=2e-3, atol=0)
    plain_bf16 = features.mfcc_pitch_features_plain(x, SR, 64, normalize,
                                                    pitch_normalized)[0]
    assert float((plain_bf16 - ref).abs().max()) > 1.0


def test_mfcc_pitch_kernel_emulated_plucks(libs, matmul_route):
    """On the 47 clean plucks K6 holds K3's near-tie pin and agrees with a
    float64 YIN on every other clip to rtol 2e-3; the fp32 block route of
    the plain version (the JAX package's matmul route) misses four of the
    clean plucks above fmax = 1000 Hz (indices 41-46: 880-1175 Hz), which
    is why K6 keeps K3's direct ACF."""
    from tests.test_torch_spectral import pluck_clips
    from tests.test_torch_yin import NEAR_TIE
    assert NEAR_TIE == PLUCK_NEAR_TIE
    assert np.array_equal(port_pluck_clips(0.0), pluck_clips(0.0))
    x = torch.from_numpy(port_pluck_clips(0.0))
    status, _, hz = mfcc_pitch_emulated(libs, x, SR, True, False)
    assert status == 0
    truth = yin_float64(x, SR)
    keep = torch.ones(len(x), dtype=torch.bool)
    keep[NEAR_TIE] = False
    torch.testing.assert_close(hz[keep], truth[keep], rtol=2e-3, atol=0)
    _, plain_hz = features.mfcc_pitch_features_plain(x, SR)
    assert int(((plain_hz / truth - 1).abs() > 2e-3).sum()) >= 4


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


def test_mfcc_pitch_kernel_emulated_zero_rows(libs):
    """A batch of no clips launches nothing and writes nothing (the
    wrapper returns its empty outputs before the launch, as K2's and
    K3's do)."""
    status, out, hz = mfcc_pitch_emulated(libs, torch.zeros(0, 5512), SR,
                                          True, False)
    assert status == 0 and out.shape == (0, 65) and hz.shape == (0,)
    got, got_hz = features.mfcc_pitch_features(torch.zeros(0, 5512), SR)
    assert got.shape == (0, 65) and got_hz.shape == (0,)


def test_mfcc_pitch_kernel_emulated_refusals(libs):
    """K6 refuses 2000 frames or more (1,023,488 samples, the frame limit)
    and a period range whose single frame of YIN exceeds a block's shared
    memory, with a nonzero status the wrapper raises on (its workspace
    query says -1). Longer clips than one block holds at once run in
    groups of frames (`test_mfcc_pitch_kernel_emulated_long`)."""
    x = torch.zeros(1, 2000 * 512)
    assert mfcc_pitch_emulated(libs, x, SR, True, False)[0] != 0
    x = torch.zeros(1, 5512)
    assert mfcc_pitch_emulated(libs, x, SR, True, False,
                               periods=(11, 60000))[0] != 0


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


@pytest.mark.parametrize("sr, length", [(11025, 4608), (11025, 5512),
                                        (11025, 6000), (22050, 11025)])
@pytest.mark.parametrize("normalize", [True, False])
def test_mfcc_pitch_kernel_emulated_frame_counts(libs, sr, length,
                                                 normalize):
    """10, 11, 12 and 22 frames: 11, 12, 13 and 23 hop-blocks of shared
    ACF chains (44, 48, 52 and 92 chains), so rounds of two hop-blocks
    with an odd count and a last round of one block, and at 22050 Hz two
    lag blocks. K6's MFCC is K2's and its raw pitch K3's bit for bit."""
    x = frame_count_clips(length)
    status, out, hz = mfcc_pitch_emulated(libs, x, sr, normalize, False)
    assert status == 0
    k2, k3 = k2_k3_emulated(libs, x, sr, normalize)
    assert torch.equal(out[:, :64], k2)
    assert torch.equal(hz, k3)
    torch.testing.assert_close(out[:, 64], torch.log10(hz), rtol=0,
                               atol=1e-6)


def test_mfcc_pitch_kernel_emulated_unaligned_rows(libs):
    """11,025-sample rows (44,100 bytes) at 22050 Hz: the clip copy for
    YIN is 16-byte copies on the first row and 4-byte copies on the other
    three. The same rows at a one-float offset, all copied 4 bytes at a
    time, give the same floats, and those are K2's and K3's."""
    x = frame_count_clips(11025)
    status, out, hz = mfcc_pitch_emulated(libs, x, 22050, True, False)
    assert status == 0
    shifted = torch.empty(x.numel() + 1)[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 != 0
    status, out_s, hz_s = mfcc_pitch_emulated(libs, shifted, 22050, True,
                                              False)
    assert status == 0
    assert torch.equal(out, out_s) and torch.equal(hz, hz_s)
    k2, k3 = k2_k3_emulated(libs, x, 22050, True)
    assert torch.equal(out[:, :64], k2) and torch.equal(hz, k3)


@pytest.mark.parametrize("hop", [256, 384])
def test_mfcc_pitch_kernel_emulated_other_hops(libs, hop):
    """A hop of 2 or 3 segments of win / 8 = 128 shares 6 or 5 of each
    frame's 8 chains with the frames after it: K6 is still K2 and K3 bit
    for bit at that hop."""
    x = frame_count_clips(5512)
    status, out, hz = mfcc_pitch_emulated(libs, x, SR, False, False, hop=hop)
    assert status == 0
    k2, k3 = k2_k3_emulated(libs, x, SR, False, hop=hop)
    assert torch.equal(out[:, :64], k2) and torch.equal(hz, k3)


@pytest.mark.parametrize("hop, win", [(500, 1024), (512, 1020),
                                      (64, 1024)])
def test_mfcc_pitch_kernel_emulated_refuses_hop(libs, hop, win):
    """The shared ACF chains need win / 8 to tile the hop: K6 and its
    occupancy query refuse any other (hop, win) with a nonzero status,
    and write nothing."""
    x = frame_count_clips(5512)
    status, out, hz = mfcc_pitch_emulated(libs, x, SR, True, False, hop=hop,
                                          win=win)
    assert status != 0
    assert bool(out.isnan().all()) and bool(hz.isnan().all())
    fn = _fn(libs["mfcc_pitch_frontend"],
             "gat_mfcc_pitch_frontend_blocks_per_sm",
             [ctypes.c_int] * 6 + [ctypes.c_void_p])
    blocks = ctypes.c_int(-1)
    assert fn(5512, hop, spectral.n_frames(5512, 2048, hop), 128, win, 221,
              ctypes.addressof(blocks)) != 0


# Clips past what one block held at once before groups and workspaces:
# K3 refused 71 frames or more at hop 512 (11025 Hz: 3.25 s), K6 70, K2
# 355 and K1 745 at hop 256.
LONG_FRAMES = (71, 100, 200)


def frames_clips(n_frames: int, hop: int = 512) -> torch.Tensor:
    """`frame_count_clips` of exactly n_frames frames at `hop`."""
    return frame_count_clips((n_frames - 1) * hop)


@pytest.mark.parametrize("n_frames", LONG_FRAMES)
def test_yin_kernel_emulated_long(libs, n_frames):
    """K3 at 71, 100 and 200 frames, where its clip no longer fits a block
    whole: it runs in groups of frames and agrees with the plain version
    to rtol 2e-3, as at 11 frames."""
    x = frames_clips(n_frames)
    group = _fn(libs["yin_pitch"], "gat_yin_group", [ctypes.c_int] * 4)(
        1024, 512, n_frames, 221)
    assert 0 < group < n_frames
    _, k3 = k2_k3_emulated(libs, x, SR, True)
    torch.testing.assert_close(k3, yin.yin_pitch_plain(x, SR), rtol=2e-3,
                               atol=0)


@pytest.mark.parametrize("n_frames", LONG_FRAMES)
def test_mfcc_pitch_kernel_emulated_long(libs, matmul_route, n_frames):
    """K6 at 71, 100 and 200 frames, YIN in groups of frames: against the
    plain shared front-end to `test_mfcc_pitch_kernel_emulated`'s
    tolerances, its MFCC K2's and its pitch K3's bit for bit (chains that
    cross a group's end are summed again in the next group)."""
    x = frames_clips(n_frames)
    group = _fn(libs["mfcc_pitch_frontend"], "gat_mfcc_pitch_group",
                [ctypes.c_int] * 6)(n_frames, 128, 64, 1024, 512, 221)
    assert 0 < group < n_frames
    status, out, hz = mfcc_pitch_emulated(libs, x, SR, True, False)
    assert status == 0
    ref, ref_hz = features.mfcc_pitch_features_plain(x, SR, 64, True, False)
    torch.testing.assert_close(out[:, :64], ref[:, :64], atol=1e-3,
                               rtol=2e-6)
    torch.testing.assert_close(hz, ref_hz, rtol=2e-3, atol=0)
    k2, k3 = k2_k3_emulated(libs, x, SR, True)
    assert torch.equal(out[:, :64], k2) and torch.equal(hz, k3)


@pytest.mark.parametrize("pitch_normalized", [True, False])
def test_mfcc_pitch_kernel_emulated_long_normalized(libs, matmul_route,
                                                    pitch_normalized):
    """Each group's copy is divided by the clip's volume divisor when both
    flags ask for it: 100 frames, against the plain version."""
    x = frames_clips(100)
    status, out, hz = mfcc_pitch_emulated(libs, x, SR, True,
                                          pitch_normalized)
    assert status == 0
    ref, ref_hz = features.mfcc_pitch_features_plain(x, SR, 64, True,
                                                     pitch_normalized)
    torch.testing.assert_close(out[:, :64], ref[:, :64], atol=1e-3,
                               rtol=2e-6)
    torch.testing.assert_close(hz, ref_hz, rtol=2e-3, atol=0)


def test_melspec_kernel_emulated_past_the_image_limit(libs):
    """K1 at 800 frames (hop 256; it refused 745 or more): the image is
    written straight to the output, to K1's tolerance against the plain
    version, on the noisy rows. The clean decaying tone (row 0) is left
    out: its bands 66 dB below its peak differ from the plain version by
    up to 0.22 dB at 744 frames too, with the image in shared memory,
    which is fp32 FFT leakage and not where the image is kept."""
    x = frames_clips(800, hop=256)[[1, 2, 3]]
    check_mel_image(_melspec_emulated(libs, x, True, True),
                    features.melspec_features_plain(x, SR), True)


@pytest.mark.parametrize("n_frames", [354, 355, 400])
def test_mfcc_kernels_emulated_past_the_image_limit(libs, matmul_route,
                                                    n_frames):
    """K2 and K6 at 354 frames keep the dB image in shared memory, and from
    355 frames (K2 refused 355 or more) in a workspace of n_frames x 128
    floats per clip: K2 against the plain version (atol 1e-3 and rtol
    2e-6, as K6's test: the mostly silent pluck row's c0 is -261, a mean
    over 355 frames summed in another order than torch.mean's), K6's MFCC
    K2's and its pitch K3's bit for bit."""
    x = frames_clips(n_frames)[[1, 3]]
    floats = n_frames * 128 if n_frames >= 355 else 0
    sizes = (n_frames, 128, 64, 1024, 512, 221)
    assert _fn(libs["mfcc_frontend"], "gat_mfcc_workspace_floats",
               [ctypes.c_int] * 2)(128, n_frames) == floats
    assert _fn(libs["mfcc_pitch_frontend"],
               "gat_mfcc_pitch_workspace_floats",
               [ctypes.c_int] * 6)(*sizes) == floats
    k2, k3 = k2_k3_emulated(libs, x, SR, True)
    torch.testing.assert_close(k2, features.mfcc_frontend_plain(x, SR),
                               atol=1e-3, rtol=2e-6)
    status, out, hz = mfcc_pitch_emulated(libs, x, SR, True, False)
    assert status == 0
    assert torch.equal(out[:, :64], k2) and torch.equal(hz, k3)


def test_mfcc_kernel_emulated_refuses_missing_workspace(libs):
    """A launch whose dB image needs the workspace is refused without
    one, and writes nothing."""
    x = frames_clips(400)[:1]
    out = torch.full((1, 64), float("nan"))
    hann, tw, fb, lo, hi = features._kernel_tables(SR, 128, False, CPU)
    fn = _fn(libs["mfcc_frontend"], "gat_mfcc_frontend", features._MFCC_ARGS)
    assert fn(x.data_ptr(), out.data_ptr(), hann.data_ptr(), tw.data_ptr(),
              fb.data_ptr(), lo.data_ptr(), hi.data_ptr(),
              spectral.dct_ii_matrix(128, 64).data_ptr(), None, 1,
              x.shape[1], 512, 400, 128, 64, 1, 80.0, None) != 0
    assert bool(out.isnan().all())


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


@pytest.mark.parametrize("sr, length", list(GOLDEN))
def test_clip_kernels_emulated_golden(libs, matmul_route, sr, length):
    """At up to 69 frames every clip front-end gives the floats it gave
    before this length handling, bit for bit: the one-group layout at 11
    frames, groups of frames at 22 (22050 Hz) and 69 (K3)."""
    x = golden_clips(length)
    want = GOLDEN[(sr, length)]
    k2, k3 = k2_k3_emulated(libs, x, sr, True)
    _, k6, hz = mfcc_pitch_emulated(libs, x, sr, True, False)
    got = {"K2": _digest(k2), "K3": _digest(k3), "K6": _digest(k6)}
    if "K1" in want:
        got["K1"] = _digest(_melspec_emulated(libs, x, True, True))
    assert {k: got[k] for k in want} == want
    assert torch.equal(hz, k3)


@pytest.mark.parametrize("name, symbol, args", [
    ("melspec_frontend", "gat_melspec_blocks_per_sm", (64,)),
    ("mfcc_frontend", "gat_mfcc_blocks_per_sm", (128,)),
    ("yin_pitch", "gat_yin_blocks_per_sm", (1024, 512, None, 221)),
    ("mfcc_pitch_frontend", "gat_mfcc_pitch_frontend_blocks_per_sm",
     (0, 512, None, 128, 1024, 221)),
])
def test_frame_limit_is_the_wrappers_guard(libs, name, symbol, args):
    """Each clip front-end takes 1999 frames and refuses 2000, and so does
    the wrappers' guard, whose error names the limit."""
    def query(n_frames):
        full = [n_frames if a is None else a for a in args]
        if None not in args:
            full.append(n_frames)
        fn = _fn(libs[name], symbol, [ctypes.c_int] * len(full)
                 + [ctypes.c_void_p])
        blocks = ctypes.c_int(-1)
        return fn(*full, ctypes.addressof(blocks))
    assert query(kernels.MAX_FRAMES - 1) == 0
    assert query(kernels.MAX_FRAMES) != 0
    kernels.check_frames(kernels.MAX_FRAMES - 1, 512, 0, name)
    with pytest.raises(ValueError, match="fewer than 2000 frames"):
        kernels.check_frames(kernels.MAX_FRAMES, 512, 1023488, name)
    assert features.kernel_frames(1998 * 512, 512, name) == 1999
    with pytest.raises(ValueError, match="1023488 samples give 2000 frames"):
        features.kernel_frames(1999 * 512, 512, name)


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


@pytest.mark.parametrize("n", [22050, 45000])
@pytest.mark.parametrize("padded", [False, True])
def test_onset_envelope_emulated(libs, n, padded):
    """44 and 88 frames (11 and 22 rounds of four per file); with a valid
    prefix the top_db peak reads the valid frames only."""
    y = torch.from_numpy(riffs(n))
    t = spectral.n_frames(n, 2048, 512)
    nvf = (torch.tensor([t, t - 5, 1 + int(0.6 * n) // 512]) if padded
           else None)
    got = onset_envelope_emulated(libs, y, nvf)
    ref = onset.onset_strength_plain(y, FILE_SR, n_valid_frames=nvf)
    torch.testing.assert_close(got, ref, atol=1e-3, rtol=0)
    assert float(ref.max()) > 1.0  # the tones give the flux real peaks


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


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("n", [22562, 23586])
def test_onset_envelope_emulated_batches(libs, b, n):
    """One file and four, at 45 and 47 frames: the last round of each
    file holds one or three frames, so an FFT runs with a zero partner,
    and a block's share of rounds crosses from one file to the next."""
    y, nvf = file_batch(n, b)
    got = onset_envelope_emulated(libs, y, nvf, grid=7)
    ref = onset.onset_strength_plain(y, FILE_SR, n_valid_frames=nvf)
    torch.testing.assert_close(got, ref, atol=1e-3, rtol=0)


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


@pytest.mark.parametrize("n", [45000, 88200])
def test_onset_kernels_emulated_zero_row(libs, n):
    """A padding row of n_valid 0 (one valid frame, its min equal to its
    max): K4 and K5 agree with their plain versions and give no onset."""
    y, nvf = padded_wave(n)
    env = onset_envelope_emulated(libs, y, nvf)
    check_zero_row(y, nvf, env, lambda e, v, c: onset_pick_emulated(
        libs, e, v, 64, c))


def test_onset_envelope_emulated_grid_invariant(libs):
    """The envelope is the same, bit for bit, whatever the first pass's
    grid: one block for all rounds, three, and more blocks than rounds
    (cut to one round each)."""
    y, nvf = file_batch(22562, 4)
    rounds = 4 * -(-spectral.n_frames(22562, 2048, 512) // 4)  # 4 files
    envs = [onset_envelope_emulated(libs, y, nvf, grid=g)
            for g in (1, 3, rounds + 1)]
    assert torch.equal(envs[0], envs[1]) and torch.equal(envs[0], envs[2])


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


@pytest.mark.parametrize("n,loud_tail", [(45000, False), (175616, False),
                                         (60000, True)])
def test_onset_mel_db_shards_stitch_to_envelope(libs, n, loud_tail):
    """`gat_onset_mel_db` over 4 shards that carry their left context and
    right halo (origin 0), stitched, gives `gat_onset_envelope`'s pre-clamp
    dB and peak bit for bit, and `gat_onset_flux` over the stitched rows
    its envelope; the plain halves stitch to `onset_strength_plain`.
    Each shard holds whole rounds of four frames, so every FFT pairs the
    frames the whole file's pass pairs: 88 frames in shards of 24, 344 in
    shards of 88; the loud tail puts the file's peak in its last frames,
    where the budget frames past the end would move it."""
    y = riffs(n)[0]
    if loud_tail:
        y = y * 0.05
        y[-400:] = 0.9
    t = spectral.n_frames(n, 2048, 512)
    env, db, peak = onset_passes_emulated(libs, torch.from_numpy(y)[None],
                                          None)
    shards = time_shards(y, 4)
    got_db, got_peak = stitch(
        [mel_db_emulated(libs, ext, frames, 0, nvf)
         for ext, frames, nvf in shards], t)
    assert torch.equal(got_db, db) and torch.equal(got_peak, peak)
    torch.testing.assert_close(flux_emulated(libs, got_db, got_peak), env,
                               atol=1e-6, rtol=0)
    ref = onset.onset_strength_plain(torch.from_numpy(y)[None], FILE_SR)
    torch.testing.assert_close(env, ref, atol=1e-3, rtol=0)
    plain_db, plain_peak = stitch(
        [onset.onset_mel_db_plain(ext, FILE_SR, origin=0, frames=frames,
                                  n_valid_frames=nvf)
         for ext, frames, nvf in shards], t)
    torch.testing.assert_close(onset.onset_flux_plain(plain_db, plain_peak),
                               ref, atol=1e-5, rtol=0)


def test_onset_passes_emulated_match_plain(libs):
    """The two entry points on their own against their plain versions, on
    centred files with valid prefixes: dB within 1e-3 where the plain dB
    is above -60, the peak keys' dB within 1e-3, the flux of the same
    rows within 1e-5."""
    y, nvf = file_batch(23586, 4)
    db, peak = mel_db_emulated(libs, y, spectral.n_frames(23586, 2048, 512),
                               -1024, nvf)
    ref_db, ref_peak = onset.onset_mel_db_plain(y, FILE_SR,
                                                n_valid_frames=nvf)
    loud = ref_db > -60.0
    torch.testing.assert_close(db[loud], ref_db[loud], atol=1e-3, rtol=0)
    torch.testing.assert_close(onset.key_value(peak),
                               onset.key_value(ref_peak), atol=1e-3, rtol=0)
    torch.testing.assert_close(flux_emulated(libs, ref_db, ref_peak),
                               onset.onset_flux_plain(ref_db, ref_peak),
                               atol=1e-5, rtol=0)
    torch.testing.assert_close(
        onset.onset_flux_plain(ref_db, ref_peak),
        onset.onset_strength_plain(y, FILE_SR, n_valid_frames=nvf),
        atol=1e-5, rtol=0)


def test_order_keys_keep_the_order():
    v = torch.tensor([-np.inf, -3.5, -0.0, 0.0, 1e-30, 2.0, np.inf],
                     dtype=torch.float32)
    k = onset.order_key(v)
    assert torch.equal(k, torch.sort(k).values)
    assert torch.equal(onset.key_value(k), v)
    assert int(onset.order_key(v[:1])) == onset._NEG_INF_KEY


LIVE_RING = 33075  # the live engine's 1.5 s ring at 22050 Hz


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("padded", [False, True])
def test_onset_envelope_emulated_hop_1024(libs, b, padded):
    """The live path's shape: rings of 33,075 samples at hop 1024 (33
    frames, the first lag + 2048 / (2 * 1024) = 2 of them zero), one ring
    and a batch of 3, with and without valid prefixes."""
    y = torch.from_numpy(riffs(LIVE_RING)[:b])
    t = spectral.n_frames(LIVE_RING, 2048, 1024)
    nvf = torch.tensor([t, t - 5, 20][:b]) if padded else None
    got = onset_envelope_emulated(libs, y, nvf, hop=1024)
    ref = onset.onset_strength_plain(y, FILE_SR, hop_length=1024,
                                     n_valid_frames=nvf)
    assert got.shape == (b, 33)
    torch.testing.assert_close(got, ref, atol=1e-3, rtol=0)
    assert float(ref.max()) > 1.0 and not bool(got[:, :2].any())


def test_onset_envelope_attribute_only_grows(libs):
    """K4's occupancy query raises the first pass's shared-memory
    attribute and never lowers it: after hop 1024 (59,088 B at 365 mel
    items) a query at hop 512 (52,944 B) leaves 59,088 B, so a later
    launch at hop 1024, whose query is cached, still fits."""
    lib = libs["onset_envelope"]
    attr = ctypes.c_int.in_dll(lib, "emu_smem_attr")
    attr.value = 48 * 1024
    fn = _fn(lib, "gat_onset_envelope_blocks_per_sm",
             [ctypes.c_int] * 2 + [ctypes.c_void_p])
    n_items = onset._mel_items(FILE_SR, 128, CPU)[2]
    blocks = ctypes.c_int(-1)
    held = []
    for hop in (1024, 512, 1024):
        assert fn(n_items, hop, ctypes.addressof(blocks)) == 0
        held.append(attr.value)
    assert n_items == 365 and held == [59088] * 3


def test_mel_items_cover_the_filterbank():
    """K4's mel table gives every band exactly its nonzero bins and
    weights, in order, cut into runs of at most ceil(nnz / threads); each
    thread's items close where a band or its run ends."""
    _, _, fb, lo, hi = features._kernel_tables(FILE_SR, 128, False, CPU)
    tab, weights, n_items = onset._mel_items(FILE_SR, 128, CPU)
    tab, weights = tab.numpy(), weights.numpy()
    nnz = int((hi - lo).sum())
    run = -(-nnz // onset._THREADS)
    thread_first = tab[:onset._THREADS + 1]
    band_first = tab[onset._THREADS + 1:onset._THREADS + 130]
    codes = tab[onset._THREADS + 130:]
    assert len(codes) == len(weights) == nnz and run <= onset._MEL_RUN
    bins, ends = codes & 0xFFFF, codes >> 16
    edges = np.cumsum((hi - lo).numpy())
    np.testing.assert_array_equal(np.flatnonzero(ends) + 1, edges)
    for m in range(128):
        a = edges[m - 1] if m else 0
        np.testing.assert_array_equal(bins[a:edges[m]],
                                      np.arange(int(lo[m]), int(hi[m])))
        np.testing.assert_array_equal(weights[a:edges[m]],
                                      fb[m, lo[m]:hi[m]].numpy())
    # items: pieces of each thread's run split at band ends
    closes = ends.astype(bool) | (np.arange(nnz) % run == run - 1)
    closes[-1] = True
    assert n_items == int(closes.sum()) == thread_first[-1]
    np.testing.assert_array_equal(
        thread_first[:-(-nnz // run)],
        np.concatenate([[0], np.cumsum(closes)])[::run][:-(-nnz // run)])
    assert band_first[0] == 0 and band_first[-1] == n_items
    np.testing.assert_array_equal(np.diff(band_first),
                                  [int(closes[(edges[m - 1] if m else 0):
                                              edges[m]].sum())
                                   for m in range(128)])


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


@pytest.mark.parametrize("cand_budget", [None, 0, 3])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("backtrack", [True, False])
def test_onset_pick_emulated(libs, cand_budget, seed, backtrack):
    """All five outputs identical to the plain version, over full and
    short valid prefixes, with budgets that truncate (3 candidates, a
    4-onset cap) and that do not."""
    env = torch.from_numpy(random_envelopes(300, seed))
    nvf = torch.tensor([300, 211, 40])
    for max_onsets in (4, 64):
        got = onset_pick_emulated(libs, env, nvf, max_onsets, cand_budget,
                                  backtrack)
        ref = check_pick(got, env, nvf, max_onsets, cand_budget, backtrack)
        assert bool(ref[1].any())


LONG_FRAMES = 1 + 400 * FILE_SR // 512  # a 400 s file: 17,227 frames


@pytest.mark.parametrize("cand_budget", [None, 0, 3])
@pytest.mark.parametrize("backtrack", [True, False])
def test_onset_pick_emulated_long(libs, cand_budget, backtrack):
    """A 400 s envelope (17 tiles), over full and short valid prefixes:
    all five outputs identical to the plain version."""
    t = LONG_FRAMES
    env = torch.from_numpy(random_envelopes(t, 3))
    nvf = torch.tensor([t, t - 1500, 40])
    for max_onsets in (4, 64):
        got = onset_pick_emulated(libs, env, nvf, max_onsets, cand_budget,
                                  backtrack)
        check_pick(got, env, nvf, max_onsets, cand_budget, backtrack)


def test_onset_pick_emulated_any_length(libs):
    """20,000 frames, beyond what the first K5 could hold in a block's
    shared memory, are taken and picked as the plain version picks them;
    the occupancy query takes no length."""
    t = 20000
    env = torch.from_numpy(random_envelopes(t, 4))
    nvf = torch.tensor([t, 12345, 1])
    got = onset_pick_emulated(libs, env, nvf, 256, 0)
    assert bool(check_pick(got, env, nvf, 256, 0, True)[1].any())
    blocks = ctypes.c_int(-1)
    fn = _fn(libs["onset_pick"], "gat_onset_pick_blocks_per_sm",
             [ctypes.c_void_p])
    assert fn(ctypes.addressof(blocks)) == 0 and blocks.value == 0


# the live engine's min separation at 22050 Hz: its 0.3 s floor lifted
# to min_slice_t plus one hop of 1024 (stream/live.py)
LIVE_MIN_SEP = 0.3 + 1024 / FILE_SR


@pytest.mark.parametrize("cand_budget", [None, 0])
def test_onset_pick_emulated_live_windows(libs, cand_budget):
    """K5 at the live path's windows, 22050 Hz at hop 1024: a moving max
    of size 1 (left 0), averages over 2 + 3 frames and a wait of 0, at
    the live min separation and 64 slots; 33-frame envelopes of live
    rings (K4's plain version) and random ones, with short valid
    prefixes."""
    assert onset._pick_windows(FILE_SR, 1024) == (1, 0, 2, 3, 0)
    rings = torch.from_numpy(riffs(LIVE_RING))
    env = torch.cat([onset.onset_strength_plain(rings, FILE_SR,
                                                hop_length=1024),
                     torch.from_numpy(random_envelopes(33, 5))])
    nvf = torch.tensor([33, 33, 20, 33, 25, 3])
    got = onset_pick_emulated(libs, env, nvf, 64, cand_budget, hop=1024,
                              min_sep=LIVE_MIN_SEP)
    ref = check_pick(got, env, nvf, 64, cand_budget, True, hop=1024,
                     min_sep=LIVE_MIN_SEP)
    assert bool(ref[1][0].any()) and bool(ref[1][1].any())


def scan_envelopes() -> np.ndarray:
    """(4, 65) envelopes of the scan engine's rings (33,075 samples at
    hop 512): three random rows, and a row of (0, 1, 1) repeats whose 43
    candidates pass the 32 that the scan's budget walks."""
    dense = np.tile(np.array([0.0, 1.0, 1.0], np.float32), 22)[:65]
    return np.concatenate([random_envelopes(65, 6), dense[None]])


@pytest.mark.parametrize("cand_budget", [None, 0])
def test_onset_pick_emulated_scan_budget(libs, cand_budget):
    """K5 at the scan engine's budget: 8 slots, min_sep 0, 65 frames, so
    candidate_limit(65, 8, None) = 32; the dense row's walk is cut by
    both the candidate limit and the cap, and flags it."""
    assert onset.candidate_limit(65, 8, None) == 32
    env = torch.from_numpy(scan_envelopes())
    got = onset_pick_emulated(libs, env, None, 8, cand_budget, min_sep=0.0)
    ref = check_pick(got, env, None, 8, cand_budget, True, min_sep=0.0)
    assert bool(ref[2][-1]) and bool(ref[3][-1])
    if cand_budget is None:  # the limit truncated the dense row's walk
        full = onset.pick_onsets_plain(env, FILE_SR, 512, 0.0, 8,
                                       cand_budget=0)
        assert int(ref[4][-1]) < int(full[4][-1])


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


@pytest.mark.parametrize("t", [onset._PICK_TILE - 1, onset._PICK_TILE,
                               onset._PICK_TILE + 1])
@pytest.mark.parametrize("cand_budget", [None, 0, 3])
@pytest.mark.parametrize("backtrack", [True, False])
def test_onset_pick_emulated_tile_edges(libs, t, cand_budget, backtrack):
    """T at the tile size and one either side (one tile or two), with a
    candidate and a backtrack minimum on each side of a tile edge and no
    valid counts (all T frames): identical to the plain version, and the
    planted onsets are picked where the budget lets them be."""
    env = torch.from_numpy(edge_envelopes(t))
    for max_onsets in (4, 64):
        got = onset_pick_emulated(libs, env, None, max_onsets, cand_budget,
                                  backtrack)
        ref = check_pick(got, env, None, max_onsets, cand_budget, backtrack)
        if max_onsets == 64 and cand_budget != 3:
            for row, (dip, burst) in enumerate(edge_onsets(t)):
                frame = dip if backtrack else burst
                assert 512 * frame in ref[0][row][ref[1][row]].tolist()


def test_onset_pick_refuses_windows_past_halo(libs):
    """Peak-pick windows wider than the compiled halo are refused: the
    wrapper raises and the C entry point returns an error."""
    assert onset._pick_windows(FILE_SR, 512)[2] + 1 <= onset._PICK_HALO
    with pytest.raises(ValueError, match="halo"):
        onset._pick_windows(384000, 128)
    env = torch.zeros(1, 500)
    outs = onset._pick_outputs(1, 4, CPU)
    fn = _fn(libs["onset_pick"], "gat_onset_pick", onset._PICK_ARGS)
    assert fn(env.data_ptr(), None, *(o.data_ptr() for o in outs), 1, 500,
              2, 1, onset._PICK_HALO, 5, 0.07, 1, 512, 6615, 4, 500, 1,
              None) != 0


def test_pick_constants_match_kernel():
    """The wrapper's tile and halo are the kernel's."""
    src = (kernels.CSRC / "onset_pick.cu").read_text()
    assert re.search(rf"kTile = {onset._PICK_TILE};", src)
    assert re.search(rf"kHalo = {onset._PICK_HALO};", src)


def test_function_resolves_once(libs, monkeypatch):
    """`kernels.function` sets an entry point's argument types at its
    first resolve and hands the same object back after that."""
    monkeypatch.setitem(kernels._libs, "onset_pick", libs["onset_pick"])
    monkeypatch.setattr(kernels, "_functions", {})
    first = kernels.function("onset_pick", "gat_onset_pick", onset._PICK_ARGS)
    again = kernels.function("onset_pick", "gat_onset_pick", [])
    assert again is first and list(first.argtypes) == onset._PICK_ARGS
    assert first.restype is ctypes.c_int
    assert kernels._functions == {("onset_pick", "gat_onset_pick"): first}


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


@pytest.mark.parametrize("hop", [512, 256, 700])
@pytest.mark.parametrize("counted", [True, False])
@pytest.mark.parametrize("min_db", [GATE_MIN_DB, None])
def test_noise_gate_emulated(libs, hop, counted, min_db):
    """K7 against `gate_parts_plain` (gate_waveform with min_db, rms_gate
    without) on 2 s rows with valid counts 0, 1000, 2047, 2048, 5000 and
    the row (or none), at hop 512, 256 and 700 (runs of 21, 41 and 15
    frames), at the bounds of `check_gate`."""
    n = 2 * FILE_SR
    y = torch.from_numpy(gate_rows(n))
    nv = torch.from_numpy(gate_counts(n)) if counted else None
    got = noise_gate_emulated(libs, y, nv, min_db, hop)
    ref = gating.gate_parts_plain(y, min_db, hop, nv)
    check_gate(got, ref, y, min_db, hop)
    assert bool(got["out"].any())
    if counted:
        assert not bool(got["out"][0].any())


@pytest.mark.parametrize("n", [44100, 44104, 44101])
def test_noise_gate_emulated_vector_path(libs, n):
    """Rows whose length is a multiple of 4 take the 16-byte apply path,
    others (44101) the scalar one; both give the plain gate."""
    y = torch.from_numpy(gate_rows(n, seed=n)[:3])
    nv = torch.tensor([n, 30001, 2048])
    check_gate(noise_gate_emulated(libs, y, nv, GATE_MIN_DB),
               gating.gate_parts_plain(y, GATE_MIN_DB, 512, nv), y,
               GATE_MIN_DB, 512)


def test_noise_gate_emulated_grid_invariant(libs):
    """The gate does not depend on its grid: 1 block, 5, and more than
    there are runs of frames give the same bits."""
    n = 2 * FILE_SR
    y = torch.from_numpy(gate_rows(n)[:2])
    nv = torch.tensor([n, 30000])
    first = noise_gate_emulated(libs, y, nv, GATE_MIN_DB, grid=1)
    for grid in (5, 64):
        again = noise_gate_emulated(libs, y, nv, GATE_MIN_DB, grid=grid)
        assert all(torch.equal(first[k], again[k]) for k in first)


@pytest.mark.parametrize("hop", [4096, 20000])
def test_noise_gate_emulated_long_hops(libs, hop):
    """Hops past the stage's room: runs of 3 frames, then of 1 frame."""
    n = 3 * FILE_SR
    y = torch.from_numpy(gate_rows(n)[:2])
    nv = torch.tensor([n, 40000])
    check_gate(noise_gate_emulated(libs, y, nv, GATE_MIN_DB, hop),
               gating.gate_parts_plain(y, GATE_MIN_DB, hop, nv), y,
               GATE_MIN_DB, hop)


def test_noise_gate_emulated_percentile_ties(libs):
    """Envelopes with long runs of equal frames (a row of silence and a
    row of a held level under a step): the order statistics at and
    next to the 20th percentile come from a run of equal keys."""
    n = 2 * FILE_SR
    y = np.zeros((3, n), np.float32)
    y[1] = 0.25
    y[1, n // 2:] = 0.5
    y[2] = np.sign(np.sin(np.arange(n) / 7.0)) * 0.1
    y = torch.from_numpy(y)
    nv = torch.tensor([n, n, 33333])
    for min_db in (GATE_MIN_DB, None):
        got = noise_gate_emulated(libs, y, nv, min_db)
        ref = gating.gate_parts_plain(y, min_db, 512, nv)
        check_gate(got, ref, y, min_db, 512)
        assert torch.equal(got["gate_db"], ref["gate_db"])


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


@pytest.mark.parametrize("hop, counted, min_db", list(GATE_PINS))
def test_noise_gate_emulated_pins(libs, hop, counted, min_db):
    """K7 gives the bits its first design gave: gate_db, the frame mask and
    the gated rows bit-equal to the pins, and the envelope and its median
    too (hop blocks summed in fp64 give each frame's float32 sum of its
    2048 squares as a warp per frame did)."""
    n = 2 * FILE_SR
    y = torch.from_numpy(gate_rows(n))
    nv = torch.from_numpy(gate_counts(n)) if counted else None
    got = noise_gate_emulated(libs, y, nv, min_db, hop)
    keys = ("gate_db", "frame_mask", "out", "env", "med")
    assert tuple(_digest(got[k]) for k in keys) == GATE_PINS[
        (hop, counted, min_db)]


def pass_blocks(libs, n: int, hop: int) -> list:
    """K7's `gat_noise_gate_pass_blocks`: each pass's resident blocks per
    SM (0 under the emulation), the threshold block's threads, and
    whether it stages the envelope in shared memory."""
    out = (ctypes.c_int * 5)(*[-1] * 5)
    fn = _fn(libs["noise_gate"], "gat_noise_gate_pass_blocks",
             [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    assert fn(n, hop, ctypes.addressof(out)) == 0
    return list(out)


@pytest.mark.parametrize("n", [gating.GATE_STAGED_FRAMES - 1,
                               gating.GATE_STAGED_FRAMES])
def test_noise_gate_emulated_threshold_in_device_memory(libs, n):
    """At hop 1 the threshold pass stages 24,576 frames in shared memory
    (the row of 24,575 samples) and keeps 24,577 in device memory (one
    sample more): both give the plain gate at `check_gate`'s bounds, with
    1024 threads a file."""
    y = torch.from_numpy(gate_rows(n, seed=7)[:2])
    nv = torch.tensor([n, 20001])
    assert pass_blocks(libs, n, 1)[3:] == [
        1024, int(n < gating.GATE_STAGED_FRAMES)]
    check_gate(noise_gate_emulated(libs, y, nv, GATE_MIN_DB, 1),
               gating.gate_parts_plain(y, GATE_MIN_DB, 1, nv), y,
               GATE_MIN_DB, 1)


def test_noise_gate_emulated_pass_blocks(libs):
    """The passes' query refuses hop 0 and n 0. The threshold block has 256
    threads up to 2,048 frames, then twice as many while a thread would
    hold more than 8 frames, 1024 at most; it stages the envelope in
    shared memory up to `GATE_STAGED_FRAMES` frames (192 KB with the
    median): the file path's 2 s file, serving wave and 400 s riff at hop
    512, the riff at hop 128 (past the limit) and hop 700."""
    for n, hop, threads in ((44100, 512, 256), (1048064, 512, 256),
                            (1048576, 512, 512), (1323000, 512, 512),
                            (8820000, 512, 1024), (8820000, 128, 1024),
                            (44100, 700, 256)):
        staged = int(1 + n // hop <= gating.GATE_STAGED_FRAMES)
        assert pass_blocks(libs, n, hop) == [0, 0, 0, threads, staged]
    assert pass_blocks(libs, 8820000, 128)[4] == 0
    assert gating.GATE_STAGED_FRAMES * 8 == 192 * 1024
    fn = _fn(libs["noise_gate"], "gat_noise_gate_pass_blocks",
             [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    out = (ctypes.c_int * 5)()
    assert fn(44100, 0, ctypes.addressof(out)) != 0
    assert fn(0, 512, ctypes.addressof(out)) != 0


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_noise_gate_emulated_unaligned_rows(libs, offset):
    """Rows of an odd length at a pointer 1-3 floats past 16-byte
    alignment: the rms pass shifts its stages to the rows' phase and the
    apply pass takes its scalar path; the bits are those of the same rows
    at an aligned pointer, and the plain gate's at `check_gate`'s
    bounds."""
    n = 44101
    y = torch.from_numpy(gate_rows(n, seed=offset)[:3])
    nv = torch.tensor([n, 30001, 2048])
    buf = torch.empty(3 * n + 4)
    moved = buf[offset:offset + 3 * n].view(3, n)
    moved.copy_(y)
    assert moved.data_ptr() % 16 == 4 * offset
    got = noise_gate_emulated(libs, moved, nv, GATE_MIN_DB)
    aligned = noise_gate_emulated(libs, y, nv, GATE_MIN_DB)
    assert all(torch.equal(got[k], aligned[k]) for k in got)
    check_gate(got, gating.gate_parts_plain(y, GATE_MIN_DB, 512, nv), y,
               GATE_MIN_DB, 512)


def test_noise_gate_emulated_sample_gate_band(libs):
    """Samples swept across min_db from 0.05 dB below to 0.05 dB above, in
    steps of 1e-4 dB: inside the 0.01 dB band the kernel takes the log10,
    outside it the amplitude alone decides; every sample farther than
    1e-4 dB from min_db takes the formula's decision, on both sides of
    the band's edges."""
    n = 4 * 4096
    db = GATE_MIN_DB + np.linspace(-0.05, 0.05, n)
    amp = (10.0 ** (db / 20.0)).astype(np.float32)
    sign = np.where(np.arange(n) % 2, -1.0, 1.0).astype(np.float32)
    y = torch.from_numpy(np.stack([amp * sign, amp[::-1] * sign]))
    nv = torch.tensor([n, n])
    got = noise_gate_emulated(libs, y, nv, GATE_MIN_DB)
    ref = gating.gate_parts_plain(y, GATE_MIN_DB, 512, nv)
    check_gate(got, ref, y, GATE_MIN_DB, 512)
    kept = gating.sample_db_gate(y, GATE_MIN_DB) != 0
    assert 0 < int(kept.sum()) < y.numel()


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


@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("onset_hop", [None, 512])
@pytest.mark.parametrize("counted", [True, False])
def test_slice_clips_emulated(libs, strict, onset_hop, counted):
    """K8 against `slice_at_onsets_plain` on 3 s rows, both gathers, both
    last-note rules, valid counts short of the rows (clips cut and
    refused there) or none."""
    n = 3 * FILE_SR
    y = torch.from_numpy(gate_rows(n)[:3])
    onsets, valid = onset_rows(n, onset_hop is not None)
    nv = torch.tensor([n, n - 3000, 40000]) if counted else None
    got = slice_clips_emulated(libs, y, onsets, valid, nv, strict, onset_hop)
    ref = slicing.slice_at_onsets_plain(y, onsets, valid, FILE_SR,
                                        0.5, 0.01, -40.0, strict,
                                        onset_hop=onset_hop, n_valid=nv)
    check_slice(got, ref)
    assert bool(ref[1].any()) and not bool(ref[1].all())


def test_slice_clips_emulated_on_detected_onsets(libs):
    """K8 on the onsets the plain detection finds in the gated riffs, as
    `segment_waveform` hands them over (hop 512, 112 slots mostly
    empty), padding rows of n_valid 0 and 1500 among the rows."""
    n = 3 * FILE_SR
    y = torch.from_numpy(gate_rows(n)[:4])
    nv = torch.tensor([n, 50001, 0, 1500])
    gated = gating.gate_waveform_plain(y, GATE_MIN_DB, n_valid=nv)
    onsets, valid, *_ = onset.detect_onsets(gated, sr=FILE_SR, min_sep=0.25,
                                            max_onsets=16, n_valid=nv)
    assert int(valid.sum()) >= 6 and not bool(valid[2:].any())
    for strict in (True, False):
        got = slice_clips_emulated(libs, y, onsets, valid, nv, strict, 512)
        ref = slicing.slice_at_onsets_plain(y, onsets, valid, FILE_SR, 0.5,
                                            0.01, -40.0, strict,
                                            onset_hop=512, n_valid=nv)
        check_slice(got, ref)


def test_slice_clips_emulated_edges(libs):
    """A skip past the row (every clip empty), a clip longer than the row,
    unaligned onsets with the row gather (the reference's rows, not the
    samples), negative and past-the-end onsets, and a row with no valid
    slot: the plain slicer's outputs."""
    y = torch.from_numpy(gate_rows(3000)[:2])
    onsets = torch.tensor([[-700, 3, 1500, 2999], [100, 200, 5000, 900]],
                          dtype=torch.int32)
    valid = torch.tensor([[True, True, True, True], [False] * 4])
    for skip_sec, length_sec, hop in ((0.2, 0.5, 512), (0.0, 0.2, None),
                                      (0.001, 0.2, 512), (0.0, 0.01, 7)):
        for strict in (True, False):
            got = slice_clips_emulated(libs, y, onsets, valid, None, strict,
                                       hop, length_sec, skip_sec)
            ref = slicing.slice_at_onsets_plain(
                y, onsets, valid, FILE_SR, length_sec, skip_sec, -40.0,
                strict, onset_hop=hop)
            check_slice(got, ref)


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


@pytest.mark.parametrize("length_sec, onset_hop, strict", list(SLICE_PINS))
def test_slice_clips_emulated_pins(libs, length_sec, onset_hop, strict):
    """K8 gives the bits its first design gave on `pin_inputs`: clips of
    0.5 s (shorter than the stage ring, odd) and 4.0 s (seven times the
    ring) by both gathers and both last-note rules; and the plain
    slicer's at `check_slice`'s bounds."""
    y, onsets, valid, nv = pin_inputs(length_sec, onset_hop)
    assert y.data_ptr() % 16 == 0
    got = slice_clips_emulated(libs, y, onsets, valid, nv, strict, onset_hop,
                               length_sec)
    check_slice(got, slicing.slice_at_onsets_plain(
        y, onsets, valid, FILE_SR, length_sec, 0.01, -40.0, strict,
        onset_hop=onset_hop, n_valid=nv))
    assert tuple(_digest(t) for t in got) == SLICE_PINS[
        (length_sec, onset_hop, strict)]


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_slice_clips_emulated_unaligned_rows(libs, offset):
    """Rows at a pointer 1-3 floats past 16-byte alignment, windows from
    the tensor's first sample to its last: the staged route reads the
    floats its copies' rounding would take from outside the tensor one at
    a time; the bits are those of the same rows at an aligned pointer,
    and the plain slicer's at `check_slice`'s bounds."""
    n = 3001
    y = torch.from_numpy(gate_rows(n, seed=offset)[:2])
    onsets = torch.tensor([[0, 1, 1500, 2000], [0, 700, 2990, 2999]],
                          dtype=torch.int32)
    valid = torch.ones(2, 4, dtype=torch.bool)
    buf = torch.empty(2 * n + 4)
    moved = buf[offset:offset + 2 * n].view(2, n)
    moved.copy_(y)
    assert moved.data_ptr() % 16 == 4 * offset
    for hop, strict in ((None, False), (1, True)):
        got = slice_clips_emulated(libs, moved, onsets, valid, None, strict,
                                   hop, 0.1, 0.0)
        aligned = slice_clips_emulated(libs, y, onsets, valid, None, strict,
                                       hop, 0.1, 0.0)
        assert all(torch.equal(a, b) for a, b in zip(got, aligned))
        check_slice(got, slicing.slice_at_onsets_plain(
            y, onsets, valid, FILE_SR, 0.1, 0.0, -40.0, strict,
            onset_hop=hop))


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


@pytest.mark.parametrize("onset_hop, strict", list(SLICE_PINS_PAST_ROW))
def test_slice_clips_emulated_pins_past_the_row(libs, onset_hop, strict):
    """A valid count past the row's end opens windows that cross it: K8
    reads them as the plain slicer does (clamped, never a sample past the
    row) and gives its first design's bits."""
    y, onsets, valid, nv = past_row_inputs(onset_hop)
    got = slice_clips_emulated(libs, y, onsets, valid, nv, strict, onset_hop,
                               0.1)
    check_slice(got, slicing.slice_at_onsets_plain(
        y, onsets, valid, FILE_SR, 0.1, 0.01, -40.0, strict,
        onset_hop=onset_hop, n_valid=nv))
    assert tuple(_digest(t) for t in got) == SLICE_PINS_PAST_ROW[
        (onset_hop, strict)]


def test_slice_clips_ring_fits_shared_memory(libs):
    """K8's ring (`gat_slice_clips_ring`): a 0.5 s clip at 22050 Hz is in
    flight at once, a 4.0 s one goes round it, and the block's static
    shared memory stays within 48 KB and leaves 4 blocks an SM room."""
    shape = [ctypes.c_int(0) for _ in range(3)]
    assert _fn(libs["slice_clips"], "gat_slice_clips_ring",
               [ctypes.c_void_p] * 3)(*map(ctypes.addressof, shape)) == 0
    stages, chunk, smem = (v.value for v in shape)
    assert stages >= 2 and chunk % 4 == 0
    assert stages * chunk >= int(0.5 * FILE_SR)
    assert stages * chunk < int(4.0 * FILE_SR)
    assert 4 * stages * chunk < smem <= 48 * 1024
    assert 4 * (smem + 1024) <= 228 * 1024


def test_gate_and_slice_occupancy_and_guards(libs):
    """K7's occupancy query takes every hop of 1 or more and refuses 0,
    as its launch and the wrapper's guard do (the guard names the
    limit); K8's shared memory is fixed, its query has no size. Both
    wrappers' other guards name what they refuse, and the C entry points
    refuse the same."""
    blocks = ctypes.c_int(-1)
    q7 = _fn(libs["noise_gate"], "gat_noise_gate_blocks_per_sm",
             [ctypes.c_int, ctypes.c_void_p])
    assert q7(1, ctypes.addressof(blocks)) == 0 and blocks.value == 0
    assert q7(0, ctypes.addressof(blocks)) != 0
    q8 = _fn(libs["slice_clips"], "gat_slice_clips_blocks_per_sm",
             [ctypes.c_void_p])
    blocks.value = -1
    assert q8(ctypes.addressof(blocks)) == 0 and blocks.value == 0
    with pytest.raises(ValueError, match="hop_length must be >= 1"):
        gating.check_gate(44100, 0, True)
    with pytest.raises(ValueError, match="more than 1024 samples"):
        gating.check_gate(1024, 512, False)
    gating.check_gate(1025, 1, False)
    gating.check_gate(1, 512, True)
    with pytest.raises(ValueError, match="1 or more samples"):
        slicing.check_slice(1, 4, 0, 0, 512)
    with pytest.raises(ValueError, match="onset_hop must be >= 1"):
        slicing.check_slice(1, 4, 100, 0, 0)
    y = torch.zeros(1, 4096)
    fn = _fn(libs["noise_gate"], "gat_noise_gate", gating._GATE_ARGS)
    ws = torch.empty(64)
    assert fn(y.data_ptr(), y.data_ptr(), None, ws.data_ptr(),
              ws.data_ptr(), ws.data_ptr(), ws.data_ptr(), 1, 4096, 0, 1,
              -45.0, 3, None) != 0
    fn = _fn(libs["slice_clips"], "gat_slice_clips", slicing._SLICE_ARGS)
    ons = torch.zeros(1, 4, dtype=torch.int32)
    assert fn(y.data_ptr(), ons.data_ptr(), ons.data_ptr(), None,
              ws.data_ptr(), ws.data_ptr(), ws.data_ptr(), 1, 4096, 4, 0,
              0, 512, 1, -40.0, 1.0 / FILE_SR, None) != 0


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


@pytest.mark.parametrize("orig,target", RESAMPLE_RATES)
@pytest.mark.parametrize("length", [0, 1, 7, 1001, 4099])
def test_resample_kernel_emulated(libs, orig, target, length):
    """K9 on stereo rows (2, n), as `resample` flattens them, against
    `resample_plain` at atol 1e-5 (float32 sums of 49 to 209 taps in
    another order); the first outputs of every row have a negative u,
    the last read past the row. A row of 0 samples is refused by the C
    entry point, and the wrapper launches nothing for it."""
    x = resample_rows_np(length)
    ref = resample.resample_plain(x, orig, target)
    if length == 0:
        up, down = resample._ratio(orig, target)
        fn = _fn(libs["resample"], "gat_resample", resample._RESAMPLE_ARGS)
        out = torch.empty(2, 1)
        assert fn(x.data_ptr(), None, x.data_ptr(), out.data_ptr(), 2, 0,
                  2, 1, up, down, 1, 0, None) != 0
        assert ref.shape == (2, 0)
        return
    got = resample_emulated(libs, x, orig, target)
    assert got.shape == ref.shape
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("orig,target", [(22050, 11025), (48000, 22050),
                                         (16000, 22050)])
def test_resample_rows_kernel_emulated(libs, orig, target):
    """`resample_rows`' launch: a permuted selection with a repeat, a
    single row, out_len above m (zeros past it) and below it (a cut, the
    file body's 11,025 -> 5,512), against `resample_rows_plain`; a row
    index outside x's rows gives a row of NaN."""
    x = resample_rows_np(4099, rows=5)
    m = -(-4099 * resample._ratio(orig, target)[0]
          // resample._ratio(orig, target)[1])
    for rows, out_len in (([3, 0, 4, 1, 3], m), ([2], m), ([4, 1], m + 700),
                          ([0, 2, 1], m // 2), (None, m - 1)):
        got = resample_emulated(libs, x, orig, target, rows, out_len)
        ref = resample.resample_rows_plain(x, rows, orig, target, out_len)
        assert got.shape == ref.shape
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)
    got = resample_emulated(libs, x, orig, target, [1, 5, -1], 300)
    assert not bool(got[0].isnan().any())
    assert bool(got[1:].isnan().all())


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_resample_kernel_emulated_unaligned_rows(libs, offset):
    """Rows at a pointer 1-3 floats past 16-byte alignment: the copies'
    cover stops at the tensor's aligned interior and its first and last
    floats are read one at a time; the bits are those of the same rows
    at an aligned pointer, and the plain version's within 1e-5."""
    n = 1003
    x = resample_rows_np(n, seed=offset)
    buf = torch.empty(2 * n + 4)
    moved = buf[offset:offset + 2 * n].view(2, n)
    moved.copy_(x)
    assert moved.data_ptr() % 16 == 4 * offset
    for orig, target in ((22050, 11025), (48000, 22050)):
        got = resample_emulated(libs, moved, orig, target)
        assert torch.equal(got, resample_emulated(libs, x, orig, target))
        torch.testing.assert_close(
            got, resample.resample_plain(x, orig, target), atol=1e-5,
            rtol=0)


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


def test_resample_kernel_emulated_taps_through_the_cache(libs):
    """7999 -> 22050 Hz (up 22050, down 7999): a phase table of 22050 x
    49 floats (4.3 MB) does not fit a block's shared memory, so K9 reads
    its taps through the read-only cache, builds no banded table, and
    stages rows; the outputs are the plain version's within 1e-5."""
    up, down, k_taps = resample_taps(7999, 22050)
    lay = resample_layout(libs, up, down, k_taps)
    assert (up, k_taps, lay["taps"], lay["rows"]) == (22050, 49, 0, 1)
    assert lay["bytes"] == 4 * (152 + 2 * lay["buf"]
                                + lay["frames"] * (4 * lay["groups"] + 1))
    x = resample_rows_np(301)
    torch.testing.assert_close(resample_emulated(libs, x, 7999, 22050),
                               resample.resample_plain(x, 7999, 22050),
                               atol=1e-5, rtol=0)


def test_resample_kernel_emulated_cache_route_grid(libs):
    """The read-only-cache route with the grid sized to the card: a 2003
    sample row at 7999 Hz (5,522 outputs in one frame of 44,100 phases,
    87 tiles of 16 groups) on 3 blocks gives the bits of 64 blocks, and
    the plain version's within 1e-5."""
    x = resample_rows_np(2003, rows=1)
    assert resample_tiles(libs, 7999, 22050, 2003, 1) == 87
    with emulated_sms(libs, 3):
        got = resample_emulated(libs, x, 7999, 22050)
    with emulated_sms(libs, 64):
        assert torch.equal(got, resample_emulated(libs, x, 7999, 22050))
    torch.testing.assert_close(got, resample.resample_plain(x, 7999, 22050),
                               atol=1e-5, rtol=0)


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


@pytest.mark.parametrize("orig,target", list(RESAMPLE_PINS))
def test_resample_kernel_emulated_pins(libs, orig, target):
    """K9 gives the bits its first design gave at every rate pair, the
    read-only-cache route included: each output still adds its taps in
    ascending k with fmaf from 0, and the banded table's zeros around
    them leave the sum as it was."""
    def run(x, rows, out_len):
        return resample_emulated(libs, x, orig, target, rows, out_len)
    assert resample_pin_digest(run, orig, target) == RESAMPLE_PINS[
        (orig, target)]


@pytest.mark.parametrize("orig,target", [(22050, 11025), (48000, 22050),
                                         (16000, 22050), (44100, 11025)])
@pytest.mark.parametrize("sms", [1, 7])
def test_resample_kernel_emulated_grid(libs, orig, target, sms):
    """Blocks that compute several tiles each, a block's tiles crossing
    rows' ends (3 rows of 9001 samples at 48 and 16 kHz, of 33,000 and
    66,000 in the span's tiles of 4096 outputs): the span route at lags 8
    and 16 and the rows route give on 1 and 7 blocks the bits of 64
    blocks (one a tile but at 16 kHz's 84 tiles), and the plain version's
    within 1e-5."""
    n = {22050: 33000, 44100: 66000}.get(orig, 9001)
    x = resample_rows_np(n, rows=3, seed=2)
    tiles = resample_tiles(libs, orig, target, n, 3)
    assert tiles >= 2 * sms
    with emulated_sms(libs, sms):
        got = resample_emulated(libs, x, orig, target)
    with emulated_sms(libs, 64):
        assert torch.equal(got, resample_emulated(libs, x, orig, target))
    torch.testing.assert_close(got, resample.resample_plain(x, orig, target),
                               atol=1e-5, rtol=0)


def test_resample_kernel_emulated_tiles_not_a_multiple_of_the_grid(libs):
    """30 tiles (10 parts of 16 groups x 3 rows at 48 kHz) on 4 blocks:
    blocks of 7 and 8 tiles, parts changing inside a block (its banded
    table rebuilt), the same bits as one block a tile."""
    x = resample_rows_np(9001, rows=3, seed=2)
    sel = [2, 0, 1]
    tiles = resample_tiles(libs, 48000, 22050, 9001, 3)
    assert tiles == 30 and tiles % 4
    with emulated_sms(libs, 4):
        got = resample_emulated(libs, x, 48000, 22050, sel, 4000)
    with emulated_sms(libs, tiles):
        assert torch.equal(got, resample_emulated(libs, x, 48000, 22050,
                                                  sel, 4000))
    torch.testing.assert_close(
        got, resample.resample_rows_plain(x, sel, 48000, 22050, 4000),
        atol=1e-5, rtol=0)


def test_resample_kernel_emulated_buffer_parity(libs):
    """One block computes all 6 tiles of 6 rows at 22050 -> 11025 Hz, so
    each input buffer serves 3 tiles, its k-th use waiting on its
    mbarrier's parity k & 1: a wrong parity would read a buffer before its
    copy landed (stale outputs) or wait forever."""
    x = resample_rows_np(4099, rows=6, seed=8)
    assert resample_tiles(libs, 22050, 11025, 4099, 6) == 6
    with emulated_sms(libs, 1):
        got = resample_emulated(libs, x, 22050, 11025)
    torch.testing.assert_close(got, resample.resample_plain(x, 22050, 11025),
                               atol=1e-5, rtol=0)


def test_resample_kernel_emulated_short_rows(libs):
    """Rows shorter than a tile (9 rows of 37 samples) at every rate pair
    on 2 blocks: a tile or a few parts a row, a frame holding every output
    (fewer outputs than a frame's phases), within 1e-5 of the plain
    version."""
    x = resample_rows_np(37, rows=9, seed=3)
    with emulated_sms(libs, 2):
        for orig, target in RESAMPLE_RATES + [(7999, 22050)]:
            torch.testing.assert_close(
                resample_emulated(libs, x, orig, target),
                resample.resample_plain(x, orig, target), atol=1e-5, rtol=0)


@pytest.mark.parametrize("orig", [11025, 24000, 32000, 88200, 192000,
                                  384000])
def test_resample_kernel_emulated_other_rates(libs, orig):
    """Rates of WAVs users load, to 22050 Hz, beyond the tests' pairs: up 2
    (a span at lag 2), down 160 and 640 (rows), up 1 at down 4 (a span at
    lag 16), and 192 and 384 kHz, whose phase tables (246 and 492 KB) go
    through the read-only cache in rows of 32 and 16 frames of 8 groups;
    within 1e-5 of the plain version."""
    up, down, k = resample_taps(orig, 22050)
    lay = resample_layout(libs, up, down, k)
    assert lay["bytes"] > 0
    assert lay["frames"] == {11025: 1024, 24000: 32, 32000: 32, 88200: 1024,
                             192000: 32, 384000: 16}[orig]
    assert (lay["taps"] == 0) == (orig >= 192000)
    x = resample_rows_np(3001)
    torch.testing.assert_close(resample_emulated(libs, x, orig, 22050),
                               resample.resample_plain(x, orig, 22050),
                               atol=1e-5, rtol=0)


def test_resample_layout_and_attribute_only_grows(libs):
    """Every rate pair of the tests fits a block: rows of 32 frames x 16
    groups, one frame a lane, at lag 4 where a frame's samples lie a
    multiple of 32 floats apart (48, 16, 96 and 8 kHz; 96 kHz's rows and
    table take 200,160 bytes), a span of 1024 frames of one group, four a
    lane, elsewhere at lag gcd(D, 32) (8 at 22050 -> 11025: 89,488
    bytes); a thread walks the group's window, K +
    ceil(3·down / up) positions, lagged and rounded up to 4. The occupancy
    query (a launch does the same) raises the dynamic shared-memory
    attribute and never lowers it: after 96 kHz, 48 kHz and 22050 Hz leave
    it at 96 kHz's bytes."""
    sizes = {}
    for orig, target in RESAMPLE_RATES:
        up, down, k = resample_taps(orig, target)
        lay = resample_layout(libs, up, down, k)
        stride = lay["phases"] // up * down
        rows = stride % 32 == 0
        assert lay["phases"] == up * 4 // np.gcd(up, 4)
        want = ((1, 32, 16, 4, 1) if rows
                else (0, 1024, 1, np.gcd(stride, 32), 4))
        assert (lay["rows"], lay["frames"], lay["groups"], lay["lag"],
                lay["per_lane"]) == want
        assert lay["tile"] == lay["frames"] * 4 * lay["groups"]
        window = -(-3 * down // up) + k + lay["lag"] - 1
        assert lay["steps"] == -(-window // 4) * 4
        assert lay["taps"] == lay["groups"] * (lay["steps"] + lay["lag"]
                                               - 1) * 4
        assert 0 < lay["bytes"] <= 232448
        sizes[(orig, target)] = (up, down, k, lay["bytes"])
    assert sizes[(96000, 22050)] == (147, 640, 209, 200160)
    assert sizes[(22050, 11025)][3] == 89488
    lib = libs["resample"]
    attr = ctypes.c_int.in_dll(lib, "emu_smem_attr")
    attr.value = 48 * 1024
    fn = _fn(lib, "gat_resample_blocks_per_sm",
             [ctypes.c_int] * 3 + [ctypes.c_void_p])
    blocks = ctypes.c_int(-1)
    held = []
    for rates in ((96000, 22050), (48000, 22050), (22050, 11025)):
        assert fn(*sizes[rates][:3], ctypes.addressof(blocks)) == 0
        assert blocks.value == 0
        held.append(attr.value)
    assert held == [sizes[(96000, 22050)][3]] * 3
    resample_emulated(libs, resample_rows_np(500), 48000, 22050)
    assert attr.value == sizes[(96000, 22050)][3]
    assert fn(1, 0, 97, ctypes.addressof(blocks)) != 0


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


@pytest.mark.parametrize("shape", WAVE_SHAPES + WAVE_SHAPES_PAST)
@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_wave_select_emulated(libs, shape, density):
    """Random budgets (1, below, at and above the kept count, all slots)
    and densities: K10's selection equal to the plain one, field by
    field, sel in the reference's order."""
    n_files, k = shape
    kept = wave_kept(n_files, k, density, seed=n_files * k)
    n_kept = int(kept.sum())
    rng = np.random.default_rng(7)
    budgets = {1, max(1, n_kept - 1), max(1, n_kept), n_kept + 1,
               n_files * k, int(rng.integers(1, n_files * k + 1))}
    ovf, fix = wave_flags(n_files, n_files * k)
    for budget in sorted(budgets):
        check_selection(
            wave_select_emulated(libs, kept, budget, overflow=ovf,
                                 fixable=fix),
            compaction.wave_select_plain(kept, budget, overflow=ovf,
                                         fixable=fix))


@pytest.mark.parametrize("shape, world, density", [
    ((4, 112), 2, 0.2), ((4, 112), 4, 0.9), ((8, 112), 8, 0.5),
    ((64, 64), 4, 0.3), ((6, 7), 3, 0.6), ((90, 100), 3, 0.5),
    ((64, 112), 4, 0.6), ((64, 129), 2, 0.6), ((8200, 2), 2, 0.5)])
def test_wave_select_emulated_mesh(libs, shape, world, density):
    """Each rank's (first, n_local) of the whole wave's kept bits: its
    slots of the wave's selection, in the same order, equal to the plain
    code's sel[(sel >= first·K) & (sel < (first + b)·K)] - first·K; a rank
    none of whose slots is picked gets n_sel 0."""
    n_files, k = shape
    kept = wave_kept(n_files, k, density, seed=world)
    b = n_files // world
    for budget in (1, max(1, int(kept.sum()) // 2), n_files * k - 1):
        whole = compaction.wave_select_plain(kept, budget).sel.long()
        for rank in range(world):
            first = rank * b
            ref = compaction.wave_select_plain(kept, budget, first, b)
            want = whole[(whole >= first * k) & (whole < (first + b) * k)]
            assert torch.equal(ref.sel.long(), want - first * k)
            check_selection(wave_select_emulated(libs, kept, budget, first,
                                                 b), ref)
    # budget 1 with slot 0 of file 0 kept: only rank 0 picks a slot
    kept[0, 0] = True
    assert [wave_select_emulated(libs, kept, 1, r * b, b).n_sel
            for r in range(world)] == [1] + [0] * (world - 1)


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


@pytest.mark.parametrize("shape, c, density, budget", [
    ((1, 1), 47, 1.0, 1), ((4, 112), 47, 0.3, 384), ((4, 112), 47, 0.9, 1),
    ((41, 100), 1, 0.5, 3000), ((6, 7), 5, 0.4, 42), ((6, 7), 5, 0.0, 9),
    ((64, 112), 47, 0.6, 5376), ((64, 112), 33, 0.5, 100)])
def test_wave_scatter_emulated(libs, shape, c, density, budget):
    """The compact outputs back at their slots, zeros elsewhere: bit-equal
    to the plain scatter (a copy), with a dummy row past n_sel unread."""
    n_files, k = shape
    kept = wave_kept(n_files, k, density, seed=c)
    s = compaction.wave_select_plain(kept, budget)
    parts = scatter_parts(s.n_sel + 1, c, seed=budget)
    got = wave_scatter_emulated(libs, s.pos, parts)
    ref = compaction.wave_scatter_plain(s.pos, parts)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("cnn, mlp", [(False, True), (True, False),
                                      (False, False)])
def test_wave_scatter_emulated_missing_parts(libs, cnn, mlp):
    """A build without a CNN or an MLP passes None for its probs: no output
    for that part, the others as the plain scatter."""
    kept = wave_kept(6, 7, 0.4, seed=3)
    s = compaction.wave_select_plain(kept, 30)
    parts = scatter_parts(s.n_sel, 47, seed=3, cnn=cnn, mlp=mlp)
    got = wave_scatter_emulated(libs, s.pos, parts)
    ref = compaction.wave_scatter_plain(s.pos, parts)
    for g, r in zip(got, ref):
        assert (g is None and r is None) or torch.equal(g, r)


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


def test_wave_compact_grid(libs):
    """gat_wave_compact_grid follows the rule at the emulated SMs (one
    resident block an SM): the serving wave and 64 files one tile, past
    8,192 slots several; the scatter's grid the rows' warps up to the
    SMs'."""
    fn = _fn(libs["wave_compact"], "gat_wave_compact_grid",
             compaction._GRID_ARGS)
    out = (ctypes.c_int * 4)()
    for sms in (1, 4, 132):
        with emulated_sms(libs, sms, "wave_compact"):
            for shape in WAVE_SHAPES + WAVE_SHAPES_PAST:
                assert fn(*shape, ctypes.addressof(out)) == 0
                assert list(out) == compact_grid_rule(*shape, sms, 1), shape
    assert compact_grid_rule(4, 112, 132, 8)[::2] == [1, 56]
    assert compact_grid_rule(64, 112, 132, 8)[::2] == [1, 896]
    assert compact_grid_rule(83, 100, 132, 8)[0] == 2
    assert fn(0, 4, ctypes.addressof(out)) != 0


def test_wave_compact_refusals(libs):
    """The C entry points refuse what the wrappers' guards refuse."""
    sel_fn = _fn(libs["wave_compact"], "gat_wave_select",
                 compaction._SELECT_ARGS)
    for n_files, k, budget, first, n_local in ((0, 4, 1, 0, 0),
                                               (2, 4, 0, 0, 2),
                                               (2, 4, 1, 1, 2),
                                               (2, 4, 1, 0, 0)):
        assert sel_fn(*[None] * 10, n_files, k, budget, first, n_local,
                      None) != 0
        with pytest.raises(ValueError):
            compaction.check_select(torch.zeros(n_files, k, dtype=torch.bool),
                                    budget, first, n_local)
    scatter_fn = _fn(libs["wave_compact"], "gat_wave_scatter",
                     compaction._SCATTER_ARGS)
    assert scatter_fn(*[None] * 9, 0, 47, None) != 0
    assert scatter_fn(*[None] * 9, 4, 0, None) != 0


def test_wave_compact_constants_match_kernel():
    """`compaction.MAX_SLOTS` leaves the selection's last tile of kTile
    positions inside int32, as its C entry point refuses the rest; a tile
    is whole words of 32 positions."""
    src = (kernels.CSRC / "wave_compact.cu").read_text()
    tile = int(re.search(r"kTile = (\d+);", src)[1])
    assert tile == COMPACT_TILE and tile % 32 == 0
    assert compaction.MAX_SLOTS == 2 ** 31 - 1 - tile
    with pytest.raises(ValueError, match="at most"):
        compaction.check_select(torch.zeros(1, 1, dtype=torch.bool).expand(
            compaction.MAX_SLOTS + 1, 1), 1, 0, 1)


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


@pytest.mark.parametrize("b, c", [(8, 47), (19, 47), (32, 47), (5, 3),
                                  (32, 3), (3, 70), (32, 70), (64, 47),
                                  (500, 3), (16, 600)])
@pytest.mark.parametrize("scale", [1.0, 0.125])
def test_softmax_xent_kernel_emulated(libs, b, c, scale):
    """The one-block form: the training step's 32 x 47 (8 lanes a row, 6
    classes a lane), fewer classes than lanes, more than two rounds of
    them, two tiles of 32 rows (8 lanes a row), two tiles of 256 rows of 3
    classes (a lane a row) and 600 classes (32 lanes a row, 19 classes a
    lane); no partial slot, fence or ticket."""
    logits, labels = xent_inputs(b, c, seed=b * c)
    assert check_xent(libs, logits, labels, scale)[0] == 1


@pytest.mark.parametrize("b, c, grad", [(1500, 47, True), (2000, 47, False),
                                        (700, 70, True), (1100, 3, False)])
def test_softmax_xent_kernel_emulated_grid_form(libs, b, c, grad):
    """The grid form over 4 emulated SMs: several blocks, each a span of
    double-buffered tiles (1,500 rows: 47 tiles of 32, the last of 28;
    700 x 70: 16 lanes a row, 44 tiles of 16), with and without the
    gradient, the partials added by the last block."""
    logits, labels = xent_inputs(b, c, seed=b + c)
    with emulated_sms(libs, 4, "softmax_xent"):
        grid = check_xent(libs, logits, labels, 1.0 / b, grad)
    assert grid[0] == 4 and -(-b // grid[2]) > grid[0]


@pytest.mark.parametrize("b, sms", [(32, 4), (1500, 4), (1500, 1)])
def test_softmax_xent_kernel_emulated_unaligned(libs, b, sms):
    """Logits as a view one row in (188 bytes: off 16) take the element
    route of the same kernels; one SM gives the grid form one block, which
    writes the results itself."""
    logits, labels = xent_inputs(b + 1, 47, seed=b)
    view, labels = logits[1:], labels[1:]
    assert view.data_ptr() % 16 != 0
    view[0, [1, 46]] = view[0].max() + 1.0
    with emulated_sms(libs, sms, "softmax_xent"):
        grid = check_xent(libs, view, labels, 1.0 / b)
    assert grid[0] == (1 if b == 32 or sms == 1 else 4)


@pytest.mark.parametrize("b, sms", [(21, 4), (1500, 4)])
def test_softmax_xent_kernel_emulated_eval_form(libs, b, sms):
    """Without a gradient (the eval step) the launch writes none and gives
    the same loss, count and argmaxes, in both forms."""
    logits, labels = xent_inputs(b, 47, seed=5)
    with emulated_sms(libs, sms, "softmax_xent"):
        with_grad = xent_emulated(libs, logits, labels, 0.05, 1.0)
        without = xent_emulated(libs, logits, labels, 0.05, 1.0, grad=False)
    assert without[2] is None
    assert torch.equal(with_grad[0], without[0])
    assert torch.equal(with_grad[1], without[1])
    assert torch.equal(with_grad[3], without[3])


def test_softmax_xent_grid(libs):
    """gat_softmax_xent_grid follows the rule at the emulated SMs, and the
    rule gives the card's launches: the step one block of 32 rows at 8
    lanes, an eval chunk 2,048 tiles of 32 rows over 528 blocks at 4
    resident a SM; the C entry points refuse what the wrapper refuses."""
    for sms in (1, 4, 132):
        with emulated_sms(libs, sms, "softmax_xent"):
            for b, c in ((1, 47), (32, 47), (128, 47), (129, 47),
                         (65536, 47), (7, 300), (2000, 1000), (40, 1024)):
                got = xent_grid_emulated(libs, b, c)
                assert [got[0], got[2], got[3]] == xent_grid_rule(b, c, sms,
                                                                  1), (b, c)
    assert xent_grid_rule(32, 47, 132, 4) == [1, 32, 8]
    assert xent_grid_rule(65536, 47, 132, 4) == [528, 32, 8]
    grid_fn = _fn(libs["softmax_xent"], "gat_softmax_xent_grid",
                  loss_mod._GRID_ARGS)
    out = (ctypes.c_int * 5)()
    for b, c in ((0, 47), (4, 0), (4, loss_mod.MAX_CLASSES + 1)):
        assert grid_fn(b, c, ctypes.addressof(out)) != 0
    fn = _fn(libs["softmax_xent"], "gat_softmax_xent", loss_mod._ARGS)
    for blocks, rows, lanes in ((2, 32, 8), (1, 6, 8), (1, 256, 3),
                                (1, 256, 1)):
        assert fn(*[None] * 9, 600, 47, 0.05, 1.0, blocks, rows, lanes,
                  None) != 0  # no partials; rows not of 4; lanes not 2^k;
        # more than 32 classes a lane
    with pytest.raises(ValueError, match="at most"):
        loss_mod.check_kernel(torch.zeros(2, loss_mod.MAX_CLASSES + 1),
                              torch.zeros(2, dtype=torch.int64))
    loss_mod.check_kernel(torch.zeros(2, loss_mod.MAX_CLASSES),
                          torch.zeros(2, dtype=torch.int64))


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


@pytest.mark.parametrize("n", [300, 5000])
@pytest.mark.parametrize("g_scale, max_norm", [(0.1, 1.0), (10.0, 1.0),
                                               (10.0, None)])
def test_clip_adamw_kernel_emulated(libs, n, g_scale, max_norm):
    """Three steps, the learning rate changed after the first, below the
    clip threshold, above it, and without a clip; one block (300) and
    three (5000). The norm within 1e-6 relative (other summation orders),
    p, mu, nu and the clipped gradients within 2e-6 relative (powf against
    torch.pow, and the norm's last bit through the clip) and 2e-7 of each
    buffer's largest value (about an ulp of it, where (1 - b1)·g + b1·mu
    cancels); the count exact. A second run from the same buffers gives
    the same bits."""
    got = adamw_inputs(n, seed=n, g_scale=g_scale)
    again = {k: v.clone() for k, v in got.items()}
    ref = {k: v.clone() for k, v in got.items()}
    counts = [torch.zeros((), dtype=torch.int32) for _ in range(3)]
    lr = torch.tensor(1e-3)
    for step in range(3):
        if step == 1:
            lr.fill_(3e-4)
        if step:
            for st in (got, again, ref):  # a fresh gradient a step
                st["g"].copy_(adamw_inputs(n, seed=n + step,
                                           g_scale=g_scale)["g"])
        norm = adamw_emulated(libs, got, counts[0], lr, max_norm)
        assert torch.equal(adamw_emulated(libs, again, counts[2], lr,
                                          max_norm), norm)
        ref_norm = adamw_plain_step(ref, counts[1], lr, max_norm)
        torch.testing.assert_close(norm, ref_norm, rtol=1e-6, atol=0)
        assert int(counts[0]) == int(counts[1]) == step + 1
        for k in ("p", "g", "mu", "nu"):
            assert torch.equal(got[k], again[k]), k
            torch.testing.assert_close(
                got[k], ref[k], rtol=2e-6,
                atol=2e-7 * float(ref[k].abs().max()),
                msg=lambda m, k=k: f"{k}: {m}")
    clipped = max_norm is not None and float(ref_norm) >= max_norm
    assert clipped == (g_scale > 1.0 and max_norm is not None)


def unaligned(st: dict) -> dict:
    """The buffers of `st` as views one float past a 16-byte boundary."""
    out = {}
    for k, v in st.items():
        base = torch.zeros(v.numel() + 1)
        base[1:].copy_(v)
        out[k] = base[1:]
        assert out[k].data_ptr() % 16 == 4
    return out


@pytest.mark.parametrize("n, offset", [(1001, 0), (5002, 0), (20143, 0),
                                       (20143, 1)])
@pytest.mark.parametrize("g_scale", [0.1, 10.0])
def test_clip_adamw_kernel_emulated_tails(libs, n, offset, g_scale):
    """K12 at n mod 4 = 1, 2 and 3 (20,143: the shipped MLP's count), the
    last n mod 4 parameters taken one by one after the float4 loads, and
    over views one float off a 16-byte boundary (the element route), below
    and above the clip threshold (max_norm 1). The first step's pass 2
    gives the bits of `adamw_update_plain` given the kernel's norm (at
    count 1 powf and torch.pow both give b exactly, and every other step
    rounds alike); two more steps, the learning rate changed, within
    `test_clip_adamw_kernel_emulated`'s tolerances. Two runs give the same
    bits."""
    base = adamw_inputs(n, seed=n + offset, g_scale=g_scale)
    runs = [unaligned(base) if offset else {k: v.clone()
                                             for k, v in base.items()}
            for _ in range(2)]
    ref = {k: v.clone() for k, v in base.items()}
    counts = [torch.zeros((), dtype=torch.int32) for _ in range(3)]
    lr = torch.tensor(1e-3)
    for step in range(3):
        if step == 1:
            lr.fill_(3e-4)
        if step:
            g = adamw_inputs(n, seed=n + offset + step, g_scale=g_scale)["g"]
            for st in (*runs, ref):
                st["g"].copy_(g)
        norms = [adamw_emulated(libs, st, k, lr, 1.0)
                 for st, k in zip(runs, counts)]
        assert torch.equal(norms[0], norms[1])
        if step == 0:  # the same norm and the same rounding: the same bits
            adamw_plain_step(ref, counts[2], lr, 1.0, norm=norms[0].clone())
            for k in ("p", "g", "mu", "nu"):
                assert torch.equal(runs[0][k], ref[k]), k
        else:
            ref_norm = adamw_plain_step(ref, counts[2], lr, 1.0)
            torch.testing.assert_close(norms[0], ref_norm, rtol=1e-6, atol=0)
            for k in ("p", "g", "mu", "nu"):
                torch.testing.assert_close(
                    runs[0][k], ref[k], rtol=2e-6,
                    atol=2e-7 * float(ref[k].abs().max()),
                    msg=lambda m, k=k: f"{k}: {m}")
        for k in ("p", "g", "mu", "nu"):
            assert torch.equal(runs[0][k], runs[1][k]), k
        assert int(counts[0]) == int(counts[1]) == int(counts[2]) == step + 1


def test_clip_adamw_grid(libs):
    """gat_clip_adamw_grid sizes both passes to the card by the rule, at
    the shipped CNN's and MLP's parameter counts and the emulated SMs: a
    card's worth of blocks for the CNN, one round of loads over as many
    blocks as there are 256 float4 of the MLP's (20 on 132 SMs)."""
    for sms in (4, 132):
        with emulated_sms(libs, sms, "clip_adamw"):
            for n in (629743, 20143, 1):
                items = -(-n // 4)
                assert clip_adamw_grid_emulated(libs, n) == [
                    grid_rule(items, 4, sms, 1), 1, grid_rule(items, 2, sms,
                                                              1), 1]
    # the card's rule: 132 SMs, 8 resident blocks of 256 threads
    assert grid_rule(-(-20143 // 4), 2, 132, 8) == 20
    assert grid_rule(-(-629743 // 4), 2, 132, 8) == 308
    assert grid_rule(-(-629743 // 4), 4, 132, 8) == 154


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


@pytest.mark.parametrize("shape, channels_last", [
    ((3, 4, 5, 6), False), ((3, 4, 5, 6), True), ((4, 2, 48, 48), False),
    ((4, 4, 48, 48), True), ((2, 3, 4, 5), True), ((2, 8, 1, 7), False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batchnorm_kernels_emulated(libs, shape, channels_last, dtype):
    """K13's moments, apply, apply-backward and moments-backward against
    the plain version and its autograd (`check_bn_runs`): NCHW (the runs
    map; 16-byte loads along 2,304 positions, one element a load along 30
    and 7), channels-last (the rows map: 4 channels, fewer than a 16-byte
    load of bfloat16 holds), channels-last with 3 channels (which does not
    divide 256: the runs map over channels-last strides) and H = 1."""
    d = bn_inputs(shape, seed=sum(shape), dtype=dtype,
                  channels_last=channels_last)
    check_bn_runs(libs, d, dtype)


# the shipped CNN's three BatchNorm layers at a batch of 2
BN_CNN_LAYERS = ((2, 32, 64, 22), (2, 64, 32, 11), (2, 128, 16, 5))


@pytest.mark.parametrize("shape", BN_CNN_LAYERS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batchnorm_kernels_emulated_cnn_layers(libs, shape, dtype):
    """K13 at the shipped CNN's channel widths and image sizes, dense
    channels-last as cuDNN gives them (the rows map, 16-byte loads), on an
    emulated card of 8 SMs, so the sums span 8 blocks and several rounds
    of loads (`check_bn_runs`)."""
    d = bn_inputs(shape, seed=sum(shape), dtype=dtype, channels_last=True)
    with emulated_sms(libs, 8, "batchnorm_train"):
        check_bn_runs(libs, d, dtype)


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


@pytest.mark.parametrize("case", BN_LAYOUT_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batchnorm_kernels_emulated_other_layouts(libs, case, dtype):
    """K13 off the rows map's 16-byte route (`bn_layout_case`):
    contiguous NCHW (2, 8, 64, 22) (the runs map, 16-byte loads along
    1,408 positions); an incoming gradient expanded from one image (1, C,
    H, W), stride 0 along N, at the same shape: beside channels-last x
    the backward kernels take the runs map, one element a load, beside
    NCHW x the runs map's 16-byte loads; and channels-last tensors one
    element past a 16-byte boundary at the second layer (2, 64, 32, 11)
    (the rows map, one element a load, 64 channels over two warps'
    lanes). `check_bn_runs` on an emulated card of 2 SMs."""
    d = bn_layout_case(case, dtype)
    with emulated_sms(libs, 2, "batchnorm_train"):
        check_bn_runs(libs, d, dtype)


def test_batchnorm_layout_refusals():
    """The wrappers' guard refuses what the kernels cannot read in place:
    a 3-D tensor, positions not p·stride(W) apart, and for an output's
    layout a tensor neither contiguous nor channels-last; an incoming
    gradient may be expanded."""
    x = torch.zeros(2, 3, 4, 5)
    assert batchnorm.layout(x) == ((60, 20, 1), False)
    assert batchnorm.layout(x.contiguous(memory_format=torch.channels_last)
                            )[1] is False  # 3 channels: the NCHW map
    assert batchnorm.layout(torch.zeros(2, 4, 4, 5).contiguous(
        memory_format=torch.channels_last)) == ((80, 1, 4), True)
    with pytest.raises(ValueError):
        batchnorm.layout(torch.zeros(2, 3, 4))
    with pytest.raises(ValueError):
        batchnorm.layout(torch.zeros(2, 3, 5, 4).transpose(2, 3))
    with pytest.raises(ValueError):
        batchnorm.layout(torch.zeros(3, 2, 4, 5).transpose(0, 1))
    expanded = torch.ones(()).expand(2, 3, 4, 5)
    assert batchnorm.layout(expanded, read_only=True) == ((0, 0, 0), False)


def test_batchnorm_splits(libs):
    """gat_bn_splits sizes the grid to the card (`bn_splits_rule`): the
    rows map's blocks, or the runs map's splits of each channel, follow the
    rule at 4 and 132 emulated SMs for the shipped CNN's three layers at a
    step of 32 clips, both dtypes, with and without the summing kernels'
    cap; on the card's 132 SMs and 8 resident blocks the bfloat16 layers
    take 176, 132 and 132 blocks in the elementwise kernels (every SM,
    where the first design took 176, 88 and 40) and 176, 128 and 64 in the
    two that sum; channels-last with C not dividing 256 is refused (-1)."""
    fn = _fn(libs["batchnorm_train"], "gat_bn_splits",
             [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 3)
    layers = ((32, 45056), (64, 11264), (128, 2560))
    for sms in (4, 132):
        with emulated_sms(libs, sms, "batchnorm_train"):
            for c, m in layers + ((3, 9000),):
                for last, bf16, sums in itertools.product((0, 1), repeat=3):
                    if last and c == 3:
                        continue
                    assert fn(c, m, last, bf16, sums) == bn_splits_rule(
                        c, m, last, bf16, sms, 1, sums)
            assert fn(3, 1000, 1, 0, 0) == -1 and fn(3, 1000, 0, 0, 1) >= 1
            assert fn(4, 0, 0, 0, 0) == -1
    assert [[bn_splits_rule(c, m, True, 1, 132, 8, sums) for c, m in layers]
            for sums in (False, True)] == [[176, 132, 132], [176, 128, 64]]
