// K9: the polyphase resampler, x (n_src, n) float32 -> out (n_rows,
// out_len) float32, row r of out from row rows[r] of x (all rows in order
// when rows is NULL), cut or zero-padded to out_len samples.
//
// Replaces the JAX package's XLA program gat_tpu/ops/resample.py:89
// resample (a Kaiser-windowed sinc, beta 9.58, 24 zero crossings; the
// reference never wrote a Pallas kernel for it), composed with the row
// gather and fix_length the file body applies around it
// (gat_tpu/infer/pipeline.py:180: fix_length(resample(flat[sel]), L)).
// With up / down the rates' ratio in lowest terms, h the filter,
// half = (len(h) - 1) / 2, K = ceil(len(h) / up) and hp the phase table
// hp[p][k] = h[p + k·up] (zero past h), output j < m = ceil(n·up / down)
// of a row is
//   u = j·down - half,  i0 = ceil(u / up),  delta = i0·up - u,
//   y[j] = sum over k in [0, K) of x[i0 + k] · hp[delta][k],
// x being 0 outside [0, n); outputs m <= j < out_len are 0. up == 1 is the
// case delta = 0 (a plain decimation with h itself).
//
// What bounds it: bytes at the file path's rates (each row read once, each
// output written once: 2 flops a tap against about 6 bytes an output), the
// operations where K is large against down / up (48 kHz: 105 taps an
// output). The reference's routes do more than the function needs: a
// banded matrix product of 128-output super-frames that reads 351 band
// rows for 97 taps when up == 1, and a convolution that computes all up
// phase correlations at every input position (down = 320 times the
// multiply-adds at 48 kHz, into an (up, n) tensor) when up > 1. Here each
// output takes exactly its K taps, and nothing but the output is written.
//
// One block per (row, tile of kTile outputs), one launch. The block stages
// the inputs its tile reads, [i0(first), i0(last) + K), and, when the
// whole table fits beside them, the phase table, in shared memory with
// Hopper's bulk copies (csrc/bulk_copy.cuh, one mbarrier); then each
// thread computes kPerThread outputs kThreads apart (coalesced stores),
// adding each output's taps in ascending k with fmaf, so the g++ emulation
// and the card give the same bits. The block's route is a template: up == 1
// (kOnePhase: every output reads the phase-0 row, one tap load serves the
// thread's outputs, and lane groups run a tap apart so that a warp's
// samples, down floats apart, fall in distinct banks), and taps in shared
// memory or through the read-only cache (kTapsInSmem).
//
// Where the trouble is, and where it is handled:
//  1. 64-bit indices: j·down passes 2^31 at j > 6.7 M when down is 320 (a
//     400 s file at 48 kHz has m = 8.82 M), and n·up for m too: j, u, i0,
//     m and the span are long long throughout (ceil_div, stage_span,
//     resample_kernel, gat_resample).
//  2. The ceiling of a negative u: C++ `/` truncates toward zero, the
//     reference's -(-u // up) is a floor-based ceiling; ceil_div takes
//     negative u apart (the first half / down outputs of every row).
//  3. Zero padding, not clamping: the reference pads zeros on both sides,
//     so positions outside [0, n) read 0; stage_span zeroes them in shared
//     memory once the copies have landed (K8's clamped gather is not
//     reused).
//  4. Tap tables above the default 48 KB of shared memory (147 x 105 floats
//     at 48 kHz, 441 x 49 at 16 and 8 kHz, 147 x 209 at 96 kHz): the
//     dynamic shared-memory attribute of each instantiation is read and
//     only ever raised, under a lock, before its launch (raise_attribute),
//     so a later rate pair that needs less never lowers it under another's
//     launch; a table that does not fit beside the span (a ratio like
//     44099 / 44100) is read through the read-only cache instead.
//  5. Leading dimensions: the wrapper flattens (..., n) to rows (stereo
//     (2, n) is two rows, channels first) and casts to float32 once; the
//     kernel takes contiguous float32 rows.
//  6. The empty selection: the file body classifies one dummy slot when no
//     slot of a rank is picked; a launch of one row is an ordinary launch.
//     A row index outside [0, n_src) gives a row of NaN, not a read
//     outside x.
#include <cstdint>
#include <mutex>

#include "bulk_copy.cuh"
#include "dsp_common.cuh"

using namespace gat;

constexpr int kPerThread = 4;                 // outputs a thread computes
constexpr int kTile = kThreads * kPerThread;  // outputs a block computes

// The reference's ceiling of u / up (up > 0), for negative u too.
__host__ __device__ __forceinline__ long long ceil_div(long long u,
                                                       long long up) {
  return u >= 0 ? (u + up - 1) / up : -((-u) / up);
}

struct Plan {
  const float* x;     // (n_src, n)
  const int* rows;    // (n_rows,) or NULL
  const float* taps;  // (up, k_taps)
  float* out;         // (n_rows, out_len)
  long long n_src, n, m, out_len;
  int up, down, k_taps, half, n_tiles;
  int taps_floats;  // the table's floats in shared memory, 0 when read
                    // through the read-only cache
};

// The floats of shared memory a tile's inputs take, at most: i0 of its
// last output lies at most (kTile - 1)·down / up + 1 past its first's,
// the span is K past that, and the copy's rounding adds 3 floats before
// it (the phase of its first sample) and 3 after.
__host__ __device__ __forceinline__ int span_floats(int up, int down,
                                                    int k_taps) {
  const long long s = (long long)(kTile - 1) * down / up + 1 + k_taps;
  return (int)((s + 6 + 3) & ~3LL);
}

// Stages row indices [lo, hi) of `row` (a row of x, n samples) into
// xs[i - base], zero outside [0, n): one bulk copy of the 16-byte-aligned
// cover of the part inside the row, within the tensor's aligned interior
// [t_lo, t_hi) (in the row's indices), what that interior cuts off one
// float at a time, and, with the table, one bulk copy of its aligned head
// and its tail one float at a time. Every thread calls it; it returns once
// the span and the table are in shared memory.
__device__ __forceinline__ void stage_span(const Plan& p, const float* row,
                                           long long lo_need,
                                           long long hi_need, long long base,
                                           float* xs, float* taps_s,
                                           uint64_t* bar) {
  const long long row_word = (long long)((uintptr_t)row >> 2);
  const long long x_word = (long long)((uintptr_t)p.x >> 2);
  const long long t_lo = ((x_word + 3) & ~3LL) - row_word;
  const long long t_hi = ((x_word + p.n_src * p.n) & ~3LL) - row_word;
  const long long a = lo_need > 0 ? lo_need : 0;
  const long long b = hi_need < p.n ? hi_need : p.n;
  long long lo = b, hi = b;  // the bulk-copied cover
  if (a < b) {
    lo = a - ((row_word + a) & 3);
    hi = b + ((4 - ((row_word + b) & 3)) & 3);
    lo = lo > t_lo ? lo : t_lo;
    hi = hi < t_hi ? hi : t_hi;
    if (hi <= lo) lo = hi = b;
  }
  const int tab = p.taps_floats ? p.up * p.k_taps : 0;
  const int tab16 = tab & ~3;
  if (threadIdx.x == 0) {
    const unsigned span_bytes = hi > lo ? (unsigned)(4 * (hi - lo)) : 0u;
    mbar_arrive_expect(bar, span_bytes + 4u * (unsigned)tab16);
    if (span_bytes) bulk_load(xs + (lo - base), row + lo, span_bytes, bar);
    if (tab16) bulk_load(taps_s, p.taps, 4u * (unsigned)tab16, bar);
  }
  // in the row, outside the cover; the table's tail
  for (long long i = a + threadIdx.x; i < b && i < lo; i += kThreads)
    xs[i - base] = row[i];
  for (long long i = (hi > a ? hi : a) + threadIdx.x; i < b; i += kThreads)
    xs[i - base] = row[i];
  for (int i = tab16 + threadIdx.x; i < tab; i += kThreads)
    taps_s[i] = p.taps[i];
  mbar_wait(bar, 0);
  // zeros outside the row, over what the copy may have brought there
  const long long z0 = lo_need < 0 ? (hi_need < 0 ? hi_need : 0) : lo_need;
  for (long long i = lo_need + threadIdx.x; i < z0; i += kThreads)
    xs[i - base] = 0.0f;
  for (long long i = (p.n > lo_need ? p.n : lo_need) + threadIdx.x;
       i < hi_need; i += kThreads)
    xs[i - base] = 0.0f;
  __syncthreads();
}

template <bool kOnePhase, bool kTapsInSmem>
__global__ void __launch_bounds__(kThreads)
resample_kernel(Plan p) {
  extern __shared__ float smem[];
  const long long r = (long long)blockIdx.x / p.n_tiles;
  const long long j_first = (long long)blockIdx.x % p.n_tiles * kTile;
  float* dst = p.out + r * p.out_len;
  const long long eff = p.m < p.out_len ? p.m : p.out_len;
  const long long src = p.rows ? (long long)p.rows[r] : r;
  const bool bad_row = src < 0 || src >= p.n_src;
  if (j_first >= eff || bad_row) {  // a tile of zeros past m, or NaN
    const float v = bad_row ? __int_as_float(0x7fc00000) : 0.0f;
    for (int s = 0; s < kPerThread; ++s) {
      const long long j = j_first + threadIdx.x + s * kThreads;
      if (j < p.out_len) dst[j] = v;
    }
    return;
  }
  const long long j_last = (j_first + kTile < eff ? j_first + kTile : eff) - 1;
  const long long span_lo = ceil_div(j_first * p.down - p.half, p.up);
  const long long span_hi =
      ceil_div(j_last * p.down - p.half, p.up) + p.k_taps;
  const float* row = p.x + src * p.n;
  // xs[q] holds row index base + q, base the span's first index rounded
  // down to 16 bytes, so the cover's copy lands 16-byte aligned
  const long long base =
      span_lo - (((long long)((uintptr_t)row >> 2) + span_lo) & 3);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* taps_s = smem + 4;
  float* xs = taps_s + p.taps_floats;
  if (threadIdx.x == 0) mbar_init(bar, 1);
  __syncthreads();
  stage_span(p, row, span_lo, span_hi, base, xs, taps_s, bar);

  const float* taps = kTapsInSmem ? taps_s : p.taps;
  float acc[kPerThread];
  int off[kPerThread];
  const float* tp[kPerThread];
  for (int s = 0; s < kPerThread; ++s) {
    long long j = j_first + threadIdx.x + s * kThreads;
    j = j < j_last ? j : j_last;  // past the tile's end: computed, not stored
    const long long u = j * p.down - p.half;
    const long long i0 = ceil_div(u, p.up);
    off[s] = (int)(i0 - base);
    tp[s] = taps + (kOnePhase ? 0 : (i0 * p.up - u) * p.k_taps);
    acc[s] = 0.0f;
  }
  if (kOnePhase) {
    // a warp's lanes read samples `down` floats apart, so lanes 32 / g
    // apart (g = gcd(down, 32)) would share a bank; lane group q of the g
    // runs q taps behind the first, which puts the warp's samples of one
    // step in 32 distinct banks and its taps in g neighbouring words.
    // Each output still adds its taps in ascending k.
    const int g = (p.down & -p.down) < 32 ? (p.down & -p.down) : 32;
    const int lag = (int)(threadIdx.x & 31) / (32 / g);
#pragma unroll 4
    for (int i = 0; i < p.k_taps + g - 1; ++i) {
      const int k = i - lag;
      if (k >= 0 && k < p.k_taps) {
        const float h = kTapsInSmem ? taps[k] : __ldg(taps + k);
        for (int s = 0; s < kPerThread; ++s)
          acc[s] = fmaf(xs[off[s] + k], h, acc[s]);
      }
    }
  } else {
#pragma unroll 4
    for (int k = 0; k < p.k_taps; ++k)
      for (int s = 0; s < kPerThread; ++s) {
        const float h = kTapsInSmem ? tp[s][k] : __ldg(tp[s] + k);
        acc[s] = fmaf(xs[off[s] + k], h, acc[s]);
      }
  }
  for (int s = 0; s < kPerThread; ++s) {
    const long long j = j_first + threadIdx.x + s * kThreads;
    if (j < p.out_len) dst[j] = j <= j_last ? acc[s] : 0.0f;
  }
}

// The shared memory of a launch at these rates, and whether the table
// takes part of it: 16 bytes for the barrier, the table rounded to 16
// bytes when it fits beside the span, the span. -1 when the span alone
// does not fit.
static long long smem_bytes(int up, int down, int k_taps, int* taps_floats) {
  const long long span = 4LL * span_floats(up, down, k_taps);
  const long long tab = 4LL * (((long long)up * k_taps + 3) & ~3LL);
  *taps_floats = 0;
  if (16 + span > (long long)kMaxBlockSmem) return -1;
  const bool fits = 16 + tab + span <= (long long)kMaxBlockSmem;
  if (fits) *taps_floats = (int)(tab / 4);
  return 16 + span + (fits ? tab : 0);
}

// The instantiation a launch at these rates runs.
using Kernel = void (*)(Plan);
static Kernel kernel_for(int up, bool taps_in_smem) {
  if (up == 1)
    return taps_in_smem ? resample_kernel<true, true>
                        : resample_kernel<true, false>;
  return taps_in_smem ? resample_kernel<false, true>
                      : resample_kernel<false, false>;
}

static std::mutex attribute_lock;

// Raises the kernel's dynamic shared-memory attribute to `bytes` if it
// holds less, never lowers it (a launch of another rate pair may need
// more). Called under attribute_lock.
static int raise_attribute(Kernel kernel, long long bytes) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  if (attr.maxDynamicSharedSizeBytes < bytes)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
  return (int)err;
}

// Resamples rows of x (n_src rows of n samples) by up / down with the
// phase table `taps` (up x k_taps float32) of a filter whose centre is
// `half`: row r of out (n_rows x out_len) from row rows[r] of x (rows
// NULL: row r, n_rows == n_src), cut or zero-padded to out_len samples.
extern "C" int gat_resample(const float* x, const int* rows,
                            const float* taps, float* out, int n_src, int n,
                            int n_rows, int out_len, int up, int down,
                            int k_taps, int half, void* stream) {
  if (n_src < 1 || n < 1 || n_rows < 1 || out_len < 1 || up < 1 ||
      down < 1 || k_taps < 1 || half < 0 || (!rows && n_rows != n_src))
    return (int)cudaErrorInvalidValue;
  Plan p;
  p.x = x;
  p.rows = rows;
  p.taps = taps;
  p.out = out;
  p.n_src = n_src;
  p.n = n;
  p.m = ((long long)n * up + down - 1) / down;
  p.out_len = out_len;
  p.up = up;
  p.down = down;
  p.k_taps = k_taps;
  p.half = half;
  p.n_tiles = (out_len + kTile - 1) / kTile;
  const long long bytes = smem_bytes(up, down, k_taps, &p.taps_floats);
  const long long grid = (long long)n_rows * p.n_tiles;
  if (bytes < 0 || grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Kernel kernel = kernel_for(up, p.taps_floats > 0);
  std::lock_guard<std::mutex> guard(attribute_lock);
  const int status = raise_attribute(kernel, bytes);
  if (status != 0) return status;
  kernel<<<(int)grid, kThreads, (size_t)bytes, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the launch at these rates, as the CUDA runtime
// computes it; raises the attribute as a launch does (never lowers it).
extern "C" int gat_resample_blocks_per_sm(int up, int down, int k_taps,
                                          int* blocks) {
  if (up < 1 || down < 1 || k_taps < 1) return (int)cudaErrorInvalidValue;
  int taps_floats = 0;
  const long long bytes = smem_bytes(up, down, k_taps, &taps_floats);
  if (bytes < 0) return (int)cudaErrorInvalidValue;
  const Kernel kernel = kernel_for(up, taps_floats > 0);
  std::lock_guard<std::mutex> guard(attribute_lock);
  const int err = raise_attribute(kernel, bytes);
  if (err != 0) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, kThreads, (size_t)bytes);
}

// A launch's layout at these rates: the outputs a block computes, the
// floats of its staged span and of its table in shared memory (0: read
// through the read-only cache) and its shared memory in bytes (-1 when the
// span does not fit a block).
extern "C" int gat_resample_layout(int up, int down, int k_taps, int* tile,
                                   int* span, int* taps_floats,
                                   int* bytes) {
  if (up < 1 || down < 1 || k_taps < 1) return (int)cudaErrorInvalidValue;
  *tile = kTile;
  *span = span_floats(up, down, k_taps);
  *bytes = (int)smem_bytes(up, down, k_taps, taps_floats);
  return 0;
}
