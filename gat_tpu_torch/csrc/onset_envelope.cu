// K4: the onset envelope of whole files, y (B, n) -> env (B, T),
// T = 1 + n / hop.
//
// Replaces the JAX package's XLA program gat_tpu/ops/onset.py::
// onset_strength (librosa.onset.onset_strength). Per file:
//   1. zero center pad of n_fft / 2, hop-`hop` periodic-Hann frames, a
//      2048-point DFT, |X|^2 on the 1025 rfft bins;
//   2. the Slaney mel projection (n_mels bands at the file's rate);
//   3. 10*log10(max(., 1e-10)), clamped at peak - top_db, with the peak
//      over the file's valid frames t < nvf only;
//   4. the positive lag difference, averaged over the bands;
//   5. shifted right by `shift` = lag + n_fft / (2 hop) frames with zeros
//      in front, cut to T.
//
// Three C entry points: gat_onset_envelope runs both passes over centred
// files; gat_onset_mel_db runs pass 1 alone (steps 1-2, the pre-clamp dB
// and each file's peak key) with frame 0 at a given sample `origin`, and
// gat_onset_flux pass 2 alone (steps 3-5) over given dB rows and peak
// keys. The time-sharded envelope (parallel/timeshard.py) runs pass 1 on
// each shard, takes the peak over all of them, and pass 2 on the
// gathered rows.
//
// What bounds it: fp32 operations. Each frame needs one real-input
// 2048-point FFT and a sparse 128-band mel (about 70 k flops) against
// 2 KB of new samples. The transform is K1's and K2's (fft_stockham.cuh:
// two frames per complex FFT, register Stockham passes; kInFlight = 4
// frames a round, mel_rounds.cuh), and the spectrum never leaves the
// block.
//
// What the design does about it:
//   - The grid is sized to the card, not to the files. The unit of work is
//     a round: kInFlight frames of one file. The caller passes the grid
//     (the SMs times the resident blocks per SM); each block takes an
//     equal, contiguous share of all (file, round) pairs. One 4 s file (44
//     rounds) spreads over 44 blocks, and 64 files of 8 s (5,568 rounds)
//     over one wave of blocks of 14 or 15 rounds instead of a wave and a
//     third of 8-round blocks.
//   - A block's rounds are consecutive frames, so it copies the next
//     round's samples into shared memory (cp.async) while it computes the
//     current one; read at the start of a round, they would stall it for
//     a trip to device memory. With that stage, 80 registers (3 blocks per
//     SM) ran faster than 64 (4 blocks per SM), which spilled.
//   - The file's peak needs every frame, so pass 1 writes the pre-clamp
//     dB to a (B, T, n_mels) scratch and folds each block's maximum over
//     its valid frames into a (B,) buffer by atomicMax on an order-
//     preserving integer key. A max is exact in any order, so the result
//     does not depend on the grid. Pass 2, one warp per output frame,
//     clamps, differences and averages.
//   - The mel stage is balanced by nonzeros. Slaney band widths at 128
//     bands run from 4 to 53 bins; the host cuts the 2,018 nonzero
//     weights into kThreads runs of equal length (ops/onset.py::
//     _mel_items), so no thread sums more than ceil(nnz / kThreads) = 8
//     weights for the four frames, in a loop unrolled over kMelRun.
//   - The shared-memory attribute is not set on every launch. It is one
//     value per kernel and device, so the occupancy entry point, which
//     the wrapper calls once per device, item count and hop before the
//     first launch there, raises it to that hop's bytes and never lowers
//     it: a launch at any hop finds room, whatever hops ran before.
#include <cuda_pipeline.h>

#include <cmath>

#include "mel_rounds.cuh"

using namespace gat;

constexpr int kFluxFrames = kThreads / 32;  // output frames per pass-2 block
constexpr int kMelRun = 8;  // most mel weights a thread sums (_MEL_RUN)

// An int whose signed order is the float's order, and back; the key of
// -inf is what the caller fills the peak buffer with.
__device__ __forceinline__ int order_key(float v) {
  const int i = __float_as_int(v);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float key_value(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// The samples a round reads: kInFlight frames of kFFT, hop apart.
__host__ __device__ constexpr int round_span(int hop) {
  return (kInFlight - 1) * hop + kFFT;
}

static size_t mel_db_smem_bytes(int n_items, int hop) {
  return sizeof(float) *
         (size_t)(4 * kFFT + kInFlight * n_items + round_span(hop));
}

// Starts copying the samples of the round at frame t0 of `clip` into
// `stage`: sample origin + t0 * hop + s at stage[s], zeros outside the
// clip. The copies (cp.async) land while the block computes; every
// thread waits for its own with __pipeline_wait_prior(0), then the block
// synchronizes before reading.
__device__ __forceinline__ void stage_round(const float* __restrict__ clip,
                                            int n_samples, int hop,
                                            int origin, int t0,
                                            float* stage) {
  const int first = origin + t0 * hop;
  for (int s = threadIdx.x; s < round_span(hop); s += kThreads) {
    const int i = first + s;
    if (i >= 0 && i < n_samples)
      __pipeline_memcpy_async(stage + s, clip + i, sizeof(float));
    else
      stage[s] = 0.0f;
  }
  __pipeline_commit();
}

// tab: thread_first[kThreads + 1] (the first mel item of thread i),
// band_first[n_mels + 1] (band m's items, in order), then per nonzero
// weight e, band after band, its bin plus 2^16 where its band ends.
// Thread i sums weights [i * run, (i + 1) * run), run = ceil(nnz /
// kThreads); an item is a piece of that run within one band.
__global__ void __launch_bounds__(kThreads, 3)
onset_mel_db_kernel(const float* __restrict__ y, float* __restrict__ db,
                    int* __restrict__ peak_key,
                    const float* __restrict__ hann,
                    const float* __restrict__ tw,
                    const int* __restrict__ tab,
                    const float* __restrict__ weights, int nnz,
                    int n_items, const int* __restrict__ nvf,
                    int n_samples, int hop, int origin, int n_frames,
                    int n_mels, int n_files) {
  extern __shared__ float smem[];
  float* xre = smem;                  // 2 transforms x kFFT
  float* xim = xre + 2 * kFFT;        // 2 transforms x kFFT
  float* power = smem;                // kInFlight x kBins, over xre / xim
  float* partial = xim + 2 * kFFT;    // kInFlight x n_items
  float* stage = partial + kInFlight * n_items;  // round_span(hop)
  const int* band_first = tab + kThreads + 1;
  const int* codes = band_first + n_mels + 1;
  const int item_begin = tab[threadIdx.x];
  const int run = (nnz + kThreads - 1) / kThreads;
  const int e0 = threadIdx.x * run;
  const int my_run = nnz - e0 < run ? nnz - e0 : run;  // <= 0: idle

  const int g = threadIdx.x / kFFTThreads;  // transform of this thread
  const int j = threadIdx.x % kFFTThreads;
  float* re = xre + g * kFFT;
  float* im = xim + g * kFFT;

  // this block's share of the (file, round) pairs, file-major
  const int rounds = (n_frames + kInFlight - 1) / kInFlight;
  const long long total = (long long)n_files * rounds;
  const int w_begin = (int)(total * blockIdx.x / gridDim.x);
  const int w_end = (int)(total * (blockIdx.x + 1) / gridDim.x);
  int file = w_begin / rounds;
  float peak = -INFINITY;
  if (w_begin < w_end)
    stage_round(y + (size_t)file * n_samples, n_samples, hop, origin,
                (w_begin - file * rounds) * kInFlight, stage);
  for (int w = w_begin; w < w_end; ++w) {
    if (w / rounds != file) {  // block-uniform: every thread is here
      const float p = block_max(peak, smem);
      if (threadIdx.x == 0) atomicMax(peak_key + file, order_key(p));
      file = w / rounds;
      peak = -INFINITY;
    }
    const int t0 = (w - file * rounds) * kInFlight;
    const int end = t0 + kInFlight < n_frames ? t0 + kInFlight : n_frames;
    const int valid_end = nvf ? nvf[file] : n_frames;
    float* out = db + (size_t)file * n_frames * n_mels;

    // frames t0 + 2g (real part) and t0 + 2g + 1 (imaginary), from the
    // staged samples
    const bool has_a = t0 + 2 * g < end, has_b = t0 + 2 * g + 1 < end;
    const float* sa = stage + 2 * g * hop;
    __pipeline_wait_prior(0);
    __syncthreads();
    float vr[16], vi[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int n = j + kFFTThreads * r;
      const float wn = hann[n];
      vr[r] = has_a ? sa[n] * wn : 0.0f;
      vi[r] = has_b ? sa[hop + n] * wn : 0.0f;
    }
    fft2048_stockham(vr, vi, re, im, tw, j);
    // the transform's first barrier follows every read of the stage:
    // the next round's samples may land there now
    if (w + 1 < w_end) {
      const int f1 = (w + 1) / rounds;
      stage_round(y + (size_t)f1 * n_samples, n_samples, hop, origin,
                  (w + 1 - f1 * rounds) * kInFlight, stage);
    }
    __syncthreads();  // the last pass has read the exchange buffer
    split_power_bins(vr, vi, j, power + 2 * g * kBins,
                     power + (2 * g + 1) * kBins);
    __syncthreads();

    // mel partial sums: this thread's run of weights for the four frames
    // at once, unrolled so that its loads are in flight together; a
    // partial sum closes where a band ends and where the run ends
    {
      int code[kMelRun];
      float wk[kMelRun];
#pragma unroll
      for (int q = 0; q < kMelRun; ++q) {
        code[q] = q < my_run ? codes[e0 + q] : 0;
        wk[q] = q < my_run ? weights[e0 + q] : 0.0f;
      }
      float acc[kInFlight] = {};
      int it = item_begin;
#pragma unroll
      for (int q = 0; q < kMelRun; ++q) {
        const int k = code[q] & 0xffff;
#pragma unroll
        for (int f = 0; f < kInFlight; ++f)
          acc[f] += wk[q] * power[f * kBins + k];
        if (q < my_run && ((code[q] >> 16) || q == my_run - 1)) {
#pragma unroll
          for (int f = 0; f < kInFlight; ++f) {
            partial[f * n_items + it] = acc[f];
            acc[f] = 0.0f;
          }
          ++it;
        }
      }
    }
    __syncthreads();

    // one thread per (band, frame) sums the band's items in order; the
    // bands of one frame go to neighbouring threads and addresses
    for (int i = threadIdx.x; i < n_mels * kInFlight; i += kThreads) {
      const int m = i % n_mels, f = i / n_mels, t = t0 + f;
      if (t >= end) continue;
      const float* q = partial + f * n_items;
      float v = 0.0f;
      for (int it = band_first[m]; it < band_first[m + 1]; ++it) v += q[it];
      // the split's (1/2)^2, as power_scale(..., normalize = 0) applies it
      const float d = 10.0f * log10f(fmaxf(v * 0.25f, 1e-10f));
      out[(size_t)t * n_mels + m] = d;
      if (t < valid_end) peak = fmaxf(peak, d);
    }
  }
  if (w_begin < w_end) {
    // the exchange buffer is free: the rounds' last reads of it are done
    const float p = block_max(peak, smem);
    if (threadIdx.x == 0) atomicMax(peak_key + file, order_key(p));
  }
}

// One warp per output frame t: lane l sums the bands l, l + 32, ... of
// the clamped positive difference, then one lane adds the 32 sums in
// order.
__global__ void __launch_bounds__(kThreads)
onset_flux_kernel(const float* __restrict__ db,
                  const int* __restrict__ peak_key, float* __restrict__ env,
                  int n_frames, int n_mels, int lag, int shift,
                  float top_db) {
  extern __shared__ float smem[];  // kThreads lane sums
  const int blocks_per_file = (n_frames + kFluxFrames - 1) / kFluxFrames;
  const int file = blockIdx.x / blocks_per_file;
  const int lane = threadIdx.x % 32;
  const int t = (blockIdx.x % blocks_per_file) * kFluxFrames +
                threadIdx.x / 32;
  // output frame t >= shift is the flux from frame j = t - shift to j + lag
  const int j = t - shift;
  float acc = 0.0f;
  if (t < n_frames && j >= 0) {
    const float floor_db = key_value(peak_key[file]) - top_db;
    const float* a = db + ((size_t)file * n_frames + j) * n_mels;
    const float* b = a + (size_t)lag * n_mels;
    for (int m = lane; m < n_mels; m += 32)
      acc += fmaxf(fmaxf(b[m], floor_db) - fmaxf(a[m], floor_db), 0.0f);
  }
  smem[threadIdx.x] = acc;
  __syncthreads();
  if (lane == 0 && t < n_frames) {
    float s = 0.0f;
    for (int l = 0; l < 32; ++l) s += smem[threadIdx.x + l];
    env[(size_t)file * n_frames + t] = j < 0 ? 0.0f : s / (float)n_mels;
  }
}

// Pass 1 alone: frame t of file f starts at sample origin + t * hop of
// its row (zeros outside it), its pre-clamp dB goes to db (B, T, n_mels)
// and the maximum over its valid frames t < nvf[f] to peak_key[f], which
// must hold the key of -inf (ops/onset.py::_NEG_INF_KEY); `grid` is the
// number of blocks (at most one per round).
static int launch_mel_db(const float* y, float* db, int* peak_key,
                         const float* hann, const float* tw, const int* tab,
                         const float* weights, int nnz, int n_items,
                         const int* nvf, int n_files, int n_samples, int hop,
                         int origin, int n_frames, int n_mels, int grid,
                         cudaStream_t stream) {
  if (n_frames < 1 || grid < 1 || nnz > kMelRun * kThreads)
    return (int)cudaErrorInvalidValue;
  const long long rounds =
      (long long)n_files * ((n_frames + kInFlight - 1) / kInFlight);
  if (rounds < grid) grid = (int)rounds;
  onset_mel_db_kernel<<<grid, kThreads, mel_db_smem_bytes(n_items, hop),
                        stream>>>(y, db, peak_key, hann, tw, tab, weights,
                                  nnz, n_items, nvf, n_samples, hop, origin,
                                  n_frames, n_mels, n_files);
  return (int)cudaGetLastError();
}

// Pass 2 alone: the clamped, lagged, band-averaged flux of db (B, T,
// n_mels) under each file's peak key, shifted right by `shift` frames.
static int launch_flux(const float* db, const int* peak_key, float* env,
                       int n_files, int n_frames, int n_mels, int lag,
                       int shift, float top_db, cudaStream_t stream) {
  // pass 2 reads frames j + lag <= T - 1 - shift + lag
  if (lag < 1 || shift < lag || lag >= n_frames)
    return (int)cudaErrorInvalidValue;
  const int flux_blocks = (n_frames + kFluxFrames - 1) / kFluxFrames;
  onset_flux_kernel<<<n_files * flux_blocks, kThreads,
                      sizeof(float) * kThreads, stream>>>(
      db, peak_key, env, n_frames, n_mels, lag, shift, top_db);
  return (int)cudaGetLastError();
}

// Both passes over centred files (frame t starts at t * hop - n_fft / 2).
// peak_key (B,) must hold the key of -inf (ops/onset.py::_NEG_INF_KEY);
// `grid` is the number of pass-1 blocks (at most one per round).
extern "C" int gat_onset_envelope(const float* y, float* env, float* db,
                                  int* peak_key, const float* hann,
                                  const float* tw, const int* tab,
                                  const float* weights, int nnz,
                                  int n_items, const int* nvf, int n_files,
                                  int n_samples,
                                  int hop, int n_frames, int n_mels, int lag,
                                  int shift, float top_db, int grid,
                                  void* stream) {
  if (lag < 1 || shift < lag || lag >= n_frames)
    return (int)cudaErrorInvalidValue;
  const int err = launch_mel_db(y, db, peak_key, hann, tw, tab, weights, nnz,
                                n_items, nvf, n_files, n_samples, hop,
                                -kFFT / 2, n_frames, n_mels, grid,
                                (cudaStream_t)stream);
  if (err != 0) return err;
  return launch_flux(db, peak_key, env, n_files, n_frames, n_mels, lag,
                     shift, top_db, (cudaStream_t)stream);
}

// Pass 1 alone, with frame 0 at sample `origin` of each row: -n_fft / 2
// for a centred file, 0 for a time shard that carries its own left
// context and its right halo (parallel/timeshard.py).
extern "C" int gat_onset_mel_db(const float* y, float* db, int* peak_key,
                                const float* hann, const float* tw,
                                const int* tab, const float* weights, int nnz,
                                int n_items, const int* nvf, int n_files,
                                int n_samples, int hop, int n_frames,
                                int n_mels, int origin, int grid,
                                void* stream) {
  return launch_mel_db(y, db, peak_key, hann, tw, tab, weights, nnz, n_items,
                       nvf, n_files, n_samples, hop, origin, n_frames, n_mels,
                       grid, (cudaStream_t)stream);
}

// Pass 2 alone, over given dB rows and peak keys.
extern "C" int gat_onset_flux(const float* db, const int* peak_key,
                              float* env, int n_files, int n_frames,
                              int n_mels, int lag, int shift, float top_db,
                              void* stream) {
  return launch_flux(db, peak_key, env, n_files, n_frames, n_mels, lag, shift,
                     top_db, (cudaStream_t)stream);
}

// Resident blocks per SM of pass 1 (the FFT work) for n_items mel items
// and this hop, as the CUDA runtime computes it from registers and shared
// memory. Raises pass 1's shared-memory attribute to this hop's bytes when
// it holds less, and never lowers it; a launch does not set it.
extern "C" int gat_onset_envelope_blocks_per_sm(int n_items, int hop,
                                                int* blocks) {
  const int bytes = (int)mel_db_smem_bytes(n_items, hop);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, onset_mel_db_kernel);
  if (err != cudaSuccess) return (int)err;
  if (attr.maxDynamicSharedSizeBytes < bytes) {
    err = cudaFuncSetAttribute(onset_mel_db_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, onset_mel_db_kernel, kThreads, bytes);
}
