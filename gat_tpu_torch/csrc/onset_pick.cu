// K5: the onset pick of whole files, env (B, T) -> onset samples
// (B, max_onsets), valid, overflow, cap_overflow, n_kept.
//
// Replaces the JAX package's XLA program gat_tpu/ops/onset.py::
// pick_onsets_from_envelope, which runs its greedy walk as a lax.scan.
// Per file, over its valid frames t < nvf:
//   1. min-max normalization;
//   2. librosa.util.peak_pick's candidates: the frame equals the moving
//      max (window [t - left, t - left + size), padded with the valid
//      minimum), is at least the moving average (librosa's truncated
//      window [t - pre_avg, t + post_avg) cut at nvf, from one prefix sum
//      of the mean-centred envelope, which keeps the sum near zero however
//      long the file) plus delta, and is nonzero;
//   3. energy-minimum backtracking: for each frame the latest frame at or
//      before it with e[i] <= e[i-1] and e[i] < e[i+1] (frame 0 always,
//      the last valid frame never), a max-scan;
//   4. the earliest `cand_limit` candidates compacted into a list;
//   5. the greedy walk: a candidate more than `wait` frames after the last
//      accepted peak is a peak; its backtracked sample is kept when it is
//      at least `min_samples` after the last kept one;
//   6. whether a truncated candidate list could have changed the result:
//      the latest raw candidate dominates every dropped one (largest frame,
//      and largest backtracked sample, bt being a cummax).
// The kept samples come out of the walk in nondecreasing order (bt is a
// cummax and min_samples >= 0), so they are written as they come, with no
// sort.
//
// What bounds it: a file's envelope is a few KB and the walk a few hundred
// dependent steps, so neither the card's memory rate nor its operation
// rate does; the time is latency: the block's barriers and the one-thread
// walk. The design keeps everything in shared memory, runs the
// data-parallel steps over all 256 threads with block scans (a sequential
// segment per thread, then a Hillis-Steele scan of the 256 totals), and
// walks only the compacted candidates, not every frame. One block per
// file; files run in parallel. Shared memory: 16 bytes per frame plus 1 KB
// (41 KB at 2584 frames, a 60 s file at hop 512).
#include <cmath>

#include "dsp_common.cuh"

using namespace gat;

constexpr float kTiny = 1.1754944e-38f;  // np.finfo(np.float32).tiny

static size_t pick_smem_bytes(int n_frames) {
  return sizeof(float) * (size_t)(kThreads + 4 * n_frames + 1);
}

template <class T, class Op>
__device__ __forceinline__ T block_reduce(T v, T* scratch, Op op) {
  scratch[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s)
      scratch[threadIdx.x] =
          op(scratch[threadIdx.x], scratch[threadIdx.x + s]);
    __syncthreads();
  }
  const T r = scratch[0];
  __syncthreads();
  return r;
}

// Inclusive scan of a[0..n) in place: each thread scans a contiguous
// segment, a Hillis-Steele scan combines the 256 segment totals, and each
// segment adds the total before it.
template <class T, class Op>
__device__ __forceinline__ void block_scan(T* a, int n, T identity,
                                           T* totals, Op op) {
  const int per = (n + kThreads - 1) / kThreads;
  const int b0 = threadIdx.x * per < n ? threadIdx.x * per : n;
  const int b1 = b0 + per < n ? b0 + per : n;
  T acc = identity;
  for (int i = b0; i < b1; ++i) {
    acc = op(acc, a[i]);
    a[i] = acc;
  }
  totals[threadIdx.x] = acc;
  __syncthreads();
  for (int s = 1; s < kThreads; s <<= 1) {
    const T v = threadIdx.x >= s ? totals[threadIdx.x - s] : identity;
    __syncthreads();
    totals[threadIdx.x] = op(v, totals[threadIdx.x]);
    __syncthreads();
  }
  const T off = threadIdx.x > 0 ? totals[threadIdx.x - 1] : identity;
  if (threadIdx.x > 0)
    for (int i = b0; i < b1; ++i) a[i] = op(off, a[i]);
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
onset_pick_kernel(const float* __restrict__ env, const int* __restrict__ nvf,
                  int* __restrict__ onsets, unsigned char* __restrict__ valid,
                  unsigned char* __restrict__ overflow,
                  unsigned char* __restrict__ cap_overflow,
                  int* __restrict__ n_kept, int n_frames, int size, int left,
                  int pre_avg, int post_avg, float delta, int wait, int hop,
                  int min_samples, int max_onsets, int cand_limit,
                  int backtrack) {
  extern __shared__ float smem[];
  float* red = smem;                                   // kThreads
  int* ired = reinterpret_cast<int*>(smem);            // kThreads, same
  float* en = smem + kThreads;                         // n_frames
  float* csum = en + n_frames;                         // n_frames + 1
  int* list = reinterpret_cast<int*>(csum);            // over csum, later
  int* bt = reinterpret_cast<int*>(csum + n_frames + 1);  // n_frames
  int* cpos = bt + n_frames;                           // n_frames

  const int t = n_frames, file = blockIdx.x;
  int nv = nvf[file];
  nv = nv < 0 ? 0 : (nv > t ? t : nv);
  const float* e = env + (size_t)file * t;
  auto fmin_op = [](float a, float b) { return fminf(a, b); };
  auto fmax_op = [](float a, float b) { return fmaxf(a, b); };
  auto fadd_op = [](float a, float b) { return a + b; };
  auto iadd_op = [](int a, int b) { return a + b; };
  auto imax_op = [](int a, int b) { return a > b ? a : b; };

  // 1. normalization over the valid frames
  float lo = INFINITY, hi = -INFINITY;
  for (int i = threadIdx.x; i < nv; i += kThreads) {
    lo = fminf(lo, e[i]);
    hi = fmaxf(hi, e[i]);
  }
  const float emin = block_reduce(lo, red, fmin_op);
  const float emax = block_reduce(hi, red, fmax_op);
  const float denom = emax - emin + kTiny;
  for (int i = threadIdx.x; i < t; i += kThreads)
    en[i] = (e[i] - emin) / denom;
  __syncthreads();

  // the valid minimum (the moving max's pad), the valid mean, and the
  // prefix sum of the mean-centred envelope
  lo = INFINITY;
  float sum = 0.0f;
  for (int i = threadIdx.x; i < nv; i += kThreads) {
    lo = fminf(lo, en[i]);
    sum += en[i];
  }
  const float x_min = block_reduce(lo, red, fmin_op);
  const float x_mean =
      block_reduce(sum, red, fadd_op) / (float)(nv > 1 ? nv : 1);
  for (int i = threadIdx.x; i < t; i += kThreads)
    csum[i + 1] = i < nv ? en[i] - x_mean : 0.0f;
  if (threadIdx.x == 0) csum[0] = 0.0f;
  __syncthreads();
  block_scan(csum + 1, t, 0.0f, red, fadd_op);

  // 2-3. candidates, backtrack minima, and the latest raw candidate
  int i_max = -1;
  for (int i = threadIdx.x; i < t; i += kThreads) {
    float mov_max = -INFINITY;
    for (int k = 0; k < size; ++k) {
      const int j = i - left + k;
      mov_max = fmaxf(mov_max, (j >= 0 && j < nv) ? en[j] : x_min);
    }
    int a = i - pre_avg, b = i + post_avg;
    a = a < 0 ? 0 : (a > nv ? nv : a);
    b = b < 0 ? 0 : (b > nv ? nv : b);
    const float mov_avg =
        x_mean + (csum[b] - csum[a]) / (float)(b - a > 1 ? b - a : 1);
    const float det = en[i] == mov_max ? en[i] : 0.0f;
    const bool cand = det != 0.0f && det >= mov_avg + delta && i < nv;
    cpos[i] = cand ? 1 : 0;
    if (cand) i_max = i;
    bool minimum = i == 0;
    if (i > 0 && i < t - 1)
      minimum = en[i] <= en[i - 1] && en[i] < en[i + 1] && i + 1 < nv;
    bt[i] = backtrack ? (minimum ? i : -1) : i;
  }
  i_max = block_reduce(i_max, ired, imax_op);
  block_scan(bt, t, -1, ired, imax_op);
  block_scan(cpos, t, 0, ired, iadd_op);
  const int n_raw = cpos[t - 1];

  // 4. the earliest cand_limit candidates, in frame order, over csum
  for (int i = threadIdx.x; i < t; i += kThreads) {
    const int r = cpos[i] - 1;
    const bool cand = cpos[i] - (i > 0 ? cpos[i - 1] : 0) == 1;
    if (cand && r < cand_limit) list[r] = i;
  }
  __syncthreads();

  // 5-6. the greedy walk, by one thread
  if (threadIdx.x == 0) {
    const int n_scan = n_raw < cand_limit ? n_raw : cand_limit;
    int last_frame = -1000000000, last_sample = -999999, kept = 0;
    int* out = onsets + (size_t)file * max_onsets;
    for (int r = 0; r < n_scan; ++r) {
      const int i = list[r];
      if (i > last_frame + wait) {
        last_frame = i;
        const int s = bt[i] * hop;
        if (s - last_sample >= min_samples) {
          if (kept < max_onsets) out[kept] = s;
          ++kept;
          last_sample = s;
        }
      }
    }
    const int s_max = bt[i_max > 0 ? i_max : 0] * hop;
    const bool could_differ =
        i_max > last_frame + wait && s_max - last_sample >= min_samples;
    const bool cap = kept > max_onsets;
    overflow[file] = (n_raw > cand_limit && could_differ) || cap;
    cap_overflow[file] = cap;
    n_kept[file] = kept;
    unsigned char* v = valid + (size_t)file * max_onsets;
    for (int j = 0; j < max_onsets; ++j) {
      v[j] = j < kept;
      if (j >= kept) out[j] = 0;
    }
  }
}

static cudaError_t pick_set_attributes(int n_frames) {
  return cudaFuncSetAttribute(onset_pick_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)pick_smem_bytes(n_frames));
}

extern "C" int gat_onset_pick(const float* env, const int* nvf, int* onsets,
                              unsigned char* valid, unsigned char* overflow,
                              unsigned char* cap_overflow, int* n_kept,
                              int n_files, int n_frames, int size, int left,
                              int pre_avg, int post_avg, float delta,
                              int wait, int hop, int min_samples,
                              int max_onsets, int cand_limit, int backtrack,
                              void* stream) {
  if (n_frames < 2 || size < 1 || left < 0 || left >= size ||
      max_onsets < 1 || cand_limit < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = pick_set_attributes(n_frames);
  if (err != cudaSuccess) return (int)err;
  onset_pick_kernel<<<n_files, kThreads, pick_smem_bytes(n_frames),
                      (cudaStream_t)stream>>>(
      env, nvf, onsets, valid, overflow, cap_overflow, n_kept, n_frames,
      size, left, pre_avg, post_avg, delta, wait, hop, min_samples,
      max_onsets, cand_limit, backtrack);
  return (int)cudaGetLastError();
}

// Resident blocks per SM at this envelope length, as the CUDA runtime
// computes it from registers and shared memory.
extern "C" int gat_onset_pick_blocks_per_sm(int n_frames, int* blocks) {
  cudaError_t err = pick_set_attributes(n_frames);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, onset_pick_kernel, kThreads, pick_smem_bytes(n_frames));
}
