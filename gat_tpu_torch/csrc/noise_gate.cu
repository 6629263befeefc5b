// K7: the noise gate of whole files, y (B, n) -> gated (B, n), with an
// optional (B,) count of valid samples per row.
//
// Replaces the JAX package's XLA program gat_tpu/segment/gating.py:154
// gate_waveform (sample_db_gate, then rms_gate :114 with rms_db_envelope
// :36, dynamic_thresholds :98 and filters.py:79 masked_percentile), and
// the separate length mask the file body applied before it. It replaces
// no Pallas kernel: the reference never wrote one for the gates. Per row,
// with nv its valid count (n when none is given):
//   1. the sample gate: y · [20·log10(|y| + 1e-10) > min_db], the same
//      formula as the reference (a precomputed amplitude threshold would
//      flip a sample at the threshold);
//   2. the frame RMS in dB at frame 2048, centred, reflect-padded, over
//      the row extended as rms_db_envelope extends it: the valid samples,
//      then the mirror of the valid end written into [nv, nv + 1024)
//      (ye[nv + j] = y[nv - 2 - j], zero below sample 0), then zeros;
//      frames t < 1 + n / hop;
//   3. the 5-wide median with symmetric edges, over the envelope extended
//      by two frames whose values at nvf = 1 + nv / hop and nvf + 1 are
//      the envelope's frames nvf - 1 and nvf - 2 (zero below frame 0);
//   4. the 20th percentile of the smoothed frames t < nvf, linear between
//      order statistics and never interpolating past the valid frames,
//      plus 6 dB: gate_db; each frame passes when its smoothed dB is above;
//   5. gated = y · sample gate · frame gate[i / hop] · [i < nv].
// Without a count (nv = n) this is the reference's unmasked rms_gate, for
// every n it takes (n > 1024): its reflect pads are the mirrors above.
//
// What bounds it: bytes. The gate reads each sample and writes it once,
// 8 bytes per sample, and does a few dozen operations per sample (the
// log10 of the sample gate, 4 squares of the overlapping frames), far
// below the card's operation rate. The reference's XLA program (and the
// port's plain PyTorch) spends a dozen passes over the samples, two sorts
// and index tensors. The design makes three passes, each a launch of its
// own because each needs the one before it whole:
//   rms   grid-stride over (file, run of frames): each block stages the
//         (F - 1)·hop + 2048 samples of its run of F frames in shared
//         memory once, with the length mask, the sample gate and both
//         reflections applied as they load, then a warp per frame sums its
//         2048 squares (in fp64: the order of the sum costs no float32
//         rounding) and writes its dB to a (B, T) workspace;
//   gate  one block per file: the median with both mirrors into a second
//         (B, T) workspace, then the two order statistics of the valid
//         frames by radix selection on order-preserving uint32 keys (four
//         rounds of 8 bits, a shared histogram per round; the upper
//         statistic is the lower one again or the least larger value), so
//         any frame count works with the frames in device memory, and the
//         threshold is bit-equal to the plain percentile of the same
//         envelope (its float32 steps are rounded one by one, no FMA);
//         then the frame mask;
//   apply grid-stride over the samples, 16-byte loads and stores where the
//         row length and the pointers allow: the sample read a second time
//         (from L2 at the serving wave's 21 MB), the mask bytes read per
//         frame.
// Every hop >= 1 is taken: a run holds as many frames as fit the stage.
#include <cmath>
#include <cstdint>

#include "dsp_common.cuh"

using namespace gat;

constexpr int kFrame = 2048;            // rms_gate's frame length
constexpr int kHalf = kFrame / 2;       // its centre pad
constexpr int kStage = 12288;           // staged samples per block (48 KB)
constexpr int kWarps = kThreads / 32;
constexpr float kEps = 1e-10f;          // the gates' log10 floor
constexpr float kNoiseQuantile = 0.2f;  // the noise floor's percentile / 100
constexpr float kGateOffsetDb = 6.0f;   // gate_db = noise floor + 6 dB
constexpr unsigned kFull = 0xffffffffu;

struct GateShared {
  int hist[256];         // one radix round's histogram
  int wsum[kWarps];      // warp totals of the histogram scan
  float wmin[kWarps];    // warp minima
  int bin, k_rem, eq;    // the selected bin, the rank left in it, its count
};

template <class T, class Op>
__device__ __forceinline__ T warp_reduce(T v, Op op) {
  for (int s = 16; s > 0; s >>= 1) v = op(v, __shfl_xor_sync(kFull, v, s));
  return v;
}

__device__ __forceinline__ int valid_count(const int* n_valid, int file,
                                           int n) {
  if (!n_valid) return n;
  const int nv = n_valid[file];
  return nv < 0 ? 0 : (nv > n ? n : nv);
}

// sample_db_gate of one sample (or the sample itself without the gate)
__device__ __forceinline__ float sample_gate(float v, int gate_samples,
                                             float min_db) {
  if (!gate_samples) return v;
  return v * (20.0f * log10f(fabsf(v) + kEps) > min_db ? 1.0f : 0.0f);
}

// Sample p of the row as the frame RMS reads it: the reflect pad at the
// left, the valid samples, the mirror of the valid end, then zeros.
__device__ __forceinline__ float extended_sample(const float* row,
                                                 long long p, int nv,
                                                 int gate_samples,
                                                 float min_db) {
  if (p < 0) p = -p;
  if (p < nv) return sample_gate(row[p], gate_samples, min_db);
  if (p < (long long)nv + kHalf) {
    const long long q = 2LL * nv - 2 - p;
    return q >= 0 ? sample_gate(row[q], gate_samples, min_db) : 0.0f;
  }
  return 0.0f;
}

__device__ __forceinline__ int frames_per_run(int hop) {
  const int f = 1 + (kStage - kFrame) / hop;
  return f < 1 ? 1 : f;
}

__global__ void __launch_bounds__(kThreads)
noise_gate_rms_kernel(const float* __restrict__ y,
                      const int* __restrict__ n_valid,
                      float* __restrict__ env, int n_files, int n, int hop,
                      int t_out, int gate_samples, float min_db) {
  __shared__ float stage[kStage];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int run = frames_per_run(hop);
  const int runs = (t_out + run - 1) / run;
  const long long items = (long long)n_files * runs;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const int file = (int)(item / runs);
    const int t0 = (int)(item % runs) * run;
    const int frames = t_out - t0 < run ? t_out - t0 : run;
    const int nv = valid_count(n_valid, file, n);
    const float* row = y + (size_t)file * n;
    const long long p0 = (long long)t0 * hop - kHalf;
    const int span = (frames - 1) * hop + kFrame;
    for (int s = threadIdx.x; s < span; s += kThreads)
      stage[s] = extended_sample(row, p0 + s, nv, gate_samples, min_db);
    __syncthreads();
    for (int f = warp; f < frames; f += kWarps) {
      const float* w = stage + (size_t)f * hop;
      double acc = 0.0;
      for (int k = lane; k < kFrame; k += 32) {
        const float v = w[k];
        acc += (double)(v * v);
      }
      acc = warp_reduce(acc, [](double a, double b) { return a + b; });
      if (lane == 0) {
        const float mean = (float)acc * (1.0f / kFrame);
        env[(size_t)file * t_out + t0 + f] =
            20.0f * log10f(sqrtf(mean) + kEps);
      }
    }
    __syncthreads();  // the next run overwrites the stage
  }
}

// Order-preserving key of a float (no NaN reaches it): unsigned order of
// the keys is the float order.
__device__ __forceinline__ unsigned order_bits(float v) {
  const unsigned u = (unsigned)__float_as_int(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(unsigned k) {
  return __int_as_float((int)((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k));
}

// The k-th smallest (from 0) of v[0, count) by four radix rounds; also
// the rank left inside its value's run and how many values equal it.
__device__ float select_kth(const float* v, int count, int k, int* k_rem,
                            int* eq, GateShared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned prefix = 0u, pmask = 0u;
  for (int shift = 24; shift >= 0; shift -= 8) {
    sh.hist[threadIdx.x] = 0;
    __syncthreads();
    for (int t = threadIdx.x; t < count; t += kThreads) {
      const unsigned u = order_bits(v[t]);
      if ((u & pmask) == prefix) atomicAdd(&sh.hist[(u >> shift) & 255u], 1);
    }
    __syncthreads();
    const int h = sh.hist[threadIdx.x];
    int incl = h;
    for (int s = 1; s < 32; s <<= 1) {
      const int u = __shfl_up_sync(kFull, incl, s);
      if (lane >= s) incl += u;
    }
    if (lane == 31) sh.wsum[warp] = incl;
    __syncthreads();
    int excl = incl - h;
    for (int w = 0; w < warp; ++w) excl += sh.wsum[w];
    if (k >= excl && k < excl + h) {
      sh.bin = threadIdx.x;
      sh.k_rem = k - excl;
      sh.eq = h;
    }
    __syncthreads();
    prefix |= (unsigned)sh.bin << shift;
    pmask |= 255u << shift;
    k = sh.k_rem;
    *eq = sh.eq;
    __syncthreads();  // before the next round clears the histogram
  }
  *k_rem = k;
  return key_float(prefix);
}

__global__ void __launch_bounds__(kThreads)
noise_gate_threshold_kernel(const float* __restrict__ env,
                            const int* __restrict__ n_valid, float* med,
                            unsigned char* __restrict__ frame_mask,
                            float* __restrict__ gate_db, int n, int hop,
                            int t_out) {
  __shared__ GateShared sh;
  const int file = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nv = valid_count(n_valid, file, n);
  int nvf = 1 + nv / hop;
  nvf = nvf > t_out ? t_out : nvf;
  const float* e = env + (size_t)file * t_out;
  float* m = med + (size_t)file * t_out;

  // the envelope extended by the mirror of its valid end, read with
  // symmetric edges at frame 0
  auto ee = [&](int i) -> float {
    if (i < 0) i = -1 - i;
    if (i == nvf) return e[nvf - 1];
    if (i == nvf + 1) return nvf >= 2 ? e[nvf - 2] : 0.0f;
    return i < t_out ? e[i] : 0.0f;
  };
  for (int t = threadIdx.x; t < t_out; t += kThreads) {
    float a[5] = {ee(t - 2), ee(t - 1), ee(t), ee(t + 1), ee(t + 2)};
    // a sorting network of 5: its middle is the median
    const int net[9][2] = {{0, 1}, {3, 4}, {2, 4}, {2, 3}, {1, 4},
                           {0, 3}, {0, 2}, {1, 3}, {1, 2}};
#pragma unroll
    for (int c = 0; c < 9; ++c) {
      const float lo = fminf(a[net[c][0]], a[net[c][1]]);
      const float hi = fmaxf(a[net[c][0]], a[net[c][1]]);
      a[net[c][0]] = lo;
      a[net[c][1]] = hi;
    }
    m[t] = a[2];
  }
  __syncthreads();  // the smoothed frames, in device memory, for all

  // masked_percentile(med, 20, t < nvf): pos = 0.2 · (count - 1)
  const float pos = __fmul_rn(kNoiseQuantile, __fsub_rn((float)nvf, 1.0f));
  const int lo = (int)floorf(pos);
  const float frac = __fsub_rn(pos, (float)lo);
  int k_rem, eq;
  const float xlo = select_kth(m, nvf, lo, &k_rem, &eq, sh);
  float xhi = xlo;
  if (lo + 1 < nvf && k_rem + 1 >= eq) {
    // the next order statistic is the least value above xlo
    float least = INFINITY;
    for (int t = threadIdx.x; t < nvf; t += kThreads)
      if (m[t] > xlo) least = fminf(least, m[t]);
    least = warp_reduce(least, [](float a, float b) { return fminf(a, b); });
    if (lane == 0) sh.wmin[warp] = least;
    __syncthreads();
    xhi = sh.wmin[0];
    for (int w = 1; w < kWarps; ++w) xhi = fminf(xhi, sh.wmin[w]);
  }
  const float noise = __fadd_rn(xlo, __fmul_rn(frac, __fsub_rn(xhi, xlo)));
  const float gate = __fadd_rn(noise, kGateOffsetDb);
  if (threadIdx.x == 0) gate_db[file] = gate;
  unsigned char* fm = frame_mask + (size_t)file * t_out;
  for (int t = threadIdx.x; t < t_out; t += kThreads) fm[t] = m[t] > gate;
}

__device__ __forceinline__ float gated_sample(float v, int i, int nv,
                                              const unsigned char* fm,
                                              int hop, int gate_samples,
                                              float min_db) {
  const bool keep = i < nv && fm[i / hop];
  return sample_gate(v, gate_samples, min_db) * (keep ? 1.0f : 0.0f);
}

__global__ void __launch_bounds__(kThreads)
noise_gate_apply_kernel(const float* __restrict__ y, float* __restrict__ out,
                        const unsigned char* __restrict__ frame_mask,
                        const int* __restrict__ n_valid, int n_files, int n,
                        int hop, int t_out, int gate_samples, float min_db,
                        int vec) {
  const size_t total = (size_t)n_files * n;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t first = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (vec) {  // n % 4 == 0 and both pointers 16-byte aligned
    const float4* y4 = reinterpret_cast<const float4*>(y);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (size_t u = first; u < total / 4; u += stride) {
      const size_t e = 4 * u;
      const int file = (int)(e / n), i = (int)(e - (size_t)file * n);
      const int nv = valid_count(n_valid, file, n);
      const unsigned char* fm = frame_mask + (size_t)file * t_out;
      float4 x = y4[u];
      x.x = gated_sample(x.x, i, nv, fm, hop, gate_samples, min_db);
      x.y = gated_sample(x.y, i + 1, nv, fm, hop, gate_samples, min_db);
      x.z = gated_sample(x.z, i + 2, nv, fm, hop, gate_samples, min_db);
      x.w = gated_sample(x.w, i + 3, nv, fm, hop, gate_samples, min_db);
      o4[u] = x;
    }
    return;
  }
  for (size_t e = first; e < total; e += stride) {
    const int file = (int)(e / n), i = (int)(e - (size_t)file * n);
    out[e] = gated_sample(y[e], i, valid_count(n_valid, file, n),
                          frame_mask + (size_t)file * t_out, hop,
                          gate_samples, min_db);
  }
}

// The gate of n_files rows of n samples. n_valid: (n_files,) int32 valid
// counts, or NULL for none; env, med: (n_files, 1 + n / hop) float32
// workspaces (the frame RMS in dB, then smoothed); frame_mask: the frames'
// gate bytes; gate_db: (n_files,) thresholds. gate_samples 0 leaves out
// the sample gate (rms_gate alone). grid: blocks of the rms and apply
// passes (the wrapper's SMs x resident blocks per SM).
extern "C" int gat_noise_gate(const float* y, float* out, const int* n_valid,
                              float* env, float* med,
                              unsigned char* frame_mask, float* gate_db,
                              int n_files, int n, int hop, int gate_samples,
                              float min_db, int grid, void* stream) {
  if (n_files < 1 || n < 1 || n > 0x7fffffff - 2 * kFrame || hop < 1 ||
      grid < 1)
    return (int)cudaErrorInvalidValue;
  const int t_out = 1 + n / hop;
  cudaStream_t s = (cudaStream_t)stream;
  noise_gate_rms_kernel<<<grid, kThreads, 0, s>>>(
      y, n_valid, env, n_files, n, hop, t_out, gate_samples, min_db);
  int status = (int)cudaGetLastError();
  if (status != 0) return status;
  noise_gate_threshold_kernel<<<n_files, kThreads, 0, s>>>(
      env, n_valid, med, frame_mask, gate_db, n, hop, t_out);
  status = (int)cudaGetLastError();
  if (status != 0) return status;
  const int vec = n % 4 == 0 && ((uintptr_t)y & 15u) == 0 &&
                  ((uintptr_t)out & 15u) == 0;
  noise_gate_apply_kernel<<<grid, kThreads, 0, s>>>(
      y, out, frame_mask, n_valid, n_files, n, hop, t_out, gate_samples,
      min_db, vec);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the rms pass (its 48 KB stage is static, the
// same at every hop), as the CUDA runtime computes it; hop < 1 is refused
// as the launch refuses it.
extern "C" int gat_noise_gate_blocks_per_sm(int hop, int* blocks) {
  if (hop < 1) return (int)cudaErrorInvalidValue;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, noise_gate_rms_kernel, kThreads, 0);
}
