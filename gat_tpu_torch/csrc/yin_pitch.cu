// K3: YIN pitch per clip, clips (N, L) -> median frame f0 (N,) in Hz.
//
// Replaces the TPU-side YIN program gat_tpu/ops/yin.py::yin_pitch
// (_cmnd / _cmnd_block + _f0_from_cmnd + the median), which the JAX
// package runs as XLA code (its ACF goes through DFT GEMMs on the TPU).
// Per clip, with frames of frame_length at hop `hop` over a zero center
// pad of frame_length/2:
//   1. acf(tau) = sum_{i=1..W} x[i] x[i+tau] and the sliding energy
//      e(tau) = sum_{i=1..W} x[i+tau]^2, tau = 0..max_p, both zeroed
//      below 1e-6;
//   2. d(tau) = e(0) + e(tau) - 2 acf(tau) and the cumulative-mean-
//      normalized difference over tau in [min_p, max_p];
//   3. the first trough below `threshold` (troughs: left-strict, right
//      non-strict, position 0 a trough iff c0 < c1), else the first global
//      minimum; a parabolic shift (0 at the edges or when |shift| > 1);
//   4. f0 = sr / period per frame, then the median over frames (the mean
//      of the two middle values when the count is even, as jnp.median).
//
// What bounds it: the ACF is frames * (max_p + 1) * W multiply-adds, about
// 2.5 M per 0.5 s clip at 11025 Hz, against 22 KB read per clip: it is
// bound by operations. The design computes the ACF directly in the time
// domain from the padded clip in shared memory, one (frame, lag) pair per
// thread at a time, so each lag sum reads a broadcast x[i] and contiguous
// x[i + tau] across a warp. The energies cost O(W + max_p) per frame:
// e(0) is acf(0) (the same products), and e(tau) - e(0) is the prefix sum
// over s = 1..tau of x[s + W]^2 - x[s]^2, the entering minus the leaving
// square. It is kept in fp64, so that its max_p steps add no drift to
// d(tau), a small difference of large terms near a trough, and scanned in
// kChunks chunks of lags per frame, so that no thread walks all max_p
// steps alone. The sequential parts (cumulative mean, trough walk,
// median) run one thread per frame.
#include <cmath>

#include "dsp_common.cuh"

using namespace gat;

constexpr float kTiny = 1.1754944e-38f;  // np.finfo(np.float32).tiny
constexpr int kChunks = 8;               // energy scan chunks per frame

// The energy scan's term at lag tau: the square entering the window
// minus the square leaving it.
__device__ __forceinline__ double energy_step(const float* x, int tau,
                                              int win) {
  const double enter = x[tau + win], leave = x[tau];
  return enter * enter - leave * leave;
}

__global__ void __launch_bounds__(kThreads)
yin_pitch_kernel(const float* __restrict__ clips, float* __restrict__ out,
                 int n_samples, int frame_length, int win, int hop,
                 int n_frames, int min_p, int max_p, float threshold,
                 float sr) {
  const int n_lags = max_p + 1;
  const int n_cmnd = max_p - min_p + 1;
  extern __shared__ float smem[];
  double* energy = reinterpret_cast<double*>(smem);  // n_frames * n_lags
  double* chunk = energy + n_frames * n_lags;        // n_frames * kChunks
  float* scratch = reinterpret_cast<float*>(chunk + n_frames * kChunks);
  float* acf = scratch + kThreads;                // n_frames * n_lags
  float* cmnd = acf + n_frames * n_lags;          // n_frames * n_lags
  float* f0 = cmnd + n_frames * n_lags;           // n_frames
  float* padded = f0 + n_frames;                  // n_samples + frame_length

  load_padded_clip(clips + (size_t)blockIdx.x * n_samples, n_samples,
                   frame_length / 2, /*reflect=*/false, /*normalize=*/false,
                   padded, scratch);

  // The energy scan, first pass: each chunk's sum of terms. The barrier
  // after the ACF loop publishes them.
  const int chunk_len = (max_p + kChunks - 1) / kChunks;
  for (int w = threadIdx.x; w < n_frames * kChunks; w += kThreads) {
    const int t = w / kChunks;
    const int first = 1 + (w - t * kChunks) * chunk_len;
    const int last = first + chunk_len - 1 < max_p ? first + chunk_len - 1
                                                   : max_p;
    const float* x = padded + t * hop;
    double s = 0.0;
    for (int tau = first; tau <= last; ++tau) s += energy_step(x, tau, win);
    chunk[w] = s;
  }

  // kParts interleaved partial sums per lag: one running fp32 sum over
  // W = 1024 products drifts enough to swap near-equal CMND troughs on
  // clean periodic frames, where the FFT route of the plain version does
  // not; the partials also give each thread independent FMA chains. The
  // sums are stored unzeroed: acf(0) seeds the energies below.
  constexpr int kParts = 8;
  for (int w = threadIdx.x; w < n_frames * n_lags; w += kThreads) {
    const int t = w / n_lags;
    const int tau = w - t * n_lags;
    const float* x = padded + t * hop;
    float a[kParts] = {};
    int i = 1;
    for (; i + kParts - 1 <= win; i += kParts) {
#pragma unroll
      for (int k = 0; k < kParts; ++k) a[k] += x[i + k] * x[i + k + tau];
    }
    for (int k = 0; i <= win; ++i, ++k) a[k] += x[i] * x[i + tau];
    float as = a[0];
#pragma unroll
    for (int k = 1; k < kParts; ++k) as += a[k];
    acf[w] = as;
  }
  __syncthreads();

  // Second pass: each chunk's running sums from the chunks before it,
  // energy[t][tau] = e(tau) - e(0).
  for (int w = threadIdx.x; w < n_frames * kChunks; w += kThreads) {
    const int t = w / kChunks;
    const int c = w - t * kChunks;
    const int first = 1 + c * chunk_len;
    const int last = first + chunk_len - 1 < max_p ? first + chunk_len - 1
                                                   : max_p;
    const float* x = padded + t * hop;
    double s = 0.0;
    for (int k = 0; k < c; ++k) s += chunk[t * kChunks + k];
    for (int tau = first; tau <= last; ++tau) {
      s += energy_step(x, tau, win);
      energy[t * n_lags + tau] = s;
    }
  }
  __syncthreads();

  for (int t = threadIdx.x; t < n_frames; t += kThreads) {
    const float* ac = acf + t * n_lags;
    const double* en = energy + t * n_lags;
    float* c = cmnd + t * n_lags;
    const float e0 = fabsf(ac[0]) < 1e-6f ? 0.0f : ac[0];
    float cum = 0.0f;
    for (int tau = 1; tau <= max_p; ++tau) {
      const float e = (float)(ac[0] + en[tau]);
      const float et = fabsf(e) < 1e-6f ? 0.0f : e;
      const float at = fabsf(ac[tau]) < 1e-6f ? 0.0f : ac[tau];
      const float d = e0 + et - 2.0f * at;
      cum += d;
      if (tau >= min_p) c[tau - min_p] = d / (cum / (float)tau + kTiny);
    }
    int idx = -1;
    for (int j = 0; j < n_cmnd && idx < 0; ++j) {
      bool trough;
      if (j == 0) {
        trough = c[0] < c[1];
      } else {
        const float right = j + 1 < n_cmnd ? c[j + 1] : c[j];
        trough = c[j] < c[j - 1] && c[j] <= right;
      }
      if (trough && c[j] < threshold) idx = j;
    }
    if (idx < 0) {
      idx = 0;
      for (int j = 1; j < n_cmnd; ++j)
        if (c[j] < c[idx]) idx = j;
    }
    float shift = 0.0f;
    if (idx > 0 && idx < n_cmnd - 1) {
      const float a = (c[idx - 1] + c[idx + 1] - 2.0f * c[idx]) / 2.0f;
      const float b = (c[idx + 1] - c[idx - 1]) / 2.0f;
      const float inner = -b / (2.0f * a + kTiny);
      shift = fabsf(inner) > 1.0f ? 0.0f : inner;
    }
    f0[t] = sr / ((float)(min_p + idx) + shift);
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    for (int i = 1; i < n_frames; ++i) {  // insertion sort, n_frames small
      const float v = f0[i];
      int j = i - 1;
      while (j >= 0 && f0[j] > v) {
        f0[j + 1] = f0[j];
        --j;
      }
      f0[j + 1] = v;
    }
    const int h = n_frames / 2;
    out[blockIdx.x] = (n_frames & 1) ? f0[h] : (f0[h - 1] + f0[h]) * 0.5f;
  }
}

extern "C" int gat_yin_pitch(const float* clips, float* out, int n_clips,
                             int n_samples, int frame_length, int win,
                             int hop, int n_frames, int min_p, int max_p,
                             float threshold, float sr, void* stream) {
  const int n_lags = max_p + 1;
  size_t smem = sizeof(double) * (size_t)(n_frames * (n_lags + kChunks)) +
                sizeof(float) * (size_t)(kThreads + 2 * n_frames * n_lags +
                                         n_frames + n_samples +
                                         2 * (frame_length / 2));
  cudaError_t err = cudaFuncSetAttribute(
      yin_pitch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  yin_pitch_kernel<<<n_clips, kThreads, smem, (cudaStream_t)stream>>>(
      clips, out, n_samples, frame_length, win, hop, n_frames, min_p, max_p,
      threshold, sr);
  return (int)cudaGetLastError();
}
