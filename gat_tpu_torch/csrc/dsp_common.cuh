// Device code shared by the spectral front-end kernels: the clip load with
// center padding and volume normalization, a 2048-point FFT in shared
// memory, the sparse mel projection and block reductions.
//
// Every kernel of this directory runs one thread block per clip, with
// blockDim.x == kThreads. Reductions go through shared memory and
// __syncthreads only (no warp shuffles).
#pragma once

#include <cuda_runtime.h>

namespace gat {

constexpr int kThreads = 256;          // threads per block, a power of two
constexpr int kFFT = 2048;             // n_fft of both front-ends
constexpr int kLogFFT = 11;
constexpr int kBins = kFFT / 2 + 1;    // rfft bins, Nyquist included
constexpr float kVolumeEps = 1e-9f;    // normalize_volume: y / (rms + eps)

// numpy 'reflect' padding (the edge sample is not repeated); valid while
// the pad is shorter than the signal.
__device__ __forceinline__ int reflect_index(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return i;
}

// Sum of v over the block; every thread gets the result. scratch holds
// kThreads floats.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  scratch[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) scratch[threadIdx.x] += scratch[threadIdx.x + s];
    __syncthreads();
  }
  float r = scratch[0];
  __syncthreads();
  return r;
}

__device__ __forceinline__ float block_max(float v, float* scratch) {
  scratch[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s)
      scratch[threadIdx.x] = fmaxf(scratch[threadIdx.x],
                                   scratch[threadIdx.x + s]);
    __syncthreads();
  }
  float r = scratch[0];
  __syncthreads();
  return r;
}

// Loads one clip into shared memory with `pad` samples of center padding
// on each side (reflect or zeros), divided by (rms + eps) when normalize
// is set, as normalize_volume does before the front-end. padded holds
// n + 2 * pad floats.
__device__ void load_padded_clip(const float* __restrict__ clip, int n,
                                 int pad, bool reflect, bool normalize,
                                 float* padded, float* scratch) {
  float denom = 1.0f;
  if (normalize) {
    float ss = 0.0f;
    for (int i = threadIdx.x; i < n; i += kThreads) ss += clip[i] * clip[i];
    ss = block_sum(ss, scratch);
    denom = sqrtf(ss / (float)n) + kVolumeEps;
  }
  const int total = n + 2 * pad;
  for (int p = threadIdx.x; p < total; p += kThreads) {
    int i = p - pad;
    float v;
    if (reflect) {
      v = clip[reflect_index(i, n)];
    } else {
      v = (i >= 0 && i < n) ? clip[i] : 0.0f;
    }
    padded[p] = normalize ? v / denom : v;
  }
  __syncthreads();
}

// Stages the Hann-windowed frame x[n] = padded[start + n] * hann[n] in
// bit-reversed order as a complex signal with zero imaginary part.
__device__ __forceinline__ void load_windowed_frame(const float* padded,
                                                    int start,
                                                    const float* hann,
                                                    float* re, float* im) {
  for (int n = threadIdx.x; n < kFFT; n += kThreads) {
    int r = __brev(n) >> (32 - kLogFFT);
    re[r] = padded[start + n] * hann[n];
    im[r] = 0.0f;
  }
  __syncthreads();
}

// In-place radix-2 decimation-in-time FFT of kFFT points whose input was
// staged in bit-reversed order. tw_re/tw_im hold e^(-2*pi*i*k/kFFT) for
// k < kFFT/2.
__device__ void fft2048(float* re, float* im, const float* tw_re,
                        const float* tw_im) {
  for (int half = 1, stride = kFFT / 2; half < kFFT;
       half <<= 1, stride >>= 1) {
    for (int b = threadIdx.x; b < kFFT / 2; b += kThreads) {
      int pos = b & (half - 1);
      int i = ((b - pos) << 1) + pos;
      int j = i + half;
      float wr = tw_re[pos * stride], wi = tw_im[pos * stride];
      float xr = re[j], xi = im[j];
      float tr = wr * xr - wi * xi;
      float ti = wr * xi + wi * xr;
      float ur = re[i], ui = im[i];
      re[j] = ur - tr;
      im[j] = ui - ti;
      re[i] = ur + tr;
      im[i] = ui + ti;
    }
    __syncthreads();
  }
}

// power[k] = |X[k]|^2 for the kBins rfft bins of the transformed frame.
__device__ __forceinline__ void power_bins(const float* re, const float* im,
                                           float* power) {
  for (int k = threadIdx.x; k < kBins; k += kThreads)
    power[k] = re[k] * re[k] + im[k] * im[k];
  __syncthreads();
}

// Mel projection of one power spectrum: mel m sums fb[m, k] * power[k]
// over its nonzero bins [lo[m], hi[m]). fb is (n_mels, kBins) row-major.
__device__ __forceinline__ float mel_band(const float* __restrict__ fb,
                                          const int* __restrict__ lo,
                                          const int* __restrict__ hi,
                                          const float* power, int m) {
  const float* row = fb + (size_t)m * kBins;
  float acc = 0.0f;
  for (int k = lo[m]; k < hi[m]; ++k) acc += row[k] * power[k];
  return acc;
}

}  // namespace gat
