// Constants and device helpers shared by the kernels of this directory:
// the FFT size, the reflect pad index and block reductions.
//
// Every kernel of this directory runs blocks of blockDim.x == kThreads.
// The block reductions here go through shared memory and __syncthreads;
// the onset pick (onset_pick.cu) reduces and scans with warp shuffles.
#pragma once

#include <cuda_runtime.h>

namespace gat {

constexpr int kThreads = 256;          // threads per block, a power of two
constexpr int kFFT = 2048;             // n_fft of both front-ends
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

}  // namespace gat
