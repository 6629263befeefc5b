// Constants and device helpers shared by the kernels of this directory:
// the FFT size, the clip length limit, the card's shared memory, the
// reflect pad index and block reductions.
//
// Every kernel of this directory runs blocks of blockDim.x == kThreads.
// The block reductions here go through shared memory and __syncthreads;
// the onset pick (onset_pick.cu) reduces and scans with warp shuffles.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace gat {

constexpr int kThreads = 256;          // threads per block, a power of two
constexpr int kFFT = 2048;             // n_fft of both front-ends
constexpr int kBins = kFFT / 2 + 1;    // rfft bins, Nyquist included
constexpr float kVolumeEps = 1e-9f;    // normalize_volume: y / (rms + eps)
// The clip front-ends (K1, K2, K3, K6) take fewer frames than this
// (kernels.py MAX_FRAMES, the wrappers' guard)
constexpr int kMaxFrames = 2000;

// Shared memory of an H100 SM: 228 KB, of which one block may take at most
// 227 KB; the runtime reserves 1 KB more per resident block, and allocates
// in units of 128 bytes.
constexpr size_t kSmemPerSM = 233472;
constexpr size_t kMaxBlockSmem = 232448;
constexpr size_t kSmemReserved = 1024;
constexpr size_t kSmemUnit = 128;

// The shared memory a block may take when `blocks` blocks share an SM.
__host__ __device__ constexpr size_t smem_per_block(int blocks) {
  return kSmemPerSM / blocks - kSmemReserved < kMaxBlockSmem
             ? kSmemPerSM / blocks - kSmemReserved
             : kMaxBlockSmem;
}

// Whether `bytes` of dynamic shared memory fit in `budget` bytes once
// rounded up to the allocation unit.
__host__ __device__ constexpr bool smem_fits(size_t bytes, size_t budget) {
  return (bytes + kSmemUnit - 1) / kSmemUnit * kSmemUnit <= budget;
}

// Blocks of `bytes` shared memory each that fit on an SM, at most `cap`.
__host__ __device__ constexpr int blocks_per_sm(size_t bytes, int cap) {
  int b = cap;
  while (b > 1 && !smem_fits(bytes, smem_per_block(b))) --b;
  return b;
}

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
