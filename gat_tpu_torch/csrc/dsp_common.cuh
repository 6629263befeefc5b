// Constants and device helpers shared by the kernels of this directory:
// the FFT size, the card's shared memory, the split route of the clip
// front-ends, the reflect pad index and block reductions.
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

// The split route of the clip front-ends (K1, K2, K3, K6). One block a
// clip fills the card only when there are as many clips as the card holds
// resident blocks; past that a clip of many frames runs on one SM while
// the others idle. The split route cuts each clip's frames into tiles of
// `tile` frames, one block a tile, and finishes what is per clip (the
// volume scale before, the top_db peak, the mean over frames and the
// median pitch after) in launches of their own, so that no block waits
// for another. It is taken for clips of at least two tiles of
// kSplitMinTile frames when the clips alone leave resident blocks free,
// or when a clip is longer than the `max_tile` frames its kernel's one
// block should take alone; the tiles are then as many as fill the card
// once (or more, of at most max_tile frames), at least kSplitMinTile
// frames and a multiple of `quantum` each.
constexpr int kSplitMinTile = 32;
constexpr int kNoMaxTile = 0x7fffffff;  // the one-block route takes any length

// Frames a tile of the split route takes, or 0 for one block a clip, for
// n_clips clips of n_frames frames on a card of `slots` resident blocks
// (its SMs times the blocks of the split kernel an SM holds).
inline int split_tile(int n_clips, int n_frames, long long slots,
                      int quantum, int max_tile) {
  if (n_clips < 1 || n_frames < 2 * kSplitMinTile) return 0;
  long long tiles = (slots + n_clips - 1) / n_clips;  // fill the card once
  const long long longest = (n_frames + (long long)max_tile - 1) / max_tile;
  if (tiles < longest) tiles = longest;
  if (tiles > n_frames / kSplitMinTile) tiles = n_frames / kSplitMinTile;
  if (tiles <= 1) return 0;
  const long long tile = (n_frames + tiles - 1) / tiles;
  return (int)((tile + quantum - 1) / quantum * quantum);
}

// The card's resident blocks of `kernel` at `smem` bytes of dynamic shared
// memory: its SMs times the blocks an SM holds (at least one); the blocks
// an SM holds as the CUDA runtime reports them go to *per_sm.
template <class Kernel>
inline cudaError_t card_slots(Kernel kernel, size_t smem, long long* slots,
                              int* per_sm) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                        kThreads, smem);
  *slots = (long long)sms * (*per_sm > 0 ? *per_sm : 1);
  return err;
}

// The plan of a clip front-end's launch, as its `gat_*_plan` entry point
// reports it to the wrapper.
enum PlanField {
  kPlanTile,      // frames a tile (0: one block a clip)
  kPlanTiles,     // tiles a clip (1: one block a clip)
  kPlanPerSM,     // resident blocks per SM of the kernel that runs the frames
  kPlanFloats,    // floats of device-memory scratch a clip
  kPlanFields
};

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
