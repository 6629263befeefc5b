// K3: YIN pitch per clip, clips (N, L) -> median frame f0 (N,) in Hz.
//
// Replaces the TPU-side YIN program gat_tpu/ops/yin.py::yin_pitch
// (_cmnd / _cmnd_block + _f0_from_cmnd + the median), which the JAX
// package runs as XLA code (its ACF goes through DFT GEMMs on the TPU).
// Per clip: the median YIN f0 of its frames, steps 1-4 of yin_acf.cuh,
// whose device code K6 (mfcc_pitch_frontend.cu) shares.
//
// What bounds it: operations. The function's least work is the ACF from
// FFTs, 1.9 M flops per 0.5 s clip at 11025 Hz (utils/roofline.py::
// yin_cost), against 22 KB read; this kernel's direct ACF does frames *
// (max_p + 1) * W multiply-adds, about 2.5 M, for its precision (below). One block of 256 threads owns one clip, staged in
// shared memory with its zero pad. The ACF is tiled in registers:
//   - Each thread computes kTile = 7 consecutive lags tau0 .. tau0 + 6 of
//     one frame over one segment of i, and keeps the window x[i + tau0 ..
//     i + tau0 + 6] in registers. A step loads x[i] and one new window
//     sample and does 7 FMAs: 2 shared-memory loads per 7 multiply-adds
//     instead of 2 per one. The i loop is unrolled by 7, so the window
//     rotates by register index and no register moves.
//   - A warp covers 32 * 7 = 224 lags (tau0 = 224 b + 7 * lane); the 8
//     warps of the block take the 8 segments of 128 i of one frame, one
//     unit (frame, lag block) per round. 11 frames of 222 lags are 11
//     rounds with no thread idle but lags 222 and 223.
//   - No bank conflicts, with no skew or stagger: every lane of a warp
//     loads the same x[i] (one broadcast), and lane l loads its window
//     sample at i + 7 l + const, a stride of 7 words. 7 is odd, so the 32
//     lanes hit 32 distinct banks. The partial-sum stores (stride 7) and
//     the reduction's loads (stride 1) are conflict-free for the same
//     reasons.
//   - Precision: one running fp32 sum over W = 1024 products drifts enough
//     to swap near-equal CMND troughs on clean periodic frames, where the
//     FFT route of the plain version does not. Each lag's sum is formed
//     from 8 independent chains of 128 products (one per segment), summed
//     afterwards in a fixed order through a double-buffered shared-memory
//     table, so a round needs one barrier.
// The energies cost O(W + max_p) per frame: e(0) is acf(0) (the same
// products), and e(tau) - e(0) is the prefix sum over s = 1..tau of
// x[s + W]^2 - x[s]^2, the entering minus the leaving square. It is kept
// in fp64, so that its max_p steps add no drift to d(tau), a small
// difference of large terms near a trough. The lags of a frame are cut
// into kChunks chunks, and each pass over them is a scan in two steps:
// every (frame, chunk) thread first sums its chunk's terms, then walks
// its chunk from the sum of the chunks before it. So no thread walks all
// max_p lags: the energy prefix and d(tau), then the cumulative mean and
// the CMND, both in place over the ACF. The trough walk and the median
// run one thread per frame and one per clip. Shared memory at 11 frames
// of 222 lags: 50,680 bytes, so four blocks fit on an SM.
//
// Clips of any length: the frames run in groups
// (yin_acf.cuh), each group's padded samples and tables staged in turn,
// the group the largest whose shared memory lets four blocks share an SM
// (kBlocksPerSM, the launch bounds), or, if not even one frame does, the
// largest that fits a block at all. Only the f0 of every frame stays for
// the median. Each frame's sums are those of a clip staged whole, so the
// pitch is the same float at any group; a clip of at most one group (11
// frames at 11025 Hz: the whole clip) takes the one-group layout above.
//
// Where one block a clip leaves the card under-filled, or a clip has more
// frames than kMaxTile (the one-block route keeps every f0 in shared
// memory and sorts them on one thread), the split route
// (dsp_common.cuh) cuts each clip's frames into tiles, one block a tile
// running the tile's frames in groups as above (yin_tile_kernel), every
// frame's f0 into device memory, the same float at any tile or group;
// then one block a clip takes the median of its frames' f0 by a radix
// selection over device memory (yin_acf.cuh::select_median,
// yin_median_kernel), the sorted order's middle values.
#include "yin_acf.cuh"

using namespace gat;

constexpr int kBlocksPerSM = 4;

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
yin_pitch_kernel(const float* __restrict__ clips, float* __restrict__ out,
                 int n_samples, int frame_length, int win, int hop,
                 int n_frames, int group, int min_p, int max_p,
                 float threshold, float sr) {
  const YinLayout lay(win, hop, group, max_p, n_frames);
  extern __shared__ float smem[];
  char* base = reinterpret_cast<char*>(smem);
  float* padded = reinterpret_cast<float*>(base + lay.tables);
  float* f0 = reinterpret_cast<float*>(base + lay.f0);

  const float* clip = clips + (size_t)blockIdx.x * n_samples;
  const int pad = frame_length / 2;
  for (int g0 = 0; g0 < n_frames; g0 += group) {
    if (g0 > 0) __syncthreads();  // the last group is done with the copy
    // the group's samples with the clip's zero center pad, up to the last
    // sample read
    for (int p = threadIdx.x; p < lay.padded_len; p += kThreads) {
      const int i = g0 * hop + p - pad;
      padded[p] = (i >= 0 && i < n_samples) ? clip[i] : 0.0f;
    }
    __syncthreads();
    yin_frames_f0(padded, base, lay,
                  n_frames - g0 < group ? n_frames - g0 : group, f0 + g0,
                  win, hop, min_p, max_p, threshold, sr);
  }
  const float hz = yin_median(base, lay, n_frames);
  if (threadIdx.x == 0) out[blockIdx.x] = hz;
}

static size_t yin_smem_bytes(const YinLayout& lay) {
  return lay.tables + sizeof(float) * lay.padded_len;
}

// The group of frames a clip runs in: the largest at kBlocksPerSM blocks
// per SM, else the largest a block can hold; 0 (refused) when not even
// one frame fits beside the clip's f0 table.
static int yin_launch_group(int win, int hop, int n_frames, int max_p) {
  if (n_frames < 1 || max_p < 1) return 0;
  const auto bytes = [&](int g) {
    return yin_smem_bytes(YinLayout(win, hop, g, max_p, n_frames));
  };
  const int g = yin_group(win, hop, n_frames, max_p,
                          smem_per_block(kBlocksPerSM), bytes);
  return g > 0 ? g : yin_group(win, hop, n_frames, max_p, kMaxBlockSmem,
                               bytes);
}

static cudaError_t yin_set_attributes(const YinLayout& lay) {
  return cudaFuncSetAttribute(yin_pitch_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)yin_smem_bytes(lay));
}

extern "C" int gat_yin_pitch(const float* clips, float* out, int n_clips,
                             int n_samples, int frame_length, int win,
                             int hop, int n_frames, int min_p, int max_p,
                             float threshold, float sr, void* stream) {
  const int group = yin_launch_group(win, hop, n_frames, max_p);
  if (group == 0) return (int)cudaErrorInvalidValue;
  const YinLayout lay(win, hop, group, max_p, n_frames);
  cudaError_t err = yin_set_attributes(lay);
  if (err != cudaSuccess) return (int)err;
  yin_pitch_kernel<<<n_clips, kThreads, yin_smem_bytes(lay),
                     (cudaStream_t)stream>>>(
      clips, out, n_samples, frame_length, win, hop, n_frames, group, min_p,
      max_p, threshold, sr);
  return (int)cudaGetLastError();
}

// The group of frames a launch at these sizes runs in (0: refused).
extern "C" int gat_yin_group(int win, int hop, int n_frames, int max_p) {
  return yin_launch_group(win, hop, n_frames, max_p);
}

// Resident blocks per SM at these sizes, as the CUDA runtime computes it
// from the kernel's registers and shared memory.
extern "C" int gat_yin_blocks_per_sm(int win, int hop, int n_frames,
                                     int max_p, int* blocks) {
  const int group = yin_launch_group(win, hop, n_frames, max_p);
  if (group == 0) return (int)cudaErrorInvalidValue;
  const YinLayout lay(win, hop, group, max_p, n_frames);
  cudaError_t err = yin_set_attributes(lay);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, yin_pitch_kernel, kThreads, yin_smem_bytes(lay));
}

// ---------------------------------------------------------------------------
// The split route
// ---------------------------------------------------------------------------
constexpr int kMaxTile = 512;  // frames the one-block route takes alone

// Block b runs tile b % tiles of clip b / tiles: frames [t0, t0 + tile),
// cut at n_frames, in groups of `group` frames, their f0 into
// f0s[clip * n_frames + t].
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
yin_tile_kernel(const float* __restrict__ clips, float* __restrict__ f0s,
                int n_samples, int frame_length, int win, int hop,
                int n_frames, int group, int tile, int tiles, int min_p,
                int max_p, float threshold, float sr) {
  const YinLayout lay(win, hop, group, max_p);
  extern __shared__ float smem[];
  char* base = reinterpret_cast<char*>(smem);
  float* padded = reinterpret_cast<float*>(base + lay.tables);

  const int c = blockIdx.x / tiles;
  const int t0 = (blockIdx.x - c * tiles) * tile;
  const int t1 = t0 + tile < n_frames ? t0 + tile : n_frames;
  const float* clip = clips + (size_t)c * n_samples;
  float* f0 = f0s + (size_t)c * n_frames;
  const int pad = frame_length / 2;
  for (int g0 = t0; g0 < t1; g0 += group) {
    if (g0 > t0) __syncthreads();  // the last group is done with the copy
    for (int p = threadIdx.x; p < lay.padded_len; p += kThreads) {
      const int i = g0 * hop + p - pad;
      padded[p] = (i >= 0 && i < n_samples) ? clip[i] : 0.0f;
    }
    __syncthreads();
    yin_frames_f0(padded, base, lay, t1 - g0 < group ? t1 - g0 : group,
                  f0 + g0, win, hop, min_p, max_p, threshold, sr);
  }
}

// Block c: the median of clip c's frames' f0.
__global__ void __launch_bounds__(kThreads)
yin_median_kernel(const float* __restrict__ f0s, float* __restrict__ out,
                  int n_frames) {
  __shared__ int hist[258];
  const float hz =
      select_median(f0s + (size_t)blockIdx.x * n_frames, n_frames, hist);
  if (threadIdx.x == 0) out[blockIdx.x] = hz;
}

// The split route's layout of a group of `group` frames (the f0 go to
// device memory; the layout's own f0 table is the group's).
static size_t yin_tile_smem_bytes(int win, int hop, int group, int max_p) {
  return yin_smem_bytes(YinLayout(win, hop, group, max_p));
}

// The split route's group for tiles of up to `tile` frames: the largest at
// kBlocksPerSM blocks per SM, else the largest a block holds (0: none).
static int yin_tile_group(int win, int hop, int tile, int max_p) {
  if (tile < 1 || max_p < 1) return 0;
  const auto bytes = [&](int g) {
    return yin_tile_smem_bytes(win, hop, g, max_p);
  };
  const int g = yin_group(win, hop, tile, max_p,
                          smem_per_block(kBlocksPerSM), bytes);
  return g > 0 ? g : yin_group(win, hop, tile, max_p, kMaxBlockSmem, bytes);
}

static cudaError_t yin_tile_attributes(size_t bytes) {
  return cudaFuncSetAttribute(yin_tile_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// The launch at these sizes on the current device: plan[kPlanTile] frames
// a tile (0: one block a clip), plan[kPlanTiles] tiles a clip,
// plan[kPlanPerSM] the resident blocks per SM of the kernel that runs the
// frames, plan[kPlanFloats] floats of scratch a clip (the split route's
// f0 of every frame).
extern "C" int gat_yin_plan(int n_clips, int win, int hop, int n_frames,
                            int max_p, int* plan) {
  if (n_frames < 1 || n_clips < 0) return (int)cudaErrorInvalidValue;
  const int group = yin_tile_group(win, hop, kMaxTile, max_p);
  if (group == 0) return (int)cudaErrorInvalidValue;
  const size_t bytes = yin_tile_smem_bytes(win, hop, group, max_p);
  cudaError_t err = yin_tile_attributes(bytes);
  long long slots = 0;
  int per_sm = 0;
  if (err == cudaSuccess)
    err = card_slots(yin_tile_kernel, bytes, &slots, &per_sm);
  if (err != cudaSuccess) return (int)err;
  const int tile = split_tile(n_clips, n_frames, slots, 1, kMaxTile);
  plan[kPlanTile] = tile;
  plan[kPlanTiles] = tile ? (n_frames + tile - 1) / tile : 1;
  plan[kPlanFloats] = tile ? n_frames : 0;
  if (tile) {
    plan[kPlanPerSM] = per_sm;
    return 0;
  }
  return gat_yin_blocks_per_sm(win, hop, n_frames, max_p,
                               &plan[kPlanPerSM]);
}

// The split route: tiles of `tile` frames, one block a tile; `scratch`
// holds n_clips x n_frames floats, every frame's f0. Two launches: the
// tiles, then the medians.
extern "C" int gat_yin_split(const float* clips, float* out, float* scratch,
                             int n_clips, int n_samples, int frame_length,
                             int win, int hop, int n_frames, int min_p,
                             int max_p, float threshold, float sr, int tile,
                             void* stream) {
  if (n_frames < 1 || tile < 1 || !scratch) return (int)cudaErrorInvalidValue;
  const int tiles = (n_frames + tile - 1) / tile;
  const int group = yin_tile_group(win, hop, tile, max_p);
  if (group == 0 || (long long)n_clips * tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = yin_tile_smem_bytes(win, hop, group, max_p);
  cudaError_t err = yin_tile_attributes(bytes);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const int grid = n_clips * tiles;
  yin_tile_kernel<<<grid, kThreads, bytes, s>>>(
      clips, scratch, n_samples, frame_length, win, hop, n_frames, group,
      tile, tiles, min_p, max_p, threshold, sr);
  yin_median_kernel<<<n_clips, kThreads, 0, s>>>(scratch, out, n_frames);
  return (int)cudaGetLastError();
}
