// K1: the CNN's mel front-end, clips (N, L) -> mel image (N, n_mels, T, 1).
//
// Replaces the TPU kernel melspec_pallas
// (1951c8f^:gat_tpu/ops/pallas/melspec_frontend.py:71) and its block-DFT
// form melspec_block_pallas (1951c8f^:gat_tpu/ops/pallas/blockmel.py:123);
// the live reference is gat_tpu/features.py::melspec_features. Per clip:
// volume normalization y / (rms + 1e-9) (when asked for), reflect center
// pad of n_fft/2, hop-`hop` frames with a periodic Hann window, a
// 2048-point DFT, |X|^2 on the 1025 rfft bins, the HTK mel projection,
// 10*log10(max(., 1e-10)) (when to_db), the image written NHWC once.
//
// What bounds it: the fp32 rate of 22 real 2048-point FFTs per 0.5 s clip
// (22 * 2.5 * 2048 * 11 = 1.24 M flops against 22 KB read and 5.6 KB
// written), not memory. One block of 256 threads owns one clip. What each
// part of the design does about what held the first version of this kernel
// back:
//   1. A complex FFT on real data -> two frames per FFT: frames t (real
//      part) and t + 1 (imaginary part) share one complex transform Z,
//      split on the power bins as X_t = (Z[k] + conj Z[-k]) / 2 and
//      X_t+1 = (Z[k] - conj Z[-k]) / 2i. Adjacent frames are paired, so
//      the two differ little in level; an odd last frame runs with a zero
//      partner. 11 transforms per 22-frame clip instead of 22.
//   2. One frame at a time, a barrier per radix-2 stage -> Stockham passes
//      in registers (fft_stockham.cuh): 128 threads run one transform, 16
//      values each, as radix 16, 16 and 8 passes with two shared-memory
//      exchanges. The last pass leaves X[k] and X[2048 - k] in the same
//      thread, so the split needs no third exchange.
//   3. Bank conflicts in the bit-reversed staging and the twiddle reads ->
//      nothing is stored bit-reversed: the first pass reads its samples
//      straight from the clip in device memory (L1-cached, reflect index
//      per sample), the exchanges go through an XOR swizzle that gives
//      every warp 32 distinct banks, and the twiddles are per-pass tables
//      (computed by the host in float64) that a warp reads contiguously.
//   4. Threads idle in the mel -> each band's nonzero bins are cut into 8
//      equal parts; every (band, part) item sums its bins for the four
//      frames in flight at once (one filterbank load, four FMAs), the items
//      spread over all 256 threads, and one thread per (band, frame) then
//      sums the band's 8 parts. fp32, no tensor cores.
//   5. Low occupancy (2 blocks of 256 threads per SM) -> the clip is not
//      copied into shared memory, and the power bins reuse the FFT's
//      exchange buffer: 47,616 bytes of shared memory for 64 mels and 22
//      frames, and __launch_bounds__(256, 4), so four blocks fit on an SM.
//      The two halves of a block run two frame pairs at once (four frames
//      in flight), so a 22-frame clip takes 6 rounds of 6 barriers: 3 in
//      the FFT, 1 before the power bins overwrite the exchange buffer, 1
//      after them, 1 after the mel partial sums.
// Items 1, 2 and 4 are the round loop of mel_rounds.cuh, which K2
// (mfcc_frontend.cu) shares with a zero pad and its own epilogue.
// A clip whose image does not fit beside the rounds' buffers in a block's
// shared memory (745 frames or more at 64 mels) writes each value straight
// into the output, which is the image (the kernel's kImageInSmem = false
// instance): the same values, stored one at a time instead of once as a
// whole.
//
// Clips of any length. Where one block a clip leaves the card under-filled
// (dsp_common.cuh: fewer clips than resident blocks, at least 64 frames),
// the split route cuts each clip's frames into tiles, one block a tile
// (melspec_tile_kernel), each writing its frames' values straight into the
// image. The image is per frame; the one per-clip term is the volume
// scale: a pre-pass sums the squares of each chunk of the clip in a block
// of its own (melspec_divisor_kernel), and each tile sums those lane sums
// into the one-block route's divisor (mel_rounds.cuh::summed_divisor),
// so no block reads a whole clip. A tile is an even number
// of frames, so every FFT pairs the frames the one-block route pairs and
// the image is that route's bit for bit.
#include "mel_rounds.cuh"

using namespace gat;

__host__ __device__ constexpr bool melspec_image_in_smem(int n_mels,
                                                        int n_frames) {
  return sizeof(float) *
             (size_t)(mel_rounds_floats(n_mels) + n_mels * n_frames) <=
         kMaxBlockSmem;
}

static size_t melspec_smem_bytes(int n_mels, int n_frames) {
  return sizeof(float) *
         (size_t)(mel_rounds_floats(n_mels) +
                  (melspec_image_in_smem(n_mels, n_frames) ? n_mels * n_frames
                                                           : 0));
}

template <bool kImageInSmem>
__global__ void __launch_bounds__(kThreads, 4)
melspec_frontend_kernel(const float* __restrict__ clips,
                        float* __restrict__ out,
                        const float* __restrict__ hann,
                        const float* __restrict__ tw,
                        const float* __restrict__ fb,
                        const int* __restrict__ lo,
                        const int* __restrict__ hi, int n_samples, int hop,
                        int n_frames, int n_mels, int normalize, int to_db) {
  extern __shared__ float smem[];
  float* o = out + (size_t)blockIdx.x * n_mels * n_frames;
  // n_mels x n_frames
  float* img = kImageInSmem ? smem + mel_rounds_floats(n_mels) : o;

  const float* clip = clips + (size_t)blockIdx.x * n_samples;
  const float scale = power_scale(clip, n_samples, normalize, smem);

  mel_rounds</*kReflect=*/true>(
      clip, n_samples, hop, 0, n_frames, n_mels, hann, tw, fb, lo, hi, smem,
      [&](int m, int t, float v) {
        v *= scale;
        img[m * n_frames + t] = to_db ? 10.0f * log10f(fmaxf(v, 1e-10f)) : v;
      });
  if constexpr (kImageInSmem) {
    __syncthreads();
    for (int i = threadIdx.x; i < n_mels * n_frames; i += kThreads)
      o[i] = img[i];
  }
}

using MelspecKernel = decltype(&melspec_frontend_kernel<true>);

static MelspecKernel melspec_kernel(int n_mels, int n_frames) {
  return melspec_image_in_smem(n_mels, n_frames)
             ? melspec_frontend_kernel<true>
             : melspec_frontend_kernel<false>;
}

static cudaError_t melspec_set_attributes(int n_mels, int n_frames) {
  return cudaFuncSetAttribute(
      melspec_kernel(n_mels, n_frames),
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)melspec_smem_bytes(n_mels, n_frames));
}

extern "C" int gat_melspec_frontend(const float* clips, float* out,
                                    const float* hann, const float* tw,
                                    const float* fb, const int* lo,
                                    const int* hi, int n_clips,
                                    int n_samples, int hop, int n_frames,
                                    int n_mels, int normalize, int to_db,
                                    void* stream) {
  if (n_frames < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = melspec_set_attributes(n_mels, n_frames);
  if (err != cudaSuccess) return (int)err;
  const MelspecKernel kernel = melspec_kernel(n_mels, n_frames);
  kernel<<<n_clips, kThreads, melspec_smem_bytes(n_mels, n_frames),
           (cudaStream_t)stream>>>(
      clips, out, hann, tw, fb, lo, hi, n_samples, hop, n_frames, n_mels,
      normalize, to_db);
  return (int)cudaGetLastError();
}

// Resident blocks per SM at these sizes, as the CUDA runtime computes it
// from the kernel's registers and shared memory.
extern "C" int gat_melspec_blocks_per_sm(int n_mels, int n_frames,
                                         int* blocks) {
  if (n_frames < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = melspec_set_attributes(n_mels, n_frames);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, melspec_kernel(n_mels, n_frames), kThreads,
      melspec_smem_bytes(n_mels, n_frames));
}

// ---------------------------------------------------------------------------
// The split route
// ---------------------------------------------------------------------------
// Block b: the lane sums of squares of chunk b % chunks of clip b /
// chunks (mel_rounds.cuh::chunk_lane_sums), the volume divisor's parts.
__global__ void __launch_bounds__(kThreads)
melspec_divisor_kernel(const float* __restrict__ clips,
                       float* __restrict__ sums, int n_samples) {
  chunk_lane_sums(clips, n_samples, sums);
}

// Block b runs tile b % tiles of clip b / tiles: frames [t0, t0 + tile)
// of the clip, cut at n_frames, scaled by the clip's divisor from its
// chunks' lane sums (none: not normalized).
__global__ void __launch_bounds__(kThreads, 4)
melspec_tile_kernel(const float* __restrict__ clips, float* __restrict__ out,
                    const float* __restrict__ sums,
                    const float* __restrict__ hann,
                    const float* __restrict__ tw,
                    const float* __restrict__ fb,
                    const int* __restrict__ lo, const int* __restrict__ hi,
                    int n_samples, int hop, int n_frames, int n_mels,
                    int tile, int tiles, int to_db) {
  extern __shared__ float smem[];
  const int c = blockIdx.x / tiles;
  const int t0 = (blockIdx.x - c * tiles) * tile;
  const int t1 = t0 + tile < n_frames ? t0 + tile : n_frames;
  const float scale =
      sums ? divisor_scale(summed_divisor(
                 sums + (size_t)c * divisor_chunks(n_samples) * kThreads,
                 n_samples, smem))
           : 0.25f;
  float* o = out + (size_t)c * n_mels * n_frames;
  mel_rounds</*kReflect=*/true>(
      clips + (size_t)c * n_samples, n_samples, hop, t0, t1, n_mels, hann,
      tw, fb, lo, hi, smem, [&](int m, int t, float v) {
        v *= scale;
        o[(size_t)m * n_frames + t] =
            to_db ? 10.0f * log10f(fmaxf(v, 1e-10f)) : v;
      });
}

static size_t melspec_tile_smem_bytes(int n_mels) {
  return sizeof(float) * (size_t)mel_rounds_floats(n_mels);
}

static cudaError_t melspec_tile_attributes(int n_mels) {
  return cudaFuncSetAttribute(melspec_tile_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)melspec_tile_smem_bytes(n_mels));
}

// The launch at these sizes on the current device: plan[kPlanTile] frames
// a tile (0: one block a clip), plan[kPlanTiles] tiles a clip,
// plan[kPlanPerSM] the resident blocks per SM of the kernel the route
// runs, plan[kPlanFloats] floats of scratch a clip (the split route's
// lane sums of the volume divisor when normalizing).
extern "C" int gat_melspec_plan(int n_clips, int n_samples, int n_frames,
                                int n_mels, int normalize, int* plan) {
  if (n_frames < 1 || n_clips < 0 || n_samples < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = melspec_tile_attributes(n_mels);
  long long slots = 0;
  int per_sm = 0;
  if (err == cudaSuccess)
    err = card_slots(melspec_tile_kernel, melspec_tile_smem_bytes(n_mels),
                     &slots, &per_sm);
  if (err != cudaSuccess) return (int)err;
  const int tile =
      split_tile(n_clips, n_frames, slots, kInFlight, kNoMaxTile);
  plan[kPlanTile] = tile;
  plan[kPlanTiles] = tile ? (n_frames + tile - 1) / tile : 1;
  plan[kPlanFloats] =
      tile && normalize ? divisor_chunks(n_samples) * kThreads : 0;
  if (tile) {
    plan[kPlanPerSM] = per_sm;
    return 0;
  }
  return gat_melspec_blocks_per_sm(n_mels, n_frames, &plan[kPlanPerSM]);
}

// The split route: tiles of `tile` frames (even, so that each FFT pairs
// the one-block route's frames), one block a tile; `scratch` holds
// n_clips x divisor_chunks(n_samples) x kThreads floats, the clips'
// chunks' lane sums of squares, when `normalize` (else it may be NULL).
// Two launches: the lane sums, a block a chunk, then the tiles.
extern "C" int gat_melspec_split(const float* clips, float* out,
                                 float* scratch, const float* hann,
                                 const float* tw, const float* fb,
                                 const int* lo, const int* hi, int n_clips,
                                 int n_samples, int hop, int n_frames,
                                 int n_mels, int normalize, int to_db,
                                 int tile, void* stream) {
  if (n_frames < 1 || n_samples < 1 || tile < 2 || tile % 2 != 0 ||
      (normalize && !scratch))
    return (int)cudaErrorInvalidValue;
  const int tiles = (n_frames + tile - 1) / tile;
  const long long chunk_grid = (long long)n_clips * divisor_chunks(n_samples);
  if ((long long)n_clips * tiles > 0x7fffffffLL || chunk_grid > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = melspec_tile_attributes(n_mels);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  if (normalize) {
    melspec_divisor_kernel<<<(int)chunk_grid, kThreads, 0, s>>>(
        clips, scratch, n_samples);
  }
  const int grid = n_clips * tiles;
  melspec_tile_kernel<<<grid, kThreads, melspec_tile_smem_bytes(n_mels),
                        s>>>(
      clips, out, normalize ? scratch : nullptr, hann, tw, fb, lo, hi,
      n_samples, hop, n_frames, n_mels, tile, tiles, to_db);
  return (int)cudaGetLastError();
}
