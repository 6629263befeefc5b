// K2: the MLP's MFCC front-end, clips (N, L) -> MFCC mean (N, n_mfcc).
//
// Replaces the TPU kernel gat_tpu/ops/pallas/mfcc_frontend.py::
// mfcc_mean_pallas, deleted in 1951c8f; the live reference is
// gat_tpu/features.py::mfcc_feature_vectors (spectral.mfcc, then the mean
// over frames). Per clip:
//   1. volume normalization y / (rms + 1e-9) (when asked for), applied as
//      the scale 1 / (rms + eps)^2 on the power;
//   2. hop-`hop` frames over a zero center pad of n_fft/2, periodic Hann,
//      a 2048-point DFT, |X|^2 on the 1025 rfft bins;
//   3. the Slaney mel projection (128 bands) over each band's nonzero bins;
//   4. 10*log10(max(., 1e-10)), then the clamp at peak - top_db, with the
//      peak over all frames and bands of the clip;
//   5. the mean over frames, then one orthonormal DCT-II. The DCT commutes
//      with the mean, so it runs once per clip instead of once per frame.
//
// What bounds it: per clip the 11 real-input FFTs need 0.62 M fp32 flops
// against 22 KB read and 256 B written, so its roofline bound is the fp32
// operation rate. The clamp needs the whole clip's mel image before any
// coefficient can be formed, so one block of 256 threads owns one clip.
// Steps 2-5 are mfcc_mean.cuh, which K6 shares. Steps 2 and 3 are K1's
// round loop (mel_rounds.cuh): two adjacent frames per complex FFT as
// register Stockham passes, four frames in flight, the mel spread over
// all threads; the clip is read through L1, never copied
// to shared memory. An 11-frame clip takes 3 rounds: (0,1)(2,3),
// (4,5)(6,7), (8,9)(10,-). The epilogue keeps the 11 x 128 dB image in
// shared memory; each thread folds the values it writes into a running
// max, so the peak costs one block reduction at the end. The mean over
// frames takes one thread per band, and the DCT (4 parts of the bands for
// each coefficient) all 256 threads. Shared memory: the rounds' 2 x 2 x
// 2048 floats of exchange and 128 x 36 of partial sums, and the image,
// 56,832 bytes for 11 frames, so four blocks fit on an SM with
// __launch_bounds__(256, 4). A clip whose image does not fit beside the
// rounds' buffers in a block's shared memory (355 frames or more at 128
// mels) keeps it in a workspace in device memory that the caller passes,
// n_frames x n_mels floats per clip (the kernel's kImageInSmem = false
// instance); the max, the clamp and the mean read the same floats in the
// same order.
//
// Clips of any length. Where one block a clip leaves the card under-filled
// (dsp_common.cuh), the split route cuts each clip's frames into tiles,
// one block a tile, in four launches (mfcc_mean.cuh's split steps): the
// lane sums of squares of each chunk of a clip's samples, a block a chunk
// (mel_rounds.cuh, which each tile sums into the one-block route's
// divisor); each tile's rounds into the dB image in device memory and its
// peak; the sums of each chunk of kMeanChunk frames clamped at the clip's
// peak - top_db; per clip the sum of its chunks' sums in order, the mean
// and the DCT. No block waits for another, none reads a whole clip or
// its whole image, the last step reads chunks x n_mels sums a clip, and the mean is
// the one-block route's float (its frames summed in the same chunks).
#include "mfcc_mean.cuh"

using namespace gat;

static size_t mfcc_smem_bytes(int n_mels, int n_frames) {
  return sizeof(float) *
         (size_t)mfcc_mean_floats(
             n_mels, mfcc_image_in_smem(n_mels, n_frames) ? n_frames : 0);
}

template <bool kImageInSmem>
__global__ void __launch_bounds__(kThreads, 4)
mfcc_frontend_kernel(const float* __restrict__ clips,
                     float* __restrict__ out,
                     const float* __restrict__ hann,
                     const float* __restrict__ tw,
                     const float* __restrict__ fb,
                     const int* __restrict__ lo, const int* __restrict__ hi,
                     const float* __restrict__ dct, float* workspace,
                     int n_samples, int hop, int n_frames, int n_mels,
                     int n_mfcc, int normalize, float top_db) {
  extern __shared__ float smem[];
  const float* clip = clips + (size_t)blockIdx.x * n_samples;
  const float scale = power_scale(clip, n_samples, normalize, smem);
  float* img = kImageInSmem
                   ? smem + mel_rounds_floats(n_mels)
                   : workspace + (size_t)blockIdx.x * n_frames * n_mels;
  mfcc_mean(clip, n_samples, hop, n_frames, n_mels, n_mfcc, scale, top_db,
            hann, tw, fb, lo, hi, dct, smem, img,
            out + (size_t)blockIdx.x * n_mfcc);
}

using MfccKernel = decltype(&mfcc_frontend_kernel<true>);

static MfccKernel mfcc_kernel(int n_mels, int n_frames) {
  return mfcc_image_in_smem(n_mels, n_frames) ? mfcc_frontend_kernel<true>
                                              : mfcc_frontend_kernel<false>;
}

static cudaError_t mfcc_set_attributes(int n_mels, int n_frames) {
  return cudaFuncSetAttribute(
      mfcc_kernel(n_mels, n_frames),
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)mfcc_smem_bytes(n_mels, n_frames));
}

// Floats of device-memory workspace per clip that a launch at these sizes
// needs: 0 when the dB image stays in shared memory.
extern "C" int gat_mfcc_workspace_floats(int n_mels, int n_frames) {
  return mfcc_image_in_smem(n_mels, n_frames) ? 0 : n_frames * n_mels;
}

extern "C" int gat_mfcc_frontend(const float* clips, float* out,
                                 const float* hann, const float* tw,
                                 const float* fb, const int* lo,
                                 const int* hi, const float* dct,
                                 float* workspace, int n_clips,
                                 int n_samples, int hop, int n_frames,
                                 int n_mels, int n_mfcc, int normalize,
                                 float top_db, void* stream) {
  if (n_frames < 1 || !mfcc_epilogue_fits(n_mels, n_mfcc) ||
      (gat_mfcc_workspace_floats(n_mels, n_frames) > 0 && !workspace))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = mfcc_set_attributes(n_mels, n_frames);
  if (err != cudaSuccess) return (int)err;
  const MfccKernel kernel = mfcc_kernel(n_mels, n_frames);
  kernel<<<n_clips, kThreads, mfcc_smem_bytes(n_mels, n_frames),
           (cudaStream_t)stream>>>(
      clips, out, hann, tw, fb, lo, hi, dct, workspace, n_samples, hop,
      n_frames, n_mels, n_mfcc, normalize, top_db);
  return (int)cudaGetLastError();
}

// Resident blocks per SM at these sizes, as the CUDA runtime computes it
// from the kernel's registers and shared memory.
extern "C" int gat_mfcc_blocks_per_sm(int n_mels, int n_frames,
                                      int* blocks) {
  if (n_frames < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = mfcc_set_attributes(n_mels, n_frames);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, mfcc_kernel(n_mels, n_frames), kThreads,
      mfcc_smem_bytes(n_mels, n_frames));
}

// ---------------------------------------------------------------------------
// The split route
// ---------------------------------------------------------------------------
// Block b: the lane sums of squares of chunk b % chunks of clip b /
// chunks (mel_rounds.cuh::chunk_lane_sums), the volume divisor's parts.
__global__ void __launch_bounds__(kThreads)
mfcc_divisor_kernel(const float* __restrict__ clips,
                    float* __restrict__ sums, int n_samples) {
  chunk_lane_sums(clips, n_samples, sums);
}

// Block b runs tile b % tiles of clip b / tiles: its frames' dB values,
// scaled by the clip's divisor from its chunks' lane sums (none: not
// normalized), into the clip's image, its peak into peaks[b].
__global__ void __launch_bounds__(kThreads, 4)
mfcc_tile_kernel(const float* __restrict__ clips,
                 const float* __restrict__ sums,
                 const float* __restrict__ hann,
                 const float* __restrict__ tw,
                 const float* __restrict__ fb, const int* __restrict__ lo,
                 const int* __restrict__ hi, float* __restrict__ img,
                 float* __restrict__ peaks, int n_samples, int hop,
                 int n_frames, int n_mels, int tile, int tiles) {
  extern __shared__ float smem[];
  const int c = blockIdx.x / tiles;
  const int t0 = (blockIdx.x - c * tiles) * tile;
  const int t1 = t0 + tile < n_frames ? t0 + tile : n_frames;
  const float scale =
      sums ? divisor_scale(summed_divisor(
                 sums + (size_t)c * divisor_chunks(n_samples) * kThreads,
                 n_samples, smem))
           : 0.25f;
  const float peak = mfcc_tile_db(
      clips + (size_t)c * n_samples, n_samples, hop, t0, t1, n_mels, scale,
      hann, tw, fb, lo, hi, smem, img + (size_t)c * n_frames * n_mels);
  if (threadIdx.x == 0) peaks[blockIdx.x] = peak;
}

// Block b sums chunk b % chunks of clip b / chunks into sums[b * n_mels..].
__global__ void __launch_bounds__(kThreads)
mfcc_sums_kernel(const float* __restrict__ img,
                 const float* __restrict__ peaks,
                 float* __restrict__ sums, int n_frames, int n_mels,
                 int tiles, float top_db) {
  const int chunks = mean_chunks(n_frames);
  const int c = blockIdx.x / chunks;
  mfcc_chunk_sums(img + (size_t)c * n_frames * n_mels,
                  peaks + (size_t)c * tiles, tiles, blockIdx.x - c * chunks,
                  n_frames, n_mels, top_db,
                  sums + (size_t)blockIdx.x * n_mels);
}

// Block c: clip c's mean MFCC from its chunks' sums.
__global__ void __launch_bounds__(kThreads)
mfcc_mean_kernel(const float* __restrict__ sums,
                 const float* __restrict__ dct, float* __restrict__ out,
                 int n_frames, int n_mels, int n_mfcc) {
  extern __shared__ float smem[];
  mfcc_chunks_mean(sums + (size_t)blockIdx.x * mean_chunks(n_frames) * n_mels,
                   n_frames, n_mels, n_mfcc, dct, smem,
                   out + (size_t)blockIdx.x * n_mfcc);
}

static size_t mfcc_tile_smem_bytes(int n_mels) {
  return sizeof(float) * (size_t)mel_rounds_floats(n_mels);
}

static cudaError_t mfcc_tile_attributes(int n_mels) {
  return cudaFuncSetAttribute(mfcc_tile_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)mfcc_tile_smem_bytes(n_mels));
}

// Floats of scratch a clip on the split route: its divisor's lane sums,
// its tiles' peaks, its chunks' sums and its dB image.
static long long mfcc_split_floats(int n_samples, int n_frames, int n_mels,
                                   int tiles) {
  return (long long)divisor_chunks(n_samples) * kThreads + tiles +
         (long long)mean_chunks(n_frames) * n_mels +
         (long long)n_frames * n_mels;
}

// The launch at these sizes on the current device: plan[kPlanTile] frames
// a tile (0: one block a clip), plan[kPlanTiles] tiles a clip,
// plan[kPlanPerSM] the resident blocks per SM of the kernel that runs the
// rounds, plan[kPlanFloats] floats of scratch a clip (one block: the
// workspace of gat_mfcc_workspace_floats).
extern "C" int gat_mfcc_plan(int n_clips, int n_samples, int n_frames,
                             int n_mels, int* plan) {
  if (n_frames < 1 || n_clips < 0 || n_samples < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = mfcc_tile_attributes(n_mels);
  long long slots = 0;
  int per_sm = 0;
  if (err == cudaSuccess)
    err = card_slots(mfcc_tile_kernel, mfcc_tile_smem_bytes(n_mels), &slots,
                     &per_sm);
  if (err != cudaSuccess) return (int)err;
  const int tile =
      split_tile(n_clips, n_frames, slots, kInFlight, kNoMaxTile);
  plan[kPlanTile] = tile;
  plan[kPlanTiles] = tile ? (n_frames + tile - 1) / tile : 1;
  if (tile) {
    const long long floats =
        mfcc_split_floats(n_samples, n_frames, n_mels, plan[kPlanTiles]);
    if (floats > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    plan[kPlanPerSM] = per_sm;
    plan[kPlanFloats] = (int)floats;
    return 0;
  }
  plan[kPlanFloats] = gat_mfcc_workspace_floats(n_mels, n_frames);
  return gat_mfcc_blocks_per_sm(n_mels, n_frames, &plan[kPlanPerSM]);
}

// The split route: tiles of `tile` frames (even, so that each FFT pairs
// the one-block route's frames), one block a tile; `scratch` holds
// n_clips x (divisor_chunks(n_samples) x kThreads + tiles + chunks x
// n_mels + n_frames x n_mels) floats (plan[kPlanFloats] a clip; chunks =
// mean_chunks(n_frames)). Four launches: the divisor's lane sums, a
// block a chunk of samples (when `normalize`), the tiles' dB and peaks,
// the chunks' clamped sums, the means.
extern "C" int gat_mfcc_split(const float* clips, float* out, float* scratch,
                              const float* hann, const float* tw,
                              const float* fb, const int* lo, const int* hi,
                              const float* dct, int n_clips, int n_samples,
                              int hop, int n_frames, int n_mels, int n_mfcc,
                              int normalize, float top_db, int tile,
                              void* stream) {
  if (n_frames < 1 || n_samples < 1 || tile < 2 || tile % 2 != 0 ||
      !scratch || !mfcc_epilogue_fits(n_mels, n_mfcc))
    return (int)cudaErrorInvalidValue;
  const int tiles = (n_frames + tile - 1) / tile;
  const int div_chunks = divisor_chunks(n_samples);
  if ((long long)n_clips * tiles > 0x7fffffffLL ||
      (long long)n_clips * mean_chunks(n_frames) > 0x7fffffffLL ||
      (long long)n_clips * div_chunks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = mfcc_tile_attributes(n_mels);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  float* lanes = scratch;
  float* peaks = lanes + (size_t)n_clips * div_chunks * kThreads;
  float* sums = peaks + (size_t)n_clips * tiles;
  float* img = sums + (size_t)n_clips * mean_chunks(n_frames) * n_mels;
  if (normalize) {
    mfcc_divisor_kernel<<<n_clips * div_chunks, kThreads, 0, s>>>(
        clips, lanes, n_samples);
  }
  const int grid = n_clips * tiles;
  mfcc_tile_kernel<<<grid, kThreads, mfcc_tile_smem_bytes(n_mels), s>>>(
      clips, normalize ? lanes : nullptr, hann, tw, fb, lo, hi, img,
      peaks, n_samples, hop, n_frames, n_mels, tile, tiles);
  const int chunk_grid = n_clips * mean_chunks(n_frames);
  mfcc_sums_kernel<<<chunk_grid, kThreads, 0, s>>>(img, peaks, sums,
                                                   n_frames, n_mels, tiles,
                                                   top_db);
  const size_t mean_bytes =
      sizeof(float) * (size_t)(n_mels + kDctParts * n_mfcc);
  mfcc_mean_kernel<<<n_clips, kThreads, mean_bytes, s>>>(
      sums, dct, out, n_frames, n_mels, n_mfcc);
  return (int)cudaGetLastError();
}
