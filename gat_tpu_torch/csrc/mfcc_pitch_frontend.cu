// K6: the shared MFCC and YIN front-end of the matmul route, clips (N, L)
// -> features (N, n_mfcc + 1), the MFCC mean then log10 of the YIN pitch,
// and the pitch (N,) in Hz.
//
// Replaces gat_tpu/features.py::_fused_mfcc_mean_and_pitch, which the JAX
// package runs as XLA code: one hop-block DFT of the raw clips, from which
// both the MFCC mean (Hann applied in frequency, mel, dB, DCT) and the YIN
// CMND are formed, the volume scale applied to the shared coefficients by
// linearity. Here one launch computes both branches of each clip; per
// clip:
//   1. d = rms + 1e-9 in K2's order of summation (power_scale's), when
//      `normalize` is on;
//   2. the MFCC branch is K2's (mfcc_mean.cuh), reading the clip from
//      device memory through L1 as K2 does, the power scaled by 1 / d^2
//      when `normalize` is on;
//   3. as the rounds end, YIN's zero-padded copy of the clip is started
//      into the part of the buffer that the MFCC epilogue leaves alone
//      (cp.async, 16 bytes a copy where the row allows it, else 4), and
//      lands while the clamp, the mean and the DCT run;
//   4. the YIN branch is K3's (yin_acf.cuh) over that copy, divided in
//      place by d first when both `normalize` and `pitch_normalized` are
//      on (the JAX function's pitch-source rule): the direct ACF, 8
//      chains per lag, with the chains that overlapping frames share
//      computed once (acf_shared_chains), the fp64 energy prefix, the
//      CMND, then the trough walk one warp per frame (frame_f0_warps),
//      the parabolic shift and the median of the f0 placed by rank;
//   5. thread 0 writes log10(hz) after the n_mfcc coefficients, and hz.
// So K6 gives K2's coefficients and K3's pitch of the same clip bit for
// bit, in one launch where the FFT route has two. It runs K3's direct ACF
// rather than deriving the ACF from the MFCC branch's spectrum: the
// FFT-free 8-chain sums are what hold K3's near-tie pin.
//
// What bounds it: operations. The function's least work is one unwindowed
// FFT per frame shared by both branches, the window applied in frequency,
// and the ACF from FFTs: 2.2 M fp32 flops per 0.5 s clip at 11025 Hz
// (utils/roofline.py::mfcc_pitch_cost) against 22 KB read. This kernel
// does K2's 0.76 M flops and a direct ACF of 48 distinct (hop-block,
// segment) chains per lag instead of the 88 (frame, segment) units of
// K3: 1.36 M multiply-adds a clip instead of 2.50 M (11 frames, 222
// lags), in 6 rounds of 8 warps instead of 11. One block of 256 threads
// owns one clip (the clamp needs the whole mel image, the median every
// frame's f0). The serial tails of K3 (one thread per frame walking up to
// 212 lags for the trough, an insertion sort on thread 0) cost K6 a fifth
// of its time once the ACF was shared; here a warp tests 32 lags of a
// frame at once and every thread ranks one f0, with the same comparisons,
// so the pitch stays K3's float.
//
// Shared memory is one buffer of K2's size that both branches use
// (FrontendLayout, in floats, at 11 frames of 128 mels): the rounds'
// exchange [0, 8192) and partial sums [8192, 12800), then the dB image
// [12800, 14208); the epilogue keeps its scratch, means and DCT parts in
// the first 640 (896 reserved for n_mfcc up to n_mels); YIN's padded clip
// takes [896, 7265), free once the rounds end, and the YIN tables
// (energy chunks, ACF, the chains' table, f0: 25,204 bytes) follow it once
// the epilogue is done. 56,832 bytes in all, as K2's, so with
// __launch_bounds__(256, 4) four blocks fit on an SM, where staging the
// clip before the rounds (26,240 bytes more) fitted two. The price is a
// second read of each clip, for YIN, which hits L2: about 528 clips of 22
// KB are in flight on the card's 132 SMs, against a 50 MB L2. Longer
// clips put the YIN copy after the dB image and the tables at the start of
// the buffer when the copy does not fit in the exchange buffer.
//
// Clips of any length: YIN runs in groups of
// frames (yin_acf.cuh), the first group's copy started by the hook as
// above, each later one staged when the last is done; the group is the
// largest that fits the shared memory a block has at the occupancy the
// MFCC branch allows (four blocks at 11 frames, where the group is the
// whole clip and the layout the one above). Chains that cross a group's
// end are summed again in the next group, from the same samples in the
// same order, so every frame's f0 is the same float. Where the dB image
// and a group of YIN do not fit beside the rounds' buffers (355 frames or
// more at 128 mels, as in K2), the image goes to a workspace in device
// memory that the caller passes, n_frames x n_mels floats per clip.
//
// Where one block a clip leaves the card under-filled, or a clip has more
// frames than kMaxTile, the split route (dsp_common.cuh) cuts each clip's
// frames into tiles, one block a tile, in four launches: the lane sums
// of squares of each chunk of a clip's samples, a block a chunk
// (mel_rounds.cuh, which each tile sums into the one-block route's
// volume divisor); each
// tile's MFCC rounds into the dB image in device memory with its peak
// (K2's split steps, mfcc_mean.cuh), then YIN over the tile's frames in
// groups, every frame's f0 into device memory (the same float at any tile
// or group); each chunk's clamped sums; and per clip the mean and the DCT
// from its chunks' sums in order, and the median of its frames' f0 by a
// radix selection over device memory (yin_acf.cuh::select_median). Its
// MFCC is K2's and its raw pitch K3's bit for bit, and both are the
// one-block route's floats.
#include <cuda_pipeline.h>

#include <cstdint>
#include <initializer_list>

#include "mfcc_mean.cuh"
#include "yin_acf.cuh"

using namespace gat;

constexpr int kPad = kFFT / 2;  // YIN's zero centre pad, frame_length / 2
constexpr int kBlocksPerSM = 4;

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// The shared-memory buffer of one block, in floats: the MFCC branch's
// (mfcc_mean_floats, with the dB image when kImageInSmem), and where
// YIN's padded copy of a group of `group` frames (`clip`) and its tables
// (`tables`, in bytes, 16-byte aligned) go in it. The copy sits past the
// epilogue's buffers in the exchange buffer when it fits there, else past
// the dB image with the tables at the start.
struct FrontendLayout {
  YinLayout yin;
  int clip, floats;
  size_t tables;
  __host__ __device__ FrontendLayout(int n_frames, int n_mels, int win,
                                     int hop, int max_p, int group,
                                     bool image_in_smem)
      : yin(win, hop, group, max_p, n_frames) {
    const int mfcc = mfcc_mean_floats(n_mels, image_in_smem ? n_frames : 0);
    // the epilogue's buffers for any n_mfcc <= n_mels
    const int head = round4(mfcc_epilogue_floats(n_mels, n_mels));
    const int yin_floats = round4((int)((yin.tables + 3) / 4));
    int end;
    if (head + yin.padded_len <= 4 * kFFT) {
      clip = head;
      tables = sizeof(float) * (size_t)round4(clip + yin.padded_len);
      end = (int)(tables / sizeof(float)) + yin_floats;
    } else {
      clip = round4(mfcc);
      const bool at_start = yin_floats <= clip;
      tables = at_start ? 0 : sizeof(float) * (size_t)round4(
                                  clip + yin.padded_len);
      end = at_start ? clip + yin.padded_len
                     : (int)(tables / sizeof(float)) + yin_floats;
    }
    floats = mfcc > end ? mfcc : end;
  }
  __host__ __device__ size_t bytes() const {
    return sizeof(float) * (size_t)floats;
  }
};

// Starts copying the zero-padded samples of a group, from the padded
// clip's index `first` on, into `padded` (len floats): padded[p] =
// clip[first + p - kPad], zeros outside the clip. The zeros are stored
// now; the samples are cp.async copies, 16 bytes each where both rows are
// 16-byte aligned (an 11,025-sample row of 44,100 bytes is not, on three
// rows of four), else 4, committed as one group. Every thread waits for
// its own with __pipeline_wait_prior(0), then the block synchronizes
// before reading.
__device__ __forceinline__ void stage_yin_clip(const float* __restrict__ clip,
                                               int n_samples, int first,
                                               int len,
                                               float* __restrict__ padded) {
  const int lead = first < kPad ? kPad - first : 0;  // zeros before sample 0
  const float* src = clip + (first + lead - kPad);
  int n = n_samples - (first + lead - kPad);
  if (n > len - lead) n = len - lead;
  if (n < 0) n = 0;
  float* dst = padded + lead;
  for (int p = threadIdx.x; p < lead; p += kThreads) padded[p] = 0.0f;
  for (int p = lead + n + threadIdx.x; p < len; p += kThreads)
    padded[p] = 0.0f;
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(src) |
        reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    done = n / 4 * 4;
    for (int q = 4 * threadIdx.x; q < done; q += 4 * kThreads)
      __pipeline_memcpy_async(dst + q, src + q, 4 * sizeof(float));
  }
  for (int i = done + threadIdx.x; i < n; i += kThreads)
    __pipeline_memcpy_async(dst + i, src + i, sizeof(float));
  __pipeline_commit();
}

template <bool kImageInSmem>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
mfcc_pitch_frontend_kernel(const float* __restrict__ clips,
                           float* __restrict__ out, float* __restrict__ hz_out,
                           const float* __restrict__ hann,
                           const float* __restrict__ tw,
                           const float* __restrict__ fb,
                           const int* __restrict__ lo,
                           const int* __restrict__ hi,
                           const float* __restrict__ dct, float* workspace,
                           int n_samples, int hop, int n_frames, int n_mels,
                           int n_mfcc, int win, int min_p, int max_p,
                           int group, int normalize, int pitch_normalized,
                           float top_db, float threshold, float sr) {
  const FrontendLayout lay(n_frames, n_mels, win, hop, max_p, group,
                           kImageInSmem);
  extern __shared__ float smem[];
  float* padded = smem + lay.clip;
  char* tables = reinterpret_cast<char*>(smem) + lay.tables;
  float* f0 = reinterpret_cast<float*>(tables + lay.yin.f0);

  // 1. the volume divisor, in K2's order of summation
  const float* clip = clips + (size_t)blockIdx.x * n_samples;
  const float d = normalize ? volume_divisor(clip, n_samples, smem) : 1.0f;

  // 2-3. the MFCC mean into the row's first n_mfcc values; YIN's copy of
  // the first group is started as the rounds end
  float* row = out + (size_t)blockIdx.x * (n_mfcc + 1);
  float* img = kImageInSmem
                   ? smem + mel_rounds_floats(n_mels)
                   : workspace + (size_t)blockIdx.x * n_frames * n_mels;
  const float scale = normalize ? 0.25f / (d * d) : 0.25f;
  mfcc_mean(clip, n_samples, hop, n_frames, n_mels, n_mfcc, scale, top_db,
            hann, tw, fb, lo, hi, dct, smem, img, row, [&]() {
              stage_yin_clip(clip, n_samples, 0, lay.yin.padded_len, padded);
            });
  __pipeline_wait_prior(0);
  __syncthreads();  // the copy has landed and the epilogue is done: the
                    // rest of the buffer passes to the YIN tables

  // 4. the YIN pitch, of the normalized clip when both flags ask for it,
  // group by group
  for (int g0 = 0; g0 < n_frames; g0 += group) {
    if (g0 > 0) {
      __syncthreads();  // the last group is done with the copy
      stage_yin_clip(clip, n_samples, g0 * hop, lay.yin.padded_len, padded);
      __pipeline_wait_prior(0);
      __syncthreads();
    }
    if (normalize && pitch_normalized) {
      for (int p = threadIdx.x; p < lay.yin.padded_len; p += kThreads)
        padded[p] = padded[p] / d;
      __syncthreads();
    }
    yin_frames_f0</*kFused=*/true>(
        padded, tables, lay.yin,
        n_frames - g0 < group ? n_frames - g0 : group, f0 + g0, win, hop,
        min_p, max_p, threshold, sr);
  }
  const float hz = yin_median</*kFused=*/true>(tables, lay.yin, n_frames);
  if (threadIdx.x == 0) {
    row[n_mfcc] = log10f(hz);
    hz_out[blockIdx.x] = hz;
  }
}

using FrontendKernel = decltype(&mfcc_pitch_frontend_kernel<true>);

// How a launch at these sizes runs: the dB image in shared memory or not,
// YIN's group of frames, and the layout. The image stays in shared memory
// when some group fits beside it; the group is the largest whose buffer
// fits at the occupancy the MFCC branch alone allows (at most
// kBlocksPerSM), else the largest a block holds beside the image in device
// memory. group 0: refused.
struct FrontendPlan {
  bool image_in_smem = true;
  int group = 0;
};

static FrontendPlan frontend_plan(int n_frames, int n_mels, int n_mfcc,
                                  int win, int hop, int max_p) {
  FrontendPlan plan;
  if (n_frames < 1 || max_p < 1 ||
      n_mfcc > n_mels || !mfcc_epilogue_fits(n_mels, n_mfcc) ||
      !shared_chains_fit(win, hop))
    return plan;
  for (const bool in_smem : {true, false}) {
    const size_t mfcc =
        sizeof(float) * (size_t)mfcc_mean_floats(n_mels,
                                                 in_smem ? n_frames : 0);
    if (!smem_fits(mfcc, kMaxBlockSmem)) continue;
    const size_t budget = smem_per_block(blocks_per_sm(mfcc, kBlocksPerSM));
    plan.image_in_smem = in_smem;
    plan.group = yin_group(win, hop, n_frames, max_p, budget, [&](int g) {
      return FrontendLayout(n_frames, n_mels, win, hop, max_p, g, in_smem)
          .bytes();
    });
    if (plan.group > 0) break;
  }
  if (plan.group == 0) {  // a clip whose f0 table crowds out any group at
                          // that occupancy: the largest group a block holds
    plan.image_in_smem = false;
    plan.group = yin_group(win, hop, n_frames, max_p, kMaxBlockSmem,
                           [&](int g) {
                             return FrontendLayout(n_frames, n_mels, win, hop,
                                                   max_p, g, false)
                                 .bytes();
                           });
  }
  return plan;
}

static FrontendKernel frontend_kernel(const FrontendPlan& plan) {
  return plan.image_in_smem ? mfcc_pitch_frontend_kernel<true>
                            : mfcc_pitch_frontend_kernel<false>;
}

static FrontendLayout frontend_layout(const FrontendPlan& plan, int n_frames,
                                      int n_mels, int win, int hop,
                                      int max_p) {
  return FrontendLayout(n_frames, n_mels, win, hop, max_p, plan.group,
                        plan.image_in_smem);
}

static cudaError_t frontend_set_attributes(const FrontendPlan& plan,
                                           const FrontendLayout& lay) {
  return cudaFuncSetAttribute(frontend_kernel(plan),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)lay.bytes());
}

// Floats of device-memory workspace per clip that a launch at these sizes
// needs (0: the dB image stays in shared memory), or -1 when it is
// refused.
extern "C" int gat_mfcc_pitch_workspace_floats(int n_frames, int n_mels,
                                               int n_mfcc, int win, int hop,
                                               int max_p) {
  const FrontendPlan plan =
      frontend_plan(n_frames, n_mels, n_mfcc, win, hop, max_p);
  if (plan.group == 0) return -1;
  return plan.image_in_smem ? 0 : n_frames * n_mels;
}

// YIN's group of frames at these sizes (0: refused).
extern "C" int gat_mfcc_pitch_group(int n_frames, int n_mels, int n_mfcc,
                                    int win, int hop, int max_p) {
  return frontend_plan(n_frames, n_mels, n_mfcc, win, hop, max_p).group;
}

extern "C" int gat_mfcc_pitch_frontend(
    const float* clips, float* out, float* hz, const float* hann,
    const float* tw, const float* fb, const int* lo, const int* hi,
    const float* dct, float* workspace, int n_clips, int n_samples, int hop,
    int n_frames, int n_mels, int n_mfcc, int win, int min_p, int max_p,
    int normalize, int pitch_normalized, float top_db, float threshold,
    float sr, void* stream) {
  const FrontendPlan plan =
      frontend_plan(n_frames, n_mels, n_mfcc, win, hop, max_p);
  if (plan.group == 0 || (!plan.image_in_smem && !workspace))
    return (int)cudaErrorInvalidValue;
  const FrontendLayout lay =
      frontend_layout(plan, n_frames, n_mels, win, hop, max_p);
  cudaError_t err = frontend_set_attributes(plan, lay);
  if (err != cudaSuccess) return (int)err;
  const FrontendKernel kernel = frontend_kernel(plan);
  kernel<<<n_clips, kThreads, lay.bytes(), (cudaStream_t)stream>>>(
      clips, out, hz, hann, tw, fb, lo, hi, dct, workspace, n_samples, hop,
      n_frames, n_mels, n_mfcc, win, min_p, max_p, plan.group, normalize,
      pitch_normalized, top_db, threshold, sr);
  return (int)cudaGetLastError();
}

// Resident blocks per SM at these sizes, as the CUDA runtime computes it
// from the kernel's registers and shared memory.
extern "C" int gat_mfcc_pitch_frontend_blocks_per_sm(int n_samples, int hop,
                                                     int n_frames, int n_mels,
                                                     int win, int max_p,
                                                     int* blocks) {
  (void)n_samples;  // the buffer depends on the frame count only
  const FrontendPlan plan =
      frontend_plan(n_frames, n_mels, n_mels, win, hop, max_p);
  if (plan.group == 0) return (int)cudaErrorInvalidValue;
  const FrontendLayout lay =
      frontend_layout(plan, n_frames, n_mels, win, hop, max_p);
  cudaError_t err = frontend_set_attributes(plan, lay);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, frontend_kernel(plan), kThreads, lay.bytes());
}

// ---------------------------------------------------------------------------
// The split route
// ---------------------------------------------------------------------------
constexpr int kMaxTile = 512;  // frames the one-block route takes alone

// Block b: the lane sums of squares of chunk b % chunks of clip b /
// chunks (mel_rounds.cuh::chunk_lane_sums), the volume divisor's parts.
__global__ void __launch_bounds__(kThreads)
mfcc_pitch_divisor_kernel(const float* __restrict__ clips,
                          float* __restrict__ sums, int n_samples) {
  chunk_lane_sums(clips, n_samples, sums);
}

// The split route's shared memory for groups of `group` frames: the
// rounds' buffers, then over them YIN's tables at 0 and its padded copy
// of a group past them. Bytes.
struct TileLayout {
  YinLayout yin;
  size_t clip, bytes;
  __host__ __device__ TileLayout(int n_mels, int win, int hop, int max_p,
                                 int group)
      : yin(win, hop, group, max_p) {
    clip = (yin.tables + 15) / 16 * 16;
    const size_t yin_bytes = clip + sizeof(float) * (size_t)yin.padded_len;
    const size_t rounds = sizeof(float) * (size_t)mel_rounds_floats(n_mels);
    bytes = yin_bytes > rounds ? yin_bytes : rounds;
  }
};

// Block b runs tile b % tiles of clip b / tiles: the MFCC rounds of its
// frames, scaled by the clip's divisor from its chunks' lane sums (none:
// not normalized), into the clip's dB image with its peak into peaks[b],
// then YIN over the same frames in groups of `group`, their f0 into
// f0s[clip * n_frames + t].
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
mfcc_pitch_tile_kernel(const float* __restrict__ clips,
                       const float* __restrict__ lanes,
                       const float* __restrict__ hann,
                       const float* __restrict__ tw,
                       const float* __restrict__ fb,
                       const int* __restrict__ lo, const int* __restrict__ hi,
                       float* __restrict__ img, float* __restrict__ peaks,
                       float* __restrict__ f0s, int n_samples, int hop,
                       int n_frames, int n_mels, int win, int min_p,
                       int max_p, int group, int tile, int tiles,
                       int pitch_normalized, float threshold, float sr) {
  const TileLayout lay(n_mels, win, hop, max_p, group);
  extern __shared__ float smem[];
  char* tables = reinterpret_cast<char*>(smem);
  float* padded = reinterpret_cast<float*>(tables + lay.clip);

  const int c = blockIdx.x / tiles;
  const int t0 = (blockIdx.x - c * tiles) * tile;
  const int t1 = t0 + tile < n_frames ? t0 + tile : n_frames;
  const float* clip = clips + (size_t)c * n_samples;
  const float d =
      lanes ? summed_divisor(
                  lanes + (size_t)c * divisor_chunks(n_samples) * kThreads,
                  n_samples, smem)
            : 1.0f;
  const float scale = lanes ? divisor_scale(d) : 0.25f;
  const float peak =
      mfcc_tile_db(clip, n_samples, hop, t0, t1, n_mels, scale, hann, tw, fb,
                   lo, hi, smem, img + (size_t)c * n_frames * n_mels);
  if (threadIdx.x == 0) peaks[blockIdx.x] = peak;

  // block_max's last barrier: the rounds' buffers pass to YIN
  float* f0 = f0s + (size_t)c * n_frames;
  for (int g0 = t0; g0 < t1; g0 += group) {
    if (g0 > t0) __syncthreads();  // the last group is done with the copy
    stage_yin_clip(clip, n_samples, g0 * hop, lay.yin.padded_len, padded);
    __pipeline_wait_prior(0);
    __syncthreads();
    if (lanes && pitch_normalized) {
      for (int p = threadIdx.x; p < lay.yin.padded_len; p += kThreads)
        padded[p] = padded[p] / d;
      __syncthreads();
    }
    yin_frames_f0</*kFused=*/true>(
        padded, tables, lay.yin, t1 - g0 < group ? t1 - g0 : group, f0 + g0,
        win, hop, min_p, max_p, threshold, sr);
  }
}

// Block b sums chunk b % chunks of clip b / chunks into sums[b * n_mels..].
__global__ void __launch_bounds__(kThreads)
mfcc_pitch_sums_kernel(const float* __restrict__ img,
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

// Block c: clip c's mean MFCC from its chunks' sums into its row's first
// n_mfcc values, the median of its frames' f0 into hz[c] and log10 of it
// after the coefficients.
__global__ void __launch_bounds__(kThreads)
mfcc_pitch_mean_kernel(const float* __restrict__ sums,
                       const float* __restrict__ f0s,
                       const float* __restrict__ dct, float* __restrict__ out,
                       float* __restrict__ hz_out, int n_frames, int n_mels,
                       int n_mfcc) {
  extern __shared__ float smem[];
  float* row = out + (size_t)blockIdx.x * (n_mfcc + 1);
  mfcc_chunks_mean(sums + (size_t)blockIdx.x * mean_chunks(n_frames) * n_mels,
                   n_frames, n_mels, n_mfcc, dct, smem, row);
  int* hist = reinterpret_cast<int*>(smem + n_mels + kDctParts * n_mfcc);
  const float hz =
      select_median(f0s + (size_t)blockIdx.x * n_frames, n_frames, hist);
  if (threadIdx.x == 0) {
    row[n_mfcc] = log10f(hz);
    hz_out[blockIdx.x] = hz;
  }
}

// The split route's group for tiles of up to `tile` frames: the largest
// whose layout lets kBlocksPerSM blocks share an SM, else the largest a
// block holds (0: none).
static int tile_group(int n_mels, int win, int hop, int tile, int max_p) {
  if (tile < 1 || max_p < 1) return 0;
  const auto bytes = [&](int g) {
    return TileLayout(n_mels, win, hop, max_p, g).bytes;
  };
  const int g = yin_group(win, hop, tile, max_p,
                          smem_per_block(kBlocksPerSM), bytes);
  return g > 0 ? g : yin_group(win, hop, tile, max_p, kMaxBlockSmem, bytes);
}

static cudaError_t tile_attributes(size_t bytes) {
  return cudaFuncSetAttribute(mfcc_pitch_tile_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Floats of scratch a clip on the split route: its divisor's lane sums,
// its tiles' peaks, its chunks' sums, its frames' f0 and its dB image.
static long long split_floats(int n_samples, int n_frames, int n_mels,
                              int tiles) {
  return (long long)divisor_chunks(n_samples) * kThreads + tiles +
         (long long)mean_chunks(n_frames) * n_mels + n_frames +
         (long long)n_frames * n_mels;
}

// Whether the split route takes these sizes: what the one-block route
// needs of them, but the frame bound.
static bool split_fits(int n_mels, int n_mfcc, int win, int hop, int max_p) {
  return max_p >= 1 && n_mfcc <= n_mels &&
         mfcc_epilogue_fits(n_mels, n_mfcc) && shared_chains_fit(win, hop);
}

// The launch at these sizes on the current device: plan[kPlanTile] frames
// a tile (0: one block a clip), plan[kPlanTiles] tiles a clip,
// plan[kPlanPerSM] the resident blocks per SM of the kernel that runs the
// frames, plan[kPlanFloats] floats of scratch a clip (one block: the
// workspace of gat_mfcc_pitch_workspace_floats).
extern "C" int gat_mfcc_pitch_plan(int n_clips, int n_samples, int n_frames,
                                   int n_mels, int n_mfcc, int win, int hop,
                                   int max_p, int* plan) {
  if (n_frames < 1 || n_clips < 0 || n_samples < 1 ||
      !split_fits(n_mels, n_mfcc, win, hop, max_p))
    return (int)cudaErrorInvalidValue;
  const int group = tile_group(n_mels, win, hop, kMaxTile, max_p);
  if (group == 0) return (int)cudaErrorInvalidValue;
  const size_t bytes = TileLayout(n_mels, win, hop, max_p, group).bytes;
  cudaError_t err = tile_attributes(bytes);
  long long slots = 0;
  int per_sm = 0;
  if (err == cudaSuccess)
    err = card_slots(mfcc_pitch_tile_kernel, bytes, &slots, &per_sm);
  if (err != cudaSuccess) return (int)err;
  const int tile = split_tile(n_clips, n_frames, slots, kInFlight, kMaxTile);
  plan[kPlanTile] = tile;
  plan[kPlanTiles] = tile ? (n_frames + tile - 1) / tile : 1;
  if (tile) {
    const long long floats =
        split_floats(n_samples, n_frames, n_mels, plan[kPlanTiles]);
    if (floats > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    plan[kPlanPerSM] = per_sm;
    plan[kPlanFloats] = (int)floats;
    return 0;
  }
  plan[kPlanFloats] = gat_mfcc_pitch_workspace_floats(n_frames, n_mels,
                                                      n_mfcc, win, hop, max_p);
  if (plan[kPlanFloats] < 0) return (int)cudaErrorInvalidValue;
  return gat_mfcc_pitch_frontend_blocks_per_sm(0, hop, n_frames, n_mels, win,
                                               max_p, &plan[kPlanPerSM]);
}

// The split route: tiles of `tile` frames (even, so that each FFT pairs
// the one-block route's frames), one block a tile; `scratch` holds
// plan[kPlanFloats] floats a clip at this tile. Four launches: the
// divisor's lane sums (when `normalize`), the tiles' dB, peaks and f0,
// their clamped sums, the means and medians.
extern "C" int gat_mfcc_pitch_split(
    const float* clips, float* out, float* hz, float* scratch,
    const float* hann, const float* tw, const float* fb, const int* lo,
    const int* hi, const float* dct, int n_clips, int n_samples, int hop,
    int n_frames, int n_mels, int n_mfcc, int win, int min_p, int max_p,
    int normalize, int pitch_normalized, float top_db, float threshold,
    float sr, int tile, void* stream) {
  if (n_frames < 1 || n_samples < 1 || tile < 2 || tile % 2 != 0 ||
      !scratch || !split_fits(n_mels, n_mfcc, win, hop, max_p))
    return (int)cudaErrorInvalidValue;
  const int tiles = (n_frames + tile - 1) / tile;
  const int group = tile_group(n_mels, win, hop, tile, max_p);
  const int div_chunks = divisor_chunks(n_samples);
  if (group == 0 || (long long)n_clips * tiles > 0x7fffffffLL ||
      (long long)n_clips * mean_chunks(n_frames) > 0x7fffffffLL ||
      (long long)n_clips * div_chunks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = TileLayout(n_mels, win, hop, max_p, group).bytes;
  cudaError_t err = tile_attributes(bytes);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  float* lanes = scratch;
  float* peaks = lanes + (size_t)n_clips * div_chunks * kThreads;
  float* sums = peaks + (size_t)n_clips * tiles;
  float* f0s = sums + (size_t)n_clips * mean_chunks(n_frames) * n_mels;
  float* img = f0s + (size_t)n_clips * n_frames;
  if (normalize) {
    mfcc_pitch_divisor_kernel<<<n_clips * div_chunks, kThreads, 0, s>>>(
        clips, lanes, n_samples);
  }
  const int grid = n_clips * tiles;
  mfcc_pitch_tile_kernel<<<grid, kThreads, bytes, s>>>(
      clips, normalize ? lanes : nullptr, hann, tw, fb, lo, hi, img,
      peaks, f0s, n_samples, hop, n_frames, n_mels, win, min_p, max_p, group,
      tile, tiles, pitch_normalized, threshold, sr);
  const int chunk_grid = n_clips * mean_chunks(n_frames);
  mfcc_pitch_sums_kernel<<<chunk_grid, kThreads, 0, s>>>(
      img, peaks, sums, n_frames, n_mels, tiles, top_db);
  const size_t mean_bytes =
      sizeof(float) * (size_t)(n_mels + kDctParts * n_mfcc) +
      sizeof(int) * 258;
  mfcc_pitch_mean_kernel<<<n_clips, kThreads, mean_bytes, s>>>(
      sums, f0s, dct, out, hz, n_frames, n_mels, n_mfcc);
  return (int)cudaGetLastError();
}
