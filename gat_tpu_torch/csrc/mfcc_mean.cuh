// The MFCC mean of one clip, shared by K2 (mfcc_frontend.cu) and K6
// (mfcc_pitch_frontend.cu): K1's round loop (mel_rounds.cuh) over a zero
// centre pad, then the epilogue:
//   1. 10*log10(max(v * scale, 1e-10)) per (band, frame) into a dB image,
//      in shared memory where it fits and else in a workspace in device
//      memory, each thread folding the values it writes into a running
//      max, so the clip's peak costs one block reduction;
//   2. the clamp at peak - top_db and the mean over frames, one thread per
//      band, the frames summed in chunks of kMeanChunk (each chunk in
//      order, then the chunks' sums in order: a clip of at most one chunk
//      is one running sum);
//   3. one orthonormal DCT-II of the mean (it commutes with the mean), 4
//      parts of the bands per coefficient over all threads, then the sum
//      of the parts in order.
#pragma once

#include <cmath>

#include "mel_rounds.cuh"

namespace gat {

constexpr int kDctParts = 4;  // parts of the bands per DCT coefficient
// Frames of a chunk of the mean over frames: the one-block and the split
// routes sum the same chunks in the same order, so their means are the
// same floats at any tile.
constexpr int kMeanChunk = 128;

__host__ __device__ constexpr int mean_chunks(int n_frames) {
  return (n_frames + kMeanChunk - 1) / kMeanChunk;
}

// Floats of shared memory `mfcc_mean` uses from its `smem`: the rounds'
// exchange buffer and partial sums, then the n_frames x n_mels dB image
// (n_frames 0: the image is in device memory).
__host__ __device__ constexpr int mfcc_mean_floats(int n_mels, int n_frames) {
  return mel_rounds_floats(n_mels) + n_frames * n_mels;
}

// Whether the dB image of a clip stays in shared memory with the rounds'
// buffers (else it goes to a workspace in device memory, n_frames x n_mels
// floats per clip).
__host__ __device__ constexpr bool mfcc_image_in_smem(int n_mels,
                                                     int n_frames) {
  return sizeof(float) * (size_t)mfcc_mean_floats(n_mels, n_frames) <=
         kMaxBlockSmem;
}

// Floats at the start of `smem` that the epilogue uses after the rounds:
// the block reduction's kThreads, the n_mels means and kDctParts x n_mfcc
// parts of the DCT.
__host__ __device__ constexpr int mfcc_epilogue_floats(int n_mels,
                                                      int n_mfcc) {
  return kThreads + n_mels + kDctParts * n_mfcc;
}

// Whether the epilogue's buffers (the block reduction's kThreads floats,
// the n_mels means, kDctParts x n_mfcc parts) fit in the rounds' exchange
// buffer, which they reuse.
__host__ __device__ constexpr bool mfcc_epilogue_fits(int n_mels, int n_mfcc) {
  return mfcc_epilogue_floats(n_mels, n_mfcc) <= 4 * kFFT;
}

// Step 3: out[k] = the orthonormal DCT-II of the n_mels band means, 4
// parts of the bands per coefficient over all threads, then the sum of
// the parts in order. mean_db is published; part holds kDctParts x
// n_mfcc floats. Every thread of the block calls this.
__device__ __forceinline__ void mean_dct(const float* mean_db, float* part,
                                         const float* __restrict__ dct,
                                         int n_mels, int n_mfcc,
                                         float* __restrict__ out) {
  // item i is (coefficient k, part p of the bands)
  const int len = (n_mels + kDctParts - 1) / kDctParts;
  for (int i = threadIdx.x; i < n_mfcc * kDctParts; i += kThreads) {
    const int k = i % n_mfcc, p = i / n_mfcc;
    const int m1 = (p + 1) * len < n_mels ? (p + 1) * len : n_mels;
    float acc = 0.0f;
    for (int m = p * len; m < m1; ++m) acc += mean_db[m] * dct[m * n_mfcc + k];
    part[p * n_mfcc + k] = acc;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n_mfcc; k += kThreads) {
    float acc = part[k];
#pragma unroll
    for (int p = 1; p < kDctParts; ++p) acc += part[p * n_mfcc + k];
    out[k] = acc;
  }
}

// The hook mfcc_mean runs by default once the rounds are done: nothing.
struct NoHook {
  __device__ __forceinline__ void operator()() const {}
};

// Writes the n_mfcc coefficients of the clip's mean MFCC to out[0..n_mfcc).
// `scale` multiplies the rounds' mel sums: the split's (1/2)^2 times the
// volume scale of the power. Frame t reads the clip's samples t * hop + n
// - kFFT / 2, zeros outside [0, n_samples). `img` holds the n_frames x
// n_mels dB image: smem + mel_rounds_floats(n_mels) where it fits
// (mfcc_image_in_smem), else this clip's rows of a workspace in device
// memory; the same floats in the same order either way.
// Every thread of the block calls this; on return `smem` is free again
// once the block has passed a barrier. Every thread calls
// `after_rounds()` as it leaves the rounds, before the epilogue: from
// then on the floats [mfcc_epilogue_floats(n_mels, n_mfcc), 4 * kFFT)
// and those past the image, or past the rounds' buffers when the image is
// in device memory, of `smem` are not touched again, so it may start
// filling them.
template <class AfterRounds = NoHook>
__device__ __forceinline__ void mfcc_mean(
    const float* __restrict__ clip, int n_samples, int hop, int n_frames,
    int n_mels, int n_mfcc, float scale, float top_db,
    const float* __restrict__ hann, const float* __restrict__ tw,
    const float* __restrict__ fb, const int* __restrict__ lo,
    const int* __restrict__ hi, const float* __restrict__ dct, float* smem,
    float* img, float* __restrict__ out, AfterRounds after_rounds = {}) {
  // after the rounds, over the exchange buffer:
  float* scratch = smem;                 // kThreads
  float* mean_db = scratch + kThreads;   // n_mels
  float* part = mean_db + n_mels;        // kDctParts x n_mfcc

  float peak = -INFINITY;
  mel_rounds</*kReflect=*/false>(
      clip, n_samples, hop, 0, n_frames, n_mels, hann, tw, fb, lo, hi, smem,
      [&](int m, int t, float v) {
        const float db = 10.0f * log10f(fmaxf(v * scale, 1e-10f));
        img[t * n_mels + m] = db;
        peak = fmaxf(peak, db);
      });
  after_rounds();  // the exchange buffer's power bins are all read
  // block_max's first barrier also publishes the image
  const float floor_db = block_max(peak, scratch) - top_db;

  for (int m = threadIdx.x; m < n_mels; m += kThreads) {
    float s = 0.0f;
    for (int t0 = 0; t0 < n_frames; t0 += kMeanChunk) {
      const int t1 = t0 + kMeanChunk < n_frames ? t0 + kMeanChunk : n_frames;
      float c = 0.0f;
      for (int t = t0; t < t1; ++t) c += fmaxf(img[t * n_mels + m], floor_db);
      s += c;
    }
    mean_db[m] = s / (float)n_frames;
  }
  __syncthreads();
  mean_dct(mean_db, part, dct, n_mels, n_mfcc, out);
}

// The split route (dsp_common.cuh) in three steps, each a launch of its
// own, so that no block waits for another and none reads a clip's whole
// image: the rounds of a tile's frames into the dB image in device memory
// with the tile's peak (mfcc_tile_db); each chunk's sums over its
// kMeanChunk frames of the image clamped at the clip's peak - top_db
// (mfcc_chunk_sums); per clip the sum of its chunks' sums in order, the
// mean and the DCT (mfcc_chunks_mean). The dB values, the peak and the
// sums are the one-block route's floats in its order, so the mean is its
// float bit for bit, at any tile.

// The rounds of frames [t0, t1) of `clip` into img[t * n_mels + m] (the
// clip's image in device memory, all frames), as mfcc_mean's epilogue
// step 1 forms them; returns the block's peak of those values to every
// thread. Every thread of the block calls this; `smem` holds the rounds'
// buffers.
__device__ __forceinline__ float mfcc_tile_db(
    const float* __restrict__ clip, int n_samples, int hop, int t0, int t1,
    int n_mels, float scale, const float* __restrict__ hann,
    const float* __restrict__ tw, const float* __restrict__ fb,
    const int* __restrict__ lo, const int* __restrict__ hi, float* smem,
    float* __restrict__ img) {
  float peak = -INFINITY;
  mel_rounds</*kReflect=*/false>(
      clip, n_samples, hop, t0, t1, n_mels, hann, tw, fb, lo, hi, smem,
      [&](int m, int t, float v) {
        const float db = 10.0f * log10f(fmaxf(v * scale, 1e-10f));
        img[(size_t)t * n_mels + m] = db;
        peak = fmaxf(peak, db);
      });
  return block_max(peak, smem);
}

// sums[m] = the sum over the frames t of chunk k, in order, of
// max(img[t * n_mels + m], peak - top_db), the peak the largest of the
// clip's `tiles` tile peaks. Every thread of the block calls this.
__device__ __forceinline__ void mfcc_chunk_sums(
    const float* __restrict__ img, const float* __restrict__ peaks,
    int tiles, int k, int n_frames, int n_mels, float top_db,
    float* __restrict__ sums) {
  float peak = -INFINITY;
  for (int j = 0; j < tiles; ++j) peak = fmaxf(peak, peaks[j]);
  const float floor_db = peak - top_db;
  const int t0 = k * kMeanChunk;
  const int t1 = t0 + kMeanChunk < n_frames ? t0 + kMeanChunk : n_frames;
  for (int m = threadIdx.x; m < n_mels; m += kThreads) {
    float c = 0.0f;
    for (int t = t0; t < t1; ++t)
      c += fmaxf(img[(size_t)t * n_mels + m], floor_db);
    sums[m] = c;
  }
}

// The n_mfcc coefficients of a clip's mean MFCC into out, from its
// mean_chunks(n_frames) x n_mels chunk sums (mfcc_chunk_sums), summed in
// order. `smem` holds n_mels + kDctParts x n_mfcc floats. Every thread of
// the block calls this.
__device__ __forceinline__ void mfcc_chunks_mean(
    const float* __restrict__ sums, int n_frames, int n_mels, int n_mfcc,
    const float* __restrict__ dct, float* smem, float* __restrict__ out) {
  float* mean_db = smem;            // n_mels
  float* part = mean_db + n_mels;   // kDctParts x n_mfcc
  const int chunks = mean_chunks(n_frames);
  for (int m = threadIdx.x; m < n_mels; m += kThreads) {
    float s = 0.0f;
    for (int k = 0; k < chunks; ++k) s += sums[(size_t)k * n_mels + m];
    mean_db[m] = s / (float)n_frames;
  }
  __syncthreads();
  mean_dct(mean_db, part, dct, n_mels, n_mfcc, out);
}

}  // namespace gat
