// The round loop shared by the two spectral front-ends, K1 (mel image,
// reflect pad) and K2 (MFCC, zero pad): frame pair -> 2048-point FFT ->
// two-for-one split -> mel partial sums -> one value per (band, frame).
//
// One block of kThreads threads owns one clip. Its two halves of
// kFFTThreads threads each run one complex transform, whose real part is
// frame t and whose imaginary part is frame t + 1 (fft_stockham.cuh), so a
// round carries kInFlight = 4 frames; an odd last frame runs with a zero
// partner. The power bins of the four frames reuse the FFT's exchange
// buffer. The mel is cut into (band, eighth-of-band) items spread over all
// threads, each summing its bins for the four frames at once (one
// filterbank load, four FMAs); one thread per (band, frame) then sums the
// band's eight parts and hands the result to the caller's `emit`. Six
// barriers per round: 3 in the FFT, 1 before the power bins overwrite the
// exchange buffer, 1 after them, 1 after the mel partial sums.
#pragma once

#include "dsp_common.cuh"
#include "fft_stockham.cuh"

namespace gat {

constexpr int kInFlight = 4;   // frames per round: two pairs
constexpr int kMelParts = 8;   // parts of a band's nonzero bins
constexpr int kPartStride = kInFlight * kMelParts + 4;  // floats per band,
                                                        // padded for banks

// Floats of shared memory the rounds use from the start of `smem`: the
// two transforms' exchange buffer (re, im), then the mel partial sums.
__host__ __device__ constexpr int mel_rounds_floats(int n_mels) {
  return 4 * kFFT + n_mels * kPartStride;
}

// Sample i of the clip after a center pad: numpy 'reflect' (K1) or zeros
// (K2) outside [0, n).
template <bool kReflect>
__device__ __forceinline__ float padded_sample(const float* __restrict__ clip,
                                               int i, int n) {
  if (kReflect) return clip[reflect_index(i, n)];
  return (i >= 0 && i < n) ? clip[i] : 0.0f;
}

// The volume normalization's divisor rms + eps, y / (rms + eps), from its
// sum of squares in one fixed order: lane l of the kThreads lanes sums
// the squares of its samples l, l + kThreads, ... of each chunk of
// kDivisorChunk samples in order, then its chunks' sums in order, then
// the block sums the lanes (block_sum). A clip of at most one chunk (5.9
// s at 11025 Hz) is one running sum a lane. The split route
// (dsp_common.cuh) forms each chunk's lane sums in a block of its own and
// sums them as the one-block route does: the same float.
constexpr int kDivisorChunk = kThreads * 256;  // samples of a chunk

__host__ __device__ constexpr int divisor_chunks(int n_samples) {
  return (n_samples + kDivisorChunk - 1) / kDivisorChunk;
}

// Lane threadIdx.x's sum of squares over chunk c of the clip, in order;
// its loads eight at a time before their sums.
__device__ __forceinline__ float chunk_squares(const float* __restrict__ clip,
                                               int n_samples, int c) {
  const int end = (c + 1) * kDivisorChunk < n_samples
                      ? (c + 1) * kDivisorChunk
                      : n_samples;
  float p = 0.0f;
  int i = c * kDivisorChunk + threadIdx.x;
  for (; i + 7 * kThreads < end; i += 8 * kThreads) {
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = clip[i + k * kThreads];
#pragma unroll
    for (int k = 0; k < 8; ++k) p += v[k] * v[k];
  }
  for (; i < end; i += kThreads) p += clip[i] * clip[i];
  return p;
}

// rms + eps from each lane's sum of squares. Every thread of the block
// calls this and gets the result; scratch holds kThreads floats.
__device__ __forceinline__ float lane_divisor(float ss, int n_samples,
                                              float* scratch) {
  ss = block_sum(ss, scratch);
  return sqrtf(ss / (float)n_samples) + kVolumeEps;
}

// The clip's divisor, read whole by this block. Every thread of the block
// calls this and gets the result; scratch holds kThreads floats.
__device__ __forceinline__ float volume_divisor(const float* __restrict__ clip,
                                                int n_samples,
                                                float* scratch) {
  float ss = 0.0f;
  for (int c = 0; c < divisor_chunks(n_samples); ++c)
    ss += chunk_squares(clip, n_samples, c);
  return lane_divisor(ss, n_samples, scratch);
}

// The split route's pre-pass, a block a (clip, chunk): block b writes the
// kThreads lane sums of chunk b % chunks of clip b / chunks to
// sums[b * kThreads ..], a clip's chunks one after another.
__device__ __forceinline__ void chunk_lane_sums(
    const float* __restrict__ clips, int n_samples, float* __restrict__ sums) {
  const int chunks = divisor_chunks(n_samples);
  const int c = blockIdx.x / chunks;
  sums[(size_t)blockIdx.x * kThreads + threadIdx.x] = chunk_squares(
      clips + (size_t)c * n_samples, n_samples, blockIdx.x - c * chunks);
}

// A split clip's divisor from its chunks' lane sums (chunk_lane_sums),
// summed as volume_divisor sums them. Every thread of the block calls
// this and gets the result; scratch holds kThreads floats.
__device__ __forceinline__ float summed_divisor(const float* __restrict__ sums,
                                                int n_samples,
                                                float* scratch) {
  float ss = 0.0f;
  for (int c = 0; c < divisor_chunks(n_samples); ++c)
    ss += sums[c * kThreads + threadIdx.x];
  return lane_divisor(ss, n_samples, scratch);
}

// The power scale of a clip whose volume divisor is d: the split's
// (1/2)^2 over d^2.
__device__ __forceinline__ float divisor_scale(float d) {
  return 0.25f / (d * d);
}

// The scale of the rounds' mel sums: the 1/2 of the two-for-one split,
// squared, and the volume normalization (when asked for), which scales
// the power by 1 / (rms + eps)^2. Every thread of the block calls this;
// scratch holds kThreads floats.
__device__ __forceinline__ float power_scale(const float* __restrict__ clip,
                                             int n_samples, int normalize,
                                             float* scratch) {
  if (!normalize) return 0.25f;
  return divisor_scale(volume_divisor(clip, n_samples, scratch));
}

// Runs frames first_frame .. end_frame - 1 of `clip` through the rounds;
// frame t reads samples t * hop + n - kFFT / 2, n < kFFT, of the clip.
// For each band m and frame t, one thread calls emit(m, t, v) with v the
// band's mel sum of |X|^2, times 4 (the split's (1/2)^2 is the caller's
// to apply). Every thread of the block calls this. On return the exchange
// buffer is free again, and the last emit may still be running in other
// threads.
template <bool kReflect, class Emit>
__device__ __forceinline__ void mel_rounds(const float* __restrict__ clip,
                                           int n_samples, int hop,
                                           int first_frame, int end_frame,
                                           int n_mels,
                                           const float* __restrict__ hann,
                                           const float* __restrict__ tw,
                                           const float* __restrict__ fb,
                                           const int* __restrict__ lo,
                                           const int* __restrict__ hi,
                                           float* smem, Emit emit) {
  float* xre = smem;                  // 2 transforms x kFFT
  float* xim = xre + 2 * kFFT;        // 2 transforms x kFFT
  float* power = smem;                // kInFlight x kBins, over xre / xim
  float* partial = xim + 2 * kFFT;    // n_mels x kPartStride

  const int g = threadIdx.x / kFFTThreads;  // transform of this thread
  const int j = threadIdx.x % kFFTThreads;
  float* re = xre + g * kFFT;
  float* im = xim + g * kFFT;

  for (int t0 = first_frame; t0 < end_frame; t0 += kInFlight) {
    const int ta = t0 + 2 * g;  // frames ta (real part), ta + 1 (imaginary)
    const bool has_a = ta < end_frame, has_b = ta + 1 < end_frame;
    float vr[16], vi[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int n = j + kFFTThreads * r;
      const int i = ta * hop + n - kFFT / 2;
      const float w = hann[n];
      vr[r] = has_a ? padded_sample<kReflect>(clip, i, n_samples) * w : 0.0f;
      vi[r] = has_b ? padded_sample<kReflect>(clip, i + hop, n_samples) * w
                    : 0.0f;
    }
    fft2048_stockham(vr, vi, re, im, tw, j);
    __syncthreads();  // the last pass has read the exchange buffer
    split_power_bins(vr, vi, j, power + 2 * g * kBins,
                     power + (2 * g + 1) * kBins);
    __syncthreads();

    // mel partial sums: item i is (band m, part s) for the four frames
    for (int i = threadIdx.x; i < n_mels * kMelParts; i += kThreads) {
      const int m = i / kMelParts, s = i % kMelParts;
      const int l = lo[m], h = hi[m];
      const int len = (h - l + kMelParts - 1) / kMelParts;
      const int k0 = l + s * len;
      const int k1 = k0 + len < h ? k0 + len : h;
      const float* row = fb + (size_t)m * kBins;
      float acc[kInFlight] = {};
#pragma unroll 4
      for (int k = k0; k < k1; ++k) {
        const float w = row[k];
#pragma unroll
        for (int f = 0; f < kInFlight; ++f) acc[f] += w * power[f * kBins + k];
      }
#pragma unroll
      for (int f = 0; f < kInFlight; ++f)
        partial[m * kPartStride + s * kInFlight + f] = acc[f];
    }
    __syncthreads();

    // one thread per (band, frame) sums the parts
    for (int i = threadIdx.x; i < n_mels * kInFlight; i += kThreads) {
      const int f = i % kInFlight, m = i / kInFlight;
      if (t0 + f >= end_frame) continue;
      const float* q = partial + m * kPartStride + f;
      float v = 0.0f;
#pragma unroll
      for (int s = 0; s < kMelParts; ++s) v += q[s * kInFlight];
      emit(m, t0 + f, v);
    }
  }
}

}  // namespace gat
