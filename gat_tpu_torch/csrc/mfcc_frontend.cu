// K2: the MLP's MFCC front-end, clips (N, L) -> MFCC mean (N, n_mfcc).
//
// Replaces the TPU kernel gat_tpu/ops/pallas/mfcc_frontend.py::
// mfcc_mean_pallas, deleted in 1951c8f; the live reference is
// gat_tpu/features.py::mfcc_feature_vectors (spectral.mfcc, then the mean
// over frames). Per clip:
//   1. volume normalization y / (rms + 1e-9) (when asked for);
//   2. zero center pad of n_fft/2 in shared memory;
//   3. hop-`hop` frames, periodic Hann, a 2048-point FFT, |X|^2;
//   4. the Slaney mel projection (128 bands) over each band's nonzero bins;
//   5. 10*log10(max(., 1e-10)), then the clamp at peak - top_db, with the
//      peak over all frames and bands of the clip (a block-wide max);
//   6. the mean over frames, then one orthonormal DCT-II. The DCT commutes
//      with the mean, so it runs once per clip instead of once per frame.
//
// What bounds it: the clamp needs the whole clip's mel image before any
// coefficient can be formed, so one block owns one clip. Per clip the 11
// real-input FFTs need 0.62 M fp32 flops (run here as complex transforms,
// twice that) against 22 KB read and 256 B written, so its roofline
// bound is the fp32 operation rate. Like K1 it keeps everything
// in shared memory and is held back further by latency (the FFT stages'
// __syncthreads and the frames in sequence).
#include <cmath>

#include "dsp_common.cuh"

using namespace gat;

__global__ void __launch_bounds__(kThreads)
mfcc_frontend_kernel(const float* __restrict__ clips,
                     float* __restrict__ out,
                     const float* __restrict__ hann_g,
                     const float* __restrict__ tw_g,
                     const float* __restrict__ fb,
                     const int* __restrict__ lo, const int* __restrict__ hi,
                     const float* __restrict__ dct, int n_samples, int hop,
                     int n_frames, int n_mels, int n_mfcc, int normalize,
                     float top_db) {
  extern __shared__ float smem[];
  float* re = smem;                          // kFFT
  float* im = re + kFFT;                     // kFFT
  float* tw_re = im + kFFT;                  // kFFT / 2
  float* tw_im = tw_re + kFFT / 2;           // kFFT / 2
  float* hann = tw_im + kFFT / 2;            // kFFT
  float* power = hann + kFFT;                // kBins
  float* scratch = power + kBins;            // kThreads
  float* img = scratch + kThreads;           // n_frames * n_mels
  float* mean_db = img + n_frames * n_mels;  // n_mels
  float* padded = mean_db + n_mels;          // n_samples + kFFT

  for (int k = threadIdx.x; k < kFFT / 2; k += kThreads) {
    tw_re[k] = tw_g[k];
    tw_im[k] = tw_g[kFFT / 2 + k];
  }
  for (int k = threadIdx.x; k < kFFT; k += kThreads) hann[k] = hann_g[k];
  load_padded_clip(clips + (size_t)blockIdx.x * n_samples, n_samples,
                   kFFT / 2, /*reflect=*/false, normalize != 0, padded,
                   scratch);

  for (int t = 0; t < n_frames; ++t) {
    load_windowed_frame(padded, t * hop, hann, re, im);
    fft2048(re, im, tw_re, tw_im);
    power_bins(re, im, power);
    for (int m = threadIdx.x; m < n_mels; m += kThreads) {
      float v = mel_band(fb, lo, hi, power, m);
      img[t * n_mels + m] = 10.0f * log10f(fmaxf(v, 1e-10f));
    }
  }
  __syncthreads();

  float peak = -INFINITY;
  for (int i = threadIdx.x; i < n_frames * n_mels; i += kThreads)
    peak = fmaxf(peak, img[i]);
  const float floor_db = block_max(peak, scratch) - top_db;
  for (int m = threadIdx.x; m < n_mels; m += kThreads) {
    float s = 0.0f;
    for (int t = 0; t < n_frames; ++t)
      s += fmaxf(img[t * n_mels + m], floor_db);
    mean_db[m] = s / (float)n_frames;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n_mfcc; k += kThreads) {
    float acc = 0.0f;
    for (int m = 0; m < n_mels; ++m) acc += mean_db[m] * dct[m * n_mfcc + k];
    out[(size_t)blockIdx.x * n_mfcc + k] = acc;
  }
}

extern "C" int gat_mfcc_frontend(const float* clips, float* out,
                                 const float* hann, const float* tw,
                                 const float* fb, const int* lo,
                                 const int* hi, const float* dct,
                                 int n_clips, int n_samples, int hop,
                                 int n_frames, int n_mels, int n_mfcc,
                                 int normalize, float top_db, void* stream) {
  size_t smem = sizeof(float) * (size_t)(5 * kFFT + kBins + kThreads +
                                         n_frames * n_mels + n_mels +
                                         n_samples);
  cudaError_t err = cudaFuncSetAttribute(
      mfcc_frontend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  mfcc_frontend_kernel<<<n_clips, kThreads, smem, (cudaStream_t)stream>>>(
      clips, out, hann, tw, fb, lo, hi, dct, n_samples, hop, n_frames,
      n_mels, n_mfcc, normalize, top_db);
  return (int)cudaGetLastError();
}
