// K1: the CNN's mel front-end, clips (N, L) -> mel image (N, n_mels, T, 1).
//
// Replaces the TPU kernel gat_tpu/ops/pallas/melspec_frontend.py::
// melspec_pallas (and its block-DFT formulation blockmel.py::
// melspec_block_pallas), both deleted in 1951c8f; the live reference is
// gat_tpu/features.py::melspec_features. Per clip:
//   1. volume normalization y / (rms + 1e-9) (when asked for);
//   2. reflect center pad of n_fft/2, done in shared memory, so no padded
//      copy reaches device memory;
//   3. hop-`hop` frames with a periodic Hann window;
//   4. a 2048-point FFT in shared memory, |X|^2 on the rfft bins;
//   5. the HTK mel projection over each band's nonzero bins;
//   6. 10*log10(max(., 1e-10)) (when to_db), no clamp;
//   7. the image written NHWC, coalesced, once.
//
// What bounds it: per 0.5 s clip at 11025 Hz the 22 real-input FFTs need
// 22 * 2.5 * 2048 * 11 = 1.24 M fp32 flops against 22 KB read and 5.6 KB
// written, so its roofline bound is the fp32 operation rate, not memory.
// This kernel runs each as a complex 2048-point transform, twice that.
// The design keeps the whole chain in shared memory (the (N, T, 1025)
// spectrum never exists in device memory) and runs one block per clip.
// This first version is held back further by latency: a __syncthreads
// after each of the 11 FFT stages, and the frames of a clip in sequence.
#include "dsp_common.cuh"

using namespace gat;

__global__ void __launch_bounds__(kThreads)
melspec_frontend_kernel(const float* __restrict__ clips,
                        float* __restrict__ out,
                        const float* __restrict__ hann_g,
                        const float* __restrict__ tw_g,
                        const float* __restrict__ fb,
                        const int* __restrict__ lo,
                        const int* __restrict__ hi, int n_samples, int hop,
                        int n_frames, int n_mels, int normalize, int to_db) {
  extern __shared__ float smem[];
  float* re = smem;                          // kFFT
  float* im = re + kFFT;                     // kFFT
  float* tw_re = im + kFFT;                  // kFFT / 2
  float* tw_im = tw_re + kFFT / 2;           // kFFT / 2
  float* hann = tw_im + kFFT / 2;            // kFFT
  float* power = hann + kFFT;                // kBins
  float* scratch = power + kBins;            // kThreads
  float* img = scratch + kThreads;           // n_mels * n_frames
  float* padded = img + n_mels * n_frames;   // n_samples + kFFT

  for (int k = threadIdx.x; k < kFFT / 2; k += kThreads) {
    tw_re[k] = tw_g[k];
    tw_im[k] = tw_g[kFFT / 2 + k];
  }
  for (int k = threadIdx.x; k < kFFT; k += kThreads) hann[k] = hann_g[k];
  load_padded_clip(clips + (size_t)blockIdx.x * n_samples, n_samples,
                   kFFT / 2, /*reflect=*/true, normalize != 0, padded,
                   scratch);

  for (int t = 0; t < n_frames; ++t) {
    load_windowed_frame(padded, t * hop, hann, re, im);
    fft2048(re, im, tw_re, tw_im);
    power_bins(re, im, power);
    for (int m = threadIdx.x; m < n_mels; m += kThreads) {
      float v = mel_band(fb, lo, hi, power, m);
      img[m * n_frames + t] = to_db ? 10.0f * log10f(fmaxf(v, 1e-10f)) : v;
    }
  }
  __syncthreads();
  float* o = out + (size_t)blockIdx.x * n_mels * n_frames;
  for (int i = threadIdx.x; i < n_mels * n_frames; i += kThreads)
    o[i] = img[i];
}

extern "C" int gat_melspec_frontend(const float* clips, float* out,
                                    const float* hann, const float* tw,
                                    const float* fb, const int* lo,
                                    const int* hi, int n_clips,
                                    int n_samples, int hop, int n_frames,
                                    int n_mels, int normalize, int to_db,
                                    void* stream) {
  size_t smem = sizeof(float) * (size_t)(5 * kFFT + kBins + kThreads +
                                         n_mels * n_frames + n_samples);
  cudaError_t err = cudaFuncSetAttribute(
      melspec_frontend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  melspec_frontend_kernel<<<n_clips, kThreads, smem, (cudaStream_t)stream>>>(
      clips, out, hann, tw, fb, lo, hi, n_samples, hop, n_frames, n_mels,
      normalize, to_db);
  return (int)cudaGetLastError();
}
