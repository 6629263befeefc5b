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
  if (n_frames < 1 || n_frames >= kMaxFrames ||
      !mfcc_epilogue_fits(n_mels, n_mfcc) ||
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
  if (n_frames < 1 || n_frames >= kMaxFrames)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = mfcc_set_attributes(n_mels, n_frames);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, mfcc_kernel(n_mels, n_frames), kThreads,
      mfcc_smem_bytes(n_mels, n_frames));
}
