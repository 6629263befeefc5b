// K6: the shared MFCC and YIN front-end of the matmul route, clips (N, L)
// -> features (N, n_mfcc + 1), the MFCC mean then log10 of the YIN pitch,
// and the pitch (N,) in Hz.
//
// Replaces gat_tpu/features.py::_fused_mfcc_mean_and_pitch, which the JAX
// package runs as XLA code: one hop-block DFT of the raw clips, from which
// both the MFCC mean (Hann applied in frequency, mel, dB, DCT) and the YIN
// CMND are formed, the volume scale applied to the shared coefficients by
// linearity. Here the shared operand is the clip itself, read from device
// memory once; per clip:
//   1. the clip is staged in shared memory with its zero centre pad of
//      n_fft/2 on each side, and its sum of squares reduced on the way:
//      d = rms + 1e-9, in K2's order of summation;
//   2. the MFCC branch is K2's (mfcc_mean.cuh) over the staged clip, the
//      power scaled by 1 / d^2 when `normalize` is on;
//   3. the YIN branch is K3's (yin_acf.cuh) over the same staged clip,
//      divided in place by d first when both `normalize` and
//      `pitch_normalized` are on (the JAX function's pitch-source rule):
//      the direct ACF, 8 chains per lag, the fp64 energy prefix, the CMND,
//      the trough walk, the parabolic shift and the median;
//   4. thread 0 writes log10(hz) after the n_mfcc coefficients, and hz.
// So K6 gives K2's coefficients and K3's pitch of the same clip, with one
// read of the clip and one launch where the FFT route has two of each. It
// runs K3's direct ACF rather than deriving the ACF from the MFCC
// branch's spectrum: the FFT-free sums are what hold K3's near-tie pin.
//
// What bounds it: operations. The function's least work is one unwindowed
// FFT per frame shared by both branches, the window applied in frequency,
// and the ACF from FFTs: 2.2 M fp32 flops per 0.5 s clip at 11025 Hz
// (utils/roofline.py::mfcc_pitch_cost) against 22 KB read; this kernel
// does K2's 0.76 M and K3's direct 5.0 M. One
// block of 256 threads owns one clip (the clamp needs the whole mel
// image, the median every frame's f0). Shared memory: the staged clip, then one buffer that the
// MFCC branch's rounds and dB image use first and the YIN tables reuse:
// 26,240 + 56,832 = 83,072 bytes at 11 frames, so two blocks fit on an SM
// with __launch_bounds__(256, 2).
#include "mfcc_mean.cuh"
#include "yin_acf.cuh"

using namespace gat;

constexpr int kMaxFrames = 2000;  // features.py _KERNEL_MAX_FRAMES

// The shared-memory layout of one block, in floats: the staged clip (its
// pad, the clip, zeros up to the last sample either branch reads, rounded
// up to a 128-byte row), then the work buffer of the two branches.
struct FrontendLayout {
  YinLayout yin;
  int staged, work;
  __host__ __device__ FrontendLayout(int n_samples, int n_frames, int n_mels,
                                     int win, int hop, int max_p)
      : yin(win, hop, n_frames, max_p) {
    const int mfcc_end = kFFT / 2 + n_samples;
    const int len = mfcc_end > yin.padded_len ? mfcc_end : yin.padded_len;
    staged = (len + 31) / 32 * 32;
    const int yin_floats = (int)((yin.tables + sizeof(float) - 1)
                                 / sizeof(float));
    const int mfcc_floats = mfcc_mean_floats(n_mels, n_frames);
    work = mfcc_floats > yin_floats ? mfcc_floats : yin_floats;
  }
  __host__ __device__ size_t bytes() const {
    return sizeof(float) * ((size_t)staged + work);
  }
};

__global__ void __launch_bounds__(kThreads, 2)
mfcc_pitch_frontend_kernel(const float* __restrict__ clips,
                           float* __restrict__ out, float* __restrict__ hz_out,
                           const float* __restrict__ hann,
                           const float* __restrict__ tw,
                           const float* __restrict__ fb,
                           const int* __restrict__ lo,
                           const int* __restrict__ hi,
                           const float* __restrict__ dct, int n_samples,
                           int hop, int n_frames, int n_mels, int n_mfcc,
                           int win, int min_p, int max_p, int normalize,
                           int pitch_normalized, float top_db,
                           float threshold, float sr) {
  const FrontendLayout lay(n_samples, n_frames, n_mels, win, hop, max_p);
  extern __shared__ float smem[];
  float* staged = smem;
  float* work = smem + lay.staged;
  constexpr int kPad = kFFT / 2;

  // 1. stage the clip with its pad; kPad is a multiple of kThreads, so
  // each thread sums the squares of K2's samples in K2's order
  const float* clip = clips + (size_t)blockIdx.x * n_samples;
  float ss = 0.0f;
  for (int p = threadIdx.x; p < lay.staged; p += kThreads) {
    const int i = p - kPad;
    const float v = (i >= 0 && i < n_samples) ? clip[i] : 0.0f;
    staged[p] = v;
    ss += v * v;
  }
  ss = block_sum(ss, work);  // its barriers publish the staged clip
  const float d = sqrtf(ss / (float)n_samples) + kVolumeEps;

  // 2. the MFCC mean into the row's first n_mfcc values
  float* row = out + (size_t)blockIdx.x * (n_mfcc + 1);
  const float scale = normalize ? 0.25f / (d * d) : 0.25f;
  mfcc_mean(staged + kPad, n_samples, hop, n_frames, n_mels, n_mfcc, scale,
            top_db, hann, tw, fb, lo, hi, dct, work, row);
  __syncthreads();  // the work buffer passes to the YIN tables

  // 3. the YIN pitch, of the normalized clip when both flags ask for it
  if (normalize && pitch_normalized) {
    for (int p = threadIdx.x; p < lay.staged; p += kThreads)
      staged[p] = staged[p] / d;
    __syncthreads();
  }
  const float hz = yin_median_f0(staged, reinterpret_cast<char*>(work),
                                 lay.yin, n_frames, win, hop, min_p, max_p,
                                 threshold, sr);
  if (threadIdx.x == 0) {
    row[n_mfcc] = log10f(hz);
    hz_out[blockIdx.x] = hz;
  }
}

static cudaError_t frontend_set_attributes(const FrontendLayout& lay) {
  return cudaFuncSetAttribute(mfcc_pitch_frontend_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)lay.bytes());
}

extern "C" int gat_mfcc_pitch_frontend(
    const float* clips, float* out, float* hz, const float* hann,
    const float* tw, const float* fb, const int* lo, const int* hi,
    const float* dct, int n_clips, int n_samples, int hop, int n_frames,
    int n_mels, int n_mfcc, int win, int min_p, int max_p, int normalize,
    int pitch_normalized, float top_db, float threshold, float sr,
    void* stream) {
  if (n_frames >= kMaxFrames || !mfcc_epilogue_fits(n_mels, n_mfcc))
    return (int)cudaErrorInvalidValue;
  const FrontendLayout lay(n_samples, n_frames, n_mels, win, hop, max_p);
  cudaError_t err = frontend_set_attributes(lay);
  if (err != cudaSuccess) return (int)err;
  mfcc_pitch_frontend_kernel<<<n_clips, kThreads, lay.bytes(),
                               (cudaStream_t)stream>>>(
      clips, out, hz, hann, tw, fb, lo, hi, dct, n_samples, hop, n_frames,
      n_mels, n_mfcc, win, min_p, max_p, normalize, pitch_normalized, top_db,
      threshold, sr);
  return (int)cudaGetLastError();
}

// Resident blocks per SM at these sizes, as the CUDA runtime computes it
// from the kernel's registers and shared memory.
extern "C" int gat_mfcc_pitch_frontend_blocks_per_sm(int n_samples, int hop,
                                                     int n_frames, int n_mels,
                                                     int win, int max_p,
                                                     int* blocks) {
  if (n_frames >= kMaxFrames) return (int)cudaErrorInvalidValue;
  const FrontendLayout lay(n_samples, n_frames, n_mels, win, hop, max_p);
  cudaError_t err = frontend_set_attributes(lay);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, mfcc_pitch_frontend_kernel, kThreads, lay.bytes());
}
