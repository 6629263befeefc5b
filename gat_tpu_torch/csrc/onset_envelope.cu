// K4: the onset envelope of whole files, y (B, n) -> env (B, T),
// T = 1 + n / hop.
//
// Replaces the JAX package's XLA program gat_tpu/ops/onset.py::
// onset_strength (librosa.onset.onset_strength). Per file:
//   1. zero center pad of n_fft / 2, hop-`hop` periodic-Hann frames, a
//      2048-point DFT, |X|^2 on the 1025 rfft bins;
//   2. the Slaney mel projection (n_mels bands, K2's tables at the file's
//      rate);
//   3. 10*log10(max(., 1e-10)), clamped at peak - top_db, with the peak
//      over the file's valid frames t < nvf only;
//   4. the positive lag difference, averaged over the bands;
//   5. shifted right by `shift` = lag + n_fft / (2 hop) frames with zeros
//      in front, cut to T.
//
// What bounds it: each frame needs one real-input 2048-point FFT (about
// 70 k fp32 flops with the mel) against 2 KB of new samples, so the fp32
// operation rate bounds it. K2's round loop (mel_rounds.cuh: two frames
// per complex FFT, register Stockham passes, four frames in flight) does
// that work; the spectrum never leaves the block. K2 owns a clip with one
// block, but a file of 60 s has 2584 frames, which one block would walk
// alone. So the grid runs over (file, chunk of kChunk frames), and the
// peak, which needs the whole file, takes a second pass:
//   pass 1 (one block per chunk): the rounds over the chunk's frames, the
//     pre-clamp dB into a (B, T, n_mels) scratch, and the chunk's maximum
//     over its valid frames into a (B, n_chunks) scratch;
//   pass 2 (one block per chunk): the file's peak from its chunk maxima,
//     then clamp, difference and mean for the chunk's output frames.
// The scratch costs T * n_mels * 8 bytes of traffic per file, about 6 %
// of the samples' FFT work in time. Shared memory of pass 1 is K2's
// rounds (51,200 bytes at 128 bands), so four blocks fit on an SM.
#include <cmath>

#include "mel_rounds.cuh"

using namespace gat;

constexpr int kChunk = 32;  // frames per block (ONSET_CHUNK in ops/onset.py)

static size_t mel_db_smem_bytes(int n_mels) {
  return sizeof(float) * (size_t)mel_rounds_floats(n_mels);
}

static size_t flux_smem_bytes(int n_mels) {
  return sizeof(float) * (size_t)(kThreads + kChunk * n_mels);
}

__global__ void __launch_bounds__(kThreads, 4)
onset_mel_db_kernel(const float* __restrict__ y, float* __restrict__ db,
                    float* __restrict__ chunk_max,
                    const float* __restrict__ hann,
                    const float* __restrict__ tw,
                    const float* __restrict__ fb,
                    const int* __restrict__ lo, const int* __restrict__ hi,
                    const int* __restrict__ nvf, int n_samples, int hop,
                    int n_frames, int n_mels, int n_chunks) {
  extern __shared__ float smem[];
  const int file = blockIdx.x / n_chunks, chunk = blockIdx.x % n_chunks;
  const int t_begin = chunk * kChunk;
  const int t_end = t_begin + kChunk < n_frames ? t_begin + kChunk : n_frames;
  const int valid_end = nvf[file];
  const float* clip = y + (size_t)file * n_samples;
  float* out = db + (size_t)file * n_frames * n_mels;

  float peak = -INFINITY;
  mel_rounds</*kReflect=*/false>(
      clip, n_samples, hop, t_begin, t_end, n_mels, hann, tw, fb, lo, hi,
      smem, [&](int m, int t, float v) {
        // the split's (1/2)^2: power_scale(..., normalize = 0)
        const float d = 10.0f * log10f(fmaxf(v * 0.25f, 1e-10f));
        out[(size_t)t * n_mels + m] = d;
        if (t < valid_end) peak = fmaxf(peak, d);
      });
  // the exchange buffer is free once the rounds return
  const float p = block_max(peak, smem);
  if (threadIdx.x == 0) chunk_max[blockIdx.x] = p;
}

__global__ void __launch_bounds__(kThreads)
onset_flux_kernel(const float* __restrict__ db,
                  const float* __restrict__ chunk_max,
                  float* __restrict__ env, int n_frames, int n_mels,
                  int n_chunks, int lag, int shift, float top_db) {
  extern __shared__ float smem[];
  float* scratch = smem;            // kThreads
  float* part = smem + kThreads;    // kChunk x n_mels
  const int file = blockIdx.x / n_chunks, chunk = blockIdx.x % n_chunks;
  const int t_begin = chunk * kChunk;
  const int n_out = (t_begin + kChunk < n_frames ? t_begin + kChunk
                                                 : n_frames) - t_begin;

  float m = -INFINITY;
  for (int i = threadIdx.x; i < n_chunks; i += kThreads)
    m = fmaxf(m, chunk_max[(size_t)file * n_chunks + i]);
  const float floor_db = block_max(m, scratch) - top_db;

  // output frame t >= shift is the flux from frame j = t - shift to j + lag
  const float* s = db + (size_t)file * n_frames * n_mels;
  for (int i = threadIdx.x; i < n_out * n_mels; i += kThreads) {
    const int f = i / n_mels, band = i % n_mels;
    const int j = t_begin + f - shift;
    float d = 0.0f;
    if (j >= 0) {
      const float a = fmaxf(s[(size_t)j * n_mels + band], floor_db);
      const float b = fmaxf(s[(size_t)(j + lag) * n_mels + band], floor_db);
      d = fmaxf(b - a, 0.0f);
    }
    part[i] = d;
  }
  __syncthreads();
  for (int f = threadIdx.x; f < n_out; f += kThreads) {
    const float* row = part + f * n_mels;
    float acc = 0.0f;
    for (int band = 0; band < n_mels; ++band) acc += row[band];
    env[(size_t)file * n_frames + t_begin + f] =
        t_begin + f < shift ? 0.0f : acc / (float)n_mels;
  }
}

static cudaError_t onset_set_attributes(int n_mels) {
  cudaError_t err = cudaFuncSetAttribute(
      onset_mel_db_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)mel_db_smem_bytes(n_mels));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(onset_flux_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)flux_smem_bytes(n_mels));
}

extern "C" int gat_onset_envelope(const float* y, float* env, float* db,
                                  float* chunk_max, const float* hann,
                                  const float* tw, const float* fb,
                                  const int* lo, const int* hi,
                                  const int* nvf, int n_files, int n_samples,
                                  int hop, int n_frames, int n_mels, int lag,
                                  int shift, float top_db, void* stream) {
  // pass 2 reads frames j + lag <= T - 1 - shift + lag
  if (lag < 1 || shift < lag || lag >= n_frames)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = onset_set_attributes(n_mels);
  if (err != cudaSuccess) return (int)err;
  const int n_chunks = (n_frames + kChunk - 1) / kChunk;
  onset_mel_db_kernel<<<n_files * n_chunks, kThreads,
                        mel_db_smem_bytes(n_mels), (cudaStream_t)stream>>>(
      y, db, chunk_max, hann, tw, fb, lo, hi, nvf, n_samples, hop, n_frames,
      n_mels, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  onset_flux_kernel<<<n_files * n_chunks, kThreads, flux_smem_bytes(n_mels),
                      (cudaStream_t)stream>>>(
      db, chunk_max, env, n_frames, n_mels, n_chunks, lag, shift, top_db);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the first pass (the FFT work) at these sizes,
// as the CUDA runtime computes it from registers and shared memory.
extern "C" int gat_onset_envelope_blocks_per_sm(int n_mels, int* blocks) {
  cudaError_t err = onset_set_attributes(n_mels);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, onset_mel_db_kernel, kThreads, mel_db_smem_bytes(n_mels));
}
