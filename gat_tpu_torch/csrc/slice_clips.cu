// K8: the clip slicer of whole files, y (B, n), onsets (B, K) int32,
// onsets_valid (B, K) -> clips (B, K, L) float32, kept (B, K), times
// (B, K, 2) float32 seconds.
//
// Replaces the JAX package's XLA program gat_tpu/segment/slicing.py:48
// slice_at_onsets with its loudness gate gat_tpu/segment/gating.py:147
// slice_rms_db. It replaces no Pallas kernel: the reference never wrote
// one for the slicer. Per (file, slot k), with n the row's valid count
// (its length when none is given) and count the file's valid slots:
//   nxt   = onsets[k + 1] if k + 1 < count, else onsets[max(count - 1, 0)]
//           (strict_reference_compat: the last onset's slice is empty) or
//           n (without it);
//   start = onsets[k] + skip, end = min(start + L, nxt);
//   clip  = the samples of [start, end), at clip positions [0, end -
//           start), zero elsewhere and zero unless start < n, end <= n and
//           the slot is valid; read as the reference reads them: sample
//           by sample with the position clamped into the row, or (hop > 0)
//           as hop-long rows of the skip-shifted row, rows clamped, past
//           the row zero; inside the window both read y[start + j];
//   kept  = valid and 20·log10(sqrt(mean(clip²)) + 1e-10) > min_db;
//   times = (start, end) · fl(1 / sr) in float32.
//
// What bounds it: bytes. It writes K·L floats per file and reads at most
// as many samples (the windows), with two operations a sample for the
// loudness sum, far below the operation rate; the reference's program and
// the port's plain PyTorch build (B, K, L) index and mask tensors besides.
// The design is one block per (file, slot), one launch per call: the block
// reads the file's valid row and its slot's onsets, works out the window,
// writes the clip with 16-byte stores (the row's unaligned head and tail
// one float at a time), gathering only inside the window (an empty or
// refused window writes zeros and reads nothing), sums the squares it
// wrote in fp64, and writes kept and times.
#include <cmath>
#include <cstdint>

#include "dsp_common.cuh"

using namespace gat;

constexpr int kWarps = kThreads / 32;
constexpr float kEps = 1e-10f;  // slice_rms_db's log10 floor
constexpr unsigned kFull = 0xffffffffu;

template <class T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(kFull, v, s);
  return v;
}

// The window of one slot and how its samples are read.
struct Window {
  const float* row;
  long long start, end, first_row;
  int n, skip, hop, n_rows;
  bool open;  // start < n, end <= n and the slot valid

  // clip sample j: y[start + j] inside the window, else 0
  __device__ __forceinline__ float at(int j) const {
    const long long pos = start + j;
    if (!open || pos >= end) return 0.0f;
    if (hop == 0) {  // the per-sample gather, position clamped
      const long long p = pos < 0 ? 0 : (pos > n - 1 ? n - 1 : pos);
      return row[p];
    }
    // the row gather: rows first_row + j / hop, clamped, of the row cut
    // into hop-long rows from sample skip, zero past its end
    long long r = first_row + j / hop;
    r = r > n_rows - 1 ? n_rows - 1 : r;
    const long long q = skip + r * hop + j % hop;
    return q < n ? row[q] : 0.0f;
  }
};

__global__ void __launch_bounds__(kThreads)
slice_clips_kernel(const float* __restrict__ y, const int* __restrict__ onsets,
                   const unsigned char* __restrict__ onsets_valid,
                   const int* __restrict__ n_valid, float* __restrict__ clips,
                   unsigned char* __restrict__ kept,
                   float* __restrict__ times, int n, int k, int length,
                   int skip, int hop, int strict, float min_slice_rms_db,
                   float inv_sr) {
  __shared__ int wcount[kWarps];
  __shared__ double wsum[kWarps];
  const int slot = blockIdx.x, file = slot / k, j = slot % k;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* o = onsets + (size_t)file * k;
  const unsigned char* ov = onsets_valid + (size_t)file * k;

  int c = 0;
  for (int q = threadIdx.x; q < k; q += kThreads) c += ov[q] != 0;
  c = warp_sum(c);
  if (lane == 0) wcount[warp] = c;
  __syncthreads();
  int count = 0;
  for (int w = 0; w < kWarps; ++w) count += wcount[w];

  const long long nn = n_valid ? (long long)n_valid[file] : (long long)n;
  const long long last = o[count - 1 > 0 ? count - 1 : 0];
  const long long nxt =
      j + 1 < count ? (long long)o[(j + 1) % k] : (strict ? last : nn);
  Window w;
  w.row = y + (size_t)file * n;
  w.n = n;
  w.skip = skip;
  w.hop = hop;
  w.start = (long long)o[j] + skip;
  w.end = w.start + length < nxt ? w.start + length : nxt;
  w.open = w.start < nn && w.end <= nn && ov[j] != 0;
  if (hop > 0) {
    const long long avail = n - skip > 0 ? (long long)n - skip : 0;
    const long long rows = (avail + hop - 1) / hop;
    w.n_rows = rows > 1 ? (int)rows : 1;
    long long first = o[j] >= 0 ? o[j] / hop : -((-(long long)o[j] + hop - 1)
                                                 / hop);  // floor division
    first = first < 0 ? 0 : (first > w.n_rows - 1 ? w.n_rows - 1 : first);
    w.first_row = first;
  }

  float* dst = clips + (size_t)slot * length;
  double acc = 0.0;
  int head = (int)(((16u - ((uintptr_t)dst & 15u)) & 15u) / 4u);
  head = head > length ? length : head;
  for (int q = threadIdx.x; q < head; q += kThreads) {
    const float v = w.at(q);
    dst[q] = v;
    acc += (double)(v * v);
  }
  const int body = (length - head) / 4;
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  for (int b = threadIdx.x; b < body; b += kThreads) {
    const int q = head + 4 * b;
    float4 v;
    v.x = w.at(q);
    v.y = w.at(q + 1);
    v.z = w.at(q + 2);
    v.w = w.at(q + 3);
    d4[b] = v;
    acc += (double)(v.x * v.x) + (double)(v.y * v.y) + (double)(v.z * v.z) +
           (double)(v.w * v.w);
  }
  for (int q = head + 4 * body + threadIdx.x; q < length; q += kThreads) {
    const float v = w.at(q);
    dst[q] = v;
    acc += (double)(v * v);
  }
  acc = warp_sum(acc);
  if (lane == 0) wsum[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double total = 0.0;
    for (int q = 0; q < kWarps; ++q) total += wsum[q];
    const float mean = (float)total / (float)length;
    const float db = 20.0f * log10f(sqrtf(mean) + kEps);
    kept[slot] = ov[j] != 0 && db > min_slice_rms_db;
    times[2 * (size_t)slot] = __fmul_rn((float)w.start, inv_sr);
    times[2 * (size_t)slot + 1] = __fmul_rn((float)w.end, inv_sr);
  }
}

// Slices n_files rows of n samples at k onsets each into clips of
// `length` samples from `skip` past each onset. n_valid: (n_files,)
// int32, or NULL for the whole rows; hop 0 reads sample by sample, hop > 0
// as the reference's hop-long rows; inv_sr is fl(1 / sr).
extern "C" int gat_slice_clips(const float* y, const int* onsets,
                               const unsigned char* onsets_valid,
                               const int* n_valid, float* clips,
                               unsigned char* kept, float* times,
                               int n_files, int n, int k, int length,
                               int skip, int hop, int strict,
                               float min_slice_rms_db, float inv_sr,
                               void* stream) {
  if (n_files < 1 || n < 1 || k < 1 || length < 1 || skip < 0 || hop < 0 ||
      (long long)n_files * k > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  slice_clips_kernel<<<n_files * k, kThreads, 0, (cudaStream_t)stream>>>(
      y, onsets, onsets_valid, n_valid, clips, kept, times, n, k, length,
      skip, hop, strict, min_slice_rms_db, inv_sr);
  return (int)cudaGetLastError();
}

// Resident blocks per SM, as the CUDA runtime computes it (its shared
// memory is fixed: the same at any clip length).
extern "C" int gat_slice_clips_blocks_per_sm(int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, slice_clips_kernel, kThreads, 0);
}
