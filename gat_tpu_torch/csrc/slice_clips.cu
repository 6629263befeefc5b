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
//           the row zero;
//   kept  = valid and 20·log10(sqrt(mean(clip²)) + 1e-10) > min_db;
//   times = (start, end) · fl(1 / sr) in float32.
//
// What bounds it: bytes. It writes K·L floats per file and reads at most
// as many samples (the windows), with two operations a sample for the
// loudness sum, far below the operation rate; the reference's program and
// the port's plain PyTorch build (B, K, L) index and mask tensors besides.
// One block per (file, slot), one launch per call. The block reads the
// file's valid row and its slot's onsets and works out the window, then
// takes one of two routes, the same for all its threads:
//   staged   the window is closed or empty (w = 0), or it is open with
//            start >= 0, end <= n (the row's length: a valid count past
//            it opens windows that cross it) and either hop == 0 or an
//            onset that is a non-negative multiple of hop. Then clip sample
//            j is y[start + j] for j < w = end - start, with no clamp: for
//            hop == 0, start + j lies in [start, end) within [0, n); for
//            hop > 0, onset = m·hop with m >= 0 and onset < n - skip
//            (start < end <= n), so first_row = m needs no clamp, and row
//            r = m + j / hop holds skip + r·hop + j % hop = start + j < end
//            <= n, so no row is clamped and no sample lies past the row.
//            The window goes through a ring of kStages stages in shared
//            memory, chunk
//            c of kChunk clip samples (and the 3 past it that its last
//            float4 reads) by one bulk copy (TMA, cp.async.bulk on the
//            stage's mbarrier) of its 16-byte-aligned cover, rounded out
//            to 16 bytes at both ends (floats beside the window are read
//            and not used; only floats past the tensor's aligned interior
//            are read one at a time instead, at the tensor's first and
//            last 16 bytes). Every chunk of the window is in flight before
//            the first is written out when the window fits the ring (0.5 s
//            at 22050 Hz); past that a stage is refilled as soon as the
//            block has written it out. Each thread writes its float4 of
//            the clip's aligned body from four floats of the stage read at
//            the source's phase (the clip's and the row's 16-byte phases
//            differ from slot to slot), the clip's unaligned head and tail
//            a float at a time; past w the block stores zeros and reads
//            nothing.
//   general  every other open window (an onset off the hop grid, whose
//            samples are the reference's hop-long rows, a negative start,
//            whose clamped positions repeat sample 0, or an end past the
//            row, whose positions are clamped to sample n - 1 or whose rows
//            are clamped and zero past the row): a sample at a
//            time through Window::at, the division and clamps of the
//            reference's gathers, as the first design of this kernel did.
// Both routes give each thread the clip samples and the order of adds of
// the first design (head, body float4s b ≡ thread mod kThreads, tail), and
// the loudness sums each stored sample squared in float32 and widened to
// fp64, so kept and times are those of the first design bit for bit.
#include <cmath>
#include <cstdint>

#include "bulk_copy.cuh"
#include "dsp_common.cuh"

using namespace gat;

constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;     // stages of the ring
constexpr int kChunk = 4064;   // clip samples a stage serves
// + up to 3 floats of the copy's rounding at the front, the 3 floats past
// the chunk its last float4 reads, and the rounding of their end: 48,864
// bytes for the ring, under the 48 KB of static shared memory with the
// barriers and the warp sums; 4 blocks of 256 threads an SM
constexpr int kStageFloats = kChunk + 8;
constexpr float kEps = 1e-10f;  // slice_rms_db's log10 floor
constexpr unsigned kFull = 0xffffffffu;

template <class T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(kFull, v, s);
  return v;
}

// The window of one slot and how the general route reads its samples.
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

struct alignas(16) SliceShared {
  float ring[kStages][kStageFloats];
  uint64_t bars[kStages];
  double wsum[kWarps];
  int wcount[kWarps];
};

// The staged route's window: clip sample q is src[q] for q < w. sh is
// src's 16-byte phase in floats (kChunk is a multiple of 4, so every chunk
// starts at it); [lo_min, hi_max) the tensor's 16-byte-aligned interior,
// in floats from src.
struct Staged {
  const float* src;
  int w, sh;
  long long lo_min, hi_max;
};

// Stages chunk c into its stage, completing on its barrier: one bulk copy
// of the chunk's cover within the tensor's aligned interior, what the
// interior cuts off one float at a time, stored before thread 0's arrival
// (its release makes them visible with the copy). Thread 0 only.
__device__ __forceinline__ void stage_chunk(SliceShared& sm, const Staged& s,
                                            int c) {
  const int st = c % kStages;
  const long long need_lo = (long long)c * kChunk;
  const long long need_hi =
      need_lo + kChunk + 3 < s.w ? need_lo + kChunk + 3 : (long long)s.w;
  long long lo = need_lo - s.sh;
  long long hi = lo + ((need_hi - lo + 3) & ~3LL);
  lo = lo > s.lo_min ? lo : s.lo_min;
  hi = hi < s.hi_max ? hi : s.hi_max;
  float* stage = sm.ring[st];  // clip sample q at stage[q - need_lo + sh]
  const long long off = s.sh - need_lo;
  for (long long q = need_lo; q < need_hi && q < lo; ++q)
    stage[q + off] = s.src[q];
  for (long long q = hi > need_lo ? hi : need_lo; q < need_hi; ++q)
    stage[q + off] = s.src[q];
  const unsigned bytes = hi > lo ? (unsigned)(4 * (hi - lo)) : 0u;
  mbar_arrive_expect(&sm.bars[st], bytes);
  if (bytes) bulk_load(stage + (lo + off), s.src + lo, bytes, &sm.bars[st]);
}

__global__ void __launch_bounds__(kThreads, 4)
slice_clips_kernel(const float* __restrict__ y, const int* __restrict__ onsets,
                   const unsigned char* __restrict__ onsets_valid,
                   const int* __restrict__ n_valid, float* __restrict__ clips,
                   unsigned char* __restrict__ kept,
                   float* __restrict__ times, int n_files, int n, int k,
                   int length, int skip, int hop, int strict,
                   float min_slice_rms_db, float inv_sr) {
  __shared__ SliceShared sm;
  const int slot = blockIdx.x, file = slot / k, j = slot % k;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* o = onsets + (size_t)file * k;
  const unsigned char* ov = onsets_valid + (size_t)file * k;
  if (threadIdx.x == 0)
    for (int s = 0; s < kStages; ++s) mbar_init(&sm.bars[s], 1);

  // the slot's own values load beside the valid flags, in one round trip;
  // the last valid onset only where the window needs it
  const int onset = o[j], next_onset = o[(j + 1) % k];
  const bool valid = ov[j] != 0;
  const long long nn = n_valid ? (long long)n_valid[file] : (long long)n;
  int c = 0;
  for (int q = threadIdx.x; q < k; q += kThreads) c += ov[q] != 0;
  c = warp_sum(c);
  if (lane == 0) sm.wcount[warp] = c;
  __syncthreads();
  int count = 0;
  for (int w = 0; w < kWarps; ++w) count += sm.wcount[w];

  const long long nxt =
      j + 1 < count ? (long long)next_onset
                    : (strict ? (long long)o[count - 1 > 0 ? count - 1 : 0]
                              : nn);
  Window w;
  w.row = y + (size_t)file * n;
  w.n = n;
  w.skip = skip;
  w.hop = hop;
  w.start = (long long)onset + skip;
  w.end = w.start + length < nxt ? w.start + length : nxt;
  w.open = w.start < nn && w.end <= nn && valid;
  const int wlen = w.open && w.end > w.start ? (int)(w.end - w.start) : 0;
  const bool staged =
      wlen == 0 || (w.start >= 0 && w.end <= n &&
                    (hop == 0 || (onset >= 0 && onset % hop == 0)));

  float* dst = clips + (size_t)slot * length;
  double acc = 0.0;
  int head = (int)(((16u - ((uintptr_t)dst & 15u)) & 15u) / 4u);
  head = head > length ? length : head;
  const int body = (length - head) / 4;
  const int tail = head + 4 * body;
  float4* d4 = reinterpret_cast<float4*>(dst + head);

  if (staged) {
    Staged s;
    s.src = w.row + (wlen ? w.start : 0);
    s.w = wlen;
    s.sh = (int)(((uintptr_t)s.src >> 2) & 3);
    const uintptr_t first = (uintptr_t)y;
    const uintptr_t past = (uintptr_t)(y + (size_t)n_files * n);
    s.lo_min = ((long long)((first + 15) & ~(uintptr_t)15) -
                (long long)(uintptr_t)s.src) / 4;
    s.hi_max = ((long long)(past & ~(uintptr_t)15) -
                (long long)(uintptr_t)s.src) / 4;
    const int n_data = wlen > 0 ? (wlen - 1) / kChunk + 1 : 0;
    if (threadIdx.x == 0)
      for (int q = 0; q < n_data && q < kStages; ++q) stage_chunk(sm, s, q);
    // past the window's chunks: zeros, stores only (a zero adds nothing),
    // while the copies are in flight
    const int z = n_data * kChunk;
    for (int q = threadIdx.x; q < head; q += kThreads)
      if (q >= z) dst[q] = 0.0f;
    const float4 zero = {0.0f, 0.0f, 0.0f, 0.0f};
    const int bz0 = z > head ? (z - head + 3) >> 2 : 0;
    for (int b = bz0 + threadIdx.x; b < body; b += kThreads) d4[b] = zero;
    for (int q = tail + threadIdx.x; q < length; q += kThreads)
      if (q >= z) dst[q] = 0.0f;
    for (int ch = 0; ch < n_data; ++ch) {
      mbar_wait(&sm.bars[ch % kStages], (ch / kStages) & 1);
      // stage index of clip sample q: q + off, for q in [ch·kChunk,
      // (ch + 1)·kChunk + 3)
      const int off = ch % kStages * kStageFloats + s.sh - ch * kChunk;
      const float* ring = &sm.ring[0][0];
      auto at = [&](int q) { return q < wlen ? ring[q + off] : 0.0f; };
      const int lo = ch * kChunk, hi = lo + kChunk;
      if (ch == 0)
        for (int q = threadIdx.x; q < head; q += kThreads) {
          const float v = at(q);
          dst[q] = v;
          acc += (double)(v * v);
        }
      // the float4s that start in this chunk, each thread's own as in the
      // first design (b ≡ thread mod kThreads)
      const int b_lo = (lo - head + 3) >> 2;
      const int b_end = (hi - head + 3) >> 2;
      const int b_hi = b_end < body ? b_end : body;
      for (int b = b_lo + (((int)threadIdx.x - b_lo) & (kThreads - 1)); b < b_hi;
           b += kThreads) {
        const int q = head + 4 * b;
        float4 v;
        v.x = at(q);
        v.y = at(q + 1);
        v.z = at(q + 2);
        v.w = at(q + 3);
        d4[b] = v;
        acc += (double)(v.x * v.x) + (double)(v.y * v.y) +
               (double)(v.z * v.z) + (double)(v.w * v.w);
      }
      for (int q = tail + threadIdx.x; q < length; q += kThreads)
        if (q >= lo && q < hi) {
          const float v = at(q);
          dst[q] = v;
          acc += (double)(v * v);
        }
      if (ch + kStages < n_data) {
        __syncthreads();  // the stage is read out: refill it
        if (threadIdx.x == 0) stage_chunk(sm, s, ch + kStages);
      }
    }
  } else {
    if (hop > 0) {
      const long long avail = n - skip > 0 ? (long long)n - skip : 0;
      const long long rows = (avail + hop - 1) / hop;
      w.n_rows = rows > 1 ? (int)rows : 1;
      long long first = onset >= 0 ? onset / hop
                                   : -((-(long long)onset + hop - 1) / hop);
      first = first < 0 ? 0 : (first > w.n_rows - 1 ? w.n_rows - 1 : first);
      w.first_row = first;
    }
    for (int q = threadIdx.x; q < head; q += kThreads) {
      const float v = w.at(q);
      dst[q] = v;
      acc += (double)(v * v);
    }
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
    for (int q = tail + threadIdx.x; q < length; q += kThreads) {
      const float v = w.at(q);
      dst[q] = v;
      acc += (double)(v * v);
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) sm.wsum[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double total = 0.0;
    for (int q = 0; q < kWarps; ++q) total += sm.wsum[q];
    const float mean = (float)total / (float)length;
    const float db = 20.0f * log10f(sqrtf(mean) + kEps);
    kept[slot] = valid && db > min_slice_rms_db;
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
      y, onsets, onsets_valid, n_valid, clips, kept, times, n_files, n, k,
      length, skip, hop, strict, min_slice_rms_db, inv_sr);
  return (int)cudaGetLastError();
}

// Resident blocks per SM, as the CUDA runtime computes it (its shared
// memory is static: the same at any clip length).
extern "C" int gat_slice_clips_blocks_per_sm(int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, slice_clips_kernel, kThreads, 0);
}

// The staged route's ring: its stages, the clip samples a stage serves and
// the block's static shared memory in bytes, the ring's barriers and the
// warp sums included.
extern "C" int gat_slice_clips_ring(int* stages, int* chunk, int* bytes) {
  *stages = kStages;
  *chunk = kChunk;
  *bytes = (int)sizeof(SliceShared);
  return 0;
}
