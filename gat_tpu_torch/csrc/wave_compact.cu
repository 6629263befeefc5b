// K10: the wave's clip-budget compaction, two kernels.
//
// Replaces the JAX package's XLA program gat_tpu/infer/pipeline.py:171-196,
// the budget branch of build_files_fn: a stable argsort of the wave's kept
// bits in slot-major order (jnp.argsort(~keptt, stable=True)[:budget]), the
// map of each picked position to its file-major slot, and the scatter of
// the budget's outputs back to zeros with the computed/dropped flags. It
// replaces no Pallas kernel: the reference left the compaction to XLA.
//
// gat_wave_select: kept_all (n_files, K) bytes, 0 or 1, of the whole wave;
// this rank's files are [first, first + n_local) (first 0 and n_local
// n_files on one device). Slot-major position p is file f = p % n_files,
// slot s = p / n_files. With kb(p) the kept bits before p and n_kept their
// total, p's rank in the stable partition is
//   r = kb(p)                     if p is kept,
//   r = n_kept + (p - kb(p))      if not,
// and p is picked when r < budget: the reference's sel is the picked
// positions in rank order, each as the file-major slot f·K + s. This rank
// keeps its own picked slots in the same order: its row for a picked slot
// is the count of its picked kept slots before it, or for a non-kept one
// the total of its picked kept slots plus its picked non-kept slots before
// it (on one device that row is r). The launch writes
//   sel[row]     = the local file-major slot, rows [0, n_sel);
//   pos[slot]    = its row, or -1 where the slot is not picked;
//   kept[slot]   = kept and picked (the reference's kept & computed);
//   dropped[f]   = the file lost a kept slot to the budget;
//   overflow[f]  = overflow_in[f] | dropped[f], fixable likewise;
//   n_sel[0]     = the rows written.
// Non-kept slots inside the budget are picked too: they are classified
// from zero clips and their outputs are scattered back, as the reference's.
//
// gat_wave_scatter: pos (n,) and the compact outputs (rows, C) of the
// blend, the MLP and the CNN and (rows,) of the pitch -> the (n, C) and
// (n,) outputs, out[i] = pos[i] >= 0 ? compact[pos[i]] : 0. A part given
// as a null pointer is skipped (a build without a CNN or an MLP).
//
// What bounds them: latency. The serving wave (4 files x 112 slots, budget
// 384, 47 classes) moves under half a megabyte in all, 0.14 µs at the
// card's 3.35 TB/s, so a launch and its few dependent steps are the time.
// The design takes the least of those. The select is one block of 512
// threads that walks the slot-major positions in tiles of 512 x `items`
// positions, `items` consecutive positions a thread, as few as cover the
// wave and at most 16 (the serving wave: one a thread; a 64-file wave of
// 7,168 slots: 14 a thread, one tile). A thread finds its first
// position's file and slot by one division and steps through the others,
// loads its kept bits with the loads in flight together and counts them;
// one block-wide exclusive scan of the threads' counts (warp shuffles, one
// exchange of warp totals through shared memory) gives every position its
// kb, and the counts carry from tile to tile. A wave of one tile is read
// once for everything (its kept count is the scan's total); a longer one
// is counted first, in memory order; under a mesh a pass more counts this
// rank's picked kept slots. The scatter is one launch for all four
// outputs, each part its own range of blocks sized to it, each thread four
// output elements a block's width apart (32-bit index arithmetic), each
// reading its row's pos and copying or writing 0. No library sort, scan or
// scatter is called.
#include <cuda_runtime.h>

constexpr int kSelectThreads = 512;  // one block
constexpr int kSelectWarps = kSelectThreads / 32;
constexpr int kItems = 16;           // consecutive positions a thread, at most
constexpr int kTile = kSelectThreads * kItems;
constexpr int kScatterThreads = 256;
constexpr int kScatterItems = 4;     // output elements a thread
constexpr int kScatterBlock = kScatterThreads * kScatterItems;

// Exclusive prefix sums in thread order of N counts a thread over the
// block (`before`) and their totals (`total`). Every thread of the block
// calls it; `sums` is shared memory of N x kSelectWarps ints.
template <int N>
__device__ __forceinline__ void block_scan(const int (&v)[N],
                                           int (&before)[N],
                                           int (&total)[N],
                                           int (*sums)[kSelectWarps]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc[N];
  for (int i = 0; i < N; ++i) {
    inc[i] = v[i];
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, inc[i], d);
      if (lane >= d) inc[i] += u;
    }
    if (lane == 31) sums[i][warp] = inc[i];
  }
  __syncthreads();
  for (int i = 0; i < N; ++i) {
    int b = inc[i] - v[i], t = 0;
    for (int w = 0; w < kSelectWarps; ++w) {
      const int s = sums[i][w];
      b += w < warp ? s : 0;
      t += s;
    }
    before[i] = b;
    total[i] = t;
  }
  __syncthreads();  // sums are free for the next call
}

// A thread's walk over its `items` slot-major positions from p0 on:
// position p is file p % n_files, slot p / n_files, found once by a
// division and then stepped.
struct Walk {
  int f, s, n_files;
  __device__ Walk(int p0, int n) : f(p0 % n), s(p0 / n), n_files(n) {}
  __device__ void next() {
    if (++f == n_files) {
      f = 0;
      ++s;
    }
  }
};

// The kept bits of a thread's positions (0 past the wave) as the bits of
// one word; the loads are independent, so they are in flight together.
__device__ __forceinline__ unsigned thread_bits(
    const unsigned char* __restrict__ kept_all, int p0, int items, int total,
    int n_files, int k) {
  unsigned bits = 0;
  Walk w(p0, n_files);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (j < items && p0 + j < total && kept_all[w.f * k + w.s] != 0)
      bits |= 1u << j;
    w.next();
  }
  return bits;
}

__global__ void __launch_bounds__(kSelectThreads) wave_select_kernel(
    const unsigned char* __restrict__ kept_all,
    const unsigned char* __restrict__ overflow_in,
    const unsigned char* __restrict__ fixable_in, int* __restrict__ sel,
    int* __restrict__ pos, unsigned char* __restrict__ kept,
    unsigned char* __restrict__ dropped, unsigned char* __restrict__ overflow,
    unsigned char* __restrict__ fixable, int* __restrict__ n_sel,
    int n_files, int k, int budget, int first, int n_local, int items) {
  __shared__ int sums[2][kSelectWarps];
  const int t = threadIdx.x;
  const int total = n_files * k;
  const int tile_len = kSelectThreads * items;
  const bool one_tile = total <= tile_len;
  const bool whole = first == 0 && n_local == n_files;
  for (int f = t; f < n_local; f += kSelectThreads) dropped[f] = 0;

  // the wave's kept count, read in memory order (one tile: the scans
  // below count it)
  int n_kept = 0;
  for (int base = 0; !one_tile && base < total; base += tile_len) {
    int count[1] = {0}, before[1], tile[1];
    for (int j = 0; j < items; ++j) {
      const int i = base + j * kSelectThreads + t;
      count[0] += i < total && kept_all[i] != 0;
    }
    block_scan<1>(count, before, tile, sums);
    n_kept += tile[0];
  }

  // a position with kb kept bits before it is picked when its rank in the
  // stable partition is below the budget
  const auto picked = [&](int p, int kb, bool is_kept) {
    return (is_kept ? kb : n_kept + (p - kb)) < budget;
  };
  const auto local = [&](int f) { return f >= first && f < first + n_local; };

  // this rank's picked kept slots: all the picked kept ones on one device
  int local_kept = -1;
  if (!whole) {
    local_kept = 0;
    int carry = 0;  // kept bits before the tile
    for (int base = 0; base < total; base += tile_len) {
      const int p0 = base + t * items;
      const unsigned bits = thread_bits(kept_all, p0, items, total, n_files,
                                        k);
      int count[1] = {__popc(bits)}, before[1], tile[1];
      block_scan<1>(count, before, tile, sums);
      if (one_tile) n_kept = tile[0];
      int kb = carry + before[0], lk[1] = {0}, lk_before[1], lk_tile[1];
      Walk w(p0, n_files);
      for (int j = 0; j < items && p0 + j < total; ++j, w.next()) {
        const bool is_kept = bits >> j & 1u;
        lk[0] += is_kept && picked(p0 + j, kb, true) && local(w.f);
        kb += is_kept;
      }
      block_scan<1>(lk, lk_before, lk_tile, sums);
      local_kept += lk_tile[0];
      carry += tile[0];
    }
  }

  // every output, tile by tile: this rank's row of a picked slot is its
  // count of picked kept slots before it, or past them its count of
  // picked non-kept ones
  int carry_k = 0, carry_lk = 0, carry_ln = 0;
  for (int base = 0; base < total; base += tile_len) {
    const int p0 = base + t * items;
    const unsigned bits = thread_bits(kept_all, p0, items, total, n_files,
                                      k);
    int count[1] = {__popc(bits)}, before[1], tile[1];
    block_scan<1>(count, before, tile, sums);
    if (one_tile) n_kept = tile[0];
    if (local_kept < 0) local_kept = n_kept < budget ? n_kept : budget;
    unsigned lk_bits = 0, ln_bits = 0;
    int kb = carry_k + before[0];
    Walk w(p0, n_files);
    for (int j = 0; j < items && p0 + j < total; ++j, w.next()) {
      const bool is_kept = bits >> j & 1u;
      if (picked(p0 + j, kb, is_kept) && local(w.f))
        (is_kept ? lk_bits : ln_bits) |= 1u << j;
      kb += is_kept;
    }
    int mine[2] = {__popc(lk_bits), __popc(ln_bits)}, mine_before[2],
        mine_tile[2];
    block_scan<2>(mine, mine_before, mine_tile, sums);
    int row_k = carry_lk + mine_before[0];
    int row_n = local_kept + carry_ln + mine_before[1];
    w = Walk(p0, n_files);
    for (int j = 0; j < items && p0 + j < total; ++j, w.next()) {
      if (!local(w.f)) continue;
      const int f = w.f - first;
      const int at = f * k + w.s;
      const bool is_lk = lk_bits >> j & 1u, is_ln = ln_bits >> j & 1u;
      const int row = is_lk ? row_k++ : is_ln ? row_n++ : -1;
      pos[at] = row;
      kept[at] = is_lk;
      if (row >= 0) sel[row] = at;
      if ((bits >> j & 1u) && !is_lk) dropped[f] = 1;
    }
    carry_k += tile[0];
    carry_lk += mine_tile[0];
    carry_ln += mine_tile[1];
  }
  __syncthreads();  // every dropped bit is written
  for (int f = t; f < n_local; f += kSelectThreads) {
    overflow[f] = overflow_in[f] | dropped[f];
    fixable[f] = fixable_in[f] | dropped[f];
  }
  if (t == 0) n_sel[0] = local_kept + carry_ln;
}

// Blocks [0, end0) write the blend, [end0, end1) the MLP's, [end1, end2)
// the CNN's probs and [end2, gridDim) the pitch; a part given as null has
// no blocks.
__global__ void __launch_bounds__(kScatterThreads) wave_scatter_kernel(
    const int* __restrict__ pos, const float* __restrict__ probs_c,
    const float* __restrict__ mlp_c, const float* __restrict__ cnn_c,
    const float* __restrict__ pitch_c, float* __restrict__ probs,
    float* __restrict__ mlp, float* __restrict__ cnn,
    float* __restrict__ pitch, int n, int c, int end0, int end1, int end2) {
  const int b = blockIdx.x;
  const float* __restrict__ src = b < end0 ? probs_c
                                  : b < end1 ? mlp_c
                                  : b < end2 ? cnn_c : pitch_c;
  float* __restrict__ dst = b < end0 ? probs
                            : b < end1 ? mlp : b < end2 ? cnn : pitch;
  const int first = b < end0 ? 0 : b < end1 ? end0 : b < end2 ? end1 : end2;
  const int width = b < end2 ? c : 1;
  const int n_el = n * width;
  const int e0 = (b - first) * kScatterBlock + threadIdx.x;
#pragma unroll
  for (int q = 0; q < kScatterItems; ++q) {
    const int e = e0 + q * kScatterThreads;
    if (e < n_el) {
      const int i = e / width;
      const int row = pos[i];
      dst[e] = row >= 0 ? src[row * width + (e - i * width)] : 0.0f;
    }
  }
}

// The compaction's selection of one wave (see the top of this file). sel
// holds at least min(budget, n_local·K) ints, pos and kept n_local·K,
// dropped, overflow and fixable (and their inputs) n_local bytes; n_sel
// one int.
extern "C" int gat_wave_select(const unsigned char* kept_all,
                               const unsigned char* overflow_in,
                               const unsigned char* fixable_in, int* sel,
                               int* pos, unsigned char* kept,
                               unsigned char* dropped,
                               unsigned char* overflow,
                               unsigned char* fixable, int* n_sel,
                               int n_files, int k, int budget, int first,
                               int n_local, void* stream) {
  if (n_files < 1 || k < 1 || budget < 1 || first < 0 || n_local < 1 ||
      first + n_local > n_files ||
      (long long)n_files * k > 0x7fffffff - kTile)
    return (int)cudaErrorInvalidValue;
  const int total = n_files * k;
  const int per_thread = (total + kSelectThreads - 1) / kSelectThreads;
  const int items = per_thread < kItems ? per_thread : kItems;
  wave_select_kernel<<<1, kSelectThreads, 0, (cudaStream_t)stream>>>(
      kept_all, overflow_in, fixable_in, sel, pos, kept, dropped, overflow,
      fixable, n_sel, n_files, k, budget, first, n_local, items);
  return (int)cudaGetLastError();
}

// The scatter of the budget's compact outputs back to the wave's n slots:
// probs, mlp and cnn (rows, c) -> (n, c), pitch (rows,) -> (n,); any part
// may be null (its output too), not all. pos (n,) holds rows in [0, rows)
// or -1.
extern "C" int gat_wave_scatter(const int* pos, const float* probs_c,
                                const float* mlp_c, const float* cnn_c,
                                const float* pitch_c, float* probs,
                                float* mlp, float* cnn, float* pitch, int n,
                                int c, void* stream) {
  if (n < 1 || c < 1 || (long long)n * c > 0x7fffffff - kScatterBlock)
    return (int)cudaErrorInvalidValue;
  const int mat = (n * c + kScatterBlock - 1) / kScatterBlock;
  const int end0 = probs_c == nullptr ? 0 : mat;
  const int end1 = end0 + (mlp_c == nullptr ? 0 : mat);
  const int end2 = end1 + (cnn_c == nullptr ? 0 : mat);
  const int blocks =
      end2 + (pitch_c == nullptr ? 0 : (n + kScatterBlock - 1) /
                                           kScatterBlock);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  wave_scatter_kernel<<<blocks, kScatterThreads, 0, (cudaStream_t)stream>>>(
      pos, probs_c, mlp_c, cnn_c, pitch_c, probs, mlp, cnn, pitch, n, c, end0,
      end1, end2);
  return (int)cudaGetLastError();
}
