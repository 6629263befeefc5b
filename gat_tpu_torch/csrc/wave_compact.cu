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
// The design takes the least of those.
//
// The select is one block of 512 threads over tiles of the wave. A tile
// is slots [s0, s0 + w) of files [f0, f0 + fc) whose slot-major positions
// are one contiguous range: every file and as many slots as fill kTile
// positions (fc = n_files), or, past kTile files, one slot of kTile files
// (w = 1). A wave of at most kTile slots is one tile: its kept bytes are
// read once, in memory order, by 16-byte loads into shared memory (448
// bytes at the serving wave, 7,168 at 64 files); a longer one is counted
// first in memory order the same way, then staged tile by tile, each row
// segment by coalesced byte loads. In a tile:
// - each warp takes a contiguous run of 32-position words in slot-major
//   order; a lane finds its first position's file and slot by one
//   division, then steps; `__ballot_sync` of the kept bits read from
//   shared memory gives the words, `__popc` their counts;
// - one block-wide exclusive scan of the warps' counts (warp 0's shuffle
//   scan) gives every position its kb as the warp's prefix, its words
//   before and `__popc` of its word under the lane mask; under a mesh a
//   second scan counts the rank's picked kept and picked non-kept words;
// - each position's row and kept byte go into shared memory in the
//   tile's file-major order, sel is written in rank order (consecutive
//   ranks from consecutive lanes), and a bit a file marks a lost kept
//   slot (shared-memory atomicOr);
// - pos and kept leave shared memory in file-major order, coalesced, and
//   dropped / overflow / fixable are built from the file bits.
// Under a mesh a wave of more than one tile takes a pass more that counts
// this rank's picked kept slots before any row is written.
//
// The scatter works by output row: a warp a row, its pos read once (the
// next row's read while this one is copied) and the row's C floats of
// each part copied (or zeroed) by the warp's lanes, no division an
// element, the pitch by lane 0; the four parts in one launch, a null part
// skipped; the grid is the rows' warps, at most what the SMs hold at once
// (8 blocks of 256 threads a SM by the launch bounds, as the CUDA
// runtime reports them), the warps striding over the rows. No library
// sort, scan or scatter is called.
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

constexpr int kSelectThreads = 512;  // one block
constexpr int kSelectWarps = kSelectThreads / 32;
constexpr int kTile = 8192;           // slot-major positions a tile
constexpr int kTileWords = kTile / 32;
constexpr int kScatterThreads = 256;
constexpr int kScatterWarps = kScatterThreads / 32;
constexpr int kScatterBlocksPerSm = 8;  // a warp a row: 8,448 rows at once
constexpr unsigned kFull = 0xffffffffu;

// A tile of the wave (see the top of this file): slots [s0, s0 + w) of
// files [f0, f0 + fc), its n = w·fc positions the slot-major range from p0.
struct Tile {
  int s0, w, f0, fc, n, p0;
};

__host__ __device__ inline int tile_width(int n_files, int k) {
  return kTile / n_files < k ? kTile / n_files : k;
}

__host__ __device__ inline int tile_count(int n_files, int k) {
  if (n_files <= kTile) {
    const int w = tile_width(n_files, k);
    return (k + w - 1) / w;
  }
  return k * ((n_files + kTile - 1) / kTile);
}

__device__ inline Tile tile_at(int i, int n_files, int k) {
  Tile t;
  if (n_files <= kTile) {
    const int w = tile_width(n_files, k);
    t.s0 = i * w;
    t.w = k - t.s0 < w ? k - t.s0 : w;
    t.f0 = 0;
    t.fc = n_files;
  } else {
    const int chunks = (n_files + kTile - 1) / kTile;
    t.s0 = i / chunks;
    t.w = 1;
    t.f0 = (i - t.s0 * chunks) * kTile;
    t.fc = n_files - t.f0 < kTile ? n_files - t.f0 : kTile;
  }
  t.n = t.w * t.fc;
  t.p0 = t.s0 * n_files + t.f0;
  return t;
}

// Index i = major·width + minor, found by one division and stepped by d.
struct Step {
  int major, minor, width, d_major, d_minor;
  __device__ Step(int i, int width_, int d) : width(width_) {
    major = i / width;
    minor = i - major * width;
    d_major = d / width;
    d_minor = d - d_major * width;
  }
  __device__ void next() {
    minor += d_minor;
    major += d_major;
    if (minor >= width) {
      minor -= width;
      ++major;
    }
  }
};

// The tile's kept bytes into shared memory in its file-major order (file
// f0 + e / w, slot s0 + e % w at e): whole rows are one range in memory
// order, read by 16-byte loads where it starts on 16 bytes; row segments
// by coalesced byte loads.
__device__ __forceinline__ void stage(const unsigned char* __restrict__ kept_all,
                                      const Tile& tl, int k,
                                      unsigned char* bits) {
  const int t = threadIdx.x;
  if (tl.w == k) {
    const unsigned char* src = kept_all + (long long)tl.f0 * k;
    int i0 = 0;
    if (((uintptr_t)src & 15u) == 0) {
      for (int i = t; i < tl.n >> 4; i += kSelectThreads)
        reinterpret_cast<uint4*>(bits)[i] =
            __ldg(reinterpret_cast<const uint4*>(src) + i);
      i0 = tl.n & ~15;
    }
    for (int i = i0 + t; i < tl.n; i += kSelectThreads) bits[i] = src[i];
  } else {
    Step e(t, tl.w, kSelectThreads);
    for (int i = t; i < tl.n; i += kSelectThreads, e.next())
      bits[i] = kept_all[(long long)(tl.f0 + e.major) * k + tl.s0 + e.minor];
  }
}

// The block's exclusive scan of N counts a warp (lane 0's v, warps in
// order): this warp's prefixes in `before`, the totals in `total`. Every
// thread calls it; each scan of a tile has its own rows of s_scan.
template <int N>
__device__ __forceinline__ void warp_scan(const int (&v)[N],
                                          int (*s_scan)[kSelectWarps],
                                          int* s_total, int (&before)[N],
                                          int (&total)[N]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0)
    for (int j = 0; j < N; ++j) s_scan[j][warp] = v[j];
  __syncthreads();
  if (warp == 0)
    for (int j = 0; j < N; ++j) {
      const int x = lane < kSelectWarps ? s_scan[j][lane] : 0;
      int inc = x;
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(kFull, inc, d);
        if (lane >= d) inc += u;
      }
      if (lane < kSelectWarps) s_scan[j][lane] = inc - x;
      if (lane == 31) s_total[j] = inc;
    }
  __syncthreads();
  for (int j = 0; j < N; ++j) {
    before[j] = s_scan[j][warp];
    total[j] = s_total[j];
  }
}

__global__ void __launch_bounds__(kSelectThreads) wave_select_kernel(
    const unsigned char* __restrict__ kept_all,
    const unsigned char* __restrict__ overflow_in,
    const unsigned char* __restrict__ fixable_in, int* __restrict__ sel,
    int* __restrict__ pos, unsigned char* __restrict__ kept,
    unsigned char* __restrict__ dropped, unsigned char* __restrict__ overflow,
    unsigned char* __restrict__ fixable, int* __restrict__ n_sel,
    int n_files, int k, int budget, int first, int n_local) {
  __shared__ uint4 s_bits4[kTile / 16];  // kept bits, then kept & picked
  __shared__ int s_row[kTile];           // rows, -1: not picked
  __shared__ unsigned s_word[kTileWords], s_lk[kTileWords], s_ln[kTileWords];
  __shared__ unsigned s_drop[kTileWords];  // a bit a file of the tile
  __shared__ int s_scan[3][kSelectWarps];
  __shared__ int s_total[3];
  unsigned char* bits = reinterpret_cast<unsigned char*>(s_bits4);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int total = n_files * k, tiles = tile_count(n_files, k);
  const bool whole = first == 0 && n_local == n_files;
  const bool chunked = n_files > kTile;  // a tile holds part of the files
  const auto local = [&](int f) { return f >= first && f < first + n_local; };
  for (int i = t; i < kTileWords; i += kSelectThreads) s_drop[i] = 0;
  if (chunked)
    for (int f = t; f < n_local; f += kSelectThreads) dropped[f] = 0;

  // the wave's kept count: one tile's scan counts it; past one tile it is
  // read first, in memory order (bytes 0 or 1)
  int n_kept = 0;
  if (tiles > 1) {
    int cnt = 0, i0 = 0;
    if (((uintptr_t)kept_all & 15u) == 0) {
      const uint4* v = reinterpret_cast<const uint4*>(kept_all);
      for (int i = t; i < total >> 4; i += kSelectThreads) {
        const uint4 q = __ldg(v + i);
        cnt += __popc(q.x & 0x01010101u) + __popc(q.y & 0x01010101u) +
               __popc(q.z & 0x01010101u) + __popc(q.w & 0x01010101u);
      }
      i0 = total & ~15;
    }
    for (int i = i0 + t; i < total; i += kSelectThreads)
      cnt += kept_all[i] != 0;
    for (int d = 16; d > 0; d >>= 1) cnt += __shfl_xor_sync(kFull, cnt, d);
    int v[1] = {cnt}, before[1], tot[1];
    warp_scan<1>(v, s_scan, s_total, before, tot);
    n_kept = tot[0];
  }

  // this rank's picked kept slots (under a mesh), ahead of its non-kept
  // rows; past one tile a first pass counts them
  int local_kept = 0, carry_ln = 0;
  for (int pass = !whole && tiles > 1 ? 0 : 1; pass < 2; ++pass) {
    int carry = 0, carry_lk = 0;  // the counts before the tile
    carry_ln = 0;
    for (int ti = 0; ti < tiles; ++ti) {
      const Tile tl = tile_at(ti, n_files, k);
      stage(kept_all, tl, k, bits);
      __syncthreads();
      // words of 32 slot-major positions, a contiguous run a warp; a
      // lane's position is (slot major, file minor) of the tile
      const int words = (tl.n + 31) >> 5;
      const int per = (words + kSelectWarps - 1) / kSelectWarps;
      const int w0 = warp * per, w1 = w0 + per < words ? w0 + per : words;
      int cnt = 0;
      {
        Step q(w0 * 32 + lane, tl.fc, 32);
        for (int wd = w0; wd < w1; ++wd, q.next()) {
          const unsigned word = __ballot_sync(
              kFull, wd * 32 + lane < tl.n &&
                         bits[q.minor * tl.w + q.major] != 0);
          if (lane == 0) s_word[wd] = word;
          cnt += __popc(word);
        }
      }
      int v1[1] = {cnt}, kb_before[1], kb_tile[1];
      warp_scan<1>(v1, s_scan, s_total, kb_before, kb_tile);
      if (tiles == 1) n_kept = kb_tile[0];
      // under a mesh: this rank's picked kept and picked non-kept words
      int lk_before = 0, ln_before = 0, lk_tile = 0, ln_tile = 0;
      if (!whole) {
        Step q(w0 * 32 + lane, tl.fc, 32);
        int kb = carry + kb_before[0], ck = 0, cn = 0;
        for (int wd = w0; wd < w1; ++wd, q.next()) {
          const unsigned word = s_word[wd];
          const int at = wd * 32 + lane, kbl = kb + __popc(word & lt);
          const bool b = word >> lane & 1u;
          const bool mine = at < tl.n && local(tl.f0 + q.minor) &&
                            (b ? kbl : n_kept + (tl.p0 + at - kbl)) < budget;
          const unsigned lk = __ballot_sync(kFull, mine && b);
          const unsigned ln = __ballot_sync(kFull, mine && !b);
          if (lane == 0) {
            s_lk[wd] = lk;
            s_ln[wd] = ln;
          }
          ck += __popc(lk);
          cn += __popc(ln);
          kb += __popc(word);
        }
        int v2[2] = {ck, cn}, b2[2], t2[2];
        warp_scan<2>(v2, s_scan + 1, s_total + 1, b2, t2);
        lk_before = b2[0];
        ln_before = b2[1];
        lk_tile = t2[0];
        ln_tile = t2[1];
        if (tiles == 1) local_kept = lk_tile;
      }
      if (pass == 0) {
        local_kept += lk_tile;
        carry += kb_tile[0];
        continue;
      }
      // every position's row and kept byte into the tile's file-major
      // order; sel in rank order
      {
        Step q(w0 * 32 + lane, tl.fc, 32);
        int kb = carry + kb_before[0];
        int rk = carry_lk + lk_before, rn = local_kept + carry_ln + ln_before;
        for (int wd = w0; wd < w1; ++wd, q.next()) {
          const unsigned word = s_word[wd];
          const int at = wd * 32 + lane, kbl = kb + __popc(word & lt);
          const bool b = word >> lane & 1u;
          int row;
          if (whole) {
            const int r = b ? kbl : n_kept + (tl.p0 + at - kbl);
            row = r < budget ? r : -1;
          } else {
            const unsigned lk = s_lk[wd], ln = s_ln[wd];
            row = lk >> lane & 1u   ? rk + __popc(lk & lt)
                  : ln >> lane & 1u ? rn + __popc(ln & lt)
                                    : -1;
            rk += __popc(lk);
            rn += __popc(ln);
          }
          kb += __popc(word);
          if (at >= tl.n) continue;
          const int e = q.minor * tl.w + q.major;
          s_row[e] = row;
          bits[e] = b && row >= 0;
          if (b && row < 0) atomicOr(&s_drop[q.minor >> 5], 1u << (q.minor & 31));
          if (row >= 0) sel[row] = (tl.f0 + q.minor - first) * k + tl.s0 + q.major;
        }
      }
      __syncthreads();
      // pos and kept of this rank's files, file-major, coalesced
      if (tl.w == k) {  // whole rows: this rank's files are one range
        const int lo = first > tl.f0 ? (first - tl.f0) * k : 0;
        const int end = (first + n_local - tl.f0) * k;
        const int hi = end < tl.n ? end : tl.n;
        const long long out = (long long)(tl.f0 - first) * k;
        for (int e = lo + t; e < hi; e += kSelectThreads) {
          pos[out + e] = s_row[e];
          kept[out + e] = bits[e];
        }
      } else {
        Step r(t, tl.w, kSelectThreads);
        for (int e = t; e < tl.n; e += kSelectThreads, r.next()) {
          const int f = tl.f0 + r.major;
          if (!local(f)) continue;
          const long long out = (long long)(f - first) * k + tl.s0 + r.minor;
          pos[out] = s_row[e];
          kept[out] = bits[e];
        }
      }
      if (chunked) {  // the tile's file bits, to this rank's dropped
        for (int fl = t; fl < tl.fc; fl += kSelectThreads)
          if (local(tl.f0 + fl) && (s_drop[fl >> 5] >> (fl & 31) & 1u))
            dropped[tl.f0 + fl - first] = 1;
        __syncthreads();
        for (int i = t; i < kTileWords; i += kSelectThreads) s_drop[i] = 0;
      }
      carry += kb_tile[0];
      carry_lk += lk_tile;
      carry_ln += ln_tile;
      __syncthreads();  // the tile's shared memory is free
    }
  }
  __syncthreads();  // every file bit (or dropped byte) is set
  for (int f = t; f < n_local; f += kSelectThreads) {
    const int fl = f + first;
    const unsigned char d =
        chunked ? dropped[f] : (unsigned char)(s_drop[fl >> 5] >> (fl & 31) & 1u);
    if (!chunked) dropped[f] = d;
    overflow[f] = overflow_in[f] | d;
    fixable[f] = fixable_in[f] | d;
  }
  if (t == 0) n_sel[0] = whole ? (budget < total ? budget : total)
                               : local_kept + carry_ln;
}

// A warp an output row: its pos read once, the row's c floats of each
// part copied from the compact row or zeroed, the pitch by lane 0; a null
// part is skipped. The warps stride over the n rows.
__global__ void __launch_bounds__(kScatterThreads, kScatterBlocksPerSm)
    wave_scatter_kernel(const int* __restrict__ pos,
                        const float* __restrict__ probs_c,
                        const float* __restrict__ mlp_c,
                        const float* __restrict__ cnn_c,
                        const float* __restrict__ pitch_c,
                        float* __restrict__ probs, float* __restrict__ mlp,
                        float* __restrict__ cnn, float* __restrict__ pitch,
                        int n, int c) {
  const int lane = threadIdx.x & 31;
  const int warps = (int)gridDim.x * kScatterWarps;
  int i = blockIdx.x * kScatterWarps + (threadIdx.x >> 5);
  int row = i < n ? __ldg(pos + i) : -1;
  for (; i < n; i += warps) {
    // the warp's next row's pos is in flight while this row is copied
    const int next = i + warps < n ? __ldg(pos + i + warps) : -1;
    const bool hit = row >= 0;
    const long long src = (long long)(hit ? row : 0) * c,
                    dst = (long long)i * c;
    for (int j = lane; j < c; j += 32) {
      if (probs_c != nullptr)
        probs[dst + j] = hit ? __ldg(probs_c + src + j) : 0.0f;
      if (mlp_c != nullptr) mlp[dst + j] = hit ? __ldg(mlp_c + src + j) : 0.0f;
      if (cnn_c != nullptr) cnn[dst + j] = hit ? __ldg(cnn_c + src + j) : 0.0f;
    }
    if (pitch_c != nullptr && lane == 0)
      pitch[i] = hit ? __ldg(pitch_c + row) : 0.0f;
    row = next;
  }
}

static std::mutex occupancy_lock;

// The scatter's resident blocks per SM (remembered per device) and the
// SMs of the current device.
static int scatter_occupancy(int* per_sm, int* sms) {
  struct Entry {
    int device, per_sm;
  };
  static Entry seen[16];
  static int n_seen = 0;
  int device = 0;
  int err = (int)cudaGetDevice(&device);
  if (!err)
    err = (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                      device);
  if (err) return err;
  std::lock_guard<std::mutex> guard(occupancy_lock);
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].device == device) {
      *per_sm = seen[i].per_sm;
      return 0;
    }
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, wave_scatter_kernel, kScatterThreads, 0);
  if (err) return err;
  if (*per_sm < 1) *per_sm = 1;
  if (n_seen < 16) seen[n_seen++] = {device, *per_sm};
  return 0;
}

// The scatter's blocks over n rows: a warp a row, at most what the SMs
// hold at once.
static int scatter_blocks(int n, int per_sm, int sms) {
  const long long need = ((long long)n + kScatterWarps - 1) / kScatterWarps;
  const long long most = (long long)per_sm * sms;
  return (int)(need < most ? need : most);
}

// K10's launches over a wave of n_files x K slots on the current device:
// out[0] the selection's tiles, out[1] its threads (one block), out[2] the
// scatter's blocks over the n_files·K rows and out[3] its resident blocks
// per SM.
extern "C" int gat_wave_compact_grid(int n_files, int k, int* out) {
  if (n_files < 1 || k < 1 || (long long)n_files * k > 0x7fffffff - kTile)
    return (int)cudaErrorInvalidValue;
  int per_sm = 0, sms = 0;
  const int err = scatter_occupancy(&per_sm, &sms);
  if (err) return err;
  out[0] = tile_count(n_files, k);
  out[1] = kSelectThreads;
  out[2] = scatter_blocks(n_files * k, per_sm, sms);
  out[3] = per_sm;
  return 0;
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
  wave_select_kernel<<<1, kSelectThreads, 0, (cudaStream_t)stream>>>(
      kept_all, overflow_in, fixable_in, sel, pos, kept, dropped, overflow,
      fixable, n_sel, n_files, k, budget, first, n_local);
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
  if (n < 1 || c < 1 || (long long)n * c > 0x7fffffff ||
      (probs_c == nullptr && mlp_c == nullptr && cnn_c == nullptr &&
       pitch_c == nullptr))
    return (int)cudaErrorInvalidValue;
  int per_sm = 0, sms = 0;
  const int err = scatter_occupancy(&per_sm, &sms);
  if (err) return err;
  const int blocks = scatter_blocks(n, per_sm, sms);
  wave_scatter_kernel<<<blocks, kScatterThreads, 0, (cudaStream_t)stream>>>(
      pos, probs_c, mlp_c, cnn_c, pitch_c, probs, mlp, cnn, pitch, n, c);
  return (int)cudaGetLastError();
}
