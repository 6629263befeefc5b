// K5: the onset pick of whole files, env (B, T) -> onset samples
// (B, max_onsets), valid, overflow, cap_overflow, n_kept.
//
// Replaces the JAX package's XLA program gat_tpu/ops/onset.py:178
// pick_onsets_from_envelope, which runs its greedy walk as a lax.scan.
// Per file, over its valid frames t < nvf:
//   1. min-max normalization;
//   2. librosa.util.peak_pick's candidates: the frame equals the moving
//      max (window [t - left, t - left + size), padded with the valid
//      minimum), is at least the moving average (librosa's truncated
//      window [t - pre_avg, t + post_avg) cut at nvf, from one prefix sum
//      of the mean-centred envelope, which keeps the sum near zero however
//      long the file) plus delta, and is nonzero;
//   3. energy-minimum backtracking: for each frame the latest frame at or
//      before it with e[i] <= e[i-1] and e[i] < e[i+1] (frame 0 always,
//      the last valid frame never), a max-scan;
//   4. the earliest `cand_limit` candidates, in frame order;
//   5. the greedy walk: a candidate more than `wait` frames after the last
//      accepted peak is a peak; its backtracked sample is kept when it is
//      at least `min_samples` after the last kept one;
//   6. whether a truncated candidate list could have changed the result:
//      the latest raw candidate dominates every dropped one (largest frame,
//      and largest backtracked sample, bt being a cummax).
// The kept samples come out of the walk in nondecreasing order (bt is a
// cummax and min_samples >= 0), so they are written as they come, with no
// sort.
//
// What bounds it: a file's envelope is a few KB to a few hundred KB and
// the walk a few hundred dependent steps, so neither the card's memory
// rate nor its operation rate does; the time is latency: the dependent
// steps of the scans and the walk, and the launch. So the design counts
// barriers, not bytes. One block of 256 threads per file, files in
// parallel. The valid min, max and mean are read from device memory (the
// file sits in L2) and reduced with warp shuffles and one exchange of the
// 8 warp results each. Then the block walks the file in tiles of kTile
// frames, 4 contiguous frames per thread; each tile costs four barriers,
// whatever its length:
//   load  the tile's frames, normalized, and their mean-centred prefix sum
//         (in fp64, a thread's 4 frames, then __shfl_up_sync over the
//         warp, then one exchange of the warp totals, plus the carry of
//         all earlier tiles) into shared memory;
//   eval  the frames kHalo behind the load front, so that each has the
//         halo its windows read on both sides already in shared memory:
//         the moving max (left, size - 1 - left frames), the moving average
//         (pre_avg + 1 and post_avg - 1 prefix sums) and the minimum test
//         (one frame). The backtrack cummax scans like the prefix sum
//         (carry: the last minimum seen), and each warp ranks its
//         candidates with __ballot_sync + __popc, so they are compacted
//         into a list in frame order;
//   walk  thread 0 walks the tile's list with the walk's state (last peak,
//         last sample, kept, candidates seen) in registers across tiles.
// The buffer keeps the last 2·kHalo frames of a tile for the next one, so
// shared memory is fixed (17 KB, no attribute to set) whatever the file's
// length. Each prefix sum is computed once and carried in fp64, so a
// frame's moving average reads the same two sums whichever tile holds it,
// and the rounding does not grow with the file. The tail (valid mask, zero
// fill past the kept onsets) is written by all threads.
#include <cmath>

#include "dsp_common.cuh"

using namespace gat;

constexpr float kTiny = 1.1754944e-38f;  // np.finfo(np.float32).tiny
constexpr int kTile = 1024;   // frames a tile loads (_PICK_TILE in onset.py)
constexpr int kHalo = 64;     // frames of halo each side (_PICK_HALO)
constexpr int kPer = kTile / kThreads;  // contiguous frames per thread
constexpr int kWarps = kThreads / 32;
constexpr int kBuf = kTile + 2 * kHalo;  // frames [t0 - 2·kHalo, t0 + kTile)
constexpr unsigned kFull = 0xffffffffu;

struct PickShared {
  float en[kBuf];          // normalized envelope
  float cs[kBuf];          // csum[f + 1]: the prefix sum through frame f
  int2 cand[kTile];        // the tile's candidates in frame order:
                           // (frame, backtracked frame)
  double wsum[kWarps];     // warp totals of the prefix sum
  int wmax[kWarps];        // warp maxima of the backtrack scan
  int wcount[kWarps];      // warp candidate counts
  float red[3][kWarps];    // the whole-file reductions
  double red_sum[kWarps];
  int kept;
};

template <class T, class Op>
__device__ __forceinline__ T warp_reduce(T v, Op op) {
  for (int s = 16; s > 0; s >>= 1) v = op(v, __shfl_xor_sync(kFull, v, s));
  return v;
}

// Inclusive scan over the lanes of a warp (Hillis-Steele, 5 steps).
template <class T, class Op>
__device__ __forceinline__ T warp_scan(T v, Op op) {
  const int lane = threadIdx.x & 31;
  for (int s = 1; s < 32; s <<= 1) {
    const T u = __shfl_up_sync(kFull, v, s);
    if (lane >= s) v = op(u, v);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
onset_pick_kernel(const float* __restrict__ env, const int* __restrict__ nvf,
                  int* __restrict__ onsets, unsigned char* __restrict__ valid,
                  unsigned char* __restrict__ overflow,
                  unsigned char* __restrict__ cap_overflow,
                  int* __restrict__ n_kept, int n_frames, int size, int left,
                  int pre_avg, int post_avg, float delta, int wait, int hop,
                  int min_samples, int max_onsets, int cand_limit,
                  int backtrack) {
  __shared__ PickShared sh;
  const int t = n_frames, file = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int nv = nvf ? nvf[file] : t;
  nv = nv < 0 ? 0 : (nv > t ? t : nv);
  const float* e = env + (size_t)file * t;
  auto fmin_op = [](float a, float b) { return fminf(a, b); };
  auto fmax_op = [](float a, float b) { return fmaxf(a, b); };
  auto dadd_op = [](double a, double b) { return a + b; };
  auto imax_op = [](int a, int b) { return a > b ? a : b; };

  // 1. normalization over the valid frames, then their minimum and mean
  float lo = INFINITY, hi = -INFINITY;
  for (int i = threadIdx.x; i < nv; i += kThreads) {
    lo = fminf(lo, e[i]);
    hi = fmaxf(hi, e[i]);
  }
  lo = warp_reduce(lo, fmin_op);
  hi = warp_reduce(hi, fmax_op);
  if (lane == 0) {
    sh.red[0][warp] = lo;
    sh.red[1][warp] = hi;
  }
  __syncthreads();
  float emin = sh.red[0][0], emax = sh.red[1][0];
  for (int w = 1; w < kWarps; ++w) {
    emin = fminf(emin, sh.red[0][w]);
    emax = fmaxf(emax, sh.red[1][w]);
  }
  const float denom = emax - emin + kTiny;
  float xlo = INFINITY;
  double sum = 0.0;
  for (int i = threadIdx.x; i < nv; i += kThreads) {
    const float x = (e[i] - emin) / denom;
    xlo = fminf(xlo, x);
    sum += x;
  }
  xlo = warp_reduce(xlo, fmin_op);
  sum = warp_reduce(sum, dadd_op);
  if (lane == 0) {
    sh.red[2][warp] = xlo;
    sh.red_sum[warp] = sum;
  }
  __syncthreads();
  float x_min = sh.red[2][0];
  double total = sh.red_sum[0];
  for (int w = 1; w < kWarps; ++w) {
    x_min = fminf(x_min, sh.red[2][w]);
    total += sh.red_sum[w];
  }
  const float x_mean = (float)total / (float)(nv > 1 ? nv : 1);

  // 2-5. the tiles: load frames [t0, t0 + kTile), evaluate the kTile
  // frames kHalo behind them, walk their candidates
  double carry = 0.0;     // prefix sum of all frames loaded before
  int bt_carry = -1;      // the last backtrack minimum evaluated before
  int last_frame = -1000000000, last_sample = -999999, kept = 0;
  int n_raw = 0, i_max = -1, bt_max = 0;  // walk state, thread 0's
  int* out = onsets + (size_t)file * max_onsets;
  const int n_tiles = (t + kHalo + kTile - 1) / kTile;
  const unsigned lanes_below = (1u << lane) - 1u;
  // a thread's envelope values of the next tile, loaded a tile ahead so
  // that the loads are in flight during the walk
  float raw[kPer];
  auto load = [&](int t0) {
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int f = t0 + kPer * threadIdx.x + r;
      raw[r] = f < t ? e[f] : 0.0f;
    }
  };
  load(0);
  for (int k = 0; k < n_tiles; ++k) {
    const int t0 = k * kTile, base = t0 - 2 * kHalo;
    const int f0 = t0 + kPer * threadIdx.x;
    float x[kPer];
    double c[kPer], acc = 0.0;
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int f = f0 + r;
      x[r] = f < t ? (raw[r] - emin) / denom : 0.0f;
      acc += (double)(f < nv ? x[r] - x_mean : 0.0f);
      c[r] = acc;
    }
    // the previous tile's last 2·kHalo frames, which go to the buffer's
    // front: read before the barrier, as this tile's stores overwrite them
    float keep_en = 0.0f, keep_cs = 0.0f;
    if (k > 0 && threadIdx.x < 2 * kHalo) {
      keep_en = sh.en[kTile + threadIdx.x];
      keep_cs = sh.cs[kTile + threadIdx.x];
    }
    const double incl = warp_scan(acc, dadd_op);
    double excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = 0.0;
    if (lane == 31) sh.wsum[warp] = incl;
    __syncthreads();
    double off = carry, tile_sum = 0.0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) off += sh.wsum[w];
      tile_sum += sh.wsum[w];
    }
    off += excl;
    carry += tile_sum;
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      sh.en[2 * kHalo + kPer * threadIdx.x + r] = x[r];
      sh.cs[2 * kHalo + kPer * threadIdx.x + r] = (float)(off + c[r]);
    }
    if (threadIdx.x < 2 * kHalo) {
      sh.en[threadIdx.x] = keep_en;
      sh.cs[threadIdx.x] = keep_cs;
    }
    __syncthreads();

    // candidates and backtrack minima of frames [t0 - kHalo, t0 + kTile -
    // kHalo), each at buffer position i - base
    const int i0 = t0 - kHalo + kPer * threadIdx.x;
    int run = -1, bt_run[kPer];
    unsigned bits = 0;
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int i = i0 + r, p = i - base;
      int b = -1;
      if (i >= 0 && i < t) {
        const float xi = sh.en[p];
        if (i < nv) {
          float mov_max = -INFINITY;
          for (int q = 0; q < size; ++q) {
            const int j = i - left + q;
            mov_max = fmaxf(mov_max,
                            (j >= 0 && j < nv) ? sh.en[p - left + q] : x_min);
          }
          int a = i - pre_avg, bb = i + post_avg;
          a = a < 0 ? 0 : a;            // a <= i < nv
          bb = bb > nv ? nv : bb;       // bb >= i >= 0
          const float csa = a > 0 ? sh.cs[a - 1 - base] : 0.0f;
          const float csb = bb > 0 ? sh.cs[bb - 1 - base] : 0.0f;
          const float mov_avg =
              x_mean + (csb - csa) / (float)(bb - a > 1 ? bb - a : 1);
          const float det = xi == mov_max ? xi : 0.0f;
          if (det != 0.0f && det >= mov_avg + delta) bits |= 1u << r;
        }
        bool minimum = i == 0;
        if (i > 0 && i < t - 1)
          minimum = xi <= sh.en[p - 1] && xi < sh.en[p + 1] && i + 1 < nv;
        b = backtrack ? (minimum ? i : -1) : i;
      }
      run = run > b ? run : b;
      bt_run[r] = run;
    }
    const int wrun = warp_scan(run, imax_op);
    int wexcl = __shfl_up_sync(kFull, wrun, 1);
    if (lane == 0) wexcl = -1;
    int rank = 0, count = 0;
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const unsigned m = __ballot_sync(kFull, (bits >> r) & 1u);
      rank += __popc(m & lanes_below);
      count += __popc(m);
    }
    if (lane == 31) sh.wmax[warp] = wrun;
    if (lane == 0) sh.wcount[warp] = count;
    __syncthreads();
    int bt_off = bt_carry > wexcl ? bt_carry : wexcl, tile_count = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) {
        bt_off = bt_off > sh.wmax[w] ? bt_off : sh.wmax[w];
        rank += sh.wcount[w];
      }
      tile_count += sh.wcount[w];
      bt_carry = bt_carry > sh.wmax[w] ? bt_carry : sh.wmax[w];
    }
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      if ((bits >> r) & 1u) {
        sh.cand[rank++] =
            make_int2(i0 + r, bt_off > bt_run[r] ? bt_off : bt_run[r]);
      }
    }
    __syncthreads();
    if (k + 1 < n_tiles) load(t0 + kTile);

    // the greedy walk over the tile's candidates, by one thread; the
    // other warps go on to the next tile
    if (threadIdx.x == 0) {
      int n_walk = cand_limit - n_raw;
      n_walk = n_walk < 0 ? 0 : (n_walk > tile_count ? tile_count : n_walk);
#pragma unroll 4
      for (int q = 0; q < n_walk; ++q) {
        const int2 cand = sh.cand[q];
        if (cand.x > last_frame + wait) {
          last_frame = cand.x;
          const int s = cand.y * hop;
          if (s - last_sample >= min_samples) {
            if (kept < max_onsets) out[kept] = s;
            ++kept;
            last_sample = s;
          }
        }
      }
      if (tile_count > 0) {
        i_max = sh.cand[tile_count - 1].x;
        bt_max = sh.cand[tile_count - 1].y;
      }
      n_raw += tile_count;
    }
  }

  // 6. the flags, then the tail by all threads
  if (threadIdx.x == 0) {
    const int s_max = bt_max * hop;  // bt[0] = 0 when there is no candidate
    const bool could_differ =
        i_max > last_frame + wait && s_max - last_sample >= min_samples;
    const bool cap = kept > max_onsets;
    overflow[file] = (n_raw > cand_limit && could_differ) || cap;
    cap_overflow[file] = cap;
    n_kept[file] = kept;
    sh.kept = kept;
  }
  __syncthreads();
  const int n_out = sh.kept;
  unsigned char* v = valid + (size_t)file * max_onsets;
  for (int j = threadIdx.x; j < max_onsets; j += kThreads) {
    v[j] = j < n_out;
    if (j >= n_out) out[j] = 0;
  }
}

extern "C" int gat_onset_pick(const float* env, const int* nvf, int* onsets,
                              unsigned char* valid, unsigned char* overflow,
                              unsigned char* cap_overflow, int* n_kept,
                              int n_files, int n_frames, int size, int left,
                              int pre_avg, int post_avg, float delta,
                              int wait, int hop, int min_samples,
                              int max_onsets, int cand_limit, int backtrack,
                              void* stream) {
  // the windows must fit the halo (the wrapper raises before this)
  if (n_files < 1 || n_frames < 2 || size < 1 || left < 0 || left >= size ||
      left > kHalo || size - 1 - left > kHalo || pre_avg < 0 ||
      pre_avg + 1 > kHalo || post_avg < 0 || post_avg > kHalo + 1 ||
      max_onsets < 1 || cand_limit < 1)
    return (int)cudaErrorInvalidValue;
  onset_pick_kernel<<<n_files, kThreads, 0, (cudaStream_t)stream>>>(
      env, nvf, onsets, valid, overflow, cap_overflow, n_kept, n_frames,
      size, left, pre_avg, post_avg, delta, wait, hop, min_samples,
      max_onsets, cand_limit, backtrack);
  return (int)cudaGetLastError();
}

// Resident blocks per SM, as the CUDA runtime computes it from registers
// and the fixed shared memory (the same at any envelope length).
extern "C" int gat_onset_pick_blocks_per_sm(int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, onset_pick_kernel, kThreads, 0);
}
