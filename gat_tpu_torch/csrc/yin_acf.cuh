// YIN over one clip staged in shared memory, shared by K3 (yin_pitch.cu)
// and K6 (mfcc_pitch_frontend.cu). Per clip, with frames of frame_length
// at hop `hop` over a zero centre pad of frame_length/2:
//   1. acf(tau) = sum_{i=1..W} x[i] x[i+tau] and the sliding energy
//      e(tau) = sum_{i=1..W} x[i+tau]^2, tau = 0..max_p, both zeroed
//      below 1e-6;
//   2. d(tau) = e(0) + e(tau) - 2 acf(tau) and the cumulative-mean-
//      normalized difference over tau in [min_p, max_p];
//   3. the first trough below `threshold` (troughs: left-strict, right
//      non-strict, position 0 a trough iff c0 < c1), else the first global
//      minimum; a parabolic shift (0 at the edges or when |shift| > 1);
//   4. f0 = sr / period per frame, then the median over frames (the mean
//      of the two middle values when the count is even, as jnp.median).
// Steps 1-3 are per frame, so a clip runs in groups of frames
// (yin_frames_f0): a group's padded samples and its frames' tables fit in
// shared memory whatever the clip's length, and each frame's sums are the
// same floats in any group. Only the f0 of every frame (4 bytes a frame)
// stays for the median (yin_median). A clip of at most one group stages
// all of itself at once, as before groups existed. The host picks the
// group from the shared memory a block has at the kernel's occupancy
// (yin_group).
// How the ACF is tiled and why its sums are split is K3's header comment.
// K6 forms the same sums with the chains that overlapping frames share
// (acf_shared_chains below), and runs steps 3-4 with a warp per frame and
// a rank per f0 (frame_f0_warps; both the kFused branch) where K3 runs
// one thread per frame and an insertion sort: the same floats either way.
#pragma once

#include <cmath>

#include "dsp_common.cuh"

namespace gat {

constexpr float kTiny = 1.1754944e-38f;  // np.finfo(np.float32).tiny
constexpr int kChunks = 8;               // energy scan chunks per frame
constexpr int kTile = 7;                 // lags per thread, odd
constexpr int kWarp = 32;
constexpr int kBlockLags = kWarp * kTile;  // lags per unit: 224
constexpr int kSegs = kThreads / kWarp;    // segments of i: one per warp

// The tables of one group of `group` frames in shared memory: byte
// offsets from an 8-byte aligned base, doubles first, `tables` bytes in
// all; and the length of the group's zero-padded samples the ACF reads.
// The f0 table holds every frame of the clip, `n_frames` (default: the
// group is the whole clip).
struct YinLayout {
  int n_lags, lag_blocks, padded_len;
  size_t chunk, dchunk, acf, red, f0, tables;
  __host__ __device__ YinLayout(int win, int hop, int group, int max_p,
                                int n_frames = 0) {
    if (n_frames < group) n_frames = group;
    n_lags = max_p + 1;
    lag_blocks = (n_lags + kBlockLags - 1) / kBlockLags;
    // up to the highest sample read, x[win + lag_blocks * kBlockLags] of
    // the group's last frame (the window refill after the ACF's last step)
    padded_len = (group - 1) * hop + win + lag_blocks * kBlockLags + 1;
    chunk = 0;  // fp64 energy sum per (frame, chunk)
    dchunk = chunk + sizeof(double) * group * kChunks;
    acf = dchunk + sizeof(float) * group * kChunks;
    red = acf + sizeof(float) * group * n_lags;
    f0 = red + sizeof(float) * 2 * kSegs * kBlockLags;
    tables = f0 + sizeof(float) * n_frames;
  }
};

// The frames whose f0 the median's rank sort (K6) places in the ACF round
// table, free by then; a one-block clip of more frames takes the
// insertion sort (the same floats).
constexpr int kRankFrames = 2 * kSegs * kBlockLags;

// The largest group of frames, at most n_frames, whose shared memory
// `bytes(g)` fits in `budget` bytes; 0 when not even one frame fits. Any
// layout holds the group's padded samples and tables apart, which grow
// with g, so the search ends where those alone exceed the budget.
template <class Bytes>
inline int yin_group(int win, int hop, int n_frames, int max_p,
                     size_t budget, Bytes bytes) {
  int best = 0;
  for (int g = 1; g <= n_frames; ++g) {
    const YinLayout y(win, hop, g, max_p, n_frames);
    if (!smem_fits(y.tables + sizeof(float) * y.padded_len, budget)) break;
    if (smem_fits(bytes(g), budget)) best = g;
  }
  return best;
}

// The energy scan's term at lag tau: the square entering the window
// minus the square leaving it.
__device__ __forceinline__ double energy_step(const float* x, int tau,
                                              int win) {
  const double enter = x[tau + win], leave = x[tau];
  return enter * enter - leave * leave;
}

// acc[r] += sum_{i0 <= i < i1} x[i] x[i + tau0 + r], r < kTile, with the
// window x[i + tau0 + r] in registers.
__device__ __forceinline__ void acf_tile(const float* x, int i0, int i1,
                                         int tau0, float* acc) {
  const float* xw = x + tau0;
  float w[kTile];  // slot (s + r) % kTile holds xw[i + s + r] at step s
#pragma unroll
  for (int r = 0; r < kTile; ++r) w[r] = xw[i0 + r];
  int i = i0;
  for (; i + kTile <= i1; i += kTile) {
#pragma unroll
    for (int s = 0; s < kTile; ++s) {
      const float xi = x[i + s];
#pragma unroll
      for (int r = 0; r < kTile; ++r) acc[r] += xi * w[(s + r) % kTile];
      w[s] = xw[i + s + kTile];  // slot s is done with xw[i + s]
    }
  }
  for (; i < i1; ++i) {  // the rest, fewer than kTile steps
    const float xi = x[i];
#pragma unroll
    for (int r = 0; r < kTile; ++r) acc[r] += xi * w[r];
#pragma unroll
    for (int r = 0; r + 1 < kTile; ++r) w[r] = w[r + 1];
    w[kTile - 1] = xw[i + kTile];
  }
}

// f0 in Hz of a frame whose trough or minimum is c[idx], c[j] =
// CMND(min_p + j), j < n_cmnd: the parabolic shift through c[idx - 1],
// c[idx], c[idx + 1] (0 at the edges or when |shift| > 1).
__device__ __forceinline__ float frame_f0(const float* c, int idx,
                                          int n_cmnd, int min_p, float sr) {
  float shift = 0.0f;
  if (idx > 0 && idx < n_cmnd - 1) {
    const float a = (c[idx - 1] + c[idx + 1] - 2.0f * c[idx]) / 2.0f;
    const float b = (c[idx + 1] - c[idx - 1]) / 2.0f;
    const float inner = -b / (2.0f * a + kTiny);
    shift = fabsf(inner) > 1.0f ? 0.0f : inner;
  }
  return sr / ((float)(min_p + idx) + shift);
}

// The median of n ascending values (the mean of the two middle ones when
// n is even, as jnp.median).
__device__ __forceinline__ float sorted_median(const float* v, int n) {
  const int h = n / 2;
  return (n & 1) ? v[h] : (v[h - 1] + v[h]) * 0.5f;
}

// f0[t] for every frame, one warp per frame, from c = CMND(min_p + j):
// the serial walk's first trough below the threshold, tested 32 lags at a
// time (each lane tests the trough and threshold conditions at its lag,
// __ballot_sync and __ffs pick the first hit), else the first global
// minimum by a warp argmin (each lane's first minimum over its lags, then
// the smaller value or, on a tie, the smaller index across lanes). The
// same comparisons pick the same index, and lane 0 forms f0 with
// frame_f0, so f0 is the serial walk's float.
__device__ __forceinline__ void frame_f0_warps(const float* acf, float* f0,
                                               int n_frames, int n_lags,
                                               int min_p, int n_cmnd,
                                               float threshold, float sr) {
  const int lane = threadIdx.x % kWarp;
  for (int t = threadIdx.x / kWarp; t < n_frames; t += kThreads / kWarp) {
    const float* c = acf + t * n_lags + min_p;
    int idx = -1;
    for (int j0 = 0; j0 < n_cmnd; j0 += kWarp) {
      const int j = j0 + lane;
      bool hit = false;
      if (j < n_cmnd) {
        bool trough;
        if (j == 0) {
          trough = c[0] < c[1];
        } else {
          const float right = j + 1 < n_cmnd ? c[j + 1] : c[j];
          trough = c[j] < c[j - 1] && c[j] <= right;
        }
        hit = trough && c[j] < threshold;
      }
      const unsigned mask = __ballot_sync(0xffffffffu, hit);
      if (mask != 0) {
        idx = j0 + __ffs(mask) - 1;
        break;
      }
    }
    if (idx < 0) {
      float best = INFINITY;
      int at = n_cmnd;  // no lag: loses every comparison
      if (lane < n_cmnd) {
        best = c[lane];
        at = lane;
      }
      for (int j = lane + kWarp; j < n_cmnd; j += kWarp)
        if (c[j] < best) {
          best = c[j];
          at = j;
        }
#pragma unroll
      for (int o = kWarp / 2; o > 0; o >>= 1) {
        const float b = __shfl_xor_sync(0xffffffffu, best, o);
        const int i = __shfl_xor_sync(0xffffffffu, at, o);
        if (b < best || (b == best && i < at)) {
          best = b;
          at = i;
        }
      }
      idx = __shfl_sync(0xffffffffu, at, 0);
    }
    if (lane == 0) f0[t] = frame_f0(c, idx, n_cmnd, min_p, sr);
  }
}

// Whether acf_shared_chains takes this frame geometry: segments of
// win / kSegs samples that tile the hop.
__host__ __device__ constexpr bool shared_chains_fit(int win, int hop) {
  return win % kSegs == 0 && hop > 0 && hop % (win / kSegs) == 0;
}

// The ACF of every frame into acf[t * n_lags + tau], with the chains that
// overlapping frames share computed once (K6; shared_chains_fit(win,
// hop)). Chain g is the sum over the seg_len = win / kSegs samples from
// padded[g * seg_len + 1] of x[i] x[i + tau]; segment s of frame t (the
// per-frame loop's warp s) is chain t * m + s, m = hop / seg_len. So the
// n_frames * kSegs (frame, segment) units are (n_frames - 1) * m + kSegs
// distinct chains: at hop = win / 2, 48 instead of 88 for 11 frames.
// Each round, the 8 warps compute 8 consecutive chains of one lag block
// with acf_tile over the same samples, lags and i-range length as the
// per-frame loop, so each chain's FMAs are the same in the same order and
// its sum is the same float. The chains go into a double-buffered table
// of partial sums (`red`); after the round's barrier, the thread of lag
// tau adds each chain to the frames it belongs to, in segment order, the
// running sum of a frame whose chains span two rounds kept in acf[t] in
// between. So acf(t, tau) = p0 + p1 + ... + p7 is summed in the per-frame
// loop's order from the same partials, and equals its float bit for bit.
// Every thread of the block calls this; acf is published at the next
// barrier.
__device__ __forceinline__ void acf_shared_chains(
    const float* __restrict__ padded, const YinLayout& lay, float* acf,
    float* red, int n_frames, int win, int hop) {
  const int n_lags = lay.n_lags;
  const int lane = threadIdx.x % kWarp, seg = threadIdx.x / kWarp;
  const int seg_len = win / kSegs;
  const int m = hop / seg_len;  // chains per hop
  const int n_chains = (n_frames - 1) * m + kSegs;
  const int rounds = (n_chains + kSegs - 1) / kSegs;
  for (int u = 0; u < lay.lag_blocks * rounds; ++u) {
    const int b = u / rounds;
    const int g0 = (u - b * rounds) * kSegs;  // this round's first chain
    const int g1 = g0 + kSegs < n_chains ? g0 + kSegs : n_chains;
    float* part = red + (u & 1) * kSegs * kBlockLags;
    if (g0 + seg < g1) {
      float acc[kTile] = {};
      acf_tile(padded + (g0 + seg) * seg_len, 1, 1 + seg_len,
               b * kBlockLags + kTile * lane, acc);
#pragma unroll
      for (int r = 0; r < kTile; ++r)
        part[seg * kBlockLags + kTile * lane + r] = acc[r];
    }
    __syncthreads();  // one barrier per round: the next round writes the
                      // other half of the table
    for (int k = threadIdx.x; k < kBlockLags; k += kThreads) {
      const int tau = b * kBlockLags + k;
      if (tau >= n_lags) continue;
      // the frames with a chain in [g0, g1): t * m + kSegs > g0
      for (int t = g0 >= kSegs ? (g0 - kSegs) / m + 1 : 0;
           t < n_frames && t * m < g1; ++t) {
        const int first = t * m;  // the frame's chain of segment 0
        const int end = first + kSegs < g1 ? first + kSegs : g1;
        int g = first > g0 ? first : g0;
        float s = first >= g0 ? part[(g++ - g0) * kBlockLags + k]
                              : acf[t * n_lags + tau];
        for (; g < end; ++g) s += part[(g - g0) * kBlockLags + k];
        acf[t * n_lags + tau] = s;
      }
    }
  }
}

// Steps 1-3 for a group of n_frames frames (at most the layout's group):
// frame t is padded[t * hop + n], n < frame_length, of the group's
// zero-padded samples `padded` (lay.padded_len floats in shared memory,
// zeros past the clip), with the tables at `base` (lay.tables bytes); its
// f0 in Hz goes to f0[t]. kFused (K6, which needs shared_chains_fit(win,
// hop)): the ACF is acf_shared_chains', the trough walk runs one warp per
// frame (frame_f0_warps); else (K3) one unit (frame, lag block) per ACF
// round and one thread per frame. Either way each f0 is the same float.
// Every thread of the block calls this; f0 is published on return.
template <bool kFused = false>
__device__ __forceinline__ void yin_frames_f0(
    const float* __restrict__ padded, char* base, const YinLayout& lay,
    int n_frames, float* f0, int win, int hop, int min_p, int max_p,
    float threshold, float sr) {
  const int n_lags = lay.n_lags;
  const int n_cmnd = max_p - min_p + 1;
  double* chunk = reinterpret_cast<double*>(base + lay.chunk);
  float* dchunk = reinterpret_cast<float*>(base + lay.dchunk);
  float* acf = reinterpret_cast<float*>(base + lay.acf);  // then d, CMND
  float* red = reinterpret_cast<float*>(base + lay.red);

  // The energy scan's first step: each chunk's sum of terms. The
  // barriers of the ACF rounds publish them.
  const int chunk_len = (max_p + kChunks - 1) / kChunks;
  for (int w = threadIdx.x; w < n_frames * kChunks; w += kThreads) {
    const int t = w / kChunks;
    const int first = 1 + (w - t * kChunks) * chunk_len;
    const int last = first + chunk_len - 1 < max_p ? first + chunk_len - 1
                                                   : max_p;
    const float* x = padded + t * hop;
    double s = 0.0;
    for (int tau = first; tau <= last; ++tau) s += energy_step(x, tau, win);
    chunk[w] = s;
  }

  // The ACF, one unit (frame t, lag block b) per round: warp `seg` sums
  // i in its segment for its lane's kTile lags, then the block adds the
  // kSegs partial sums of each lag in order. The sums are stored
  // unzeroed: acf(0) seeds the energies below.
  if constexpr (kFused) {
    acf_shared_chains(padded, lay, acf, red, n_frames, win, hop);
  } else {
    const int lane = threadIdx.x % kWarp, seg = threadIdx.x / kWarp;
    const int seg_len = (win + kSegs - 1) / kSegs;
    const int i0 = 1 + seg * seg_len;
    const int i1 = i0 + seg_len < win + 1 ? i0 + seg_len : win + 1;
    for (int u = 0; u < n_frames * lay.lag_blocks; ++u) {
      const int t = u / lay.lag_blocks, b = u - t * lay.lag_blocks;
      float acc[kTile] = {};
      acf_tile(padded + t * hop, i0, i1, b * kBlockLags + kTile * lane, acc);
      float* part = red + (u & 1) * kSegs * kBlockLags;
#pragma unroll
      for (int r = 0; r < kTile; ++r)
        part[seg * kBlockLags + kTile * lane + r] = acc[r];
      __syncthreads();  // one barrier per round: the next round writes the
                        // other half of the table
      for (int k = threadIdx.x; k < kBlockLags; k += kThreads) {
        const int tau = b * kBlockLags + k;
        if (tau >= n_lags) continue;
        float s = part[k];
#pragma unroll
        for (int q = 1; q < kSegs; ++q) s += part[q * kBlockLags + k];
        acf[t * n_lags + tau] = s;
      }
    }
  }
  __syncthreads();

  // Chunk by chunk, in place in acf[t]: d(tau) = e(0) + e(tau) -
  // 2 acf(tau), with e(tau) = acf(0) + the energy prefix in fp64 (the
  // chunks before this one, then its own terms), and each chunk's sum of
  // d; then the cumulative mean from those sums and the CMND. Slot 0
  // keeps acf(0).
  for (int w = threadIdx.x; w < n_frames * kChunks; w += kThreads) {
    const int t = w / kChunks;
    const int c = w - t * kChunks;
    const int first = 1 + c * chunk_len;
    const int last = first + chunk_len - 1 < max_p ? first + chunk_len - 1
                                                   : max_p;
    const float* x = padded + t * hop;
    float* ac = acf + t * n_lags;
    const float a0 = ac[0];
    const float e0 = fabsf(a0) < 1e-6f ? 0.0f : a0;
    double s = 0.0;
    for (int k = 0; k < c; ++k) s += chunk[t * kChunks + k];
    float dsum = 0.0f;
    for (int tau = first; tau <= last; ++tau) {
      s += energy_step(x, tau, win);
      const float e = (float)(a0 + s);
      const float et = fabsf(e) < 1e-6f ? 0.0f : e;
      const float at = fabsf(ac[tau]) < 1e-6f ? 0.0f : ac[tau];
      const float d = e0 + et - 2.0f * at;
      ac[tau] = d;
      dsum += d;
    }
    dchunk[w] = dsum;
  }
  __syncthreads();
  for (int w = threadIdx.x; w < n_frames * kChunks; w += kThreads) {
    const int t = w / kChunks;
    const int c = w - t * kChunks;
    const int first = 1 + c * chunk_len;
    const int last = first + chunk_len - 1 < max_p ? first + chunk_len - 1
                                                   : max_p;
    float* ac = acf + t * n_lags;
    float cum = 0.0f;
    for (int k = 0; k < c; ++k) cum += dchunk[t * kChunks + k];
    for (int tau = first; tau <= last; ++tau) {
      const float d = ac[tau];
      cum += d;
      if (tau >= min_p) ac[tau] = d / (cum / (float)tau + kTiny);
    }
  }
  __syncthreads();

  if constexpr (kFused) {
    frame_f0_warps(acf, f0, n_frames, n_lags, min_p, n_cmnd, threshold, sr);
  } else {
    // one thread per frame: the trough walk over c[j] = CMND(min_p + j)
    for (int t = threadIdx.x; t < n_frames; t += kThreads) {
      const float* c = acf + t * n_lags + min_p;
      int idx = -1;
      for (int j = 0; j < n_cmnd && idx < 0; ++j) {
        bool trough;
        if (j == 0) {
          trough = c[0] < c[1];
        } else {
          const float right = j + 1 < n_cmnd ? c[j + 1] : c[j];
          trough = c[j] < c[j - 1] && c[j] <= right;
        }
        if (trough && c[j] < threshold) idx = j;
      }
      if (idx < 0) {
        idx = 0;
        for (int j = 1; j < n_cmnd; ++j)
          if (c[j] < c[idx]) idx = j;
      }
      f0[t] = frame_f0(c, idx, n_cmnd, min_p, sr);
    }
  }
  __syncthreads();
}

// Thread 0's insertion sort of f0[0..n_frames) in place, and its
// median (the result is thread 0's).
__device__ __forceinline__ float insertion_median(float* f0, int n_frames) {
  float hz = 0.0f;
  if (threadIdx.x == 0) {
    for (int i = 1; i < n_frames; ++i) {  // insertion sort
      const float v = f0[i];
      int j = i - 1;
      while (j >= 0 && f0[j] > v) {
        f0[j + 1] = f0[j];
        --j;
      }
      f0[j + 1] = v;
    }
    hz = sorted_median(f0, n_frames);
  }
  return hz;
}

// Step 4: the median in Hz of the f0 of a clip's n_frames frames, in the
// layout's f0 table. kFused: each f0's rank (ties by frame) places it in
// ascending order in the ACF round table, free by then, which is the
// insertion sort's order of the same values; else (K3), or past the
// kRankFrames the table holds, an insertion sort in place on thread 0.
// Every thread of the block calls this; the result is thread 0's.
template <bool kFused = false>
__device__ __forceinline__ float yin_median(char* base, const YinLayout& lay,
                                            int n_frames) {
  float* f0 = reinterpret_cast<float*>(base + lay.f0);
  if (kFused && n_frames <= kRankFrames) {
    float* sorted = reinterpret_cast<float*>(base + lay.red);
    for (int t = threadIdx.x; t < n_frames; t += kThreads) {
      const float v = f0[t];
      int rank = 0;
      for (int j = 0; j < n_frames; ++j)
        rank += f0[j] < v || (f0[j] == v && j < t);
      sorted[rank] = v;
    }
    __syncthreads();
    return threadIdx.x == 0 ? sorted_median(sorted, n_frames) : 0.0f;
  }
  return insertion_median(f0, n_frames);
}

// The split route's median (dsp_common.cuh): the median of the n f0 of a
// clip in device memory, from any number of frames, by a radix selection
// of each middle value (k = n / 2, and n / 2 - 1 when n is even) over the
// floats' order keys, 8 bits a pass from the top: each pass counts, in a
// histogram of 256 bins in shared memory, the keys whose bits above the
// pass match the digits found so far, and thread 0 walks the bins to the
// one that holds the k-th key. The middle values are the sorted order's,
// and the median is sorted_median's float (the mean of the two middle
// ones when n is even, as jnp.median). hist holds 258 ints of shared
// memory. Every thread of the block calls this; the result is every
// thread's.
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = (unsigned)__float_as_int(v);
  return u & 0x80000000u ? ~u : u | 0x80000000u;
}

__device__ __forceinline__ float key_float(unsigned k) {
  return __int_as_float((int)(k & 0x80000000u ? k & 0x7fffffffu : ~k));
}

__device__ __forceinline__ float select_kth(const float* __restrict__ v,
                                            int n, int k, int* hist) {
  unsigned prefix = 0, mask = 0;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < 256; i += kThreads) hist[i] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const unsigned key = order_key(v[i]);
      if ((key & mask) == prefix) atomicAdd(&hist[(key >> shift) & 255u], 1);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int d = 0;
      while (k >= hist[d]) k -= hist[d++];
      hist[256] = d;
      hist[257] = k;
    }
    __syncthreads();
    prefix |= (unsigned)hist[256] << shift;
    mask |= 255u << shift;
    k = hist[257];
    __syncthreads();  // the next pass clears the bins
  }
  return key_float(prefix);
}

__device__ __forceinline__ float select_median(const float* __restrict__ f0,
                                               int n, int* hist) {
  const int h = n / 2;
  const float hi = select_kth(f0, n, h, hist);
  if (n & 1) return hi;
  return (select_kth(f0, n, h - 1, hist) + hi) * 0.5f;
}

}  // namespace gat
