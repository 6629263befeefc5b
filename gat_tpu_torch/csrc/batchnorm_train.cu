// K13: flax's train-mode BatchNorm and its backward, four kernels.
//
// Replaces the XLA program of flax's nn.BatchNorm(use_running_average=False,
// momentum=0.9, epsilon=1e-5) at gat_tpu/models/cnn.py:84-85, forward and
// (through jax.grad) backward, which XLA fused inside the training step. It
// replaces no Pallas kernel.
//
// x is (N, C, H, W) with any strides where stride(H) = W·stride(W), so a
// position p = h·W + w is at p·stride(W): contiguous NCHW and channels-last
// both are. M = N·H·W positions a channel. Elements are float32 or
// bfloat16 (converted by bit casts, rounded to nearest even on the way
// out).
//   gat_bn_moments:      mean_c = sum x / M, sq_c = sum x² / M (float32).
//   gat_bn_apply:        var = max(sq - mean², 0), r = 1/sqrt(var + eps),
//                        mul = r·w, y = (x - mean)·mul + b rounded to x's
//                        type; running_mean = keep·running_mean + upd·mean,
//                        running_var likewise toward var (flax: the biased
//                        variance).
//   gat_bn_apply_grad:   from dy: db = sum dy, dmul = sum dy·(x - mean),
//                        dw = dmul·r, dvar = -0.5·dmul·w·r³, and where
//                        sq - mean² >= 0 (the clamp passes) dsq = dvar and
//                        dmean = -mul·db - 2·mean·dvar, else dsq = 0 and
//                        dmean = -mul·db; also mul.
//   gat_bn_moments_grad: dx = dy·mul + dmean / M + 2·x·(dsq / M), rounded
//                        once to x's type: the apply's direct term and the
//                        moments' backward in one pass (the caller passes
//                        the moments' gradients after any all-reduce).
//
// What bounds them: bytes. A training step of the shipped CNN at 32 clips
// holds 1.44 M, 0.72 M and 0.33 M elements in its three layers (2.9, 1.4
// and 0.7 MB in bfloat16): a few µs of memory traffic each, so a launch's
// latency, one round of loads and the sums' tail are what a kernel costs.
// The design keeps every part of that short:
// - Two maps. The dense channels-last layout that cuDNN's convolutions
//   give (the "rows" map, C dividing 256) is read as a flat (M, C) array,
//   element i = m·C + c, 16 bytes a load (8 bfloat16 or 4 float32
//   consecutive channels), so a warp reads 512 contiguous bytes a step;
//   since C divides 256, a thread's vectors always hold the same channels
//   and their sums stay in registers. Any other layout (NCHW, C not
//   dividing 256, H = 1, an expanded dy) takes the "runs" map: a block a
//   channel and a range of its positions, (n, p) advanced by increments
//   (one division a thread at its start, none an element), 16-byte loads
//   along positions where they are contiguous and aligned, else one
//   element a load.
// - Each thread issues kUnroll loads a tensor before it uses any.
// - The grid is sized to the card (`bn_blocks`): as many blocks as take
//   kUnroll loads a thread once, at least one an SM while each thread
//   still has a load, at most what the SMs hold at once; for the two
//   kernels that sum, at most as many blocks as leave the last block one
//   round of loads of their partials (`gat_bn_splits`): a second round
//   cost more than the SMs the cap leaves idle (PERF.md §6, PR 24).
// - The per-channel sums are split over the blocks: each block reduces its
//   threads' sums by warp shuffles and then over its warps in a fixed
//   order into one partial a channel, and the last block to finish (a
//   ticket taken with an integer atomic after a fence) adds the partials
//   of each channel with all its threads, a slice of the blocks each in
//   block order with 16-byte loads of 4 channels, kBatch of them in
//   flight, then a tree over the slices, and resets the ticket. No float
//   atomics: two runs give the same bits.
// - The elementwise kernels compute each channel's multiplier and shift
//   once a block into shared memory, then stream 16-byte loads and stores,
//   each element rounded step by step as before (__fmul_rn, __fadd_rn).
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <mutex>

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // loads of one tensor a thread keeps in flight
constexpr int kMaxChannelsLast = kThreads;  // C dividing 256: the rows map

struct Shape {
  int c, p;
  long long m, sn, sc, sp;  // M = N·P; strides in elements
};

__device__ __forceinline__ unsigned bf16_bits(float v) {
  const unsigned u = (unsigned)__float_as_int(v);
  return (u & 0x7fffffffu) > 0x7f800000u
             ? 0x7fc0u
             : (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
}

// kW elements from element offset o (kW > 1: one 16-byte load, o a
// multiple of kW).
template <bool kBf16, int kW>
__device__ __forceinline__ void load_item(const void* base, long long o,
                                          float (&v)[kW]) {
  if constexpr (kW == 1) {
    if constexpr (kBf16)
      v[0] = __int_as_float(
          (int)((unsigned)static_cast<const unsigned short*>(base)[o] << 16));
    else
      v[0] = static_cast<const float*>(base)[o];
  } else {
    const uint4 u = __ldg(static_cast<const uint4*>(base) + o / kW);
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
    for (int k = 0; k < kW; ++k)
      if constexpr (kBf16)
        v[k] = __int_as_float(
            (int)(k & 1 ? w[k / 2] & 0xffff0000u : w[k / 2] << 16));
      else
        v[k] = __int_as_float((int)w[k]);
  }
}

template <bool kBf16, int kW>
__device__ __forceinline__ void store_item(void* base, long long o,
                                           const float (&v)[kW]) {
  if constexpr (kW == 1) {
    if constexpr (kBf16)
      static_cast<unsigned short*>(base)[o] = (unsigned short)bf16_bits(v[0]);
    else
      static_cast<float*>(base)[o] = v[0];
  } else {
    unsigned w[4];
    for (int k = 0; k < 4; ++k)
      if constexpr (kBf16)
        w[k] = bf16_bits(v[2 * k]) | bf16_bits(v[2 * k + 1]) << 16;
      else
        w[k] = (unsigned)__float_as_int(v[k]);
    uint4 u;
    u.x = w[0];
    u.y = w[1];
    u.z = w[2];
    u.w = w[3];
    static_cast<uint4*>(base)[o / kW] = u;
  }
}

// A thread's walk over its items, kUnroll at a time: element offsets in x
// (ox) and in dy (og), and which of them exist.
template <bool kRows, int kW>
struct Walk;

// Rows map: items are runs of kW elements of the flat (M, C) array; a
// block's round covers kThreads·kUnroll consecutive items, thread t item
// t + j·kThreads of it, so its channels are (t·kW + k) mod C in every
// round.
template <int kW>
struct Walk<true, kW> {
  long long u, end, step;
  __device__ Walk(const Shape& s, const Shape&, int)
      : u((long long)blockIdx.x * kThreads * kUnroll + threadIdx.x),
        end(s.m * s.c / kW),
        step((long long)gridDim.x * kThreads * kUnroll) {}
  __device__ bool more() const { return u < end; }
  __device__ void next(long long (&ox)[kUnroll], long long (&og)[kUnroll],
                       bool (&ok)[kUnroll]) {
    for (int j = 0; j < kUnroll; ++j) {
      const long long v = u + (long long)j * kThreads;
      ok[j] = v < end;
      ox[j] = og[j] = v * kW;
    }
    u += step;
  }
};

// Runs map: block b takes channel b / splits and the split b mod splits
// of its M / kW items (kW consecutive positions each); thread t walks
// items t, t + kThreads, ... of the split, (n, p) advanced by increments.
template <int kW>
struct Walk<false, kW> {
  int c, split, pw, pv, dp;
  long long u, end, n, dn;
  long long xn, xc, xp, gn, gc, gp;  // strides; positions in items
  __device__ Walk(const Shape& s, const Shape& gs, int splits) {
    c = blockIdx.x / splits;
    split = blockIdx.x - c * splits;
    pw = s.p / kW;
    const long long items = s.m / kW;
    u = items * split / splits + threadIdx.x;
    end = items * (split + 1) / splits;
    n = u / pw;
    pv = (int)(u - n * pw);
    dn = kThreads / pw;
    dp = kThreads - (int)dn * pw;
    xn = s.sn, xc = c * s.sc, xp = s.sp * kW;
    gn = gs.sn, gc = c * gs.sc, gp = gs.sp * kW;
  }
  __device__ bool more() const { return u < end; }
  __device__ void next(long long (&ox)[kUnroll], long long (&og)[kUnroll],
                       bool (&ok)[kUnroll]) {
    for (int j = 0; j < kUnroll; ++j) {
      ok[j] = u < end;
      ox[j] = n * xn + xc + pv * xp;
      og[j] = n * gn + gc + pv * gp;
      u += kThreads;
      n += dn;
      pv += dp;
      if (pv >= pw) {
        pv -= pw;
        ++n;
      }
    }
  }
};

// The channel of lane k of this thread in the rows map.
__device__ __forceinline__ int lane_channel(int c_all, int kw, int k) {
  return ((int)threadIdx.x * kw + k) & (c_all - 1);
}

// The block's per-channel sums of acc[q] into part[(q·S + split)·C + c]
// (S = splits), then a barrier, after which `last_block` publishes them.
template <bool kRows, int kW, int NQ>
__device__ __forceinline__ void block_partials(float (&acc)[NQ][kW],
                                               float* part, int c_all,
                                               int splits, int split, int c) {
  __shared__ float red[NQ][kWarps][kMaxChannelsLast];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (kRows) {
    // lanes k >= C of a thread repeat channels k mod C: fold them
    if (c_all < kW)
      for (int k = 0; k < kW; ++k)
        for (int k2 = 0; k2 < kW; ++k2)
          if (k2 >= c_all && (k2 & (c_all - 1)) == k)
            for (int q = 0; q < NQ; ++q) acc[q][k] += acc[q][k2];
    // lanes g apart (g = C / kW) hold the same channels
    const int g = c_all >= kW ? c_all / kW : 1;
    for (int off = 16; off >= g; off >>= 1)
      for (int q = 0; q < NQ; ++q)
        for (int k = 0; k < kW; ++k)
          acc[q][k] += __shfl_xor_sync(0xffffffffu, acc[q][k], off);
    if (lane < g)
      for (int k = 0; k < kW; ++k)
        if (k < c_all)
          for (int q = 0; q < NQ; ++q)
            red[q][warp][lane_channel(c_all, kW, k)] = acc[q][k];
    __syncthreads();
    if (t < c_all) {
      // the warps that hold channel t: all when g <= 32, else those of
      // lane group (t / kW) / 32 of g / 32
      const int step = g > 32 ? g / 32 : 1;
      const int w0 = g > 32 ? (t / kW) / 32 : 0;
      for (int q = 0; q < NQ; ++q) {
        float sum = 0.0f;
        for (int w = w0; w < kWarps; w += step) sum += red[q][w][t];
        part[((long long)q * splits + split) * c_all + t] = sum;
      }
    }
  } else {
    for (int q = 0; q < NQ; ++q) {
      for (int k = 1; k < kW; ++k) acc[q][0] += acc[q][k];
      for (int off = 16; off >= 1; off >>= 1)
        acc[q][0] += __shfl_xor_sync(0xffffffffu, acc[q][0], off);
      if (lane == 0) red[q][warp][0] = acc[q][0];
    }
    __syncthreads();
    if (t == 0) {
      for (int q = 0; q < NQ; ++q) {
        float sum = 0.0f;
        for (int w = 0; w < kWarps; ++w) sum += red[q][w][0];
        part[((long long)q * splits + split) * c_all + c] = sum;
      }
    }
  }
  __syncthreads();
}

// True in the last block of the launch to finish its partials. Thread 0
// fences before it takes the ticket (the fence is cumulative: it orders
// the partials that the block's barrier made it observe), and in the last
// block fences again before the barrier that releases the block's reads.
__device__ __forceinline__ bool last_block(int* ticket) {
  __shared__ int s_last;
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
    if (s_last) __threadfence();
  }
  __syncthreads();
  return s_last != 0;
}

// In the last block: each channel's S partials added by `per` threads, a
// slice of the splits each in split order, kBatch splits of every sum's
// loads in flight at once (16 bytes a load, 4 channels, where C is a
// multiple of 4), then the slices by a tree in a fixed order; fin(c, sums)
// for each channel; then the ticket reset. Its cost is the rounds of loads
// a thread waits for: ceil(S / (per·kBatch)).
constexpr int kBatch = 8;

template <int kQ, int NQ, class Fin>
__device__ __forceinline__ void finalize_units(const float* part, int c_all,
                                               int splits, Fin& fin) {
  __shared__ float red[NQ][kThreads * kQ];
  const int t = threadIdx.x;
  const int units = c_all / kQ;  // kQ channels a unit
  const int per = units >= kThreads ? 1 : kThreads / units;
  const int groups = per > 1 ? units : kThreads;
  int span = 1;
  while (span < per) span <<= 1;
  for (int u0 = 0; u0 < units; u0 += groups) {
    const int s = per > 1 ? t / units : 0;
    const int u = u0 + (per > 1 ? t - s * units : t);
    const bool mine = s < per && u < units;
    float acc[NQ][kQ];
    for (int q = 0; q < NQ; ++q)
      for (int k = 0; k < kQ; ++k) acc[q][k] = 0.0f;
    for (int b0 = s; mine && b0 < splits; b0 += kBatch * per) {
      float v[NQ][kBatch][kQ];
      for (int i = 0; i < kBatch; ++i) {
        const int b = b0 + i * per;
        for (int q = 0; q < NQ; ++q) {
          for (int k = 0; k < kQ; ++k) v[q][i][k] = 0.0f;
          if (b >= splits) continue;
          const float* src =
              part + ((long long)q * splits + b) * c_all + (long long)u * kQ;
          if constexpr (kQ == 4) {
            const float4 f = __ldcg(reinterpret_cast<const float4*>(src));
            v[q][i][0] = f.x;
            v[q][i][1] = f.y;
            v[q][i][2] = f.z;
            v[q][i][3] = f.w;
          } else {
            v[q][i][0] = __ldcg(src);
          }
        }
      }
      for (int i = 0; i < kBatch; ++i)
        for (int q = 0; q < NQ; ++q)
          for (int k = 0; k < kQ; ++k) acc[q][k] += v[q][i][k];
    }
    for (int q = 0; q < NQ; ++q)
      for (int k = 0; k < kQ; ++k) red[q][t * kQ + k] = acc[q][k];
    __syncthreads();
    for (int h = span / 2; h >= 1; h >>= 1) {
      if (mine && s < h && s + h < per)
        for (int q = 0; q < NQ; ++q)
          for (int k = 0; k < kQ; ++k)
            red[q][t * kQ + k] += red[q][(t + h * units) * kQ + k];
      __syncthreads();
    }
    if (mine && s == 0)
      for (int k = 0; k < kQ; ++k) {
        float sums[NQ];
        for (int q = 0; q < NQ; ++q) sums[q] = red[q][t * kQ + k];
        fin(u * kQ + k, sums);
      }
    __syncthreads();
  }
}

template <int NQ, class Fin>
__device__ __forceinline__ void finalize(const float* part, int c_all,
                                         int splits, int* ticket, Fin fin) {
  if (c_all % 4 == 0)
    finalize_units<4, NQ>(part, c_all, splits, fin);
  else
    finalize_units<1, NQ>(part, c_all, splits, fin);
  if (threadIdx.x == 0) *ticket = 0;
}

template <bool kBf16, bool kRows, int kW>
__global__ void __launch_bounds__(kThreads)
    bn_moments_kernel(const void* __restrict__ x, Shape s, int splits,
                      float* part, int* ticket, float* mean, float* sq) {
  Walk<kRows, kW> w(s, s, splits);
  float acc[2][kW];
  for (int k = 0; k < kW; ++k) acc[0][k] = acc[1][k] = 0.0f;
  while (w.more()) {
    long long ox[kUnroll], og[kUnroll];
    bool ok[kUnroll];
    w.next(ox, og, ok);
    float a[kUnroll][kW];
    for (int j = 0; j < kUnroll; ++j) {
      for (int k = 0; k < kW; ++k) a[j][k] = 0.0f;
      if (ok[j]) load_item<kBf16, kW>(x, ox[j], a[j]);
    }
    for (int j = 0; j < kUnroll; ++j)
      for (int k = 0; k < kW; ++k) {
        acc[0][k] += a[j][k];
        acc[1][k] += a[j][k] * a[j][k];
      }
  }
  const int split = kRows ? (int)blockIdx.x : (int)blockIdx.x % splits;
  const int c = kRows ? 0 : (int)blockIdx.x / splits;
  block_partials<kRows, kW, 2>(acc, part, s.c, splits, split, c);
  if (!last_block(ticket)) return;
  const float count = (float)s.m;
  finalize<2>(part, s.c, splits, ticket, [&](int ch, const float* sums) {
    mean[ch] = sums[0] / count;
    sq[ch] = sums[1] / count;
  });
}

// var = max(sq - mean², 0) with the subtraction's sign kept for the
// backward's clamp, and mul = w / sqrt(var + eps), rounded step by step.
struct Norm {
  float var, raw, r, mul;
};

__device__ __forceinline__ Norm norm_of(float mean, float sq, float w,
                                        float eps) {
  const float raw = __fsub_rn(sq, __fmul_rn(mean, mean));
  const float var = fmaxf(raw, 0.0f);
  const float r = 1.0f / sqrtf(__fadd_rn(var, eps));
  return {var, raw, r, __fmul_rn(r, w)};
}

// The channels this block reads: all C in the rows map (thread t fills
// channel t), the walk's one in the runs map (thread 0 fills slot 0).
template <bool kRows>
__device__ __forceinline__ int channel_slots(int c_all) {
  return kRows ? c_all : 1;
}

// Lane k's slot of the block's per-channel tables.
template <bool kRows, int kW>
__device__ __forceinline__ int slot_of(int c_all, int k) {
  return kRows ? lane_channel(c_all, kW, k) : 0;
}

template <bool kBf16, bool kRows, int kW>
__global__ void __launch_bounds__(kThreads)
    bn_apply_kernel(const void* __restrict__ x, void* __restrict__ y, Shape s,
                    int splits, const float* mean, const float* sq,
                    const float* weight, const float* bias, float eps,
                    float* running_mean, float* running_var, float keep,
                    float upd) {
  __shared__ float s_mu[kMaxChannelsLast], s_mul[kMaxChannelsLast],
      s_b[kMaxChannelsLast];
  Walk<kRows, kW> w(s, s, splits);
  const int t = threadIdx.x;
  const int first = kRows ? 0 : (int)blockIdx.x / splits;
  const bool updates = kRows ? blockIdx.x == 0 : blockIdx.x % splits == 0;
  if (t < channel_slots<kRows>(s.c)) {
    const int c = first + t;
    const float mu = mean[c];
    const Norm nm = norm_of(mu, sq[c], weight[c], eps);
    s_mu[t] = mu;
    s_mul[t] = nm.mul;
    s_b[t] = bias[c];
    if (updates) {
      running_mean[c] = __fadd_rn(__fmul_rn(keep, running_mean[c]),
                                  __fmul_rn(upd, mu));
      running_var[c] = __fadd_rn(__fmul_rn(keep, running_var[c]),
                                 __fmul_rn(upd, nm.var));
    }
  }
  __syncthreads();
  float mu[kW], mul[kW], b[kW];
  for (int k = 0; k < kW; ++k) {
    const int i = slot_of<kRows, kW>(s.c, k);
    mu[k] = s_mu[i];
    mul[k] = s_mul[i];
    b[k] = s_b[i];
  }
  while (w.more()) {
    long long ox[kUnroll], og[kUnroll];
    bool ok[kUnroll];
    w.next(ox, og, ok);
    float a[kUnroll][kW];
    for (int j = 0; j < kUnroll; ++j)
      if (ok[j]) load_item<kBf16, kW>(x, ox[j], a[j]);
    for (int j = 0; j < kUnroll; ++j) {
      if (!ok[j]) continue;
      float v[kW];
      for (int k = 0; k < kW; ++k)
        v[k] = __fadd_rn(__fmul_rn(__fsub_rn(a[j][k], mu[k]), mul[k]), b[k]);
      store_item<kBf16, kW>(y, ox[j], v);
    }
  }
}

template <bool kBf16, bool kRows, int kW>
__global__ void __launch_bounds__(kThreads)
    bn_apply_grad_kernel(const void* __restrict__ dy, Shape gs,
                         const void* __restrict__ x, Shape s, int splits,
                         const float* mean, const float* sq,
                         const float* weight, float eps, float* part,
                         int* ticket, float* dweight, float* dbias,
                         float* dmean, float* dsq, float* mul) {
  __shared__ float s_mu[kMaxChannelsLast];
  Walk<kRows, kW> w(s, gs, splits);
  const int t = threadIdx.x;
  const int first = kRows ? 0 : (int)blockIdx.x / splits;
  if (t < channel_slots<kRows>(s.c)) s_mu[t] = mean[first + t];
  __syncthreads();
  float mu[kW];
  for (int k = 0; k < kW; ++k) mu[k] = s_mu[slot_of<kRows, kW>(s.c, k)];
  float acc[2][kW];
  for (int k = 0; k < kW; ++k) acc[0][k] = acc[1][k] = 0.0f;
  while (w.more()) {
    long long ox[kUnroll], og[kUnroll];
    bool ok[kUnroll];
    w.next(ox, og, ok);
    float g[kUnroll][kW], a[kUnroll][kW];
    for (int j = 0; j < kUnroll; ++j) {
      for (int k = 0; k < kW; ++k) g[j][k] = a[j][k] = 0.0f;
      if (ok[j]) {
        load_item<kBf16, kW>(dy, og[j], g[j]);
        load_item<kBf16, kW>(x, ox[j], a[j]);
      }
    }
    for (int j = 0; j < kUnroll; ++j)
      for (int k = 0; k < kW; ++k) {
        acc[0][k] += g[j][k];
        acc[1][k] += g[j][k] * __fsub_rn(a[j][k], mu[k]);
      }
  }
  const int split = kRows ? (int)blockIdx.x : (int)blockIdx.x % splits;
  block_partials<kRows, kW, 2>(acc, part, s.c, splits, split, first);
  if (!last_block(ticket)) return;
  finalize<2>(part, s.c, splits, ticket, [&](int c, const float* sums) {
    const float mc = mean[c], wc = weight[c];
    const Norm nm = norm_of(mc, sq[c], wc, eps);
    const float dvar = __fmul_rn(
        __fmul_rn(-0.5f, __fmul_rn(sums[1], wc)),
        __fmul_rn(__fmul_rn(nm.r, nm.r), nm.r));
    const float through = nm.raw >= 0.0f ? dvar : 0.0f;
    dbias[c] = sums[0];
    dweight[c] = __fmul_rn(sums[1], nm.r);
    dsq[c] = through;
    dmean[c] = __fsub_rn(-__fmul_rn(nm.mul, sums[0]),
                         __fmul_rn(2.0f, __fmul_rn(mc, through)));
    mul[c] = nm.mul;
  });
}

template <bool kBf16, bool kRows, int kW>
__global__ void __launch_bounds__(kThreads)
    bn_moments_grad_kernel(const void* __restrict__ dy, Shape gs,
                           const void* __restrict__ x, void* __restrict__ dx,
                           Shape s, int splits, const float* mul,
                           const float* dmean, const float* dsq) {
  __shared__ float s_k[kMaxChannelsLast], s_a0[kMaxChannelsLast],
      s_a1[kMaxChannelsLast];
  Walk<kRows, kW> w(s, gs, splits);
  const int t = threadIdx.x;
  if (t < channel_slots<kRows>(s.c)) {
    const int c = (kRows ? 0 : (int)blockIdx.x / splits) + t;
    const float count = (float)s.m;
    s_k[t] = mul[c];
    s_a0[t] = dmean[c] / count;
    s_a1[t] = __fmul_rn(2.0f, dsq[c] / count);
  }
  __syncthreads();
  float k0[kW], a0[kW], a1[kW];
  for (int k = 0; k < kW; ++k) {
    const int i = slot_of<kRows, kW>(s.c, k);
    k0[k] = s_k[i];
    a0[k] = s_a0[i];
    a1[k] = s_a1[i];
  }
  while (w.more()) {
    long long ox[kUnroll], og[kUnroll];
    bool ok[kUnroll];
    w.next(ox, og, ok);
    float g[kUnroll][kW], a[kUnroll][kW];
    for (int j = 0; j < kUnroll; ++j)
      if (ok[j]) {
        load_item<kBf16, kW>(dy, og[j], g[j]);
        load_item<kBf16, kW>(x, ox[j], a[j]);
      }
    for (int j = 0; j < kUnroll; ++j) {
      if (!ok[j]) continue;
      float v[kW];
      for (int k = 0; k < kW; ++k)
        v[k] = __fadd_rn(__fadd_rn(__fmul_rn(g[j][k], k0[k]), a0[k]),
                         __fmul_rn(a[j][k], a1[k]));
      store_item<kBf16, kW>(dx, ox[j], v);
    }
  }
}

// The kernels of one (dtype, map, load width); kW > 1 is 16 bytes.
#define BN_PICK(name, bf16, rows, vec)                                  \
  ((bf16) ? ((rows) ? ((vec) ? name<true, true, 8> : name<true, true, 1>) \
                    : ((vec) ? name<true, false, 8>                       \
                             : name<true, false, 1>))                     \
          : ((rows) ? ((vec) ? name<false, true, 4> : name<false, true, 1>) \
                    : ((vec) ? name<false, false, 4>                      \
                             : name<false, false, 1>)))

static bool channels_last_ok(int c) {
  return c >= 1 && c <= kMaxChannelsLast && kMaxChannelsLast % c == 0;
}

// x's strides are those of a dense channels-last tensor (strides of size-1
// dimensions are free).
static bool dense_rows(int n, const Shape& s) {
  return s.sc == 1 && (s.p == 1 || s.sp == s.c) &&
         (n == 1 || s.sn == (long long)s.p * s.c);
}

static bool aligned(const void* ptr) {
  return ((uintptr_t)ptr & 15u) == 0;
}

// 16-byte loads along positions in the runs map: contiguous positions,
// runs and channels that start on a vector.
static bool runs_vectorise(const Shape& s, int w) {
  return s.sp == 1 && s.p % w == 0 && s.sn % w == 0 && s.sc % w == 0;
}

static std::mutex occupancy_lock;

// Resident blocks per SM of `kernel` on the current device, remembered per
// (device, kernel); at least 1.
template <class Kernel>
static int resident(Kernel kernel, int* blocks) {
  struct Entry {
    int device;
    const void* kernel;
    int blocks;
  };
  static Entry seen[64];
  static int n_seen = 0;
  int device = 0;
  int err = (int)cudaGetDevice(&device);
  if (err != 0) return err;
  std::lock_guard<std::mutex> guard(occupancy_lock);
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].device == device && seen[i].kernel == (const void*)kernel) {
      *blocks = seen[i].blocks;
      return 0;
    }
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                           kThreads, 0);
  if (err != 0) return err;
  if (*blocks < 1) *blocks = 1;
  if (n_seen < 64) seen[n_seen++] = {device, (const void*)kernel, *blocks};
  return 0;
}

// The blocks of a launch over `items` loads of kThreads threads on `sms`
// SMs holding `per_sm` blocks each: enough that every thread issues
// kUnroll loads once, at least one an SM while each thread still has a
// load, at most all the resident ones.
static long long bn_blocks(long long items, int sms, int per_sm) {
  const long long once = (items + kThreads * kUnroll - 1) /
                         (kThreads * kUnroll);
  const long long each = (items + kThreads - 1) / kThreads;
  long long blocks = once > sms ? once : (each < sms ? each : sms);
  const long long most = (long long)sms * per_sm;
  blocks = blocks > most ? most : blocks;
  return blocks < 1 ? 1 : blocks;
}

// The splits of the positions that a launch at C channels and M positions
// uses on the current device (its grid is splits blocks in the rows map,
// C·splits in the runs map), -1 where refused (channels-last with C not
// dividing 256, or no device). `sums`: for the two kernels that sum over
// the positions, whose last block reads every partial: at most as many
// splits as it reads in one round of loads (kBatch of 4 channels, or of
// one where C is not a multiple of 4, a thread). Their partial buffers
// hold 2·C·splits floats.
extern "C" int gat_bn_splits(int c, long long m, int channels_last, int bf16,
                             int sums) {
  if (c < 1 || m < 1 || (channels_last && !channels_last_ok(c))) return -1;
  int device = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&device) != 0 ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                             device) != 0 ||
      resident(BN_PICK(bn_moments_kernel, bf16, channels_last, 1), &per_sm) !=
          0)
    return -1;
  const int w = bf16 ? 8 : 4;
  const long long blocks = bn_blocks((m * c + w - 1) / w, sms, per_sm);
  long long cap = 1LL << 30;
  if (sums) {
    cap = (long long)kThreads * kBatch * (c % 4 == 0 ? 4 : 1) / c;
    cap = cap < 1 ? 1 : cap;
  }
  if (channels_last) return (int)(blocks < cap ? blocks : cap);
  long long s = (blocks + c - 1) / c;
  const long long most = (m + kThreads - 1) / kThreads;
  s = s < most ? s : most;
  return (int)(s < cap ? s : cap);
}

// Resident blocks per SM of the four kernels (moments, apply,
// apply-backward, moments-backward) of one dtype and map, 16-byte loads,
// into blocks[4].
extern "C" int gat_bn_blocks_per_sm(int bf16, int channels_last,
                                    int* blocks) {
  int err = resident(BN_PICK(bn_moments_kernel, bf16, channels_last, 1),
                     blocks);
  if (!err)
    err = resident(BN_PICK(bn_apply_kernel, bf16, channels_last, 1),
                   blocks + 1);
  if (!err)
    err = resident(BN_PICK(bn_apply_grad_kernel, bf16, channels_last, 1),
                   blocks + 2);
  if (!err)
    err = resident(BN_PICK(bn_moments_grad_kernel, bf16, channels_last, 1),
                   blocks + 3);
  return err;
}

static bool bad(int n, int c, int p, int splits, int channels_last) {
  return n < 0 || c < 1 || p < 1 || splits < 1 ||
         (channels_last && !channels_last_ok(c));
}

// The launch's route: the rows map where the caller asks for it and every
// tensor is dense channels-last alike, and 16-byte loads where every
// pointer is aligned and the map's items are whole vectors.
struct Route {
  bool rows, vec;
  int blocks;
};

static Route route(int n, const Shape& s, const Shape* gs, int splits,
                   int channels_last, int bf16, const void* p0,
                   const void* p1, const void* p2) {
  const int w = bf16 ? 8 : 4;
  const bool rows =
      channels_last && dense_rows(n, s) && (!gs || dense_rows(n, *gs));
  bool vec = aligned(p0) && aligned(p1) && aligned(p2);
  if (rows)
    vec = vec && (s.m * s.c) % w == 0;
  else
    vec = vec && runs_vectorise(s, w) && (!gs || runs_vectorise(*gs, w));
  return {rows, vec, rows ? splits : s.c * splits};
}

extern "C" int gat_bn_moments(const void* x, int n, int c, int p,
                              long long sn, long long sc, long long sp,
                              int splits, float* part, int* ticket,
                              float* mean, float* sq, int bf16,
                              int channels_last, void* stream) {
  if (bad(n, c, p, splits, channels_last) || n < 1)
    return (int)cudaErrorInvalidValue;
  const Shape s{c, p, (long long)n * p, sn, sc, sp};
  const Route r = route(n, s, nullptr, splits, channels_last, bf16, x, x, x);
  auto kernel = BN_PICK(bn_moments_kernel, bf16, r.rows, r.vec);
  kernel<<<r.blocks, kThreads, 0, (cudaStream_t)stream>>>(
      x, s, splits, part, ticket, mean, sq);
  return (int)cudaGetLastError();
}

// y has x's strides. With n = 0 only the running statistics move.
extern "C" int gat_bn_apply(const void* x, void* y, int n, int c, int p,
                            long long sn, long long sc, long long sp,
                            int splits, const float* mean, const float* sq,
                            const float* weight, const float* bias, float eps,
                            float* running_mean, float* running_var,
                            float keep, float upd, int bf16, int channels_last,
                            void* stream) {
  if (bad(n, c, p, splits, channels_last)) return (int)cudaErrorInvalidValue;
  const Shape s{c, p, (long long)n * p, sn, sc, sp};
  const Route r = route(n, s, nullptr, splits, channels_last, bf16, x, y, y);
  auto kernel = BN_PICK(bn_apply_kernel, bf16, r.rows, r.vec);
  kernel<<<r.blocks, kThreads, 0, (cudaStream_t)stream>>>(
      x, y, s, splits, mean, sq, weight, bias, eps, running_mean, running_var,
      keep, upd);
  return (int)cudaGetLastError();
}

// dy with its own strides (gsn, gsc, gsp), x with (sn, sc, sp); with n = 0
// the sums are 0.
extern "C" int gat_bn_apply_grad(const void* dy, long long gsn, long long gsc,
                                 long long gsp, const void* x, int n, int c,
                                 int p, long long sn, long long sc,
                                 long long sp, int splits, const float* mean,
                                 const float* sq, const float* weight,
                                 float eps, float* part, int* ticket,
                                 float* dweight, float* dbias, float* dmean,
                                 float* dsq, float* mul, int bf16,
                                 int channels_last, void* stream) {
  if (bad(n, c, p, splits, channels_last)) return (int)cudaErrorInvalidValue;
  const long long m = (long long)n * p;
  const Shape gs{c, p, m, gsn, gsc, gsp}, s{c, p, m, sn, sc, sp};
  const Route r = route(n, s, &gs, splits, channels_last, bf16, x, dy, dy);
  auto kernel = BN_PICK(bn_apply_grad_kernel, bf16, r.rows, r.vec);
  kernel<<<r.blocks, kThreads, 0, (cudaStream_t)stream>>>(
      dy, gs, x, s, splits, mean, sq, weight, eps, part, ticket, dweight,
      dbias, dmean, dsq, mul);
  return (int)cudaGetLastError();
}

// dx has x's strides.
extern "C" int gat_bn_moments_grad(const void* dy, long long gsn,
                                   long long gsc, long long gsp,
                                   const void* x, void* dx, int n, int c,
                                   int p, long long sn, long long sc,
                                   long long sp, int splits, const float* mul,
                                   const float* dmean, const float* dsq,
                                   int bf16, int channels_last, void* stream) {
  if (bad(n, c, p, splits, channels_last) || n < 1)
    return (int)cudaErrorInvalidValue;
  const long long m = (long long)n * p;
  const Shape gs{c, p, m, gsn, gsc, gsp}, s{c, p, m, sn, sc, sp};
  const Route r = route(n, s, &gs, splits, channels_last, bf16, x, dy, dx);
  auto kernel = BN_PICK(bn_moments_grad_kernel, bf16, r.rows, r.vec);
  kernel<<<r.blocks, kThreads, 0, (cudaStream_t)stream>>>(
      dy, gs, x, dx, s, splits, mul, dmean, dsq);
  return (int)cudaGetLastError();
}
