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
// and 0.7 MB in bfloat16); forward reads x twice and writes y, backward
// reads dy and x twice and writes dx. The per-channel sums are split over
// the positions so that the card is filled (32 channels would make only
// 32 blocks): each block writes one partial a channel, and the last block
// to finish (a ticket taken with an integer atomic after a fence) adds
// them in block order, so the sums do not depend on which block finishes
// when (no float atomics), and resets the ticket to 0. Two thread maps,
// chosen by the caller for coalesced reads: for contiguous NCHW each block
// takes one channel and a range of positions, its threads on consecutive
// positions; for channels-last (stride(C) = 1, C dividing 256) each block
// takes a range of positions for every channel, thread t on channel
// t mod C, so a warp reads consecutive channels.
#include <cuda_runtime.h>

#include <cmath>

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 264;         // two a streaming multiprocessor
constexpr long long kBlockWork = 8192;  // elements a block, below the cap

struct Shape {
  int c, p;
  long long m, sn, sc, sp;  // M = N·P; strides in elements
};

__device__ __forceinline__ long long offset(const Shape& s, long long m,
                                            int c) {
  const long long n = m / s.p;
  return n * s.sn + c * s.sc + (m - n * s.p) * s.sp;
}

template <bool kBf16>
__device__ __forceinline__ float load(const void* base, long long i) {
  if (kBf16) {
    const unsigned h = static_cast<const unsigned short*>(base)[i];
    return __int_as_float((int)(h << 16));
  }
  return static_cast<const float*>(base)[i];
}

template <bool kBf16>
__device__ __forceinline__ void store(void* base, long long i, float v) {
  if (kBf16) {
    const unsigned u = (unsigned)__float_as_int(v);
    const unsigned h = (u & 0x7fffffffu) > 0x7f800000u
                           ? 0x7fc0u
                           : (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
    static_cast<unsigned short*>(base)[i] = (unsigned short)h;
  } else {
    static_cast<float*>(base)[i] = v;
  }
}

// This thread's channel and its positions [m, end) in steps of `step`.
struct Walk {
  int c, step;
  long long m, end;
};

template <bool kLast>
__device__ __forceinline__ Walk walk(const Shape& s, int splits) {
  const int t = threadIdx.x;
  if (kLast) {
    const long long sp = blockIdx.x;
    return {t % s.c, kThreads / s.c, s.m * sp / splits + t / s.c,
            s.m * (sp + 1) / splits};
  }
  const int c = blockIdx.x / splits;
  const long long sp = blockIdx.x % splits;
  return {c, kThreads, s.m * sp / splits + t, s.m * (sp + 1) / splits};
}

// The block's per-channel sums of v[q] into part[q·C·S + c·S + split];
// the writers fence their writes for the last block.
template <bool kLast, int NQ>
__device__ __forceinline__ void block_partials(const float (&v)[NQ],
                                               float* part, int c_all,
                                               int splits, int c) {
  __shared__ float red[NQ][kThreads];
  const int t = threadIdx.x;
  for (int q = 0; q < NQ; ++q) red[q][t] = v[q];
  __syncthreads();
  if (kLast) {
    if (t < c_all) {
      const int per = kThreads / c_all;
      for (int q = 0; q < NQ; ++q) {
        float acc = 0.0f;
        for (int k = 0; k < per; ++k) acc += red[q][k * c_all + t];
        part[(long long)q * c_all * splits + (long long)t * splits +
             blockIdx.x] = acc;
      }
      __threadfence();
    }
  } else {
    for (int w = kThreads / 2; w > 0; w >>= 1) {
      if (t < w)
        for (int q = 0; q < NQ; ++q) red[q][t] += red[q][t + w];
      __syncthreads();
    }
    if (t == 0) {
      for (int q = 0; q < NQ; ++q)
        part[(long long)q * c_all * splits + (long long)c * splits +
             blockIdx.x % splits] = red[q][0];
      __threadfence();
    }
  }
  __syncthreads();
}

// True in the last block of the launch to finish its partials.
__device__ __forceinline__ bool last_block(int* ticket) {
  __shared__ int s_last;
  if (threadIdx.x == 0)
    s_last = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
  __syncthreads();
  return s_last != 0;
}

// In the last block: each channel's partials added in split order (the
// threads of a channel take every per-th split, then their sums are added
// in thread order), handed to fin(c, sums); then the ticket reset.
template <int NQ, class Fin>
__device__ __forceinline__ void finalize(const float* part, int c_all,
                                         int splits, int* ticket, Fin fin) {
  __shared__ float red[NQ][kThreads];
  __threadfence();
  const int t = threadIdx.x;
  const int per = c_all >= kThreads ? 1 : kThreads / c_all;
  const int groups = kThreads / per;
  for (int c0 = 0; c0 < c_all; c0 += groups) {
    const int c = c0 + t / per, k = t % per;
    const bool mine = t < groups * per && c < c_all;
    float acc[NQ];
    for (int q = 0; q < NQ; ++q) {
      acc[q] = 0.0f;
      if (mine)
        for (int s = k; s < splits; s += per)
          acc[q] += __ldcg(part + (long long)q * c_all * splits +
                           (long long)c * splits + s);
      red[q][t] = acc[q];
    }
    __syncthreads();
    if (mine && k == 0) {
      float sums[NQ];
      for (int q = 0; q < NQ; ++q) {
        sums[q] = 0.0f;
        for (int j = 0; j < per; ++j) sums[q] += red[q][t + j];
      }
      fin(c, sums);
    }
    __syncthreads();
  }
  if (t == 0) *ticket = 0;
}

template <bool kBf16, bool kLast>
__global__ void __launch_bounds__(kThreads)
    bn_moments_kernel(const void* __restrict__ x, Shape s, int splits,
                      float* part, int* ticket, float* mean, float* sq) {
  const Walk w = walk<kLast>(s, splits);
  float v[2] = {0.0f, 0.0f};
  for (long long m = w.m; m < w.end; m += w.step) {
    const float a = load<kBf16>(x, offset(s, m, w.c));
    v[0] += a;
    v[1] += a * a;
  }
  block_partials<kLast>(v, part, s.c, splits, w.c);
  if (!last_block(ticket)) return;
  const float count = (float)s.m;
  finalize<2>(part, s.c, splits, ticket, [&](int c, const float* sums) {
    mean[c] = sums[0] / count;
    sq[c] = sums[1] / count;
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

template <bool kBf16, bool kLast>
__global__ void __launch_bounds__(kThreads)
    bn_apply_kernel(const void* __restrict__ x, void* __restrict__ y, Shape s,
                    int splits, const float* mean, const float* sq,
                    const float* weight, const float* bias, float eps,
                    float* running_mean, float* running_var, float keep,
                    float upd) {
  const Walk w = walk<kLast>(s, splits);
  const float mu = mean[w.c], b = bias[w.c];
  const Norm nm = norm_of(mu, sq[w.c], weight[w.c], eps);
  for (long long m = w.m; m < w.end; m += w.step) {
    const long long o = offset(s, m, w.c);
    const float a = load<kBf16>(x, o);
    store<kBf16>(y, o, __fadd_rn(__fmul_rn(__fsub_rn(a, mu), nm.mul), b));
  }
  const bool first = kLast ? blockIdx.x == 0 && threadIdx.x < s.c
                           : blockIdx.x % splits == 0 && threadIdx.x == 0;
  if (first) {
    running_mean[w.c] = __fadd_rn(__fmul_rn(keep, running_mean[w.c]),
                                  __fmul_rn(upd, mu));
    running_var[w.c] = __fadd_rn(__fmul_rn(keep, running_var[w.c]),
                                 __fmul_rn(upd, nm.var));
  }
}

template <bool kBf16, bool kLast>
__global__ void __launch_bounds__(kThreads)
    bn_apply_grad_kernel(const void* __restrict__ dy, Shape gs,
                         const void* __restrict__ x, Shape s, int splits,
                         const float* mean, const float* sq,
                         const float* weight, float eps, float* part,
                         int* ticket, float* dweight, float* dbias,
                         float* dmean, float* dsq, float* mul) {
  const Walk w = walk<kLast>(s, splits);
  const float mu = mean[w.c];
  float v[2] = {0.0f, 0.0f};
  for (long long m = w.m; m < w.end; m += w.step) {
    const float g = load<kBf16>(dy, offset(gs, m, w.c));
    const float a = load<kBf16>(x, offset(s, m, w.c));
    v[0] += g;
    v[1] += g * __fsub_rn(a, mu);
  }
  block_partials<kLast>(v, part, s.c, splits, w.c);
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

template <bool kBf16, bool kLast>
__global__ void __launch_bounds__(kThreads)
    bn_moments_grad_kernel(const void* __restrict__ dy, Shape gs,
                           const void* __restrict__ x, void* __restrict__ dx,
                           Shape s, int splits, const float* mul,
                           const float* dmean, const float* dsq) {
  const Walk w = walk<kLast>(s, splits);
  const float count = (float)s.m;
  const float k = mul[w.c], a0 = dmean[w.c] / count,
              a1 = __fmul_rn(2.0f, dsq[w.c] / count);
  for (long long m = w.m; m < w.end; m += w.step) {
    const long long o = offset(s, m, w.c);
    const float g = load<kBf16>(dy, offset(gs, m, w.c));
    const float a = load<kBf16>(x, o);
    store<kBf16>(dx, o,
                 __fadd_rn(__fadd_rn(__fmul_rn(g, k), a0), __fmul_rn(a, a1)));
  }
}

static bool channels_last_ok(int c) {
  return c >= 1 && c <= kThreads && kThreads % c == 0;
}

// The splits of the positions that a launch at C channels and M positions
// uses (its grid is C·splits blocks for NCHW, splits for channels-last),
// -1 where the map is refused (channels-last with C not dividing 256). The
// partial buffers hold 2·C·splits floats.
extern "C" int gat_bn_splits(int c, long long m, int channels_last) {
  if (c < 1 || m < 1 || (channels_last && !channels_last_ok(c))) return -1;
  long long blocks = (m * c + kBlockWork - 1) / kBlockWork;
  blocks = blocks < 1 ? 1 : (blocks > kMaxBlocks ? kMaxBlocks : blocks);
  if (channels_last) {
    const long long rows = kThreads / c;
    const long long most = (m + rows - 1) / rows;
    return (int)(blocks < most ? blocks : most);
  }
  long long s = (blocks + c - 1) / c;
  const long long most = (m + kThreads - 1) / kThreads;
  return (int)(s < most ? s : most);
}

static bool bad(int n, int c, int p, int splits, int channels_last) {
  return n < 0 || c < 1 || p < 1 || splits < 1 ||
         (channels_last && !channels_last_ok(c));
}

static int grid(int c, int splits, int channels_last) {
  return channels_last ? splits : c * splits;
}

extern "C" int gat_bn_moments(const void* x, int n, int c, int p,
                              long long sn, long long sc, long long sp,
                              int splits, float* part, int* ticket,
                              float* mean, float* sq, int bf16,
                              int channels_last, void* stream) {
  if (bad(n, c, p, splits, channels_last) || n < 1)
    return (int)cudaErrorInvalidValue;
  const Shape s{c, p, (long long)n * p, sn, sc, sp};
  auto kernel = bf16 ? (channels_last ? bn_moments_kernel<true, true>
                                      : bn_moments_kernel<true, false>)
                     : (channels_last ? bn_moments_kernel<false, true>
                                      : bn_moments_kernel<false, false>);
  const int blocks = grid(c, splits, channels_last);
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
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
  auto kernel = bf16 ? (channels_last ? bn_apply_kernel<true, true>
                                      : bn_apply_kernel<true, false>)
                     : (channels_last ? bn_apply_kernel<false, true>
                                      : bn_apply_kernel<false, false>);
  const int blocks = grid(c, splits, channels_last);
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
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
  auto kernel = bf16 ? (channels_last ? bn_apply_grad_kernel<true, true>
                                      : bn_apply_grad_kernel<true, false>)
                     : (channels_last ? bn_apply_grad_kernel<false, true>
                                      : bn_apply_grad_kernel<false, false>);
  const int blocks = grid(c, splits, channels_last);
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
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
  auto kernel = bf16 ? (channels_last ? bn_moments_grad_kernel<true, true>
                                      : bn_moments_grad_kernel<true, false>)
                     : (channels_last ? bn_moments_grad_kernel<false, true>
                                      : bn_moments_grad_kernel<false, false>);
  const int blocks = grid(c, splits, channels_last);
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      dy, gs, x, dx, s, splits, mul, dmean, dsq);
  return (int)cudaGetLastError();
}
