// K11: the label-smoothed softmax cross entropy of a batch of logits, its
// correct count and its gradient, in one launch.
//
// Replaces the XLA program of gat_tpu/train/trainer.py:250-253 (`_loss`:
// optax.smooth_labels + softmax_cross_entropy, then the mean) and :266
// (`correct`: argmax == y), which XLA fused inside the training step and
// the eval step. It replaces no Pallas kernel.
//
// For row i of logits x (b, c) float32 and label y_i, with the smoothed
// target t_j = (1 - alpha)·[j == y_i] + alpha / c (optax.smooth_labels; a
// label outside [0, c) gives t_j = alpha / c, as jax.nn.one_hot does):
//   m     = max_j x_ij, and the argmax the first j that reaches it
//   s     = sum_j exp(x_ij - m)
//   lp_j  = (x_ij - m) - log(s)                  (log_softmax)
//   loss  = scale · sum_i ( -sum_j t_j · lp_j )
//   grad  = scale · (exp(x_ij - m) / s · T - t_j) (when grad is not null;
//           T = sum_j t_j, 1 for a label in range, else alpha)
//   correct = #{i : argmax_i == y_i}, pred_i = argmax_i (when pred is not
//   null).
// One `scale` serves the mean (1/b), the eval's sum (1) and a data-parallel
// rank's share of the global mean (1/n for its k of the global n rows).
//
// What bounds it: at a training step (32 x 47) the launch's latency; at an
// eval chunk (65,536 x 47) the bytes, 12.3 MB read once. The design:
// - Each logit is read from device memory once. A block stages tiles of
//   `rows` rows flat into shared memory by 16-byte cp.async (4-byte copies
//   where the logits do not start on 16 bytes: the element route of the
//   same kernel), with the tile's labels, in a ring of kStages buffers:
//   the next tiles' copies are in flight while this one is reduced.
// - A group of `lanes` lanes (a power of two, 1 to 32) takes a row: each
//   lane loads its classes j = lane, lane + lanes, ... from shared memory
//   into registers at once (kE of them at most, a template: 4, 8, 16 or
//   32), and the row's max and first argmax, its exponents, their sum,
//   the sum of d_j = x_j - m and the gradient come from those registers,
//   each sum a fixed pairwise tree over the lane's classes and a shuffle
//   tree over the group; the loss is -(off · (sum_j d_j - c · log s) +
//   (on - off) · (d_y - log s)), x_y read once a row. As many lanes a row
//   as keep a lane to 8 classes (8 at 47 classes: 32 rows a tile), more
//   for a batch smaller than the block's threads.
// - The gradient is written into the tile in place and leaves it in
//   16-byte stores; the argmaxes go out as consecutive int64s.
// - Two forms, chosen on the host by gat_softmax_xent_grid from the SM
//   count and the occupancy the CUDA runtime reports: a batch of at most
//   kOneBlockTiles tiles is one block, which adds its rows' losses and
//   counts and writes the results itself (no partials, no fence, no
//   ticket: the training step and the validation sets); a larger batch
//   runs on a grid sized to the card, each block a contiguous span of
//   tiles and one partial, and the last block to finish (an integer ticket
//   after a fence) adds the partials with all its threads in one round of
//   loads.
// - Every sum has a fixed order: a lane's classes in a pairwise tree, the
//   group's shuffle tree, a thread's rows in order, the warp's shuffle
//   tree, the warps in order, the partials in slot order. Two runs give
//   the same bits, and no float atomic is used.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <mutex>

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kOneBlockTiles = 2;   // tiles a batch of the one-block form
constexpr int kStages = 2;          // tiles a block has in shared memory
constexpr int kLaneClasses = 8;     // classes a lane, where lanes allow
constexpr int kMaxClasses = 1024;   // 32 lanes of 32 classes
constexpr int kMaxShared = 227 * 1024 - 1024;  // dynamic bytes a block
constexpr int kMaxRounds = 8;       // the last block's loads of partials
constexpr unsigned kFull = 0xffffffffu;

// Floats of one buffer: the tile's rows x c logits, padded to 16 bytes,
// then its rows int64 labels.
__host__ __device__ inline int tile_pad(int rows, int c) {
  return (rows * c + 3) & ~3;
}
__host__ __device__ inline int buffer_floats(int rows, int c) {
  return tile_pad(rows, c) + 2 * rows;
}

// Tile k's logits and labels into the buffer at xs by cp.async: 16 bytes a
// copy (kVec) or 4, the labels 8.
template <bool kVec>
__device__ __forceinline__ void stage(const float* __restrict__ logits,
                                      const long long* __restrict__ labels,
                                      float* xs, int b, int c, int rows,
                                      int k) {
  const int t = threadIdx.x;
  const int row0 = k * rows, n = b - row0 < rows ? b - row0 : rows;
  const int nf = n * c;
  const float* src = logits + (long long)row0 * c;
  int i0 = 0;
  if (kVec) {
    for (int i = t; i < nf >> 2; i += kThreads)
      __pipeline_memcpy_async(xs + 4 * i, src + 4 * i, 16);
    i0 = nf & ~3;
  }
  for (int i = i0 + t; i < nf; i += kThreads)
    __pipeline_memcpy_async(xs + i, src + i, 4);
  long long* ys = reinterpret_cast<long long*>(xs + tile_pad(rows, c));
  for (int i = t; i < n; i += kThreads)
    __pipeline_memcpy_async(ys + i, labels + row0 + i, 8);
}

// v summed over the group of `lanes` lanes (a shuffle tree).
__device__ __forceinline__ float group_sum(float v, int lanes) {
  for (int d = lanes >> 1; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

// The block's sums of v and k, in thread 0: the warp's shuffle tree, then
// the warps in order. Every thread of the block calls it.
__device__ __forceinline__ void block_sums(float& v, int& k, float* s_v,
                                           int* s_k) {
  for (int d = 16; d > 0; d >>= 1) {
    v += __shfl_xor_sync(kFull, v, d);
    k += __shfl_xor_sync(kFull, k, d);
  }
  if ((threadIdx.x & 31) == 0) {
    s_v[threadIdx.x >> 5] = v;
    s_k[threadIdx.x >> 5] = k;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    v = 0.0f;
    k = 0;
    for (int w = 0; w < kWarps; ++w) {
      v += s_v[w];
      k += s_k[w];
    }
  }
}

// a[0] + ... + a[N - 1] in a fixed pairwise tree (N a power of two): the
// upper half added to the lower, level by level, each level a loop of a
// known length, so that the array stays in registers.
template <int N, int W = N / 2>
__device__ __forceinline__ float tree_sum(float (&a)[N]) {
#pragma unroll
  for (int i = 0; i < W; ++i) a[i] = __fadd_rn(a[i], a[i + W]);
  if constexpr (W > 1)
    return tree_sum<N, W / 2>(a);
  else
    return a[0];
}

template <bool kVec, int kE>
__global__ void __launch_bounds__(kThreads)
    softmax_xent_kernel(const float* __restrict__ logits,
                        const long long* __restrict__ labels,
                        float* __restrict__ grad, long long* __restrict__ pred,
                        float* part_loss, int* part_correct, int* ticket,
                        float* loss, long long* correct, int b, int c,
                        int rows, int lanes, float alpha, float scale) {
  extern __shared__ float smem[];
  __shared__ float s_loss[kWarps];
  __shared__ int s_count[kWarps];
  __shared__ int s_last;
  const int t = threadIdx.x, lg = __ffs(lanes) - 1;  // lanes = 2^lg
  const int groups = kThreads >> lg, g = t >> lg, l = t & (lanes - 1);
  const int pad = tile_pad(rows, c), buf = buffer_floats(rows, c);
  const int tiles = (b + rows - 1) / rows;
  // this block's contiguous span of tiles
  const int span = tiles / (int)gridDim.x, extra = tiles % (int)gridDim.x;
  const int bid = blockIdx.x;
  const int first = bid * span + (bid < extra ? bid : extra);
  const int end = first + span + (bid < extra);
  const float off = alpha / (float)c;
  const float on = __fadd_rn(1.0f - alpha, off);
  float acc_loss = 0.0f;
  int acc_count = 0;
  for (int q = 0; q < kStages - 1; ++q) {  // the first tiles in flight
    if (first + q < end)
      stage<kVec>(logits, labels, smem + q * buf, b, c, rows, first + q);
    __pipeline_commit();
  }
  for (int k = first; k < end; ++k) {
    float* xs = smem + (k - first) % kStages * buf;
    const int ahead = k + kStages - 1;  // into the buffer freed last round
    if (ahead < end)
      stage<kVec>(logits, labels, smem + (ahead - first) % kStages * buf, b,
                  c, rows, ahead);
    __pipeline_commit();
    __pipeline_wait_prior(kStages - 1);  // tile k has landed
    __syncthreads();
    const long long* ys = reinterpret_cast<const long long*>(xs + pad);
    const int row0 = k * rows, n = b - row0 < rows ? b - row0 : rows;
    for (int r0 = 0; r0 < n; r0 += groups) {  // uniform over the block
      const int r = r0 + g;
      const bool valid = r < n;
      const int cc = valid ? c : 0;  // an idle group reads nothing
      float* x = xs + (valid ? r : 0) * c;
      float v[kE];
#pragma unroll
      for (int q = 0; q < kE; ++q) {
        const int j = l + q * lanes;
        v[q] = j < cc ? x[j] : -INFINITY;
      }
      const long long y = ys[valid ? r : 0];
      const bool hit = y >= 0 && y < c;
      const float xy = hit && valid ? x[y] : 0.0f;  // read before any write
      // the max and the first argmax: the lane's classes in order (its
      // first taken as it is), then the group's shuffle tree
      float m = v[0];
      int arg = l < cc ? l : 0x7fffffff;
#pragma unroll
      for (int q = 1; q < kE; ++q)
        if (v[q] > m) {
          m = v[q];
          arg = l + q * lanes;
        }
      for (int d = lanes >> 1; d > 0; d >>= 1) {
        const float om = __shfl_xor_sync(kFull, m, d);
        const int oa = __shfl_xor_sync(kFull, arg, d);
        if (om > m || (om == m && oa < arg)) {
          m = om;
          arg = oa;
        }
      }
      // the exponents, their sum and the sum of d_j = x_j - m
      float e[kE], es[kE], ds[kE];
#pragma unroll
      for (int q = 0; q < kE; ++q) {  // past the row: v = -inf, e = 0
        const float d = __fsub_rn(v[q], m);
        e[q] = expf(d);
        es[q] = e[q];
        ds[q] = l + q * lanes < cc ? d : 0.0f;
      }
      const float s = group_sum(tree_sum(es), lanes);
      const float sum_d = group_sum(tree_sum(ds), lanes);
      const float log_s = logf(s);
      // -sum_j t_j (d_j - log s) = -(off · sum_j (d_j - log s)
      //                              + (on - off) · (d_y - log s))
      const float all = __fsub_rn(sum_d, __fmul_rn((float)c, log_s));
      const float dy = __fsub_rn(__fsub_rn(xy, m), log_s);
      const float acc = __fadd_rn(__fmul_rn(off, all),
                                  hit ? __fmul_rn(__fsub_rn(on, off), dy)
                                      : 0.0f);
      if (grad != nullptr) {
        const float tsum = hit ? 1.0f : alpha;  // sum_j t_j
#pragma unroll
        for (int q = 0; q < kE; ++q) {
          const int j = l + q * lanes;
          if (j < cc)  // in place: this lane alone read x[j]
            x[j] = __fmul_rn(
                __fsub_rn(__fmul_rn(e[q] / s, tsum), j == y ? on : off),
                scale);
        }
      }
      if (valid && l == 0) {
        acc_loss = __fadd_rn(acc_loss, -acc);
        acc_count += arg == y;
        if (pred != nullptr) pred[row0 + r] = arg;
      }
    }
    if (grad != nullptr) {  // the tile's gradient, out of shared memory
      __syncthreads();
      const int nf = n * c;
      float* dst = grad + (long long)row0 * c;
      int i0 = 0;
      if (kVec) {
        for (int i = t; i < nf >> 2; i += kThreads)
          reinterpret_cast<float4*>(dst)[i] =
              reinterpret_cast<const float4*>(xs)[i];
        i0 = nf & ~3;
      }
      for (int i = i0 + t; i < nf; i += kThreads) dst[i] = xs[i];
    }
    __syncthreads();  // the buffer is free for tile k + kStages
  }

  float v = acc_loss;
  int cnt = acc_count;
  block_sums(v, cnt, s_loss, s_count);
  if (gridDim.x == 1) {  // the one-block form writes the results itself
    if (t == 0) {
      *loss = __fmul_rn(v, scale);
      *correct = cnt;
    }
    return;
  }
  if (t == 0) {
    part_loss[blockIdx.x] = v;
    part_correct[blockIdx.x] = cnt;
    __threadfence();
    s_last = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  // the last block: every thread its slots t, t + kThreads, ... loaded in
  // one round, added in slot order, then the block's sum
  __threadfence();
  float pv[kMaxRounds];
  int pk[kMaxRounds];
#pragma unroll
  for (int q = 0; q < kMaxRounds; ++q) {
    const int i = t + q * kThreads;
    pv[q] = i < (int)gridDim.x ? __ldcg(part_loss + i) : 0.0f;
    pk[q] = i < (int)gridDim.x ? __ldcg(part_correct + i) : 0;
  }
  v = 0.0f;
  cnt = 0;
#pragma unroll
  for (int q = 0; q < kMaxRounds; ++q) {
    v += pv[q];
    cnt += pk[q];
  }
  block_sums(v, cnt, s_loss, s_count);
  if (t == 0) {
    *loss = __fmul_rn(v, scale);
    *correct = cnt;
    *ticket = 0;
  }
}

// The lanes a row of c classes takes on the grid form: the power of two
// that keeps a lane to kLaneClasses classes, at most 32.
static int row_lanes(int c) {
  int lanes = 1;
  while (lanes < 32 && lanes * kLaneClasses < c) lanes <<= 1;
  return lanes;
}

// The instance whose lanes hold ceil(c / lanes) classes: kE 4, 8, 16 or 32.
using Kernel = void (*)(const float*, const long long*, float*, long long*,
                        float*, int*, int*, float*, long long*, int, int, int,
                        int, float, float);
static Kernel kernel_for(bool vec, int c, int lanes) {
  const int per = (c + lanes - 1) / lanes;
  if (per <= 4)
    return vec ? softmax_xent_kernel<true, 4> : softmax_xent_kernel<false, 4>;
  if (per <= 8)
    return vec ? softmax_xent_kernel<true, 8> : softmax_xent_kernel<false, 8>;
  if (per <= 16)
    return vec ? softmax_xent_kernel<true, 16>
               : softmax_xent_kernel<false, 16>;
  return vec ? softmax_xent_kernel<true, 32> : softmax_xent_kernel<false, 32>;
}

static std::mutex grid_lock;

// Resident blocks per SM of `kernel` at `bytes` of dynamic shared memory
// on `device`, remembered per (device, kernel, bytes); at least 1. The
// first query on a device raises every instance's shared-memory attribute
// to the most a layout takes.
static int resident(int device, Kernel kernel, int bytes, int* blocks) {
  struct Entry {
    int device;
    Kernel kernel;
    int bytes, blocks;
  };
  static Entry seen[64];
  static int n_seen = 0;
  static int attr_set[64];
  static int n_attr = 0;
  std::lock_guard<std::mutex> guard(grid_lock);
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].device == device && seen[i].kernel == kernel &&
        seen[i].bytes == bytes) {
      *blocks = seen[i].blocks;
      return 0;
    }
  bool set = false;
  for (int i = 0; i < n_attr; ++i) set = set || attr_set[i] == device;
  int err = 0;
  if (!set) {
    for (const bool vec : {true, false})
      for (const int per : {4, 8, 16, 32})  // classes a lane
        if (!err)
          err = (int)cudaFuncSetAttribute(
              kernel_for(vec, per, 1),
              cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxShared);
    if (err) return err;
    if (n_attr < 64) attr_set[n_attr++] = device;
  }
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                           kThreads, bytes);
  if (err) return err;
  if (*blocks < 1) *blocks = 1;
  if (n_seen < 64) seen[n_seen++] = {device, kernel, bytes, *blocks};
  return 0;
}

// K11's launch over b rows of c classes on the current device: out[0] the
// blocks (and partial slots: none at 1), out[1] resident blocks per SM,
// out[2] rows a tile (one a group of lanes), out[3] lanes a row, out[4]
// dynamic shared bytes. A batch of at most kOneBlockTiles tiles is one
// block, its lanes widened (up to 32) while the batch fills under half of
// its groups; a larger one takes min(tiles, SMs x resident blocks).
extern "C" int gat_softmax_xent_grid(int b, int c, int* out) {
  if (b < 1 || c < 1 || c > kMaxClasses) return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0;
  int err = (int)cudaGetDevice(&device);
  if (!err)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      device);
  if (err) return err;
  int lanes = row_lanes(c);
  const long long tiles = ((long long)b + kThreads / lanes - 1) /
                          (kThreads / lanes);
  long long blocks = 1;
  if (tiles <= kOneBlockTiles)
    while (lanes < 32 && (long long)(kThreads / lanes) >= 2LL * b) lanes <<= 1;
  const int rows = kThreads / lanes;
  const int bytes = 4 * kStages * buffer_floats(rows, c);
  err = resident(device, kernel_for(true, c, lanes), bytes, out + 1);
  if (err) return err;
  if (tiles > kOneBlockTiles) {
    blocks = (long long)sms * out[1];
    if (blocks > tiles) blocks = tiles;
    if (blocks > kThreads * kMaxRounds) blocks = kThreads * kMaxRounds;
  }
  out[0] = (int)blocks;
  out[2] = rows;
  out[3] = lanes;
  out[4] = bytes;
  return 0;
}

static bool aligned(const void* ptr) {
  return ((uintptr_t)ptr & 15u) == 0;
}

// logits (b, c) float32 row-major, labels (b,) int64 -> loss (1,) float32,
// correct (1,) int64; grad (b, c) float32 and pred (b,) int64 may be null.
// blocks, rows and lanes are gat_softmax_xent_grid's out[0], out[2] and
// out[3]; at more than one block part_loss and part_correct hold `blocks`
// slots and ticket is one int, 0 before the launch and after it (at one
// block none of the three is touched).
extern "C" int gat_softmax_xent(const float* logits, const long long* labels,
                                float* grad, long long* pred, float* part_loss,
                                int* part_correct, int* ticket, float* loss,
                                long long* correct, int b, int c, float alpha,
                                float scale, int blocks, int rows, int lanes,
                                void* stream) {
  if (b < 1 || c < 1 || c > kMaxClasses || blocks < 1 ||
      blocks > kThreads * kMaxRounds || rows < 4 || rows % 4 != 0 ||
      lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0 ||
      (c + lanes - 1) / lanes > 32 || 4 * kStages * buffer_floats(rows, c) > kMaxShared ||
      (blocks > 1 && (part_loss == nullptr || part_correct == nullptr ||
                      ticket == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int bytes = 4 * kStages * buffer_floats(rows, c);
  const Kernel kernel = kernel_for(
      aligned(logits) && (grad == nullptr || aligned(grad)), c, lanes);
  kernel<<<blocks, kThreads, bytes, (cudaStream_t)stream>>>(
      logits, labels, grad, pred, part_loss, part_correct, ticket, loss,
      correct, b, c, rows, lanes, alpha, scale);
  return (int)cudaGetLastError();
}
