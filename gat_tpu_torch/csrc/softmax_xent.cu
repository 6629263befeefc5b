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
// What bounds it: at a training step (32 x 47) latency, one launch; at an
// eval chunk (65,536 x 47) the bytes, 12.3 MB read and, with the gradient,
// as much written. One warp takes a row: its lanes stride the classes,
// shuffles give the row's max and first argmax, the exponent sum and the
// loss, and the gradient is written as the logits were read. Eight rows a
// block; the block's loss and count go to a partial slot, and the last
// block to finish (a ticket taken with an integer atomic after a fence)
// adds the partials in block order, so the sum does not depend on which
// block finishes when: no float atomics. That block resets the ticket to
// 0 for the next launch on the stream.
#include <cuda_runtime.h>

#include <cmath>

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
  for (int d = 16; d >= 1; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

__global__ void __launch_bounds__(kThreads)
    softmax_xent_kernel(const float* __restrict__ logits,
                        const long long* __restrict__ labels,
                        float* __restrict__ grad, long long* __restrict__ pred,
                        float* part_loss, int* part_correct, int* ticket,
                        float* loss, long long* correct, int b, int c,
                        float alpha, float scale) {
  __shared__ float s_loss[kWarps];
  __shared__ int s_correct[kWarps];
  __shared__ float s_sum[kThreads];
  __shared__ int s_count[kThreads];
  __shared__ int s_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarps + warp;
  if (row < b) {
    const float* x = logits + (long long)row * c;
    float m = -INFINITY;
    int arg = 0x7fffffff;
    for (int j = lane; j < c; j += 32) {
      const float v = x[j];
      if (v > m || arg == 0x7fffffff) {
        m = v;
        arg = j;
      }
    }
    for (int d = 16; d >= 1; d >>= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, m, d);
      const int oa = __shfl_xor_sync(0xffffffffu, arg, d);
      if (om > m || (om == m && oa < arg)) {
        m = om;
        arg = oa;
      }
    }
    float s = 0.0f;
    for (int j = lane; j < c; j += 32) s += expf(__fsub_rn(x[j], m));
    s = warp_sum(s);
    const float log_s = logf(s);
    const long long y = labels[row];
    const float off = alpha / (float)c;
    const float on = __fadd_rn(1.0f - alpha, off);
    const float tsum = y >= 0 && y < c ? 1.0f : alpha;  // sum_j t_j
    float acc = 0.0f;
    for (int j = lane; j < c; j += 32) {
      const float d = __fsub_rn(x[j], m);
      const float t = j == y ? on : off;
      acc = __fadd_rn(acc, __fmul_rn(t, __fsub_rn(d, log_s)));
      if (grad != nullptr)
        grad[(long long)row * c + j] =
            __fmul_rn(__fsub_rn(__fmul_rn(expf(d) / s, tsum), t), scale);
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      s_loss[warp] = -acc;
      s_correct[warp] = arg == y;
      if (pred != nullptr) pred[row] = arg;
    }
  } else if (lane == 0) {
    s_loss[warp] = 0.0f;
    s_correct[warp] = 0;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.0f;
    int k = 0;
    for (int w = 0; w < kWarps; ++w) {
      t += s_loss[w];
      k += s_correct[w];
    }
    part_loss[blockIdx.x] = t;
    part_correct[blockIdx.x] = k;
    __threadfence();
    s_last = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  // the last block: the partials in block order, then a fixed tree
  __threadfence();
  float t = 0.0f;
  int k = 0;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += kThreads) {
    t += __ldcg(part_loss + i);
    k += __ldcg(part_correct + i);
  }
  s_sum[threadIdx.x] = t;
  s_count[threadIdx.x] = k;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) {
      s_sum[threadIdx.x] += s_sum[threadIdx.x + w];
      s_count[threadIdx.x] += s_count[threadIdx.x + w];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    *loss = __fmul_rn(s_sum[0], scale);
    *correct = s_count[0];
    *ticket = 0;
  }
}

// The partial slots a launch over b rows needs (floats, and as many ints).
extern "C" int gat_softmax_xent_blocks(int b) {
  return b < 1 ? -1 : (b + kWarps - 1) / kWarps;
}

// logits (b, c) float32 row-major, labels (b,) int64 -> loss (1,) float32,
// correct (1,) int64; grad (b, c) float32 and pred (b,) int64 may be null.
// part_loss and part_correct hold gat_softmax_xent_blocks(b) slots; ticket
// is one int, 0 before the launch and after it.
extern "C" int gat_softmax_xent(const float* logits, const long long* labels,
                                float* grad, long long* pred, float* part_loss,
                                int* part_correct, int* ticket, float* loss,
                                long long* correct, int b, int c, float alpha,
                                float scale, void* stream) {
  if (b < 1 || c < 1) return (int)cudaErrorInvalidValue;
  const int blocks = gat_softmax_xent_blocks(b);
  softmax_xent_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      logits, labels, grad, pred, part_loss, part_correct, ticket, loss,
      correct, b, c, alpha, scale);
  return (int)cudaGetLastError();
}
