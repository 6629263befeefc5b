// K12: optax's clip_by_global_norm followed by adamw, over the flat float32
// buffers of every parameter, its gradient and its two moments: two
// launches a step.
//
// Replaces the XLA program of gat_tpu/train/trainer.py:263-265, the global
// norm (optax.global_norm), then tx.update of optax.chain(
// clip_by_global_norm(max_norm), inject_hyperparams(adamw)(lr, wd))
// (:164-167) and optax.apply_updates, which XLA fused inside the training
// step. It replaces no Pallas kernel.
//
// gat_clip_norm (pass 1): norm = sqrt(sum g²) over the n gradients, as
// per-block partials and then the last block's sum of them in block order
// (a ticket taken with an integer atomic after a fence; no float
// atomics), so the norm does not depend on which block finishes when. The
// same last block adds 1 to the step count (optax's safe_int32_increment)
// and resets the ticket. No other block reads the count in that launch.
//
// gat_adamw_update (pass 2), each element, reading the norm, the count and
// the learning rate from device memory (a later step changes none of them
// on the host, so the step reads nothing back):
//   g   = g                      when norm < max_norm or clip is 0,
//         g / norm · max_norm    otherwise (optax's clip, in that order),
//                                and then written back, so the gradients
//                                hold the clipped values after the step
//   mu  = c1·g + b1·mu,  nu = c2·g² + b2·nu   (c = 1 - b)
//   u   = (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)
//   p   = p + (-lr)·(u + wd·p)   (decoupled decay on the old p)
// with c1, c2 given by the caller, as optax rounds them: 1 - b in float32
// of float32 hyperparameters (inject_hyperparams), or 1 - b of Python
// floats rounded to float32 (plain optax.adamw); every product and sum is
// rounded on its own
// (__fmul_rn, __fadd_rn) where optax's are separate XLA operations.
//
// What bounds it: bytes. Pass 1 reads g (4 bytes a parameter); pass 2
// reads p, g, mu, nu and writes p, mu, nu (28 bytes), and g where it
// clips (4 more). For the shipped CNN's 629,743 parameters that is 20.2 MB
// a step unclipped, 6.0 µs at 3.35 TB/s; the MLP's
// 20,143 parameters are a launch's latency. Both passes stride the flat
// buffers with a grid of at most kMaxBlocks blocks, fixed by n alone, so a
// pass is one launch whatever the model.
#include <cuda_runtime.h>

#include <cmath>

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 512;
constexpr int kPerThread = 8;  // elements a thread at least, below the cap

__host__ __device__ inline int clip_blocks(long long n) {
  const long long work = kThreads * kPerThread;
  const long long want = (n + work - 1) / work;
  return want < 1 ? 1 : (want > kMaxBlocks ? kMaxBlocks : (int)want);
}

__global__ void __launch_bounds__(kThreads)
    clip_norm_kernel(const float* __restrict__ g, long long n, float* part,
                     int* ticket, float* norm, int* count) {
  __shared__ float s_sum[kThreads];
  __shared__ int s_last;
  float acc = 0.0f;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const float v = g[i];
    acc = __fadd_rn(acc, __fmul_rn(v, v));
  }
  s_sum[threadIdx.x] = acc;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) s_sum[threadIdx.x] += s_sum[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    part[blockIdx.x] = s_sum[0];
    __threadfence();
    s_last = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  float t = 0.0f;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += kThreads)
    t += __ldcg(part + i);
  s_sum[threadIdx.x] = t;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) s_sum[threadIdx.x] += s_sum[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    *norm = sqrtf(s_sum[0]);
    const int k = *count;
    *count = k < 0x7fffffff ? k + 1 : k;
    *ticket = 0;
  }
}

__global__ void __launch_bounds__(kThreads)
    adamw_update_kernel(float* __restrict__ p, float* __restrict__ g,
                        float* __restrict__ mu, float* __restrict__ nu,
                        long long n, const float* norm_p, const int* count_p,
                        const float* lr_p, int clip, float max_norm, float b1,
                        float b2, float c1, float c2, float eps, float wd) {
  const float norm = *norm_p, neg_lr = -*lr_p;
  const float k = (float)*count_p;
  const bool scale = clip && !(norm < max_norm);
  const float bc1 = 1.0f - powf(b1, k), bc2 = 1.0f - powf(b2, k);
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    float gi = g[i];
    if (scale) {
      gi = __fmul_rn(gi / norm, max_norm);
      g[i] = gi;
    }
    const float m = __fadd_rn(__fmul_rn(c1, gi), __fmul_rn(b1, mu[i]));
    const float v =
        __fadd_rn(__fmul_rn(c2, __fmul_rn(gi, gi)), __fmul_rn(b2, nu[i]));
    const float u = (m / bc1) / __fadd_rn(sqrtf(v / bc2), eps);
    const float pi = p[i];
    p[i] = __fadd_rn(pi, __fmul_rn(neg_lr, __fadd_rn(u, __fmul_rn(wd, pi))));
    mu[i] = m;
    nu[i] = v;
  }
}

// The partial slots pass 1 needs over n gradients.
extern "C" int gat_clip_norm_blocks(long long n) {
  return n < 1 ? -1 : clip_blocks(n);
}

// Pass 1: g (n,) -> norm (1,), count (1,) int32 += 1; part holds
// gat_clip_norm_blocks(n) floats; ticket is one int, 0 before and after.
extern "C" int gat_clip_norm(const float* g, float* part, int* ticket,
                             float* norm, int* count, long long n,
                             void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int blocks = clip_blocks(n);
  clip_norm_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      g, n, part, ticket, norm, count);
  return (int)cudaGetLastError();
}

// Pass 2: p, mu, nu (n,) updated in place from g (n,) (clipped in place
// where the norm reaches max_norm), the norm and count
// of pass 1 and the learning rate lr (1,), all on the device; clip 0 skips
// the clip (plain adamw).
extern "C" int gat_adamw_update(float* p, float* g, float* mu,
                                float* nu, const float* norm,
                                const int* count, const float* lr,
                                long long n, int clip, float max_norm,
                                float b1, float b2, float c1, float c2,
                                float eps, float wd, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int blocks = clip_blocks(n);
  adamw_update_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      p, g, mu, nu, n, norm, count, lr, clip, max_norm, b1, b2, c1, c2, eps,
      wd);
  return (int)cudaGetLastError();
}
