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
// a step unclipped, 6.0 µs at 3.35 TB/s; the MLP's 20,143 parameters are
// a launch's latency. So each pass is one round of loads where it can be:
// - 16-byte loads (float4 of p, g, mu, nu) where every pointer is 16-byte
//   aligned, as `ClipAdamW`'s fresh flat buffers are, with the n mod 4
//   last elements taken one by one by block 0 in the same launch; an
//   unaligned view takes the same kernel's route of one element a load;
// - each thread issues all its loads of a round (pass 1: kNormUnroll
//   vectors; pass 2: kUpdateUnroll vectors of each of the four buffers)
//   before it uses any;
// - the grid is sized to the card (`clip_blocks`): as many blocks as take
//   one round of loads, at least one an SM while each thread still has a
//   load, at most what the SMs hold at once (their resident blocks from
//   the CUDA runtime), so the MLP's pass 2 is one round over 20 blocks;
// - pass 1's per-block sums (warp shuffles, then the warps in order) are
//   added by the last block with all its threads, a slice of the blocks
//   each in block order, then the same block sum: a fixed order, so two
//   runs give the same norm.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <mutex>

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNormUnroll = 4;    // float4 loads of g a thread in flight
constexpr int kUpdateUnroll = 2;  // float4 loads of each buffer a thread

// kW consecutive floats from index i of a buffer of items of kW floats.
template <int kW>
__device__ __forceinline__ void load_item(const float* base, long long i,
                                          float (&v)[4]) {
  if constexpr (kW == 4) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(base) + i);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  } else {
    v[0] = base[i];
  }
}

template <int kW>
__device__ __forceinline__ void store_item(float* base, long long i,
                                           const float (&v)[4]) {
  if constexpr (kW == 4) {
    float4 f;
    f.x = v[0];
    f.y = v[1];
    f.z = v[2];
    f.w = v[3];
    reinterpret_cast<float4*>(base)[i] = f;
  } else {
    base[i] = v[0];
  }
}

// The block's sum of v, in thread 0 (warp shuffles, then the warps in
// order); every thread of the block calls it.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warps[kWarps];
  for (int off = 16; off >= 1; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = v;
  __syncthreads();
  float sum = 0.0f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) sum += warps[w];
  __syncthreads();
  return sum;
}

template <int kW>
__global__ void __launch_bounds__(kThreads)
    clip_norm_kernel(const float* __restrict__ g, long long n, float* part,
                     int* ticket, float* norm, int* count) {
  __shared__ int s_last;
  const int t = threadIdx.x;
  const long long items = n / kW;
  float acc = 0.0f;
  for (long long base = (long long)blockIdx.x * kThreads * kNormUnroll + t;
       base < items; base += (long long)gridDim.x * kThreads * kNormUnroll) {
    float v[kNormUnroll][4];
    for (int j = 0; j < kNormUnroll; ++j) {
      const long long i = base + (long long)j * kThreads;
      for (int k = 0; k < 4; ++k) v[j][k] = 0.0f;
      if (i < items) load_item<kW>(g, i, v[j]);
    }
    for (int j = 0; j < kNormUnroll; ++j)
      for (int k = 0; k < kW; ++k)
        acc = __fadd_rn(acc, __fmul_rn(v[j][k], v[j][k]));
  }
  if (blockIdx.x == 0 && t < n - items * kW) {  // the n mod 4 last ones
    const float v = g[items * kW + t];
    acc = __fadd_rn(acc, __fmul_rn(v, v));
  }
  const float sum = block_sum(acc);
  if (t == 0) {
    part[blockIdx.x] = sum;
    __threadfence();
    s_last = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
    if (s_last) __threadfence();
  }
  __syncthreads();
  if (!s_last) return;
  float total = 0.0f;
  for (int i = t; i < (int)gridDim.x; i += kThreads) total += __ldcg(part + i);
  total = block_sum(total);
  if (t == 0) {
    *norm = sqrtf(total);
    const int k = *count;
    *count = k < 0x7fffffff ? k + 1 : k;
    *ticket = 0;
  }
}

// One parameter's step (optax's clip, moments, bias corrections and
// decoupled decay), every product and sum rounded on its own.
struct AdamStep {
  bool scale;
  float norm, max_norm, neg_lr, b1, b2, c1, c2, bc1, bc2, eps, wd;
  __device__ __forceinline__ void operator()(float& pi, float& gi, float& mi,
                                             float& vi) const {
    if (scale) gi = __fmul_rn(gi / norm, max_norm);
    const float m = __fadd_rn(__fmul_rn(c1, gi), __fmul_rn(b1, mi));
    const float v =
        __fadd_rn(__fmul_rn(c2, __fmul_rn(gi, gi)), __fmul_rn(b2, vi));
    const float u = (m / bc1) / __fadd_rn(sqrtf(v / bc2), eps);
    pi = __fadd_rn(pi, __fmul_rn(neg_lr, __fadd_rn(u, __fmul_rn(wd, pi))));
    mi = m;
    vi = v;
  }
};

template <int kW>
__global__ void __launch_bounds__(kThreads)
    adamw_update_kernel(float* __restrict__ p, float* __restrict__ g,
                        float* __restrict__ mu, float* __restrict__ nu,
                        long long n, const float* norm_p, const int* count_p,
                        const float* lr_p, int clip, float max_norm, float b1,
                        float b2, float c1, float c2, float eps, float wd) {
  const float norm = *norm_p;
  const float k = (float)*count_p;
  const AdamStep step{clip && !(norm < max_norm), norm, max_norm, -*lr_p,
                      b1, b2, c1, c2, 1.0f - powf(b1, k), 1.0f - powf(b2, k),
                      eps, wd};
  const int t = threadIdx.x;
  const long long items = n / kW;
  for (long long base = (long long)blockIdx.x * kThreads * kUpdateUnroll + t;
       base < items;
       base += (long long)gridDim.x * kThreads * kUpdateUnroll) {
    float P[kUpdateUnroll][4], G[kUpdateUnroll][4], M[kUpdateUnroll][4],
        V[kUpdateUnroll][4];
    bool ok[kUpdateUnroll];
    for (int j = 0; j < kUpdateUnroll; ++j) {
      const long long i = base + (long long)j * kThreads;
      ok[j] = i < items;
      if (ok[j]) {
        load_item<kW>(p, i, P[j]);
        load_item<kW>(g, i, G[j]);
        load_item<kW>(mu, i, M[j]);
        load_item<kW>(nu, i, V[j]);
      }
    }
    for (int j = 0; j < kUpdateUnroll; ++j) {
      if (!ok[j]) continue;
      const long long i = base + (long long)j * kThreads;
      for (int e = 0; e < kW; ++e) step(P[j][e], G[j][e], M[j][e], V[j][e]);
      store_item<kW>(p, i, P[j]);
      if (step.scale) store_item<kW>(g, i, G[j]);
      store_item<kW>(mu, i, M[j]);
      store_item<kW>(nu, i, V[j]);
    }
  }
  if (blockIdx.x == 0 && t < n - items * kW) {  // the n mod 4 last ones
    const long long i = items * kW + t;
    float pi = p[i], gi = g[i], mi = mu[i], vi = nu[i];
    step(pi, gi, mi, vi);
    p[i] = pi;
    if (step.scale) g[i] = gi;
    mu[i] = mi;
    nu[i] = vi;
  }
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
  static Entry seen[16];
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
  if (n_seen < 16) seen[n_seen++] = {device, (const void*)kernel, *blocks};
  return 0;
}

// The blocks of a pass over n parameters taking `unroll` float4 loads of a
// buffer a thread a round, on `sms` SMs holding `per_sm` blocks each.
static long long clip_blocks(long long n, int unroll, int sms, int per_sm) {
  const long long items = (n + 3) / 4;
  const long long once = (items + kThreads * unroll - 1) / (kThreads * unroll);
  const long long each = (items + kThreads - 1) / kThreads;
  long long blocks = once > sms ? once : (each < sms ? each : sms);
  const long long most = (long long)sms * per_sm;
  blocks = blocks > most ? most : blocks;
  return blocks < 1 ? 1 : blocks;
}

// The grids of both passes over n parameters on the current device:
// out[0] pass 1's blocks (the partial slots it needs), out[1] its resident
// blocks per SM, out[2] pass 2's blocks, out[3] its resident blocks per SM.
extern "C" int gat_clip_adamw_grid(long long n, int* out) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0;
  int err = (int)cudaGetDevice(&device);
  if (!err)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      device);
  if (!err) err = resident(clip_norm_kernel<4>, out + 1);
  if (!err) err = resident(adamw_update_kernel<4>, out + 3);
  if (err) return err;
  out[0] = (int)clip_blocks(n, kNormUnroll, sms, out[1]);
  out[2] = (int)clip_blocks(n, kUpdateUnroll, sms, out[3]);
  return 0;
}

static bool aligned(const void* ptr) {
  return ((uintptr_t)ptr & 15u) == 0;
}

// Pass 1: g (n,) -> norm (1,), count (1,) int32 += 1, over `blocks` blocks
// (gat_clip_adamw_grid's out[0]); part holds `blocks` floats; ticket is
// one int, 0 before and after.
extern "C" int gat_clip_norm(const float* g, float* part, int blocks,
                             int* ticket, float* norm, int* count,
                             long long n, void* stream) {
  if (n < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  auto kernel = aligned(g) ? clip_norm_kernel<4> : clip_norm_kernel<1>;
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(g, n, part, ticket,
                                                        norm, count);
  return (int)cudaGetLastError();
}

// Pass 2 over `blocks` blocks (gat_clip_adamw_grid's out[2]): p, mu, nu
// (n,) updated in place from g (n,) (clipped in place where the norm
// reaches max_norm), the norm and count of pass 1 and the learning rate lr
// (1,), all on the device; clip 0 skips the clip (plain adamw).
extern "C" int gat_adamw_update(float* p, float* g, float* mu,
                                float* nu, const float* norm,
                                const int* count, const float* lr,
                                long long n, int blocks, int clip,
                                float max_norm, float b1, float b2, float c1,
                                float c2, float eps, float wd, void* stream) {
  if (n < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  auto kernel = aligned(p) && aligned(g) && aligned(mu) && aligned(nu)
                    ? adamw_update_kernel<4>
                    : adamw_update_kernel<1>;
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      p, g, mu, nu, n, norm, count, lr, clip, max_norm, b1, b2, c1, c2, eps,
      wd);
  return (int)cudaGetLastError();
}
