// K7: the noise gate of whole files, y (B, n) -> gated (B, n), with an
// optional (B,) count of valid samples per row.
//
// Replaces the JAX package's XLA program gat_tpu/segment/gating.py:154
// gate_waveform (sample_db_gate, then rms_gate :114 with rms_db_envelope
// :36, dynamic_thresholds :98 and filters.py:79 masked_percentile), and
// the separate length mask the file body applied before it. It replaces
// no Pallas kernel: the reference never wrote one for the gates. Per row,
// with nv its valid count (n when none is given):
//   1. the sample gate: y · [20·log10(|y| + 1e-10) > min_db], the same
//      formula as the reference (a precomputed amplitude threshold would
//      flip a sample at the threshold);
//   2. the frame RMS in dB at frame 2048, centred, reflect-padded, over
//      the row extended as rms_db_envelope extends it: the valid samples,
//      then the mirror of the valid end written into [nv, nv + 1024)
//      (ye[nv + j] = y[nv - 2 - j], zero below sample 0), then zeros;
//      frames t < 1 + n / hop;
//   3. the 5-wide median with symmetric edges, over the envelope extended
//      by two frames whose values at nvf = 1 + nv / hop and nvf + 1 are
//      the envelope's frames nvf - 1 and nvf - 2 (zero below frame 0);
//   4. the 20th percentile of the smoothed frames t < nvf, linear between
//      order statistics and never interpolating past the valid frames,
//      plus 6 dB: gate_db; each frame passes when its smoothed dB is above;
//   5. gated = y · sample gate · frame gate[i / hop] · [i < nv].
// Without a count (nv = n) this is the reference's unmasked rms_gate, for
// every n it takes (n > 1024): its reflect pads are the mirrors above.
//
// What bounds it: bytes. The gate reads each sample and writes it once,
// 8 bytes per sample, and does a few dozen operations per sample, far
// below the card's operation rate. Three passes, each a launch of its own
// because each needs the one before it whole:
//   rms   a grid-stride loop over (file, run of frames) on two waves of
//         resident blocks (the wrapper's grid; a block that has summed its
//         runs gives its SM to one that starts copying), two stages of
//         kStage samples in dynamic shared memory: while a block sums one
//         run the next one's span lands in the other stage, one bulk copy
//         (TMA, cp.async.bulk on an mbarrier) of its 16-byte-aligned
//         middle (a run that touches sample 0 or the valid end copies a
//         sample at a time, reflected and mirrored, with cp.async, all in
//         flight at once). The sample gate is applied as the squares are
//         read, once per staged sample; each square is summed in fp64
//         into its hop block of g = gcd(hop, 2048) samples (a warp per
//         block, g >= 32), and a frame's sum is the sum of its 2048 / g
//         blocks, so each staged sample is squared and widened once, not
//         once per frame that covers it;
//   gate  one block per file of 256-1024 threads: the envelope staged in
//         dynamic shared memory (files of up to kThresholdFrames frames;
//         longer ones read it and keep the median in device memory, the
//         same code on other pointers), the median with both mirrors, then
//         the two order statistics of the valid frames by radix selection
//         on order-preserving uint32 keys (four rounds of 8 bits, a
//         histogram per warp, a thread adding each stretch of equal bins
//         of its run of frames at once; the upper statistic is the lower
//         one again or the least larger value), so the threshold is
//         bit-equal to the plain percentile of the same envelope (its
//         float32 steps are rounded one by one, no FMA); then the frame
//         mask;
//   apply one warp per frame over (file, chunk of whole frames) items: the
//         frame's mask byte read once, its samples in 16-byte loads, four
//         in flight per lane, where the row length, the hop and the
//         pointers allow (else one float at a time).
// The sample gate's log10 runs only for samples within 0.01 dB of min_db:
// outside that band the amplitude alone decides it, with a margin far
// above log10f's error, so every sample takes the formula's own decision.
// Every hop >= 1 is taken: a run holds as many frames as fit a stage.
#include <cuda_pipeline.h>

#include <cmath>
#include <cstdint>

#include "bulk_copy.cuh"
#include "dsp_common.cuh"

using namespace gat;

constexpr int kFrame = 2048;             // rms_gate's frame length
constexpr int kHalf = kFrame / 2;        // its centre pad
constexpr int kStage = 8192;             // samples a stage of the rms pass holds
constexpr int kStageFloats = kStage + 4; // + the shift that aligns its copies
constexpr int kWarps = kThreads / 32;
// The threshold pass stages a file's envelope and median in shared memory
// up to this many frames (192 KB, beside its 32 KB of histograms; 570 s
// at hop 512 and 22050 Hz); longer files keep them in device memory.
constexpr int kThresholdFrames = 24576;
constexpr int kGateThreadsMax = 1024;    // threads of a threshold block
constexpr int kGateWarpsMax = kGateThreadsMax / 32;
// Apply blocks per rms block: the rms grid is two waves of 3 blocks of 256
// threads an SM at hop 512 (its stages), the apply pass holds 6 an SM (its
// registers), so 2 x grid gives every SM two waves of apply blocks; past
// that they stride.
constexpr int kApplyPerRmsBlock = 2;
constexpr float kEps = 1e-10f;           // the gates' log10 floor
constexpr float kNoiseQuantile = 0.2f;   // the noise floor's percentile / 100
constexpr float kGateOffsetDb = 6.0f;    // gate_db = noise floor + 6 dB
constexpr double kGateBandDb = 0.01;     // where the sample gate takes log10
constexpr unsigned kFull = 0xffffffffu;

struct GateShared {
  int hist[kGateWarpsMax][256];  // a radix round's histogram, one per warp
  int wsum[256 / 32];            // warp totals of the histogram scan
  float wmin[kGateWarpsMax];     // warp minima
  int bin, k_rem, eq;  // the selected bin, the rank left in it, its count
};

// The sample gate: min_db, and the amplitudes |y| + 1e-10 below lo (gated
// off) and above hi (kept) that decide it without the log10; without the
// gate lo = hi = -1, below every amplitude.
struct SampleGate {
  float min_db, lo, hi;
};

template <class T, class Op>
__device__ __forceinline__ T warp_reduce(T v, Op op) {
  for (int s = 16; s > 0; s >>= 1) v = op(v, __shfl_xor_sync(kFull, v, s));
  return v;
}

__device__ __forceinline__ int valid_count(const int* n_valid, int file,
                                           int n) {
  if (!n_valid) return n;
  const int nv = n_valid[file];
  return nv < 0 ? 0 : (nv > n ? n : nv);
}

// 1 where sample_db_gate keeps v, else 0 (1 without the gate, 0 for a
// NaN, whose product is NaN either way): the reference's
// 20·log10(|v| + 1e-10) > min_db, the log10 taken only in the band around
// min_db.
__device__ __forceinline__ float gate_factor(float v, const SampleGate& g) {
  const float a = fabsf(v) + kEps;
  float f = a > g.hi ? 1.0f : 0.0f;
  if (a >= g.lo && a <= g.hi) f = 20.0f * log10f(a) > g.min_db ? 1.0f : 0.0f;
  return f;
}

// The row sample that extended sample p is, as the frame RMS reads the
// row (the sample gate comes later): the reflect pad at the left, the
// valid samples, the mirror of the valid end; -1 for the zeros past it.
__device__ __forceinline__ long long extended_index(long long p, int nv) {
  if (p < 0) p = -p;
  if (p < nv) return p;
  if (p < (long long)nv + kHalf) {
    const long long q = 2LL * nv - 2 - p;
    return q >= 0 ? q : -1;
  }
  return -1;
}

__host__ __device__ constexpr int frames_per_run(int hop) {
  return hop > kStage - kFrame ? 1 : 1 + (kStage - kFrame) / hop;
}

// gcd(hop, 2048): the hop block, the largest power of two dividing both
__host__ __device__ constexpr int hop_block(int hop) {
  return (hop & -hop) < kFrame ? (hop & -hop) : kFrame;
}

// Two stages, the hop blocks' fp64 sums of one run, the stages' barriers.
__host__ __device__ constexpr size_t rms_smem_bytes(int hop) {
  return 2 * sizeof(float) * kStageFloats +
         sizeof(double) * (kStage / hop_block(hop)) + 2 * sizeof(uint64_t);
}

constexpr size_t kRmsSmemMax = rms_smem_bytes(1);
constexpr size_t kThresholdSmemMax = 2 * sizeof(float) * kThresholdFrames;

// One run of the rms pass: its file, its first frame, its frames, the
// first extended sample it reads, and where its span starts in its stage
// (a shift of 0-3 floats that gives the stage the row's 16-byte phase; 0
// for a run that takes the reflect and mirror path).
struct Run {
  int file, t0, frames, nv, span, shift;
  long long p0;
  bool interior;
};

__device__ __forceinline__ Run run_of(const float* y, const int* n_valid,
                                      long long item, int runs, int n,
                                      int hop, int t_out) {
  Run r;
  const int per = frames_per_run(hop);
  r.file = (int)(item / runs);
  r.t0 = (int)(item - (long long)r.file * runs) * per;
  r.frames = t_out - r.t0 < per ? t_out - r.t0 : per;
  r.nv = valid_count(n_valid, r.file, n);
  r.p0 = (long long)r.t0 * hop - kHalf;
  r.span = (r.frames - 1) * hop + kFrame;
  r.interior = r.p0 >= 0 && r.p0 + r.span <= r.nv;
  r.shift = r.interior
                ? (int)(((uintptr_t)(y + (size_t)r.file * n + r.p0) >> 2) & 3)
                : 0;
  return r;
}

// Starts staging the run's span into `stage`, its completion on `bar`: an
// interior run as one bulk copy of its 16-byte-aligned middle (thread 0),
// its 0-3 floats at each end by cp.async; a run at sample 0 or the valid
// end a sample a copy (cp.async) from where extended_index maps it, zeros
// stored, thread 0 arriving on `bar` with no bytes. All of it in flight at
// once; each thread commits one pipeline group.
__device__ __forceinline__ void stage_run(const float* __restrict__ y,
                                          const Run& r, int n, float* stage,
                                          uint64_t* bar) {
  const float* row = y + (size_t)r.file * n;
  float* dst = stage + r.shift;
  if (r.interior) {
    const float* src = row + r.p0;
    const int align = (4 - r.shift) & 3;  // floats before a 16-byte phase
    const int head = align < r.span ? align : r.span;
    const int quads = (r.span - head) >> 2;
    const int tail = head + 4 * quads;
    if (threadIdx.x == 0) {
      const unsigned bytes = 16u * quads;
      mbar_arrive_expect(bar, bytes);
      if (bytes) bulk_load(dst + head, src + head, bytes, bar);
    }
    if (threadIdx.x < head)
      __pipeline_memcpy_async(dst + threadIdx.x, src + threadIdx.x,
                              sizeof(float));
    for (int s = tail + threadIdx.x; s < r.span; s += kThreads)
      __pipeline_memcpy_async(dst + s, src + s, sizeof(float));
  } else {
    if (threadIdx.x == 0) mbar_arrive_expect(bar, 0);
    for (int s = threadIdx.x; s < r.span; s += kThreads) {
      const long long q = extended_index(r.p0 + s, r.nv);
      if (q >= 0)
        __pipeline_memcpy_async(dst + s, row + q, sizeof(float));
      else
        dst[s] = 0.0f;
    }
  }
  __pipeline_commit();
}

__global__ void __launch_bounds__(kThreads)
noise_gate_rms_kernel(const float* __restrict__ y,
                      const int* __restrict__ n_valid,
                      float* __restrict__ env, int n_files, int n, int hop,
                      int t_out, SampleGate gate) {
  extern __shared__ float smem[];
  const int g = hop_block(hop);
  double* blocks = reinterpret_cast<double*>(smem + 2 * kStageFloats);
  uint64_t* bars = reinterpret_cast<uint64_t*>(blocks + kStage / g);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int runs = (t_out + frames_per_run(hop) - 1) / frames_per_run(hop);
  const long long items = (long long)n_files * runs;
  const int per_frame = kFrame / g, step = hop / g;
  if (threadIdx.x == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
  }
  __syncthreads();
  long long item = blockIdx.x;
  if (item < items)
    stage_run(y, run_of(y, n_valid, item, runs, n, hop, t_out), n, smem,
              &bars[0]);
  for (int it = 0; item < items; item += gridDim.x, ++it) {
    // the next run's copies go out into the stage the last run freed, and
    // land while this one's are waited for and summed
    const int cur = it & 1;
    const long long next = item + gridDim.x;
    if (next < items)
      stage_run(y, run_of(y, n_valid, next, runs, n, hop, t_out), n,
                smem + (cur ^ 1) * kStageFloats, &bars[cur ^ 1]);
    else
      __pipeline_commit();
    __pipeline_wait_prior(1);
    mbar_wait(&bars[cur], (it >> 1) & 1);
    __syncthreads();  // this run's span, staged by every thread
    const Run r = run_of(y, n_valid, item, runs, n, hop, t_out);
    const float* w = smem + cur * kStageFloats + r.shift;
    const int nb = r.span / g;
    if (g >= 32) {
      for (int j = warp; j < nb; j += kWarps) {
        double acc = 0.0;
        for (int k = lane; k < g; k += 32) {
          const float v = w[j * g + k];
          const float u = v * gate_factor(v, gate);
          acc += (double)(u * u);
        }
        acc = warp_reduce(acc, [](double a, double b) { return a + b; });
        if (lane == 0) blocks[j] = acc;
      }
    } else {
      for (int j = threadIdx.x; j < nb; j += kThreads) {
        double acc = 0.0;
        for (int k = 0; k < g; ++k) {
          const float v = w[j * g + k];
          const float u = v * gate_factor(v, gate);
          acc += (double)(u * u);
        }
        blocks[j] = acc;
      }
    }
    __syncthreads();
    for (int f = threadIdx.x; f < r.frames; f += kThreads) {
      double acc = 0.0;
      for (int c = 0; c < per_frame; ++c) acc += blocks[f * step + c];
      const float mean = (float)acc * (1.0f / kFrame);
      env[(size_t)r.file * t_out + r.t0 + f] =
          20.0f * log10f(sqrtf(mean) + kEps);
    }
    __syncthreads();  // the stage and the blocks are written again next
  }
}

// Order-preserving key of a float (no NaN reaches it): unsigned order of
// the keys is the float order.
__device__ __forceinline__ unsigned order_bits(float v) {
  const unsigned u = (unsigned)__float_as_int(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(unsigned k) {
  return __int_as_float((int)((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k));
}

// A thread's run of consecutive frames out of `count`: per frames each,
// an odd number, so the lanes of a warp reading their runs' i-th frames
// hit distinct banks of shared memory.
struct Chunk {
  int first, last;
};

__device__ __forceinline__ Chunk chunk_of(int count) {
  int per = (count + blockDim.x - 1) / blockDim.x;
  per |= 1;
  Chunk c;
  c.first = threadIdx.x * per;
  c.last = c.first + per < count ? c.first + per : count;
  return c;
}

// Counts a thread's keys into its warp's histogram, each stretch of equal
// bins at once: frames next to each other have close dB and so mostly the
// same bin (the first round puts most frames of a file in one or two
// bins, which one shared histogram would serialize over every warp).
struct BinRun {
  unsigned bin = 256u;  // 256: no bin (past the count, another prefix)
  int run = 0;
  __device__ __forceinline__ void add(unsigned b, int* own) {
    if (b != bin) {
      flush(own);
      bin = b;
    }
    run += b < 256u;
  }
  __device__ __forceinline__ void flush(int* own) {
    if (run) atomicAdd(&own[bin], run);
    run = 0;
  }
};

// The k-th smallest (from 0) of v[0, count) by four radix rounds on the
// order keys, 8 bits a round; also the rank left inside its value's run
// and how many values equal it. The first round's counts are in the
// warps' histograms already, behind a barrier (the median's loop made
// them). Three barriers a round: after the counts, after the scan of the
// bins' totals, after the bin is chosen.
__device__ float select_kth(const float* v, int count, int k, int* k_rem,
                            int* eq, GateShared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const Chunk c = chunk_of(count);
  int* own = sh.hist[warp];
  unsigned prefix = 0u, pmask = 0u;
  for (int shift = 24; shift >= 0; shift -= 8) {
    if (shift < 24) {
      BinRun counts;
      for (int t = c.first; t < c.last; ++t) {
        const unsigned u = order_bits(v[t]);
        counts.add((u & pmask) == prefix ? (u >> shift) & 255u : 256u, own);
      }
      counts.flush(own);
      __syncthreads();
    }
    int h = 0, incl = 0;
    if (threadIdx.x < 256) {
      for (int w = 0; w < warps; ++w) h += sh.hist[w][threadIdx.x];
      incl = h;
      for (int s = 1; s < 32; s <<= 1) {
        const int u = __shfl_up_sync(kFull, incl, s);
        if (lane >= s) incl += u;
      }
      if (lane == 31) sh.wsum[warp] = incl;
    }
    __syncthreads();
    if (threadIdx.x < 256) {
      int excl = incl - h;
      for (int w = 0; w < warp; ++w) excl += sh.wsum[w];
      if (k >= excl && k < excl + h) {
        sh.bin = threadIdx.x;
        sh.k_rem = k - excl;
        sh.eq = h;
      }
    }
    __syncthreads();
    prefix |= (unsigned)sh.bin << shift;
    pmask |= 255u << shift;
    k = sh.k_rem;
    *eq = sh.eq;
    // every warp's histogram was read before the last barrier: each warp
    // clears its own for the next round, and the next round's choice is
    // written two barriers after these reads
    for (int b = lane; b < 256; b += 32) own[b] = 0;
    __syncwarp();
  }
  *k_rem = k;
  return key_float(prefix);
}

// The median of five: of the larger of the pairs' minima, the smaller of
// their maxima and e (one of the five, by min and max).
__device__ __forceinline__ float median5(float a, float b, float c, float d,
                                         float e) {
  const float lo = fmaxf(fminf(a, b), fminf(c, d));
  const float hi = fminf(fmaxf(a, b), fmaxf(c, d));
  return fmaxf(fminf(lo, hi), fminf(fmaxf(lo, hi), e));
}

// staged: the envelope and the median in shared memory (t_out <=
// kThresholdFrames), else the envelope read from and the median kept in
// device memory.
__global__ void __launch_bounds__(kGateThreadsMax)
noise_gate_threshold_kernel(const float* __restrict__ env,
                            const int* __restrict__ n_valid, float* med,
                            unsigned char* __restrict__ frame_mask,
                            float* __restrict__ gate_db, int n, int hop,
                            int t_out, int staged) {
  extern __shared__ float smem[];
  __shared__ GateShared sh;
  const int file = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nv = valid_count(n_valid, file, n);
  int nvf = 1 + nv / hop;
  nvf = nvf > t_out ? t_out : nvf;
  const float* e = env + (size_t)file * t_out;
  float* med_row = med + (size_t)file * t_out;
  float* m = med_row;
  int* own = sh.hist[warp];
  for (int b = lane; b < 256; b += 32) own[b] = 0;
  if (staged) {
    for (int t = threadIdx.x; t < t_out; t += blockDim.x)
      __pipeline_memcpy_async(smem + t, e + t, sizeof(float));
    __pipeline_commit();
    __pipeline_wait_prior(0);
    e = smem;
    m = smem + t_out;
  }
  __syncthreads();

  // the envelope extended by the mirror of its valid end, read with
  // symmetric edges at frame 0
  auto ee = [&](int i) -> float {
    if (i < 0) i = -1 - i;
    if (i == nvf) return e[nvf - 1];
    if (i == nvf + 1) return nvf >= 2 ? e[nvf - 2] : 0.0f;
    return i < t_out ? e[i] : 0.0f;
  };
  // the median over a window sliding along the thread's run of frames;
  // the first radix round's counts (the keys' top bytes) of the valid ones
  {
    const Chunk c = chunk_of(t_out);
    float w0 = ee(c.first - 2), w1 = ee(c.first - 1), w2 = ee(c.first),
          w3 = ee(c.first + 1);
    BinRun counts;
    for (int t = c.first; t < c.last; ++t) {
      const float w4 = ee(t + 2);
      const float v = median5(w0, w1, w2, w3, w4);
      m[t] = v;
      counts.add(t < nvf ? order_bits(v) >> 24 : 256u, own);
      w0 = w1;
      w1 = w2;
      w2 = w3;
      w3 = w4;
    }
    counts.flush(own);
  }
  __syncthreads();  // the smoothed frames, for all

  // masked_percentile(med, 20, t < nvf): pos = 0.2 · (count - 1)
  const float pos = __fmul_rn(kNoiseQuantile, __fsub_rn((float)nvf, 1.0f));
  const int lo = (int)floorf(pos);
  const float frac = __fsub_rn(pos, (float)lo);
  int k_rem, eq;
  const float xlo = select_kth(m, nvf, lo, &k_rem, &eq, sh);
  float xhi = xlo;
  if (lo + 1 < nvf && k_rem + 1 >= eq) {
    // the next order statistic is the least value above xlo
    float least = INFINITY;
    for (int t = threadIdx.x; t < nvf; t += blockDim.x)
      if (m[t] > xlo) least = fminf(least, m[t]);
    least = warp_reduce(least, [](float a, float b) { return fminf(a, b); });
    if (lane == 0) sh.wmin[warp] = least;
    __syncthreads();
    xhi = sh.wmin[0];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
      xhi = fminf(xhi, sh.wmin[w]);
  }
  const float noise = __fadd_rn(xlo, __fmul_rn(frac, __fsub_rn(xhi, xlo)));
  const float gate = __fadd_rn(noise, kGateOffsetDb);
  if (threadIdx.x == 0) gate_db[file] = gate;
  unsigned char* fm = frame_mask + (size_t)file * t_out;
  for (int t = threadIdx.x; t < t_out; t += blockDim.x) {
    const float v = m[t];
    fm[t] = v > gate;
    if (staged) med_row[t] = v;
  }
}

// The threshold block's threads: 256 (the histogram's bins), doubled up to
// 1024 while a thread would hold more than 8 frames.
static int threshold_threads(int t_out) {
  int threads = 256;
  while (threads < kGateThreadsMax && threads * 8 < t_out) threads *= 2;
  return threads;
}

// The apply pass's frames per item: a warp per frame, at least 512
// samples a warp.
static int frames_per_chunk(int hop) {
  return kWarps * (hop >= 512 ? 1 : (512 + hop - 1) / hop);
}

// v · sample gate · [kept], as the reference multiplies them out (the
// factors are 0 or 1, so a NaN or a signed zero comes out as its product)
__device__ __forceinline__ float gated(float v, bool kept,
                                       const SampleGate& g) {
  return v * (kept ? gate_factor(v, g) : 0.0f);
}

__global__ void __launch_bounds__(kThreads)
noise_gate_apply_kernel(const float* __restrict__ y, float* __restrict__ out,
                        const unsigned char* __restrict__ frame_mask,
                        const int* __restrict__ n_valid, int n, int hop,
                        int t_out, int chunk, int chunks, long long items,
                        SampleGate gate, int vec) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const int file = (int)(item / chunks);
    const int c = (int)(item - (long long)file * chunks);
    const int nv = valid_count(n_valid, file, n);
    const unsigned char* fm = frame_mask + (size_t)file * t_out;
    const size_t row = (size_t)file * n;
    const int t_end = t_out < (c + 1) * chunk ? t_out : (c + 1) * chunk;
    for (int t = c * chunk + warp; t < t_end; t += kWarps) {
      const int start = t * hop;
      if (start >= n) break;  // the last frame when hop divides n
      const int len = n - start < hop ? n - start : hop;
      // the frame's samples [0, kept) pass its gate and the length mask
      const int kept = fm[t] ? nv - start : 0;
      const float* src = y + row + start;
      float* dst = out + row + start;
      if (vec) {  // n, hop and both pointers 16-byte aligned
        const float4* s4 = reinterpret_cast<const float4*>(src);
        float4* d4 = reinterpret_cast<float4*>(dst);
        const int quads = len >> 2;
        for (int q0 = lane; q0 < quads; q0 += 4 * 32) {
          float4 x[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (q0 + 32 * k < quads) x[k] = s4[q0 + 32 * k];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int q = q0 + 32 * k;
            if (q >= quads) break;
            const int i = 4 * q;
            x[k].x = gated(x[k].x, i < kept, gate);
            x[k].y = gated(x[k].y, i + 1 < kept, gate);
            x[k].z = gated(x[k].z, i + 2 < kept, gate);
            x[k].w = gated(x[k].w, i + 3 < kept, gate);
            d4[q] = x[k];
          }
        }
      } else {
        for (int i = lane; i < len; i += 32)
          dst[i] = gated(src[i], i < kept, gate);
      }
    }
  }
}

// The sample gate's parameters: the band of amplitudes |y| + 1e-10 whose
// dB lies within kGateBandDb of min_db; outside it the formula's decision
// is certain (log10f and the product by 20 err by far less).
static SampleGate sample_gate(int on, float min_db) {
  SampleGate g;
  g.min_db = min_db;
  g.lo = on ? (float)std::pow(10.0, ((double)min_db - kGateBandDb) / 20.0)
            : -1.0f;
  g.hi = on ? (float)std::pow(10.0, ((double)min_db + kGateBandDb) / 20.0)
            : -1.0f;
  return g;
}

// Lets the rms and threshold passes take their largest dynamic shared
// memory (the same values on every call, on the current device).
static int set_attributes() {
  cudaError_t err = cudaFuncSetAttribute(
      noise_gate_rms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kRmsSmemMax);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncSetAttribute(noise_gate_threshold_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)kThresholdSmemMax);
}

// The gate of n_files rows of n samples. n_valid: (n_files,) int32 valid
// counts, or NULL for none; env, med: (n_files, 1 + n / hop) float32
// workspaces (the frame RMS in dB, then smoothed); frame_mask: the frames'
// gate bytes; gate_db: (n_files,) thresholds. gate_samples 0 leaves out
// the sample gate (rms_gate alone). grid: blocks of the rms pass (the
// wrapper's two waves of SMs x resident blocks per SM); the threshold
// pass runs a
// block per file, the apply pass up to kApplyPerRmsBlock x grid blocks
// over its items of frames.
extern "C" int gat_noise_gate(const float* y, float* out, const int* n_valid,
                              float* env, float* med,
                              unsigned char* frame_mask, float* gate_db,
                              int n_files, int n, int hop, int gate_samples,
                              float min_db, int grid, void* stream) {
  if (n_files < 1 || n < 1 || n > 0x7fffffff - 2 * kFrame || hop < 1 ||
      grid < 1)
    return (int)cudaErrorInvalidValue;
  const int t_out = 1 + n / hop;
  const SampleGate gate = sample_gate(gate_samples, min_db);
  cudaStream_t s = (cudaStream_t)stream;
  int status = set_attributes();
  if (status != 0) return status;
  const size_t rms_bytes = rms_smem_bytes(hop);
  noise_gate_rms_kernel<<<grid, kThreads, rms_bytes, s>>>(
      y, n_valid, env, n_files, n, hop, t_out, gate);
  status = (int)cudaGetLastError();
  if (status != 0) return status;
  const int staged = t_out <= kThresholdFrames;
  const int threads = threshold_threads(t_out);
  const size_t gate_bytes = staged ? 2 * sizeof(float) * t_out : 0;
  noise_gate_threshold_kernel<<<n_files, threads, gate_bytes, s>>>(
      env, n_valid, med, frame_mask, gate_db, n, hop, t_out, staged);
  status = (int)cudaGetLastError();
  if (status != 0) return status;
  const int vec = n % 4 == 0 && hop % 4 == 0 &&
                  ((uintptr_t)y & 15u) == 0 && ((uintptr_t)out & 15u) == 0;
  const int chunk = frames_per_chunk(hop);
  const int chunks = (t_out + chunk - 1) / chunk;
  const long long items = (long long)n_files * chunks;
  const long long most = (long long)kApplyPerRmsBlock * grid;
  const int blocks = (int)(items < most ? items : most);
  noise_gate_apply_kernel<<<blocks, kThreads, 0, s>>>(
      y, out, frame_mask, n_valid, n, hop, t_out, chunk, chunks, items, gate,
      vec);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the rms pass at this hop (its two stages and
// hop blocks in dynamic shared memory), as the CUDA runtime computes it;
// hop < 1 is refused as the launch refuses it.
extern "C" int gat_noise_gate_blocks_per_sm(int hop, int* blocks) {
  if (hop < 1) return (int)cudaErrorInvalidValue;
  const int status = set_attributes();
  if (status != 0) return status;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, noise_gate_rms_kernel, kThreads, rms_smem_bytes(hop));
}

// Each pass's resident blocks per SM for rows of n samples at this hop:
// out[0] rms, out[1] threshold, out[2] apply; out[3] the threshold
// block's threads and out[4] whether it stages the envelope in shared
// memory (t_out <= kThresholdFrames, also written).
extern "C" int gat_noise_gate_pass_blocks(int n, int hop, int* out) {
  if (hop < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const int t_out = 1 + n / hop;
  int status = gat_noise_gate_blocks_per_sm(hop, out);
  if (status != 0) return status;
  out[3] = threshold_threads(t_out);
  out[4] = t_out <= kThresholdFrames;
  status = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out + 1, noise_gate_threshold_kernel, out[3],
      out[4] ? 2 * sizeof(float) * t_out : 0);
  if (status != 0) return status;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out + 2, noise_gate_apply_kernel, kThreads, 0);
}
