// A 2048-point complex FFT run by 128 threads, 16 values each, as three
// Stockham passes in registers (radix 16, 16, 8) with two shared-memory
// exchanges between them. The Stockham order leaves the output in natural
// order, so nothing is ever stored bit-reversed.
//
// Pass p with radix R after strides Ns (the product of the radices before
// it): butterfly b reads x[b + r * N/R] for r < R, multiplies element r by
// W_(Ns R)^(r (b mod Ns)), runs an R-point DFT and writes its output r to
// (b / Ns) * Ns * R + (b mod Ns) + r * Ns. The twiddles come from a table
// the host computes in float64 (layout below), read through the cache.
//
// Shared-memory addresses go through `swizzle`, an XOR of a 32-float
// row's column with bits of its row number. The stores of a warp then hit
// 32 distinct banks, at 16j + r in pass A and at (j / 16) * 256 + j % 16 +
// 16 r in pass B, as do the loads at j + 128 r and j + 256 r, which cover
// one row each; the loads at 256 - j + 256 r span two rows.
#pragma once

#include <cuda_runtime.h>

namespace gat {

constexpr int kFFTThreads = 128;  // threads per transform

// Twiddle table (floats): the pass-B table W_256^(r m), r, m < 16, as re
// [0, 256) and im [256, 512) at r*16+m, then the pass-C table
// W_2048^(r b), r < 8, b < 256, as re [512, 2560) and im [2560, 4608) at
// r*256+b.
constexpr int kTwPassB = 0;
constexpr int kTwPassC = kTwPassB + 2 * 256;

__device__ __forceinline__ int swizzle(int a) {
  return a ^ (((a >> 5) & 15) | (((a >> 8) & 1) << 4));
}

// (re, im) *= e^(-2*pi*i*q/16); q is a constant once the callers' loops
// are unrolled, so the switch folds away.
__device__ __forceinline__ void rotate16(float& re, float& im, int q) {
  const float c1 = 0.92387953251128674f;  // cos(pi/8)
  const float s1 = 0.38268343236508977f;  // sin(pi/8)
  const float h = 0.70710678118654752f;   // sqrt(1/2)
  float c, s;  // e^(-2*pi*i*q/16) = c - i*s
  switch (q & 15) {
    case 0: return;
    case 1: c = c1; s = s1; break;
    case 2: c = h; s = h; break;
    case 3: c = s1; s = c1; break;
    case 4: c = 0.0f; s = 1.0f; break;
    case 5: c = -s1; s = c1; break;
    case 6: c = -h; s = h; break;
    case 7: c = -c1; s = s1; break;
    case 8: c = -1.0f; s = 0.0f; break;
    case 9: c = -c1; s = -s1; break;
    case 10: c = -h; s = -h; break;
    case 11: c = -s1; s = -c1; break;
    case 12: c = 0.0f; s = -1.0f; break;
    case 13: c = s1; s = -c1; break;
    case 14: c = h; s = -h; break;
    default: c = c1; s = -s1; break;
  }
  const float r = re * c + im * s;
  im = im * c - re * s;
  re = r;
}

// In-place 4-point DFT of x[a], x[a+d], x[a+2d], x[a+3d], natural order.
__device__ __forceinline__ void dft4(float* re, float* im, int a, int d) {
  const float t0r = re[a] + re[a + 2 * d], t0i = im[a] + im[a + 2 * d];
  const float t1r = re[a] - re[a + 2 * d], t1i = im[a] - im[a + 2 * d];
  const float t2r = re[a + d] + re[a + 3 * d];
  const float t2i = im[a + d] + im[a + 3 * d];
  const float t3r = re[a + d] - re[a + 3 * d];
  const float t3i = im[a + d] - im[a + 3 * d];
  re[a] = t0r + t2r;          im[a] = t0i + t2i;
  re[a + d] = t1r + t3i;      im[a + d] = t1i - t3r;
  re[a + 2 * d] = t0r - t2r;  im[a + 2 * d] = t0i - t2i;
  re[a + 3 * d] = t1r - t3i;  im[a + 3 * d] = t1i + t3r;
}

// In-place R-point DFT (R = 16 or 8) of registers, natural order in and
// out, as 4 x Q with Q = R / 4: x[Q n1 + n2] -> Q 4-point DFTs over n1,
// twiddles W_R^(n2 k1), R/4-point DFTs over n2 -> X[k1 + 4 k2].
template <int R>
__device__ __forceinline__ void dft_regs(float* re, float* im) {
  constexpr int Q = R / 4;
#pragma unroll
  for (int n2 = 0; n2 < Q; ++n2) dft4(re, im, n2, Q);
#pragma unroll
  for (int n2 = 1; n2 < Q; ++n2)
#pragma unroll
    for (int k1 = 1; k1 < 4; ++k1)
      rotate16(re[Q * k1 + n2], im[Q * k1 + n2], n2 * k1 * (16 / R));
  // slot Q k1 + n2 now holds the k1-th output of column n2
  if constexpr (Q == 4) {
#pragma unroll
    for (int k1 = 0; k1 < 4; ++k1) dft4(re, im, 4 * k1, 1);
  } else {
#pragma unroll
    for (int k1 = 0; k1 < 4; ++k1) {
      const float ar = re[2 * k1], ai = im[2 * k1];
      re[2 * k1] = ar + re[2 * k1 + 1];
      im[2 * k1] = ai + im[2 * k1 + 1];
      re[2 * k1 + 1] = ar - re[2 * k1 + 1];
      im[2 * k1 + 1] = ai - im[2 * k1 + 1];
    }
  }
  // slot Q k1 + k2 holds X[k1 + 4 k2]: transpose to natural order
  float tr[R], ti[R];
#pragma unroll
  for (int k1 = 0; k1 < 4; ++k1)
#pragma unroll
    for (int k2 = 0; k2 < Q; ++k2) {
      tr[k1 + 4 * k2] = re[Q * k1 + k2];
      ti[k1 + 4 * k2] = im[Q * k1 + k2];
    }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    re[r] = tr[r];
    im[r] = ti[r];
  }
}

__device__ __forceinline__ void twiddle(float& re, float& im,
                                        const float* __restrict__ w_re,
                                        const float* __restrict__ w_im) {
  const float c = *w_re, s = *w_im;
  const float r = re * c - im * s;
  im = re * s + im * c;
  re = r;
}

// Transform of the 2048 complex values that thread j (< 128) of the
// transform holds as x[j + 128 r] = (vr[r], vi[r]), r < 16, using (re,
// im) as the exchange buffer. On return the thread holds X[b_h + 256 r] in
// (vr[8 h + r], vi[8 h + r]), r < 8, for b_0 = j and b_1 = 256 - j (128
// for j = 0): X[k] and X[2048 - k] then sit in one thread, as the split of
// a two-frame transform needs. Three __syncthreads, so every thread of the
// block calls it; the last pass still reads (re, im), so the caller
// synchronizes before it writes there again.
__device__ __forceinline__ void fft2048_stockham(float* vr, float* vi,
                                                 float* re, float* im,
                                                 const float* __restrict__ tw,
                                                 int j) {
  // pass A: radix 16, Ns = 1, no twiddles
  dft_regs<16>(vr, vi);
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    re[swizzle(16 * j + r)] = vr[r];
    im[swizzle(16 * j + r)] = vi[r];
  }
  __syncthreads();
  // pass B: radix 16, Ns = 16
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    vr[r] = re[swizzle(j + 128 * r)];
    vi[r] = im[swizzle(j + 128 * r)];
  }
  __syncthreads();  // every load is done before the stores below
  const int m = j & 15;
#pragma unroll
  for (int r = 1; r < 16; ++r)
    twiddle(vr[r], vi[r], tw + kTwPassB + r * 16 + m,
            tw + kTwPassB + 256 + r * 16 + m);
  dft_regs<16>(vr, vi);
  const int base = (j >> 4) * 256 + m;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    re[swizzle(base + 16 * r)] = vr[r];
    im[swizzle(base + 16 * r)] = vi[r];
  }
  __syncthreads();
  // pass C: radix 8, Ns = 256, butterflies b_0 and b_1, kept in registers
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int b = h == 0 ? j : (j == 0 ? 128 : 256 - j);
    float* ur = vr + 8 * h;
    float* ui = vi + 8 * h;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      ur[r] = re[swizzle(b + 256 * r)];
      ui[r] = im[swizzle(b + 256 * r)];
    }
#pragma unroll
    for (int r = 1; r < 8; ++r)
      twiddle(ur[r], ui[r], tw + kTwPassC + r * 256 + b,
              tw + kTwPassC + 2048 + r * 256 + b);
    dft_regs<8>(ur, ui);
  }
}

// |X_a[k]|^2 and |X_b[k]|^2, times 4, of the real frames a and b packed
// as Z = a + i b, from z = Z[k] and w = Z[2048 - k]:
// X_a = (z + conj w) / 2, X_b = (z - conj w) / 2i.
__device__ __forceinline__ void split_power(float zr, float zi, float wr,
                                            float wi, float* pa, float* pb,
                                            int k) {
  pa[k] = (zr + wr) * (zr + wr) + (zi - wi) * (zi - wi);
  pb[k] = (zr - wr) * (zr - wr) + (zi + wi) * (zi + wi);
}

// The 1025 power bins of both frames from what fft2048_stockham left in
// thread j's registers: bins j + 256 r and 256 - j + 256 r, r < 4, for
// j > 0; bins 256 r, r <= 4, and 128 + 256 r, r < 4, for j = 0.
__device__ __forceinline__ void split_power_bins(const float* vr,
                                                 const float* vi, int j,
                                                 float* pa, float* pb) {
  if (j != 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      split_power(vr[r], vi[r], vr[15 - r], vi[15 - r], pa, pb,
                  j + 256 * r);
      split_power(vr[8 + r], vi[8 + r], vr[7 - r], vi[7 - r], pa, pb,
                  256 - j + 256 * r);
    }
  } else {
#pragma unroll
    for (int r = 0; r <= 4; ++r)
      split_power(vr[r], vi[r], vr[(8 - r) & 7], vi[(8 - r) & 7], pa, pb,
                  256 * r);
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_power(vr[8 + r], vi[8 + r], vr[15 - r], vi[15 - r], pa, pb,
                  128 + 256 * r);
  }
}

}  // namespace gat
