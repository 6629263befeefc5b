// K9: the polyphase resampler, x (n_src, n) float32 -> out (n_rows,
// out_len) float32, row r of out from row rows[r] of x (all rows in order
// when rows is NULL), cut or zero-padded to out_len samples.
//
// Replaces the JAX package's XLA program gat_tpu/ops/resample.py:89
// resample (a Kaiser-windowed sinc, beta 9.58, 24 zero crossings; the
// reference never wrote a Pallas kernel for it), composed with the row
// gather and fix_length the file body applies around it
// (gat_tpu/infer/pipeline.py:180: fix_length(resample(flat[sel]), L)).
// With up / down the rates' ratio in lowest terms, h the filter,
// half = (len(h) - 1) / 2, K = ceil(len(h) / up) and hp the phase table
// hp[p][k] = h[p + k·up] (zero past h), output j < m = ceil(n·up / down)
// of a row is
//   u = j·down - half,  i0 = ceil(u / up),  delta = i0·up - u,
//   y[j] = sum over k in [0, K) of x[i0 + k] · hp[delta][k],
// x being 0 outside [0, n); outputs m <= j < out_len are 0.
//
// Frames and phases. With U = lcm(up, 4) and D = U / up · down, output
// j = t·U + s (frame t, phase s) starts at i0 = t·D + c[s], c[s] =
// ceil((s·down - half) / up), and uses the tap row delta[s] = c[s]·up -
// s·down + half, whatever t. (up == 1 is U = 4, four consecutive outputs
// a frame, D = 4·down.) A group is 4 consecutive phases: its window starts
// at c[4g], and phase 4g + p sits at o[p] = c[4g + p] - c[4g] inside it,
// so a zero-banded window of W <= K + ceil(3·down / up) positions carries
// all four phases' taps (torchaudio's form, limited to 4 phases: 6 % more
// positions than K at 48 kHz). A thread walks its frames' window of one
// group in ascending position: per step one float4 of the four phases'
// taps from shared memory, kept in registers for its F frames (F = 4 or
// 1), and one sample of each frame, four fmaf a frame.
//
// Bits. Each output still adds its taps in ascending k with fmaf from 0,
// as the first design did; the band's zeros around its K taps are
// fmaf(x, 0, acc), which leaves acc as it was for finite x (+0 stays +0
// before the first tap). So the outputs equal the first design's bit for
// bit (the emulated and card tests pin them).
//
// Shared-memory wavefronts. The 32 lanes of a warp take 32 frames of one
// group (F frames a lane, 32 apart): the taps of a step are the same for
// the warp up to its lag (below), a float4 of at most 8 distinct
// addresses, and each frame's sample is a load of its own, so a step is
// about F + 1 wavefronts for 4·F multiply-adds a lane: 0.5 a warp-wide 32
// multiply-adds at F = 1 and 0.31 at F = 4, the first design's 1.25 at
// up == 1 and about 4 at up > 1 (the card's clocks per step agree, PERF.md
// §6). The samples of a step lie D floats apart and must fall in 32
// distinct banks. Two layouts of the staged inputs do it:
//  - span: the tile's inputs as one contiguous range, one bulk copy on an
//    mbarrier; lane group q of the g = gcd(D, 32) runs q steps behind
//    (Λ = g), so that lane·D - q covers 32 banks (the first design's lag).
//    Used when g <= 8 (up == 1 at down 2: D = 8), F = 4: 1024 frames a
//    tile (F = 1, 256 frames, for a launch of fewer tiles than SMs).
//  - rows: a row of shared memory per frame, pitch ≡ 4 (mod 32) floats,
//    filled by 16-byte cp.async chunks, a warp a row (one bulk copy a row,
//    32 a tile from warp 0, measured no faster); the rows put lanes l and
//    l + 8 in the same bank quad, so
//    lane l runs λ in [0, 4) steps behind with e - λ ≡ l / 8 (mod 4), e
//    the row's alignment in its 16-byte unit (a row whose e - λ is
//    negative starts one quad later). Used when g >= 16 and a frame has at
//    least 8 groups (48, 16, 96, 8 kHz: down 320, 640 or 160), F = 1,
//    32 frames x 16 groups a tile; the rows repeat the K-wide overlap of
//    neighbouring frames' windows.
//
// Tiles and blocks. A tile is (group part, output row, frame tile): TF
// frames times GB groups, items of a frame block and a group taken by the
// warps in turn. The grid is min(tiles, SMs x resident blocks); block b
// takes the contiguous tiles [b·tiles / grid, (b + 1)·tiles / grid),
// ordered part, row, frame tile, so a block rarely changes part. Each
// block builds its part's banded table in shared memory from hp (read
// through the read-only cache) when the part changes, and keeps its
// inputs in two buffers: the next tile's copies go out before the block
// computes this one (a span's on two mbarriers, the k-th use of a
// buffer waiting on parity k & 1; rows' as one cp.async group a tile).
// The outputs go through shared memory, so a warp stores consecutive
// outputs. A launch of few tiles launches one block a tile.
//
// Where the trouble is, and where it is handled:
//  1. 64-bit indices: j·down passes 2^31 at j > 6.7 M when down is 320 (a
//     400 s file at 48 kHz has m = 8.82 M), and n·up for m too: j, frame
//     and input positions are long long throughout.
//  2. The ceiling of a negative u: C++ `/` truncates toward zero, the
//     reference's -(-u // up) is a floor-based ceiling; ceil_div takes
//     negative u apart (the first half / down outputs of every row).
//  3. Zero padding, not clamping: positions outside [0, n) read 0; they
//     are zeroed in shared memory once the copies have landed (fix_tile).
//  4. Copies of ranges that start anywhere: each is rounded out to 16
//     bytes and clamped to the tensor's aligned interior; what the clamp
//     cuts off is read a float at a time (fix_tile).
//  5. Shared memory above the default 48 KB: the dynamic shared-memory
//     attribute of each instantiation is read and only ever raised, under
//     a lock, before its launch (raise_attribute). A phase table hp too
//     large for a block (7999 -> 22050 Hz: 22050 x 49 floats) is read
//     through the read-only cache, four taps a step, and no banded table
//     is built (kTapsInSmem false).
//  6. Leading dimensions: the wrapper flattens (..., n) to rows (stereo
//     (2, n) is two rows, channels first) and casts to float32 once; the
//     kernel takes contiguous float32 rows.
//  7. The empty selection: the file body classifies one dummy slot when no
//     slot of a rank is picked; a launch of one row is an ordinary launch.
//     A row index outside [0, n_src) gives a row of NaN, not a read
//     outside x.
#include <cuda_pipeline.h>

#include <cstdint>
#include <mutex>

#include "bulk_copy.cuh"
#include "dsp_common.cuh"

using namespace gat;

// a block's warps, which take a tile's items in turn
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroups = 16;  // GB's largest value
// The head of shared memory: two mbarriers (4 floats), then the loaded
// part's phases (`Part`, 148 floats)
constexpr int kHeadFloats = 152;
constexpr int kLayoutFields = 11;  // gat_resample_layout's outputs

// The reference's ceiling of u / up (up > 0), for negative u too.
__host__ __device__ __forceinline__ long long ceil_div(long long u,
                                                       long long up) {
  return u >= 0 ? (u + up - 1) / up : -((-u) / up);
}

__host__ __device__ __forceinline__ long long lmin(long long a,
                                                   long long b) {
  return a < b ? a : b;
}

__host__ __device__ __forceinline__ long long lmax(long long a,
                                                   long long b) {
  return a > b ? a : b;
}

__host__ __device__ __forceinline__ int gcd(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// A launch's shape in shared memory, the same for every length at these
// rates.
struct Layout {
  int rows;         // 1: a row per frame; 0: one contiguous span
  int per_lane;     // F, frames a lane computes, 32 apart
  int frames;       // TF, frames a tile
  int groups;       // GB, groups of 4 phases a tile
  int lag;          // Λ, the lags a warp's lanes run at
  int steps;        // S, positions a thread walks (a multiple of 4)
  int pitch;        // rows: floats a row (≡ 4 mod 32); span: 0
  int buf_floats;   // one input buffer
  int out_floats;   // the output tile, TF rows of 4·GB + 1 floats
  int taps_floats;  // the banded table, GB x (S + Λ - 1) float4;
                    // 0: taps through the read-only cache
  long long bytes;  // shared memory a block
};

struct Plan {
  const float* x;     // (n_src, n)
  const int* rows;    // (n_rows,) or NULL
  const float* taps;  // (up, k_taps), hp
  float* out;         // (n_rows, out_len)
  long long n_src, n, m, out_len;
  long long frame_tiles;  // tiles of TF frames a row
  long long n_tiles;      // parts x n_rows x frame_tiles
  int n_rows, up, down, k_taps, half;
  int phases;  // U = lcm(up, 4)
  int stride;  // D = U / up · down, inputs a frame
  int n_groups;  // groups a frame worth computing (U / 4, fewer when one
                 // frame holds every output)
  long long need_frames;  // frames holding an output below min(m, out_len)
  Layout L;
};

// The phases' input offsets and rows of the filter.
__host__ __device__ __forceinline__ long long phase_start(const Plan& p,
                                                          long long s) {
  return ceil_div(s * p.down - p.half, p.up);
}

// The layout at these rates, `rows` chosen, TF frames and GB groups a
// tile, taps in shared memory or not: shared memory and sizes.
static Layout layout_of(int up, int down, int k_taps, bool rows, int per_lane,
                        int frames, int groups, bool taps_in_smem) {
  const int phases = up * (4 / gcd(up, 4));
  const long long stride = (long long)phases / up * down;
  Layout L;
  L.rows = rows;
  L.per_lane = per_lane;
  L.frames = frames;
  L.groups = groups;
  L.lag = rows ? 4 : gcd((int)(stride % 32), 32);
  // a group's window: its phases start at most ceil(3·down / up) apart
  const long long window = ceil_div(3LL * down, up) + k_taps;
  L.steps = (int)((window + L.lag - 1 + 3) & ~3LL);
  // one frame's inputs for a part of GB groups (each lagged Λ - 1 ahead)
  const long long reach = ceil_div((4LL * groups - 4) * down, up) + L.steps +
                          L.lag - 1;
  long long buf;
  if (rows) {
    const long long need = reach + 10;  // + a quad's shift, e, the copy's
                                        // rounding past the end
    L.pitch = (int)lmin((need + 27) / 32 * 32 + 4, 1LL << 30);
    buf = (long long)frames * L.pitch;
  } else {
    L.pitch = 0;
    buf = ((frames - 1) * stride + reach + 6 + 3) & ~3LL;
  }
  L.buf_floats = (int)lmin(buf, 1LL << 30);
  L.out_floats = (frames * (4 * groups + 1) + 3) & ~3;
  L.taps_floats = taps_in_smem ? groups * (L.steps + L.lag - 1) * 4 : 0;
  L.bytes = 4 * (kHeadFloats + (long long)L.taps_floats + L.out_floats +
                 2 * buf);
  return L;
}

// The first layout at these rates that fits a block. Rows when a frame's
// samples fall 16 or 32 floats apart and a frame has 8 groups: 32 frames
// of 16 groups (two items a warp), then of 8, 4, 2 or 1 groups, then 16
// frames, ...; a span otherwise: 1024 frames of one group, 4 a lane, then
// 256 (1 a lane), then fewer frames of more groups; each kind before the
// other when it fits no layout of its own; a launch of fewer tiles than
// SMs takes a span of one frame a lane (more, smaller tiles). The banded
// table in shared memory when hp fits a block, else through the
// read-only cache. false when none fits.
static bool plan_layout(int up, int down, int k_taps, Layout* out,
                        bool few_tiles = false) {
  const int phases = up * (4 / gcd(up, 4));
  const long long stride = (long long)phases / up * down;
  const int g = gcd((int)(stride % 32), 32);
  const int n_groups = phases / 4;
  const bool rows_first = g >= 16 && n_groups >= kWarps;
  const bool hp_fits = 4LL * up * k_taps <= (long long)kMaxBlockSmem;
  // (F, TF, GB) in order, rows then span
  static const int kRowsTry[][3] = {{1, 32, 16}, {1, 32, 8}, {1, 32, 4},
                                    {1, 32, 2},  {1, 32, 1}, {1, 16, 8},
                                    {1, 16, 4},  {1, 8, 8},  {1, 4, 8},
                                    {1, 2, 8},   {1, 1, 8}};
  static const int kSpanTry[][3] = {{4, 1024, 1}, {1, 256, 1}, {1, 128, 2},
                                    {1, 64, 4},   {1, 32, 8}};
  for (int smem_taps = hp_fits ? 1 : 0; smem_taps >= 0; --smem_taps)
    for (int pass = 0; pass < 2; ++pass) {
      const bool rows = (pass == 0) == rows_first;
      const int n = rows ? 11 : 5;
      for (int c = 0; c < n; ++c) {
        const int* f = rows ? kRowsTry[c] : kSpanTry[c];
        if (!rows && f[0] > 1 && few_tiles) continue;
        const Layout L =
            layout_of(up, down, k_taps, rows, f[0], f[1],
                      f[2] < n_groups ? f[2] : n_groups, smem_taps);
        if (L.bytes <= (long long)kMaxBlockSmem) {
          *out = L;
          return true;
        }
      }
    }
  return false;
}

// A tile's place: its part, output row, row of x and frame tile, and
// whether it computes anything (a row of x, an output below min(m,
// out_len)).
struct Tile {
  int part;
  int nf;  // its frames that hold an output below min(m, out_len)
  long long r, src, ft;
  bool live;
};

__device__ __forceinline__ void locate(const Plan& p, Tile* t) {
  const long long src = p.rows ? (long long)p.rows[t->r] : t->r;
  t->src = src < 0 || src >= p.n_src ? -1 : src;
  const long long first = t->ft * p.L.frames * p.phases +
                          4LL * t->part * p.L.groups;
  t->nf = (int)lmax(0, lmin(p.L.frames, p.need_frames - t->ft * p.L.frames));
  t->live = t->src >= 0 && first < lmin(p.m, p.out_len);
}

// Tile `tile` of the order part, row, frame tile.
__device__ __forceinline__ Tile tile_at(const Plan& p, long long tile) {
  Tile t;
  const long long per_part = (long long)p.n_rows * p.frame_tiles;
  t.part = (int)(tile / per_part);
  const long long rest = tile - t.part * per_part;
  t.r = rest / p.frame_tiles;
  t.ft = rest - t.r * p.frame_tiles;
  locate(p, &t);
  return t;
}

// The tile after t, without a division.
__device__ __forceinline__ Tile next_tile(const Plan& p, Tile t) {
  if (++t.ft == p.frame_tiles) {
    t.ft = 0;
    if (++t.r == p.n_rows) {
      t.r = 0;
      ++t.part;
    }
  }
  locate(p, &t);
  return t;
}

// The part's inputs: frame t's row holds x[t·D + lo + q], q in [0,
// reach); lo is the part's first window start, lagged Λ - 1 ahead.
struct Reach {
  long long lo, reach;
};

__device__ __forceinline__ Reach reach_of(const Plan& p, int part) {
  const int g0 = part * p.L.groups;
  const int g1 = (int)lmin(g0 + p.L.groups, p.n_groups) - 1;
  const long long c0 = phase_start(p, 4LL * g0);
  return {c0 - (p.L.lag - 1),
          phase_start(p, 4LL * g1) - c0 + p.L.steps + p.L.lag - 1};
}

// The part a block computes, in shared memory: its inputs' reach, and
// for each of its (at most 32) phases the offset in its group's window
// and its row of hp (delta·K); for each group its window's start after
// the part's first.
struct Part {
  Reach rc;
  int o[4 * kMaxGroups], row[4 * kMaxGroups], start[kMaxGroups];
};
static_assert(sizeof(Part) <= 4 * (kHeadFloats - 4), "the head holds a part");

// The bulk-copied cover of [lo_need, hi_need) in a row of x: the part
// inside the row rounded out to 16 bytes, within the tensor's aligned
// interior [t_lo, t_hi) (in the row's indices); empty (lo == hi) when
// nothing of the range lies in the row.
struct Cover {
  long long lo, hi, t_lo, t_hi;
};

__device__ __forceinline__ Cover cover_of(const Plan& p, const float* row,
                                          long long lo_need,
                                          long long hi_need) {
  const long long row_word = (long long)((uintptr_t)row >> 2);
  const long long x_word = (long long)((uintptr_t)p.x >> 2);
  Cover c;
  c.t_lo = ((x_word + 3) & ~3LL) - row_word;
  c.t_hi = ((x_word + p.n_src * p.n) & ~3LL) - row_word;
  const long long a = lmax(lo_need, 0), b = lmin(hi_need, p.n);
  c.lo = c.hi = b;
  if (a < b) {
    c.lo = lmax(a - ((row_word + a) & 3), c.t_lo);
    c.hi = lmin(b + ((4 - ((row_word + b) & 3)) & 3), c.t_hi);
    if (c.hi <= c.lo) c.lo = c.hi = b;
  }
  return c;
}

// Where row index lo_need of a staged range lands in its buffer: its
// offset e in its 16-byte unit (so that the copy's aligned source lands
// aligned), after the row's start; and the lag λ of the lane i & 31 that
// reads it. rows: row i starts at i·pitch, one quad later when e - λ is
// negative (see the header: e - λ ≡ lane / 8 mod 4 puts a warp's samples
// of a step in 32 banks); span: λ = lane / (32 / Λ).
struct Place {
  int base, lag;
};

__device__ __forceinline__ Place place_of(const Plan& p, const float* row,
                                          long long lo_need, int i) {
  const int e = (int)(((long long)((uintptr_t)row >> 2) + lo_need) & 3);
  Place pl;
  if (p.L.rows) {
    pl.lag = (e - ((i & 31) >> 3)) & 3;
    pl.base = i * p.L.pitch + (e < pl.lag ? 4 : 0) + e;
  } else {
    pl.lag = (i & 31) / (32 / p.L.lag);
    pl.base = e;
  }
  return pl;
}

// The range a tile's buffer row `i` holds (rows: frame i of the tile;
// span: the tile's frames up to its last needed one, i = 0), lo_need and
// its end.
__device__ __forceinline__ void range_of(const Plan& p, const Tile& t,
                                         const Reach& rc, int i,
                                         long long* lo_need,
                                         long long* hi_need) {
  const long long frame = t.ft * p.L.frames + i;
  *lo_need = frame * p.stride + rc.lo;
  *hi_need = *lo_need + rc.reach +
             (p.L.rows ? 0 : (long long)(t.nf - 1) * p.stride);
}

// Span: warp 0 copies tile t's range into `buf` by one bulk copy (lane 0)
// completing on `bar` (32 arrivals a phase, one a lane; a tile that
// computes nothing arrives with no bytes).
__device__ __forceinline__ void issue_span(const Plan& p, const Tile& t,
                                           const Reach& rc, float* buf,
                                           uint64_t* bar) {
  unsigned bytes = 0;
  float* dst = buf;
  const float* src = p.x;
  if (t.live && threadIdx.x == 0) {
    const float* row = p.x + t.src * p.n;
    long long lo_need, hi_need;
    range_of(p, t, rc, 0, &lo_need, &hi_need);
    const Cover c = cover_of(p, row, lo_need, hi_need);
    if (c.hi > c.lo) {
      bytes = (unsigned)(4 * (c.hi - c.lo));
      dst = buf + place_of(p, row, lo_need, 0).base + (c.lo - lo_need);
      src = row + c.lo;
    }
  }
  mbar_arrive_expect(bar, bytes);
  if (bytes) bulk_load(dst, src, bytes, bar);
}

// Rows: every warp copies its rows of tile t (row i by warp i mod 8) into
// `buf` in 16-byte cp.async chunks, a lane a chunk, as one commit group;
// a row's cover is a few hundred bytes, and one bulk copy per row (32 a
// tile) held the rows route at the copy engine's rate of requests.
__device__ __forceinline__ void stage_rows(const Plan& p, const Tile& t,
                                           const Reach& rc, float* buf) {
  if (t.live) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const float* row = p.x + t.src * p.n;
    long long lo0, hi0;
    range_of(p, t, rc, 0, &lo0, &hi0);
    const Cover c0 = cover_of(p, row, lo0, hi0);
    const long long hi_last = hi0 + (long long)(t.nf - 1) * p.stride;
    const int e = (int)(((long long)((uintptr_t)row >> 2) + lo0) & 3);
    if (p.stride % 4 == 0 && lo0 - 3 >= lmax(c0.t_lo, 0) &&
        hi_last + 3 <= lmin(c0.t_hi, p.n)) {
      // inside the row and the interior, every row at alignment e: row i
      // is [lo0 - e, ...) + i·D, rounded up to 16 bytes, at i·pitch (one
      // quad later for a lag above e)
      const int chunks = (e + (int)rc.reach + 3) >> 2;
      for (int i = warp; i < t.nf; i += kWarps) {
        float* dst = buf + i * p.L.pitch +
                     (e < ((e - ((i & 31) >> 3)) & 3) ? 4 : 0);
        const float* src = row + lo0 - e + (long long)i * p.stride;
        for (int k = lane; k < chunks; k += 32)
          __pipeline_memcpy_async(dst + 4 * k, src + 4 * k, 16);
      }
    } else {
      for (int i = warp; i < t.nf; i += kWarps) {
        long long lo_need, hi_need;
        range_of(p, t, rc, i, &lo_need, &hi_need);
        const Cover c = cover_of(p, row, lo_need, hi_need);
        float* dst =
            buf + place_of(p, row, lo_need, i).base + (c.lo - lo_need);
        const float* src = row + c.lo;
        const int chunks = (int)((c.hi - c.lo) >> 2);
        for (int k = lane; k < chunks; k += 32)
          __pipeline_memcpy_async(dst + 4 * k, src + 4 * k, 16);
      }
    }
  }
  __pipeline_commit();
}

// After each thread's copies landed: what the tensor's aligned interior
// cut off, read a float at a time, and zeros outside the row, over what
// the copy may have brought there (after a barrier: every thread's copies
// landed). Nothing to do for a tile whose every range lies inside the row
// and the interior with 3 floats to spare (all but a row's first and last
// tiles).
__device__ __forceinline__ void fix_tile(const Plan& p, const Tile& t,
                                         const Reach& rc, float* buf) {
  const float* row = p.x + t.src * p.n;
  const int n_ranges = p.L.rows ? t.nf : 1;
  long long lo_first, hi_first, lo_last, hi_last;
  range_of(p, t, rc, 0, &lo_first, &hi_first);
  range_of(p, t, rc, n_ranges - 1, &lo_last, &hi_last);
  const Cover c = cover_of(p, row, lo_first, hi_first);
  if (lo_first - 3 >= lmax(c.t_lo, 0) && hi_last + 3 <= lmin(c.t_hi, p.n))
    return;
  __syncthreads();  // every thread's copies have landed
  // rows: a warp a row (row i by warp i mod 8), its lanes along it; a
  // span: the block along it
  const int i0 = p.L.rows ? (int)threadIdx.x >> 5 : 0;
  const int di = p.L.rows ? kWarps : 1;
  const int k0 = p.L.rows ? (int)threadIdx.x & 31 : (int)threadIdx.x;
  const int dk = p.L.rows ? 32 : kThreads;
  for (int i = i0; i < n_ranges; i += di) {
    long long lo_need, hi_need;
    range_of(p, t, rc, i, &lo_need, &hi_need);
    const Cover ci = cover_of(p, row, lo_need, hi_need);
    float* xs = buf + place_of(p, row, lo_need, i).base - lo_need;
    const long long a = lmax(lo_need, 0), b = lmin(hi_need, p.n);
    for (long long k = a + k0; k < b && k < ci.lo; k += dk) xs[k] = row[k];
    for (long long k = lmax(ci.hi, a) + k0; k < b; k += dk) xs[k] = row[k];
    const long long z0 = lmin(hi_need, 0);
    for (long long k = lo_need + k0; k < z0; k += dk) xs[k] = 0.0f;
    for (long long k = lmax(p.n, lo_need) + k0; k < hi_need; k += dk)
      xs[k] = 0.0f;
  }
}

// Loads part `part` into shared memory (every thread; one barrier), then,
// with the taps in shared memory, its banded table: T[gl][v] holds, as a
// float4, the taps of the four phases of group part·GB + gl at window
// position w = v - (Λ - 1), hp[delta[s]][w - o[s]] inside [0, K), zero
// around.
template <bool kTapsInSmem>
__device__ __forceinline__ void load_part(const Plan& p, int part,
                                          Part* pt, float* taps_s) {
  const int g0 = part * p.L.groups;
  const int n_ph = 4 * (int)(lmin(g0 + p.L.groups, p.n_groups) - g0);
  if ((int)threadIdx.x < n_ph) {
    const long long s = 4LL * g0 + threadIdx.x;
    const long long c = phase_start(p, s);
    const long long c_g = phase_start(p, s & ~3LL);
    pt->o[threadIdx.x] = (int)(c - c_g);
    pt->row[threadIdx.x] =
        (int)(c * p.up - (s * p.down - p.half)) * p.k_taps;
    if ((threadIdx.x & 3) == 0)
      pt->start[threadIdx.x >> 2] = (int)(c_g - phase_start(p, 4LL * g0));
  }
  if (threadIdx.x == 0) pt->rc = reach_of(p, part);
  __syncthreads();
  if (!kTapsInSmem) return;
  // element i = sp·positions + v of the table, i = thread + 256·r: 16 of
  // a thread's loads in flight at a time (one at a time left the build,
  // a part's first, at a third of a tile's time at 48 kHz)
  const int positions = p.L.steps + p.L.lag - 1;
  const int total = n_ph * positions;
  const int d_sp = kThreads / positions, d_v = kThreads - d_sp * positions;
  int sp = (int)threadIdx.x / positions,
      v = (int)threadIdx.x - sp * positions;
  for (int i0 = threadIdx.x; i0 < total; i0 += 16 * kThreads) {
    float val[16];
    int at[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const bool in = i0 + u * kThreads < total;
      const int k = in ? v - (p.L.lag - 1) - pt->o[sp] : -1;
      val[u] = (unsigned)k < (unsigned)p.k_taps
                   ? __ldg(p.taps + pt->row[sp] + k) : 0.0f;
      at[u] = in ? ((sp >> 2) * positions + v) * 4 + (sp & 3) : -1;
      v += d_v;
      sp += d_sp;
      if (v >= positions) {
        v -= positions;
        ++sp;
      }
    }
#pragma unroll
    for (int u = 0; u < 16; ++u)
      if (at[u] >= 0) taps_s[at[u]] = val[u];
  }
}

// An item of a live tile, item = fb·GB + gl: frame block fb, group gl of
// the part; each lane kF frames 32 apart, four outputs each into the
// output tile, each float4 of taps serving the kF frames.
template <bool kTapsInSmem, int kF>
__device__ __forceinline__ void compute_item(const Plan& p, const Tile& t,
                                             const Part& pt, int item,
                                             const float* buf,
                                             const float* taps_s,
                                             float* outs) {
  const int lane = threadIdx.x & 31;
  const int fb = item / p.L.groups, gl = item - fb * p.L.groups;
  const int f = fb * 32 * kF + lane;  // the lane's first frame in the tile
  const int g = t.part * p.L.groups + gl;
  // frames past the tile's needed ones hold no output below m: their
  // samples were not staged, and their sums are never stored
  if (fb * 32 * kF >= t.nf || f >= p.L.frames || g >= p.n_groups) return;
  const float* row = p.x + t.src * p.n;
  long long lo_need, hi_need;
  range_of(p, t, pt.rc, p.L.rows ? f : 0, &lo_need, &hi_need);
  const Place pl = place_of(p, row, lo_need, f);
  // the sample of window position w = i - λ at step i, frame k at +k·fs
  const float* xs = buf + pl.base + (p.L.rows ? 0 : f * p.stride) +
                    pt.start[gl] + (p.L.lag - 1) - pl.lag;
  const int fs = 32 * (p.L.rows ? p.L.pitch : p.stride);
  float a[kF][4];
#pragma unroll
  for (int k = 0; k < kF; ++k) a[k][0] = a[k][1] = a[k][2] = a[k][3] = 0.0f;
  if (kTapsInSmem) {
    const float4* tp = reinterpret_cast<const float4*>(taps_s) +
                       gl * (p.L.steps + p.L.lag - 1) + (p.L.lag - 1) -
                       pl.lag;
    for (int i = 0; i < p.L.steps; i += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 h = tp[i + u];
#pragma unroll
        for (int k = 0; k < kF; ++k) {
          const float v = xs[k * fs + i + u];
          a[k][0] = fmaf(v, h.x, a[k][0]);
          a[k][1] = fmaf(v, h.y, a[k][1]);
          a[k][2] = fmaf(v, h.z, a[k][2]);
          a[k][3] = fmaf(v, h.w, a[k][3]);
        }
      }
    }
  } else {
    // hp's rows of the four phases, each from its offset in the window
    const float* hr[4];
    int o[4];
    for (int q = 0; q < 4; ++q) {
      o[q] = pt.o[4 * gl + q] + pl.lag;
      hr[q] = p.taps + pt.row[4 * gl + q];
    }
    for (int i = 0; i < p.L.steps; ++i) {
      float h[4];
      for (int q = 0; q < 4; ++q) {
        const int k = i - o[q];
        h[q] = (unsigned)k < (unsigned)p.k_taps ? __ldg(hr[q] + k) : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < kF; ++k) {
        const float v = xs[k * fs + i];
        a[k][0] = fmaf(v, h[0], a[k][0]);
        a[k][1] = fmaf(v, h[1], a[k][1]);
        a[k][2] = fmaf(v, h[2], a[k][2]);
        a[k][3] = fmaf(v, h[3], a[k][3]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kF; ++k) {
    float* o4 = outs + (f + 32 * k) * (4 * p.L.groups + 1) + 4 * gl;
    o4[0] = a[k][0];
    o4[1] = a[k][1];
    o4[2] = a[k][2];
    o4[3] = a[k][3];
  }
}

// The tile's outputs, consecutive outputs from consecutive threads: the
// output tile's values below min(m, out_len), zeros from m on, NaN for a
// row outside x.
__device__ __forceinline__ void write_tile(const Plan& p, const Tile& t,
                                           const float* outs) {
  const int g0 = t.part * p.L.groups;
  const int width = 4 * (int)(lmin(g0 + p.L.groups, p.n_groups) - g0);
  // output (f, q) of the tile is j = j0 + f·U + q; below `stored` it is
  // written, below `computed` it is the output tile's
  const long long j0 = t.ft * p.L.frames * p.phases + 4LL * g0;
  if (j0 >= p.out_len) return;
  const int stored = (int)lmin(p.out_len - j0, 0x7fffffffLL);
  const int computed =
      t.live ? (int)lmax(0, lmin(lmin(p.m, p.out_len) - j0, stored)) : 0;
  const float fill = t.src < 0 ? __int_as_float(0x7fc00000) : 0.0f;
  float* dst = p.out + t.r * p.out_len + j0;
  // (f, q) from f·width + q = thread index, stepped without a division
  int f = (int)threadIdx.x / width, q = (int)threadIdx.x - f * width;
  const int f_step = kThreads / width, q_step = kThreads - f_step * width;
  for (; f < p.L.frames; f += f_step) {
    const int j = f * p.phases + q;
    if (j < stored)
      dst[j] = j < computed ? outs[f * (4 * p.L.groups + 1) + q] : fill;
    q += q_step;
    if (q >= width) {
      q -= width;
      ++f;
    }
  }
}

template <bool kTapsInSmem, int kF>
__global__ void __launch_bounds__(kThreads, 2)
resample_kernel(Plan p) {
  extern __shared__ float smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  Part* pt = reinterpret_cast<Part*>(smem + 4);
  float* taps_s = smem + kHeadFloats;
  float* outs = taps_s + p.L.taps_floats;
  float* bufs = outs + p.L.out_floats;
  const long long first = blockIdx.x * p.n_tiles / gridDim.x;
  const long long last = (blockIdx.x + 1) * p.n_tiles / gridDim.x;
  if (first >= last) return;
  if (threadIdx.x == 0) {
    mbar_init(bar, 32);
    mbar_init(bar + 1, 32);
  }
  __syncthreads();
  Tile t = tile_at(p, first);
  // tile i's inputs go to buffer i & 1: rows by cp.async (one commit group
  // a tile), a span by a bulk copy whose k-th use of a buffer's mbarrier
  // waits on parity k & 1; the first tile's copies are in flight while the
  // block builds its table
  if (p.L.rows)
    stage_rows(p, t, reach_of(p, t.part), bufs);
  else if (threadIdx.x < 32)
    issue_span(p, t, reach_of(p, t.part), bufs, bar);
  int loaded = -1;  // the part in shared memory
  for (long long tile = first; tile < last; ++tile) {
    const int i = (int)(tile - first);
    float* buf = bufs + (i & 1) * p.L.buf_floats;
    if (t.live && t.part != loaded) {
      load_part<kTapsInSmem>(p, t.part, pt, taps_s);
      loaded = t.part;
    }
    const Tile next = next_tile(p, t);
    const bool more = tile + 1 < last;
    const Reach rc_next =
        next.part == loaded ? pt->rc : reach_of(p, next.part);
    float* buf_next = bufs + ((i + 1) & 1) * p.L.buf_floats;
    if (p.L.rows) {
      if (more)
        stage_rows(p, next, rc_next, buf_next);
      else
        __pipeline_commit();
      __pipeline_wait_prior(1);  // this tile's group has landed
    } else {
      if (threadIdx.x < 32 && more)
        issue_span(p, next, rc_next, buf_next, bar + ((i + 1) & 1));
      mbar_wait(bar + (i & 1), (i >> 1) & 1);
    }
    if (t.live) fix_tile(p, t, pt->rc, buf);
    __syncthreads();
    if (t.live) {
      const int items = p.L.groups * (p.L.frames > 32 * kF
                                          ? p.L.frames / (32 * kF) : 1);
      for (int item = threadIdx.x >> 5; item < items; item += kWarps)
        compute_item<kTapsInSmem, kF>(p, t, *pt, item, buf, taps_s, outs);
    }
    __syncthreads();
    write_tile(p, t, outs);
    t = next;
  }
}

// The instantiation a launch of this layout runs: taps in shared memory
// or through the read-only cache.
using Kernel = void (*)(Plan);
static Kernel kernel_for(const Layout& L) {
  if (L.per_lane == 4)
    return L.taps_floats ? resample_kernel<true, 4> : resample_kernel<false, 4>;
  return L.taps_floats ? resample_kernel<true, 1> : resample_kernel<false, 1>;
}

static std::mutex attribute_lock;

// Raises the kernel's dynamic shared-memory attribute to `bytes` if it
// holds less, never lowers it (a launch of another rate pair may need
// more). Called under attribute_lock.
static int raise_attribute(Kernel kernel, long long bytes) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  if (attr.maxDynamicSharedSizeBytes < bytes)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
  return (int)err;
}

// Resident blocks per SM of `kernel` at `bytes` on the current device,
// remembered per (device, kernel, bytes); raises the attribute first.
// Called under attribute_lock.
static int resident_blocks(Kernel kernel, long long bytes, int* blocks) {
  struct Entry {
    int device;
    Kernel kernel;
    long long bytes;
    int blocks;
  };
  static Entry seen[16];
  static int n_seen = 0;
  int device = 0;
  int err = (int)cudaGetDevice(&device);
  if (err != 0) return err;
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].device == device && seen[i].kernel == kernel &&
        seen[i].bytes == bytes) {
      *blocks = seen[i].blocks;
      return raise_attribute(kernel, bytes);
    }
  err = raise_attribute(kernel, bytes);
  if (err != 0) return err;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, kThreads, (size_t)bytes);
  if (err != 0) return err;
  seen[n_seen < 16 ? n_seen++ : (int)(bytes % 16)] = {device, kernel, bytes,
                                                      *blocks};
  return 0;
}

// Resamples rows of x (n_src rows of n samples) by up / down with the
// phase table `taps` (up x k_taps float32) of a filter whose centre is
// `half`: row r of out (n_rows x out_len) from row rows[r] of x (rows
// NULL: row r, n_rows == n_src), cut or zero-padded to out_len samples.
extern "C" int gat_resample(const float* x, const int* rows,
                            const float* taps, float* out, int n_src, int n,
                            int n_rows, int out_len, int up, int down,
                            int k_taps, int half, void* stream) {
  if (n_src < 1 || n < 1 || n_rows < 1 || out_len < 1 || up < 1 ||
      down < 1 || k_taps < 1 || half < 0 || (!rows && n_rows != n_src))
    return (int)cudaErrorInvalidValue;
  Plan p;
  if (!plan_layout(up, down, k_taps, &p.L)) return (int)cudaErrorInvalidValue;
  p.x = x;
  p.rows = rows;
  p.taps = taps;
  p.out = out;
  p.n_src = n_src;
  p.n = n;
  p.m = ((long long)n * up + down - 1) / down;
  p.out_len = out_len;
  p.n_rows = n_rows;
  p.up = up;
  p.down = down;
  p.k_taps = k_taps;
  p.half = half;
  p.phases = up * (4 / gcd(up, 4));
  p.stride = p.phases / up * down;
  const long long frames = ((long long)out_len + p.phases - 1) / p.phases;
  p.need_frames = (lmin(p.m, out_len) + p.phases - 1) / p.phases;
  // one frame holds every output: only the groups below out_len
  p.n_groups = (int)lmin(p.phases / 4, frames > 1 ? p.phases / 4
                                                  : (out_len + 3) / 4);
  int blocks = 0, sms = 0, device = 0;
  int status = (int)cudaGetDevice(&device);
  if (status == 0)
    status = (int)cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, device);
  if (status != 0) return status;
  for (int pass = 0; pass < 2; ++pass) {
    p.frame_tiles = (frames + p.L.frames - 1) / p.L.frames;
    const long long parts = (p.n_groups + p.L.groups - 1) / p.L.groups;
    p.n_tiles = parts * n_rows * p.frame_tiles;
    if (pass || p.L.rows || p.L.per_lane == 1 || p.n_tiles >= sms) break;
    plan_layout(up, down, k_taps, &p.L, true);  // few tiles: smaller ones
  }
  if ((long long)p.L.frames * p.phases > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;  // write_tile's 32-bit offsets
  const Kernel kernel = kernel_for(p.L);
  std::lock_guard<std::mutex> guard(attribute_lock);
  status = resident_blocks(kernel, p.L.bytes, &blocks);
  if (status != 0) return status;
  const long long grid = lmin(p.n_tiles, (long long)sms * lmax(blocks, 1));
  if (grid > 0x7fffffffLL || grid < 1) return (int)cudaErrorInvalidValue;
  kernel<<<(int)grid, kThreads, (size_t)p.L.bytes, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the launch at these rates, as the CUDA runtime
// computes it; raises the attribute as a launch does (never lowers it).
extern "C" int gat_resample_blocks_per_sm(int up, int down, int k_taps,
                                          int* blocks) {
  if (up < 1 || down < 1 || k_taps < 1) return (int)cudaErrorInvalidValue;
  Layout L;
  if (!plan_layout(up, down, k_taps, &L)) return (int)cudaErrorInvalidValue;
  std::lock_guard<std::mutex> guard(attribute_lock);
  return resident_blocks(kernel_for(L), L.bytes, blocks);
}

// A launch's layout at these rates, kLayoutFields ints: the outputs a
// tile computes (TF x 4·GB), the floats of one input buffer, of the
// banded table in shared memory (0: taps through the read-only cache),
// the shared memory a block in bytes (-1 when no layout fits a block),
// rows (1) or span (0), TF frames and GB groups a tile, the lags Λ, the
// steps S a thread walks, the phases U of a frame, and the frames F a
// lane computes.
extern "C" int gat_resample_layout(int up, int down, int k_taps,
                                   int* fields) {
  if (up < 1 || down < 1 || k_taps < 1) return (int)cudaErrorInvalidValue;
  Layout L = {};
  const bool fits = plan_layout(up, down, k_taps, &L);
  const int got[kLayoutFields] = {
      L.frames * 4 * L.groups, L.buf_floats, L.taps_floats,
      fits ? (int)L.bytes : -1, L.rows, L.frames, L.groups, L.lag, L.steps,
      up * (4 / gcd(up, 4)), L.per_lane};
  for (int i = 0; i < kLayoutFields; ++i) fields[i] = fits ? got[i] : -1;
  return 0;
}
