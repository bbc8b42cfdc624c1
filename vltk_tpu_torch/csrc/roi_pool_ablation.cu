// RoIPool ablation variants for Hopper (sm_90a): K6-K9.
//
// Replaces the four Pallas TPU kernels of tools/probe_roipool_ablation.py:
//   K6 pool             (body make_kernel)            modes full, v3, noP1, noP2, noBoth
//   K7 pool_contig      (body make_kernel_contig)     modes full, stackwrite, p1only, zeroOut
//   K8 pool_grouped     (body make_group_kernel)      v2 RoIPool, G RoIs per grid step
//   K9 pool_grouped_v3  (body make_group_kernel_v3)   v3 RoIPool, G RoIs per grid step
// They are variants of the separable-max RoIPool design that the shipped
// TPU kernel uses, made to time its phases; what each mode returns is
// written out in ops/roi_pool_ablation.py, the plain version.
//
// features (B, H, W, C) NHWC float32 or bf16, boxes (B, P, 4) xyxy float32
// in image coordinates (scale 1/16, 14 x 14 bins) -> (B, P, 14, 14, C), or
// (B, C/cb, P, 14, 14, cb) for K7.
//
// The table: one launch over the whole batch builds the row-range-max table
// T[l][b][y][x][c] = max(feat[b][y .. min(y + l, H - 1)][x][c]), l < max_bh,
// in a scratch the wrapper allocates (5 levels x 8.9 MB per image in bf16 at
// 52 x 84 x 1024). The TPU built it in VMEM at the first RoI of each (image,
// channel block) and carried it along its sequential grid; blocks on this
// card run in no order and share nothing, so the table goes through device
// memory. The build reads each cell's max_bh rows as one group of 16-byte
// loads and writes the running maxima to the levels. K6-K9 all read it.
//
// Bound on this card: memory. At the probe shape (B=8, 52 x 84 x 1024 bf16,
// P=300) the function reads a 71.6 MB map and writes 963 MB, ~0.31 ms at
// 3.35 TB/s; the table adds 358 MB written and read back.
//
// K6-K9: one register body, the output address a template parameter
// (K1's design, csrc/roi_pool.cu, applied to the table).
// - 16-byte vectors along C: a thread owns 8 bf16 or 4 float32 channels, so
//   a warp loads and stores 512 contiguous bytes. bf16 maxima are taken on
//   pairs with __hmax2_nan; float32 keeps the explicit NaN rule.
// - A thread owns kBins column bins of one RoI (the edges walked as K1's
//   BinWalk walks them) and all 14 row bins. For row bin i it loads the table
//   row (level rows_i - 1, row hs_i) over the cells of its column bins as one
//   unrolled group of predicated loads, takes the capped window maxima in
//   registers and stores bins (i, j). No shared memory: the TPU's rowmax
//   scratch (150 KB a block in the first port) is gone, so it no longer sets
//   how many blocks an SM runs.
// - Output: K6 writes bin (i, j) as C contiguous elements of
//   (B, P, 14, 14, C); K7 writes into the contiguous (14, 14, cb) tile of
//   (b, C/cb block, p): 16 threads x 8 channels cover cb = 128 of a bin.
//   Evict-first stores (st.global.cs), so the 0.96 GB stream does not push
//   the table out of L2.
// - Image-major order: the image is the slowest index of the flat thread
//   id, then (K67_SLAB, below) a slab of channels, then the RoI (the RoI
//   group for K8 and K9), so an image's table (44.7 MB in bf16) is read
//   while it sits in L2.
// - K8 and K9 (the v2 and v3 windows of K6 full and v3, NHWC): a thread
//   walks G RoIs p = pg G + k, k < G, in a loop, with the same channels and
//   column bins in each, so the flat id decodes once for G RoIs, as the TPU
//   kernel's grid step served G RoIs. G changes how the work is grouped,
//   not the values. The grid has G times fewer threads, and the threads an
//   SM holds read G times as many channels of an image's table as K6's at
//   once, so more of it misses L2: K8 and K9 run fewer, fatter threads
//   (K89_MIN_BLOCKS, below: ~120 registers, 4 blocks an SM).
// - Modes, each removing on the card the work it removed on the TPU:
//   noP1 reads feature row i (table level 0) in place of the table row;
//   noP2 and noBoth issue as many column loads per bin as full (at least
//   one, from column j) and copy the cell of column j instead of taking the
//   window maximum; p1only does full's loads and writes zeros; zeroOut
//   writes zeros alone; stackwrite (K7) loads the 14 row bins' cells of one
//   column as one group before any max, where full goes row bin by row bin.
//   A load whose result is otherwise dead is folded (bitwise OR) into a
//   value stored only when ``observe`` is nonzero, which no launch sets: it
//   keeps the load from being removed as dead code.
// - A scalar path (one element a thread) takes what the vector path cannot:
//   C (or K7's cb) not a multiple of the vector width, or features that are
//   not 16-byte aligned. The wrapper picks the path before launching.
//
// Exactness: every value is a max or a copy of input values, so all modes
// agree bitwise with the plain version (NaN in the same places). The
// sentinel -1e30 is rounded to the features' type; a bin whose max is at or
// below -5e29 (in float) is written as 0, as the TPU bodies do. NaN
// propagates as in torch.maximum.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int S = 14;          // output bins per side
constexpr float NEG = -1e30f;
constexpr float EMPTY_AT = -5e29f;  // NEG / 2

enum Mode { FULL = 0, V3 = 1, NOP1 = 2, NOP2 = 3, NOBOTH = 4, STACK = 5, P1ONLY = 6, ZERO = 7 };

__device__ __forceinline__ int round_half_away(float box) {
  const float s = __fmul_rn(box, 0.0625f);  // == box / 16, exactly
  return (int)(s >= 0.f ? floorf(__fadd_rn(s, 0.5f)) : ceilf(__fsub_rn(s, 0.5f)));
}

__device__ __forceinline__ int clampl(long long v, int lo, int hi) {
  return (int)(v < lo ? lo : (v > hi ? hi : v));
}

// max as torch.maximum: NaN wins
__device__ __forceinline__ float max_nan(float m, float v) {
  return (v > m || isnan(v)) ? (isnan(m) ? m : v) : m;
}

// ============================================================ K6-K9

// Block shape of K6-K9 and the build, three or four digits "bb u t" as
// K1's (221 is bb = 02):
//   bb  column bins a thread owns (01-14)
//   u   cells of a bin a thread loads in one unrolled, predicated group
//   t   threads a block, in units of 128
// K67_SLAB, the channels of the table that one wave of blocks reads (0: all
// C): the order is image, channel slab, RoI, so a smaller slab reads less
// of an image's table at a time. K89_MIN_BLOCKS: the blocks of K8 and K9 an
// SM must hold at once, __launch_bounds__'s second argument (0: none
// given); 1 lets ptxas spend registers on loads in flight, which K8 and K9
// need more than occupancy. tools/sweep_roipool_ablation.py builds others
// and times them on the probe's inputs; PERF.md has the rankings (221 with
// slabs of 256 channels came first; K89_MIN_BLOCKS 1 for K8 and K9).
#ifndef K67_SHAPE
#define K67_SHAPE 221
#endif
#ifndef K67_SLAB
#define K67_SLAB 256
#endif
#ifndef K89_MIN_BLOCKS
#define K89_MIN_BLOCKS 1
#endif

constexpr int kBins = K67_SHAPE / 100;
constexpr int kUnroll = K67_SHAPE / 10 % 10;
constexpr int kThreads = 128 * (K67_SHAPE % 10);
static_assert(kBins >= 1 && kBins <= 14 && kUnroll >= 1 && kThreads >= 128,
              "K67_SHAPE: want bb in 01-14, u >= 1, t >= 1");
static_assert(K67_SLAB >= 0, "K67_SLAB: want channels >= 0");
constexpr int kGroups = (S + kBins - 1) / kBins;
constexpr int kBuildGroup = 8;  // table levels a build thread loads in one group
#define K67_BOUNDS __launch_bounds__(kThreads)
#if K89_MIN_BLOCKS > 0
#define K89_BOUNDS __launch_bounds__(kThreads, K89_MIN_BLOCKS)
#else
#define K89_BOUNDS __launch_bounds__(kThreads)
#endif

template <typename To, typename From>
__device__ __forceinline__ To bit_cast(const From& x) {
  static_assert(sizeof(To) == sizeof(From), "bit_cast sizes");
  To y;
  memcpy(&y, &x, sizeof(To));
  return y;
}

// One thread's channels of a cell: N elements, loaded through the read-only
// path, stored evict-first (out) or normally (the table).
template <typename T, int N>
struct Cells;

template <>
struct Cells<__nv_bfloat16, 8> {
  static constexpr int N = 8;
  __nv_bfloat162 h[4];
  static __device__ __forceinline__ Cells fill(__nv_bfloat16 x) {
    Cells c;
#pragma unroll
    for (int k = 0; k < 4; ++k) c.h[k] = __bfloat162bfloat162(x);
    return c;
  }
  static __device__ __forceinline__ Cells neg() { return fill(__ushort_as_bfloat16(0xFF80)); }  // -inf
  static __device__ __forceinline__ Cells zero() { return fill(__ushort_as_bfloat16(0)); }
  static __device__ __forceinline__ Cells sentinel() { return fill(__float2bfloat16_rn(NEG)); }
  static __device__ __forceinline__ Cells load(const __nv_bfloat16* p) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    Cells c;
    c.h[0] = bit_cast<__nv_bfloat162>(u.x);
    c.h[1] = bit_cast<__nv_bfloat162>(u.y);
    c.h[2] = bit_cast<__nv_bfloat162>(u.z);
    c.h[3] = bit_cast<__nv_bfloat162>(u.w);
    return c;
  }
  __device__ __forceinline__ void max_with(const Cells& o) {
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __hmax2_nan(h[k], o.h[k]);
  }
  __device__ __forceinline__ void fold(const Cells& o) {
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = bit_cast<__nv_bfloat162>(bit_cast<unsigned>(h[k]) | bit_cast<unsigned>(o.h[k]));
  }
  // the TPU bodies' rule: a max at or below -5e29 is written as 0
  __device__ __forceinline__ void zero_low() {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      if (f.x <= EMPTY_AT) h[k].x = __ushort_as_bfloat16(0);
      if (f.y <= EMPTY_AT) h[k].y = __ushort_as_bfloat16(0);
    }
  }
  __device__ __forceinline__ uint4 bits() const {
    return make_uint4(bit_cast<unsigned>(h[0]), bit_cast<unsigned>(h[1]), bit_cast<unsigned>(h[2]),
                      bit_cast<unsigned>(h[3]));
  }
  __device__ __forceinline__ void store(__nv_bfloat16* p) const { __stcs(reinterpret_cast<uint4*>(p), bits()); }
  __device__ __forceinline__ void store_keep(__nv_bfloat16* p) const { *reinterpret_cast<uint4*>(p) = bits(); }
};

template <>
struct Cells<__nv_bfloat16, 1> {
  static constexpr int N = 1;
  __nv_bfloat16 h;
  static __device__ __forceinline__ Cells fill(__nv_bfloat16 x) {
    Cells c;
    c.h = x;
    return c;
  }
  static __device__ __forceinline__ Cells neg() { return fill(__ushort_as_bfloat16(0xFF80)); }
  static __device__ __forceinline__ Cells zero() { return fill(__ushort_as_bfloat16(0)); }
  static __device__ __forceinline__ Cells sentinel() { return fill(__float2bfloat16_rn(NEG)); }
  static __device__ __forceinline__ Cells load(const __nv_bfloat16* p) {
    return fill(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
  }
  __device__ __forceinline__ void max_with(const Cells& o) { h = __hmax_nan(h, o.h); }
  __device__ __forceinline__ void fold(const Cells& o) {
    h = __ushort_as_bfloat16(__bfloat16_as_ushort(h) | __bfloat16_as_ushort(o.h));
  }
  __device__ __forceinline__ void zero_low() {
    if (__bfloat162float(h) <= EMPTY_AT) h = __ushort_as_bfloat16(0);
  }
  __device__ __forceinline__ void store(__nv_bfloat16* p) const {
    __stcs(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(h));
  }
  __device__ __forceinline__ void store_keep(__nv_bfloat16* p) const { *p = h; }
};

template <>
struct Cells<float, 4> {
  static constexpr int N = 4;
  float4 v;
  static __device__ __forceinline__ Cells fill(float x) {
    Cells c;
    c.v = make_float4(x, x, x, x);
    return c;
  }
  static __device__ __forceinline__ Cells neg() { return fill(-INFINITY); }
  static __device__ __forceinline__ Cells zero() { return fill(0.f); }
  static __device__ __forceinline__ Cells sentinel() { return fill(NEG); }
  static __device__ __forceinline__ Cells load(const float* p) {
    Cells c;
    c.v = __ldg(reinterpret_cast<const float4*>(p));
    return c;
  }
  __device__ __forceinline__ void max_with(const Cells& o) {
    v.x = max_nan(v.x, o.v.x);
    v.y = max_nan(v.y, o.v.y);
    v.z = max_nan(v.z, o.v.z);
    v.w = max_nan(v.w, o.v.w);
  }
  __device__ __forceinline__ void fold(const Cells& o) {
    v.x = __uint_as_float(__float_as_uint(v.x) | __float_as_uint(o.v.x));
    v.y = __uint_as_float(__float_as_uint(v.y) | __float_as_uint(o.v.y));
    v.z = __uint_as_float(__float_as_uint(v.z) | __float_as_uint(o.v.z));
    v.w = __uint_as_float(__float_as_uint(v.w) | __float_as_uint(o.v.w));
  }
  __device__ __forceinline__ void zero_low() {
    if (v.x <= EMPTY_AT) v.x = 0.f;
    if (v.y <= EMPTY_AT) v.y = 0.f;
    if (v.z <= EMPTY_AT) v.z = 0.f;
    if (v.w <= EMPTY_AT) v.w = 0.f;
  }
  __device__ __forceinline__ void store(float* p) const { __stcs(reinterpret_cast<float4*>(p), v); }
  __device__ __forceinline__ void store_keep(float* p) const { *reinterpret_cast<float4*>(p) = v; }
};

template <>
struct Cells<float, 1> {
  static constexpr int N = 1;
  float v;
  static __device__ __forceinline__ Cells fill(float x) {
    Cells c;
    c.v = x;
    return c;
  }
  static __device__ __forceinline__ Cells neg() { return fill(-INFINITY); }
  static __device__ __forceinline__ Cells zero() { return fill(0.f); }
  static __device__ __forceinline__ Cells sentinel() { return fill(NEG); }
  static __device__ __forceinline__ Cells load(const float* p) { return fill(__ldg(p)); }
  __device__ __forceinline__ void max_with(const Cells& o) { v = max_nan(v, o.v); }
  __device__ __forceinline__ void fold(const Cells& o) { v = __uint_as_float(__float_as_uint(v) | __float_as_uint(o.v)); }
  __device__ __forceinline__ void zero_low() {
    if (v <= EMPTY_AT) v = 0.f;
  }
  __device__ __forceinline__ void store(float* p) const { __stcs(p, v); }
  __device__ __forceinline__ void store_keep(float* p) const { *p = v; }
};

// Walks i * r = q * S + m (0 <= m < S) one bin at a time, as K1 does: a
// thread's bin edges take two 64-bit divisions (a box far off the map must
// not overflow) instead of two a bin. Bin i spans [floor(i r / S),
// ceil((i + 1) r / S)) from the corner.
struct BinWalk {
  long long q, dq;
  int m, dm;
  __device__ __forceinline__ BinWalk(int i, long long r) {
    const long long n = i * r;
    q = n / S;
    m = (int)(n % S);
    dq = r / S;
    dm = (int)(r % S);
  }
  // [start, end) of the current bin, offset by lo and clipped to [0, n];
  // moves on to the next bin
  __device__ __forceinline__ void edges(int lo, int n, int& start, int& end) {
    start = clampl(q + lo, 0, n);
    q += dq;
    m += dm;
    if (m >= S) {
      ++q;
      m -= S;
    }
    end = clampl(q + (m > 0) + lo, 0, n);
  }
};

// The thread's (channel vector, column-bin group, RoI group, image) from its
// flat id (((b * slabs + slab) * R + pg) * groups + group) * vecs + vector in
// the slab, R = P / G RoI groups an image (K6 and K7: G = 1, the RoI): the
// image is the slowest index, so the order is image-major, then the channel
// slab (one slab of all C channels by default), then the RoI group.
template <typename I>
__device__ __forceinline__ void decode(I t, I vecs, I slabs, I R, I& cv, I& g, I& pg, I& b) {
  cv = t % vecs;
  t /= vecs;
  g = t % kGroups;
  t /= kGroups;
  pg = t % R;
  t /= R;
  cv += t % slabs * vecs;
  b = t / slabs;
}

// One RoI (roi = b P + p, of image b): V::N channels from c0 of kBins
// column bins from j0, all 14 row bins. CONTIG: the (B, C/cb, P, 14, 14,
// cb) layout of K7, else NHWC.
template <typename T, typename V, int MODE, bool CONTIG>
__device__ __forceinline__ void roi_body(const T* __restrict__ table, const float* __restrict__ boxes,
                                         T* __restrict__ out, int B, int H, int W, int C, int P, int max_bh,
                                         int max_bw, int cb, long long b, long long roi, int c0, int j0,
                                         int observe) {
  // bin (i, j) is written at o + (i * S + j) * step
  T* o;
  int step;
  if (CONTIG) {
    const int k = c0 / cb;
    o = out + ((b * (C / cb) + k) * P + (roi - b * P)) * S * S * cb + (c0 - k * cb);
    step = cb;
  } else {
    o = out + roi * S * S * C + c0;
    step = C;
  }
  if (MODE == ZERO) {
    for (int i = 0; i < S; ++i) {
#pragma unroll
      for (int jj = 0; jj < kBins; ++jj)
        if (j0 + jj < S) V::zero().store(o + (size_t)(i * S + j0 + jj) * step);
    }
    return;
  }

  const float* box = boxes + roi * 4;
  const int x1 = round_half_away(box[0]);
  const int y1 = round_half_away(box[1]);
  const int x2 = round_half_away(box[2]);
  const int y2 = round_half_away(box[3]);
  const long long roi_w = max(x2 - x1 + 1, 1);
  const long long roi_h = max(y2 - y1 + 1, 1);

  // the cells each column bin loads: [lo, lo + n) of a row
  int lo[kBins], n[kBins];
  int widest = 0;
  BinWalk cols(j0, roi_w);
#pragma unroll
  for (int jj = 0; jj < kBins; ++jj) {
    lo[jj] = n[jj] = 0;
    if (j0 + jj < S) {
      int ws, we;
      cols.edges(x1, W, ws, we);
      // the capped window: v3 inside [8 (ws / 8), + win), else v2 inside
      // [clip(ws, 0, W - max_bw), + max_bw) (ws >= 0 here)
      const int end = MODE == V3 ? min(we, ws / 8 * 8 + 2 * ((max_bw + 7) / 8) * 8)
                                 : min(we, min(ws, W - max_bw) + max_bw);
      const int cnt = max(end - ws, 0);
      if (MODE == NOP2 || MODE == NOBOTH) {
        // as many loads as the v2 window, from column j (j < 14 <= W)
        lo[jj] = j0 + jj;
        n[jj] = min(max(cnt, 1), W - lo[jj]);
      } else {
        lo[jj] = ws;
        n[jj] = cnt;
      }
    }
    widest = max(widest, n[jj]);
  }

  const size_t plane = (size_t)H * W * C;  // one image of one table level
  const size_t level_stride = (size_t)B * plane;
  const T* tab = table + (size_t)b * plane + c0;
  V sink = V::zero();  // loads whose result is otherwise dead
  BinWalk rows(0, roi_h);

  if (MODE == STACK) {
    // the 14 row bins' table rows, then per column of a bin one group of
    // 14 loads before any max
    const T* rp[S];
    unsigned live = 0;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      int hs, he;
      rows.edges(y1, H, hs, he);
      const int nr = min(max(he - hs, 0), max_bh);
      rp[i] = tab;
      if (nr > 0) {
        rp[i] = tab + (size_t)(nr - 1) * level_stride + (size_t)hs * W * C;
        live |= 1u << i;
      }
    }
#pragma unroll
    for (int jj = 0; jj < kBins; ++jj) {
      if (j0 + jj >= S) break;
      V acc[S];
#pragma unroll
      for (int i = 0; i < S; ++i) acc[i] = V::neg();
      for (int x = 0; x < n[jj]; ++x) {
        V v[S];
        const size_t col = (size_t)(lo[jj] + x) * C;
#pragma unroll
        for (int i = 0; i < S; ++i) v[i] = (live >> i & 1) ? V::load(rp[i] + col) : V::neg();
#pragma unroll
        for (int i = 0; i < S; ++i) acc[i].max_with(v[i]);
      }
#pragma unroll
      for (int i = 0; i < S; ++i) {
        V r = V::zero();
        if ((live >> i & 1) && n[jj] > 0) {
          r = acc[i];
          r.zero_low();
        }
        r.store(o + (size_t)(i * S + j0 + jj) * step);
      }
    }
    return;
  }

  for (int i = 0; i < S; ++i) {
    int hs, he;
    rows.edges(y1, H, hs, he);
    const int nr = min(max(he - hs, 0), max_bh);
    // noP1 / noBoth read feature row i (H >= 14), the others the table row
    // of the row bin: level nr - 1, row hs
    constexpr bool fixed_row = MODE == NOP1 || MODE == NOBOTH;
    const bool live = fixed_row || nr > 0;
    V val[kBins];
#pragma unroll
    for (int jj = 0; jj < kBins; ++jj) val[jj] = V::neg();
    if (live) {
      const T* row = fixed_row ? tab + (size_t)i * W * C : tab + (size_t)(nr - 1) * level_stride + (size_t)hs * W * C;
      for (int x0 = 0; x0 < widest; x0 += kUnroll) {
        V v[kBins][kUnroll];
#pragma unroll
        for (int jj = 0; jj < kBins; ++jj) {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int x = x0 + u;
            v[jj][u] = x < n[jj] ? V::load(row + (size_t)(lo[jj] + x) * C) : V::neg();
          }
        }
#pragma unroll
        for (int jj = 0; jj < kBins; ++jj) {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            if (MODE == FULL || MODE == V3 || MODE == NOP1) {
              val[jj].max_with(v[jj][u]);
            } else if (MODE == NOP2 || MODE == NOBOTH) {
              if (x0 + u == 0)
                val[jj] = v[jj][u];  // column j
              else
                sink.fold(v[jj][u]);
            } else {  // P1ONLY
              sink.fold(v[jj][u]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < kBins; ++jj) {
      if (j0 + jj >= S) continue;
      V r = V::zero();
      if (MODE == NOP2) {
        r = live ? val[jj] : V::sentinel();  // the raw sentinel for an empty row bin
      } else if (MODE == NOBOTH) {
        r = val[jj];
      } else if (MODE != P1ONLY && live && n[jj] > 0) {
        r = val[jj];
        r.zero_low();
      }
      r.store(o + (size_t)(i * S + j0 + jj) * step);
    }
  }
  if ((MODE == NOP2 || MODE == NOBOTH || MODE == P1ONLY) && observe) sink.store(o);
}

// One thread: the body for each of its G RoIs p = pg * G + k, k < G, in
// turn (GROUPED: K8 and K9, G = group; else G = 1). The loop amortises the
// decode over G RoIs, as the TPU's grid step amortised its cost over them.
template <typename T, typename V, int MODE, bool CONTIG, bool GROUPED>
__device__ __forceinline__ void ablation_body(const T* __restrict__ table, const float* __restrict__ boxes,
                                              T* __restrict__ out, int B, int H, int W, int C, int P, int max_bh,
                                              int max_bw, int cb, int slab, int group, long long total,
                                              int observe) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const int G = GROUPED ? group : 1;
  long long cv, g, roi0, b;  // roi0 = b P + pg G, the group's first RoI
  if (total <= 0xffffffffLL) {
    unsigned cv32, g32, pg32, b32;
    decode<unsigned>((unsigned)t, slab / V::N, C / slab, P / G, cv32, g32, pg32, b32);
    cv = cv32, g = g32, roi0 = b32 * P + pg32 * G, b = b32;
  } else {
    long long pg;
    decode<long long>(t, slab / V::N, C / slab, P / G, cv, g, pg, b);
    roi0 = b * P + pg * G;
  }
  const int c0 = (int)cv * V::N, j0 = (int)g * kBins;
  if (!GROUPED) {
    roi_body<T, V, MODE, CONTIG>(table, boxes, out, B, H, W, C, P, max_bh, max_bw, cb, b, roi0, c0, j0, observe);
    return;
  }
#pragma unroll 1
  for (int k = 0; k < G; ++k)
    roi_body<T, V, MODE, CONTIG>(table, boxes, out, B, H, W, C, P, max_bh, max_bw, cb, b, roi0 + k, c0, j0,
                                 observe);
}

// the table: thread per (image, row, column, channel vector); loads rows
// y .. y + L - 1 of its cells (those inside the map) in groups, and writes
// the running maxima to the L levels
template <typename T, typename V>
__device__ __forceinline__ void build_body(const T* __restrict__ feat, T* __restrict__ table, int H, int W, int C,
                                           int L, long long total) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const size_t e = (size_t)t * V::N;  // element index in (B, H, W, C)
  const size_t row = (size_t)W * C;
  const int y = (int)((e / row) % H);
  const size_t level = (size_t)total * V::N;
  V m = V::neg();
  for (int l0 = 0; l0 < L; l0 += kBuildGroup) {
    V v[kBuildGroup];
#pragma unroll
    for (int u = 0; u < kBuildGroup; ++u) {
      const int l = l0 + u;
      v[u] = l < L && y + l < H ? V::load(feat + e + l * row) : V::neg();
    }
#pragma unroll
    for (int u = 0; u < kBuildGroup; ++u) {
      if (l0 + u < L) {
        m.max_with(v[u]);
        m.store_keep(table + (l0 + u) * level + e);
      }
    }
  }
}

// one kernel per mode, layout, type and path, named so that -Xptxas -v
// tells them apart; BOUNDS: its __launch_bounds__
#define ABL_KERNEL(name, T, n, MODE, CONTIG, GROUPED, BOUNDS)                                                \
  __global__ void BOUNDS                                                                                      \
      name(const T* __restrict__ table, const float* __restrict__ boxes, T* __restrict__ out, int B, int H,   \
           int W, int C, int P, int max_bh, int max_bw, int cb, int slab, int group, long long total,         \
           int observe) {                                                                                     \
    ablation_body<T, Cells<T, n>, MODE, CONTIG, GROUPED>(table, boxes, out, B, H, W, C, P, max_bh, max_bw, cb, \
                                                         slab, group, total, observe);                        \
  }
#define ABL_MODE(mode, MODE, CONTIG, GROUPED, BOUNDS)                                              \
  ABL_KERNEL(roi_ablation_##mode##_bf16_vector, __nv_bfloat16, 8, MODE, CONTIG, GROUPED, BOUNDS) \
  ABL_KERNEL(roi_ablation_##mode##_bf16_scalar, __nv_bfloat16, 1, MODE, CONTIG, GROUPED, BOUNDS) \
  ABL_KERNEL(roi_ablation_##mode##_f32_vector, float, 4, MODE, CONTIG, GROUPED, BOUNDS)          \
  ABL_KERNEL(roi_ablation_##mode##_f32_scalar, float, 1, MODE, CONTIG, GROUPED, BOUNDS)
ABL_MODE(pool_full, FULL, false, false, K67_BOUNDS)
ABL_MODE(pool_v3, V3, false, false, K67_BOUNDS)
ABL_MODE(pool_noP1, NOP1, false, false, K67_BOUNDS)
ABL_MODE(pool_noP2, NOP2, false, false, K67_BOUNDS)
ABL_MODE(pool_noBoth, NOBOTH, false, false, K67_BOUNDS)
ABL_MODE(contig_full, FULL, true, false, K67_BOUNDS)
ABL_MODE(contig_stackwrite, STACK, true, false, K67_BOUNDS)
ABL_MODE(contig_p1only, P1ONLY, true, false, K67_BOUNDS)
ABL_MODE(contig_zeroOut, ZERO, true, false, K67_BOUNDS)
ABL_MODE(grouped_v2, FULL, false, true, K89_BOUNDS)
ABL_MODE(grouped_v3, V3, false, true, K89_BOUNDS)
#undef ABL_MODE
#undef ABL_KERNEL

#define ABL_BUILD(name, T, n)                                                                               \
  __global__ void __launch_bounds__(kThreads)                                                              \
      name(const T* __restrict__ feat, T* __restrict__ table, int H, int W, int C, int L, long long total) { \
    build_body<T, Cells<T, n>>(feat, table, H, W, C, L, total);                                            \
  }
ABL_BUILD(roi_ablation_build_bf16_vector, __nv_bfloat16, 8)
ABL_BUILD(roi_ablation_build_bf16_scalar, __nv_bfloat16, 1)
ABL_BUILD(roi_ablation_build_f32_vector, float, 4)
ABL_BUILD(roi_ablation_build_f32_scalar, float, 1)
#undef ABL_BUILD

template <typename T>
using AblationKernel = void (*)(const T*, const float*, T*, int, int, int, int, int, int, int, int, int, int,
                                long long, int);

template <typename T, int N>
int launch_pool(AblationKernel<T> kernel, const void* table, const void* boxes, void* out, int B, int H, int W, int C,
                int P, int max_bh, int max_bw, int cb, int group, cudaStream_t stream) {
  if (C % N || cb % N) return (int)cudaErrorInvalidValue;
  // the channel slab of a wave: K67_SLAB where it divides C into whole
  // vectors, else all of C
  const int slab = K67_SLAB > 0 && K67_SLAB < C && C % K67_SLAB == 0 && K67_SLAB % N == 0 ? K67_SLAB : C;
  const long long total = (long long)B * (P / group) * kGroups * (C / N);
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(static_cast<const T*>(table), static_cast<const float*>(boxes),
                                                    static_cast<T*>(out), B, H, W, C, P, max_bh, max_bw, cb, slab,
                                                    group, total, 0);
  return (int)cudaGetLastError();
}

template <typename T, int N>
int launch_build(void (*kernel)(const T*, T*, int, int, int, int, long long), const void* feat, void* table, int B,
                 int H, int W, int C, int L, cudaStream_t stream) {
  if (C % N) return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * H * W * (C / N);
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(static_cast<const T*>(feat), static_cast<T*>(table), H, W, C, L,
                                                    total);
  return (int)cudaGetLastError();
}

// the K6, K7 or K8 / K9 kernel of a mode, for a type and path
#define ABL_PICK(mode)                                                                                            \
  return dtype == 0 ? (vector ? launch_pool<float, 4>(roi_ablation_##mode##_f32_vector, ARGS)                     \
                              : launch_pool<float, 1>(roi_ablation_##mode##_f32_scalar, ARGS))                    \
                    : (vector ? launch_pool<__nv_bfloat16, 8>(roi_ablation_##mode##_bf16_vector, ARGS)            \
                              : launch_pool<__nv_bfloat16, 1>(roi_ablation_##mode##_bf16_scalar, ARGS))
#define ARGS table, boxes, out, B, H, W, C, P, max_bh, max_bw, cb, group, s
enum Variant { K6 = 0, K7 = 1, K8_K9 = 2 };

int pool_variant(int mode, int variant, const void* table, const void* boxes, void* out, int B, int H, int W, int C,
                 int P, int max_bh, int max_bw, int cb, int group, int dtype, bool vector, cudaStream_t s) {
  if (variant == K6) {
    switch (mode) {
      case FULL: ABL_PICK(pool_full);
      case V3: ABL_PICK(pool_v3);
      case NOP1: ABL_PICK(pool_noP1);
      case NOP2: ABL_PICK(pool_noP2);
      case NOBOTH: ABL_PICK(pool_noBoth);
    }
  } else if (variant == K7) {
    switch (mode) {
      case FULL: ABL_PICK(contig_full);
      case STACK: ABL_PICK(contig_stackwrite);
      case P1ONLY: ABL_PICK(contig_p1only);
      case ZERO: ABL_PICK(contig_zeroOut);
    }
  } else {
    switch (mode) {
      case FULL: ABL_PICK(grouped_v2);
      case V3: ABL_PICK(grouped_v3);
    }
  }
  return (int)cudaErrorInvalidValue;
}
#undef ARGS
#undef ABL_PICK

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

bool bad_args(int dtype, int vector, const void* table, const void* out) {
  return (dtype != 0 && dtype != 1) || (vector && (misaligned(table) || misaligned(out)));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. vector: 1 = the 16-byte path (C, and
// K7's cb, a multiple of 16 bytes' worth of elements; pointers 16-byte
// aligned), 0 = one element a thread. Each returns the cudaError_t of its
// launch. The wrapper has checked shapes, modes and divisibility.

// table (L, B, H, W, C) from features (B, H, W, C), L = max_bh levels
extern "C" int roi_ablation_build_table(const void* feat, void* table, int B, int H, int W, int C, int L,
                                        int dtype, int vector, void* stream) {
  if (B == 0 || H == 0 || W == 0 || C == 0) return 0;
  if (vector && (misaligned(feat) || misaligned(table))) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vector ? launch_build<float, 4>(roi_ablation_build_f32_vector, feat, table, B, H, W, C, L, s)
                  : launch_build<float, 1>(roi_ablation_build_f32_scalar, feat, table, B, H, W, C, L, s);
  if (dtype == 1)
    return vector ? launch_build<__nv_bfloat16, 8>(roi_ablation_build_bf16_vector, feat, table, B, H, W, C, L, s)
                  : launch_build<__nv_bfloat16, 1>(roi_ablation_build_bf16_scalar, feat, table, B, H, W, C, L, s);
  return (int)cudaErrorInvalidValue;
}

// K6; mode: 0 full, 1 v3, 2 noP1, 3 noP2, 4 noBoth
extern "C" int roi_ablation_pool(const void* table, const void* boxes, void* out, int B, int H, int W, int C,
                                 int P, int max_bh, int max_bw, int mode, int dtype, int vector, void* stream) {
  if (B == 0 || P == 0 || C == 0) return 0;
  if (bad_args(dtype, vector, table, out)) return (int)cudaErrorInvalidValue;
  return pool_variant(mode, K6, table, boxes, out, B, H, W, C, P, max_bh, max_bw, C, 1, dtype, vector,
                      static_cast<cudaStream_t>(stream));
}

// K7; mode: 0 full, 5 stackwrite, 6 p1only, 7 zeroOut; C % cb == 0
extern "C" int roi_ablation_pool_contig(const void* table, const void* boxes, void* out, int B, int H, int W,
                                        int C, int P, int max_bh, int max_bw, int mode, int cb, int dtype,
                                        int vector, void* stream) {
  if (B == 0 || P == 0 || C == 0) return 0;
  if (cb < 1 || C % cb || bad_args(dtype, vector, table, out)) return (int)cudaErrorInvalidValue;
  return pool_variant(mode, K7, table, boxes, out, B, H, W, C, P, max_bh, max_bw, cb, 1, dtype, vector,
                      static_cast<cudaStream_t>(stream));
}

// The compiled block shape (K67_SHAPE), channel slab (K67_SLAB) and K8/K9
// launch bound (K89_MIN_BLOCKS), for reports.
extern "C" int roi_ablation_shape() { return K67_SHAPE; }
extern "C" int roi_ablation_slab() { return K67_SLAB; }
extern "C" int roi_ablation_grouped_min_blocks() { return K89_MIN_BLOCKS; }

// K8 (v3 = 0) and K9 (v3 = 1), G = group RoIs a thread; P % group == 0
extern "C" int roi_ablation_pool_grouped(const void* table, const void* boxes, void* out, int B, int H, int W,
                                         int C, int P, int max_bh, int max_bw, int v3, int group, int dtype,
                                         int vector, void* stream) {
  if (B == 0 || P == 0 || C == 0) return 0;
  if (group < 1 || P % group || bad_args(dtype, vector, table, out)) return (int)cudaErrorInvalidValue;
  return pool_variant(v3 ? V3 : FULL, K8_K9, table, boxes, out, B, H, W, C, P, max_bh, max_bw, C, group, dtype,
                      vector, static_cast<cudaStream_t>(stream));
}
