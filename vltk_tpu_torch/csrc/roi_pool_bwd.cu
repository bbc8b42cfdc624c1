// K10: RoIPool backward for Hopper (sm_90a), with JAX's tie and NaN rule.
//
// Replaces: the VJP of the XLA sparse-table RoIPool, _roi_pool_xla in
// vltk_tpu/ops/pallas_kernels.py (the backward of roi_pool_pallas_ad, and
// JAX's RoIPool gradient on every backend; vltk_tpu/ops/roi_pool.py:roi_pool).
// No Pallas kernel computes it: like K2, it ports an XLA computation that
// the card's training path needs.
//
// What it computes: features (B, H, W, C) NHWC float32 or bf16, boxes
// (B, P, 4) xyxy float32, grad_out (B, P, S, S, C) -> grad_features
// (B, H, W, C) in the features' dtype. JAX's forward takes every bin's max
// as the max of four lookups in a table of power-of-two range maxima
// (two row windows of 2^kh rows, one from the bin's first row and one
// ending at its last, times two column windows of 2^kw columns), where a
// table entry is the max of two entries of the level below. JAX's max
// gives the cotangent to the operand equal to the result, half to each
// when both are, and nothing when the result is NaN. So a bin's cotangent
// goes down the four lookups and then every doubling step (rows first,
// then columns), halved at each tie: the shares are exact dyadic numbers
// set by equality tests alone. Every node that carries a share holds the
// bin's max m, and a node holds m exactly when its window has a cell equal
// to m, so the shares follow from the mask of the cells equal to m. An
// empty bin gives nothing, and so does a bin whose max is NaN. (For finite
// cotangents: JAX multiplies a NaN cotangent by zero shares too.)
//
// Bound on this card: bytes. At the training step (B=2, P=300, S=14,
// C=1024, bf16) grad_out is 240.8 MB, read once; the features (17.9 MB)
// are read and the gradient (17.9 MB) written once: 0.083 ms at 3.35 TB/s.
//
// Design: one block a tile of the gradient, one launch a call.
// - A tile is one image, a slab of V channels (16 bytes of them on the
//   vector path: 8 bf16 or 4 float32; one channel on the scalar path) and a
//   band of map rows: the whole map unless the planner
//   (ops/roi_pool_kernel.py:plan_backward) splits it to fit. Blocks run
//   slab-fastest, so neighbouring slabs of one image read the two 16-byte
//   halves of each 32-byte grad_out sector at about the same time.
// - The block stages the image's slab of the features in shared memory
//   (cp.async, 16 bytes a cell on the vector path; on the "l2" path, where
//   the map does not fit, it reads them through L1/L2 instead) and zeroes
//   float32 sums for its band's cells, also in shared memory.
// - Threads take the image's bins in a strided loop: neighbouring threads,
//   neighbouring bins, so their cells are neighbours too. A bin's edges
//   come from its RoI's four rounded corners in 32-bit arithmetic (K1's
//   rule); a bin neither of whose row windows meets the band is skipped,
//   as is a zero cotangent. One load brings the bin's V cotangents.
// - One pass over the bin's lookup cells keeps, per channel, the max (NaN
//   propagating), how many cells equal it and the slot of the cell that
//   last raised it (bf16 pairs through packed compares). A channel with
//   one such cell adds its cotangent there: one shared-memory atomic.
// - A tie where every lookup cell equals the max (a plateau: a relu map's
//   zeros) needs no mask: the shares follow from the geometry. Any other
//   tie walks the table's trees on the equality mask, read again from the
//   cells for every tied channel at once (16-byte rows, packed compares):
//   one pass finds the rows of each lookup that meet the mask, a second
//   takes each row's mask and gives each tied cell g times the sum of its
//   dyadic shares over the lookups that hold it (one atomic a cell).
// - The block writes its tile once, cast to the features' type (bf16: one
//   round to nearest even of the float32 sum).
// Nothing goes through device memory but grad_out (once), the features
// (once a band) and the gradient (once): no scratch, no zero-fill, no
// global atomic, no second launch. The shared-memory atomics leave the
// order of a cell's float32 sum to the schedule, so on random cotangents
// the result varies in the last bits from run to run; dyadic cotangents
// sum exactly in any order.
//
// What sets the pace on this card: Hopper has no float add in shared
// memory, so each atomicAdd is a compare-and-swap loop (ATOMS.CAST.SPIN in
// the SASS; red.shared.add.f32 compiles to the same), and lanes that hit
// one cell (the many bins of a small RoI) retry. The adds, the scans and
// the tie walks take the time; the bytes do not. The code's shape matters
// as much (tools/bench_roipool_bwd.py times edited copies): the tie walk
// unrolled over the channels (one inlined copy each) runs several times
// slower than the rolled loop below, while the single-cell adds stay
// unrolled (rolled, they were no faster on the training step's own
// inputs); 1024 threads a block (64 registers, a few bytes spilled) beat
// 512 and 768.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxTableBin = 15;    // the largest bin extent the 16-bit row masks hold
constexpr int kSafeCorner = 1 << 20;  // corners within this keep the bin rule in 32 bits

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, 4);
  return u;
}
__device__ __forceinline__ __nv_bfloat162 as_bf2(uint32_t u) {
  __nv_bfloat162 v;
  memcpy(&v, &u, 4);
  return v;
}

// a 16-byte load from shared memory or, read-only, from device memory
template <bool SHARED>
__device__ __forceinline__ uint4 load16(const void* p) {
  if constexpr (SHARED) return *reinterpret_cast<const uint4*>(p);
  else return __ldg(reinterpret_cast<const uint4*>(p));
}
template <bool SHARED, typename T>
__device__ __forceinline__ T load1(const T* p) {
  if constexpr (SHARED) return *p;
  else return __ldg(p);
}

// V elements at p as floats
template <typename T, int V, bool SHARED>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    const uint4 raw = load16<SHARED>(p);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if constexpr (sizeof(T) == 2) {
        v[2 * k] = __uint_as_float(w[k] << 16);
        v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
      } else {
        v[k] = __uint_as_float(w[k]);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = to_float(load1<SHARED>(p + k));
  }
}

// the reference's rounding of a scaled corner, as K1 and the plain version
__device__ __forceinline__ int round_half_away(float box, float scale) {
  float s = __fmul_rn(box, scale);
  return (int)(s >= 0.f ? floorf(__fadd_rn(s, 0.5f)) : ceilf(__fsub_rn(s, 0.5f)));
}

// n / d for any 32-bit n by a multiply-high: m = ceil(2^32 / d) gives the
// quotient or one more, and one compare corrects it (d = 1 passes n)
struct Divider {
  uint32_t d, m;
  __device__ __forceinline__ explicit Divider(uint32_t d_) : d(d_), m(d_ > 1 ? (uint32_t)(0xffffffffull / d_) + 1 : 0) {}
  __device__ __forceinline__ uint32_t operator()(uint32_t n) const {
    if (d == 1) return n;
    const uint32_t q = __umulhi(n, m);
    return q - (q * d > n);
  }
};

__device__ __forceinline__ int clampl(long long v, int lo, int hi) {
  return (int)(v < lo ? lo : (v > hi ? hi : v));
}

// One bin of one RoI: its edges, its table levels, and its lookup cells as
// slots (rows 0..nr-1: the first nh from hs, the rest ending at he; the two
// windows coincide for a power-of-two extent and cover the bin for one
// within the table's levels; columns likewise).
struct Bin {
  int hs, he, ws, we, kh, kw, nh, nw, nr, nc;

  __device__ __forceinline__ int row(int r) const { return r < nh ? hs + r : he - nr + r; }
  __device__ __forceinline__ int col(int q) const { return q < nw ? ws + q : we - nc + q; }
  // does either row window meet the band [r0, r1)?
  __device__ __forceinline__ bool meets(int r0, int r1) const {
    return (hs < r1 && hs + nh > r0) || (he - nh < r1 && he > r0);
  }
};

// Bin (i, j) of the RoI `box`: K1's bin rule (floor(i R / S), ceil((i + 1) R
// / S) from the corner, clipped to the map). False for an empty bin.
__device__ __forceinline__ bool decode(const float* box, float scale, int i, int j, const Divider& by_s, int H,
                                       int W, int max_bin_h, int max_bin_w, Bin& bin) {
  const int S = (int)by_s.d;
  const int x1 = round_half_away(__ldg(box), scale);
  const int y1 = round_half_away(__ldg(box + 1), scale);
  const int x2 = round_half_away(__ldg(box + 2), scale);
  const int y2 = round_half_away(__ldg(box + 3), scale);
  const bool small = x1 > -kSafeCorner && x1 < kSafeCorner && y1 > -kSafeCorner && y1 < kSafeCorner &&
                     x2 > -kSafeCorner && x2 < kSafeCorner && y2 > -kSafeCorner && y2 < kSafeCorner;
  if (small) {  // every product below stays under 2^31 (S <= 512, the entry's check)
    const int roi_w = max(x2 - x1 + 1, 1), roi_h = max(y2 - y1 + 1, 1);
    bin.hs = min(max((int)by_s(i * roi_h) + y1, 0), H);
    bin.he = min(max((int)by_s((i + 1) * roi_h + S - 1) + y1, 0), H);
    bin.ws = min(max((int)by_s(j * roi_w) + x1, 0), W);
    bin.we = min(max((int)by_s((j + 1) * roi_w + S - 1) + x1, 0), W);
  } else {  // corners far off the map: the plain version's 64-bit rule
    const long long roi_w = max((long long)x2 - x1 + 1, 1LL), roi_h = max((long long)y2 - y1 + 1, 1LL);
    bin.hs = clampl(i * roi_h / S + y1, 0, H);
    bin.he = clampl(((i + 1) * roi_h + S - 1) / S + y1, 0, H);
    bin.ws = clampl(j * roi_w / S + x1, 0, W);
    bin.we = clampl(((j + 1) * roi_w + S - 1) / S + x1, 0, W);
  }
  const int lh = bin.he - bin.hs, lw = bin.we - bin.ws;
  if (lh <= 0 || lw <= 0) return false;  // an empty bin: 0, no gradient
  bin.kh = 31 - __clz(min(lh, max_bin_h));
  bin.kw = 31 - __clz(min(lw, max_bin_w));
  bin.nh = 1 << bin.kh;
  bin.nw = 1 << bin.kw;
  bin.nr = min(lh, 2 * bin.nh);
  bin.nc = min(lw, 2 * bin.nw);
  return true;
}

// The cells of one image's channel slab: shared memory [H * W][V] when
// staged, else the features in device memory (a cell every C elements).
template <typename T, int V, bool STAGED>
struct Cells {
  const T* base;
  int stride, W;
  __device__ __forceinline__ const T* at(int y, int x) const { return base + (size_t)(y * W + x) * stride; }
};

// x[i] for an index known only at run time, by selects: the array stays in
// registers
template <typename X, int N>
__device__ __forceinline__ X pick(const X (&x)[N], int i) {
  X v = x[0];
#pragma unroll
  for (int j = 1; j < N; ++j) v = i == j ? x[j] : v;
  return v;
}

// Per channel over the bin's cells: the max, how many cells equal it, the
// slot (r * 16 + q) of the cell that last raised it, and whether a cell is
// NaN. Float for float32 and the scalar path, one channel a word of the
// equality masks (kWords words, 16 bits a channel).
template <typename T, int V>
struct Scan {
  static constexpr int kWords = V;
  float m[V];
  int n[V], s[V];
  bool nan[V];

  __device__ __forceinline__ Scan() {
#pragma unroll
    for (int k = 0; k < V; ++k) m[k] = -INFINITY, n[k] = 0, s[k] = 0, nan[k] = false;
  }
  template <bool SHARED>
  __device__ __forceinline__ void add(const T* cell, int slot) {
    float v[V];
    load_vec<T, V, SHARED>(cell, v);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const bool gt = v[k] > m[k];
      nan[k] |= v[k] != v[k];
      n[k] = gt ? 1 : n[k] + (v[k] == m[k]);
      s[k] = gt ? slot : s[k];
      m[k] = gt ? v[k] : m[k];
    }
  }
  // bit q of each channel's word: the cell equals the channel's max
  template <bool SHARED>
  __device__ __forceinline__ void eq_bits(const T* cell, uint32_t q_bit, uint32_t (&bits)[kWords]) const {
    float v[V];
    load_vec<T, V, SHARED>(cell, v);
#pragma unroll
    for (int k = 0; k < V; ++k) bits[k] |= v[k] == m[k] ? q_bit : 0u;
  }
  __device__ __forceinline__ static uint32_t replicate(uint32_t x) { return x; }
  __device__ __forceinline__ static uint32_t nonzero(uint32_t x) { return x != 0; }  // 1 a nonzero channel
  __device__ __forceinline__ static uint32_t lane(const uint32_t (&w)[kWords], int k) { return pick(w, k); }
  __device__ __forceinline__ static uint32_t lanes(uint32_t channels, int word) { return ((channels >> word) & 1) ? 0xffffu : 0u; }
  __device__ __forceinline__ bool is_nan(int k) const { return nan[k]; }
  __device__ __forceinline__ int count(int k) const { return n[k]; }
  __device__ __forceinline__ int slot(int k) const { return s[k]; }
};

// The bf16 vector path: the same on pairs of channels, 16 bits a channel
// in each word (max with NaN propagating, compares as masks).
template <>
struct Scan<__nv_bfloat16, 8> {
  static constexpr int kWords = 4;
  uint32_t m[4], n[4], s[4];

  __device__ __forceinline__ Scan() {
#pragma unroll
    for (int k = 0; k < 4; ++k) m[k] = 0xff80ff80u, n[k] = 0, s[k] = 0;  // -inf, -inf
  }
  template <bool SHARED>
  __device__ __forceinline__ void add(const __nv_bfloat16* cell, int slot) {
    const uint4 raw = load16<SHARED>(cell);
    const uint32_t v[4] = {raw.x, raw.y, raw.z, raw.w};
    const uint32_t slot2 = (uint32_t)slot * 0x00010001u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 a = as_bf2(v[k]), b = as_bf2(m[k]);
      const uint32_t gt = __hgt2_mask(a, b), eq = __heq2_mask(a, b);
      n[k] = (n[k] & ~gt) + ((gt | eq) & 0x00010001u);
      s[k] = (slot2 & gt) | (s[k] & ~gt);
      m[k] = as_u32(__hmax2_nan(b, a));
    }
  }
  template <bool SHARED>
  __device__ __forceinline__ void eq_bits(const __nv_bfloat16* cell, uint32_t q_bit, uint32_t (&bits)[4]) const {
    const uint4 raw = load16<SHARED>(cell);
    const uint32_t v[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) bits[k] |= __heq2_mask(as_bf2(v[k]), as_bf2(m[k])) & q_bit;
  }
  __device__ __forceinline__ static uint32_t replicate(uint32_t x) { return x * 0x00010001u; }
  // 1 in each half that is nonzero (halves below 2^15)
  __device__ __forceinline__ static uint32_t nonzero(uint32_t x) { return ((x + 0x7fff7fffu) >> 15) & 0x00010001u; }
  __device__ __forceinline__ static uint32_t lane(const uint32_t (&w)[4], int k) {
    return (pick(w, k >> 1) >> ((k & 1) * 16)) & 0xffffu;
  }
  __device__ __forceinline__ static uint32_t lanes(uint32_t channels, int word) {
    return (((channels >> (2 * word)) & 1) ? 0xffffu : 0u) | (((channels >> (2 * word + 1)) & 1) ? 0xffff0000u : 0u);
  }
  __device__ __forceinline__ bool is_nan(int k) const { return isnan(__uint_as_float(lane(m, k) << 16)); }
  __device__ __forceinline__ int count(int k) const { return (int)lane(n, k); }
  __device__ __forceinline__ int slot(int k) const { return (int)lane(s, k); }
};

// The factor of the doubling steps below a lookup for the cell at
// position `pos` of its 2^k window: one half at every level where the
// other half of the cell's block also meets the mask (`hits`, one bit a
// position of the window).
__device__ __forceinline__ float tree_share(uint32_t hits, int pos, int k) {
  float share = 1.f;
  for (int level = k; level >= 1; --level) {
    const int half = 1 << (level - 1);
    const int base = pos & ~((1 << level) - 1);
    const int sibling = (pos & half) ? base : base + half;
    if ((hits >> sibling) & ((1u << half) - 1)) share *= 0.5f;
  }
  return share;
}

// The equality masks of one slot row, every tied channel at once: bit q of
// a channel's 16 bits for the cell at column slot q.
template <typename T, int V, bool STAGED>
__device__ __forceinline__ void row_bits(const Cells<T, V, STAGED>& cells, const Bin& bin, const Scan<T, V>& scan,
                                         int y, const uint32_t (&tied)[Scan<T, V>::kWords],
                                         uint32_t (&bits)[Scan<T, V>::kWords]) {
  using S = Scan<T, V>;
#pragma unroll
  for (int w = 0; w < S::kWords; ++w) bits[w] = 0;
  for (int q = 0; q < bin.nc; ++q) scan.template eq_bits<STAGED>(cells.at(y, bin.col(q)), S::replicate(1u << q), bits);
#pragma unroll
  for (int w = 0; w < S::kWords; ++w) bits[w] &= tied[w];
}

// The tied channels (bit k of `ties`): each cotangent goes down the four
// lookups' trees on its channel's equality mask, into the band's cells.
// Pass 1 reads the bin's rows and keeps, per channel, the rows of each
// lookup that meet the mask inside its columns; pass 2 reads the rows that
// do again and gives each tied cell g times the sum of its shares over the
// lookups that hold it (one atomic a cell).
template <typename T, int V, bool STAGED>
__device__ __forceinline__ void add_ties(const Cells<T, V, STAGED>& cells, const Bin& bin, const Scan<T, V>& scan,
                                         const float (&g)[V], uint32_t ties, float* __restrict__ sums, int r0,
                                         int r1, int W) {
  using S = Scan<T, V>;
  constexpr int kW = S::kWords;
  const int r_hi = bin.nr - bin.nh, c_hi = bin.nc - bin.nw;  // first slot of each second window
  const uint32_t wmask = S::replicate((1u << bin.nw) - 1);
  uint32_t tied[kW], h00[kW], h01[kW], h10[kW], h11[kW], bits[kW];
#pragma unroll
  for (int w = 0; w < kW; ++w) tied[w] = S::lanes(ties, w), h00[w] = h01[w] = h10[w] = h11[w] = 0;
  for (int r = 0; r < bin.nr; ++r) {
    row_bits(cells, bin, scan, bin.row(r), tied, bits);
#pragma unroll
    for (int w = 0; w < kW; ++w) {
      const uint32_t in0 = S::nonzero(bits[w] & wmask), in1 = S::nonzero((bits[w] >> c_hi) & wmask);
      if (r < bin.nh) h00[w] |= in0 << r, h01[w] |= in1 << r;
      if (r >= r_hi) h10[w] |= in0 << (r - r_hi), h11[w] |= in1 << (r - r_hi);
    }
  }
  for (int r = 0; r < bin.nr; ++r) {
    const int y = bin.row(r);
    if (y < r0 || y >= r1) continue;  // another band's row
    uint32_t hit = 0;
#pragma unroll
    for (int w = 0; w < kW; ++w) {
      if (r < bin.nh) hit |= (h00[w] | h01[w]) >> r;
      if (r >= r_hi) hit |= (h10[w] | h11[w]) >> (r - r_hi);
    }
    if (!(hit & S::replicate(1))) continue;  // no tied cell in this row
    row_bits(cells, bin, scan, y, tied, bits);
    float* row_sums = sums + (size_t)(y - r0) * W * V;
    for (uint32_t left_k = ties; left_k; left_k &= left_k - 1) {  // rolled: one body for every channel
      const int k = __ffs(left_k) - 1;
      const uint32_t b = S::lane(bits, k);
      if (!b) continue;
      const uint32_t c00 = S::lane(h00, k), c01 = S::lane(h01, k), c10 = S::lane(h10, k), c11 = S::lane(h11, k);
      // out = max(max(L00, L01), max(L10, L11)): each lookup's share, then
      // the row trees' factors of this row for column windows 0 and 1
      const bool side0 = c00 | c01, side1 = c10 | c11;
      float f0 = 0.f, f1 = 0.f;
      if (r < bin.nh) {
        const float l = side1 ? 0.5f : 1.f;
        if ((c00 >> r) & 1) f0 += l * (c01 ? 0.5f : 1.f) * tree_share(c00, r, bin.kh);
        if ((c01 >> r) & 1) f1 += l * (c00 ? 0.5f : 1.f) * tree_share(c01, r, bin.kh);
      }
      if (r >= r_hi) {
        const int rr = r - r_hi;
        const float l = side0 ? 0.5f : 1.f;
        if ((c10 >> rr) & 1) f0 += l * (c11 ? 0.5f : 1.f) * tree_share(c10, rr, bin.kh);
        if ((c11 >> rr) & 1) f1 += l * (c10 ? 0.5f : 1.f) * tree_share(c11, rr, bin.kh);
      }
      const uint32_t w0 = b & ((1u << bin.nw) - 1), w1 = (b >> c_hi) & ((1u << bin.nw) - 1);
      for (uint32_t left = b; left; left &= left - 1) {
        const int q = __ffs(left) - 1;
        float share = 0.f;
        if (q < bin.nw) share += f0 * tree_share(w0, q, bin.kw);
        if (q >= c_hi) share += f1 * tree_share(w1, q - c_hi, bin.kw);
        atomicAdd(row_sums + bin.col(q) * V + k, pick(g, k) * share);
      }
    }
  }
}

// The channels (bit k of `plateaus`) whose every lookup cell equals the
// max: every node of every tree ties, so a cell's share is 2^-(kh+kw+2)
// (the two halvings of the outer maxima, one a doubling step) times the
// number of row windows and of column windows that hold it.
template <int V>
__device__ __forceinline__ void add_plateaus(const Bin& bin, const float (&g)[V], uint32_t plateaus,
                                             float* __restrict__ sums, int r0, int r1, int W) {
  const int r_hi = bin.nr - bin.nh, c_hi = bin.nc - bin.nw;
  const float unit = ldexpf(0.25f, -(bin.kh + bin.kw));
  for (int r = 0; r < bin.nr; ++r) {
    const int y = bin.row(r);
    if (y < r0 || y >= r1) continue;  // another band's row
    const float row_share = unit * (float)((r < bin.nh) + (r >= r_hi));
    float* row_sums = sums + (size_t)(y - r0) * W * V;
    for (int q = 0; q < bin.nc; ++q) {
      const float share = row_share * (float)((q < bin.nw) + (q >= c_hi));
      float* cell = row_sums + bin.col(q) * V;
#pragma unroll
      for (int k = 0; k < V; ++k)
        if ((plateaus >> k) & 1) atomicAdd(cell + k, g[k] * share);
    }
  }
}

// the staged slab's bytes, rounded up to 16 so that the sums after it stay
// aligned
__host__ __device__ constexpr long long staged_bytes(long long cells, int cell_bytes) {
  return (cells * cell_bytes + 15) / 16 * 16;
}

// The body of every K10 kernel: one tile (image, channel slab, row band).
template <typename T, int V, bool STAGED>
__device__ __forceinline__ void tile(const T* __restrict__ feat, const float* __restrict__ boxes,
                                     const T* __restrict__ gout, T* __restrict__ out, int H, int W, int C, int P,
                                     int S, float scale, int max_bin_h, int max_bin_w, int slabs, int bands,
                                     int band_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int slab = blockIdx.x % slabs;
  const int band = blockIdx.x / slabs % bands;
  const int b = blockIdx.x / slabs / bands;
  const int c0 = slab * V;
  const int r0 = band * band_rows, r1 = min(H, r0 + band_rows);
  const int HW = H * W;
  const T* img = feat + (size_t)b * HW * C + c0;
  T* staged = reinterpret_cast<T*>(smem);
  float* sums = reinterpret_cast<float*>(smem + (STAGED ? staged_bytes(HW, V * (int)sizeof(T)) : 0));

  if constexpr (STAGED) {
    if constexpr (V * sizeof(T) == 16) {
      for (int cell = threadIdx.x; cell < HW; cell += kThreads) {
        const uint32_t dst = (uint32_t)__cvta_generic_to_shared(staged + cell * V);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(img + (size_t)cell * C));
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    } else {
      for (int cell = threadIdx.x; cell < HW; cell += kThreads)
#pragma unroll
        for (int k = 0; k < V; ++k) staged[cell * V + k] = __ldg(img + (size_t)cell * C + k);
    }
  }
  const int n_sums = (r1 - r0) * W * V;
  for (int e = threadIdx.x; e < n_sums / 4; e += kThreads)
    reinterpret_cast<float4*>(sums)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int e = n_sums / 4 * 4 + threadIdx.x; e < n_sums; e += kThreads) sums[e] = 0.f;
  if constexpr (STAGED && V * sizeof(T) == 16) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const Cells<T, V, STAGED> cells{STAGED ? staged : img, STAGED ? V : C, W};
  const int SS = S * S, nbins = P * SS;
  const Divider by_s(S), by_ss(SS);
  const float* img_boxes = boxes + (size_t)b * P * 4;
  const T* img_gout = gout + (size_t)b * nbins * C + c0;
  for (int t = threadIdx.x; t < nbins; t += kThreads) {
    const int p = (int)by_ss(t), ij = t - p * SS, i = (int)by_s(ij), j = ij - i * S;
    Bin bin;
    if (!decode(img_boxes + 4 * p, scale, i, j, by_s, H, W, max_bin_h, max_bin_w, bin)) continue;
    if (!bin.meets(r0, r1)) continue;
    float g[V];
    load_vec<T, V, false>(img_gout + (size_t)t * C, g);
    bool any = false;
#pragma unroll
    for (int k = 0; k < V; ++k) any |= g[k] != 0.f;
    if (!any) continue;

    Scan<T, V> scan;
    for (int r = 0; r < bin.nr; ++r) {
      const int y = bin.row(r);
      for (int q = 0; q < bin.nc; ++q) scan.template add<STAGED>(cells.at(y, bin.col(q)), r * 16 + q);
    }
    uint32_t ties = 0, plateaus = 0;
    const int slots = bin.nr * bin.nc;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (g[k] == 0.f || scan.is_nan(k)) continue;  // nothing to give, or the max is NaN
      const int count = scan.count(k);
      if (count == 1) {
        const int s = scan.slot(k), y = bin.row(s >> 4);
        if (y >= r0 && y < r1) atomicAdd(sums + ((size_t)(y - r0) * W + bin.col(s & 15)) * V + k, g[k]);
      } else if (count == slots) {
        plateaus |= 1u << k;
      } else {
        ties |= 1u << k;
      }
    }
    if (plateaus) add_plateaus(bin, g, plateaus, sums, r0, r1, W);
    if (ties) add_ties(cells, bin, scan, g, ties, sums, r0, r1, W);
  }
  __syncthreads();

  // the tile, written once in the features' type
  T* dst = out + ((size_t)b * HW + (size_t)r0 * W) * C + c0;
  for (int cell = threadIdx.x; cell < (r1 - r0) * W; cell += kThreads) {
    const float* s = sums + cell * V;
    T* d = dst + (size_t)cell * C;
    if constexpr (V * sizeof(T) == 16) {
      uint4 w;
      if constexpr (sizeof(T) == 2) {
        const float4 a = reinterpret_cast<const float4*>(s)[0], c = reinterpret_cast<const float4*>(s)[1];
        w.x = as_u32(__floats2bfloat162_rn(a.x, a.y));
        w.y = as_u32(__floats2bfloat162_rn(a.z, a.w));
        w.z = as_u32(__floats2bfloat162_rn(c.x, c.y));
        w.w = as_u32(__floats2bfloat162_rn(c.z, c.w));
      } else {
        const float4 a = reinterpret_cast<const float4*>(s)[0];
        w = make_uint4(__float_as_uint(a.x), __float_as_uint(a.y), __float_as_uint(a.z), __float_as_uint(a.w));
      }
      *reinterpret_cast<uint4*>(d) = w;
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) d[k] = from_float<T>(s[k]);
    }
  }
}

// One kernel a (type, path), each under its own name so that ptxas and the
// profiler tell them apart.
#define K10_KERNEL(name, TYPE, V, STAGED)                                                                 \
  __global__ void __launch_bounds__(kThreads, 1) name(const TYPE* __restrict__ feat,                       \
                                                      const float* __restrict__ boxes,                     \
                                                      const TYPE* __restrict__ gout, TYPE* __restrict__ out, \
                                                      int H, int W, int C, int P, int S, float scale,      \
                                                      int max_bin_h, int max_bin_w, int slabs, int bands,  \
                                                      int band_rows) {                                     \
    tile<TYPE, V, STAGED>(feat, boxes, gout, out, H, W, C, P, S, scale, max_bin_h, max_bin_w, slabs, bands,  \
                          band_rows);                                                                      \
  }

K10_KERNEL(roi_pool_bwd_bf16_vector, __nv_bfloat16, 8, true)
K10_KERNEL(roi_pool_bwd_bf16_vector_l2, __nv_bfloat16, 8, false)
K10_KERNEL(roi_pool_bwd_bf16_scalar, __nv_bfloat16, 1, true)
K10_KERNEL(roi_pool_bwd_bf16_scalar_l2, __nv_bfloat16, 1, false)
K10_KERNEL(roi_pool_bwd_f32_vector, float, 4, true)
K10_KERNEL(roi_pool_bwd_f32_vector_l2, float, 4, false)
K10_KERNEL(roi_pool_bwd_f32_scalar, float, 1, true)
K10_KERNEL(roi_pool_bwd_f32_scalar_l2, float, 1, false)

template <typename T>
using Kernel = void (*)(const T*, const float*, const T*, T*, int, int, int, int, int, float, int, int, int, int,
                        int);

// Shared memory of a tile: the staged slab (when staged) and the band's
// sums. The planner sizes the band to fit; a tile past what a block may
// take is refused by cudaFuncSetAttribute below.
template <typename T>
int launch(Kernel<T> kernel, int V, bool staged, const void* feat, const void* boxes, const void* gout, void* out,
           int B, int H, int W, int C, int P, int S, float scale, int max_bin_h, int max_bin_w, int band_rows,
           cudaStream_t stream) {
  const long long smem =
      (staged ? staged_bytes((long long)H * W, V * (int)sizeof(T)) : 0) + (long long)band_rows * W * V * 4;
  if (smem > 0x7fffffffLL || C % V) return (int)cudaErrorInvalidValue;
  const int slabs = C / V, bands = (H + band_rows - 1) / band_rows;
  const long long blocks = (long long)B * slabs * bands;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(feat), static_cast<const float*>(boxes), static_cast<const T*>(gout),
      static_cast<T*>(out), H, W, C, P, S, scale, max_bin_h, max_bin_w, slabs, bands, band_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch: grad_features (out, the features' dtype, fully written) from
// grad_out, tiles of band_rows map rows (the planner's choice). dtype 0 =
// float32, 1 = bfloat16; vector: 16 bytes of channels a slab, else one;
// staged: the slab of the features in shared memory too. Returns the
// cudaError_t of the launch.
extern "C" int roi_pool_backward(const void* feat, const void* boxes, const void* gout, void* out, int B, int H,
                                 int W, int C, int P, int S, float scale, int max_bin_h, int max_bin_w, int dtype,
                                 int vector, int staged, int band_rows, void* stream) {
  if (S <= 0 || S > 512 || band_rows < 1 || max_bin_h < 1 || max_bin_w < 1 || max_bin_h > kMaxTableBin ||
      max_bin_w > kMaxTableBin)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    Kernel<float> k = vector ? (staged ? roi_pool_bwd_f32_vector : roi_pool_bwd_f32_vector_l2)
                             : (staged ? roi_pool_bwd_f32_scalar : roi_pool_bwd_f32_scalar_l2);
    return launch<float>(k, vector ? 4 : 1, staged, feat, boxes, gout, out, B, H, W, C, P, S, scale, max_bin_h,
                         max_bin_w, band_rows, s);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  Kernel<__nv_bfloat16> k = vector ? (staged ? roi_pool_bwd_bf16_vector : roi_pool_bwd_bf16_vector_l2)
                                   : (staged ? roi_pool_bwd_bf16_scalar : roi_pool_bwd_bf16_scalar_l2);
  return launch<__nv_bfloat16>(k, vector ? 8 : 1, staged, feat, boxes, gout, out, B, H, W, C, P, S, scale,
                               max_bin_h, max_bin_w, band_rows, s);
}
