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
// Design: the simple one that is right (a faster one is later work).
// - One thread a (bin, channel): threads of a warp take neighbouring
//   channels, so every load of grad_out and of a map cell is coalesced.
// - Pass 1 over the bin's lookup cells finds m, whether a cell is NaN, and
//   how many cells equal m. With one such cell (no tie), the cell takes the
//   whole cotangent: one atomic add.
// - With a tie, pass 2 builds the bin's equality mask in registers (16 rows
//   of 16 bits: the two windows of a side span at most 2 * 2^k <= 16 cells
//   for bins of at most 15 cells, the wrapper's check), then walks the four
//   lookups' trees on the mask and adds g * share to each tied cell.
// - The sums go to a float32 scratch with atomicAdd: their order varies
//   from run to run, so float32 results vary in the last bits (dyadic
//   cotangents sum exactly in any order). One pass then casts the scratch
//   to bf16 (round to nearest even); for float32 the scratch is the result.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 16;       // mask rows, and bits a row
constexpr int kMaxTableBin = 15;  // the largest bin extent the mask holds

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

// the reference's rounding of a scaled corner, as K1 and the plain version
__device__ __forceinline__ int round_half_away(float box, float scale) {
  float s = __fmul_rn(box, scale);
  return (int)(s >= 0.f ? floorf(__fadd_rn(s, 0.5f)) : ceilf(__fsub_rn(s, 0.5f)));
}

__device__ __forceinline__ int clampl(long long v, int lo, int hi) {
  return (int)(v < lo ? lo : (v > hi ? hi : v));
}

__device__ __forceinline__ uint32_t pick(const uint32_t (&bits)[kSlots], int r) {
  uint32_t v = 0;
#pragma unroll
  for (int q = 0; q < kSlots; ++q) v = q == r ? bits[q] : v;
  return v;
}

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    roi_pool_bwd(const T* __restrict__ feat, const float* __restrict__ boxes, const T* __restrict__ gout,
                 float* __restrict__ acc, int H, int W, int C, int P, int S, float scale, int max_bin_h,
                 int max_bin_w, long long total) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const float g = load(gout + t);
  if (g == 0.f) return;
  const int c = (int)(t % C);
  const long long bin = t / C;  // ((b * P + p) * S + i) * S + j
  const int j = (int)(bin % S);
  const int i = (int)(bin / S % S);
  const long long roi = bin / ((long long)S * S);
  const long long b = roi / P;

  const float* box = boxes + roi * 4;
  const int x1 = round_half_away(box[0], scale);
  const int y1 = round_half_away(box[1], scale);
  const int x2 = round_half_away(box[2], scale);
  const int y2 = round_half_away(box[3], scale);
  const long long roi_w = max(x2 - x1 + 1, 1);
  const long long roi_h = max(y2 - y1 + 1, 1);
  const int hs = clampl(i * roi_h / S + y1, 0, H);
  const int he = clampl(((i + 1) * roi_h + S - 1) / S + y1, 0, H);
  const int ws = clampl(j * roi_w / S + x1, 0, W);
  const int we = clampl(((j + 1) * roi_w + S - 1) / S + x1, 0, W);
  const int lh = he - hs, lw = we - ws;
  if (lh <= 0 || lw <= 0) return;  // an empty bin: 0, no gradient

  // the table levels of the bin and its cells as slots: rows 0..nh-1 from
  // hs (the first lookup row), the rest ending at he (the second); the two
  // windows coincide for a power-of-two extent and cover the bin for one
  // within the level bound, and columns likewise
  const int kh = 31 - __clz(min(lh, max_bin_h));
  const int kw = 31 - __clz(min(lw, max_bin_w));
  const int nh = 1 << kh, nw = 1 << kw;
  const int nr = min(lh, 2 * nh), nc = min(lw, 2 * nw);
  auto row = [&](int r) { return r < nh ? hs + r : he - nr + r; };
  auto col = [&](int q) { return q < nw ? ws + q : we - nc + q; };

  const T* f = feat + (size_t)b * H * W * C + c;
  float m = 0.f;
  int count = 0, my = 0, mx = 0;
  for (int r = 0; r < nr; ++r) {
    const T* fr = f + (size_t)row(r) * W * C;
    for (int q = 0; q < nc; ++q) {
      const float v = load(fr + (size_t)col(q) * C);
      if (isnan(v)) return;  // the bin's max is NaN: no cell gets anything
      if (count == 0 || v > m) {
        m = v;
        count = 1;
        my = row(r);
        mx = col(q);
      } else if (v == m) {
        ++count;
      }
    }
  }
  float* a = acc + (size_t)b * H * W * C + c;
  if (count == 1) {
    atomicAdd(a + ((size_t)my * W + mx) * C, g);
    return;
  }

  // a tie: the mask of the cells equal to m, bit q of row r
  uint32_t bits[kSlots];
#pragma unroll
  for (int r = 0; r < kSlots; ++r) {
    uint32_t rb = 0;
    if (r < nr) {
      const T* fr = f + (size_t)row(r) * W * C;
      for (int q = 0; q < nc; ++q) rb |= (uint32_t)(load(fr + (size_t)col(q) * C) == m) << q;
    }
    bits[r] = rb;
  }
  // rows of each lookup (ra: 0 from hs, 1 ending at he; ca likewise) that
  // meet the mask inside the lookup's columns
  const uint32_t wmask = (1u << nw) - 1;
  uint32_t rowhit[2][2];
#pragma unroll
  for (int ra = 0; ra < 2; ++ra) {
#pragma unroll
    for (int ca = 0; ca < 2; ++ca) {
      const int r0 = ra ? nr - nh : 0, c0 = ca ? nc - nw : 0;
      uint32_t hits = 0;
#pragma unroll
      for (int r = 0; r < kSlots; ++r) {
        if (r >= r0 && r < r0 + nh && ((bits[r] >> c0) & wmask)) hits |= 1u << (r - r0);
      }
      rowhit[ra][ca] = hits;
    }
  }
  // out = max(max(L00, L01), max(L10, L11)): the lookups' shares
  bool hit[2][2], side[2];
#pragma unroll
  for (int ra = 0; ra < 2; ++ra) {
    hit[ra][0] = rowhit[ra][0] != 0;
    hit[ra][1] = rowhit[ra][1] != 0;
    side[ra] = hit[ra][0] || hit[ra][1];
  }
#pragma unroll
  for (int ra = 0; ra < 2; ++ra) {
#pragma unroll
    for (int ca = 0; ca < 2; ++ca) {
      if (!hit[ra][ca]) continue;
      const float share = (side[1 - ra] ? 0.5f : 1.f) * (hit[ra][1 - ca] ? 0.5f : 1.f);
      const int r0 = ra ? nr - nh : 0, c0 = ca ? nc - nw : 0;
      const uint32_t hits = rowhit[ra][ca];
      for (int rr = 0; rr < nh; ++rr) {
        if (!((hits >> rr) & 1)) continue;
        const float row_share = share * tree_share(hits, rr, kh);
        const uint32_t cols = (pick(bits, r0 + rr) >> c0) & wmask;
        float* ar = a + (size_t)row(r0 + rr) * W * C;
        for (int cc = 0; cc < nw; ++cc) {
          if (!((cols >> cc) & 1)) continue;
          atomicAdd(ar + (size_t)col(c0 + cc) * C, g * (row_share * tree_share(cols, cc, kw)));
        }
      }
    }
  }
}

__global__ void cast_out(const float* __restrict__ acc, __nv_bfloat16* __restrict__ out, long long n) {
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < n; k += (long long)gridDim.x * blockDim.x)
    out[k] = __float2bfloat16_rn(acc[k]);
}

template <typename T>
int launch(const void* feat, const void* boxes, const void* gout, void* acc, void* out, int B, int H, int W,
           int C, int P, int S, float scale, int max_bin_h, int max_bin_w, cudaStream_t stream) {
  const long long total = (long long)B * P * S * S * C;
  if (total > 0) {
    const long long blocks = (total + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    roi_pool_bwd<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(feat), static_cast<const float*>(boxes), static_cast<const T*>(gout),
        static_cast<float*>(acc), H, W, C, P, S, scale, max_bin_h, max_bin_w, total);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// dtype: 0 = float32 (out is acc, the float32 scratch), 1 = bfloat16 (one
// cast pass from acc into out). acc (B, H, W, C) float32 must hold zeros.
// Returns the cudaError_t of the launches.
extern "C" int roi_pool_backward(const void* feat, const void* boxes, const void* gout, void* acc, void* out,
                                 int B, int H, int W, int C, int P, int S, float scale, int max_bin_h,
                                 int max_bin_w, int dtype, void* stream) {
  if (S <= 0 || max_bin_h < 1 || max_bin_w < 1 || max_bin_h > kMaxTableBin || max_bin_w > kMaxTableBin)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(feat, boxes, gout, acc, out, B, H, W, C, P, S, scale, max_bin_h, max_bin_w, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  int err = launch<__nv_bfloat16>(feat, boxes, gout, acc, out, B, H, W, C, P, S, scale, max_bin_h, max_bin_w, s);
  if (err) return err;
  const long long n = (long long)B * H * W * C;
  if (n > 0) {
    const long long blocks = (n + 4 * kThreads - 1) / (4 * kThreads);
    cast_out<<<(unsigned)(blocks < 65535 * 16 ? blocks : 65535 * 16), kThreads, 0, s>>>(
        static_cast<const float*>(acc), static_cast<__nv_bfloat16*>(out), n);
    return (int)cudaGetLastError();
  }
  return 0;
}
