// K1: RoIPool forward for Hopper (sm_90a), exact torchvision semantics.
//
// Replaces: vltk_tpu/ops/pallas_kernels.py:roi_pool_pallas (the Pallas TPU
// kernel, body _kernel), the RoIPool of the FRCNN RoI heads.
//
// What it computes: features (B, H, W, C) NHWC, boxes (B, P, 4) xyxy float32
// in image coordinates -> out (B, P, S, S, C). Box corners are scaled by
// spatial_scale and rounded half away from zero with the reference's
// expression (s >= 0 ? floor(s + 0.5) : ceil(s - 0.5)); bin i spans
// [floor(i*R/S), ceil((i+1)*R/S)) from the corner, clipped to the map; the
// bin value is the max over its cells (NaN propagates, as torch.maximum
// does) and an empty bin is 0.
//
// Bound on this card: bytes. At the extraction shape (B=8, P=300, S=14,
// C=1024, bf16) the kernel writes 0.96 GB and reads a 71.6 MB feature map:
// 0.31 ms at 3.35 TB/s. The max comparisons (1.7 G on proposal-like
// boxes) are a fraction of that at the non-tensor rate. What the map costs
// is traffic from L2: its cells are requested again by every bin that
// covers them. On chip_smoke.py's proposal-like boxes at B=8 x 300 a bin
// averages 3.5 cells, and reading each bin's cells requests 3.37 GB, 47x
// the map (a count on the boxes, not a counter read on the card).
//
// Design.
// - 16-byte vectors along C: a thread owns 8 bf16 or 4 float32 channels of
//   a cell, so a warp loads and stores 512 contiguous bytes. bf16 maxima
//   are taken on pairs with __hmax2_nan (exact; NaN propagates); float32
//   keeps the explicit NaN rule, since fmaxf drops NaN.
// - Separable order: a thread computes one map row's column-bin maxima
//   once, keeps them in registers and folds them into every bin row that
//   covers the row. Consecutive bin rows share at most one map row
//   (he_i - hs_{i+1} is 0 or 1), so keeping the last row computed is
//   enough: the bytes requested fall from 3.37 to 1.75 GB on the same
//   boxes (the same count). On the H100 the separable order was the faster
//   one on every set of boxes timed (PERF.md has the times).
// - Many loads in flight: a row's cells for the thread's column bins are
//   loaded as one unrolled group of predicated loads before any max is
//   taken; a wider bin loops over further groups, so any bin extent works.
// - A RoI's column bins are split between threads (bb a thread, below),
//   which keeps the accumulators in registers and puts more warps on each
//   SM; the cell on the edge of two threads' bins is read by both. Bin
//   edges are walked with two divisions a thread (BinWalk).
// - Output: each RoI's (S, S, C) block is written contiguously with
//   evict-first stores (st.global.cs), so the 0.96 GB stream does not push
//   the feature map out of L2.
// - No shared memory and no table (a 150-200 KB block serialised the
//   phases of the ablation probe's kernels), small blocks, and image-major
//   order: the RoI is the slowest index of the flat thread id, so the
//   blocks of one image run together while its 8.9 MB map sits in L2.
// - A scalar path (one element a thread) takes what the vector path cannot:
//   C not a multiple of the vector width, or a base that is not 16-byte
//   aligned. The wrapper picks the path before launching.
// max over bf16 values is exact, so both paths agree bitwise with the
// plain version.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

// Block shape, three or four digits "bb u t" (222 is bb = 02):
//   bb  column bins a thread owns (01-14)
//   u   cells of a bin a thread loads in one unrolled, predicated group
//   t   threads a block, in units of 128
// tools/bench_roipool.py --shapes builds others with -DK1_SHAPE and times
// them on the extraction step's own inputs; PERF.md has the ranking.
#ifndef K1_SHAPE
#define K1_SHAPE 222
#endif

namespace {

constexpr int kBins = K1_SHAPE / 100;
constexpr int kUnroll = K1_SHAPE / 10 % 10;
constexpr int kThreads = 128 * (K1_SHAPE % 10);
static_assert(kBins >= 1 && kBins <= 14 && kUnroll >= 1 && kThreads >= 128,
              "K1_SHAPE: want bb in 01-14, u >= 1, t >= 1");

template <typename To, typename From>
__device__ __forceinline__ To bit_cast(const From& x) {
  static_assert(sizeof(To) == sizeof(From), "bit_cast sizes");
  To y;
  memcpy(&y, &x, sizeof(To));
  return y;
}

__device__ __forceinline__ float max_nan(float m, float v) {
  return (v > m || isnan(v)) ? (isnan(m) ? m : v) : m;
}

// One thread's channels of a cell: N elements, loaded through the read-only
// path, stored evict-first.
template <typename T, int N>
struct Cells;

template <>
struct Cells<__nv_bfloat16, 8> {
  static constexpr int N = 8;
  __nv_bfloat162 h[4];
  static __device__ __forceinline__ Cells neg() { return fill(0xFF80); }  // -inf
  static __device__ __forceinline__ Cells zero() { return fill(0); }
  static __device__ __forceinline__ Cells fill(unsigned short bits) {
    Cells c;
    const __nv_bfloat162 x = __bfloat162bfloat162(__ushort_as_bfloat16(bits));
#pragma unroll
    for (int k = 0; k < 4; ++k) c.h[k] = x;
    return c;
  }
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
  __device__ __forceinline__ void store(__nv_bfloat16* p) const {
    uint4 u;
    u.x = bit_cast<unsigned>(h[0]);
    u.y = bit_cast<unsigned>(h[1]);
    u.z = bit_cast<unsigned>(h[2]);
    u.w = bit_cast<unsigned>(h[3]);
    __stcs(reinterpret_cast<uint4*>(p), u);
  }
};

template <>
struct Cells<__nv_bfloat16, 1> {
  static constexpr int N = 1;
  __nv_bfloat16 h;
  static __device__ __forceinline__ Cells neg() { return fill(0xFF80); }
  static __device__ __forceinline__ Cells zero() { return fill(0); }
  static __device__ __forceinline__ Cells fill(unsigned short bits) {
    Cells c;
    c.h = __ushort_as_bfloat16(bits);
    return c;
  }
  static __device__ __forceinline__ Cells load(const __nv_bfloat16* p) {
    Cells c;
    c.h = __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p)));
    return c;
  }
  __device__ __forceinline__ void max_with(const Cells& o) { h = __hmax_nan(h, o.h); }
  __device__ __forceinline__ void store(__nv_bfloat16* p) const {
    __stcs(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(h));
  }
};

template <>
struct Cells<float, 4> {
  static constexpr int N = 4;
  float4 v;
  static __device__ __forceinline__ Cells neg() { return fill(-INFINITY); }
  static __device__ __forceinline__ Cells zero() { return fill(0.f); }
  static __device__ __forceinline__ Cells fill(float x) {
    Cells c;
    c.v = make_float4(x, x, x, x);
    return c;
  }
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
  __device__ __forceinline__ void store(float* p) const { __stcs(reinterpret_cast<float4*>(p), v); }
};

template <>
struct Cells<float, 1> {
  static constexpr int N = 1;
  float v;
  static __device__ __forceinline__ Cells neg() { return fill(-INFINITY); }
  static __device__ __forceinline__ Cells zero() { return fill(0.f); }
  static __device__ __forceinline__ Cells fill(float x) {
    Cells c;
    c.v = x;
    return c;
  }
  static __device__ __forceinline__ Cells load(const float* p) {
    Cells c;
    c.v = __ldg(p);
    return c;
  }
  __device__ __forceinline__ void max_with(const Cells& o) { v = max_nan(v, o.v); }
  __device__ __forceinline__ void store(float* p) const { __stcs(p, v); }
};

__device__ __forceinline__ int round_half_away(float box, float scale) {
  float s = __fmul_rn(box, scale);
  return (int)(s >= 0.f ? floorf(__fadd_rn(s, 0.5f)) : ceilf(__fsub_rn(s, 0.5f)));
}

__device__ __forceinline__ int clampl(long long v, int lo, int hi) {
  return (int)(v < lo ? lo : (v > hi ? hi : v));
}

// Walks i * r = q * S + m (0 <= m < S) one bin at a time, so that a
// thread's bin edges take two 64-bit divisions (a box far off the map must
// not overflow) instead of two a bin. The plain version's edges of bin i,
// before clipping and the corner's offset: floor(i r / S) = q_i and
// ceil((i + 1) r / S) = q_{i+1} + (m_{i+1} > 0).
struct BinWalk {
  long long q, dq;
  int m, dm, S;
  __device__ __forceinline__ BinWalk(int i, long long r, int S_) : S(S_) {
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

// The maxima of one map row over the thread's column bins: every cell of
// a group of kUnroll columns of each bin is loaded before any max is taken.
template <typename T, typename V>
__device__ __forceinline__ void row_maxima(const T* __restrict__ row, const int (&ws)[kBins],
                                           const int (&we)[kBins], int widest, int C, V (&m)[kBins]) {
#pragma unroll
  for (int jj = 0; jj < kBins; ++jj) m[jj] = V::neg();
  for (int x0 = 0; x0 < widest; x0 += kUnroll) {
    V v[kBins][kUnroll];
#pragma unroll
    for (int jj = 0; jj < kBins; ++jj) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int x = ws[jj] + x0 + u;
        v[jj][u] = x < we[jj] ? V::load(row + (size_t)x * C) : V::neg();
      }
    }
#pragma unroll
    for (int jj = 0; jj < kBins; ++jj) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) m[jj].max_with(v[jj][u]);
    }
  }
}

// The thread's (channel vector, column-bin group, RoI, image) from its
// flat id ((roi * groups + group) * vecs + channel vector): roi = b * P + p
// is the slowest index, so the order is image-major. I is 32-bit where the
// grid allows it.
template <typename I>
__device__ __forceinline__ void decode(I t, I vecs, I groups, I P, I& cv, I& g, I& roi, I& b) {
  cv = t % vecs;
  t /= vecs;
  g = t % groups;
  roi = t / groups;
  b = roi / P;
}

// One thread: V::N channels of one RoI's kBins column bins, all S bin rows.
template <typename T, typename V>
__device__ __forceinline__ void roi_pool_body(const T* __restrict__ feat, const float* __restrict__ boxes,
                                              T* __restrict__ out, int H, int W, int C, int P, int S,
                                              float spatial_scale, long long total) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const int groups = (S + kBins - 1) / kBins;
  long long cv, g, roi, b;
  if (total <= 0xffffffffLL) {
    unsigned cv32, g32, roi32, b32;
    decode<unsigned>((unsigned)t, C / V::N, groups, P, cv32, g32, roi32, b32);
    cv = cv32, g = g32, roi = roi32, b = b32;
  } else {
    decode<long long>(t, C / V::N, groups, P, cv, g, roi, b);
  }
  const int j0 = (int)g * kBins;

  const float* box = boxes + roi * 4;
  const int x1 = round_half_away(box[0], spatial_scale);
  const int y1 = round_half_away(box[1], spatial_scale);
  const int x2 = round_half_away(box[2], spatial_scale);
  const int y2 = round_half_away(box[3], spatial_scale);
  const long long roi_w = max(x2 - x1 + 1, 1);
  const long long roi_h = max(y2 - y1 + 1, 1);

  int ws[kBins], we[kBins];
  int widest = 0;
  BinWalk cols(j0, roi_w, S);
#pragma unroll
  for (int jj = 0; jj < kBins; ++jj) {
    ws[jj] = we[jj] = 0;
    if (j0 + jj < S) cols.edges(x1, W, ws[jj], we[jj]);
    widest = max(widest, we[jj] - ws[jj]);
  }

  const T* f = feat + (size_t)b * H * W * C + (size_t)cv * V::N;
  T* o = out + (size_t)roi * S * S * C + (size_t)cv * V::N;
  V row[kBins];  // the column-bin maxima of map row `have`
  int have = -1;
  BinWalk rows(0, roi_h, S);
  for (int i = 0; i < S; ++i) {
    int hs, he;
    rows.edges(y1, H, hs, he);
    V acc[kBins];
#pragma unroll
    for (int jj = 0; jj < kBins; ++jj) acc[jj] = V::neg();
    for (int y = hs; y < he; ++y) {
      if (y != have) {
        row_maxima<T, V>(f + (size_t)y * W * C, ws, we, widest, C, row);
        have = y;
      }
#pragma unroll
      for (int jj = 0; jj < kBins; ++jj) acc[jj].max_with(row[jj]);
    }
#pragma unroll
    for (int jj = 0; jj < kBins; ++jj) {
      if (j0 + jj < S) {
        const bool empty = he <= hs || we[jj] <= ws[jj];
        (empty ? V::zero() : acc[jj]).store(o + (size_t)(i * S + j0 + jj) * C);
      }
    }
  }
}

// one kernel per type and path, named so that -Xptxas -v tells them apart
#define K1_KERNEL(name, T, n)                                                                    \
  __global__ void __launch_bounds__(kThreads)                                                    \
      name(const T* __restrict__ feat, const float* __restrict__ boxes, T* __restrict__ out, int H, \
           int W, int C, int P, int S, float spatial_scale, long long total) {                  \
    roi_pool_body<T, Cells<T, n>>(feat, boxes, out, H, W, C, P, S, spatial_scale, total);      \
  }
K1_KERNEL(roi_pool_bf16_vector, __nv_bfloat16, 8)
K1_KERNEL(roi_pool_bf16_scalar, __nv_bfloat16, 1)
K1_KERNEL(roi_pool_f32_vector, float, 4)
K1_KERNEL(roi_pool_f32_scalar, float, 1)
#undef K1_KERNEL

template <typename T, int N>
int launch(void (*kernel)(const T*, const float*, T*, int, int, int, int, int, float, long long),
           const void* feat, const void* boxes, void* out, int B, int H, int W, int C, int P, int S,
           float spatial_scale, cudaStream_t stream) {
  if (C % N) return (int)cudaErrorInvalidValue;
  const long long groups = (S + kBins - 1) / kBins;
  const long long total = (long long)B * P * groups * (C / N);
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(static_cast<const T*>(feat), static_cast<const float*>(boxes),
                                                    static_cast<T*>(out), H, W, C, P, S, spatial_scale, total);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. vector: 1 = the 16-byte path (C a
// multiple of 16 bytes' worth of elements, features and out 16-byte
// aligned), 0 = one element a thread. Returns the cudaError_t of the launch.
extern "C" int roi_pool_forward(const void* feat, const void* boxes, void* out, int B, int H, int W,
                                int C, int P, int S, float spatial_scale, int dtype, int vector,
                                void* stream) {
  if (B == 0 || P == 0 || C == 0) return 0;
  if (S <= 0) return (int)cudaErrorInvalidValue;
  if (vector && (reinterpret_cast<uintptr_t>(feat) % 16 || reinterpret_cast<uintptr_t>(out) % 16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vector ? launch<float, 4>(roi_pool_f32_vector, feat, boxes, out, B, H, W, C, P, S, spatial_scale, s)
                  : launch<float, 1>(roi_pool_f32_scalar, feat, boxes, out, B, H, W, C, P, S, spatial_scale, s);
  if (dtype == 1)
    return vector ? launch<__nv_bfloat16, 8>(roi_pool_bf16_vector, feat, boxes, out, B, H, W, C, P, S,
                                             spatial_scale, s)
                  : launch<__nv_bfloat16, 1>(roi_pool_bf16_scalar, feat, boxes, out, B, H, W, C, P, S,
                                             spatial_scale, s);
  return (int)cudaErrorInvalidValue;
}

// The compiled block shape (K1_SHAPE), for reports.
extern "C" int roi_pool_shape() { return K1_SHAPE; }
