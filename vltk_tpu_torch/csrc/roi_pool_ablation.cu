// RoIPool ablation variants for Hopper (sm_90a): K6-K9.
//
// Replaces the four Pallas TPU kernels of tools/probe_roipool_ablation.py:
//   K6 pool             (body make_kernel)            modes full, v3, noP1, noP2, noBoth
//   K7 pool_contig      (body make_kernel_contig)     modes full, stackwrite, p1only, zeroOut
//   K8 pool_grouped     (body make_group_kernel)      v2 RoIPool, G RoIs per block
//   K9 pool_grouped_v3  (body make_group_kernel_v3)   v3 RoIPool, G RoIs per block
// They are variants of the separable-max RoIPool design that the shipped
// TPU kernel uses, made to time its phases; what each mode returns is
// written out in ops/roi_pool_ablation.py, the plain version.
//
// features (B, H, W, C) NHWC float32 or bf16, boxes (B, P, 4) xyxy float32
// in image coordinates (scale 1/16, 14 x 14 bins) -> (B, P, 14, 14, C), or
// (B, C/cb, P, 14, 14, cb) for K7.
//
// Phases, kept apart so that each mode removes on the card the work it
// removed on the TPU:
//   build   one launch over the whole batch: the row-range-max table
//           T[l][b][y][x][c] = max(feat[b][y .. min(y + l, H - 1)][x][c]),
//           l < max_bh, in a scratch the wrapper allocates. The TPU built it
//           in VMEM at the first RoI of each (image, channel block) and
//           carried it along its sequential grid; blocks on this card run in
//           no order and share nothing, so the table goes through device
//           memory (5 levels x 8.9 MB per image in bf16 at 52 x 84 x 1024).
//   pass 1  per RoI and row bin i, one table row (level = the bin's row
//           count - 1, capped at max_bh) over the RoI's own columns into a
//           shared-memory rowmax [14][W][cc]; noP1/noBoth read feature row
//           i instead (table level 0); noP2/noBoth load as many columns as
//           the v2 mode, from column 0 (at least 14). The TPU filled all W
//           columns; only the RoI's columns are read by pass 2.
//   pass 2  per bin (i, j), a max over the capped column window of rowmax
//           (v2: [ws, we) inside [clip(ws, 0, W - max_bw), + max_bw); v3:
//           inside [8 * (ws / 8), + win)); noP2/noBoth copy rowmax[i][j].
//   write   NHWC: each thread one channel, a warp one run of C per bin. K7
//           stages the 14 x 14 x cb output tile in shared memory and writes
//           it as one contiguous run of 16-byte stores.
//   per-block cost: one block per (RoI, image, channel chunk) for K6 and K7;
//           K8/K9 loop over G RoIs of one image in a block instead.
//
// Shared memory: the TPU rowmax (84, 14, 128) would be 301 KB in bf16, above
// the 227 KB a block may use, so a block works on a channel chunk cc (64
// channels in bf16, 32 in float32, 128 bytes a row; fewer if W is large):
// rowmax 14 x 84 x 64 x 2 B = 150 KB. K7's block covers its cb channels in
// chunks of cc and adds the 14 x 14 x cb tile (50 KB in bf16).
//
// Bound on this card: memory. At the probe shape (B=8, 52 x 84 x 1024 bf16,
// P=300) the function reads a 71.6 MB map and writes 963 MB, ~0.31 ms at
// 3.35 TB/s; the table adds 358 MB written and read back.
//
// Exactness: every value is a max or a copy of input values, done in float
// on values of the features' type, so all modes agree bitwise with the
// plain version. The sentinel -1e30 is rounded to the features' type; a bin
// whose max is at or below -5e29 (in float) is written as 0, as the TPU
// bodies do. NaN propagates as in torch.maximum.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int S = 14;          // output bins per side
constexpr int THREADS = 256;
constexpr int SMEM_LIMIT = 232448 - 1024;  // 227 KB a block may use, less the static Bins
constexpr float NEG = -1e30f;
constexpr float EMPTY_AT = -5e29f;  // NEG / 2

enum Mode { FULL = 0, V3 = 1, NOP1 = 2, NOP2 = 3, NOBOTH = 4, STACK = 5, P1ONLY = 6, ZERO = 7 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// max as torch.maximum: NaN wins
__device__ __forceinline__ float max_nan(float m, float v) {
  if (isnan(m)) return m;
  return (v > m || isnan(v)) ? v : m;
}

__device__ __forceinline__ int round_half_away(float box) {
  const float s = __fmul_rn(box, 0.0625f);  // == box / 16, exactly
  return (int)(s >= 0.f ? floorf(__fadd_rn(s, 0.5f)) : ceilf(__fsub_rn(s, 0.5f)));
}

__device__ __forceinline__ int clampl(long long v, int lo, int hi) {
  return (int)(v < lo ? lo : (v > hi ? hi : v));
}

// the bins of one RoI, in shared memory
struct Bins {
  int row0[S];  // first row of row bin i
  int rows[S];  // its row count after the cap (0: empty)
  int col0[S];  // first column of column bin j
  int col1[S];  // its end after the column window's cap
  int xlo;      // pass 1 fills columns [xlo, xlo + span)
  int span;
};

template <int MODE>
__device__ void load_bins(const float* box, int H, int W, int max_bh, int max_bw, Bins& s) {
  const int t = threadIdx.x;
  if (t < S) {
    const int x1 = round_half_away(box[0]);
    const int y1 = round_half_away(box[1]);
    const int x2 = round_half_away(box[2]);
    const int y2 = round_half_away(box[3]);
    // 64-bit bin arithmetic: a box far off the map must not overflow
    const long long rw = max(x2 - x1 + 1, 1);
    const long long rh = max(y2 - y1 + 1, 1);
    const int hs = clampl(t * rh / S + y1, 0, H);
    const int he = clampl(((t + 1) * rh + S - 1) / S + y1, 0, H);
    s.row0[t] = hs;
    s.rows[t] = max(min(he - hs, max_bh), 0);
    const int ws = clampl(t * rw / S + x1, 0, W);
    const int we = clampl(((t + 1) * rw + S - 1) / S + x1, 0, W);
    int end;
    if (MODE == V3) {
      const int win = 2 * ((max_bw + 7) / 8) * 8;
      end = min(we, ws / 8 * 8 + win);
    } else {
      end = min(we, min(ws, W - max_bw) + max_bw);  // ws >= 0
    }
    s.col0[t] = ws;
    s.col1[t] = end;
  }
  __syncthreads();
  if (t == 0) {
    int hi = s.col0[0];
    for (int j = 0; j < S; ++j) hi = max(hi, s.col1[j]);
    if (MODE == NOP2 || MODE == NOBOTH) {
      // the copy reads columns 0..13; pass 1 loads as many columns as the
      // v2 mode would, so that these modes remove pass 2 and not pass 1
      s.xlo = 0;
      s.span = max(hi - s.col0[0], S);
    } else {
      s.xlo = s.col0[0];
      s.span = hi - s.col0[0];
    }
  }
  __syncthreads();
}

// pass 1: rowmax[i][x - xlo][tc] for the RoI's columns. tab_b is level 0
// of image b; level l lies l * level_stride further.
template <typename T, int MODE>
__device__ void pass1(const T* __restrict__ tab_b, size_t level_stride, int W, int C, int c,
                      const Bins& s, T* rowmax, int cc, int tc, int tr, int nr) {
  const T neg = from_float<T>(NEG);
  const bool live = c < C;
  const int span = s.span;
  if (MODE == STACK) {
    // the 14 row values of one column gathered in registers, then stored
    // together (the TPU's single stacked rowmax store)
    for (int x = tr; x < span; x += nr) {
      T r[S];
#pragma unroll
      for (int i = 0; i < S; ++i)
        r[i] = (live && s.rows[i] > 0)
                   ? tab_b[(s.rows[i] - 1) * level_stride + ((size_t)s.row0[i] * W + s.xlo + x) * C + c]
                   : neg;
#pragma unroll
      for (int i = 0; i < S; ++i) rowmax[(i * W + x) * cc + tc] = r[i];
    }
    return;
  }
#pragma unroll 4
  for (int idx = tr; idx < S * span; idx += nr) {
    const int i = idx / span;
    const int x = idx - i * span;
    T v = neg;
    if (MODE == NOP1 || MODE == NOBOTH) {
      if (live) v = tab_b[((size_t)i * W + s.xlo + x) * C + c];
    } else if (live && s.rows[i] > 0) {
      v = tab_b[(s.rows[i] - 1) * level_stride + ((size_t)s.row0[i] * W + s.xlo + x) * C + c];
    }
    rowmax[(i * W + x) * cc + tc] = v;
  }
}

// pass 2: the value of bin (i, j)
template <typename T, int MODE>
__device__ __forceinline__ float bin_value(const T* rowmax, int W, int cc, int tc, const Bins& s, int i, int j) {
  if (MODE == NOP2 || MODE == NOBOTH) return to_float(rowmax[(i * W + j) * cc + tc]);
  float m = -INFINITY;
  for (int x = s.col0[j]; x < s.col1[j]; ++x) m = max_nan(m, to_float(rowmax[(i * W + x - s.xlo) * cc + tc]));
  return m <= EMPTY_AT ? 0.f : m;
}

// one RoI, one channel chunk, NHWC output (K6, K8, K9)
template <typename T, int MODE>
__device__ void pool_roi(const T* __restrict__ table, const float* __restrict__ boxes, T* __restrict__ out,
                         int B, int H, int W, int C, int P, int max_bh, int max_bw, int cc, int b, int p,
                         Bins& bins, T* rowmax) {
  const int tc = threadIdx.x % cc, tr = threadIdx.x / cc, nr = blockDim.x / cc;
  const int c = blockIdx.z * cc + tc;
  load_bins<MODE>(boxes + ((size_t)b * P + p) * 4, H, W, max_bh, max_bw, bins);
  const size_t level_stride = (size_t)B * H * W * C;
  pass1<T, MODE>(table + (size_t)b * H * W * C, level_stride, W, C, c, bins, rowmax, cc, tc, tr, nr);
  __syncthreads();
  if (c < C) {
    T* o = out + ((size_t)b * P + p) * S * S * C + c;
    for (int idx = tr; idx < S * S; idx += nr)
      o[(size_t)idx * C] = from_float<T>(bin_value<T, MODE>(rowmax, W, cc, tc, bins, idx / S, idx % S));
  }
}

// K6: one block per (RoI, image, channel chunk)
template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS)
pool_kernel(const T* __restrict__ table, const float* __restrict__ boxes, T* __restrict__ out,
            int B, int H, int W, int C, int P, int max_bh, int max_bw, int cc) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Bins bins;
  pool_roi<T, MODE>(table, boxes, out, B, H, W, C, P, max_bh, max_bw, cc, blockIdx.y, blockIdx.x,
                    bins, reinterpret_cast<T*>(smem));
}

// K8 (v2 window) and K9 (v3 window): one block per (G RoIs, image, channel
// chunk), the RoIs in a loop
template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS)
pool_grouped_kernel(const T* __restrict__ table, const float* __restrict__ boxes, T* __restrict__ out,
                    int B, int H, int W, int C, int P, int max_bh, int max_bw, int cc, int group) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Bins bins;
  for (int g = 0; g < group; ++g) {
    pool_roi<T, MODE>(table, boxes, out, B, H, W, C, P, max_bh, max_bw, cc, blockIdx.y,
                      blockIdx.x * group + g, bins, reinterpret_cast<T*>(smem));
    __syncthreads();  // bins and rowmax are rewritten by the next RoI
  }
}

// a tile of n elements from shared memory (or zeros) to device memory,
// 16-byte stores by neighbouring threads where the tile allows them
template <typename T>
__device__ void store_tile(T* __restrict__ dst, const T* src, int n) {
  const int bytes = n * (int)sizeof(T);
  if (bytes % 16 == 0) {
    uint4* d = reinterpret_cast<uint4*>(dst);
    const uint4* v = reinterpret_cast<const uint4*>(src);
    for (int k = threadIdx.x; k < bytes / 16; k += blockDim.x) d[k] = src ? v[k] : make_uint4(0, 0, 0, 0);
  } else {
    for (int k = threadIdx.x; k < n; k += blockDim.x) dst[k] = src ? src[k] : from_float<T>(0.f);
  }
}

// K7: one block per (RoI, image, channel block of cb), the block's cb
// channels in chunks of cc; output (B, C/cb, P, 14, 14, cb). ``observe`` is
// 0 in every launch: it keeps p1only's pass 1 from being removed as dead
// code (its result would otherwise be unused).
template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS)
pool_contig_kernel(const T* __restrict__ table, const float* __restrict__ boxes, T* __restrict__ out,
                   int B, int H, int W, int C, int P, int max_bh, int max_bw, int cb, int cc, int observe) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Bins bins;
  const int p = blockIdx.x, b = blockIdx.y, k = blockIdx.z;
  T* dst = out + (((size_t)b * (C / cb) + k) * P + p) * S * S * cb;
  if (MODE == ZERO) {
    store_tile<T>(dst, nullptr, S * S * cb);
    return;
  }
  constexpr int BINS = MODE == P1ONLY ? FULL : MODE;
  T* tile = reinterpret_cast<T*>(smem);
  T* rowmax = tile + S * S * cb;
  const int tc = threadIdx.x % cc, tr = threadIdx.x / cc, nr = blockDim.x / cc;
  load_bins<BINS>(boxes + ((size_t)b * P + p) * 4, H, W, max_bh, max_bw, bins);
  const size_t level_stride = (size_t)B * H * W * C;
  const T* tab_b = table + (size_t)b * H * W * C;
  if (MODE == P1ONLY) store_tile<T>(dst, nullptr, S * S * cb);
  for (int sub = 0; sub < cb; sub += cc) {
    pass1<T, BINS>(tab_b, level_stride, W, C, k * cb + sub + tc, bins, rowmax, cc, tc, tr, nr);
    __syncthreads();
    if (MODE == P1ONLY) {
      if (observe && threadIdx.x == 0) dst[sub] = rowmax[0];
    } else {
      for (int idx = tr; idx < S * S; idx += nr)
        tile[idx * cb + sub + tc] = from_float<T>(bin_value<T, BINS>(rowmax, W, cc, tc, bins, idx / S, idx % S));
    }
    __syncthreads();  // rowmax is rewritten by the next chunk
  }
  if (MODE != P1ONLY) store_tile<T>(dst, tile, S * S * cb);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
build_table_kernel(const T* __restrict__ feat, T* __restrict__ table, int H, int W, int C, int L, size_t n) {
  const size_t row = (size_t)W * C;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < n; e += (size_t)gridDim.x * blockDim.x) {
    const int y = (int)((e / row) % H);
    const T v0 = feat[e];
    table[e] = v0;
    float m = to_float(v0);
    for (int l = 1; l < L; ++l) {
      if (y + l < H) m = max_nan(m, to_float(feat[e + l * row]));
      table[l * n + e] = from_float<T>(m);
    }
  }
}

// the largest power-of-two channel chunk up to cmax (and up to C rounded
// up) that divides ``divides`` (0: any) and whose rowmax fits beside
// ``extra`` bytes of shared memory; 0 if none does
int pick_chunk(int W, int C, int es, int extra, int divides) {
  const int cmax = 128 / es;
  int cc = 1;
  while (cc < cmax && cc < C) cc *= 2;
  for (; cc >= 1; cc /= 2)
    if ((divides == 0 || divides % cc == 0) && (size_t)S * W * cc * es + extra <= (size_t)SMEM_LIMIT) return cc;
  return 0;
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, int smem, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <typename T>
int build(const void* feat, void* table, int B, int H, int W, int C, int L, cudaStream_t stream) {
  const size_t n = (size_t)B * H * W * C;
  const size_t want = (n + THREADS - 1) / THREADS;
  const int blocks = (int)(want < 132 * 32 ? want : 132 * 32);
  build_table_kernel<T><<<blocks, THREADS, 0, stream>>>(static_cast<const T*>(feat), static_cast<T*>(table),
                                                        H, W, C, L, n);
  return (int)cudaGetLastError();
}

template <typename T, int MODE>
int pool_nhwc(const void* table, const void* boxes, void* out, int B, int H, int W, int C, int P, int max_bh,
              int max_bw, int group, cudaStream_t stream) {
  const int es = (int)sizeof(T);
  const int cc = pick_chunk(W, C, es, 0, 0);
  if (cc == 0) return (int)cudaErrorInvalidValue;
  const int smem = S * W * cc * es;
  const T* tab = static_cast<const T*>(table);
  const float* bx = static_cast<const float*>(boxes);
  T* o = static_cast<T*>(out);
  if (group == 0) {
    dim3 grid(P, B, (C + cc - 1) / cc);
    return launch(pool_kernel<T, MODE>, grid, smem, stream, tab, bx, o, B, H, W, C, P, max_bh, max_bw, cc);
  }
  dim3 grid(P / group, B, (C + cc - 1) / cc);
  return launch(pool_grouped_kernel<T, MODE>, grid, smem, stream, tab, bx, o, B, H, W, C, P, max_bh, max_bw,
                cc, group);
}

template <typename T, int MODE>
int pool_contig(const void* table, const void* boxes, void* out, int B, int H, int W, int C, int P, int max_bh,
                int max_bw, int cb, cudaStream_t stream) {
  const int es = (int)sizeof(T);
  const int tile = S * S * cb * es;
  const int cc = MODE == ZERO ? 1 : pick_chunk(W, cb, es, tile, cb);
  if (cc == 0) return (int)cudaErrorInvalidValue;
  const int smem = MODE == ZERO ? 0 : tile + S * W * cc * es;
  dim3 grid(P, B, C / cb);
  return launch(pool_contig_kernel<T, MODE>, grid, smem, stream, static_cast<const T*>(table),
                static_cast<const float*>(boxes), static_cast<T*>(out), B, H, W, C, P, max_bh, max_bw, cb, cc,
                0);
}

template <typename T>
int pool_mode(int mode, const void* table, const void* boxes, void* out, int B, int H, int W, int C, int P,
              int max_bh, int max_bw, cudaStream_t s) {
  switch (mode) {
    case FULL: return pool_nhwc<T, FULL>(table, boxes, out, B, H, W, C, P, max_bh, max_bw, 0, s);
    case V3: return pool_nhwc<T, V3>(table, boxes, out, B, H, W, C, P, max_bh, max_bw, 0, s);
    case NOP1: return pool_nhwc<T, NOP1>(table, boxes, out, B, H, W, C, P, max_bh, max_bw, 0, s);
    case NOP2: return pool_nhwc<T, NOP2>(table, boxes, out, B, H, W, C, P, max_bh, max_bw, 0, s);
    case NOBOTH: return pool_nhwc<T, NOBOTH>(table, boxes, out, B, H, W, C, P, max_bh, max_bw, 0, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int contig_mode(int mode, const void* table, const void* boxes, void* out, int B, int H, int W, int C, int P,
                int max_bh, int max_bw, int cb, cudaStream_t s) {
  switch (mode) {
    case FULL: return pool_contig<T, FULL>(table, boxes, out, B, H, W, C, P, max_bh, max_bw, cb, s);
    case STACK: return pool_contig<T, STACK>(table, boxes, out, B, H, W, C, P, max_bh, max_bw, cb, s);
    case P1ONLY: return pool_contig<T, P1ONLY>(table, boxes, out, B, H, W, C, P, max_bh, max_bw, cb, s);
    case ZERO: return pool_contig<T, ZERO>(table, boxes, out, B, H, W, C, P, max_bh, max_bw, cb, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each returns the cudaError_t of its
// launch. The wrapper has checked shapes, modes and divisibility.

// table (L, B, H, W, C) from features (B, H, W, C), L = max_bh levels
extern "C" int roi_ablation_build_table(const void* feat, void* table, int B, int H, int W, int C, int L,
                                        int dtype, void* stream) {
  if (B == 0 || H == 0 || W == 0 || C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return build<float>(feat, table, B, H, W, C, L, s);
  if (dtype == 1) return build<__nv_bfloat16>(feat, table, B, H, W, C, L, s);
  return (int)cudaErrorInvalidValue;
}

// K6; mode: 0 full, 1 v3, 2 noP1, 3 noP2, 4 noBoth
extern "C" int roi_ablation_pool(const void* table, const void* boxes, void* out, int B, int H, int W, int C,
                                 int P, int max_bh, int max_bw, int mode, int dtype, void* stream) {
  if (B == 0 || P == 0 || C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return pool_mode<float>(mode, table, boxes, out, B, H, W, C, P, max_bh, max_bw, s);
  if (dtype == 1) return pool_mode<__nv_bfloat16>(mode, table, boxes, out, B, H, W, C, P, max_bh, max_bw, s);
  return (int)cudaErrorInvalidValue;
}

// K7; mode: 0 full, 5 stackwrite, 6 p1only, 7 zeroOut; C % cb == 0
extern "C" int roi_ablation_pool_contig(const void* table, const void* boxes, void* out, int B, int H, int W,
                                        int C, int P, int max_bh, int max_bw, int mode, int cb, int dtype,
                                        void* stream) {
  if (B == 0 || P == 0 || C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return contig_mode<float>(mode, table, boxes, out, B, H, W, C, P, max_bh, max_bw, cb, s);
  if (dtype == 1)
    return contig_mode<__nv_bfloat16>(mode, table, boxes, out, B, H, W, C, P, max_bh, max_bw, cb, s);
  return (int)cudaErrorInvalidValue;
}

// K8 (v3 = 0) and K9 (v3 = 1); P % group == 0
extern "C" int roi_ablation_pool_grouped(const void* table, const void* boxes, void* out, int B, int H, int W,
                                         int C, int P, int max_bh, int max_bw, int v3, int group, int dtype,
                                         void* stream) {
  if (B == 0 || P == 0 || C == 0) return 0;
  if (group < 1 || P % group) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return v3 ? pool_nhwc<float, V3>(table, boxes, out, B, H, W, C, P, max_bh, max_bw, group, s)
              : pool_nhwc<float, FULL>(table, boxes, out, B, H, W, C, P, max_bh, max_bw, group, s);
  if (dtype == 1)
    return v3 ? pool_nhwc<__nv_bfloat16, V3>(table, boxes, out, B, H, W, C, P, max_bh, max_bw, group, s)
              : pool_nhwc<__nv_bfloat16, FULL>(table, boxes, out, B, H, W, C, P, max_bh, max_bw, group, s);
  return (int)cudaErrorInvalidValue;
}
