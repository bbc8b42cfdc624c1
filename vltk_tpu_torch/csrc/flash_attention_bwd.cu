// Flash-attention backward with segment ids for Hopper (sm_90a): K5 (dQ, and
// di) and K4 (dK, dV), launched in that order.
//
// Replaces: the two Pallas TPU kernels of the custom VJP of
// jax.experimental.pallas.ops.tpu.flash_attention, which JAX runs when it
// differentiates vltk_tpu/models/lxmert.py:_flash_self_attention (every
// self-attention of LayoutLM training at padded length >= 1024):
// _flash_attention_bwd_dq (K5) and _flash_attention_bwd_dkv (K4); and the
// di = sum(o * do) that JAX computes between them outside Pallas (K5).
//
// What they compute, per batch row b and head h, with q, k, v, o (the
// forward's output), do (the output gradient) and dq, dk, dv (n, s, nh, 64)
// read and written in that layout through strides, ids (n, s) int32, and the
// forward's row statistics m, l float32 (n, nh, s):
//   di = sum(o * do)     (float32 (n, nh, s); K5 writes it, K4 reads it)
//   p  = exp(q k^T * sm_scale + where(ids differ, MASK) - m) * (1 / l)
//   dv = p^T do          (p rounded to the input type first)
//   ds = (do v^T - di) * p * sm_scale
//   dk = ds^T q,  dq = ds k   (ds rounded to the input type first)
// in float32 with the results rounded to the input type once, the order and
// rounding points of the Pallas kernels. MASK is their finite -0.7 * FLT_MAX.
// As in the forward, the sequence counts as padded to a multiple of 128 with
// zero keys of id 0, but here the pad is skipped: a zero key adds nothing to
// dq (ds * 0), and a query past s has a zero output gradient, so it adds
// nothing to dk or dv; only the statistics carry the pad's effect.
//
// Bound on this card: operations. At the training inputs (n = 8, s = 1024,
// nh = 12, dh = 64, bf16, 819 real tokens of 1024 in every row) 6.84e7
// (query, key) pairs match; K4 does four 64-deep products on each, 3.50e10
// FLOP, 0.0354 ms at 989 TFLOP/s, and K5 three, 2.63e10 FLOP, 0.0266 ms.
// Their bytes (q, k, v, do, for K5 also o, the statistics and di, the
// outputs) take 0.023 ms each at 3.35 TB/s. Each also recomputes 6.8e7
// exponentials.
//
// Design (FlashAttention-2's backward, split in two kernels so that nothing
// is summed across blocks: no atomics, so dq, dk and dv are deterministic).
// A block owns resident rows, 64 per warpgroup, and streams 64-row tiles of
// the other side through a ring of NS stages in shared memory. Every tile
// is copied by TMA (one thread issues it, an mbarrier counts its bytes)
// into 128-byte-swizzled shared memory, the layout wgmma reads. Every
// product is wgmma.mma_async bf16 -> f32 on a warpgroup's 64 rows: scores
// and dp with A and B from shared memory (K-major), the gradient updates
// with the rounded p or ds as A from registers (an accumulator's layout is
// wgmma's A layout) and the streamed tile as B read transposed (tnspB). exp
// is exp2 on pre-scaled scores (ex2.approx.ftz).
//   K5: one block of one warpgroup per (64 queries, b x h). Its q, do and o
// tiles come in once; the prologue computes di for its rows from o and do
// (and writes it for K4), reads m and l, and then walks the key tiles:
// S = q k^T, dP = do v^T (m64n64), p and ds in registers, dQ += ds k. Two
// warpgroups of 64 queries a block spill at two blocks an SM (128
// registers) and run a fifth slower at one block an SM, so K5 takes one
// warpgroup at three blocks an SM (at most 168 registers): one block's
// exponentials overlap another's products.
//   K4: one block of one warpgroup per (64 keys, b x h). Its k and v tiles
// come in once; the ring carries the query tiles of q and do with their m,
// l, di and ids, taken in two halves of 32 queries: S^T = k q^T, dP^T =
// v do^T (m64n32), dV += p^T do, dK += ds^T q. The halves keep a thread
// under 168 registers (dK and dV hold 64), so three blocks share an SM. On an
// H100 this beats two warpgroups of 64 keys each in one block (one block
// an SM) at the training inputs, although fewer resident keys read each
// query tile from L2 twice as often:
// tools/sweep_flash_backward.py times both (PERF.md keeps the numbers).
//   Tile skipping: each block reduces its batch row's ids to a [min, max]
// interval per 64-row tile and walks only the streamed tiles whose interval
// meets one of its warpgroups' (a warpgroup skips the products of a tile
// that meets only another's). This is exact: a pair of rows whose ids
// differ has p = exp2(MASK - m) = 0 in float32, and so ds = 0, so a skipped
// tile would add only zeros; a query always matches its own key, so no row
// loses all its keys.
//   One thread issues the ring's next TMA before the block waits on the
// current stage, and one __syncthreads per tile frees a stage for reuse: no
// warp specialisation yet. `-Xptxas -v` reports the registers; no spills.
//
// float32 inputs take scalar instantiations of the same algorithm (one
// thread per key row for K4, per query row for K5), for the dtype=None
// configs and the float32 checks; K5's computes di too.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_utils.cuh"

namespace {

constexpr int D = 64;         // head size
constexpr int BT = 64;        // rows of a streamed tile, and of a warpgroup's share
// Block shapes as three digits: warpgroups of 64 resident rows per block,
// blocks an SM keeps (it caps the registers: 65536 / (128 x warpgroups x
// blocks)), stages of the ring. The design note says why these;
// tools/sweep_flash_backward.py builds others with -DDQ_SHAPE / -DDKV_SHAPE.
#ifndef DQ_SHAPE
#define DQ_SHAPE 133  // K5: 128 threads at <= 168 registers
#endif
#ifndef DKV_SHAPE
#define DKV_SHAPE 133  // K4: 128 threads at <= 168 registers
#endif
constexpr int TILE = BT * D;  // elements of a 64-row tile
constexpr uint32_t TILE_BYTES = TILE * 2;
constexpr float MASK_VALUE = -0.7f * FLT_MAX;
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const void* o;
  const int* ids;
  const float* m;
  const float* l;
  float* di;
  void* dq;
  void* dk;
  void* dv;
  int s, nh;
  // (batch, seq, head) strides in elements of q, k, v, do, o, dq, dk, dv
  long long st[8][3];
  float sm_scale;
};

enum { Q = 0, K = 1, V = 2, DO = 3, O = 4, DQ = 5, DK = 6, DV = 7 };

// the TMA maps of the bf16 inputs (o: K5 only)
struct Maps {
  CUtensorMap q, k, v, dout, o;
};

template <typename T>
__device__ __forceinline__ T* base(const Params& p, const void* ptr, int which) {
  const int b = blockIdx.y / p.nh, h = blockIdx.y % p.nh;
  return static_cast<T*>(const_cast<void*>(ptr)) + b * p.st[which][0] + h * p.st[which][2];
}

// ------------------------------------------------------ bf16 shared helpers

// [min, max] of the ids of each 64-row tile's rows below s (the empty
// interval for none), one warp per tile
__device__ __forceinline__ void tile_intervals(const int* ids, int s, int nt, int2* iv) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t = warp; t < nt; t += blockDim.x / 32) {
    int lo = INT_MAX, hi = INT_MIN;
    for (int r = lane; r < BT; r += 32) {
      const int row = t * BT + r;
      if (row < s) {
        lo = min(lo, ids[row]);
        hi = max(hi, ids[row]);
      }
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(~0u, lo, o));
      hi = max(hi, __shfl_xor_sync(~0u, hi, o));
    }
    if (lane == 0) iv[t] = make_int2(lo, hi);
  }
}

// the interval of warpgroup w's resident rows (a block of WGS warpgroups
// owns tiles WGS * blockIdx.x ...)
template <int WGS>
__device__ __forceinline__ int2 own_interval(const int2* iv, int nt, int w) {
  const int t = WGS * blockIdx.x + w;
  return t < nt ? iv[t] : empty_interval();
}

// one warp: the streamed tiles whose interval meets one of the block's
// warpgroups', in order, and their count
template <int WGS>
__device__ __forceinline__ void needed_tiles(const int2* iv, int nt, int* list, int* count) {
  const int lane = threadIdx.x & 31;
  int c = 0;
  for (int b0 = 0; b0 < nt; b0 += 32) {
    const int t = b0 + lane;
    bool need = false;
#pragma unroll
    for (int w = 0; w < WGS; ++w) need = need || (t < nt && meets(iv[t], own_interval<WGS>(iv, nt, w)));
    const unsigned ballot = __ballot_sync(~0u, need);
    if (need) list[c + __popc(ballot & ((1u << lane) - 1))] = t;
    c += __popc(ballot);
  }
  if (lane == 0) *count = c;
}

// write a warp's 16 rows of a warpgroup accumulator (r_lo = row0 + g, r_hi
// = r_lo + 8) to a (s, 64) bf16 view with row stride ss
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, long long ss, const float (&c)[32], int r_lo,
                                           int s, int tig) {
  const int r_hi = r_lo + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = j * 8 + 2 * tig;
    if (r_lo < s)
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)r_lo * ss + col) =
          __floats2bfloat162_rn(c[4 * j], c[4 * j + 1]);
    if (r_hi < s)
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)r_hi * ss + col) =
          __floats2bfloat162_rn(c[4 * j + 2], c[4 * j + 3]);
  }
}

// the resident rows of a block, 64 per warpgroup from row0, into `dst`; a
// tile that starts past s is not loaded (its warpgroup has no row to
// compute or store)
template <int WGS>
__device__ __forceinline__ void load_resident(__nv_bfloat16* dst, const CUtensorMap* map, uint64_t* bar, int row0,
                                              int s, int h, int b) {
  for (int w = 0; w < WGS; ++w)
    if (row0 + w * BT < s) tma_load_4d(dst + w * TILE, map, bar, 0, h, row0 + w * BT, b);
}

// the bytes load_resident copies
template <int WGS>
__device__ __forceinline__ uint32_t resident_bytes(int row0, int s) {
  uint32_t bytes = 0;
  for (int w = 0; w < WGS; ++w) bytes += row0 + w * BT < s ? TILE_BYTES : 0u;
  return bytes;
}

// shared memory of the bf16 kernels, in bytes (the first 1024 are room to
// align the tiles); rows = resident rows of a block, NS = stages of the
// ring, nt = tiles of 64 rows in s
__host__ __device__ constexpr size_t dq_smem_bytes(int rows, int NS, int nt) {
  return 1024 + (size_t)(3 * rows + 2 * NS * BT) * D * 2  // q, do, o; the k, v ring
         + (NS + 1) * 8                                     // barriers
         + (4 * rows + NS * BT) * 4                         // m, 1/l, di, ids of the queries; key ids
         + (size_t)nt * 12 + 4;                             // intervals, tile list, count
}
__host__ __device__ constexpr size_t dkv_smem_bytes(int rows, int NS, int nt) {
  return 1024 + (size_t)(2 * rows + 2 * NS * BT) * D * 2  // k, v; the q, do ring
         + (NS + 1) * 8                                     // barriers
         + 4 * NS * BT * 4                                  // m, 1/l, di, ids of the ring's queries
         + (size_t)nt * 12 + 4;                             // intervals, tile list, count
}

// ------------------------------------------------------------- K5, bf16

template <int WGS, int MIN_BLOCKS, int NS>
__global__ void __launch_bounds__(128 * WGS, MIN_BLOCKS)
    flash_bwd_dq_bf16(const __grid_constant__ Maps maps, Params p) {
  constexpr int TR = WGS * BT;  // resident query rows
  static_assert(NS >= 2, "the ring loads one stage ahead");
  extern __shared__ uint8_t smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(align1024(smem_raw));
  __nv_bfloat16* sDO = sQ + TR * D;
  __nv_bfloat16* sO = sDO + TR * D;
  __nv_bfloat16* sK = sO + TR * D;  // NS tiles
  __nv_bfloat16* sV = sK + NS * TILE;
  uint64_t* full = reinterpret_cast<uint64_t*>(sV + NS * TILE);  // NS
  uint64_t* res = full + NS;
  float* sM = reinterpret_cast<float*>(res + 1);  // m * log2(e) of the 128 queries
  float* sIL = sM + TR;                           // 1 / l
  float* sDi = sIL + TR;
  int* sQid = reinterpret_cast<int*>(sDi + TR);
  int* sKid = sQid + TR;  // NS x 64 key ids
  int2* sIv = reinterpret_cast<int2*>(sKid + NS * BT);
  const int s = p.s, nt = (s + BT - 1) / BT;
  int* sList = reinterpret_cast<int*>(sIv + nt);
  int* sCount = sList + nt;

  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int b = blockIdx.y / p.nh, h = blockIdx.y % p.nh;
  const int q0 = blockIdx.x * TR;
  const int* ids = p.ids + (size_t)b * s;
  const size_t srow = (size_t)blockIdx.y * s;

  if (tid == 0) {
    for (int i = 0; i < NS; ++i) mbar_init(&full[i], 1);
    mbar_init(res, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    tma_prefetch_map(&maps.k);
    tma_prefetch_map(&maps.v);
    mbar_expect_tx(res, 3 * resident_bytes<WGS>(q0, s));
    load_resident<WGS>(sQ, &maps.q, res, q0, s, h, b);
    load_resident<WGS>(sDO, &maps.dout, res, q0, s, h, b);
    load_resident<WGS>(sO, &maps.o, res, q0, s, h, b);
  }
  tile_intervals(ids, s, nt, sIv);
  if (tid < TR) {
    const int row = q0 + tid;
    const bool live = row < s;
    sM[tid] = live ? p.m[srow + row] * LOG2E : 0.f;
    sIL[tid] = live ? 1.f / p.l[srow + row] : 0.f;
    sQid[tid] = live ? ids[row] : -2;
  }
  __syncthreads();
  if (warp == 0) needed_tiles<WGS>(sIv, nt, sList, sCount);
  __syncthreads();
  const int cnt = *sCount;
  const int2 mine = own_interval<WGS>(sIv, nt, wg);

  auto load_stage = [&](int i) {  // entry i of the list into stage i % NS
    const int st = i % NS, k0 = sList[i] * BT;
    mbar_expect_tx(&full[st], 2 * TILE_BYTES);
    tma_load_4d(sK + st * TILE, &maps.k, &full[st], 0, h, k0, b);
    tma_load_4d(sV + st * TILE, &maps.v, &full[st], 0, h, k0, b);
  };
  // a key past s is a zero key: id -1 skips it (it would add ds * 0)
  auto key_id = [&](int i) {  // thread tid < 64: the id of key row tid of entry i
    const int key = sList[i] * BT + tid;
    return key < s ? ids[key] : -1;
  };
  const int ahead0 = min(NS - 1, cnt);
  if (tid == 0)
    for (int i = 0; i < ahead0; ++i) load_stage(i);
  if (tid < BT)
    for (int i = 0; i < ahead0; ++i) sKid[(i % NS) * BT + tid] = key_id(i);

  // di of row tid / 2 from its o and do rows (two threads, 32 columns each)
  mbar_wait(res, 0);
  {
    const int r = tid >> 1, half = tid & 1;
    const uint8_t* orow = reinterpret_cast<const uint8_t*>(sO) + r * 128;
    const uint8_t* dorow = reinterpret_cast<const uint8_t*>(sDO) + r * 128;
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int chunk = (half * 4 + c) ^ (r & 7);  // the 128B swizzle
      const uint4 ov = *reinterpret_cast<const uint4*>(orow + chunk * 16);
      const uint4 dv = *reinterpret_cast<const uint4*>(dorow + chunk * 16);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = __bfloat1622float2(o2[e]), x = __bfloat1622float2(d2[e]);
        acc = fmaf(a.x, x.x, acc);
        acc = fmaf(a.y, x.y, acc);
      }
    }
    acc += __shfl_xor_sync(~0u, acc, 1);
    if (half == 0) {
      sDi[r] = acc;
      if (q0 + r < s) p.di[srow + q0 + r] = acc;
    }
  }
  __syncthreads();

  // this thread's two query rows of its warpgroup's 64
  const int rl = wg * BT + (warp & 3) * 16 + g, rh = rl + 8;
  const int id_lo = sQid[rl], id_hi = sQid[rh];
  const float m_lo = sM[rl], m_hi = sM[rh], il_lo = sIL[rl], il_hi = sIL[rh];
  const float di_lo = sDi[rl], di_hi = sDi[rh];
  const float scale = p.sm_scale * LOG2E;
  const uint64_t q_a = sw128_desc(sQ + wg * TILE), do_a = sw128_desc(sDO + wg * TILE);

  float dq[32], sc[32], dp[32];
  zero(dq);
  zero(sc);
  zero(dp);
  for (int i = 0; i < cnt; ++i) {
    const int st = i % NS, ahead = i + NS - 1;
    int next_id = -1;
    if (ahead < cnt) {
      if (tid == 0) load_stage(ahead);  // into the stage freed at the end of i - 1
      if (tid < BT) next_id = key_id(ahead);
    }
    if (meets(sIv[sList[i]], mine)) {
      mbar_wait(&full[st], (i / NS) & 1);
      const uint64_t k_b = sw128_desc(sK + st * TILE), v_b = sw128_desc(sV + st * TILE);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss<0>(sc, q_a + kk * DESC_K_STEP, k_b + kk * DESC_K_STEP, kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss<0>(dp, do_a + kk * DESC_K_STEP, v_b + kk * DESC_K_STEP, kk);
      wgmma_commit();
      wgmma_wait<1>();  // S
      fence_acc(sc);
      const int* kid = sKid + st * BT;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int2 kk = *reinterpret_cast<const int2*>(kid + 8 * j + 2 * tig);  // columns 2 tig, 2 tig + 1
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool lo = e < 2;
          const float x = (e & 1 ? kk.y : kk.x) == (lo ? id_lo : id_hi) ? sc[4 * j + e] * scale : MASK_VALUE;
          sc[4 * j + e] = exp2_ftz(x - (lo ? m_lo : m_hi)) * (lo ? il_lo : il_hi);
        }
      }
      wgmma_wait<0>();  // dP
      fence_acc(dp);
      uint32_t a[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[4 * j + e] = (dp[4 * j + e] - (e < 2 ? di_lo : di_hi)) * sc[4 * j + e] * p.sm_scale;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_a(a[kk], dp, kk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<1>(dq, a[kk], k_b + kk * DESC_MN_STEP, 1);  // dQ += ds k
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dq);
    }
    if (ahead < cnt && tid < BT) sKid[(ahead % NS) * BT + tid] = next_id;
    __syncthreads();  // stage i read by both warpgroups before it is refilled
  }

  store_rows(base<__nv_bfloat16>(p, p.dq, DQ), p.st[DQ][1], dq, q0 + rl, s, tig);
}

// ------------------------------------------------------------- K4, bf16

template <int WGS, int MIN_BLOCKS, int NS>
__global__ void __launch_bounds__(128 * WGS, MIN_BLOCKS)
    flash_bwd_dkv_bf16(const __grid_constant__ Maps maps, Params p) {
  constexpr int TR = WGS * BT;  // resident key rows
  static_assert(NS >= 2, "the ring loads one stage ahead");
  extern __shared__ uint8_t smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(align1024(smem_raw));
  __nv_bfloat16* sV = sK + TR * D;
  __nv_bfloat16* sQ = sV + TR * D;  // NS tiles
  __nv_bfloat16* sDO = sQ + NS * TILE;
  uint64_t* full = reinterpret_cast<uint64_t*>(sDO + NS * TILE);  // NS
  uint64_t* res = full + NS;
  float* sM = reinterpret_cast<float*>(res + 1);  // NS x 64: m * log2(e) of the ring's queries
  float* sIL = sM + NS * BT;                      // 1 / l
  float* sDi = sIL + NS * BT;
  int* sQid = reinterpret_cast<int*>(sDi + NS * BT);
  int2* sIv = reinterpret_cast<int2*>(sQid + NS * BT);
  const int s = p.s, nt = (s + BT - 1) / BT;
  int* sList = reinterpret_cast<int*>(sIv + nt);
  int* sCount = sList + nt;

  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int b = blockIdx.y / p.nh, h = blockIdx.y % p.nh;
  const int k0 = blockIdx.x * TR;
  const int* ids = p.ids + (size_t)b * s;
  const size_t srow = (size_t)blockIdx.y * s;

  if (tid == 0) {
    for (int i = 0; i < NS; ++i) mbar_init(&full[i], 1);
    mbar_init(res, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    tma_prefetch_map(&maps.q);
    tma_prefetch_map(&maps.dout);
    mbar_expect_tx(res, 2 * resident_bytes<WGS>(k0, s));
    load_resident<WGS>(sK, &maps.k, res, k0, s, h, b);
    load_resident<WGS>(sV, &maps.v, res, k0, s, h, b);
  }
  tile_intervals(ids, s, nt, sIv);
  __syncthreads();
  if (warp == 0) needed_tiles<WGS>(sIv, nt, sList, sCount);
  __syncthreads();
  const int cnt = *sCount;
  const int2 mine = own_interval<WGS>(sIv, nt, wg);

  auto load_stage = [&](int i) {  // entry i of the list into stage i % NS
    const int st = i % NS, q0 = sList[i] * BT;
    mbar_expect_tx(&full[st], 2 * TILE_BYTES);
    tma_load_4d(sQ + st * TILE, &maps.q, &full[st], 0, h, q0, b);
    tma_load_4d(sDO + st * TILE, &maps.dout, &full[st], 0, h, q0, b);
  };
  // a query past s: id -1 matches no key, so its p is 0. Threads 0-63 carry
  // m and 1 / l of query row tid of entry i, threads 64-127 di and the id of
  // row tid - 64.
  auto row_data = [&](int i, float& x, float& y) {
    const int r = tid & (BT - 1), row = sList[i] * BT + r;
    const bool live = row < s;
    if (tid < BT) {
      x = live ? p.m[srow + row] * LOG2E : 0.f;
      y = live ? 1.f / p.l[srow + row] : 0.f;
    } else {
      x = live ? p.di[srow + row] : 0.f;
      y = __int_as_float(live ? ids[row] : -1);
    }
  };
  auto store_row_data = [&](int i, float x, float y) {
    const int at = (i % NS) * BT + (tid & (BT - 1));
    if (tid < BT) {
      sM[at] = x;
      sIL[at] = y;
    } else {
      sDi[at] = x;
      sQid[at] = __float_as_int(y);
    }
  };
  const int ahead0 = min(NS - 1, cnt);
  if (tid == 0)
    for (int i = 0; i < ahead0; ++i) load_stage(i);
  if (tid < 2 * BT) {
    for (int i = 0; i < ahead0; ++i) {
      float x, y;
      row_data(i, x, y);
      store_row_data(i, x, y);
    }
  }

  // this thread's two key rows of its warpgroup's 64 (a key past s is never
  // stored; id 0 as the zero keys of the pad)
  const int rl = wg * BT + (warp & 3) * 16 + g;
  const int kr_lo = k0 + rl, kr_hi = kr_lo + 8;
  const int kid_lo = kr_lo < s ? ids[kr_lo] : 0;
  const int kid_hi = kr_hi < s ? ids[kr_hi] : 0;
  const float scale = p.sm_scale * LOG2E;
  const uint64_t k_a = sw128_desc(sK + wg * TILE), v_a = sw128_desc(sV + wg * TILE);
  __syncthreads();  // the first stages' row data
  mbar_wait(res, 0);

  float dk[32], dv[32], sc[16], dp[16];
  zero(dk);
  zero(dv);
  zero(sc);
  zero(dp);
  for (int i = 0; i < cnt; ++i) {
    const int st = i % NS, ahead = i + NS - 1;
    float nx = 0.f, ny = 0.f;
    if (ahead < cnt) {
      if (tid == 0) load_stage(ahead);  // into the stage freed at the end of i - 1
      if (tid < 2 * BT) row_data(ahead, nx, ny);
    }
    if (meets(sIv[sList[i]], mine)) {
      mbar_wait(&full[st], (i / NS) & 1);
      // the 64 queries of the stage in two halves of 32, which keeps the
      // score tiles to 16 registers each
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const __nv_bfloat16* qt = sQ + st * TILE + half * 32 * D;
        const __nv_bfloat16* dot = sDO + st * TILE + half * 32 * D;
        const uint64_t q_b = sw128_desc(qt), do_b = sw128_desc(dot);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_ss_n32<0>(sc, k_a + kk * DESC_K_STEP, q_b + kk * DESC_K_STEP, kk);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_ss_n32<0>(dp, v_a + kk * DESC_K_STEP, do_b + kk * DESC_K_STEP, kk);
        wgmma_commit();
        wgmma_wait<1>();  // S^T: 64 keys x 32 queries
        fence_acc(sc);
        const int c0 = st * BT + half * 32;
        const float* m2 = sM + c0;
        const float* il = sIL + c0;
        const float* dd = sDi + c0;
        const int* qid = sQid + c0;
        // this thread's columns 8 j + 2 tig and 8 j + 2 tig + 1 as pairs
        auto pair = [&](const float* v, int j) { return *reinterpret_cast<const float2*>(v + 8 * j + 2 * tig); };
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 mm = pair(m2, j), ll = pair(il, j);
          const int2 qq = *reinterpret_cast<const int2*>(qid + 8 * j + 2 * tig);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool hit = (e & 1 ? qq.y : qq.x) == (e < 2 ? kid_lo : kid_hi);
            const float x = hit ? sc[4 * j + e] * scale : MASK_VALUE;
            sc[4 * j + e] = exp2_ftz(x - (e & 1 ? mm.y : mm.x)) * (e & 1 ? ll.y : ll.x);
          }
        }
        uint32_t a[2][4];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) acc_to_a(a[kk], sc, kk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) wgmma_rs<1>(dv, a[kk], do_b + kk * DESC_MN_STEP, 1);  // dV += p^T do
        wgmma_commit();
        wgmma_wait<1>();  // dP^T
        fence_acc(dp);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 d2 = pair(dd, j);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[4 * j + e] = (dp[4 * j + e] - (e & 1 ? d2.y : d2.x)) * sc[4 * j + e] * p.sm_scale;
        }
        uint32_t c[2][4];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) acc_to_a(c[kk], dp, kk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) wgmma_rs<1>(dk, c[kk], q_b + kk * DESC_MN_STEP, 1);  // dK += ds^T q
        wgmma_commit();  // the second half's first wait retires the first half's updates
      }
      wgmma_wait<0>();
      fence_acc(dv);
      fence_acc(dk);
    }
    if (ahead < cnt && tid < 2 * BT) store_row_data(ahead, nx, ny);
    __syncthreads();  // stage i read by every warpgroup before it is refilled
  }

  store_rows(base<__nv_bfloat16>(p, p.dk, DK), p.st[DK][1], dk, kr_lo, s, tig);
  store_rows(base<__nv_bfloat16>(p, p.dv, DV), p.st[DV][1], dv, kr_lo, s, tig);
}

// --------------------------------------------------------------- float32

constexpr int FB = 64;      // rows (threads) of a float32 block
constexpr int FT = 16;      // streamed rows per step of the scalar kernels
constexpr int FLD = D + 1;  // padded stride of the per-thread rows

// K4 in float32: thread t owns key k0 + t; query tiles of FT rows are
// streamed through shared memory
__global__ void __launch_bounds__(FB) flash_bwd_dkv_f32(Params p) {
  __shared__ float sK[FB * FLD], sV[FB * FLD];
  __shared__ float sQ[FT][D], sO[FT][D];
  __shared__ float sM[FT], sL[FT], sD[FT];
  __shared__ int sId[FT];

  const int tid = threadIdx.x;
  const int key = blockIdx.x * FB + tid;
  const float* Qp = base<const float>(p, p.q, Q);
  const float* Kp = base<const float>(p, p.k, K);
  const float* Vp = base<const float>(p, p.v, V);
  const float* Op = base<const float>(p, p.dout, DO);
  const int* ids = p.ids + (size_t)(blockIdx.y / p.nh) * p.s;
  const size_t srow = (size_t)blockIdx.y * p.s;
  const bool live = key < p.s;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    sK[tid * FLD + d] = live ? Kp[(size_t)key * p.st[K][1] + d] : 0.f;
    sV[tid * FLD + d] = live ? Vp[(size_t)key * p.st[V][1] + d] : 0.f;
  }
  const int kid = live ? ids[key] : 0;
  float dk[D], dv[D];
#pragma unroll
  for (int d = 0; d < D; ++d) dk[d] = dv[d] = 0.f;

  for (int q0 = 0; q0 < p.s; q0 += FT) {
    __syncthreads();
    for (int i = tid; i < FT * D; i += FB) {
      const int r = i / D, c = i % D, row = q0 + r;
      sQ[r][c] = row < p.s ? Qp[(size_t)row * p.st[Q][1] + c] : 0.f;
      sO[r][c] = row < p.s ? Op[(size_t)row * p.st[DO][1] + c] : 0.f;
    }
    if (tid < FT) {
      const int row = q0 + tid;
      const bool ok = row < p.s;
      sM[tid] = ok ? p.m[srow + row] : 0.f;
      sL[tid] = ok ? 1.f / p.l[srow + row] : 0.f;
      sD[tid] = ok ? p.di[srow + row] : 0.f;
      sId[tid] = ok ? ids[row] : -1;
    }
    __syncthreads();
    for (int i = 0; i < FT; ++i) {
      float dot = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dot = fmaf(sQ[i][d], sK[tid * FLD + d], dot);
        dp = fmaf(sO[i][d], sV[tid * FLD + d], dp);
      }
      const float x = sId[i] == kid ? dot * p.sm_scale : MASK_VALUE;
      const float pij = expf(x - sM[i]) * sL[i];
      const float ds = (dp - sD[i]) * pij * p.sm_scale;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dv[d] = fmaf(pij, sO[i][d], dv[d]);
        dk[d] = fmaf(ds, sQ[i][d], dk[d]);
      }
    }
  }
  if (live) {
    float* DKp = base<float>(p, p.dk, DK) + (size_t)key * p.st[DK][1];
    float* DVp = base<float>(p, p.dv, DV) + (size_t)key * p.st[DV][1];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      DKp[d] = dk[d];
      DVp[d] = dv[d];
    }
  }
}

// K5 in float32: thread t owns query q0 + t (and writes its di); key tiles
// of FT rows are streamed through shared memory
__global__ void __launch_bounds__(FB) flash_bwd_dq_f32(Params p) {
  __shared__ float sQ[FB * FLD], sO[FB * FLD];
  __shared__ float sK[FT][D], sV[FT][D];
  __shared__ int sId[FT];

  const int tid = threadIdx.x;
  const int row = blockIdx.x * FB + tid;
  const float* Qp = base<const float>(p, p.q, Q);
  const float* Kp = base<const float>(p, p.k, K);
  const float* Vp = base<const float>(p, p.v, V);
  const float* Op = base<const float>(p, p.dout, DO);
  const float* Outp = base<const float>(p, p.o, O);
  const int* ids = p.ids + (size_t)(blockIdx.y / p.nh) * p.s;
  const size_t srow = (size_t)blockIdx.y * p.s;
  const bool live = row < p.s;
  float di = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    sQ[tid * FLD + d] = live ? Qp[(size_t)row * p.st[Q][1] + d] : 0.f;
    const float g = live ? Op[(size_t)row * p.st[DO][1] + d] : 0.f;
    sO[tid * FLD + d] = g;
    di = fmaf(live ? Outp[(size_t)row * p.st[O][1] + d] : 0.f, g, di);
  }
  if (live) p.di[srow + row] = di;
  const int qid = live ? ids[row] : -2;
  const float m = live ? p.m[srow + row] : 0.f;
  const float il = live ? 1.f / p.l[srow + row] : 0.f;
  float dq[D];
#pragma unroll
  for (int d = 0; d < D; ++d) dq[d] = 0.f;

  for (int k0 = 0; k0 < p.s; k0 += FT) {
    __syncthreads();
    for (int i = tid; i < FT * D; i += FB) {
      const int r = i / D, c = i % D, key = k0 + r;
      sK[r][c] = key < p.s ? Kp[(size_t)key * p.st[K][1] + c] : 0.f;
      sV[r][c] = key < p.s ? Vp[(size_t)key * p.st[V][1] + c] : 0.f;
    }
    if (tid < FT) sId[tid] = k0 + tid < p.s ? ids[k0 + tid] : -1;
    __syncthreads();
    for (int j = 0; j < FT; ++j) {
      float dot = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dot = fmaf(sQ[tid * FLD + d], sK[j][d], dot);
        dp = fmaf(sO[tid * FLD + d], sV[j][d], dp);
      }
      const float x = sId[j] == qid ? dot * p.sm_scale : MASK_VALUE;
      const float pij = expf(x - m) * il;
      const float ds = (dp - di) * pij * p.sm_scale;
#pragma unroll
      for (int d = 0; d < D; ++d) dq[d] = fmaf(ds, sK[j][d], dq[d]);
    }
  }
  if (live) {
    float* DQp = base<float>(p, p.dq, DQ) + (size_t)row * p.st[DQ][1];
#pragma unroll
    for (int d = 0; d < D; ++d) DQp[d] = dq[d];
  }
}

// ------------------------------------------------------------------ host

Params make_params(const void* q, const void* k, const void* v, const void* dout, const void* o, const int* ids,
                   const float* m, const float* l, float* di, void* dq, void* dk, void* dv, int s, int nh,
                   const long long* strides, float sm_scale) {
  Params p{q, k, v, dout, o, ids, m, l, di, dq, dk, dv, s, nh, {}, sm_scale};
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) p.st[t][i] = strides[3 * t + i];
  return p;
}

// the maps of q, k, v, do and, for K5, o
bool make_maps(Maps* maps, const Params& p, int n, bool with_o) {
  return make_map(&maps->q, p.q, n, p.s, p.nh, p.st[Q], BT) && make_map(&maps->k, p.k, n, p.s, p.nh, p.st[K], BT) &&
         make_map(&maps->v, p.v, n, p.s, p.nh, p.st[V], BT) &&
         make_map(&maps->dout, p.dout, n, p.s, p.nh, p.st[DO], BT) &&
         (!with_o || make_map(&maps->o, p.o, n, p.s, p.nh, p.st[O], BT));
}

constexpr size_t MAX_SMEM = 232448;  // what a block of this card can have

template <int WGS, typename Kernel>
int launch_bf16(Kernel kernel, size_t smem, bool with_o, const Params& p, int n, cudaStream_t st) {
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  // a runtime call first, as make_map needs
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  Maps maps;
  if (!make_maps(&maps, p, n, with_o)) return (int)cudaErrorInvalidValue;
  dim3 grid((p.s + WGS * BT - 1) / (WGS * BT), n * p.nh);
  kernel<<<grid, 128 * WGS, smem, st>>>(maps, p);
  return (int)cudaGetLastError();
}

// K5 and K4 at a block shape (see DQ_SHAPE)
template <int SHAPE>
int launch_dq(const Params& p, int n, cudaStream_t st) {
  constexpr int wgs = SHAPE / 100, blocks = SHAPE / 10 % 10, stages = SHAPE % 10;
  const size_t smem = dq_smem_bytes(wgs * BT, stages, (p.s + BT - 1) / BT);
  return launch_bf16<wgs>(flash_bwd_dq_bf16<wgs, blocks, stages>, smem, true, p, n, st);
}
template <int SHAPE>
int launch_dkv(const Params& p, int n, cudaStream_t st) {
  constexpr int wgs = SHAPE / 100, blocks = SHAPE / 10 % 10, stages = SHAPE % 10;
  const size_t smem = dkv_smem_bytes(wgs * BT, stages, (p.s + BT - 1) / BT);
  return launch_bf16<wgs>(flash_bwd_dkv_bf16<wgs, blocks, stages>, smem, false, p, n, st);
}

}  // namespace

// q, k, v, dout (the output gradient), o (the forward's output) and dq, dk,
// dv: (n, s, nh, 64) with the (batch, seq, head) strides in elements given
// in that order, 24 values (the last stride is 1; for bf16 every base
// pointer is 16-byte aligned and every stride a positive multiple of 8, as
// TMA needs; the outputs a kernel does not write, and o for K4, may be
// null); ids (n, s) int32 contiguous; m, l, di float32 (n, nh, s)
// contiguous: K5 writes di, K4 reads it, so K5 runs first. dtype: 0 =
// float32, 1 = bfloat16. Each returns the cudaError_t of its launch.
#define FLASH_BWD_ARGS                                                                                     \
  const void *q, const void *k, const void *v, const void *dout, const void *o, const int *ids,           \
      const float *m, const float *l, float *di, void *dq, void *dk, void *dv, int n, int s, int nh,      \
      const long long *strides, float sm_scale, int dtype, void *stream

// K5: dq and di
extern "C" int flash_attention_backward_dq(FLASH_BWD_ARGS) {
  if (n == 0 || s == 0 || nh == 0) return 0;
  const Params p = make_params(q, k, v, dout, o, ids, m, l, di, dq, dk, dv, s, nh, strides, sm_scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_dq<DQ_SHAPE>(p, n, st);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  flash_bwd_dq_f32<<<dim3((s + FB - 1) / FB, n * nh), FB, 0, st>>>(p);
  return (int)cudaGetLastError();
}

// K4: dk and dv
extern "C" int flash_attention_backward_dkv(FLASH_BWD_ARGS) {
  if (n == 0 || s == 0 || nh == 0) return 0;
  const Params p = make_params(q, k, v, dout, o, ids, m, l, di, dq, dk, dv, s, nh, strides, sm_scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_dkv<DKV_SHAPE>(p, n, st);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  flash_bwd_dkv_f32<<<dim3((s + FB - 1) / FB, n * nh), FB, 0, st>>>(p);
  return (int)cudaGetLastError();
}
