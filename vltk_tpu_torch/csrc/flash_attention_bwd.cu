// Flash-attention backward with segment ids for Hopper (sm_90a): K4 (dK, dV)
// and K5 (dQ).
//
// Replaces: the two Pallas TPU kernels of the custom VJP of
// jax.experimental.pallas.ops.tpu.flash_attention, which JAX runs when it
// differentiates vltk_tpu/models/lxmert.py:_flash_self_attention (every
// self-attention of LayoutLM training at padded length >= 1024):
// _flash_attention_bwd_dkv (K4) and _flash_attention_bwd_dq (K5).
//
// What they compute, per batch row b and head h, with q, k, v, do (the
// output gradient) and dq, dk, dv (n, s, nh, 64) read and written in that
// layout through strides, ids (n, s) int32, and the forward's row statistics
// m, l and di = sum(o * do) float32 (n, nh, s):
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
// Bound on this card: operations. At the training shape (n = 8, s = 1024,
// nh = 12, dh = 64, bf16) K4 does four s x s x 64 products per (b, h),
// 5.2e10 FLOP, 0.052 ms at 989 TFLOP/s, and K5 three, 3.9e10 FLOP, 0.039 ms;
// their bytes (q, k, v, do, the statistics, the outputs) take ~0.02 ms each
// at 3.35 TB/s. Each also recomputes 1.0e8 exponentials.
//
// Design (FlashAttention-2's backward, split in two kernels so that nothing
// is summed across blocks: no atomics, so dq, dk and dv are deterministic).
// K4: one block of 4 warps per (64-key tile, batch row x head); each warp owns
// 16 keys, keeps their k and v as mma A fragments and their 16 x 64 dK and dV
// accumulators in registers, and walks every query tile: it recomputes p^T
// (keys x queries) from q and the statistics, takes dV += p^T do, then
// dp^T = v do^T, ds^T, and dK += ds^T q. K5: one block per (64-query tile,
// batch row x head); each warp owns 16 queries, keeps q and do as A
// fragments, their statistics and di in registers (read once), and walks
// every key tile: p, dp = do v^T, ds, dQ += ds k. The streamed q/do (K4) or
// k/v (K5) tiles are double-buffered in shared memory with cp.async; the
// block's own tiles are staged through the second buffer before the loop.
// All products are warp-level mma.sync.m16n8k16 bf16 -> f32 with ldmatrix
// (.trans where the tile's rows are the product's depth); score fragments
// are re-packed in registers as the A operand. exp is exp2 on pre-scaled
// scores. This is the simple form: wgmma and TMA are a later step.
//
// float32 inputs take scalar instantiations of the same algorithm (one
// thread per key row for K4, per query row for K5), for the dtype=None
// configs and the float32 checks.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "mma_utils.cuh"

namespace {

constexpr int D = 64;       // head size
constexpr int BT = 64;      // rows of a tile (keys or queries)
constexpr int LDS = D + 8;  // shared row stride (elements): 144 bytes
constexpr float MASK_VALUE = -0.7f * FLT_MAX;
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const int* ids;
  const float* m;
  const float* l;
  const float* di;
  void* dq;
  void* dk;
  void* dv;
  int s, nh;
  // (batch, seq, head) strides in elements of q, k, v, do, dq, dk, dv
  long long st[7][3];
  float sm_scale;
};

enum { Q = 0, K = 1, V = 2, DO = 3, DQ = 4, DK = 5, DV = 6 };

template <typename T>
__device__ __forceinline__ T* base(const Params& p, const void* ptr, int which) {
  const int b = blockIdx.y / p.nh, h = blockIdx.y % p.nh;
  return static_cast<T*>(const_cast<void*>(ptr)) + b * p.st[which][0] + h * p.st[which][2];
}

__device__ __forceinline__ void zero(float (&c)[8][4]) {
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[t][e] = 0.f;
}

// a warp's A fragments of rows [warp*16, warp*16+16) of a 64 x 64 tile
__device__ __forceinline__ void load_a(uint32_t (&f)[4][4], const __nv_bfloat16* tile, int warp,
                                       int lane) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    ldmatrix_x4(f[ks], &tile[(warp * 16 + (lane & 15)) * LDS + ks * 16 + (lane >> 4) * 8]);
}

// c (16 x 64) += a (16 x 64, A fragments) * tile^T: the tile's rows are the
// product's columns, its 64 elements the depth
__device__ __forceinline__ void mma_abt(float (&c)[8][4], const uint32_t (&a)[4][4],
                                        const __nv_bfloat16* tile, int lane) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
    for (int t2 = 0; t2 < 4; ++t2) {
      uint32_t b[4];
      const int row = t2 * 16 + (lane & 7) + ((lane >> 4) << 3);
      ldmatrix_x4(b, &tile[row * LDS + ks * 16 + ((lane >> 3) & 1) * 8]);
      mma_bf16(c[2 * t2], a[ks], b[0], b[1]);
      mma_bf16(c[2 * t2 + 1], a[ks], b[2], b[3]);
    }
  }
}

// c (16 x 64) += x (16 x 64, an accumulator rounded to bf16 as A) * tile:
// the tile's rows are the product's depth
__device__ __forceinline__ void mma_ab(float (&c)[8][4], const float (&x)[8][4],
                                       const __nv_bfloat16* tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
#pragma unroll
    for (int d2 = 0; d2 < 4; ++d2) {
      uint32_t b[4];
      const int row = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      ldmatrix_x4_trans(b, &tile[row * LDS + d2 * 16 + (lane >> 4) * 8]);
      mma_bf16(c[2 * d2], a, b[0], b[1]);
      mma_bf16(c[2 * d2 + 1], a, b[2], b[3]);
    }
  }
}

// 64 rows from row0 of a (s, 64) bf16 view with row stride ss into a padded
// shared tile; rows past s are zero-filled
__device__ __forceinline__ void copy_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long ss, int row0, int s, int tid) {
  for (int c = tid; c < BT * 8; c += 128) {
    const int r = c >> 3, col = (c & 7) * 8, row = row0 + r;
    cp_async16(&dst[r * LDS + col], src + (size_t)min(row, s - 1) * ss + col, row < s ? 16 : 0);
  }
}

// write a warp's 16 x 64 accumulator rows (r_lo = row0 + g, r_hi = r_lo + 8)
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, long long ss, const float (&c)[8][4],
                                           int r_lo, int s, int tig) {
  const int r_hi = r_lo + 8;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int col = t * 8 + 2 * tig;
    if (r_lo < s)
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)r_lo * ss + col) =
          __floats2bfloat162_rn(c[t][0], c[t][1]);
    if (r_hi < s)
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)r_hi * ss + col) =
          __floats2bfloat162_rn(c[t][2], c[t][3]);
  }
}

// ------------------------------------------------------------- K4, bf16

__global__ void __launch_bounds__(128) flash_bwd_dkv_bf16(Params p) {
  __shared__ __align__(16) __nv_bfloat16 sQ[2][BT * LDS];
  __shared__ __align__(16) __nv_bfloat16 sO[2][BT * LDS];  // do tiles
  __shared__ float sM[2][BT], sL[2][BT], sD[2][BT];  // m * log2(e), 1 / l, di
  __shared__ int sId[2][BT];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int k0 = blockIdx.x * BT;
  const __nv_bfloat16* Qp = base<const __nv_bfloat16>(p, p.q, Q);
  const __nv_bfloat16* Kp = base<const __nv_bfloat16>(p, p.k, K);
  const __nv_bfloat16* Vp = base<const __nv_bfloat16>(p, p.v, V);
  const __nv_bfloat16* Op = base<const __nv_bfloat16>(p, p.dout, DO);
  const int b = blockIdx.y / p.nh;
  const int* ids = p.ids + (size_t)b * p.s;
  const size_t srow = (size_t)blockIdx.y * p.s;

  auto load_q = [&](int tile, int buf) {
    const int q0 = tile * BT;
    copy_tile(sQ[buf], Qp, p.st[Q][1], q0, p.s, tid);
    copy_tile(sO[buf], Op, p.st[DO][1], q0, p.s, tid);
    if (tid < BT) {
      const int row = q0 + tid;
      const bool live = row < p.s;
      // a query past s: id -1 matches no key, so its p is 0
      sM[buf][tid] = live ? p.m[srow + row] * LOG2E : 0.f;
      sL[buf][tid] = live ? 1.f / p.l[srow + row] : 0.f;
      sD[buf][tid] = live ? p.di[srow + row] : 0.f;
      sId[buf][tid] = live ? ids[row] : -1;
    }
  };

  // the block's keys and values, staged through buffer 1
  copy_tile(sQ[1], Kp, p.st[K][1], k0, p.s, tid);
  copy_tile(sO[1], Vp, p.st[V][1], k0, p.s, tid);
  load_q(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t kf[4][4], vf[4][4];
  load_a(kf, sQ[1], warp, lane);
  load_a(vf, sO[1], warp, lane);
  __syncthreads();  // buffer 1 is free for the next query tile

  const int kr_lo = k0 + warp * 16 + g, kr_hi = kr_lo + 8;
  const int kid_lo = kr_lo < p.s ? ids[kr_lo] : 0;
  const int kid_hi = kr_hi < p.s ? ids[kr_hi] : 0;
  const float scale = p.sm_scale * LOG2E;

  float dk[8][4], dv[8][4];
  zero(dk);
  zero(dv);
  const int nq = (p.s + BT - 1) / BT;
  for (int j = 0; j < nq; ++j) {
    const int buf = j & 1;
    if (j + 1 < nq) load_q(j + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest: tile j has landed
    __syncthreads();

    // p^T: 16 keys x 64 queries per warp (rows g, g + 8: e < 2, e >= 2)
    float pt[8][4];
    zero(pt);
    mma_abt(pt, kf, sQ[buf], lane);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = t * 8 + 2 * tig + (e & 1);
        const bool hit = sId[buf][qc] == (e < 2 ? kid_lo : kid_hi);
        const float x = hit ? pt[t][e] * scale : MASK_VALUE;
        pt[t][e] = exp2f(x - sM[buf][qc]) * sL[buf][qc];
      }
    }
    mma_ab(dv, pt, sO[buf], lane);  // dV += p^T do

    float ds[8][4];  // dp^T = v do^T, then ds^T
    zero(ds);
    mma_abt(ds, vf, sO[buf], lane);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = t * 8 + 2 * tig + (e & 1);
        ds[t][e] = (ds[t][e] - sD[buf][qc]) * pt[t][e] * p.sm_scale;
      }
    }
    mma_ab(dk, ds, sQ[buf], lane);  // dK += ds^T q
    __syncthreads();  // tile j read by every warp before its buffer is refilled
  }

  store_rows(base<__nv_bfloat16>(p, p.dk, DK), p.st[DK][1], dk, kr_lo, p.s, tig);
  store_rows(base<__nv_bfloat16>(p, p.dv, DV), p.st[DV][1], dv, kr_lo, p.s, tig);
}

// ------------------------------------------------------------- K5, bf16

__global__ void __launch_bounds__(128) flash_bwd_dq_bf16(Params p) {
  __shared__ __align__(16) __nv_bfloat16 sK[2][BT * LDS];
  __shared__ __align__(16) __nv_bfloat16 sV[2][BT * LDS];
  __shared__ int sId[2][BT];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * BT;
  const __nv_bfloat16* Qp = base<const __nv_bfloat16>(p, p.q, Q);
  const __nv_bfloat16* Kp = base<const __nv_bfloat16>(p, p.k, K);
  const __nv_bfloat16* Vp = base<const __nv_bfloat16>(p, p.v, V);
  const __nv_bfloat16* Op = base<const __nv_bfloat16>(p, p.dout, DO);
  const int b = blockIdx.y / p.nh;
  const int* ids = p.ids + (size_t)b * p.s;
  const size_t srow = (size_t)blockIdx.y * p.s;

  auto load_kv = [&](int tile, int buf) {
    const int k0 = tile * BT;
    copy_tile(sK[buf], Kp, p.st[K][1], k0, p.s, tid);
    copy_tile(sV[buf], Vp, p.st[V][1], k0, p.s, tid);
    // a key past s is a zero key: id -1 skips it (it would add ds * 0)
    if (tid < BT) sId[buf][tid] = k0 + tid < p.s ? ids[k0 + tid] : -1;
  };

  // the block's queries and output gradients, staged through buffer 1
  copy_tile(sK[1], Qp, p.st[Q][1], q0, p.s, tid);
  copy_tile(sV[1], Op, p.st[DO][1], q0, p.s, tid);
  load_kv(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[4][4], of[4][4];
  load_a(qf, sK[1], warp, lane);
  load_a(of, sV[1], warp, lane);
  __syncthreads();

  // this thread's two query rows: statistics and di, read once
  const int r_lo = q0 + warp * 16 + g, r_hi = r_lo + 8;
  const bool live_lo = r_lo < p.s, live_hi = r_hi < p.s;
  const int id_lo = live_lo ? ids[r_lo] : -2, id_hi = live_hi ? ids[r_hi] : -2;
  const float m_lo = live_lo ? p.m[srow + r_lo] * LOG2E : 0.f;
  const float m_hi = live_hi ? p.m[srow + r_hi] * LOG2E : 0.f;
  const float il_lo = live_lo ? 1.f / p.l[srow + r_lo] : 0.f;
  const float il_hi = live_hi ? 1.f / p.l[srow + r_hi] : 0.f;
  const float di_lo = live_lo ? p.di[srow + r_lo] : 0.f;
  const float di_hi = live_hi ? p.di[srow + r_hi] : 0.f;
  const float scale = p.sm_scale * LOG2E;

  float dq[8][4];
  zero(dq);
  const int nk = (p.s + BT - 1) / BT;
  for (int j = 0; j < nk; ++j) {
    const int buf = j & 1;
    if (j + 1 < nk) load_kv(j + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    float pr[8][4];  // p: 16 queries x 64 keys per warp
    zero(pr);
    mma_abt(pr, qf, sK[buf], lane);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kid = sId[buf][t * 8 + 2 * tig + (e & 1)];
        const bool lo = e < 2;
        const float x = kid == (lo ? id_lo : id_hi) ? pr[t][e] * scale : MASK_VALUE;
        pr[t][e] = exp2f(x - (lo ? m_lo : m_hi)) * (lo ? il_lo : il_hi);
      }
    }
    float ds[8][4];  // dp = do v^T, then ds
    zero(ds);
    mma_abt(ds, of, sV[buf], lane);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[t][e] = (ds[t][e] - (e < 2 ? di_lo : di_hi)) * pr[t][e] * p.sm_scale;
    }
    mma_ab(dq, ds, sK[buf], lane);  // dQ += ds k
    __syncthreads();
  }

  store_rows(base<__nv_bfloat16>(p, p.dq, DQ), p.st[DQ][1], dq, r_lo, p.s, tig);
}

// --------------------------------------------------------------- float32

constexpr int FT = 16;      // streamed rows per step of the scalar kernels
constexpr int FLD = D + 1;  // padded stride of the per-thread rows

// K4 in float32: thread t owns key k0 + t; query tiles of FT rows are
// streamed through shared memory
__global__ void __launch_bounds__(BT) flash_bwd_dkv_f32(Params p) {
  __shared__ float sK[BT * FLD], sV[BT * FLD];
  __shared__ float sQ[FT][D], sO[FT][D];
  __shared__ float sM[FT], sL[FT], sD[FT];
  __shared__ int sId[FT];

  const int tid = threadIdx.x;
  const int key = blockIdx.x * BT + tid;
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
    for (int i = tid; i < FT * D; i += BT) {
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

// K5 in float32: thread t owns query q0 + t; key tiles of FT rows are
// streamed through shared memory
__global__ void __launch_bounds__(BT) flash_bwd_dq_f32(Params p) {
  __shared__ float sQ[BT * FLD], sO[BT * FLD];
  __shared__ float sK[FT][D], sV[FT][D];
  __shared__ int sId[FT];

  const int tid = threadIdx.x;
  const int row = blockIdx.x * BT + tid;
  const float* Qp = base<const float>(p, p.q, Q);
  const float* Kp = base<const float>(p, p.k, K);
  const float* Vp = base<const float>(p, p.v, V);
  const float* Op = base<const float>(p, p.dout, DO);
  const int* ids = p.ids + (size_t)(blockIdx.y / p.nh) * p.s;
  const size_t srow = (size_t)blockIdx.y * p.s;
  const bool live = row < p.s;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    sQ[tid * FLD + d] = live ? Qp[(size_t)row * p.st[Q][1] + d] : 0.f;
    sO[tid * FLD + d] = live ? Op[(size_t)row * p.st[DO][1] + d] : 0.f;
  }
  const int qid = live ? ids[row] : -2;
  const float m = live ? p.m[srow + row] : 0.f;
  const float il = live ? 1.f / p.l[srow + row] : 0.f;
  const float di = live ? p.di[srow + row] : 0.f;
  float dq[D];
#pragma unroll
  for (int d = 0; d < D; ++d) dq[d] = 0.f;

  for (int k0 = 0; k0 < p.s; k0 += FT) {
    __syncthreads();
    for (int i = tid; i < FT * D; i += BT) {
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

Params make_params(const void* q, const void* k, const void* v, const void* dout, const int* ids,
                   const float* m, const float* l, const float* di, void* dq, void* dk, void* dv,
                   int s, int nh, const long long* strides, float sm_scale) {
  Params p{q, k, v, dout, ids, m, l, di, dq, dk, dv, s, nh, {}, sm_scale};
  for (int t = 0; t < 7; ++t)
    for (int i = 0; i < 3; ++i) p.st[t][i] = strides[3 * t + i];
  return p;
}

}  // namespace

// q, k, v, dout (the output gradient) and dq, dk, dv: (n, s, nh, 64) with
// the (batch, seq, head) strides in elements given in that order, 21 values
// (the last stride is 1; for bf16 every base pointer is 16-byte aligned and
// every stride a multiple of 8; the outputs a kernel does not write may be
// null); ids (n, s) int32 contiguous; m, l, di float32 (n, nh, s)
// contiguous. dtype: 0 = float32, 1 = bfloat16. Each returns the
// cudaError_t of its launch.
#define FLASH_BWD_ARGS                                                                           \
  const void *q, const void *k, const void *v, const void *dout, const int *ids, const float *m, \
      const float *l, const float *di, void *dq, void *dk, void *dv, int n, int s, int nh,       \
      const long long *strides, float sm_scale, int dtype, void *stream

// K4: dk and dv
extern "C" int flash_attention_backward_dkv(FLASH_BWD_ARGS) {
  if (n == 0 || s == 0 || nh == 0) return 0;
  const Params p = make_params(q, k, v, dout, ids, m, l, di, dq, dk, dv, s, nh, strides, sm_scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((s + BT - 1) / BT, n * nh);
  if (dtype == 1) {
    flash_bwd_dkv_bf16<<<grid, 128, 0, st>>>(p);
  } else if (dtype == 0) {
    flash_bwd_dkv_f32<<<grid, BT, 0, st>>>(p);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K5: dq
extern "C" int flash_attention_backward_dq(FLASH_BWD_ARGS) {
  if (n == 0 || s == 0 || nh == 0) return 0;
  const Params p = make_params(q, k, v, dout, ids, m, l, di, dq, dk, dv, s, nh, strides, sm_scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((s + BT - 1) / BT, n * nh);
  if (dtype == 1) {
    flash_bwd_dq_bf16<<<grid, 128, 0, st>>>(p);
  } else if (dtype == 0) {
    flash_bwd_dq_f32<<<grid, BT, 0, st>>>(p);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
