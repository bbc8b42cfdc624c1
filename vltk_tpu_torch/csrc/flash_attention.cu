// Flash-attention forward with segment ids for Hopper (sm_90a): K3.
//
// Replaces: vltk_tpu/models/lxmert.py:_flash_self_attention, the call of the
// Pallas TPU kernel jax.experimental.pallas.ops.tpu.flash_attention (forward)
// that every self-attention of LayoutLM takes at padded length >= 1024.
//
// What it computes, per batch row b and head h: out = softmax(q k^T * sm_scale
// + where(ids_q != ids_k, MASK)) v, with q, k, v and out (n, s, nh, 64) read
// and written in that layout through strides (no transposes), ids (n, s)
// int32. As in the JAX function, the sequence counts as padded to
// s_pad = ceil(s / 128) * 128 with zero keys and values of id 0: keys in
// [s, s_pad) are zero-filled here instead of materialised. Scores, the
// running max and the running sum are float32; the probabilities are
// rounded to the input type before the product with v, which accumulates in
// float32 (the Pallas kernel's p.astype(v.dtype)); MASK is the Pallas
// kernel's finite -0.7 * FLT_MAX.
//
// Bound on this card: operations. At the serving shape (n = 32, s = 1024,
// nh = 12, dh = 64, bf16, every row real) the two products are
// 4 n nh s^2 dh = 1.03e11 FLOP, 0.104 ms at 989 TFLOP/s, against 201 MB of
// q, k, v and out, 0.060 ms at 3.35 TB/s. The 4.0e8 exponentials take about
// as long again on the SFUs (16 a clock an SM).
//
// Design (bf16; FlashAttention-2's algorithm in the Hopper form of
// FlashAttention-3). A block of WGS warpgroups owns 64 query rows per
// warpgroup of one (b, h); each thread keeps its two rows' output
// accumulator (32 floats), running max and sum in registers, so the (s, s)
// scores never leave the SM.
//   Copies: every tile is a TMA box of 64 rows of the strided view (its 4-D
// map (64, nh, s, n), 128-byte swizzle, zeros past s: the zero keys of the
// pad come free). The q tiles come in once; key tiles of KT = 64 or 128
// rows (k and v) stream through a ring of NS stages, each completed on an
// mbarrier. The stage of a tile is refilled, NS tiles on, by the last of
// the block's warps to finish with it (a count in shared memory), so no
// warpgroup waits for another but through the ring: the two warpgroups of
// a block drift apart, and one's exponentials overlap the other's
// products. The output goes back through shared memory (the q tiles'
// room) with a TMA store, which writes no row past s.
//   Products: S = q k^T is wgmma with A and B from shared memory (K-major);
// O += p v is wgmma with p, rounded to bf16, from registers as A (the
// accumulator's layout is the A layout) and v as B read transposed (tnspB).
//   Overlap inside a warpgroup: each step issues S of tile i and O += p v
// of tile i - 1 together and runs tile i's exponentials while the second
// product runs. exp is ex2.approx.ftz on scores pre-scaled by log2(e) (one
// FFMA and one MUFU op an element). A masked score is -inf here, which adds
// exactly what MASK adds: a real row always sees its own key, so its max
// is a real score, and exp(MASK - m) is 0 in float32; a row that has seen
// no key yet keeps m = -inf and a zero sum (the -inf - -inf case is taken
// out).
//   Tile skipping: the block keeps its batch row's ids over [0, s_pad) in
// shared memory (the tail has id 0), reduces them to a [min, max] interval
// per key tile and walks only the tiles whose interval meets one of its
// warpgroups' query intervals (rows below s); every warpgroup walks the
// block's list. A tile whose interval is one id that every row of a warp
// has skips the per-element compare (15% of the kernel's time at the
// serving shape on an H100). Skipping is exact: a skipped tile would add
// only zeros to every real row's sum and output.
//   Block shape (FWD_SHAPE below): two warpgroups of 64 queries, two
// blocks an SM, a 3-stage ring of 64-key tiles. On an H100 this beats one
// warpgroup at three or four blocks an SM, 128-key tiles and a block-wide
// barrier per tile (tools/sweep_flash_backward.py --forward builds and
// times others; PERF.md keeps the numbers). `-Xptxas -v` reports the
// registers; no spills.
//
// With m_out and l_out (non-null: the STATS instantiation) the kernel also
// writes the row statistics the backward kernels (csrc/flash_attention_bwd.cu)
// recompute p from, as the Pallas forward keeps them for its VJP: m, the
// row max of the masked, scaled scores, and l, the row sum of
// exp(scores - m); float32 (n, nh, s), natural-log units (the running max
// is kept in log2 units here and scaled by ln 2 on the way out). Rows past s
// are not written. Serving passes null and runs the instantiation without.
//
// float32 inputs take a scalar instantiation of the same algorithm (one
// thread per query row, FMAs on the CUDA cores): it exists so that the
// dtype=None configs and the float32 checks run through the kernel too.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_utils.cuh"

// Block shape of the bf16 kernel as four digits: warpgroups of 64 query
// rows per block, blocks an SM keeps (it caps the registers: 65536 / (128 x
// warpgroups x blocks)), stages of the key ring, and the key tile in units
// of 64 rows (1 or 2). The design note says why this one;
// tools/sweep_flash_backward.py --forward builds others with -DFWD_SHAPE.
#ifndef FWD_SHAPE
#define FWD_SHAPE 2231
#endif

namespace {

constexpr int D = 64;          // head size
constexpr int BQ = 64;         // query rows per block of the float32 kernel
constexpr int BK = 64;         // keys per tile of the float32 kernel
constexpr int BT = 64;         // rows of a TMA box, and of a warpgroup's queries
constexpr int TILE = BT * D;   // elements of a 64-row box
constexpr uint32_t TILE_BYTES = TILE * 2;
constexpr int PAD_BLOCK = 128; // the Pallas kernel's block: s counts as padded to it
constexpr float MASK_VALUE = -0.7f * FLT_MAX;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* ids;
  void* o;
  float* m_out;  // nullable: row statistics (n, nh, s)
  float* l_out;
  int s, s_pad, nh;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  float sm_scale;
};

// the TMA maps of the bf16 kernel
struct Maps {
  CUtensorMap q, k, v, o;
};

// ------------------------------------------------------------------ bf16

// shared memory of the bf16 kernel in bytes (the first 1024 are room to
// align the tiles): q (and the output), the k and v ring, barriers, the
// stages' release counts, the key ids of the batch row over [0, s_pad),
// the warpgroups' query intervals, the key tiles' intervals, the tile list
// and its count
__host__ __device__ constexpr size_t fwd_smem_bytes(int wgs, int ns, int kt, int s_pad) {
  return 1024 + (size_t)wgs * TILE_BYTES + (size_t)2 * ns * kt * D * 2 + (ns + 1) * 8 + (ns + 1) / 2 * 8 +
         (size_t)s_pad * 4 + wgs * 8 + (size_t)(s_pad / kt) * 12 + 4;
}

template <int WGS, int MIN_BLOCKS, int NS, int NB, bool STATS>
__global__ void __launch_bounds__(128 * WGS, MIN_BLOCKS)
    flash_fwd_bf16(const __grid_constant__ Maps maps, Params p) {
  constexpr int KT = NB * BT;  // keys of a tile
  static_assert(NS >= 2 && (NB == 1 || NB == 2), "block shape");
  extern __shared__ uint8_t smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(align1024(smem_raw));  // WGS boxes
  __nv_bfloat16* sK = sQ + WGS * TILE;                                         // NS x NB boxes
  __nv_bfloat16* sV = sK + NS * NB * TILE;
  uint64_t* full = reinterpret_cast<uint64_t*>(sV + NS * NB * TILE);  // NS
  uint64_t* qbar = full + NS;
  int* sRel = reinterpret_cast<int*>(qbar + 1);  // NS: warps done with each stage, ever
  const int s = p.s, s_pad = p.s_pad, nt = s_pad / KT;
  int* sKid = sRel + (NS + 1) / 2 * 2;                    // s_pad key ids (0 past s), 8-byte aligned
  int2* sOwn = reinterpret_cast<int2*>(sKid + s_pad);     // WGS query intervals
  int2* sIv = sOwn + WGS;                                 // nt key-tile intervals
  int* sList = reinterpret_cast<int*>(sIv + nt);
  int* sCount = sList + nt;

  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int b = blockIdx.y / p.nh, h = blockIdx.y % p.nh;
  const int q0 = blockIdx.x * WGS * BT;
  const int* ids = p.ids + (size_t)b * s;

  if (tid == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(&full[i], 1);
      sRel[i] = 0;
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  for (int r = tid; r < s_pad; r += 128 * WGS) sKid[r] = r < s ? ids[r] : 0;
  __syncthreads();
  if (tid == 0) {
    tma_prefetch_map(&maps.k);
    tma_prefetch_map(&maps.v);
    uint32_t bytes = 0;
    for (int w = 0; w < WGS; ++w) bytes += q0 + w * BT < s ? TILE_BYTES : 0u;
    mbar_expect_tx(qbar, bytes);
    for (int w = 0; w < WGS; ++w)
      if (q0 + w * BT < s) tma_load_4d(sQ + w * TILE, &maps.q, qbar, 0, h, q0 + w * BT, b);
  }
  // intervals, one warp each: key tiles over [0, s_pad) (the tail has id
  // 0), then each warpgroup's query rows below s
  for (int t = warp; t < nt + WGS; t += 4 * WGS) {
    const bool key = t < nt;
    const int row0 = key ? t * KT : q0 + (t - nt) * BT, rows = key ? KT : BT;
    const int end = key ? s_pad : s;
    int lo = INT_MAX, hi = INT_MIN;
    for (int r = lane; r < rows; r += 32) {
      const int row = row0 + r;
      if (row < end) {
        lo = min(lo, sKid[row]);
        hi = max(hi, sKid[row]);
      }
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      lo = min(lo, __shfl_xor_sync(~0u, lo, off));
      hi = max(hi, __shfl_xor_sync(~0u, hi, off));
    }
    if (lane == 0) (key ? sIv[t] : sOwn[t - nt]) = make_int2(lo, hi);
  }
  __syncthreads();
  if (warp == 0) {  // the key tiles that meet a warpgroup's queries, in order
    int c = 0;
    for (int b0 = 0; b0 < nt; b0 += 32) {
      const int t = b0 + lane;
      bool need = false;
#pragma unroll
      for (int w = 0; w < WGS; ++w) need = need || (t < nt && meets(sIv[t], sOwn[w]));
      const unsigned ballot = __ballot_sync(~0u, need);
      if (need) sList[c + __popc(ballot & ((1u << lane) - 1))] = t;
      c += __popc(ballot);
    }
    if (lane == 0) *sCount = c;
  }
  __syncthreads();
  const int cnt = *sCount;

  auto load_stage = [&](int i) {  // entry i of the list into stage i % NS
    const int st = i % NS, k0 = sList[i] * KT;
    mbar_expect_tx(&full[st], 2 * NB * TILE_BYTES);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      tma_load_4d(sK + (st * NB + nb) * TILE, &maps.k, &full[st], 0, h, k0 + nb * BT, b);
      tma_load_4d(sV + (st * NB + nb) * TILE, &maps.v, &full[st], 0, h, k0 + nb * BT, b);
    }
  };
  if (tid == 0)
    for (int i = 0; i < min(NS, cnt); ++i) load_stage(i);
  // the last of the block's warps done with entry i's stage (its products
  // have completed) refills it with entry i + NS: no warpgroup waits for
  // another but through the ring
  auto release = [&](int i) {
    if (lane == 0 && atomicAdd(&sRel[i % NS], 1) % (4 * WGS) == 4 * WGS - 1 && i + NS < cnt) load_stage(i + NS);
  };

  // this thread's two query rows of its warpgroup's 64 (a row past s is
  // never stored: it takes any key tile as all-matching)
  const int rl = wg * BT + (warp & 3) * 16 + g, rh = rl + 8;
  const bool live_lo = q0 + rl < s, live_hi = q0 + rh < s;
  const int id_lo = live_lo ? sKid[q0 + rl] : 0, id_hi = live_hi ? sKid[q0 + rh] : 0;
  const float scale = p.sm_scale * LOG2E;
  const uint64_t q_a = sw128_desc(sQ + wg * TILE);
  mbar_wait(qbar, 0);

  float o[32], sc[NB][32];
  uint32_t pa[NB * 4][4];
  zero(o);
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;

  // S = q k^T of entry i (its stage has landed)
  auto issue_s = [&](int i) {
    const int st = i % NS;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const uint64_t k_b = sw128_desc(sK + (st * NB + nb) * TILE);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss<0>(sc[nb], q_a + kk * DESC_K_STEP, k_b + kk * DESC_K_STEP, kk);
    }
    wgmma_commit();
  };
  // O += p v of entry i, p from pa
  auto issue_pv = [&](int i) {
    const int st = i % NS;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const uint64_t v_b = sw128_desc(sV + (st * NB + nb) * TILE);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<1>(o, pa[nb * 4 + kk], v_b + kk * DESC_MN_STEP, 1);
    }
    wgmma_commit();
  };
  // the masked online softmax of entry i's scores: sc becomes p (float32,
  // not yet rounded), the max and sum move on; a_lo / a_hi rescale o
  auto softmax = [&](int i, float& a_lo, float& a_hi) {
    const int2 iv = sIv[sList[i]];
    const bool all_hit = iv.x == iv.y && (!live_lo || id_lo == iv.x) && (!live_hi || id_hi == iv.x);
    if (!__all_sync(~0u, all_hit)) {
      const int* kid = sKid + sList[i] * KT;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int2 kk = *reinterpret_cast<const int2*>(kid + nb * BT + 8 * j + 2 * tig);
          float* x = sc[nb] + 4 * j;
          if (live_lo && kk.x != id_lo) x[0] = -INFINITY;
          if (live_lo && kk.y != id_lo) x[1] = -INFINITY;
          if (live_hi && kk.x != id_hi) x[2] = -INFINITY;
          if (live_hi && kk.y != id_hi) x[3] = -INFINITY;
        }
      }
    }
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx_lo = fmaxf(mx_lo, fmaxf(sc[nb][4 * j], sc[nb][4 * j + 1]));
        mx_hi = fmaxf(mx_hi, fmaxf(sc[nb][4 * j + 2], sc[nb][4 * j + 3]));
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(~0u, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(~0u, mx_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo * scale), mn_hi = fmaxf(m_hi, mx_hi * scale);
    // a row with no matching key so far subtracts 0: its p are exp2(-inf) = 0
    const float ms_lo = mn_lo == -INFINITY ? 0.f : mn_lo, ms_hi = mn_hi == -INFINITY ? 0.f : mn_hi;
    a_lo = exp2_ftz(m_lo - ms_lo);
    a_hi = exp2_ftz(m_hi - ms_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float* x = sc[nb] + 4 * j;
        x[0] = exp2_ftz(fmaf(x[0], scale, -ms_lo));
        x[1] = exp2_ftz(fmaf(x[1], scale, -ms_lo));
        x[2] = exp2_ftz(fmaf(x[2], scale, -ms_hi));
        x[3] = exp2_ftz(fmaf(x[3], scale, -ms_hi));
        sum_lo += x[0] + x[1];
        sum_hi += x[2] + x[3];
      }
    }
    l_lo = l_lo * a_lo + sum_lo;  // this thread's share; summed over the quad at the end
    l_hi = l_hi * a_hi + sum_hi;
  };
  auto pack_p = [&]() {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_a(pa[nb * 4 + kk], sc[nb], kk);
  };

  if (cnt > 0) {
    mbar_wait(&full[0], 0);
    wgmma_fence();
    issue_s(0);
    wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_acc(sc[nb]);
    float a_lo, a_hi;
    softmax(0, a_lo, a_hi);
    pack_p();
  }
  for (int i = 1; i < cnt; ++i) {
    mbar_wait(&full[i % NS], (i / NS) & 1);
    wgmma_fence();
    issue_s(i);
    issue_pv(i - 1);
    wgmma_wait<1>();  // S
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_acc(sc[nb]);
    float a_lo, a_hi;
    softmax(i, a_lo, a_hi);
    wgmma_wait<0>();  // O += p v of entry i - 1
    fence_acc(o);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[4 * j] *= a_lo;
      o[4 * j + 1] *= a_lo;
      o[4 * j + 2] *= a_hi;
      o[4 * j + 3] *= a_hi;
    }
    pack_p();
    release(i - 1);  // its k was read by S of entry i - 1, its v just now
  }
  if (cnt > 0) {
    wgmma_fence();
    issue_pv(cnt - 1);
    wgmma_wait<0>();
    fence_acc(o);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(~0u, l_lo, off);
    l_hi += __shfl_xor_sync(~0u, l_hi, off);
  }
  const float inv_lo = l_lo > 0.f ? 1.f / l_lo : 0.f;
  const float inv_hi = l_hi > 0.f ? 1.f / l_hi : 0.f;
  if (STATS && tig == 0) {
    const size_t row0 = (size_t)blockIdx.y * s + q0;
    if (live_lo) {
      p.m_out[row0 + rl] = m_lo * LN2;
      p.l_out[row0 + rl] = l_lo;
    }
    if (live_hi) {
      p.m_out[row0 + rh] = m_hi * LN2;
      p.l_out[row0 + rh] = l_hi;
    }
  }
  // the output through the warpgroup's q box (its products are done), in
  // the 128-byte swizzle the store's map reads
  uint8_t* orow = reinterpret_cast<uint8_t*>(sQ + wg * TILE);
  const int r_lo = rl - wg * BT, r_hi = r_lo + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<uint32_t*>(orow + r_lo * 128 + ((j ^ (r_lo & 7)) << 4) + tig * 4) =
        pack_bf16(o[4 * j] * inv_lo, o[4 * j + 1] * inv_lo);
    *reinterpret_cast<uint32_t*>(orow + r_hi * 128 + ((j ^ (r_hi & 7)) << 4) + tig * 4) =
        pack_bf16(o[4 * j + 2] * inv_hi, o[4 * j + 3] * inv_hi);
  }
  fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
    for (int w = 0; w < WGS; ++w)
      if (q0 + w * BT < s) tma_store_4d(&maps.o, sQ + w * TILE, 0, h, q0 + w * BT, b);
    tma_store_wait();
  }
}

// --------------------------------------------------------------- float32

constexpr int KC = 16;  // keys per online-softmax step of the scalar kernel

__global__ void __launch_bounds__(BQ) flash_fwd_f32(Params p) {
  __shared__ float sK[BK][D];
  __shared__ float sV[BK][D];
  __shared__ int sId[BK];

  const int tid = threadIdx.x;
  const int b = blockIdx.y / p.nh, h = blockIdx.y % p.nh;
  const int row = blockIdx.x * BQ + tid;
  const float* Q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* K = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* V = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  float* O = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
  const int* ids = p.ids + (size_t)b * p.s;

  const bool live = row < p.s;
  float q[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    q[d] = live ? Q[(size_t)row * p.q_ss + d] : 0.f;
    acc[d] = 0.f;
  }
  const int qid = live ? ids[row] : 0;
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < p.s_pad; k0 += BK) {
    __syncthreads();
    for (int i = tid; i < BK * D; i += BQ) {
      const int r = i / D, c = i % D, key = k0 + r;
      sK[r][c] = key < p.s ? K[(size_t)key * p.k_ss + c] : 0.f;
      sV[r][c] = key < p.s ? V[(size_t)key * p.v_ss + c] : 0.f;
    }
    if (tid < BK) sId[tid] = k0 + tid < p.s ? ids[k0 + tid] : 0;
    __syncthreads();
    for (int c0 = 0; c0 < BK; c0 += KC) {
      float sc[KC];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) dot = fmaf(q[d], sK[c0 + j][d], dot);
        sc[j] = dot * p.sm_scale + (sId[c0 + j] == qid ? 0.f : MASK_VALUE);
        mx = fmaxf(mx, sc[j]);
      }
      const float mn = fmaxf(m, mx);
      const float alpha = expf(m - mn);
      m = mn;
      l *= alpha;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const float pj = expf(sc[j] - mn);
        l += pj;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] = fmaf(pj, sV[c0 + j][d], acc[d]);
      }
    }
  }
  if (live) {
    if (p.m_out != nullptr) {
      p.m_out[(size_t)blockIdx.y * p.s + row] = m;
      p.l_out[(size_t)blockIdx.y * p.s + row] = l;
    }
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) O[(size_t)row * p.o_ss + d] = acc[d] * inv;
  }
}

// ------------------------------------------------------------------ host

constexpr size_t MAX_SMEM = 232448;  // what a block of this card can have

// the bf16 kernel at a block shape (see FWD_SHAPE), with or without the
// statistics
template <int SHAPE>
int launch_bf16(const Params& p, int n, cudaStream_t st) {
  constexpr int wgs = SHAPE / 1000, blocks = SHAPE / 100 % 10, stages = SHAPE / 10 % 10, nb = SHAPE % 10;
  const size_t smem = fwd_smem_bytes(wgs, stages, nb * BT, p.s_pad);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kernel = p.m_out != nullptr ? flash_fwd_bf16<wgs, blocks, stages, nb, true>
                                   : flash_fwd_bf16<wgs, blocks, stages, nb, false>;
  // a runtime call first, as make_map needs
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long qs[3] = {p.q_sb, p.q_ss, p.q_sh}, ks[3] = {p.k_sb, p.k_ss, p.k_sh};
  const long long vs[3] = {p.v_sb, p.v_ss, p.v_sh}, os[3] = {p.o_sb, p.o_ss, p.o_sh};
  Maps maps;
  if (!(make_map(&maps.q, p.q, n, p.s, p.nh, qs, BT) && make_map(&maps.k, p.k, n, p.s, p.nh, ks, BT) &&
        make_map(&maps.v, p.v, n, p.s, p.nh, vs, BT) && make_map(&maps.o, p.o, n, p.s, p.nh, os, BT)))
    return (int)cudaErrorInvalidValue;
  dim3 grid((p.s + wgs * BT - 1) / (wgs * BT), n * p.nh);
  kernel<<<grid, 128 * wgs, smem, st>>>(maps, p);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out: (n, s, nh, 64) with the given strides in elements (the last
// stride is 1); ids: (n, s) int32 contiguous; m_out, l_out: null, or float32
// (n, nh, s) contiguous for the row statistics. dtype: 0 = float32,
// 1 = bfloat16 (then every base pointer is 16-byte aligned and every stride a
// positive multiple of 8, as TMA needs). Returns the cudaError_t of the
// launch.
extern "C" int flash_attention_forward(const void* q, const void* k, const void* v,
                                       const int* ids, void* out, float* m_out,
                                       float* l_out, int n, int s, int nh,
                                       long long q_sb, long long q_ss, long long q_sh,
                                       long long k_sb, long long k_ss, long long k_sh,
                                       long long v_sb, long long v_ss, long long v_sh,
                                       long long o_sb, long long o_ss, long long o_sh,
                                       float sm_scale, int dtype, void* stream) {
  if (n == 0 || s == 0 || nh == 0) return 0;
  Params p{q, k, v, ids, out, m_out, l_out, s, (s + PAD_BLOCK - 1) / PAD_BLOCK * PAD_BLOCK, nh,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_bf16<FWD_SHAPE>(p, n, st);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  flash_fwd_f32<<<dim3((s + BQ - 1) / BQ, n * nh), BQ, 0, st>>>(p);
  return (int)cudaGetLastError();
}
