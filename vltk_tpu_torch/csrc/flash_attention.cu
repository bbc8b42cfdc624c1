// Flash-attention forward with segment ids for Hopper (sm_90a).
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
// nh = 12, dh = 64, bf16) the two products are 4 n nh s^2 dh = 1.03e11 FLOP,
// 0.104 ms at 989 TFLOP/s, against 201 MB of q, k, v and out, 0.060 ms at
// 3.35 TB/s. The 4.0e8 exponentials take about as long again on the SFUs.
//
// Design (FlashAttention-2): one block of 4 warps per (64-query tile, batch
// row x head); each warp owns 16 query rows and keeps its q fragments, its
// 16 x 64 output accumulator and its row max and sum in registers, so the
// (s, s) score matrix never leaves the SM. Key/value tiles of 64 rows are
// double-buffered in shared memory with cp.async (16-byte copies, zero fill
// past s), rows padded to 144 bytes so ldmatrix is free of bank conflicts.
// Both products run on the tensor cores as warp-level
// mma.sync.m16n8k16 bf16 -> f32; the score accumulator is re-packed in
// registers as the A operand of the second product. exp is exp2 on scores
// pre-scaled by log2(e). This is the simple form: wgmma and TMA, which the
// card needs for its full tensor rate, are a later step.
//
// With m_out and l_out (nullable) the kernel also writes the row statistics
// the backward kernels (csrc/flash_attention_bwd.cu) recompute p from, as the
// Pallas forward keeps them for its VJP: m, the row max of the masked,
// scaled scores, and l, the row sum of exp(scores - m); float32 (n, nh, s),
// natural-log units (the running max is kept in log2 units here and scaled
// by ln 2 on the way out). Rows past s are not written. Serving passes null
// and pays nothing for it.
//
// float32 inputs take a scalar instantiation of the same algorithm (one
// thread per query row, FMAs on the CUDA cores): it exists so that the
// dtype=None configs and the float32 checks run through the kernel too.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "mma_utils.cuh"

namespace {

constexpr int D = 64;          // head size
constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per tile
constexpr int LDS = D + 8;     // shared row stride (elements): 144 bytes
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

// ------------------------------------------------------------------ bf16

__global__ void __launch_bounds__(128) flash_fwd_bf16(Params p) {
  __shared__ __align__(16) __nv_bfloat16 sQ[BQ * LDS];
  __shared__ __align__(16) __nv_bfloat16 sK[2][BK * LDS];
  __shared__ __align__(16) __nv_bfloat16 sV[2][BK * LDS];
  __shared__ int sId[2][BK];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int b = blockIdx.y / p.nh, h = blockIdx.y % p.nh;
  const int q0 = blockIdx.x * BQ;
  const __nv_bfloat16* Q = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* K = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* V = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  __nv_bfloat16* O = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
  const int* ids = p.ids + (size_t)b * p.s;

  // q tile: 64 rows x 8 chunks of 16 bytes, rows past s zero-filled
  for (int c = tid; c < BQ * 8; c += 128) {
    const int r = c >> 3, col = (c & 7) * 8, row = q0 + r;
    cp_async16(&sQ[r * LDS + col], Q + (size_t)min(row, p.s - 1) * p.q_ss + col,
               row < p.s ? 16 : 0);
  }
  auto load_kv = [&](int tile, int buf) {
    const int k0 = tile * BK;
    for (int c = tid; c < BK * 8; c += 128) {
      const int r = c >> 3, col = (c & 7) * 8, row = k0 + r;
      const int bytes = row < p.s ? 16 : 0;
      const size_t rr = (size_t)min(row, p.s - 1);
      cp_async16(&sK[buf][r * LDS + col], K + rr * p.k_ss + col, bytes);
      cp_async16(&sV[buf][r * LDS + col], V + rr * p.v_ss + col, bytes);
    }
    if (tid < BK) sId[buf][tid] = k0 + tid < p.s ? ids[k0 + tid] : 0;
  };
  load_kv(0, 0);
  cp_async_commit();

  const int r_lo = q0 + warp * 16 + g, r_hi = r_lo + 8;
  const int id_lo = r_lo < p.s ? ids[r_lo] : 0;
  const int id_hi = r_hi < p.s ? ids[r_hi] : 0;
  const float scale = p.sm_scale * LOG2E;

  uint32_t qf[4][4];
  float acc[8][4];
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;

  const int ntiles = p.s_pad / BK;
  for (int j = 0; j < ntiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < ntiles) load_kv(j + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest: q and tile j have landed
    __syncthreads();

    if (j == 0) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        ldmatrix_x4(qf[ks], &sQ[(warp * 16 + (lane & 15)) * LDS + ks * 16 + (lane >> 4) * 8]);
    }

    // scores: 16 query rows x 64 keys per warp, 8 n-tiles of 8 keys
    float sc[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[t][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int t2 = 0; t2 < 4; ++t2) {
        uint32_t kb[4];
        const int key = t2 * 16 + (lane & 7) + ((lane >> 4) << 3);
        ldmatrix_x4(kb, &sK[buf][key * LDS + ks * 16 + ((lane >> 3) & 1) * 8]);
        mma_bf16(sc[2 * t2], qf[ks], kb[0], kb[1]);
        mma_bf16(sc[2 * t2 + 1], qf[ks], kb[2], kb[3]);
      }
    }

    // segment mask, online softmax (rows r_lo: e = 0, 1; r_hi: e = 2, 3)
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kid = sId[buf][t * 8 + 2 * tig + (e & 1)];
        const bool hit = kid == (e < 2 ? id_lo : id_hi);
        const float x = hit ? sc[t][e] * scale : MASK_VALUE;
        sc[t][e] = x;
        if (e < 2) mx_lo = fmaxf(mx_lo, x);
        else mx_hi = fmaxf(mx_hi, x);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float a_lo = exp2f(m_lo - mn_lo), a_hi = exp2f(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      sc[t][0] = exp2f(sc[t][0] - mn_lo);
      sc[t][1] = exp2f(sc[t][1] - mn_lo);
      sc[t][2] = exp2f(sc[t][2] - mn_hi);
      sc[t][3] = exp2f(sc[t][3] - mn_hi);
      sum_lo += sc[t][0] + sc[t][1];
      sum_hi += sc[t][2] + sc[t][3];
      acc[t][0] *= a_lo;
      acc[t][1] *= a_lo;
      acc[t][2] *= a_hi;
      acc[t][3] *= a_hi;
    }
    l_lo = l_lo * a_lo + sum_lo;  // this thread's share; summed over the quad at the end
    l_hi = l_hi * a_hi + sum_hi;

    // out += p v: p re-packed from the score accumulator as the A operand
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      pa[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      pa[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      pa[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
      for (int d2 = 0; d2 < 4; ++d2) {
        uint32_t vb[4];
        const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(vb, &sV[buf][key * LDS + d2 * 16 + (lane >> 4) * 8]);
        mma_bf16(acc[2 * d2], pa, vb[0], vb[1]);
        mma_bf16(acc[2 * d2 + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // tile j read by every warp before its buffer is refilled
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float inv_lo = l_lo > 0.f ? 1.f / l_lo : 0.f;
  const float inv_hi = l_hi > 0.f ? 1.f / l_hi : 0.f;
  if (p.m_out != nullptr && tig == 0) {
    const size_t row0 = (size_t)blockIdx.y * p.s;
    if (r_lo < p.s) {
      p.m_out[row0 + r_lo] = m_lo * LN2;
      p.l_out[row0 + r_lo] = l_lo;
    }
    if (r_hi < p.s) {
      p.m_out[row0 + r_hi] = m_hi * LN2;
      p.l_out[row0 + r_hi] = l_hi;
    }
  }
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int col = t * 8 + 2 * tig;
    if (r_lo < p.s)
      *reinterpret_cast<__nv_bfloat162*>(O + (size_t)r_lo * p.o_ss + col) =
          __floats2bfloat162_rn(acc[t][0] * inv_lo, acc[t][1] * inv_lo);
    if (r_hi < p.s)
      *reinterpret_cast<__nv_bfloat162*>(O + (size_t)r_hi * p.o_ss + col) =
          __floats2bfloat162_rn(acc[t][2] * inv_hi, acc[t][3] * inv_hi);
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

}  // namespace

// q, k, v, out: (n, s, nh, 64) with the given strides in elements (the last
// stride is 1); ids: (n, s) int32 contiguous; m_out, l_out: null, or float32
// (n, nh, s) contiguous for the row statistics. dtype: 0 = float32,
// 1 = bfloat16 (then every base pointer is 16-byte aligned and every stride a
// multiple of 8). Returns the cudaError_t of the launch.
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
  dim3 grid((s + BQ - 1) / BQ, n * nh);
  if (dtype == 1) {
    flash_fwd_bf16<<<grid, 128, 0, st>>>(p);
  } else if (dtype == 0) {
    flash_fwd_f32<<<grid, BQ, 0, st>>>(p);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
