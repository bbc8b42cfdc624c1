// Fixed-budget greedy NMS for Hopper (sm_90a): one launch per call, one
// thread-block cluster per row.
//
// Replaces: vltk_tpu/ops/nms.py:nms_fixed (and nms_fixed_blocked, which has
// the same contract). In JAX these are XLA loops, not Pallas; the reference
// this repo replaced called torchvision's CUDA nms, which is absent here, so
// greedy NMS gets a hand kernel. Callers: the RPN (B rows, 6000 -> 300 at
// 0.7) and the detection selection (B*3 rows, 300 -> 36 at 0.5/1.0/0.1).
//
// Contract (per row): live scores are the valid ones, NEG_INF elsewhere;
// candidates are those above NEG_INF/2, visited in descending score order,
// equal scores lower index first -- the order argmax-greedy visits them.
// Box i is kept when no earlier kept box has IoU > t with it (strict); the
// first max_out keeps are written as original indices, -1 after. A NaN among
// the live scores makes the whole row -1: argmax takes the NaN first and it
// is no candidate, so the reference never moves past it.
//
// Bound on this card: latency. Greedy NMS needs each candidate it visits
// tested against the keeps before it -- ~45 K IoUs a row for 6000 -> 300,
// where the sweep stops near the 310th candidate -- and the boxes of those
// candidates with every score: ~0.3 MB for 8 rows, under a microsecond of
// either. The sequential greedy dependence, not bytes or operations, sets
// the time.
//
// Design. A row is a cluster of CL CTAs (CL from the wrapper). Each CTA sorts
// the whole row in shared memory on a key that orders scores descending,
// -0.0 equal to +0.0 and NaN first (the order of the reference's argmax and
// of a stable descending torch.sort) -- by counting ranks for a row of at
// most one key a thread, else with CUB's block radix sort, which caps a row
// at kMaxK = 6144 candidates (every configuration's pre_nms_topk is at most
// 6000; nms_forward refuses longer rows) -- so every CTA knows the order
// and the live count, and nothing runs before the launch. The greedy chain then walks the sorted row one
// word of 64 candidates at a time, in every CTA alike:
//   1. pull: test the word's candidates against the keeps so far, up to the
//      first hit -- each CTA against its share of the keeps (keep n lives in
//      CTA n % CL), 8 groups of 64 threads each taking every 8th keep -- and
//      OR the hits into a 64-bit removal word;
//   2. gather the CL partial removal words (distributed shared memory, one
//      cluster barrier a word; the partials are double-buffered by word);
//   3. compute, for each live candidate of the word, the live candidates
//      before it in the word whose IoU with it exceeds t (a 64-bit column);
//   4. resolve the word in one warp on those bits: the greedy keep-set is
//      the fixed point of K = {live j : no i in K removes j}, reached by
//      iterating from K = the live set (two ballots a round; bit j is final
//      after j + 1 rounds, and the rounds stop when K stops changing), cut to
//      the budget's first max_out keeps; every CTA reaches the same keeps, so
//      nothing is broadcast; CTA 0 writes them.
// The next word's boxes are loaded from global memory while the word is
// resolved. It stops at max_out keeps or after the word holding the last
// candidate, at the same word in every CTA; a final cluster barrier keeps
// every CTA's shared memory alive until no CTA reads it. IoUs are evaluated
// only within visited words and between a visited candidate and the keeps
// before it, a subset of (keeps x later candidates): never the K x K mask,
// never a candidate after the sweep's end, and no global scratch. (Pushing
// each word's keeps onto every later candidate instead does ~27x the IoUs
// on the RPN's rows.)
//
// Rounding: the IoU is (area_i + area_j - inter) and inter / union in float32
// exactly as the reference writes it; the file is built with --fmad=false and
// uses the _rn intrinsics, so no multiply-add contraction moves a pair that
// sits on the threshold. min and max propagate NaN (PTX min.NaN / max.NaN),
// as jnp.minimum / jnp.maximum and torch.minimum / torch.maximum do, so a box
// with a NaN coordinate has union NaN and IoU 0 with every box. A pair whose
// intersection is 0 has IoU exactly 0, which exceeds t only when t < 0: the
// division is skipped for such pairs only where t >= 0.

#include <cooperative_groups.h>
#include <cub/block/block_radix_sort.cuh>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWord = 64;
constexpr int kThreads = 512;
constexpr int kGroups = kThreads / 64;  // groups of 64 threads in the pull
constexpr int kMaxCluster = 8;  // the portable maximum
constexpr float kLiveAbove = -1e10f / 2;  // NEG_INF / 2

typedef unsigned long long u64;

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float area(const float4 b) {
  return __fmul_rn(max_nan(__fsub_rn(b.z, b.x), 0.f), max_nan(__fsub_rn(b.w, b.y), 0.f));
}

// IoU(a, b) > t for the earlier box a and the later box b, in the
// reference's operation order (_iou_one_vs_all: the selected box's area
// first)
__device__ __forceinline__ bool suppresses(const float4 a, const float4 b, float t) {
  const float w = max_nan(__fsub_rn(min_nan(a.z, b.z), max_nan(a.x, b.x)), 0.f);
  const float h = max_nan(__fsub_rn(min_nan(a.w, b.w), max_nan(a.y, b.y)), 0.f);
  const float inter = __fmul_rn(w, h);
  if (inter == 0.f && t >= 0.f) return false;  // IoU exactly 0
  const float uni = __fsub_rn(__fadd_rn(area(a), area(b)), inter);
  return (uni > 0.f ? __fdiv_rn(inter, uni) : 0.f) > t;
}

// the sort key of a live score: ascending keys are descending scores,
// -0.0 is +0.0, and NaN comes first
__device__ __forceinline__ uint32_t sort_key(float f) {
  if (f != f) return 0u;
  const uint32_t u = f == 0.f ? 0u : __float_as_uint(f);
  return (u & 0x80000000u) ? u : ~(u | 0x80000000u);
}

// rows of more than one key a thread sort with CUB's block radix sort, 12
// keys a thread in registers, which caps a row at kMaxK candidates
constexpr int kCubItems = 12;
constexpr int kMaxK = kThreads * kCubItems;
typedef cub::BlockRadixSort<uint32_t, kThreads, kCubItems, uint16_t> CubSort;

// dynamic shared memory of a CTA for K candidates and room for `kcap`
// keeps: the keeps' boxes, the sort's keys, then its indices (16-bit), each
// twice (the counting ranks write the second buffers)
__host__ __device__ constexpr size_t rounded(int K) { return (size_t)((K + 3) & ~3); }
__host__ __device__ constexpr size_t smem_bytes(int K, int kcap) {
  return (size_t)kcap * sizeof(float4) + 2 * rounded(K) * sizeof(uint32_t) +
         2 * rounded(K) * sizeof(uint16_t);
}
// the longest row with every candidate kept, beside the static arrays (CUB's
// and ~2.6 KB of the kernel's), fits the 227 KB a CTA may take
static_assert(smem_bytes(kMaxK, kMaxK) + sizeof(CubSort::TempStorage) + 4096 <= 227 * 1024,
              "a row of kMaxK candidates must fit one CTA");

// Stable sort of keys[0, K) ascending with their indices, K <= kMaxK, in the
// block's shared memory. A row of at most one key a thread takes each key's
// rank by counting (into the second buffers, which it then swaps in); a
// longer one, CUB's block radix sort.
__device__ void sort_row(uint32_t*& keys, uint32_t*& keys2, uint16_t*& idx, uint16_t*& idx2, int K) {
  const int tid = threadIdx.x;
  if (K <= kThreads) {
    // a row of at most one key a thread: each key's rank is the number of
    // keys before it in the stable order, in one pass over the row
    if (tid < K) {
      const uint32_t k = keys[tid];
      int rank = 0;
#pragma unroll 8
      for (int j = 0; j < K; ++j) {
        const uint32_t o = keys[j];
        rank += o < k || (o == k && j < tid);
      }
      keys2[rank] = k;
      idx2[rank] = idx[tid];
    }
    __syncthreads();
    uint32_t* tk = keys; keys = keys2; keys2 = tk;
    uint16_t* ti = idx; idx = idx2; idx2 = ti;
    return;
  }
  // blocked arrangement: thread t holds keys [12t, 12t + 12), so CUB's
  // stable sort keeps equal keys in index order; the padding sorts last
  __shared__ typename CubSort::TempStorage temp;
  uint32_t k[kCubItems];
  uint16_t v[kCubItems];
#pragma unroll
  for (int u = 0; u < kCubItems; ++u) {
    const int i = tid * kCubItems + u;
    k[u] = i < K ? keys[i] : 0xffffffffu;
    v[u] = i < K ? idx[i] : (uint16_t)0;
  }
  __syncthreads();
  CubSort(temp).Sort(k, v);
#pragma unroll
  for (int u = 0; u < kCubItems; ++u) {
    const int i = tid * kCubItems + u;
    if (i < K) {
      keys[i] = k[u];
      idx[i] = v[u];
    }
  }
  __syncthreads();
}

__device__ __forceinline__ float4 load_box(const float* rb, int o) {
  return make_float4(rb[4 * o], rb[4 * o + 1], rb[4 * o + 2], rb[4 * o + 3]);
}

// grid R * CL CTAs in clusters of CL, one cluster per row; room for `kcap`
// keeps a CTA
__global__ void __launch_bounds__(kThreads)
nms_cluster_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
                   const uint8_t* __restrict__ valid, const float* __restrict__ thresh,
                   float thresh_value, int* __restrict__ keep, bool* __restrict__ kept_mask, int K,
                   int max_out, int kcap) {
  extern __shared__ float4 kbox[];  // this CTA's share of the keeps
  uint32_t* keys = reinterpret_cast<uint32_t*>(kbox + kcap);
  uint32_t* keys2 = keys + rounded(K);
  uint16_t* idx = reinterpret_cast<uint16_t*>(keys2 + rounded(K));
  uint16_t* idx2 = idx + rounded(K);
  __shared__ float4 wbox[2][kWord];  // the word being resolved, the next one
  __shared__ uint32_t wcol_lo[kWord], wcol_hi[kWord];  // its IoU bits, by column
  __shared__ uint32_t s_pull[2][2];  // this CTA's removal bits of a word, by half
  __shared__ u64 s_kept;
  __shared__ int s_count;

  cg::cluster_group cluster = cg::this_cluster();
  const int cl = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int r = blockIdx.x / cl;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float t = thresh != nullptr ? thresh[r] : thresh_value;
  const float* rs = scores + (size_t)r * K;
  const uint8_t* rv = valid != nullptr ? valid + (size_t)r * K : nullptr;
  const float* rb = boxes + (size_t)r * K * 4;

  // the row's keys; a NaN among the live scores empties the row
  bool nan = false;
  for (int i0 = tid; i0 < K; i0 += 4 * kThreads) {
    float f[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {  // every load of the group first
      const int i = i0 + u * kThreads;
      const float x = i < K ? rs[i] : 0.f;
      f[u] = i < K && rv != nullptr && !rv[i] ? -1e10f : x;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * kThreads;
      if (i < K) {
        nan |= f[u] != f[u];
        keys[i] = sort_key(f[u]);
        idx[i] = (uint16_t)i;
      }
    }
  }
  const bool nan_row = __syncthreads_or(nan);
  if (!nan_row) sort_row(keys, keys2, idx, idx2, K);
  // candidates are a prefix of the sorted row: its length by binary search,
  // the same in every thread
  const uint32_t live_below = sort_key(kLiveAbove);
  int n_cand = 0;
  if (!nan_row) {
    int hi = K;
    while (n_cand < hi) {
      const int mid = (n_cand + hi) >> 1;
      if (keys[mid] < live_below) n_cand = mid + 1; else hi = mid;
    }
  }
  const int nw = (n_cand + kWord - 1) / kWord;
  if (tid < kWord && tid < n_cand) wbox[0][tid] = load_box(rb, idx[tid]);
  if (tid < 4) s_pull[tid >> 1][tid & 1] = 0u;
  if (tid < kWord) wcol_lo[tid] = wcol_hi[tid] = 0u;
  cluster.sync();

  const int j = tid & (kWord - 1), g = tid / kWord;
  int count = 0;
  for (int w = 0; w < nw; ++w) {
    const int buf = w & 1;
    const float4* cur = wbox[buf];
    // the next word's boxes, loaded while this one is resolved
    const int qn = (w + 1) * kWord + tid - kWord;
    const bool fetch = tid >= kWord && tid < 2 * kWord && qn < n_cand;
    float4 next = make_float4(0.f, 0.f, 0.f, 0.f);
    if (fetch) next = load_box(rb, idx[qn]);
    // 1. pull: the word's live candidates against this CTA's keeps so far
    const int q = w * kWord + j;
    const int mine = count > rank ? (count - rank - 1) / cl + 1 : 0;
    bool hit = false;
    if (q < n_cand) {
      const float4 b = cur[j];
      for (int k = g; k < mine && !hit; k += kGroups) hit = suppresses(kbox[k], b, t);
    }
    const uint32_t bits = __ballot_sync(0xffffffffu, hit);
    if (lane == 0 && bits) atomicOr(&s_pull[buf][warp & 1], bits);
    // 2. every CTA's hits on the word, and what is no candidate
    if (cl > 1) cluster.sync(); else __syncthreads();
    const int left = n_cand - w * kWord;
    u64 wrem = left >= kWord ? 0ULL : ~0ULL << left;
    for (int c = 0; c < cl; ++c) {
      const uint32_t* part = cluster.map_shared_rank(s_pull[buf], c);
      wrem |= (u64)part[0] | ((u64)part[1] << 32);
    }
    // the other buffer's last readers (the word before) are past the barrier
    if (tid < 2) s_pull[buf ^ 1][tid] = 0u;
    // 3. column bits: for each live candidate j of the word, the live
    // candidates i < j of the word whose IoU with it exceeds t; 8 groups of
    // 64 threads take every 8th i
    {
      u64 col = 0ULL;
      if (!((wrem >> j) & 1ULL)) {
        const float4 b = cur[j];
        for (int i = g; i < j; i += kGroups)
          if (!((wrem >> i) & 1ULL) && suppresses(cur[i], b, t)) col |= 1ULL << i;
      }
      if (col) {
        atomicOr(&wcol_lo[j], (uint32_t)col);
        atomicOr(&wcol_hi[j], (uint32_t)(col >> 32));
      }
    }
    __syncthreads();
    // 4. greedy order within the word, one warp: the keep-set K is the fixed
    // point of K = {j live : no i in K removes j}, reached by iterating from
    // K = the live set (bit j is final after j + 1 rounds); the budget keeps
    // its first max_out - count bits
    if (warp == 0) {
      const u64 c0 = (u64)wcol_lo[lane] | ((u64)wcol_hi[lane] << 32);
      const u64 c1 = (u64)wcol_lo[lane + 32] | ((u64)wcol_hi[lane + 32] << 32);
      const bool a0 = !((wrem >> lane) & 1ULL), a1 = !((wrem >> (lane + 32)) & 1ULL);
      u64 kept = ~wrem;
      while (true) {
        const u64 nk = (u64)__ballot_sync(0xffffffffu, a0 && !(c0 & kept)) |
                       ((u64)__ballot_sync(0xffffffffu, a1 && !(c1 & kept)) << 32);
        if (nk == kept) break;
        kept = nk;
      }
      const int room = max_out - count;
      while (__popcll(kept) > room) kept &= ~(1ULL << (63 - __clzll((long long)kept)));
      wcol_lo[lane] = wcol_hi[lane] = wcol_lo[lane + 32] = wcol_hi[lane + 32] = 0u;
      if (lane == 0) {
        s_kept = kept;
        s_count = count + __popcll(kept);
      }
    }
    __syncthreads();
    const u64 kept = s_kept;
    if (tid < kWord && ((kept >> tid) & 1ULL)) {
      const int n = count + __popcll(kept & ((1ULL << tid) - 1ULL));
      if (n % cl == rank) kbox[n / cl] = cur[tid];
      if (rank == 0) {
        keep[(size_t)r * max_out + n] = idx[w * kWord + tid];
        kept_mask[(size_t)r * max_out + n] = true;
      }
    }
    if (fetch) wbox[buf ^ 1][tid - kWord] = next;
    count = s_count;
    if (count >= max_out) break;  // the same word in every CTA
    __syncthreads();
  }
  if (rank == 0) {
    for (int k = count + tid; k < max_out; k += kThreads) {
      keep[(size_t)r * max_out + k] = -1;
      kept_mask[(size_t)r * max_out + k] = false;
    }
  }
  cluster.sync();  // no CTA leaves while another may read its partials
}

// room for keeps a CTA: its share of the most a row can keep
int keep_room(int K, int max_out, int cluster) {
  const int most = min(max_out, K);
  return max((most + cluster - 1) / cluster, 1);
}

}  // namespace

// Dynamic shared memory a CTA takes for K candidates a row and a budget of
// max_out keeps over `cluster` CTAs (reported by the wrapper's plan).
extern "C" long long nms_smem_bytes(int K, int max_out, int cluster) {
  return (long long)smem_bytes(K, keep_room(K, max_out, cluster));
}

// boxes (R, K, 4) float32; scores (R, K) float32; valid (R, K) bool, or null
// for all valid; thresh (R,) float32, or null for thresh_value on every row;
// keep (R, max_out) int32 and its validity (R, max_out) bool. K <= kMaxK
// (6144) and cluster <= 8, else cudaErrorInvalidValue. One launch of
// R * cluster CTAs. Returns the cudaError_t of the launch.
extern "C" int nms_forward(const void* boxes, const void* scores, const void* valid,
                           const void* thresh, float thresh_value, void* keep, void* kept_mask,
                           int R, int K, int max_out, int cluster, void* stream) {
  if (R == 0 || max_out == 0) return 0;
  if (cluster < 1 || cluster > kMaxCluster || K < 0 || K > kMaxK || max_out < 0)
    return (int)cudaErrorInvalidValue;
  const int kcap = keep_room(K, max_out, cluster);
  const size_t smem = smem_bytes(K, kcap);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(R * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, nms_cluster_kernel, static_cast<const float*>(boxes),
                           static_cast<const float*>(scores), static_cast<const uint8_t*>(valid),
                           static_cast<const float*>(thresh), thresh_value, static_cast<int*>(keep),
                           static_cast<bool*>(kept_mask), K, max_out, kcap);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
