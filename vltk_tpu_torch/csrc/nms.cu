// Fixed-budget greedy NMS for Hopper (sm_90a), batched over rows.
//
// Replaces: vltk_tpu/ops/nms.py:nms_fixed (and nms_fixed_blocked, which has
// the same contract). In JAX these are XLA loops, not Pallas; the reference
// this repo replaced called torchvision's CUDA nms, which is absent here, so
// greedy NMS gets a hand kernel. Callers: the RPN (B rows, 6000 -> 300 at
// 0.7) and the detection selection (B*3 rows, 300 -> 36 at 0.5/1.0/0.1).
//
// Contract (per row): candidates are the boxes the wrapper marked live
// (valid and score > NEG_INF/2), sorted by the wrapper into descending
// score, equal scores lower index first -- the order argmax-greedy visits
// them. Box i is kept when no earlier kept box has IoU > t with it (strict);
// the first max_out keeps are written as original indices, -1 after.
//
// Bound on this card: latency. The work the data needs is one IoU per
// (kept box, later candidate) pair -- ~15 M IoUs for 8 x 6000 -> 300, a few
// microseconds of float32 arithmetic -- and ~1 MB of boxes; the sequential
// greedy dependence, not bytes or operations, sets the time.
//
// Design: (1) nms_mask_kernel: for every pair i < j of candidates, one bit
// (IoU > t) in an upper-triangle mask of 64-bit words, 64 x 64 tiles per
// block, the column boxes staged in shared memory. (2) nms_sweep_kernel:
// one block per row walks the candidates a word (64 boxes) at a time:
// thread 0 resolves the word's boxes in order against the removal bits
// (reading only the diagonal word of each kept box), then all threads OR
// the kept boxes' mask rows into the later removal words in parallel. It
// stops at max_out keeps or at the last candidate.
//
// Rounding: the IoU is (area_i + area_j - inter) and inter / union in
// float32 exactly as the reference writes it; the file is built with
// --fmad=false and uses the _rn intrinsics, so no multiply-add contraction
// moves a pair that sits on the threshold.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;

__device__ __forceinline__ float area(const float* b) {
  return __fmul_rn(fmaxf(__fsub_rn(b[2], b[0]), 0.f),
                   fmaxf(__fsub_rn(b[3], b[1]), 0.f));
}

// IoU of the earlier box a against the later box b, in the reference's
// operation order (_iou_one_vs_all: the selected box's area first).
__device__ __forceinline__ float iou(const float* a, const float* b) {
  const float w = fmaxf(__fsub_rn(fminf(a[2], b[2]), fmaxf(a[0], b[0])), 0.f);
  const float h = fmaxf(__fsub_rn(fminf(a[3], b[3]), fmaxf(a[1], b[1])), 0.f);
  const float inter = __fmul_rn(w, h);
  const float uni = __fsub_rn(__fadd_rn(area(a), area(b)), inter);
  return uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
}

// grid (col tiles, row tiles, rows); 64 threads, one per row box of the tile
__global__ void nms_mask_kernel(const float* __restrict__ sboxes,
                                const float* __restrict__ thresh,
                                const int* __restrict__ n_cand,
                                unsigned long long* __restrict__ mask, int K,
                                int nwords) {
  const int r = blockIdx.z;
  const int rt = blockIdx.y;
  const int ct = blockIdx.x;
  const int nc = n_cand[r];
  // lower-triangle tiles are never read; tiles past the candidates only
  // hold bits of boxes the sweep never visits
  if (ct < rt || rt * kTile >= nc || ct * kTile >= nc) return;

  __shared__ float cbox[kTile * 4];
  const int j0 = ct * kTile;
  const int ncols = min(kTile, nc - j0);
  const float* rb = sboxes + (size_t)r * K * 4;
  if (threadIdx.x < ncols) {
    for (int q = 0; q < 4; ++q)
      cbox[threadIdx.x * 4 + q] = rb[(size_t)(j0 + threadIdx.x) * 4 + q];
  }
  __syncthreads();

  const int i = rt * kTile + threadIdx.x;
  if (i >= nc) return;
  float a[4];
  for (int q = 0; q < 4; ++q) a[q] = rb[(size_t)i * 4 + q];
  const float t = thresh[r];
  unsigned long long bits = 0ULL;
  const int start = (ct == rt) ? threadIdx.x + 1 : 0;
  for (int q = start; q < ncols; ++q) {
    if (iou(a, &cbox[q * 4]) > t) bits |= 1ULL << q;
  }
  mask[((size_t)r * K + i) * nwords + ct] = bits;
}

// one block per row; dynamic shared memory holds the row's removal words
__global__ void nms_sweep_kernel(const unsigned long long* __restrict__ mask,
                                 const int64_t* __restrict__ order,
                                 const int* __restrict__ n_cand,
                                 int* __restrict__ keep, int K, int nwords,
                                 int max_out) {
  extern __shared__ unsigned long long remv[];
  __shared__ int kept[kTile];
  __shared__ int n_kept;
  __shared__ int count;

  const int r = blockIdx.x;
  const unsigned long long* m = mask + (size_t)r * K * nwords;
  int* out = keep + (size_t)r * max_out;
  const int nc = n_cand[r];
  const int nw = (nc + kTile - 1) / kTile;

  for (int w = threadIdx.x; w < nwords; w += blockDim.x) remv[w] = 0ULL;
  for (int k = threadIdx.x; k < max_out; k += blockDim.x) out[k] = -1;
  if (threadIdx.x == 0) count = 0;
  __syncthreads();

  for (int w = 0; w < nw; ++w) {
    const bool done = count >= max_out;
    __syncthreads();  // every thread has read count before thread 0 moves it
    if (done) break;  // uniform across the block
    if (threadIdx.x == 0) {
      unsigned long long cur = remv[w];
      int c = count;
      int nk = 0;
      for (int b = 0; b < kTile; ++b) {
        const int i = w * kTile + b;
        if (i >= nc || c >= max_out) break;
        if (!((cur >> b) & 1ULL)) {
          out[c++] = (int)order[(size_t)r * K + i];
          kept[nk++] = i;
          cur |= m[(size_t)i * nwords + w];
        }
      }
      remv[w] = cur;
      n_kept = nk;
      count = c;
    }
    __syncthreads();
    const int nk = n_kept;
    for (int w2 = w + 1 + threadIdx.x; w2 < nw; w2 += blockDim.x) {
      unsigned long long acc = remv[w2];
      for (int q = 0; q < nk; ++q) acc |= m[(size_t)kept[q] * nwords + w2];
      remv[w2] = acc;
    }
    __syncthreads();
  }
}

}  // namespace

// sboxes (R, K, 4) float32 in sorted order; order (R, K) int64 original
// index of each sorted position; n_cand (R,) int32; thresh (R,) float32;
// mask scratch (R, K, ceil(K/64)) uint64; keep (R, max_out) int32.
// Returns the cudaError_t of the launches.
extern "C" int nms_forward(const void* sboxes, const void* order,
                           const void* n_cand, const void* thresh, void* mask,
                           void* keep, int R, int K, int max_out,
                           void* stream) {
  if (R == 0 || max_out == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nwords = (K + kTile - 1) / kTile;
  if (K > 0) {
    dim3 grid(nwords, nwords, R);
    nms_mask_kernel<<<grid, kTile, 0, s>>>(
        static_cast<const float*>(sboxes), static_cast<const float*>(thresh),
        static_cast<const int*>(n_cand),
        static_cast<unsigned long long*>(mask), K, nwords);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  const size_t smem = (size_t)(nwords > 0 ? nwords : 1) * sizeof(unsigned long long);
  nms_sweep_kernel<<<R, 128, smem, s>>>(
      static_cast<const unsigned long long*>(mask),
      static_cast<const int64_t*>(order), static_cast<const int*>(n_cand),
      static_cast<int*>(keep), K, nwords, max_out);
  return (int)cudaGetLastError();
}
