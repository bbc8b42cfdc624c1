// RoIPool forward for Hopper (sm_90a), exact torchvision semantics.
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
// Bound on this card: memory. At the extraction shape (B=8, P=300, S=14,
// C=1024, bf16) the kernel writes 963 MB and reads a 71.6 MB feature map,
// ~0.31 ms at 3.35 TB/s; the max comparisons (~10 G) are a fraction of that
// at the non-tensor rate.
//
// Design: the TPU kernel's per-image row-range-max table in VMEM and its
// 8-aligned sublane slices answer the TPU's memory layout and are not
// carried over. Here one block handles one (image, RoI, channel chunk);
// threads run across C, which is contiguous in NHWC, so every cell load and
// every output store of a warp is one coalesced run. Each thread computes
// the bin edges with the same integer formulas and loops over the cells of
// each bin (at most 5 x 8 at the extraction canvas); the feature map of an
// image (8.9 MB bf16) stays in the 50 MB L2 across its RoIs. max over bf16
// values is exact in float, so the kernel agrees bitwise with the plain
// version.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ int round_half_away(float box, float scale) {
  float s = __fmul_rn(box, scale);
  return (int)(s >= 0.f ? floorf(__fadd_rn(s, 0.5f)) : ceilf(__fsub_rn(s, 0.5f)));
}

__device__ __forceinline__ int clampl(long long v, int lo, int hi) {
  return (int)(v < lo ? lo : (v > hi ? hi : v));
}

template <typename T>
__global__ void roi_pool_kernel(const T* __restrict__ feat,
                                const float* __restrict__ boxes,
                                T* __restrict__ out, int H, int W, int C, int P,
                                int S, float spatial_scale) {
  const int p = blockIdx.x;
  const int b = blockIdx.y;
  const int c = blockIdx.z * blockDim.x + threadIdx.x;
  if (c >= C) return;

  const float* box = boxes + ((size_t)b * P + p) * 4;
  const int x1 = round_half_away(box[0], spatial_scale);
  const int y1 = round_half_away(box[1], spatial_scale);
  const int x2 = round_half_away(box[2], spatial_scale);
  const int y2 = round_half_away(box[3], spatial_scale);
  // 64-bit bin arithmetic: a box far off the map must not overflow
  const long long roi_w = max(x2 - x1 + 1, 1);
  const long long roi_h = max(y2 - y1 + 1, 1);

  const T* f = feat + (size_t)b * H * W * C + c;
  T* o = out + ((size_t)b * P + p) * S * S * C + c;

  for (int i = 0; i < S; ++i) {
    const int hs = clampl(i * roi_h / S + y1, 0, H);
    const int he = clampl(((i + 1) * roi_h + S - 1) / S + y1, 0, H);
    for (int j = 0; j < S; ++j) {
      const int ws = clampl(j * roi_w / S + x1, 0, W);
      const int we = clampl(((j + 1) * roi_w + S - 1) / S + x1, 0, W);
      float m = -INFINITY;
      for (int y = hs; y < he; ++y) {
        const T* row = f + (size_t)y * W * C;
        for (int x = ws; x < we; ++x) {
          const float v = to_float(row[(size_t)x * C]);
          if (v > m || isnan(v)) m = isnan(m) ? m : v;
        }
      }
      const bool empty = (he <= hs) || (we <= ws);
      store(o + (size_t)(i * S + j) * C, empty ? 0.f : m);
    }
  }
}

template <typename T>
int launch(const void* feat, const void* boxes, void* out, int B, int H, int W,
           int C, int P, int S, float spatial_scale, cudaStream_t stream) {
  const int threads = C < 256 ? C : 256;
  dim3 grid(P, B, (C + threads - 1) / threads);
  roi_pool_kernel<T><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(feat), static_cast<const float*>(boxes),
      static_cast<T*>(out), H, W, C, P, S, spatial_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int roi_pool_forward(const void* feat, const void* boxes, void* out,
                                int B, int H, int W, int C, int P, int S,
                                float spatial_scale, int dtype, void* stream) {
  if (B == 0 || P == 0 || C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(feat, boxes, out, B, H, W, C, P, S, spatial_scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(feat, boxes, out, B, H, W, C, P, S, spatial_scale, s);
  return (int)cudaErrorInvalidValue;
}
