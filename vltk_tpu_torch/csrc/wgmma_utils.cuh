// Hopper (sm_90a) building blocks shared by the flash-attention kernels
// (flash_attention.cu, flash_attention_bwd.cu): TMA tile loads into
// 128-byte-swizzled shared memory, completed on mbarriers, and TMA tile
// stores back; the warpgroup product wgmma.mma_async m64n64k16 bf16 -> f32
// with A from shared memory or from registers, as inline PTX; and, on the
// host, the encoder of the TMA maps of a (n, s, nh, 64) bf16 view.
//
// Tile layout: R rows of 64 bf16 (128 bytes a row), as TMA writes a box
// with CU_TENSOR_MAP_SWIZZLE_128B: row r at byte r * 128, its 16-byte chunk
// c at chunk c ^ (r % 8). Every tile starts on a 1024-byte boundary (one
// 8-row swizzle atom), so the swizzle phase that wgmma reads back from the
// address bits is the one TMA wrote.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------------------- helpers

// 2^x on the MUFU unit, subnormal results flushed to zero (a p below
// 2^-126 adds nothing at bf16 precision); one instruction where exp2f spends
// four on the subnormal range
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// id intervals [x, y] of the tile skipping; the empty one meets none
__device__ __forceinline__ int2 empty_interval() { return make_int2(INT_MAX, INT_MIN); }

__device__ __forceinline__ bool meets(int2 a, int2 b) { return a.x <= b.y && b.x <= a.y; }

template <int N>
__device__ __forceinline__ void zero(float (&c)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) c[i] = 0.f;
}

// the first 1024-byte boundary at or after `raw` (dynamic shared memory
// has room for it)
__device__ __forceinline__ uint8_t* align1024(uint8_t* raw) {
  return raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
}

// ----------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also tells the barrier to expect `bytes` more
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed; every thread of
// the warp calls it, and the warp leaves it converged (for the .aligned
// wgmma instructions that follow). A copy that never lands (a bad map)
// traps after 2^24 tries, seconds, so the launch fails instead of hanging
// the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 24)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
  __syncwarp();
}

// ----------------------------------------------------------------- TMA

// the box at coordinates (c0, c1, c2, c3) of a 4-D tensor map into shared
// memory; its bytes complete on `bar`. Coordinates past the tensor's edge
// read as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// the box at `src` in shared memory to coordinates (c0, c1, c2, c3) of a
// 4-D tensor map; elements past the tensor's edge are not written. The
// writers of `src` run fence_proxy_async() and a barrier first; the issuing
// thread commits and waits (tma_store_wait) before shared memory may go.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0, int c1, int c2,
                                             int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// makes this thread's ordinary writes to shared memory visible to TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// commits the issued stores and waits until their shared memory was read
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// --------------------------------------------------------------- wgmma

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products that own it
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Matrix descriptors of a 128B-swizzled tile (layout type 1 in bits 62-63;
// offsets in 16-byte units).
// K-major (the product's depth runs along the 128-byte row: A, and B with
// tnspB = 0): 64 rows from `tile`, 8-row groups 1024 bytes apart; the
// k-step kk of 16 elements starts 32 bytes further: desc + 2 * kk.
// MN-major (B with tnspB = 1: the depth runs down the rows, the 64 output
// columns along the row): 16 rows from `tile` make one k-step, two 8-row
// groups 1024 bytes apart; the k-step kk starts 2048 bytes further:
// desc + 128 * kk.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  const uint64_t lbo = 16 >> 4, sbo = 1024 >> 4;
  return (uint64_t)((smem_addr(tile) >> 4) & 0x3FFF) | (lbo << 16) | (sbo << 32) | (1ull << 62);
}
constexpr uint64_t DESC_K_STEP = 32 >> 4;     // K-major: 16 bf16 along the row
constexpr uint64_t DESC_MN_STEP = 2048 >> 4;  // MN-major: 16 rows of 128 bytes

#define WGMMA_D32                                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, " \
  "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WGMMA_D32_OUT(d)                                                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), \
      "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),  \
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (64 x 64, f32) (+)= A (64 x 16, shared) * B (16 x 64, shared); d is
// overwritten when accumulate is 0. The accumulator's layout: thread t of
// the warpgroup holds rows 16 (t / 32) + (t % 32) / 4 (+ 8 for e >= 2) and
// columns 8 j + 2 (t % 4) + (e % 2) in d[4 j + e], the mma.sync C layout
// repeated over the 8 column chunks j.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32 ", %32, %33, p, 1, 1, 0, %35;\n"
      "}\n"
      : WGMMA_D32_OUT(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TRANS_B));
}

// d (64 x 64, f32) (+)= A (64 x 16, registers: the mma.sync A fragment of
// the warp's 16 rows) * B (16 x 64, shared)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32 ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : WGMMA_D32_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate), "n"(TRANS_B));
}

#define WGMMA_D16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define WGMMA_D16_OUT(d)                                                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), \
      "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])

// d (64 x 32, f32) (+)= A (64 x 16, shared) * B (16 x 32, shared): the same
// layouts with 4 column chunks, d[4 j + e]
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " WGMMA_D16 ", %16, %17, p, 1, 1, 0, %19;\n"
      "}\n"
      : WGMMA_D16_OUT(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TRANS_B));
}

#undef WGMMA_D32
#undef WGMMA_D32_OUT
#undef WGMMA_D16
#undef WGMMA_D16_OUT

// the A fragment of k-step kk (columns 16 kk .. 16 kk + 15) of a 64 x 64
// (or 64 x 32) accumulator, rounded to bf16: the accumulator's layout is the A layout.
// Call it with kk known at compile time (an unrolled loop), so that d stays
// in registers.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&d)[N], int kk) {
  a[0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// ---------------------------------------------------------- host: maps

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the CUDA driver API's cuTensorMapEncodeTiled, reached through the
// runtime so that the library needs no -lcuda; null if it is missing
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(ptr)
                                                                       : nullptr;
  }();
  return fn;
}

// the TMA map of a (n, s, nh, 64) bf16 view with (batch, seq, head) strides
// `st` in elements: the 4-D tensor (64, nh, s, n), a box of `rows` rows of
// one head, 128-byte swizzle, zeros read past s (and nothing written
// there). The caller makes a runtime call first (cudaFuncSetAttribute
// does): it makes the device's context current in this thread, which the
// encode needs (autograd runs the backward in a thread of its own that may
// not have made it current yet).
inline bool make_map(CUtensorMap* map, const void* ptr, int n, int s, int nh, const long long* st, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr || ptr == nullptr) return false;
  const cuuint64_t dims[4] = {64, (cuuint64_t)nh, (cuuint64_t)s, (cuuint64_t)n};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2, (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
