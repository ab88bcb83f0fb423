// Hopper building blocks shared by the bf16 flash kernels (sm_90a): TMA
// tensor maps and loads, mbarriers, wgmma and its shared-memory operand
// descriptors, register rebalancing between warpgroups.
//
// Every operand tile lives in shared memory as 64-column slabs written by
// TMA with the 128-byte swizzle: a row of 64 bf16 is 128 bytes, and eight
// rows (1024 bytes) form one swizzle atom. wgmma reads the same slabs
// through descriptors of the matching layout: K-major (the reduction runs
// along the row) for Q K^T-style products, MN-major (the reduction runs
// down the rows, the transpose bit set) for P V-style products. Slabs and
// tiles start on 1024-byte boundaries so both agree on the pattern.
//
// Each kernel source includes it; it includes no PyTorch header.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <stdint.h>

namespace hopper {

constexpr unsigned FULL = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
// Bytes of one 64-row x 64-column bf16 slab.
constexpr int SLAB = 64 * 128;

// ------------------------------------------------------------ host side

// A 4-D tensor map over a contiguous (B, S, heads, dh) bf16 tensor, read
// in place: dims innermost first (dh, heads, S, B), boxes of 64 columns x
// 1 head x `rows` positions x 1 batch row, 128-byte swizzle. Positions
// past S read as zeros. Returns a cudaError_t code.
inline int make_map(CUtensorMap* map, const void* base, int B, int S,
                    int heads, int dh, int rows) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
    if (e != cudaSuccess) return (int)e;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)dh * 2,
                                 (cuuint64_t)heads * dh * 2,
                                 (cuuint64_t)S * heads * dh * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Allow a kernel `bytes` of dynamic shared memory, once.
template <typename Kern>
int allow_smem(Kern kern, int bytes, bool* done) {
  if (*done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  *done = true;
  return 0;
}

// ---------------------------------------------------------- device side

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary at or after p (the launch asks for 1024
// bytes more than the layout needs).
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive and add `bytes` to the transactions the current phase awaits.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA load of a box at coordinates (c0, c1, c2, c3) into shared
// memory, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Order this thread's generic shared-memory accesses after the async
// proxy's (TMA, wgmma) on the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Synchronise the 128 threads of one warpgroup on named barrier `id`.
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// A shared-memory matrix descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets (bytes, multiples of 16).
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// K-major operand: rows of one 64-column slab, 8-row groups 1024 bytes
// apart; a k16 step moves 32 bytes along the row (the leading offset is
// unused with this swizzle).
__device__ __forceinline__ uint64_t desc_k(const void* p) {
  return make_desc(p, 16, 1024);
}

// MN-major operand: 64-wide MN slabs `slab` bytes apart, 8-row k groups
// 1024 bytes apart; a k16 step moves 16 rows (2048 bytes).
__device__ __forceinline__ uint64_t desc_mn(const void* p, uint32_t slab) {
  return make_desc(p, slab, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving register reads or writes of an
// accumulator or operand across the asynchronous wgmma boundaries.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
}

// Two floats as a packed bf16 pair, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// An f32 accumulator of m64 x n (n = 16 k) as the A operands of k16
// steps: the accumulator's layout for two n8 blocks is the register
// layout of one k16 slice of A, so the conversion is a rounding in place.
template <int NA, int NK>
__device__ __forceinline__ void to_a_operand(const float (&d)[NA],
                                             uint32_t (&a)[NK][4]) {
  static_assert(NA == 8 * NK, "an accumulator of n = 16 k columns");
#pragma unroll
  for (int k = 0; k < NK; ++k)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[k][r] = pack_bf16(d[8 * k + 2 * r], d[8 * k + 2 * r + 1]);
}

// The wgmma accumulator fragment (f32, m64 x n): thread t of the
// warpgroup holds rows 16 (t / 32) + (t % 32) / 4 + 8 i and columns
// 8 j + 2 (t % 4) + c as d[4 j + 2 i + c].

#define WG_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_F16(d, i) \
  WG_F4(d, i), WG_F4(d, i + 4), WG_F4(d, i + 8), WG_F4(d, i + 12)
#define WG_D32(d) WG_F16(d, 0), WG_F16(d, 16)
#define WG_D64(d) WG_D32(d), WG_F16(d, 32), WG_F16(d, 48)

// D (m64 x n64, f32) = A B^T (acc = 0) or D += A B^T (acc = 1); A and B
// K-major in shared memory, given by their descriptors.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D32(d)
      : "l"(a), "l"(b), "r"(acc));
}

// D (m64 x n64, f32) += A B: A (m64 x k16 bf16) in registers as four
// packed pairs, B in shared memory MN-major (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (m64 x n128, f32) = A B^T (acc = 0) or D += A B^T (acc = 1); A and B
// K-major in shared memory, given by their descriptors.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_D64(d)
      : "l"(a), "l"(b), "r"(acc));
}

// D (m64 x n128, f32) += A B: A (m64 x k16 bf16) in registers as four
// packed pairs, B in shared memory MN-major (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_D64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef WG_D64
#undef WG_D32
#undef WG_F16
#undef WG_F4

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int acc) {
  static_assert(N == 64 || N == 128, "n64 or n128");
  if constexpr (N == 64)
    wgmma_ss_n64(d, a, b, acc);
  else
    wgmma_ss_n128(d, a, b, acc);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  static_assert(N == 64 || N == 128, "n64 or n128");
  if constexpr (N == 64)
    wgmma_rs_n64(d, a, b);
  else
    wgmma_rs_n128(d, a, b);
}

}  // namespace hopper
