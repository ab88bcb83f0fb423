// Flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ptype_tpu/ops/flash_attention.py
// (_fwd_kernel, launched by _fwd): causal or full attention forward with
// an online softmax over K/V tiles, tiles above the diagonal skipped,
// GQA-native (query head h reads kv head h / (H/K)), the log-sum-exp row
// written only when the caller asks for it.
//
// What bounds it on an H100: causal attention with K = H does about S/4
// flops per byte of q, k, v and o in bf16 against the card's ~295
// flop/byte balance point, so reading and writing those once bounds it up
// to S of about 1200 (the optimus-125m prompts of 512 and 1024) and the
// bf16 tensor-core rate (989 TFLOP/s dense) above that, or sooner with GQA.
// Either way the time a kernel like this one actually takes is set by how
// well it keeps the tensor cores fed, which this first version does not.
//
// What the design does about it (a first, simple version; TMA, wgmma and
// warp specialisation are later work):
// - bf16 products run on the tensor cores through WMMA 16x16x16 fragments
//   with f32 accumulation, for both S = Q K^T and O += P V; the f32
//   variant (kept so the CPU's f32 parity runs can be repeated on the
//   card) does the same arithmetic with scalar f32 multiply-adds;
// - one block of 4 warps per (q tile of 64 rows, head, batch row); each
//   warp owns 16 query rows, so the softmax and the rescaling of its
//   accumulator need only warp-level synchronisation; K/V tiles of 64
//   rows are staged in shared memory once per block and used by all four
//   warps;
// - scores, probabilities and the output accumulator stay in shared
//   memory: nothing of size S x S reaches device memory;
// - causal blocks stop at the diagonal tile, and the grid is walked from
//   the last q tile to the first so the longest blocks start first;
// - the kernel reads q, k, v in their (B, S, H|K, Dh) layout through
//   strides and writes o in that layout: no head-major copies, and the
//   LSE, when asked for, is a plain (B, H, S) f32 row (the TPU kernel
//   replicated it over 128 lanes for Mosaic's tiling).
//
// C interface (bound with ctypes): flash_fwd(...) enqueues on the given
// stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NWARP = 4;
constexpr int NT = NWARP * 32;
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

template <typename T, int DH>
struct Layout {
  static constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int LDT = DH + (kBf16 ? 8 : 4);  // q/k/v tile row
  static constexpr int LDS = BK + 4;                // f32 scores row
  static constexpr int LDP = BK + 8;                // bf16 probs row
  static constexpr int LDO = DH + 4;                // f32 output row
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + sizeof(T) * BQ * LDT;
  static constexpr size_t v_off = k_off + sizeof(T) * BK * LDT;
  static constexpr size_t s_off = v_off + sizeof(T) * BK * LDT;
  static constexpr size_t p_off = s_off + sizeof(float) * BQ * LDS;
  static constexpr size_t o_off = p_off + (kBf16 ? 2 * BQ * LDP : 0);
  static constexpr size_t m_off = o_off + sizeof(float) * BQ * LDO;
  static constexpr size_t l_off = m_off + sizeof(float) * BQ;
  static constexpr size_t a_off = l_off + sizeof(float) * BQ;
  static constexpr size_t bytes = a_off + sizeof(float) * BQ;
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Stage `rows` rows of one head into a shared tile with 16-byte loads;
// rows past the sequence end are zero-filled.
template <typename T, int DH, int LDT>
__device__ __forceinline__ void load_tile(T* tile, const T* src, int b,
                                          int row0, int rows, int S,
                                          int heads, int head) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = DH / VEC;
  for (int idx = threadIdx.x; idx < rows * CPR; idx += NT) {
    const int r = idx / CPR, c = idx % CPR;
    uint4 val = make_uint4(0, 0, 0, 0);
    const int sr = row0 + r;
    if (sr < S)
      val = *reinterpret_cast<const uint4*>(
          src + (((size_t)b * S + sr) * heads + head) * DH + c * VEC);
    *reinterpret_cast<uint4*>(tile + r * LDT + c * VEC) = val;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int S, int H, int K, int causal,
                 float scale) {
  using Lay = Layout<T, DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + Lay::q_off);
  T* sK = reinterpret_cast<T*>(smem + Lay::k_off);
  T* sV = reinterpret_cast<T*>(smem + Lay::v_off);
  float* sS = reinterpret_cast<float*>(smem + Lay::s_off);
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(smem + Lay::p_off);
  float* sO = reinterpret_cast<float*>(smem + Lay::o_off);
  float* sM = reinterpret_cast<float*>(smem + Lay::m_off);
  float* sL = reinterpret_cast<float*>(smem + Lay::l_off);
  float* sA = reinterpret_cast<float*>(smem + Lay::a_off);

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / K);
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;  // this warp's first row in the tile

  load_tile<T, DH, Lay::LDT>(sQ, q, b, q0, BQ, S, H, h);
  for (int rr = 0; rr < 16; ++rr) {
    for (int d = lane; d < DH; d += 32) sO[(r0 + rr) * Lay::LDO + d] = 0.f;
    if (lane == 0) { sM[r0 + rr] = NEG; sL[r0 + rr] = 0.f; }
  }
  __syncthreads();

  // The warp's Q fragments stay in registers for the whole K/V loop.
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
      qa[DH / 16];
  if constexpr (Lay::kBf16) {
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wmma::load_matrix_sync(qa[kk], sQ + r0 * Lay::LDT + kk * 16, Lay::LDT);
  }

  int n_kv = (S + BK - 1) / BK;
  if (causal) {
    const int last = (min(q0 + BQ, S) - 1) / BK + 1;
    n_kv = min(n_kv, last);
  }

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<T, DH, Lay::LDT>(sK, k, b, k0, BK, S, K, kvh);
    load_tile<T, DH, Lay::LDT>(sV, v, b, k0, BK, S, K, kvh);
    __syncthreads();

    // S = Q K^T for the warp's 16 rows.
    if constexpr (Lay::kBf16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> kb;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
#pragma unroll
      for (int n = 0; n < BK / 16; ++n) {
        wmma::fill_fragment(c, 0.f);
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          wmma::load_matrix_sync(kb, sK + n * 16 * Lay::LDT + kk * 16,
                                 Lay::LDT);
          wmma::mma_sync(c, qa[kk], kb, c);
        }
        wmma::store_matrix_sync(sS + r0 * Lay::LDS + n * 16, c, Lay::LDS,
                                wmma::mem_row_major);
      }
    } else {
      for (int rr = 0; rr < 16; ++rr) {
        const T* qr = sQ + (r0 + rr) * Lay::LDT;
        for (int c = lane; c < BK; c += 32) {
          const T* kr = sK + c * Lay::LDT;
          float s = 0.f;
#pragma unroll 8
          for (int d = 0; d < DH; ++d) s += qr[d] * kr[d];
          sS[(r0 + rr) * Lay::LDS + c] = s;
        }
      }
    }
    __syncwarp();

    // Online softmax over this tile, one row at a time across the warp.
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr, row = q0 + r;
      const float m_old = sM[r];
      float sv[BK / 32];
      bool ok[BK / 32];
      float mx = NEG;
#pragma unroll
      for (int e = 0; e < BK / 32; ++e) {
        const int c = lane + 32 * e, colg = k0 + c;
        ok[e] = colg < S && (!causal || colg <= row);
        sv[e] = sS[r * Lay::LDS + c] * scale;
        if (ok[e]) mx = fmaxf(mx, sv[e]);
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float m_new = fmaxf(m_old, mx);
      const float alpha = __expf(m_old - m_new);
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < BK / 32; ++e) {
        const int c = lane + 32 * e;
        const float p = ok[e] ? __expf(sv[e] - m_new) : 0.f;
        sum += p;
        if constexpr (Lay::kBf16)
          sP[r * Lay::LDP + c] = __float2bfloat16(p);
        else
          sS[r * Lay::LDS + c] = p;
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        sum += __shfl_xor_sync(FULL, sum, off);
      if (lane == 0) {
        sM[r] = m_new;
        sL[r] = sL[r] * alpha + sum;
        sA[r] = alpha;
      }
    }
    __syncwarp();
    for (int rr = 0; rr < 16; ++rr) {
      const float al = sA[r0 + rr];
      for (int d = lane; d < DH; d += 32) sO[(r0 + rr) * Lay::LDO + d] *= al;
    }
    __syncwarp();

    // O += P V for the warp's 16 rows.
    if constexpr (Lay::kBf16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> pa[BK / 16];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> vb;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wmma::load_matrix_sync(pa[kk], sP + r0 * Lay::LDP + kk * 16, Lay::LDP);
#pragma unroll
      for (int n = 0; n < DH / 16; ++n) {
        float* op = sO + r0 * Lay::LDO + n * 16;
        wmma::load_matrix_sync(c, op, Lay::LDO, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          wmma::load_matrix_sync(vb, sV + kk * 16 * Lay::LDT + n * 16,
                                 Lay::LDT);
          wmma::mma_sync(c, pa[kk], vb, c);
        }
        wmma::store_matrix_sync(op, c, Lay::LDO, wmma::mem_row_major);
      }
    } else {
      for (int rr = 0; rr < 16; ++rr) {
        const float* pr = sS + (r0 + rr) * Lay::LDS;
        for (int d = lane; d < DH; d += 32) {
          float acc = sO[(r0 + rr) * Lay::LDO + d];
#pragma unroll 8
          for (int c = 0; c < BK; ++c)
            acc += pr[c] * sV[c * Lay::LDT + d];
          sO[(r0 + rr) * Lay::LDO + d] = acc;
        }
      }
    }
    __syncwarp();
  }

  // Normalise and write o (and the LSE row when asked for).
  for (int rr = 0; rr < 16; ++rr) {
    const int r = r0 + rr, row = q0 + r;
    if (row >= S) break;
    const float l = sL[r];
    const float l_safe = l == 0.f ? 1.f : l;
    T* dst = o + (((size_t)b * S + row) * H + h) * DH;
    for (int d = lane; d < DH; d += 32)
      store(dst + d, sO[r * Lay::LDO + d] / l_safe);
    if (lse != nullptr && lane == 0)
      lse[((size_t)b * H + h) * S + row] = sM[r] + logf(l_safe);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o,
           float* lse, int B, int S, int H, int K, int causal, float scale,
           cudaStream_t stream) {
  using Lay = Layout<T, DH>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)Lay::bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, DH><<<grid, NT, Lay::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, H, K, causal,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q, o (B, S, H, Dh); k, v (B, S, K,
// Dh), all contiguous; lse (B, H, S) f32 or null.
int flash_fwd(const void* q, const void* k, const void* v, void* o,
              float* lse, int B, int S, int H, int K, int Dh, int dtype,
              int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K <= 0 || H % K != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && Dh == 128)
    return launch<float, 128>(q, k, v, o, lse, B, S, H, K, causal, scale, s);
  if (dtype == 0 && Dh == 64)
    return launch<float, 64>(q, k, v, o, lse, B, S, H, K, causal, scale, s);
  if (dtype == 1 && Dh == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, lse, B, S, H, K, causal,
                                      scale, s);
  if (dtype == 1 && Dh == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, lse, B, S, H, K, causal,
                                     scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
