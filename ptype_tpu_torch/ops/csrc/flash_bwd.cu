// Flash attention backward for Hopper (sm_90a): the dq kernel and the
// dk/dv kernel.
//
// Replace the Pallas TPU kernels of ptype_tpu/ops/flash_attention.py,
// launched by _flash_bwd:
// - flash_bwd_dq_kernel replaces _dq_kernel: dq for one q tile, K/V tiles
//   streamed, P recomputed from the forward's LSE, dS = P (dP - delta);
// - flash_bwd_dkv_kernel replaces _dkv_kernel: dk and dv for one kv tile
//   of one KV head, summed over the query heads of its GQA group and over
//   every q tile.
// delta = rowsum(dO o O) comes in precomputed, as in the reference.
//
// What bounds them on an H100: the dq pass does 6 Dh flops per causal
// (q, k) pair and head, the dk/dv pass 8 Dh, against q, k, v, dO and the
// gradients read or written once. At the optimus-125m train shape (S=1024,
// Dh=128, causal) that is ~305 flops per byte for dq and ~340 for dk/dv,
// just over the card's ~295 flop/byte balance point, so both are bound by
// the bf16 tensor-core rate (989 TFLOP/s dense) with the memory rate
// (3.35 TB/s) close behind; longer sequences and GQA move them further
// onto the tensor cores. What a kernel like this actually takes is set by
// how well it keeps the tensor cores fed, which this first version does
// not.
//
// What the design does about it (a first, simple version; TMA, wgmma and
// pipelining are later work):
// - bf16 products run on the tensor cores through WMMA 16x16x16 fragments
//   with f32 accumulation; the f32 variant (kept so the CPU's f32 parity
//   runs can be repeated on the card) does the same arithmetic with scalar
//   f32 multiply-adds;
// - one block of 4 warps per (q tile of 64 rows, head, batch row) for dq,
//   and per (kv tile of 64 rows, KV head, batch row) for dk/dv; each warp
//   owns 16 rows of the tile it accumulates, so the elementwise pass needs
//   only warp-level synchronisation;
// - the TPU grid's innermost sequential dimensions become loops inside the
//   block: dq loops over K/V tiles up to the diagonal, dk/dv over the
//   group's G query heads and the q tiles from the diagonal on; the GQA
//   group sum stays inside the block, so there are no atomics and the
//   result is deterministic;
// - the gradient accumulators live in registers as WMMA accumulator
//   fragments for the whole loop and are written once; S and dP go through
//   shared memory in f32, and P / dS are rounded to bf16 in place over the
//   S rows for the next products, which keeps a block at ~103 KB of shared
//   memory so two fit on an SM;
// - causal blocks skip every tile on the far side of the diagonal; dq
//   walks its grid from the last q tile (the longest) to the first, and
//   the dk/dv grid starts at kv tile 0 (the longest) by construction;
// - all tensors are read and written in their (B, S, H|K, Dh) layout
//   through strides: no head-major copies. lse is the forward's plain
//   (B, H, S) f32 row and delta a (B, S, H) f32 row.
//
// Numerics: the bf16 kernels round P and dS to bf16 before the tensor-core
// products (the reference rounds dS, and computes dP and dV with dO in
// f32). Tolerances are stated where the kernels are checked.
//
// C interface (bound with ctypes): flash_bwd_dq(...) and flash_bwd_dkv(...)
// enqueue on the given stream and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int BQ = 64;  // q rows of a tile
constexpr int BK = 64;  // k rows of a tile (== BQ: score tiles are square)
constexpr int NWARP = 4;
constexpr int NT = NWARP * 32;

template <typename T, int DH>
struct Tiles {
  static constexpr bool kBf16 = std::is_same<T, bf16>::value;
  static constexpr int LDT = DH + (kBf16 ? 8 : 4);  // operand tile row
  static constexpr int LDS = BK + 4;                // f32 score row
  static constexpr int LDB = 2 * LDS;               // that row as bf16
  static constexpr int LDA = DH + 4;                // f32 epilogue row
  static constexpr size_t tile = sizeof(T) * 64 * LDT;
  static constexpr size_t scores = sizeof(float) * 64 * LDS;
  // Four operand tiles, the S and dP tiles, the lse and delta rows.
  static constexpr size_t bytes = 4 * tile + 2 * scores + 2 * 64 * 4;
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
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

// out (16 x 64 f32, row stride ldo) = a (16 x DH) . bt^T, with a and bt
// (64 x DH) row-major bf16 tiles of row stride LDT: the warp's rows of
// Q K^T, dO V^T, K Q^T or V dO^T.
template <int DH, int LDT>
__device__ __forceinline__ void warp_abt(float* out, int ldo, const bf16* a,
                                         const bf16* bt) {
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
      fa[DH / 16];
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wmma::load_matrix_sync(fa[kk], a + kk * 16, LDT);
#pragma unroll
  for (int n = 0; n < 64 / 16; ++n) {
    wmma::fill_fragment(c, 0.f);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      wmma::load_matrix_sync(fb, bt + n * 16 * LDT + kk * 16, LDT);
      wmma::mma_sync(c, fa[kk], fb, c);
    }
    wmma::store_matrix_sync(out + n * 16, c, ldo, wmma::mem_row_major);
  }
}

// The scalar f32 counterpart of warp_abt.
template <int DH, int LDT>
__device__ __forceinline__ void warp_abt_f32(float* out, int ldo,
                                             const float* a,
                                             const float* bt) {
  const int lane = threadIdx.x % 32;
  for (int rr = 0; rr < 16; ++rr) {
    const float* ar = a + rr * LDT;
    for (int c = lane; c < 64; c += 32) {
      const float* br = bt + c * LDT;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) s += ar[d] * br[d];
      out[rr * ldo + c] = s;
    }
  }
}

// ------------------------------------------------------------------- dq

template <typename T, int DH>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dO,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int S, int H, int K, int causal, float scale) {
  using L = Tiles<T, DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sdO = reinterpret_cast<T*>(smem + L::tile);
  T* sK = reinterpret_cast<T*>(smem + 2 * L::tile);
  T* sV = reinterpret_cast<T*>(smem + 3 * L::tile);
  float* sS = reinterpret_cast<float*>(smem + 4 * L::tile);
  float* sdP = reinterpret_cast<float*>(smem + 4 * L::tile + L::scores);
  float* sLse = reinterpret_cast<float*>(smem + 4 * L::tile + 2 * L::scores);
  float* sDel = sLse + BQ;

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / K);
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;  // this warp's first row in the tile

  load_tile<T, DH, L::LDT>(sQ, q, b, q0, BQ, S, H, h);
  load_tile<T, DH, L::LDT>(sdO, dO, b, q0, BQ, S, H, h);
  for (int r = threadIdx.x; r < BQ; r += NT) {
    const int row = q0 + r;
    sLse[r] = row < S ? lse[((size_t)b * H + h) * S + row] : 0.f;
    sDel[r] = row < S ? delta[((size_t)b * S + row) * H + h] : 0.f;
  }

  // dQ accumulators for the warp's 16 rows: fragments (bf16) or one
  // register per (row, column lane + 32 i) (f32).
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[DH / 16];
  float facc[16][DH / 32];
  if constexpr (L::kBf16) {
#pragma unroll
    for (int n = 0; n < DH / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
  } else {
#pragma unroll
    for (int rr = 0; rr < 16; ++rr)
#pragma unroll
      for (int i = 0; i < DH / 32; ++i) facc[rr][i] = 0.f;
  }

  int n_kv = (S + BK - 1) / BK;
  if (causal) n_kv = min(n_kv, (min(q0 + BQ, S) - 1) / BK + 1);

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<T, DH, L::LDT>(sK, k, b, k0, BK, S, K, kvh);
    load_tile<T, DH, L::LDT>(sV, v, b, k0, BK, S, K, kvh);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for the warp's 16 rows.
    if constexpr (L::kBf16) {
      warp_abt<DH, L::LDT>(sS + r0 * L::LDS, L::LDS,
                           reinterpret_cast<const bf16*>(sQ) + r0 * L::LDT,
                           reinterpret_cast<const bf16*>(sK));
      warp_abt<DH, L::LDT>(sdP + r0 * L::LDS, L::LDS,
                           reinterpret_cast<const bf16*>(sdO) + r0 * L::LDT,
                           reinterpret_cast<const bf16*>(sV));
    } else {
      warp_abt_f32<DH, L::LDT>(sS + r0 * L::LDS, L::LDS,
                               reinterpret_cast<const float*>(sQ) +
                                   r0 * L::LDT,
                               reinterpret_cast<const float*>(sK));
      warp_abt_f32<DH, L::LDT>(sdP + r0 * L::LDS, L::LDS,
                               reinterpret_cast<const float*>(sdO) +
                                   r0 * L::LDT,
                               reinterpret_cast<const float*>(sV));
    }
    __syncwarp();

    // dS = P (dP - delta) scale, P = exp(S scale - lse), one row at a
    // time across the warp. bf16: dS overwrites the row's first 128
    // bytes, after every lane has read the row.
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr, row = q0 + r;
      const float l = sLse[r], dl = sDel[r];
      float ds[BK / 32];
#pragma unroll
      for (int e = 0; e < BK / 32; ++e) {
        const int c = lane + 32 * e, col = k0 + c;
        const bool ok = row < S && col < S && (!causal || col <= row);
        const float p = ok ? __expf(sS[r * L::LDS + c] * scale - l) : 0.f;
        ds[e] = p * (sdP[r * L::LDS + c] - dl) * scale;
      }
      if constexpr (L::kBf16) {
        __syncwarp();
        bf16* sb = reinterpret_cast<bf16*>(sS + r * L::LDS);
#pragma unroll
        for (int e = 0; e < BK / 32; ++e)
          sb[lane + 32 * e] = __float2bfloat16(ds[e]);
      } else {
#pragma unroll
        for (int e = 0; e < BK / 32; ++e) sS[r * L::LDS + lane + 32 * e] = ds[e];
      }
    }
    __syncwarp();

    // dQ += dS K for the warp's 16 rows.
    if constexpr (L::kBf16) {
      const bf16* sb = reinterpret_cast<const bf16*>(sS + r0 * L::LDS);
      const bf16* kb = reinterpret_cast<const bf16*>(sK);
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
          da[BK / 16];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wmma::load_matrix_sync(da[kk], sb + kk * 16, L::LDB);
#pragma unroll
      for (int n = 0; n < DH / 16; ++n) {
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          wmma::load_matrix_sync(fb, kb + kk * 16 * L::LDT + n * 16, L::LDT);
          wmma::mma_sync(acc[n], da[kk], fb, acc[n]);
        }
      }
    } else {
      const float* kf = reinterpret_cast<const float*>(sK);
#pragma unroll
      for (int rr = 0; rr < 16; ++rr) {
        const float* dsr = sS + (r0 + rr) * L::LDS;
        // Not unrolled: 64 x 16 x DH/32 unrolled FMAs tripled the build.
#pragma unroll 1
        for (int c = 0; c < BK; ++c) {
          const float w = dsr[c];
#pragma unroll
          for (int i = 0; i < DH / 32; ++i)
            facc[rr][i] += w * kf[c * L::LDT + lane + 32 * i];
        }
      }
    }
  }

  // Write dq (B, S, H, Dh).
  if constexpr (L::kBf16) {
    __syncthreads();  // the epilogue buffer spans other warps' S rows
    float* buf = sS;
#pragma unroll
    for (int n = 0; n < DH / 16; ++n)
      wmma::store_matrix_sync(buf + r0 * L::LDA + n * 16, acc[n], L::LDA,
                              wmma::mem_row_major);
    __syncwarp();
    for (int rr = 0; rr < 16; ++rr) {
      const int row = q0 + r0 + rr;
      if (row >= S) break;
      T* dst = dq + (((size_t)b * S + row) * H + h) * DH;
      for (int d = lane; d < DH; d += 32)
        store(dst + d, buf[(r0 + rr) * L::LDA + d]);
    }
  } else {
#pragma unroll
    for (int rr = 0; rr < 16; ++rr) {
      const int row = q0 + r0 + rr;
      if (row < S) {
        T* dst = dq + (((size_t)b * S + row) * H + h) * DH;
#pragma unroll
        for (int i = 0; i < DH / 32; ++i) store(dst + lane + 32 * i, facc[rr][i]);
      }
    }
  }
}

// ----------------------------------------------------------------- dk/dv

template <typename T, int DH>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dO,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int H, int K, int causal,
                     float scale) {
  using L = Tiles<T, DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = reinterpret_cast<T*>(smem + L::tile);
  T* sQ = reinterpret_cast<T*>(smem + 2 * L::tile);
  T* sdO = reinterpret_cast<T*>(smem + 3 * L::tile);
  float* sS = reinterpret_cast<float*>(smem + 4 * L::tile);
  float* sdP = reinterpret_cast<float*>(smem + 4 * L::tile + L::scores);
  float* sLse = reinterpret_cast<float*>(smem + 4 * L::tile + 2 * L::scores);
  float* sDel = sLse + BQ;

  const int kt = blockIdx.x;  // tile 0 has the most causal q tiles
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / K;
  const int k0 = kt * BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;  // this warp's first kv row in the tile

  load_tile<T, DH, L::LDT>(sK, k, b, k0, BK, S, K, kvh);
  load_tile<T, DH, L::LDT>(sV, v, b, k0, BK, S, K, kvh);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acck[DH / 16];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> accv[DH / 16];
  float fk[16][DH / 32], fv[16][DH / 32];
  if constexpr (L::kBf16) {
#pragma unroll
    for (int n = 0; n < DH / 16; ++n) {
      wmma::fill_fragment(acck[n], 0.f);
      wmma::fill_fragment(accv[n], 0.f);
    }
  } else {
#pragma unroll
    for (int rr = 0; rr < 16; ++rr)
#pragma unroll
      for (int i = 0; i < DH / 32; ++i) fk[rr][i] = fv[rr][i] = 0.f;
  }

  const int nq = (S + BQ - 1) / BQ;
  // Causal: q tile i holds a row at or past this tile's first key iff
  // (i + 1) BQ > k0, i.e. i >= k0 / BQ (BQ == BK).
  const int i0 = causal ? k0 / BQ : 0;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int i = i0; i < nq; ++i) {
      const int q0 = i * BQ;
      __syncthreads();  // every warp is done with the previous Q/dO tile
      load_tile<T, DH, L::LDT>(sQ, q, b, q0, BQ, S, H, h);
      load_tile<T, DH, L::LDT>(sdO, dO, b, q0, BQ, S, H, h);
      for (int r = threadIdx.x; r < BQ; r += NT) {
        const int row = q0 + r;
        sLse[r] = row < S ? lse[((size_t)b * H + h) * S + row] : 0.f;
        sDel[r] = row < S ? delta[((size_t)b * S + row) * H + h] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T for the warp's 16 kv rows.
      if constexpr (L::kBf16) {
        warp_abt<DH, L::LDT>(sS + r0 * L::LDS, L::LDS,
                             reinterpret_cast<const bf16*>(sK) + r0 * L::LDT,
                             reinterpret_cast<const bf16*>(sQ));
        warp_abt<DH, L::LDT>(sdP + r0 * L::LDS, L::LDS,
                             reinterpret_cast<const bf16*>(sV) + r0 * L::LDT,
                             reinterpret_cast<const bf16*>(sdO));
      } else {
        warp_abt_f32<DH, L::LDT>(sS + r0 * L::LDS, L::LDS,
                                 reinterpret_cast<const float*>(sK) +
                                     r0 * L::LDT,
                                 reinterpret_cast<const float*>(sQ));
        warp_abt_f32<DH, L::LDT>(sdP + r0 * L::LDS, L::LDS,
                                 reinterpret_cast<const float*>(sV) +
                                     r0 * L::LDT,
                                 reinterpret_cast<const float*>(sdO));
      }
      __syncwarp();

      // P^T and dS^T, one kv row at a time across the warp. bf16: P goes
      // to the row's first 128 bytes and dS to the next 128, after every
      // lane has read the row; f32: in place in S and dP.
      for (int rr = 0; rr < 16; ++rr) {
        const int r = r0 + rr, kcol = k0 + r;
        float p[BQ / 32], ds[BQ / 32];
#pragma unroll
        for (int e = 0; e < BQ / 32; ++e) {
          const int c = lane + 32 * e, row = q0 + c;
          const bool ok = row < S && kcol < S && (!causal || kcol <= row);
          p[e] = ok ? __expf(sS[r * L::LDS + c] * scale - sLse[c]) : 0.f;
          ds[e] = p[e] * (sdP[r * L::LDS + c] - sDel[c]) * scale;
        }
        if constexpr (L::kBf16) {
          __syncwarp();
          bf16* sb = reinterpret_cast<bf16*>(sS + r * L::LDS);
#pragma unroll
          for (int e = 0; e < BQ / 32; ++e) {
            sb[lane + 32 * e] = __float2bfloat16(p[e]);
            sb[BQ + lane + 32 * e] = __float2bfloat16(ds[e]);
          }
        } else {
#pragma unroll
          for (int e = 0; e < BQ / 32; ++e) {
            sS[r * L::LDS + lane + 32 * e] = p[e];
            sdP[r * L::LDS + lane + 32 * e] = ds[e];
          }
        }
      }
      __syncwarp();

      // dV += P^T dO and dK += dS^T Q for the warp's 16 kv rows.
      if constexpr (L::kBf16) {
        const bf16* sb = reinterpret_cast<const bf16*>(sS + r0 * L::LDS);
        const bf16* qb = reinterpret_cast<const bf16*>(sQ);
        const bf16* ob = reinterpret_cast<const bf16*>(sdO);
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
            pa[BQ / 16], da[BQ / 16];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          wmma::load_matrix_sync(pa[kk], sb + kk * 16, L::LDB);
          wmma::load_matrix_sync(da[kk], sb + BQ + kk * 16, L::LDB);
        }
#pragma unroll
        for (int n = 0; n < DH / 16; ++n) {
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk) {
            wmma::load_matrix_sync(fb, ob + kk * 16 * L::LDT + n * 16, L::LDT);
            wmma::mma_sync(accv[n], pa[kk], fb, accv[n]);
            wmma::load_matrix_sync(fb, qb + kk * 16 * L::LDT + n * 16, L::LDT);
            wmma::mma_sync(acck[n], da[kk], fb, acck[n]);
          }
        }
      } else {
        const float* qf = reinterpret_cast<const float*>(sQ);
        const float* of = reinterpret_cast<const float*>(sdO);
#pragma unroll
        for (int rr = 0; rr < 16; ++rr) {
          const float* pr = sS + (r0 + rr) * L::LDS;
          const float* dsr = sdP + (r0 + rr) * L::LDS;
#pragma unroll 1
          for (int c = 0; c < BQ; ++c) {
            const float wp = pr[c], wd = dsr[c];
#pragma unroll
            for (int i = 0; i < DH / 32; ++i) {
              fv[rr][i] += wp * of[c * L::LDT + lane + 32 * i];
              fk[rr][i] += wd * qf[c * L::LDT + lane + 32 * i];
            }
          }
        }
      }
    }
  }

  // Write dk, dv (B, S, K, Dh).
  if constexpr (L::kBf16) {
    __syncthreads();  // the epilogue buffers span the Q, dO, S, dP tiles
    float* bufk = reinterpret_cast<float*>(sQ);
    float* bufv = bufk + 64 * L::LDA;
#pragma unroll
    for (int n = 0; n < DH / 16; ++n) {
      wmma::store_matrix_sync(bufk + r0 * L::LDA + n * 16, acck[n], L::LDA,
                              wmma::mem_row_major);
      wmma::store_matrix_sync(bufv + r0 * L::LDA + n * 16, accv[n], L::LDA,
                              wmma::mem_row_major);
    }
    __syncwarp();
    for (int rr = 0; rr < 16; ++rr) {
      const int row = k0 + r0 + rr;
      if (row >= S) break;
      const size_t off = (((size_t)b * S + row) * K + kvh) * DH;
      for (int d = lane; d < DH; d += 32) {
        store(dk + off + d, bufk[(r0 + rr) * L::LDA + d]);
        store(dv + off + d, bufv[(r0 + rr) * L::LDA + d]);
      }
    }
  } else {
#pragma unroll
    for (int rr = 0; rr < 16; ++rr) {
      const int row = k0 + r0 + rr;
      if (row < S) {
        const size_t off = (((size_t)b * S + row) * K + kvh) * DH;
#pragma unroll
        for (int i = 0; i < DH / 32; ++i) {
          store(dk + off + lane + 32 * i, fk[rr][i]);
          store(dv + off + lane + 32 * i, fv[rr][i]);
        }
      }
    }
  }
}

// The epilogue buffers must fit in the space they reuse.
static_assert(64 * (128 + 4) * 4 <= 2 * Tiles<bf16, 128>::scores,
              "dq epilogue buffer exceeds the S and dP tiles");
static_assert(2 * 64 * (128 + 4) * 4 <=
                  2 * Tiles<bf16, 128>::tile + 2 * Tiles<bf16, 128>::scores,
              "dk/dv epilogue buffers exceed the Q, dO, S and dP tiles");

template <typename Kern>
int set_smem(Kern kern, size_t bytes, bool* done) {
  if (*done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  *done = true;
  return 0;
}

template <typename T, int DH>
int launch_dq(const void* q, const void* k, const void* v, const void* dO,
              const float* lse, const float* delta, void* dq, int B, int S,
              int H, int K, int causal, float scale, cudaStream_t stream) {
  using L = Tiles<T, DH>;
  static bool attr_set = false;
  const int e = set_smem(flash_bwd_dq_kernel<T, DH>, L::bytes, &attr_set);
  if (e) return e;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_bwd_dq_kernel<T, DH><<<grid, NT, L::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dO), lse, delta,
      static_cast<T*>(dq), S, H, K, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch_dkv(const void* q, const void* k, const void* v, const void* dO,
               const float* lse, const float* delta, void* dk, void* dv,
               int B, int S, int H, int K, int causal, float scale,
               cudaStream_t stream) {
  using L = Tiles<T, DH>;
  static bool attr_set = false;
  const int e = set_smem(flash_bwd_dkv_kernel<T, DH>, L::bytes, &attr_set);
  if (e) return e;
  const dim3 grid((S + BK - 1) / BK, K, B);
  flash_bwd_dkv_kernel<T, DH><<<grid, NT, L::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dO), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), S, H, K, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q, dO, dq (B, S, H, Dh); k, v
// (B, S, K, Dh), all contiguous; lse (B, H, S) and delta (B, S, H) f32.
int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dO,
                 const float* lse, const float* delta, void* dq, int B, int S,
                 int H, int K, int Dh, int dtype, int causal, float scale,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K <= 0 || H % K != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && Dh == 128)
    return launch_dq<float, 128>(q, k, v, dO, lse, delta, dq, B, S, H, K,
                                 causal, scale, s);
  if (dtype == 0 && Dh == 64)
    return launch_dq<float, 64>(q, k, v, dO, lse, delta, dq, B, S, H, K,
                                causal, scale, s);
  if (dtype == 1 && Dh == 128)
    return launch_dq<bf16, 128>(q, k, v, dO, lse, delta, dq, B, S, H, K,
                                causal, scale, s);
  if (dtype == 1 && Dh == 64)
    return launch_dq<bf16, 64>(q, k, v, dO, lse, delta, dq, B, S, H, K,
                               causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

// Same operands; dk, dv (B, S, K, Dh).
int flash_bwd_dkv(const void* q, const void* k, const void* v,
                  const void* dO, const float* lse, const float* delta,
                  void* dk, void* dv, int B, int S, int H, int K, int Dh,
                  int dtype, int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K <= 0 || H % K != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && Dh == 128)
    return launch_dkv<float, 128>(q, k, v, dO, lse, delta, dk, dv, B, S, H,
                                  K, causal, scale, s);
  if (dtype == 0 && Dh == 64)
    return launch_dkv<float, 64>(q, k, v, dO, lse, delta, dk, dv, B, S, H,
                                 K, causal, scale, s);
  if (dtype == 1 && Dh == 128)
    return launch_dkv<bf16, 128>(q, k, v, dO, lse, delta, dk, dv, B, S, H,
                                 K, causal, scale, s);
  if (dtype == 1 && Dh == 64)
    return launch_dkv<bf16, 64>(q, k, v, dO, lse, delta, dk, dv, B, S, H, K,
                                causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
