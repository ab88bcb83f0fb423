// Flash attention backward for Hopper (sm_90a): the dq kernel and the
// dk/dv kernel.
//
// Replace the Pallas TPU kernels of ptype_tpu/ops/flash_attention.py,
// launched by _flash_bwd:
// - flash_bwd_dq_kernel_* replace _dq_kernel: dq for one q tile, K/V tiles
//   streamed, P recomputed from the forward's LSE, dS = P (dP - delta);
// - flash_bwd_dkv_kernel_* replace _dkv_kernel: dk and dv for one kv tile
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
// onto the tensor cores. What a kernel actually takes is set by how well
// it keeps the tensor cores fed: every product on wgmma, fed by TMA loads
// that overlap the math, with nothing but the operand tiles in shared
// memory.
//
// Shared by both: the TPU grid's innermost sequential dimensions become
// loops inside the block. dq loops over K/V tiles up to the diagonal;
// dk/dv over the group's G query heads and the q tiles from the diagonal
// on, so the GQA group sum stays inside the block: no atomics, and the
// result is deterministic. Causal blocks skip every tile on the far side
// of the diagonal; dq walks its grid from the last q tile (the longest)
// to the first, and the dk/dv grid starts at kv tile 0 (the longest). All
// tensors are read and written in their (B, S, H|K, Dh) layout: no
// head-major copies. lse is the forward's plain (B, H, S) f32 row and
// delta a (B, S, H) f32 row.
//
// dq in bf16, a Hopper design (the forward's structure with one more
// product):
// - one block per (q tile of 128 rows, head, batch row): two consumer
//   warpgroups of 64 q rows each and one producer warpgroup, whose
//   registers move to the consumers with setmaxnreg;
// - the producer loads Q and dO once with TMA and streams (K, V) tiles of
//   64 rows of kv head h / (H/K) through a ring of three shared-memory
//   stages, signalled by full and empty mbarriers;
// - a q row's lse (pre-scaled by log2 e) and delta are fixed for the
//   block, so each consumer thread holds its two rows' values in
//   registers: nothing to stage;
// - per K/V tile: S = Q K^T and dP = dO V^T on wgmma with both operands in
//   shared memory (K-major); P = exp2(S scale log2 e - lse log2 e) and
//   dS = P (dP - delta) scale on the accumulator fragments, masked only
//   on diagonal and ragged tiles; dS rounded to bf16 in registers as the
//   A operand of dQ += dS K, with K the MN-major shared-memory B operand.
//   Neither S, dP nor the dQ accumulator (64 registers a thread at
//   Dh=128) touches shared memory; a warpgroup skips the products of a
//   causal tile that lies wholly past its rows;
// - the epilogue stages dQ through the warpgroup's own Q tile and writes
//   16-byte rows.
//
// dk/dv in bf16, a Hopper design:
// - one block per (kv tile of 128 rows, KV head, batch row): two consumer
//   warpgroups of 64 kv rows each and one producer warpgroup, whose
//   registers move to the consumers with setmaxnreg;
// - K and V are loaded once with TMA; the producer streams (Q, dO) tiles
//   of 64 rows through a ring of three shared-memory stages with TMA and
//   stages their lse (pre-scaled by log2 e) and delta rows beside them,
//   signalled by full and empty mbarriers;
// - every product runs on wgmma with f32 accumulators in registers, in the
//   transposed forms, so that P and dS land in registers already in the
//   layout of a wgmma A operand: S^T = K Q^T and dP^T = V dO^T with both
//   operands in shared memory (K-major), then P^T = exp2(S^T scale log2 e
//   - lse log2 e) and dS^T = P^T (dP^T - delta) scale on the fragments,
//   rounded to bf16, and dV += P^T dO, dK += dS^T Q with the register A
//   operand and dO, Q as MN-major shared-memory B operands. Neither S, dP
//   nor the dK, dV accumulators (64 + 64 registers a thread at Dh=128)
//   touch shared memory;
// - the epilogue stages dK and dV through the warpgroup's own K and V
//   tiles and writes 16-byte rows.
//
// The f32 variants exist so that the CPU's f32 parity runs can be
// repeated on the card; no main path runs them. They are simple scalar
// code: one block of 4 warps per 64-row tile, each warp owning 16 rows,
// scores in shared memory.
//
// Numerics: the bf16 kernels round P and dS to bf16 before the tensor-core
// products (the reference rounds dS, and computes dP and dV with dO in
// f32). Tolerances are stated where the kernels are checked.
//
// C interface (bound with ctypes): flash_bwd_dq(...) and flash_bwd_dkv(...)
// enqueue on the given stream and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------------- f32 tiles

constexpr int BQ = 64;  // q rows of a tile
constexpr int BK = 64;  // k rows of a tile (== BQ: score tiles are square)
constexpr int NWARP = 4;
constexpr int NT = NWARP * 32;

template <int DH>
struct Tiles {
  static constexpr int LDT = DH + 4;  // operand tile row
  static constexpr int LDS = BK + 4;  // score row
  static constexpr size_t tile = sizeof(float) * 64 * LDT;
  static constexpr size_t scores = sizeof(float) * 64 * LDS;
  // Four operand tiles, the S and dP tiles, the lse and delta rows.
  static constexpr size_t bytes = 4 * tile + 2 * scores + 2 * 64 * 4;
};

// Stage `rows` rows of one head into a shared tile with 16-byte loads;
// rows past the sequence end are zero-filled.
template <int DH, int LDT>
__device__ __forceinline__ void load_tile(float* tile, const float* src,
                                          int b, int row0, int rows, int S,
                                          int heads, int head) {
  constexpr int CPR = DH / 4;
  for (int idx = threadIdx.x; idx < rows * CPR; idx += NT) {
    const int r = idx / CPR, c = idx % CPR;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    const int sr = row0 + r;
    if (sr < S)
      val = *reinterpret_cast<const float4*>(
          src + (((size_t)b * S + sr) * heads + head) * DH + c * 4);
    *reinterpret_cast<float4*>(tile + r * LDT + c * 4) = val;
  }
}

// out (16 x 64, row stride ldo) = a (16 x DH) . bt^T, with a and bt
// (64 x DH) row-major tiles of row stride LDT: the warp's rows of Q K^T,
// dO V^T, K Q^T or V dO^T.
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

// ------------------------------------------------------------- dq, f32

template <int DH>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel_f32(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dO,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int S, int H, int K,
                        int causal, float scale) {
  using L = Tiles<DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sdO = reinterpret_cast<float*>(smem + L::tile);
  float* sK = reinterpret_cast<float*>(smem + 2 * L::tile);
  float* sV = reinterpret_cast<float*>(smem + 3 * L::tile);
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

  load_tile<DH, L::LDT>(sQ, q, b, q0, BQ, S, H, h);
  load_tile<DH, L::LDT>(sdO, dO, b, q0, BQ, S, H, h);
  for (int r = threadIdx.x; r < BQ; r += NT) {
    const int row = q0 + r;
    sLse[r] = row < S ? lse[((size_t)b * H + h) * S + row] : 0.f;
    sDel[r] = row < S ? delta[((size_t)b * S + row) * H + h] : 0.f;
  }

  // dQ for the warp's 16 rows: one register per (row, column lane + 32 i).
  float facc[16][DH / 32];
#pragma unroll
  for (int rr = 0; rr < 16; ++rr)
#pragma unroll
    for (int i = 0; i < DH / 32; ++i) facc[rr][i] = 0.f;

  int n_kv = (S + BK - 1) / BK;
  if (causal) n_kv = min(n_kv, (min(q0 + BQ, S) - 1) / BK + 1);

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<DH, L::LDT>(sK, k, b, k0, BK, S, K, kvh);
    load_tile<DH, L::LDT>(sV, v, b, k0, BK, S, K, kvh);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for the warp's 16 rows.
    warp_abt_f32<DH, L::LDT>(sS + r0 * L::LDS, L::LDS, sQ + r0 * L::LDT, sK);
    warp_abt_f32<DH, L::LDT>(sdP + r0 * L::LDS, L::LDS, sdO + r0 * L::LDT,
                             sV);
    __syncwarp();

    // dS = P (dP - delta) scale, P = exp(S scale - lse), in place over S,
    // one row at a time across the warp.
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr, row = q0 + r;
      const float l = sLse[r], dl = sDel[r];
#pragma unroll
      for (int e = 0; e < BK / 32; ++e) {
        const int c = lane + 32 * e, col = k0 + c;
        const bool ok = row < S && col < S && (!causal || col <= row);
        const float p = ok ? __expf(sS[r * L::LDS + c] * scale - l) : 0.f;
        sS[r * L::LDS + c] = p * (sdP[r * L::LDS + c] - dl) * scale;
      }
    }
    __syncwarp();

    // dQ += dS K for the warp's 16 rows.
#pragma unroll
    for (int rr = 0; rr < 16; ++rr) {
      const float* dsr = sS + (r0 + rr) * L::LDS;
      // Not unrolled: 64 x 16 x DH/32 unrolled FMAs tripled the build.
#pragma unroll 1
      for (int c = 0; c < BK; ++c) {
        const float w = dsr[c];
#pragma unroll
        for (int i = 0; i < DH / 32; ++i)
          facc[rr][i] += w * sK[c * L::LDT + lane + 32 * i];
      }
    }
  }

  // Write dq (B, S, H, Dh).
#pragma unroll
  for (int rr = 0; rr < 16; ++rr) {
    const int row = q0 + r0 + rr;
    if (row < S) {
      float* dst = dq + (((size_t)b * S + row) * H + h) * DH;
#pragma unroll
      for (int i = 0; i < DH / 32; ++i) dst[lane + 32 * i] = facc[rr][i];
    }
  }
}

// ------------------------------------------- bf16 epilogue (dq and dk/dv)

// Write a warpgroup's 64 x DH f32 accumulator as bf16 rows row0.. of head
// `head` of a (B, S, heads, DH) tensor, through `stage` (64 x DH bf16 of
// shared memory, 16-byte chunks swizzled by row).
template <int DH>
__device__ __forceinline__ void store_rows(const float (&acc)[DH / 2],
                                           bf16* stage, bf16* dst, int b,
                                           int row0, int S, int heads,
                                           int head, int bar_id) {
  const int tid = threadIdx.x % 128, lane = tid % 32;
  const int r_lo = 16 * (tid / 32) + lane / 4, qd = lane % 4;
  hopper::fence_proxy_async();
#pragma unroll
  for (int jj = 0; jj < DH / 8; ++jj)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r_lo + 8 * i;
      *reinterpret_cast<uint32_t*>(stage + r * DH + (jj ^ (r & 7)) * 8 +
                                   2 * qd) =
          hopper::pack_bf16(acc[4 * jj + 2 * i], acc[4 * jj + 2 * i + 1]);
    }
  hopper::warpgroup_sync(bar_id);
  constexpr int CPR = DH / 8;
  for (int idx = tid; idx < 64 * CPR; idx += 128) {
    const int r = idx / CPR, c = idx % CPR, row = row0 + r;
    if (row < S)
      *reinterpret_cast<uint4*>(dst +
                                (((size_t)b * S + row) * heads + head) * DH +
                                c * 8) =
          *reinterpret_cast<const uint4*>(stage + r * DH + (c ^ (r & 7)) * 8);
  }
}

// ---------------------------------------------- dq, bf16: TMA + wgmma

// One block per (q tile of 128 rows, head, batch row): two consumer
// warpgroups of 64 q rows each and one producer warpgroup.
template <int DH>
struct Dq {
  static constexpr int NC = 2;        // consumer warpgroups
  static constexpr int BQ = 64 * NC;  // q rows of a block
  static constexpr int BK = 64;       // kv rows of a streamed tile
  static constexpr int ST = 3;        // stages in the (K, V) ring
  static constexpr int NSUB = DH / 64;
  static constexpr int Q_BYTES = NC * NSUB * hopper::SLAB;  // [wg][slab]
  static constexpr int KV_BYTES = NSUB * hopper::SLAB;      // one stage
  static constexpr int q_off = 0;
  static constexpr int do_off = Q_BYTES;
  static constexpr int k_off = 2 * Q_BYTES;
  static constexpr int v_off = k_off + ST * KV_BYTES;
  static constexpr int bar_off = v_off + ST * KV_BYTES;
  static constexpr int alloc = bar_off + 8 * (1 + 2 * ST) + 1024;
  static constexpr int threads = 128 * (NC + 1);
};

template <int DH>
__global__ void __launch_bounds__(Dq<DH>::threads, 1)
flash_bwd_dq_kernel_bf16(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dq, int S, int H, int K,
                         int causal, float scale) {
  using namespace hopper;
  using L = Dq<DH>;
  constexpr int NC = L::NC, BK = L::BK, ST = L::ST;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + ST;

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / K);
  const int q0 = qt * L::BQ;
  int n_kv = (S + BK - 1) / BK;
  if (causal) n_kv = min(n_kv, (min(q0 + L::BQ, S) - 1) / BK + 1);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == NC) {
    // Producer: one thread issues every load.
    reg_dealloc<24>();
    if (threadIdx.x == NC * 128) {
      mbar_arrive_tx(qbar, 2 * L::Q_BYTES);
      for (int c = 0; c < NC; ++c)
        for (int sub = 0; sub < L::NSUB; ++sub) {
          const int off = (c * L::NSUB + sub) * SLAB;
          tma_load_4d(smem + L::q_off + off, &tq, qbar, sub * 64, h,
                      q0 + 64 * c, b);
          tma_load_4d(smem + L::do_off + off, &tdo, qbar, sub * 64, h,
                      q0 + 64 * c, b);
        }
      for (int j = 0; j < n_kv; ++j) {
        const int st = j % ST;
        mbar_wait(&empty[st], ((j / ST) & 1) ^ 1);
        mbar_arrive_tx(&full[st], 2 * L::KV_BYTES);
        for (int sub = 0; sub < L::NSUB; ++sub) {
          const int off = st * L::KV_BYTES + sub * SLAB;
          tma_load_4d(smem + L::k_off + off, &tk, &full[st], sub * 64, kvh,
                      j * BK, b);
          tma_load_4d(smem + L::v_off + off, &tv, &full[st], sub * 64, kvh,
                      j * BK, b);
        }
      }
    }
  } else {
    // Consumer warpgroup wg: query rows q0 + 64 wg ... + 63.
    reg_alloc<240>();
    const int tid = threadIdx.x % 128, lane = tid % 32;
    const int qd = lane % 4;
    const int row0 = q0 + 64 * wg + 16 * (tid / 32) + lane / 4;  // and + 8
    unsigned char* sq = smem + L::q_off + wg * L::NSUB * SLAB;
    const unsigned char* sdo = smem + L::do_off + wg * L::NSUB * SLAB;
    const float sl2 = scale * kLog2e;

    // The two rows' lse (in log2 units) and delta, fixed for the block.
    float lq[2], dl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      lq[i] = row < S ? lse[((size_t)b * H + h) * S + row] * kLog2e : 0.f;
      dl[i] = row < S ? delta[((size_t)b * S + row) * H + h] : 0.f;
    }
    float acc[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;

    mbar_wait(qbar, 0);
    for (int j = 0; j < n_kv; ++j) {
      const int st = j % ST, k0 = j * BK;
      mbar_wait(&full[st], (j / ST) & 1);
      // A causal tile wholly past the warpgroup's last row adds nothing.
      if (!causal || k0 <= q0 + 64 * wg + 63) {
        const unsigned char* sk = smem + L::k_off + st * L::KV_BYTES;
        const unsigned char* sv = smem + L::v_off + st * L::KV_BYTES;

        // S = Q K^T and dP = dO V^T for the warpgroup's 64 rows.
        float s[BK / 2], dp[BK / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk)
          wgmma_ss<BK>(s, desc_k(sq + (kk / 4) * SLAB + (kk % 4) * 32),
                       desc_k(sk + (kk / 4) * SLAB + (kk % 4) * 32), kk > 0);
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk)
          wgmma_ss<BK>(dp, desc_k(sdo + (kk / 4) * SLAB + (kk % 4) * 32),
                       desc_k(sv + (kk / 4) * SLAB + (kk % 4) * 32), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);

        // P = exp(S scale - lse), dS = P (dP - delta) scale, on the
        // fragments: element 4 jj + e is row row0 + 8 (e >> 1) and column
        // k0 + 8 jj + 2 qd + (e & 1).
        const bool edge =
            (causal && k0 + BK - 1 > q0 + 64 * wg) || k0 + BK > S;
#pragma unroll
        for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1, el = 4 * jj + e;
            float p = exp2f(fmaf(s[el], sl2, -lq[i]));
            if (edge) {
              const int col = k0 + 8 * jj + 2 * qd + (e & 1);
              if (col >= S || (causal && col > row0 + 8 * i)) p = 0.f;
            }
            dp[el] = p * (dp[el] - dl[i]) * scale;
          }

        // dQ += dS K, dS in registers as bf16.
        uint32_t da[BK / 16][4];
        to_a_operand(dp, da);
        fence_regs(acc);
        fence_regs(da);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs<DH>(acc, da[kk], desc_mn(sk + kk * 2048, SLAB));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
      }
      mbar_arrive(&empty[st]);
    }

    // dq through the warpgroup's own Q tile.
    store_rows<DH>(acc, reinterpret_cast<bf16*>(sq), dq, b, q0 + 64 * wg, S,
                   H, h, 1 + wg);
  }
}

// ------------------------------------------------------ dk/dv, bf16: TMA + wgmma

// One block per (kv tile of 128 rows, KV head, batch row): two consumer
// warpgroups of 64 kv rows each and one producer warpgroup.
template <int DH>
struct Dkv {
  static constexpr int NC = 2;         // consumer warpgroups
  static constexpr int BKV = 64 * NC;  // kv rows of a block
  static constexpr int BQ = 64;        // q rows of a streamed tile
  static constexpr int ST = 3;         // stages in the (Q, dO) ring
  static constexpr int NSUB = DH / 64;
  static constexpr int KV_BYTES = NC * NSUB * hopper::SLAB;  // [wg][slab]
  static constexpr int QS_BYTES = NSUB * hopper::SLAB;       // one stage
  static constexpr int k_off = 0;
  static constexpr int v_off = KV_BYTES;
  static constexpr int q_off = 2 * KV_BYTES;
  static constexpr int do_off = q_off + ST * QS_BYTES;
  static constexpr int lse_off = do_off + ST * QS_BYTES;
  static constexpr int del_off = lse_off + ST * BQ * 4;
  static constexpr int bar_off = del_off + ST * BQ * 4;
  static constexpr int alloc = bar_off + 8 * (1 + 2 * ST) + 1024;
  static constexpr int threads = 128 * (NC + 1);
};

template <int DH>
__global__ void __launch_bounds__(Dkv<DH>::threads, 1)
flash_bwd_dkv_kernel_bf16(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int S,
                          int H, int K, int causal, float scale) {
  using namespace hopper;
  using L = Dkv<DH>;
  constexpr int NC = L::NC, BQ = L::BQ, ST = L::ST;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  float* s_lse = reinterpret_cast<float*>(smem + L::lse_off);
  float* s_del = reinterpret_cast<float*>(smem + L::del_off);
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + ST;

  const int kt = blockIdx.x;  // tile 0 has the most causal q tiles
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / K;
  const int k0 = kt * L::BKV;
  const int nq = (S + BQ - 1) / BQ;
  // Causal: q tile i holds a row at or past this block's first key iff
  // (i + 1) BQ > k0, i.e. i >= k0 / BQ.
  const int i0 = causal ? k0 / BQ : 0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes
      mbar_init(&empty[s], NC * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == NC) {
    // Producer: the first warp's 32 lanes stage each tile's lse (in log2
    // units) and delta rows; its lane 0 issues the TMA loads.
    reg_dealloc<24>();
    if (threadIdx.x / 32 == NC * 4) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        mbar_arrive_tx(kvbar, 2 * L::KV_BYTES);
        for (int c = 0; c < NC; ++c)
          for (int sub = 0; sub < L::NSUB; ++sub) {
            const int off = (c * L::NSUB + sub) * SLAB;
            tma_load_4d(smem + L::k_off + off, &tk, kvbar, sub * 64, kvh,
                        k0 + 64 * c, b);
            tma_load_4d(smem + L::v_off + off, &tv, kvbar, sub * 64, kvh,
                        k0 + 64 * c, b);
          }
      }
      int it = 0;
      for (int g = 0; g < G; ++g) {
        const int h = kvh * G + g;
        for (int i = i0; i < nq; ++i, ++it) {
          const int st = it % ST, q0 = i * BQ;
          mbar_wait(&empty[st], ((it / ST) & 1) ^ 1);
          for (int r = lane; r < BQ; r += 32) {
            const int row = q0 + r;
            s_lse[st * BQ + r] =
                row < S ? lse[((size_t)b * H + h) * S + row] * kLog2e : 0.f;
            s_del[st * BQ + r] =
                row < S ? delta[((size_t)b * S + row) * H + h] : 0.f;
          }
          // Each lane arrives after its own rows are written.
          if (lane == 0) {
            mbar_arrive_tx(&full[st], 2 * L::QS_BYTES);
            for (int sub = 0; sub < L::NSUB; ++sub) {
              const int off = st * L::QS_BYTES + sub * SLAB;
              tma_load_4d(smem + L::q_off + off, &tq, &full[st], sub * 64, h,
                          q0, b);
              tma_load_4d(smem + L::do_off + off, &tdo, &full[st], sub * 64,
                          h, q0, b);
            }
          } else {
            mbar_arrive(&full[st]);
          }
        }
      }
    }
  } else {
    // Consumer warpgroup wg: kv rows k0 + 64 wg ... + 63.
    reg_alloc<240>();
    const int tid = threadIdx.x % 128, lane = tid % 32;
    const int qd = lane % 4;
    const int kr = k0 + 64 * wg + 16 * (tid / 32) + lane / 4;  // and kr + 8
    unsigned char* sk = smem + L::k_off + wg * L::NSUB * SLAB;
    unsigned char* sv = smem + L::v_off + wg * L::NSUB * SLAB;
    const float sl2 = scale * kLog2e;

    float acc_k[DH / 2], acc_v[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

    mbar_wait(kvbar, 0);
    int it = 0;
    for (int g = 0; g < G; ++g) {
      for (int i = i0; i < nq; ++i, ++it) {
        const int st = it % ST, q0 = i * BQ;
        mbar_wait(&full[st], (it / ST) & 1);
        const unsigned char* sq = smem + L::q_off + st * L::QS_BYTES;
        const unsigned char* sdo = smem + L::do_off + st * L::QS_BYTES;
        const float* tl = s_lse + st * BQ;
        const float* td = s_del + st * BQ;

        // S^T = K Q^T and dP^T = V dO^T for the warpgroup's 64 kv rows.
        float s[BQ / 2], dp[BQ / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk)
          wgmma_ss<BQ>(s, desc_k(sk + (kk / 4) * SLAB + (kk % 4) * 32),
                       desc_k(sq + (kk / 4) * SLAB + (kk % 4) * 32), kk > 0);
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk)
          wgmma_ss<BQ>(dp, desc_k(sv + (kk / 4) * SLAB + (kk % 4) * 32),
                       desc_k(sdo + (kk / 4) * SLAB + (kk % 4) * 32), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);

        // P^T = exp(S^T scale - lse), dS^T = P^T (dP^T - delta) scale, on
        // the fragments: element 4 jj + 2 i + c is kv row kr + 8 i and q
        // column 8 jj + 2 qd + c of the tile.
        const bool diag = causal && k0 + 64 * wg + 63 > q0;
#pragma unroll
        for (int jj = 0; jj < BQ / 8; ++jj)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = 8 * jj + 2 * qd + c;
            const float lq = tl[col], dl = td[col];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int e = 4 * jj + 2 * i + c;
              float p = exp2f(fmaf(s[e], sl2, -lq));
              if (diag && kr + 8 * i > q0 + col) p = 0.f;
              s[e] = p;
              dp[e] = p * (dp[e] - dl) * scale;
            }
          }

        // dV += P^T dO and dK += dS^T Q, P^T and dS^T in registers as bf16.
        uint32_t pa[BQ / 16][4], da[BQ / 16][4];
        to_a_operand(s, pa);
        to_a_operand(dp, da);
        fence_regs(acc_k);
        fence_regs(acc_v);
        fence_regs(pa);
        fence_regs(da);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          wgmma_rs<DH>(acc_v, pa[kk], desc_mn(sdo + kk * 2048, SLAB));
          wgmma_rs<DH>(acc_k, da[kk], desc_mn(sq + kk * 2048, SLAB));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc_k);
        fence_regs(acc_v);
        mbar_arrive(&empty[st]);
      }
    }

    // dk and dv through the warpgroup's own K and V tiles.
    const int row0 = k0 + 64 * wg;
    store_rows<DH>(acc_k, reinterpret_cast<bf16*>(sk), dk, b, row0, S, K, kvh,
                   1 + wg);
    store_rows<DH>(acc_v, reinterpret_cast<bf16*>(sv), dv, b, row0, S, K, kvh,
                   1 + wg);
  }
}

// --------------------------------------------------------- dk/dv, f32

template <int DH>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel_f32(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dO,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int S, int H, int K, int causal, float scale) {
  using L = Tiles<DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = reinterpret_cast<float*>(smem + L::tile);
  float* sQ = reinterpret_cast<float*>(smem + 2 * L::tile);
  float* sdO = reinterpret_cast<float*>(smem + 3 * L::tile);
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

  load_tile<DH, L::LDT>(sK, k, b, k0, BK, S, K, kvh);
  load_tile<DH, L::LDT>(sV, v, b, k0, BK, S, K, kvh);

  float fk[16][DH / 32], fv[16][DH / 32];
#pragma unroll
  for (int rr = 0; rr < 16; ++rr)
#pragma unroll
    for (int i = 0; i < DH / 32; ++i) fk[rr][i] = fv[rr][i] = 0.f;

  const int nq = (S + BQ - 1) / BQ;
  // Causal: q tile i holds a row at or past this tile's first key iff
  // (i + 1) BQ > k0, i.e. i >= k0 / BQ (BQ == BK).
  const int i0 = causal ? k0 / BQ : 0;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int i = i0; i < nq; ++i) {
      const int q0 = i * BQ;
      __syncthreads();  // every warp is done with the previous Q/dO tile
      load_tile<DH, L::LDT>(sQ, q, b, q0, BQ, S, H, h);
      load_tile<DH, L::LDT>(sdO, dO, b, q0, BQ, S, H, h);
      for (int r = threadIdx.x; r < BQ; r += NT) {
        const int row = q0 + r;
        sLse[r] = row < S ? lse[((size_t)b * H + h) * S + row] : 0.f;
        sDel[r] = row < S ? delta[((size_t)b * S + row) * H + h] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T for the warp's 16 kv rows.
      warp_abt_f32<DH, L::LDT>(sS + r0 * L::LDS, L::LDS, sK + r0 * L::LDT,
                               sQ);
      warp_abt_f32<DH, L::LDT>(sdP + r0 * L::LDS, L::LDS, sV + r0 * L::LDT,
                               sdO);
      __syncwarp();

      // P^T and dS^T in place in S and dP, one kv row at a time.
      for (int rr = 0; rr < 16; ++rr) {
        const int r = r0 + rr, kcol = k0 + r;
#pragma unroll
        for (int e = 0; e < BQ / 32; ++e) {
          const int c = lane + 32 * e, row = q0 + c;
          const bool ok = row < S && kcol < S && (!causal || kcol <= row);
          const float p =
              ok ? __expf(sS[r * L::LDS + c] * scale - sLse[c]) : 0.f;
          sS[r * L::LDS + c] = p;
          sdP[r * L::LDS + c] = p * (sdP[r * L::LDS + c] - sDel[c]) * scale;
        }
      }
      __syncwarp();

      // dV += P^T dO and dK += dS^T Q for the warp's 16 kv rows.
#pragma unroll
      for (int rr = 0; rr < 16; ++rr) {
        const float* pr = sS + (r0 + rr) * L::LDS;
        const float* dsr = sdP + (r0 + rr) * L::LDS;
#pragma unroll 1
        for (int c = 0; c < BQ; ++c) {
          const float wp = pr[c], wd = dsr[c];
#pragma unroll
          for (int i = 0; i < DH / 32; ++i) {
            fv[rr][i] += wp * sdO[c * L::LDT + lane + 32 * i];
            fk[rr][i] += wd * sQ[c * L::LDT + lane + 32 * i];
          }
        }
      }
    }
  }

  // Write dk, dv (B, S, K, Dh).
#pragma unroll
  for (int rr = 0; rr < 16; ++rr) {
    const int row = k0 + r0 + rr;
    if (row < S) {
      const size_t off = (((size_t)b * S + row) * K + kvh) * DH;
#pragma unroll
      for (int i = 0; i < DH / 32; ++i) {
        dk[off + lane + 32 * i] = fk[rr][i];
        dv[off + lane + 32 * i] = fv[rr][i];
      }
    }
  }
}

template <int DH>
int launch_dq_f32(const void* q, const void* k, const void* v, const void* dO,
                  const float* lse, const float* delta, void* dq, int B,
                  int S, int H, int K, int causal, float scale,
                  cudaStream_t stream) {
  using L = Tiles<DH>;
  static bool attr_set = false;
  const int e = hopper::allow_smem(flash_bwd_dq_kernel_f32<DH>,
                                   (int)L::bytes, &attr_set);
  if (e) return e;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_bwd_dq_kernel_f32<DH><<<grid, NT, L::bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dO), lse, delta,
      static_cast<float*>(dq), S, H, K, causal, scale);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_dq_bf16(const void* q, const void* k, const void* v,
                   const void* dO, const float* lse, const float* delta,
                   void* dq, int B, int S, int H, int K, int causal,
                   float scale, cudaStream_t stream) {
  using L = Dq<DH>;
  CUtensorMap tq, tk, tv, tdo;
  int e = hopper::make_map(&tq, q, B, S, H, DH, 64);
  if (!e) e = hopper::make_map(&tdo, dO, B, S, H, DH, 64);
  if (!e) e = hopper::make_map(&tk, k, B, S, K, DH, L::BK);
  if (!e) e = hopper::make_map(&tv, v, B, S, K, DH, L::BK);
  static bool attr_set = false;
  if (!e)
    e = hopper::allow_smem(flash_bwd_dq_kernel_bf16<DH>, L::alloc, &attr_set);
  if (e) return e;
  const dim3 grid((S + L::BQ - 1) / L::BQ, H, B);
  flash_bwd_dq_kernel_bf16<DH><<<grid, L::threads, L::alloc, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(dq), S, H, K, causal,
      scale);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_dkv_bf16(const void* q, const void* k, const void* v,
                    const void* dO, const float* lse, const float* delta,
                    void* dk, void* dv, int B, int S, int H, int K,
                    int causal, float scale, cudaStream_t stream) {
  using L = Dkv<DH>;
  CUtensorMap tq, tk, tv, tdo;
  int e = hopper::make_map(&tq, q, B, S, H, DH, L::BQ);
  if (!e) e = hopper::make_map(&tdo, dO, B, S, H, DH, L::BQ);
  if (!e) e = hopper::make_map(&tk, k, B, S, K, DH, 64);
  if (!e) e = hopper::make_map(&tv, v, B, S, K, DH, 64);
  static bool attr_set = false;
  if (!e) e = hopper::allow_smem(flash_bwd_dkv_kernel_bf16<DH>, L::alloc,
                                    &attr_set);
  if (e) return e;
  const dim3 grid((S + L::BKV - 1) / L::BKV, K, B);
  flash_bwd_dkv_kernel_bf16<DH><<<grid, L::threads, L::alloc, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), S, H, K, causal, scale);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_dkv_f32(const void* q, const void* k, const void* v,
                   const void* dO, const float* lse, const float* delta,
                   void* dk, void* dv, int B, int S, int H, int K, int causal,
                   float scale, cudaStream_t stream) {
  using L = Tiles<DH>;
  static bool attr_set = false;
  const int e = hopper::allow_smem(flash_bwd_dkv_kernel_f32<DH>,
                                   (int)L::bytes, &attr_set);
  if (e) return e;
  const dim3 grid((S + BK - 1) / BK, K, B);
  flash_bwd_dkv_kernel_f32<DH><<<grid, NT, L::bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dO), lse, delta,
      static_cast<float*>(dk), static_cast<float*>(dv), S, H, K, causal,
      scale);
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
    return launch_dq_f32<128>(q, k, v, dO, lse, delta, dq, B, S, H, K,
                              causal, scale, s);
  if (dtype == 0 && Dh == 64)
    return launch_dq_f32<64>(q, k, v, dO, lse, delta, dq, B, S, H, K,
                             causal, scale, s);
  if (dtype == 1 && Dh == 128)
    return launch_dq_bf16<128>(q, k, v, dO, lse, delta, dq, B, S, H, K,
                               causal, scale, s);
  if (dtype == 1 && Dh == 64)
    return launch_dq_bf16<64>(q, k, v, dO, lse, delta, dq, B, S, H, K,
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
    return launch_dkv_f32<128>(q, k, v, dO, lse, delta, dk, dv, B, S, H, K,
                               causal, scale, s);
  if (dtype == 0 && Dh == 64)
    return launch_dkv_f32<64>(q, k, v, dO, lse, delta, dk, dv, B, S, H, K,
                              causal, scale, s);
  if (dtype == 1 && Dh == 128)
    return launch_dkv_bf16<128>(q, k, v, dO, lse, delta, dk, dv, B, S, H, K,
                                causal, scale, s);
  if (dtype == 1 && Dh == 64)
    return launch_dkv_bf16<64>(q, k, v, dO, lse, delta, dk, dv, B, S, H, K,
                               causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
