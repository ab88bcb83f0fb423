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
// flop/byte balance point. At the optimus-125m shapes (S = 512 and 1024,
// Dh = 128) reading and writing those once bounds it (bytes), with the
// bf16 tensor-core rate (989 TFLOP/s dense) close behind; above S of
// about 1200, or sooner with GQA, the tensor cores bound it. Either way
// what the kernel takes is set by how well it keeps the tensor cores fed
// and its loads in flight.
//
// What the bf16 design does about it:
// - one block per (q tile of 128 rows, head, batch row): two consumer
//   warpgroups of 64 query rows each and one producer warpgroup, whose
//   registers move to the consumers with setmaxnreg;
// - the producer loads the Q tile once and streams K and V tiles of 128
//   rows through a ring of two shared-memory stages with TMA, signalled
//   by full and empty mbarriers, so loads overlap the products;
// - q, k and v are read in their (B, S, H|K, Dh) layout through 4-D
//   tensor maps (Dh, heads, S, B) with the 128-byte swizzle: no
//   head-major copies; positions past S arrive as zeros;
// - S = Q K^T runs on wgmma with both operands in shared memory (K is
//   K-major); the online softmax works on the accumulator fragment in
//   registers (quad shuffles for the row max, exp2 with the scale folded
//   into log2 e), masking only diagonal and ragged tiles;
// - P is rounded to bf16 in registers and is the register A operand of
//   O += P V, with V the MN-major shared-memory B operand; O stays in
//   registers for the whole K/V loop and is rescaled there;
// - the epilogue normalises O, stages it through the block's own Q tile
//   in shared memory and writes 16-byte rows; the (B, H, S) f32 LSE only
//   when asked for;
// - causal blocks stop at the diagonal tile, and the grid is walked from
//   the last q tile to the first so the longest blocks start first. The
//   q tile stays at 128 rows on small grids too: at the serving prefill
//   (96 blocks for 132 SMs) 64-row tiles with one consumer warpgroup took
//   twice as long on an H100, since one warpgroup a block cannot hide its
//   own softmax and load waits.
//
// The f32 variant exists so that the CPU's f32 parity runs can be
// repeated on the card; no main path runs it. It stays simple scalar
// code: one block of 4 warps per (q tile of 64 rows, head, batch row),
// each warp owning 16 rows, scores and output in shared memory.
//
// C interface (bound with ctypes): flash_fwd(...) enqueues on the given
// stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

// ------------------------------------------------------ bf16: TMA + wgmma

constexpr int TBK = 128;  // K/V rows of a stage
constexpr int TST = 2;    // stages in the K/V ring

template <int DH>
struct Tma {
  static constexpr int NC = 2;                  // consumer warpgroups
  static constexpr int BQ = 64 * NC;
  static constexpr int NSUB = DH / 64;          // 64-column slabs of a row
  static constexpr int Q_BYTES = NC * NSUB * SLAB;  // [warpgroup][slab]
  static constexpr int KV_SLAB = TBK * 128;     // one slab of a K/V stage
  static constexpr int KV_BYTES = NSUB * KV_SLAB;
  static constexpr int q_off = 0;
  static constexpr int k_off = Q_BYTES;
  static constexpr int v_off = k_off + TST * KV_BYTES;
  static constexpr int bar_off = v_off + TST * KV_BYTES;
  static constexpr int alloc = bar_off + 8 * (1 + 2 * TST) + 1024;
  static constexpr int threads = 128 * (NC + 1);
};

template <int DH>
__global__ void __launch_bounds__(Tma<DH>::threads, 1)
flash_fwd_kernel_bf16(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      bf16* __restrict__ o, float* __restrict__ lse, int S,
                      int H, int K, int causal, float scale) {
  using L = Tma<DH>;
  constexpr int NC = L::NC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + TST;

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / K);
  const int q0 = qt * L::BQ;
  int n_kv = (S + TBK - 1) / TBK;
  if (causal) n_kv = min(n_kv, (min(q0 + L::BQ, S) - 1) / TBK + 1);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < TST; ++s) {
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
      mbar_arrive_tx(qbar, L::Q_BYTES);
      for (int c = 0; c < NC; ++c)
        for (int sub = 0; sub < L::NSUB; ++sub)
          tma_load_4d(smem + L::q_off + (c * L::NSUB + sub) * SLAB, &tq, qbar,
                      sub * 64, h, q0 + 64 * c, b);
      for (int j = 0; j < n_kv; ++j) {
        const int st = j % TST;
        mbar_wait(&empty[st], ((j / TST) & 1) ^ 1);
        mbar_arrive_tx(&full[st], 2 * L::KV_BYTES);
        for (int sub = 0; sub < L::NSUB; ++sub) {
          tma_load_4d(smem + L::k_off + st * L::KV_BYTES + sub * L::KV_SLAB,
                      &tk, &full[st], sub * 64, kvh, j * TBK, b);
          tma_load_4d(smem + L::v_off + st * L::KV_BYTES + sub * L::KV_SLAB,
                      &tv, &full[st], sub * 64, kvh, j * TBK, b);
        }
      }
    }
  } else {
    // Consumer warpgroup wg: query rows q0 + 64 wg ... + 63.
    reg_alloc<240>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int qd = lane % 4;
    const int r_lo = 16 * warp + lane / 4;  // rows r_lo and r_lo + 8
    const int row0 = q0 + 64 * wg + r_lo;
    unsigned char* sq = smem + L::q_off + wg * L::NSUB * SLAB;
    const float sl2 = scale * kLog2e;

    float acc[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    mbar_wait(qbar, 0);
    for (int j = 0; j < n_kv; ++j) {
      const int st = j % TST, k0 = j * TBK;
      mbar_wait(&full[st], (j / TST) & 1);
      const unsigned char* sk = smem + L::k_off + st * L::KV_BYTES;
      const unsigned char* sv = smem + L::v_off + st * L::KV_BYTES;

      // S = Q K^T (raw scores) for the warpgroup's 64 rows.
      float s[TBK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        wgmma_ss<TBK>(s, desc_k(sq + (kk / 4) * SLAB + (kk % 4) * 32),
                      desc_k(sk + (kk / 4) * L::KV_SLAB + (kk % 4) * 32),
                      kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      if ((causal && k0 + TBK - 1 > q0 + 64 * wg) || k0 + TBK > S) {
#pragma unroll
        for (int jj = 0; jj < TBK / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + 8 * jj + 2 * qd + (e & 1);
            const int row = row0 + 8 * (e >> 1);
            if (col >= S || (causal && col > row)) s[4 * jj + e] = -INFINITY;
          }
      }

      // Online softmax on the fragment: each row lives in one quad.
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int jj = 0; jj < TBK / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * jj + e]);
      float base[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
        base[i] = mx[i] == -INFINITY ? 0.f : mx[i] * sl2;
        alpha[i] = exp2f(m[i] * sl2 - base[i]);
        m[i] = mx[i];
      }
#pragma unroll
      for (int jj = 0; jj < TBK / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(fmaf(s[4 * jj + e], sl2, -base[e >> 1]));
          s[4 * jj + e] = p;
          sum[e >> 1] += p;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];
#pragma unroll
      for (int jj = 0; jj < DH / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * jj + e] *= alpha[e >> 1];

      // O += P V, P in registers as bf16.
      uint32_t pa[TBK / 16][4];
      to_a_operand(s, pa);
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TBK / 16; ++kk)
        wgmma_rs<DH>(acc, pa[kk], desc_mn(sv + kk * 2048, L::KV_SLAB));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[st]);
    }

    // Normalise; stage O in the warpgroup's Q tile (64 rows x DH, 16-byte
    // chunks swizzled by row) and write whole rows.
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(FULL, l[i], 1);
      l[i] += __shfl_xor_sync(FULL, l[i], 2);
      inv[i] = l[i] == 0.f ? 0.f : 1.f / l[i];
    }
    bf16* so = reinterpret_cast<bf16*>(sq);
    fence_proxy_async();
#pragma unroll
    for (int jj = 0; jj < DH / 8; ++jj)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = r_lo + 8 * i;
        *reinterpret_cast<uint32_t*>(so + r * DH + (jj ^ (r & 7)) * 8 +
                                     2 * qd) =
            pack_bf16(acc[4 * jj + 2 * i] * inv[i],
                      acc[4 * jj + 2 * i + 1] * inv[i]);
      }
    warpgroup_sync(1 + wg);
    constexpr int CPR = DH / 8;  // 16-byte chunks of a row
    for (int idx = tid; idx < 64 * CPR; idx += 128) {
      const int r = idx / CPR, c = idx % CPR, row = q0 + 64 * wg + r;
      if (row < S)
        *reinterpret_cast<uint4*>(o + (((size_t)b * S + row) * H + h) * DH +
                                  c * 8) =
            *reinterpret_cast<const uint4*>(so + r * DH + (c ^ (r & 7)) * 8);
    }
    if (lse != nullptr && qd == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + 8 * i;
        if (row < S)
          lse[((size_t)b * H + h) * S + row] =
              m[i] * scale + logf(l[i] == 0.f ? 1.f : l[i]);
      }
    }
  }
}

template <int DH>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int S, int H, int K, int causal,
                float scale, cudaStream_t stream) {
  using L = Tma<DH>;
  CUtensorMap tq, tk, tv;
  int e = make_map(&tq, q, B, S, H, DH, 64);
  if (!e) e = make_map(&tk, k, B, S, K, DH, TBK);
  if (!e) e = make_map(&tv, v, B, S, K, DH, TBK);
  static bool attr_set = false;
  if (!e) e = allow_smem(flash_fwd_kernel_bf16<DH>, L::alloc, &attr_set);
  if (e) return e;
  const dim3 grid((S + L::BQ - 1) / L::BQ, H, B);
  flash_fwd_kernel_bf16<DH><<<grid, L::threads, L::alloc, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), lse, S, H, K, causal, scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------- f32: scalar code

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NWARP = 4;
constexpr int NT = NWARP * 32;
constexpr float NEG = -1e30f;

template <int DH>
struct Layout {
  static constexpr int LDT = DH + 4;  // q/k/v tile row
  static constexpr int LDS = BK + 4;  // scores row
  static constexpr int LDO = DH + 4;  // output row
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + sizeof(float) * BQ * LDT;
  static constexpr size_t v_off = k_off + sizeof(float) * BK * LDT;
  static constexpr size_t s_off = v_off + sizeof(float) * BK * LDT;
  static constexpr size_t o_off = s_off + sizeof(float) * BQ * LDS;
  static constexpr size_t m_off = o_off + sizeof(float) * BQ * LDO;
  static constexpr size_t l_off = m_off + sizeof(float) * BQ;
  static constexpr size_t a_off = l_off + sizeof(float) * BQ;
  static constexpr size_t bytes = a_off + sizeof(float) * BQ;
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

template <int DH>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int S, int H, int K, int causal,
                     float scale) {
  using Lay = Layout<DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem + Lay::q_off);
  float* sK = reinterpret_cast<float*>(smem + Lay::k_off);
  float* sV = reinterpret_cast<float*>(smem + Lay::v_off);
  float* sS = reinterpret_cast<float*>(smem + Lay::s_off);
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

  load_tile<DH, Lay::LDT>(sQ, q, b, q0, BQ, S, H, h);
  for (int rr = 0; rr < 16; ++rr) {
    for (int d = lane; d < DH; d += 32) sO[(r0 + rr) * Lay::LDO + d] = 0.f;
    if (lane == 0) { sM[r0 + rr] = NEG; sL[r0 + rr] = 0.f; }
  }
  __syncthreads();

  int n_kv = (S + BK - 1) / BK;
  if (causal) {
    const int last = (min(q0 + BQ, S) - 1) / BK + 1;
    n_kv = min(n_kv, last);
  }

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<DH, Lay::LDT>(sK, k, b, k0, BK, S, K, kvh);
    load_tile<DH, Lay::LDT>(sV, v, b, k0, BK, S, K, kvh);
    __syncthreads();

    // S = Q K^T for the warp's 16 rows.
    for (int rr = 0; rr < 16; ++rr) {
      const float* qr = sQ + (r0 + rr) * Lay::LDT;
      for (int c = lane; c < BK; c += 32) {
        const float* kr = sK + c * Lay::LDT;
        float s = 0.f;
#pragma unroll 8
        for (int d = 0; d < DH; ++d) s += qr[d] * kr[d];
        sS[(r0 + rr) * Lay::LDS + c] = s;
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
    for (int rr = 0; rr < 16; ++rr) {
      const float* pr = sS + (r0 + rr) * Lay::LDS;
      for (int d = lane; d < DH; d += 32) {
        float acc = sO[(r0 + rr) * Lay::LDO + d];
#pragma unroll 8
        for (int c = 0; c < BK; ++c) acc += pr[c] * sV[c * Lay::LDT + d];
        sO[(r0 + rr) * Lay::LDO + d] = acc;
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
    float* dst = o + (((size_t)b * S + row) * H + h) * DH;
    for (int d = lane; d < DH; d += 32) dst[d] = sO[r * Lay::LDO + d] / l_safe;
    if (lse != nullptr && lane == 0)
      lse[((size_t)b * H + h) * S + row] = sM[r] + logf(l_safe);
  }
}

template <int DH>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int S, int H, int K, int causal,
               float scale, cudaStream_t stream) {
  using Lay = Layout<DH>;
  static bool attr_set = false;
  const int e = allow_smem(flash_fwd_kernel_f32<DH>, (int)Lay::bytes,
                           &attr_set);
  if (e) return e;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel_f32<DH><<<grid, NT, Lay::bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, H, K,
      causal, scale);
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
    return launch_f32<128>(q, k, v, o, lse, B, S, H, K, causal, scale, s);
  if (dtype == 0 && Dh == 64)
    return launch_f32<64>(q, k, v, o, lse, B, S, H, K, causal, scale, s);
  if (dtype == 1 && Dh == 128)
    return launch_bf16<128>(q, k, v, o, lse, B, S, H, K, causal, scale, s);
  if (dtype == 1 && Dh == 64)
    return launch_bf16<64>(q, k, v, o, lse, B, S, H, K, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
