// Paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ptype_tpu/ops/paged_attention.py
// (_paged_kernel, launched by paged_attention): decode attention (one
// query token per sequence) through per-sequence block tables, online
// softmax over the table's slots, keys attended while position <= pos.
//
// What bounds it on an H100: bytes. Each row reads 2*(pos+1)*Kh*Dh
// elements of K and V once and does two multiply-adds per element
// read, far under the card's ~295 flop/byte balance point. With
// G = H/Kh = 1 (optimus-125m) a tensor core would have one useful row,
// so this kernel uses none.
//
// What the design does about it:
// - it reads the bank in its native (n_blocks, bt, Kh, Dh) layout, each
//   lane loading 16 contiguous bytes of a K or V row, so a warp load is
//   one or more whole 128-byte lines (the TPU kernel transposed the whole
//   bank layer first, a Mosaic tiling workaround that on this card would
//   copy the bank every layer of every step);
// - a block reads tables[b, i] itself (no scalar prefetch) and visits
//   only the live slots i < ceil((pos+1)/bt), where the TPU grid walked
//   all nb slots and skipped dead ones;
// - one block per (kv head, sequence); its WARPS warps take the live
//   slots round robin, each keeping its own online-softmax state in
//   registers for the G query heads of the group, and the block merges
//   the warps' partial (m, l, acc) in shared memory at the end;
// - the G query heads sharing a kv head are rows of the same pass, so
//   K and V are read once per group (GQA), never repeated per head.
//
// C interface (bound with ctypes): paged_decode(...) enqueues on the
// given stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int MAXG = 8;
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int DH>
__global__ void __launch_bounds__(WARPS * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc,
                    const int* __restrict__ tables,
                    const int* __restrict__ pos, T* __restrict__ out,
                    int H, int Kh, int bt, int nb, float scale) {
  constexpr int VEC = 16 / sizeof(T);  // elements in one 16-byte load
  constexpr int LPR = DH / VEC;        // lanes that cover one row
  constexpr int RPW = 32 / LPR;        // rows one warp load covers
  static_assert(LPR <= 32 && 32 % LPR == 0, "unsupported head_dim");

  __shared__ float sm_m[WARPS][MAXG];
  __shared__ float sm_l[WARPS][MAXG];
  __shared__ float sm_acc[WARPS][MAXG][DH];

  const int kh = blockIdx.x, b = blockIdx.y;
  const int G = H / Kh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane / LPR;          // row of the warp load
  const int col = (lane % LPR) * VEC;  // first dim this lane holds

  float qv[MAXG][VEC], acc[MAXG][VEC], m[MAXG], l[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = NEG;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) { qv[g][e] = 0.f; acc[g][e] = 0.f; }
    if (g < G) {
      load16(q + ((size_t)b * H + (size_t)kh * G + g) * DH + col, qv[g]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) qv[g][e] *= scale;
    }
  }

  const int p = pos[b];
  int n_live = (p >= 0 ? p / bt : 0) + 1;
  if (n_live > nb) n_live = nb;
  const size_t tok_stride = (size_t)Kh * DH;

  for (int i = warp; i < n_live; i += WARPS) {
    const int blk = tables[(size_t)b * nb + i];
    const size_t base = ((size_t)blk * bt * Kh + kh) * DH + col;
#pragma unroll 2
    for (int t0 = 0; t0 < bt; t0 += RPW) {
      const int t = t0 + sub;
      const bool valid = t < bt && i * bt + t <= p;
      float kv[VEC], vv[VEC];
      if (t < bt) {
        load16(kc + base + t * tok_stride, kv);
        load16(vc + base + t * tok_stride, vv);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) { kv[e] = 0.f; vv[e] = 0.f; }
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g >= G) break;
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) s += qv[g][e] * kv[e];
#pragma unroll
        for (int off = LPR / 2; off > 0; off /= 2)
          s += __shfl_xor_sync(FULL, s, off);
        s = valid ? s : NEG;
        float mx = s;
#pragma unroll
        for (int off = LPR; off < 32; off *= 2)
          mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
        const float m_new = fmaxf(m[g], mx);
        const float alpha = __expf(m[g] - m_new);
        const float pr = valid ? __expf(s - m_new) : 0.f;
        float psum = pr;
#pragma unroll
        for (int off = LPR; off < 32; off *= 2)
          psum += __shfl_xor_sync(FULL, psum, off);
        l[g] = l[g] * alpha + psum;
        m[g] = m_new;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] = acc[g][e] * alpha + pr * vv[e];
      }
    }
  }

  // Sum the rows of the warp loads: every lane group holds a partial acc
  // over its own tokens, all under the warp's shared running max.
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g >= G) break;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
#pragma unroll
      for (int off = LPR; off < 32; off *= 2)
        acc[g][e] += __shfl_xor_sync(FULL, acc[g][e], off);
    }
    if (sub == 0) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) sm_acc[warp][g][col + e] = acc[g][e];
    }
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
  }
  __syncthreads();

  // Merge the warps' partial softmax states; l == 0 (nothing attended)
  // writes zeros, as the TPU kernel's guard did.
  for (int idx = threadIdx.x; idx < G * DH; idx += WARPS * 32) {
    const int g = idx / DH, d = idx % DH;
    float M = NEG;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, sm_m[w][g]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = __expf(sm_m[w][g] - M);
      L += sm_l[w][g] * f;
      O += sm_acc[w][g][d] * f;
    }
    store(out + ((size_t)b * H + (size_t)kh * G + g) * DH + d,
          L == 0.f ? 0.f : O / L);
  }
}

template <typename T, int DH>
void launch(const void* q, const void* kc, const void* vc,
            const int* tables, const int* pos, void* out, int B, int H,
            int Kh, int bt, int nb, float scale, cudaStream_t stream) {
  paged_decode_kernel<T, DH><<<dim3(Kh, B), WARPS * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), tables, pos, static_cast<T*>(out), H, Kh,
      bt, nb, scale);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Shapes: q (B, 1, H, Dh); kc, vc
// (n_blocks, bt, Kh, Dh); tables (B, nb) int32; pos (B,) int32;
// out (B, 1, H, Dh). All contiguous.
int paged_decode(const void* q, const void* kc, const void* vc,
                 const int* tables, const int* pos, void* out, int B,
                 int H, int Kh, int Dh, int bt, int nb, int dtype,
                 float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H % Kh != 0 || H / Kh > MAXG) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && Dh == 128)
    launch<float, 128>(q, kc, vc, tables, pos, out, B, H, Kh, bt, nb, scale, s);
  else if (dtype == 0 && Dh == 64)
    launch<float, 64>(q, kc, vc, tables, pos, out, B, H, Kh, bt, nb, scale, s);
  else if (dtype == 1 && Dh == 128)
    launch<__nv_bfloat16, 128>(q, kc, vc, tables, pos, out, B, H, Kh, bt, nb, scale, s);
  else if (dtype == 1 && Dh == 64)
    launch<__nv_bfloat16, 64>(q, kc, vc, tables, pos, out, B, H, Kh, bt, nb, scale, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
