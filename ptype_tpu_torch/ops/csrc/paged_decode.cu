// Paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ptype_tpu/ops/paged_attention.py
// (_paged_kernel, launched by paged_attention): decode attention (one
// query token per sequence) through per-sequence block tables, keys
// attended while position <= pos.
//
// What bounds it on an H100: bytes. Each row reads 2 (pos+1) Kh Dh
// elements of K and V once and does two multiply-adds per element and
// query head, far under the card's ~295 flop/byte balance point. With
// G = H/Kh = 1 (optimus-125m) a tensor core would have one useful row,
// so the kernel runs on CUDA cores. A decode step reads a few MB per
// layer, which the card moves in microseconds only if every SM keeps
// many loads in flight: what limits a kernel here is bytes in flight and
// the length of its chain of dependent steps, not arithmetic.
//
// What the design does about it (split-K, "flash-decoding"):
// - each row's live pages are split across CTAs: the grid is
//   (split, kv head, row); a CTA's W warps each take one unit of `ppw`
//   consecutive pages. The launcher picks ppw from nb, B and Kh: one page
//   a warp, or more only while the grid would still fill two waves of the
//   card's SMs. Units that start past the row's live pages (pos is read
//   on the device: no host sync) exit at once;
// - a warp reads a page in chunks of 16 tokens (8 when one row fills the
//   warp's 16-byte loads, f32 at Dh=128, or when the group has 8 heads,
//   to keep them in registers): it issues every 16-byte load of
//   the chunk's K and V rows into registers before their first use,
//   computes the chunk's scores for the G query heads of the group, then
//   makes one online-softmax update per head and chunk. K and V are read
//   once per GQA group, in the bank's native (n_blocks, bt, Kh, Dh) layout,
//   and the block tables by the kernel itself (the TPU kernel transposed
//   the whole bank layer first, a Mosaic tiling workaround that here would
//   copy the bank every layer of every step);
// - each unit writes its partial (m, l, acc[G][Dh]), f32, to a workspace
//   the wrapper allocates; a combine kernel on the same stream merges a
//   row's live units in unit order, so the result does not depend on which
//   CTA finished first and is the same bit for bit from call to call. Rows
//   that attend nothing give zeros, as the TPU kernel's guard did.
//
// C interface (bound with ctypes): paged_decode_workspace(...) gives the
// workspace's size in bytes; paged_decode(...) enqueues both kernels on
// the given stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int W = 4;  // warps of a split CTA
constexpr int MAXG = 8;
constexpr float NEG = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// The 16 bytes `v` as 4 floats, or as 8 bf16 values widened to f32.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& v, float* out);
template <>
__device__ __forceinline__ void unpack<float>(const uint4& v, float* out) {
  out[0] = __uint_as_float(v.x);
  out[1] = __uint_as_float(v.y);
  out[2] = __uint_as_float(v.z);
  out[3] = __uint_as_float(v.w);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& v,
                                                      float* out) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__host__ __device__ constexpr int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// Live pages of a row at position p: through the page of p, at least one
// (a row with p < 0 attends nothing and gives zeros), at most nb.
__device__ __forceinline__ int live_pages(int p, int bt, int nb) {
  return min((p >= 0 ? p / bt : 0) + 1, nb);
}

// Workspace: acc [B][Kh][U][G][DH], then (m, l) [B][Kh][U][G][2], for U
// units a (row, kv head).
template <typename T, int DH, int GM>
__global__ void __launch_bounds__(W * 32)
paged_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                          const T* __restrict__ vc,
                          const int* __restrict__ tables,
                          const int* __restrict__ pos, float* __restrict__ ws,
                          int H, int Kh, int bt, int nb, int ppw,
                          float scale) {
  constexpr int VEC = 16 / sizeof(T);  // elements in one 16-byte load
  constexpr int LPR = DH / VEC;        // lanes that cover one row
  constexpr int RPW = 32 / LPR;        // rows one warp load covers
  static_assert(LPR <= 32 && 32 % LPR == 0, "unsupported head_dim");
  // Warp loads of K (and of V) a chunk: 16 tokens, or 8 where a row fills
  // the warp's loads or the group has 8 heads, so that the chunk's loads
  // and scores stay in registers.
  constexpr int NLD0 = (RPW == 1 ? 8 : 16) / RPW;
  constexpr int NLD = NLD0 < 32 / GM ? NLD0 : 32 / GM;
  constexpr int CT = NLD * RPW;  // tokens of a chunk

  const int kh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int unit = blockIdx.x * W + warp;
  const int p = pos[b];
  const int pg0 = unit * ppw;
  const int pg1 = min(pg0 + ppw, live_pages(p, bt, nb));
  if (pg0 >= pg1) return;  // past the row's live pages

  const int G = H / Kh;
  const int sub = lane / LPR;          // row of a warp load
  const int col = (lane % LPR) * VEC;  // first dim this lane holds
  const float sl2 = scale * kLog2e;    // scores in log2 units

  float qv[GM][VEC], acc[GM][VEC], m[GM], l[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = NEG;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) qv[g][e] = acc[g][e] = 0.f;
    if (g < G) {
      unpack<T>(load16(q + ((size_t)b * H + (size_t)kh * G + g) * DH + col),
                qv[g]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) qv[g][e] *= sl2;
    }
  }

  const size_t tok_stride = (size_t)Kh * DH;
  for (int pg = pg0; pg < pg1; ++pg) {
    const size_t base =
        ((size_t)tables[(size_t)b * nb + pg] * bt * Kh + kh) * DH + col;
    for (int t0 = 0; t0 < bt; t0 += CT) {
      // Every load of the chunk in flight before the first use.
      uint4 kr[NLD], vr[NLD];
      bool valid[NLD];
#pragma unroll
      for (int s = 0; s < NLD; ++s) {
        const int t = t0 + s * RPW + sub;
        valid[s] = t < bt && pg * bt + t <= p;
        kr[s] = vr[s] = make_uint4(0, 0, 0, 0);
        if (t < bt) {
          kr[s] = load16(kc + base + t * tok_stride);
          vr[s] = load16(vc + base + t * tok_stride);
        }
      }
      // Scores of the chunk's tokens for each head: each lane group sums
      // its row; one K row widened at a time.
      float sc[GM][NLD];
#pragma unroll
      for (int s = 0; s < NLD; ++s) {
        float kf[VEC];
        unpack<T>(kr[s], kf);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) d = fmaf(qv[g][e], kf[e], d);
#pragma unroll
          for (int off = LPR / 2; off > 0; off /= 2)
            d += __shfl_xor_sync(FULL, d, off);
          sc[g][s] = valid[s] ? d : NEG;
        }
      }
      // One online-softmax update a head and chunk; m is the same in every
      // lane, l and acc are each lane group's share of its tokens.
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float mx = sc[g][0];
#pragma unroll
        for (int s = 1; s < NLD; ++s) mx = fmaxf(mx, sc[g][s]);
#pragma unroll
        for (int off = LPR; off < 32; off *= 2)
          mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
        const float m_new = fmaxf(m[g], mx);
        const float alpha = exp2f(m[g] - m_new);
        m[g] = m_new;
        l[g] *= alpha;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] *= alpha;
#pragma unroll
        for (int s = 0; s < NLD; ++s) {
          sc[g][s] = valid[s] ? exp2f(sc[g][s] - m_new) : 0.f;
          l[g] += sc[g][s];
        }
      }
#pragma unroll
      for (int s = 0; s < NLD; ++s) {
        float vf[VEC];
        unpack<T>(vr[s], vf);
#pragma unroll
        for (int g = 0; g < GM; ++g)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[g][e] = fmaf(sc[g][s], vf[e], acc[g][e]);
      }
    }
  }

  // Sum the lane groups' shares and write the unit's partial.
  const int U = gridDim.x * W;
  const size_t rec = ((size_t)b * Kh + kh) * U + unit;
  float* ws_acc = ws + rec * G * DH;
  float* ws_ml = ws + (size_t)gridDim.z * Kh * U * G * DH + rec * G * 2;
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g >= G) break;
#pragma unroll
    for (int off = LPR; off < 32; off *= 2) {
      l[g] += __shfl_xor_sync(FULL, l[g], off);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc[g][e] += __shfl_xor_sync(FULL, acc[g][e], off);
    }
    if (sub == 0) {
#pragma unroll
      for (int e = 0; e < VEC; e += 4)
        *reinterpret_cast<float4*>(ws_acc + g * DH + col + e) =
            make_float4(acc[g][e], acc[g][e + 1], acc[g][e + 2],
                        acc[g][e + 3]);
    }
    if (lane == 0) {
      ws_ml[2 * g] = m[g];
      ws_ml[2 * g + 1] = l[g];
    }
  }
}

// One CTA per (kv head, row), one thread per output element (G DH of
// them): merge the row's live units in unit order. The loop is unrolled
// so that the loads of several units are in flight at once; the sums run
// in the same order every call.
template <typename T, int DH>
__global__ void __launch_bounds__(MAXG * DH)
paged_decode_combine_kernel(const float* __restrict__ ws,
                            const int* __restrict__ pos, T* __restrict__ out,
                            int H, int Kh, int bt, int nb, int ppw, int U) {
  const int kh = blockIdx.x, b = blockIdx.y;
  const int G = H / Kh;
  const int g = threadIdx.x / DH, d = threadIdx.x % DH;
  const int n_units = ceil_div(live_pages(pos[b], bt, nb), ppw);
  const size_t rec = ((size_t)b * Kh + kh) * U;
  const float* acc = ws + rec * G * DH + g * DH + d;
  const float* ml = ws + (size_t)gridDim.y * Kh * U * G * DH + rec * G * 2 +
                    2 * g;
  float M = NEG, L = 0.f, O = 0.f;
#pragma unroll 8
  for (int u = 0; u < n_units; ++u) {
    const float mu = ml[u * G * 2], lu = ml[u * G * 2 + 1];
    const float au = acc[(size_t)u * G * DH];
    const float mn = fmaxf(M, mu);
    const float a = exp2f(M - mn), c = exp2f(mu - mn);
    L = L * a + lu * c;
    O = O * a + au * c;
    M = mn;
  }
  // l == 0 (nothing attended) writes zeros, as the TPU kernel's guard did.
  store(out + ((size_t)b * H + (size_t)kh * G + g) * DH + d,
        L == 0.f ? 0.f : O / L);
}

struct Split {
  int ppw;      // pages a warp takes
  int n_split;  // CTAs a (row, kv head)
};

// One page a warp, doubled only while the grid of a doubled split still
// fills two waves of the SMs (a wave: every SM full of split CTAs, by
// threads). The grid counts nb pages a row: pos stays on the device.
Split split_of(int B, int Kh, int nb) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long wave = (long long)sms * (2048 / (32 * W));
  int ppw = 1;
  while (ppw < nb &&
         (long long)B * Kh * ceil_div(nb, 2 * ppw * W) >= 2 * wave)
    ppw *= 2;
  return {ppw, ceil_div(ceil_div(nb, ppw), W)};
}

template <typename T, int DH, int GM>
int launch(const void* q, const void* kc, const void* vc, const int* tables,
           const int* pos, void* out, float* ws, int B, int H, int Kh,
           int bt, int nb, float scale, cudaStream_t stream) {
  const Split sp = split_of(B, Kh, nb);
  paged_decode_split_kernel<T, DH, GM>
      <<<dim3(sp.n_split, Kh, B), W * 32, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(kc),
          static_cast<const T*>(vc), tables, pos, ws, H, Kh, bt, nb, sp.ppw,
          scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  paged_decode_combine_kernel<T, DH>
      <<<dim3(Kh, B), (H / Kh) * DH, 0, stream>>>(
          ws, pos, static_cast<T*>(out), H, Kh, bt, nb, sp.ppw,
          sp.n_split * W);
  return (int)cudaGetLastError();
}

// The registers a warp holds for its query heads follow GM, the group
// size rounded up to a power of two.
template <typename T, int DH>
int launch_g(const void* q, const void* kc, const void* vc, const int* tables,
             const int* pos, void* out, float* ws, int B, int H, int Kh,
             int bt, int nb, float scale, cudaStream_t stream) {
  const int G = H / Kh;
  if (G == 1)
    return launch<T, DH, 1>(q, kc, vc, tables, pos, out, ws, B, H, Kh, bt,
                            nb, scale, stream);
  if (G == 2)
    return launch<T, DH, 2>(q, kc, vc, tables, pos, out, ws, B, H, Kh, bt,
                            nb, scale, stream);
  if (G <= 4)
    return launch<T, DH, 4>(q, kc, vc, tables, pos, out, ws, B, H, Kh, bt,
                            nb, scale, stream);
  return launch<T, DH, MAXG>(q, kc, vc, tables, pos, out, ws, B, H, Kh, bt,
                             nb, scale, stream);
}

}  // namespace

extern "C" {

// Bytes of the f32 workspace paged_decode needs for these shapes.
long long paged_decode_workspace(int B, int H, int Kh, int Dh, int nb) {
  const Split sp = split_of(B, Kh, nb);
  return (long long)B * H * sp.n_split * W * (Dh + 2) * sizeof(float);
}

// dtype: 0 = float32, 1 = bfloat16. Shapes: q (B, 1, H, Dh); kc, vc
// (n_blocks, bt, Kh, Dh); tables (B, nb) int32; pos (B,) int32;
// out (B, 1, H, Dh); ws paged_decode_workspace(...) bytes. All contiguous.
int paged_decode(const void* q, const void* kc, const void* vc,
                 const int* tables, const int* pos, void* out, void* ws,
                 int B, int H, int Kh, int Dh, int bt, int nb, int dtype,
                 float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  if (Kh <= 0 || H % Kh != 0 || H / Kh > MAXG || bt <= 0 || nb <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && Dh == 128)
    return launch_g<float, 128>(q, kc, vc, tables, pos, out, w, B, H, Kh, bt,
                                nb, scale, s);
  if (dtype == 0 && Dh == 64)
    return launch_g<float, 64>(q, kc, vc, tables, pos, out, w, B, H, Kh, bt,
                               nb, scale, s);
  if (dtype == 1 && Dh == 128)
    return launch_g<__nv_bfloat16, 128>(q, kc, vc, tables, pos, out, w, B, H,
                                        Kh, bt, nb, scale, s);
  if (dtype == 1 && Dh == 64)
    return launch_g<__nv_bfloat16, 64>(q, kc, vc, tables, pos, out, w, B, H,
                                       Kh, bt, nb, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
