// GQA one-token decode attention (split-K flash-decode) for sm_90a.
//
// Replaces the TPU kernel decode_attention_pallas
// (src/repro/kernels/decode_attention/decode_attention.py:78, body _kernel
// :26): q (B, H = Hkv*G, hd) attends over a (B, S, Hkv, hd) K/V cache under a
// (B, S) valid mask; online softmax in fp32; a row with nothing valid gives
// 0 (denominator clamped to 1e-20). The TPU grid walks S in order and
// carries (m, l, acc) in VMEM scratch; Hopper runs blocks in parallel with
// nothing carried between them, so S is split across blocks instead and a
// second kernel merges the splits.
//
// What bounds it: bytes. Each valid K and V row is read once (2 * hd *
// sizeof(T) bytes per position and KV head) for 4 * G * hd flops, far
// below the card's ~300 flops per byte. The design keeps every byte read
// once and in flight:
//   * one block per (S-split, KV head, batch row); the wrapper picks the
//     number of splits so that B * Hkv * splits covers the SMs at least
//     twice, so even B * Hkv = 64 streams from every SM;
//   * the block's G query heads sit in registers (lane i holds elements
//     [i*EPL, (i+1)*EPL) of each, EPL = hd / 32), so one K row load of
//     8 bytes per lane (bf16, hd 128) serves all G heads;
//   * each warp takes positions in turn, kUnroll at a time, issuing the K
//     and V loads of all kUnroll positions before using any;
//   * positions whose valid byte is 0 skip their K/V loads (the flag is
//     the same for the whole warp), so a slot with a short history reads
//     only that history;
//   * scores are warp reductions; (m, l, acc) are fp32 per head per warp,
//     merged across the block's warps through shared memory, and written
//     as fp32 partials to a workspace the wrapper allocates;
//   * decode_combine merges the splits, divides by max(l, 1e-20) and
//     writes q's dtype.
// Left for later: cp.async/TMA staging, several KV heads per block, and
// folding the combine into the last block of each row.
//
// Plain C interface (ctypes): decode_attention(...) returns the CUDA error
// of its launches (0 on success); it never synchronises or allocates.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kUnroll = 4;

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// EPL contiguous elements at p (aligned to EPL * sizeof(T)) as fp32.
template <typename T, int EPL>
__device__ __forceinline__ void load_row(const T* __restrict__ p,
                                         float (&out)[EPL]) {
  static_assert(EPL == 2 || EPL == 4, "hd must be 64 or 128");
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (EPL == 4) {
      const float4 r = __ldg(reinterpret_cast<const float4*>(p));
      out[0] = r.x; out[1] = r.y; out[2] = r.z; out[3] = r.w;
    } else {
      const float2 r = __ldg(reinterpret_cast<const float2*>(p));
      out[0] = r.x; out[1] = r.y;
    }
  } else {
    if constexpr (EPL == 4) {
      const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
      out[0] = bf16_lo(r.x); out[1] = bf16_hi(r.x);
      out[2] = bf16_lo(r.y); out[3] = bf16_hi(r.y);
    } else {
      const uint32_t r = __ldg(reinterpret_cast<const unsigned int*>(p));
      out[0] = bf16_lo(r); out[1] = bf16_hi(r);
    }
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// One block per (split, kv head, batch row). Workspace entry
// ((b * hkv + h) * splits + split) * G + g holds [m, l, acc[HD]].
template <typename T, int HD, int G>
__global__ void __launch_bounds__(kWarps * 32)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const uint8_t* __restrict__ valid,
                    float* __restrict__ ws, int S, int hkv, int splits,
                    int chunk, float scale) {
  constexpr int EPL = HD / 32;
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s_begin = split * chunk;
  const int s_end = min(S, s_begin + chunk);

  float qr[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g)
    load_row<T, EPL>(q + ((size_t)(b * hkv + h) * G + g) * HD + lane * EPL,
                     qr[g]);

  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  const size_t row_stride = (size_t)hkv * HD;   // between positions
  const size_t head_off = ((size_t)b * S * hkv + h) * HD + lane * EPL;
  const T* kb = k + head_off;
  const T* vb = v + head_off;
  const uint8_t* ok_row = valid + (size_t)b * S;

  for (int base = s_begin + warp; base < s_end; base += kWarps * kUnroll) {
    float kr[kUnroll][EPL], vr[kUnroll][EPL];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = base + u * kWarps;
      ok[u] = p < s_end && ok_row[p] != 0;     // the same for the warp
      if (ok[u]) {
        load_row<T, EPL>(kb + (size_t)p * row_stride, kr[u]);
        load_row<T, EPL>(vb + (size_t)p * row_stride, vr[u]);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kr[u][e] = vr[u][e] = 0.f;
      }
    }
    float s[kUnroll][G];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        s[u][g] = -INFINITY;
        if (ok[u]) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) dot = fmaf(qr[g][e], kr[u][e], dot);
          s[u][g] = warp_sum(dot) * scale;
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) mx = fmaxf(mx, s[u][g]);
      if (mx == -INFINITY) continue;             // nothing valid yet
      const float alpha = expf(m[g] - mx);       // 0 when m[g] is -inf
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!ok[u]) continue;
        const float p = expf(s[u][g] - mx);
        l[g] += p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(p, vr[u][e], acc[g][e]);
      }
      m[g] = mx;
    }
  }

  // merge the block's warps through shared memory
  __shared__ float sm_m[kWarps][G], sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][HD];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[warp][g][lane * EPL + e] = acc[g][e];
  }
  __syncthreads();
  float* out = ws + ((size_t)(b * hkv + h) * splits + split) * G * (HD + 2);
  for (int idx = threadIdx.x; idx < G * HD; idx += kWarps * 32) {
    const int g = idx / HD, d = idx % HD;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w][g]);
    float A = 0.f, L = 0.f;
    if (M != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float mw = sm_m[w][g];
        if (mw == -INFINITY) continue;
        const float c = expf(mw - M);
        A = fmaf(c, sm_acc[w][g][d], A);
        L = fmaf(c, sm_l[w][g], L);
      }
    }
    float* e = out + (size_t)g * (HD + 2);
    e[2 + d] = A;
    if (d == 0) {
      e[0] = M;
      e[1] = L;
    }
  }
}

// One block of HD threads per (batch row, kv head, group member): merges
// the splits' partials and writes out[b, h * G + g, :].
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
decode_combine_kernel(const float* __restrict__ ws, T* __restrict__ out,
                      int splits, int G) {
  const int r = blockIdx.x;                 // (b * hkv + h) * G + g
  const int d = threadIdx.x;
  const int bh = r / G, g = r % G;
  const size_t stride = (size_t)G * (HD + 2);
  const float* base = ws + ((size_t)bh * splits * G + g) * (HD + 2);
  float M = -INFINITY;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, base[s * stride]);
  float A = 0.f, L = 0.f;
  if (M != -INFINITY) {
    for (int s = 0; s < splits; ++s) {
      const float* e = base + s * stride;
      if (e[0] == -INFINITY) continue;
      const float c = expf(e[0] - M);
      A = fmaf(c, e[2 + d], A);
      L = fmaf(c, e[1], L);
    }
  }
  out[(size_t)r * HD + d] = from_float<T>(A / fmaxf(L, 1e-20f));
}

template <typename T, int HD, int G>
int launch(const void* q, const void* k, const void* v, const void* valid,
           void* ws, void* out, int B, int S, int hkv, int splits, int chunk,
           cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)HD);
  decode_split_kernel<T, HD, G><<<dim3(splits, hkv, B), kWarps * 32, 0,
                                   stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(valid),
      static_cast<float*>(ws), S, hkv, splits, chunk, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<T, HD><<<B * hkv * G, HD, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<T*>(out), splits, G);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_g(int G, const void* q, const void* k, const void* v,
             const void* valid, void* ws, void* out, int B, int S, int hkv,
             int splits, int chunk, cudaStream_t st) {
  switch (G) {
#define DA_CASE(NG) \
    case NG: return launch<T, HD, NG>(q, k, v, valid, ws, out, B, S, hkv, \
                                      splits, chunk, st);
    DA_CASE(1) DA_CASE(2) DA_CASE(3) DA_CASE(4)
    DA_CASE(5) DA_CASE(6) DA_CASE(7) DA_CASE(8)
#undef DA_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* valid, void* ws, void* out, int B,
                                int S, int hkv, int G, int hd, int is_bf16,
                                int splits, int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (hd == 128)
      return launch_g<__nv_bfloat16, 128>(G, q, k, v, valid, ws, out, B, S,
                                          hkv, splits, chunk, st);
    if (hd == 64)
      return launch_g<__nv_bfloat16, 64>(G, q, k, v, valid, ws, out, B, S,
                                         hkv, splits, chunk, st);
  } else {
    if (hd == 128)
      return launch_g<float, 128>(G, q, k, v, valid, ws, out, B, S, hkv,
                                  splits, chunk, st);
    if (hd == 64)
      return launch_g<float, 64>(G, q, k, v, valid, ws, out, B, S, hkv,
                                 splits, chunk, st);
  }
  return (int)cudaErrorInvalidValue;
}
