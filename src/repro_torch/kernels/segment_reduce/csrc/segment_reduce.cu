// Deterministic CSR segment sum for sm_90a.
//
// Replaces the TPU kernel segment_sum_pallas
// (src/repro/kernels/segment_reduce/segment_reduce.py:50, body _kernel :25):
// out[n, :] = sum of msg[e, :] over the edges e with seg[e] == n. The TPU
// has no good scatter, so it builds a one-hot (edge block x node block)
// matrix in registers and multiplies it into the output on the MXU,
// carrying each node block's sum across the in-order sweep of edge blocks.
// Hopper has neither the need nor the in-order grid: the messages come
// grouped by segment (a CSR: rowptr, and optionally a perm that lists the
// grouped message rows), and each segment is reduced by one warp. No
// atomics, so every output row is summed in one fixed order and the result
// is the same bits on every run.
//
// Contract: out[i, :] = sum over j in [rowptr[i], rowptr[i+1]) of
// msg[perm ? perm[j] : j, :], accumulated in fp32 with one add per entry in
// increasing j starting from 0, and written once, rounded to msg's dtype
// (fp32 or bf16). A segment with no entries writes 0. Every one of the
// n_seg output rows is written.
//
// What bounds it: bytes. Each message row is read once (d * sizeof(T)
// bytes for d adds), the output written once, against the card's ~20
// flops per byte of fp32 arithmetic. The design keeps the reads wide and
// many in flight:
//   * one warp per segment, a grid-stride loop over segments;
//   * lane l owns V consecutive columns (a 16-, 8- or 4-byte vector when
//     d * sizeof(T) and the pointers allow it, one element otherwise), so
//     the warp reads a message row as one contiguous run; rows wider than
//     32 * V columns take several column passes, each over its own bytes;
//   * kUnroll rows' loads are issued before any is added, and then added
//     in order, so the sum keeps its fixed order;
//   * fp32 accumulators in registers, one store per output vector.
// Left for later: splitting a long (hub) segment across warps, packing two
// narrow rows (d = 68 uses 17 of 32 lanes) per warp, and TMA/cp.async
// staging of the rows.
//
// Plain C interface (ctypes): segment_sum_csr(...) returns the CUDA error of
// its launch (0 on success); it never synchronises or allocates.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;      // warps per block
constexpr int kUnroll = 4;     // rows in flight per lane
constexpr int kMaxBlocks = 65535;

template <int BYTES>
struct Vec;
template <> struct Vec<16> { using type = uint4; };
template <> struct Vec<8> { using type = uint2; };
template <> struct Vec<4> { using type = uint32_t; };
template <> struct Vec<2> { using type = uint16_t; };

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

// V elements of T as one vector load, widened to fp32.
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&x)[V]) {
  using W = typename Vec<(int)(V * sizeof(T))>::type;
  const W w = __ldg(reinterpret_cast<const W*>(p));
  if constexpr (std::is_same<T, float>::value) {
    const float* f = reinterpret_cast<const float*>(&w);
#pragma unroll
    for (int e = 0; e < V; ++e) x[e] = f[e];
  } else {
    const uint16_t* h = reinterpret_cast<const uint16_t*>(&w);
#pragma unroll
    for (int e = 0; e < V; ++e) x[e] = bf16_bits_to_float(h[e]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* __restrict__ p,
                                          const float (&acc)[V]) {
  using W = typename Vec<(int)(V * sizeof(T))>::type;
  W w;
  if constexpr (std::is_same<T, float>::value) {
    float* f = reinterpret_cast<float*>(&w);
#pragma unroll
    for (int e = 0; e < V; ++e) f[e] = acc[e];
  } else {
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&w);
#pragma unroll
    for (int e = 0; e < V; ++e) h[e] = __float2bfloat16(acc[e]);   // RNE
  }
  *reinterpret_cast<W*>(p) = w;
}

template <typename T, int V, bool PERM>
__global__ void __launch_bounds__(kWarps * 32)
segment_sum_kernel(const T* __restrict__ msg, const int* __restrict__ rowptr,
                   const int* __restrict__ perm, T* __restrict__ out,
                   int n_seg, int d) {
  const int lane = threadIdx.x & 31;
  const int n_vec = d / V;                       // vectors per row
  const int warp_stride = gridDim.x * kWarps;
  for (int seg = blockIdx.x * kWarps + (threadIdx.x >> 5); seg < n_seg;
       seg += warp_stride) {
    const int beg = __ldg(rowptr + seg), end = __ldg(rowptr + seg + 1);
    for (int c = lane; c < n_vec; c += 32) {
      const T* col = msg + (size_t)c * V;
      float acc[V];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = 0.f;
      int j = beg;
      for (; j + kUnroll <= end; j += kUnroll) {
        float x[kUnroll][V];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const size_t row = PERM ? (size_t)__ldg(perm + j + u)
                                  : (size_t)(j + u);
          load_vec<T, V>(col + row * d, x[u]);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
#pragma unroll
          for (int e = 0; e < V; ++e) acc[e] += x[u][e];
      }
      for (; j < end; ++j) {
        const size_t row = PERM ? (size_t)__ldg(perm + j) : (size_t)j;
        float x[V];
        load_vec<T, V>(col + row * d, x);
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] += x[e];
      }
      store_vec<T, V>(out + (size_t)seg * d + (size_t)c * V, acc);
    }
  }
}

template <typename T, int V>
int launch(const void* msg, const int* rowptr, const int* perm, void* out,
           int n_seg, int d, cudaStream_t stream) {
  const int blocks = (int)(((long long)n_seg + kWarps - 1) / kWarps);
  const dim3 grid(blocks < kMaxBlocks ? blocks : kMaxBlocks);
  if (perm)
    segment_sum_kernel<T, V, true><<<grid, kWarps * 32, 0, stream>>>(
        static_cast<const T*>(msg), rowptr, perm, static_cast<T*>(out),
        n_seg, d);
  else
    segment_sum_kernel<T, V, false><<<grid, kWarps * 32, 0, stream>>>(
        static_cast<const T*>(msg), rowptr, nullptr, static_cast<T*>(out),
        n_seg, d);
  return (int)cudaGetLastError();
}

}  // namespace

// msg (E, d) of fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1), contiguous;
// rowptr (n_seg + 1,) int32; perm (E',) int32 or null; out points at the
// first of n_seg contiguous output rows of width d. vec is the elements per
// lane load, chosen by the caller: 1, 2 or 4 for fp32, 1, 2, 4 or 8 for
// bf16, with d % vec == 0 and msg and out aligned to vec elements.
extern "C" int segment_sum_csr(const void* msg, const void* rowptr,
                               const void* perm, void* out, int n_seg, int d,
                               int is_bf16, int vec, void* stream) {
  if (n_seg <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* rp = static_cast<const int*>(rowptr);
  const int* pm = static_cast<const int*>(perm);
  if (is_bf16) {
    switch (vec) {
      case 8: return launch<__nv_bfloat16, 8>(msg, rp, pm, out, n_seg, d, st);
      case 4: return launch<__nv_bfloat16, 4>(msg, rp, pm, out, n_seg, d, st);
      case 2: return launch<__nv_bfloat16, 2>(msg, rp, pm, out, n_seg, d, st);
      case 1: return launch<__nv_bfloat16, 1>(msg, rp, pm, out, n_seg, d, st);
    }
  } else {
    switch (vec) {
      case 4: return launch<float, 4>(msg, rp, pm, out, n_seg, d, st);
      case 2: return launch<float, 2>(msg, rp, pm, out, n_seg, d, st);
      case 1: return launch<float, 1>(msg, rp, pm, out, n_seg, d, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}
