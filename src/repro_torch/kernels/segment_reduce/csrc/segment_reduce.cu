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
// The backward role (segment_sum_csr_accumulate, below): the transpose of a
// row gather, out[r] += the sum of the cotangent rows that gathered row r.
// Autograd's own transpose is index_add_ (atomics: other bits on every run).
// Each of a message block's two gathers adds its block into the one
// gradient buffer of the layer, in place, over the rows the block touches
// only (its destination range, or its distinct sources), in the order the
// backward runs the blocks. Contract: out[row_i] = out[row_i] + s_i, s_i
// the fp32 sum, from 0, one add per entry in increasing j, of msg[perm ?
// perm[j] : j] over j in [rowptr[i], rowptr[i+1]), added to the row once in
// fp32 and rounded once to out's dtype; row_i = rows[i], or seg_lo + i
// without a rows list. The rows must be distinct (one warp owns each row:
// no atomics), and only they are read or written.
//
// What bounds it: bytes, each cotangent row read once and each touched row
// read and written once. A block's sources are ~1.2 entries a segment, its
// destinations ~25, at d = 67 fp32: a 268-byte row, which is no multiple
// of 16, so neither a 16-byte vector nor TMA's bulk copy moves one row.
// The design keeps the loads on the register path with many in flight:
//   * a warp walks each row once at any width: lane l owns columns l,
//     l + 32, l + 64, ... (NC fp32 accumulators, NC = ceil(d / 32) up to 8;
//     wider rows take column tiles of 256);
//   * a warp takes a group of G consecutive segments (G up to 31, chosen by
//     the caller from the mean segment length so that a warp walks ~32
//     entries): lane l holds rowptr[s0 + l] and the group's output rows,
//     each loaded once, and perm comes 32 entries at a time in one
//     coalesced load, handed out with __shfl_sync;
//   * kAccUnroll entries' rows are loaded before any is added, then added
//     in order; the output rows of the next kPrefetch segments are loaded
//     ahead of their flush, so the read-modify-write of a short segment's
//     row overlaps the loads of the ones before it;
//   * few rows a warp and many warps: a block's sources are gathered
//     rows, and the latency of those random reads, not their bytes, is
//     what holds the kernel back (4 rows in flight at 32 warps an SM beat
//     8 at 24; see the constants below).
// G changes no bit: each segment is summed in its own order and added to
// its row once.
//
// Plain C interface (ctypes): each entry returns the CUDA error of its
// launch (0 on success); neither synchronises or allocates.
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

// The in-place kernel is bound by how many rows are in flight, so by
// occupancy: 4 entries' rows and 4 output rows ahead in 64 registers (4
// blocks of 8 warps an SM) beat 8 or 16 rows at 24 or 16 warps an SM, and
// fewer registers spill. The macros let kernels/segment_reduce/sweep.py
// build other settings.
#ifndef SEG_ACC_UNROLL
#define SEG_ACC_UNROLL 4
#endif
#ifndef SEG_ACC_PREFETCH
#define SEG_ACC_PREFETCH 4
#endif
#ifndef SEG_ACC_MIN_BLOCKS
#define SEG_ACC_MIN_BLOCKS 4
#endif
constexpr unsigned kFull = 0xffffffffu;
constexpr int kAccUnroll = SEG_ACC_UNROLL;    // entries' rows in flight
constexpr int kPrefetch = SEG_ACC_PREFETCH;   // output rows loaded ahead
constexpr int kAccBlocksCap = 1 << 20;

template <typename T>
__device__ __forceinline__ float load_elem(const T* __restrict__ p) {
  if constexpr (std::is_same<T, float>::value) {
    return __ldg(p);
  } else {
    return bf16_bits_to_float(
        __ldg(reinterpret_cast<const unsigned short*>(p)));
  }
}

template <typename T>
__device__ __forceinline__ float read_out(const T* p) {
  if constexpr (std::is_same<T, float>::value) {
    return *p;
  } else {
    return bf16_bits_to_float(*reinterpret_cast<const unsigned short*>(p));
  }
}

template <typename T>
__device__ __forceinline__ void write_out(T* p, float v) {
  if constexpr (std::is_same<T, float>::value) {
    *p = v;
  } else {
    *p = __float2bfloat16(v);                                  // RNE
  }
}

// Adds acc to segment cur's row (loaded ahead in o[0]) and zeroes acc,
// moves the prefetched rows down and loads segment cur + kPrefetch's, then
// steps to the next segment of the group.
template <typename T, int NC>
__device__ __forceinline__ void flush_row(T* __restrict__ out, int d, int c0,
                                          int lane, int orow, int rp, int ns,
                                          int& cur, int& cur_end,
                                          float (&acc)[NC],
                                          float (&o)[kPrefetch][NC]) {
  const int r = __shfl_sync(kFull, orow, cur);
#pragma unroll
  for (int q = 0; q < NC; ++q) {
    const int col = c0 + q * 32 + lane;
    if (col < d) write_out(out + (size_t)r * d + col, o[0][q] + acc[q]);
    acc[q] = 0.f;
  }
#pragma unroll
  for (int p = 0; p + 1 < kPrefetch; ++p)
#pragma unroll
    for (int q = 0; q < NC; ++q) o[p][q] = o[p + 1][q];
  const int nxt = cur + kPrefetch;
  const int rn = __shfl_sync(kFull, orow, nxt & 31);
#pragma unroll
  for (int q = 0; q < NC; ++q) {
    const int col = c0 + q * 32 + lane;
    o[kPrefetch - 1][q] =
        (nxt < ns && col < d) ? read_out(out + (size_t)rn * d + col) : 0.f;
  }
  ++cur;
  cur_end = __shfl_sync(kFull, rp, (cur + 1) & 31);
}

// Entries jb + u0 .. jb + u0 + kAccUnroll - 1 (those below cnt) of the
// 32-entry chunk at jb: their rows' columns of this lane, 0 past cnt.
template <typename T, int NC, bool PERM>
__device__ __forceinline__ void load_rows(float (&x)[kAccUnroll][NC],
                                          const T* __restrict__ msg, int d,
                                          int c0, int lane, int pj, int jb,
                                          int u0, int cnt) {
#pragma unroll
  for (int u = 0; u < kAccUnroll; ++u) {
    const int e = PERM ? __shfl_sync(kFull, pj, (u0 + u) & 31) : jb + u0 + u;
    const T* src = msg + (size_t)e * d;
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      const int col = c0 + q * 32 + lane;
      x[u][q] = (u0 + u < cnt && col < d) ? load_elem(src + col) : 0.f;
    }
  }
}

// One warp per group of `group` consecutive segments (see the note at the
// top). NC column groups of 32 per lane; a row wider than 32 * NC columns
// takes several column tiles, each a walk of the group's entries.
template <typename T, int NC, bool PERM>
__global__ void __launch_bounds__(kWarps * 32, SEG_ACC_MIN_BLOCKS)
segment_accumulate_kernel(const T* __restrict__ msg,
                          const int* __restrict__ rowptr,
                          const int* __restrict__ perm,
                          const int* __restrict__ rows, T* __restrict__ out,
                          int n_seg, int d, int seg_lo, int group) {
  const int lane = threadIdx.x & 31;
  const int n_groups = (n_seg + group - 1) / group;
  const int warp_stride = gridDim.x * kWarps;
  for (int g = blockIdx.x * kWarps + (threadIdx.x >> 5); g < n_groups;
       g += warp_stride) {
    const int s0 = g * group;
    const int ns = min(group, n_seg - s0);       // segments of this group
    // lane l <= ns: rowptr[s0 + l]; lane l < ns: segment s0 + l's row
    const int rp = lane <= ns ? __ldg(rowptr + s0 + lane) : 0;
    int orow = 0;
    if (lane < ns) orow = rows ? __ldg(rows + s0 + lane) : seg_lo + s0 + lane;
    const int beg = __shfl_sync(kFull, rp, 0);
    const int end = __shfl_sync(kFull, rp, ns);
    for (int c0 = 0; c0 < d; c0 += 32 * NC) {
      float acc[NC];
      float o[kPrefetch][NC];                   // rows of segments cur, ...
#pragma unroll
      for (int q = 0; q < NC; ++q) acc[q] = 0.f;
#pragma unroll
      for (int p = 0; p < kPrefetch; ++p) {
        const int r = __shfl_sync(kFull, orow, p & 31);
#pragma unroll
        for (int q = 0; q < NC; ++q) {
          const int col = c0 + q * 32 + lane;
          o[p][q] = (p < ns && col < d)
                        ? read_out(out + (size_t)r * d + col) : 0.f;
        }
      }
      int cur = 0;                              // the segment being summed
      int cur_end = __shfl_sync(kFull, rp, 1);
      for (int jb = beg; jb < end; jb += 32) {
        const int cnt = min(32, end - jb);
        int pj = 0;
        if (PERM && lane < cnt) pj = __ldg(perm + jb + lane);
        for (int u0 = 0; u0 < cnt; u0 += kAccUnroll) {
          float x[kAccUnroll][NC];
          load_rows<T, NC, PERM>(x, msg, d, c0, lane, pj, jb, u0, cnt);
#pragma unroll
          for (int u = 0; u < kAccUnroll; ++u) {
            if (u0 + u < cnt) {
              // entry j opens the next non-empty segment: flush the ones
              // it passes (the finished one and any empty ones)
              while (jb + u0 + u == cur_end)
                flush_row<T, NC>(out, d, c0, lane, orow, rp, ns, cur, cur_end,
                                 acc, o);
#pragma unroll
              for (int q = 0; q < NC; ++q) acc[q] += x[u][q];
            }
          }
        }
      }
      while (cur < ns)                          // the last, and empty ones
        flush_row<T, NC>(out, d, c0, lane, orow, rp, ns, cur, cur_end, acc, o);
    }
  }
}

template <typename T, int NC>
int launch_acc(const void* msg, const int* rowptr, const int* perm,
               const int* rows, void* out, int n_seg, int d, int seg_lo,
               int group, cudaStream_t stream) {
  const long long groups = ((long long)n_seg + group - 1) / group;
  const long long blocks = (groups + kWarps - 1) / kWarps;
  const dim3 grid((unsigned)(blocks < kAccBlocksCap ? blocks : kAccBlocksCap));
  if (perm)
    segment_accumulate_kernel<T, NC, true><<<grid, kWarps * 32, 0, stream>>>(
        static_cast<const T*>(msg), rowptr, perm, rows, static_cast<T*>(out),
        n_seg, d, seg_lo, group);
  else
    segment_accumulate_kernel<T, NC, false><<<grid, kWarps * 32, 0, stream>>>(
        static_cast<const T*>(msg), rowptr, nullptr, rows,
        static_cast<T*>(out), n_seg, d, seg_lo, group);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_acc(const void* msg, const int* rowptr, const int* perm,
                 const int* rows, void* out, int n_seg, int d, int seg_lo,
                 int group, cudaStream_t st) {
  const int nc = (d + 31) / 32;
  switch (nc) {
    case 1: return launch_acc<T, 1>(msg, rowptr, perm, rows, out, n_seg, d, seg_lo, group, st);
    case 2: return launch_acc<T, 2>(msg, rowptr, perm, rows, out, n_seg, d, seg_lo, group, st);
    case 3: return launch_acc<T, 3>(msg, rowptr, perm, rows, out, n_seg, d, seg_lo, group, st);
    case 4: return launch_acc<T, 4>(msg, rowptr, perm, rows, out, n_seg, d, seg_lo, group, st);
    default: return launch_acc<T, 8>(msg, rowptr, perm, rows, out, n_seg, d, seg_lo, group, st);
  }
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

// msg (E, d) fp32 or bf16 (is_bf16), contiguous; rowptr (n_seg + 1,) int32;
// perm (E',) int32 or null; rows (n_seg,) int32 distinct row ids or null
// (then rows seg_lo .. seg_lo + n_seg - 1); out (R, d) contiguous, msg's
// dtype, updated in place; group: segments per warp, 1..31.
extern "C" int segment_sum_csr_accumulate(const void* msg, const void* rowptr,
                                          const void* perm, const void* rows,
                                          void* out, int n_seg, int d,
                                          int seg_lo, int group, int is_bf16,
                                          void* stream) {
  if (n_seg <= 0 || d <= 0 || group < 1 || group > 31)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* rp = static_cast<const int*>(rowptr);
  const int* pm = static_cast<const int*>(perm);
  const int* rw = static_cast<const int*>(rows);
  if (is_bf16)
    return dispatch_acc<__nv_bfloat16>(msg, rp, pm, rw, out, n_seg, d, seg_lo,
                                       group, st);
  return dispatch_acc<float>(msg, rp, pm, rw, out, n_seg, d, seg_lo, group,
                             st);
}
