// Deterministic CSR segment sum for sm_90a, in two modes of one design.
//
// Replaces the TPU kernel segment_sum_pallas
// (src/repro/kernels/segment_reduce/segment_reduce.py:50, body _kernel :25):
// out[n, :] = sum of msg[e, :] over the edges e with seg[e] == n. The TPU
// has no good scatter, so it builds a one-hot (edge block x node block)
// matrix in registers and multiplies it into the output on the MXU,
// carrying each node block's sum across the in-order sweep of edge blocks.
// Hopper has neither the need nor the in-order grid: the messages come
// grouped by segment (a CSR: rowptr, and optionally a perm that lists the
// grouped message rows), and each segment's columns are summed by one lane
// each. No atomics, so every output row is summed in one fixed order and
// the result is the same bits on every run.
//
// The summing mode (segment_sum_csr, ADD = false): out[seg_lo + i, :] =
// the sum over j in [rowptr[i], rowptr[i+1]) of msg[perm ? perm[j] : j, :],
// accumulated in fp32 with one add per entry in increasing j starting from
// 0, and written once, rounded to msg's dtype (fp32 or bf16). A segment
// with no entries writes 0. Every one of the n_seg output rows is written;
// no row is read.
//
// The in-place mode (segment_sum_csr_accumulate, ADD = true), the
// backward role: the transpose of a row gather, out[r] += the sum of the
// cotangent rows that gathered row r. Autograd's own transpose is
// index_add_ (atomics: other bits on every run). Each of a message block's
// two gathers adds its block into the one gradient buffer of the layer, in
// place, over the rows the block touches only (its destination range, or
// its distinct sources), in the order the backward runs the blocks.
// Contract: out[row_i] = out[row_i] + s_i, s_i the fp32 sum, from 0, one
// add per entry in increasing j, of msg[perm ? perm[j] : j] over j in
// [rowptr[i], rowptr[i+1]), added to the row once in fp32 and rounded once
// to out's dtype; row_i = rows[i], or seg_lo + i without a rows list. The
// rows must be distinct (one warp, or one team of lanes, owns each row's
// columns: no atomics), and only they are read or written.
//
// In both modes a segment's entries are never split: each is summed by one
// lane per column in its own order, so every route and every plan gives
// the same bits.
//
// What bounds it: bytes, each message row read once, each output row
// written once (and, in place, read once). The rows are gathered (perm) or
// streamed, so what holds a route back is how many of those bytes are in
// flight: latency, not bandwidth. The caller (ops.sum_plan, ops.acc_plan)
// picks the route from the row's bytes, the vector its pointers allow and
// the CSR's sizes:
//   * the vector: 16-, 8- or 4-byte loads (uint4 is 4 fp32 or 8 bf16) where
//     the row's bytes and both base pointers allow, else one element. TMA
//     cannot take the rows that refuse a vector either (its global strides
//     are multiples of 16 bytes: EGNN's 268-byte, NequIP's 1,156-byte and
//     Equiformer-v2's 25,100-byte fp32 rows are not);
//   * rows (rows_body: segment_sum_kernel summing, segment_accumulate_kernel
//     in place), for rows over 64 bytes: a warp owns
//     a (group of G consecutive segments, column slice). Lane l holds
//     rowptr[s0 + l] and, in place, the group's output rows, each loaded
//     once; perm comes 32 entries at a time in one coalesced load, handed
//     out with __shfl_sync; in place, the output rows of the next
//     kPrefetch segments are loaded ahead of their flush. Entries' rows are
//     loaded ahead of their adds, through a shared-memory ring of kRing
//     entries by cp.async of a vector a lane (kRing - 1 always in flight,
//     no registers held) or kAhead at a time in registers: in place, the
//     ring takes gathered one-element fp32 rows (4 entries); summing, it
//     takes gathered rows of 4-byte or wider vectors and streamed rows of
//     16-byte vectors (8 entries). "medium": the row fits one slice at NC * (a vector's
//     registers) <= 4 a lane (EGNN's 67 and 68 fp32, DimeNet's 128 as one
//     uint4 a lane). "wide": balanced slices at <= 3 registers (or one
//     vector) a lane, each slice its own warp on the grid (groups x slices
//     warps), neighbouring warps on neighbouring slices of one group's rows;
//   * team (team_body: segment_sum_kernel_team, segment_accumulate_kernel_
//     team), for rows of 64 bytes or less:
//     a warp splits into teams of d / vec lanes (1 at d = 1, 5 with 8-byte
//     vectors at d = 10 fp32), and team t walks its own run of G / teams
//     consecutive segments as the row kernel walks a group (kAhead entries
//     ahead and, in place, kPrefetch output rows ahead), so 32 / team
//     segments walk at once, each in its own order.
// G and the slices change no bit: each segment is summed in its own order
// and written (or added to its row) once.
//
// The summing mode drops the output row's read and its registers: the
// flush stores acc, which is 0 for a segment no entry reached. It has its
// own group rule (ops.sum_group_size: about 8 entries a warp, at least
// 4,096 warps), its ring (above) and its build settings (SEG_SUM_*). It
// replaced the first summing kernel, one warp a segment (a grid-stride
// loop), lane l owning vectors l, l + 32, ... of the row in passes over
// the segment's entries (each pass reloading perm and the rows'
// addresses, 4 rows in flight, the perm one broadcast load an entry),
// which left 27 of 32 lanes idle at d = 10, 31 at d = 1 and walked
// 6,272-wide rows in 49 passes in series.
//
// Measured, summing (kernels/segment_reduce/sweep.py --mode sum, CUDA
// events, L2 flushed, on "NVIDIA H100 80GB HBM3, 700.00 W"; ms, the first
// summing kernel -> this one, in turns in one call; the share of the byte
// bound): EGNN's layer (61,859,140 x 68 fp32, medium, uint4 through the
// ring, 1 a warp) 5.795 -> 5.703 (92%); NequIP's chunk (926,883 x 289,
// wide, 4 slices of 73, registers) 0.610 -> 0.393 (85%); Equiformer-v2's
// (42,790 x 6,272 tree-shaped, 49 slices of 128, 8 a warp) 0.804 ->
// 0.734 (87%); DimeNet's (41,008 x 128 gathered into 10,556 rows, 2 a
// warp) 0.0189 -> 0.0180 (44%); xDeepFM's EmbeddingBag (1,342,750 x 10,
// teams of 5 lanes, a bag a team) 0.0565 -> 0.0433 (43%); k-means' runs
// at 1,048,576 x 384 (3 slices of 128, gathered) 0.560 -> 0.545 (89%),
// its clusters (4,127 runs into 64) 0.033 -> 0.0145; the hop operator's
// degrees (d = 1, teams of one lane) 0.034 -> 0.0103. Tried and dropped:
// registers for gathered vector rows, DimeNet 0.0215 (52 registers, 4
// blocks an SM, where the first kernel ran 6 at 40); the in-place group
// rule (32 entries a warp): DimeNet at 6 or 8 a warp 0.0208, Equiformer-v2
// at 31 0.755 (at 1, 0.831); staging one-element streamed rows too,
// NequIP 0.425; a ring of 4, EGNN 5.734 and the clusters 0.0170; 8
// entries in registers, NequIP 0.381 but the bag 0.0466 and 7 instances
// spilling; 5 blocks an SM, NequIP 0.385 and bf16 instances spilling;
// the team route's perm loaded a round ahead, the bag 0.0475 (44
// registers); 3 slices of 97 at NequIP, 0.385 (kept: one slicing rule
// for both modes).
//
// Measured, in place (kernels/segment_reduce/sweep.py, CUDA events, L2
// flushed, on "NVIDIA H100 80GB HBM3, 700.00 W"; ms, the one-warp-a-group
// kernel that walked 256-column tiles in series before it, then this one):
// EGNN's 67 block, source 0.437 -> 0.347, destination 0.131 -> 0.131;
// NequIP's 291, 2.60 -> 0.70 and 1.09 -> 0.25; Equiformer-v2's 6,275
// (65,536 edges), 7.29 -> 1.81 and 14.45 -> 1.94; the LM token's 3,072
// bf16, 0.283 -> 0.038; DimeNet's 128, 0.070 -> 0.026; xDeepFM's 10 and 1
// (2,555,904 entries into 1,874,716 rows), 0.340 -> 0.177 and 0.246 ->
// 0.051. The old kernel's destination side at 6,275 was twice its source
// side because a minibatch union's destinations are tree heads (15 and 10
// edges) between runs of empty leaves: ~400 groups held every entry, each
// one warp walking 25 tiles in series (on one edge a row it took 7.48).
// Tried and dropped: slices of 4 registers a lane (512 bytes of fp32)
// spill 16 bytes at the 64-register cap, 6,275's source 2.69 against 2.15
// at 2 registers; 3 registers (96 columns) beat 2 and 4 once staged (1.81,
// 1.87, 1.91); staging streamed (no perm) rows, EGNN's destination 0.1356
// against 0.1343 in registers; the team route as one segment a team in
// rounds without look-ahead, 0.203 at d = 10, and with a rolling
// two-stage pipeline (each added row loads the one kAccUnroll on), 0.204
// and 0.056; 2 or 8 entries in flight, 2 or 8 output rows ahead, a ring of
// 8, or 3 or 5 blocks an SM: none better at every shape.
//
// Plain C interface (ctypes): each entry returns the CUDA error of its
// launch (0 on success); neither synchronises or allocates.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;      // warps per block

template <int BYTES>
struct Vec;
template <> struct Vec<16> { using type = uint4; };
template <> struct Vec<8> { using type = uint2; };
template <> struct Vec<4> { using type = uint32_t; };
template <> struct Vec<2> { using type = uint16_t; };

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

// p[0 .. V) = acc, rounded to T, as one vector store.
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

// The kernels are bound by how many rows are in flight, so by occupancy:
// in place, 4 entries' rows and 4 output rows ahead in 64 registers (4
// blocks of 8 warps an SM) beat 8 or 16 rows at 24 or 16 warps an SM, and
// fewer registers spill. The summing mode holds no output rows, so it has
// its own settings (SEG_SUM_*). The macros let
// kernels/segment_reduce/sweep.py build other settings.
#ifndef SEG_ACC_UNROLL
#define SEG_ACC_UNROLL 4
#endif
#ifndef SEG_ACC_PREFETCH
#define SEG_ACC_PREFETCH 4
#endif
#ifndef SEG_ACC_MIN_BLOCKS
#define SEG_ACC_MIN_BLOCKS 4
#endif
#ifndef SEG_ACC_STAGES
#define SEG_ACC_STAGES 4
#endif
#ifndef SEG_SUM_UNROLL
#define SEG_SUM_UNROLL 4
#endif
#ifndef SEG_SUM_MIN_BLOCKS
#define SEG_SUM_MIN_BLOCKS 4
#endif
#ifndef SEG_SUM_STAGES
#define SEG_SUM_STAGES 8
#endif
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPrefetch = SEG_ACC_PREFETCH;   // output rows loaded ahead
constexpr int kAccBlocksCap = 1 << 20;
// entries' rows in flight, and the output rows held (the summing mode
// reads none: one slot keeps the arrays' shapes)
template <bool ADD>
constexpr int kAhead = ADD ? SEG_ACC_UNROLL : SEG_SUM_UNROLL;
template <bool ADD>
constexpr int kHeld = ADD ? kPrefetch : 1;
// The row kernel's rows can come through a shared-memory ring of kRing
// entries by cp.async of one vector a lane (4, 8 or 16 bytes) instead of
// kAhead entries in registers (SEG_*_STAGES <= 1: never). In place:
// gathered (perm) one-element fp32 rows. Summing: gathered rows of >=
// 4-byte vectors, and streamed rows of 16-byte vectors.
template <bool ADD>
constexpr int kRing = ADD ? (SEG_ACC_STAGES > 1 ? SEG_ACC_STAGES : 1)
                          : (SEG_SUM_STAGES > 1 ? SEG_SUM_STAGES : 1);
template <typename T, int V, bool PERM, bool ADD>
constexpr bool kStaged =
    kRing<ADD> > 1 &&
    (ADD ? PERM && std::is_same<T, float>::value && V == 1
         : V * sizeof(T) >= 4 && (PERM || V * sizeof(T) == 16));

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(gmem), "n"(BYTES)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// V elements of T as one raw vector, kept packed in registers until added.
template <typename T, int V>
using Raw = typename Vec<(int)(V * sizeof(T))>::type;

// The most vectors a lane holds of one row: NC * (the vector's 32-bit
// registers) <= 4, so kAhead entries and kPrefetch output rows fit.
template <typename T, int V>
constexpr int kMaxNC = (V * sizeof(T) > 4) ? 4 / (int)(V * sizeof(T) / 4) : 4;

// The warp's ring: R entries of NC * 32 vectors W.
template <typename W, int NC, int R>
__device__ __forceinline__ W* stage_ring() {
  __shared__ W ring[kWarps * R * NC * 32];
  return ring + (threadIdx.x >> 5) * R * NC * 32;
}

// Issues entry i's (i < cnt) copies of the 32-entry chunk at jb into its
// ring slot, one vector a lane and column block, and commits a group
// (empty past cnt).
template <typename T, int V, int NC, int R, bool PERM>
__device__ __forceinline__ void stage_entry(Raw<T, V>* ring,
                                            const T* __restrict__ msg, int d,
                                            int c0, int c_hi, int lane, int pj,
                                            int jb, int i, int cnt) {
  if (i < cnt) {
    const int e = PERM ? __shfl_sync(kFull, pj, i) : jb + i;
    const T* src = msg + (size_t)e * d;
    Raw<T, V>* dst = ring + (i % R) * NC * 32 + lane;
#pragma unroll
    for (int q = 0; q < NC; ++q)
      if (c0 + q * 32 * V < c_hi)
        cp_async<(int)(V * sizeof(T))>(dst + q * 32, src + c0 + q * 32 * V);
  }
  cp_commit();
}

template <typename T, int V>
__device__ __forceinline__ Raw<T, V> ld_msg(const T* __restrict__ p) {
  return __ldg(reinterpret_cast<const Raw<T, V>*>(p));
}

template <typename T, int V>
__device__ __forceinline__ Raw<T, V> ld_out(const T* p) {
  return *reinterpret_cast<const Raw<T, V>*>(p);
}

template <typename T, int V>
__device__ __forceinline__ float elem(const Raw<T, V>& w, int e) {
  if constexpr (std::is_same<T, float>::value) {
    return reinterpret_cast<const float*>(&w)[e];
  } else {
    return bf16_bits_to_float(reinterpret_cast<const uint16_t*>(&w)[e]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void add_raw(float (&acc)[V], const Raw<T, V>& w) {
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] += elem<T, V>(w, e);
}

// Segment cur's row at p gets acc (ADD false) or o + acc (ADD true, o its
// row loaded ahead), added in fp32 and rounded once to T.
template <typename T, int V, bool ADD>
__device__ __forceinline__ void write_row(T* p, const Raw<T, V>& o,
                                          const float (&acc)[V]) {
  if constexpr (ADD) {
    float s[V];
#pragma unroll
    for (int e = 0; e < V; ++e) s[e] = elem<T, V>(o, e) + acc[e];
    store_vec<T, V>(p, s);
  } else {
    store_vec<T, V>(p, acc);
  }
}

// Writes segment cur's row (write_row) and zeroes acc; in place, moves the
// prefetched rows down and loads segment cur + kPrefetch's; then steps to
// the next segment of the group. The lane's columns are c0 + q * 32 * V
// (q < NC), those below c_hi its own.
template <typename T, int V, int NC, bool ADD>
__device__ __forceinline__ void flush_row(T* __restrict__ out, int d, int c0,
                                          int c_hi, int orow, int rp, int ns,
                                          int& cur, int& cur_end,
                                          float (&acc)[NC][V],
                                          Raw<T, V> (&o)[kHeld<ADD>][NC]) {
  const int r = __shfl_sync(kFull, orow, cur);
#pragma unroll
  for (int q = 0; q < NC; ++q) {
    const int col = c0 + q * 32 * V;
    if (col < c_hi)
      write_row<T, V, ADD>(out + (size_t)r * d + col, o[0][q], acc[q]);
#pragma unroll
    for (int e = 0; e < V; ++e) acc[q][e] = 0.f;
  }
  if constexpr (ADD) {
#pragma unroll
    for (int p = 0; p + 1 < kPrefetch; ++p)
#pragma unroll
      for (int q = 0; q < NC; ++q) o[p][q] = o[p + 1][q];
    const int nxt = cur + kPrefetch;
    const int rn = __shfl_sync(kFull, orow, nxt & 31);
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      const int col = c0 + q * 32 * V;
      o[kPrefetch - 1][q] = (nxt < ns && col < c_hi)
                                ? ld_out<T, V>(out + (size_t)rn * d + col)
                                : Raw<T, V>();
    }
  }
  ++cur;
  cur_end = __shfl_sync(kFull, rp, (cur + 1) & 31);
}

// Entries jb + u0 .. jb + u0 + U - 1 (those below cnt) of the 32-entry
// chunk at jb: their rows' vectors of this lane, 0 past cnt.
template <typename T, int V, int NC, bool PERM, int U>
__device__ __forceinline__ void load_rows(Raw<T, V> (&x)[U][NC],
                                          const T* __restrict__ msg, int d,
                                          int c0, int c_hi, int pj, int jb,
                                          int u0, int cnt) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int e = PERM ? __shfl_sync(kFull, pj, (u0 + u) & 31) : jb + u0 + u;
    const T* src = msg + (size_t)e * d;
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      const int col = c0 + q * 32 * V;
      x[u][q] = (u0 + u < cnt && col < c_hi) ? ld_msg<T, V>(src + col)
                                             : Raw<T, V>();
    }
  }
}

// The medium and wide routes: one warp per (group of `group` consecutive
// segments, slice of `width` columns); warp w takes group w / slices and
// slice w % slices. NC vectors of V elements a lane cover the slice.
template <typename T, int V, int NC, bool PERM, bool ADD>
__device__ __forceinline__ void rows_body(const T* __restrict__ msg,
                                          const int* __restrict__ rowptr,
                                          const int* __restrict__ perm,
                                          const int* __restrict__ rows,
                                          T* __restrict__ out, int n_seg,
                                          int d, int seg_lo, int group,
                                          int width, int slices) {
  using W = Raw<T, V>;
  constexpr int U = kAhead<ADD>;
  const int lane = threadIdx.x & 31;
  const long long n_work = (long long)((n_seg + group - 1) / group) * slices;
  const long long warp_stride = (long long)gridDim.x * kWarps;
  for (long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       w < n_work; w += warp_stride) {
    const int g = (int)(w / slices);
    const int lo = (int)(w - (long long)g * slices) * width;
    const int c_hi = min(d, lo + width);
    const int c0 = lo + lane * V;               // this lane's first column
    const int s0 = g * group;
    const int ns = min(group, n_seg - s0);       // segments of this group
    // lane l <= ns: rowptr[s0 + l]; lane l < ns: segment s0 + l's row
    const int rp = lane <= ns ? __ldg(rowptr + s0 + lane) : 0;
    int orow = 0;
    if (lane < ns) orow = rows ? __ldg(rows + s0 + lane) : seg_lo + s0 + lane;
    const int beg = __shfl_sync(kFull, rp, 0);
    const int end = __shfl_sync(kFull, rp, ns);
    float acc[NC][V];
    W o[kHeld<ADD>][NC];                         // rows of segments cur, ...
#pragma unroll
    for (int q = 0; q < NC; ++q)
#pragma unroll
      for (int e = 0; e < V; ++e) acc[q][e] = 0.f;
    if constexpr (ADD) {
#pragma unroll
      for (int p = 0; p < kPrefetch; ++p) {
        const int r = __shfl_sync(kFull, orow, p & 31);
#pragma unroll
        for (int q = 0; q < NC; ++q) {
          const int col = c0 + q * 32 * V;
          o[p][q] = (p < ns && col < c_hi)
                        ? ld_out<T, V>(out + (size_t)r * d + col)
                        : W();
        }
      }
    }
    int cur = 0;                                // the segment being summed
    int cur_end = __shfl_sync(kFull, rp, 1);
    for (int jb = beg; jb < end; jb += 32) {
      const int cnt = min(32, end - jb);
      int pj = 0;
      if (PERM && lane < cnt) pj = __ldg(perm + jb + lane);
      if constexpr (kStaged<T, V, PERM, ADD>) {   // the ring, R - 1 ahead
        constexpr int R = kRing<ADD>;
        W* ring = stage_ring<W, NC, R>();
        for (int i = 0; i + 1 < R; ++i)
          stage_entry<T, V, NC, R, PERM>(ring, msg, d, c0, c_hi, lane, pj, jb,
                                         i, cnt);
        for (int i = 0; i < cnt; ++i) {
          stage_entry<T, V, NC, R, PERM>(ring, msg, d, c0, c_hi, lane, pj, jb,
                                         i + R - 1, cnt);
          cp_wait<R - 1>();
          while (jb + i == cur_end)
            flush_row<T, V, NC, ADD>(out, d, c0, c_hi, orow, rp, ns, cur,
                                     cur_end, acc, o);
          const W* x = ring + (i % R) * NC * 32 + lane;
#pragma unroll
          for (int q = 0; q < NC; ++q)
            if (c0 + q * 32 * V < c_hi) add_raw<T, V>(acc[q], x[q * 32]);
        }
      } else {
        for (int u0 = 0; u0 < cnt; u0 += U) {
          W x[U][NC];
          load_rows<T, V, NC, PERM, U>(x, msg, d, c0, c_hi, pj, jb, u0, cnt);
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (u0 + u < cnt) {
              // entry j opens the next non-empty segment: flush the ones
              // it passes (the finished one and any empty ones)
              while (jb + u0 + u == cur_end)
                flush_row<T, V, NC, ADD>(out, d, c0, c_hi, orow, rp, ns, cur,
                                         cur_end, acc, o);
#pragma unroll
              for (int q = 0; q < NC; ++q) add_raw<T, V>(acc[q], x[u][q]);
            }
          }
        }
      }
    }
    while (cur < ns)                            // the last, and empty ones
      flush_row<T, V, NC, ADD>(out, d, c0, c_hi, orow, rp, ns, cur, cur_end,
                               acc, o);
  }
}

// Each mode's kernels have their own names, so that a profile, ptxas'
// report and a kernel's share of a step tell the modes apart.
template <typename T, int V, int NC, bool PERM>
__global__ void __launch_bounds__(kWarps * 32, SEG_SUM_MIN_BLOCKS)
segment_sum_kernel(const T* __restrict__ msg, const int* __restrict__ rowptr,
                   const int* __restrict__ perm, T* __restrict__ out,
                   int n_seg, int d, int group, int width, int slices) {
  rows_body<T, V, NC, PERM, false>(msg, rowptr, perm, nullptr, out, n_seg, d,
                                   0, group, width, slices);
}

template <typename T, int V, int NC, bool PERM>
__global__ void __launch_bounds__(kWarps * 32, SEG_ACC_MIN_BLOCKS)
segment_accumulate_kernel(const T* __restrict__ msg,
                          const int* __restrict__ rowptr,
                          const int* __restrict__ perm,
                          const int* __restrict__ rows, T* __restrict__ out,
                          int n_seg, int d, int seg_lo, int group, int width,
                          int slices) {
  rows_body<T, V, NC, PERM, true>(msg, rowptr, perm, rows, out, n_seg, d,
                                  seg_lo, group, width, slices);
}

// The team route's flush: segment cur's row gets write_row, acc is
// zeroed; in place, the prefetched rows move down and segment cur +
// kPrefetch's is loaded; then the team steps to its next segment.
template <typename T, int V, bool ADD>
__device__ __forceinline__ void flush_team(
    T* __restrict__ out, const int* __restrict__ rowptr,
    const int* __restrict__ rows, int d, int col, int seg_lo, int b,
    int& cur, int& cur_end, float (&acc)[V], Raw<T, V> (&o)[kHeld<ADD>]) {
  const int r = rows ? __ldg(rows + cur) : seg_lo + cur;
  write_row<T, V, ADD>(out + (size_t)r * d + col, o[0], acc);
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.f;
  if constexpr (ADD) {
#pragma unroll
    for (int p = 0; p + 1 < kPrefetch; ++p) o[p] = o[p + 1];
    const int nxt = cur + kPrefetch;
    if (nxt < b) {
      const int rn = rows ? __ldg(rows + nxt) : seg_lo + nxt;
      o[kPrefetch - 1] = ld_out<T, V>(out + (size_t)rn * d + col);
    }
  }
  ++cur;
  if (cur < b) cur_end = __ldg(rowptr + cur + 1);
}

// The team route, rows of d = team * V elements (team <= 32 lanes): a
// warp takes `group` consecutive segments, a whole number per team; team
// t walks its run of consecutive segments as the row kernel walks a
// group (kAhead entries' rows loaded before any is added and, in place,
// the rows of the next kPrefetch segments loaded ahead of their flush),
// lane u of it owning columns u * V .. u * V + V - 1. Lanes past 32 / team
// * team idle.
template <typename T, int V, bool PERM, bool ADD>
__device__ __forceinline__ void team_body(const T* __restrict__ msg,
                                          const int* __restrict__ rowptr,
                                          const int* __restrict__ perm,
                                          const int* __restrict__ rows,
                                          T* __restrict__ out, int n_seg,
                                          int d, int seg_lo, int group) {
  using W = Raw<T, V>;
  constexpr int U = kAhead<ADD>;
  const int lane = threadIdx.x & 31;
  const int team = d / V;
  const int teams = 32 / team;
  const int t = lane / team;
  if (t >= teams) return;                       // no shuffles below
  const int col = (lane - t * team) * V;
  const int per = group / teams;                // segments a team
  const int n_groups = (n_seg + group - 1) / group;
  const int warp_stride = gridDim.x * kWarps;
  for (int g = blockIdx.x * kWarps + (threadIdx.x >> 5); g < n_groups;
       g += warp_stride) {
    const int a = g * group + t * per;          // the team's [a, b)
    const int b = min(n_seg, a + per);
    if (a >= b) continue;
    W o[kHeld<ADD>];                            // rows of segments cur, ...
    if constexpr (ADD) {
#pragma unroll
      for (int p = 0; p < kPrefetch; ++p) {
        const int s = a + p;
        const int r = s < b ? (rows ? __ldg(rows + s) : seg_lo + s) : 0;
        o[p] = s < b ? ld_out<T, V>(out + (size_t)r * d + col) : W();
      }
    }
    float acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = 0.f;
    const int end = __ldg(rowptr + b);
    int cur = a;                                // the segment being summed
    int cur_end = __ldg(rowptr + a + 1);
    for (int j0 = __ldg(rowptr + a); j0 < end; j0 += U) {
      W x[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u;
        const size_t e = j < end ? (PERM ? (size_t)__ldg(perm + j) : (size_t)j)
                                 : 0;
        x[u] = j < end ? ld_msg<T, V>(msg + e * d + col) : W();
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (j0 + u < end) {
          while (j0 + u == cur_end)             // passed: flush
            flush_team<T, V, ADD>(out, rowptr, rows, d, col, seg_lo, b, cur,
                                  cur_end, acc, o);
          add_raw<T, V>(acc, x[u]);
        }
      }
    }
    while (cur < b)                             // the last, and empty ones
      flush_team<T, V, ADD>(out, rowptr, rows, d, col, seg_lo, b, cur,
                            cur_end, acc, o);
  }
}

template <typename T, int V, bool PERM>
__global__ void __launch_bounds__(kWarps * 32, SEG_SUM_MIN_BLOCKS)
segment_sum_kernel_team(const T* __restrict__ msg,
                        const int* __restrict__ rowptr,
                        const int* __restrict__ perm, T* __restrict__ out,
                        int n_seg, int d, int group) {
  team_body<T, V, PERM, false>(msg, rowptr, perm, nullptr, out, n_seg, d, 0,
                               group);
}

template <typename T, int V, bool PERM>
__global__ void __launch_bounds__(kWarps * 32, SEG_ACC_MIN_BLOCKS)
segment_accumulate_kernel_team(const T* __restrict__ msg,
                               const int* __restrict__ rowptr,
                               const int* __restrict__ perm,
                               const int* __restrict__ rows,
                               T* __restrict__ out, int n_seg, int d,
                               int seg_lo, int group) {
  team_body<T, V, PERM, true>(msg, rowptr, perm, rows, out, n_seg, d, seg_lo,
                              group);
}

struct AccArgs {
  const void* msg;
  const int* rowptr;
  const int* perm;
  const int* rows;
  void* out;
  int n_seg, d, seg_lo, group, width, slices, grid;
  cudaStream_t stream;
};

template <typename T, int V, int NC, bool PERM, bool ADD>
void launch_rows_as(const AccArgs& a) {
  const T* msg = static_cast<const T*>(a.msg);
  T* out = static_cast<T*>(a.out);
  if constexpr (ADD)
    segment_accumulate_kernel<T, V, NC, PERM>
        <<<a.grid, kWarps * 32, 0, a.stream>>>(msg, a.rowptr, a.perm, a.rows,
                                               out, a.n_seg, a.d, a.seg_lo,
                                               a.group, a.width, a.slices);
  else
    segment_sum_kernel<T, V, NC, PERM><<<a.grid, kWarps * 32, 0, a.stream>>>(
        msg, a.rowptr, a.perm, out, a.n_seg, a.d, a.group, a.width,
        a.slices);
}

template <typename T, int V, int NC, bool ADD>
int launch_rows(const AccArgs& a) {
  if (a.perm)
    launch_rows_as<T, V, NC, true, ADD>(a);
  else
    launch_rows_as<T, V, NC, false, ADD>(a);
  return (int)cudaGetLastError();
}

template <typename T, int V, bool PERM, bool ADD>
void launch_team_as(const AccArgs& a) {
  const T* msg = static_cast<const T*>(a.msg);
  T* out = static_cast<T*>(a.out);
  if constexpr (ADD)
    segment_accumulate_kernel_team<T, V, PERM>
        <<<a.grid, kWarps * 32, 0, a.stream>>>(msg, a.rowptr, a.perm, a.rows,
                                               out, a.n_seg, a.d, a.seg_lo,
                                               a.group);
  else
    segment_sum_kernel_team<T, V, PERM><<<a.grid, kWarps * 32, 0, a.stream>>>(
        msg, a.rowptr, a.perm, out, a.n_seg, a.d, a.group);
}

template <typename T, int V, bool ADD>
int launch_team(const AccArgs& a) {
  if (a.perm)
    launch_team_as<T, V, true, ADD>(a);
  else
    launch_team_as<T, V, false, ADD>(a);
  return (int)cudaGetLastError();
}

// route 0: the team kernel (d / V <= 32 lanes); route 1: the row kernel,
// NC = ceil(width / (32 V)) vectors a lane, at most kMaxNC<T, V>.
template <typename T, int V, bool ADD>
int dispatch(const AccArgs& a, int route) {
  if (route == 0)                               // whole teams to a warp
    return a.d / V <= 32 && a.group % (32 / (a.d / V)) == 0
               ? launch_team<T, V, ADD>(a)
               : (int)cudaErrorInvalidValue;
  const int nc = (a.width / V + 31) / 32;
  if (nc == 1) return launch_rows<T, V, 1, ADD>(a);
  if constexpr (kMaxNC<T, V> >= 2) {
    if (nc == 2) return launch_rows<T, V, 2, ADD>(a);
  }
  if constexpr (kMaxNC<T, V> >= 3) {
    if (nc == 3) return launch_rows<T, V, 3, ADD>(a);
  }
  if constexpr (kMaxNC<T, V> >= 4) {
    if (nc == 4) return launch_rows<T, V, 4, ADD>(a);
  }
  return (int)cudaErrorInvalidValue;
}

// Both entries: checks the plan, then launches it in the mode ADD.
template <bool ADD>
int run(const void* msg, const void* rowptr, const void* perm,
        const void* rows, void* out, int n_seg, int d, int seg_lo,
        int is_bf16, int route, int vec, int group, int slices, int grid,
        void* stream) {
  if (n_seg <= 0 || d <= 0 || vec < 1 || d % vec || group < 1 || grid < 1 ||
      grid > kAccBlocksCap || (route != 0 && route != 1) ||
      (route == 1 && (group > 31 || slices < 1 || slices > d / vec)))
    return (int)cudaErrorInvalidValue;
  const int n_vec = d / vec;
  const int width = route == 1 ? (n_vec + slices - 1) / slices * vec : d;
  if (route == 1 && (long long)(slices - 1) * width >= d)
    return (int)cudaErrorInvalidValue;           // an empty slice
  const AccArgs a{msg, static_cast<const int*>(rowptr),
                  static_cast<const int*>(perm), static_cast<const int*>(rows),
                  out, n_seg, d, seg_lo, group, width, slices, grid,
                  static_cast<cudaStream_t>(stream)};
  if (is_bf16) {
    switch (vec) {
      case 8: return dispatch<__nv_bfloat16, 8, ADD>(a, route);
      case 4: return dispatch<__nv_bfloat16, 4, ADD>(a, route);
      case 2: return dispatch<__nv_bfloat16, 2, ADD>(a, route);
      case 1: return dispatch<__nv_bfloat16, 1, ADD>(a, route);
    }
  } else {
    switch (vec) {
      case 4: return dispatch<float, 4, ADD>(a, route);
      case 2: return dispatch<float, 2, ADD>(a, route);
      case 1: return dispatch<float, 1, ADD>(a, route);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The plan, chosen by the caller (ops.sum_plan, ops.acc_plan): route 0
// (team: d / vec lanes a segment) or 1 (rows: a warp a (group, slice));
// vec, the elements per lane load (1, 2 or 4 fp32, 1, 2, 4 or 8 bf16; d %
// vec == 0, msg and out aligned to vec elements); group, the segments a
// warp (1..31 on route 1, a multiple of 32 / (d / vec) teams on route 0);
// slices, the column slices of route 1, each ceil(d / vec / slices)
// vectors wide; grid, the blocks of 8 warps (a grid-stride loop covers the
// rest).
//
// The summing mode. msg (E, d) of fp32 (is_bf16 = 0) or bf16 (is_bf16 =
// 1), contiguous; rowptr (n_seg + 1,) int32; perm (E',) int32 or null; out
// points at the first of n_seg contiguous output rows of width d, each
// written once and none read.
extern "C" int segment_sum_csr(const void* msg, const void* rowptr,
                               const void* perm, void* out, int n_seg, int d,
                               int is_bf16, int route, int vec, int group,
                               int slices, int grid, void* stream) {
  return run<false>(msg, rowptr, perm, nullptr, out, n_seg, d, 0, is_bf16,
                    route, vec, group, slices, grid, stream);
}

// The in-place mode. msg as above; rows (n_seg,) int32 distinct row ids or
// null (then rows seg_lo .. seg_lo + n_seg - 1); out (R, d) contiguous,
// msg's dtype, updated in place.
extern "C" int segment_sum_csr_accumulate(const void* msg, const void* rowptr,
                                          const void* perm, const void* rows,
                                          void* out, int n_seg, int d,
                                          int seg_lo, int is_bf16, int route,
                                          int vec, int group, int slices,
                                          int grid, void* stream) {
  return run<true>(msg, rowptr, perm, rows, out, n_seg, d, seg_lo, is_bf16,
                   route, vec, group, slices, grid, stream);
}
