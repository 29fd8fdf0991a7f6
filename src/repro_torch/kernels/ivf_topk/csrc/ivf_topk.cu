// Fused int8 scan + per-chunk (max, argmax): the IVF hot loop on Hopper.
//
// Replaces the two Pallas kernels of src/repro/kernels/ivf_topk/ivf_topk.py:
//   ivf_probe_scan  <- scan_topk_pallas_batched (body _kernel_batched): the
//                      IVF probe, each query against its own probed partitions
//   ivf_shared_scan <- scan_topk_pallas (body _kernel): every query against
//                      one shared slab (the delta store, chunk = 1)
//
// Both compute, per (query q, row r),
//     score = scale[r] * (q . code[r]) + qsum[q] * aff[r] + bias[r]
// with code[r] the int8 row (centred at -128), aff = 128*scale + vmin and
// bias = 0 (live) or -3e38 (masked), then the max and the first argmax of
// every `chunk` consecutive rows. Rows past the end score -3e38.
//
// What bounds them on an H100: operations. At the serving shape (Q = 256,
// d = 384, 8 probes of 32,769 rows) the probe scan does 51.5 GFLOP of fp32
// FMA over at most 805 MB of distinct slab bytes, 64 FLOP per byte: above the
// fp32 ridge of 67 TFLOP/s over 3.35 TB/s (20 FLOP/byte). The design keeps
// the FMA pipe fed and does not dequantize in memory:
//   * int8 rows are read straight from the flat (K*cap, d) slab (probe list
//     per query, no (Q, M, d) gather), 16 bytes per thread per load, eight
//     threads per row so that a row is read as coalesced 128-byte segments;
//   * each thread keeps its slice of the query (the same dims for every row)
//     in registers, staged once per block through shared memory;
//   * a byte becomes an exact fp32 with one byte-permute and one add (the
//     2^23 magic-number trick) instead of a slower int-to-float conversion;
//   * the eight partial sums meet by warp shuffles, and a block writes its
//     tile of scores to shared memory, where one thread per chunk takes the
//     max and argmax.
// Tensor cores (a bf16 split of the query against the exact int8 codes) and
// reading each probed partition once for all the queries that probe it are
// the next steps.
//
// Plain C interface for ctypes; each entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;                          // threads per row
constexpr int kGroupsPerBlock = kThreads / kGroup;  // rows in flight
constexpr int kTileRows = 1024;                    // rows per block (rounded to chunks)
constexpr int kMaxVecPerThread = 8;                // 16-byte vectors: d <= 1024
constexpr float kNeg = -3e38f;

// Slab row of query q's r-th scanned row.
struct ProbeRows {
  const int32_t* probes;
  int n_probe;
  int cap;
  __device__ __forceinline__ size_t operator()(int q, int r) const {
    const int p = probes[(size_t)q * n_probe + r / cap];
    return (size_t)p * cap + (size_t)(r % cap);
  }
};

struct SharedRows {
  __device__ __forceinline__ size_t operator()(int, int r) const {
    return (size_t)r;
  }
};

// Four int8 codes -> four exact fp32 values. With the sign bits flipped,
// byte i reads u = code + 128; 0x4B000000 | u is the float 2^23 + u.
__device__ __forceinline__ void bytes4(unsigned w, float& a, float& b,
                                       float& c, float& e) {
  w ^= 0x80808080u;
  const float off = 8388736.0f;  // 2^23 + 128
  a = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440)) - off;
  b = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7441)) - off;
  c = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7442)) - off;
  e = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7443)) - off;
}

// grid: (Q, tiles); block: kThreads. Dynamic shared memory: d + tile_rows
// floats. VPT: 16-byte vectors per thread (0 = bytewise loop over the row,
// for widths or pointers that are not 16-byte aligned).
template <int VPT, class RowMap>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const float* __restrict__ q, const float* __restrict__ qsum,
            const int8_t* __restrict__ data, const float* __restrict__ aff,
            const float* __restrict__ scale, const float* __restrict__ bias,
            RowMap rowmap, int d, int m, int chunk, int tile_rows,
            int n_chunks, float* __restrict__ cmax,
            int32_t* __restrict__ carg) {
  extern __shared__ float smem[];
  float* qs = smem;            // (d,) query row
  float* sc = smem + d;        // (tile_rows,) scores of this tile
  const int qi = blockIdx.x;
  const int row0 = blockIdx.y * tile_rows;
  for (int j = threadIdx.x; j < d; j += kThreads) qs[j] = q[(size_t)qi * d + j];
  __syncthreads();

  const int g = threadIdx.x / kGroup;
  const int t = threadIdx.x % kGroup;
  const int nvec = VPT > 0 ? d / 16 : 0;
  const int tail0 = nvec * 16;
  float qr[VPT > 0 ? VPT * 16 : 1];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int v = t + kGroup * i;
#pragma unroll
    for (int e = 0; e < 16; ++e) qr[i * 16 + e] = v < nvec ? qs[v * 16 + e] : 0.f;
  }
  const float qsq = qsum[qi];

  // every lane of a warp runs the same trip count: the shuffles below need
  // the whole warp
  for (int base = 0; base < tile_rows; base += kGroupsPerBlock) {
    const int rl = base + g;
    const int r = row0 + rl;
    const bool live = rl < tile_rows && r < m;
    size_t sr = 0;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    if (live) {
      sr = rowmap(qi, r);
      const int8_t* row = data + sr * (size_t)d;
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        const int v = t + kGroup * i;
        if (v < nvec) {
          const int4 w = __ldg(reinterpret_cast<const int4*>(row) + v);
          const float* qv = qr + i * 16;
          float x0, x1, x2, x3;
          bytes4((unsigned)w.x, x0, x1, x2, x3);
          a0 = fmaf(qv[0], x0, a0); a1 = fmaf(qv[1], x1, a1);
          a2 = fmaf(qv[2], x2, a2); a3 = fmaf(qv[3], x3, a3);
          bytes4((unsigned)w.y, x0, x1, x2, x3);
          a0 = fmaf(qv[4], x0, a0); a1 = fmaf(qv[5], x1, a1);
          a2 = fmaf(qv[6], x2, a2); a3 = fmaf(qv[7], x3, a3);
          bytes4((unsigned)w.z, x0, x1, x2, x3);
          a0 = fmaf(qv[8], x0, a0); a1 = fmaf(qv[9], x1, a1);
          a2 = fmaf(qv[10], x2, a2); a3 = fmaf(qv[11], x3, a3);
          bytes4((unsigned)w.w, x0, x1, x2, x3);
          a0 = fmaf(qv[12], x0, a0); a1 = fmaf(qv[13], x1, a1);
          a2 = fmaf(qv[14], x2, a2); a3 = fmaf(qv[15], x3, a3);
        }
      }
      for (int j = tail0 + t; j < d; j += kGroup)
        a0 = fmaf(qs[j], (float)row[j], a0);
    }
    float acc = (a0 + a1) + (a2 + a3);
    acc += __shfl_xor_sync(0xffffffffu, acc, 4);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (t == 0 && rl < tile_rows)
      sc[rl] = live ? acc * scale[sr] + qsq * aff[sr] + bias[sr] : kNeg;
  }
  __syncthreads();

  const int tile_chunks = tile_rows / chunk;
  const int chunk0 = blockIdx.y * tile_chunks;
  for (int c = threadIdx.x; c < tile_chunks; c += kThreads) {
    const int gc = chunk0 + c;
    if (gc >= n_chunks) break;
    const float* s = sc + c * chunk;
    float best = s[0];
    int arg = 0;
    for (int j = 1; j < chunk; ++j) {
      if (s[j] > best) { best = s[j]; arg = j; }
    }
    cmax[(size_t)qi * n_chunks + gc] = best;
    carg[(size_t)qi * n_chunks + gc] = gc * chunk + arg;
  }
}

template <class RowMap>
int launch(const float* q, const float* qsum, const int8_t* data,
           const float* aff, const float* scale, const float* bias,
           RowMap rowmap, int nq, int d, int m, int chunk, int vec_ok,
           float* cmax, int32_t* carg, cudaStream_t stream) {
  if (nq <= 0 || m <= 0) return (int)cudaGetLastError();
  if (chunk < 1 || chunk > kTileRows || d < 1) return (int)cudaErrorInvalidValue;
  const int tile_chunks = kTileRows / chunk;
  const int tile_rows = tile_chunks * chunk;
  const int n_chunks = (m + chunk - 1) / chunk;
  const int tiles = (n_chunks + tile_chunks - 1) / tile_chunks;
  if (tiles > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid(nq, tiles);
  const size_t smem = (size_t)(d + tile_rows) * sizeof(float);
  int vpt = 0;
  if (vec_ok && d % 16 == 0) {
    vpt = (d / 16 + kGroup - 1) / kGroup;
    if (vpt > kMaxVecPerThread) vpt = 0;
  }
#define SCAN_CASE(V)                                                        \
  case V:                                                                   \
    scan_kernel<V, RowMap><<<grid, kThreads, smem, stream>>>(               \
        q, qsum, data, aff, scale, bias, rowmap, d, m, chunk, tile_rows,    \
        n_chunks, cmax, carg);                                              \
    break;
  switch (vpt) {
    SCAN_CASE(0) SCAN_CASE(1) SCAN_CASE(2) SCAN_CASE(3)
    SCAN_CASE(4) SCAN_CASE(5) SCAN_CASE(6) SCAN_CASE(7) SCAN_CASE(8)
  }
#undef SCAN_CASE
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Probe scan: query q's r-th row (r < n_probe * cap) is slab row
// probes[q, r / cap] * cap + r % cap. Outputs (nq, ceil(n_probe*cap/chunk)).
int ivf_probe_scan(const void* q, const void* qsum, const void* slab,
                   const void* aff, const void* scale, const void* bias,
                   const void* probes, int nq, int d, int n_probe, int cap,
                   int chunk, int vec_ok, void* cmax, void* carg,
                   void* stream) {
  ProbeRows rows{static_cast<const int32_t*>(probes), n_probe, cap};
  return launch(static_cast<const float*>(q), static_cast<const float*>(qsum),
                static_cast<const int8_t*>(slab),
                static_cast<const float*>(aff),
                static_cast<const float*>(scale),
                static_cast<const float*>(bias), rows, nq, d, n_probe * cap,
                chunk, vec_ok, static_cast<float*>(cmax),
                static_cast<int32_t*>(carg),
                static_cast<cudaStream_t>(stream));
}

// Shared-slab scan: every query against rows [0, n). Outputs
// (nq, ceil(n/chunk)).
int ivf_shared_scan(const void* q, const void* qsum, const void* data,
                    const void* aff, const void* scale, const void* bias,
                    int nq, int n, int d, int chunk, int vec_ok, void* cmax,
                    void* carg, void* stream) {
  return launch(static_cast<const float*>(q), static_cast<const float*>(qsum),
                static_cast<const int8_t*>(data),
                static_cast<const float*>(aff),
                static_cast<const float*>(scale),
                static_cast<const float*>(bias), SharedRows{}, nq, d, n, chunk,
                vec_ok, static_cast<float*>(cmax),
                static_cast<int32_t*>(carg),
                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
