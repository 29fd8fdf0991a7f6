// Fused int8 scan + per-chunk (max, argmax) on the tensor cores: the IVF
// hot loop on Hopper.
//
// Replaces the two Pallas kernels of src/repro/kernels/ivf_topk/ivf_topk.py:
//   ivf_probe_scan  <- scan_topk_pallas_batched (body _kernel_batched): the
//                      IVF probe, each query against its own probed partitions
//   ivf_shared_scan <- scan_topk_pallas (body _kernel): every query against
//                      one shared slab (the delta store)
// Both run the one device routine below, `scan_mma_kernel`.
//
// Function. Per (query q, row r),
//     score = scale[r] * (q . code[r]) + qsum[q] * aff[r] + bias[r]
// with code[r] the int8 row (centred at -128), aff = 128*scale + vmin and
// bias = 0 (live) or -3e38 (masked); then, per segment of `cap` rows (one
// probed partition; the whole slab for the shared scan), the max and the
// first argmax of every `chunk` consecutive rows, chunk c covering rows
// [c*chunk, min((c+1)*chunk, cap)) of its segment. Rows past a segment's end
// score -3e38.
//
// Arithmetic. The codes are exact int8. The wrapper (ops.query_limbs)
// splits each fp32 query into kLimbs = 4 int8 limbs and one fp32 step
// s = max|q| / 127:  q ~= s * sum_i a_i * 2^(-7 i), a_0 in [-127, 127] and
// each later limb the rounded residual of the one before, in [-64, 64]. The
// tensor cores form every sum_d a_i[d] * code[d] as an exact int32
// (|sum| <= d * 128 * 127 < 2^31), and each element combines
// its limbs in fp32 in one fixed order,
//     v = ((c3 * 2^-7 + c2) * 2^-7 + c1) * 2^-7 + c0,   dot = v * s,
// then score = (dot * scale + qsum * aff) + bias, each step rounded once. A
// score thus depends on its query and row only: not on the tile, the batch
// or the other queries of a launch (ref.*_scan_limbs computes the same bits).
// Per element the limb residual is at most s * 2^-(7*4-6) = s * 2^-22, so a
// dot product is off by at most d * 128 * s * 2^-22 and a score by that
// times |scale|: 3.3e-6 at d = 384, max|q| = 3.5 and scale = 0.01, under the
// 1e-4 score tolerance (L = 3 would give 4.2e-4).
//
// What bounds it on an H100. Probe scan at serve_1m (Q 256, d 384, 8 probes
// of 32,769 rows of 64 partitions): every probed partition is read once per
// batch, 0.83 GB of codes plus 34 MB of chunk outputs, 0.26 ms at 3.35 TB/s;
// the 4 limb passes are 206 G int8 operations, 0.10 ms at 1,979 TOP/s: bound
// by bytes. Shared scan at Q 256 x N 65,536 (chunk 1): 51.5 G operations,
// 0.026 ms, under the 0.048 ms of its (Q, N) output plane: bound by bytes.
// What holds this design back on the card is latency, not the tensor cores
// (dropping the products saves 0.29 of the probe's 0.95 ms; PERF.md). The
// design:
//   * grid (row-tile blocks, partitions, pair-group splits); a block walks
//     row tiles of 128 rows (64 for rows wider than 1,152 bytes) of its
//     partition and, for each tile, the (query, probe) pairs that probe the
//     partition, 16 at a time (the wrapper sorts the pairs by partition on
//     the device). A partition nobody probes exits at once. So a probed row
//     is read from memory once per batch, not once per query. A scan with
//     few tiles (a small delta) splits the pair groups over blockIdx.z;
//   * a row tile arrives by TMA bulk copies (one per row, into rows padded
//     to an odd multiple of 16 bytes so that ldmatrix reads them without
//     bank conflicts), completing on an mbarrier. A pair group's limbs
//     arrive by cp.async into a two-stage ring, one group ahead. One block
//     barrier per step (tile x group). Two blocks of 8 warps share an SM
//     (103 KB of shared memory each at d = 384), so one block's tile load
//     overlaps the other's products (one block per SM with a 3-stage tile
//     ring and resident limbs measured slower);
//   * mma.sync.m16n8k32 s8 x s8 -> s32 with ldmatrix.x4 fragments: 8 warps,
//     each 32 rows x (8 pairs x 4 limbs), one n8 tile per limb;
//   * the row terms (scale, aff, bias) and the pairs' steps are loaded into
//     registers before the products, so their latency hides behind them;
//   * the chunk (max, first argmax) comes from registers and warp shuffles
//     when the chunk is a power of two up to 32 (the probe path's 16, the
//     delta's 1); other chunks go through a score tile in shared memory,
//     reduced by lane groups.
// Widths that are not a multiple of 16 bytes, or a slab view that is not
// 16-byte aligned, take a bytewise load route into the same shared tile
// (its padding columns meet zero limb columns); the MMA path is the same.
//
// Plain C interface for ctypes; each entry returns a cudaError_t code.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileRows = 128;  // rows of a tile: 4 warps x 32 (64 for d > 1,152)
constexpr int kWarpRows = 32;   // two m16 tiles per warp
constexpr int kPairs = 16;      // (query, probe) pairs per group: 2 x n8
constexpr int kLimbs = 4;       // int8 limbs per query
constexpr int kMaxSmem = 232448;
constexpr float kNeg = -3e38f;

struct Args {
  const int8_t* data;     // (n_parts * cap, d) codes
  const float* aff;       // (n_parts * cap,)
  const float* scale;
  const float* bias;
  const int8_t* limbs;    // (nq, kLimbs, dp), zero past d
  const float* qscale;    // (nq,) the limbs' step s
  const float* qsum;      // (nq,)
  const int64_t* order;   // (nq * n_probe,) pair ids q * n_probe + j sorted
                          // by partition; null: pairs 0..nq-1 (shared scan)
  const int32_t* offsets; // (n_parts + 1,) into order; null: [0, nq)
  float* cmax;            // (nq, n_probe * nchp)
  int32_t* carg;
  int nq, d, dp, stride, n_probe, cap, chunk, tile_rows, n_tiles, nchp;
  int tm;                 // rows of a shared tile: kTileRows, or 64 for wide rows
  int lanes;              // else: threads per chunk in the smem reduction
  int b_stages, vec_ok;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared.b64 [%0], 1;\n" ::"r"(smem_u32(bar)));
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes),
      "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (v, row) beats (best, arg): larger, or equal at an earlier row.
__device__ __forceinline__ void take_max(float& best, int& arg, float v,
                                         int row) {
  if (v > best || (v == best && row < arg)) { best = v; arg = row; }
}

// Rows [tile * tile_rows, +tile_rows) of segment `part` (clipped at cap) into
// a shared tile of row stride `stride`. Bulk route: warp 0 issues one TMA
// bulk copy per row, completing on `bar`. Bytewise route: every thread,
// synchronously (the caller then needs a block barrier).
__device__ __forceinline__ void load_tile(const Args& a, int part, int tile,
                                          int8_t* dst, uint64_t* bar) {
  const int r0 = tile * a.tile_rows;
  const int nrows = min(a.tile_rows, a.cap - r0);
  const int8_t* src = a.data + ((size_t)part * a.cap + r0) * (size_t)a.d;
  if (a.vec_ok) {
    if (threadIdx.x < 32) {
      if (threadIdx.x == 0) mbar_expect(bar, (unsigned)(nrows * a.d));
      __syncwarp();
      for (int r = threadIdx.x; r < nrows; r += 32)
        bulk_copy(dst + r * a.stride, src + (size_t)r * a.d, a.d, bar);
    }
  } else {
    for (int i = threadIdx.x; i < nrows * a.d; i += kThreads) {
      const int r = i / a.d, c = i - r * a.d;
      dst[r * a.stride + c] = src[(size_t)r * a.d + c];
    }
  }
}

__device__ __forceinline__ int pair_id(const Args& a, int idx) {
  return a.order ? (int)__ldg(a.order + idx) : idx;
}

struct PairMeta {
  int q, j;        // query, probe
  float s, qsum;   // the query's limb step and sum
};

// The limbs of pairs [p0, p0 + cnt) into dst[limb][pair][stride] (cp.async),
// and each pair's meta (read a step ahead, off the products' path). Threads
// 16p..16p+15 copy pair p's kLimbs * dp / 16 vectors (one query's limbs are
// contiguous).
__device__ __forceinline__ void load_limbs(const Args& a, int p0, int cnt,
                                           int8_t* dst, PairMeta* meta) {
  constexpr int kLanes = kThreads / kPairs;
  const int p = threadIdx.x / kLanes, lp = threadIdx.x % kLanes;
  PairMeta m{0, 0, 0.f, 0.f};
  if (p < cnt) {
    const int f = pair_id(a, p0 + p);
    m.q = f / a.n_probe;
    m.j = f - m.q * a.n_probe;
    if (lp == 0) {
      m.s = __ldg(a.qscale + m.q);
      m.qsum = __ldg(a.qsum + m.q);
    }
  }
  if (lp == 0) meta[p] = m;
  if (p >= cnt) return;
  const int q = m.q;
  const int nv = a.dp >> 4;
  const int8_t* src = a.limbs + (size_t)q * kLimbs * a.dp;
  int l = lp / nv, v = lp - l * nv;
  for (int i = lp; i < kLimbs * nv; i += kLanes) {
    cp16(dst + (l * kPairs + p) * a.stride + v * 16, src + i * 16);
    v += kLanes;
    while (v >= nv) { v -= nv; ++l; }
  }
}

// grid: (row-tile blocks, segments, pair-group splits); block: kThreads.
// Dynamic shared memory: one row tile, b_stages limb tiles (+ pair meta),
// the row tile's mbarrier, and a score tile when the chunk is reduced in
// shared memory. CHUNK: the chunk when it is a power of two <= 32 (reduced
// in registers), else 0.
template <int CHUNK>
__global__ void __launch_bounds__(kThreads, 2)
scan_mma_kernel(const Args a) {
  extern __shared__ __align__(128) int8_t smem[];
  const int part = blockIdx.y;
  const int off = a.offsets ? a.offsets[part] : 0;
  const int end = a.offsets ? a.offsets[part + 1] : a.nq;
  if (off >= end) return;                      // nobody probes this partition
  const int tile_bytes = a.tm * a.stride;
  const int limb_bytes = kLimbs * kPairs * a.stride;
  int8_t* s_tile = smem;
  int8_t* s_limb = smem + tile_bytes;
  PairMeta* s_meta =
      reinterpret_cast<PairMeta*>(s_limb + a.b_stages * limb_bytes);
  uint64_t* s_bar = reinterpret_cast<uint64_t*>(s_meta + 2 * kPairs);
  float* s_score = reinterpret_cast<float*>(s_bar + 1);

  // this block's row tiles (blockIdx.x + i * gridDim.x) and pair groups
  // (blockIdx.z + i * gridDim.z): a scan with few tiles splits its groups
  // over blockIdx.z
  const int all_groups = (end - off + kPairs - 1) / kPairs;
  if ((int)blockIdx.z >= all_groups) return;
  const int ngroups = (all_groups - (int)blockIdx.z + (int)gridDim.z - 1) /
                      (int)gridDim.z;
  const int my_tiles = (a.n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                       (int)gridDim.x;
  const int steps = my_tiles * ngroups;
  auto tile_of = [&](int i) { return (int)blockIdx.x + i * (int)gridDim.x; };
  auto group_p0 = [&](int gi) {
    return off + ((int)blockIdx.z + gi * (int)gridDim.z) * kPairs;
  };
  auto group_cnt = [&](int gi) { return min(kPairs, end - group_p0(gi)); };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = (warp & 3) * kWarpRows;     // this warp's rows of a tile
  const int wpair = (warp >> 2) * 8;           // and its 8 pairs of a group
  // ldmatrix row addresses: rows as m16 x k32 = 4 matrices 8 x 16 B; limbs
  // (8 pairs x k32 per limb) = 2 matrices, two limbs per x4
  const int a_off = (wrow + (lane & 7) + ((lane >> 3) & 1) * 8) * a.stride +
                    (lane >> 4) * 16;
  const int b_off = ((lane >> 4) * kPairs + wpair + (lane & 7)) * a.stride +
                    ((lane >> 3) & 1) * 16;

  if (threadIdx.x == 0) {
    mbar_init(s_bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (a.vec_ok) load_tile(a, part, tile_of(0), s_tile, s_bar);
  if (a.b_stages == 2) {
    load_limbs(a, group_p0(0), group_cnt(0), s_limb, s_meta);
    cp_commit();
  }

  float rs[2][2], ra[2][2], rb[2][2];   // row terms, loaded once per tile
  for (int s = 0; s < steps; ++s) {
    const int ti = s / ngroups, gi = s - ti * ngroups;
    const int bbuf = a.b_stages == 2 ? (s & 1) : 0;
    const int tile = tile_of(ti);
    cp_wait_all();
    __syncthreads();   // this step's limbs are in; every warp left step s-1
    if (a.b_stages == 2) {
      if (s + 1 < steps) {
        const int gn = (s + 1) % ngroups;
        load_limbs(a, group_p0(gn), group_cnt(gn),
                   s_limb + ((s + 1) & 1) * limb_bytes,
                   s_meta + ((s + 1) & 1) * kPairs);
        cp_commit();
      }
    } else {
      load_limbs(a, group_p0(gi), group_cnt(gi), s_limb, s_meta);
      cp_commit();
      cp_wait_all();
      __syncthreads();
    }
    if (gi == 0) {     // a new tile; every warp is done with the last one
      if (!a.vec_ok) {
        load_tile(a, part, tile, s_tile, nullptr);
        __syncthreads();
      } else if (ti > 0) {
        load_tile(a, part, tile, s_tile, s_bar);
      }
    }
    // the ti-th fill of the tile completes its mbarrier's phase ti
    if (a.vec_ok) mbar_wait(s_bar, ti & 1);

    // ---- operands of the epilogue, loaded ahead of the products
    const int r0 = tile * a.tile_rows;
    const int cnt = group_cnt(gi);
    const PairMeta* meta = s_meta + bbuf * kPairs;
    PairMeta pm[2];
    pm[0] = meta[wpair + t * 2];
    pm[1] = meta[wpair + t * 2 + 1];
    if (gi == 0) {   // the row terms of this warp's rows, once per tile
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rl = wrow + m * 16 + h * 8 + g;
          const int r = r0 + rl;
          rs[m][h] = ra[m][h] = rb[m][h] = 0.f;
          if (rl < a.tile_rows && r < a.cap) {
            const size_t sr = (size_t)part * a.cap + r;
            rs[m][h] = __ldg(a.scale + sr);
            ra[m][h] = __ldg(a.aff + sr);
            rb[m][h] = __ldg(a.bias + sr);
          }
        }
    }

    // ---- tensor-core products: 32 rows x (8 pairs x 4 limbs) per warp
    // (with 64-row tiles, warps past them only keep the barriers)
    int acc[2][kLimbs][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int l = 0; l < kLimbs; ++l)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][l][e] = 0;
    const unsigned a_addr = smem_u32(s_tile + a_off);
    const unsigned b_addr = smem_u32(s_limb + bbuf * limb_bytes + b_off);
    const unsigned b_half = 2 * kPairs * a.stride;   // limbs 2, 3
    const int k_end = wrow < a.tm ? a.dp : 0;
#pragma unroll 4
    for (int k0 = 0; k0 < k_end; k0 += 32) {
      unsigned a0[4], a1[4], b01[4], b23[4];
      ldsm_x4(a0, a_addr + k0);
      ldsm_x4(a1, a_addr + 16 * a.stride + k0);
      ldsm_x4(b01, b_addr + k0);
      ldsm_x4(b23, b_addr + b_half + k0);
      mma_s8(acc[0][0], a0, b01[0], b01[1]);
      mma_s8(acc[0][1], a0, b01[2], b01[3]);
      mma_s8(acc[0][2], a0, b23[0], b23[1]);
      mma_s8(acc[0][3], a0, b23[2], b23[3]);
      mma_s8(acc[1][0], a1, b01[0], b01[1]);
      mma_s8(acc[1][1], a1, b01[2], b01[3]);
      mma_s8(acc[1][2], a1, b23[0], b23[1]);
      mma_s8(acc[1][3], a1, b23[2], b23[3]);
    }

    // ---- combine limbs, affine terms, mask. Element (m, h, e): tile row
    // wrow + m*16 + h*8 + g, pair wpair + t*2 + e
    float sc[2][2][2];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = wrow + m * 16 + h * 8 + g;
        const bool live = rl < a.tile_rows && r0 + rl < a.cap;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = h * 2 + e;
          float v = __int2float_rn(acc[m][3][c]);
          v = __fadd_rn(__fmul_rn(v, 0.0078125f), __int2float_rn(acc[m][2][c]));
          v = __fadd_rn(__fmul_rn(v, 0.0078125f), __int2float_rn(acc[m][1][c]));
          v = __fadd_rn(__fmul_rn(v, 0.0078125f), __int2float_rn(acc[m][0][c]));
          const float dot = __fmul_rn(v, pm[e].s);
          const float score = __fadd_rn(
              __fadd_rn(__fmul_rn(dot, rs[m][h]), __fmul_rn(pm[e].qsum, ra[m][h])),
              rb[m][h]);
          sc[m][h][e] = live ? score : kNeg;
        }
      }

    const size_t ncols = (size_t)a.n_probe * a.nchp;
    if (CHUNK > 0) {
      // ---- chunk (max, first argmax) in registers: a chunk of c <= 8 rows
      // spans c lanes' g; 16 adds the two h halves, 32 the two m tiles
      constexpr int c = CHUNK > 0 ? CHUNK : 1;
      int arg[2][2][2];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) arg[m][h][e] = wrow + m * 16 + h * 8 + g;
      if (c >= 32) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            take_max(sc[0][h][e], arg[0][h][e], sc[1][h][e], arg[1][h][e]);
      }
      if (c >= 16) {
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            take_max(sc[m][0][e], arg[m][0][e], sc[m][1][e], arg[m][1][e]);
      }
      constexpr int span = c < 8 ? c : 8;      // lanes' g per chunk
      constexpr int nm = c >= 32 ? 1 : 2, nh = c >= 16 ? 1 : 2;
#pragma unroll
      for (int o = 4; o < 4 * span; o <<= 1) {
#pragma unroll
        for (int m = 0; m < nm; ++m)
#pragma unroll
          for (int h = 0; h < nh; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float ov = __shfl_xor_sync(0xffffffffu, sc[m][h][e], o);
              const int oa = __shfl_xor_sync(0xffffffffu, arg[m][h][e], o);
              take_max(sc[m][h][e], arg[m][h][e], ov, oa);
            }
      }
      if (g % span == 0) {
#pragma unroll
        for (int m = 0; m < nm; ++m)
#pragma unroll
          for (int h = 0; h < nh; ++h) {
            const int first = wrow + m * 16 + h * 8 + g;   // chunk's first row
            const int cg = (r0 + first) / c;
            if (first >= a.tile_rows || cg >= a.nchp) continue;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (wpair + t * 2 + e >= cnt) continue;
              const size_t o =
                  (size_t)pm[e].q * ncols + (size_t)pm[e].j * a.nchp + cg;
              a.cmax[o] = sc[m][h][e];
              a.carg[o] = pm[e].j * a.cap + r0 + arg[m][h][e];
            }
          }
      }
    } else {
      // ---- other chunks: scores through shared memory, `lanes` threads
      // per (pair, chunk)
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (wrow < a.tm)
              s_score[(wpair + t * 2 + e) * a.tm + wrow + m * 16 + h * 8 + g] =
                  sc[m][h][e];
      __syncthreads();
      const int per = a.tile_rows / a.chunk;
      const int tasks = kPairs * per;
      const int slots = kThreads / a.lanes;
      const int lg = threadIdx.x & (a.lanes - 1);
      for (int base = 0; base < tasks; base += slots) {
        const int task = base + threadIdx.x / a.lanes;
        float best = -__int_as_float(0x7f800000);
        int barg = 0, p = 0, ch = 0;
        if (task < tasks) {
          p = task / per;
          ch = task - p * per;
          const float* sp = s_score + p * a.tm + ch * a.chunk;
          for (int j = lg; j < a.chunk; j += a.lanes) {
            const float v = sp[j];
            if (v > best) { best = v; barg = j; }
          }
        }
        for (int o = a.lanes >> 1; o > 0; o >>= 1) {
          const float ob = __shfl_xor_sync(0xffffffffu, best, o);
          const int oa = __shfl_xor_sync(0xffffffffu, barg, o);
          take_max(best, barg, ob, oa);
        }
        const int cg = tile * per + ch;
        if (lg == 0 && task < tasks && p < cnt && cg < a.nchp) {
          const PairMeta mt = meta[p];
          const size_t o = (size_t)mt.q * ncols + (size_t)mt.j * a.nchp + cg;
          a.cmax[o] = best;
          a.carg[o] = mt.j * a.cap + cg * a.chunk + barg;
        }
      }
      // the next step's barrier keeps s_score until every task has read it
    }
  }
}

// How a launch is cut: tile rows, grid, ring stages, shared memory.
struct Plan {
  int tm, tile_rows, n_tiles, nchp, grid_x, grid_z, b_stages, lanes;
  int reg_chunk;
  size_t smem;
};

int make_plan(int d, int chunk, int cap, int n_parts, int n_pairs,
              Plan* p) {
  if (chunk < 1 || d < 1 || cap < 1 || n_parts < 1 || n_parts > 65535)
    return (int)cudaErrorInvalidValue;
  const int dp = (d + 31) / 32 * 32;
  const int stride = dp + 16;
  p->reg_chunk = chunk <= 32 && (chunk & (chunk - 1)) == 0;
  // a 128-row tile and one limb stage (and the score tile) must fit; else
  // 64-row tiles (d > 1,152)
  const size_t limb = (size_t)kLimbs * kPairs * stride;
  const size_t meta = 2 * kPairs * sizeof(PairMeta) + sizeof(uint64_t);
  auto fixed = [&](int tm) {
    return meta + (p->reg_chunk ? 0 : (size_t)kPairs * tm * 4);
  };
  p->tm = fixed(kTileRows) + (size_t)kTileRows * stride + limb <= kMaxSmem
              ? kTileRows : 64;
  if (chunk > p->tm) return (int)cudaErrorInvalidValue;
  p->tile_rows = p->tm / chunk * chunk;
  p->n_tiles = (cap + p->tile_rows - 1) / p->tile_rows;
  p->nchp = (cap + chunk - 1) / chunk;
  p->lanes = 1;
  while (p->lanes * 2 <= chunk && p->lanes < 32) p->lanes *= 2;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // tiles per block: enough blocks for ~4 waves, up to 8 tiles each (the
  // time barely moves with it: 0.93-0.97 ms probe for 1 to 8 on an H100)
  const long total = (long)p->n_tiles * n_parts;
  int tpb = (int)(total / ((long)sms * 4));
  tpb = tpb < 1 ? 1 : (tpb > 8 ? 8 : tpb);
  p->grid_x = (p->n_tiles + tpb - 1) / tpb;
  // few blocks (a small shared scan): split each tile's pair groups over
  // blockIdx.z, so that two blocks per SM have work
  const long blocks = (long)p->grid_x * n_parts;
  const int groups = (n_pairs + kPairs - 1) / kPairs;
  p->grid_z = blocks >= 2L * sms ? 1 : (int)((2L * sms + blocks - 1) / blocks);
  if (p->grid_z > groups) p->grid_z = groups > 0 ? groups : 1;
  if (p->grid_z > 65535) p->grid_z = 65535;
  // a two-stage limb ring where it fits: at d = 384 one tile and two limb
  // stages take 103 KB, two blocks per SM; at d = 1,280 (64-row tiles) two
  // limb stages do not fit (249 KB), one takes 166 KB
  const size_t tile = (size_t)p->tm * stride;
  const size_t fix = fixed(p->tm);
  p->b_stages = fix + tile + 2 * limb <= kMaxSmem ? 2 : 1;
  p->smem = fix + tile + p->b_stages * limb;
  return p->smem > kMaxSmem ? (int)cudaErrorInvalidValue : 0;
}

int launch(Args a, int n_parts, cudaStream_t stream) {
  if (a.nq <= 0 || a.cap <= 0 || n_parts <= 0) return (int)cudaGetLastError();
  Plan p;
  const int err = make_plan(a.d, a.chunk, a.cap, n_parts, a.nq * a.n_probe,
                            &p);
  if (err) return err;
  a.dp = (a.d + 31) / 32 * 32;
  a.stride = a.dp + 16;                  // an odd multiple of 16 bytes
  a.tm = p.tm;
  a.tile_rows = p.tile_rows;
  a.n_tiles = p.n_tiles;
  a.nchp = p.nchp;
  a.lanes = p.lanes;
  a.b_stages = p.b_stages;
  void (*kernel)(Args) = scan_mma_kernel<0>;
  switch (p.reg_chunk ? a.chunk : 0) {
    case 1: kernel = scan_mma_kernel<1>; break;
    case 2: kernel = scan_mma_kernel<2>; break;
    case 4: kernel = scan_mma_kernel<4>; break;
    case 8: kernel = scan_mma_kernel<8>; break;
    case 16: kernel = scan_mma_kernel<16>; break;
    case 32: kernel = scan_mma_kernel<32>; break;
  }
  if (p.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(p.grid_x, n_parts, p.grid_z), kThreads, p.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

Args make_args(const void* limbs, const void* qscale, const void* qsum,
               const void* data, const void* aff, const void* scale,
               const void* bias, void* cmax, void* carg) {
  Args a{};
  a.data = static_cast<const int8_t*>(data);
  a.aff = static_cast<const float*>(aff);
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.limbs = static_cast<const int8_t*>(limbs);
  a.qscale = static_cast<const float*>(qscale);
  a.qsum = static_cast<const float*>(qsum);
  a.cmax = static_cast<float*>(cmax);
  a.carg = static_cast<int32_t*>(carg);
  return a;
}

}  // namespace

extern "C" {

// Probe scan. Query q's rows are the n_probe segments probes[q, j] of `cap`
// rows each; pairs (q, j) come sorted by partition in `order` (ids
// q * n_probe + j) with `offsets` (n_parts + 1) delimiting each partition's
// run. Outputs (nq, n_probe * ceil(cap / chunk)), chunk c of probe j at
// column j * ceil(cap / chunk) + c; carg indexes the query's own
// [0, n_probe * cap) rows.
int ivf_probe_scan(const void* limbs, const void* qscale, const void* qsum,
                   const void* slab, const void* aff, const void* scale,
                   const void* bias, const void* order, const void* offsets,
                   int nq, int d, int n_parts, int n_probe, int cap, int chunk,
                   int vec_ok, void* cmax, void* carg, void* stream) {
  if (!order || !offsets || n_probe < 1) return (int)cudaErrorInvalidValue;
  Args a = make_args(limbs, qscale, qsum, slab, aff, scale, bias, cmax, carg);
  a.order = static_cast<const int64_t*>(order);
  a.offsets = static_cast<const int32_t*>(offsets);
  a.nq = nq; a.d = d; a.n_probe = n_probe; a.cap = cap; a.chunk = chunk;
  a.vec_ok = vec_ok;
  return launch(a, n_parts, static_cast<cudaStream_t>(stream));
}

// Shared-slab scan: every query against rows [0, n), one segment. Outputs
// (nq, ceil(n / chunk)).
int ivf_shared_scan(const void* limbs, const void* qscale, const void* qsum,
                    const void* data, const void* aff, const void* scale,
                    const void* bias, int nq, int n, int d, int chunk,
                    int vec_ok, void* cmax, void* carg, void* stream) {
  Args a = make_args(limbs, qscale, qsum, data, aff, scale, bias, cmax, carg);
  a.nq = nq; a.d = d; a.n_probe = 1; a.cap = n; a.chunk = chunk;
  a.vec_ok = vec_ok;
  return launch(a, 1, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
