// GQA one-token decode attention (split-K flash-decode, one launch) for
// sm_90a.
//
// Replaces the TPU kernel decode_attention_pallas
// (src/repro/kernels/decode_attention/decode_attention.py:78, body _kernel
// :26): q (B, H = Hkv*G, hd) attends over a (B, S, Hkv, hd) K/V cache under
// an arbitrary (B, S) valid mask; online softmax in fp32, p kept in fp32 for
// p·V; a row with nothing valid gives 0 (denominator clamped to 1e-20). The
// TPU grid walks S in order and carries (m, l, acc) in VMEM scratch; Hopper
// runs blocks in parallel with nothing carried between them, so S is cut
// into splits, each block writes its split's (m, l, acc), and the last
// block of each (row, KV head) to finish merges them.
//
// What bounds it: bytes. Each valid K and V row is read once (2 * hd *
// sizeof(T) bytes per position and KV head) for 4 * G * hd flops, far
// below the card's ~300 flops per byte; at phi4-mini's tick (B 8, Hkv 8,
// hd 128, bf16) the valid rows are ~38 MB, 11 us at 3.35 TB/s. Little's
// law at that rate and ~1 us of latency asks for ~25 KB in flight per SM.
// What the design does about it:
//   * Splits over the valid history. S is cut into tiles of kTile = 64
//     positions and a split is `tiles` consecutive tiles (1..kMaxTiles,
//     planned by the wrapper from the shapes alone: enough splits for
//     several blocks per SM). One block per (split, KV head, row). A
//     block reads its split's mask bytes once, coalesced, at the start; a
//     split with no valid position writes an empty partial (m = -inf) and
//     never touches K/V, and a tile with none is neither loaded nor
//     computed.
//   * K/V staged through shared memory by cp.async, 16 B per thread per
//     copy, in a ring of kStages tiles: the next tile's loads are in
//     flight while the current one is computed. Rows of invalid
//     positions are copied with a source size of 0 (zero fill, no bytes
//     read), so a slot with a short history reads only that history and
//     stale cache rows never reach the arithmetic. Sizing: a bf16 hd-128
//     tile is 64 * 256 B * 2 = 32 KB of K and V; with 2 stages (~68 KB of
//     shared memory) three blocks fit on an SM, so one to three tiles,
//     32-96 KB, are in flight per SM, above the ~25 KB that Little's law
//     asks for. A tile's K and V are two commit groups, so its scores
//     start while its V is still in flight. Each 16 B chunk of a row goes
//     to chunk c ^ (row & 7) of its row in shared memory (c ^ (row &
//     (chunks - 1)) for a row of fewer than 8 chunks), so both read
//     patterns below are free of bank conflicts.
//   * Scores without per-position warp reductions: thread (position r,
//     part of hd) dots its part of the row of K with the G query rows
//     (fp32, in shared memory, read as broadcasts); the parts are added in
//     a fixed order. One warp per head then takes the tile's max (one warp
//     reduction per head and tile, not per position), rescales the running
//     max and writes p = exp(s - m) to shared memory.
//   * p·V on the CUDA cores in fp32: thread (16 B chunk of hd, position
//     group) accumulates G rows of acc and l over its positions; the
//     position groups are added in a fixed order at the end of the split.
//     fp32 caches run the same fp32 arithmetic (no tensor cores, no TF32).
//   * One launch, deterministic: each block writes its fp32 partial,
//     fences, and counts itself in an arrival counter per (row, KV head);
//     the last block to arrive resets the counter to 0 and merges the
//     splits in split order, so every run gives the same bits. It reads
//     every split's (m, l) in one parallel pass, forms the weights
//     exp(m - M) in shared memory, and reads acc only for live splits,
//     several splits' loads in flight per thread.
//
// What is left (PERF.md, measured on an H100): a fixed cost of ~0.02 ms
// per call whatever the history (launch, three waves of blocks, the mask
// and first-tile latency, the arrival and merge), so the tick's 38 MB
// run at about a third of the byte bound.
//
// Shapes: hd 16, 64 or 128 (16 is the reference's smoke head dim), G 1..8,
// S up to kMaxSplits * kMaxTiles * kTile. Every offset into q, K/V, the
// mask, the workspace and out is a 64-bit size_t product, so a cache of
// 2^31 elements or more indexes correctly.
//
// Plain C interface (ctypes): decode_attention(...) returns the CUDA error
// of its launch (0 on success); it never synchronises or allocates.
// decode_attention_smem(...) gives the dynamic shared memory of a block.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;       // positions per tile
constexpr int kStages = 2;      // tiles in the shared-memory ring
constexpr int kMaxTiles = 8;    // tiles per split, at most
constexpr int kMaxSplits = 512; // splits per (row, KV head), at most
constexpr int kTP = kThreads / kTile;   // threads per position in the dots
static_assert(kTile % 32 == 0 && kThreads % kTile == 0, "tile shape");
static_assert(kMaxTiles <= 32, "one bit per tile");

constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }

// Shared memory of one block (bytes). The arena holds the ring of kStages
// tiles (K then V) while tiles stream, then the reduction over position
// groups, then, in the merging block, the splits' m and l.
template <typename T, int HD, int G>
struct Layout {
  static constexpr int kCE = 16 / (int)sizeof(T);          // elements per chunk
  static constexpr int kChunks = HD / kCE;                  // chunks per row
  static constexpr int kGroups = kThreads / kChunks;        // p·V position groups
  // chunk c of row r sits at chunk c ^ (r & kSwz) of its row: a row of
  // fewer than 8 chunks (hd 16) swizzles within itself
  static constexpr int kSwz = (kChunks < 8 ? kChunks : 8) - 1;
  static constexpr int kTileElems = kTile * HD;
  static constexpr size_t kRing = (size_t)kStages * 2 * kTileElems * sizeof(T);
  static constexpr size_t kArena =
      cmax(kRing, cmax((size_t)kGroups * G * HD * 4,        // [kGroups][G][HD]
                       (size_t)2 * kMaxSplits * G * 4));    // [2][splits][G]
  static constexpr size_t kQ = kArena;                      // float [G][HD]
  static constexpr size_t kPart = kQ + (size_t)G * HD * 4;  // [kTP][G][kTile]
  static constexpr size_t kProb = kPart + (size_t)kTP * G * kTile * 4;  // [G][kTile]
  static constexpr size_t kStat = kProb + (size_t)G * kTile * 4;  // [2][G]
  static constexpr size_t kRedL = kStat + (size_t)2 * G * 4;  // [kGroups][G]
  static constexpr size_t kBytes = kRedL + (size_t)kGroups * G * 4;
  static_assert((kChunks & (kChunks - 1)) == 0 && kChunks % kTP == 0,
                "swizzle and dot split");
};

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// One 16 B chunk of shared memory as fp32.
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p,
                                           float (&f)[8]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  f[0] = bf16_lo(r.x); f[1] = bf16_hi(r.x);
  f[2] = bf16_lo(r.y); f[3] = bf16_hi(r.y);
  f[4] = bf16_lo(r.z); f[5] = bf16_hi(r.z);
  f[6] = bf16_lo(r.w); f[7] = bf16_hi(r.w);
}
__device__ __forceinline__ void load_chunk(const float* p, float (&f)[4]) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 B global -> shared; with ok false nothing is read and 16 zero bytes
// are written.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool ok) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// One block per (split, kv head, batch row). Workspace entry
// ((b * hkv + h) * splits + split) * G + g holds [m, l, acc[HD]];
// arrivals[b * hkv + h] counts the finished splits and is 0 between calls.
template <typename T, int HD, int G>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const uint8_t* __restrict__ valid,
              float* __restrict__ ws, int* __restrict__ arrivals,
              T* __restrict__ out, int S, int hkv, int tiles, int splits,
              float scale) {
  using L = Layout<T, HD, G>;
  constexpr int CE = L::kCE, NC = L::kChunks, NG = L::kGroups;
  extern __shared__ __align__(16) uint8_t smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* qs = reinterpret_cast<float*>(smem + L::kQ);
  float* parts = reinterpret_cast<float*>(smem + L::kPart);
  float* probs = reinterpret_cast<float*>(smem + L::kProb);
  float* mrun = reinterpret_cast<float*>(smem + L::kStat);
  float* alpha = mrun + G;
  float* redl = reinterpret_cast<float*>(smem + L::kRedL);
  __shared__ uint8_t okm[kMaxTiles * kTile];
  __shared__ uint32_t live_bits;
  __shared__ int is_last;

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int s0 = split * tiles * kTile;
  const int n_tiles = min(tiles, (S - s0 + kTile - 1) / kTile);
  const size_t bh = (size_t)b * hkv + h;
  float* part = ws + (bh * splits + split) * G * (HD + 2);

  // the split's mask bytes, once; positions past S are invalid
  if (tid == 0) live_bits = 0;
  __syncthreads();
  {
    const uint8_t* vrow = valid + (size_t)b * S + s0;
    uint32_t bits = 0;
    for (int i = tid; i < n_tiles * kTile; i += kThreads) {
      const uint8_t ok = s0 + i < S ? vrow[i] : 0;
      okm[i] = ok;
      if (ok) bits |= 1u << (i / kTile);
    }
    if (bits) atomicOr(&live_bits, bits);
  }
  __syncthreads();
  const uint32_t live = live_bits;

  if (live == 0) {
    if (tid < G) {                       // empty partial: skipped by the merge
      part[tid * (HD + 2)] = -INFINITY;
      part[tid * (HD + 2) + 1] = 0.f;
    }
  } else {
    const size_t pos_stride = (size_t)hkv * HD;
    const T* kh = k + ((size_t)b * S * hkv + h) * HD;
    const T* vh = v + ((size_t)b * S * hkv + h) * HD;
    // tile t of the split into ring stage t % kStages as two commit
    // groups, K then V (both empty past the split or for a dead tile), so
    // the scores can start before V has landed
    auto issue = [&](int t) {
      const bool go = t < n_tiles && ((live >> t) & 1u);
      T* ks = ring + (size_t)(t % kStages) * 2 * L::kTileElems;
#pragma unroll
      for (int kv = 0; kv < 2; ++kv) {
        if (go) {
          const T* src = kv ? vh : kh;
          T* dst = ks + kv * L::kTileElems;
#pragma unroll
          for (int j = tid; j < kTile * NC; j += kThreads) {
            const int r = j / NC, c = j % NC;
            const bool ok = okm[t * kTile + r] != 0;
            const size_t off =
                ok ? (size_t)(s0 + t * kTile + r) * pos_stride + c * CE : 0;
            cp_async16(dst + r * HD + (c ^ (r & L::kSwz)) * CE, src + off,
                       ok);
          }
        }
        cp_async_commit();
      }
    };

    const int c_pv = tid % NC, g_pv = tid / NC;   // p·V: chunk, position group
    float acc[G][CE], lsum[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      lsum[g] = 0.f;
#pragma unroll
      for (int e = 0; e < CE; ++e) acc[g][e] = 0.f;
    }

#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) issue(st);
    // the G query rows as fp32, while the first tiles are in flight
    const T* qb = q + bh * G * HD;
    for (int i = tid; i < G * HD; i += kThreads) qs[i] = to_float(qb[i]);
    if (tid < G) mrun[tid] = -INFINITY;
    for (int t = 0; t < n_tiles; ++t) {
      issue(t + kStages - 1);
      cp_async_wait<2 * kStages - 1>();  // K of tile t has landed
      __syncthreads();
      if ((live >> t) & 1u) {
        const T* ks = ring + (size_t)(t % kStages) * 2 * L::kTileElems;
        const T* vs = ks + L::kTileElems;
        const uint8_t* okt = okm + t * kTile;
        // 1. partial dots: thread (position r, part pt of hd's chunks)
        {
          const int r = tid % kTile, pt = tid / kTile;
          float dot[G];
#pragma unroll
          for (int g = 0; g < G; ++g) dot[g] = 0.f;
          if (okt[r]) {
#pragma unroll
            for (int cc = 0; cc < NC / kTP; ++cc) {
              const int c = pt * (NC / kTP) + cc;
              float kf[CE];
              load_chunk(ks + r * HD + (c ^ (r & L::kSwz)) * CE, kf);
#pragma unroll
              for (int g = 0; g < G; ++g) {
                const float* qg = qs + g * HD + c * CE;
#pragma unroll
                for (int e = 0; e < CE; e += 4) {
                  const float4 qv = *reinterpret_cast<const float4*>(qg + e);
                  dot[g] = fmaf(qv.x, kf[e], dot[g]);
                  dot[g] = fmaf(qv.y, kf[e + 1], dot[g]);
                  dot[g] = fmaf(qv.z, kf[e + 2], dot[g]);
                  dot[g] = fmaf(qv.w, kf[e + 3], dot[g]);
                }
              }
            }
          }
#pragma unroll
          for (int g = 0; g < G; ++g)
            parts[(pt * G + g) * kTile + r] = dot[g];
        }
        __syncthreads();
        // 2. one warp per head: tile max, running max, p = exp(s - m)
        {
          const int warp = tid / 32, lane = tid % 32;
          constexpr int PPL = kTile / 32;          // positions per lane
          for (int g = warp; g < G; g += kThreads / 32) {
            float s[PPL], mx = -INFINITY;
#pragma unroll
            for (int i = 0; i < PPL; ++i) {
              const int r = lane + 32 * i;
              float d = parts[g * kTile + r];
#pragma unroll
              for (int p = 1; p < kTP; ++p) d += parts[(p * G + g) * kTile + r];
              s[i] = okt[r] ? d * scale : -INFINITY;
              mx = fmaxf(mx, s[i]);
            }
            const float m_old = mrun[g];
            // the tile holds a valid position, so m_new is finite
            const float m_new = fmaxf(m_old, warp_max(mx));
#pragma unroll
            for (int i = 0; i < PPL; ++i)
              probs[g * kTile + lane + 32 * i] = expf(s[i] - m_new);
            if (lane == 0) {
              alpha[g] = expf(m_old - m_new);    // 0 while m_old is -inf
              mrun[g] = m_new;
            }
          }
        }
        cp_async_wait<2 * kStages - 2>();  // V of tile t has landed
        __syncthreads();
        // 3. p·V in fp32: thread (chunk c_pv, positions g_pv + NG * i)
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float a = alpha[g];
          lsum[g] *= a;
#pragma unroll
          for (int e = 0; e < CE; ++e) acc[g][e] *= a;
        }
#pragma unroll 4
        for (int r = g_pv; r < kTile; r += NG) {
          float vf[CE];
          load_chunk(vs + r * HD + (c_pv ^ (r & L::kSwz)) * CE, vf);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float p = probs[g * kTile + r];
            lsum[g] += p;
#pragma unroll
            for (int e = 0; e < CE; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
          }
        }
      }
      __syncthreads();                   // stage t % kStages is free again
    }
    cp_async_wait<0>();

    // the split's partial: position groups added in order, through the ring
    float* red = reinterpret_cast<float*>(smem);   // [NG][G][HD]
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int e = 0; e < CE; e += 4)
        *reinterpret_cast<float4*>(red + (g_pv * G + g) * HD + c_pv * CE + e) =
            make_float4(acc[g][e], acc[g][e + 1], acc[g][e + 2], acc[g][e + 3]);
      if (c_pv == 0) redl[g_pv * G + g] = lsum[g];
    }
    __syncthreads();
    for (int i = tid; i < G * HD; i += kThreads) {
      const int g = i / HD, d = i % HD;
      float a = red[g * HD + d];
      for (int pg = 1; pg < NG; ++pg) a += red[(pg * G + g) * HD + d];
      part[g * (HD + 2) + 2 + d] = a;
    }
    if (tid < G) {
      float l = redl[tid];
      for (int pg = 1; pg < NG; ++pg) l += redl[pg * G + tid];
      part[tid * (HD + 2)] = mrun[tid];
      part[tid * (HD + 2) + 1] = l;
    }
  }

  // arrive; the last split of this (row, KV head) merges all of them
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(arrivals + bh, 1) == splits - 1;
  __syncthreads();
  if (!is_last) return;
  if (tid == 0) arrivals[bh] = 0;          // ready for the next call
  __threadfence();
  const float* base = ws + bh * splits * G * (HD + 2);
  // every split's m and l at once; entry i = split * G + g
  float* cf = reinterpret_cast<float*>(smem);          // [splits][G]
  float* ls = cf + kMaxSplits * G;                     // [splits][G]
  for (int i = tid; i < splits * G; i += kThreads) {
    cf[i] = __ldcg(base + (size_t)i * (HD + 2));
    ls[i] = __ldcg(base + (size_t)i * (HD + 2) + 1);
  }
  __syncthreads();
  // per head: M, c = exp(m - M) (0 for an empty split) and L, split order
  if (tid < G) {
    float M = -INFINITY;
    for (int sp = 0; sp < splits; ++sp) M = fmaxf(M, cf[sp * G + tid]);
    float Lsum = 0.f;
    for (int sp = 0; sp < splits; ++sp) {
      const float m = cf[sp * G + tid];
      const float c = m == -INFINITY ? 0.f : expf(m - M);
      cf[sp * G + tid] = c;
      Lsum = fmaf(c, ls[sp * G + tid], Lsum);
    }
    mrun[tid] = Lsum;
  }
  __syncthreads();
  T* ob = out + bh * G * HD;
  for (int i = tid; i < G * HD; i += kThreads) {
    const int g = i / HD;
    const float* e = base + (size_t)g * (HD + 2) + 2 + i % HD;
    float A = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < splits; ++sp) {
      const float c = cf[sp * G + g];
      // an empty split's acc was never written: not read
      A = fmaf(c, c != 0.f ? __ldcg(e + (size_t)sp * G * (HD + 2)) : 0.f, A);
    }
    ob[i] = from_float<T>(A / fmaxf(mrun[g], 1e-20f));
  }
}

template <typename T, int HD, int G>
int launch(const void* q, const void* k, const void* v, const void* valid,
           void* ws, void* arrivals, void* out, int B, int S, int hkv,
           int tiles, int splits, cudaStream_t stream) {
  using L = Layout<T, HD, G>;
  auto kern = decode_kernel<T, HD, G>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(splits, hkv, B), kThreads, L::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(valid),
      static_cast<float*>(ws), static_cast<int*>(arrivals),
      static_cast<T*>(out), S, hkv, tiles, splits,
      1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

// The instantiation for a runtime (dtype, hd, G): fn.template run<T, HD,
// G>(), or cudaErrorInvalidValue for a combination not compiled.
template <typename Fn>
int dispatch(int is_bf16, int hd, int G, const Fn& fn) {
#define DA_G(T, HD)                                      \
  switch (G) {                                           \
    case 1: return fn.template run<T, HD, 1>();          \
    case 2: return fn.template run<T, HD, 2>();          \
    case 3: return fn.template run<T, HD, 3>();          \
    case 4: return fn.template run<T, HD, 4>();          \
    case 5: return fn.template run<T, HD, 5>();          \
    case 6: return fn.template run<T, HD, 6>();          \
    case 7: return fn.template run<T, HD, 7>();          \
    case 8: return fn.template run<T, HD, 8>();          \
    default: return (int)cudaErrorInvalidValue;          \
  }
  if (is_bf16) {
    if (hd == 128) DA_G(__nv_bfloat16, 128)
    if (hd == 64) DA_G(__nv_bfloat16, 64)
    if (hd == 16) DA_G(__nv_bfloat16, 16)
  } else {
    if (hd == 128) DA_G(float, 128)
    if (hd == 64) DA_G(float, 64)
    if (hd == 16) DA_G(float, 16)
  }
#undef DA_G
  return (int)cudaErrorInvalidValue;
}

struct Launch {
  const void *q, *k, *v, *valid;
  void *ws, *arrivals, *out;
  int B, S, hkv, tiles, splits;
  cudaStream_t stream;
  template <typename T, int HD, int G>
  int run() const {
    return launch<T, HD, G>(q, k, v, valid, ws, arrivals, out, B, S, hkv,
                            tiles, splits, stream);
  }
};

struct SmemBytes {
  template <typename T, int HD, int G>
  int run() const { return (int)Layout<T, HD, G>::kBytes; }
};

}  // namespace

extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* valid, void* ws, void* arrivals,
                                void* out, int B, int S, int hkv, int G,
                                int hd, int is_bf16, int tiles, int splits,
                                void* stream) {
  if (tiles < 1 || tiles > kMaxTiles || splits < 1 || splits > kMaxSplits ||
      (long long)(splits - 1) * tiles * kTile >= S ||
      (long long)splits * tiles * kTile < S)
    return (int)cudaErrorInvalidValue;
  return dispatch(is_bf16, hd, G,
                  Launch{q, k, v, valid, ws, arrivals, out, B, S, hkv, tiles,
                         splits, static_cast<cudaStream_t>(stream)});
}

extern "C" int decode_attention_smem(int G, int hd, int is_bf16) {
  return dispatch(is_bf16, hd, G, SmemBytes{});
}
