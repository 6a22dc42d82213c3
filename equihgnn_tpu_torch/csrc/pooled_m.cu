// The pooled-M build of the SE(3)-Transformer's per-J pooled ConvSE3 path,
// forward and backward: kernels L and M.
//
//   L  M[s,x,f]   = Σ_k h[s,k,f] · tc[s,k,x]
//   M  dh[s,k,f]  = Σ_x tc[s,k,x] · dM[s,x,f]
//      dtc[s,k,x] = Σ_f h[s,k,f] · dM[s,x,f]
//
// Shapes (s = the G·A sites): h [S, K, F], tc [S, K, X], M and dM [S, X, F],
// dh [S, K, F], dtc [S, K, X], all in one type T, bf16 or f32. Products and
// sums are f32; each output is rounded once to T, as JAX's dots with
// preferred_element_type=f32 followed by astype.
// Replaces equihgnn_tpu/ops/pallas/pooled_m.py `_pm_fwd` (L, body
// `_fwd_kernel`) and `_pm_bwd` (M, body `_bwd_kernel`).
//
// Bound on the H100: bytes. At the batch-768 shapes (S = 24,608, K = 16,
// F = 128, X = 64 or 192, bf16) L writes M, 0.40 or 1.21 GB, for 2·K = 32
// operations an element, and M reads it back: 2-4 operations a byte, far
// below the ~295 a byte at which the bf16 tensor cores would bind.
//
// Design of L in bf16 (the model's path): a persistent, pipelined build.
//  - A few persistent blocks an SM (as many as fit, one round of the
//    card, 5 an SM), 4 warps each, walk the sites with a stride of the
//    grid. A 2-stage cp.async ring holds a site's h [K, F] and tc [K, X] in
//    bf16 (6 KB a site at X = 64): the next site's copies are in flight
//    while one is computed and stored. Deeper rings (3-8 sites) were slower
//    at X = 64 on the card, where L's reads are a quarter of its bytes and
//    M's writes the rest. M leaves in streaming stores (st.global.cs).
//  - Each thread owns 8 (x) × 8 (f) tiles of M: per k one 16-byte load of
//    8 h and one of 8 tc, unpacked to f32 by a shift or a mask (exact), and
//    64 FMAs, k in order; each sum is rounded once to bf16 and a row's 8
//    values leave in one 16-byte store.
//  - Not the tensor cores. mma.sync.m16n8k16 in bf16 was this design's
//    first version, and it failed L's gate on the card (first call, batch
//    768, X = 64): 0.999997 of the elements equal to the plain version's,
//    but 40 bf16 ulps at most (26,560 in a card test), where the gate allows
//    1. The tensor cores align the 16 products to the largest and truncate,
//    so a sum that cancels to ~1e-5 of its largest product keeps few
//    correct bits; the plain version (and this kernel) add the exact f32
//    products in order, rounding each sum to nearest, and agree to the bit.
//    The FMAs are ~0.11 ms of CUDA-core time at the batch-768 shapes, below
//    the 0.16 ms that L's bytes take.
//  - A site whose h and tc are all ±0 (the SE(3)-Transformer's sites with
//    no neighbour within the radius) skips the products and writes +0, the
//    plain version's value; a block-wide OR over the staged copies decides.
//  - A site is owned by one block and each element by one thread, summed in
//    a fixed order: no atomics, the same bits twice.
// L in f32 (an entry no model path reaches) keeps the design of the first
// port: one block of 256 threads per site, operands staged as f32, each
// thread a 4 (x) × 8 (f) register tile summed over k in order.
// Design of M in bf16 (the model's path): the ring, as L's.
//  - Persistent blocks of 4 warps (as many as fit the card at once) walk the
//    sites with the grid's stride. A site's h [K, F] and tc [K, X] are
//    copied first (6 KB at X = 64) into a ring of 3 slots; an OR over the
//    staged copies decides whether the site is live. Only a live site's dM
//    is copied, in stages of 64 rows (16 KB; X = 192 takes 3): a dead site
//    (no neighbour within the radius: 48 % at batch 768, where their dM is
//    194 of the 403 MB at X = 64) writes +0 to dh and dtc in 16-byte
//    streaming stores and reads no dM. While a unit (a dM stage, or a dead
//    site) is computed, the next unit's copies (the next stage, or the next
//    site's first one if that site is live, and the h and tc of the site
//    after it) are in flight.
//  - Two warps sum dh, two dtc: the same K·F·X FMAs each. A dh thread owns
//    4 (k) × 8 (f) tiles, fed per x by one 16-byte load of 8 dM values and,
//    per 8 x, one of 8 tc values a row; a dtc thread owns 4 (k) × 4 (x)
//    tiles, fed per 8 f by one 16-byte load a row of h and of dM. bf16 is
//    unpacked to f32 by a shift or a mask (exact), each sum taken in order
//    (x for dh, carried in f32 between stages; f for dtc) and rounded once.
//    Outputs leave from registers in 16-byte streaming stores: a dh row's 8
//    f, and a dtc row's 8 x once two neighbouring lanes have swapped half
//    their tiles (8 shuffles a lane). dM's 16-byte pieces are swizzled by
//    row so that a dtc quarter-warp's rows (4 apart) hit 8 bank groups.
//  - On the card M's copies and stores alone (no products) take about half
//    its time at X = 64, the products the other half: the two overlap
//    little (`ablate_kernels.py --kernels M`).
//  - Not the tensor cores, for L's reason: its sums over x (64, 192) and f
//    (128) cancel as L's do.
//  - Contract: each element is computed by one thread in a fixed order: no
//    atomics, the same bits twice (and those of the f32 design below run
//    on bf16 operands, which sums in the same order). The dead-site skip
//    is exact wherever dM is finite: at a site whose h and tc are all ±0
//    every product is ±0 and every sum from +0 is +0, which it writes; the
//    plain version gives 0 · Inf = NaN where dM is not finite there. A shape whose rows are not whole 16-byte
//    pieces (F or X not a multiple of 8, or an operand not aligned) takes
//    the same kernel with plain copies and stores, its pads zeroed.
// M in f32 (an entry no model path reaches) keeps the design of the first
// port: one block of 256 threads per site (a grid-stride loop over the
// sites). dM [X, F] is staged in T with an odd number of 4-byte words a
// row, so that 32 threads reading one column of 32 rows hit 32 banks; h
// and tc are staged transposed ([F][K'], [X][K'], K' = K rounded up to 4)
// so that four k of one column are one 16-byte load. dh's threads own a
// 4 (k) × 2 (f) tile and sum over x; dtc's own 4 (k) × 2 (x, x + 32) and
// sum over f; both kinds share one loop over the block's threads.

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_GRID = 1 << 20;      // blocks; more sites loop in the blocks
constexpr size_t MAX_SMEM = 232448;    // shared memory a block may use on Hopper

struct Dims {
  int64_t s;  // sites
  int k, f, x;
};

// Which operands may move in 16-byte vectors (aligned, whole vectors a site).
struct Vec {
  bool h, tc, dm, out;
};

__host__ __device__ constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Elements of T in 16 bytes.
template <typename T>
__host__ __device__ constexpr int vw() { return 16 / static_cast<int>(sizeof(T)); }

// Row stride (elements of T) of the staged dM: an odd number of 4-byte words.
template <typename T>
__host__ __device__ inline int dm_stride(int f) {
  const int per_word = 4 / static_cast<int>(sizeof(T));
  const int words = (f + per_word - 1) / per_word;
  return (words % 2 ? words : words + 1) * per_word;
}

// v as D: converted to f32, or kept in T.
template <typename D, typename T>
__device__ __forceinline__ D as(T v) {
  if constexpr (std::is_same<D, float>::value) {
    return to_f(v);
  } else {
    return v;
  }
}

// Copies the [rows, cols] matrix src (contiguous) into shared memory as
// dst[r * ld + c], or dst[c * ld + r] when TRANS, converted to D.
template <typename T, typename D, bool TRANS>
__device__ void stage(const T* __restrict__ src, int rows, int cols, D* dst, int ld, bool vec) {
  const int n = rows * cols;
  if (vec) {
    constexpr int V = vw<T>();
    for (int v = threadIdx.x; v < n / V; v += blockDim.x) {
      const uint4 raw = reinterpret_cast<const uint4*>(src)[v];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int idx = v * V + j, r = idx / cols, c = idx % cols;
        dst[TRANS ? c * ld + r : r * ld + c] = as<D>(e[j]);
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
      const int r = idx / cols, c = idx % cols;
      dst[TRANS ? c * ld + r : r * ld + c] = as<D>(src[idx]);
    }
  }
}

// Writes the first n (≤ 8) of acc to dst in T: one or two 16-byte stores
// when vec and all 8 are in the row.
template <typename T>
__device__ __forceinline__ void store8(T* dst, const float (&acc)[8], int n, bool vec) {
  if (vec && n >= 8) {
    alignas(16) T vals[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) vals[c] = from_f<T>(acc[c]);
#pragma unroll
    for (int j = 0; j < 8 / vw<T>(); ++j)
      reinterpret_cast<uint4*>(dst)[j] = reinterpret_cast<const uint4*>(vals)[j];
  } else {
    for (int c = 0; c < n && c < 8; ++c) dst[c] = from_f<T>(acc[c]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    pooled_m_fwd_kernel(const T* __restrict__ h, const T* __restrict__ tc, T* __restrict__ m,
                        Dims d, Vec vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int fp = round_up(d.f, 8), xp = round_up(d.x, 4);
  float* sh = reinterpret_cast<float*>(smem_raw);  // [K][fp]
  float* st = sh + d.k * fp;                       // [K][xp]
  const int nfg = (d.f + 7) / 8, nxc = (d.x + 3) / 4;
  for (int64_t s = blockIdx.x; s < d.s; s += gridDim.x) {
    stage<T, float, false>(h + s * d.k * d.f, d.k, d.f, sh, fp, vec.h);
    stage<T, float, false>(tc + s * d.k * d.x, d.k, d.x, st, xp, vec.tc);
    __syncthreads();
    T* out = m + s * d.x * d.f;
    for (int item = threadIdx.x; item < nfg * nxc; item += blockDim.x) {
      const int f0 = (item % nfg) * 8, x0 = (item / nfg) * 4;
      float acc[4][8] = {};
      for (int k = 0; k < d.k; ++k) {
        const float4 ha = *reinterpret_cast<const float4*>(sh + k * fp + f0);
        const float4 hb = *reinterpret_cast<const float4*>(sh + k * fp + f0 + 4);
        const float4 t4 = *reinterpret_cast<const float4*>(st + k * xp + x0);
        const float hv[8] = {ha.x, ha.y, ha.z, ha.w, hb.x, hb.y, hb.z, hb.w};
        const float tv[4] = {t4.x, t4.y, t4.z, t4.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(tv[r], hv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (x0 + r < d.x) store8<T>(out + static_cast<int64_t>(x0 + r) * d.f + f0, acc[r], d.f - f0,
                                    vec.out);
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    pooled_m_bwd_kernel(const T* __restrict__ h, const T* __restrict__ tc,
                        const T* __restrict__ dm, T* __restrict__ dh, T* __restrict__ dtc,
                        Dims d, Vec vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kp = round_up(d.k, 4), ldd = dm_stride<T>(d.f);
  float* ht = reinterpret_cast<float*>(smem_raw);  // [F][kp]
  float* tt = ht + d.f * kp;                       // [X][kp]
  T* sd = reinterpret_cast<T*>(tt + d.x * kp);     // [X][ldd]
  const int nfp = (d.f + 1) / 2, nkc = kp / 4, nxb = (d.x + 63) / 64;
  const int na = nfp * nkc, nb = nkc * nxb * 32;  // dh and dtc thread tiles
  for (int64_t s = blockIdx.x; s < d.s; s += gridDim.x) {
    stage<T, float, true>(h + s * d.k * d.f, d.k, d.f, ht, kp, vec.h);
    stage<T, float, true>(tc + s * d.k * d.x, d.k, d.x, tt, kp, vec.tc);
    stage<T, T, false>(dm + s * d.x * d.f, d.x, d.f, sd, ldd, vec.dm);
    for (int idx = threadIdx.x; idx < (d.f + d.x) * (kp - d.k); idx += blockDim.x) {
      const int row = idx / (kp - d.k), k = d.k + idx % (kp - d.k);
      ht[row * kp + k] = 0.f;  // the k pads (rows of tt follow those of ht)
    }
    __syncthreads();
    T* dhs = dh + s * d.k * d.f;
    T* dts = dtc + s * d.k * d.x;
    for (int item = threadIdx.x; item < na + nb; item += blockDim.x) {
      float acc[4][2] = {};
      if (item < na) {  // dh[k0 .. k0+3, f0 .. f0+1] = Σ_x tc[k, x] · dM[x, f]
        const int f0 = (item % nfp) * 2, k0 = (item / nfp) * 4;
        const bool f1 = f0 + 1 < d.f;
        for (int x = 0; x < d.x; ++x) {
          const float4 t4 = *reinterpret_cast<const float4*>(tt + x * kp + k0);
          const float m0 = to_f(sd[x * ldd + f0]);
          const float m1 = f1 ? to_f(sd[x * ldd + f0 + 1]) : 0.f;
          const float tv[4] = {t4.x, t4.y, t4.z, t4.w};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            acc[r][0] = fmaf(tv[r], m0, acc[r][0]);
            acc[r][1] = fmaf(tv[r], m1, acc[r][1]);
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (k0 + r >= d.k) break;
          dhs[(k0 + r) * d.f + f0] = from_f<T>(acc[r][0]);
          if (f1) dhs[(k0 + r) * d.f + f0 + 1] = from_f<T>(acc[r][1]);
        }
      } else {  // dtc[k0 .. k0+3, (x0, x0 + 32)] = Σ_f h[k, f] · dM[x, f]
        const int b = item - na, rest = b / 32;
        const int x0 = (rest % nxb) * 64 + b % 32, k0 = (rest / nxb) * 4;
        const int xs[2] = {x0, x0 + 32};
        const int xr0 = x0 < d.x ? x0 : 0, xr1 = x0 + 32 < d.x ? x0 + 32 : 0;
        for (int f = 0; f < d.f; ++f) {
          const float4 h4 = *reinterpret_cast<const float4*>(ht + f * kp + k0);
          const float m0 = to_f(sd[xr0 * ldd + f]), m1 = to_f(sd[xr1 * ldd + f]);
          const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            acc[r][0] = fmaf(hv[r], m0, acc[r][0]);
            acc[r][1] = fmaf(hv[r], m1, acc[r][1]);
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (k0 + r >= d.k) break;
#pragma unroll
          for (int j = 0; j < 2; ++j)
            if (xs[j] < d.x) dts[(k0 + r) * d.x + xs[j]] = from_f<T>(acc[r][j]);
        }
      }
    }
    __syncthreads();
  }
}

// ------------------------------------------- kernel L in bf16: the ring

constexpr int RING_THREADS = 128;  // 4 warps
constexpr int RING_STAGES = 2;     // sites in the ring (deeper rings were slower at X = 64)

// The staged shapes (in bf16 elements): row strides fs of h and xs of tc,
// F and X rounded up to 8 (whole 16-byte pieces for the thread tiles).
struct RingDims {
  int64_t s;
  int k, f, x, fs, xs;
  __host__ __device__ int stage() const { return k * (fs + xs); }
};

size_t ring_smem(const RingDims& d) {
  return sizeof(__nv_bfloat16) * static_cast<size_t>(RING_STAGES) * d.stage();
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
#if defined(__CUDA_ARCH__)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
#else
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

// Waits until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

// 8 consecutive bf16 of shared memory (16-byte aligned) as f32 (exact: a
// shift or a mask).
__device__ __forceinline__ void unpack8(const __nv_bfloat16* p, float (&out)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    out[2 * j] = __uint_as_float(w[j] << 16);
    out[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

// Site s's h [K, F] and tc [K, X] into a ring stage (h rows fs apart, then
// tc rows xs apart). VEC: 16-byte copies in flight (F and X multiples of
// 8, operands aligned); else plain loads and stores.
template <bool VEC>
__device__ void ring_load(const __nv_bfloat16* __restrict__ h,
                          const __nv_bfloat16* __restrict__ tc, const RingDims& d, int64_t s,
                          __nv_bfloat16* hs) {
  __nv_bfloat16* ts = hs + d.k * d.fs;
  const __nv_bfloat16* hsrc = h + s * d.k * d.f;
  const __nv_bfloat16* tsrc = tc + s * d.k * d.x;
  if (VEC) {
    const int hc = d.f / 8, xc = d.x / 8;  // 16-byte pieces of a row
    for (int e = threadIdx.x; e < d.k * hc; e += RING_THREADS)
      cp_async16(hs + (e / hc) * d.fs + (e % hc) * 8, hsrc + e * 8);
    for (int e = threadIdx.x; e < d.k * xc; e += RING_THREADS)
      cp_async16(ts + (e / xc) * d.xs + (e % xc) * 8, tsrc + e * 8);
  } else {
    for (int e = threadIdx.x; e < d.k * d.f; e += RING_THREADS)
      hs[(e / d.f) * d.fs + e % d.f] = hsrc[e];
    for (int e = threadIdx.x; e < d.k * d.x; e += RING_THREADS)
      ts[(e / d.x) * d.xs + e % d.x] = tsrc[e];
  }
}

// Whether any of the values this thread copied into a ring stage (after
// its wait: they are visible to it) is other than ±0.
template <bool VEC>
__device__ bool own_nonzero(const RingDims& d, const __nv_bfloat16* hs) {
  const __nv_bfloat16* ts = hs + d.k * d.fs;
  uint32_t bits = 0;
  if (VEC) {
    const int hc = d.f / 8, xc = d.x / 8;
    for (int e = threadIdx.x; e < d.k * hc; e += RING_THREADS) {
      const uint4 v = *reinterpret_cast<const uint4*>(hs + (e / hc) * d.fs + (e % hc) * 8);
      bits |= v.x | v.y | v.z | v.w;
    }
    for (int e = threadIdx.x; e < d.k * xc; e += RING_THREADS) {
      const uint4 v = *reinterpret_cast<const uint4*>(ts + (e / xc) * d.xs + (e % xc) * 8);
      bits |= v.x | v.y | v.z | v.w;
    }
    bits &= 0x7fff7fffu;  // the signs of both halves
  } else {
    const uint16_t* hb = reinterpret_cast<const uint16_t*>(hs);
    const uint16_t* tb = reinterpret_cast<const uint16_t*>(ts);
    for (int e = threadIdx.x; e < d.k * d.f; e += RING_THREADS) bits |= hb[(e / d.f) * d.fs + e % d.f];
    for (int e = threadIdx.x; e < d.k * d.x; e += RING_THREADS) bits |= tb[(e / d.x) * d.xs + e % d.x];
    bits &= 0x7fffu;
  }
  return bits != 0;
}

// Persistent blocks walk the sites with the grid's stride; the copies of
// the next RING_STAGES − 1 sites are in flight while one is computed. Each
// thread owns 8 (x) × 8 (f) tiles of M and sums over k in order. A site
// whose h and tc are all ±0 (the SE(3)-Transformer's sites with no
// neighbour within the radius: 48 % at batch 768) skips the products: every
// sum of its ±0 products from +0 is +0, which it writes.
template <bool VEC>
__global__ void __launch_bounds__(RING_THREADS, 5)  // 5 blocks an SM: at most 102 registers
    pooled_m_fwd_ring_kernel(const __nv_bfloat16* __restrict__ h,
                             const __nv_bfloat16* __restrict__ tc,
                             __nv_bfloat16* __restrict__ m, RingDims d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int64_t step = gridDim.x;
#pragma unroll
  for (int j = 0; j < RING_STAGES - 1; ++j) {
    const int64_t s = blockIdx.x + j * step;
    if (s < d.s) ring_load<VEC>(h, tc, d, s, ring + j * d.stage());
    cp_async_commit();
  }
  const int nft = (d.f + 7) / 8, nxt = (d.x + 7) / 8;
  int it = 0;
  for (int64_t s = blockIdx.x; s < d.s; s += step, ++it) {
    cp_async_wait<RING_STAGES - 2>();
    const __nv_bfloat16* hs = ring + (it % RING_STAGES) * d.stage();
    const __nv_bfloat16* ts = hs + d.k * d.fs;
    // site s staged; every thread done with the stage refilled below
    const bool nonzero = __syncthreads_or(own_nonzero<VEC>(d, hs));
    const int64_t next = s + (RING_STAGES - 1) * step;
    if (next < d.s)
      ring_load<VEC>(h, tc, d, next, ring + ((it + RING_STAGES - 1) % RING_STAGES) * d.stage());
    cp_async_commit();
    __nv_bfloat16* out = m + s * d.x * d.f;
    for (int item = threadIdx.x; item < nft * nxt; item += RING_THREADS) {
      const int f0 = (item % nft) * 8, x0 = (item / nft) * 8;
      float acc[8][8] = {};
      for (int k = 0; nonzero && k < d.k; ++k) {
        float hv[8], tv[8];
        unpack8(hs + k * d.fs + f0, hv);
        unpack8(ts + k * d.xs + x0, tv);
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(tv[r], hv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (x0 + r >= d.x) break;
        __nv_bfloat16* orow = out + static_cast<int64_t>(x0 + r) * d.f + f0;
        if (VEC) {
          uint4 v;
          uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const __nv_bfloat162 p = __floats2bfloat162_rn(acc[r][2 * j], acc[r][2 * j + 1]);
            w[j] = *reinterpret_cast<const uint32_t*>(&p);
          }
          __stcs(reinterpret_cast<uint4*>(orow), v);  // streamed: M is not read back here
        } else {
          for (int c = 0; c < 8 && f0 + c < d.f; ++c) orow[c] = __float2bfloat16_rn(acc[r][c]);
        }
      }
    }
  }
  cp_async_wait<0>();
}

// ------------------------------------------- kernel M in bf16: the ring

constexpr int BWD_THREADS = 128;  // 4 warps: the first two sum dh, the last two dtc
constexpr int BWD_HALF = BWD_THREADS / 2;
constexpr int XC = 64;            // rows of dM a stage holds: a site's X goes in chunks of 64
// sites whose h and tc the ring holds: this one, the next (its liveness read
// at this one's last unit) and HT_SLOTS - 2 more in flight (4 slots were as
// fast at X = 64 on the card and 12 % slower at X = 192, with a block an SM
// fewer)
constexpr int HT_SLOTS = 3;
constexpr int DH_W = 8;  // dh thread tiles: 4 k × DH_W f
constexpr int DT_W = 4;  // dtc thread tiles: 4 k × DT_W x

// The staged shapes (in bf16 elements): K rounded up to 4 (kp), F and X to 8
// (fs, xs); a dM stage of xc = min(xs, XC) rows fs apart, whose 16-byte
// pieces are swizzled (piece q of row r at q ^ (r / DT_W mod 8) where a row
// has a multiple of 8 pieces: swz 7, else 0), so that the 8 threads of a
// quarter-warp of dtc, reading one piece of rows DT_W apart, hit 8 bank
// groups; nc stages a live site; fsh = log2(F / 8) where F / 8 is a power
// of 2, else -1 (a copy's row by a shift, not a division).
struct BwdDims {
  int64_t s;
  int k, f, x, kp, fs, xs, xc, swz, nc, fsh;
  __host__ __device__ int ht() const { return kp * (fs + xs); }  // h [kp][fs], then tc [kp][xs]
  __host__ __device__ int dmb() const { return xc * fs; }
};

BwdDims bwd_dims(int64_t s, int k, int f, int x) {
  BwdDims d{s, k, f, x, round_up(k, 4), round_up(f, 8), round_up(x, 8), 0, 0, 0, -1};
  d.xc = d.xs < XC ? d.xs : XC;
  d.swz = d.fs / 8 % 8 == 0 ? 7 : 0;
  d.nc = (d.xs + XC - 1) / XC;
  for (int b = 0; b < 16; ++b)
    if (f / 8 == 1 << b) d.fsh = b;
  return d;
}

// The ring's h/tc slots and dM stages and, for a site of more than one
// stage, dh's running f32 sums [kp][fs].
size_t bwd_ring_smem(const BwdDims& d) {
  return sizeof(__nv_bfloat16) * (static_cast<size_t>(HT_SLOTS) * d.ht() + 2 * d.dmb()) +
         (d.nc > 1 ? sizeof(float) * d.kp * d.fs : 0);
}

// Element (r, c) of a staged dM stage.
__device__ __forceinline__ int dm_at(const BwdDims& d, int r, int c) {
  return r * d.fs + (((c >> 3) ^ ((r / DT_W) & d.swz)) << 3) + (c & 7);
}

// W consecutive bf16 of shared memory (2W-byte aligned) as f32, exactly.
template <int W>
__device__ __forceinline__ void unpack(const __nv_bfloat16* p, float (&out)[W]) {
  if constexpr (W == 8) {
    unpack8(p, out);
  } else {
    uint32_t w[W / 2];
    if constexpr (W == 4) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x, w[1] = v.y;
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    }
#pragma unroll
    for (int j = 0; j < W / 2; ++j) {
      out[2 * j] = __uint_as_float(w[j] << 16);
      out[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
}

// The first n of v rounded to bf16 into dst: with VEC (all W there, dst
// 2W-byte aligned) one streaming store of 2W bytes, else one element each.
template <int W, bool VEC>
__device__ __forceinline__ void put(__nv_bfloat16* dst, const float (&v)[W], int n) {
  if (VEC) {
    uint32_t w[W / 2];
#pragma unroll
    for (int j = 0; j < W / 2; ++j) {
      const __nv_bfloat162 q = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
      w[j] = *reinterpret_cast<const uint32_t*>(&q);
    }
    if constexpr (W == 8) __stcs(reinterpret_cast<uint4*>(dst), make_uint4(w[0], w[1], w[2], w[3]));
    else if constexpr (W == 4) __stcs(reinterpret_cast<uint2*>(dst), make_uint2(w[0], w[1]));
    else __stcs(reinterpret_cast<unsigned*>(dst), w[0]);
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j)
      if (j < n) dst[j] = __float2bfloat16_rn(v[j]);
  }
}

// Site s's h and tc into an h/tc slot. VEC: 16-byte copies in flight (F and
// X multiples of 8, operands aligned: the slot's rows are the operands'
// rows, so each is one flat copy); else plain loads, the columns past F and
// X zeroed (they join the sums as +0 products, after the real ones).
template <bool VEC>
__device__ void ht_load(const __nv_bfloat16* __restrict__ h, const __nv_bfloat16* __restrict__ tc,
                        const BwdDims& d, int64_t s, __nv_bfloat16* hs) {
  __nv_bfloat16* ts = hs + d.kp * d.fs;
  const __nv_bfloat16* hsrc = h + s * d.k * d.f;
  const __nv_bfloat16* tsrc = tc + s * d.k * d.x;
  if (VEC) {
    for (int e = threadIdx.x; e < d.k * d.f / 8; e += BWD_THREADS) cp_async16(hs + e * 8, hsrc + e * 8);
    for (int e = threadIdx.x; e < d.k * d.x / 8; e += BWD_THREADS) cp_async16(ts + e * 8, tsrc + e * 8);
  } else {
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
    for (int e = threadIdx.x; e < d.k * d.fs; e += BWD_THREADS) {
      const int r = e / d.fs, c = e % d.fs;
      hs[e] = c < d.f ? hsrc[r * d.f + c] : zero;
    }
    for (int e = threadIdx.x; e < d.k * d.xs; e += BWD_THREADS) {
      const int r = e / d.xs, c = e % d.xs;
      ts[e] = c < d.x ? tsrc[r * d.x + c] : zero;
    }
  }
}

// Whether any of the h and tc values this thread copied into a slot (after
// its wait: they are visible to it) is other than ±0.
template <bool VEC>
__device__ bool ht_nonzero(const BwdDims& d, const __nv_bfloat16* hs) {
  const __nv_bfloat16* ts = hs + d.kp * d.fs;
  uint32_t bits = 0;
  if (VEC) {
    for (int e = threadIdx.x; e < d.k * d.f / 8; e += BWD_THREADS) {
      const uint4 v = reinterpret_cast<const uint4*>(hs)[e];
      bits |= v.x | v.y | v.z | v.w;
    }
    for (int e = threadIdx.x; e < d.k * d.x / 8; e += BWD_THREADS) {
      const uint4 v = reinterpret_cast<const uint4*>(ts)[e];
      bits |= v.x | v.y | v.z | v.w;
    }
  } else {
    const uint16_t* hb = reinterpret_cast<const uint16_t*>(hs);
    const uint16_t* tb = reinterpret_cast<const uint16_t*>(ts);
    for (int e = threadIdx.x; e < d.k * d.fs; e += BWD_THREADS) bits |= hb[e];
    for (int e = threadIdx.x; e < d.k * d.xs; e += BWD_THREADS) bits |= tb[e];
  }
  return (bits & 0x7fff7fffu) != 0;  // the signs aside: a site of ±0 alone has no neighbour
}

// Stage c (rows c·XC ..) of site s's dM into a dM stage; without VEC the
// rows past X and the columns past F zeroed.
template <bool VEC>
__device__ void dm_load(const __nv_bfloat16* __restrict__ dm, const BwdDims& d, int64_t s, int c,
                        __nv_bfloat16* st) {
  const int x0 = c * XC;
  const __nv_bfloat16* src = dm + s * d.x * d.f + static_cast<int64_t>(x0) * d.f;
  if (VEC) {
    const int rows = d.x - x0 < XC ? d.x - x0 : XC, fc = d.f / 8;
    for (int e = threadIdx.x; e < rows * fc; e += BWD_THREADS) {
      const int r = d.fsh >= 0 ? e >> d.fsh : e / fc;
      cp_async16(st + dm_at(d, r, (e - r * fc) * 8), src + e * 8);
    }
  } else {
    const int rows = d.xs - x0 < XC ? d.xs - x0 : XC;
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
    for (int e = threadIdx.x; e < rows * d.fs; e += BWD_THREADS) {
      const int r = e / d.fs, c2 = e % d.fs;
      st[dm_at(d, r, c2)] = x0 + r < d.x && c2 < d.f ? src[r * d.f + c2] : zero;
    }
  }
}

// Stage c of live site s: dh's threads add the stage's x to their tiles'
// sums (kept in f32 between stages) and store them after the last; dtc's
// threads sum the stage's columns of dtc over all of f and store them. Both
// sum in order and round once.
template <bool VEC>
__device__ void bwd_stage(const BwdDims& d, const __nv_bfloat16* hs, const __nv_bfloat16* dms,
                          float* part, int c, __nv_bfloat16* __restrict__ dh,
                          __nv_bfloat16* __restrict__ dtc, int64_t s) {
  const __nv_bfloat16* ts = hs + d.kp * d.fs;
  const int cx = c * XC, xcc = d.xs - cx < XC ? d.xs - cx : XC;
  const bool first = c == 0, last = c == d.nc - 1;
  if (threadIdx.x < BWD_HALF) {  // dh[k0 + r][f0 + j] += Σ_x tc[k0 + r][x] · dM[x][f0 + j]
    const int nfg = d.fs / DH_W, n = d.kp / 4 * nfg;
    for (int it = threadIdx.x; it < n; it += BWD_HALF) {
      const int k0 = it / nfg * 4, f0 = it % nfg * DH_W;
      float acc[4][DH_W];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < DH_W; ++j) acc[r][j] = first ? 0.f : part[(k0 + r) * d.fs + f0 + j];
      for (int x0 = 0; x0 < xcc; x0 += 8) {
        float tv[4][8];
#pragma unroll
        for (int r = 0; r < 4; ++r) unpack8(ts + (k0 + r) * d.xs + cx + x0, tv[r]);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          float mv[DH_W];
          unpack<DH_W>(dms + dm_at(d, x0 + q, f0), mv);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int j = 0; j < DH_W; ++j) acc[r][j] = fmaf(tv[r][q], mv[j], acc[r][j]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (!last) {
#pragma unroll
          for (int j = 0; j < DH_W; ++j) part[(k0 + r) * d.fs + f0 + j] = acc[r][j];
        } else if (k0 + r < d.k && f0 < d.f) {
          put<DH_W, VEC>(dh + (s * d.k + k0 + r) * d.f + f0, acc[r], d.f - f0);
        }
      }
    }
  } else {  // dtc[k0 + r][x0 + j] = Σ_f h[k0 + r][f] · dM[x0 + j][f]
    // every lane takes each round (the pairs' exchange below), xcc / DT_W even
    const int nxg = xcc / DT_W, n = d.kp / 4 * nxg;
    const int lane = threadIdx.x & 31;
    for (int base = 0; base < n; base += BWD_HALF) {
      const int it = base + threadIdx.x - BWD_HALF;
      const bool on = it < n;
      const int k0 = on ? it / nxg * 4 : 0, x0 = on ? it % nxg * DT_W : 0;
      float acc[4][DT_W] = {};
      for (int f0 = 0; on && f0 < d.fs; f0 += 8) {
        float hv[4][8];
#pragma unroll
        for (int r = 0; r < 4; ++r) unpack8(hs + (k0 + r) * d.fs + f0, hv[r]);
#pragma unroll
        for (int j = 0; j < DT_W; ++j) {
          float mv[8];
          unpack8(dms + dm_at(d, x0 + j, f0), mv);
#pragma unroll
          for (int q = 0; q < 8; ++q)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[r][j] = fmaf(hv[r][q], mv[q], acc[r][j]);
        }
      }
      const int xg = cx + x0;
      if constexpr (VEC && DT_W == 4) {
        // lanes 2m and 2m + 1 hold x0 .. x0 + 3 and x0 + 4 .. x0 + 7 of rows k0 .. k0 + 3:
        // the even lane takes rows k0, k0 + 1 and the odd one k0 + 2, k0 + 3, 8 x each
        const bool odd = lane & 1;
        float sent[8], got[8], row[2][8];
#pragma unroll
        for (int i = 0; i < 8; ++i) sent[i] = odd ? acc[i / 4][i % 4] : acc[2 + i / 4][i % 4];
#pragma unroll
        for (int i = 0; i < 8; ++i) got[i] = __shfl_xor_sync(0xffffffffu, sent[i], 1);
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            row[m][j] = odd ? got[4 * m + j] : acc[m][j];
            row[m][4 + j] = odd ? acc[2 + m][j] : got[4 * m + j];
          }
        const int kr = k0 + (odd ? 2 : 0), xr = xg - (odd ? DT_W : 0);
#pragma unroll
        for (int m = 0; m < 2; ++m)
          if (on && kr + m < d.k) put<8, true>(dtc + (s * d.k + kr + m) * d.x + xr, row[m], 8);
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (on && k0 + r < d.k && xg < d.x)
            put<DT_W, false>(dtc + (s * d.k + k0 + r) * d.x + xg, acc[r], d.x - xg);
      }
    }
  }
}

// A dead site's dh and dtc: +0, the value of every sum of its ±0 products
// from +0 (for a finite dM), which the site's dM is not read for.
template <bool VEC>
__device__ void zero_site(const BwdDims& d, __nv_bfloat16* __restrict__ dh,
                          __nv_bfloat16* __restrict__ dtc, int64_t s) {
  __nv_bfloat16* dhs = dh + s * d.k * d.f;
  __nv_bfloat16* dts = dtc + s * d.k * d.x;
  if (VEC) {
    const uint4 z = make_uint4(0, 0, 0, 0);
    for (int e = threadIdx.x; e < d.k * d.f / 8; e += BWD_THREADS)
      __stcs(reinterpret_cast<uint4*>(dhs) + e, z);
    for (int e = threadIdx.x; e < d.k * d.x / 8; e += BWD_THREADS)
      __stcs(reinterpret_cast<uint4*>(dts) + e, z);
  } else {
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
    for (int e = threadIdx.x; e < d.k * d.f; e += BWD_THREADS) dhs[e] = zero;
    for (int e = threadIdx.x; e < d.k * d.x; e += BWD_THREADS) dts[e] = zero;
  }
}

// Persistent blocks walk the sites with the grid's stride, a live site in
// nc units (its dM stages), a dead one in one. At the top of each unit the
// block waits for its copies and, at a site's last unit, ORs the next
// site's staged h and tc. Then it issues the next unit's dM stage (the next
// one of this site, or the next site's first if that site is live) and, at
// a site's last unit, the h and tc of the site HT_SLOTS - 1 on, in two copy
// groups: they fly while this unit's products run, and a top waits for all
// but the newest group (the h and tc, needed only HT_SLOTS - 2 units on).
template <bool VEC>
__global__ void __launch_bounds__(BWD_THREADS, 3)
    pooled_m_bwd_ring_kernel(const __nv_bfloat16* __restrict__ h,
                             const __nv_bfloat16* __restrict__ tc,
                             const __nv_bfloat16* __restrict__ dm, __nv_bfloat16* __restrict__ dh,
                             __nv_bfloat16* __restrict__ dtc, BwdDims d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ht = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [HT_SLOTS] slots
  __nv_bfloat16* dmb = ht + HT_SLOTS * d.ht();                       // [2] dM stages
  float* part = reinterpret_cast<float*>(dmb + 2 * d.dmb());         // dh's sums (nc > 1)
  const int64_t step = gridDim.x;
  int64_t s = blockIdx.x;
  if (s >= d.s) return;
#pragma unroll
  for (int j = 0; j < HT_SLOTS - 1; ++j) {
    if (s + j * step < d.s) ht_load<VEC>(h, tc, d, s + j * step, ht + j * d.ht());
    cp_async_commit();
  }
  cp_async_wait<HT_SLOTS - 2>();
  bool live = __syncthreads_or(ht_nonzero<VEC>(d, ht));
  if (live) dm_load<VEC>(dm, d, s, 0, dmb);
  cp_async_commit();
  cp_async_commit();
  int slot = 0, c = 0, rbuf = 0, wbuf = live ? 1 : 0;
  while (true) {
    const bool last = !live || c == d.nc - 1;
    const int64_t next = s + step;
    const int nslot = slot + 1 < HT_SLOTS ? slot + 1 : 0;
    cp_async_wait<HT_SLOTS - 3>();
    // this unit's dM stage landed (and, at a site's last unit, the next
    // site's h and tc); every thread is done with the buffers refilled below
    const bool live_next =
        __syncthreads_or(last && next < d.s && ht_nonzero<VEC>(d, ht + nslot * d.ht()));
    if (!last) {
      dm_load<VEC>(dm, d, s, c + 1, dmb + wbuf * d.dmb());
      wbuf ^= 1;
    } else if (live_next) {
      dm_load<VEC>(dm, d, next, 0, dmb + wbuf * d.dmb());
      wbuf ^= 1;
    }
    cp_async_commit();  // in flight while this unit's products run
    if (last && next + (HT_SLOTS - 2) * step < d.s)
      ht_load<VEC>(h, tc, d, next + (HT_SLOTS - 2) * step,
                   ht + (slot + HT_SLOTS - 1) % HT_SLOTS * d.ht());
    cp_async_commit();
    if (live) {
      bwd_stage<VEC>(d, ht + slot * d.ht(), dmb + rbuf * d.dmb(), part, c, dh, dtc, s);
      rbuf ^= 1;
    } else {
      zero_site<VEC>(d, dh, dtc, s);
    }
    if (!last) {
      ++c;
      continue;
    }
    if (next >= d.s) break;
    s = next, slot = nslot, live = live_next, c = 0;
  }
  cp_async_wait<0>();
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

bool bad_dims(const Dims& d) { return d.s < 0 || d.k < 0 || d.f < 0 || d.x < 0; }

// p 16-byte aligned and each site's n elements whole vectors of T.
template <typename T>
bool vec_ok(const void* p, int64_t n) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && n % vw<T>() == 0;
}

int grid_of(int64_t s) { return static_cast<int>(s < MAX_GRID ? s : MAX_GRID); }

template <typename T>
int fwd(const T* h, const T* tc, T* m, int64_t s, int k, int f, int x, cudaStream_t stream) {
  const Dims d{s, k, f, x};
  if (bad_dims(d)) return static_cast<int>(cudaErrorInvalidValue);
  if (s == 0 || f == 0 || x == 0) return 0;  // an empty output
  const size_t smem = static_cast<size_t>(k) * (round_up(f, 8) + round_up(x, 4)) * sizeof(float);
  const cudaError_t err = set_smem(pooled_m_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Vec vec{vec_ok<T>(h, static_cast<int64_t>(k) * f), vec_ok<T>(tc, static_cast<int64_t>(k) * x),
                false, vec_ok<T>(m, f)};
  pooled_m_fwd_kernel<T><<<grid_of(s), THREADS, smem, stream>>>(h, tc, m, d, vec);
  return static_cast<int>(cudaGetLastError());
}

// L in bf16: persistent blocks, as many as fit the card at once.
int fwd_ring(const __nv_bfloat16* h, const __nv_bfloat16* tc, __nv_bfloat16* m, int64_t s,
             int k, int f, int x, cudaStream_t stream) {
  if (s < 0 || k < 0 || f < 0 || x < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (s == 0 || f == 0 || x == 0) return 0;  // an empty output
  const RingDims d{s, k, f, x, round_up(f, 8), round_up(x, 8)};
  const size_t smem = ring_smem(d);
  const bool vec = f % 8 == 0 && x % 8 == 0 && vec_ok<__nv_bfloat16>(h, 0) &&
                   vec_ok<__nv_bfloat16>(tc, 0) && vec_ok<__nv_bfloat16>(m, 0);
  void (*kernel)(const __nv_bfloat16*, const __nv_bfloat16*, __nv_bfloat16*, RingDims) =
      vec ? pooled_m_fwd_ring_kernel<true> : pooled_m_fwd_ring_kernel<false>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, RING_THREADS, smem)) !=
          cudaSuccess)
    return static_cast<int>(err);
  const int64_t slots = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  kernel<<<static_cast<int>(s < slots ? s : slots), RING_THREADS, smem, stream>>>(h, tc, m, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd(const T* h, const T* tc, const T* dm, T* dh, T* dtc, int64_t s, int k, int f, int x,
        cudaStream_t stream) {
  const Dims d{s, k, f, x};
  if (bad_dims(d)) return static_cast<int>(cudaErrorInvalidValue);
  if (s == 0 || k == 0) return 0;  // empty gradients
  const int kp = round_up(k, 4);
  const size_t smem = static_cast<size_t>(f + x) * kp * sizeof(float) +
                      static_cast<size_t>(x) * dm_stride<T>(f) * sizeof(T);
  const cudaError_t err = set_smem(pooled_m_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Vec vec{vec_ok<T>(h, static_cast<int64_t>(k) * f), vec_ok<T>(tc, static_cast<int64_t>(k) * x),
                vec_ok<T>(dm, static_cast<int64_t>(x) * f), false};
  pooled_m_bwd_kernel<T><<<grid_of(s), THREADS, smem, stream>>>(h, tc, dm, dh, dtc, d, vec);
  return static_cast<int>(cudaGetLastError());
}

// M in bf16: persistent blocks, as many as fit the card at once.
int bwd_ring(const __nv_bfloat16* h, const __nv_bfloat16* tc, const __nv_bfloat16* dm,
             __nv_bfloat16* dh, __nv_bfloat16* dtc, int64_t s, int k, int f, int x,
             cudaStream_t stream) {
  if (s < 0 || k < 0 || f < 0 || x < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (s == 0 || k == 0) return 0;  // empty gradients
  if (f == 0 || x == 0) {  // one gradient is empty, the other sums nothing
    const size_t n = static_cast<size_t>(s) * k * (f + x) * sizeof(__nv_bfloat16);
    return static_cast<int>(cudaMemsetAsync(f ? static_cast<void*>(dh) : static_cast<void*>(dtc),
                                            0, n, stream));
  }
  const BwdDims d = bwd_dims(s, k, f, x);
  const size_t smem = bwd_ring_smem(d);
  const bool vec = f % 8 == 0 && x % 8 == 0 && vec_ok<__nv_bfloat16>(h, 0) &&
                   vec_ok<__nv_bfloat16>(tc, 0) && vec_ok<__nv_bfloat16>(dm, 0) &&
                   vec_ok<__nv_bfloat16>(dh, 0) && vec_ok<__nv_bfloat16>(dtc, 0);
  void (*kernel)(const __nv_bfloat16*, const __nv_bfloat16*, const __nv_bfloat16*,
                 __nv_bfloat16*, __nv_bfloat16*, BwdDims) =
      vec ? pooled_m_bwd_ring_kernel<true> : pooled_m_bwd_ring_kernel<false>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BWD_THREADS, smem)) !=
          cudaSuccess)
    return static_cast<int>(err);
  const int64_t slots = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  kernel<<<static_cast<int>(s < slots ? s : slots), BWD_THREADS, smem, stream>>>(h, tc, dm, dh,
                                                                                 dtc, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Writes M [S, X, F] = L(h [S, K, F], tc [S, K, X]); K = 0 gives zeros.
extern "C" int pooled_m_fwd_bf16(const __nv_bfloat16* h, const __nv_bfloat16* tc,
                                 __nv_bfloat16* m, int64_t s, int k, int f, int x,
                                 cudaStream_t stream) {
  return fwd_ring(h, tc, m, s, k, f, x, stream);
}

extern "C" int pooled_m_fwd_f32(const float* h, const float* tc, float* m, int64_t s, int k,
                                int f, int x, cudaStream_t stream) {
  return fwd(h, tc, m, s, k, f, x, stream);
}

// Writes dh [S, K, F] and dtc [S, K, X] for the gradient dm [S, X, F] of M.
extern "C" int pooled_m_bwd_bf16(const __nv_bfloat16* h, const __nv_bfloat16* tc,
                                 const __nv_bfloat16* dm, __nv_bfloat16* dh, __nv_bfloat16* dtc,
                                 int64_t s, int k, int f, int x, cudaStream_t stream) {
  return bwd_ring(h, tc, dm, dh, dtc, s, k, f, x, stream);
}

extern "C" int pooled_m_bwd_f32(const float* h, const float* tc, const float* dm, float* dh,
                                float* dtc, int64_t s, int k, int f, int x, cudaStream_t stream) {
  return bwd(h, tc, dm, dh, dtc, s, k, f, x, stream);
}
