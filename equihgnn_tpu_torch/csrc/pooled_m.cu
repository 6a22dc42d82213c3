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
// M: one block of 256 threads per site (a grid-stride loop over the
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
  return bwd(h, tc, dm, dh, dtc, s, k, f, x, stream);
}

extern "C" int pooled_m_bwd_f32(const float* h, const float* tc, const float* dm, float* dh,
                                float* dtc, int64_t s, int k, int f, int x, cudaStream_t stream) {
  return bwd(h, tc, dm, dh, dtc, s, k, f, x, stream);
}
