// The fused pooled ConvSE3 unit of the SE(3)-Transformer in bfloat16: kernel
// J (forward) and kernel K (backward) of the bfloat16 path. The float32 J
// and K are `pooled_conv_fwd.cu` and `pooled_conv.cu`, kept apart.
//
//   M[s,c,i,f]   = bf16(Σ_k h[s,k,f] · tc[s,k,c,i])               (k = the neighbours)
//   J out[s,c,o] = bf16(Σ_{i,f} W[f,o,i] · M[s,c,i,f])            (s live, else 0)
//   K dM[s,c,i,f]  = bf16(Σ_o dout[s,c,o] · W[f,o,i])             (s live)
//     dh[s,k,f]    = bf16(Σ_{c,i} tc[s,k,c,i] · dM[s,c,i,f])      (0 at dead sites)
//     dtc[s,k,c,i] = bf16(Σ_f h[s,k,f] · dM[s,c,i,f])             (0 at dead sites)
//     dW[f,o,i]    = bf16(Σ_{s live, c} M[s,c,i,f] · dout[s,c,o])
//
// Every sum is a float32 sum of exact products of bfloat16 values, rounded
// to bfloat16 once, where JAX's bfloat16 Pallas kernels round
// (`equihgnn_tpu/ops/pallas/pooled_conv.py`: M in VMEM `:97`, out `:111`,
// dM `:134`, dh and dtc `:152-158`, dW summed in f32 over the whole grid
// and rounded once `:132, :141`). Shapes (s = the G·A sites): h [S, K, F];
// tc [S, K, C·I] (c outer, i inner); W [F, O, I] and dW as JAX lays them
// out (i contiguous); out and dout [S, C, O]. All bfloat16. The live sites
// are given, as for the f32 kernels, by the ids of the sites (live ones
// first) and their count, both on the device; without them every site is
// live. A dead site's out is not written (the caller zeroes it), its dout
// is not read, and its dh and dtc are written as +0.
// Replaces equihgnn_tpu/ops/pallas/pooled_conv.py `_pc_fwd` and `_pc_bwd`
// in bfloat16.
//
// Design: simple and deterministic (no atomics; each output element owned
// by one thread and summed in a fixed order, so two runs give the same
// bits). The products that carry the work, the projection (J), dM and dW
// (K), run on the tensor cores as bfloat16 mma.sync.m16n8k16 with float32
// sums; the K = 16 contractions (the M build, dh, dtc) on the CUDA cores
// in float32, k in order. No copy is overlapped with compute: a block
// stages a chunk, waits, computes, and waits again.
//
//  - J (`fwd_kernel`): one block a tile of 64 / C sites of the list (64
//    rows) × 256 columns of O. The contraction (i, f) runs in chunks of
//    16 i × 4 f (four k16 steps, each 16 consecutive i of one f, which W
//    holds contiguously); per chunk the block stages W [4 f, 256 o, 16 i],
//    h [sites, K, 4 f] and, once an i-chunk, tc [rows, K, 16 i], builds
//    the [64, 64] M tile on the CUDA cores, rounds it to bfloat16 and
//    multiplies. Each chunk is summed from 0 in the tensor cores and added
//    to the running sums on the CUDA cores (the tensor cores' adds
//    truncate; carried over the whole contraction in one accumulator they
//    drift, as the f32 J's did, PERF.md). 8 warps, each a 32 × 64 patch.
//  - K, dM/dh/dtc (`dm_kernel`): one block a tile of TS sites (TS·C ≤ 16
//    rows where C ≤ 16; 16 sites at C = 1, 5 at C = 3), sized to shared
//    memory. It stages the tile's dout rows once, then walks i-chunks of 8
//    (outer) and f-chunks of 8 (inner): per chunk W [8 f, all O, 8 i],
//    re-laid so that each column's o are contiguous, the dM tile [rows,
//    64 columns] over all of O on the tensor cores (8 warps, 8 columns
//    each), rounded to bfloat16; then Σ_f h·dM into the i-chunk's dtc sums
//    (written once its f-chunks are done) and Σ_{c,i} tc·dM into the
//    block's dh sums, [TS, K, F] float32 in shared memory until the block
//    ends. Tiles past the live count write their sites' dh and dtc as +0.
//  - K, dW (`dw_kernel`): one block a tile of 8 i × 8 f (64 pairs) × 256
//    columns of O; it walks the live rows (s, c) 32 at a time, stages
//    their h, tc and dout (transposed), rebuilds Mᵀ [64 pairs, 32 rows],
//    rounded to bfloat16, and multiplies it by dout [32 rows, 256 o]; each
//    chunk of 32 rows summed from 0 in the tensor cores, the running sums
//    on the CUDA cores.
// Limits: K ≤ 32 (a chunk stages a site's K neighbours whole) and C ≤ 64
// (a J tile holds the C rows of one site at least). The dM kernel's tile
// must fit shared memory: its dh sums [TS, K, F], the whole of O of its
// W chunk and of its dout rows (at K = 16, F = 128: O up to ~1,000). A
// shape that does not fit is refused (cudaErrorInvalidValue).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int MAX_K = 32;
constexpr int MAX_C = 64;
constexpr size_t MAX_SMEM = 232448;  // shared memory a block may use on Hopper

__device__ __forceinline__ float f32(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a · b: one bf16 m16n8k16 tensor-core product with f32 sums. a is the
// row-major [16, 16] fragment, b the column-major [16, 8] one.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The A fragment of rows r0..r0+15, columns k0..k0+15 of a row-major bf16
// tile with row stride `ld` (elements).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* t, int ld, int r0, int k0,
                                       int lane) {
  const bf16* p = t + (r0 + (lane >> 2)) * ld + k0 + (lane & 3) * 2;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// The B fragment of columns n0..n0+7, rows k0..k0+15 of a bf16 tile stored
// column by column (each column's k contiguous, column stride `ld`).
__device__ __forceinline__ void load_b(uint32_t (&b)[2], const bf16* t, int ld, int n0, int k0,
                                       int lane) {
  const bf16* p = t + (n0 + (lane >> 2)) * ld + k0 + (lane & 3) * 2;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

// 8 bf16 from global memory (16 bytes): one vector load where `vec` (the
// caller checked alignment) and all 8 lie in the row, else element by
// element, 0 past `n` valid elements.
__device__ __forceinline__ uint4 load8(const bf16* p, int n, bool vec) {
  if (vec && n >= 8) return *reinterpret_cast<const uint4*>(p);
  uint4 r = make_uint4(0, 0, 0, 0);
  bf16* v = reinterpret_cast<bf16*>(&r);
  for (int j = 0; j < 8 && j < n; ++j) v[j] = p[j];
  return r;
}

// Element e of 8 bf16 held in a uint4.
__device__ __forceinline__ bf16 at(const uint4& v, int e) {
  return reinterpret_cast<const bf16*>(&v)[e];
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

size_t up16(size_t bytes) { return (bytes + 15) / 16 * 16; }

cudaError_t set_smem(const void* kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// ------------------------------------------------------------- kernel J

namespace j {

constexpr int BM = 64;        // rows of a tile
constexpr int BN = 256;       // columns of O of a block
constexpr int IC = 16;        // i of a chunk: one k16 step
constexpr int FC = 4;         // f of a chunk: four k16 steps
constexpr int KC = IC * FC;   // contraction columns of a chunk, f outer, i inner
constexpr int AS = KC + 8;    // row stride of the M tile (bf16): 36 words, no bank conflict
constexpr int WS = IC + 8;    // (f, o) stride of the W chunk (bf16): 12 words

struct Layout {  // byte offsets of the shared-memory regions
  size_t w, a, tc, h, sid, total;
  Layout(int k, int c) {
    const int spt = BM / c;
    w = 0;
    a = w + up16(static_cast<size_t>(FC) * BN * WS * sizeof(bf16));
    tc = a + up16(static_cast<size_t>(BM) * AS * sizeof(bf16));
    h = tc + up16(static_cast<size_t>(BM) * k * IC * sizeof(bf16));
    sid = h + up16(static_cast<size_t>(spt) * k * FC * sizeof(float));
    total = sid + up16(BM * sizeof(int));
  }
};

__global__ void __launch_bounds__(THREADS, 1)
fwd_kernel(const bf16* __restrict__ h, const bf16* __restrict__ tc, const bf16* __restrict__ w,
           const int* __restrict__ ids, const int* __restrict__ count, bf16* __restrict__ out,
           int s, int K, int C, int I, int F, int O, size_t off_a, size_t off_tc, size_t off_h,
           size_t off_sid, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ws = reinterpret_cast<bf16*>(smem);
  bf16* as = reinterpret_cast<bf16*>(smem + off_a);
  bf16* tcs = reinterpret_cast<bf16*>(smem + off_tc);
  float* hs = reinterpret_cast<float*>(smem + off_h);
  int* sid = reinterpret_cast<int*>(smem + off_sid);

  const int spt = BM / C, rows = spt * C;
  const int live = count ? min(*count, s) : s;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * spt;
  if (p0 >= live) return;  // every site of the tile is dead: out stays 0
  const int o0 = blockIdx.y * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // a 32-row × 64-column patch of the tile
  if (tid < spt) {
    const int64_t p = p0 + tid;
    sid[tid] = p < live ? (ids ? ids[p] : static_cast<int>(p)) : -1;
  }

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int nf = (F + FC - 1) / FC, ni = (I + IC - 1) / IC;
  const int64_t ci = static_cast<int64_t>(C) * I;
  for (int q = 0; q < ni * nf; ++q) {
    const int i0 = (q / nf) * IC, f0 = (q % nf) * FC;
    __syncthreads();  // the last chunk's tiles are read; sid is written
    if (f0 == 0) {  // tc [rows, K, 16 i] of the i-chunk
      for (int u = tid; u < rows * K * 2; u += THREADS) {
        const int half = u & 1, rk = u >> 1, r = rk / K, k = rk % K;
        const int site = sid[r / C], c = r % C, i = i0 + half * 8;
        const uint4 v = site >= 0 ? load8(tc + (static_cast<int64_t>(site) * K + k) * ci + c * I + i, I - i, vec) : make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(tcs + rk * IC + half * 8) = v;
      }
    }
    for (int u = tid; u < spt * K * FC; u += THREADS) {  // h [sites, K, 4 f]
      const int fl = u % FC, sk = u / FC, sl = sk / K, k = sk % K;
      const int site = sid[sl], f = f0 + fl;
      hs[u] = site >= 0 && f < F ? f32(h[(static_cast<int64_t>(site) * K + k) * F + f]) : 0.f;
    }
    for (int u = tid; u < FC * BN * 2; u += THREADS) {  // W [4 f, 256 o, 16 i]
      const int half = u & 1, fo = u >> 1, fl = fo / BN, o = fo % BN;
      const int f = f0 + fl, i = i0 + half * 8;
      const uint4 v = f < F && o0 + o < O ? load8(w + (static_cast<int64_t>(f) * O + o0 + o) * I + i, I - i, vec) : make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(ws + fo * WS + half * 8) = v;
    }
    __syncthreads();
    // the M tile [64 rows, (4 f) × (16 i)], each element k in order, rounded
    for (int e = tid; e < BM * KC; e += THREADS) {
      const int r = e / KC, col = e % KC, fl = col / IC, il = col % IC;
      float m = 0.f;
      if (r < rows && sid[r / C] >= 0) {
        const float* hp = hs + (r / C) * K * FC + fl;
        const bf16* tp = tcs + r * K * IC + il;
        for (int k = 0; k < K; ++k) m = fmaf(hp[k * FC], f32(tp[k * IC]), m);
      }
      as[r * AS + col] = __float2bfloat16_rn(m);
    }
    __syncthreads();
    float part[2][8][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.f;
#pragma unroll
    for (int fl = 0; fl < FC; ++fl) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) load_a(a[mt], as, AS, wm * 32 + mt * 16, fl * IC, lane);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t b[2];
        load_b(b, ws + fl * BN * WS, WS, wn * 64 + nt * 8, 0, lane);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma(part[mt][nt], a[mt], b);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm * 32 + mt * 16 + (lane >> 2) + half * 8;
      if (r >= rows) continue;
      const int site = sid[r / C];
      if (site < 0) continue;
      bf16* dst = out + (static_cast<int64_t>(site) * C + r % C) * O;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int o = o0 + wn * 64 + nt * 8 + (lane & 3) * 2;
        const float x = acc[mt][nt][half * 2], y = acc[mt][nt][half * 2 + 1];
        if (o + 1 < O && O % 2 == 0) {
          *reinterpret_cast<__nv_bfloat162*>(dst + o) = __floats2bfloat162_rn(x, y);
        } else {
          if (o < O) dst[o] = __float2bfloat16_rn(x);
          if (o + 1 < O) dst[o + 1] = __float2bfloat16_rn(y);
        }
      }
    }
}

}  // namespace j

// --------------------------------------------------- kernel K: dM, dh, dtc

namespace kd {

constexpr int IC = 8;         // i of a chunk
constexpr int FC = 8;         // f of a chunk
constexpr int NB = IC * FC;   // columns of a dM tile: f outer, i inner (8 warps × n8)

__host__ __device__ inline int o_pad(int o) { return (o + 15) / 16 * 16; }
__host__ __device__ inline int o_stride(int o) { return o_pad(o) + 8; }  // bf16: an odd 4 words
__host__ __device__ inline int rows_pad(int ts, int c) { return (ts * c + 15) / 16 * 16; }
constexpr int DS = NB + 4;    // row stride of the dM tile (f32)

struct Layout {  // byte offsets of the shared-memory regions for a tile of ts sites
  size_t dout, w, dm, h, tc, dtc, dh, sid, total;
  Layout(int ts, int k, int c, int f, int o) {
    const int rp = rows_pad(ts, c);
    dout = 0;
    w = dout + up16(static_cast<size_t>(rp) * o_stride(o) * sizeof(bf16));
    dm = w + up16(static_cast<size_t>(NB) * o_stride(o) * sizeof(bf16));
    h = dm + up16(static_cast<size_t>(rp) * DS * sizeof(float));
    tc = h + up16(static_cast<size_t>(ts) * k * FC * sizeof(float));
    dtc = tc + up16(static_cast<size_t>(ts) * c * k * IC * sizeof(float));
    dh = dtc + up16(static_cast<size_t>(ts) * c * k * IC * sizeof(float));
    sid = dh + up16(static_cast<size_t>(ts) * k * f * sizeof(float));
    total = sid + up16(2 * ts * sizeof(int));
  }
};

// The largest tile whose buffers fit a block: at most 16 rows (one site
// where C > 16), 0 if none fits.
int tile_sites(int k, int c, int f, int o) {
  for (int ts = c > 16 ? 1 : 16 / c; ts >= 1; --ts)
    if (Layout(ts, k, c, f, o).total <= MAX_SMEM) return ts;
  return 0;
}

__global__ void __launch_bounds__(THREADS, 1)
dm_kernel(const bf16* __restrict__ h, const bf16* __restrict__ tc, const bf16* __restrict__ w,
          const bf16* __restrict__ dout, const int* __restrict__ ids,
          const int* __restrict__ count, bf16* __restrict__ dh, bf16* __restrict__ dtc, int s,
          int K, int C, int I, int F, int O, int ts, Layout lay, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* douts = reinterpret_cast<bf16*>(smem + lay.dout);
  bf16* wt = reinterpret_cast<bf16*>(smem + lay.w);
  float* dms = reinterpret_cast<float*>(smem + lay.dm);
  float* hs = reinterpret_cast<float*>(smem + lay.h);
  float* tcs = reinterpret_cast<float*>(smem + lay.tc);
  float* dtcs = reinterpret_cast<float*>(smem + lay.dtc);
  float* dhs = reinterpret_cast<float*>(smem + lay.dh);
  int* sid = reinterpret_cast<int*>(smem + lay.sid);  // the tile's site ids (-1: none)
  int* live_of = sid + ts;                            // 1 where the site is live

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int live = count ? min(*count, s) : s;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * ts;
  const int64_t ci = static_cast<int64_t>(C) * I;
  const int rows = ts * C, rp = rows_pad(ts, C), mts = rp / 16, os = o_stride(O);
  const bf16 zero = __float2bfloat16_rn(0.f);

  if (p0 >= live) {  // dead sites only: dh and dtc are +0
    for (int sl = 0; sl < ts; ++sl) {
      const int64_t p = p0 + sl;
      if (p >= s) break;
      const int64_t site = ids ? ids[p] : p;
      for (int64_t e = tid; e < static_cast<int64_t>(K) * F; e += THREADS)
        dh[site * K * F + e] = zero;
      for (int64_t e = tid; e < K * ci; e += THREADS) dtc[site * K * ci + e] = zero;
    }
    return;
  }
  if (tid < ts) {
    const int64_t p = p0 + tid;
    sid[tid] = p < s ? (ids ? ids[p] : static_cast<int>(p)) : -1;
    live_of[tid] = p < live;
  }
  for (int e = tid; e < ts * K * F; e += THREADS) dhs[e] = 0.f;
  for (int e = tid; e < rows * K * IC; e += THREADS) dtcs[e] = 0.f;
  __syncthreads();
  // the tile's dout rows [rp, O] (0 past its live rows and past O)
  for (int u = tid; u < rp * (o_pad(O) / 8); u += THREADS) {
    const int r = u / (o_pad(O) / 8), o = (u % (o_pad(O) / 8)) * 8;
    const int sl = r / C;
    const uint4 v = r < rows && sid[sl] >= 0 && live_of[sl]
        ? load8(dout + (static_cast<int64_t>(sid[sl]) * C + r % C) * O + o, O - o,
                vec && O % 8 == 0)
        : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int e = 0; e < 8; ++e) douts[r * os + o + e] = at(v, e);
  }

  const int nf = (F + FC - 1) / FC, ni = (I + IC - 1) / IC;
  for (int q = 0; q < ni * nf; ++q) {
    const int i0 = (q / nf) * IC, f0 = (q % nf) * FC;
    __syncthreads();  // the last chunk's tiles are read
    if (f0 == 0) {  // tc [rows, K, 8 i] of the i-chunk (0 at dead sites)
      for (int u = tid; u < rows * K; u += THREADS) {
        const int r = u / K, k = u % K, sl = r / C, site = sid[sl];
        const uint4 v = site >= 0 && live_of[sl] ? load8(tc + (static_cast<int64_t>(site) * K + k) * ci + (r % C) * I + i0, I - i0,
                vec) : make_uint4(0, 0, 0, 0);
#pragma unroll
        for (int e = 0; e < IC; ++e) tcs[u * IC + e] = f32(at(v, e));
      }
    }
    for (int u = tid; u < ts * K; u += THREADS) {  // h [sites, K, 8 f] (0 at dead sites)
      const int sl = u / K, k = u % K, site = sid[sl];
      const uint4 v = site >= 0 && live_of[sl] ? load8(h + (static_cast<int64_t>(site) * K + k) * F + f0, F - f0, vec && F % 8 == 0) : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int e = 0; e < FC; ++e) hs[u * FC + e] = f32(at(v, e));
    }
    // W [8 f, all O, 8 i] re-laid column by column: wt[(fl·8 + il), o]
    for (int u = tid; u < FC * o_pad(O); u += THREADS) {
      const int fl = u / o_pad(O), o = u % o_pad(O), f = f0 + fl;
      const uint4 v = f < F && o < O ? load8(w + (static_cast<int64_t>(f) * O + o) * I + i0, I - i0, vec) : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int e = 0; e < IC; ++e) wt[(fl * IC + e) * os + o] = at(v, e);
    }
    __syncthreads();
    // dM [rp, 64 columns] = dout · Wᵀ over all of O; warp w the columns 8w..8w+7
    for (int mt = 0; mt < mts; ++mt) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k0 = 0; k0 < o_pad(O); k0 += 16) {
        uint32_t a[4], b[2];
        load_a(a, douts, os, mt * 16, k0, lane);
        load_b(b, wt, os, warp * 8, k0, lane);
        mma(d, a, b);
      }
      const int r = mt * 16 + (lane >> 2), col = warp * 8 + (lane & 3) * 2;
      dms[r * DS + col] = __bfloat162float(__float2bfloat16_rn(d[0]));
      dms[r * DS + col + 1] = __bfloat162float(__float2bfloat16_rn(d[1]));
      dms[(r + 8) * DS + col] = __bfloat162float(__float2bfloat16_rn(d[2]));
      dms[(r + 8) * DS + col + 1] = __bfloat162float(__float2bfloat16_rn(d[3]));
    }
    __syncthreads();
    // dtc[r, k, il] += Σ_fl h[s, k, f0 + fl] · dM[r, (fl, il)]
    for (int u = tid; u < rows * K * IC; u += THREADS) {
      const int il = u % IC, rk = u / IC, r = rk / K, k = rk % K;
      const float* hp = hs + ((r / C) * K + k) * FC;
      const float* dp = dms + r * DS + il;
      float acc = dtcs[u];
      for (int fl = 0; fl < FC && f0 + fl < F; ++fl) acc = fmaf(hp[fl], dp[fl * IC], acc);
      dtcs[u] = acc;
    }
    // dh[sl, k, f0 + fl] += Σ_{c, il} tc[(sl, c), k, il] · dM[(sl, c), (fl, il)]
    for (int u = tid; u < ts * K * FC; u += THREADS) {
      const int fl = u % FC, sk = u / FC, sl = sk / K, k = sk % K;
      if (f0 + fl >= F) continue;
      float acc = dhs[sk * F + f0 + fl];
      for (int c = 0; c < C; ++c) {
        const float* tp = tcs + ((sl * C + c) * K + k) * IC;
        const float* dp = dms + (sl * C + c) * DS + fl * IC;
        for (int il = 0; il < IC; ++il) acc = fmaf(tp[il], dp[il], acc);
      }
      dhs[sk * F + f0 + fl] = acc;
    }
    if (f0 + FC >= F) {  // the i-chunk's dtc is whole: write it, start the next from 0
      __syncthreads();
      for (int u = tid; u < rows * K * IC; u += THREADS) {
        const int il = u % IC, rk = u / IC, r = rk / K, k = rk % K, site = sid[r / C];
        if (site >= 0 && i0 + il < I)
          dtc[(static_cast<int64_t>(site) * K + k) * ci + (r % C) * I + i0 + il] =
              __float2bfloat16_rn(dtcs[u]);
        dtcs[u] = 0.f;
      }
    }
  }
  __syncthreads();
  for (int u = tid; u < ts * K * F; u += THREADS) {
    const int sl = u / (K * F), site = sid[sl];
    if (site >= 0) dh[static_cast<int64_t>(site) * K * F + u % (K * F)] = __float2bfloat16_rn(dhs[u]);
  }
}

}  // namespace kd

// ------------------------------------------------------------ kernel K: dW

namespace kw {

constexpr int IP = 8;          // i of a block's pairs
constexpr int FP = 8;          // f of a block's pairs
constexpr int PB = IP * FP;    // (i, f) pairs of a block: pair = fp·8 + ip
constexpr int BN = 256;        // columns of O of a block
constexpr int RC = 32;         // rows of a chunk: two k16 steps
constexpr int MS = RC + 8;     // stride of the Mᵀ and doutᵀ tiles (bf16): 20 words

struct Layout {
  size_t mt, dt, h, tc, row, total;
  explicit Layout(int k) {
    mt = 0;
    dt = mt + up16(static_cast<size_t>(PB) * MS * sizeof(bf16));
    h = dt + up16(static_cast<size_t>(BN) * MS * sizeof(bf16));
    tc = h + up16(static_cast<size_t>(RC) * k * FP * sizeof(float));
    row = tc + up16(static_cast<size_t>(RC) * k * IP * sizeof(float));
    total = row + up16(2 * RC * sizeof(int));
  }
};

__global__ void __launch_bounds__(THREADS, 1)
dw_kernel(const bf16* __restrict__ h, const bf16* __restrict__ tc,
          const bf16* __restrict__ dout, const int* __restrict__ ids,
          const int* __restrict__ count, bf16* __restrict__ dw, int s, int K, int C, int I,
          int F, int O, Layout lay, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* mts = reinterpret_cast<bf16*>(smem + lay.mt);
  bf16* dts = reinterpret_cast<bf16*>(smem + lay.dt);
  float* hs = reinterpret_cast<float*>(smem + lay.h);
  float* tcs = reinterpret_cast<float*>(smem + lay.tc);
  int* rsite = reinterpret_cast<int*>(smem + lay.row);
  int* rc = rsite + RC;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 32 pairs × 64 columns of O a warp
  const int ni = (I + IP - 1) / IP;
  const int i0 = (blockIdx.x % ni) * IP, f0 = (blockIdx.x / ni) * FP, o0 = blockIdx.y * BN;
  const int live = count ? min(*count, s) : s;
  const int64_t nrows = static_cast<int64_t>(live) * C, ci = static_cast<int64_t>(C) * I;

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int64_t r0 = 0; r0 < nrows; r0 += RC) {
    __syncthreads();  // the last chunk's tiles are read
    if (tid < RC) {
      const int64_t r = r0 + tid;
      const int64_t p = r / C;
      rsite[tid] = r < nrows ? (ids ? ids[p] : static_cast<int>(p)) : -1;
      rc[tid] = static_cast<int>(r % C);
    }
    __syncthreads();
    for (int u = tid; u < RC * K; u += THREADS) {  // h [rows, K, 8 f], tc [rows, K, 8 i]
      const int rl = u / K, k = u % K, site = rsite[rl];
      uint4 v = make_uint4(0, 0, 0, 0), t = v;
      if (site >= 0) {
        const int64_t sk = static_cast<int64_t>(site) * K + k;
        v = load8(h + sk * F + f0, F - f0, vec && F % 8 == 0);
        t = load8(tc + sk * ci + rc[rl] * I + i0, I - i0, vec);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        hs[u * FP + e] = f32(at(v, e));
        tcs[u * IP + e] = f32(at(t, e));
      }
    }
    for (int u = tid; u < RC * (BN / 8); u += THREADS) {  // doutᵀ [256 o, rows]
      const int rl = u / (BN / 8), o = (u % (BN / 8)) * 8, site = rsite[rl];
      const uint4 v = site >= 0 && o0 + o < O ? load8(dout + (static_cast<int64_t>(site) * C + rc[rl]) * O + o0 + o, O - o0 - o,
              vec && O % 8 == 0) : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int e = 0; e < 8; ++e) dts[(o + e) * MS + rl] = at(v, e);
    }
    __syncthreads();
    // Mᵀ [64 pairs, 32 rows], each element k in order, rounded
    for (int e = tid; e < PB * RC; e += THREADS) {
      const int rl = e / PB, pair = e % PB, fp = pair / IP, ip = pair % IP;
      const float* hp = hs + rl * K * FP + fp;
      const float* tp = tcs + rl * K * IP + ip;
      float m = 0.f;
      for (int k = 0; k < K; ++k) m = fmaf(hp[k * FP], tp[k * IP], m);
      mts[pair * MS + rl] = __float2bfloat16_rn(m);
    }
    __syncthreads();
    float part[2][8][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < RC; k0 += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) load_a(a[mt], mts, MS, wm * 32 + mt * 16, k0, lane);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t b[2];
        load_b(b, dts, MS, wn * 64 + nt * 8, k0, lane);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma(part[mt][nt], a[mt], b);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int pair = wm * 32 + mt * 16 + (lane >> 2) + half * 8;
      const int f = f0 + pair / IP, i = i0 + pair % IP;
      if (f >= F || i >= I) continue;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int o = o0 + wn * 64 + nt * 8 + (lane & 3) * 2;
        if (o < O)
          dw[(static_cast<int64_t>(f) * O + o) * I + i] = __float2bfloat16_rn(acc[mt][nt][half * 2]);
        if (o + 1 < O)
          dw[(static_cast<int64_t>(f) * O + o + 1) * I + i] =
              __float2bfloat16_rn(acc[mt][nt][half * 2 + 1]);
      }
    }
}

}  // namespace kw

bool bad_dims(int s, int k, int c, int i, int f, int o) {
  return s < 0 || k < 0 || k > MAX_K || c < 1 || c > MAX_C || i < 1 || f < 1 || o < 1;
}

}  // namespace

// Writes out [S, C, O] at the live sites (all, without ids); the caller
// zeroes the others' rows.
extern "C" int pooled_conv_fwd_bf16(const bf16* h, const bf16* tc, const bf16* w, const int* ids,
                                    const int* count, bf16* out, int s, int k, int c, int i,
                                    int f, int o, cudaStream_t stream) {
  if (bad_dims(s, k, c, i, f, o)) return cudaErrorInvalidValue;
  if (s == 0) return cudaSuccess;
  const j::Layout lay(k, c);
  if (lay.total > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(reinterpret_cast<const void*>(j::fwd_kernel), lay.total);
  if (err != cudaSuccess) return err;
  const int spt = j::BM / c;
  const dim3 grid((s + spt - 1) / spt, (o + j::BN - 1) / j::BN);
  const bool vec = i % 8 == 0 && aligned16(tc) && aligned16(w);
  j::fwd_kernel<<<grid, THREADS, lay.total, stream>>>(h, tc, w, ids, count, out, s, k, c, i, f,
                                                      o, lay.a, lay.tc, lay.h, lay.sid, vec);
  return cudaGetLastError();
}

// Writes dh [S, K, F], dtc [S, K, C·I] (+0 at the dead sites) and dW
// [F, O, I] for the gradient dout [S, C, O] of J's output.
extern "C" int pooled_conv_bwd_bf16(const bf16* h, const bf16* tc, const bf16* w,
                                    const bf16* dout, const int* ids, const int* count, bf16* dh,
                                    bf16* dtc, bf16* dw, int s, int k, int c, int i, int f, int o,
                                    cudaStream_t stream) {
  if (bad_dims(s, k, c, i, f, o)) return cudaErrorInvalidValue;
  const int ts = kd::tile_sites(k, c, f, o);
  if (ts == 0) return cudaErrorInvalidValue;
  const kw::Layout wl(k);
  if (wl.total > MAX_SMEM) return cudaErrorInvalidValue;
  const bool vec = aligned16(h) && aligned16(tc) && aligned16(w) && aligned16(dout) &&
                   i % 8 == 0;
  cudaError_t err;
  if (s > 0) {
    const kd::Layout dl(ts, k, c, f, o);
    err = set_smem(reinterpret_cast<const void*>(kd::dm_kernel), dl.total);
    if (err != cudaSuccess) return err;
    kd::dm_kernel<<<(s + ts - 1) / ts, THREADS, dl.total, stream>>>(
        h, tc, w, dout, ids, count, dh, dtc, s, k, c, i, f, o, ts, dl, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  err = set_smem(reinterpret_cast<const void*>(kw::dw_kernel), wl.total);
  if (err != cudaSuccess) return err;
  const dim3 grid(((i + kw::IP - 1) / kw::IP) * ((f + kw::FP - 1) / kw::FP),
                  (o + kw::BN - 1) / kw::BN);
  kw::dw_kernel<<<grid, THREADS, wl.total, stream>>>(h, tc, dout, ids, count, dw, s, k, c, i, f,
                                                     o, wl, vec);
  return cudaGetLastError();
}
