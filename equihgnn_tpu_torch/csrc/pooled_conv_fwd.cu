// The forward of the fused pooled ConvSE3 unit of the SE(3)-Transformer:
// kernel J (its backward, kernel K, is `pooled_conv.cu`).
//
//   M[s,c,i,f]   = Σ_k h[s,k,f] · tc[s,k,c,i]                  (k = the neighbours)
//   out[s,c,o]   = live[s] · Σ_{i,f} W[f,o,i] · M[s,c,i,f]
//
// Shapes (s = the G·A sites, r = (s, c) the S·C rows): h [S, K, F];
// tc [S, K, C·I] (c outer, i inner); W [F, O, I] as JAX lays it out (i
// contiguous); out [S, C, O]. All f32.
// Replaces equihgnn_tpu/ops/pallas/pooled_conv.py `_pc_fwd` (body
// `_fwd_kernel`).
//
// Bound on the H100: operations. At the batch-768 shapes (S = 24,608, K =
// 16, F = 128, I = O = 256) the projection is a [S'·C, I·F] × [I·F, O]
// product over the S' = 12,731 live sites (a site with no neighbour within
// the radius has tc = 0 and output 0): 0.21 TFLOP at C = 1. Its operands
// are 0.3-0.6 GB; M, 3.2 GB a C over all sites, never leaves the chip.
//
// Design.
//  - Live sites only. The caller may pass the ids of the live sites (a
//    device list, live ones first) and their count (on the device: the
//    wrapper never waits for it). A row tile holds the C rows of up to
//    64 / C live sites, so that a site never straddles two tiles; the grid
//    is sized for all sites and a block past the count returns at once.
//    Without a list every site is live.
//  - The projection on the tensor cores in 3xTF32. Each operand x is split
//    into big = tf32(x) and small = tf32(x − big) (cvt.rna), and
//    big·big + big·small + small·big is summed in f32, as CUTLASS's
//    OpMultiplyAddFastF32: three TF32 products for each f32 one, at ~f32
//    accuracy (the dropped small·small term is ~2⁻²² of a product). One
//    TF32 product would leave ~2⁻¹¹ of each product, above the gate of
//    1e-4 of max |out| that J is held to. The tensor cores truncate where
//    they align and add, so each chunk of 32 columns is summed from 0 and
//    then added to the running f32 sums on the CUDA cores, rounded to
//    nearest: carried through the 4,096 k8 steps of the model's
//    contraction in one accumulator, the truncations drifted one way, to
//    ~2.5e-4 of max |out| (the card's first call). mma.sync.m16n8k8
//    (row.col), not wgmma: its fragments are plain registers, loaded and
//    split by the threads that multiply them.
//  - The M-build on the CUDA cores in f32, into shared memory only. The
//    contraction runs in chunks of IB = 8 i × FB = 4 f = 32 columns, i-chunk
//    outer: a k8 step of the product is 8 consecutive i of one f, which W
//    holds contiguously.
//  - Warp-specialized. 8 consumer warps multiply; 4 producer warps (one on
//    each SM sub-partition) copy and build: per chunk they wait for its
//    copies, start the next chunk's W [4 f, 256 o, 8 i] and h [sites, K,
//    4 f] (cp.async; tc [rows, K, 8 i] once an i-chunk), build the [64, 32]
//    A tile (M of 2 f × 8 i a thread, k in order), split it into big and
//    small and signal it. Named barriers pass the two A slots back and
//    forth (full, empty); W has three stages, so that the next one is
//    copied while the consumers read the current one. Done in turn by the
//    same warps, the M-build and the copies took about as long as the
//    products (PERF.md §6).
//  - Tiles: 64 rows × 256 columns of O, each consumer warp a 32 × 64 patch
//    (2 × 8 mma tiles; 64 f32 sums and 64 partial sums a thread). All of O
//    in one block: M is built once per row tile, not once per O tile; the
//    ~199 KB of shared memory allow one block an SM. At C = 1 the 199 live
//    tiles take two rounds of 132 SMs (the second half full); tiling O as
//    well would halve the rounds' grain but build every M tile twice.
//  - Shared-memory layouts without bank conflicts: the A tile's rows are
//    36 words apart; W's [o][8 i] rows have their 16-byte halves swapped
//    where bit 2 of o is set, so that a B fragment (8 o × 4 i) hits 32
//    banks; the staged h and tc rows are padded by 4 words.
//  - Each output element is owned by one thread and summed in a fixed
//    order: no atomics, the same bits twice.

#include <cstdint>
#include <cuda_runtime.h>

#include "tf32_mma.cuh"

namespace {

constexpr int BM = 64;         // rows of a row tile, at most
constexpr int BN = 256;       // columns of O of a block
constexpr int IB = 8;         // i of a chunk: one k8 step
constexpr int FB = 4;         // f of a chunk: the k8 steps of a chunk
constexpr int KC = IB * FB;   // contraction columns of a chunk
constexpr int AS = KC + 4;    // row stride of the A tile
constexpr int CONSUMERS = 256;  // 8 warps of products: 2 (rows) × 4 (columns of O)
constexpr int PRODUCERS = 128;  // 4 warps of copies and M-builds, one on each SM sub-partition
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr int WSLOTS = 3;     // W stages in the ring
// named barriers (0 is __syncthreads): A slot b full (+b), A slot b and
// the W stage read with it empty (+b), the producers alone
constexpr int BAR_FULL = 1, BAR_EMPTY = 3, BAR_PROD = 5;

struct Dims {
  int s, k, c, i, f, o;  // sites, neighbours, C, I, F, O
};

__host__ __device__ inline int tile_sites(int c) { return BM / c; }
__host__ __device__ inline int h_stride(int k) { return k * FB + 4; }  // a site's staged h
__host__ __device__ inline int t_stride(int k) { return k * IB + 4; }  // a row's staged tc

// Floats of each shared-memory region: WSLOTS W stages, 2 h stages, one tc
// stage, 2 A tiles of big and small halves.
struct Layout {
  size_t w, h, t, a;
  __host__ __device__ Layout(int k, int c)
      : w(static_cast<size_t>(FB) * BN * IB),
        h(static_cast<size_t>(tile_sites(c)) * h_stride(k)),
        t(static_cast<size_t>(tile_sites(c) * c) * t_stride(k)),
        a(static_cast<size_t>(BM) * AS) {}
  __host__ __device__ size_t floats() const { return WSLOTS * w + 2 * h + t + 4 * a; }
};

size_t fwd_smem(int k, int c) {
  return Layout(k, c).floats() * sizeof(float) + tile_sites(c) * sizeof(int);
}

// Where W[f, o, i0 + ii] lies in a [o][8] row of the W stage: the two
// 16-byte halves swapped where bit 2 of o is set.
__device__ __forceinline__ int w_at(int o, int ii) { return o * IB + (ii ^ (o & 4)); }

// ---------------------------------------------------------- the kernel

struct Bufs {
  float *w, *h, *t, *a;  // W stages, h stages, the tc stage, A tiles (big, small; slot-major)
  int* sid;
};

struct Chunk {  // chunk n: i-chunk n / n_fc outer, f-chunk n % n_fc inner
  int ic, fc;
  __device__ Chunk(int n, int n_fc) : ic(n / n_fc), fc(n % n_fc) {}
};

// W [FB][BN][IB] of chunk n into W stage n % WSLOTS and h [sites][K][FB]
// into h stage n & 1, asynchronously, by the producers (p = their index).
// VEC: 16-byte copies (I and F multiples of 4, operands 16-byte aligned).
template <bool VEC>
__device__ void load_wh(const float* __restrict__ h, const float* __restrict__ w, const Dims& d,
                        int n, int n_fc, int o0, const Bufs& b, int p) {
  const Chunk ch(n, n_fc);
  const int i0 = ch.ic * IB, f0 = ch.fc * FB, hs = h_stride(d.k);
  const Layout lay(d.k, d.c);
  float* wd = b.w + (n % WSLOTS) * lay.w;
  float* hd = b.h + (n & 1) * lay.h;
  constexpr int V = VEC ? 4 : 1;
  for (int e = p; e < FB * BN * IB / V; e += PRODUCERS) {
    const int ii = (e % (IB / V)) * V, o = (e / (IB / V)) % BN, ff = e / (BN * IB / V);
    const int f = f0 + ff, oo = o0 + o, i = i0 + ii;
    const bool ok = f < d.f && oo < d.o && i < d.i;
    cp_async<4 * V>(wd + ff * BN * IB + w_at(o, ii),
                    ok ? w + (static_cast<int64_t>(f) * d.o + oo) * d.i + i : w, ok);
  }
  for (int e = p; e < tile_sites(d.c) * d.k * FB / V; e += PRODUCERS) {
    const int ff = (e % (FB / V)) * V, k = (e / (FB / V)) % d.k, site = e / (d.k * FB / V);
    const int s = b.sid[site], f = f0 + ff;
    const bool ok = s >= 0 && f < d.f;
    cp_async<4 * V>(hd + site * hs + k * FB + ff,
                    ok ? h + (static_cast<int64_t>(s) * d.k + k) * d.f + f : h, ok);
  }
}

// tc [rows][K][IB] of i-chunk ic into the tc stage, asynchronously.
template <bool VEC>
__device__ void load_t(const float* __restrict__ tc, const Dims& d, int ic, const Bufs& b,
                       int p) {
  const int i0 = ic * IB, rows = tile_sites(d.c) * d.c, ts = t_stride(d.k);
  constexpr int V = VEC ? 4 : 1;
  for (int e = p; e < rows * d.k * IB / V; e += PRODUCERS) {
    const int ii = (e % (IB / V)) * V, k = (e / (IB / V)) % d.k, row = e / (d.k * IB / V);
    const int s = b.sid[row / d.c], i = i0 + ii;
    const bool ok = s >= 0 && i < d.i;
    const int64_t at = (static_cast<int64_t>(s) * d.k + k) * d.c * d.i +
                       static_cast<int64_t>(row % d.c) * d.i + i;
    cp_async<4 * V>(b.t + row * ts + k * IB + ii, ok ? tc + at : tc, ok);
  }
}

// M[row, f0 + ff, i0 … i0+7] of chunk n for ff = 2q, 2q + 1, split into big
// and small, into A slot n & 1 (column ff·8 + ii); the producers take the
// (row, q) items in turn.
__device__ void build_a(const Dims& d, int n, const Bufs& b, int p) {
  const int rows = tile_sites(d.c) * d.c;
  const Layout lay(d.k, d.c);
  for (int item = p; item < BM * FB / 2; item += PRODUCERS) {
    const int row = item / 2, q = item % 2;
    float m[2][IB] = {};
    if (row < rows) {
      const float* hp = b.h + (n & 1) * lay.h + (row / d.c) * h_stride(d.k) + 2 * q;
      const float* tp = b.t + row * t_stride(d.k);
      for (int k = 0; k < d.k; ++k) {
        const float2 hv = *reinterpret_cast<const float2*>(hp + k * FB);
        const float4 t0 = *reinterpret_cast<const float4*>(tp + k * IB);
        const float4 t1 = *reinterpret_cast<const float4*>(tp + k * IB + 4);
        const float tv[IB] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
#pragma unroll
        for (int j = 0; j < IB; ++j) {
          m[0][j] = fmaf(hv.x, tv[j], m[0][j]);
          m[1][j] = fmaf(hv.y, tv[j], m[1][j]);
        }
      }
    }
    float* ah = b.a + (n & 1) * 2 * lay.a + row * AS + 2 * q * IB;
    float* al = ah + lay.a;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float hi[IB], lo[IB];
#pragma unroll
      for (int j = 0; j < IB; ++j) {
        hi[j] = as_float(tf32(m[r][j]));
        lo[j] = as_float(tf32(m[r][j] - hi[j]));
      }
      *reinterpret_cast<float4*>(ah + r * IB) = make_float4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<float4*>(ah + r * IB + 4) = make_float4(hi[4], hi[5], hi[6], hi[7]);
      *reinterpret_cast<float4*>(al + r * IB) = make_float4(lo[0], lo[1], lo[2], lo[3]);
      *reinterpret_cast<float4*>(al + r * IB + 4) = make_float4(lo[4], lo[5], lo[6], lo[7]);
    }
  }
}

// acc += A slot n & 1 · W stage n % WSLOTS, in 3xTF32: consumer warp (wm,
// wn) owns rows wm·32 … +31 (2 m16 tiles) and columns wn·64 … +63 (8 n8
// tiles). The chunk's products are summed from 0 in the tensor cores and
// then added to acc on the CUDA cores, rounded to nearest: the tensor
// cores align and truncate their sums, and carried through the 4,096 k8
// steps of the model's contraction in one accumulator, the truncations
// drifted one way, to ~2.5e-4 of max |out|.
__device__ __forceinline__ void mma_chunk(const Dims& d, int n, const Bufs& b,
                                          float (&acc)[2][8][4]) {
  const Layout lay(d.k, d.c);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = (warp / 4) * 32 + g, c0 = (warp % 4) * 64 + g;
  const float* ws = b.w + (n % WSLOTS) * lay.w;
  const float* ahi = b.a + (n & 1) * 2 * lay.a;
  const float* alo = ahi + lay.a;
  float part[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[mt][nt][j] = 0.f;
#pragma unroll
  for (int ks = 0; ks < FB; ++ks) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int r = r0 + mt * 16, col = ks * IB + t;
      const int at[4] = {r * AS + col, (r + 8) * AS + col, r * AS + col + 4,
                         (r + 8) * AS + col + 4};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ah[mt][j] = __float_as_uint(ahi[at[j]]);
        al[mt][j] = __float_as_uint(alo[at[j]]);
      }
    }
    const float* wk = ws + ks * BN * IB;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int o = c0 + nt * 8;
      const float w0 = wk[w_at(o, t)], w1 = wk[w_at(o, t + 4)];
      const uint32_t bh0 = tf32(w0), bh1 = tf32(w1);
      const uint32_t bl0 = tf32(w0 - as_float(bh0)), bl1 = tf32(w1 - as_float(bh1));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_3xtf32(part[mt][nt], ah[mt], al[mt], bh0, bh1, bl0, bl1);
    }
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] += part[mt][nt][j];
}

// One block per (row tile, BN columns of O): 8 consumer warps multiply, 4
// producer warps copy and build. ids: the live sites' ids (live ones
// first) and count their number, both on the device, or null: every site
// live.
//  producers, chunk n: wait for chunk n's copies; wait until the consumers
//    are done with chunk n − 2 (A slot n & 1, W stage (n + 1) % 3); start
//    the copies of chunk n + 1's W and h; build A(n); signal it full; at the
//    end of an i-chunk, copy the next one's tc.
//  consumers, chunk n: wait for A(n); multiply; signal A slot n & 1 empty.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
pooled_conv_fwd_tc_kernel(const float* __restrict__ h, const float* __restrict__ tc,
                          const float* __restrict__ w, const int* __restrict__ ids,
                          const int* __restrict__ count, float* __restrict__ out, Dims d) {
  extern __shared__ __align__(16) float smem[];
  const int bs = tile_sites(d.c), rows = bs * d.c;
  const int n_live = count ? *count : d.s;
  const int p0 = blockIdx.x * bs, o0 = blockIdx.y * BN;
  if (p0 >= n_live) return;  // the whole block: no barrier is skipped
  const Layout lay(d.k, d.c);
  Bufs b;
  b.w = smem;
  b.h = b.w + WSLOTS * lay.w;
  b.t = b.h + 2 * lay.h;
  b.a = b.t + lay.t;
  b.sid = reinterpret_cast<int*>(b.a + 4 * lay.a);
  for (int j = threadIdx.x; j < bs; j += THREADS) {
    const int p = p0 + j;
    b.sid[j] = p < n_live ? (ids ? ids[p] : p) : -1;
  }
  __syncthreads();

  const int n_fc = (d.f + FB - 1) / FB;
  const int n_chunks = d.k > 0 ? ((d.i + IB - 1) / IB) * n_fc : 0;
  if (threadIdx.x >= CONSUMERS) {  // producers
    const int p = threadIdx.x - CONSUMERS;
    if (n_chunks > 0) {
      load_wh<VEC>(h, w, d, 0, n_fc, o0, b, p);
      load_t<VEC>(tc, d, 0, b, p);
      cp_async_commit();
    }
    for (int n = 0; n < n_chunks; ++n) {
      cp_async_wait_all();
      bar_sync(BAR_PROD, PRODUCERS);  // chunk n's operands arrived, from every producer
      if (n >= 2) bar_sync(BAR_EMPTY + (n & 1), THREADS);
      if (n + 1 < n_chunks) {
        load_wh<VEC>(h, w, d, n + 1, n_fc, o0, b, p);
        cp_async_commit();
      }
      build_a(d, n, b, p);
      bar_arrive(BAR_FULL + (n & 1), THREADS);
      if (n + 1 < n_chunks && Chunk(n + 1, n_fc).fc == 0) {
        bar_sync(BAR_PROD, PRODUCERS);  // every build of this i-chunk read the tc stage
        load_t<VEC>(tc, d, Chunk(n + 1, n_fc).ic, b, p);
        cp_async_commit();
      }
    }
    return;
  }

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;
  for (int n = 0; n < n_chunks; ++n) {
    bar_sync(BAR_FULL + (n & 1), THREADS);
    mma_chunk(d, n, b, acc);
    if (n + 2 < n_chunks) bar_arrive(BAR_EMPTY + (n & 1), THREADS);
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = (warp / 4) * 32 + mt * 16 + half * 8 + g;
      const int s = row < rows ? b.sid[row / d.c] : -1;
      if (s < 0) continue;
      float* orow = out + (static_cast<int64_t>(s) * d.c + row % d.c) * d.o;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int o = o0 + (warp % 4) * 64 + nt * 8 + 2 * t;
        if (VEC && o + 1 < d.o) {
          *reinterpret_cast<float2*>(orow + o) =
              make_float2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
        } else {
          if (o < d.o) orow[o] = acc[mt][nt][2 * half];
          if (o + 1 < d.o) orow[o + 1] = acc[mt][nt][2 * half + 1];
        }
      }
    }
}

}  // namespace

// Writes out [S, C, O] = J(h [S, K, F], tc [S, K, C·I], w [F, O, I]) at
// the live sites: ids [S] (the live sites' ids first) and count [1], both
// int32 on the device, or both null (every site live). Rows of sites not
// listed are not written.
extern "C" int pooled_conv_fwd_f32(const float* h, const float* tc, const float* w,
                                   const int* ids, const int* count, float* out, int s, int k,
                                   int c, int i, int f, int o, cudaStream_t stream) {
  const Dims d{s, k, c, i, f, o};
  if (s < 0 || k < 0 || c < 1 || c > BM || i < 0 || f < 0 || o < 0 || (!ids != !count))
    return static_cast<int>(cudaErrorInvalidValue);
  if (s == 0 || o == 0) return 0;  // an empty output
  const bool vec = i % 4 == 0 && f % 4 == 0 && o % 2 == 0 && aligned16(h) && aligned16(tc) &&
                   aligned16(w) && aligned16(out);
  const size_t smem = fwd_smem(k, c);
  const cudaError_t err = vec ? set_smem(pooled_conv_fwd_tc_kernel<true>, smem)
                              : set_smem(pooled_conv_fwd_tc_kernel<false>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bs = tile_sites(c);
  const dim3 grid((s + bs - 1) / bs, (o + BN - 1) / BN);
  if (vec)
    pooled_conv_fwd_tc_kernel<true><<<grid, THREADS, smem, stream>>>(h, tc, w, ids, count, out, d);
  else
    pooled_conv_fwd_tc_kernel<false><<<grid, THREADS, smem, stream>>>(h, tc, w, ids, count, out, d);
  return static_cast<int>(cudaGetLastError());
}
