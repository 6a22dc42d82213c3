// The backward of the fused pooled ConvSE3 unit of the SE(3)-Transformer:
// kernel K (its forward, kernel J, is `pooled_conv_fwd.cu`).
//
//   M[s,c,i,f] = Σ_k h[s,k,f] · tc[s,k,c,i]                    (k = the neighbours)
//   J out[s,c,o] = Σ_{i,f} W[f,o,i] · M[s,c,i,f]
//   K dh[s,k,f]    = Σ_{c,i} tc[s,k,c,i] · dM[s,c,i,f]
//     dtc[s,k,c,i] = Σ_f h[s,k,f] · dM[s,c,i,f]
//     dW[f,o,i]    = Σ_{s,c} M[s,c,i,f] · dout[s,c,o]          with dM = dout · Wᵀ
//
// Shapes (s = the G·A sites, r = (s, c) the S·C rows): h [S, K, F];
// tc [S, K, C·I] (c outer, i inner); W [F, O, I] and dW as JAX lays them
// out (i contiguous); dout [S, C, O]. All f32.
// Replaces equihgnn_tpu/ops/pallas/pooled_conv.py `_pc_bwd` (body
// `_bwd_kernel`). Unlike it, the products here are f32 on the CUDA cores
// (no TF32, no tensor cores yet).
//
// Bound on the H100: operations. At the batch-768 shapes (S = 24,608, K =
// 16, F = 128, I = O = 256) the backward's products are 2 × 0.41 TFLOP a C
// over all sites, against 0.2-0.6 GB of operands; the padding sites (no
// neighbour within the radius) need none of it, and chip_smoke.py counts
// only the live ones. What must not happen is what the plain version does:
// write M and dM, 3.2 GB a C each, to device memory and read them back.
//
// Design. Every kernel builds the M (or dM) values it needs in shared
// memory, from staged h and tc chunks (a K-term dot product per value),
// and never writes them to device memory. A row tile holds the C rows of
// up to 64 / C whole sites, so that a site never straddles two tiles.
// W is read in i-chunks of IB (32 contiguous bytes) in every kernel.
// Three kernels, no atomics, each output element owned by one thread and
// summed in a fixed order, so two runs give the same bits:
//  - dtc: one block per (row tile, i-chunk); for each f-chunk it computes
//    the [rows, IB·FB] dM tile (a product over O) in shared memory and
//    adds Σ_f h·dM into dtc's accumulator, written at the end;
//  - dh: one block per (row tile, f-chunk), the same over i-chunks, adding
//    Σ_{c,i} tc·dM; dh sums over c, which the site-aligned tile holds;
//  - dW: one block per 64 (i, f) pairs and 256 columns of O; it walks all
//    S·C rows, 16 at a time, rebuilds M[rows, its (i, f) pairs] and
//    accumulates Mᵀ · dout in registers.
// dM is computed twice (by dtc and by dh): 1.5x the backward's least work,
// for no device-memory copy of dM and no cross-block reduction. The
// operands streamed from device memory (dout and W in the dM tiles; the h,
// tc and dout rows of dW) are copied with cp.async into a second buffer
// while the current one is used, and each warp owns a 32 × 64 (dW) or
// 16 × 32 (dM) patch of its block's tile, so that a step reads few
// distinct shared-memory words. At the batch-768 shapes K still runs at
// ~6 % of the f32 peak, counted over the work the function needs
// (PERF.md): it also does the padding sites' work, and its products
// between barriers are short (8 columns of the contraction).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;   // rows of a row tile, at most
constexpr int BN = 256;  // columns of O of a dW block
constexpr int FB = 8;    // f of a chunk
constexpr int IB = 8;    // i of a chunk
constexpr int PB = IB * FB;  // (i, f) pairs of a dM tile or a dW block
constexpr int OC = 16;   // o of a sub-chunk of the dM product (two buffers)
constexpr int RC = 16;   // rows of a dW step
constexpr int THREADS = 256;
constexpr int DS = BM + 4;  // row stride of the transposed dout / W sub-chunks (float4 aligned)
constexpr int MS = PB + 1;  // row stride of the dM tile

struct Dims {
  int s, k, c, i, f, o;  // sites, neighbours, C, I, F, O
};

__host__ __device__ inline int tile_sites(int c) { return BM / c; }

inline int imax(int a, int b) { return a > b ? a : b; }

__host__ __device__ inline int64_t tc_at(const Dims& d, int s, int k, int c, int i) {
  return (static_cast<int64_t>(s) * d.k + k) * d.c * d.i + static_cast<int64_t>(c) * d.i + i;
}

// Eight consecutive floats of shared memory (16-byte aligned) into v.
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}


// cp.async of one float into shared memory, zero-filled when !valid (then
// src is any readable address and no byte is read). Off the card (a host
// compiler emulating the kernels), a plain copy.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
#if defined(__CUDA_ARCH__)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
#else
  *dst = valid ? *src : 0.f;
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

// Waits for this thread's copies; a __syncthreads after it shows them to all.
__device__ __forceinline__ void cp_async_wait_all() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#endif
}

// The thread tile of a 64 × 256 block tile (dW): warp w of 8 owns rows
// (w / 4)·32 … +31 and columns (w % 4)·64 … +63; its lane (lr, lc) of 4 × 8
// owns rows +lr·8 … +7 and columns +lc·4 … +3 and +32 + lc·4 … +3. A warp
// then reads 4 distinct A and 8 distinct B float4s a step, not 32.
struct Tile8 {
  int row, col;
  __device__ Tile8() {
    const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
    row = (w / 4) * 32 + (lane / 8) * 8;
    col = (w % 4) * 64 + (lane % 8) * 4;
  }
  __device__ int col_of(int j) const { return col + (j < 4 ? j : 28 + j); }
};

// acc += A[arow: the tile's 64 rows] ⊗ B[brow: its 256 columns] for one k.
__device__ __forceinline__ void fma8x8(const float* arow, const float* brow, const Tile8& t,
                                       float (&acc)[8][8]) {
  float a[8], b[8];
  load8(arow + t.row, a);
  const float4 b0 = *reinterpret_cast<const float4*>(brow + t.col);
  const float4 b1 = *reinterpret_cast<const float4*>(brow + t.col + 32);
  b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
  b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] += a[r] * b[j];
}

// ----------------------------------------------------- kernel K: dtc, dh

// dout[rows, oc0 …] and W[(i0, f0) pairs, oc0 …] into ds, ws [OC][DS] (the
// pair ii·FB + ff), transposed, asynchronously.
__device__ void dm_load(const float* __restrict__ dout, const float* __restrict__ w,
                        const Dims& d, int64_t row0, int rows, int i0, int f0, int oc0,
                        float* ds, float* ws) {
  const int64_t nrows = static_cast<int64_t>(d.s) * d.c;
  for (int e = threadIdx.x; e < OC * BM; e += THREADS) {
    const int oc = e % OC, row = e / OC, o = oc0 + oc;
    const bool ok = row < rows && row0 + row < nrows && o < d.o;
    cp_async4(ds + oc * DS + row, ok ? dout + (row0 + row) * d.o + o : dout, ok);
  }
  for (int e = threadIdx.x; e < OC * PB; e += THREADS) {  // consecutive threads: consecutive i
    const int ii = e % IB, ff = (e / IB) % FB, oc = e / PB;
    const int i = i0 + ii, f = f0 + ff, o = oc0 + oc;
    const bool ok = i < d.i && f < d.f && o < d.o;
    cp_async4(ws + oc * DS + ii * FB + ff,
              ok ? w + (static_cast<int64_t>(f) * d.o + o) * d.i + i : w, ok);
  }
  cp_async_commit();
}

// The dM tile of (the block's rows) × (i0 + ii, f0 + ff), ii < IB, ff < FB:
// dM[row, ii·FB + ff] = Σ_o dout[row, o] · W[f0 + ff, o, i0 + ii], into ms
// [BM][MS], through OC-wide sub-chunks of o staged transposed in two
// buffers of ds / ws (the next one copied while this one is used). Warp w of
// 8 owns rows (w / 2)·16 … +15 and pairs (w % 2)·32 … +31; its lane (lr, lc)
// of 4 × 8 the 4 × 4 rows +lr·4 and pairs +lc·4. All threads call it, after
// a barrier that follows every read of ds, ws and ms.
__device__ void dm_tile(const float* __restrict__ dout, const float* __restrict__ w,
                        const Dims& d, int s0, int rows, int i0, int f0, float* ds, float* ws,
                        float* ms) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = (warp / 2) * 16 + (lane / 8) * 4, p0 = (warp % 2) * 32 + (lane % 8) * 4;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
  const int64_t row0 = static_cast<int64_t>(s0) * d.c;
  const int n_sub = (d.o + OC - 1) / OC;
  if (n_sub > 0) dm_load(dout, w, d, row0, rows, i0, f0, 0, ds, ws);
  for (int q = 0; q < n_sub; ++q) {
    cp_async_wait_all();
    __syncthreads();  // sub-chunk q arrived; everyone is done with q − 1
    if (q + 1 < n_sub) {
      const int nb = ((q + 1) & 1) * OC * DS;
      dm_load(dout, w, d, row0, rows, i0, f0, (q + 1) * OC, ds + nb, ws + nb);
    }
    const float* dq = ds + (q & 1) * OC * DS;
    const float* wq = ws + (q & 1) * OC * DS;
#pragma unroll 8
    for (int oc = 0; oc < OC; ++oc) {
      const float4 a = *reinterpret_cast<const float4*>(dq + oc * DS + r0);
      const float4 b = *reinterpret_cast<const float4*>(wq + oc * DS + p0);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] += av[r] * bv[j];
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) ms[(r0 + r) * MS + p0 + j] = acc[r][j];
}

size_t bwd_tile_smem(int k, int c) {
  const int bs = tile_sites(c), rows = bs * c;
  const size_t stage = static_cast<size_t>(imax(bs * (k * FB + 1), rows * (k * IB + 1)));
  const size_t acc = static_cast<size_t>(imax(bs * k * FB, rows * k * IB));
  return sizeof(float) * (4 * OC * DS + BM * MS + stage + acc);
}

// DTC = true: dtc for one i-chunk (blockIdx.y); false: dh for one f-chunk.
template <bool DTC>
__global__ void __launch_bounds__(THREADS, 2)
pooled_conv_dtile_kernel(const float* __restrict__ h, const float* __restrict__ tc,
                         const float* __restrict__ w, const float* __restrict__ dout,
                         float* __restrict__ grad, Dims d) {
  extern __shared__ __align__(16) float smem[];
  const int bs = tile_sites(d.c), rows = bs * d.c;
  const int s0 = blockIdx.x * bs;
  float* ds = smem;              // 2 × [OC][DS]
  float* ws = ds + 2 * OC * DS;  // 2 × [OC][DS]
  float* ms = ws + 2 * OC * DS;  // [BM][MS]
  float* stage = ms + BM * MS;  // DTC: h [bs][k][FB]; dh: tc [rows][k][IB]
  const int st_stride = DTC ? d.k * FB + 1 : d.k * IB + 1;
  float* acc = stage + (DTC ? bs : rows) * st_stride;  // DTC: [rows][k][IB]; dh: [bs][k][FB]
  const int n_acc = DTC ? rows * d.k * IB : bs * d.k * FB;
  const int tid = threadIdx.x;
  for (int e = tid; e < n_acc; e += THREADS) acc[e] = 0.f;
  const int i_fix = blockIdx.y * IB, f_fix = blockIdx.y * FB;
  const int n_chunks = DTC ? (d.f + FB - 1) / FB : (d.i + IB - 1) / IB;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int i0 = DTC ? i_fix : ch * IB, f0 = DTC ? ch * FB : f_fix;
    __syncthreads();  // the last chunk's reads of stage and ms
    if (DTC) {
      for (int e = tid; e < bs * d.k * FB; e += THREADS) {
        const int ff = e % FB, k = (e / FB) % d.k, site = e / (FB * d.k);
        const int s = s0 + site, f = f0 + ff;
        stage[site * st_stride + k * FB + ff] =
            (s < d.s && f < d.f) ? h[(static_cast<int64_t>(s) * d.k + k) * d.f + f] : 0.f;
      }
    } else {
      for (int e = tid; e < rows * d.k * IB; e += THREADS) {
        const int ii = e % IB, k = (e / IB) % d.k, row = e / (IB * d.k);
        const int s = s0 + row / d.c, i = i0 + ii;
        stage[row * st_stride + k * IB + ii] =
            (s < d.s && i < d.i) ? tc[tc_at(d, s, k, row % d.c, i)] : 0.f;
      }
    }
    dm_tile(dout, w, d, s0, rows, i0, f0, ds, ws, ms);
    __syncthreads();
    if (DTC) {  // dtc[row, k, ii] += Σ_ff h[site, k, ff] · dM[row, ii, ff]
      for (int e = tid; e < n_acc; e += THREADS) {
        const int ii = e % IB, k = (e / IB) % d.k, row = e / (IB * d.k);
        const float* hp = stage + (row / d.c) * st_stride + k * FB;
        const float* mp = ms + row * MS + ii * FB;
        float sum = 0.f;
#pragma unroll
        for (int ff = 0; ff < FB; ++ff) sum += hp[ff] * mp[ff];
        acc[e] += sum;
      }
    } else {  // dh[site, k, ff] += Σ_{c, ii} tc[site, k, c, ii] · dM[(site, c), ii, ff]
      for (int e = tid; e < n_acc; e += THREADS) {
        const int ff = e % FB, k = (e / FB) % d.k, site = e / (FB * d.k);
        float sum = 0.f;
        for (int c = 0; c < d.c; ++c) {
          const int row = site * d.c + c;
          const float* tp = stage + row * st_stride + k * IB;
          const float* mp = ms + row * MS + ff;
#pragma unroll
          for (int ii = 0; ii < IB; ++ii) sum += tp[ii] * mp[ii * FB];
        }
        acc[e] += sum;
      }
    }
  }
  __syncthreads();
  if (DTC) {  // dtc [S, K, C·I]
    for (int e = tid; e < n_acc; e += THREADS) {
      const int ii = e % IB, k = (e / IB) % d.k, row = e / (IB * d.k);
      const int s = s0 + row / d.c, i = i_fix + ii;
      if (s < d.s && i < d.i) grad[tc_at(d, s, k, row % d.c, i)] = acc[e];
    }
  } else {  // dh [S, K, F]
    for (int e = tid; e < n_acc; e += THREADS) {
      const int ff = e % FB, k = (e / FB) % d.k, site = e / (FB * d.k);
      const int s = s0 + site, f = f_fix + ff;
      if (s < d.s && f < d.f) grad[(static_cast<int64_t>(s) * d.k + k) * d.f + f] = acc[e];
    }
  }
}

// ----------------------------------------------------------- kernel K: dW

size_t dw_smem(int k) {
  return sizeof(float) * (static_cast<size_t>(RC) * PB + 2 * RC * (k * (FB + IB) + BN));
}

// The h, tc and dout rows r0 … r0+RC that a dW step needs, into one buffer
// (hst [RC][k][FB], tst [RC][k][IB], dst [RC][BN]), asynchronously.
__device__ void dw_load(const float* __restrict__ h, const float* __restrict__ tc,
                        const float* __restrict__ dout, const Dims& d, int64_t r0, int i0,
                        int f0, int o0, float* hst, float* tst, float* dst) {
  const int64_t nrows = static_cast<int64_t>(d.s) * d.c;
  for (int e = threadIdx.x; e < RC * d.k * FB; e += THREADS) {
    const int ff = e % FB, k = (e / FB) % d.k, rr = e / (FB * d.k);
    const int64_t r = r0 + rr;
    const bool ok = r < nrows && f0 + ff < d.f;
    const int s = ok ? static_cast<int>(r / d.c) : 0;
    cp_async4(hst + e, ok ? h + (static_cast<int64_t>(s) * d.k + k) * d.f + f0 + ff : h, ok);
  }
  for (int e = threadIdx.x; e < RC * d.k * IB; e += THREADS) {
    const int ii = e % IB, k = (e / IB) % d.k, rr = e / (IB * d.k);
    const int64_t r = r0 + rr;
    const bool ok = r < nrows && i0 + ii < d.i;
    const int s = ok ? static_cast<int>(r / d.c) : 0, c = ok ? static_cast<int>(r % d.c) : 0;
    cp_async4(tst + e, ok ? tc + tc_at(d, s, k, c, i0 + ii) : tc, ok);
  }
  for (int e = threadIdx.x; e < RC * BN; e += THREADS) {
    const int o = e % BN, rr = e / BN;
    const int64_t r = r0 + rr;
    const bool ok = r < nrows && o0 + o < d.o;
    cp_async4(dst + e, ok ? dout + r * d.o + o0 + o : dout, ok);
  }
  cp_async_commit();
}

// dW[f, o, i] = Σ_r M[r, i, f] · dout[r, o] for one block's PB (i, f)
// pairs (blockIdx.x: i-chunk major, f-chunk minor) and BN columns of o: the
// pairs, (f − f0)·IB + i − i0, are the rows of its 64 × 256 tile, so that a
// thread's 8 rows are 8 consecutive i of dW. It walks all rows RC at a time:
// the next step's h, tc and dout rows are copied while this step rebuilds
// M[rows, pairs] from the staged ones and accumulates Mᵀ · dout.
__global__ void __launch_bounds__(THREADS, 2)
pooled_conv_dw_kernel(const float* __restrict__ h, const float* __restrict__ tc,
                      const float* __restrict__ dout, float* __restrict__ dw, Dims d) {
  extern __shared__ __align__(16) float smem[];
  const int n_fc = (d.f + FB - 1) / FB;
  const int i0 = (blockIdx.x / n_fc) * IB, f0 = (blockIdx.x % n_fc) * FB;
  const int o0 = blockIdx.y * BN;
  const int buf = RC * (d.k * (FB + IB) + BN);  // floats of one staging buffer
  float* as = smem;  // [RC][PB]: M[r0 + rr, pair]
  float* stage = as + RC * PB;  // 2 buffers of hst, tst, dst
  const Tile8 t;
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;
  const int64_t nrows = static_cast<int64_t>(d.s) * d.c;
  const int64_t n_steps = (nrows + RC - 1) / RC;
  auto parts = [&](int64_t step, float*& hst, float*& tst, float*& dst) {
    hst = stage + (step & 1) * buf;
    tst = hst + RC * d.k * FB;
    dst = tst + RC * d.k * IB;
  };
  float *hst, *tst, *dst;
  if (n_steps > 0) {
    parts(0, hst, tst, dst);
    dw_load(h, tc, dout, d, 0, i0, f0, o0, hst, tst, dst);
  }
  for (int64_t step = 0; step < n_steps; ++step) {
    cp_async_wait_all();
    __syncthreads();  // this step's rows arrived; the last step's reads of as and its buffer done
    if (step + 1 < n_steps) {
      float *hn, *tn, *dn;
      parts(step + 1, hn, tn, dn);
      dw_load(h, tc, dout, d, (step + 1) * RC, i0, f0, o0, hn, tn, dn);
    }
    parts(step, hst, tst, dst);
    for (int e = threadIdx.x; e < RC * PB; e += THREADS) {
      const int p = e % PB, rr = e / PB;
      const float* hp = hst + rr * d.k * FB + p / IB;
      const float* tp = tst + rr * d.k * IB + p % IB;
      float m = 0.f;
      for (int k = 0; k < d.k; ++k) m += hp[k * FB] * tp[k * IB];
      as[e] = m;
    }
    __syncthreads();
#pragma unroll 4
    for (int rr = 0; rr < RC; ++rr) fma8x8(as + rr * PB, dst + rr * BN, t, acc);
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int p = t.row + r, i = i0 + p % IB, f = f0 + p / IB;
    if (i >= d.i || f >= d.f) continue;
    float* dcol = dw + static_cast<int64_t>(f) * d.o * d.i + i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int o = o0 + t.col_of(j);
      if (o < d.o) dcol[static_cast<int64_t>(o) * d.i] = acc[r][j];
    }
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

cudaError_t zero(float* p, int64_t n, cudaStream_t stream) {
  return n > 0 ? cudaMemsetAsync(p, 0, n * sizeof(float), stream) : cudaSuccess;
}

bool bad_dims(const Dims& d) {
  return d.s < 0 || d.k < 0 || d.c < 1 || d.c > BM || d.i < 0 || d.f < 0 || d.o < 0;
}

}  // namespace

// Writes dh [S, K, F], dtc [S, K, C·I] and dw [F, O, I] for the output
// gradient dout [S, C, O]: three kernels on `stream`.
extern "C" int pooled_conv_bwd_f32(const float* h, const float* tc, const float* w,
                                   const float* dout, float* dh, float* dtc, float* dw,
                                   int s, int k, int c, int i, int f, int o,
                                   cudaStream_t stream) {
  const Dims d{s, k, c, i, f, o};
  if (bad_dims(d)) return static_cast<int>(cudaErrorInvalidValue);
  const int bs = tile_sites(c);
  cudaError_t err = cudaSuccess;
  if (s > 0 && k > 0) {
    const size_t smem = bwd_tile_smem(k, c);
    if ((err = set_smem(pooled_conv_dtile_kernel<true>, smem)) != cudaSuccess ||
        (err = set_smem(pooled_conv_dtile_kernel<false>, smem)) != cudaSuccess)
      return static_cast<int>(err);
    if (i > 0) {
      pooled_conv_dtile_kernel<true><<<dim3((s + bs - 1) / bs, (i + IB - 1) / IB), THREADS,
                                       smem, stream>>>(h, tc, w, dout, dtc, d);
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    }
    if (f > 0) {
      if (i == 0 || o == 0) {  // dM is 0
        err = zero(dh, static_cast<int64_t>(s) * k * f, stream);
      } else {
        pooled_conv_dtile_kernel<false><<<dim3((s + bs - 1) / bs, (f + FB - 1) / FB), THREADS,
                                          smem, stream>>>(h, tc, w, dout, dh, d);
        err = cudaGetLastError();
      }
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  if (i > 0 && f > 0 && o > 0) {
    const size_t smem = dw_smem(k);
    if ((err = set_smem(pooled_conv_dw_kernel, smem)) != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(((i + IB - 1) / IB) * ((f + FB - 1) / FB), (o + BN - 1) / BN);
    pooled_conv_dw_kernel<<<grid, THREADS, smem, stream>>>(h, tc, dout, dw, d);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}
