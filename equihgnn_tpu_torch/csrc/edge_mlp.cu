// Fused EGNN edge messages, forward (kernel B) and backward (kernel C):
//   out[g, a, kk, :] = silu(silu(ui[g, a] + ujn[g, idx[g, a, kk]]
//                                + dist[g, a, kk] * wd + b0) @ W1 + b1)
// with ui, ujn [G, A, F], dist [G, A, K], idx [G, A, K] (slot indices into
// the A axis), wd, b0 [F], W1 [F, M], b1 [M] and out [G, A, K, M], all f32.
//
// Replaces: equihgnn_tpu/ops/pallas/edge_mlp.py `_fwd_impl` / `_fwd_kernel`
// (forward) and `_vjp_bwd` / `_bwd_kernel` (backward). As on the TPU, the
// point is that the [G, A, K, F] pre-activation never reaches device memory:
// at the batch-768 shapes (G = 769, A = 32, K = 16, F = 1026, M = 16) it
// would be 1.62 GB, while the forward reads ui and ujn (101 MB each) and
// writes 25 MB. The TPU kernels select neighbour rows with a one-hot [A, A]
// matmul, a Mosaic workaround; here the neighbour row is read directly.
//
// Bound on the H100: the 16-wide products with W1 (2·E·F·M = 12.9 GFLOP
// per pass at those shapes, E = G·A·K edges) and the E·F sigmoids run on
// the CUDA cores, and each f term needs W1[f, 0..M) from shared memory or
// registers. Device memory traffic is small; the neighbour rows of ujn are
// re-read from L2.
//
// Forward design: one block per molecule row g. The block stages W1
// transposed ([M][F], so that lanes reading consecutive f hit consecutive
// banks), wd and b0 in dynamic shared memory: 18·F·4 bytes, 73.9 KB at
// F = 1026, above the 48 KB static limit, hence
// cudaFuncAttributeMaxDynamicSharedMemorySize. Each warp takes a slot a and
// NE = 4 of its neighbours at a time; its lanes stride over f (the tail of
// F = 1026 is masked by the loop bound), and each lane keeps NE·M partial
// dot products in registers, so one W1 value read from shared memory serves
// NE edges. A butterfly of warp shuffles then sums the partials, and the
// lanes write the NE·M outputs. Every edge is computed, padded neighbours
// included; the caller masks them afterwards. M must be 16 (the EGNN
// message width); any F, A and K are taken.
//
// Backward design (kernel C), for dm = dL/dout. Per edge e and column f:
//   pre = ui + ujn[idx] + dist·wd + b0, a1 = silu(pre), z = a1 @ W1 + b1,
//   dz = dm ⊙ silu'(z), dpre = (dz @ W1ᵀ) ⊙ silu'(pre);
//   dui[a] = Σ_kk dpre, dujn[idx] += dpre (within the row), ddist = dpre·wd,
//   dwd = Σ dpre·dist, db0 = Σ dpre, dW1 = Σ a1ᵀ dz, db1 = Σ dz over all
// E edges. Everything does not fit one block's shared memory at once (W1ᵀ
// 65.7 KB, a dujn row [A][F] 131 KB, dW1 65.7 KB), and z needs all of F
// while the parameter sums need all edges, so it runs as four launches:
//   1. the forward kernel in `kDz` mode recomputes z and writes
//      dz [G, A, K, M] (25 MB) to a workspace instead of the output;
//   2. `edge_mlp_bwd_kernel`: a block takes BW_ROWS molecule rows and
//      BW_COLS columns of F, one column per thread. The thread keeps
//      W1[f, :], and its running sums of dW1[f, :], dwd[f] and db0[f], in
//      registers, and owns column f of a shared dujn [A][BW_COLS]
//      accumulator, so the scatter into dujn needs no atomics. It walks the
//      row's edges slot by slot (dz, idx and dist of the slot's K edges are
//      staged in shared memory and read as broadcasts), recomputing pre in
//      registers. ddist sums over all F: each warp reduces its 32 columns by
//      shuffles, the block adds its warps in order, and the block writes
//      one partial per column chunk. The block's parameter sums go to one
//      workspace row;
//   3. and 4. `column_sum_kernel` adds the parameter partials over the row
//      blocks and the ddist partials over the column chunks, each output
//      column owned by one block, in a fixed order.
// TPU blocks ran in order and carried the parameter sums in a revisited
// output block; Hopper blocks run in no order, hence the workspace and the
// second pass. The result is deterministic (no atomics).

#include <cstdint>
#include <cuda_runtime.h>

#include "column_sum.cuh"

namespace {

constexpr int M_OUT = 16;  // message width m
constexpr int NE = 4;      // neighbours a warp carries at once (forward)
constexpr int WARPS = 8;   // warps per block (forward)
constexpr unsigned FULL = 0xffffffffu;

constexpr int BW_COLS = 128;  // backward: f columns per block, one per thread
constexpr int BW_WARPS = BW_COLS / 32;
constexpr int BW_ROWS = 2;    // backward: molecule rows per block

__device__ __forceinline__ float silu(float x) { return x / (1.f + __expf(-x)); }

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + __expf(-x)); }

__device__ __forceinline__ float dsilu(float x) {
  const float s = sigmoid(x);
  return s * (1.f + x * (1.f - s));
}

// kDz = false: out = silu(z). kDz = true: out = dm ⊙ silu'(z) (backward pass 1).
template <bool kDz>
__global__ void __launch_bounds__(WARPS * 32)
edge_mlp_fwd_kernel(const float* __restrict__ ui, const float* __restrict__ ujn,
                    const float* __restrict__ dist, const int64_t* __restrict__ idx,
                    const float* __restrict__ wd, const float* __restrict__ b0,
                    const float* __restrict__ w1, const float* __restrict__ b1,
                    const float* __restrict__ dm, float* __restrict__ out,
                    int a_slots, int k_nbrs, int f_dim) {
  extern __shared__ float smem[];
  float* w1t = smem;                    // [M_OUT][F]
  float* wd_s = w1t + M_OUT * f_dim;    // [F]
  float* b0_s = wd_s + f_dim;           // [F]

  for (int i = threadIdx.x; i < f_dim * M_OUT; i += blockDim.x) {
    const int f = i / M_OUT, j = i - f * M_OUT;
    w1t[j * f_dim + f] = w1[i];
  }
  for (int f = threadIdx.x; f < f_dim; f += blockDim.x) {
    wd_s[f] = wd[f];
    b0_s[f] = b0[f];
  }
  __syncthreads();

  const int g = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = (k_nbrs + NE - 1) / NE;
  const float* ujn_g = ujn + static_cast<size_t>(g) * a_slots * f_dim;

  for (int item = warp; item < a_slots * groups; item += WARPS) {
    const int a = item / groups;
    const int k0 = (item - a * groups) * NE;
    const size_t row = static_cast<size_t>(g) * a_slots + a;
    const float* ui_r = ui + row * f_dim;

    const float* uj[NE];
    float dd[NE];
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int kk = k0 + e;
      const bool valid = kk < k_nbrs;
      const int64_t j = valid ? idx[row * k_nbrs + kk] : 0;
      uj[e] = ujn_g + static_cast<size_t>(j) * f_dim;
      dd[e] = valid ? dist[row * k_nbrs + kk] : 0.f;
    }

    float acc[NE][M_OUT];
#pragma unroll
    for (int e = 0; e < NE; ++e)
#pragma unroll
      for (int j = 0; j < M_OUT; ++j) acc[e][j] = 0.f;

    for (int f = lane; f < f_dim; f += 32) {
      const float base = ui_r[f] + b0_s[f];
      const float w = wd_s[f];
      float s[NE];
#pragma unroll
      for (int e = 0; e < NE; ++e) s[e] = silu(base + uj[e][f] + dd[e] * w);
#pragma unroll
      for (int j = 0; j < M_OUT; ++j) {
        const float wj = w1t[j * f_dim + f];
#pragma unroll
        for (int e = 0; e < NE; ++e) acc[e][j] = fmaf(s[e], wj, acc[e][j]);
      }
    }

#pragma unroll
    for (int e = 0; e < NE; ++e)
#pragma unroll
      for (int j = 0; j < M_OUT; ++j)
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc[e][j] += __shfl_xor_sync(FULL, acc[e][j], off);

    // every lane now holds all NE·M sums; lane t % 32 writes output t
#pragma unroll
    for (int e = 0; e < NE; ++e) {
#pragma unroll
      for (int j = 0; j < M_OUT; ++j) {
        if (((e * M_OUT + j) & 31) == lane && k0 + e < k_nbrs) {
          const size_t o = (row * k_nbrs + k0 + e) * M_OUT + j;
          const float z = acc[e][j] + b1[j];
          out[o] = kDz ? dm[o] * dsilu(z) : silu(z);
        }
      }
    }
  }
}

// Backward pass 2: see the file comment. Grid (ceil(G / BW_ROWS),
// ceil(F / BW_COLS)); dynamic shared memory (A·BW_COLS + K·(M + 2 +
// BW_WARPS)) floats.
__global__ void __launch_bounds__(BW_COLS)
edge_mlp_bwd_kernel(const float* __restrict__ ui, const float* __restrict__ ujn,
                    const float* __restrict__ dist, const int64_t* __restrict__ idx,
                    const float* __restrict__ wd, const float* __restrict__ b0,
                    const float* __restrict__ w1, const float* __restrict__ dz,
                    float* __restrict__ dui, float* __restrict__ dujn,
                    float* __restrict__ ddist_part, float* __restrict__ param_part,
                    int g_rows, int a_slots, int k_nbrs, int f_dim) {
  extern __shared__ float smem[];
  float* dujn_s = smem;                             // [A][BW_COLS]
  float* dz_s = dujn_s + a_slots * BW_COLS;         // [K][M_OUT]
  float* dist_s = dz_s + k_nbrs * M_OUT;            // [K]
  float* ddist_s = dist_s + k_nbrs;                 // [BW_WARPS][K]
  int* idx_s = reinterpret_cast<int*>(ddist_s + BW_WARPS * k_nbrs);  // [K]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = blockIdx.y;
  const int f = chunk * BW_COLS + tid;
  const bool live = f < f_dim;

  float w1f[M_OUT], dw1[M_OUT];
#pragma unroll
  for (int j = 0; j < M_OUT; ++j) {
    w1f[j] = live ? w1[static_cast<size_t>(f) * M_OUT + j] : 0.f;
    dw1[j] = 0.f;
  }
  const float wdf = live ? wd[f] : 0.f;
  const float b0f = live ? b0[f] : 0.f;
  float dwd = 0.f, db0 = 0.f, db1 = 0.f;  // db1: thread j < M_OUT of chunk 0

  const int g_end = min(g_rows, (static_cast<int>(blockIdx.x) + 1) * BW_ROWS);
  for (int g = blockIdx.x * BW_ROWS; g < g_end; ++g) {
    for (int a = 0; a < a_slots; ++a) dujn_s[a * BW_COLS + tid] = 0.f;  // own column
    const float* ujn_g = ujn + static_cast<size_t>(g) * a_slots * f_dim;

    for (int a = 0; a < a_slots; ++a) {
      const size_t row = static_cast<size_t>(g) * a_slots + a;
      __syncthreads();  // the previous slot's staged edges are read no more
      for (int i = tid; i < k_nbrs * M_OUT; i += BW_COLS)
        dz_s[i] = dz[row * k_nbrs * M_OUT + i];
      for (int i = tid; i < k_nbrs; i += BW_COLS) {
        idx_s[i] = static_cast<int>(idx[row * k_nbrs + i]);
        dist_s[i] = dist[row * k_nbrs + i];
      }
      __syncthreads();

      if (chunk == 0 && tid < M_OUT)
        for (int kk = 0; kk < k_nbrs; ++kk) db1 += dz_s[kk * M_OUT + tid];

      const float base = (live ? ui[row * f_dim + f] : 0.f) + b0f;
      float dui_acc = 0.f;
      for (int kk = 0; kk < k_nbrs; ++kk) {
        const int j = idx_s[kk];
        const float d = dist_s[kk];
        const float pre =
            base + (live ? ujn_g[static_cast<size_t>(j) * f_dim + f] : 0.f) + d * wdf;
        const float s = sigmoid(pre);
        const float a1 = pre * s;
        const float4* dz4 = reinterpret_cast<const float4*>(dz_s + kk * M_OUT);
        float t = 0.f;
#pragma unroll
        for (int q = 0; q < M_OUT / 4; ++q) {
          const float4 v = dz4[q];
          t = fmaf(v.x, w1f[4 * q + 0], t);
          t = fmaf(v.y, w1f[4 * q + 1], t);
          t = fmaf(v.z, w1f[4 * q + 2], t);
          t = fmaf(v.w, w1f[4 * q + 3], t);
          dw1[4 * q + 0] = fmaf(a1, v.x, dw1[4 * q + 0]);
          dw1[4 * q + 1] = fmaf(a1, v.y, dw1[4 * q + 1]);
          dw1[4 * q + 2] = fmaf(a1, v.z, dw1[4 * q + 2]);
          dw1[4 * q + 3] = fmaf(a1, v.w, dw1[4 * q + 3]);
        }
        const float dpre = t * (s * (1.f + pre * (1.f - s)));  // 0 where !live
        dui_acc += dpre;
        dujn_s[j * BW_COLS + tid] += dpre;
        dwd = fmaf(dpre, d, dwd);
        db0 += dpre;
        float v = dpre * wdf;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
        if (lane == 0) ddist_s[warp * k_nbrs + kk] = v;
      }
      if (live) dui[row * f_dim + f] = dui_acc;
      __syncthreads();
      for (int i = tid; i < k_nbrs; i += BW_COLS) {
        float sum = 0.f;
        for (int w = 0; w < BW_WARPS; ++w) sum += ddist_s[w * k_nbrs + i];
        ddist_part[(static_cast<size_t>(chunk) * g_rows * a_slots + row) * k_nbrs + i] = sum;
      }
    }
    if (live)
      for (int a = 0; a < a_slots; ++a)
        dujn[(static_cast<size_t>(g) * a_slots + a) * f_dim + f] = dujn_s[a * BW_COLS + tid];
  }

  // this block's partial parameter sums: row blockIdx.x of the workspace,
  // laid out as the concatenated output [dW1 (F·M) | dwd (F) | db0 (F) | db1 (M)]
  float* part = param_part +
      static_cast<size_t>(blockIdx.x) * (static_cast<size_t>(f_dim) * (M_OUT + 2) + M_OUT);
  if (live) {
#pragma unroll
    for (int j = 0; j < M_OUT; ++j) part[static_cast<size_t>(f) * M_OUT + j] = dw1[j];
    part[static_cast<size_t>(f_dim) * M_OUT + f] = dwd;
    part[static_cast<size_t>(f_dim) * (M_OUT + 1) + f] = db0;
  }
  if (chunk == 0 && tid < M_OUT) part[static_cast<size_t>(f_dim) * (M_OUT + 2) + tid] = db1;
}

size_t fwd_smem(int f_dim) { return static_cast<size_t>(M_OUT + 2) * f_dim * sizeof(float); }

size_t bwd_smem(int a_slots, int k_nbrs) {
  return (static_cast<size_t>(a_slots) * BW_COLS +
          static_cast<size_t>(k_nbrs) * (M_OUT + 2 + BW_WARPS)) * sizeof(float);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" int edge_mlp_fwd_f32(const float* ui, const float* ujn, const float* dist,
                                const int64_t* idx, const float* wd, const float* b0,
                                const float* w1, const float* b1, float* out,
                                int g_rows, int a_slots, int k_nbrs, int f_dim,
                                int m_out, cudaStream_t stream) {
  if (m_out != M_OUT) return static_cast<int>(cudaErrorInvalidValue);
  if (g_rows <= 0 || a_slots <= 0 || k_nbrs <= 0) return 0;  // nothing to launch
  const size_t smem = fwd_smem(f_dim);
  cudaError_t err = allow_smem(edge_mlp_fwd_kernel<false>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  edge_mlp_fwd_kernel<false><<<g_rows, WARPS * 32, smem, stream>>>(
      ui, ujn, dist, idx, wd, b0, w1, b1, nullptr, out, a_slots, k_nbrs, f_dim);
  return static_cast<int>(cudaGetLastError());
}

// Floats of scratch that `edge_mlp_bwd_f32` needs: dz [G, A, K, M], the
// parameter partials [ceil(G / BW_ROWS), F·(M + 2) + M] and the ddist
// partials [ceil(F / BW_COLS), G·A·K].
extern "C" int edge_mlp_bwd_workspace_f32(int g_rows, int a_slots, int k_nbrs, int f_dim,
                                          int m_out, int64_t* floats) {
  if (m_out != M_OUT || g_rows < 0 || a_slots < 0 || k_nbrs < 0 || f_dim < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t edges = static_cast<int64_t>(g_rows) * a_slots * k_nbrs;
  const int64_t row_blocks = (g_rows + BW_ROWS - 1) / BW_ROWS;
  const int64_t chunks = (f_dim + BW_COLS - 1) / BW_COLS;
  *floats = edges * M_OUT + row_blocks * (static_cast<int64_t>(f_dim) * (M_OUT + 2) + M_OUT) +
            chunks * edges;
  return 0;
}

// Backward of edge_mlp_fwd_f32 for dm [G, A, K, M]. Writes dui, dujn
// [G, A, F], ddist [G, A, K] and dparams = [dW1 (F·M) | dwd (F) | db0 (F) |
// db1 (M)]; `ws` holds edge_mlp_bwd_workspace_f32 floats.
extern "C" int edge_mlp_bwd_f32(const float* ui, const float* ujn, const float* dist,
                                const int64_t* idx, const float* wd, const float* b0,
                                const float* w1, const float* b1, const float* dm,
                                float* dui, float* dujn, float* ddist, float* dparams,
                                float* ws, int g_rows, int a_slots, int k_nbrs, int f_dim,
                                int m_out, cudaStream_t stream) {
  if (m_out != M_OUT) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t c_tot = static_cast<int64_t>(f_dim) * (M_OUT + 2) + M_OUT;
  const int64_t edges = static_cast<int64_t>(g_rows) * a_slots * k_nbrs;
  const int64_t nodes = static_cast<int64_t>(g_rows) * a_slots * f_dim;
  cudaError_t err;
  if (g_rows <= 0 || a_slots <= 0 || k_nbrs <= 0 || f_dim <= 0) {  // no edge: all zero
    err = cudaMemsetAsync(dparams, 0, c_tot * sizeof(float), stream);
    if (err == cudaSuccess && nodes > 0) err = cudaMemsetAsync(dui, 0, nodes * sizeof(float), stream);
    if (err == cudaSuccess && nodes > 0) err = cudaMemsetAsync(dujn, 0, nodes * sizeof(float), stream);
    if (err == cudaSuccess && edges > 0) err = cudaMemsetAsync(ddist, 0, edges * sizeof(float), stream);
    return static_cast<int>(err);
  }
  const int row_blocks = (g_rows + BW_ROWS - 1) / BW_ROWS;
  const int chunks = (f_dim + BW_COLS - 1) / BW_COLS;
  float* dz = ws;
  float* param_part = dz + edges * M_OUT;
  float* ddist_part = param_part + static_cast<int64_t>(row_blocks) * c_tot;

  // 1. dz = dm ⊙ silu'(z), z recomputed as the forward computes it
  const size_t smem1 = fwd_smem(f_dim);
  err = allow_smem(edge_mlp_fwd_kernel<true>, smem1);
  if (err != cudaSuccess) return static_cast<int>(err);
  edge_mlp_fwd_kernel<true><<<g_rows, WARPS * 32, smem1, stream>>>(
      ui, ujn, dist, idx, wd, b0, w1, b1, dm, dz, a_slots, k_nbrs, f_dim);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // 2. input gradients and per-block partial sums
  const size_t smem2 = bwd_smem(a_slots, k_nbrs);
  err = allow_smem(edge_mlp_bwd_kernel, smem2);
  if (err != cudaSuccess) return static_cast<int>(err);
  edge_mlp_bwd_kernel<<<dim3(row_blocks, chunks), BW_COLS, smem2, stream>>>(
      ui, ujn, dist, idx, wd, b0, w1, dz, dui, dujn, ddist_part, param_part,
      g_rows, a_slots, k_nbrs, f_dim);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // 3. and 4. the cross-block sums
  err = column_sum(param_part, dparams, row_blocks, c_tot, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(column_sum(ddist_part, ddist, chunks, edges, stream));
}
