// Fused EGNN edge messages, forward:
//   out[g, a, kk, :] = silu(silu(ui[g, a] + ujn[g, idx[g, a, kk]]
//                                + dist[g, a, kk] * wd + b0) @ W1 + b1)
// with ui, ujn [G, A, F], dist [G, A, K], idx [G, A, K] (slot indices into
// the A axis), wd, b0 [F], W1 [F, M], b1 [M] and out [G, A, K, M], all f32.
//
// Replaces: equihgnn_tpu/ops/pallas/edge_mlp.py `_fwd_impl` / `_fwd_kernel`.
// As on the TPU, the point is that the [G, A, K, F] pre-activation never
// reaches device memory: at the serving shapes (G = 769, A = 32, K = 16,
// F = 1026, M = 16) it would be 1.62 GB, while this kernel reads ui and ujn
// (101 MB each) and writes 25 MB. The TPU kernel selects neighbour rows
// with a one-hot [A, A] matmul, a Mosaic workaround; here the neighbour row
// is read directly.
//
// Bound on the H100: the 16-wide product with W1 (2·E·F·M = 12.9 GFLOP at
// the serving shapes, E = G·A·K edges) and the E·F sigmoids run on the CUDA
// cores, and each f term needs W1[f, 0..M) from shared memory. Device
// memory traffic is small; the neighbour rows of ujn are re-read from L2.
//
// Design: one block per molecule row g. The block stages W1 transposed
// ([M][F], so that lanes reading consecutive f hit consecutive banks), wd
// and b0 in dynamic shared memory: 18·F·4 bytes, 73.9 KB at F = 1026, above
// the 48 KB static limit, hence cudaFuncAttributeMaxDynamicSharedMemorySize.
// Each warp takes a slot a and NE = 4 of its neighbours at a time; its lanes
// stride over f (the tail of F = 1026 is masked by the loop bound), and each
// lane keeps NE·M partial dot products in registers, so one W1 value read
// from shared memory serves NE edges. A butterfly of warp shuffles then
// sums the partials, and the lanes write the NE·M outputs. Every edge is
// computed, padded neighbours included; the caller masks them afterwards.
// M must be 16 (the EGNN message width); any F, A and K are taken.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int M_OUT = 16;  // message width m
constexpr int NE = 4;      // neighbours a warp carries at once
constexpr int WARPS = 8;   // warps per block
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float silu(float x) { return x / (1.f + __expf(-x)); }

__global__ void __launch_bounds__(WARPS * 32)
edge_mlp_fwd_kernel(const float* __restrict__ ui, const float* __restrict__ ujn,
                    const float* __restrict__ dist, const int64_t* __restrict__ idx,
                    const float* __restrict__ wd, const float* __restrict__ b0,
                    const float* __restrict__ w1, const float* __restrict__ b1,
                    float* __restrict__ out, int a_slots, int k_nbrs, int f_dim) {
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
          out[(row * k_nbrs + k0 + e) * M_OUT + j] = silu(acc[e][j] + b1[j]);
        }
      }
    }
  }
}

}  // namespace

extern "C" int edge_mlp_fwd_f32(const float* ui, const float* ujn, const float* dist,
                                const int64_t* idx, const float* wd, const float* b0,
                                const float* w1, const float* b1, float* out,
                                int g_rows, int a_slots, int k_nbrs, int f_dim,
                                int m_out, cudaStream_t stream) {
  if (m_out != M_OUT) return static_cast<int>(cudaErrorInvalidValue);
  if (g_rows <= 0 || a_slots <= 0 || k_nbrs <= 0) return 0;  // nothing to launch
  const size_t smem = static_cast<size_t>(M_OUT + 2) * f_dim * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      edge_mlp_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  edge_mlp_fwd_kernel<<<g_rows, WARPS * 32, smem, stream>>>(
      ui, ujn, dist, idx, wd, b0, w1, b1, out, a_slots, k_nbrs, f_dim);
  return static_cast<int>(cudaGetLastError());
}
