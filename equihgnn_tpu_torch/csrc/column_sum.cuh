// Deterministic cross-block sums for the backward kernels (C and E): each
// block of a backward pass writes one row of partial sums to a workspace,
// and `column_sum` adds the rows, every output column owned by one block
// and summed in a fixed order, so that no atomics are needed and a run
// gives the same bits every time.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SUM_COLS = 32;  // columns per block (lanes)
constexpr int SUM_LANES = 8;  // rows summed in parallel per column

// out[c] = Σ_r in[r, c] for a row-major [rows, cols] matrix. Each block owns
// SUM_COLS columns; its SUM_LANES thread rows stride over the rows and are
// then added in a fixed order.
__global__ void __launch_bounds__(SUM_COLS * SUM_LANES)
column_sum_kernel(const float* __restrict__ in, float* __restrict__ out,
                  int64_t rows, int64_t cols) {
  __shared__ float part[SUM_LANES][SUM_COLS];
  const int64_t c = static_cast<int64_t>(blockIdx.x) * SUM_COLS + threadIdx.x;
  float acc = 0.f;
  if (c < cols)
    for (int64_t r = threadIdx.y; r < rows; r += SUM_LANES) acc += in[r * cols + c];
  part[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && c < cols) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < SUM_LANES; ++w) sum += part[w][threadIdx.x];
    out[c] = sum;
  }
}

cudaError_t column_sum(const float* in, float* out, int64_t rows, int64_t cols,
                       cudaStream_t stream) {
  if (cols <= 0) return cudaSuccess;
  const unsigned blocks = static_cast<unsigned>((cols + SUM_COLS - 1) / SUM_COLS);
  column_sum_kernel<<<blocks, dim3(SUM_COLS, SUM_LANES), 0, stream>>>(in, out, rows, cols);
  return cudaGetLastError();
}

}  // namespace
