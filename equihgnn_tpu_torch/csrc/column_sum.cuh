// Deterministic cross-block sums for the backward kernels (C and E): each
// block of a backward pass writes one row of partial sums to a workspace,
// and `column_sum` adds the rows, every output column owned by one block
// and summed in a fixed order, so that no atomics are needed and a run
// gives the same bits every time. `column_sums` does two such sums in one
// launch (kernel C's parameter and ddist partials).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SUM_COLS = 32;  // columns per block (lanes)
constexpr int SUM_LANES = 8;  // rows summed in parallel per column

// out[c] = Σ_r in[r, c] for a row-major [rows, cols] matrix.
struct SumJob {
  const float* in;
  float* out;
  int64_t rows, cols;
};

// Each block owns SUM_COLS columns of job a (the first blocks_a blocks) or
// of job b; its SUM_LANES thread rows stride over the rows and are then
// added in a fixed order.
__global__ void __launch_bounds__(SUM_COLS * SUM_LANES)
column_sum_kernel(SumJob a, SumJob b, unsigned blocks_a) {
  __shared__ float part[SUM_LANES][SUM_COLS];
  const bool second = blockIdx.x >= blocks_a;
  const float* in = second ? b.in : a.in;
  float* out = second ? b.out : a.out;
  const int64_t rows = second ? b.rows : a.rows, cols = second ? b.cols : a.cols;
  const int64_t c =
      static_cast<int64_t>(second ? blockIdx.x - blocks_a : blockIdx.x) * SUM_COLS + threadIdx.x;
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

cudaError_t column_sums(SumJob a, SumJob b, cudaStream_t stream) {
  const int64_t blocks_a = a.cols > 0 ? (a.cols + SUM_COLS - 1) / SUM_COLS : 0;
  const int64_t blocks_b = b.cols > 0 ? (b.cols + SUM_COLS - 1) / SUM_COLS : 0;
  if (blocks_a + blocks_b == 0) return cudaSuccess;
  column_sum_kernel<<<static_cast<unsigned>(blocks_a + blocks_b), dim3(SUM_COLS, SUM_LANES), 0,
                      stream>>>(a, b, static_cast<unsigned>(blocks_a));
  return cudaGetLastError();
}

cudaError_t column_sum(const float* in, float* out, int64_t rows, int64_t cols,
                       cudaStream_t stream) {
  return column_sums(SumJob{in, out, rows, cols}, SumJob{nullptr, nullptr, 0, 0}, stream);
}

}  // namespace
