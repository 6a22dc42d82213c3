// Sorted segment sum, forward: out[s, :] = sum over rows i with ids[i] == s
// of data[i, :], for ids sorted non-decreasing.
//
// Replaces: equihgnn_tpu/ops/pallas/segment_sum.py `sorted_segment_sum`
// (`_pallas_forward` / `_kernel`). The TPU kernel turns each block of 256
// rows into a one-hot matmul and carries the sums across a sequential grid
// in a revisited output block. Hopper blocks run in parallel and in no
// order, so nothing can be carried between them; here every output element
// is owned by exactly one block instead.
//
// Bound on the H100: device memory, and the latency of the loads when a
// segment is long. At the serving shapes (M = 29,456 rows, D = 256,
// S = 13,968 segments) a call reads 30 MB and writes 14 MB. Most segments
// hold 2 rows, but the padding hyperedge of a batch collects every padded
// incidence row: 1,406 rows at the serving shapes. One thread summing those
// one dependent load after another sets the kernel's time alone.
//
// Design: a block owns SPB consecutive segments by COLS feature columns.
// Two warps find the block's row range [lower_bound(s0),
// lower_bound(s0 + SPB)) over the sorted ids, each by a 32-way search (one
// ballot of 32 probes per step: 3 dependent loads at the serving shapes,
// where a binary search takes 15 and kept the whole block waiting). Each of
// the block's LANES warps then walks every LANES-th row of that range,
// lanes over columns (coalesced reads), with BATCH rows' loads in flight.
// Because ids are sorted, a warp meets its segments in order: it keeps a
// running sum in registers and stores it to a shared-memory slot
// [segment][warp] when the id changes, so no slot is written twice and no
// atomics are needed. Last, each thread adds one segment's LANES partial
// sums in warp order and writes the output; a segment with no rows
// writes 0. The result is deterministic.
//
// Contract (checked on the host, by `pad_hypergraph_batch`, not here): ids
// are non-decreasing. Ids outside [0, S) fall in no output row.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int COLS = 32;   // feature columns per block: the lanes of a warp
constexpr int LANES = 16;  // warps per block, each over every LANES-th row
constexpr int SPB = 16;    // consecutive segments per block
constexpr int BATCH = 4;   // rows a warp has in flight
constexpr unsigned FULL = 0xffffffffu;

// First index in [0, n) whose id is >= key (n if none), found by the 32
// lanes of a warp together; every lane returns it.
__device__ __forceinline__ int64_t warp_lower_bound(const int64_t* __restrict__ ids,
                                                    int64_t n, int64_t key, int lane) {
  int64_t lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const int64_t span = hi - lo;
    const int c = __popc(__ballot_sync(FULL, ids[lo + span * lane / 32] < key));
    if (c == 0) return lo;  // ids[lo] >= key
    const int64_t below = lo + span * (c - 1) / 32;  // last probe under key
    hi = c < 32 ? lo + span * c / 32 : hi;
    lo = below + 1;
  }
  const int64_t p = lo + lane;
  return lo + __popc(__ballot_sync(FULL, p < hi && ids[p] < key));
}

__global__ void __launch_bounds__(COLS * LANES)
sorted_segment_sum_kernel(const float* __restrict__ data,
                          const int64_t* __restrict__ ids,
                          float* __restrict__ out,
                          int64_t m, int64_t d, int64_t s) {
  __shared__ float part[SPB][LANES][COLS];
  __shared__ int64_t range[2];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * SPB;
  const int64_t col = static_cast<int64_t>(blockIdx.y) * COLS + lane;
  if (warp < 2) {
    const int64_t bound = warp_lower_bound(ids, m, s0 + warp * SPB, lane);
    if (lane == 0) range[warp] = bound;
  }
#pragma unroll
  for (int j = 0; j < SPB; ++j) part[j][warp][lane] = 0.f;
  __syncthreads();

  if (col < d) {
    const int64_t r1 = range[1];
    int64_t cur = -1;  // ids in range are >= s0 >= 0
    float acc = 0.f;
    for (int64_t rb = range[0] + warp; rb < r1; rb += BATCH * LANES) {
      int64_t id[BATCH];
      float v[BATCH];
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const int64_t r = rb + j * LANES;
        id[j] = r < r1 ? ids[r] : -1;
        v[j] = r < r1 ? data[r * d + col] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        if (id[j] < 0) break;
        if (id[j] != cur) {
          if (cur >= 0) part[cur - s0][warp][lane] = acc;
          cur = id[j];
          acc = 0.f;
        }
        acc += v[j];
      }
    }
    if (cur >= 0) part[cur - s0][warp][lane] = acc;
  }
  __syncthreads();

  for (int t = warp; t < SPB; t += LANES) {
    const int64_t seg = s0 + t;
    if (seg < s && col < d) {
      float total = 0.f;
#pragma unroll
      for (int w = 0; w < LANES; ++w) total += part[t][w][lane];
      out[seg * d + col] = total;
    }
  }
}

}  // namespace

extern "C" int sorted_segment_sum_f32(const float* data, const int64_t* ids,
                                      float* out, int64_t m, int64_t d,
                                      int64_t s, cudaStream_t stream) {
  if (s <= 0 || d <= 0) return 0;  // nothing to launch
  const dim3 block(COLS, LANES);
  const dim3 grid(static_cast<unsigned>((s + SPB - 1) / SPB),
                  static_cast<unsigned>((d + COLS - 1) / COLS));
  sorted_segment_sum_kernel<<<grid, block, 0, stream>>>(data, ids, out, m, d, s);
  return static_cast<int>(cudaGetLastError());
}
