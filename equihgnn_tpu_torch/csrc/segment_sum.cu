// Sorted segment sum, forward: out[s, :] = sum over rows i with ids[i] == s
// of data[i, :], for ids sorted non-decreasing.
//
// Replaces: equihgnn_tpu/ops/pallas/segment_sum.py `sorted_segment_sum`
// (`_pallas_forward` / `_kernel`). The TPU kernel turns each block of 256
// rows into a one-hot matmul and carries the sums across a sequential grid
// in a revisited output block. Hopper blocks run in parallel and in no
// order, so nothing can be carried between them.
//
// Bound on the H100: device memory. At the serving shapes (M = 29,456 rows,
// D = 256, S = 13,968 segments) a call reads 30 MB and writes 14 MB: 13 µs
// at 3.35 TB/s. Most segments hold 2 rows, but the padding hyperedge of a
// batch collects every padded incidence row: 1,406 rows at the serving
// shapes.
//
// Design: fixed row tiles, two passes, every byte read once.
//  - Pass 1: a block takes TR consecutive rows by 64·V columns (V = 4: one
//    16-byte load a thread a row, neighbouring threads on neighbouring
//    columns). Each thread walks the tile's rows in order with BATCH rows'
//    loads in flight and keeps a running sum over each run of equal ids. A
//    segment that begins and ends inside the tile is written straight to
//    out. Only the tile's first segment (when the previous tile ends in
//    it) and its last (when the next tile begins with it) can cross a tile
//    edge; their sums go to a workspace [tiles][2][D] instead. The tile
//    also writes 0 to every segment whose id lies strictly between two
//    consecutive ids it holds, or between the previous tile's last id and
//    its first; the first tile those below its first id, the last tile
//    those above its last. Every output row is then written exactly once:
//    no memset, no atomics, no search.
//  - Pass 2: the tile in which a crossing segment begins sums its partial
//    and those of the following tiles that begin with the same id, in tile
//    order (BATCH tiles' loads at a time), and writes the row.
// Each output element is summed by one thread in a fixed order: two runs
// give the same bits.
//
// bfloat16 (`sorted_segment_sum_bf16`, the models' bf16 path): the
// function of the TPU kernel's bf16 call, the sums taken in f32 and
// rounded once to bf16 (`_pallas_forward`, `:108-109`). The same two
// passes, templated on the data type: each thread reads V = 4 bf16 (one
// 8-byte load a row), the running sums and the [tiles][2][D] workspace stay
// f32, and each output row is written once, in bf16. A call moves half the
// f32 bytes (15 + 7 MB at the serving shapes: 6.6 µs at 3.35 TB/s).
//
// Contract (checked on the host, by `pad_hypergraph_batch`, not here): ids
// are non-decreasing. Ids outside [0, S) fall in no output row.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TR = 32;       // rows of a tile
constexpr int THREADS = 64;  // threads of a block: 64·V columns of a tile
constexpr int BATCH = 16;    // rows (pass 1) or tiles (pass 2) a thread has in flight

// V consecutive values, held as floats: one 16-byte access of f32, or one
// 8-byte access of bf16, when V = 4.
template <int V>
struct Vec {
  float v[V];
  __device__ __forceinline__ void load(const float* p) {
    if constexpr (V == 4) {
      const float4 x = __ldcs(reinterpret_cast<const float4*>(p));  // read once: evict first
      v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    } else {
      v[0] = __ldcs(p);
    }
  }
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    if constexpr (V == 4) {
      const uint2 x = __ldcs(reinterpret_cast<const uint2*>(p));
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
      const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
      v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
    } else {
      v[0] = __bfloat162float(
          __ushort_as_bfloat16(__ldcs(reinterpret_cast<const unsigned short*>(p))));
    }
  }
  __device__ __forceinline__ void store(float* p) const {
    if constexpr (V == 4)
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    else
      p[0] = v[0];
  }
  __device__ __forceinline__ void store(__nv_bfloat16* p) const {  // rounded to nearest even
    if constexpr (V == 4) {
      const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
      const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
      *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const unsigned*>(&a),
                                                *reinterpret_cast<const unsigned*>(&b));
    } else {
      p[0] = __float2bfloat16_rn(v[0]);
    }
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = 0.f;
  }
  __device__ __forceinline__ void add(const Vec& o) {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] += o.v[j];
  }
};

// out rows max(lo, 0) … min(hi, s) − 1 of this thread's columns set to 0.
template <int V, typename T>
__device__ __forceinline__ void zero_rows(T* __restrict__ out, int64_t lo, int64_t hi,
                                          int64_t s, int64_t d, int64_t col) {
  Vec<V> z;
  z.zero();
  for (int64_t x = lo < 0 ? 0 : lo; x < hi && x < s; ++x) z.store(out + x * d + col);
}

template <int V, typename T>
__global__ void __launch_bounds__(THREADS)
segment_sum_tiles_kernel(const T* __restrict__ data, const int64_t* __restrict__ ids,
                         T* __restrict__ out, float* __restrict__ ws, int64_t m, int64_t d,
                         int64_t s) {
  __shared__ int64_t sid[TR + 2];  // ids[r0 − 1], the tile's ids, ids[r0 + n]
  const int64_t t = blockIdx.x, tiles = gridDim.x;
  const int64_t r0 = t * TR;
  const int n = static_cast<int>(m - r0 < TR ? m - r0 : TR);
  for (int j = threadIdx.x; j < n + 2; j += THREADS) {
    const int64_t r = r0 - 1 + j;
    sid[j] = r >= 0 && r < m ? ids[r] : 0;
  }
  __syncthreads();
  const int64_t col = (static_cast<int64_t>(blockIdx.y) * THREADS + threadIdx.x) * V;
  if (col >= d) return;
  const int64_t first = sid[1], last = sid[n];
  const bool cross_l = t > 0 && sid[0] == first;
  const bool cross_r = t + 1 < tiles && sid[n + 1] == last;
  // the ids between the previous tile's last one (or below the first) and ours
  zero_rows<V, T>(out, t > 0 ? sid[0] + 1 : 0, first, s, d, col);

  auto flush = [&](int64_t x, const Vec<V>& acc) {
    if (x == first && cross_l)
      acc.store(ws + (2 * t) * d + col);
    else if (x == last && cross_r)
      acc.store(ws + (2 * t + 1) * d + col);
    else if (x >= 0 && x < s)
      acc.store(out + x * d + col);
  };
  Vec<V> acc;
  acc.zero();
  int64_t cur = first;
  for (int b = 0; b < n; b += BATCH) {
    Vec<V> v[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      if (b + j < n) v[j].load(data + (r0 + b + j) * d + col);
      else v[j].zero();
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      if (b + j < n) {
        const int64_t id = sid[1 + b + j];
        if (id != cur) {
          flush(cur, acc);
          zero_rows<V, T>(out, cur + 1, id, s, d, col);
          cur = id;
          acc.zero();
        }
        acc.add(v[j]);
      }
    }
  }
  flush(cur, acc);
  if (t + 1 == tiles) zero_rows<V, T>(out, last + 1, s, s, d, col);
}

template <int V, typename T>
__global__ void __launch_bounds__(THREADS)
segment_sum_cross_kernel(const float* __restrict__ ws, const int64_t* __restrict__ ids,
                         T* __restrict__ out, int64_t m, int64_t d, int64_t s) {
  const int64_t t = blockIdx.x, tiles = gridDim.x;
  if (t + 1 >= tiles) return;
  const int64_t r1 = (t + 1) * TR;  // the next tile's first row (< m)
  const int64_t b = ids[r1 - 1];
  if (ids[r1] != b || b < 0 || b >= s) return;  // no crossing last segment, or no row for it
  if (t > 0 && ids[t * TR - 1] == b) return;  // it began in an earlier tile
  const int64_t col = (static_cast<int64_t>(blockIdx.y) * THREADS + threadIdx.x) * V;
  if (col >= d) return;
  Vec<V> sum;
  sum.load(ws + (2 * t + 1) * d + col);
  for (int64_t u0 = t + 1; u0 < tiles; u0 += BATCH) {
    int64_t id[BATCH];
    Vec<V> v[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {  // a partial is read before its id is known to match
      const int64_t u = u0 + j;
      id[j] = u < tiles ? ids[u * TR] : b + 1;
      if (u < tiles) v[j].load(ws + (2 * u) * d + col);
      else v[j].zero();
    }
    bool more = true;
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      more = more && id[j] == b;
      if (more) sum.add(v[j]);
    }
    if (!more) break;
  }
  sum.store(out + b * d + col);
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

template <int V, typename T>
cudaError_t launch(const T* data, const int64_t* ids, T* out, float* ws, int64_t m,
                   int64_t d, int64_t s, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((m + TR - 1) / TR),
                  static_cast<unsigned>((d + THREADS * V - 1) / (THREADS * V)));
  segment_sum_tiles_kernel<V, T><<<grid, THREADS, 0, stream>>>(data, ids, out, ws, m, d, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || grid.x < 2) return err;
  segment_sum_cross_kernel<V, T><<<grid, THREADS, 0, stream>>>(ws, ids, out, m, d, s);
  return cudaGetLastError();
}

// out [s, d] = the segment sums of data [m, d] over the non-decreasing ids
// [m], in T; ws: a workspace of ws_floats >= 2 · ceil(m / TR) · d floats
// (two partial rows a tile).
template <typename T>
int sorted_segment_sum(const T* data, const int64_t* ids, T* out, float* ws, int64_t ws_floats,
                       int64_t m, int64_t d, int64_t s, cudaStream_t stream) {
  if (m < 0 || d < 0 || s < 0 || (m + TR - 1) / TR > 0x7fffffff || d > 65535LL * THREADS ||
      ws_floats < 2 * ((m + TR - 1) / TR) * d)
    return static_cast<int>(cudaErrorInvalidValue);
  if (s == 0 || d == 0) return 0;  // nothing to write
  if (m == 0)  // every segment empty
    return static_cast<int>(cudaMemsetAsync(out, 0, s * d * sizeof(T), stream));
  const bool vec = d % 4 == 0 && aligned(data, 4 * sizeof(T)) && aligned(out, 4 * sizeof(T)) &&
                   aligned(ws, 16);
  return static_cast<int>(vec ? launch<4, T>(data, ids, out, ws, m, d, s, stream)
                              : launch<1, T>(data, ids, out, ws, m, d, s, stream));
}

}  // namespace

extern "C" int sorted_segment_sum_f32(const float* data, const int64_t* ids, float* out,
                                      float* ws, int64_t ws_floats, int64_t m, int64_t d,
                                      int64_t s, cudaStream_t stream) {
  return sorted_segment_sum<float>(data, ids, out, ws, ws_floats, m, d, s, stream);
}

// bf16 data and output, f32 sums and workspace.
extern "C" int sorted_segment_sum_bf16(const __nv_bfloat16* data, const int64_t* ids,
                                       __nv_bfloat16* out, float* ws, int64_t ws_floats,
                                       int64_t m, int64_t d, int64_t s, cudaStream_t stream) {
  return sorted_segment_sum<__nv_bfloat16>(data, ids, out, ws, ws_floats, m, d, s, stream);
}
