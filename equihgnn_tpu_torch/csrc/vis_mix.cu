// ViSNet's vector mix (ViS_MP), forward and backward: kernels F-I.
//
//   F vec_agg[g,i,l,c] = Σ_k m·s1[g,i,k,c]·vec[g,j,l,c] + Σ_k s2m[g,i,k,c]·d[g,i,k,l]
//   H w_dot[g,i,k,c]   = uv − ud·vd·(2 − Σ_l d²), with j = idx[g,i,k], m = mask[g,i,k],
//                        uv = Σ_l u[g,i,l,c]·m·vv[g,j,l,c], vd = Σ_l d[g,i,k,l]·m·vv[g,j,l,c],
//                        ud = Σ_l u[g,i,l,c]·d[g,i,k,l]
//   G the gradients of F: dvec, ds1, ds2m, dd;  I the gradients of H: du, dvv, dd.
//
// Shapes: vec, u, vv [G, A, L, h]; s1, s2m [G, A, K, h] (s1 with any row
// stride: it is a view of the [.., 2h] s_proj output); d [G, A, K, L];
// idx [G, A, K] int64 slot indices into the A axis, mask [G, A, K] bool.
// All f32, L ∈ {3, 8}. Replaces equihgnn_tpu/ops/pallas/vis_mix.py:
// `_vec_agg_fwd` (F, body `_agg_fwd_kernel`), `_vec_agg_bwd` (G,
// `_agg_bwd_kernel`), `_wdot_fwd` (H, `_wdot_fwd_kernel`) and `_wdot_bwd`
// (I, `_wdot_bwd_kernel`). Unlike those (bf16 MXU operands), every product
// here is f32.
//
// Bound on the H100: bytes. At the batch-768 shapes (G = 769, A = 32,
// K = 17, L = 8, h = 256) each [G, A, K, h] tensor is 428 MB and each
// [G, A, L, h] one 202 MB, while the arithmetic is 2-6 FMAs per loaded
// float. s1 (F, G) and gw (I) are needed only on masked-in edges (0.44 of
// them within 5 Å), and only those rows are read: F moves 1.04 GB (0.31 ms
// at 3.35 TB/s), G 2.11 GB, H 0.85 GB, I 1.03 GB. What must not happen is
// what the plain version does: build the gathered [G, A, K, L, h]
// neighbour vectors (3.4 GB) or one [G, A, K, h] temporary per l.
//
// Design. A block owns one molecule row g and a chunk of HC = 32 columns of
// h, one column per lane. It stages the neighbour side of the chunk, vec
// (F, G) or vv (H, I) [A][L][HC] (32 KB at A = 32, L = 8), and the row's
// d and indices in shared memory, so that every gather vec[j] is a
// shared-memory read by index: the TPU kernels' one-hot matmuls
// (`_block_onehot`) and their edge-k-major transposes are not carried over.
// Warp w of 16 takes the target slots i ≡ w (mod 16); per edge (i, k) it reads
// s1/s2m/gw rows with coalesced 128-byte loads. F and H run a grid of
// (G, h / 32) blocks. G and I need ~105 KB of shared memory a block at
// A = 32, so two blocks fit an SM; 16 warps a block keep 32 warps in
// flight there (with 8, G and I ran slower on the H100).
//
// The backward kernels need two things the TPU grid got from running in
// order. (1) dd sums over all of h: G and I run one block per row that loops
// over the h chunks itself, and keeps dd's running sums in shared memory,
// each (i, k) owned by one warp; the 32 lanes' terms of the L (or L + 1)
// sums are added by one butterfly that reduces all of them at once
// (`warp_sum_many`: 9 shuffles for 8 values instead of 40). (2) dvec and dvv
// scatter onto the source slot j: per row the block lists, for each j, the
// masked-in edges (i, k) whose source is j, in ascending order (counted and
// filled with shared-memory atomics, then each list sorted, so the order
// does not depend on the atomics); the warp that owns j sums its list. No
// global atomics: two runs give the same bits.
//
// Contract: every index lies in [0, A), as `knn_dense` gives them; one
// outside that range counts as a masked edge (the wrapper does not check,
// which would cost a device-to-host sync).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int HC = 32;  // h columns per chunk: one per lane
constexpr int WARPS = 16;
constexpr int THREADS = WARPS * 32;
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int pow2_ceil(int n) { return n <= 1 ? 1 : 2 * pow2_ceil((n + 1) / 2); }

// One halving step of `warp_sum_many`, then the next: each lane keeps N of
// its 2N values and sends the other N to the lane OFF away. Recursion over
// template arguments keeps every index a constant, so v stays in registers.
template <int N, int OFF, int P>
__device__ __forceinline__ void halve(float (&v)[P], int lane) {
  if constexpr (N >= 1) {
    const bool upper = (lane & OFF) != 0;
#pragma unroll
    for (int q = 0; q < N; ++q) {
      const float send = upper ? v[q] : v[q + N];
      const float keep = upper ? v[q + N] : v[q];
      v[q] = keep + __shfl_xor_sync(FULL, send, OFF);
    }
    halve<N / 2, OFF / 2>(v, lane);
  }
}

// Sums P values (P a power of two, P ≤ 32) over the 32 lanes of a warp. On
// return, lane t holds the full sum of value t / (32 / P) in v[0]. At each
// halving step a lane keeps half of its values and sends the other half to
// its partner, so P values take P − 1 + log2(32 / P) shuffles.
template <int P>
__device__ __forceinline__ float warp_sum_many(float (&v)[P], int lane) {
  halve<P / 2, 16>(v, lane);
#pragma unroll
  for (int off = 16 / P; off >= 1; off /= 2) v[0] += __shfl_xor_sync(FULL, v[0], off);
  return v[0];
}

// The row's neighbour indices (-1 where masked or out of range) and its
// d [A·K][L], staged in shared memory.
__device__ __forceinline__ void stage_edges(const int64_t* __restrict__ idx,
                                            const bool* __restrict__ mask,
                                            const float* __restrict__ d, size_t row_e, int ak,
                                            int a_slots, int L, int* idx_s, float* d_s) {
  for (int e = threadIdx.x; e < ak; e += THREADS) {
    const int64_t j = idx[row_e + e];
    idx_s[e] = (mask[row_e + e] && j >= 0 && j < a_slots) ? static_cast<int>(j) : -1;
  }
  for (int t = threadIdx.x; t < ak * L; t += THREADS) d_s[t] = d[row_e * L + t];
}

// One [A][L][HC] chunk (columns c0 .. c0 + HC) of a [G, A, L, h] tensor's
// row g, zero beyond h.
__device__ __forceinline__ void stage_chunk(const float* __restrict__ x, int g, int a_slots,
                                            int L, int h, int c0, float* x_s) {
  const size_t base = static_cast<size_t>(g) * a_slots * L;
  for (int t = threadIdx.x; t < a_slots * L * HC; t += THREADS) {
    const int cc = t % HC, al = t / HC;
    x_s[t] = c0 + cc < h ? x[(base + al) * h + c0 + cc] : 0.f;
  }
}

// For each source slot j, the row's masked-in edges e = i·K + k with
// idx = j, ascending: list_s[off_s[j] .. off_s[j + 1]).
__device__ void build_source_lists(const int* idx_s, int ak, int a_slots, int* off_s,
                                   int* cur_s, int* list_s) {
  const int tid = threadIdx.x;
  for (int j = tid; j <= a_slots; j += THREADS) off_s[j] = 0;
  __syncthreads();
  for (int e = tid; e < ak; e += THREADS)
    if (idx_s[e] >= 0) atomicAdd(&off_s[idx_s[e] + 1], 1);
  __syncthreads();
  if (tid == 0)
    for (int j = 0; j < a_slots; ++j) off_s[j + 1] += off_s[j];
  __syncthreads();
  for (int j = tid; j < a_slots; j += THREADS) cur_s[j] = off_s[j];
  __syncthreads();
  for (int e = tid; e < ak; e += THREADS)
    if (idx_s[e] >= 0) list_s[atomicAdd(&cur_s[idx_s[e]], 1)] = e;
  __syncthreads();
  for (int j = tid; j < a_slots; j += THREADS) {  // insertion sort: a fixed sum order
    const int lo = off_s[j], hi = off_s[j + 1];
    for (int p = lo + 1; p < hi; ++p) {
      const int v = list_s[p];
      int q = p;
      for (; q > lo && list_s[q - 1] > v; --q) list_s[q] = list_s[q - 1];
      list_s[q] = v;
    }
  }
  __syncthreads();
}

// Kernel F. Grid (G, ceil(h / HC)).
template <int L>
__global__ void __launch_bounds__(THREADS)
vec_agg_fwd_kernel(const float* __restrict__ vec, const float* __restrict__ s1, int64_t s1_stride,
                   const float* __restrict__ s2m, const float* __restrict__ d,
                   const int64_t* __restrict__ idx, const bool* __restrict__ mask,
                   float* __restrict__ out, int a_slots, int k_nbrs, int h) {
  extern __shared__ float smem[];
  const int ak = a_slots * k_nbrs;
  float* vec_s = smem;                                  // [A][L][HC]
  float* d_s = vec_s + a_slots * L * HC;                // [A·K][L]
  int* idx_s = reinterpret_cast<int*>(d_s + ak * L);    // [A·K]
  const int g = blockIdx.x, c0 = blockIdx.y * HC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = c0 + lane;
  const bool live = c < h;
  const size_t row_e = static_cast<size_t>(g) * ak;
  stage_edges(idx, mask, d, row_e, ak, a_slots, L, idx_s, d_s);
  stage_chunk(vec, g, a_slots, L, h, c0, vec_s);
  __syncthreads();

  for (int i = warp; i < a_slots; i += WARPS) {
    float acc[L];
#pragma unroll
    for (int l = 0; l < L; ++l) acc[l] = 0.f;
    for (int k = 0; k < k_nbrs; ++k) {
      const int e = i * k_nbrs + k;
      const int j = idx_s[e];
      const size_t er = row_e + e;
      const float a1 = (live && j >= 0) ? s1[er * s1_stride + c] : 0.f;
      const float a2 = live ? s2m[er * h + c] : 0.f;
      const float* vj = vec_s + (j >= 0 ? j : 0) * L * HC + lane;
#pragma unroll
      for (int l = 0; l < L; ++l) acc[l] = fmaf(a1, vj[l * HC], fmaf(a2, d_s[e * L + l], acc[l]));
    }
    if (live) {
      float* o = out + (static_cast<size_t>(g) * a_slots + i) * L * h + c;
#pragma unroll
      for (int l = 0; l < L; ++l) o[static_cast<size_t>(l) * h] = acc[l];
    }
  }
}

// Kernel H. Grid (G, ceil(h / HC)).
template <int L>
__global__ void __launch_bounds__(THREADS)
wdot_fwd_kernel(const float* __restrict__ d, const float* __restrict__ u,
                const float* __restrict__ vv, const int64_t* __restrict__ idx,
                const bool* __restrict__ mask, float* __restrict__ out, int a_slots, int k_nbrs,
                int h) {
  extern __shared__ float smem[];
  const int ak = a_slots * k_nbrs;
  float* vv_s = smem;                                   // [A][L][HC]
  float* d_s = vv_s + a_slots * L * HC;                 // [A·K][L]
  int* idx_s = reinterpret_cast<int*>(d_s + ak * L);    // [A·K]
  const int g = blockIdx.x, c0 = blockIdx.y * HC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = c0 + lane;
  const bool live = c < h;
  const size_t row_e = static_cast<size_t>(g) * ak;
  stage_edges(idx, mask, d, row_e, ak, a_slots, L, idx_s, d_s);
  stage_chunk(vv, g, a_slots, L, h, c0, vv_s);
  __syncthreads();

  for (int i = warp; i < a_slots; i += WARPS) {
    float ui[L];
    const float* u_i = u + (static_cast<size_t>(g) * a_slots + i) * L * h + c;
#pragma unroll
    for (int l = 0; l < L; ++l) ui[l] = live ? u_i[static_cast<size_t>(l) * h] : 0.f;
    for (int k = 0; k < k_nbrs; ++k) {
      const int e = i * k_nbrs + k;
      const int j = idx_s[e];
      const float* vj = vv_s + (j >= 0 ? j : 0) * L * HC + lane;
      float uv = 0.f, vd = 0.f, ud = 0.f, dd = 0.f;
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const float dl = d_s[e * L + l];
        const float v = j >= 0 ? vj[l * HC] : 0.f;
        uv = fmaf(ui[l], v, uv);
        vd = fmaf(dl, v, vd);
        ud = fmaf(ui[l], dl, ud);
        dd = fmaf(dl, dl, dd);
      }
      if (live) out[(row_e + e) * h + c] = uv - ud * vd * (2.f - dd);
    }
  }
}

// Kernel G: one block per row g, looping over the h chunks.
template <int L>
__global__ void __launch_bounds__(THREADS)
vec_agg_bwd_kernel(const float* __restrict__ vec, const float* __restrict__ s1, int64_t s1_stride,
                   const float* __restrict__ s2m, const float* __restrict__ d,
                   const int64_t* __restrict__ idx, const bool* __restrict__ mask,
                   const float* __restrict__ gva, float* __restrict__ dvec,
                   float* __restrict__ ds1, float* __restrict__ ds2m, float* __restrict__ dd,
                   int a_slots, int k_nbrs, int h) {
  constexpr int P = pow2_ceil(L);
  constexpr int SPAN = 32 / P;  // lanes that end up holding each sum
  extern __shared__ float smem[];
  const int ak = a_slots * k_nbrs;
  float* vec_s = smem;                                  // [A][L][HC]
  float* g_s = vec_s + a_slots * L * HC;                // [A][L][HC]
  float* d_s = g_s + a_slots * L * HC;                  // [A·K][L]
  float* dd_s = d_s + ak * L;                           // [A·K][L]
  int* idx_s = reinterpret_cast<int*>(dd_s + ak * L);   // [A·K]
  int* off_s = idx_s + ak;                              // [A + 1]
  int* cur_s = off_s + a_slots + 1;                     // [A]
  int* list_s = cur_s + a_slots;                        // [A·K]
  const int g = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t row_e = static_cast<size_t>(g) * ak;
  stage_edges(idx, mask, d, row_e, ak, a_slots, L, idx_s, d_s);
  for (int t = threadIdx.x; t < ak * L; t += THREADS) dd_s[t] = 0.f;
  __syncthreads();
  build_source_lists(idx_s, ak, a_slots, off_s, cur_s, list_s);

  for (int c0 = 0; c0 < h; c0 += HC) {
    const int c = c0 + lane;
    const bool live = c < h;
    stage_chunk(vec, g, a_slots, L, h, c0, vec_s);
    stage_chunk(gva, g, a_slots, L, h, c0, g_s);
    __syncthreads();

    // per edge (i, k): ds1, ds2m and this chunk's terms of dd
    for (int i = warp; i < a_slots; i += WARPS) {
      float gi[L];
#pragma unroll
      for (int l = 0; l < L; ++l) gi[l] = g_s[(i * L + l) * HC + lane];
      for (int k = 0; k < k_nbrs; ++k) {
        const int e = i * k_nbrs + k;
        const int j = idx_s[e];
        const size_t er = row_e + e;
        const float a2 = live ? s2m[er * h + c] : 0.f;
        const float* vj = vec_s + (j >= 0 ? j : 0) * L * HC + lane;
        float t1 = 0.f, t2 = 0.f, part[P];
#pragma unroll
        for (int l = 0; l < L; ++l) {
          t1 = fmaf(vj[l * HC], gi[l], t1);
          t2 = fmaf(d_s[e * L + l], gi[l], t2);
          part[l] = a2 * gi[l];
        }
#pragma unroll
        for (int l = L; l < P; ++l) part[l] = 0.f;
        if (live) {
          ds1[er * h + c] = j >= 0 ? t1 : 0.f;
          ds2m[er * h + c] = t2;
        }
        const float r = warp_sum_many<P>(part, lane);
        const int l = lane / SPAN;
        if (lane % SPAN == 0 && l < L) dd_s[e * L + l] += r;
      }
    }

    // dvec[j] = Σ over the edges whose source is j of s1·g_va[i]
    for (int j = warp; j < a_slots; j += WARPS) {
      float acc[L];
#pragma unroll
      for (int l = 0; l < L; ++l) acc[l] = 0.f;
      for (int p = off_s[j]; p < off_s[j + 1]; ++p) {
        const int e = list_s[p];
        const int i = e / k_nbrs;
        const float a1 = live ? s1[(row_e + e) * s1_stride + c] : 0.f;
#pragma unroll
        for (int l = 0; l < L; ++l) acc[l] = fmaf(a1, g_s[(i * L + l) * HC + lane], acc[l]);
      }
      if (live) {
        float* o = dvec + (static_cast<size_t>(g) * a_slots + j) * L * h + c;
#pragma unroll
        for (int l = 0; l < L; ++l) o[static_cast<size_t>(l) * h] = acc[l];
      }
    }
    __syncthreads();  // the chunk's staged tensors are read no more
  }
  for (int t = threadIdx.x; t < ak * L; t += THREADS) dd[row_e * L + t] = dd_s[t];
}

// Kernel I: one block per row g, looping over the h chunks.
template <int L>
__global__ void __launch_bounds__(THREADS)
wdot_bwd_kernel(const float* __restrict__ d, const float* __restrict__ u,
                const float* __restrict__ vv, const int64_t* __restrict__ idx,
                const bool* __restrict__ mask, const float* __restrict__ gw,
                float* __restrict__ du, float* __restrict__ dvv, float* __restrict__ dd,
                int a_slots, int k_nbrs, int h) {
  constexpr int P = pow2_ceil(L + 1);  // the L sums of dd's first two terms, and g_dd
  constexpr int SPAN = 32 / P;
  extern __shared__ float smem[];
  const int ak = a_slots * k_nbrs;
  float* vv_s = smem;                                   // [A][L][HC]
  float* u_s = vv_s + a_slots * L * HC;                 // [A][L][HC]
  float* d_s = u_s + a_slots * L * HC;                  // [A·K][L]
  float* ddp_s = d_s + ak * L;                          // [A·K][L]
  float* gdd_s = ddp_s + ak * L;                        // [A·K]
  int* idx_s = reinterpret_cast<int*>(gdd_s + ak);      // [A·K]
  int* off_s = idx_s + ak;                              // [A + 1]
  int* cur_s = off_s + a_slots + 1;                     // [A]
  int* list_s = cur_s + a_slots;                        // [A·K]
  const int g = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t row_e = static_cast<size_t>(g) * ak;
  stage_edges(idx, mask, d, row_e, ak, a_slots, L, idx_s, d_s);
  for (int t = threadIdx.x; t < ak * L; t += THREADS) ddp_s[t] = 0.f;
  for (int t = threadIdx.x; t < ak; t += THREADS) gdd_s[t] = 0.f;
  __syncthreads();
  build_source_lists(idx_s, ak, a_slots, off_s, cur_s, list_s);

  for (int c0 = 0; c0 < h; c0 += HC) {
    const int c = c0 + lane;
    const bool live = c < h;
    stage_chunk(vv, g, a_slots, L, h, c0, vv_s);
    stage_chunk(u, g, a_slots, L, h, c0, u_s);
    __syncthreads();

    // per target slot i: du, and this chunk's terms of dd
    for (int i = warp; i < a_slots; i += WARPS) {
      float ui[L], dui[L];
#pragma unroll
      for (int l = 0; l < L; ++l) {
        ui[l] = u_s[(i * L + l) * HC + lane];
        dui[l] = 0.f;
      }
      for (int k = 0; k < k_nbrs; ++k) {
        const int e = i * k_nbrs + k;
        const int j = idx_s[e];
        // a masked edge (vv_j = 0) adds nothing to du or dd: skip it, and
        // its gw row with it (j is the same for the whole warp)
        if (j < 0) continue;
        const float gwv = live ? gw[(row_e + e) * h + c] : 0.f;
        const float* vj = vv_s + j * L * HC + lane;
        float vjl[L], vd = 0.f, ud = 0.f, dde = 0.f;
#pragma unroll
        for (int l = 0; l < L; ++l) {
          const float dl = d_s[e * L + l];
          vjl[l] = vj[l * HC];
          vd = fmaf(dl, vjl[l], vd);
          ud = fmaf(ui[l], dl, ud);
          dde = fmaf(dl, dl, dde);
        }
        const float t = 2.f - dde;
        const float dud = -gwv * vd * t, dvd = -gwv * ud * t;
        float part[P];
#pragma unroll
        for (int l = 0; l < L; ++l) {
          dui[l] = fmaf(gwv, vjl[l], fmaf(dud, d_s[e * L + l], dui[l]));
          part[l] = fmaf(dvd, vjl[l], dud * ui[l]);
        }
        part[L] = gwv * ud * vd;
#pragma unroll
        for (int l = L + 1; l < P; ++l) part[l] = 0.f;
        const float r = warp_sum_many<P>(part, lane);
        const int l = lane / SPAN;
        if (lane % SPAN == 0) {
          if (l < L) ddp_s[e * L + l] += r;
          else if (l == L) gdd_s[e] += r;
        }
      }
      if (live) {
        float* o = du + (static_cast<size_t>(g) * a_slots + i) * L * h + c;
#pragma unroll
        for (int l = 0; l < L; ++l) o[static_cast<size_t>(l) * h] = dui[l];
      }
    }

    // dvv[j] = Σ over the edges whose source is j of gw·u[i] + dvd·d
    for (int j = warp; j < a_slots; j += WARPS) {
      float acc[L];
#pragma unroll
      for (int l = 0; l < L; ++l) acc[l] = 0.f;
      for (int p = off_s[j]; p < off_s[j + 1]; ++p) {
        const int e = list_s[p];
        const int i = e / k_nbrs;
        const float gwv = live ? gw[(row_e + e) * h + c] : 0.f;
        float ud = 0.f, dde = 0.f;
#pragma unroll
        for (int l = 0; l < L; ++l) {
          const float dl = d_s[e * L + l];
          ud = fmaf(u_s[(i * L + l) * HC + lane], dl, ud);
          dde = fmaf(dl, dl, dde);
        }
        const float dvd = -gwv * ud * (2.f - dde);
#pragma unroll
        for (int l = 0; l < L; ++l)
          acc[l] = fmaf(gwv, u_s[(i * L + l) * HC + lane], fmaf(dvd, d_s[e * L + l], acc[l]));
      }
      if (live) {
        float* o = dvv + (static_cast<size_t>(g) * a_slots + j) * L * h + c;
#pragma unroll
        for (int l = 0; l < L; ++l) o[static_cast<size_t>(l) * h] = acc[l];
      }
    }
    __syncthreads();
  }
  for (int t = threadIdx.x; t < ak * L; t += THREADS)
    dd[row_e * L + t] = fmaf(2.f * d_s[t], gdd_s[t / L], ddp_s[t]);
}

// Dynamic shared memory of a block. It grows with the slot axis A: at
// L = 8, k = 17 a block of G takes A ≤ 70 and one of I A ≤ 69 within the
// 227 KB a Hopper block may use (F and H A ≤ 142).
size_t fwd_smem(int a_slots, int k_nbrs, int L) {
  const size_t ak = static_cast<size_t>(a_slots) * k_nbrs;
  return (static_cast<size_t>(a_slots) * L * HC + ak * L) * sizeof(float) + ak * sizeof(int);
}

// G (extra = 0) and I (extra = 1: the g_dd sums).
size_t bwd_smem(int a_slots, int k_nbrs, int L, int extra) {
  const size_t ak = static_cast<size_t>(a_slots) * k_nbrs;
  return (2 * static_cast<size_t>(a_slots) * L * HC + 2 * ak * L + extra * ak) * sizeof(float) +
         (2 * ak + 2 * static_cast<size_t>(a_slots) + 1) * sizeof(int);
}

// Lets `kernel` take `smem` bytes of dynamic shared memory. A refusal (the
// row's slots do not fit a block) is returned and cleared, so that no later
// launch, ours or PyTorch's, reports it as its own.
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

bool bad_l(int L) { return L != 3 && L != 8; }

}  // namespace

extern "C" int vis_vec_agg_fwd_f32(const float* vec, const float* s1, int64_t s1_stride,
                                   const float* s2m, const float* d, const int64_t* idx,
                                   const bool* mask, float* out, int g_rows, int a_slots,
                                   int k_nbrs, int L, int h, cudaStream_t stream) {
  if (bad_l(L)) return static_cast<int>(cudaErrorInvalidValue);
  if (g_rows <= 0 || a_slots <= 0 || h <= 0) return 0;  // an empty output
  const dim3 grid(g_rows, (h + HC - 1) / HC);
  const size_t smem = fwd_smem(a_slots, k_nbrs, L);
  auto kernel = L == 8 ? vec_agg_fwd_kernel<8> : vec_agg_fwd_kernel<3>;
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, THREADS, smem, stream>>>(vec, s1, s1_stride, s2m, d, idx, mask, out, a_slots,
                                          k_nbrs, h);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vis_wdot_fwd_f32(const float* d, const float* u, const float* vv,
                                const int64_t* idx, const bool* mask, float* out, int g_rows,
                                int a_slots, int k_nbrs, int L, int h, cudaStream_t stream) {
  if (bad_l(L)) return static_cast<int>(cudaErrorInvalidValue);
  if (g_rows <= 0 || a_slots <= 0 || k_nbrs <= 0 || h <= 0) return 0;
  const dim3 grid(g_rows, (h + HC - 1) / HC);
  const size_t smem = fwd_smem(a_slots, k_nbrs, L);
  auto kernel = L == 8 ? wdot_fwd_kernel<8> : wdot_fwd_kernel<3>;
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, THREADS, smem, stream>>>(d, u, vv, idx, mask, out, a_slots, k_nbrs, h);
  return static_cast<int>(cudaGetLastError());
}

// Writes dvec [G, A, L, h], ds1 and ds2m [G, A, K, h] (contiguous) and
// dd [G, A, K, L] for the output gradient gva [G, A, L, h].
extern "C" int vis_vec_agg_bwd_f32(const float* vec, const float* s1, int64_t s1_stride,
                                   const float* s2m, const float* d, const int64_t* idx,
                                   const bool* mask, const float* gva, float* dvec, float* ds1,
                                   float* ds2m, float* dd, int g_rows, int a_slots, int k_nbrs,
                                   int L, int h, cudaStream_t stream) {
  if (bad_l(L)) return static_cast<int>(cudaErrorInvalidValue);
  if (g_rows <= 0 || a_slots <= 0) return 0;
  if (h <= 0) {  // no columns: dd sums nothing
    const size_t n = static_cast<size_t>(g_rows) * a_slots * k_nbrs * L;
    return static_cast<int>(n ? cudaMemsetAsync(dd, 0, n * sizeof(float), stream) : cudaSuccess);
  }
  const size_t smem = bwd_smem(a_slots, k_nbrs, L, 0);
  auto kernel = L == 8 ? vec_agg_bwd_kernel<8> : vec_agg_bwd_kernel<3>;
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<g_rows, THREADS, smem, stream>>>(vec, s1, s1_stride, s2m, d, idx, mask, gva, dvec, ds1,
                                            ds2m, dd, a_slots, k_nbrs, h);
  return static_cast<int>(cudaGetLastError());
}

// Writes du, dvv [G, A, L, h] and dd [G, A, K, L] for the output gradient
// gw [G, A, K, h].
extern "C" int vis_wdot_bwd_f32(const float* d, const float* u, const float* vv,
                                const int64_t* idx, const bool* mask, const float* gw, float* du,
                                float* dvv, float* dd, int g_rows, int a_slots, int k_nbrs, int L,
                                int h, cudaStream_t stream) {
  if (bad_l(L)) return static_cast<int>(cudaErrorInvalidValue);
  if (g_rows <= 0 || a_slots <= 0) return 0;
  if (h <= 0) {
    const size_t n = static_cast<size_t>(g_rows) * a_slots * k_nbrs * L;
    return static_cast<int>(n ? cudaMemsetAsync(dd, 0, n * sizeof(float), stream) : cudaSuccess);
  }
  const size_t smem = bwd_smem(a_slots, k_nbrs, L, 1);
  auto kernel = L == 8 ? wdot_bwd_kernel<8> : wdot_bwd_kernel<3>;
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<g_rows, THREADS, smem, stream>>>(d, u, vv, idx, mask, gw, du, dvv, dd, a_slots, k_nbrs,
                                            h);
  return static_cast<int>(cudaGetLastError());
}
