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
// Every block owns one molecule row g and a chunk of HC = 32 columns of h,
// one column per lane; warp w of 16 takes the target slots i ≡ w (mod 16)
// and, per edge (i, k), reads s1/s2m/gw rows with coalesced 128-byte loads.
// The gathers by slot index (vec[j], vv[j], gva[i], u[i]) read the chunk
// staged in shared memory where it fits: the TPU kernels' one-hot matmuls
// (`_block_onehot`) and their edge-k-major transposes are not carried over.
//
// F and H run a block a row and chunk, each staging the neighbour side of
// its chunk, vec or vv [A][L][HC] (32 KB at A = 32), and the row's d and
// indices; at L = 8, k = 17 that takes A ≤ 142 (227 KB a block). F's grid
// is (G, h / 32).
// H (redesigned for Hopper) runs G · h / 32 blocks with the chunk the
// fastest index, so that a row's 8 chunk blocks run together: its d and
// indices (22 KB at A = 32) come from device memory once and from L2 seven
// times, where 8 blocks ~G apart read them 8 times from device memory. The
// vv chunk and the row's d are copied by cp.async while the indices load
// and each warp loads its first slot's u. A masked edge (56 % at batch
// 768) writes +0 and reads neither d nor vv. w_dot (428 MB, half of H's
// bytes) leaves in streaming stores.
//
// G and I (redesigned for Hopper) need two things the TPU grid got from
// running in order.
// (1) dd sums over all of h. The row's h / 32 chunks run as one thread-block
// cluster of CL = min(h / 32, 8) blocks, rank r taking the chunks r, r + CL,
// ... (one each at h ≤ 256). Each block keeps its chunk's terms of dd
// [A·K][L] in its shared memory: the 32 lanes' terms of an edge's L sums
// are added by one butterfly that reduces all of them at once
// (`warp_sum_many`: 9 shuffles for 8 values instead of 40). After
// `cluster.sync()` each rank sums 1/CL of the row's dd over the CL ranks'
// shared memory (distributed shared memory), in rank order, and writes it:
// no workspace, no second launch, no atomics, the same bits every run.
// (2) dvec and dvv scatter onto the source slot j. Per row the block lists,
// for each j, the masked-in edges (i, k) whose source is j, in ascending
// order (by warp ballots: no atomics, no sort); the warp that owns j sums
// its list (the per-source walk), loading a few edges' rows ahead.
// A block copies the row's d [A·K][L] and its staged chunks into shared
// memory by cp.async, in flight while the indices load and the lists are
// built.
//
// G: the target pass (ds1, ds2m, dd) gathers vec[j], the walk (dvec) gva[i]
// and reads s1. With `STAGE` the chunks of vec and gva are staged (103 KB
// at A = 32: two blocks an SM; A ≤ 70 at L = 8, k = 17); above that the
// gathers read device memory (L2), 32 lanes a 128-byte row.
// I: the target pass computes du, the walk dvv and dd, with Σ_c gw·ud·vd
// folded into the L sums (8 values a butterfly, not 9 in 16), and 2 − |d|²
// computed once an edge. The live gw rows of the chunk are copied into
// shared memory once, by their edges' places in the lists, as many as the
// shared memory left for two blocks an SM takes (409 of 544 at A = 32; a
// block that takes more than one chunk keeps none): both passes read them
// there, and the walk leaves each edge's terms of dd in its gw's place. With
// `STAGE` (A ≤ 97) vv's chunk is staged for the target pass and u's in its
// place for the walk; above that both are gathered from device memory.
// G and I take the rows F and H take (A ≤ 142 at L = 8, k = 17) and refuse
// the others.
//
// Contract: every index lies in [0, A), as `knn_dense` gives them; one
// outside that range counts as a masked edge (the wrapper does not check,
// which would cost a device-to-host sync).
//
// bf16 (`*_bf16` entries): the function of the TPU kernels' bf16 calls,
// which JAX's ViSNet runs below f32. Every tensor is bf16; each is read,
// widened to f32, and every product and sum is f32, unfused (__fmul_rn,
// __fadd_rn) and in the order of the TPU kernels' bodies, so that the
// plain version computes the same bits; each output is rounded once to
// bf16. G's dvecj = s1·gva[i] and I's dvvj = gw·u[i] + dvd·d are rounded to
// bf16 before their f32 sum over the edges that share a source (the TPU's
// one-hot matmul takes bf16 operands); dd is summed over all of h in f32
// and rounded once. The f32 kernels above are kept apart, so that their
// code is what it was. The bf16 kernels take a chunk of HC2 = 64 columns, a
// pair a lane: a warp reads a 128-byte row as bf16 pairs, as the f32
// kernels read 32 floats. The staged chunks and the row's d are bf16; the
// sums of dd stay f32. At L = 8, k = 17 a block of F or H holds a row of
// A ≤ 170 slots (1,364 bytes a slot), and G and I take the same rows. F and
// H in bf16 keep the designs of F and H.
//
// G and I in bf16 (redesigned for Hopper; they replace `_vec_agg_bwd` and
// `_wdot_bwd`, bodies `_agg_bwd_kernel` and `_wdot_bwd_kernel`) keep the f32
// G's and I's clusters, source lists and dd sums, and run two 16-warp
// blocks an SM (at most 64 registers a thread: a lane keeps the bf16 pairs
// it loads as 32 bits and widens them where it uses them), so that one
// block's setup (the row's d, indices, lists and copies) runs while the
// other computes. Bound at the batch-768 shapes (G = 769, A = 32, K = 17,
// L = 8, h = 256): bytes, G 1.06 GB (0.315 ms at 3.35 TB/s), I 0.52 GB
// (0.154 ms). What sets their pace is instruction throughput: the unfused
// f32 arithmetic for 2 columns a lane, the widening, the bf16 roundings and
// the butterflies: by a count of this source some 500 instructions a live
// edge and warp in I (its walk, which also spills at 64 registers, takes
// most of them) and some 180 an edge in G.
// G: the target pass takes the warp's edges as one stream, the s2m pairs of
// the next AHEAD_GB = 4 edges in flight across its slots; the walk loads
// the s1 pairs of 4 edges of a list at a time. It stages vec and gva up to
// A = 77.
// I: the live gw rows of the chunk are copied into shared memory once, by
// the edge's place among the row's live edges (`live_places`), by cp.async
// started before the lists are built; at A = 32 two blocks an SM keep 499
// places of 544, more than the model's rows have live. Both passes read
// them there, so gw comes from device memory once, and the walk leaves
// each edge's terms of dd in its row's place. It stages vv, then u, up to
// A = 109; the walk reads its source's vv row from device memory, once a
// source with edges.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tf32_mma.cuh"  // cp_async, set_smem, MAX_SMEM

namespace cg = cooperative_groups;

namespace {

constexpr int HC = 32;  // h columns per chunk: one per lane
constexpr int WARPS = 16;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_CLUSTER = 8;  // the portable cluster size
constexpr int AHEAD_G = 8;  // edges whose rows a warp of G loads before it uses them
constexpr int AHEAD_I = 2;  // and of I
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

// n rounded up to a multiple of 4 (floats: 16 bytes).
__host__ __device__ constexpr int pad4(int n) { return (n + 3) & ~3; }

// The row's neighbour indices, -1 where masked or out of range.
__device__ __forceinline__ void load_idx(const int64_t* __restrict__ idx,
                                         const bool* __restrict__ mask, size_t row_e, int ak,
                                         int a_slots, int* idx_s) {
  for (int e = threadIdx.x; e < ak; e += THREADS) {
    const int64_t j = idx[row_e + e];
    idx_s[e] = (mask[row_e + e] && j >= 0 && j < a_slots) ? static_cast<int>(j) : -1;
  }
}

// An edge's L values of d from the row's d staged in shared memory (16-byte
// aligned): two 16-byte loads where L = 8.
template <int L>
__device__ __forceinline__ void load_d(const float* de, float (&dl)[L]) {
  if constexpr (L == 8) {
    const float4 a = reinterpret_cast<const float4*>(de)[0];
    const float4 b = reinterpret_cast<const float4*>(de)[1];
    dl[0] = a.x, dl[1] = a.y, dl[2] = a.z, dl[3] = a.w;
    dl[4] = b.x, dl[5] = b.y, dl[6] = b.z, dl[7] = b.w;
  } else {
#pragma unroll
    for (int l = 0; l < L; ++l) dl[l] = de[l];
  }
}

// n contiguous floats from src into x_s by cp.async (committed by the
// caller): 16-byte copies where both ends allow (`vec4`), else 4-byte ones.
__device__ __forceinline__ void stage_row_async(const float* __restrict__ src, int n, bool vec4,
                                                float* x_s) {
  const int n4 = vec4 ? n / 4 : 0;
  for (int t = threadIdx.x; t < n4; t += THREADS) cp_async<16>(x_s + 4 * t, src + 4 * t, true);
  for (int t = 4 * n4 + threadIdx.x; t < n; t += THREADS) cp_async<4>(x_s + t, src + t, true);
}

// The row's neighbour indices and its d [A·K][L], staged in shared memory.
__device__ __forceinline__ void stage_edges(const int64_t* __restrict__ idx,
                                            const bool* __restrict__ mask,
                                            const float* __restrict__ d, size_t row_e, int ak,
                                            int a_slots, int L, int* idx_s, float* d_s) {
  load_idx(idx, mask, row_e, ak, a_slots, idx_s);
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

// The same by cp.async (committed by the caller): 16-byte copies where the
// rows are 16-byte aligned (`vec4`), else 4-byte ones.
__device__ __forceinline__ void stage_chunk_async(const float* __restrict__ x, int g,
                                                  int a_slots, int L, int h, int c0, bool vec4,
                                                  float* x_s) {
  const size_t base = static_cast<size_t>(g) * a_slots * L;
  if (vec4) {
    for (int t = threadIdx.x; t < a_slots * L * HC / 4; t += THREADS) {
      const int cc = (t % (HC / 4)) * 4, al = t / (HC / 4);
      const bool ok = c0 + cc < h;
      cp_async<16>(x_s + al * HC + cc, ok ? x + (base + al) * h + c0 + cc : x, ok);
    }
  } else {
    for (int t = threadIdx.x; t < a_slots * L * HC; t += THREADS) {
      const int cc = t % HC, al = t / HC;
      const bool ok = c0 + cc < h;
      cp_async<4>(x_s + t, ok ? x + (base + al) * h + c0 + cc : x, ok);
    }
  }
}

// For each source slot j, the row's masked-in edges e = i·K + k with
// idx = j, ascending, as (i << 16) | e (A·K < 2^16 for any row F and H
// take): list_s[off_s[j] .. off_s[j + 1]). Warp w takes the slots
// j ≡ w (mod WARPS) and finds their edges by ballots over 32 edges at a
// time, U of them in flight: each list comes out in order, with no atomics
// and no sort.
__device__ void build_source_lists(const int* idx_s, int ak, int a_slots, int k_nbrs, int* off_s,
                                   int* list_s) {
  constexpr int U = 4;  // 32-edge groups a ballot round takes: U independent ballots
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = warp; j < a_slots; j += WARPS) {
    int n = 0;
    for (int e0 = lane; e0 - lane < ak; e0 += 32 * U) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + 32 * u;
        n += __popc(__ballot_sync(FULL, e < ak && idx_s[e] == j));
      }
    }
    if (lane == 0) off_s[j + 1] = n;
  }
  if (threadIdx.x == 0) off_s[0] = 0;
  __syncthreads();
  if (warp == 0) {  // the counts' running sums, 32 slots at a time
    int carry = 0;
    for (int j = 1 + lane; j - lane <= a_slots; j += 32) {
      int v = j <= a_slots ? off_s[j] : 0;
#pragma unroll
      for (int o = 1; o < 32; o *= 2) {
        const int y = __shfl_up_sync(FULL, v, o);
        if (lane >= o) v += y;
      }
      if (j <= a_slots) off_s[j] = v + carry;
      carry += __shfl_sync(FULL, v, 31);
    }
  }
  __syncthreads();
  for (int j = warp; j < a_slots; j += WARPS) {
    int at = off_s[j];
    for (int e0 = lane; e0 - lane < ak; e0 += 32 * U) {
      bool hit[U];
      unsigned b[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + 32 * u;
        hit[u] = e < ak && idx_s[e] == j;
        b[u] = __ballot_sync(FULL, hit[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + 32 * u;
        if (hit[u]) list_s[at + __popc(b[u] & ((1u << lane) - 1))] = (e / k_nbrs) << 16 | e;
        at += __popc(b[u]);
      }
    }
  }
  __syncthreads();
}

// Each rank of the row's cluster sums its share of the row's dd entries t
// over the ranks' partial sums (at `part` + at(t) in each rank's shared
// memory, at(t) < 0 for a term that is 0), in rank order, and writes them
// (rounded once where `out` is bf16).
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename At, typename Out>
__device__ __forceinline__ void cluster_dd_sum(cg::cluster_group& cluster, const float* part,
                                               At at, int n, Out* __restrict__ out) {
  const int cl = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  cluster.sync();  // every rank's partial sums are complete
  const int lo = static_cast<int>(static_cast<int64_t>(n) * rank / cl);
  const int hi = static_cast<int>(static_cast<int64_t>(n) * (rank + 1) / cl);
  for (int t = lo + static_cast<int>(threadIdx.x); t < hi; t += THREADS) {
    const int src = at(t);
    float s = 0.f;
    if (src >= 0)
      for (int q = 0; q < cl; ++q) s += cluster.map_shared_rank(part, q)[src];
    put(out + t, s);
  }
  cluster.sync();  // no rank leaves while another reads its shared memory
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

// Kernel H. Grid G · ceil(h / HC) blocks, the chunk the fastest index. A
// masked edge writes +0: the value of uv − ud·vd·(2 − |d|²) with vv_j = 0,
// for finite u and d (the plain version's and JAX's).
template <int L>
__global__ void __launch_bounds__(THREADS)
wdot_fwd_kernel(const float* __restrict__ d, const float* __restrict__ u,
                const float* __restrict__ vv, const int64_t* __restrict__ idx,
                const bool* __restrict__ mask, float* __restrict__ out, int g_rows, int a_slots,
                int k_nbrs, int h, bool vec4, bool d4) {
  extern __shared__ __align__(16) float smem[];
  const int ak = a_slots * k_nbrs;
  float* vv_s = smem;                                   // [A][L][HC]
  float* d_s = vv_s + a_slots * L * HC;                 // [A·K][L]
  int* idx_s = reinterpret_cast<int*>(d_s + ak * L);    // [A·K]
  const int n_chunks = (h + HC - 1) / HC;
  const int g = blockIdx.x / n_chunks, c0 = blockIdx.x % n_chunks * HC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = c0 + lane;
  const bool live = c < h;
  const size_t row_e = static_cast<size_t>(g) * ak;
  const float* d_row = d + row_e * L;
  stage_chunk_async(vv, g, a_slots, L, h, c0, vec4, vv_s);
  stage_row_async(d_row, ak * L, d4, d_s);
  cp_async_commit();
  load_idx(idx, mask, row_e, ak, a_slots, idx_s);
  const float* u_row = u + static_cast<size_t>(g) * a_slots * L * h + c;
  float ui[L];
#pragma unroll
  for (int l = 0; l < L; ++l) ui[l] = live && warp < a_slots ? u_row[(warp * L + l) * h] : 0.f;
  cp_async_wait_all();
  __syncthreads();

  for (int i = warp; i < a_slots; i += WARPS) {
    if (i != warp) {
#pragma unroll
      for (int l = 0; l < L; ++l) ui[l] = live ? u_row[(static_cast<size_t>(i) * L + l) * h] : 0.f;
    }
    float* o = out + (row_e + i * k_nbrs) * h + c;
    for (int k = 0; k < k_nbrs; ++k) {
      const int e = i * k_nbrs + k;
      const int j = idx_s[e];
      float w = 0.f;
      if (j >= 0) {  // the same for the whole warp
        float dl[L];
        load_d<L>(d_s + e * L, dl);
        // (the selects on j, free here, keep the loop right without the branch)
        const float* vj = vv_s + (j >= 0 ? j : 0) * L * HC + lane;
        float uv = 0.f, vd = 0.f, ud = 0.f, dd = 0.f;
#pragma unroll
        for (int l = 0; l < L; ++l) {
          const float v = j >= 0 ? vj[l * HC] : 0.f;
          uv = fmaf(ui[l], v, uv);
          vd = fmaf(dl[l], v, vd);
          ud = fmaf(ui[l], dl[l], ud);
          dd = fmaf(dl[l], dl[l], dd);
        }
        w = uv - ud * vd * (2.f - dd);
      }
      if (live) __stcs(o + static_cast<size_t>(k) * h, w);
    }
  }
}

// Kernel G. Grid (G · CL) in clusters of CL blocks, one cluster per row g.
// STAGE: vec and gva of the block's chunk in shared memory (else gathered
// from device memory).
template <int L, bool STAGE>
__global__ void __launch_bounds__(THREADS, 2)
vec_agg_bwd_kernel(const float* __restrict__ vec, const float* __restrict__ s1, int64_t s1_stride,
                   const float* __restrict__ s2m, const float* __restrict__ d,
                   const int64_t* __restrict__ idx, const bool* __restrict__ mask,
                   const float* __restrict__ gva, float* __restrict__ dvec,
                   float* __restrict__ ds1, float* __restrict__ ds2m, float* __restrict__ dd,
                   int a_slots, int k_nbrs, int h, bool vec4, bool d4) {
  constexpr int P = pow2_ceil(L);
  constexpr int SPAN = 32 / P;  // lanes that end up holding each sum
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  extern __shared__ __align__(16) float smem[];
  const int ak = a_slots * k_nbrs;
  const int staged = STAGE ? a_slots * L * HC : 0;
  float* vec_s = smem;                                  // [A][L][HC] (STAGE)
  float* g_s = vec_s + staged;                          // [A][L][HC] (STAGE)
  float* d_s = g_s + staged;                            // [A·K][L] the row's d
  float* dd_s = d_s + ak * L;                           // [A·K][L] this block's terms of dd
  int* idx_s = reinterpret_cast<int*>(dd_s + ak * L);   // [A·K]
  int* off_s = idx_s + ak;                              // [A + 1]
  int* list_s = off_s + a_slots + 1;                    // [A·K]
  const int g = blockIdx.x / cl;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_chunks = (h + HC - 1) / HC;
  const size_t row_e = static_cast<size_t>(g) * ak;
  const size_t row_v = static_cast<size_t>(g) * a_slots * L;  // first [h] row of vec, gva
  // the copies fly while the lists are built
  stage_row_async(d + row_e * L, ak * L, d4, d_s);
  if constexpr (STAGE) {
    stage_chunk_async(vec, g, a_slots, L, h, rank * HC, vec4, vec_s);
    stage_chunk_async(gva, g, a_slots, L, h, rank * HC, vec4, g_s);
  }
  cp_async_commit();
  load_idx(idx, mask, row_e, ak, a_slots, idx_s);
  __syncthreads();
  build_source_lists(idx_s, ak, a_slots, k_nbrs, off_s, list_s);

  for (int n = rank; n < n_chunks; n += cl) {
    const int c = n * HC + lane;
    const bool live = c < h;
    const int cr = live ? c : h - 1;  // a column the dead lanes may read (results dropped)
    if (STAGE && n != rank) {
      stage_chunk_async(vec, g, a_slots, L, h, n * HC, vec4, vec_s);
      stage_chunk_async(gva, g, a_slots, L, h, n * HC, vec4, g_s);
      cp_async_commit();
    }
    cp_async_wait_all();
    __syncthreads();
    // element (slot, l) of this lane's column of vec / gva
    auto vec_at = [&](int s, int l) {
      if constexpr (STAGE) return vec_s[(s * L + l) * HC + lane];
      else return vec[(row_v + s * L + l) * h + cr];
    };
    auto gva_at = [&](int s, int l) {
      if constexpr (STAGE) return g_s[(s * L + l) * HC + lane];
      else return gva[(row_v + s * L + l) * h + cr];
    };

    // the target pass, per edge (i, k): ds1, ds2m and this chunk's terms of dd
    for (int i = warp; i < a_slots; i += WARPS) {
      float gi[L];
#pragma unroll
      for (int l = 0; l < L; ++l) gi[l] = gva_at(i, l);
      for (int k0 = 0; k0 < k_nbrs; k0 += AHEAD_G) {
        float a2[AHEAD_G];
#pragma unroll
        for (int q = 0; q < AHEAD_G; ++q) {
          const size_t er = row_e + i * k_nbrs + k0 + q;
          a2[q] = (live && k0 + q < k_nbrs) ? s2m[er * h + c] : 0.f;
        }
#pragma unroll
        for (int q = 0; q < AHEAD_G; ++q) {
          if (k0 + q >= k_nbrs) break;
          const int e = i * k_nbrs + k0 + q;
          const int j = idx_s[e];
          const size_t er = row_e + e;
          float dl[L], t1 = 0.f, t2 = 0.f, part[P];
          load_d<L>(d_s + e * L, dl);
#pragma unroll
          for (int l = 0; l < L; ++l) {
            t1 = fmaf(j >= 0 ? vec_at(j, l) : 0.f, gi[l], t1);
            t2 = fmaf(dl[l], gi[l], t2);
            part[l] = a2[q] * gi[l];
          }
#pragma unroll
          for (int l = L; l < P; ++l) part[l] = 0.f;
          if (live) {
            __stcs(ds1 + er * h + c, t1);
            __stcs(ds2m + er * h + c, t2);
          }
          const float r = warp_sum_many<P>(part, lane);
          const int l = lane / SPAN;
          if (lane % SPAN == 0 && l < L) dd_s[e * L + l] = n == rank ? r : dd_s[e * L + l] + r;
        }
      }
    }

    // the per-source walk: dvec[j] = Σ over the edges whose source is j of s1·gva[i]
    for (int j = warp; j < a_slots; j += WARPS) {
      float acc[L];
#pragma unroll
      for (int l = 0; l < L; ++l) acc[l] = 0.f;
      const int hi = off_s[j + 1];
      for (int p0 = off_s[j]; p0 < hi; p0 += AHEAD_G) {
        float a1[AHEAD_G];
        int ii[AHEAD_G];
#pragma unroll
        for (int q = 0; q < AHEAD_G; ++q) {
          const int v = p0 + q < hi ? list_s[p0 + q] : 0;
          ii[q] = v >> 16;
          a1[q] = (live && p0 + q < hi) ? s1[(row_e + (v & 0xffff)) * s1_stride + c] : 0.f;
        }
#pragma unroll
        for (int q = 0; q < AHEAD_G; ++q) {
          if (p0 + q >= hi) break;
#pragma unroll
          for (int l = 0; l < L; ++l) acc[l] = fmaf(a1[q], gva_at(ii[q], l), acc[l]);
        }
      }
      if (live) {
        float* o = dvec + (row_v + j * L) * h + c;
#pragma unroll
        for (int l = 0; l < L; ++l) o[static_cast<size_t>(l) * h] = acc[l];
      }
    }
    if constexpr (STAGE) __syncthreads();  // the chunk's staged tensors are read no more
  }
  cluster_dd_sum(cluster, dd_s, [](int t) { return t; }, ak * L, dd + row_e * L);
}

// Kernel I. Grid (G · CL) in clusters of CL blocks, one cluster per row g.
// STAGE: the target pass gathers vv from the block's chunk staged in shared
// memory, the walk u from the same place, restaged (else both are gathered
// from device memory). The live gw rows of the chunk are copied once into
// shared memory, [keep][HC] by the edge's place p in the source lists, for
// p < keep (a block that takes one chunk; `keep` is what the shared memory
// left for two blocks an SM allows), while the staged chunk lands; both
// passes read them there, the others from device memory, and the walk
// leaves each edge's terms of dd in its gw's place (p < keep) or in
// ddx_s [A·K − keep][L].
template <int L, bool STAGE>
__global__ void __launch_bounds__(THREADS, 2)
wdot_bwd_kernel(const float* __restrict__ d, const float* __restrict__ u,
                const float* __restrict__ vv, const int64_t* __restrict__ idx,
                const bool* __restrict__ mask, const float* __restrict__ gw,
                float* __restrict__ du, float* __restrict__ dvv, float* __restrict__ dd,
                int a_slots, int k_nbrs, int h, int keep, bool vec4, bool d4) {
  constexpr int P = pow2_ceil(L);
  constexpr int SPAN = 32 / P;
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  extern __shared__ __align__(16) float smem[];
  const int ak = a_slots * k_nbrs;
  float* x_s = smem;                                    // [A][L][HC] vv, then u (STAGE)
  float* d_s = x_s + (STAGE ? a_slots * L * HC : 0);    // [A·K][L] the row's d
  float* t_s = d_s + ak * L;                            // [A·K] 2 − |d|² of each edge
  float* gw_s = t_s + pad4(ak * (L + 1)) - ak * L;      // [keep][HC] by list place (16-byte aligned)
  float* ddx_s = gw_s + keep * HC;                      // [A·K − keep][L]
  int* idx_s = reinterpret_cast<int*>(ddx_s + (ak - keep) * L);  // [A·K]
  int* off_s = idx_s + ak;                              // [A + 1]
  int* list_s = off_s + a_slots + 1;                    // [A·K]
  int* pos_s = list_s + ak;                             // [A·K] an edge's list place, or −1
  const int g = blockIdx.x / cl;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_chunks = (h + HC - 1) / HC;
  const size_t row_e = static_cast<size_t>(g) * ak;
  const size_t row_v = static_cast<size_t>(g) * a_slots * L;
  stage_row_async(d + row_e * L, ak * L, d4, d_s);
  if constexpr (STAGE) stage_chunk_async(vv, g, a_slots, L, h, rank * HC, vec4, x_s);
  cp_async_commit();
  for (int t = threadIdx.x; t < (ak - keep) * L; t += THREADS) ddx_s[t] = 0.f;
  for (int e = threadIdx.x; e < ak; e += THREADS) pos_s[e] = -1;
  load_idx(idx, mask, row_e, ak, a_slots, idx_s);
  __syncthreads();
  build_source_lists(idx_s, ak, a_slots, k_nbrs, off_s, list_s);
  for (int p = threadIdx.x; p < off_s[a_slots]; p += THREADS) pos_s[list_s[p] & 0xffff] = p;
  if (keep > 0) {  // the kept gw rows of the chunk, by list place
    const int n_keep = off_s[a_slots] < keep ? off_s[a_slots] : keep;
    const int c0 = rank * HC;
    for (int t = threadIdx.x; t < n_keep * (vec4 ? HC / 4 : HC); t += THREADS) {
      const int per = vec4 ? HC / 4 : HC, p = t / per, cc = (t % per) * (vec4 ? 4 : 1);
      const float* src = gw + (row_e + (list_s[p] & 0xffff)) * h + c0 + cc;
      const bool ok = c0 + cc < h;
      if (vec4) cp_async<16>(gw_s + p * HC + cc, ok ? src : gw, ok);
      else cp_async<4>(gw_s + p * HC + cc, ok ? src : gw, ok);
    }
    cp_async_commit();
  }

  cp_async_wait_all();
  __syncthreads();
  for (int e = threadIdx.x; e < ak; e += THREADS) {
    float dl[L], dde = 0.f;
    load_d<L>(d_s + e * L, dl);
#pragma unroll
    for (int l = 0; l < L; ++l) dde = fmaf(dl[l], dl[l], dde);
    t_s[e] = 2.f - dde;
  }

  for (int n = rank; n < n_chunks; n += cl) {  // keep > 0: once
    const int c = n * HC + lane;
    const bool live = c < h;
    const int cr = live ? c : h - 1;  // a column the dead lanes may read (results dropped)
    if (STAGE && n != rank) {
      stage_chunk_async(vv, g, a_slots, L, h, n * HC, vec4, x_s);
      cp_async_commit();
      cp_async_wait_all();
    }
    __syncthreads();

    // the target pass: du[i] = Σ_k gw·vv[j] + dud·d, dud = −gw·vd·(2 − |d|²)
    for (int i = warp; i < a_slots; i += WARPS) {
      float dui[L];
#pragma unroll
      for (int l = 0; l < L; ++l) dui[l] = 0.f;
      for (int k0 = 0; k0 < k_nbrs; k0 += AHEAD_I) {
        float gwv[AHEAD_I];
        int jj[AHEAD_I];
#pragma unroll
        for (int q = 0; q < AHEAD_I; ++q) {
          // a masked edge (vv_j = 0) adds nothing: its gw row is not read
          const int e = i * k_nbrs + k0 + q;
          jj[q] = k0 + q < k_nbrs ? idx_s[e] : -1;
          const int p = jj[q] >= 0 ? pos_s[e] : 0;
          gwv[q] = jj[q] < 0 ? 0.f
                   : p < keep ? gw_s[p * HC + lane]
                   : live ? gw[(row_e + e) * h + c] : 0.f;
        }
#pragma unroll
        for (int q = 0; q < AHEAD_I; ++q) {
          if (jj[q] < 0) continue;  // the same for the whole warp
          const int e = i * k_nbrs + k0 + q;
          float dl[L], vjl[L], vd = 0.f;
          load_d<L>(d_s + e * L, dl);
#pragma unroll
          for (int l = 0; l < L; ++l) {
            if constexpr (STAGE) vjl[l] = x_s[(jj[q] * L + l) * HC + lane];
            else vjl[l] = vv[(row_v + jj[q] * L + l) * h + cr];
            vd = fmaf(dl[l], vjl[l], vd);
          }
          const float dud = -gwv[q] * vd * t_s[e];
#pragma unroll
          for (int l = 0; l < L; ++l) dui[l] = fmaf(gwv[q], vjl[l], fmaf(dud, dl[l], dui[l]));
        }
      }
      if (live) {
        float* o = du + (row_v + i * L) * h + c;
#pragma unroll
        for (int l = 0; l < L; ++l) o[static_cast<size_t>(l) * h] = dui[l];
      }
    }
    __syncthreads();  // vv's chunk is read no more
    if constexpr (STAGE) {  // u's chunk takes its place
      stage_chunk_async(u, g, a_slots, L, h, n * HC, vec4, x_s);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
    }

    // the per-source walk: dvv[j] = Σ over the edges whose source is j of
    // gw·u[i] + dvd·d, dvd = −gw·ud·(2 − |d|²), and each edge's terms of dd:
    // dvd·vv[j] + dud·u[i] + 2·d·gw·ud·vd
    for (int j = warp; j < a_slots; j += WARPS) {
      float vj[L], acc[L];
#pragma unroll
      for (int l = 0; l < L; ++l) {
        vj[l] = vv[(row_v + j * L + l) * h + cr];
        acc[l] = 0.f;
      }
      const int hi = off_s[j + 1];
      for (int p0 = off_s[j]; p0 < hi; p0 += AHEAD_I) {
        float gwv[AHEAD_I];
        int vq[AHEAD_I];
#pragma unroll
        for (int q = 0; q < AHEAD_I; ++q) {
          const int p = p0 + q;
          vq[q] = p < hi ? list_s[p] : 0;
          gwv[q] = p >= hi ? 0.f
                   : p < keep ? gw_s[p * HC + lane]
                   : live ? gw[(row_e + (vq[q] & 0xffff)) * h + c] : 0.f;
        }
#pragma unroll
        for (int q = 0; q < AHEAD_I; ++q) {
          const int p = p0 + q;
          if (p >= hi) break;
          const int e = vq[q] & 0xffff, i = vq[q] >> 16;
          float dl[L], ui[L], ud = 0.f, vd = 0.f;
          load_d<L>(d_s + e * L, dl);
#pragma unroll
          for (int l = 0; l < L; ++l) {
            if constexpr (STAGE) ui[l] = x_s[(i * L + l) * HC + lane];
            else ui[l] = u[(row_v + i * L + l) * h + cr];
            ud = fmaf(ui[l], dl[l], ud);
            vd = fmaf(vj[l], dl[l], vd);
          }
          const float t = t_s[e];
          const float dvd = -gwv[q] * ud * t, dud = -gwv[q] * vd * t;
          const float w = 2.f * gwv[q] * ud * vd;
          float part[P];
#pragma unroll
          for (int l = 0; l < L; ++l) {
            acc[l] = fmaf(gwv[q], ui[l], fmaf(dvd, dl[l], acc[l]));
            part[l] = fmaf(dvd, vj[l], fmaf(dud, ui[l], w * dl[l]));
          }
#pragma unroll
          for (int l = L; l < P; ++l) part[l] = 0.f;
          const float r = warp_sum_many<P>(part, lane);
          const int l = lane / SPAN;
          __syncwarp();  // every lane has read its gw_s element of this edge
          if (lane % SPAN == 0 && l < L) {
            if (p < keep) gw_s[p * HC + l] = r;
            else ddx_s[(p - keep) * L + l] += r;
          }
        }
      }
      if (live) {
        float* o = dvv + (row_v + j * L) * h + c;
#pragma unroll
        for (int l = 0; l < L; ++l) o[static_cast<size_t>(l) * h] = acc[l];
      }
    }
    if constexpr (STAGE) __syncthreads();  // u's chunk is read no more
  }
  // dd's terms of edge e at its list place p, from gw_s (the same offsets
  // in every rank's shared memory)
  cluster_dd_sum(cluster, gw_s, [&](int t) {
    const int p = pos_s[t / L];
    return p < 0 ? -1 : p < keep ? p * HC + t % L : keep * HC + (p - keep) * L + t % L;
  }, ak * L, dd + row_e * L);
}

// ------------------------------------------------------------------ bf16

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

constexpr int HC2 = 64;  // bf16 columns a chunk: a pair a lane
constexpr int AHEAD_GB = 4;  // edges whose rows a warp of G in bf16 loads before it uses them

__host__ __device__ constexpr size_t pad16(size_t n) { return (n + 15) & ~static_cast<size_t>(15); }

// Bytes of one [A][L][HC2] bf16 chunk.
__host__ __device__ constexpr size_t chunk_bytes(int a_slots, int L) {
  return static_cast<size_t>(a_slots) * L * HC2 * sizeof(bf16);
}

__device__ __forceinline__ float2 ld_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const bf162*>(p));
}

__device__ __forceinline__ void st_pair(bf16* p, float x, float y) {
  *reinterpret_cast<bf162*>(p) = __floats2bfloat162_rn(x, y);
}

// x rounded to bf16 and widened back.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// x and y rounded to bf16 by one conversion, as a pair's bits (element 0
// in the low half).
__device__ __forceinline__ uint32_t round_pair(float x, float y) {
  const bf162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A bf16 pair as loaded (element 0 in the low half) and its elements widened.
__device__ __forceinline__ uint32_t ld_bits(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ float bf_lo(uint32_t b) { return __uint_as_float(b << 16); }
__device__ __forceinline__ float bf_hi(uint32_t b) { return __uint_as_float(b & 0xffff0000u); }

// A pair rounded to bf16 by a streaming store (written once, read later).
__device__ __forceinline__ void st_pair_cs(bf16* p, float x, float y) {
  __stcs(reinterpret_cast<unsigned int*>(p), round_pair(x, y));
}

// The f32 arithmetic of the bf16 kernels: IEEE products and sums, never
// contracted into an FMA, as the plain version computes them.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// n bf16 values from src into x_s (16-byte aligned) by cp.async (committed
// by the caller) where src is 16-byte aligned, the tail by plain loads.
__device__ __forceinline__ void stage_bf16_async(const bf16* __restrict__ src, int n, bf16* x_s) {
  const int n8 = (reinterpret_cast<uintptr_t>(src) & 15) == 0 ? n / 8 : 0;
  for (int t = threadIdx.x; t < n8; t += THREADS)
    cp_async<16>(reinterpret_cast<float*>(x_s + 8 * t), reinterpret_cast<const float*>(src + 8 * t),
                 true);
  for (int t = 8 * n8 + threadIdx.x; t < n; t += THREADS) x_s[t] = src[t];
}

// One [A][L][HC2] chunk (columns c0 .. c0 + HC2) of a bf16 [G, A, L, h]
// tensor's row g by cp.async (committed by the caller), zero beyond h:
// 16-byte copies where the rows allow (`vec16`: h % 8 == 0, 16-byte
// aligned), else 4-byte ones (a column pair; h is even).
__device__ __forceinline__ void stage_chunk_bf16_async(const bf16* __restrict__ x, int g,
                                                       int a_slots, int L, int h, int c0,
                                                       bool vec16, bf16* x_s) {
  const size_t base = static_cast<size_t>(g) * a_slots * L;
  const int w = vec16 ? 8 : 2, per = HC2 / w;  // values a copy, copies a row
  for (int t = threadIdx.x; t < a_slots * L * per; t += THREADS) {
    const int cc = (t % per) * w, al = t / per;
    const bool ok = c0 + cc < h;
    const float* src = reinterpret_cast<const float*>(ok ? x + (base + al) * h + c0 + cc : x);
    float* dst = reinterpret_cast<float*>(x_s + al * HC2 + cc);
    if (vec16) cp_async<16>(dst, src, ok);
    else cp_async<4>(dst, src, ok);
  }
}

// An edge's L values of d, widened, from the row's bf16 d in shared memory
// (16-byte aligned): one 16-byte load where L = 8.
template <int L>
__device__ __forceinline__ void load_d_bf16(const bf16* de, float (&dl)[L]) {
  if constexpr (L == 8) {
    const uint4 w = *reinterpret_cast<const uint4*>(de);
    dl[0] = bf_lo(w.x), dl[1] = bf_hi(w.x), dl[2] = bf_lo(w.y), dl[3] = bf_hi(w.y);
    dl[4] = bf_lo(w.z), dl[5] = bf_hi(w.z), dl[6] = bf_lo(w.w), dl[7] = bf_hi(w.w);
  } else {
#pragma unroll
    for (int l = 0; l < L; ++l) dl[l] = __bfloat162float(de[l]);
  }
}

// Kernel F in bf16. Grid (G, ceil(h / HC2)). Shared memory: the chunk of
// vec [A][L][HC2], the row's d [A·K][L] (bf16), its indices [A·K].
template <int L>
__global__ void __launch_bounds__(THREADS)
vec_agg_fwd_bf16_kernel(const bf16* __restrict__ vec, const bf16* __restrict__ s1,
                        int64_t s1_stride, const bf16* __restrict__ s2m,
                        const bf16* __restrict__ d, const int64_t* __restrict__ idx,
                        const bool* __restrict__ mask, bf16* __restrict__ out, int a_slots,
                        int k_nbrs, int h, bool vec16) {
  extern __shared__ __align__(16) unsigned char smem_b[];
  const int ak = a_slots * k_nbrs;
  bf16* vec_s = reinterpret_cast<bf16*>(smem_b);
  bf16* d_s = reinterpret_cast<bf16*>(smem_b + chunk_bytes(a_slots, L));
  int* idx_s = reinterpret_cast<int*>(smem_b + chunk_bytes(a_slots, L) +
                                      pad16(static_cast<size_t>(ak) * L * sizeof(bf16)));
  const int g = blockIdx.x, c0 = blockIdx.y * HC2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = c0 + 2 * lane;
  const bool live = c < h;
  const size_t row_e = static_cast<size_t>(g) * ak;
  stage_chunk_bf16_async(vec, g, a_slots, L, h, c0, vec16, vec_s);
  stage_bf16_async(d + row_e * L, ak * L, d_s);
  cp_async_commit();
  load_idx(idx, mask, row_e, ak, a_slots, idx_s);
  cp_async_wait_all();
  __syncthreads();

  const float2 zero = make_float2(0.f, 0.f);
  for (int i = warp; i < a_slots; i += WARPS) {
    float ax[L], ay[L];
#pragma unroll
    for (int l = 0; l < L; ++l) ax[l] = ay[l] = 0.f;
    for (int k = 0; k < k_nbrs; ++k) {
      const int e = i * k_nbrs + k;
      const int j = idx_s[e];
      const size_t er = row_e + e;
      const float2 a1 = (live && j >= 0) ? ld_pair(s1 + er * s1_stride + c) : zero;
      const float2 a2 = live ? ld_pair(s2m + er * h + c) : zero;
      const bf16* vj = vec_s + (j >= 0 ? j : 0) * L * HC2 + 2 * lane;
      float dl[L];
      load_d_bf16<L>(d_s + e * L, dl);
#pragma unroll
      for (int l = 0; l < L; ++l) {  // Σ_k (s1·vec[j] + s2m·d), k in order
        const float2 v = ld_pair(vj + l * HC2);
        ax[l] = add(ax[l], add(mul(a1.x, v.x), mul(a2.x, dl[l])));
        ay[l] = add(ay[l], add(mul(a1.y, v.y), mul(a2.y, dl[l])));
      }
    }
    if (live) {
      bf16* o = out + (static_cast<size_t>(g) * a_slots + i) * L * h + c;
#pragma unroll
      for (int l = 0; l < L; ++l) st_pair(o + static_cast<size_t>(l) * h, ax[l], ay[l]);
    }
  }
}

// Kernel H in bf16. Grid G · ceil(h / HC2) blocks, the chunk the fastest
// index; shared memory as F's, vv's chunk in vec's place. A masked edge
// writes +0 and reads neither d nor vv.
template <int L>
__global__ void __launch_bounds__(THREADS)
wdot_fwd_bf16_kernel(const bf16* __restrict__ d, const bf16* __restrict__ u,
                     const bf16* __restrict__ vv, const int64_t* __restrict__ idx,
                     const bool* __restrict__ mask, bf16* __restrict__ out, int a_slots,
                     int k_nbrs, int h, bool vec16) {
  extern __shared__ __align__(16) unsigned char smem_b[];
  const int ak = a_slots * k_nbrs;
  bf16* vv_s = reinterpret_cast<bf16*>(smem_b);
  bf16* d_s = reinterpret_cast<bf16*>(smem_b + chunk_bytes(a_slots, L));
  int* idx_s = reinterpret_cast<int*>(smem_b + chunk_bytes(a_slots, L) +
                                      pad16(static_cast<size_t>(ak) * L * sizeof(bf16)));
  const int n_chunks = (h + HC2 - 1) / HC2;
  const int g = blockIdx.x / n_chunks, c0 = blockIdx.x % n_chunks * HC2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = c0 + 2 * lane;
  const bool live = c < h;
  const size_t row_e = static_cast<size_t>(g) * ak;
  stage_chunk_bf16_async(vv, g, a_slots, L, h, c0, vec16, vv_s);
  stage_bf16_async(d + row_e * L, ak * L, d_s);
  cp_async_commit();
  load_idx(idx, mask, row_e, ak, a_slots, idx_s);
  const bf16* u_row = u + static_cast<size_t>(g) * a_slots * L * h + c;
  const float2 zero = make_float2(0.f, 0.f);
  float2 ui[L];
#pragma unroll
  for (int l = 0; l < L; ++l)
    ui[l] = live && warp < a_slots ? ld_pair(u_row + (warp * L + l) * h) : zero;
  cp_async_wait_all();
  __syncthreads();

  for (int i = warp; i < a_slots; i += WARPS) {
    if (i != warp) {
#pragma unroll
      for (int l = 0; l < L; ++l)
        ui[l] = live ? ld_pair(u_row + (static_cast<size_t>(i) * L + l) * h) : zero;
    }
    bf16* o = out + (row_e + i * k_nbrs) * h + c;
    for (int k = 0; k < k_nbrs; ++k) {
      const int e = i * k_nbrs + k;
      const int j = idx_s[e];
      float wx = 0.f, wy = 0.f;
      if (j >= 0) {  // warp-uniform
        float dl[L];
        load_d_bf16<L>(d_s + e * L, dl);
        const bf16* vj = vv_s + j * L * HC2 + 2 * lane;
        float uvx = 0.f, uvy = 0.f, vdx = 0.f, vdy = 0.f, udx = 0.f, udy = 0.f, dd = 0.f;
#pragma unroll
        for (int l = 0; l < L; ++l) {  // the sums over l in order, as JAX's kernel
          const float2 v = ld_pair(vj + l * HC2);
          uvx = add(uvx, mul(ui[l].x, v.x));
          uvy = add(uvy, mul(ui[l].y, v.y));
          vdx = add(vdx, mul(dl[l], v.x));
          vdy = add(vdy, mul(dl[l], v.y));
          udx = add(udx, mul(ui[l].x, dl[l]));
          udy = add(udy, mul(ui[l].y, dl[l]));
          dd = add(dd, mul(dl[l], dl[l]));
        }
        const float t = __fsub_rn(2.f, dd);  // uv − ud·vd·(2 − |d|²)
        wx = __fsub_rn(uvx, mul(mul(udx, vdx), t));
        wy = __fsub_rn(uvy, mul(mul(udy, vdy), t));
      }
      if (live) st_pair(o + static_cast<size_t>(k) * h, wx, wy);
    }
  }
}

// Kernel G in bf16. Grid (G · CL) in clusters of CL = min(h / HC2, 8)
// blocks, one cluster per row g, two blocks an SM; as the f32 G, with the
// chunk of HC2 columns and dvec's per-edge terms rounded to bf16. STAGE: vec
// and gva of the block's chunk in shared memory (else gathered from device
// memory). The target pass takes the warp's edges (i, k), i ≡ warp
// (mod WARPS), as one stream, the s2m pairs of the next AHEAD_GB edges in
// flight across its slots; the walk loads the s1 pairs of AHEAD_GB edges of
// a source's list at a time.
template <int L, bool STAGE>
__global__ void __launch_bounds__(THREADS, 2)
vec_agg_bwd_bf16_kernel(const bf16* __restrict__ vec, const bf16* __restrict__ s1,
                        int64_t s1_stride, const bf16* __restrict__ s2m,
                        const bf16* __restrict__ d, const int64_t* __restrict__ idx,
                        const bool* __restrict__ mask, const bf16* __restrict__ gva,
                        bf16* __restrict__ dvec, bf16* __restrict__ ds1, bf16* __restrict__ ds2m,
                        bf16* __restrict__ dd, int a_slots, int k_nbrs, int h, bool vec16) {
  constexpr int P = pow2_ceil(L);
  constexpr int SPAN = 32 / P;
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  extern __shared__ __align__(16) unsigned char smem_b[];
  const int ak = a_slots * k_nbrs;
  const size_t chunk = STAGE ? chunk_bytes(a_slots, L) : 0;
  bf16* vec_s = reinterpret_cast<bf16*>(smem_b);                         // [A][L][HC2] (STAGE)
  bf16* g_s = reinterpret_cast<bf16*>(smem_b + chunk);                   // [A][L][HC2] (STAGE)
  bf16* d_s = reinterpret_cast<bf16*>(smem_b + 2 * chunk);               // [A·K][L]
  float* dd_s = reinterpret_cast<float*>(smem_b + 2 * chunk +            // [A·K][L] f32
                                         pad16(static_cast<size_t>(ak) * L * sizeof(bf16)));
  int* idx_s = reinterpret_cast<int*>(dd_s + ak * L);                    // [A·K]
  int* off_s = idx_s + ak;                                               // [A + 1]
  int* list_s = off_s + a_slots + 1;                                     // [A·K]
  const int g = blockIdx.x / cl;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_chunks = (h + HC2 - 1) / HC2;
  const size_t row_e = static_cast<size_t>(g) * ak;
  const size_t row_v = static_cast<size_t>(g) * a_slots * L;
  stage_bf16_async(d + row_e * L, ak * L, d_s);
  if constexpr (STAGE) {
    stage_chunk_bf16_async(vec, g, a_slots, L, h, rank * HC2, vec16, vec_s);
    stage_chunk_bf16_async(gva, g, a_slots, L, h, rank * HC2, vec16, g_s);
  }
  cp_async_commit();
  load_idx(idx, mask, row_e, ak, a_slots, idx_s);
  __syncthreads();
  build_source_lists(idx_s, ak, a_slots, k_nbrs, off_s, list_s);

  // the warp's n_e edges, from edge warp·K on, K of a slot in a row, then
  // `jump` on to the first of its next slot
  const int n_e = warp < a_slots ? ((a_slots - 1 - warp) / WARPS + 1) * k_nbrs : 0;
  const int jump = 1 + (WARPS - 1) * k_nbrs;
  auto next = [&](int& e, int& k) {
    if (++k == k_nbrs) k = 0, e += jump;
    else ++e;
  };
  for (int n = rank; n < n_chunks; n += cl) {
    const int c = n * HC2 + 2 * lane;
    const bool live = c < h;
    const int cr = live ? c : h - 2;  // a column pair the dead lanes may read (results dropped)
    if (STAGE && n != rank) {
      stage_chunk_bf16_async(vec, g, a_slots, L, h, n * HC2, vec16, vec_s);
      stage_chunk_bf16_async(gva, g, a_slots, L, h, n * HC2, vec16, g_s);
      cp_async_commit();
    }
    cp_async_wait_all();
    __syncthreads();
    auto vec_at = [&](int s, int l) {
      if constexpr (STAGE) return ld_bits(vec_s + (s * L + l) * HC2 + 2 * lane);
      else return ld_bits(vec + (row_v + s * L + l) * h + cr);
    };
    auto gva_at = [&](int s, int l) {
      if constexpr (STAGE) return ld_bits(g_s + (s * L + l) * HC2 + 2 * lane);
      else return ld_bits(gva + (row_v + s * L + l) * h + cr);
    };

    // the target pass, per edge (i, k): ds1 = Σ_l vec[j]·gva[i], ds2m =
    // Σ_l d·gva[i] (l in order) and this chunk's terms of dd = Σ_c s2m·gva[i]
    uint32_t a2[AHEAD_GB];  // the s2m pairs of the next edges, as loaded
    int le = warp * k_nbrs, lk = 0;  // the next edge to load, its k
#pragma unroll
    for (int q = 0; q < AHEAD_GB; ++q) {
      a2[q] = live && q < n_e ? ld_bits(s2m + (row_e + le) * h + c) : 0u;
      next(le, lk);
    }
    float gx[L], gy[L];  // gva[i] of the slot i of the edge computed
    int e = warp * k_nbrs, kk = 0, i = warp;
    for (int n0 = 0; n0 < n_e; n0 += AHEAD_GB) {
#pragma unroll
      for (int q = 0; q < AHEAD_GB; ++q) {
        if (n0 + q >= n_e) break;  // the same for the whole warp
        const float sx = bf_lo(a2[q]), sy = bf_hi(a2[q]);
        a2[q] = live && n0 + q + AHEAD_GB < n_e ? ld_bits(s2m + (row_e + le) * h + c) : 0u;
        next(le, lk);
        if (kk == 0) {
#pragma unroll
          for (int l = 0; l < L; ++l) {
            const uint32_t b = gva_at(i, l);
            gx[l] = bf_lo(b), gy[l] = bf_hi(b);
          }
        }
        const int j = idx_s[e];
        const size_t er = row_e + e;
        float dl[L], part[P];
        load_d_bf16<L>(d_s + e * L, dl);
        float t1x = 0.f, t1y = 0.f, t2x = 0.f, t2y = 0.f;
#pragma unroll
        for (int l = 0; l < L; ++l) {
          const uint32_t v = j >= 0 ? vec_at(j, l) : 0u;
          t1x = add(t1x, mul(bf_lo(v), gx[l]));
          t1y = add(t1y, mul(bf_hi(v), gy[l]));
          t2x = add(t2x, mul(dl[l], gx[l]));
          t2y = add(t2y, mul(dl[l], gy[l]));
          part[l] = add(mul(sx, gx[l]), mul(sy, gy[l]));
        }
#pragma unroll
        for (int l = L; l < P; ++l) part[l] = 0.f;
        if (live) {
          st_pair_cs(ds1 + er * h + c, t1x, t1y);
          st_pair_cs(ds2m + er * h + c, t2x, t2y);
        }
        const float r = warp_sum_many<P>(part, lane);
        const int l = lane / SPAN;
        if (lane % SPAN == 0 && l < L) dd_s[e * L + l] = n == rank ? r : dd_s[e * L + l] + r;
        if (kk + 1 == k_nbrs) i += WARPS;
        next(e, kk);
      }
    }

    // the per-source walk: dvec[j] = Σ over the edges whose source is j, in
    // order, of s1·gva[i], each term rounded to bf16
    for (int j = warp; j < a_slots; j += WARPS) {
      float ax[L], ay[L];
#pragma unroll
      for (int l = 0; l < L; ++l) ax[l] = ay[l] = 0.f;
      const int end = off_s[j + 1];
      for (int p0 = off_s[j]; p0 < end; p0 += AHEAD_GB) {
        uint32_t a1[AHEAD_GB];
#pragma unroll
        for (int q = 0; q < AHEAD_GB; ++q) {
          const int p = p0 + q;
          a1[q] = live && p < end ? ld_bits(s1 + (row_e + (list_s[p] & 0xffff)) * s1_stride + c)
                                  : 0u;
        }
#pragma unroll
        for (int q = 0; q < AHEAD_GB; ++q) {
          if (p0 + q >= end) break;  // the same for the whole warp
          const int i = list_s[p0 + q] >> 16;
          const float sx = bf_lo(a1[q]), sy = bf_hi(a1[q]);
#pragma unroll
          for (int l = 0; l < L; ++l) {
            const uint32_t b = gva_at(i, l);
            const uint32_t r = round_pair(mul(sx, bf_lo(b)), mul(sy, bf_hi(b)));
            ax[l] = add(ax[l], bf_lo(r));
            ay[l] = add(ay[l], bf_hi(r));
          }
        }
      }
      if (live) {
        bf16* o = dvec + (row_v + j * L) * h + c;
#pragma unroll
        for (int l = 0; l < L; ++l) st_pair(o + static_cast<size_t>(l) * h, ax[l], ay[l]);
      }
    }
    if constexpr (STAGE) __syncthreads();  // the chunk's staged tensors are read no more
  }
  cluster_dd_sum(cluster, dd_s, [](int t) { return t; }, ak * L, dd + row_e * L);
}

// Each edge's place among the row's live edges (idx_s ≥ 0) in edge order,
// or −1 (pos_s [A·K]): a ballot a word of 32 edges, the running counts of
// the words in cnt_s [ceil(A·K / 32)] (scratch), and the ballots again.
__device__ void live_places(const int* idx_s, int ak, int* cnt_s, int* pos_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_words = (ak + 31) / 32;
  for (int q = warp; q < n_words; q += WARPS) {
    const int e = 32 * q + lane;
    const unsigned b = __ballot_sync(FULL, e < ak && idx_s[e] >= 0);
    if (lane == 0) cnt_s[q] = __popc(b);
  }
  __syncthreads();
  if (warp == 0) {  // the live edges before each word, 32 words at a time
    int carry = 0;
    for (int q0 = 0; q0 < n_words; q0 += 32) {
      const int q = q0 + lane;
      const int own = q < n_words ? cnt_s[q] : 0;
      int v = own;
#pragma unroll
      for (int o = 1; o < 32; o *= 2) {
        const int y = __shfl_up_sync(FULL, v, o);
        if (lane >= o) v += y;
      }
      if (q < n_words) cnt_s[q] = carry + v - own;
      carry += __shfl_sync(FULL, v, 31);
    }
  }
  __syncthreads();
  for (int q = warp; q < n_words; q += WARPS) {
    const int e = 32 * q + lane;
    const bool on = e < ak && idx_s[e] >= 0;
    const unsigned b = __ballot_sync(FULL, on);
    if (e < ak) pos_s[e] = on ? cnt_s[q] + __popc(b & ((1u << lane) - 1)) : -1;
  }
  __syncthreads();
}

// Kernel I in bf16. Grid (G · CL) in clusters of CL = min(h / HC2, 8)
// blocks, one cluster per row g, two blocks an SM; as the f32 I, with the
// chunk of HC2 columns and dvv's per-edge terms rounded to bf16. The live
// gw rows of the chunk are copied into shared memory once, [keep][HC2] by
// the edge's place among the row's live edges (`live_places`), for places
// < keep (a block that takes one chunk; `keep` is what the shared memory
// left for two blocks an SM allows), by cp.async started before the source
// lists are built; both passes read them there, the others from device
// memory, and the walk leaves each edge's terms of dd in its gw row's place
// (< keep) or in ddx_s [A·K − keep][L]. STAGE: the target pass gathers vv
// from the block's chunk staged in shared memory, the walk u from the same
// place, restaged (else both are gathered from device memory); the walk
// reads its source's vv row from device memory.
template <int L, bool STAGE>
__global__ void __launch_bounds__(THREADS, 2)
wdot_bwd_bf16_kernel(const bf16* __restrict__ d, const bf16* __restrict__ u,
                     const bf16* __restrict__ vv, const int64_t* __restrict__ idx,
                     const bool* __restrict__ mask, const bf16* __restrict__ gw,
                     bf16* __restrict__ du, bf16* __restrict__ dvv, bf16* __restrict__ dd,
                     int a_slots, int k_nbrs, int h, int keep, bool vec16, bool gw16) {
  constexpr int P = pow2_ceil(L);
  constexpr int SPAN = 32 / P;
  constexpr int ROW_F = HC2 * sizeof(bf16) / sizeof(float);  // floats a kept gw row spans
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  extern __shared__ __align__(16) unsigned char smem_b[];
  const int ak = a_slots * k_nbrs;
  const size_t chunk = STAGE ? chunk_bytes(a_slots, L) : 0;
  const size_t t_at = chunk + pad16(static_cast<size_t>(ak) * L * sizeof(bf16));
  const size_t gw_at_b = t_at + pad16(static_cast<size_t>(ak) * sizeof(float));
  bf16* x_s = reinterpret_cast<bf16*>(smem_b);                           // [A][L][HC2] (STAGE)
  bf16* d_s = reinterpret_cast<bf16*>(smem_b + chunk);                   // [A·K][L]
  float* t_s = reinterpret_cast<float*>(smem_b + t_at);                  // [A·K] 2 − |d|²
  bf16* gw_s = reinterpret_cast<bf16*>(smem_b + gw_at_b);                // [keep][HC2]
  float* ddx_s = reinterpret_cast<float*>(gw_s + static_cast<size_t>(keep) * HC2);  // [A·K − keep][L]
  int* idx_s = reinterpret_cast<int*>(ddx_s + (ak - keep) * L);          // [A·K]
  int* pos_s = idx_s + ak;                                               // [A·K] live place, or −1
  int* off_s = pos_s + ak;                                               // [A + 1]
  int* list_s = off_s + a_slots + 1;                                     // [A·K]
  const int g = blockIdx.x / cl;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_chunks = (h + HC2 - 1) / HC2;
  const size_t row_e = static_cast<size_t>(g) * ak;
  const size_t row_v = static_cast<size_t>(g) * a_slots * L;
  stage_bf16_async(d + row_e * L, ak * L, d_s);
  if constexpr (STAGE) stage_chunk_bf16_async(vv, g, a_slots, L, h, rank * HC2, vec16, x_s);
  cp_async_commit();
  for (int t = threadIdx.x; t < (ak - keep) * L; t += THREADS) ddx_s[t] = 0.f;
  load_idx(idx, mask, row_e, ak, a_slots, idx_s);
  __syncthreads();
  live_places(idx_s, ak, list_s, pos_s);
  if (keep > 0) {  // the kept gw rows of the block's one chunk, in flight while the lists are built
    const int c0 = rank * HC2, w = gw16 ? 8 : 2, per = HC2 / w;  // values a copy, copies a row
    for (int t = threadIdx.x; t < ak * per; t += THREADS) {
      const int e = t / per, p = pos_s[e], cc = t % per * w;
      if (p < 0 || p >= keep) continue;
      const bool ok = c0 + cc < h;
      const float* src = reinterpret_cast<const float*>(ok ? gw + (row_e + e) * h + c0 + cc : gw);
      float* dst = reinterpret_cast<float*>(gw_s + p * HC2 + cc);
      if (gw16) cp_async<16>(dst, src, ok);
      else cp_async<4>(dst, src, ok);
    }
    cp_async_commit();
  }
  build_source_lists(idx_s, ak, a_slots, k_nbrs, off_s, list_s);
  cp_async_wait_all();
  __syncthreads();
  for (int e = threadIdx.x; e < ak; e += THREADS) {
    float dl[L], dde = 0.f;
    load_d_bf16<L>(d_s + e * L, dl);
#pragma unroll
    for (int l = 0; l < L; ++l) dde = add(dde, mul(dl[l], dl[l]));
    t_s[e] = __fsub_rn(2.f, dde);
  }

  for (int n = rank; n < n_chunks; n += cl) {  // keep > 0: once
    const int c = n * HC2 + 2 * lane;
    const bool live = c < h;
    const int cr = live ? c : h - 2;  // a column pair the dead lanes may read (results dropped)
    if (STAGE && n != rank) {
      stage_chunk_bf16_async(vv, g, a_slots, L, h, n * HC2, vec16, x_s);
      cp_async_commit();
      cp_async_wait_all();
    }
    __syncthreads();
    // the gw pair of edge e at live place p: kept, or from device memory
    auto gw_pair = [&](int e, int p) {
      return p < keep ? ld_bits(gw_s + p * HC2 + 2 * lane)
                      : live ? ld_bits(gw + (row_e + e) * h + c) : 0u;
    };

    // the target pass: du[i] = Σ_k gw·vv[j] + dud·d, dud = −gw·vd·(2 − |d|²)
    for (int i = warp; i < a_slots; i += WARPS) {
      float ux[L], uy[L];
#pragma unroll
      for (int l = 0; l < L; ++l) ux[l] = uy[l] = 0.f;
      for (int k = 0; k < k_nbrs; ++k) {
        const int e = i * k_nbrs + k;
        const int j = idx_s[e];
        if (j < 0) continue;  // the same for the whole warp; a masked edge adds 0
        const uint32_t gb = gw_pair(e, pos_s[e]);
        const float gwx = bf_lo(gb), gwy = bf_hi(gb);
        float dl[L];
        uint32_t vb[L];
        load_d_bf16<L>(d_s + e * L, dl);
        float vdx = 0.f, vdy = 0.f;
#pragma unroll
        for (int l = 0; l < L; ++l) {
          if constexpr (STAGE) vb[l] = ld_bits(x_s + (j * L + l) * HC2 + 2 * lane);
          else vb[l] = ld_bits(vv + (row_v + j * L + l) * h + cr);
          vdx = add(vdx, mul(dl[l], bf_lo(vb[l])));
          vdy = add(vdy, mul(dl[l], bf_hi(vb[l])));
        }
        const float te = t_s[e];
        const float dudx = mul(mul(-gwx, vdx), te), dudy = mul(mul(-gwy, vdy), te);
#pragma unroll
        for (int l = 0; l < L; ++l) {
          ux[l] = add(ux[l], add(mul(gwx, bf_lo(vb[l])), mul(dudx, dl[l])));
          uy[l] = add(uy[l], add(mul(gwy, bf_hi(vb[l])), mul(dudy, dl[l])));
        }
      }
      if (live) {
        bf16* o = du + (row_v + i * L) * h + c;
#pragma unroll
        for (int l = 0; l < L; ++l) st_pair(o + static_cast<size_t>(l) * h, ux[l], uy[l]);
      }
    }
    __syncthreads();  // vv's chunk is read no more
    if constexpr (STAGE) {  // u's chunk takes its place
      stage_chunk_bf16_async(u, g, a_slots, L, h, n * HC2, vec16, x_s);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
    }

    // the per-source walk: dvv[j] = Σ over the edges whose source is j, in
    // order, of gw·u[i] + dvd·d (dvd = −gw·ud·(2 − |d|²)), each term rounded
    // to bf16; and each edge's terms of dd: dvd·vv[j] + dud·u[i] + 2·d·gw·ud·vd
    for (int j = warp; j < a_slots; j += WARPS) {
      const int begin = off_s[j], end = off_s[j + 1];
      uint32_t vj[L];
      float ax[L], ay[L];
#pragma unroll
      for (int l = 0; l < L; ++l) {
        vj[l] = begin < end ? ld_bits(vv + (row_v + j * L + l) * h + cr) : 0u;
        ax[l] = ay[l] = 0.f;
      }
      for (int p = begin; p < end; ++p) {
        const int v = list_s[p];
        const int e = v & 0xffff, i = v >> 16, q = pos_s[e];
        const uint32_t gb = gw_pair(e, q);
        const float gwx = bf_lo(gb), gwy = bf_hi(gb);
        auto u_at = [&](int l) {
          if constexpr (STAGE) return ld_bits(x_s + (i * L + l) * HC2 + 2 * lane);
          else return ld_bits(u + (row_v + i * L + l) * h + cr);
        };
        float dl[L], part[P];
        load_d_bf16<L>(d_s + e * L, dl);
        float udx = 0.f, udy = 0.f, vdx = 0.f, vdy = 0.f;
#pragma unroll
        for (int l = 0; l < L; ++l) {
          const uint32_t ub = u_at(l);
          udx = add(udx, mul(bf_lo(ub), dl[l]));
          udy = add(udy, mul(bf_hi(ub), dl[l]));
          vdx = add(vdx, mul(dl[l], bf_lo(vj[l])));
          vdy = add(vdy, mul(dl[l], bf_hi(vj[l])));
        }
        const float t = t_s[e];
        const float dvdx = mul(mul(-gwx, udx), t), dvdy = mul(mul(-gwy, udy), t);
        const float dudx = mul(mul(-gwx, vdx), t), dudy = mul(mul(-gwy, vdy), t);
        const float gx = mul(mul(gwx, udx), vdx), gy = mul(mul(gwy, udy), vdy);
#pragma unroll
        for (int l = 0; l < L; ++l) {
          const uint32_t ub = u_at(l);
          // each column's term rounded by its own conversion: the pair's one
          // conversion holds both terms live at once and spills (measured)
          ax[l] = add(ax[l], round_bf16(add(mul(gwx, bf_lo(ub)), mul(dvdx, dl[l]))));
          ay[l] = add(ay[l], round_bf16(add(mul(gwy, bf_hi(ub)), mul(dvdy, dl[l]))));
          const float px = add(add(mul(dvdx, bf_lo(vj[l])), mul(dudx, bf_lo(ub))),
                               mul(mul(2.f, dl[l]), gx));
          const float py = add(add(mul(dvdy, bf_hi(vj[l])), mul(dudy, bf_hi(ub))),
                               mul(mul(2.f, dl[l]), gy));
          part[l] = add(px, py);
        }
#pragma unroll
        for (int l = L; l < P; ++l) part[l] = 0.f;
        const float r = warp_sum_many<P>(part, lane);
        const int l = lane / SPAN;
        __syncwarp();  // every lane has read its gw pair of this edge
        if (lane % SPAN == 0 && l < L) {
          if (q < keep) reinterpret_cast<float*>(gw_s)[q * ROW_F + l] = r;
          else ddx_s[(q - keep) * L + l] += r;
        }
      }
      if (live) {
        bf16* o = dvv + (row_v + j * L) * h + c;
#pragma unroll
        for (int l = 0; l < L; ++l) st_pair(o + static_cast<size_t>(l) * h, ax[l], ay[l]);
      }
    }
    if constexpr (STAGE) __syncthreads();  // u's chunk is read no more
  }
  // dd's terms of edge e at its live place q, in the kept gw rows or ddx_s
  // (the same offsets in every rank's shared memory)
  cluster_dd_sum(cluster, reinterpret_cast<float*>(gw_s), [&](int t) {
    const int q = pos_s[t / L];
    return q < 0 ? -1 : q < keep ? q * ROW_F + t % L : keep * ROW_F + (q - keep) * L + t % L;
  }, ak * L, dd + row_e * L);
}

// Dynamic shared memory of a block of F or H. It grows with the slot axis
// A: at L = 8, k = 17 a block takes A ≤ 142 within the 227 KB a Hopper
// block may use; G and I take the same rows.
size_t fwd_smem(int a_slots, int k_nbrs, int L) {
  const size_t ak = static_cast<size_t>(a_slots) * k_nbrs;
  return (static_cast<size_t>(a_slots) * L * HC + ak * L) * sizeof(float) + ak * sizeof(int);
}

// Two blocks an SM (228 KB of shared memory, 1 KB of it reserved a block)
// keep the target pass of one block going while the other stages its row.
constexpr size_t TWO_BLOCK_SMEM = 233472 / 2 - 1024;

// G: the staged chunks (STAGE), the row's d, dd's terms, the indices and
// the lists.
size_t agg_bwd_smem(int a_slots, int k_nbrs, int L, bool stage) {
  const size_t a = a_slots, ak = a * k_nbrs;
  return ((stage ? 2 * a * L * HC : 0) + 2 * ak * L) * sizeof(float) +
         (2 * ak + a + 1) * sizeof(int);
}

// I without the kept gw: the staged chunk (STAGE), the row's d and 2 − |d|²,
// dd's terms, the indices, the lists and the edges' list places; each kept
// gw row adds HC floats and takes L of dd's.
size_t wdot_bwd_smem(int a_slots, int k_nbrs, int L, bool stage) {
  const size_t a = a_slots, ak = a * k_nbrs;
  return ((stage ? a * L * HC : 0) + pad4(ak * (L + 1)) + ak * L) * sizeof(float) +
         (3 * ak + a + 1) * sizeof(int);
}

// Launches a backward kernel on G rows, each a cluster of min(n_chunks, 8)
// blocks (n_chunks > 0: the row's column chunks).
template <typename... Params, typename... Args>
cudaError_t launch_rows(void (*kernel)(Params...), int g_rows, int n_chunks, size_t smem,
                        cudaStream_t stream, Args... args) {
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int cl = n_chunks < MAX_CLUSTER ? n_chunks : MAX_CLUSTER;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(g_rows) * cl);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t launched = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (launched != cudaSuccess) cudaGetLastError();
  return launched;
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

// Whether every row's d [A·K][L] starts 16-byte aligned.
bool rows16(const float* d, int a_slots, int k_nbrs, int L) {
  return aligned16(d) && static_cast<size_t>(a_slots) * k_nbrs * L % 4 == 0;
}

extern "C" int vis_wdot_fwd_f32(const float* d, const float* u, const float* vv,
                                const int64_t* idx, const bool* mask, float* out, int g_rows,
                                int a_slots, int k_nbrs, int L, int h, cudaStream_t stream) {
  if (bad_l(L)) return static_cast<int>(cudaErrorInvalidValue);
  if (g_rows <= 0 || a_slots <= 0 || k_nbrs <= 0 || h <= 0) return 0;
  const size_t smem = fwd_smem(a_slots, k_nbrs, L);
  auto kernel = L == 8 ? wdot_fwd_kernel<8> : wdot_fwd_kernel<3>;
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec4 = h % 4 == 0 && aligned16(vv);
  kernel<<<g_rows * ((h + HC - 1) / HC), THREADS, smem, stream>>>(
      d, u, vv, idx, mask, out, g_rows, a_slots, k_nbrs, h, vec4, rows16(d, a_slots, k_nbrs, L));
  return static_cast<int>(cudaGetLastError());
}

// The backward kernels' refusals and empty cases: 0 to launch, else the
// code to return (a row F and H refuse, `fwd` being their shared memory
// for it, an L other than 3 and 8, or nothing to write but dd's zeros, of
// `elem` bytes each, when h = 0).
int bwd_prologue(int g_rows, int a_slots, int k_nbrs, int L, int h, size_t fwd, void* dd,
                 size_t elem, cudaStream_t stream, bool* launch) {
  *launch = false;
  if (bad_l(L)) return static_cast<int>(cudaErrorInvalidValue);
  if (g_rows <= 0 || a_slots <= 0) return 0;
  if (fwd > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  if (h <= 0) {  // no columns: dd sums nothing
    const size_t n = static_cast<size_t>(g_rows) * a_slots * k_nbrs * L;
    return static_cast<int>(n ? cudaMemsetAsync(dd, 0, n * elem, stream) : cudaSuccess);
  }
  *launch = true;
  return 0;
}

// Writes dvec [G, A, L, h], ds1 and ds2m [G, A, K, h] (contiguous) and
// dd [G, A, K, L] for the output gradient gva [G, A, L, h].
extern "C" int vis_vec_agg_bwd_f32(const float* vec, const float* s1, int64_t s1_stride,
                                   const float* s2m, const float* d, const int64_t* idx,
                                   const bool* mask, const float* gva, float* dvec, float* ds1,
                                   float* ds2m, float* dd, int g_rows, int a_slots, int k_nbrs,
                                   int L, int h, cudaStream_t stream) {
  bool launch;
  const int code = bwd_prologue(g_rows, a_slots, k_nbrs, L, h, fwd_smem(a_slots, k_nbrs, L), dd,
                                sizeof(float), stream, &launch);
  if (!launch) return code;
  const bool stage = agg_bwd_smem(a_slots, k_nbrs, L, true) <= MAX_SMEM;
  const bool vec4 = h % 4 == 0 && aligned16(vec) && aligned16(gva);
  const size_t smem = agg_bwd_smem(a_slots, k_nbrs, L, stage);
  auto kernel = L == 8 ? (stage ? vec_agg_bwd_kernel<8, true> : vec_agg_bwd_kernel<8, false>)
                       : (stage ? vec_agg_bwd_kernel<3, true> : vec_agg_bwd_kernel<3, false>);
  return static_cast<int>(launch_rows(kernel, g_rows, (h + HC - 1) / HC, smem, stream, vec, s1,
                                      s1_stride, s2m, d, idx, mask, gva, dvec, ds1, ds2m, dd,
                                      a_slots, k_nbrs, h, vec4, rows16(d, a_slots, k_nbrs, L)));
}

// Writes du, dvv [G, A, L, h] and dd [G, A, K, L] for the output gradient
// gw [G, A, K, h].
extern "C" int vis_wdot_bwd_f32(const float* d, const float* u, const float* vv,
                                const int64_t* idx, const bool* mask, const float* gw, float* du,
                                float* dvv, float* dd, int g_rows, int a_slots, int k_nbrs, int L,
                                int h, cudaStream_t stream) {
  bool launch;
  const int code = bwd_prologue(g_rows, a_slots, k_nbrs, L, h, fwd_smem(a_slots, k_nbrs, L), dd,
                                sizeof(float), stream, &launch);
  if (!launch) return code;
  const bool stage = wdot_bwd_smem(a_slots, k_nbrs, L, true) <= MAX_SMEM;
  const size_t base = wdot_bwd_smem(a_slots, k_nbrs, L, stage);
  const size_t ak = static_cast<size_t>(a_slots) * k_nbrs;
  const size_t per_row = (HC - L) * sizeof(float);  // a kept gw row less its dd terms
  size_t keep = 0;  // a block that takes more than one chunk keeps none
  if ((h + HC - 1) / HC <= MAX_CLUSTER && base < TWO_BLOCK_SMEM)
    keep = (TWO_BLOCK_SMEM - base) / per_row < ak ? (TWO_BLOCK_SMEM - base) / per_row : ak;
  const bool vec4 = h % 4 == 0 && aligned16(vv) && aligned16(u) && aligned16(gw);
  auto kernel = L == 8 ? (stage ? wdot_bwd_kernel<8, true> : wdot_bwd_kernel<8, false>)
                       : (stage ? wdot_bwd_kernel<3, true> : wdot_bwd_kernel<3, false>);
  return static_cast<int>(launch_rows(kernel, g_rows, (h + HC - 1) / HC, base + keep * per_row,
                                      stream, d, u, vv, idx, mask, gw, du, dvv, dd, a_slots,
                                      k_nbrs, h, static_cast<int>(keep), vec4,
                                      rows16(d, a_slots, k_nbrs, L)));
}

// ------------------------------------------------------------ bf16 entries

// Dynamic shared memory of a block of F or H in bf16: the chunk, the row's
// d and its indices. At L = 8, k = 17: A ≤ 170.
size_t fwd_smem_bf16(int a_slots, int k_nbrs, int L) {
  const size_t ak = static_cast<size_t>(a_slots) * k_nbrs;
  return chunk_bytes(a_slots, L) + pad16(ak * L * sizeof(bf16)) + ak * sizeof(int);
}

// G in bf16: the staged chunks of vec and gva (STAGE), the row's d, dd's
// f32 terms, the indices and the lists. STAGE at L = 8, k = 17: A ≤ 77.
size_t agg_bwd_smem_bf16(int a_slots, int k_nbrs, int L, bool stage) {
  const size_t a = a_slots, ak = a * k_nbrs;
  return (stage ? 2 * chunk_bytes(a_slots, L) : 0) + pad16(ak * L * sizeof(bf16)) +
         ak * L * sizeof(float) + (2 * ak + a + 1) * sizeof(int);
}

// I in bf16 without the kept gw: the staged chunk (STAGE), the row's d and
// 2 − |d|², dd's f32 terms, the indices, the edges' live places and the
// lists; each kept gw row adds HC2 bf16 and takes L of dd's terms.
size_t wdot_bwd_smem_bf16(int a_slots, int k_nbrs, int L, bool stage) {
  const size_t a = a_slots, ak = a * k_nbrs;
  return (stage ? chunk_bytes(a_slots, L) : 0) + pad16(ak * L * sizeof(bf16)) +
         pad16(ak * sizeof(float)) + ak * L * sizeof(float) + (3 * ak + a + 1) * sizeof(int);
}

// Whether 16-byte copies of a bf16 [G, A, L, h] tensor's chunks are aligned.
bool rows16_bf16(const void* x, int h) { return h % 8 == 0 && aligned16(x); }

extern "C" int vis_vec_agg_fwd_bf16(const bf16* vec, const bf16* s1, int64_t s1_stride,
                                    const bf16* s2m, const bf16* d, const int64_t* idx,
                                    const bool* mask, bf16* out, int g_rows, int a_slots,
                                    int k_nbrs, int L, int h, cudaStream_t stream) {
  if (bad_l(L) || h % 2) return static_cast<int>(cudaErrorInvalidValue);
  if (g_rows <= 0 || a_slots <= 0 || h <= 0) return 0;  // an empty output
  const dim3 grid(g_rows, (h + HC2 - 1) / HC2);
  const size_t smem = fwd_smem_bf16(a_slots, k_nbrs, L);
  auto kernel = L == 8 ? vec_agg_fwd_bf16_kernel<8> : vec_agg_fwd_bf16_kernel<3>;
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, THREADS, smem, stream>>>(vec, s1, s1_stride, s2m, d, idx, mask, out, a_slots,
                                          k_nbrs, h, rows16_bf16(vec, h));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vis_wdot_fwd_bf16(const bf16* d, const bf16* u, const bf16* vv, const int64_t* idx,
                                 const bool* mask, bf16* out, int g_rows, int a_slots, int k_nbrs,
                                 int L, int h, cudaStream_t stream) {
  if (bad_l(L) || h % 2) return static_cast<int>(cudaErrorInvalidValue);
  if (g_rows <= 0 || a_slots <= 0 || k_nbrs <= 0 || h <= 0) return 0;
  const size_t smem = fwd_smem_bf16(a_slots, k_nbrs, L);
  auto kernel = L == 8 ? wdot_fwd_bf16_kernel<8> : wdot_fwd_bf16_kernel<3>;
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<g_rows * ((h + HC2 - 1) / HC2), THREADS, smem, stream>>>(
      d, u, vv, idx, mask, out, a_slots, k_nbrs, h, rows16_bf16(vv, h));
  return static_cast<int>(cudaGetLastError());
}

// Writes dvec [G, A, L, h], ds1 and ds2m [G, A, K, h] (contiguous) and
// dd [G, A, K, L], all bf16, for the output gradient gva [G, A, L, h].
extern "C" int vis_vec_agg_bwd_bf16(const bf16* vec, const bf16* s1, int64_t s1_stride,
                                    const bf16* s2m, const bf16* d, const int64_t* idx,
                                    const bool* mask, const bf16* gva, bf16* dvec, bf16* ds1,
                                    bf16* ds2m, bf16* dd, int g_rows, int a_slots, int k_nbrs,
                                    int L, int h, cudaStream_t stream) {
  if (h % 2) return static_cast<int>(cudaErrorInvalidValue);
  bool launch;
  const int code = bwd_prologue(g_rows, a_slots, k_nbrs, L, h, fwd_smem_bf16(a_slots, k_nbrs, L),
                                dd, sizeof(bf16), stream, &launch);
  if (!launch) return code;
  const bool stage = agg_bwd_smem_bf16(a_slots, k_nbrs, L, true) <= MAX_SMEM;
  const size_t smem = agg_bwd_smem_bf16(a_slots, k_nbrs, L, stage);
  auto kernel = L == 8
      ? (stage ? vec_agg_bwd_bf16_kernel<8, true> : vec_agg_bwd_bf16_kernel<8, false>)
      : (stage ? vec_agg_bwd_bf16_kernel<3, true> : vec_agg_bwd_bf16_kernel<3, false>);
  return static_cast<int>(launch_rows(kernel, g_rows, (h + HC2 - 1) / HC2, smem, stream, vec, s1,
                                      s1_stride, s2m, d, idx, mask, gva, dvec, ds1, ds2m, dd,
                                      a_slots, k_nbrs, h,
                                      rows16_bf16(vec, h) && rows16_bf16(gva, h)));
}

// Writes du, dvv [G, A, L, h] and dd [G, A, K, L], all bf16, for the output
// gradient gw [G, A, K, h].
extern "C" int vis_wdot_bwd_bf16(const bf16* d, const bf16* u, const bf16* vv, const int64_t* idx,
                                 const bool* mask, const bf16* gw, bf16* du, bf16* dvv, bf16* dd,
                                 int g_rows, int a_slots, int k_nbrs, int L, int h,
                                 cudaStream_t stream) {
  if (h % 2) return static_cast<int>(cudaErrorInvalidValue);
  bool launch;
  const int code = bwd_prologue(g_rows, a_slots, k_nbrs, L, h, fwd_smem_bf16(a_slots, k_nbrs, L),
                                dd, sizeof(bf16), stream, &launch);
  if (!launch) return code;
  const bool stage = wdot_bwd_smem_bf16(a_slots, k_nbrs, L, true) <= MAX_SMEM;
  const size_t base = wdot_bwd_smem_bf16(a_slots, k_nbrs, L, stage);
  const size_t ak = static_cast<size_t>(a_slots) * k_nbrs;
  const size_t per_row = HC2 * sizeof(bf16) - L * sizeof(float);  // a kept gw row less its dd terms
  const int n_chunks = (h + HC2 - 1) / HC2;
  size_t keep = 0;  // a block that takes more than one chunk keeps none
  if (n_chunks <= MAX_CLUSTER && base < TWO_BLOCK_SMEM) {
    const size_t room = (TWO_BLOCK_SMEM - base) / per_row;
    keep = room < ak ? room : ak;
  }
  auto kernel = L == 8 ? (stage ? wdot_bwd_bf16_kernel<8, true> : wdot_bwd_bf16_kernel<8, false>)
                       : (stage ? wdot_bwd_bf16_kernel<3, true> : wdot_bwd_bf16_kernel<3, false>);
  return static_cast<int>(launch_rows(kernel, g_rows, n_chunks, base + keep * per_row, stream, d,
                                      u, vv, idx, mask, gw, du, dvv, dd, a_slots, k_nbrs, h,
                                      static_cast<int>(keep),
                                      rows16_bf16(vv, h) && rows16_bf16(u, h),
                                      rows16_bf16(gw, h)));
}
