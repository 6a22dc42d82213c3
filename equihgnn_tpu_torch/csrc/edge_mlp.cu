// Fused EGNN edge messages, forward (kernel B) and backward (kernel C):
//   out[g, a, kk, :] = silu(z),
//   z = silu(ui[g, a] + ujn[g, idx[g, a, kk]] + dist[g, a, kk] * wd + b0) @ W1 + b1
// with ui, ujn [G, A, F], dist [G, A, K], idx [G, A, K] (slot indices into
// the A axis), wd, b0 [F], W1 [F, M], b1 [M] and out, z [G, A, K, M], all f32.
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
// registers. Device memory traffic is small; the forward re-reads the
// neighbour rows of ujn from L2. Kernel C keeps the 16-wide products on the
// CUDA cores: they take ~0.6 ms of its ~2.1 with every edge live and ~0.3
// of ~1.4 with the model's zeros (`ablate_kernels.py`, PERF.md §6), of
// which 3xTF32 `mma.sync` (three tensor-core products for each f32 one, as
// kernels J and K) could win back a part only.
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
// included; the caller masks them afterwards. When the caller trains, the
// forward also writes z (25 MB), which kernel C then reads instead of
// computing the forward again; serving passes no z pointer and writes
// nothing more. M must be 16 (the EGNN message width); any F, A and K are
// taken.
//
// Backward design (kernel C), for dm = dL/dout. Per edge e and column f:
//   dz = dm ⊙ silu'(z), pre = ui + ujn[idx] + dist·wd + b0, a1 = silu(pre),
//   dpre = (dz @ W1ᵀ) ⊙ silu'(pre);
//   dui[a] = Σ_kk dpre, dujn[idx] += dpre (within the row), ddist = dpre·wd,
//   dwd = Σ dpre·dist, db0 = Σ dpre, dW1 = Σ a1ᵀ dz, db1 = Σ dz over all
// E edges. An edge whose dm row is all 0 has dz = 0 and dpre = 0, so it adds
// nothing to any output (the model masks both consumers of out, so dm is 0
// on every padded neighbour: ~52 % of the edges at batch 768). The kernel
// tests dm by value and skips such edges, and slots whose edges are all
// such, exactly (a NaN is not 0 and is computed; a non-finite forward value
// on an edge of zero gradient is not propagated). z is read from the
// forward's saved copy.
// `edge_mlp_bwd_kernel<COLS>`: a block takes BW_ROWS molecule rows and a
// chunk of at most COLS columns of F (F split evenly over the chunks), one
// column per thread. The thread keeps W1[f, :], and its running sums of
// dW1[f, :], dwd[f] and db0[f], in registers, and owns column f of two
// shared [A][COLS] arrays: the dujn accumulator (so the scatter into dujn
// needs no atomics) and the row's ujn chunk, copied in at the row's start,
// so that a neighbour's ujn is a shared-memory read, not an L2 one. Per
// slot, the block stages dz of the slot's K edges (dz formed only where dm
// is not 0), idx and dist, and marks each edge live where its dm row is not
// all 0 (a ballot of each half-warp's 16 values); those loads are issued one
// slot ahead into registers (and ui's column one slot ahead), and the
// staging has two buffers by slot parity, so that one barrier a slot
// suffices. Each warp lists the slot's live edges in order (a ballot), pads
// the list with a zero edge to a multiple of GROUP, and walks it GROUP edges
// at a time, unguarded, recomputing pre in registers (dz read as
// broadcasts). ddist sums over all F: a thread keeps the terms dpre·wd of
// the group's edges in registers, and the warp sums them together in one
// reduce-scatter butterfly (9 shuffles a group of 8, where a butterfly an
// edge takes 40); the block adds its warps in order and writes one partial
// per column chunk (0 for a dead edge). The block's parameter sums go to one
// workspace row. One `column_sums` launch then adds the parameter partials
// over the row blocks and the ddist partials over the column chunks, each
// output column owned by one block, in a fixed order. dui, dujn and ddist
// are written in full, 0 where nothing was added. The block's shared memory
// is 8·A·COLS bytes and ~0.2 KB a neighbour: the launch takes the widest
// COLS of 128, 64 and 32 that fits a block (A ≤ 223, 448 and 897 slots at
// K = 16).
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

// backward (kernel C); `ablate_kernels.py` rebuilds it with other values
constexpr int BW_ROWS = 2;        // molecule rows per block
constexpr int BW_MIN_BLOCKS = 5;  // blocks of 128 threads an SM its registers allow
constexpr int GROUP = 8;          // live edges a warp walks at once (a power of 2)
constexpr size_t SMEM_MAX = 232448;  // bytes of shared memory a Hopper block can opt in to

__device__ __forceinline__ float silu(float x) { return x / (1.f + __expf(-x)); }

__device__ __forceinline__ float sigmoid(float x) { return __fdividef(1.f, 1.f + __expf(-x)); }

__device__ __forceinline__ float dsilu(float x) {
  const float s = sigmoid(x);
  return s * (1.f + x * (1.f - s));
}

// out = silu(z), and z itself where zout is given.
__global__ void __launch_bounds__(WARPS * 32)
edge_mlp_fwd_kernel(const float* __restrict__ ui, const float* __restrict__ ujn,
                    const float* __restrict__ dist, const int64_t* __restrict__ idx,
                    const float* __restrict__ wd, const float* __restrict__ b0,
                    const float* __restrict__ w1, const float* __restrict__ b1,
                    float* __restrict__ out, float* __restrict__ zout,
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
          out[o] = silu(z);
          if (zout) zout[o] = z;
        }
      }
    }
  }
}

// The warp's sums of v[0..N) (N = 2^n ≤ 32) in one reduce-scatter
// butterfly: each step keeps half of the values a lane holds and adds the
// other half from its partner. Returns, at lane l, the sum of v[l >> (5 − n)].
template <int N>
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[N], int lane) {
  constexpr int LOG_N = N == 1 ? 0 : N == 2 ? 1 : N == 4 ? 2 : N == 8 ? 3 : N == 16 ? 4 : 5;
#pragma unroll
  for (int s = 0; s < LOG_N; ++s) {
    const int half = N >> (s + 1), bit = 16 >> s;
    const bool up = lane & bit;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = up ? v[i] : v[i + half];
      const float keep = up ? v[i + half] : v[i];
      v[i] = keep + __shfl_xor_sync(FULL, send, bit);
    }
  }
#pragma unroll
  for (int s = LOG_N; s < 5; ++s) v[0] += __shfl_xor_sync(FULL, v[0], 16 >> s);
  return v[0];
}

// Kernel C's per-slot staging, two of it (by slot parity): dz, dist and idx
// of the slot's K edges and a zero edge K (the padding of the live lists),
// whether each edge's dm row is not all 0, and each of the block's `warps`
// warps' ddist terms.
struct SlotBufs {
  float* dz;    // [K + 1][M_OUT]
  float* dist;  // [K + 1]
  float* dd;    // [warps][K + 1]
  int* idx;     // [K + 1]
  int* live;    // [K]

  // a multiple of 4: dz is read as float4
  static __host__ __device__ size_t floats(int k, int warps) {
    return (static_cast<size_t>(k + 1) * (M_OUT + 2 + warps) + k + 3) / 4 * 4;
  }
  __device__ SlotBufs(float* at, int k, int warps)
      : dz(at), dist(at + (k + 1) * M_OUT), dd(dist + k + 1),
        idx(reinterpret_cast<int*>(dd + warps * (k + 1))), live(idx + k + 1) {}
};

constexpr int PF = 2;  // rounds of a slot's dm and z a thread loads ahead (K ≤ 16)

// Kernel C: see the file comment. Grid (ceil(G / BW_ROWS), ceil(F /
// COLS)), COLS threads; dynamic shared memory bwd_smem(A, K, COLS) bytes.
template <int COLS>
__global__ void __launch_bounds__(COLS, BW_MIN_BLOCKS * 128 / COLS)
edge_mlp_bwd_kernel(const float* __restrict__ ui, const float* __restrict__ ujn,
                    const float* __restrict__ dist, const int64_t* __restrict__ idx,
                    const float* __restrict__ wd, const float* __restrict__ b0,
                    const float* __restrict__ w1, const float* __restrict__ dm,
                    const float* __restrict__ z, float* __restrict__ dui,
                    float* __restrict__ dujn, float* __restrict__ ddist_part,
                    float* __restrict__ param_part, int g_rows, int a_slots, int k_nbrs,
                    int f_dim) {
  constexpr int WARPS_C = COLS / 32;
  extern __shared__ float smem[];
  float* dujn_s = smem;                             // [A][COLS]
  float* ujn_s = dujn_s + a_slots * COLS;           // [A][COLS]: the row's ujn chunk
  float* bufs_s = ujn_s + a_slots * COLS;           // [2][SlotBufs::floats(K, WARPS_C)]
  const size_t bf = SlotBufs::floats(k_nbrs, WARPS_C);
  const int lpad = (k_nbrs + GROUP - 1) / GROUP * GROUP;  // a live list padded to groups
  int* list_s = reinterpret_cast<int*>(bufs_s + 2 * bf);  // [WARPS_C][lpad]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = blockIdx.y;
  const int c0 = static_cast<int>(static_cast<int64_t>(chunk) * f_dim / gridDim.y);
  const int c1 = static_cast<int>(static_cast<int64_t>(chunk + 1) * f_dim / gridDim.y);
  const int f = c0 + tid;
  const bool live = f < c1;
  const int n_el = k_nbrs * M_OUT;
  int* list = list_s + warp * lpad;

  for (int b = 0; b < 2; ++b) {  // the zero edge K
    const SlotBufs sb(bufs_s + b * bf, k_nbrs, WARPS_C);
    for (int i = tid; i <= M_OUT; i += COLS) {
      if (i < M_OUT) sb.dz[k_nbrs * M_OUT + i] = 0.f;
      else sb.dist[k_nbrs] = 0.f, sb.idx[k_nbrs] = 0;
    }
  }

  float w1f[M_OUT], dw1[M_OUT];
#pragma unroll
  for (int j = 0; j < M_OUT; ++j) {
    w1f[j] = live ? w1[static_cast<size_t>(f) * M_OUT + j] : 0.f;
    dw1[j] = 0.f;
  }
  const float wdf = live ? wd[f] : 0.f;
  const float b0f = live ? b0[f] : 0.f;
  float dwd = 0.f, db0 = 0.f, db1 = 0.f;  // db1: thread j < M_OUT of chunk 0

  // a slot's dm and z elements tid + r·COLS (r < PF), idx and dist of
  // edge tid, loaded one slot ahead
  float pf_dm[PF], pf_z[PF], pf_dist = 0.f;
  int pf_idx = 0;
  auto prefetch = [&](size_t row) {
#pragma unroll
    for (int r = 0; r < PF; ++r) {
      const int i = r * COLS + tid;
      pf_dm[r] = i < n_el ? dm[row * n_el + i] : 0.f;
      pf_z[r] = i < n_el && pf_dm[r] != 0.f ? z[row * n_el + i] : 0.f;
    }
    if (tid < k_nbrs) {
      pf_idx = static_cast<int>(idx[row * k_nbrs + tid]);
      pf_dist = dist[row * k_nbrs + tid];
    }
  };

  const int g_end = min(g_rows, (static_cast<int>(blockIdx.x) + 1) * BW_ROWS);
  for (int g = blockIdx.x * BW_ROWS; g < g_end; ++g) {
    // the thread's own column of dujn and of the row's ujn (no other thread
    // reads it: no barrier)
    const float* ujn_g = ujn + static_cast<size_t>(g) * a_slots * f_dim;
    for (int a = 0; a < a_slots; ++a) {
      dujn_s[a * COLS + tid] = 0.f;
      ujn_s[a * COLS + tid] = live ? ujn_g[static_cast<size_t>(a) * f_dim + f] : 0.f;
    }
    const size_t row0 = static_cast<size_t>(g) * a_slots;
    float ui_next = live ? ui[row0 * f_dim + f] : 0.f;
    prefetch(row0);

    for (int a = 0; a < a_slots; ++a) {
      const size_t row = row0 + a;
      const SlotBufs sb(bufs_s + (a & 1) * bf, k_nbrs, WARPS_C);
      const float ui_a = ui_next;
      if (live && a + 1 < a_slots) ui_next = ui[(row + 1) * f_dim + f];
      // stage the slot: dz = dm ⊙ silu'(z) where dm is not 0, and which
      // edges carry a gradient (the 16 values of an edge lie in one half of
      // a warp)
      for (int r = 0; r * COLS < n_el; ++r) {
        const int i = r * COLS + tid;
        float v = 0.f, zz = 0.f;
        if (r < PF) {
#pragma unroll
          for (int q = 0; q < PF; ++q)
            if (q == r) v = pf_dm[q], zz = pf_z[q];
        } else if (i < n_el) {
          v = dm[row * n_el + i];
          zz = z[row * n_el + i];
        }
        if (i < n_el) sb.dz[i] = v == 0.f ? 0.f : v * dsilu(zz);
        const unsigned nz = __ballot_sync(FULL, v != 0.f);
        const int e0 = (r * COLS + 32 * warp) / M_OUT;
        if (lane == 0 && e0 < k_nbrs) sb.live[e0] = (nz & 0xFFFFu) != 0;
        if (lane == 0 && e0 + 1 < k_nbrs) sb.live[e0 + 1] = (nz >> 16) != 0;
      }
      for (int kk = tid; kk < k_nbrs; kk += COLS) {
        sb.idx[kk] = kk == tid ? pf_idx : static_cast<int>(idx[row * k_nbrs + kk]);
        sb.dist[kk] = kk == tid ? pf_dist : dist[row * k_nbrs + kk];
      }
      if (a + 1 < a_slots) prefetch(row + 1);
      __syncthreads();  // the slot is staged; every warp is done with slot a − 1

      if (a > 0) {  // ddist of slot a − 1: the block's warps in order
        const SlotBufs pb(bufs_s + ((a - 1) & 1) * bf, k_nbrs, WARPS_C);
        for (int kk = tid; kk < k_nbrs; kk += COLS) {
          float sum = 0.f;
          for (int w = 0; w < WARPS_C; ++w) sum += pb.dd[w * (k_nbrs + 1) + kk];
          ddist_part[(static_cast<size_t>(chunk) * g_rows * a_slots + row - 1) * k_nbrs + kk] =
              sum;
        }
      }
      if (chunk == 0 && tid < M_OUT)
        for (int kk = 0; kk < k_nbrs; ++kk) db1 += sb.dz[kk * M_OUT + tid];

      // this warp's list of the slot's live edges, padded with the zero edge
      // to a multiple of GROUP; its ddist terms 0 where nothing is added
      int n = 0;
      for (int w0 = 0; w0 < k_nbrs; w0 += 32) {
        const bool on = w0 + lane < k_nbrs && sb.live[w0 + lane];
        const unsigned bits = __ballot_sync(FULL, on);
        if (on) list[n + __popc(bits & ((1u << lane) - 1u))] = w0 + lane;
        n += __popc(bits);
      }
      const int n4 = (n + GROUP - 1) / GROUP * GROUP;
      if (lane < n4 - n) list[n + lane] = k_nbrs;
      for (int kk = lane; kk <= k_nbrs; kk += 32) sb.dd[warp * (k_nbrs + 1) + kk] = 0.f;
      __syncwarp();

      float dui_acc = 0.f;
      const float base = ui_a + b0f;
      for (int i0 = 0; i0 < n4; i0 += GROUP) {
        float dd[GROUP];
#pragma unroll
        for (int u = 0; u < GROUP; ++u) {
          const int kk = list[i0 + u];
          const int j = sb.idx[kk];
          const float d = sb.dist[kk];
          const float pre = base + ujn_s[j * COLS + tid] + d * wdf;
          const float s = sigmoid(pre);
          const float a1 = pre * s;
          const float4* dz4 = reinterpret_cast<const float4*>(sb.dz + kk * M_OUT);
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
          const float dpre = t * (s * (1.f + pre * (1.f - s)));  // 0 where !live or kk = K
          dui_acc += dpre;
          dujn_s[j * COLS + tid] += dpre;
          dwd = fmaf(dpre, d, dwd);
          db0 += dpre;
          dd[u] = dpre * wdf;
        }
        // lane (32 / GROUP)·u holds the warp's sum for edge u
        constexpr int SPAN = 32 / GROUP;
        const float r = warp_reduce_scatter<GROUP>(dd, lane);
        if (lane % SPAN == 0) sb.dd[warp * (k_nbrs + 1) + list[i0 + lane / SPAN]] = r;
      }
      if (live) dui[row * f_dim + f] = dui_acc;
    }
    __syncthreads();  // the row's last slot: its ddist
    const SlotBufs pb(bufs_s + ((a_slots - 1) & 1) * bf, k_nbrs, WARPS_C);
    for (int kk = tid; kk < k_nbrs; kk += COLS) {
      float sum = 0.f;
      for (int w = 0; w < WARPS_C; ++w) sum += pb.dd[w * (k_nbrs + 1) + kk];
      ddist_part[(static_cast<size_t>(chunk) * g_rows * a_slots + row0 + a_slots - 1) * k_nbrs +
                 kk] = sum;
    }
    if (live)
      for (int a = 0; a < a_slots; ++a)
        dujn[(row0 + a) * f_dim + f] = dujn_s[a * COLS + tid];
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

size_t bwd_smem(int a_slots, int k_nbrs, int cols) {
  return (static_cast<size_t>(a_slots) * 2 * cols + 2 * SlotBufs::floats(k_nbrs, cols / 32) +
          static_cast<size_t>(cols / 32) * ((k_nbrs + GROUP - 1) / GROUP * GROUP)) * sizeof(float);
}

// Kernel C's columns a block: the widest of 128, 64 and 32 whose shared
// memory fits a block; 0 if none does.
int bwd_cols(int a_slots, int k_nbrs) {
  for (int cols = 128; cols >= 32; cols /= 2)
    if (bwd_smem(a_slots, k_nbrs, cols) <= SMEM_MAX) return cols;
  return 0;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// out = silu(z) [G, A, K, M] (kernel B); where zout is not null, z itself
// too, for kernel C.
extern "C" int edge_mlp_fwd_f32(const float* ui, const float* ujn, const float* dist,
                                const int64_t* idx, const float* wd, const float* b0,
                                const float* w1, const float* b1, float* out, float* zout,
                                int g_rows, int a_slots, int k_nbrs, int f_dim,
                                int m_out, cudaStream_t stream) {
  if (m_out != M_OUT) return static_cast<int>(cudaErrorInvalidValue);
  if (g_rows <= 0 || a_slots <= 0 || k_nbrs <= 0) return 0;  // nothing to launch
  const size_t smem = fwd_smem(f_dim);
  cudaError_t err = allow_smem(edge_mlp_fwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  edge_mlp_fwd_kernel<<<g_rows, WARPS * 32, smem, stream>>>(
      ui, ujn, dist, idx, wd, b0, w1, b1, out, zout, a_slots, k_nbrs, f_dim);
  return static_cast<int>(cudaGetLastError());
}

// Floats of scratch that `edge_mlp_bwd_f32` needs: the parameter partials
// [ceil(G / BW_ROWS), F·(M + 2) + M] and the ddist partials
// [ceil(F / COLS), G·A·K].
extern "C" int edge_mlp_bwd_workspace_f32(int g_rows, int a_slots, int k_nbrs, int f_dim,
                                          int m_out, int64_t* floats) {
  const int cols = bwd_cols(a_slots, k_nbrs);
  if (m_out != M_OUT || g_rows < 0 || a_slots < 0 || k_nbrs < 0 || f_dim < 0 || cols == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t edges = static_cast<int64_t>(g_rows) * a_slots * k_nbrs;
  const int64_t row_blocks = (g_rows + BW_ROWS - 1) / BW_ROWS;
  const int64_t chunks = (f_dim + cols - 1) / cols;
  *floats = row_blocks * (static_cast<int64_t>(f_dim) * (M_OUT + 2) + M_OUT) + chunks * edges;
  return 0;
}

// Backward of edge_mlp_fwd_f32 for dm [G, A, K, M], with the forward's z
// [G, A, K, M]. Writes dui, dujn [G, A, F], ddist [G, A, K] and dparams =
// [dW1 (F·M) | dwd (F) | db0 (F) | db1 (M)]; `ws` holds
// edge_mlp_bwd_workspace_f32 floats.
extern "C" int edge_mlp_bwd_f32(const float* ui, const float* ujn, const float* dist,
                                const int64_t* idx, const float* wd, const float* b0,
                                const float* w1, const float* b1, const float* dm,
                                const float* z, float* dui, float* dujn, float* ddist,
                                float* dparams, float* ws, int g_rows, int a_slots, int k_nbrs,
                                int f_dim, int m_out, cudaStream_t stream) {
  if (m_out != M_OUT || z == nullptr) return static_cast<int>(cudaErrorInvalidValue);
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
  const int cols = bwd_cols(a_slots, k_nbrs);
  if (cols == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int row_blocks = (g_rows + BW_ROWS - 1) / BW_ROWS;
  const int chunks = (f_dim + cols - 1) / cols;
  float* param_part = ws;
  float* ddist_part = param_part + static_cast<int64_t>(row_blocks) * c_tot;

  // input gradients and per-block partial sums
  const size_t smem = bwd_smem(a_slots, k_nbrs, cols);
  const dim3 grid(row_blocks, chunks);
  auto launch = [&](auto kernel) {
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<grid, cols, smem, stream>>>(ui, ujn, dist, idx, wd, b0, w1, dm, z, dui, dujn,
                                         ddist_part, param_part, g_rows, a_slots, k_nbrs, f_dim);
    return cudaGetLastError();
  };
  err = cols == 128 ? launch(edge_mlp_bwd_kernel<128>)
      : cols == 64  ? launch(edge_mlp_bwd_kernel<64>)
                    : launch(edge_mlp_bwd_kernel<32>);
  if (err != cudaSuccess) return static_cast<int>(err);

  // the cross-block sums, in one launch
  return static_cast<int>(column_sums(SumJob{param_part, dparams, row_blocks, c_tot},
                                      SumJob{ddist_part, ddist, chunks, edges}, stream));
}
