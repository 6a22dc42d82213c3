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
// With an edge mask (the model's pair_mask), B computes
//   out = where(mask, silu(z), 0),
// and its backward is kernel C on dm·mask: a dead edge reaches no output.
//
// Bound on the H100: per edge and column f, the pre-activation and its SiLU
// (E·F = 404 M SiLU values at every edge, each two special-function
// operations, ex2 and a reciprocal, of which an SM issues 16 a clock:
// ~0.2 ms on that pipe alone) and the 16-wide product with W1 (2·E·F·M =
// 12.9 GFLOP). Device memory traffic is small: the forward reads ui and ujn
// (101 MB each) and writes 25 MB (50 MB with z).
//
// Forward design (kernel B): one block per molecule row g, 8 warps.
//  - Only live slots: the block lists the row's live edge tiles (16 edges
//    of a slot; a slot at k = 16 is one tile), a tile being live where one
//    of its edges is, writes 0 at every edge of the other tiles (52 % of
//    the slots hold no live edge at batch 768) and deals the live ones to
//    its warps, up to 4 each, 32 a pass over the columns.
//  - Neighbour rows in shared memory: the columns are staged CW at a time
//    (64, 32 or 16 columns, the widest that fits at A: A ≤ 300 / 617 /
//    1,138 slots at k = 16), with cp.async into two buffers, the next
//    chunk's copies in flight while this one computes: the row's ujn
//    [A][CW], ui of the pass's tiles, wd, b0 and W1's fragments. A
//    neighbour's row is a shared-memory read (it was 1.6 GB of L2 traffic
//    a call).
//  - The a1·W1 product on the tensor cores: a tile's 16 edges are the 16
//    rows of an m16n8k8 `mma.sync` (two n-tiles for the 16 outputs), in
//    3xTF32 (three TF32 products for each f32 one, `tf32_mma.cuh`; a1 split
//    by integer operations, cvt.rna's bits, 8 % faster than cvt.rna). Lane
//    4g + t forms a1 of edges g and g + 8 at columns c + 4t .. c + 3 of a
//    16-column group (float4 reads; k-step s takes c + 4t + 2s and + 1 as
//    k-indices t and t + 4, in A and B alike), in registers, as the A
//    fragment; W1's B fragments are split once a launch by a small kernel
//    into a workspace (`edge_mlp_w1_frags_kernel`) and staged with the
//    chunk, shared by the warp's tiles. Each 16-column group's sums start
//    from 0 in the C fragments and are added on the CUDA cores to the
//    chunk's, and those to the running sums (shared memory, in the
//    fragment layout): the tensor cores' adds truncate, and a sum carried
//    over the 8 k-steps of a chunk took B to 0.87 of its gate (kernel J's
//    finding).
//  - `__expf` and `__fdividef` in the SiLU.
// The warps write out = silu(z + b1) from the running sums, 0 at a dead
// edge of a live tile. When the caller trains, they also write z (25 MB) at
// the live edges, which kernel C then reads instead of computing the
// forward again (C never reads z where dm is 0, and dm·mask is 0 at every
// dead edge); serving passes no z pointer and writes nothing more. A tile's
// sums are taken in one fixed order whatever else is live, so out is the
// same bits at the live edges with the mask and without it, and the same
// bits with z written or not. M must be 16 (the EGNN message width); any
// F and K are taken, and A up to 1,138 at k = 16 (above it raises).
//
// Backward design (kernel C), for dm = dL/dout. C keeps its 16-wide
// products (dz·W1ᵀ, dW1) on the CUDA cores: they take ~0.6 ms of its ~2.1
// with every edge live (`ablate_kernels.py`, PERF.md §6). Per edge e and column f:
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
//
// bfloat16 (the models' --compute_dtype bfloat16): B and C are templates on
// the element type, with entry points `edge_mlp_fwd_bf16` and
// `edge_mlp_bwd_bf16` beside the f32 ones. What differs (loads, stores,
// activations and the products, on bf16 mma.sync) lies in `Elem` and in
// kernel C's `if constexpr (TC)` branches; see the bfloat16 section below.

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "column_sum.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int M_OUT = 16;  // message width m
constexpr unsigned FULL = 0xffffffffu;

// backward (kernel C); `ablate_kernels.py` rebuilds it with other values
constexpr int BW_ROWS = 2;        // molecule rows per block
constexpr int BW_MIN_BLOCKS = 5;  // blocks of 128 threads an SM its registers allow
constexpr int GROUP = 8;          // live edges a warp walks at once (a power of 2)

__device__ __forceinline__ float sigmoid(float x) { return __fdividef(1.f, 1.f + __expf(-x)); }

__device__ __forceinline__ float dsilu(float x) {
  const float s = sigmoid(x);
  return s * (1.f + x * (1.f - s));
}

// Kernel B's shape: FW_WARPS warps a block, each holding up to FW_TPW edge
// tiles (16 edges of a slot) at once, so that a pass over the columns
// covers FW_PASS tiles; `ablate_kernels.py` rebuilds it with other values.
constexpr int FW_WARPS = 8;
constexpr int FW_TPW = 4;
constexpr int FW_PASS = FW_WARPS * FW_TPW;
constexpr int FW_MIN_BLOCKS = 2;  // blocks an SM its registers allow

__device__ __forceinline__ float silu(float x) { return __fdividef(x, 1.f + __expf(-x)); }

// Kernel B's W1 as mma.sync B fragments, split for 3xTF32: for each group
// of 16 columns f (zero past F), n-tile j (outputs 8j..8j+7), part (0: big,
// 1: small) and lane 4g + t, the float4 of W1[16·grp + 4t + u][8j + g],
// u < 4, as TF32 bit patterns. Layout [grp][j][part][lane][4].
__global__ void edge_mlp_w1_frags_kernel(const float* __restrict__ w1, float* __restrict__ wfr,
                                         int f_dim, int n_grp) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // (grp, j, lane)
  if (i >= n_grp * 64) return;
  const int lane = i & 31, j = (i >> 5) & 1, grp = i >> 6;
  const int g = lane >> 2, t = lane & 3;
  float4 big, small;
  float* b = &big.x;
  float* s = &small.x;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int f = 16 * grp + 4 * t + u;
    uint32_t hi, lo;
    split_tf32(f < f_dim ? w1[static_cast<size_t>(f) * M_OUT + 8 * j + g] : 0.f, hi, lo);
    b[u] = as_float(hi);
    s[u] = as_float(lo);
  }
  float4* out = reinterpret_cast<float4*>(wfr) + ((grp * 2 + j) * 2) * 32 + lane;
  out[0] = big;
  out[32] = small;
}

// ------------------------------------------------------------ bfloat16
//
// B and C in bf16 compute the function of the TPU kernels' bf16 calls
// (`_dot(..., mm_bf16=True)`, `:51-62`): ui, ujn, dist, out, dm, dui, dujn
// and ddist are bf16; wd, b0, W1, b1, z and the parameter gradients f32.
// pre, its SiLU and every sum are f32; each product takes bf16 operands
// (a1, W1, dz rounded to nearest even) and sums in f32, on the tensor
// cores: in B one bf16 `mma.sync.m16n8k16` a 16-column group, where the f32
// route needs six TF32 ones (3xTF32, two k-steps); in C both 16-wide
// products (see the kernel). C sums dujn in f32 (JAX rounds dpre to bf16
// before its one-hot scatter, an artefact of the TPU's matrix unit) and
// writes dui, dujn and ddist in bf16, each from its f32 sum; its ujn chunk
// is staged in bf16, so that a row of A ≤ 1,164 slots fits at K = 16 (f32:
// 897).

// d += a · b for one m16n8k16 bf16 tile of the warp (row.col), f32 sums;
// the fragments as PTX lays them out, for lane 4g + t: a {(g, 2t..2t+1),
// (g+8, 2t..), (g, 2t+8..2t+9), (g+8, 2t+8..)}, b {(2t..2t+1, g),
// (2t+8..2t+9, g)}, d {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}, (row,
// column); the lower index of a pair in the low 16 bits.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
#endif
}

// (lo, hi) rounded to bf16 and packed, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// The bf16 kernels' activations, written as PyTorch's CUDA SiLU and its
// backward write them (accurate expf, IEEE division), and pre summed in the
// plain version's order, each operation rounded: a1 and dz are rounded to
// bf16 before their products, and an f32 value that differs in its last bit
// (the f32 kernels' __expf) would round to another bf16 value now and then.
__device__ __forceinline__ float pre_ref(float base, float uj, float d, float w) {
  return __fadd_rn(__fadd_rn(base, uj), __fmul_rn(d, w));
}
__device__ __forceinline__ float silu_ref(float x) { return x / (1.f + expf(-x)); }
__device__ __forceinline__ float dsilu_ref(float dy, float x) {  // dy · silu'(x)
  const float s = 1.f / (1.f + expf(-x));
  return dy * s * (1.f + x * (1.f - s));
}

// Kernel B's W1 in bf16 as mma.sync B fragments: for each group of 16
// columns f (zero past F), n-tile j and lane 4g + t, {W1[f0][n], W1[f0 +
// 1][n]} and {W1[f0 + 2][n], W1[f0 + 3][n]}, f0 = 16·grp + 4t, n = 8j + g:
// the lane's four consecutive columns are k-indices 2t, 2t + 1, 2t + 8,
// 2t + 9 (in A alike). Layout [grp][j][lane] of uint2: 512 bytes a group.
__global__ void edge_mlp_w1_frags_bf16_kernel(const float* __restrict__ w1,
                                              uint2* __restrict__ wfr, int f_dim, int n_grp) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // (grp, j, lane)
  if (i >= n_grp * 64) return;
  const int lane = i & 31, j = (i >> 5) & 1, grp = i >> 6;
  const int g = lane >> 2, t = lane & 3;
  float w[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int f = 16 * grp + 4 * t + u;
    w[u] = f < f_dim ? w1[static_cast<size_t>(f) * M_OUT + 8 * j + g] : 0.f;
  }
  wfr[i] = make_uint2(pack_bf16(w[0], w[1]), pack_bf16(w[2], w[3]));
}

// ------------------------------------------------------------ element types
//
// What B and C do otherwise in f32 and in bf16: an element's loads and
// stores, B's a1 and output SiLU, and B's product of a 16-column group
// against W1's fragments (`FRAG_FLOATS` floats a group in the workspace).
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int FRAG_FLOATS = 512;  // 3xTF32: big and small parts
  struct Frags {
    float4 wh[2], wl[2];
  };

  static __device__ __forceinline__ float f(float x) { return x; }
  static __device__ __forceinline__ float cast(float x) { return x; }
  // four consecutive elements at p (16 bytes)
  static __device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ float a1(float base, float uj, float d, float w) {
    return silu(base + uj + d * w);
  }
  // out[0..1] = silu(z0), silu(z1), or 0 at a dead edge
  static __device__ __forceinline__ void store_out(float* o, float z0, float z1, bool live) {
    *reinterpret_cast<float2*>(o) = live ? make_float2(silu(z0), silu(z1)) : make_float2(0.f, 0.f);
  }
  // the lane's B fragments of a group, for both n-tiles
  static __device__ __forceinline__ Frags frags(const float* group, int lane) {
    const float4* wf = reinterpret_cast<const float4*>(group) + lane;
    return {{wf[0], wf[64]}, {wf[32], wf[96]}};
  }
  // grp[j] = the group's sums from 0 for n-tile j: a1 of the lane's edges
  // g, g + 8 (v[0], v[1]) at its columns c .. c + 3, k-step s taking c + 2s
  // (as k-index t) and c + 2s + 1 (as t + 4), in A and B alike
  static __device__ __forceinline__ void product(float (&grp)[2][4], const float (&v)[2][4],
                                                 const Frags& w) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) grp[j][r] = 0.f;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      uint32_t ah[4], al[4];
      split_tf32_alu(v[0][2 * s], ah[0], al[0]);
      split_tf32_alu(v[1][2 * s], ah[1], al[1]);
      split_tf32_alu(v[0][2 * s + 1], ah[2], al[2]);
      split_tf32_alu(v[1][2 * s + 1], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float* hb = &w.wh[j].x;
        const float* lb = &w.wl[j].x;
        mma_3xtf32(grp[j], ah, al, __float_as_uint(hb[2 * s]), __float_as_uint(hb[2 * s + 1]),
                   __float_as_uint(lb[2 * s]), __float_as_uint(lb[2 * s + 1]));
      }
    }
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int FRAG_FLOATS = 128;
  struct Frags {
    uint2 wb[2];
  };

  static __device__ __forceinline__ float f(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ __nv_bfloat16 cast(float x) { return __float2bfloat16_rn(x); }
  static __device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = unpack_bf16(u.x), b = unpack_bf16(u.y);
    return make_float4(a.x, a.y, b.x, b.y);
  }
  static __device__ __forceinline__ float a1(float base, float uj, float d, float w) {
    return silu_ref(pre_ref(base, uj, d, w));
  }
  static __device__ __forceinline__ void store_out(__nv_bfloat16* o, float z0, float z1,
                                                   bool live) {
    *reinterpret_cast<uint32_t*>(o) = live ? pack_bf16(silu_ref(z0), silu_ref(z1)) : 0u;
  }
  static __device__ __forceinline__ Frags frags(const float* group, int lane) {
    const uint2* wf = reinterpret_cast<const uint2*>(group);
    return {{wf[lane], wf[32 + lane]}};
  }
  // the lane's columns c .. c + 3 are k-indices 2t, 2t + 1, 2t + 8, 2t + 9
  // of one m16n8k16 product, in A and B alike
  static __device__ __forceinline__ void product(float (&grp)[2][4], const float (&v)[2][4],
                                                 const Frags& w) {
    const uint32_t af[4] = {pack_bf16(v[0][0], v[0][1]), pack_bf16(v[1][0], v[1][1]),
                            pack_bf16(v[0][2], v[0][3]), pack_bf16(v[1][2], v[1][3])};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) grp[j][r] = 0.f;
      mma_bf16(grp[j], af, w.wb[j].x, w.wb[j].y);
    }
  }
};

// Bytes of kernel B's stage at CW columns: ujn [A][CW + pad] and ui
// [FW_PASS][CW] in T, wd and b0 [CW] in f32, W1's fragments; the pad keeps
// rows 16 bytes apart, and every part is a multiple of 16 bytes.
template <typename T>
__host__ __device__ constexpr int fwd_pitch(int cw) { return cw + 16 / static_cast<int>(sizeof(T)); }
template <typename T>
__host__ __device__ inline size_t fwd_stage_bytes(int a_slots, int cw) {
  return sizeof(T) * (static_cast<size_t>(a_slots) * fwd_pitch<T>(cw) + FW_PASS * cw) + 8 * cw +
         Elem<T>::FRAG_FLOATS / 4 * cw;
}

// Kernel B: see the file comment. Block = molecule row; CW columns a stage.
template <typename T, int CW>
__global__ void __launch_bounds__(FW_WARPS * 32, FW_MIN_BLOCKS)
edge_mlp_fwd_kernel(const T* __restrict__ ui, const T* __restrict__ ujn,
                    const T* __restrict__ dist, const int64_t* __restrict__ idx,
                    const uint8_t* __restrict__ emask, const float* __restrict__ wd,
                    const float* __restrict__ b0, const float* __restrict__ wfr,
                    const float* __restrict__ b1, T* __restrict__ out,
                    float* __restrict__ zout, int a_slots, int k_nbrs, int f_dim) {
  using E = Elem<T>;
  // a 4-byte copy takes EPW elements; out is zeroed 16 bytes (Q a tile row) at once
  constexpr int CWP = fwd_pitch<T>(CW), THREADS = FW_WARPS * 32;
  constexpr int EPW = 4 / sizeof(T), WORDS = CW / EPW, Q = M_OUT * sizeof(T) / 16;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tps = (k_nbrs + 15) / 16;  // edge tiles a slot
  const int n_tiles = a_slots * tps;
  const int f16 = (f_dim + 15) / 16 * 16;
  const int n_chunks = (f16 + CW - 1) / CW;
  const size_t sb = fwd_stage_bytes<T>(a_slots, CW);
  const size_t row0 = static_cast<size_t>(blockIdx.x) * a_slots;  // the row's first slot
  float* run_s = smem;                                            // [FW_PASS][2][32][4]
  unsigned char* stage_s = reinterpret_cast<unsigned char*>(run_s + FW_PASS * 256);  // [2][sb]
  int* list_s = reinterpret_cast<int*>(stage_s + 2 * sb);  // [n_tiles]: the live tiles
  int* flag_s = list_s + n_tiles;                          // [n_tiles]: 1 where live
  int* count_s = flag_s + n_tiles;

  // the row's live tiles in order (with no mask: every tile); a tile is
  // live where one of its edges is
  if (warp == 0) {
    int n = 0;
    for (int b = 0; b < n_tiles; b += 32) {
      const int tile = b + lane;
      bool on = tile < n_tiles && !emask;
      if (tile < n_tiles && emask) {
        const int a = tile / tps, e0 = (tile - a * tps) * 16;
        const uint8_t* m = emask + (row0 + a) * k_nbrs;
        for (int e = e0; e < min(e0 + 16, k_nbrs); ++e) on |= m[e] != 0;
      }
      const unsigned bits = __ballot_sync(FULL, on);
      if (on) list_s[n + __popc(bits & ((1u << lane) - 1u))] = tile;
      if (tile < n_tiles) flag_s[tile] = on;
      n += __popc(bits);
    }
    if (lane == 0) *count_s = n;
  }
  __syncthreads();
  const int n_live = *count_s;
  // out = 0 at every edge of a dead tile (z is not written there)
  if (n_live < n_tiles) {
    const size_t o0 = row0 * k_nbrs * M_OUT;
    for (int i = tid; i < a_slots * k_nbrs * Q; i += THREADS) {
      const int edge = i / Q, a = edge / k_nbrs;
      if (!flag_s[a * tps + (edge - a * k_nbrs) / 16])
        reinterpret_cast<uint4*>(out + o0)[i] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  float b1v[2][2];  // b1 at the lane's output columns 8j + 2t, + 1
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    b1v[j][0] = b1[8 * j + 2 * t];
    b1v[j][1] = b1[8 * j + 2 * t + 1];
  }

  for (int p0 = 0; p0 < n_live; p0 += FW_PASS) {
    const int n_pass = min(FW_PASS, n_live - p0);
    // this warp's tiles: pass places warp + FW_WARPS·i, i < mine
    const int mine = n_pass > warp ? (n_pass - warp + FW_WARPS - 1) / FW_WARPS : 0;
    // rows g and g + 8 of each (edges e0 + g, e0 + g + 8): the neighbour's
    // offset in the ujn stage and the distance. A row past k (a tile of a
    // slot with k < 16 neighbours) reads slot 0 at distance 0: its values
    // reach only its own row of the product, which is not written
    int jo[FW_TPW][2];
    float dd[FW_TPW][2];
#pragma unroll
    for (int i = 0; i < FW_TPW; ++i) {
      const int tile = i < mine ? list_s[p0 + warp + FW_WARPS * i] : 0;
      const int a = tile / tps, e0 = (tile - a * tps) * 16;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = e0 + g + 8 * h;
        const bool ex = i < mine && e < k_nbrs;
        const size_t at = (row0 + a) * k_nbrs + e;
        jo[i][h] = ex ? static_cast<int>(idx[at]) * CWP : 0;
        dd[i][h] = ex ? E::f(dist[at]) : 0.f;
      }
      if (i < mine) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
          reinterpret_cast<float4*>(run_s)[((warp + FW_WARPS * i) * 2 + j) * 32 + lane] =
              make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }

    // stage `chunk` (columns c0 .. c0 + CW, zero past F) into buffer `buf`,
    // the rows EPW elements a copy (F a multiple of EPW)
    auto stage = [&](int buf, int chunk) {
      T* ujn_st = reinterpret_cast<T*>(stage_s + buf * sb);
      T* ui_st = ujn_st + a_slots * CWP;
      float* wd_st = reinterpret_cast<float*>(ui_st + FW_PASS * CW);
      float* b0_st = wd_st + CW;
      float* wfr_st = b0_st + CW;
      const int c0 = chunk * CW;
      for (int i = tid; i < a_slots * WORDS; i += THREADS) {
        const int a = i / WORDS, f = c0 + EPW * (i - a * WORDS);
        cp_async<4>(reinterpret_cast<float*>(ujn_st + a * CWP + f - c0),
                    reinterpret_cast<const float*>(ujn + (row0 + a) * f_dim + min(f, f_dim - EPW)),
                    f < f_dim);
      }
      for (int pt = warp; pt < n_pass; pt += FW_WARPS) {  // a warp a tile's ui row
        const T* src = ui + (row0 + list_s[p0 + pt] / tps) * f_dim;
        for (int q = lane; q < WORDS; q += 32) {
          const int f = c0 + EPW * q;
          cp_async<4>(reinterpret_cast<float*>(ui_st + pt * CW + EPW * q),
                      reinterpret_cast<const float*>(src + min(f, f_dim - EPW)), f < f_dim);
        }
      }
      for (int c = tid; c < CW; c += THREADS) {
        const int f = min(c0 + c, f_dim - 1);
        cp_async<4>(wd_st + c, wd + f, c0 + c < f_dim);
        cp_async<4>(b0_st + c, b0 + f, c0 + c < f_dim);
      }
      const int n_grp = min(CW, f16 - c0) / 16;
      for (int i = tid; i < n_grp * E::FRAG_FLOATS / 4; i += THREADS)
        cp_async<16>(wfr_st + 4 * i, wfr + static_cast<size_t>(c0 / 16) * E::FRAG_FLOATS + 4 * i,
                     true);
      cp_async_commit();
    };

    if (n_chunks > 0) stage(0, 0);
    for (int ch = 0; ch < n_chunks; ++ch) {
      if (ch + 1 < n_chunks) {
        stage((ch + 1) & 1, ch + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // the chunk's stage is complete

      const T* ujn_st = reinterpret_cast<const T*>(stage_s + (ch & 1) * sb);
      const T* ui_st = ujn_st + a_slots * CWP;
      const float* wd_st = reinterpret_cast<const float*>(ui_st + FW_PASS * CW);
      const float* b0_st = wd_st + CW;
      const float* wfr_st = b0_st + CW;
      const int n_grp = min(CW, f16 - ch * CW) / 16;
      // the chunk's sums from 0, in the mma's C fragments (n-tiles j = 0, 1)
      float acc[FW_TPW][2][4];
#pragma unroll
      for (int i = 0; i < FW_TPW; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
      for (int gi = 0; gi < n_grp; ++gi) {
        // columns c .. c + 3 of the lane
        const int c = gi * 16 + 4 * t;
        const float4 wd4 = *reinterpret_cast<const float4*>(wd_st + c);
        const float4 b04 = *reinterpret_cast<const float4*>(b0_st + c);
        const typename E::Frags wf = E::frags(wfr_st + gi * E::FRAG_FLOATS, lane);
#pragma unroll
        for (int i = 0; i < FW_TPW; ++i) {
          if (i >= mine) break;  // warp-uniform
          const float4 u4 = E::load4(ui_st + (warp + FW_WARPS * i) * CW + c);
          const float base[4] = {u4.x + b04.x, u4.y + b04.y, u4.z + b04.z, u4.w + b04.w};
          const float w4[4] = {wd4.x, wd4.y, wd4.z, wd4.w};
          float v[2][4];  // a1 of edges g, g + 8 at the lane's 4 columns
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float4 j4 = E::load4(ujn_st + jo[i][h] + c);
            const float jv[4] = {j4.x, j4.y, j4.z, j4.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) v[h][u] = E::a1(base[u], jv[u], dd[i][h], w4[u]);
          }
          // the group's sums from 0 on the tensor cores (their adds truncate,
          // so a sum carried over many k-steps drifts), then added to the
          // chunk's on the CUDA cores
          float grp[2][4];
          E::product(grp, v, wf);
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[i][j][r] += grp[j][r];
        }
      }
      // the chunk's sums added to the running sums on the CUDA cores
#pragma unroll
      for (int i = 0; i < FW_TPW; ++i) {
        if (i >= mine) break;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float4* r = reinterpret_cast<float4*>(run_s) + ((warp + FW_WARPS * i) * 2 + j) * 32 + lane;
          float4 v = *r;
          v.x += acc[i][j][0];
          v.y += acc[i][j][1];
          v.z += acc[i][j][2];
          v.w += acc[i][j][3];
          *r = v;
        }
      }
      __syncthreads();  // every warp is done with the buffer the next stage fills
    }

    // z = the sums + b1; out = silu(z), 0 at a dead edge of a live tile; z
    // (f32) where the caller asks for it, at the live edges
#pragma unroll
    for (int i = 0; i < FW_TPW; ++i) {
      if (i >= mine) break;
      const int tile = list_s[p0 + warp + FW_WARPS * i];
      const int a = tile / tps, e0 = (tile - a * tps) * 16;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = e0 + g + 8 * h;
        if (e >= k_nbrs) continue;
        const size_t at = (row0 + a) * k_nbrs + e;
        const bool live = !emask || emask[at];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float4 r =
              reinterpret_cast<const float4*>(run_s)[((warp + FW_WARPS * i) * 2 + j) * 32 + lane];
          const float z0 = (h ? r.z : r.x) + b1v[j][0], z1 = (h ? r.w : r.y) + b1v[j][1];
          const size_t o = at * M_OUT + 8 * j + 2 * t;
          E::store_out(out + o, z0, z1, live);
          if (zout && live) *reinterpret_cast<float2*>(zout + o) = make_float2(z0, z1);
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
// warps' ddist terms; in bf16 also dz rounded to bf16, as [KT][16] and
// transposed [16][KT + 8], for the tensor cores (KT = K rounded up to 16;
// rows past K are 0).
template <typename T>
struct SlotBufs {
  static constexpr bool BF = std::is_same<T, __nv_bfloat16>::value;
  float* dz;    // [K + 1][M_OUT]
  float* dist;  // [K + 1]
  float* dd;    // [warps][K + 1]
  int* idx;     // [K + 1]
  int* live;    // [K]
  __nv_bfloat16* dzb;  // bf16: [KT][16]
  __nv_bfloat16* dzt;  // bf16: [16][KT + 8]

  static __host__ __device__ int kt(int k) { return (k + 15) / 16 * 16; }
  // a multiple of 4: dz is read as float4
  static __host__ __device__ size_t floats(int k, int warps) {
    return (static_cast<size_t>(k + 1) * (M_OUT + 2 + warps) + k + 3) / 4 * 4;
  }
  static __host__ __device__ size_t bytes(int k, int warps) {
    return floats(k, warps) * 4 +
           (BF ? static_cast<size_t>(kt(k)) * 16 * 2 +
                     (16 * static_cast<size_t>(kt(k) + 8) * 2 + 15) / 16 * 16
               : 0);
  }
  __device__ SlotBufs(unsigned char* at, int k, int warps)
      : dz(reinterpret_cast<float*>(at)), dist(dz + (k + 1) * M_OUT), dd(dist + k + 1),
        idx(reinterpret_cast<int*>(dd + warps * (k + 1))), live(idx + k + 1),
        dzb(reinterpret_cast<__nv_bfloat16*>(at + floats(k, warps) * 4)), dzt(dzb + kt(k) * 16) {}
};

constexpr int PF = 2;  // rounds of a slot's dm and z a thread loads ahead (K ≤ 16)

// Bytes of kernel C's per-warp buffers: in bf16 t [KT][32] f32 and a1
// [32][KT + 8] bf16 (see the kernel); none in f32.
template <typename T>
__host__ __device__ inline size_t bwd_warp_bytes(int k) {
  const size_t kt = SlotBufs<T>::kt(k);
  return SlotBufs<T>::BF ? kt * 32 * 4 + 32 * (kt + 8) * 2 : 0;
}

// Bytes of kernel C's shared memory before its slot buffers: dujn [A][COLS]
// in f32 and the row's ujn chunk [A][COLS] in T.
template <typename T>
__host__ __device__ inline size_t bwd_rows_bytes(int a_slots, int cols) {
  return (static_cast<size_t>(a_slots) * cols * (4 + sizeof(T)) + 15) / 16 * 16;
}

// Kernel C: see the file comment. Grid (ceil(G / BW_ROWS), ceil(F /
// COLS)), COLS threads; dynamic shared memory bwd_smem<T>(A, K, COLS) bytes.
// Its two 16-wide products, dz·W1ᵀ and dW1 = Σ a1ᵀ·dz: in f32 on the CUDA
// cores, in the walk over the slot's live edges, the thread keeping W1[f, :]
// and its sums of dW1[f, :] in registers. In bf16 (TC) both on the tensor
// cores; per slot, each warp (its 32 columns):
//  - t = dz·W1ᵀ for the slot's edges, a tile of 16 edges by 8 columns an
//    mma (W1's B fragments held in registers for the block), into the
//    warp's [KT][32] f32 buffer, which the walk reads for dpre = t ⊙
//    silu'(pre);
//  - the walk writes bf16(a1) into the warp's [32][KT + 8] buffer (a row a
//    column), and dW1 += a1ᵀ·dz is a [16 columns × 16 edges] by [16 edges
//    × 8] mma per m- and n-tile, the slot's sums from 0 on the tensor cores
//    and added to the running sums (registers, in the fragment layout) on
//    the CUDA cores.
// Both products are skipped for a slot with no live edge.
template <typename T, int COLS>
__global__ void __launch_bounds__(COLS, BW_MIN_BLOCKS * 128 / COLS)
edge_mlp_bwd_kernel(const T* __restrict__ ui, const T* __restrict__ ujn,
                    const T* __restrict__ dist, const int64_t* __restrict__ idx,
                    const float* __restrict__ wd, const float* __restrict__ b0,
                    const float* __restrict__ w1, const T* __restrict__ dm,
                    const float* __restrict__ z, T* __restrict__ dui,
                    T* __restrict__ dujn, float* __restrict__ ddist_part,
                    float* __restrict__ param_part, int g_rows, int a_slots, int k_nbrs,
                    int f_dim) {
  using E = Elem<T>;
  using Bufs = SlotBufs<T>;
  constexpr bool TC = Bufs::BF;
  constexpr int WARPS_C = COLS / 32;
  extern __shared__ __align__(16) float smem[];
  float* dujn_s = smem;                                      // [A][COLS]
  T* ujn_s = reinterpret_cast<T*>(dujn_s + a_slots * COLS);  // [A][COLS]: the row's ujn chunk
  unsigned char* bufs_s =                                    // [2][Bufs::bytes(K, WARPS_C)]
      reinterpret_cast<unsigned char*>(smem) + bwd_rows_bytes<T>(a_slots, COLS);
  const size_t bb = Bufs::bytes(k_nbrs, WARPS_C);
  const int lpad = (k_nbrs + GROUP - 1) / GROUP * GROUP;  // a live list padded to groups
  int* list_s = reinterpret_cast<int*>(bufs_s + 2 * bb);  // [WARPS_C][lpad]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = blockIdx.y;
  const int c0 = static_cast<int>(static_cast<int64_t>(chunk) * f_dim / gridDim.y);
  const int c1 = static_cast<int>(static_cast<int64_t>(chunk + 1) * f_dim / gridDim.y);
  const int f = c0 + tid;
  const bool live = f < c1;
  const int n_el = k_nbrs * M_OUT;
  int* list = list_s + warp * lpad;
  // bf16: the warp's t and a1 buffers, after the lists
  const int kt = Bufs::kt(k_nbrs), n_et = kt / 16, tp = kt + 8;
  const int g8 = lane >> 2, t4 = lane & 3;
  float* t_s = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(list_s) +
      (static_cast<size_t>(WARPS_C) * lpad * 4 + 15) / 16 * 16 + warp * bwd_warp_bytes<T>(k_nbrs));
  __nv_bfloat16* a1_s = reinterpret_cast<__nv_bfloat16*>(t_s + kt * 32);

  for (int b = 0; b < 2; ++b) {  // the zero edge K, and bf16 dz rows past K
    const Bufs sb(bufs_s + b * bb, k_nbrs, WARPS_C);
    for (int i = tid; i <= M_OUT; i += COLS) {
      if (i < M_OUT) sb.dz[k_nbrs * M_OUT + i] = 0.f;
      else sb.dist[k_nbrs] = 0.f, sb.idx[k_nbrs] = 0;
    }
    if constexpr (TC) {
      for (int i = k_nbrs * M_OUT + tid; i < kt * M_OUT; i += COLS) {
        const int e = i / M_OUT, j = i - e * M_OUT;
        sb.dzb[i] = __float2bfloat16_rn(0.f);
        sb.dzt[j * tp + e] = __float2bfloat16_rn(0.f);
      }
    }
  }
  if constexpr (TC)
    for (int e = 0; e < tp; ++e) a1_s[lane * tp + e] = __float2bfloat16_rn(0.f);

  // f32: W1[f, :] and the thread's dW1[f, :] sums. bf16: W1ᵀ's B fragments
  // of the warp's 4 n-tiles (columns 8nt + g8 of its 32: {W1[f][2t],
  // W1[f][2t + 1]}, {W1[f][2t + 8], W1[f][2t + 9]}), and dW1 of the warp's
  // columns as C fragments [m-tile][n-tile]. The other type's are 1 long.
  float w1f[TC ? 1 : M_OUT], dw1[TC ? 1 : M_OUT];
  uint32_t wb[TC ? 4 : 1][2];
  float dw1t[TC ? 2 : 1][2][4];
  if constexpr (TC) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int fc = c0 + 32 * warp + 8 * nt + g8;
      const float* wr = w1 + static_cast<size_t>(fc) * M_OUT + 2 * t4;
      const bool in = fc < c1;
      wb[nt][0] = in ? pack_bf16(wr[0], wr[1]) : 0u;
      wb[nt][1] = in ? pack_bf16(wr[8], wr[9]) : 0u;
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) dw1t[mt][nt][r] = 0.f;
  } else {
#pragma unroll
    for (int j = 0; j < M_OUT; ++j) {
      w1f[j] = live ? w1[static_cast<size_t>(f) * M_OUT + j] : 0.f;
      dw1[j] = 0.f;
    }
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
      pf_dm[r] = i < n_el ? E::f(dm[row * n_el + i]) : 0.f;
      pf_z[r] = i < n_el && pf_dm[r] != 0.f ? z[row * n_el + i] : 0.f;
    }
    if (tid < k_nbrs) {
      pf_idx = static_cast<int>(idx[row * k_nbrs + tid]);
      pf_dist = E::f(dist[row * k_nbrs + tid]);
    }
  };

  const int g_end = min(g_rows, (static_cast<int>(blockIdx.x) + 1) * BW_ROWS);
  for (int g = blockIdx.x * BW_ROWS; g < g_end; ++g) {
    // the thread's own column of dujn and of the row's ujn (no other thread
    // reads it: no barrier)
    const T* ujn_g = ujn + static_cast<size_t>(g) * a_slots * f_dim;
    for (int a = 0; a < a_slots; ++a) {
      dujn_s[a * COLS + tid] = 0.f;
      ujn_s[a * COLS + tid] = live ? ujn_g[static_cast<size_t>(a) * f_dim + f] : E::cast(0.f);
    }
    const size_t row0 = static_cast<size_t>(g) * a_slots;
    float ui_next = live ? E::f(ui[row0 * f_dim + f]) : 0.f;
    prefetch(row0);

    for (int a = 0; a < a_slots; ++a) {
      const size_t row = row0 + a;
      const Bufs sb(bufs_s + (a & 1) * bb, k_nbrs, WARPS_C);
      const float ui_a = ui_next;
      if (live && a + 1 < a_slots) ui_next = E::f(ui[(row + 1) * f_dim + f]);
      // stage the slot: dz = dm ⊙ silu'(z) where dm is not 0 (bf16: also
      // rounded, as rows and transposed), and which edges carry a gradient
      // (the 16 values of an edge lie in one half of a warp)
      for (int r = 0; r * COLS < n_el; ++r) {
        const int i = r * COLS + tid;
        float v = 0.f, zz = 0.f;
        if (r < PF) {
#pragma unroll
          for (int q = 0; q < PF; ++q)
            if (q == r) v = pf_dm[q], zz = pf_z[q];
        } else if (i < n_el) {
          v = E::f(dm[row * n_el + i]);
          zz = z[row * n_el + i];
        }
        if constexpr (TC) {
          if (i < n_el) {
            const float d = v == 0.f ? 0.f : dsilu_ref(v, zz);
            const int e = i / M_OUT, j = i - e * M_OUT;
            sb.dz[i] = d;
            sb.dzb[i] = __float2bfloat16_rn(d);
            sb.dzt[j * tp + e] = __float2bfloat16_rn(d);
          }
        } else {
          if (i < n_el) sb.dz[i] = v == 0.f ? 0.f : v * dsilu(zz);
        }
        const unsigned nz = __ballot_sync(FULL, v != 0.f);
        const int e0 = (r * COLS + 32 * warp) / M_OUT;
        if (lane == 0 && e0 < k_nbrs) sb.live[e0] = (nz & 0xFFFFu) != 0;
        if (lane == 0 && e0 + 1 < k_nbrs) sb.live[e0 + 1] = (nz >> 16) != 0;
      }
      for (int kk = tid; kk < k_nbrs; kk += COLS) {
        sb.idx[kk] = kk == tid ? pf_idx : static_cast<int>(idx[row * k_nbrs + kk]);
        sb.dist[kk] = kk == tid ? pf_dist : E::f(dist[row * k_nbrs + kk]);
      }
      if (a + 1 < a_slots) prefetch(row + 1);
      __syncthreads();  // the slot is staged; every warp is done with slot a − 1

      if (a > 0) {  // ddist of slot a − 1: the block's warps in order
        const Bufs pb(bufs_s + ((a - 1) & 1) * bb, k_nbrs, WARPS_C);
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
      if constexpr (TC) {
        if (n > 0) {  // t = dz·W1ᵀ of the slot's edges at the warp's columns
          for (int et = 0; et < n_et; ++et) {
            const __nv_bfloat16* ar = sb.dzb + (16 * et + g8) * M_OUT + 2 * t4;
            const uint32_t af[4] = {*reinterpret_cast<const uint32_t*>(ar),
                                    *reinterpret_cast<const uint32_t*>(ar + 8 * M_OUT),
                                    *reinterpret_cast<const uint32_t*>(ar + 8),
                                    *reinterpret_cast<const uint32_t*>(ar + 8 * M_OUT + 8)};
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              float c[4] = {0.f, 0.f, 0.f, 0.f};
              mma_bf16(c, af, wb[nt][0], wb[nt][1]);
              float* tr = t_s + (16 * et + g8) * 32 + 8 * nt + 2 * t4;
              *reinterpret_cast<float2*>(tr) = make_float2(c[0], c[1]);
              *reinterpret_cast<float2*>(tr + 8 * 32) = make_float2(c[2], c[3]);
            }
          }
        }
      }
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
          float dpre;  // 0 where !live or kk = K
          if constexpr (TC) {
            const float pre = pre_ref(base, E::f(ujn_s[j * COLS + tid]), d, wdf);
            const float t = kk < k_nbrs ? t_s[kk * 32 + lane] : 0.f;
            if (kk < k_nbrs) a1_s[lane * tp + kk] = __float2bfloat16_rn(silu_ref(pre));
            dpre = dsilu_ref(t, pre);
          } else {
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
            dpre = t * (s * (1.f + pre * (1.f - s)));
          }
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
      if (live) dui[row * f_dim + f] = E::cast(dui_acc);

      if constexpr (TC) {
        __syncwarp();
        if (n > 0) {  // dW1 += a1ᵀ·dz: the slot's sums from 0, then added
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              float c[4] = {0.f, 0.f, 0.f, 0.f};
              for (int et = 0; et < n_et; ++et) {
                const __nv_bfloat16* ar = a1_s + (16 * mt + g8) * tp + 16 * et + 2 * t4;
                const uint32_t af[4] = {*reinterpret_cast<const uint32_t*>(ar),
                                        *reinterpret_cast<const uint32_t*>(ar + 8 * tp),
                                        *reinterpret_cast<const uint32_t*>(ar + 8),
                                        *reinterpret_cast<const uint32_t*>(ar + 8 * tp + 8)};
                const __nv_bfloat16* br = sb.dzt + (8 * nt + g8) * tp + 16 * et + 2 * t4;
                mma_bf16(c, af, *reinterpret_cast<const uint32_t*>(br),
                         *reinterpret_cast<const uint32_t*>(br + 8));
              }
#pragma unroll
              for (int r = 0; r < 4; ++r) dw1t[mt][nt][r] += c[r];
            }
        }
      }
    }
    __syncthreads();  // the row's last slot: its ddist
    const Bufs pb(bufs_s + ((a_slots - 1) & 1) * bb, k_nbrs, WARPS_C);
    for (int kk = tid; kk < k_nbrs; kk += COLS) {
      float sum = 0.f;
      for (int w = 0; w < WARPS_C; ++w) sum += pb.dd[w * (k_nbrs + 1) + kk];
      ddist_part[(static_cast<size_t>(chunk) * g_rows * a_slots + row0 + a_slots - 1) * k_nbrs +
                 kk] = sum;
    }
    if (live)
      for (int a = 0; a < a_slots; ++a)
        dujn[(row0 + a) * f_dim + f] = E::cast(dujn_s[a * COLS + tid]);
  }

  // this block's partial parameter sums: row blockIdx.x of the workspace,
  // laid out as the concatenated output [dW1 (F·M) | dwd (F) | db0 (F) | db1 (M)]
  float* part = param_part +
      static_cast<size_t>(blockIdx.x) * (static_cast<size_t>(f_dim) * (M_OUT + 2) + M_OUT);
  if constexpr (TC) {  // lane 4g + t holds columns 16mt + g (+ 8) and outputs 8nt + 2t (+ 1)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int fc = c0 + 32 * warp + 16 * mt + g8 + 8 * h;
        if (fc >= c1) continue;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          *reinterpret_cast<float2*>(part + static_cast<size_t>(fc) * M_OUT + 8 * nt + 2 * t4) =
              make_float2(dw1t[mt][nt][2 * h], dw1t[mt][nt][2 * h + 1]);
      }
  } else if (live) {
#pragma unroll
    for (int j = 0; j < M_OUT; ++j) part[static_cast<size_t>(f) * M_OUT + j] = dw1[j];
  }
  if (live) {
    part[static_cast<size_t>(f_dim) * M_OUT + f] = dwd;
    part[static_cast<size_t>(f_dim) * (M_OUT + 1) + f] = db0;
  }
  if (chunk == 0 && tid < M_OUT) part[static_cast<size_t>(f_dim) * (M_OUT + 2) + tid] = db1;
}

// Kernel B's shared memory in bytes at `cw` columns a stage.
template <typename T>
size_t fwd_smem(int a_slots, int k_nbrs, int cw) {
  const size_t tiles = static_cast<size_t>(a_slots) * ((k_nbrs + 15) / 16);
  return FW_PASS * 256 * sizeof(float) + 2 * fwd_stage_bytes<T>(a_slots, cw) +
         (2 * tiles + 1) * sizeof(int);
}

// Kernel B's columns a stage: the widest of 64, 32 and 16 whose shared
// memory fits a block (f32: A ≤ 300, 617 and 1,138 slots at k = 16; bf16:
// 629, 1,148 and 1,887); 0 if none does.
template <typename T>
int fwd_cols(int a_slots, int k_nbrs) {
  for (int cw = 64; cw >= 16; cw /= 2)
    if (fwd_smem<T>(a_slots, k_nbrs, cw) <= MAX_SMEM) return cw;
  return 0;
}

// Kernel C's shared memory in bytes at `cols` columns a block: the rows,
// two slot buffers, each warp's live list and, in bf16, each warp's t
// [KT][32] f32 and a1 [32][KT + 8] bf16.
template <typename T>
size_t bwd_smem(int a_slots, int k_nbrs, int cols) {
  const int warps = cols / 32;
  const size_t lists = static_cast<size_t>(warps) * ((k_nbrs + GROUP - 1) / GROUP * GROUP) * 4;
  const size_t own = bwd_warp_bytes<T>(k_nbrs);
  return bwd_rows_bytes<T>(a_slots, cols) + 2 * SlotBufs<T>::bytes(k_nbrs, warps) +
         (own ? (lists + 15) / 16 * 16 + warps * own : lists);
}

// Kernel C's columns a block: the widest of 128, 64 and 32 whose shared
// memory fits a block (f32: A ≤ 223, 448 and 897 slots at K = 16; bf16:
// 1,164 at 32); 0 if none does.
template <typename T>
int bwd_cols(int a_slots, int k_nbrs) {
  for (int cols = 128; cols >= 32; cols /= 2)
    if (bwd_smem<T>(a_slots, k_nbrs, cols) <= MAX_SMEM) return cols;
  return 0;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Kernel B's launch, after the entry point's checks: W1's fragments into
// `ws`, then B at the widest stage that fits.
template <typename T>
int fwd_launch(const T* ui, const T* ujn, const T* dist, const int64_t* idx,
               const uint8_t* emask, const float* wd, const float* b0, const float* w1,
               const float* b1, T* out, float* zout, float* ws, int g_rows, int a_slots,
               int k_nbrs, int f_dim, cudaStream_t stream) {
  if (g_rows <= 0 || a_slots <= 0 || k_nbrs <= 0) return 0;  // nothing to launch
  const int cw = fwd_cols<T>(a_slots, k_nbrs);
  if (cw == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n_grp = (f_dim + 15) / 16;
  if (n_grp > 0) {
    const int blocks = (n_grp * 64 + 255) / 256;
    if constexpr (std::is_same<T, float>::value)
      edge_mlp_w1_frags_kernel<<<blocks, 256, 0, stream>>>(w1, ws, f_dim, n_grp);
    else
      edge_mlp_w1_frags_bf16_kernel<<<blocks, 256, 0, stream>>>(w1, reinterpret_cast<uint2*>(ws),
                                                                 f_dim, n_grp);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t smem = fwd_smem<T>(a_slots, k_nbrs, cw);
  auto launch = [&](auto kernel) {
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<g_rows, FW_WARPS * 32, smem, stream>>>(ui, ujn, dist, idx, emask, wd, b0, ws, b1,
                                                    out, zout, a_slots, k_nbrs, f_dim);
    return cudaGetLastError();
  };
  return static_cast<int>(cw == 64   ? launch(edge_mlp_fwd_kernel<T, 64>)
                          : cw == 32 ? launch(edge_mlp_fwd_kernel<T, 32>)
                                     : launch(edge_mlp_fwd_kernel<T, 16>));
}

// Floats of scratch that kernel C needs: the parameter partials
// [ceil(G / BW_ROWS), F·(M + 2) + M] and the ddist partials
// [ceil(F / COLS), G·A·K].
template <typename T>
int bwd_workspace(int g_rows, int a_slots, int k_nbrs, int f_dim, int m_out, int64_t* floats) {
  const int cols = bwd_cols<T>(a_slots, k_nbrs);
  if (m_out != M_OUT || g_rows < 0 || a_slots < 0 || k_nbrs < 0 || f_dim < 0 || cols == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t edges = static_cast<int64_t>(g_rows) * a_slots * k_nbrs;
  const int64_t row_blocks = (g_rows + BW_ROWS - 1) / BW_ROWS;
  const int64_t chunks = (f_dim + cols - 1) / cols;
  *floats = row_blocks * (static_cast<int64_t>(f_dim) * (M_OUT + 2) + M_OUT) + chunks * edges;
  return 0;
}

// Kernel C's launch and the cross-block sums; ddist is rounded to T there.
template <typename T>
int bwd_launch(const T* ui, const T* ujn, const T* dist, const int64_t* idx, const float* wd,
               const float* b0, const float* w1, const T* dm, const float* z, T* dui, T* dujn,
               T* ddist, float* dparams, float* ws, int g_rows, int a_slots, int k_nbrs,
               int f_dim, int m_out, cudaStream_t stream) {
  if (m_out != M_OUT || z == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t c_tot = static_cast<int64_t>(f_dim) * (M_OUT + 2) + M_OUT;
  const int64_t edges = static_cast<int64_t>(g_rows) * a_slots * k_nbrs;
  const int64_t nodes = static_cast<int64_t>(g_rows) * a_slots * f_dim;
  cudaError_t err;
  if (g_rows <= 0 || a_slots <= 0 || k_nbrs <= 0 || f_dim <= 0) {  // no edge: all zero
    err = cudaMemsetAsync(dparams, 0, c_tot * sizeof(float), stream);
    if (err == cudaSuccess && nodes > 0) err = cudaMemsetAsync(dui, 0, nodes * sizeof(T), stream);
    if (err == cudaSuccess && nodes > 0) err = cudaMemsetAsync(dujn, 0, nodes * sizeof(T), stream);
    if (err == cudaSuccess && edges > 0) err = cudaMemsetAsync(ddist, 0, edges * sizeof(T), stream);
    return static_cast<int>(err);
  }
  const int cols = bwd_cols<T>(a_slots, k_nbrs);
  if (cols == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int row_blocks = (g_rows + BW_ROWS - 1) / BW_ROWS;
  const int chunks = (f_dim + cols - 1) / cols;
  float* param_part = ws;
  float* ddist_part = param_part + static_cast<int64_t>(row_blocks) * c_tot;

  // input gradients and per-block partial sums
  const size_t smem = bwd_smem<T>(a_slots, k_nbrs, cols);
  const dim3 grid(row_blocks, chunks);
  auto launch = [&](auto kernel) {
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<grid, cols, smem, stream>>>(ui, ujn, dist, idx, wd, b0, w1, dm, z, dui, dujn,
                                         ddist_part, param_part, g_rows, a_slots, k_nbrs, f_dim);
    return cudaGetLastError();
  };
  err = cols == 128 ? launch(edge_mlp_bwd_kernel<T, 128>)
      : cols == 64  ? launch(edge_mlp_bwd_kernel<T, 64>)
                    : launch(edge_mlp_bwd_kernel<T, 32>);
  if (err != cudaSuccess) return static_cast<int>(err);

  // the cross-block sums, in one launch
  SumJob dd{ddist_part, nullptr, chunks, edges};
  if constexpr (std::is_same<T, float>::value)
    dd.out = ddist;
  else
    dd.out_bf = ddist;
  return static_cast<int>(column_sums(SumJob{param_part, dparams, row_blocks, c_tot}, dd, stream));
}

}  // namespace

// out = silu(z) [G, A, K, M] (kernel B); where zout is not null, z itself
// too, for kernel C. With emask [G, A, K] (bytes, 1 = live), out is 0 at
// every dead edge and zout is written at the live edges only; with no
// emask every edge is live. `ws` holds W1's split fragments: 32 floats a
// column of F rounded up to 16, ceil(F / 16) · 512.
extern "C" int edge_mlp_fwd_f32(const float* ui, const float* ujn, const float* dist,
                                const int64_t* idx, const uint8_t* emask, const float* wd,
                                const float* b0, const float* w1, const float* b1, float* out,
                                float* zout, float* ws, int g_rows, int a_slots, int k_nbrs,
                                int f_dim, int m_out, cudaStream_t stream) {
  if (m_out != M_OUT || f_dim < 0) return static_cast<int>(cudaErrorInvalidValue);
  return fwd_launch(ui, ujn, dist, idx, emask, wd, b0, w1, b1, out, zout, ws, g_rows, a_slots,
                    k_nbrs, f_dim, stream);
}

// Floats of scratch that `edge_mlp_bwd_f32` needs.
extern "C" int edge_mlp_bwd_workspace_f32(int g_rows, int a_slots, int k_nbrs, int f_dim,
                                          int m_out, int64_t* floats) {
  return bwd_workspace<float>(g_rows, a_slots, k_nbrs, f_dim, m_out, floats);
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
  return bwd_launch(ui, ujn, dist, idx, wd, b0, w1, dm, z, dui, dujn, ddist, dparams, ws, g_rows,
                    a_slots, k_nbrs, f_dim, m_out, stream);
}

// Kernel B in bf16: ui, ujn [G, A, F], dist [G, A, K] and out [G, A, K, M]
// in bf16, z (where zout is not null) and the parameters in f32; F even.
// `ws` holds W1's bf16 fragments: 512 bytes a group of 16 columns of F,
// ceil(F / 16) · 128 floats.
extern "C" int edge_mlp_fwd_bf16(const __nv_bfloat16* ui, const __nv_bfloat16* ujn,
                                 const __nv_bfloat16* dist, const int64_t* idx,
                                 const uint8_t* emask, const float* wd, const float* b0,
                                 const float* w1, const float* b1, __nv_bfloat16* out,
                                 float* zout, float* ws, int g_rows, int a_slots, int k_nbrs,
                                 int f_dim, int m_out, cudaStream_t stream) {
  if (m_out != M_OUT || f_dim < 2 || f_dim % 2 != 0 ||
      reinterpret_cast<uintptr_t>(ui) % 4 != 0 || reinterpret_cast<uintptr_t>(ujn) % 4 != 0 ||
      !aligned16(ws))
    return static_cast<int>(cudaErrorInvalidValue);
  return fwd_launch(ui, ujn, dist, idx, emask, wd, b0, w1, b1, out, zout, ws, g_rows, a_slots,
                    k_nbrs, f_dim, stream);
}

// Floats of scratch that `edge_mlp_bwd_bf16` needs (laid out as
// edge_mlp_bwd_workspace_f32's, at kernel C in bf16's columns a block).
extern "C" int edge_mlp_bwd_workspace_bf16(int g_rows, int a_slots, int k_nbrs, int f_dim,
                                           int m_out, int64_t* floats) {
  return bwd_workspace<__nv_bfloat16>(g_rows, a_slots, k_nbrs, f_dim, m_out, floats);
}

// Backward of edge_mlp_fwd_bf16 for dm [G, A, K, M] (bf16), with the
// forward's z [G, A, K, M] (f32). Writes dui, dujn [G, A, F] and ddist
// [G, A, K] in bf16 and dparams = [dW1 (F·M) | dwd (F) | db0 (F) | db1 (M)]
// in f32; `ws` holds edge_mlp_bwd_workspace_bf16 floats.
extern "C" int edge_mlp_bwd_bf16(const __nv_bfloat16* ui, const __nv_bfloat16* ujn,
                                 const __nv_bfloat16* dist, const int64_t* idx, const float* wd,
                                 const float* b0, const float* w1, const float* b1,
                                 const __nv_bfloat16* dm, const float* z, __nv_bfloat16* dui,
                                 __nv_bfloat16* dujn, __nv_bfloat16* ddist, float* dparams,
                                 float* ws, int g_rows, int a_slots, int k_nbrs, int f_dim,
                                 int m_out, cudaStream_t stream) {
  return bwd_launch(ui, ujn, dist, idx, wd, b0, w1, dm, z, dui, dujn, ddist, dparams, ws, g_rows,
                    a_slots, k_nbrs, f_dim, m_out, stream);
}
