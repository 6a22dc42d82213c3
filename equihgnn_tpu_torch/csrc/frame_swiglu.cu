// Frame-averaged SwiGLU of FAFormer, forward (kernel D) and backward
// (kernel E). For x [P, C] (columns 0..2 the unsigned frame projection,
// columns 3.. frame-invariant), w1 [C, H], b1 [H] and LayerNorm γ, β [H/2]:
//
//   pre_o = (s_o ⊙ x[:, :3] ‖ x[:, 3:]) @ w1 + b1          o = 0..7
//   out   = mean_o LN(drop(silu(pre_o[:, :H/2]) · pre_o[:, H/2:]))·γ + β
//
// over the 8 sign patterns s_o of `_SIGN_OPS` (o = 4·bx + 2·by + bz, bit 0
// → −1, bit 1 → +1). The parameters are f32, and so is every sum. x and out
// (and, in the backward, dout and dx) are f32 or bf16: the bf16 kernels are
// JAX's fused function on bf16 input (`_prep` casts x to f32, `_vjp_fwd`
// rounds out once, `_vjp_bwd` casts dout up and rounds dx once), the f32
// kernels' arithmetic on x and dout read as bf16 and widened, out and dx
// rounded to bf16 at the store. The element type T is a template argument
// of the kernels, used only where they read x and dout and write out and dx
// (`to_f32`, `from_f32`, `store_row`): the f32 instances are the code they
// were before the bf16 ones came.
//
// Replaces: equihgnn_tpu/ops/pallas/frame_swiglu.py `_vjp_fwd` /
// `_fwd_kernel` (forward) and `_vjp_bwd` / `_bwd_kernel` (backward). As on
// the TPU, the point is that the [P, 8, H] frame tensor never reaches device
// memory: at the batch-768 EdgeModule site (P = 393,728, C = 4, H = 256) it
// would be 3.2 GB, while the kernels read [P, C] (6.3 MB) and write or read
// [P, H/2] (202 MB).
//
// Bound on the H100: per position and frame, H pre-activations (rank-1
// terms in x), H/2 sigmoids and a LayerNorm over H/2 columns, all on the
// CUDA cores: 8·P·H/2 = 403 M SwiGLU values per launch at the EdgeModule
// site. Each sigmoid takes two special-function operations (ex2 and a
// reciprocal), of which an SM issues 16 a clock: ~0.2 ms a launch at that
// site on that pipe alone, about the operations bound. The LayerNorm
// statistics are warp reductions (shuffles). Device-memory traffic is the
// [P, H/2] output (forward) or output gradient (backward).
//
// Forward design (kernel D): a warp owns one position at a time
// (grid-stride over P, the next position's x loaded one position ahead);
// lane l holds columns l + 32·q, q < H/64, of both halves, and keeps its
// columns of w1, b1, γ and β in registers for the whole launch (the grid is
// at most the blocks that fit on the card at once). Per position:
//  - each frame's pre-activations as the frame-invariant part (once a
//    position) plus its 3 coordinate terms, summed apart from it (so that
//    their roundings stay at their own size where b1 is large). Frames in
//    Gray-code order, each moving the terms by ±2·x_i·w1[i] (one FMA a
//    column), were 4 % slower on the card: the frames then form one chain
//    of dependent updates (`ablate_kernels.py`);
//  - all 8 frames' SwiGLU values y[8][H/64] first, with the fast exponential
//    and division (`__expf`, `__fdividef`) in the sigmoid and the dropout
//    hash's first finalizer once a position (`keep_bit_h`);
//  - then the 8 frames' LayerNorm statistics together: their sums in one
//    reduce-scatter butterfly and one broadcast each (17 shuffles), then
//    the centred sums of squares the same way: the exact two-pass variance
//    in 2 butterflies a position, where a chain of 2 dependent butterflies
//    a frame took 16 (80 shuffles);
//  - out = γ·mean_o((y_o − μ_o)/σ_o) + β.
// C ∈ {3, 4} and H/2 ∈ {32, 64, 128, 256} are template arguments.
//
// Backward (kernel E), with dz = (dout/8)·γ, dy = (dz − mean dz −
// ẑ·mean(dz·ẑ))/σ, dropout's mask again, dpre = [dy·h2·silu'(h1) ‖
// dy·silu(h1)]. Per position the lane sums over the frames D = Σ_o dpre_o
// and G_i = Σ_o s_o,i·dpre_o (i < 3), which give dx[p, i] = Σ_col w1[i]·G_i
// and dx[p, c≥3] = Σ_col w1[c]·D, and the parameter sums dw1[i] += x_i·G_i,
// dw1[c≥3] += x_c·D, db1 += D, dγ += (dout/8)·Σ_o ẑ_o, dβ += dout.
// A warp owns a position at a time, as in D. What keeps it short:
//  - occupancy: the parameter sums live in the warp's row of shared memory
//    (C·H + 2H floats, 48 KB a block at C = 4, H = 256), not in registers,
//    and only w1's three coordinate rows and γ stay in registers (b1 and
//    the frame-invariant rows are read from shared memory once a
//    position), so that BWD_MIN_BLOCKS = 2 blocks of 8 warps share an SM
//    (with everything in registers, 210 of them, one block of 8 warps
//    fits an SM);
//  - one butterfly a frame: the frame's Σ(y − c), Σ(y − c)² and
//    Σ dz·(y − c), shifted by a pivot c near the mean (lane 0's first
//    value, one broadcast), go through one reduce-scatter butterfly and
//    three broadcasts (10 shuffles), which give the mean, the variance
//    (E[(y − c)²] − (μ − c)², which does not cancel where |μ| ≫ σ as
//    E[y²] − μ² would) and mean(dz·ẑ) = (mean(dz·(y − c)) − (μ −
//    c)·mean(dz))/σ; mean(dz) does not depend on the frame and is reduced
//    once a position (three dependent butterflies a frame take 20
//    shuffles);
//  - the frames in Gray-code order, so that each next one flips one
//    coordinate sign and its pre-activations move by ±2·x_i·w1[i] (one FMA
//    a column); the fast exponential (`__expf`) in the sigmoid;
//  - the C values of dx in one reduce-scatter butterfly;
//  - a position whose dout row is all 0 (FAFormer passes 0 at every masked
//    neighbour and padding slot: 56 % of the EdgeModule's positions and
//    48 % of the FAFFN's at batch 768) adds nothing to any parameter sum
//    and has dx = 0: the warp tests the row by value (`__any_sync`; a NaN
//    is not 0) and writes dx = 0 without the frames.
// At the end each block adds its warps' rows in order into one workspace
// row; `column_sum` (column_sum.cuh) then adds the rows in a fixed order.
// TPU blocks ran in order and carried the sums in a revisited output block;
// Hopper blocks run in no order, hence the workspace and the second pass.
// No atomics: the result is deterministic.
//
// Dropout: the TPU kernel draws from the TPU's PRNG seeded by (seed, tile),
// which no other device reproduces. Here the keep bit of value (p, o, j) is
// a counter-based hash of (seed, p, o·H/2 + j), independent of the launch
// layout, so that kernel E regenerates kernel D's mask and the plain
// PyTorch version (`ops/kernels/frame_swiglu.py` `dropout_keep`) computes
// the same bits with integer tensor ops. Keep iff hash ≥ round(rate·2³²).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

#include "column_sum.cuh"

namespace {

constexpr int WARPS = 8;  // warps per block
constexpr unsigned FULL = 0xffffffffu;
constexpr float LN_EPS = 1e-5f;

using bf16 = __nv_bfloat16;

// the element type's value as f32 (exact), and an f32 value rounded to it
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v) {
  if constexpr (std::is_same<T, float>::value) return v;
  else return __float2bfloat16_rn(v);
}

// A bf16 row of H/2 = 32·CPL values, lane l holding v[q] of column l + 32q,
// stored in __nv_bfloat162 pairs: of each two of a lane's columns (q0 = 2j,
// q1 = 2j + 1) an even lane stores q0's pair (its own, its odd neighbour's)
// and an odd lane q1's (its even neighbour's, its own), one shuffle a pair;
// at CPL = 1 the even lanes store every pair.
template <int CPL>
__device__ __forceinline__ void store_row(bf16* row, const float (&v)[CPL], int lane) {
  const bool odd = lane & 1;
  const int c0 = lane & ~1;
#pragma unroll
  for (int q0 = 0; q0 < CPL; q0 += 2) {
    const int q1 = q0 + 1 < CPL ? q0 + 1 : q0;
    const float other = __shfl_xor_sync(0xffffffffu, odd ? v[q0] : v[q1], 1);
    if (!odd)
      *reinterpret_cast<__nv_bfloat162*>(row + c0 + 32 * q0) = __floats2bfloat162_rn(v[q0], other);
    else if (q1 != q0)
      *reinterpret_cast<__nv_bfloat162*>(row + c0 + 32 * q1) = __floats2bfloat162_rn(other, v[q1]);
  }
}

__device__ __forceinline__ float sigmoid_fast(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// murmur3's 32-bit finalizer
__host__ __device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// keep bit of (position p, counter c = o·H/2 + j) for s = fmix32(seed),
// fmix32(fmix32(p ^ s) ^ (c·0x9E3779B9 + s)) ≥ thresh, from ph = fmix32(p ^ s),
// which the kernels compute once a position
__device__ __forceinline__ bool keep_bit_h(uint32_t ph, uint32_t s, uint32_t c, uint32_t thresh) {
  return fmix32(ph ^ (c * 0x9E3779B9u + s)) >= thresh;
}

// sign of column i in frame o: ±1 for the coordinates i < 3, +1 for the
// frame-invariant columns
__host__ __device__ constexpr float sgn(int o, int i) {
  return i >= 3 || ((o >> (2 - i)) & 1) ? 1.f : -1.f;
}

struct Dropout {
  int on;           // 0: no dropout
  uint32_t thresh;  // keep iff hash >= thresh
  float inv_keep;   // 1 / (1 − rate)
  uint32_t smix;    // fmix32(seed)
};

// The lane's K = 2·CPL columns: k < CPL → l + 32k, else H/2 + l + 32(k − CPL).
template <int CPL>
__device__ __forceinline__ int col(int k, int lane) {
  return (k < CPL) ? lane + 32 * k : CPL * 32 + lane + 32 * (k - CPL);
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

// Kernel D's blocks an SM (its registers allow, at H/2 ≤ 128;
// `ablate_kernels.py` rebuilds it with others).
constexpr int FWD_MIN_BLOCKS = 2;

// Kernel D: see the file comment. A warp owns a position at a time.
template <int C, int CPL, typename T>
__global__ void __launch_bounds__(WARPS * 32, CPL >= 8 ? 1 : FWD_MIN_BLOCKS)
frame_swiglu_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w1,
                        const float* __restrict__ b1, const float* __restrict__ ls,
                        const float* __restrict__ lb, T* __restrict__ out, int64_t n_pos,
                        Dropout drop) {
  constexpr int HH = 32 * CPL, H = 2 * HH, K = 2 * CPL;
  constexpr float INV_HH = 1.f / HH;  // exact: HH is a power of 2
  const int lane = threadIdx.x & 31;
  // the lane's columns of w1 and b1, and its γ and β, for the whole launch
  float w[C][K], b[K], g[CPL], be[CPL];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    b[k] = b1[col<CPL>(k, lane)];
#pragma unroll
    for (int c = 0; c < C; ++c) w[c][k] = w1[c * H + col<CPL>(k, lane)];
  }
#pragma unroll
  for (int q = 0; q < CPL; ++q) {
    g[q] = ls[lane + 32 * q];
    be[q] = lb[lane + 32 * q];
  }

  const int64_t nwarps = static_cast<int64_t>(gridDim.x) * WARPS;
  int64_t p = static_cast<int64_t>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  float xn[C];  // x of the warp's next position, loaded one position ahead
#pragma unroll
  for (int c = 0; c < C; ++c) xn[c] = p < n_pos ? to_f32(x[p * C + c]) : 0.f;
  for (; p < n_pos; p += nwarps) {
    float xv[C];
#pragma unroll
    for (int c = 0; c < C; ++c) xv[c] = xn[c];
    if (p + nwarps < n_pos) {
#pragma unroll
      for (int c = 0; c < C; ++c) xn[c] = to_f32(x[(p + nwarps) * C + c]);
    }
    const uint32_t ph = drop.on ? fmix32(static_cast<uint32_t>(p) ^ drop.smix) : 0u;

    // pre_o = base + u_o: base = b1 + Σ_{c≥3} x_c·w1[c] the same in every
    // frame, u_o = Σ_{i<3} s_o,i·x_i·w1[i] (3 FMAs a column) kept apart from
    // it, so that u's roundings fall at the size of the coordinate terms,
    // not at that of base (b1 + 10 would carry them at 10)
    float base[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float v = b[k];
#pragma unroll
      for (int c = 3; c < C; ++c) v = fmaf(xv[c], w[c][k], v);
      base[k] = v;
    }
    // y[o] = drop(silu(h1)·h2) of frame o, and the lane's part of its sum
    float y[8][CPL], s[8];
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      s[o] = 0.f;
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        float u1 = 0.f, u2 = 0.f;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          u1 = fmaf(sgn(o, i) * xv[i], w[i][q], u1);
          u2 = fmaf(sgn(o, i) * xv[i], w[i][CPL + q], u2);
        }
        const float h1 = base[q] + u1, h2 = base[CPL + q] + u2;
        float v = h1 * sigmoid_fast(h1) * h2;
        if (drop.on)
          v = keep_bit_h(ph, drop.smix, o * HH + lane + 32 * q, drop.thresh) ? v * drop.inv_keep
                                                                              : 0.f;
        y[o][q] = v;
        s[o] += v;
      }
    }
    // the 8 frames' means: their sums in one reduce-scatter butterfly (lane
    // 4o holds frame o's), one broadcast each; then the centred sums of
    // squares the same way (the two-pass variance)
    float mu[8], inv[8], ss[8];
    const float r1 = warp_reduce_scatter<8>(s, lane);
#pragma unroll
    for (int o = 0; o < 8; ++o) mu[o] = __shfl_sync(FULL, r1, 4 * o) * INV_HH;
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      ss[o] = 0.f;
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        y[o][q] -= mu[o];
        ss[o] = fmaf(y[o][q], y[o][q], ss[o]);
      }
    }
    const float r2 = warp_reduce_scatter<8>(ss, lane);
#pragma unroll
    for (int o = 0; o < 8; ++o) inv[o] = rsqrtf(__shfl_sync(FULL, r2, 4 * o) * INV_HH + LN_EPS);
    // out = γ·mean_o((y_o − μ_o)/σ_o) + β; in bf16 kept in frame 0's row
    // (each column read there before it is written) and stored in pairs
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
      float acc = 0.f;
#pragma unroll
      for (int o = 0; o < 8; ++o) acc = fmaf(y[o][q], inv[o], acc);
      acc = fmaf(acc * 0.125f, g[q], be[q]);
      if constexpr (std::is_same<T, float>::value) out[p * HH + lane + 32 * q] = acc;
      else y[0][q] = acc;
    }
    if constexpr (!std::is_same<T, float>::value) store_row<CPL>(out + p * HH, y[0], lane);
  }
}

// Kernel E's blocks an SM (its registers allow; `ablate_kernels.py`
// rebuilds it with others).
constexpr int BWD_MIN_BLOCKS = 2;

template <int C, int CPL>
struct BwdShape {
  static constexpr int HH = 32 * CPL, H = 2 * HH, K = 2 * CPL;
  // a row of parameter sums: [dw1 (C·H) | db1 (H) | dγ (H/2) | dβ (H/2)]
  static constexpr int ROW = C * H + H + HH + HH;
  // shared memory: each warp's row of sums, b1 and the rows c ≥ 3 of w1
  static constexpr size_t SMEM = (static_cast<size_t>(WARPS) * ROW + H + (C - 3) * H) * 4;
};

// Kernel E: see the file comment. One workspace row per block.
template <int C, int CPL, typename T>
__global__ void __launch_bounds__(WARPS * 32, CPL >= 8 ? 1 : BWD_MIN_BLOCKS)
frame_swiglu_bwd_kernel(const T* __restrict__ x, const float* __restrict__ w1,
                        const float* __restrict__ b1, const float* __restrict__ ls,
                        const T* __restrict__ dout, T* __restrict__ dx,
                        float* __restrict__ part, int64_t n_pos, Dropout drop) {
  using S = BwdShape<C, CPL>;
  constexpr int HH = S::HH, H = S::H, K = S::K, ROW = S::ROW;
  extern __shared__ float smem[];
  float* sums = smem;                // [WARPS][ROW]
  float* b_s = sums + WARPS * ROW;   // [H]
  float* wx_s = b_s + H;             // [C − 3][H]: w1's frame-invariant rows
  for (int i = threadIdx.x; i < WARPS * ROW; i += blockDim.x) sums[i] = 0.f;
  for (int i = threadIdx.x; i < H; i += blockDim.x) b_s[i] = b1[i];
  for (int i = threadIdx.x; i < (C - 3) * H; i += blockDim.x) wx_s[i] = w1[3 * H + i];
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* acc = sums + warp * ROW;
  float w[3][K], g[CPL];  // w1's coordinate rows and γ, the lane's columns
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < 3; ++i) w[i][k] = w1[i * H + col<CPL>(k, lane)];
#pragma unroll
  for (int q = 0; q < CPL; ++q) g[q] = ls[lane + 32 * q];

  const int64_t nwarps = static_cast<int64_t>(gridDim.x) * WARPS;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * WARPS + warp; p < n_pos; p += nwarps) {
    float d[CPL];
    bool nz = false;
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
      d[q] = to_f32(dout[p * HH + lane + 32 * q]);
      nz |= d[q] != 0.f;
    }
    if (!__any_sync(FULL, nz)) {  // adds nothing anywhere
      if (lane < C) dx[p * C + lane] = from_f32<T>(0.f);
      continue;
    }
    float xv[C];
#pragma unroll
    for (int c = 0; c < C; ++c) xv[c] = to_f32(x[p * C + c]);
    const uint32_t ph = drop.on ? fmix32(static_cast<uint32_t>(p) ^ drop.smix) : 0u;

    // frame 0's pre-activations (every coordinate sign −1); the frames are
    // visited in Gray-code order, so that each next one flips one sign
    float pre[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = col<CPL>(k, lane);
      float v = b_s[j];
#pragma unroll
      for (int c = 3; c < C; ++c) v += xv[c] * wx_s[(c - 3) * H + j];
#pragma unroll
      for (int i = 0; i < 3; ++i) v = fmaf(-xv[i], w[i][k], v);
      pre[k] = v;
    }
    // dz = (dout/8)·γ and its mean, the same in every frame
    float dzn[CPL], m1 = 0.f;
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
      dzn[q] = d[q] * 0.125f * g[q];
      m1 += dzn[q];
    }
    m1 = warp_sum(m1) / HH;

    // G_i = Σ_o s_o,i·dpre_o (i < 3) and D = Σ_o dpre_o; zsum = Σ_o z_o
    float G[3][K], D[K], zsum[CPL];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      D[k] = 0.f;
#pragma unroll
      for (int i = 0; i < 3; ++i) G[i][k] = 0.f;
    }
#pragma unroll
    for (int q = 0; q < CPL; ++q) zsum[q] = 0.f;

#pragma unroll
    for (int step = 0; step < 8; ++step) {
      const int o = step ^ (step >> 1);
      if (step > 0) {  // the one coordinate whose sign flips: pre ± 2·x_i·w1[i]
        const int flip = o ^ ((step - 1) ^ ((step - 1) >> 1));
        const int i = flip == 4 ? 0 : flip == 2 ? 1 : 2;
        const float t = 2.f * sgn(o, i) * xv[i];
#pragma unroll
        for (int k = 0; k < K; ++k) pre[k] = fmaf(t, w[i][k], pre[k]);
      }
      float sg[CPL], y[CPL];
      unsigned keep = 0u;
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        sg[q] = sigmoid_fast(pre[q]);
        float v = pre[q] * sg[q] * pre[CPL + q];
        if (drop.on) {
          const bool kb = keep_bit_h(ph, drop.smix, o * HH + lane + 32 * q, drop.thresh);
          keep |= static_cast<unsigned>(kb) << q;
          v = kb ? v * drop.inv_keep : 0.f;
        }
        y[q] = v;
      }
      // dmu = μ − c, 1/σ and mean(dz·ẑ) = (mean(dz·(y − c)) − dmu·mean(dz))/σ,
      // from the sums shifted by the pivot c (`piv`); y becomes y − c
      const float piv = __shfl_sync(FULL, y[0], 0);
      float st[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        y[q] -= piv;
        st[0] += y[q];
        st[1] = fmaf(y[q], y[q], st[1]);
        st[2] = fmaf(dzn[q], y[q], st[2]);
      }
      const float r = warp_reduce_scatter<4>(st, lane);
      const float dmu = __shfl_sync(FULL, r, 0) / HH;
      const float var = fmaxf(__shfl_sync(FULL, r, 8) / HH - dmu * dmu, 0.f);
      const float inv = rsqrtf(var + LN_EPS);
      const float m2 = inv * (__shfl_sync(FULL, r, 16) / HH - dmu * m1);
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        const float zq = (y[q] - dmu) * inv;
        zsum[q] += zq;
        float dy = inv * (dzn[q] - m1 - zq * m2);
        if (drop.on) dy = (keep >> q) & 1u ? dy * drop.inv_keep : 0.f;
        const float h1 = pre[q], h2 = pre[CPL + q];
        const float dh1 = dy * h2 * (sg[q] * (1.f + h1 * (1.f - sg[q])));
        const float dh2 = dy * (h1 * sg[q]);
        D[q] += dh1;
        D[CPL + q] += dh2;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          G[i][q] += sgn(o, i) * dh1;
          G[i][CPL + q] += sgn(o, i) * dh2;
        }
      }
    }

    // dx[p, i] = Σ_col w1[i]·G_i, dx[p, c ≥ 3] = Σ_col w1[c]·D: the C sums
    // in one butterfly; lane 8c holds dx[p, c]
    float v4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int i = 0; i < 3; ++i) v4[i] = fmaf(w[i][k], G[i][k], v4[i]);
      if (C == 4) v4[3] = fmaf(wx_s[col<CPL>(k, lane)], D[k], v4[3]);
    }
    const float r = warp_reduce_scatter<4>(v4, lane);
    if ((lane & 7) == 0 && (lane >> 3) < C) dx[p * C + (lane >> 3)] = from_f32<T>(r);

    // the parameter sums: dw1[i] += x_i·G_i, dw1[c ≥ 3] += x_c·D, db1 += D,
    // dγ += (dout/8)·Σ_o z_o, dβ += dout
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = col<CPL>(k, lane);
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c * H + j] += xv[c] * (c < 3 ? G[c < 3 ? c : 0][k] : D[k]);
      acc[C * H + j] += D[k];
    }
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
      acc[C * H + H + lane + 32 * q] += d[q] * 0.125f * zsum[q];
      acc[C * H + H + HH + lane + 32 * q] += d[q];
    }
  }
  __syncthreads();
  // the block's row: its warps' rows added in order
  float* row = part + static_cast<int64_t>(blockIdx.x) * ROW;
  for (int i = threadIdx.x; i < ROW; i += blockDim.x) {
    float s = 0.f;
#pragma unroll
    for (int w8 = 0; w8 < WARPS; ++w8) s += sums[w8 * ROW + i];
    row[i] = s;
  }
}

// Blocks of a grid-stride launch: enough to cover P, at most what fits on
// the card at once with `smem` bytes of dynamic shared memory a block.
// Depends on P and the device only, so that kernel E's workspace rows, and
// hence its sums, are the same in every run.
template <typename Kernel>
cudaError_t grid_for(Kernel kernel, int64_t n_pos, size_t smem, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, WARPS * 32, smem);
  if (err != cudaSuccess) return err;
  const int64_t need = (n_pos + WARPS - 1) / WARPS;
  const int64_t cap = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  *blocks = static_cast<int>(need < 1 ? 1 : (need < cap ? need : cap));
  return cudaSuccess;
}

// The C entry points' bodies, one instance per (C, H/2/32), for x, out,
// dout and dx of element type T.
template <typename T>
struct Ops {
  template <int C, int CPL>
  struct Fwd {
    static cudaError_t run(const T* x, const float* w1, const float* b1, const float* ls,
                           const float* lb, T* out, int64_t n_pos, Dropout drop,
                           cudaStream_t stream) {
      int blocks = 0;
      cudaError_t err = grid_for(frame_swiglu_fwd_kernel<C, CPL, T>, n_pos, 0, &blocks);
      if (err != cudaSuccess) return err;
      frame_swiglu_fwd_kernel<C, CPL, T><<<blocks, WARPS * 32, 0, stream>>>(x, w1, b1, ls, lb,
                                                                             out, n_pos, drop);
      return cudaGetLastError();
    }
  };

  template <int C, int CPL>
  struct BwdWorkspace {
    static cudaError_t run(int64_t n_pos, int64_t* floats) {
      int blocks = 0;
      cudaError_t err =
          grid_for(frame_swiglu_bwd_kernel<C, CPL, T>, n_pos, BwdShape<C, CPL>::SMEM, &blocks);
      *floats = static_cast<int64_t>(blocks) * BwdShape<C, CPL>::ROW;
      return err;
    }
  };

  template <int C, int CPL>
  struct Bwd {
    static cudaError_t run(const T* x, const float* w1, const float* b1, const float* ls,
                           const T* dout, T* dx, float* dparams, float* ws, int64_t n_pos,
                           Dropout drop, cudaStream_t stream) {
      constexpr size_t smem = BwdShape<C, CPL>::SMEM;
      int blocks = 0;
      cudaError_t err = grid_for(frame_swiglu_bwd_kernel<C, CPL, T>, n_pos, smem, &blocks);
      if (err != cudaSuccess) return err;
      frame_swiglu_bwd_kernel<C, CPL, T><<<blocks, WARPS * 32, smem, stream>>>(
          x, w1, b1, ls, dout, dx, ws, n_pos, drop);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      return column_sum(ws, dparams, blocks, BwdShape<C, CPL>::ROW, stream);
    }
  };
};

// Op<C, CPL>::run(args...) for C ∈ {3, 4}, H/2 = 32·CPL ∈ {32, 64, 128, 256};
// cudaErrorInvalidValue for any other shape.
template <template <int, int> class Op, typename... Args>
cudaError_t dispatch(int c_cols, int h_dim, Args... args) {
  switch (c_cols * 1000 + h_dim / 2) {
    case 3032: return Op<3, 1>::run(args...);
    case 3064: return Op<3, 2>::run(args...);
    case 3128: return Op<3, 4>::run(args...);
    case 3256: return Op<3, 8>::run(args...);
    case 4032: return Op<4, 1>::run(args...);
    case 4064: return Op<4, 2>::run(args...);
    case 4128: return Op<4, 4>::run(args...);
    case 4256: return Op<4, 8>::run(args...);
    default: return cudaErrorInvalidValue;
  }
}

Dropout make_dropout(int on, uint32_t thresh, float inv_keep, uint32_t seed) {
  return Dropout{on, thresh, inv_keep, fmix32(seed)};
}

template <typename T>
int workspace(int64_t n_pos, int c_cols, int h_dim, int64_t* floats) {
  if (n_pos < 0 || h_dim % 2) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      dispatch<Ops<T>::template BwdWorkspace>(c_cols, h_dim, n_pos, floats));
}

template <typename T>
int forward(const T* x, const float* w1, const float* b1, const float* ls, const float* lb,
            T* out, int64_t n_pos, int c_cols, int h_dim, int drop, uint32_t thresh,
            float inv_keep, uint32_t seed, cudaStream_t stream) {
  if (n_pos < 0 || h_dim % 2) return static_cast<int>(cudaErrorInvalidValue);
  if (n_pos == 0) return 0;
  return static_cast<int>(dispatch<Ops<T>::template Fwd>(
      c_cols, h_dim, x, w1, b1, ls, lb, out, n_pos, make_dropout(drop, thresh, inv_keep, seed),
      stream));
}

template <typename T>
int backward(const T* x, const float* w1, const float* b1, const float* ls, const T* dout,
             T* dx, float* dparams, float* ws, int64_t n_pos, int c_cols, int h_dim, int drop,
             uint32_t thresh, float inv_keep, uint32_t seed, cudaStream_t stream) {
  if (n_pos < 0 || h_dim % 2) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch<Ops<T>::template Bwd>(
      c_cols, h_dim, x, w1, b1, ls, dout, dx, dparams, ws, n_pos,
      make_dropout(drop, thresh, inv_keep, seed), stream));
}

}  // namespace

// Floats of scratch that frame_swiglu_bwd_f32 (_bf16) needs: one row of
// partial parameter sums per block of its grid.
extern "C" int frame_swiglu_bwd_workspace_f32(int64_t n_pos, int c_cols, int h_dim,
                                              int64_t* floats) {
  return workspace<float>(n_pos, c_cols, h_dim, floats);
}

extern "C" int frame_swiglu_bwd_workspace_bf16(int64_t n_pos, int c_cols, int h_dim,
                                               int64_t* floats) {
  return workspace<bf16>(n_pos, c_cols, h_dim, floats);
}

// out [P, H/2] = kernel D of x [P, C], w1 [C, H], b1 [H], ls/lb [H/2].
// drop = 0: no dropout; else keep iff hash(seed, p, o·H/2 + j) ≥ thresh,
// kept values scaled by inv_keep.
extern "C" int frame_swiglu_fwd_f32(const float* x, const float* w1, const float* b1,
                                    const float* ls, const float* lb, float* out, int64_t n_pos,
                                    int c_cols, int h_dim, int drop, uint32_t thresh,
                                    float inv_keep, uint32_t seed, cudaStream_t stream) {
  return forward(x, w1, b1, ls, lb, out, n_pos, c_cols, h_dim, drop, thresh, inv_keep, seed,
                 stream);
}

// The same with x and out in bf16 (the f32 parameters and arithmetic; out
// rounded once).
extern "C" int frame_swiglu_fwd_bf16(const bf16* x, const float* w1, const float* b1,
                                     const float* ls, const float* lb, bf16* out, int64_t n_pos,
                                     int c_cols, int h_dim, int drop, uint32_t thresh,
                                     float inv_keep, uint32_t seed, cudaStream_t stream) {
  return forward(x, w1, b1, ls, lb, out, n_pos, c_cols, h_dim, drop, thresh, inv_keep, seed,
                 stream);
}

// Kernel E: dx [P, C] and dparams = [dw1 (C·H) | db1 (H) | dls (H/2) |
// dlb (H/2)] for dout [P, H/2]; `ws` holds frame_swiglu_bwd_workspace_f32
// floats. The dropout arguments must be the forward's.
extern "C" int frame_swiglu_bwd_f32(const float* x, const float* w1, const float* b1,
                                    const float* ls, const float* dout, float* dx,
                                    float* dparams, float* ws, int64_t n_pos, int c_cols,
                                    int h_dim, int drop, uint32_t thresh, float inv_keep,
                                    uint32_t seed, cudaStream_t stream) {
  return backward(x, w1, b1, ls, dout, dx, dparams, ws, n_pos, c_cols, h_dim, drop, thresh,
                  inv_keep, seed, stream);
}

// The same with x, dout and dx in bf16 (dx rounded once; dparams f32), `ws`
// of frame_swiglu_bwd_workspace_bf16 floats.
extern "C" int frame_swiglu_bwd_bf16(const bf16* x, const float* w1, const float* b1,
                                     const float* ls, const bf16* dout, bf16* dx,
                                     float* dparams, float* ws, int64_t n_pos, int c_cols,
                                     int h_dim, int drop, uint32_t thresh, float inv_keep,
                                     uint32_t seed, cudaStream_t stream) {
  return backward(x, w1, b1, ls, dout, dx, dparams, ws, n_pos, c_cols, h_dim, drop, thresh,
                  inv_keep, seed, stream);
}
