// Frame-averaged SwiGLU of FAFormer, forward (kernel D) and backward
// (kernel E). For x [P, C] (columns 0..2 the unsigned frame projection,
// columns 3.. frame-invariant), w1 [C, H], b1 [H] and LayerNorm γ, β [H/2]:
//
//   pre_o = (s_o ⊙ x[:, :3] ‖ x[:, 3:]) @ w1 + b1          o = 0..7
//   out   = mean_o LN(drop(silu(pre_o[:, :H/2]) · pre_o[:, H/2:]))·γ + β
//
// over the 8 sign patterns s_o of `_SIGN_OPS` (o = 4·bx + 2·by + bz, bit 0
// → −1, bit 1 → +1). All f32.
//
// Replaces: equihgnn_tpu/ops/pallas/frame_swiglu.py `_vjp_fwd` /
// `_fwd_kernel` (forward) and `_vjp_bwd` / `_bwd_kernel` (backward). As on
// the TPU, the point is that the [P, 8, H] frame tensor never reaches device
// memory: at the batch-768 EdgeModule site (P = 393,728, C = 4, H = 256) it
// would be 3.2 GB, while the kernels read [P, C] (6.3 MB) and write or read
// [P, H/2] (202 MB).
//
// Bound on the H100: per position and frame, H pre-activations (rank-1
// terms: pre = base ± t0 ± t1 ± t2), H/2 sigmoids and a LayerNorm over H/2
// columns, all on the CUDA cores: 8·P·H/2 = 403 M SwiGLU values per launch
// at the EdgeModule site. The LayerNorm statistics are warp reductions
// (shuffles), two per frame forward and four backward. Device-memory traffic
// is the [P, H/2] output (forward) or output gradient (backward).
//
// Design: a warp owns one position at a time (grid-stride over P); lane l
// holds columns l + 32·q, q < H/64, of both halves, so each LayerNorm sum is
// a per-lane sum of H/64 values and one 32-lane butterfly. The lane keeps
// its columns of w1, b1, γ and β in registers for the whole launch (the
// grid is at most the blocks that fit on the card at once), and the 8 sign
// patterns are unrolled, so the signs are compile-time constants. C ∈ {3, 4}
// and H/2 ∈ {32, 64, 128, 256} are template arguments.
//
// Backward (kernel E): the same recompute per position; with
// dz = (dout/8)·γ, dy = (dz − mean dz − z·mean(dz·z))/σ, dropout's mask
// again, dpre = [dy·h2·silu'(h1) ‖ dy·silu(h1)]. Per position the lane sums
// over the frames D = Σ_o dpre_o and G_i = Σ_o s_o,i·dpre_o (i < 3), which
// give dx[p, i] = Σ_col w1[i]·G_i and dx[p, c≥3] = Σ_col w1[c]·D (warp
// reductions), and the parameter sums dw1[i] += x_i·G_i, dw1[c≥3] += x_c·D,
// db1 += D, dγ += Σ_o (dout/8)·z_o, dβ += dout. Each warp keeps those sums
// in registers over its positions and writes them as one row of a
// workspace; `column_sum` (column_sum.cuh) then adds the rows in a fixed
// order. TPU blocks ran in order and carried the sums in a revisited output
// block; Hopper blocks run in no order, hence the workspace and the second
// pass. No atomics: the result is deterministic.
//
// Dropout: the TPU kernel draws from the TPU's PRNG seeded by (seed, tile),
// which no other device reproduces. Here the keep bit of value (p, o, j) is
// a counter-based hash of (seed, p, o·H/2 + j), independent of the launch
// layout, so that kernel E regenerates kernel D's mask and the plain
// PyTorch version (`ops/kernels/frame_swiglu.py` `dropout_keep`) computes
// the same bits with integer tensor ops. Keep iff hash ≥ round(rate·2³²).

#include <cstdint>
#include <cuda_runtime.h>

#include "column_sum.cuh"

namespace {

constexpr int WARPS = 8;  // warps per block
constexpr unsigned FULL = 0xffffffffu;
constexpr float LN_EPS = 1e-5f;

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

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

// keep bit of (position p, counter c = o·H/2 + j); s = fmix32(seed)
__device__ __forceinline__ bool keep_bit(uint32_t s, uint32_t p, uint32_t c, uint32_t thresh) {
  const uint32_t h = fmix32(fmix32(p ^ s) ^ (c * 0x9E3779B9u + s));
  return h >= thresh;
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

template <int C, int CPL>
struct Params {
  static constexpr int HH = 32 * CPL, H = 2 * HH, K = 2 * CPL;
  float w[C][K], b[K], g[CPL];

  __device__ __forceinline__ void load(const float* w1, const float* b1, const float* ls,
                                       int lane) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      b[k] = b1[col<CPL>(k, lane)];
#pragma unroll
      for (int c = 0; c < C; ++c) w[c][k] = w1[c * H + col<CPL>(k, lane)];
    }
#pragma unroll
    for (int q = 0; q < CPL; ++q) g[q] = ls[lane + 32 * q];
  }

  // base = b1 + Σ_{c≥3} x_c·w1[c] and the rank-1 terms t_i = x_i·w1[i]
  __device__ __forceinline__ void terms(const float (&xv)[C], float (&base)[K],
                                        float (&t)[3][K]) const {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float v = b[k];
#pragma unroll
      for (int c = 3; c < C; ++c) v += xv[c] * w[c][k];
      base[k] = v;
#pragma unroll
      for (int i = 0; i < 3; ++i) t[i][k] = xv[i] * w[i][k];
    }
  }
};

template <int C, int CPL>
__global__ void __launch_bounds__(WARPS * 32)
frame_swiglu_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                        const float* __restrict__ b1, const float* __restrict__ ls,
                        const float* __restrict__ lb, float* __restrict__ out, int64_t n_pos,
                        Dropout drop) {
  using P = Params<C, CPL>;
  constexpr int HH = P::HH, K = P::K;
  const int lane = threadIdx.x & 31;
  P prm;
  prm.load(w1, b1, ls, lane);
  float be[CPL];
#pragma unroll
  for (int q = 0; q < CPL; ++q) be[q] = lb[lane + 32 * q];

  const int64_t nwarps = static_cast<int64_t>(gridDim.x) * WARPS;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * WARPS + (threadIdx.x >> 5); p < n_pos;
       p += nwarps) {
    float xv[C];
#pragma unroll
    for (int c = 0; c < C; ++c) xv[c] = x[p * C + c];
    float base[K], t[3][K];
    prm.terms(xv, base, t);

    float acc[CPL];
#pragma unroll
    for (int q = 0; q < CPL; ++q) acc[q] = 0.f;
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      float y[CPL], s = 0.f;
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        const float h1 = base[q] + sgn(o, 0) * t[0][q] + sgn(o, 1) * t[1][q] + sgn(o, 2) * t[2][q];
        const int k2 = CPL + q;
        const float h2 =
            base[k2] + sgn(o, 0) * t[0][k2] + sgn(o, 1) * t[1][k2] + sgn(o, 2) * t[2][k2];
        float v = h1 * sigmoid(h1) * h2;
        if (drop.on)
          v = keep_bit(drop.smix, static_cast<uint32_t>(p), o * HH + lane + 32 * q, drop.thresh)
                  ? v * drop.inv_keep
                  : 0.f;
        y[q] = v;
        s += v;
      }
      const float mu = warp_sum(s) / HH;
      float ss = 0.f;
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        y[q] -= mu;
        ss += y[q] * y[q];
      }
      const float inv = rsqrtf(warp_sum(ss) / HH + LN_EPS);
#pragma unroll
      for (int q = 0; q < CPL; ++q) acc[q] += y[q] * inv * prm.g[q] + be[q];
    }
#pragma unroll
    for (int q = 0; q < CPL; ++q) out[p * HH + lane + 32 * q] = acc[q] * 0.125f;
  }
}

// One workspace row per warp: [dw1 (C·H) | db1 (H) | dγ (H/2) | dβ (H/2)].
template <int C, int CPL>
__global__ void __launch_bounds__(WARPS * 32)
frame_swiglu_bwd_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                        const float* __restrict__ b1, const float* __restrict__ ls,
                        const float* __restrict__ dout, float* __restrict__ dx,
                        float* __restrict__ part, int64_t n_pos, Dropout drop) {
  using P = Params<C, CPL>;
  constexpr int HH = P::HH, H = P::H, K = P::K;
  const int lane = threadIdx.x & 31;
  P prm;
  prm.load(w1, b1, ls, lane);

  float adw[C][K], adb[K], adg[CPL], adbe[CPL];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    adb[k] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) adw[c][k] = 0.f;
  }
#pragma unroll
  for (int q = 0; q < CPL; ++q) adg[q] = adbe[q] = 0.f;

  const int64_t warp = static_cast<int64_t>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  const int64_t nwarps = static_cast<int64_t>(gridDim.x) * WARPS;
  for (int64_t p = warp; p < n_pos; p += nwarps) {
    float xv[C];
#pragma unroll
    for (int c = 0; c < C; ++c) xv[c] = x[p * C + c];
    float base[K], t[3][K];
    prm.terms(xv, base, t);
    float dyn[CPL];
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
      const float d = dout[p * HH + lane + 32 * q];
      adbe[q] += d;
      dyn[q] = d * 0.125f;  // mean over the 8 frames
    }

    // gs[c] = Σ_o sgn(o, c)·dpre_o: G_i for i < 3 and D for c ≥ 3; dsum = D
    float gs[C][K], dsum[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      dsum[k] = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) gs[c][k] = 0.f;
    }
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      float h1[CPL], h2[CPL], sg[CPL], z[CPL];
      bool keep[CPL];
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        const int k2 = CPL + q;
        h1[q] = base[q] + sgn(o, 0) * t[0][q] + sgn(o, 1) * t[1][q] + sgn(o, 2) * t[2][q];
        h2[q] = base[k2] + sgn(o, 0) * t[0][k2] + sgn(o, 1) * t[1][k2] + sgn(o, 2) * t[2][k2];
        sg[q] = sigmoid(h1[q]);
        float v = h1[q] * sg[q] * h2[q];
        keep[q] = true;
        if (drop.on) {
          keep[q] = keep_bit(drop.smix, static_cast<uint32_t>(p), o * HH + lane + 32 * q,
                             drop.thresh);
          v = keep[q] ? v * drop.inv_keep : 0.f;
        }
        z[q] = v;
        s += v;
      }
      const float mu = warp_sum(s) / HH;
      float ss = 0.f;
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        z[q] -= mu;
        ss += z[q] * z[q];
      }
      const float inv = rsqrtf(warp_sum(ss) / HH + LN_EPS);
      float dz[CPL], m1 = 0.f, m2 = 0.f;
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        z[q] *= inv;
        adg[q] += dyn[q] * z[q];
        dz[q] = dyn[q] * prm.g[q];
        m1 += dz[q];
        m2 += dz[q] * z[q];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        m1 += __shfl_xor_sync(FULL, m1, off);
        m2 += __shfl_xor_sync(FULL, m2, off);
      }
      m1 /= HH;
      m2 /= HH;
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        float dy = inv * (dz[q] - m1 - z[q] * m2);
        if (drop.on) dy = keep[q] ? dy * drop.inv_keep : 0.f;
        const float a1 = h1[q] * sg[q];
        const float dh1 = dy * h2[q] * (sg[q] * (1.f + h1[q] * (1.f - sg[q])));
        const float dh2 = dy * a1;
        dsum[q] += dh1;
        dsum[CPL + q] += dh2;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          gs[c][q] += sgn(o, c) * dh1;
          gs[c][CPL + q] += sgn(o, c) * dh2;
        }
      }
    }

    // dx[p, c] = Σ_col w1[c]·gs[c]
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float v = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) v += prm.w[c][k] * gs[c][k];
      v = warp_sum(v);
      if (lane == c) dx[p * C + c] = v;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      adb[k] += dsum[k];
#pragma unroll
      for (int c = 0; c < C; ++c) adw[c][k] += xv[c] * gs[c][k];
    }
  }

  float* row = part + warp * static_cast<int64_t>(C * H + 2 * H);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = col<CPL>(k, lane);
#pragma unroll
    for (int c = 0; c < C; ++c) row[c * H + j] = adw[c][k];
    row[C * H + j] = adb[k];
  }
#pragma unroll
  for (int q = 0; q < CPL; ++q) {
    row[C * H + H + lane + 32 * q] = adg[q];
    row[C * H + H + HH + lane + 32 * q] = adbe[q];
  }
}

// Blocks of a grid-stride launch: enough to cover P, at most what fits on
// the card at once. Depends on P and the device only, so that kernel E's
// workspace rows, and hence its sums, are the same in every run.
template <typename Kernel>
cudaError_t grid_for(Kernel kernel, int64_t n_pos, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, WARPS * 32, 0);
  if (err != cudaSuccess) return err;
  const int64_t need = (n_pos + WARPS - 1) / WARPS;
  const int64_t cap = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  *blocks = static_cast<int>(need < 1 ? 1 : (need < cap ? need : cap));
  return cudaSuccess;
}

// The three C entry points' bodies, one instance per (C, H/2/32).
template <int C, int CPL>
struct Fwd {
  static cudaError_t run(const float* x, const float* w1, const float* b1, const float* ls,
                         const float* lb, float* out, int64_t n_pos, Dropout drop,
                         cudaStream_t stream) {
    int blocks = 0;
    cudaError_t err = grid_for(frame_swiglu_fwd_kernel<C, CPL>, n_pos, &blocks);
    if (err != cudaSuccess) return err;
    frame_swiglu_fwd_kernel<C, CPL><<<blocks, WARPS * 32, 0, stream>>>(x, w1, b1, ls, lb, out,
                                                                        n_pos, drop);
    return cudaGetLastError();
  }
};

template <int C, int CPL>
struct BwdWorkspace {
  static constexpr int64_t ROW = C * 64 * CPL + 2 * 64 * CPL;  // C·H + H + H/2 + H/2

  static cudaError_t run(int64_t n_pos, int64_t* floats) {
    int blocks = 0;
    cudaError_t err = grid_for(frame_swiglu_bwd_kernel<C, CPL>, n_pos, &blocks);
    *floats = static_cast<int64_t>(blocks) * WARPS * ROW;
    return err;
  }
};

template <int C, int CPL>
struct Bwd {
  static cudaError_t run(const float* x, const float* w1, const float* b1, const float* ls,
                         const float* dout, float* dx, float* dparams, float* ws, int64_t n_pos,
                         Dropout drop, cudaStream_t stream) {
    int blocks = 0;
    cudaError_t err = grid_for(frame_swiglu_bwd_kernel<C, CPL>, n_pos, &blocks);
    if (err != cudaSuccess) return err;
    frame_swiglu_bwd_kernel<C, CPL><<<blocks, WARPS * 32, 0, stream>>>(x, w1, b1, ls, dout, dx,
                                                                        ws, n_pos, drop);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return column_sum(ws, dparams, static_cast<int64_t>(blocks) * WARPS,
                      BwdWorkspace<C, CPL>::ROW, stream);
  }
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

}  // namespace

// Floats of scratch that frame_swiglu_bwd_f32 needs: one row of partial
// parameter sums per warp of its grid.
extern "C" int frame_swiglu_bwd_workspace_f32(int64_t n_pos, int c_cols, int h_dim,
                                              int64_t* floats) {
  if (n_pos < 0 || h_dim % 2) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch<BwdWorkspace>(c_cols, h_dim, n_pos, floats));
}

// out [P, H/2] = kernel D of x [P, C], w1 [C, H], b1 [H], ls/lb [H/2].
// drop = 0: no dropout; else keep iff hash(seed, p, o·H/2 + j) ≥ thresh,
// kept values scaled by inv_keep.
extern "C" int frame_swiglu_fwd_f32(const float* x, const float* w1, const float* b1,
                                    const float* ls, const float* lb, float* out, int64_t n_pos,
                                    int c_cols, int h_dim, int drop, uint32_t thresh,
                                    float inv_keep, uint32_t seed, cudaStream_t stream) {
  if (n_pos < 0 || h_dim % 2) return static_cast<int>(cudaErrorInvalidValue);
  if (n_pos == 0) return 0;
  return static_cast<int>(dispatch<Fwd>(c_cols, h_dim, x, w1, b1, ls, lb, out, n_pos,
                                        make_dropout(drop, thresh, inv_keep, seed), stream));
}

// Kernel E: dx [P, C] and dparams = [dw1 (C·H) | db1 (H) | dls (H/2) |
// dlb (H/2)] for dout [P, H/2]; `ws` holds frame_swiglu_bwd_workspace_f32
// floats. The dropout arguments must be the forward's.
extern "C" int frame_swiglu_bwd_f32(const float* x, const float* w1, const float* b1,
                                    const float* ls, const float* dout, float* dx,
                                    float* dparams, float* ws, int64_t n_pos, int c_cols,
                                    int h_dim, int drop, uint32_t thresh, float inv_keep,
                                    uint32_t seed, cudaStream_t stream) {
  if (n_pos < 0 || h_dim % 2) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch<Bwd>(c_cols, h_dim, x, w1, b1, ls, dout, dx, dparams, ws,
                                        n_pos, make_dropout(drop, thresh, inv_keep, seed),
                                        stream));
}
