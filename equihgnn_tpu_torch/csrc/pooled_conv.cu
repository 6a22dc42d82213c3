// The backward of the fused pooled ConvSE3 unit of the SE(3)-Transformer:
// kernel K (its forward, kernel J, is `pooled_conv_fwd.cu`).
//
//   M[s,c,i,f] = Σ_k h[s,k,f] · tc[s,k,c,i]                    (k = the neighbours)
//   J out[s,c,o] = live[s] · Σ_{i,f} W[f,o,i] · M[s,c,i,f]
//   K dM[s,c,i,f]  = Σ_o dout[s,c,o] · W[f,o,i]                 (s live)
//     dh[s,k,f]    = Σ_{c,i} tc[s,k,c,i] · dM[s,c,i,f]          (0 at dead sites)
//     dtc[s,k,c,i] = Σ_f h[s,k,f] · dM[s,c,i,f]                 (0 at dead sites)
//     dW[f,o,i]    = Σ_{s live, c} M[s,c,i,f] · dout[s,c,o]
//
// Shapes (s = the G·A sites, r = (s, c) the S·C rows): h [S, K, F];
// tc [S, K, C·I] (c outer, i inner); W [F, O, I] and dW as JAX lays them
// out (i contiguous); dout [S, C, O]. All f32. The dout of a dead site is
// not read: the backward is that of J's live · out.
// Replaces equihgnn_tpu/ops/pallas/pooled_conv.py `_pc_bwd` (body
// `_bwd_kernel`).
//
// Bound on the H100: operations. At the batch-768 shapes (S = 24,608, S' =
// 12,731 live sites, K = 16, F = 128, I = O = 256) the two products, dM
// ([S'·C, O] × [O, I·F]) and dW ([I·F, S'·C] × [S'·C, O]), are 0.21 TFLOP
// each at C = 1; the M rebuild, dh and dtc 11 GFLOP each. What must not
// happen is what the plain version does: write M and dM, 3.2 GB a C each,
// to device memory and read them back.
//
// Design. Both products run on the tensor cores in 3xTF32 (`tf32_mma.cuh`,
// as kernel J): each operand split into big and small TF32 halves, three
// mma.sync.m16n8k8 products summed in f32; each chunk of the contraction
// (64 columns of O in dM, 32 rows in dW) is summed from 0 in the tensor
// cores and added to the running f32 sums on the CUDA cores, since the
// tensor cores truncate where they align and add. Live sites only: the
// caller passes the ids of the live sites (live ones first, then the dead
// ones) and their count, both on the device; without them every site is
// live. Three kernels, no atomics; each output element owned by one thread
// and summed in a fixed order, so two runs give the same bits.
//
//  - W re-laid (`pooled_conv_bwd_wt_kernel`, into the caller's workspace):
//    by the dM kernel's W stages, each one contiguous block, so that its
//    copies move whole 128-byte lines (W [F, O, I] holds a stage in 32-byte
//    pieces of 256 lines).
//  - dM, dh, dtc (`pooled_conv_bwd_dm_kernel`): one block per tile of TS
//    sites of the list (TS·C ≤ 64 rows; 16 sites at C = 1, 10 at C = 3).
//    Each dM tile is computed once and feeds both reductions: the block
//    walks i-chunks of 8 (outer) and f-chunks of 16 (inner); for each it
//    computes the [rows, 8 i × 16 f] dM tile on the tensor cores (dout rows
//    staged and split into their TF32 halves once a block; W streamed in
//    64-o stages through a 2-slot cp.async ring) and stores it to shared
//    memory, then adds Σ_f h·dM into the i-chunk's dtc sums (written out
//    once its f-chunks are done) and Σ_{c,i} tc·dM into the block's dh
//    sums. Those stay until the block ends, [TS, K, F] = 128 KB at C = 1:
//    one (site, k) row of F ≤ 128 sums a thread, in registers (in shared
//    memory they left room for 16-o stages only, and a barrier every 16
//    columns of O cost more than the products; PERF.md). Keeping dh whole
//    in one block is what bounds the tile to 16 sites, so every tile reads
//    all of W (33.5 MB) from L2: 26.7 GB a call at C = 1. The blocks of the
//    dead sites (past the count) write their dh and dtc as 0 and return.
//  - dW (`pooled_conv_bwd_dw_kernel`): kernel J's block with the roles of
//    the operands turned: one block per 64 (i, f) pairs × 256 columns of O;
//    it walks the live rows 32 at a time; 4 producer warps copy h, tc and
//    dout rows (cp.async; each row's offsets computed once a chunk, its
//    site loaded a chunk ahead) and rebuild Mᵀ [64 pairs, 32 rows] on the
//    CUDA cores, 8 consumer warps multiply it by dout [32 rows, 256 o];
//    named barriers pass the two A slots back and forth, dout has three
//    stages.
// Limits: the dM kernel takes F ≤ 128 and sizes its tile to its shared
// memory and to one (site, k) pair a thread (fewer sites for a larger K or
// C); the dW kernel stages two chunks of h and tc rows, which at 32 rows
// takes K ≤ 22. A shape that does not fit is refused.

#include <cstdint>
#include <cuda_runtime.h>

#include "tf32_mma.cuh"

namespace {

struct Dims {
  int s, k, c, i, f, o;  // sites, neighbours, C, I, F, O
};

// ------------------------------------------------- kernel K: dM, dh, dtc

namespace dm {

constexpr int IC = 8;             // i of a chunk: the 8 columns of an n8 tile
constexpr int FC = 16;            // f of a chunk: one f per n8 tile of the 16
constexpr int NB = IC * FC;       // columns of a dM tile: f outer, i inner
constexpr int OC = 64;            // o of a W stage: eight k8 steps
constexpr int STAGES = 2;         // W stages in the ring
constexpr int THREADS = 256;      // 8 warps: warp w owns f 2w, 2w + 1 of a chunk
constexpr int WS = NB + 8;        // row (o) stride of a W stage
constexpr int DS = NB + 4;        // row stride of the dM tile
constexpr int HS = FC + 4;        // (site, k) stride of the staged h
constexpr int TS_ = IC + 4;       // (row, k) stride of the staged tc
constexpr int AS = IC + 1;        // (row, k) stride of the dtc sums
constexpr int FMAX = 128;         // F whose dh sums a thread keeps in registers

__host__ __device__ inline int rows_pad(int ts, int c) { return (ts * c + 15) / 16 * 16; }
// row stride of the staged dout rows: O rounded up to the o-chunks, zero past O
__host__ __device__ inline int dout_stride(int o) { return (o + OC - 1) / OC * OC + 4; }

// Floats of each shared-memory region for a tile of ts sites.
struct Layout {
  size_t dtc, dout, dm, tc, h, w;
  __host__ __device__ Layout(const Dims& d, int ts)
      : dtc(static_cast<size_t>(ts) * d.c * d.k * AS),
        dout(static_cast<size_t>(rows_pad(ts, d.c)) * dout_stride(d.o)),
        dm(static_cast<size_t>(rows_pad(ts, d.c)) * DS),
        tc(static_cast<size_t>(ts) * d.c * d.k * TS_),
        h(static_cast<size_t>(ts) * d.k * HS),
        w(static_cast<size_t>(STAGES) * OC * WS) {}
  // the 16-byte aligned regions first
  __host__ __device__ size_t floats() const {
    auto up4 = [](size_t n) { return (n + 3) / 4 * 4; };
    return w + 2 * up4(dout) + dm + up4(tc) + h + dtc;  // dout: big and small halves
  }
};

size_t smem_bytes(const Dims& d, int ts) {
  return Layout(d, ts).floats() * sizeof(float) + ts * sizeof(int);
}

// The largest tile (sites) whose buffers fit a block, at most 16 sites, 32
// rows (64 where one site has more than 32) and one (site, k) pair of dh
// sums a thread; 0 if none does or F > FMAX.
int tile_sites(const Dims& d) {
  if (d.f > FMAX) return 0;
  int ts = d.c > 32 ? 1 : (d.c == 1 ? 16 : 32 / d.c);
  if (d.k > 0 && ts * d.k > THREADS) ts = THREADS / d.k;
  for (; ts >= 1; --ts)
    if (smem_bytes(d, ts) <= MAX_SMEM) return ts;
  return 0;
}

struct Bufs {
  float *w, *dout, *dout_lo, *dm, *tc, *h, *dtc;  // dout: its big TF32 half, dout_lo the small
  int* sid;  // the tile's site ids (-1: none or dead)
  __device__ Bufs(float* base, const Layout& l) {
    auto up4 = [](size_t n) { return (n + 3) / 4 * 4; };
    w = base;
    dout = w + l.w;
    dout_lo = dout + up4(l.dout);
    dm = dout_lo + up4(l.dout);
    tc = dm + l.dm;
    h = tc + up4(l.tc);
    dtc = h + l.h;
    sid = reinterpret_cast<int*>(dtc + l.dtc);
  }
};

// W re-laid by stage: wt [i-chunk][f-chunk][o-chunk][FC f][OC o][IC i],
// zero past I, F and O, so that a stage is one contiguous block of
// FC·OC·IC floats (whole 128-byte lines; W [F, O, I] holds a stage's
// values in 32-byte pieces of 256 lines). One thread a float4 of wt.
constexpr int STAGE_FLOATS = FC * OC * IC;

__global__ void pooled_conv_bwd_wt_kernel(const float* __restrict__ w, float* __restrict__ wt,
                                          Dims d) {
  const int n_fc = (d.f + FC - 1) / FC, n_oc = (d.o + OC - 1) / OC;
  const int64_t n4 = static_cast<int64_t>((d.i + IC - 1) / IC) * n_fc * n_oc * STAGE_FLOATS / 4;
  for (int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; e < n4;
       e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t stage = e / (STAGE_FLOATS / 4);
    const int r = static_cast<int>(e % (STAGE_FLOATS / 4)) * 4;  // [ff][oo][ii] in the stage
    const int ii = r % IC, oo = (r / IC) % OC, ff = r / (IC * OC);
    const int q = static_cast<int>(stage % n_oc), fc = static_cast<int>((stage / n_oc) % n_fc);
    const int ic = static_cast<int>(stage / (static_cast<int64_t>(n_oc) * n_fc));
    const int f = fc * FC + ff, o = q * OC + oo;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = ic * IC + ii + j;
      v[j] = f < d.f && o < d.o && i < d.i ? w[(static_cast<int64_t>(f) * d.o + o) * d.i + i] : 0.f;
    }
    *reinterpret_cast<float4*>(wt + 4 * e) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// The copies (cp.async, no commit) of W stage (ic, fc, q) from wt into a W
// slot [OC o][FC f][IC i] (rows WS apart), of the tile's h [sites][K][f-chunk
// fc] and of its tc [rows][K][i-chunk ic], zero where out of range.
__device__ void load_w(const float* __restrict__ wt, const Dims& d, int ic, int fc, int q,
                       float* ws) {
  const int n_fc = (d.f + FC - 1) / FC, n_oc = (d.o + OC - 1) / OC;
  const float* src = wt + ((static_cast<int64_t>(ic) * n_fc + fc) * n_oc + q) * STAGE_FLOATS;
  for (int e = threadIdx.x; e < STAGE_FLOATS / 4; e += THREADS) {
    const int r = 4 * e, ii = r % IC, oo = (r / IC) % OC, ff = r / (IC * OC);
    cp_async<16>(ws + oo * WS + ff * IC + ii, src + r, true);
  }
}

template <bool VEC>
__device__ void load_h(const float* __restrict__ h, const Dims& d, int ts, int fc, const Bufs& b) {
  constexpr int V = VEC ? 4 : 1;
  const int f0 = fc * FC;
  for (int e = threadIdx.x; e < ts * d.k * FC / V; e += THREADS) {
    const int ff = (e % (FC / V)) * V, k = (e / (FC / V)) % d.k, site = e / (d.k * FC / V);
    const int s = b.sid[site], f = f0 + ff;
    const bool ok = s >= 0 && f < d.f;
    cp_async<4 * V>(b.h + (site * d.k + k) * HS + ff,
                    ok ? h + (static_cast<int64_t>(s) * d.k + k) * d.f + f : h, ok);
  }
}

template <bool VEC>
__device__ void load_tc(const float* __restrict__ tc, const Dims& d, int ts, int ic,
                        const Bufs& b) {
  constexpr int V = VEC ? 4 : 1;
  const int i0 = ic * IC, rows = ts * d.c;
  for (int e = threadIdx.x; e < rows * d.k * IC / V; e += THREADS) {
    const int ii = (e % (IC / V)) * V, k = (e / (IC / V)) % d.k, row = e / (d.k * IC / V);
    const int s = b.sid[row / d.c], i = i0 + ii;
    const bool ok = s >= 0 && i < d.i;
    const int64_t at = (static_cast<int64_t>(s) * d.k + k) * d.c * d.i +
                       static_cast<int64_t>(row % d.c) * d.i + i;
    cp_async<4 * V>(b.tc + (row * d.k + k) * TS_ + ii, ok ? tc + at : tc, ok);
  }
}

// The tile's dout rows [rows_pad][dout_stride], zero past the live rows
// and past O.
template <bool VEC>
__device__ void load_dout(const float* __restrict__ dout, const Dims& d, int ts, const Bufs& b) {
  constexpr int V = VEC ? 4 : 1;
  const int rp = rows_pad(ts, d.c), ostr = dout_stride(d.o), no = (ostr - 4) / V;
  for (int e = threadIdx.x; e < rp * no; e += THREADS) {
    const int o = (e % no) * V, row = e / no;
    const int s = row < ts * d.c ? b.sid[row / d.c] : -1;
    const bool ok = s >= 0 && o < d.o;
    cp_async<4 * V>(b.dout + row * ostr + o,
                    ok ? dout + (static_cast<int64_t>(s) * d.c + row % d.c) * d.o + o : dout, ok);
  }
}

// The staged dout rows split into their big (in place) and small TF32
// halves: the A operand of every product of the block, split once rather
// than by each warp at each use.
__device__ void split_dout(const Dims& d, int ts, const Bufs& b) {
  const int n = rows_pad(ts, d.c) * dout_stride(d.o);
  for (int e = threadIdx.x; e < n; e += THREADS) {
    uint32_t big, small;
    split_tf32(b.dout[e], big, small);
    b.dout[e] = as_float(big);
    b.dout_lo[e] = as_float(small);
  }
}

// acc[mt][nt] += dout[rows, q·OC …] · W stage, in 3xTF32, summed from 0
// over the stage's OC columns of O and then added to acc. Warp w owns the
// n8 tiles of f 2w and 2w + 1 (8 i each), all MT m16 tiles of rows.
template <int MT>
__device__ __forceinline__ void mma_stage(const Dims& d, int q, const float* ws, const Bufs& b,
                                          float (&acc)[MT][2][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int ostr = dout_stride(d.o);
  float part[MT][2][4] = {};
#pragma unroll
  for (int ks = 0; ks < OC / 8; ++ks) {
    const int oc = q * OC + ks * 8 + t;  // a's columns oc, oc + 4
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int at[4] = {(mt * 16 + g) * ostr + oc, (mt * 16 + g + 8) * ostr + oc,
                         (mt * 16 + g) * ostr + oc + 4, (mt * 16 + g + 8) * ostr + oc + 4};
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // split once a block (split_dout)
        ah[mt][j] = __float_as_uint(b.dout[at[j]]);
        al[mt][j] = __float_as_uint(b.dout_lo[at[j]]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const float* bp = ws + (ks * 8 + t) * WS + (2 * warp + nt) * IC + g;
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(bp[0], bh0, bl0);
      split_tf32(bp[4 * WS], bh1, bl1);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_3xtf32(part[mt][nt], ah[mt], al[mt], bh0, bh1, bl0, bl1);
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] += part[mt][nt][j];
}

// dh[fci·FC …] += s: f-chunk fci of a thread's dh sums, kept in registers
// (every index a constant).
template <int FCI>
__device__ __forceinline__ void add_chunk(float (&dh)[FMAX], const float (&s)[FC]) {
#pragma unroll
  for (int ff = 0; ff < FC; ++ff) dh[FCI * FC + ff] += s[ff];
}

__device__ __forceinline__ void add_dh(int fc, float (&dh)[FMAX], const float (&s)[FC]) {
  static_assert(FMAX == 8 * FC, "one case an f-chunk");
  switch (fc) {
    case 0: add_chunk<0>(dh, s); break;
    case 1: add_chunk<1>(dh, s); break;
    case 2: add_chunk<2>(dh, s); break;
    case 3: add_chunk<3>(dh, s); break;
    case 4: add_chunk<4>(dh, s); break;
    case 5: add_chunk<5>(dh, s); break;
    case 6: add_chunk<6>(dh, s); break;
    default: add_chunk<7>(dh, s); break;
  }
}

// dtc sums [rows][K][IC] += Σ_f h[site, k, f] · dM[row, f, i] over the
// f-chunk, and thread (site, k)'s dh sums [F] += Σ_{c,i} tc[row, k, i] ·
// dM[row, f, i]. At the i-chunk's last f-chunk (out: dtc) the thread that
// added a (row, k)'s dtc sums writes them out and zeroes them.
__device__ void reduce_chunk(const Dims& d, int ts, int ic, int fc, const Bufs& b,
                             float* __restrict__ out, float (&dh)[FMAX]) {
  const int rows = ts * d.c, i0 = ic * IC;
  for (int p = threadIdx.x; p < rows * d.k; p += THREADS) {
    const int row = p / d.k, k = p % d.k;
    const float* hp = b.h + ((row / d.c) * d.k + k) * HS;
    const float* mp = b.dm + row * DS;
    float s[IC] = {};
#pragma unroll 4
    for (int ff = 0; ff < FC; ++ff) {
      const float hv = hp[ff];
      const float4 m0 = *reinterpret_cast<const float4*>(mp + ff * IC);
      const float4 m1 = *reinterpret_cast<const float4*>(mp + ff * IC + 4);
      const float mv[IC] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
#pragma unroll
      for (int ii = 0; ii < IC; ++ii) s[ii] = fmaf(hv, mv[ii], s[ii]);
    }
    float* ap = b.dtc + p * AS;
    if (!out) {
#pragma unroll
      for (int ii = 0; ii < IC; ++ii) ap[ii] += s[ii];
      continue;
    }
    const int site = b.sid[row / d.c];
    float* op = out + (static_cast<int64_t>(site) * d.k + k) * d.c * d.i +
                static_cast<int64_t>(row % d.c) * d.i + i0;
#pragma unroll
    for (int ii = 0; ii < IC; ++ii) {
      if (site >= 0 && i0 + ii < d.i) op[ii] = ap[ii] + s[ii];
      ap[ii] = 0.f;
    }
  }
  const int p = threadIdx.x;
  if (p < ts * d.k) {
    const int site = p / d.k, k = p % d.k;
    float s[FC] = {};
    for (int c = 0; c < d.c; ++c) {
      const int row = site * d.c + c;
      const float4 t0 = *reinterpret_cast<const float4*>(b.tc + (row * d.k + k) * TS_);
      const float4 t1 = *reinterpret_cast<const float4*>(b.tc + (row * d.k + k) * TS_ + 4);
      const float tv[IC] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
      const float* mp = b.dm + row * DS;
#pragma unroll
      for (int ff = 0; ff < FC; ++ff) {
        const float4 m0 = *reinterpret_cast<const float4*>(mp + ff * IC);
        const float4 m1 = *reinterpret_cast<const float4*>(mp + ff * IC + 4);
        const float mv[IC] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
#pragma unroll
        for (int ii = 0; ii < IC; ++ii) s[ff] = fmaf(tv[ii], mv[ii], s[ff]);
      }
    }
    add_dh(fc, dh, s);  // 0 past F: W is 0 there
  }
}

// Zeros for the dh and dtc rows of the dead sites pos0 … pos0 + n − 1 of the list.
__device__ void store_dead(float* __restrict__ dh, float* __restrict__ dtc, const Dims& d,
                           const int* __restrict__ ids, int pos0, int n) {
  const int64_t dh_n = static_cast<int64_t>(d.k) * d.f;
  const int64_t dtc_n = static_cast<int64_t>(d.k) * d.c * d.i;
  for (int j = 0; j < n; ++j) {
    const int64_t s = ids ? ids[pos0 + j] : pos0 + j;
    for (int64_t e = threadIdx.x; e < dh_n; e += THREADS) dh[s * dh_n + e] = 0.f;
    for (int64_t e = threadIdx.x; e < dtc_n; e += THREADS) dtc[s * dtc_n + e] = 0.f;
  }
}

// One block per tile of ts sites of the list (ids, count: the live ones
// first; both null: every site live). Per step (i-chunk ic outer, f-chunk
// fc inner): the dM tile through the W ring, then its two reductions.
// W stage z = step · n_oc + q is committed as copy group z and issued
// STAGES − 1 stages ahead; the h (tc) chunk of a step (an i-chunk) rides
// with the W stage issued at its first o-chunk, after the last step's
// reductions.
template <int MT, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
pooled_conv_bwd_dm_kernel(const float* __restrict__ h, const float* __restrict__ tc,
                          const float* __restrict__ wt, const float* __restrict__ dout,
                          const int* __restrict__ ids, const int* __restrict__ count,
                          float* __restrict__ dh, float* __restrict__ dtc, Dims d, int ts) {
  extern __shared__ __align__(16) float smem[];
  const int n_live = count ? *count : d.s;
  const int p0 = blockIdx.x * ts;
  const int n_here = d.s - p0 < ts ? d.s - p0 : ts;
  if (p0 >= n_live) {  // dead sites only: the whole block, no barrier is skipped
    store_dead(dh, dtc, d, ids, p0, n_here);
    return;
  }
  const Layout lay(d, ts);
  const Bufs b(smem, lay);
  const int n_dead = p0 + n_here > n_live ? p0 + n_here - n_live : 0;
  for (int j = threadIdx.x; j < ts; j += THREADS) {
    const int p = p0 + j;
    b.sid[j] = p < n_live ? (ids ? ids[p] : p) : -1;
  }
  for (size_t e = threadIdx.x; e < lay.dtc; e += THREADS) b.dtc[e] = 0.f;
  __syncthreads();
  if (n_dead > 0) store_dead(dh, dtc, d, ids, n_live, n_dead);

  const int n_ic = (d.i + IC - 1) / IC, n_fc = (d.f + FC - 1) / FC, n_oc = (d.o + OC - 1) / OC;
  const int n_steps = n_ic * n_fc, n_stages = n_steps * n_oc;
  // prologue: dout, h, tc and W stage 0 (group 0), W stages 1 … STAGES − 2
  load_dout<VEC>(dout, d, ts, b);
  load_h<VEC>(h, d, ts, 0, b);
  load_tc<VEC>(tc, d, ts, 0, b);
  for (int z = 0; z < STAGES - 1; ++z) {
    if (z < n_stages) {
      const int st = z / n_oc;
      load_w(wt, d, st / n_fc, st % n_fc, z % n_oc, b.w + z * OC * WS);
    }
    cp_async_commit();
  }

  float acc[MT][2][4];
  float dh_sums[FMAX] = {};  // thread (site, k) = (tid / K, tid % K) of the tile
  for (int step = 0; step < n_steps; ++step) {
    const int ic = step / n_fc, fc = step % n_fc;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;
    for (int q = 0; q < n_oc; ++q) {
      const int z = step * n_oc + q;
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // stage z arrived; every warp is done with stage z − 1's slot
      if (z + STAGES - 1 < n_stages) {
        const int z2 = z + STAGES - 1, st2 = z2 / n_oc;
        load_w(wt, d, st2 / n_fc, st2 % n_fc, z2 % n_oc, b.w + (z2 % STAGES) * OC * WS);
        if (q == 0 && step > 0) {  // this step's h (and tc) chunk: the last step's reads are done
          load_h<VEC>(h, d, ts, fc, b);
          if (fc == 0) load_tc<VEC>(tc, d, ts, ic, b);
        }
      } else if (q == 0 && step > 0) {
        load_h<VEC>(h, d, ts, fc, b);
        if (fc == 0) load_tc<VEC>(tc, d, ts, ic, b);
      }
      cp_async_commit();
      if (z == 0) {  // the dout rows arrived with stage 0: split them, once
        split_dout(d, ts, b);
        __syncthreads();
      }
      mma_stage<MT>(d, q, b.w + (z % STAGES) * OC * WS, b, acc);
    }
    // the dM tile to shared memory: lane (g, t) holds rows g, g + 8 and
    // columns 2t, 2t + 1 of each n8 tile (f 2w + nt, i)
    {
      const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            *reinterpret_cast<float2*>(b.dm + (mt * 16 + half * 8 + g) * DS +
                                       (2 * warp + nt) * IC + 2 * t) =
                make_float2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
    }
    if (n_oc < STAGES) cp_async_wait<0>();  // a short O: this step's h and tc may be in flight
    __syncthreads();  // the dM tile, h and tc chunks are visible
    reduce_chunk(d, ts, ic, fc, b, fc + 1 == n_fc ? dtc : nullptr, dh_sums);
    __syncthreads();  // the reads of the dM tile, h and tc are done
  }
  cp_async_wait<0>();
  // dh [S, K, F] of the live sites of the tile, a (site, k) row a thread
  if (threadIdx.x < ts * d.k) {
    const int s = b.sid[threadIdx.x / d.k];
    if (s < 0) return;
    float* row = dh + (static_cast<int64_t>(s) * d.k + threadIdx.x % d.k) * d.f;
    if (VEC) {
#pragma unroll
      for (int f = 0; f < FMAX; f += 4)
        if (f < d.f)
          *reinterpret_cast<float4*>(row + f) =
              make_float4(dh_sums[f], dh_sums[f + 1], dh_sums[f + 2], dh_sums[f + 3]);
    } else {
#pragma unroll
      for (int f = 0; f < FMAX; ++f)
        if (f < d.f) row[f] = dh_sums[f];
    }
  }
}

}  // namespace dm

// ----------------------------------------------------------- kernel K: dW

namespace dw {

constexpr int BM = 64;          // (i, f) pairs of a block: 8 i × 8 f, f outer
constexpr int PI = 8, PF = 8;   // i and f of a block
constexpr int BN = 256;         // columns of O of a block
constexpr int RC = 32;          // rows of a chunk of the contraction
constexpr int AS = RC + 4;      // row (pair) stride of the A tile
constexpr int BS = BN + 8;      // row stride of a dout stage
constexpr int CONSUMERS = 256;  // 8 warps of products: 2 (pairs) × 4 (columns of O)
constexpr int PRODUCERS = 128;  // 4 warps of copies and M-builds
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr int BSLOTS = 3;       // dout stages in the ring
constexpr int BAR_FULL = 1, BAR_EMPTY = 3, BAR_PROD = 5;

__host__ __device__ inline int stride(int k) { return k * 8 + 4; }  // a row's staged h or tc

struct Layout {
  size_t b, h, a;  // a dout stage, an h (or tc) stage, an A tile (big or small)
  __host__ __device__ explicit Layout(int k)
      : b(static_cast<size_t>(RC) * BS), h(static_cast<size_t>(RC) * stride(k)),
        a(static_cast<size_t>(BM) * AS) {}
  __host__ __device__ size_t floats() const { return BSLOTS * b + 4 * h + 4 * a; }
};

size_t smem_bytes(int k) {
  return Layout(k).floats() * sizeof(float) + 2 * RC * 3 * sizeof(int64_t);
}

struct Bufs {
  float *b, *h, *t, *a;  // dout stages, h stages, tc stages, A tiles (slot-major: big, small)
  // [2][RC][3]: where each row of the two staged chunks starts in dout, h
  // and tc (dout's −1: no row)
  int64_t* ro;
};

// The site of row rr of chunk n (−1 past the live rows): a global load,
// issued a chunk before it is used.
__device__ __forceinline__ int row_site(const Dims& d, const int* __restrict__ ids, int n_rows,
                                        int n, int rr) {
  const int r = n * RC + rr;
  return r < n_rows ? (ids ? ids[r / d.c] : r / d.c) : -1;
}

// Where row rr (site s) of chunk n starts in dout, h and tc, into slot
// n & 1 (read by the producers after a producer barrier).
__device__ __forceinline__ void set_row(const Dims& d, int n, int rr, int s, const Bufs& b) {
  int64_t* ro = b.ro + ((n & 1) * RC + rr) * 3;
  const int c = (n * RC + rr) % d.c;
  ro[0] = s >= 0 ? (static_cast<int64_t>(s) * d.c + c) * d.o : -1;
  ro[1] = static_cast<int64_t>(s) * d.k * d.f;
  ro[2] = static_cast<int64_t>(s) * d.k * d.c * d.i + static_cast<int64_t>(c) * d.i;
}

// Copies of chunk n (rows 32n …): dout rows into stage n % BSLOTS, h and
// tc rows into stage n & 1, by the producers (p = their index), from the
// rows' offsets in slot n & 1. No commit.
template <bool VEC>
__device__ void load_chunk(const float* __restrict__ h, const float* __restrict__ tc,
                           const float* __restrict__ dout, const Dims& d, int n, int i0, int f0,
                           int o0, const Bufs& b, int p) {
  constexpr int V = VEC ? 4 : 1;
  constexpr int JN = 8 / V;             // copies of a (row, k)'s 8 f (or 8 i)
  constexpr int RPP = PRODUCERS / JN;   // (row, k) pairs a pass
  const Layout lay(d.k);
  const int64_t* ro = b.ro + (n & 1) * RC * 3;
  float* bd = b.b + (n % BSLOTS) * lay.b;
  float* hd = b.h + (n & 1) * lay.h;
  float* td = b.t + (n & 1) * lay.h;
  const int hs = stride(d.k);
  for (int e = p; e < RC * (BN / V); e += PRODUCERS) {
    const int o = (e % (BN / V)) * V, rr = e / (BN / V);
    const int64_t at = ro[rr * 3];
    const bool ok = at >= 0 && o0 + o < d.o;
    cp_async<4 * V>(bd + rr * BS + o, ok ? dout + at + o0 + o : dout, ok);
  }
  const int j = (p % JN) * V;
  for (int e = p / JN; e < RC * d.k; e += RPP) {  // e = k·RC + row: a warp's lanes on 16 rows
    const int rr = e % RC, k = e / RC;
    const bool live = ro[rr * 3] >= 0;
    const bool okh = live && f0 + j < d.f, okt = live && i0 + j < d.i;
    cp_async<4 * V>(hd + rr * hs + k * 8 + j,
                    okh ? h + ro[rr * 3 + 1] + static_cast<int64_t>(k) * d.f + f0 + j : h, okh);
    cp_async<4 * V>(td + rr * hs + k * 8 + j,
                    okt ? tc + ro[rr * 3 + 2] + static_cast<int64_t>(k) * d.c * d.i + i0 + j : tc,
                    okt);
  }
}

// Mᵀ[pair (f 2q + rf, i j), row rr] of chunk n, split into big and small,
// into A slot n & 1: producer p builds row p % 32, f pair p / 32, k in order.
__device__ void build_a(const Dims& d, int n, const Bufs& b, int p) {
  const Layout lay(d.k);
  const int hs = stride(d.k);
  const int rr = p % RC, q = p / RC;
  const float* hp = b.h + (n & 1) * lay.h + rr * hs + 2 * q;
  const float* tp = b.t + (n & 1) * lay.h + rr * hs;
  float m[2][8] = {};
#pragma unroll 4
  for (int k = 0; k < d.k; ++k) {
    const float2 hv = *reinterpret_cast<const float2*>(hp + k * 8);
    const float4 t0 = *reinterpret_cast<const float4*>(tp + k * 8);
    const float4 t1 = *reinterpret_cast<const float4*>(tp + k * 8 + 4);
    const float tv[8] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      m[0][j] = fmaf(hv.x, tv[j], m[0][j]);
      m[1][j] = fmaf(hv.y, tv[j], m[1][j]);
    }
  }
  float* ah = b.a + (n & 1) * 2 * lay.a + rr;
  float* al = ah + lay.a;
#pragma unroll
  for (int rf = 0; rf < 2; ++rf)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int pair = (2 * q + rf) * PI + j;
      uint32_t big, small;
      split_tf32(m[rf][j], big, small);
      ah[pair * AS] = as_float(big);
      al[pair * AS] = as_float(small);
    }
}

// acc += A slot n & 1 · dout stage n % BSLOTS in 3xTF32, summed from 0 over
// the chunk's 32 rows and then added to acc: consumer warp (wm, wn) owns
// pairs wm·32 … +31 (2 m16 tiles) and columns wn·64 … +63 (8 n8 tiles).
__device__ __forceinline__ void mma_chunk(const Dims& d, int n, const Bufs& b,
                                          float (&acc)[2][8][4]) {
  const Layout lay(d.k);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = (warp / 4) * 32 + g, c0 = (warp % 4) * 64 + g;
  const float* bs = b.b + (n % BSLOTS) * lay.b;
  const float* ahi = b.a + (n & 1) * 2 * lay.a;
  const float* alo = ahi + lay.a;
  float part[2][8][4] = {};
#pragma unroll
  for (int ks = 0; ks < RC / 8; ++ks) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int r = r0 + mt * 16, col = ks * 8 + t;
      const int at[4] = {r * AS + col, (r + 8) * AS + col, r * AS + col + 4,
                         (r + 8) * AS + col + 4};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ah[mt][j] = __float_as_uint(ahi[at[j]]);
        al[mt][j] = __float_as_uint(alo[at[j]]);
      }
    }
    const float* bk = bs + (ks * 8 + t) * BS;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int o = c0 + nt * 8;
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(bk[o], bh0, bl0);
      split_tf32(bk[4 * BS + o], bh1, bl1);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_3xtf32(part[mt][nt], ah[mt], al[mt], bh0, bh1, bl0, bl1);
    }
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] += part[mt][nt][j];
}

// One block per (64 pairs, BN columns of O); the live rows (site ids[r / C],
// c = r % C, r < count·C) in chunks of 32, as kernel J walks its chunks:
//  producers, chunk n: wait for chunk n's copies; wait until the consumers
//    are done with chunk n − 2 (A slot n & 1, dout stage (n + 1) % 3);
//    start the copies of chunk n + 1; build A(n); signal it full.
//  consumers, chunk n: wait for A(n); multiply; signal A slot n & 1 empty.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
pooled_conv_bwd_dw_kernel(const float* __restrict__ h, const float* __restrict__ tc,
                          const float* __restrict__ dout, const int* __restrict__ ids,
                          const int* __restrict__ count, float* __restrict__ dw, Dims d) {
  extern __shared__ __align__(16) float smem[];
  const Layout lay(d.k);
  Bufs b;
  b.b = smem;
  b.h = b.b + BSLOTS * lay.b;
  b.t = b.h + 2 * lay.h;
  b.a = b.t + 2 * lay.h;
  b.ro = reinterpret_cast<int64_t*>(b.a + 4 * lay.a);
  const int n_fp = (d.f + PF - 1) / PF;
  const int i0 = (blockIdx.x / n_fp) * PI, f0 = (blockIdx.x % n_fp) * PF, o0 = blockIdx.y * BN;
  const int n_rows = (count ? *count : d.s) * d.c;
  const int n_chunks = d.k > 0 ? (n_rows + RC - 1) / RC : 0;

  if (threadIdx.x >= CONSUMERS) {  // producers
    const int p = threadIdx.x - CONSUMERS;
    // producer p < RC keeps the site of row p of the chunk after the next
    // in a register: its load has a chunk's time to land
    int next_site = -1;
    if (n_chunks > 0) {
      if (p < RC) {
        set_row(d, 0, p, row_site(d, ids, n_rows, 0, p), b);
        if (n_chunks > 1) next_site = row_site(d, ids, n_rows, 1, p);
      }
      bar_sync(BAR_PROD, PRODUCERS);
      load_chunk<VEC>(h, tc, dout, d, 0, i0, f0, o0, b, p);
      cp_async_commit();
    }
    for (int n = 0; n < n_chunks; ++n) {
      if (p < RC && n + 1 < n_chunks) {  // slot (n + 1) & 1: chunk n − 1's
        set_row(d, n + 1, p, next_site, b);
        if (n + 2 < n_chunks) next_site = row_site(d, ids, n_rows, n + 2, p);
      }
      cp_async_wait_all();
      bar_sync(BAR_PROD, PRODUCERS);  // chunk n's operands, chunk n + 1's rows: every producer's
      if (n >= 2) bar_sync(BAR_EMPTY + (n & 1), THREADS);
      if (n + 1 < n_chunks) {
        load_chunk<VEC>(h, tc, dout, d, n + 1, i0, f0, o0, b, p);
        cp_async_commit();
      }
      build_a(d, n, b, p);
      bar_arrive(BAR_FULL + (n & 1), THREADS);
    }
    return;
  }

  float acc[2][8][4] = {};
  for (int n = 0; n < n_chunks; ++n) {
    bar_sync(BAR_FULL + (n & 1), THREADS);
    mma_chunk(d, n, b, acc);
    if (n + 2 < n_chunks) bar_arrive(BAR_EMPTY + (n & 1), THREADS);
  }
  // dW[f, o, i]: lane (g, t) holds pairs (rows) g, g + 8 and columns 2t, 2t + 1
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int pair = (warp / 4) * 32 + mt * 16 + half * 8 + g;
      const int f = f0 + pair / PI, i = i0 + pair % PI;
      if (f >= d.f || i >= d.i) continue;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int o = o0 + (warp % 4) * 64 + nt * 8 + 2 * t + j;
          if (o < d.o)
            dw[(static_cast<int64_t>(f) * d.o + o) * d.i + i] = acc[mt][nt][2 * half + j];
        }
    }
}

}  // namespace dw

cudaError_t zero(float* p, int64_t n, cudaStream_t stream) {
  return n > 0 ? cudaMemsetAsync(p, 0, n * sizeof(float), stream) : cudaSuccess;
}

int64_t wt_floats(int i, int f, int o) {
  return static_cast<int64_t>((i + dm::IC - 1) / dm::IC) * ((f + dm::FC - 1) / dm::FC) *
         ((o + dm::OC - 1) / dm::OC) * dm::STAGE_FLOATS;
}

template <int MT, bool VEC>
cudaError_t launch_dm(const float* h, const float* tc, const float* wt, const float* dout,
                      const int* ids, const int* count, float* dh, float* dtc, const Dims& d,
                      int ts, cudaStream_t stream) {
  const size_t bytes = dm::smem_bytes(d, ts);
  const cudaError_t err = set_smem(dm::pooled_conv_bwd_dm_kernel<MT, VEC>, bytes);
  if (err != cudaSuccess) return err;
  dm::pooled_conv_bwd_dm_kernel<MT, VEC><<<(d.s + ts - 1) / ts, dm::THREADS, bytes, stream>>>(
      h, tc, wt, dout, ids, count, dh, dtc, d, ts);
  return cudaGetLastError();
}

// W re-laid into wt, then the dM kernel for a tile of ts sites.
template <bool VEC>
cudaError_t launch_dm_rows(const float* h, const float* tc, const float* w, float* wt,
                           const float* dout, const int* ids, const int* count, float* dh,
                           float* dtc, const Dims& d, int ts, cudaStream_t stream) {
  const int64_t n4 = wt_floats(d.i, d.f, d.o) / 4;
  const unsigned blocks = static_cast<unsigned>(n4 / 256 + 1 < 132 * 8 ? n4 / 256 + 1 : 132 * 8);
  dm::pooled_conv_bwd_wt_kernel<<<blocks, 256, 0, stream>>>(w, wt, d);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows = ts * d.c;
  if (rows <= 16) return launch_dm<1, VEC>(h, tc, wt, dout, ids, count, dh, dtc, d, ts, stream);
  if (rows <= 32) return launch_dm<2, VEC>(h, tc, wt, dout, ids, count, dh, dtc, d, ts, stream);
  return launch_dm<4, VEC>(h, tc, wt, dout, ids, count, dh, dtc, d, ts, stream);
}

}  // namespace

// Floats of the workspace `pooled_conv_bwd_f32` takes (W re-laid by stage).
extern "C" int pooled_conv_bwd_workspace_f32(int i, int f, int o, int64_t* floats) {
  if (i < 0 || f < 0 || o < 0) return static_cast<int>(cudaErrorInvalidValue);
  *floats = wt_floats(i, f, o);
  return 0;
}

// Writes dh [S, K, F], dtc [S, K, C·I] and dw [F, O, I] for the output
// gradient dout [S, C, O] at the live sites: ids [S] (the live sites' ids
// first) and count [1], both int32 on the device, or both null (every site
// live). dh and dtc are 0 at the dead sites. ws: a 16-byte aligned
// workspace of `pooled_conv_bwd_workspace_f32` floats. Three kernels on
// `stream` (W re-laid, dM with dh and dtc, dW).
extern "C" int pooled_conv_bwd_f32(const float* h, const float* tc, const float* w,
                                   const float* dout, const int* ids, const int* count, float* dh,
                                   float* dtc, float* dw, float* ws, int s, int k, int c, int i,
                                   int f, int o, cudaStream_t stream) {
  const Dims d{s, k, c, i, f, o};
  if (s < 0 || k < 0 || c < 1 || c > 64 || i < 0 || f < 0 || o < 0 || (!ids != !count) ||
      !aligned16(ws))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = i % 4 == 0 && f % 4 == 0 && o % 4 == 0 && aligned16(h) && aligned16(tc) &&
                   aligned16(w) && aligned16(dout);
  cudaError_t err = cudaSuccess;
  const int ts = dm::tile_sites(d);
  const bool dw_work = i > 0 && f > 0 && o > 0;
  if (ts == 0 || (dw_work && s > 0 && k > 0 && dw::smem_bytes(k) > MAX_SMEM))
    return static_cast<int>(cudaErrorInvalidValue);  // a tile does not fit a block
  if (s > 0 && k > 0) {
    if (i == 0 || f == 0 || o == 0) {  // dM is empty or 0
      if ((err = zero(dh, static_cast<int64_t>(s) * k * f, stream)) != cudaSuccess ||
          (err = zero(dtc, static_cast<int64_t>(s) * k * c * i, stream)) != cudaSuccess)
        return static_cast<int>(err);
    } else {
      err = vec ? launch_dm_rows<true>(h, tc, w, ws, dout, ids, count, dh, dtc, d, ts, stream)
                : launch_dm_rows<false>(h, tc, w, ws, dout, ids, count, dh, dtc, d, ts, stream);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  if (!dw_work) return 0;
  if (s == 0 || k == 0) return static_cast<int>(zero(dw, static_cast<int64_t>(f) * o * i, stream));
  const size_t bytes = dw::smem_bytes(k);
  const dim3 grid(((i + dw::PI - 1) / dw::PI) * ((f + dw::PF - 1) / dw::PF),
                  (o + dw::BN - 1) / dw::BN);
  if (vec) {
    if ((err = set_smem(dw::pooled_conv_bwd_dw_kernel<true>, bytes)) != cudaSuccess)
      return static_cast<int>(err);
    dw::pooled_conv_bwd_dw_kernel<true><<<grid, dw::THREADS, bytes, stream>>>(h, tc, dout, ids,
                                                                               count, dw, d);
  } else {
    if ((err = set_smem(dw::pooled_conv_bwd_dw_kernel<false>, bytes)) != cudaSuccess)
      return static_cast<int>(err);
    dw::pooled_conv_bwd_dw_kernel<false><<<grid, dw::THREADS, bytes, stream>>>(h, tc, dout, ids,
                                                                                count, dw, d);
  }
  return static_cast<int>(cudaGetLastError());
}
