// The fused pooled ConvSE3 unit of the SE(3)-Transformer in bfloat16: kernel
// J (forward) and kernel K (backward) of the bfloat16 path. The float32 J
// and K are `pooled_conv_fwd.cu` and `pooled_conv.cu`, kept apart.
//
//   M[s,c,i,f]   = bf16(Σ_k h[s,k,f] · tc[s,k,c,i])               (k = the neighbours)
//   J out[s,c,o] = bf16(Σ_{i,f} W[f,o,i] · M[s,c,i,f])            (s live, else 0)
//   K dM[s,c,i,f]  = bf16(Σ_o dout[s,c,o] · W[f,o,i])             (s live)
//     dh[s,k,f]    = bf16(Σ_{c,i} tc[s,k,c,i] · dM[s,c,i,f])      (0 at dead sites)
//     dtc[s,k,c,i] = bf16(Σ_f h[s,k,f] · dM[s,c,i,f])             (0 at dead sites)
//     dW[f,o,i]    = bf16(Σ_{s live, c} M[s,c,i,f] · dout[s,c,o])
//
// Every sum is a float32 sum of exact products of bfloat16 values, rounded
// to bfloat16 once, where JAX's bfloat16 Pallas kernels round
// (`equihgnn_tpu/ops/pallas/pooled_conv.py`: M in VMEM `:97`, out `:111`,
// dM `:134`, dh and dtc `:152-158`, dW summed in f32 over the whole grid
// and rounded once `:132, :141`). M is built on the CUDA cores, k in order
// from +0 with `fmaf`, in J and in K's dW alike. Shapes (s = the G·A sites):
// h [S, K, F]; tc [S, K, C·I] (c outer, i inner); W [F, O, I] and dW as JAX
// lays them out (i contiguous); out and dout [S, C, O]. All bfloat16. The
// live sites are given, as for the f32 kernels, by the ids of the sites
// (live ones first) and their count, both on the device; without them every
// site is live. A dead site's out is not written (the caller zeroes it),
// its dout is not read, and its dh and dtc are written as +0.
// Replaces equihgnn_tpu/ops/pallas/pooled_conv.py `_pc_fwd` (J) and
// `_pc_bwd` (K) in bfloat16.
//
// Bound on the H100 (batch 768: S' = 12,731 live sites, E = 171,817 live
// site-neighbour pairs, K = 16, F = 128, I = O = 256): operations at the
// bf16 tensor peak (989 TFLOP/s). J 2(E·CIF + S'·CIFO): 0.227 ms at C = 1,
// 0.682 at C = 3; K 2(3E·CIF + 2S'·CIFO): 0.466 / 1.398 ms. Bytes (each
// input read once, each output written once, at 3.35 TB/s) bound neither:
// 0.046 / 0.103 ms (J), 0.091 / 0.200 ms (K). What a kernel cannot avoid
// here is reading W (16.8 MB) again for each tile of rows from L2, and the
// M-sized CUDA-core contractions (the M build: E·C·I·F = 5.6e9 FMAs at C =
// 1), which are as large as the projection's tensor-core work.
//
// Design: deterministic (no atomics; each output element owned by one
// thread and summed in a fixed order, so two runs give the same bits). Each
// chunk of a contraction is summed from 0 in the tensor cores and added to
// float32 running sums on the CUDA cores (the tensor cores' adds truncate:
// carried over a whole contraction they drift, PERF.md). The model's shapes
// (K ≤ 16, I a multiple of 8) take the fast kernels: W by TMA (its 32-byte
// rows swizzled as the tensor cores read them), the rest by cp.async. Every
// other shape (a ragged I, K up to 32, a tile that does not fit) takes the
// general kernels in this file: cp.async copies, element by element where a
// row is not 16-byte aligned, bf16 mma.sync; the same sums.
//
//  - J (`fwd_tma_kernel`): a persistent grid, a row of one block an SM; the
//    kernel spreads the live sites evenly over it, a block's share in tiles
//    of near-equal size, at most 64 rows each (at C = 1: 96 or 97 sites a
//    block, a tile of 48 and one of 48 or 49, where tiles of 64 sites, 199
//    on 132 SMs, leave the second round half empty; an M tile's rows are
//    built 16 to a warp, so 48 rows take 3 of a warpgroup's warps and 49
//    take 4). A tile is its sites' rows × 256 columns of O; the contraction
//    (i, f) in chunks of 16 i × 4 f (four k16 steps, each 16 consecutive i
//    of one f, which W holds contiguously). Three producer warpgroups build
//    the bf16 M tile [64 rows, 64 columns] of a chunk on the CUDA cores,
//    chunk n the warpgroup n % 3's, register-tiled (a thread one row × 4 f
//    × 8 i: 12 operands a k for 32 FMAs, k in order); they share the copies
//    of h (16 f, four chunks, at a time) and tc (an i-chunk ahead). Two
//    consumer warpgroups multiply the M tiles (4 in flight) by their W stage
//    with wgmma m64n128k16, each warpgroup 128 of the 256 columns, both
//    operands read from shared memory, 4 chunks (256 columns) summed from 0.
//    W comes by TMA into a ring of 2 stages, refilled by a consumer as soon
//    as both warpgroups are past a stage; the ring and the M slots run on
//    from one of a block's tiles to the next. The producers give registers
//    up for the consumers (setmaxnreg). W is read from L2 once a tile: 4.4
//    GB a call at C = 1 (264 tiles; 3.3 GB as 199 tiles of 64 sites).
//  - K, dM with dtc (`dm_tma_kernel<false, KT>`) and dM with dh
//    (`dm_tma_kernel<true, KT>`): dtc sums over f and dh over (c, i), so no
//    one order of the chunks completes both; each kernel computes dM again
//    on the tensor cores in the order that completes its own. One block a
//    tile of 64 / C sites (64 rows), 8 warps; the tile's dout rows staged
//    once; chunks of dM of 16 f × 16 i (256 columns) summed over all of O
//    from W stages [16 f, 64 o, 16 i] that come by TMA into a ring of 4,
//    rounded to bf16 into shared memory. Then per row (dtc) or per site
//    (dh) bf16 mma.sync.m16n8k16 products whose M dimension is the K = 16
//    neighbours: dtc_r [16 k × 16 i] += h_s [16 k × 16 f] · dM_r, dh_s [16 k
//    × 16 f] += Σ_c tc_(s,c) [16 k × 16 i] · dM_(s,c); each summed from 0
//    and added to float32 sums in registers, written once their contraction
//    is whole. Tiles past the live count write their sites' dh and dtc as +0.
//  - K, dW (`kv::dw_kernel`): one block 16 f × 8 i (128 pairs) × 256 columns
//    of O over the live rows, 32 a chunk; 4 producer warps copy a chunk's
//    h, tc and dout rows (a row's site looked up once, two chunks ahead)
//    and rebuild its Mᵀ exactly as J builds M (the same bits), 8 consumer
//    warps multiply Mᵀ [128 pairs, 32 rows] by dout [32 rows, 256 o] (both
//    read by ldmatrix.trans), each chunk summed from 0; the consumers hold
//    128 sums a thread (setmaxnreg). 256 blocks at the model's shapes fill
//    the card without splitting the rows, so no second pass.
// Limits: K ≤ 32 and C ≤ 64 (a tile holds the C rows of one site at
// least). The dM kernels stage the tile's dout rows whole: 128·O bytes with
// their other buffers within a block's shared memory (O up to 1,088 at K =
// 16 and C = 1). A shape that does not fit is refused (cudaErrorInvalidValue).

#include <cstdint>

#include <cuda.h>  // CUtensorMap (the driver's entry is looked up at run time)
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int MAX_K = 32;
constexpr int MAX_C = 64;
constexpr size_t MAX_SMEM = 232448;  // shared memory a block may use on Hopper

// ------------------------------------------------------------- device helpers

__device__ __forceinline__ uint32_t sa(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (8) bytes from global to shared memory, asynchronously.
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa(dst)), "l"(src));
}

__device__ __forceinline__ void cp8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(sa(dst)), "l"(src));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Waits until at most n of this thread's copy groups are in flight (n ≤ 2).
__device__ __forceinline__ void cp_wait(int n) {
  if (n <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
}

// Four (two) 8×8 bf16 matrices from shared memory, row addresses from the
// lanes 8m … 8m + 7 of matrix m.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(sa(p)));
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(sa(p)));
}

__device__ __forceinline__ void ldsm2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(sa(p)));
}

// d += a · b: one bf16 m16n8k16 tensor-core product with f32 sums (a row-
// major, b column-major fragments).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Named barriers: bar_sync waits until n threads have arrived at barrier
// id (itself included); bar_arrive counts this thread and goes on. Both
// order this thread's earlier shared-memory writes before the waiters'
// later reads.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// mbarriers: init to n arrivals (then a fence before the cluster and the
// async proxy see them); this thread's arrival with `bytes` more expected
// from copies; wait for the phase of `parity` to complete.
__device__ __forceinline__ void mbar_init(uint64_t* b, int n) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(sa(b)), "r"(n) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(sa(b)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* b, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(sa(b)), "r"(parity)
        : "memory");
  } while (!done);
}

// A 3-D box of a tensor map (coordinates innermost first) into dst,
// completing on barrier b.
__device__ __forceinline__ void tma_3d(void* dst, const void* map, uint64_t* b, int c0, int c1,
                                       int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(sa(dst)),
      "l"(map), "r"(sa(b)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A wgmma shared-memory matrix descriptor: K-major rows, 8-row groups sbo
// bytes apart, swizzle `layout` (1: 128-byte, 3: 32-byte).
__device__ __forceinline__ uint64_t wg_desc(const void* p, int sbo, int layout) {
  return static_cast<uint64_t>((sa(p) & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (static_cast<uint64_t>(layout) << 62);
}

// wgmma ordering: the fence before a warpgroup's products (after its
// registers were touched), the commit of its issued products, the wait for
// all of them; and the fence that shows this thread's generic shared-memory
// writes to the async proxy (the tensor cores' operand reads).
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (+)= A · B for one warpgroup: wgmma m64n128k16, bf16 in, f32 sums;
// A [64 × 16] and B [128 × 16] K-major in shared memory (descriptors);
// scale_d 0: d = A · B.
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Registers a thread of this warpgroup may hold, lowered or raised to N
// (the warpgroup's four warps together; the CTA's pool is shared).
template <int N>
__device__ __forceinline__ void regs_down() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_up() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ------------------------------------------------------------ shared helpers

struct Dims {
  int s, k, c, i, f, o;  // sites, neighbours, C, I, F, O
};

// 8 bf16 at src, of which n are valid (0 past n, none where n ≤ 0), into 16
// bytes of shared memory: one cp.async where `vec` (src 16-byte aligned) and
// all 8 are valid, else element by element.
__device__ __forceinline__ void stage8(void* dst, const bf16* src, int n, bool vec) {
  if (vec && n >= 8) {
    cp16(dst, src);
    return;
  }
  uint4 v = make_uint4(0, 0, 0, 0);
  bf16* e = reinterpret_cast<bf16*>(&v);
  for (int j = 0; j < 8 && j < n; ++j) e[j] = src[j];
  *reinterpret_cast<uint4*>(dst) = v;
}

// The same for 4 bf16 (8 bytes; `vec`: src 8-byte aligned).
__device__ __forceinline__ void stage4(void* dst, const bf16* src, int n, bool vec) {
  if (vec && n >= 4) {
    cp8(dst, src);
    return;
  }
  uint2 v = make_uint2(0, 0);
  bf16* e = reinterpret_cast<bf16*>(&v);
  for (int j = 0; j < 4 && j < n; ++j) e[j] = src[j];
  *reinterpret_cast<uint2*>(dst) = v;
}

// The bf16 values in the low and high half of a word, as float32 (exact).
__device__ __forceinline__ float lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// Two floats rounded to bf16, a in the low half.
__device__ __forceinline__ uint32_t pack(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One producer's share of an M chunk: m[fl][j] = Σ_k h[k, fl] · t[k, j], k
// in order from +0, for 4 f (h: 8 bytes a k at hp, hp_step apart) and 8 i
// (t: 16 bytes a k at tp, tp_step apart), rounded to bf16 into 4 × 16 bytes.
__device__ __forceinline__ void build_m(const bf16* hp, int hp_step, const bf16* tp, int tp_step,
                                        int k_n, uint4 (&out)[4]) {
  float m[4][8];
#pragma unroll
  for (int fl = 0; fl < 4; ++fl)
#pragma unroll
    for (int j = 0; j < 8; ++j) m[fl][j] = 0.f;
#pragma unroll 2
  for (int k = 0; k < k_n; ++k) {
    const uint2 hv = *reinterpret_cast<const uint2*>(hp + k * hp_step);
    const uint4 tv = *reinterpret_cast<const uint4*>(tp + k * tp_step);
    const float hf[4] = {lo(hv.x), hi(hv.x), lo(hv.y), hi(hv.y)};
    const float tf[8] = {lo(tv.x), hi(tv.x), lo(tv.y), hi(tv.y),
                         lo(tv.z), hi(tv.z), lo(tv.w), hi(tv.w)};
#pragma unroll
    for (int fl = 0; fl < 4; ++fl)
#pragma unroll
      for (int j = 0; j < 8; ++j) m[fl][j] = fmaf(hf[fl], tf[j], m[fl][j]);
  }
#pragma unroll
  for (int fl = 0; fl < 4; ++fl)
    out[fl] = make_uint4(pack(m[fl][0], m[fl][1]), pack(m[fl][2], m[fl][3]),
                         pack(m[fl][4], m[fl][5]), pack(m[fl][6], m[fl][7]));
}

// Byte offset of 16-byte segment `seg` of row `r` in a tile of 128-byte (or
// longer) rows, the segments of each row permuted by r & 7 so that 8 rows'
// same segment lie in 8 different bank groups.
__host__ __device__ inline int swz(int r, int row_bytes, int seg) {
  return r * row_bytes + ((seg ^ (r & 7)) << 4);
}

size_t up16(size_t bytes) { return (bytes + 15) / 16 * 16; }

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

cudaError_t set_smem(const void* kernel, size_t smem) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

// ------------------------------------------------------------- kernel J

namespace j {

constexpr int BM = 64;                 // rows of a tile
constexpr int BN = 256;                // columns of O of a block
constexpr int IC = 16;                 // i of a chunk: one k16 step
constexpr int FC = 4;                  // f of a chunk: four k16 steps
constexpr int CONSUMERS = 256;         // 8 warps of products: 2 (rows) × 4 (columns)
constexpr int PRODUCERS = 128;         // 4 warps of copies and M builds
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr int W_BYTES = FC * BN * IC * 2;  // a W stage [4 f, 256 o, 16 i]: 32 KB
constexpr int M_BYTES = BM * FC * IC * 2;  // an M tile [64 rows, 64 columns]: 8 KB
constexpr int BAR_FULL = 1, BAR_EMPTY = 3, BAR_PROD = 5;

struct Layout {  // byte offsets of the shared-memory regions; ns = 0: none fits
  int ns = 0, tb = 0;         // stages of the W and h ring, tc buffers
  int h_bytes = 0, tc_bytes = 0;
  size_t h = 0, tc = 0, m = 0, sid = 0, bar = 0, total = 0;
};

// The largest ring that fits: 3 stages and 2 tc buffers, else 1 tc buffer
// (reloaded between i-chunks), else 2 stages.
Layout layout(int k, int c) {
  const int spt = BM / c, rows = spt * c;
  const int shapes[3][2] = {{3, 2}, {3, 1}, {2, 1}};
  for (const auto& sh : shapes) {
    Layout l;
    l.ns = sh[0];
    l.tb = sh[1];
    l.h_bytes = static_cast<int>(up16(static_cast<size_t>(spt) * k * FC * 2));
    l.tc_bytes = static_cast<int>(up16(static_cast<size_t>(rows) * k * IC * 2));
    l.h = static_cast<size_t>(l.ns) * W_BYTES;
    l.tc = l.h + static_cast<size_t>(l.ns) * l.h_bytes;
    l.m = l.tc + static_cast<size_t>(l.tb) * l.tc_bytes;
    l.sid = l.m + 2 * M_BYTES;
    l.total = l.sid + up16(BM * sizeof(int));
    if (l.total <= MAX_SMEM) return l;
  }
  return Layout{};
}

struct Args {
  const bf16* h;
  const bf16* tc;
  const bf16* w;
  const int* ids;
  const int* count;
  bf16* out;
  Dims d;
  Layout lay;
  bool vw, vh, vt, vh16;  // 16-byte copies of W and tc rows, 8-byte ones of h (16 f: 16-byte)
};

// W stage: (fl, o) rows of 32 bytes (16 i), the two halves swapped at o & 4.
__device__ __forceinline__ int w_off(int fl, int o, int seg) {
  return (((fl * BN + o) << 1) + (seg ^ ((o >> 2) & 1))) << 4;
}

// Copies of chunk q's W stage and h stage (slot q % ns), by producer p.
__device__ void copy_wh(const Args& a, unsigned char* smem, const int* sid, int q, int nf, int o0,
                        int p) {
  const Dims& d = a.d;
  const int spt = BM / d.c;
  const int i0 = (q / nf) * IC, f0 = (q % nf) * FC;
  unsigned char* ws = smem + (q % a.lay.ns) * W_BYTES;
  for (int e = p; e < FC * BN * 2; e += PRODUCERS) {
    const int seg = e & 1, fo = e >> 1, fl = fo / BN, o = fo % BN;
    const int f = f0 + fl, oo = o0 + o, i = i0 + seg * 8;
    const bool ok = f < d.f && oo < d.o;
    stage8(ws + w_off(fl, o, seg),
           ok ? a.w + (static_cast<int64_t>(f) * d.o + oo) * d.i + i : a.w, ok ? d.i - i : 0,
           a.vw);
  }
  unsigned char* hs = smem + a.lay.h + (q % a.lay.ns) * a.lay.h_bytes;
  for (int e = p; e < d.k * spt; e += PRODUCERS) {  // [K, sites, 4 f]
    const int k = e / spt, site = sid[e % spt];
    stage4(hs + e * 8, site >= 0 ? a.h + (static_cast<int64_t>(site) * d.k + k) * d.f + f0 : a.h,
           site >= 0 ? d.f - f0 : 0, a.vh);
  }
}

// Copies of i-chunk n's tc [K, rows, 16 i] (a tile of spt sites) into
// buffer n % tb, by producer p of np.
__device__ void copy_tc(const Args& a, unsigned char* smem, const int* sid, int n, int spt, int p,
                        int np = PRODUCERS) {
  const Dims& d = a.d;
  const int rows = spt * d.c, i0 = n * IC;
  const int64_t ci = static_cast<int64_t>(d.c) * d.i;
  unsigned char* ts = smem + a.lay.tc + (n % a.lay.tb) * a.lay.tc_bytes;
  for (int e = p; e < d.k * rows * 2; e += np) {
    const int seg = e & 1, kr = e >> 1, k = kr / rows, r = kr % rows;
    const int site = sid[r / d.c], i = i0 + seg * 8;
    stage8(ts + e * 16,
           site >= 0 ? a.tc + (static_cast<int64_t>(site) * d.k + k) * ci + (r % d.c) * d.i + i
                     : a.tc,
           site >= 0 ? d.i - i : 0, a.vt);
  }
}

// Producer p builds row p / 2, i-half p % 2 of chunk q's M tile (a tile of
// spt sites; rows past them 0), all 4 f, from h at hs (the spt sites' f
// rows, the next k hstep further) and the i-chunk's tc.
__device__ void build(const Args& a, unsigned char* smem, const int* sid, int slot, const bf16* hs,
                      int hstep, const bf16* ts, int spt, int p) {
  const Dims& d = a.d;
  const int rows = spt * d.c;
  const int r = p >> 1, ih = p & 1;
  const bool on = r < rows && sid[r / d.c] >= 0;
  uint4 m[4];
  build_m(hs + (r / d.c) * (hstep / spt), hstep, ts + r * IC + ih * 8, rows * IC,
          on ? d.k : 0, m);
  unsigned char* ms = smem + a.lay.m + slot * M_BYTES;
#pragma unroll
  for (int fl = 0; fl < FC; ++fl)
    *reinterpret_cast<uint4*>(ms + swz(r, 128, fl * 2 + ih)) = m[fl];
}

// part += chunk q's M tile (slot `slot`) · its W stage: consumer warp (wm,
// wn) owns rows wm·32 … +31 and columns wn·64 … +63; each A fragment is
// loaded once a k16 step. Columns past O are skipped.
__device__ __forceinline__ void products(const Args& a, const unsigned char* smem, int q, int slot,
                                         int o0, float (&part)[2][8][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wm = warp >> 2, wn = warp & 3;
  const unsigned char* ms = smem + a.lay.m + slot * M_BYTES;
  const unsigned char* ws = smem + (q % a.lay.ns) * W_BYTES;
  const int ob = wn * 64;
  if (o0 + ob >= a.d.o) return;
#pragma unroll
  for (int fl = 0; fl < FC; ++fl) {
    uint32_t af[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      ldsm4(af[mt], ms + swz(wm * 32 + mt * 16 + (lane & 15), 128, fl * 2 + (lane >> 4)));
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm4(b, ws + w_off(fl, ob + np * 16 + ((lane >> 4) << 3) + (lane & 7), (lane >> 3) & 1));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma(part[mt][np * 2], af[mt], b[0], b[1]);
        mma(part[mt][np * 2 + 1], af[mt], b[2], b[3]);
      }
    }
  }
}

// acc += part, part = 0: a chunk's sums, from 0 in the tensor cores, added
// to the running sums on the CUDA cores.
__device__ __forceinline__ void flush(float (&acc)[2][8][4], float (&part)[2][8][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[mt][nt][e] += part[mt][nt][e];
        part[mt][nt][e] = 0.f;
      }
}

// out at the tile's live rows from the consumers' sums, rounded once.
__device__ __forceinline__ void store_out(const Args& a, const int* sid, int o0,
                                          const float (&acc)[2][8][4]) {
  const Dims& d = a.d;
  const int rows = (BM / d.c) * d.c, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm * 32 + mt * 16 + (lane >> 2) + half * 8;
      if (r >= rows) continue;
      const int site = sid[r / d.c];
      if (site < 0) continue;
      bf16* dst = a.out + (static_cast<int64_t>(site) * d.c + r % d.c) * d.o;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int o = o0 + wn * 64 + nt * 8 + (lane & 3) * 2;
        const float x = acc[mt][nt][half * 2], y = acc[mt][nt][half * 2 + 1];
        if (o + 1 < d.o && d.o % 2 == 0) {
          *reinterpret_cast<__nv_bfloat162*>(dst + o) = __floats2bfloat162_rn(x, y);
        } else {
          if (o < d.o) dst[o] = __float2bfloat16_rn(x);
          if (o + 1 < d.o) dst[o + 1] = __float2bfloat16_rn(y);
        }
      }
    }
}

// J's general path (cp.async W and h, 4 producer and 8 mma.sync consumer
// warps). Chunk q: producers wait for its copies, wait until the consumers
// are done with chunk q − (ns − 1) (its W slot and the M slot q & 1 are then
// free), start the copies of chunk q + 1, build M(q) and signal it full;
// consumers wait for M(q), multiply and signal its slots empty.
__global__ void __launch_bounds__(THREADS, 1) fwd_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Dims& d = a.d;
  int* sid = reinterpret_cast<int*>(smem + a.lay.sid);
  const int spt = BM / d.c, rows = spt * d.c;
  const int live = a.count ? min(*a.count, d.s) : d.s;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * spt;
  if (p0 >= live) return;  // every site of the tile is dead: out stays 0
  const int o0 = blockIdx.y * BN, tid = threadIdx.x;
  if (tid < spt) {
    const int64_t p = p0 + tid;
    sid[tid] = p < live ? (a.ids ? a.ids[p] : static_cast<int>(p)) : -1;
  }
  __syncthreads();
  const int nf = (d.f + FC - 1) / FC, nq = ((d.i + IC - 1) / IC) * nf;
  const int lag = a.lay.ns - 1;
  auto empty_id = [&](int q) { return BAR_EMPTY + (lag == 2 ? (q & 1) : 0); };

  if (tid >= CONSUMERS) {  // producers
    const int p = tid - CONSUMERS;
    copy_wh(a, smem, sid, 0, nf, o0, p);
    copy_tc(a, smem, sid, 0, spt, p);
    cp_commit();
    for (int q = 0; q < nq; ++q) {
      if (a.lay.tb == 1 && q > 0 && q % nf == 0) {  // one tc buffer: reload it now
        bar_sync(BAR_PROD, PRODUCERS);  // every producer is done with the last i-chunk
        copy_tc(a, smem, sid, q / nf, spt, p);
        cp_commit();
      }
      cp_wait(0);
      bar_sync(BAR_PROD, PRODUCERS);  // chunk q's copies, every producer's
      if (q >= lag) bar_sync(empty_id(q - lag), THREADS);
      if (q + 1 < nq) {
        copy_wh(a, smem, sid, q + 1, nf, o0, p);
        if (a.lay.tb == 2 && (q + 1) % nf == 0) copy_tc(a, smem, sid, (q + 1) / nf, spt, p);
        cp_commit();
      }
      build(a, smem, sid, q & 1,
            reinterpret_cast<const bf16*>(smem + a.lay.h + (q % a.lay.ns) * a.lay.h_bytes),
            spt * FC,
            reinterpret_cast<const bf16*>(smem + a.lay.tc + ((q / nf) % a.lay.tb) * a.lay.tc_bytes),
            spt, p);
      bar_arrive(BAR_FULL + (q & 1), THREADS);
    }
    return;
  }

  float acc[2][8][4], part[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = part[mt][nt][e] = 0.f;
  for (int q = 0; q < nq; ++q) {
    bar_sync(BAR_FULL + (q & 1), THREADS);
    products(a, smem, q, q & 1, o0, part);
    if (q + lag < nq) bar_arrive(empty_id(q), THREADS);
    flush(acc, part);
  }

  store_out(a, sid, o0, acc);
}

// ------------------------------------------------ J with W by the TMA

constexpr int HF = 16;     // f of an h stage: four chunks, 32-byte rows
constexpr int NS_T = 2;    // W stages in the ring
constexpr int MS_T = 4;    // M tiles in flight between producers and consumers
constexpr int PART_CHUNKS = 4;  // chunks summed in the tensor cores before a flush
constexpr int PRODUCER_WGS = 3;  // warpgroups of copies and M builds: chunk n is n % 3's
constexpr int PRODUCERS_T = 128 * PRODUCER_WGS;
// setmaxnreg moves registers between the warpgroups of a block, which start
// with 65,536 / threads each (rounded down to 8): 96 at 640 threads, 128 at
// 512. What the producers give up must cover what the consumers take:
// 384 × (96 − 64) = 256 × (144 − 96), 256 × (128 − 80) = 256 × (176 − 128).
constexpr int THREADS_T = CONSUMERS + PRODUCERS_T;
constexpr int BAR_FULL_T = 1, BAR_EMPTY_T = 5, BAR_PROD_T = 9, BAR_CONS_T = 10;

// Shared memory of the TMA path: the W ring, 2 h stages [K, sites, 16 f],
// 2 tc buffers (one an i-chunk), the M tiles, the site ids and the ring's
// full barriers; ns = 0: it does not fit.
Layout tma_layout(int k, int c) {
  const int spt = BM / c, rows = spt * c;
  Layout l;
  l.ns = NS_T;
  l.tb = 2;
  l.h_bytes = static_cast<int>(up16(static_cast<size_t>(spt) * k * HF * 2));
  l.tc_bytes = static_cast<int>(up16(static_cast<size_t>(rows) * k * IC * 2));
  l.h = static_cast<size_t>(NS_T) * W_BYTES;
  l.tc = l.h + 2 * static_cast<size_t>(l.h_bytes);
  l.m = (l.tc + 2 * static_cast<size_t>(l.tc_bytes) + 1023) / 1024 * 1024;  // wgmma: 1,024-aligned
  l.sid = l.m + MS_T * M_BYTES;
  l.bar = l.sid + up16(BM * sizeof(int));
  l.total = l.bar + NS_T * sizeof(uint64_t);
  if (l.total > MAX_SMEM) l.ns = 0;
  return l;
}

struct TmaArgs {
  CUtensorMap w_map;  // W [F, O, I] as (I, O, F); box (16 i, 256 o, 4 f), 32-byte swizzle
  Args a;
};

// Copies of h [K, sites, 16 f] from f0 into h stage b (a tile of spt
// sites), by producer p.
__device__ void copy_h16(const Args& a, unsigned char* smem, const int* sid, int f0, int b,
                         int spt, int p) {
  const Dims& d = a.d;
  unsigned char* hs = smem + a.lay.h + b * a.lay.h_bytes;
  for (int e = p; e < d.k * spt * 2; e += PRODUCERS_T) {
    const int seg = e & 1, ks = e >> 1, k = ks / spt, site = sid[ks % spt], f = f0 + seg * 8;
    stage8(hs + e * 16, site >= 0 ? a.h + (static_cast<int64_t>(site) * d.k + k) * d.f + f : a.h,
           site >= 0 ? d.f - f : 0, a.vh16);
  }
}

// part (+)= the M tile [64 rows, 64 columns] · the W stage's columns cg·128
// … +127 for warpgroup cg: four wgmma m64n128k16, one a k16 step (f), both
// operands read by the tensor cores from shared memory (M in 128-byte
// swizzled rows, W's 32-byte rows as the TMA swizzled them); `first`: part
// starts from 0. Waits for its products before it returns.
__device__ __forceinline__ void wg_products(const unsigned char* ms, const unsigned char* ws, int cg,
                                            bool on, bool first, float (&part)[64]) {
  if (!on) return;  // columns past O
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < FC; ++kk)
    wgmma_m64n128(part, wg_desc(ms + kk * 32, 1024, 1),
                  wg_desc(ws + kk * (BN * 32) + cg * (128 * 32), 256, 3), first && kk == 0 ? 0 : 1);
  wg_commit();
  wg_wait();
}

// out at the rows of the tile of spt live sites from list position p0,
// from warpgroup cg's sums (wgmma's layout: warp w of the warpgroup holds
// rows 16w + lane / 4 (+ 8), columns 8j + 2·(lane % 4) (+ 1) in acc[4j …]).
// The sites are read from the list here: the producers may be rewriting the
// shared copy for the block's next tile.
__device__ __forceinline__ void store_out_wg(const Args& a, int64_t p0, int spt, int o0,
                                             const float (&acc)[64]) {
  const Dims& d = a.d;
  const int rows = spt * d.c, tid = threadIdx.x;
  const int cg = tid >> 7, wq = (tid >> 5) & 3, lane = tid & 31;
#pragma unroll
  for (int hv = 0; hv < 2; ++hv) {
    const int r = wq * 16 + (lane >> 2) + hv * 8;
    if (r >= rows) continue;
    const int64_t p = p0 + r / d.c;
    const int site = a.ids ? a.ids[p] : static_cast<int>(p);
    bf16* dst = a.out + (static_cast<int64_t>(site) * d.c + r % d.c) * d.o;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int o = o0 + cg * 128 + j * 8 + (lane & 3) * 2;
      const float x = acc[4 * j + 2 * hv], y = acc[4 * j + 2 * hv + 1];
      if (o + 1 < d.o && d.o % 2 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(dst + o) = __floats2bfloat162_rn(x, y);
      } else {
        if (o < d.o) dst[o] = __float2bfloat16_rn(x);
        if (o + 1 < d.o) dst[o + 1] = __float2bfloat16_rn(y);
      }
    }
  }
}

// J's fast path (the source's note), on a persistent grid: block b takes
// its share of the live list, positions [lo, lo + share), in `mine` tiles of
// near-equal size, at most 64 rows each (tile j: `bounds`). Its chunks are
// counted on (n) across its tiles, so the W ring (the same stages for every
// tile), the M slots and their barriers run on from one tile to the next. W
// comes by TMA into a ring of NS_T stages whose full barriers count a
// stage's bytes, refilled by a consumer once both consumer warpgroups are
// past a stage.
__global__ void __launch_bounds__(THREADS_T, 1)
fwd_tma_kernel(const __grid_constant__ TmaArgs t) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const Args& a = t.a;
  const Dims& d = a.d;
  int* sid = reinterpret_cast<int*>(smem + a.lay.sid);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + a.lay.bar);
  const int live = a.count ? min(*a.count, d.s) : d.s;
  const int per = gridDim.x;
  const int64_t lo = static_cast<int64_t>(live) * blockIdx.x / per;
  const int share = static_cast<int>(static_cast<int64_t>(live) * (blockIdx.x + 1) / per - lo);
  if (share == 0) return;  // no live site for this block
  const int mine = (share + BM / d.c - 1) / (BM / d.c);  // its tiles
  auto bounds = [&](int j, int64_t& p0) {  // tile j's first position; its sites
    p0 = lo + static_cast<int64_t>(share) * j / mine;
    return static_cast<int>(lo + static_cast<int64_t>(share) * (j + 1) / mine - p0);
  };
  const int o0 = blockIdx.y * BN, tid = threadIdx.x;
  const int nf = (d.f + FC - 1) / FC, nq = ((d.i + IC - 1) / IC) * nf, total = mine * nq;
  auto issue_w = [&](int n) {  // chunk n's W stage: chunk n % nq of a tile
    const int s = n % NS_T, q = n % nq;
    mbar_expect_tx(full + s, W_BYTES);
    tma_3d(smem + s * W_BYTES, &t.w_map, full + s, (q / nf) * IC, o0, (q % nf) * FC);
  };
  if (tid == 0) {
    for (int s = 0; s < NS_T; ++s) mbar_init(full + s, 1);
    mbar_fence_init();
    for (int n = 0; n < NS_T && n < total; ++n) issue_w(n);
  }
  __syncthreads();
  const int per_h = HF / FC, ngf = (nf + per_h - 1) / per_h;  // chunks an h stage, stages an i-chunk

  if (tid >= CONSUMERS) {  // producers
    regs_down<PRODUCER_WGS == 3 ? 64 : 80>();
    const int p = tid - CONSUMERS, wg = p >> 7;
    auto h_slot = [&](int q) { return ((q / nf) * ngf + (q % nf) / per_h) & 1; };
    for (int j = 0, n = 0; j < mine; ++j) {
      // the tile's sites: the last tile's builds, which read them and the h
      // and tc buffers, are every producer's done (and its copies waited for)
      if (j > 0) bar_sync(BAR_PROD_T, PRODUCERS_T);
      int64_t p0;
      const int spt = bounds(j, p0);
      if (p < spt) sid[p] = a.ids ? a.ids[p0 + p] : static_cast<int>(p0 + p);
      bar_sync(BAR_PROD_T, PRODUCERS_T);
      copy_h16(a, smem, sid, 0, 0, spt, p);
      copy_tc(a, smem, sid, 0, spt, p, PRODUCERS_T);
      cp_commit();
      for (int q = 0; q < nq; ++q, ++n) {
        if (q % nf % per_h == 0) {  // a new h stage (and perhaps i-chunk) starts
          cp_wait(0);
          bar_sync(BAR_PROD_T, PRODUCERS_T);  // the stage's h and tc, every producer's
          // the next i-chunk's tc, an i-chunk ahead: its buffer's last reader was
          // the i-chunk before, which every warpgroup is done with
          if (q % nf == 0 && (q / nf + 1) * nf < nq)
            copy_tc(a, smem, sid, q / nf + 1, spt, p, PRODUCERS_T);
          // the next h stage, a stage ahead: its slot's last reader was the stage before
          const int qn = q % nf + per_h < nf ? q + per_h : (q / nf + 1) * nf;
          if (qn < nq) copy_h16(a, smem, sid, qn % nf * FC, h_slot(qn), spt, p);
          cp_commit();
        }
        if (n % PRODUCER_WGS != wg) continue;  // another warpgroup's chunk
        if (n >= MS_T) bar_sync(BAR_EMPTY_T + (n % MS_T), CONSUMERS + 128);  // its M slot is free
        build(a, smem, sid, n % MS_T,
              reinterpret_cast<const bf16*>(smem + a.lay.h + h_slot(q) * a.lay.h_bytes) +
                  (q % nf % per_h) * FC,
              spt * HF,
              reinterpret_cast<const bf16*>(smem + a.lay.tc + ((q / nf) & 1) * a.lay.tc_bytes),
              spt, p & 127);
        fence_async_smem();  // the M tile, seen by the consumers' tensor-core reads
        bar_arrive(BAR_FULL_T + (n % MS_T), CONSUMERS + 128);
      }
    }
    return;
  }

  // consumers: warpgroup cg, all 64 rows × columns cg·128 … +127
  regs_up<PRODUCER_WGS == 3 ? 144 : 176>();
  const int cg = tid >> 7;
  const bool on = o0 + cg * 128 < d.o;
  for (int j = 0, n = 0; j < mine; ++j) {
    float acc[64], part[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = part[e] = 0.f;
    for (int q = 0; q < nq; ++q, ++n) {
      bar_sync(BAR_FULL_T + (n % MS_T), CONSUMERS + 128);
      mbar_wait(full + n % NS_T, (n / NS_T) & 1);
      wg_products(smem + a.lay.m + (n % MS_T) * M_BYTES, smem + (n % NS_T) * W_BYTES, cg, on,
                  q % PART_CHUNKS == 0, part);
      if (n + MS_T < total) bar_arrive(BAR_EMPTY_T + (n % MS_T), CONSUMERS + 128);
      if (n + NS_T < total) {  // W slot n % NS_T is read by both warpgroups: refill it
        bar_sync(BAR_CONS_T, CONSUMERS);
        if (tid == 0) issue_w(n + NS_T);
      }
      if ((q + 1) % PART_CHUNKS == 0 || q + 1 == nq)
#pragma unroll
        for (int e = 0; e < 64; ++e) acc[e] += part[e];
    }
    int64_t p0;
    const int spt = bounds(j, p0);
    store_out_wg(a, p0, spt, o0, acc);
  }
}

}  // namespace j

// --------------------------------------------------- kernel K: dM, dh, dtc

namespace kd {

constexpr int BM = 64;        // rows of a tile
constexpr int OC = 64;        // o of a W stage: four k16 steps
constexpr int THREADS = 256;  // 8 warps: 2 (rows) × 4 (columns) of a dM chunk
constexpr int NB = 128;       // columns of a dM chunk: 16 n8 tiles
constexpr int W_BYTES = NB * OC * 2;  // a W stage: 16 KB
constexpr int DMS_ROW = 8 * 48;       // a row of the dM tile: 8 × 16 bf16, rows of 48 bytes

struct Layout {  // byte offsets; nsw = 0: none fits
  int nsw = 0, ob = 0;  // W stages in the ring, operand (h or tc) buffers
  int kp = 0, no = 0, op_bytes = 0, dout_row = 0;
  size_t w = 0, dms = 0, op = 0, sid = 0, total = 0;
};

// The deepest ring that fits, with two operand buffers (loaded with a
// chunk's last W stage: needs 2·no ≥ nsw) or one (loaded with its first:
// needs no ≥ nsw).
Layout layout(bool dh, int k, int c, int o) {
  const int spt = BM / c, rows = spt * c;
  Layout l;
  l.kp = k > 16 ? 32 : 16;
  l.no = (o + OC - 1) / OC;
  l.dout_row = l.no * OC * 2;
  l.op_bytes = (dh ? rows : spt) * l.kp * 32;
  for (int ob = 2; ob >= 1; --ob)
    for (int nsw = 4; nsw >= 2; --nsw) {
      if (ob == 2 ? 2 * l.no < nsw : l.no < nsw) continue;
      l.nsw = nsw;
      l.ob = ob;
      l.w = static_cast<size_t>(BM) * l.dout_row;
      l.dms = l.w + static_cast<size_t>(nsw) * W_BYTES;
      l.op = l.dms + static_cast<size_t>(BM) * DMS_ROW;
      l.sid = l.op + static_cast<size_t>(ob) * l.op_bytes;
      l.total = l.sid + up16(2 * BM * sizeof(int));
      if (l.total <= MAX_SMEM) return l;
    }
  return Layout{};
}

struct Args {
  const bf16* h;
  const bf16* tc;
  const bf16* w;
  const bf16* dout;
  const int* ids;
  const int* count;
  bf16* dh;
  bf16* dtc;
  Dims d;
  Layout lay;
  bool vw, vd, vh, vt;  // 16-byte copies of W, dout, h and tc rows
};

// The chunks: dtc (DH false) walks i-chunks of 8 (outer) and f-chunks of 16
// (inner), dh walks f-chunks of 8 (outer) and i-chunks of 16 (inner). A dM
// chunk's n8 tile nt is (f f0 + nt, i i0 … +7), or (f f0 + nt / 2, i i0 +
// 8·(nt & 1) … +7).
template <bool DH>
struct Geo {
  static constexpr int FCK = DH ? 8 : 16, ICK = DH ? 16 : 8;
  int nf, ni, nq;
  __device__ Geo(const Dims& d)
      : nf((d.f + FCK - 1) / FCK), ni((d.i + ICK - 1) / ICK), nq(nf * ni) {}
  __device__ int i0(int q) const { return (DH ? q % ni : q / nf) * ICK; }
  __device__ int f0(int q) const { return (DH ? q / ni : q % nf) * FCK; }
  __device__ bool last(int q) const { return DH ? q % ni == ni - 1 : q % nf == nf - 1; }
};

// A W stage [FCK f, 64 o, ICK i]: (f, o) rows of 16 (dtc) or 32 bytes (dh,
// the halves swapped at o & 4); the n8 tile nt's 8 i at o.
template <bool DH>
__device__ __forceinline__ int w_off(int nt, int o) {
  return DH ? ((((nt >> 1) * OC + o) << 1) + ((nt & 1) ^ ((o >> 2) & 1))) << 4
            : (nt * OC + o) << 4;
}

// An operand row (site or row, k) of 16 f or 16 i: 32 bytes, the halves
// swapped at k & 4.
__device__ __forceinline__ int op_off(int sk, int k, int seg) {
  return ((sk << 1) + (seg ^ ((k >> 2) & 1))) << 4;
}

// Copies of W stage u (chunk u / no, o-stage u % no) into slot u % nsw.
template <bool DH>
__device__ void copy_w(const Args& a, unsigned char* smem, const Geo<DH>& g, int u) {
  const Dims& d = a.d;
  const int q = u / a.lay.no, o1 = (u % a.lay.no) * OC, i0 = g.i0(q), f0 = g.f0(q);
  unsigned char* ws = smem + a.lay.w + (u % a.lay.nsw) * W_BYTES;
  for (int e = threadIdx.x; e < NB * OC / 8; e += THREADS) {
    const int nt = DH ? ((e >> 7) << 1) + (e & 1) : e >> 6;  // dh: (f, o, half)
    const int o = DH ? (e >> 1) & 63 : e & 63;
    const int f = f0 + (DH ? nt >> 1 : nt), i = i0 + (DH ? (nt & 1) * 8 : 0), oo = o1 + o;
    const bool ok = f < d.f && oo < d.o;
    stage8(ws + w_off<DH>(nt, o),
           ok ? a.w + (static_cast<int64_t>(f) * d.o + oo) * d.i + i : a.w, ok ? d.i - i : 0,
           a.vw);
  }
}

// Copies of chunk q's operand into buffer b: h [sites, kp, 16 f] (dtc) or
// tc [rows, kp, 16 i] (dh), 0 past K and at dead sites.
template <bool DH>
__device__ void copy_op(const Args& a, unsigned char* smem, const Geo<DH>& g, const int* sid,
                        const int* alive, int q, int b) {
  const Dims& d = a.d;
  const int kp = a.lay.kp, n = (DH ? (BM / d.c) * d.c : BM / d.c) * kp * 2;
  const int i0 = g.i0(q), f0 = g.f0(q);
  const int64_t ci = static_cast<int64_t>(d.c) * d.i;
  unsigned char* os = smem + a.lay.op + b * a.lay.op_bytes;
  for (int e = threadIdx.x; e < n; e += THREADS) {
    const int seg = e & 1, sk = e >> 1, x = sk / kp, k = sk % kp;
    const int sl = DH ? x / d.c : x, site = sid[sl];
    const bool ok = site >= 0 && alive[sl] && k < d.k;
    const bf16* src = DH ? a.tc + (static_cast<int64_t>(site) * d.k + k) * ci + (x % d.c) * d.i +
                               i0 + seg * 8
                         : a.h + (static_cast<int64_t>(site) * d.k + k) * d.f + f0 + seg * 8;
    const int left = DH ? d.i - i0 - seg * 8 : d.f - f0 - seg * 8;
    stage8(os + op_off(sk, k, seg), ok ? src : a.h, ok ? left : 0, DH ? a.vt : a.vh);
  }
}

// acc += the tile's dout rows [64, o-stage] · W stage u: warp (wm, wn) owns
// rows wm·32 … +31 and n8 tiles wn·4 … +3.
template <bool DH>
__device__ __forceinline__ void dm_products(const Args& a, const unsigned char* smem, int u,
                                            float (&acc)[2][4][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wm = warp >> 2, wn = warp & 3;
  const unsigned char* ds = smem;
  const unsigned char* ws = smem + a.lay.w + (u % a.lay.nsw) * W_BYTES;
  const int o1 = (u % a.lay.no) * OC, mi = lane >> 3;
#pragma unroll
  for (int ks = 0; ks < OC / 16; ++ks) {
    uint32_t af[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      ldsm4(af[mt], ds + swz(wm * 32 + mt * 16 + (lane & 15), a.lay.dout_row,
                             ((o1 + ks * 16) >> 3) + (lane >> 4)));
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
      uint32_t b[4];
      ldsm4t(b, ws + w_off<DH>(wn * 4 + jp * 2 + (mi >> 1), ks * 16 + (lane & 7) + ((mi & 1) << 3)));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma(acc[mt][jp * 2], af[mt], b[0], b[1]);
        mma(acc[mt][jp * 2 + 1], af[mt], b[2], b[3]);
      }
    }
  }
}

// K's general dM kernels (cp.async W, 128-column chunks): one block a tile
// of 64 / C sites: the tile's dout rows once, then the W stages of every
// chunk through the ring; at a chunk's last stage dM is rounded into shared
// memory and reduced into dtc (DH false: a warp's rows w, w + 8, …) or dh
// (DH true: its sites w, w + 8, …), written once whole.
template <bool DH>
__global__ void __launch_bounds__(THREADS, 1) dm_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Dims& d = a.d;
  const Layout& L = a.lay;
  int* sid = reinterpret_cast<int*>(smem + L.sid);  // the tile's site ids (-1: none)
  int* alive = sid + BM;                            // 1 where the site is live
  const int spt = BM / d.c, rows = spt * d.c, tid = threadIdx.x;
  const int live = a.count ? min(*a.count, d.s) : d.s;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * spt;
  const int64_t ci = static_cast<int64_t>(d.c) * d.i;
  const bf16 zero = __float2bfloat16_rn(0.f);
  const int64_t per_site = DH ? static_cast<int64_t>(d.k) * d.f : d.k * ci;
  bf16* outp = DH ? a.dh : a.dtc;

  if (p0 >= live) {  // dead sites only: +0
    for (int sl = 0; sl < spt; ++sl) {
      const int64_t p = p0 + sl;
      if (p >= d.s) break;
      const int64_t site = a.ids ? a.ids[p] : p;
      for (int64_t e = tid; e < per_site; e += THREADS) outp[site * per_site + e] = zero;
    }
    return;
  }
  if (tid < spt) {
    const int64_t p = p0 + tid;
    sid[tid] = p < d.s ? (a.ids ? a.ids[p] : static_cast<int>(p)) : -1;
    alive[tid] = p < live;
  }
  __syncthreads();
  const Geo<DH> g(d);
  const int no = L.no, nu = g.nq * no;
  // the tile's dout rows [64, no·64] (0 past its live rows and past O)
  for (int e = tid; e < BM * no * 8; e += THREADS) {
    const int r = e / (no * 8), seg = e % (no * 8), sl = r / d.c;
    const bool ok = r < rows && sid[sl] >= 0 && alive[sl];
    stage8(smem + swz(r, L.dout_row, seg),
           ok ? a.dout + (static_cast<int64_t>(sid[sl]) * d.c + r % d.c) * d.o + seg * 8 : a.dout,
           ok ? d.o - seg * 8 : 0, a.vd);
  }
  auto stage = [&](int u) {
    copy_w<DH>(a, smem, g, u);
    if (L.ob == 2 && u % no == no - 1) copy_op<DH>(a, smem, g, sid, alive, u / no, (u / no) & 1);
  };
  for (int u = 0; u < L.nsw - 1; ++u) {
    if (u < nu) stage(u);
    cp_commit();
  }

  const int warp = tid >> 5, lane = tid & 31, wm = warp >> 2, wn = warp & 3;
  const int gq = lane >> 2, tq = lane & 3;
  float acc[2][4][4], sums[8][2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
#pragma unroll
  for (int x = 0; x < 8; ++x)
#pragma unroll
    for (int kt = 0; kt < 2; ++kt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sums[x][kt][e] = 0.f;

  unsigned char* dms = smem + L.dms;
  for (int u = 0; u < nu; ++u) {
    cp_wait(L.nsw - 2);
    __syncthreads();  // stage u landed; slot (u − 1) % nsw is read
    if (L.ob == 1 && u % no == 0) copy_op<DH>(a, smem, g, sid, alive, u / no, 0);
    if (u + L.nsw - 1 < nu) stage(u + L.nsw - 1);
    cp_commit();
    dm_products<DH>(a, smem, u, acc);
    if (u % no != no - 1) continue;

    // the chunk's dM, rounded to bf16: [row][8 (i or f)][16 (f or i)]
    const int q = u / no;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hv = 0; hv < 2; ++hv) {
          const int r = wm * 32 + mt * 16 + gq + hv * 8, nt = wn * 4 + j;
          const float x = acc[mt][j][hv * 2], y = acc[mt][j][hv * 2 + 1];
          if (DH) {  // f nt / 2, i 8·(nt & 1) + 2t, +1
            *reinterpret_cast<uint32_t*>(dms + r * DMS_ROW + (nt >> 1) * 48 +
                                         ((nt & 1) * 8 + 2 * tq) * 2) = pack(x, y);
          } else {  // f nt, i 2t, 2t + 1
            bf16* p = reinterpret_cast<bf16*>(dms + r * DMS_ROW + 2 * tq * 48 + nt * 2);
            p[0] = __float2bfloat16_rn(x);
            p[24] = __float2bfloat16_rn(y);
          }
          acc[mt][j][hv * 2] = acc[mt][j][hv * 2 + 1] = 0.f;
        }
    __syncthreads();  // dM whole (and the operand, landed at this stage's wait)

    const unsigned char* os = smem + L.op + (L.ob == 2 ? (q & 1) : 0) * L.op_bytes;
    const int kp = L.kp;
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      if (DH) {  // site w + 8x: dh [16 k × 8 f] += Σ_c tc_(s,c) [16 k × 16 i] · dM_(s,c)
        const int sl = warp + 8 * x;
        if (sl >= spt || sid[sl] < 0 || !alive[sl]) continue;
        float part[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        for (int c = 0; c < d.c; ++c) {
          const int r = sl * d.c + c;
          uint32_t b[2];
          ldsm2(b, dms + r * DMS_ROW + (lane & 7) * 48 + ((lane >> 3) & 1) * 16);
#pragma unroll
          for (int kt = 0; kt < 2; ++kt) {
            if (kt * 16 >= d.k) break;
            const int k = kt * 16 + (lane & 15);
            uint32_t af[4];
            ldsm4(af, os + op_off(r * kp + k, k, lane >> 4));
            mma(part[kt], af, b[0], b[1]);
          }
        }
#pragma unroll
        for (int kt = 0; kt < 2; ++kt)
#pragma unroll
          for (int e = 0; e < 4; ++e) sums[x][kt][e] += part[kt][e];
      } else {  // row w + 8x: dtc [16 k × 8 i] += h_s [16 k × 16 f] · dM_r
        const int r = warp + 8 * x;
        if (r >= rows || sid[r / d.c] < 0 || !alive[r / d.c]) continue;
        uint32_t b[2];
        ldsm2(b, dms + r * DMS_ROW + (lane & 7) * 48 + ((lane >> 3) & 1) * 16);
#pragma unroll
        for (int kt = 0; kt < 2; ++kt) {
          if (kt * 16 >= d.k) break;
          const int k = kt * 16 + (lane & 15);
          uint32_t af[4];
          ldsm4(af, os + op_off((r / d.c) * kp + k, k, lane >> 4));
          float part[4] = {0.f, 0.f, 0.f, 0.f};
          mma(part, af, b[0], b[1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) sums[x][kt][e] += part[e];
        }
      }
    }
    if (!g.last(q)) continue;

    // the sums are whole: dtc[s, k, c, i0 + 2t …] or dh[s, k, f0 + 2t …]
    const int i0 = g.i0(q), f0 = g.f0(q);
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      const int y = warp + 8 * x;  // a row (dtc) or a site (dh)
      const int sl = DH ? y : y / d.c;
      if ((DH ? y >= spt : y >= rows) || sid[sl] < 0) continue;
      const int64_t site = sid[sl];
      const bool on = alive[sl];
#pragma unroll
      for (int kt = 0; kt < 2; ++kt)
#pragma unroll
        for (int hv = 0; hv < 2; ++hv) {
          const int k = kt * 16 + gq + hv * 8, n = 2 * tq;
          if (k < d.k) {
            const float v0 = on ? sums[x][kt][hv * 2] : 0.f;
            const float v1 = on ? sums[x][kt][hv * 2 + 1] : 0.f;
            const int lim = DH ? d.f - f0 : d.i - i0;
            bf16* dst = DH ? a.dh + (site * d.k + k) * d.f + f0 + n
                           : a.dtc + (site * d.k + k) * ci + (y % d.c) * d.i + i0 + n;
            if (n + 1 < lim && (DH ? d.f : d.i) % 2 == 0) {
              *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
            } else {
              if (n < lim) dst[0] = __float2bfloat16_rn(v0);
              if (n + 1 < lim) dst[1] = __float2bfloat16_rn(v1);
            }
          }
          sums[x][kt][hv * 2] = sums[x][kt][hv * 2 + 1] = 0.f;
        }
    }
  }
}

// ----------------------------------------- dM kernels with W by the TMA

constexpr int CT = 16;                       // f and i of a chunk: 256 columns, 32 n8 tiles
constexpr int WT_BYTES = CT * OC * CT * 2;   // a W stage [16 f, 64 o, 16 i]: 32 KB
constexpr int DMT_ROW = CT * 32;             // a row of the dM tile: 16 × 16 bf16

// Byte offset of element n of line x (16 bf16, two 16-byte halves swapped at
// x & 4) of dM row r.
__device__ __forceinline__ int dmt_off(int r, int x, int n) {
  return r * DMT_ROW + x * 32 + ((((n >> 3) ^ (x >> 2)) & 1) << 4) + (n & 7) * 2;
}

struct TLayout {  // byte offsets; nsw = 0: none fits
  int nsw = 0, kp = 0, no = 0, op_bytes = 0, dout_row = 0;
  size_t w = 0, dms = 0, op = 0, sid = 0, bar = 0, total = 0;
};

// The tile's dout rows, a ring of 4 (3, 2) W stages, the dM tile, one
// operand buffer (h [sites, kp, 16 f] for dtc, tc [rows, kp, 16 i] for dh),
// the site ids and the ring's full barriers.
TLayout tma_layout(bool dh, int k, int c, int o) {
  const int spt = BM / c, rows = spt * c;
  TLayout l;
  l.kp = k > 16 ? 32 : 16;
  l.no = (o + OC - 1) / OC;
  l.dout_row = l.no * OC * 2;
  l.op_bytes = (dh ? rows : spt) * l.kp * 32;
  for (int nsw = 4; nsw >= 2; --nsw) {
    l.nsw = nsw;
    l.w = static_cast<size_t>(BM) * l.dout_row;  // a multiple of 1,024
    l.dms = l.w + static_cast<size_t>(nsw) * WT_BYTES;
    l.op = l.dms + static_cast<size_t>(BM) * DMT_ROW;
    l.sid = l.op + l.op_bytes;
    l.bar = l.sid + up16(2 * BM * sizeof(int));
    l.total = l.bar + nsw * sizeof(uint64_t);
    if (l.total <= MAX_SMEM) return l;
  }
  return TLayout{};
}

struct TmaArgs {
  CUtensorMap w_map;  // W [F, O, I] as (I, O, F); box (16 i, 64 o, 16 f), 32-byte swizzle
  Args a;
  TLayout lay;
};

// A W stage [16 f, 64 o, 16 i]: (f, o) rows of 32 bytes, the halves swapped
// at o & 4 (the TMA's 32-byte swizzle); n8 tile nt is f nt / 2, i half nt & 1.
__device__ __forceinline__ int wt_off(int nt, int o) {
  return ((((nt >> 1) * OC + o) << 1) + ((nt & 1) ^ ((o >> 2) & 1))) << 4;
}

// Copies of chunk (i0, f0)'s operand into the buffer: h [sites, kp, 16 f]
// (dtc) or tc [rows, kp, 16 i] (dh), 0 past K and at dead sites.
template <bool DH>
__device__ void copy_op_t(const Args& a, const TLayout& L, unsigned char* smem, const int* sid,
                          const int* alive, int i0, int f0) {
  const Dims& d = a.d;
  const int kp = L.kp, n = (DH ? (BM / d.c) * d.c : BM / d.c) * kp * 2;
  const int64_t ci = static_cast<int64_t>(d.c) * d.i;
  unsigned char* os = smem + L.op;
  for (int e = threadIdx.x; e < n; e += THREADS) {
    const int seg = e & 1, sk = e >> 1, x = sk / kp, k = sk % kp;
    const int sl = DH ? x / d.c : x, site = sid[sl];
    const bool ok = site >= 0 && alive[sl] && k < d.k;
    const bf16* src = DH ? a.tc + (static_cast<int64_t>(site) * d.k + k) * ci + (x % d.c) * d.i +
                               i0 + seg * 8
                         : a.h + (static_cast<int64_t>(site) * d.k + k) * d.f + f0 + seg * 8;
    const int left = DH ? d.i - i0 - seg * 8 : d.f - f0 - seg * 8;
    stage8(os + op_off(sk, k, seg), ok ? src : a.h, ok ? left : 0, DH ? a.vt : a.vh);
  }
}

// acc += the tile's dout rows [64, o-stage u % no] · W stage u: warp (wm,
// wn) owns rows wm·32 … +31 and n8 tiles wn·8 … +7 (f wn·4 … +3).
__device__ __forceinline__ void dm_products_t(const TLayout& L, const unsigned char* smem, int u,
                                              float (&acc)[2][8][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wm = warp >> 2, wn = warp & 3;
  const unsigned char* ws = smem + L.w + (u % L.nsw) * WT_BYTES;
  const int o1 = (u % L.no) * OC, mi = lane >> 3;
#pragma unroll
  for (int ks = 0; ks < OC / 16; ++ks) {
    uint32_t af[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      ldsm4(af[mt], smem + swz(wm * 32 + mt * 16 + (lane & 15), L.dout_row,
                               ((o1 + ks * 16) >> 3) + (lane >> 4)));
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      uint32_t b[4];
      ldsm4t(b, ws + wt_off(wn * 8 + jp * 2 + (mi >> 1), ks * 16 + (lane & 7) + ((mi & 1) << 3)));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma(acc[mt][jp * 2], af[mt], b[0], b[1]);
        mma(acc[mt][jp * 2 + 1], af[mt], b[2], b[3]);
      }
    }
  }
}

// As `dm_kernel`, with chunks of 16 f × 16 i (dtc: i-chunks outer; dh:
// f-chunks outer) whose W stages come by TMA into a ring of full barriers
// (a stage's slot is free again once every warp passed the barrier after
// its products); the operand of the next chunk is copied while this one's
// products run. KT: the k16 tiles of K (1: K ≤ 16, 2: K ≤ 32).
template <bool DH, int KT>
__global__ void __launch_bounds__(THREADS, 1) dm_tma_kernel(const __grid_constant__ TmaArgs t) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const Args& a = t.a;
  const TLayout& L = t.lay;
  const Dims& d = a.d;
  int* sid = reinterpret_cast<int*>(smem + L.sid);
  int* alive = sid + BM;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar);
  const int spt = BM / d.c, rows = spt * d.c, tid = threadIdx.x;
  const int live = a.count ? min(*a.count, d.s) : d.s;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * spt;
  const int64_t ci = static_cast<int64_t>(d.c) * d.i;

  if (p0 >= live) {  // dead sites only: +0
    const bf16 zero = __float2bfloat16_rn(0.f);
    const int64_t per_site = DH ? static_cast<int64_t>(d.k) * d.f : d.k * ci;
    bf16* outp = DH ? a.dh : a.dtc;
    for (int sl = 0; sl < spt; ++sl) {
      const int64_t p = p0 + sl;
      if (p >= d.s) break;
      const int64_t site = a.ids ? a.ids[p] : p;
      for (int64_t e = tid; e < per_site; e += THREADS) outp[site * per_site + e] = zero;
    }
    return;
  }
  if (tid < spt) {
    const int64_t p = p0 + tid;
    sid[tid] = p < d.s ? (a.ids ? a.ids[p] : static_cast<int>(p)) : -1;
    alive[tid] = p < live;
  }
  if (tid == 0) {
    for (int s = 0; s < L.nsw; ++s) mbar_init(full + s, 1);
    mbar_fence_init();
  }
  __syncthreads();
  const int nf = (d.f + CT - 1) / CT, ni = (d.i + CT - 1) / CT, nq = nf * ni;
  auto i0_of = [&](int q) { return (DH ? q % ni : q / nf) * CT; };
  auto f0_of = [&](int q) { return (DH ? q / ni : q % nf) * CT; };
  auto last = [&](int q) { return DH ? q % ni == ni - 1 : q % nf == nf - 1; };
  const int no = L.no, nu = nq * no;
  auto issue = [&](int u) {  // W stage u: chunk u / no, o-stage u % no
    const int s = u % L.nsw, q = u / no;
    mbar_expect_tx(full + s, WT_BYTES);
    tma_3d(smem + L.w + s * WT_BYTES, &t.w_map, full + s, i0_of(q), (u % no) * OC, f0_of(q));
  };
  if (tid == 0)
    for (int u = 0; u < L.nsw && u < nu; ++u) issue(u);
  // the tile's dout rows [64, no·64] (0 past its live rows and past O)
  for (int e = tid; e < BM * no * 8; e += THREADS) {
    const int r = e / (no * 8), seg = e % (no * 8), sl = r / d.c;
    const bool ok = r < rows && sid[sl] >= 0 && alive[sl];
    stage8(smem + swz(r, L.dout_row, seg),
           ok ? a.dout + (static_cast<int64_t>(sid[sl]) * d.c + r % d.c) * d.o + seg * 8 : a.dout,
           ok ? d.o - seg * 8 : 0, a.vd);
  }
  copy_op_t<DH>(a, L, smem, sid, alive, i0_of(0), f0_of(0));
  cp_commit();

  const int warp = tid >> 5, lane = tid & 31, wm = warp >> 2, wn = warp & 3;
  const int gq = lane >> 2, tq = lane & 3, mi = lane >> 3;
  float acc[2][8][4], sums[8][KT][2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
#pragma unroll
  for (int x = 0; x < 8; ++x)
#pragma unroll
    for (int kt = 0; kt < KT; ++kt)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int e = 0; e < 4; ++e) sums[x][kt][h2][e] = 0.f;

  unsigned char* dms = smem + L.dms;
  const unsigned char* os = smem + L.op;
  const int kp = L.kp;
  for (int u = 0; u < nu; ++u) {
    if (u == 0) {
      cp_wait(0);
      __syncthreads();  // the dout rows and the first operand landed
    }
    mbar_wait(full + u % L.nsw, (u / L.nsw) & 1);
    dm_products_t(L, smem, u, acc);
    __syncthreads();  // every warp is done with W slot u % nsw
    if (tid == 0 && u + L.nsw < nu) issue(u + L.nsw);
    if (u % no != no - 1) continue;

    // the chunk's dM, rounded to bf16: [row][16 (i or f)][16 (f or i)]
    const int q = u / no;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hv = 0; hv < 2; ++hv) {
          const int r = wm * 32 + mt * 16 + gq + hv * 8, nt = wn * 8 + j;
          const int fl = nt >> 1, il = (nt & 1) * 8 + 2 * tq;
          const float x = acc[mt][j][hv * 2], y = acc[mt][j][hv * 2 + 1];
          if (DH) {  // [f][i]
            *reinterpret_cast<uint32_t*>(dms + dmt_off(r, fl, il)) = pack(x, y);
          } else {  // [i][f]
            *reinterpret_cast<bf16*>(dms + dmt_off(r, il, fl)) = __float2bfloat16_rn(x);
            *reinterpret_cast<bf16*>(dms + dmt_off(r, il + 1, fl)) = __float2bfloat16_rn(y);
          }
          acc[mt][j][hv * 2] = acc[mt][j][hv * 2 + 1] = 0.f;
        }
    cp_wait(0);
    __syncthreads();  // dM whole, the chunk's operand landed

#pragma unroll
    for (int x = 0; x < 8; ++x) {
      if (DH) {  // site w + 8x: dh [16 k × 16 f] += Σ_c tc_(s,c) [16 k × 16 i] · dM_(s,c)
        const int sl = warp + 8 * x;
        if (sl >= spt || sid[sl] < 0 || !alive[sl]) continue;
        float part[KT][2][4];
#pragma unroll
        for (int kt = 0; kt < KT; ++kt)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[kt][h2][e] = 0.f;
        for (int c = 0; c < d.c; ++c) {
          const int r = sl * d.c + c;
          uint32_t b[4];  // f 0-7 (i 0-7, 8-15), f 8-15 (i 0-7, 8-15)
          ldsm4(b, dms + dmt_off(r, (mi >> 1) * 8 + (lane & 7), (mi & 1) * 8));
#pragma unroll
          for (int kt = 0; kt < KT; ++kt) {
            const int k = kt * 16 + (lane & 15);
            uint32_t af[4];
            ldsm4(af, os + op_off(r * kp + k, k, lane >> 4));
            mma(part[kt][0], af, b[0], b[1]);
            mma(part[kt][1], af, b[2], b[3]);
          }
        }
#pragma unroll
        for (int kt = 0; kt < KT; ++kt)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
            for (int e = 0; e < 4; ++e) sums[x][kt][h2][e] += part[kt][h2][e];
      } else {  // row w + 8x: dtc [16 k × 16 i] += h_s [16 k × 16 f] · dM_r
        const int r = warp + 8 * x;
        if (r >= rows || sid[r / d.c] < 0 || !alive[r / d.c]) continue;
        uint32_t b[4];  // i 0-7 (f 0-7, 8-15), i 8-15 (f 0-7, 8-15)
        ldsm4(b, dms + dmt_off(r, (mi >> 1) * 8 + (lane & 7), (mi & 1) * 8));
#pragma unroll
        for (int kt = 0; kt < KT; ++kt) {
          const int k = kt * 16 + (lane & 15);
          uint32_t af[4];
          ldsm4(af, os + op_off((r / d.c) * kp + k, k, lane >> 4));
          float part[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
          mma(part[0], af, b[0], b[1]);
          mma(part[1], af, b[2], b[3]);
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
            for (int e = 0; e < 4; ++e) sums[x][kt][h2][e] += part[h2][e];
        }
      }
    }
    if (q + 1 < nq) {  // the next chunk's operand, while its products run
      __syncthreads();  // every warp is done with this one's
      copy_op_t<DH>(a, L, smem, sid, alive, i0_of(q + 1), f0_of(q + 1));
      cp_commit();
    }
    if (!last(q)) continue;

    // the sums are whole: dtc[s, k, c, i0 + 8h + 2t …] or dh[s, k, f0 + 8h + 2t …]
    const int i0 = i0_of(q), f0 = f0_of(q);
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      const int y = warp + 8 * x;  // a row (dtc) or a site (dh)
      const int sl = DH ? y : y / d.c;
      if ((DH ? y >= spt : y >= rows) || sid[sl] < 0) continue;
      const int64_t site = sid[sl];
      const bool on = alive[sl];
#pragma unroll
      for (int kt = 0; kt < KT; ++kt)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
          for (int hv = 0; hv < 2; ++hv) {
            const int k = kt * 16 + gq + hv * 8, n = h2 * 8 + 2 * tq;
            if (k < d.k) {
              const float v0 = on ? sums[x][kt][h2][hv * 2] : 0.f;
              const float v1 = on ? sums[x][kt][h2][hv * 2 + 1] : 0.f;
              const int lim = DH ? d.f - f0 : d.i - i0;
              bf16* dst = DH ? a.dh + (site * d.k + k) * d.f + f0 + n
                             : a.dtc + (site * d.k + k) * ci + (y % d.c) * d.i + i0 + n;
              if (n + 1 < lim && (DH ? d.f : d.i) % 2 == 0) {
                *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
              } else {
                if (n < lim) dst[0] = __float2bfloat16_rn(v0);
                if (n + 1 < lim) dst[1] = __float2bfloat16_rn(v1);
              }
            }
            sums[x][kt][h2][hv * 2] = sums[x][kt][h2][hv * 2 + 1] = 0.f;
          }
    }
  }
}

}  // namespace kd

// ------------------------------------------------------------ kernel K: dW

namespace kw {

constexpr int PB = 64;          // (i, f) pairs of a block: 8 f × 8 i, pair = fl·8 + il
constexpr int BN = 256;         // columns of O of a block
constexpr int RC = 64;          // rows of a chunk: four k16 steps
constexpr int CONSUMERS = 256;  // 8 warps of products: 2 (pairs) × 4 (columns)
constexpr int PRODUCERS = 128;  // 4 warps of copies and M builds
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr int D_BYTES = RC * BN * 2;  // a dout stage [64 rows, 256 o]: 32 KB
constexpr int M_BYTES = RC * PB * 2;  // an M tile [64 rows, 64 pairs]: 8 KB
constexpr int BAR_FULL = 1, BAR_EMPTY = 3, BAR_PROD = 5;

struct Layout {  // a stage: dout, then h [K, 64 rows, 8 f], tc [K, 64 rows, 8 i]
  int ns = 0, ht_bytes = 0;
  size_t stage = 0, m = 0, total = 0;
};

Layout layout(int k) {
  for (int ns = 3; ns >= 2; --ns) {
    Layout l;
    l.ns = ns;
    l.ht_bytes = RC * k * 16;
    l.stage = D_BYTES + 2 * static_cast<size_t>(l.ht_bytes);
    l.m = ns * l.stage;
    l.total = l.m + 2 * M_BYTES;
    if (l.total <= MAX_SMEM) return l;
  }
  return Layout{};
}

struct Args {
  const bf16* h;
  const bf16* tc;
  const bf16* dout;
  const int* ids;
  const int* count;
  bf16* dw;
  Dims d;
  Layout lay;
  bool vd, vh, vt;
};

// Copies of chunk n (rows 64n …) into stage n % ns, by producer p.
__device__ void copies(const Args& a, unsigned char* smem, int64_t nrows, int n, int i0, int f0,
                       int o0, int p) {
  const Dims& d = a.d;
  unsigned char* st = smem + (n % a.lay.ns) * a.lay.stage;
  const int64_t ci = static_cast<int64_t>(d.c) * d.i;
  for (int e = p; e < RC * (BN / 8); e += PRODUCERS) {  // dout [64 rows, 256 o]
    const int row = e >> 5, seg = e & 31;
    const int64_t r = static_cast<int64_t>(n) * RC + row;
    const int left = d.o - o0 - seg * 8;
    const bool ok = r < nrows && left > 0;
    const int64_t site = ok ? (a.ids ? a.ids[r / d.c] : r / d.c) : 0;
    stage8(st + swz(row, BN * 2, seg), ok ? a.dout + (site * d.c + r % d.c) * d.o + o0 + seg * 8 : a.dout,
           ok ? left : 0, a.vd);
  }
  for (int e = p; e < d.k * RC; e += PRODUCERS) {  // h and tc [K, 64 rows, 8]
    const int k = e / RC, row = e % RC;
    const int64_t r = static_cast<int64_t>(n) * RC + row;
    const bool ok = r < nrows;
    const int64_t site = ok ? (a.ids ? a.ids[r / d.c] : r / d.c) : 0;
    stage8(st + D_BYTES + e * 16, ok ? a.h + (site * d.k + k) * d.f + f0 : a.h, ok ? d.f - f0 : 0,
           a.vh);
    stage8(st + D_BYTES + a.lay.ht_bytes + e * 16,
           ok ? a.tc + (site * d.k + k) * ci + (r % d.c) * d.i + i0 : a.tc, ok ? d.i - i0 : 0,
           a.vt);
  }
}

// Producer p builds row p / 2, f-half p % 2 (4 f × 8 i) of chunk n's M tile.
__device__ void build(const Args& a, unsigned char* smem, int n, int p) {
  const int row = p >> 1, fh = p & 1;
  const unsigned char* st = smem + (n % a.lay.ns) * a.lay.stage;
  const bf16* hs = reinterpret_cast<const bf16*>(st + D_BYTES);
  const bf16* ts = reinterpret_cast<const bf16*>(st + D_BYTES + a.lay.ht_bytes);
  uint4 m[4];
  build_m(hs + row * 8 + fh * 4, RC * 8, ts + row * 8, RC * 8, a.d.k, m);
  unsigned char* ms = smem + a.lay.m + (n & 1) * M_BYTES;
#pragma unroll
  for (int fl = 0; fl < 4; ++fl) *reinterpret_cast<uint4*>(ms + swz(row, 128, fh * 4 + fl)) = m[fl];
}

// acc += Mᵀ [64 pairs, 64 rows] · dout [64 rows, 256 o] of chunk n, summed
// from 0 over the chunk: warp (wm, wn) owns pairs wm·32 … +31, columns
// wn·64 … +63 in two halves.
__device__ __forceinline__ void mma_chunk(const Args& a, const unsigned char* smem, int n, int o0,
                                          float (&acc)[2][8][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wm = warp >> 2, wn = warp & 3;
  const unsigned char* ds = smem + (n % a.lay.ns) * a.lay.stage;
  const unsigned char* ms = smem + a.lay.m + (n & 1) * M_BYTES;
  const int mi = lane >> 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int ob = wn * 64 + hf * 32;
    if (o0 + ob >= a.d.o) continue;
    float part[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < RC / 16; ++ks) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldsm4t(af[mt], ms + swz(ks * 16 + (lane & 7) + ((mi >> 1) << 3), 128,
                                wm * 4 + mt * 2 + (mi & 1)));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4];
        ldsm4t(b, ds + swz(ks * 16 + (lane & 7) + ((mi & 1) << 3), BN * 2,
                           ((ob + np * 16) >> 3) + (mi >> 1)));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma(part[mt][np * 2], af[mt], b[0], b[1]);
          mma(part[mt][np * 2 + 1], af[mt], b[2], b[3]);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][hf * 4 + nt][e] += part[mt][nt][e];
  }
}

// K's general dW kernel (K > 16): one block per (64 pairs, 256 columns of
// O), over the live rows (site ids[r / C], c = r % C, r < count·C) in chunks
// of 64, as J walks its chunks.
__global__ void __launch_bounds__(THREADS, 1) dw_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Dims& d = a.d;
  const int nfp = (d.f + 7) / 8;
  const int i0 = (blockIdx.x / nfp) * 8, f0 = (blockIdx.x % nfp) * 8, o0 = blockIdx.y * BN;
  const int live = a.count ? min(*a.count, d.s) : d.s;
  const int64_t nrows = static_cast<int64_t>(live) * d.c;
  const int nq = static_cast<int>((nrows + RC - 1) / RC);
  const int lag = a.lay.ns - 1, tid = threadIdx.x;
  auto empty_id = [&](int q) { return BAR_EMPTY + (lag == 2 ? (q & 1) : 0); };

  if (tid >= CONSUMERS) {  // producers
    const int p = tid - CONSUMERS;
    if (nq > 0) copies(a, smem, nrows, 0, i0, f0, o0, p);
    cp_commit();
    for (int q = 0; q < nq; ++q) {
      cp_wait(0);
      bar_sync(BAR_PROD, PRODUCERS);  // chunk q's copies, every producer's
      if (q >= lag) bar_sync(empty_id(q - lag), THREADS);
      if (q + 1 < nq) copies(a, smem, nrows, q + 1, i0, f0, o0, p);
      cp_commit();
      build(a, smem, q, p);
      bar_arrive(BAR_FULL + (q & 1), THREADS);
    }
    return;
  }

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  for (int q = 0; q < nq; ++q) {
    bar_sync(BAR_FULL + (q & 1), THREADS);
    mma_chunk(a, smem, q, o0, acc);
    if (q + lag < nq) bar_arrive(empty_id(q), THREADS);
  }
  // dW[f, o, i]: lane (g, t) holds pairs g, g + 8 and columns 2t, 2t + 1
  const int warp = tid >> 5, lane = tid & 31, wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int pair = wm * 32 + mt * 16 + (lane >> 2) + half * 8;
      const int f = f0 + pair / 8, i = i0 + pair % 8;
      if (f >= d.f || i >= d.i) continue;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = o0 + wn * 64 + nt * 8 + (lane & 3) * 2 + e;
          if (o < d.o)
            a.dw[(static_cast<int64_t>(f) * d.o + o) * d.i + i] =
                __float2bfloat16_rn(acc[mt][nt][half * 2 + e]);
        }
    }
}

}  // namespace kw

// ------------------------------------------- kernel K: dW, 128 pairs a block

namespace kv {

constexpr int PF = 16, PI = 8;  // f and i of a block's pairs: pair = fl·8 + il
constexpr int PB = PF * PI;     // 128 pairs
constexpr int BN = 256;         // columns of O of a block
constexpr int RC = 32;          // rows of a chunk: two k16 steps
constexpr int NS = 4;           // chunks in flight: copy stages and M tiles
constexpr int CONSUMERS = 256;  // 8 warps of products: 2 (64 pairs) × 4 (64 columns)
constexpr int PRODUCERS = 128;  // 4 warps of copies and M builds
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr int D_BYTES = RC * BN * 2;  // dout [32 rows, 256 o]: 16 KB
constexpr int M_BYTES = RC * PB * 2;  // an M tile [32 rows, 128 pairs]: 8 KB
constexpr int BAR_FULL = 1, BAR_EMPTY = 5, BAR_PROD = 9;

struct Layout {  // a stage: dout, h [K, 32 rows, 16 f], tc [K, 32 rows, 8 i]; ns = 0: no fit
  int ns = 0, h_bytes = 0, t_bytes = 0;
  size_t stage = 0, m = 0, total = 0;
};

Layout layout(int k) {
  Layout l;
  l.ns = NS;
  l.h_bytes = RC * k * PF * 2;
  l.t_bytes = RC * k * PI * 2;
  l.stage = D_BYTES + static_cast<size_t>(l.h_bytes) + l.t_bytes;
  l.m = NS * l.stage;
  l.total = l.m + NS * M_BYTES;
  if (l.total > MAX_SMEM) l.ns = 0;
  return l;
}

struct Args {
  const bf16* h;
  const bf16* tc;
  const bf16* dout;
  const int* ids;
  const int* count;
  bf16* dw;
  Dims d;
  Layout lay;
  bool vd, vh, vt;
};

// Copies of chunk n (rows 32n …) into stage n % NS: producer p copies row
// p / 4's pieces p % 4, p % 4 + 4, …, its site looked up once.
__device__ void copies(const Args& a, unsigned char* smem, int64_t nrows, int n, int i0, int f0,
                       int o0, int p) {
  const Dims& d = a.d;
  unsigned char* st = smem + (n % NS) * a.lay.stage;
  unsigned char* hs = st + D_BYTES;
  unsigned char* ts = hs + a.lay.h_bytes;
  const int row = p >> 2, sub = p & 3;
  const int64_t r = static_cast<int64_t>(n) * RC + row;
  const bool ok = r < nrows;
  const int64_t site = ok ? (a.ids ? a.ids[r / d.c] : r / d.c) : 0;
  const int c = static_cast<int>(r % d.c);
  const bf16* dr = a.dout + (site * d.c + c) * d.o + o0;
  const bf16* hr = a.h + site * d.k * d.f + f0;
  const bf16* tr = a.tc + (site * d.k * d.c + c) * d.i + i0;
  const int64_t tstep = static_cast<int64_t>(d.c) * d.i;
  for (int seg = sub; seg < BN / 8; seg += 4) {  // dout [32 rows, 256 o]
    const int left = d.o - o0 - seg * 8;
    stage8(st + swz(row, BN * 2, seg), ok && left > 0 ? dr + seg * 8 : a.dout,
           ok && left > 0 ? left : 0, a.vd);
  }
  for (int e = sub; e < d.k * 3; e += 4) {  // h [K, 32, 16 f] (2 pieces), tc [K, 32, 8 i]
    const int k = e / 3, piece = e % 3;
    if (piece < 2)
      stage8(hs + ((k * RC + row) * 2 + piece) * 16, ok ? hr + k * d.f + piece * 8 : a.h,
             ok ? d.f - f0 - piece * 8 : 0, a.vh);
    else
      stage8(ts + (k * RC + row) * 16, ok ? tr + k * tstep : a.tc, ok ? d.i - i0 : 0, a.vt);
  }
}

// Producer p builds row p / 4, f 4·(p % 4) … +3 (8 i) of chunk n's M tile.
__device__ void build(const Args& a, unsigned char* smem, int n, int p) {
  const int row = p >> 2, fq = p & 3;
  const unsigned char* st = smem + (n % NS) * a.lay.stage;
  const bf16* hs = reinterpret_cast<const bf16*>(st + D_BYTES);
  const bf16* ts = reinterpret_cast<const bf16*>(st + D_BYTES + a.lay.h_bytes);
  uint4 m[4];
  build_m(hs + row * PF + fq * 4, RC * PF, ts + row * PI, RC * PI, a.d.k, m);
  unsigned char* ms = smem + a.lay.m + (n % NS) * M_BYTES;
#pragma unroll
  for (int fl = 0; fl < 4; ++fl)
    *reinterpret_cast<uint4*>(ms + swz(row, PB * 2, fq * 4 + fl)) = m[fl];
}

// acc += Mᵀ [128 pairs, 32 rows] · dout [32 rows, 256 o] of chunk n, summed
// from 0 over the chunk a 32 × 32 patch at a time: warp (wm, wn) owns pairs
// wm·64 … +63 and columns wn·64 … +63.
__device__ __forceinline__ void mma_chunk(const Args& a, const unsigned char* smem, int n, int o0,
                                          float (&acc)[4][8][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wm = warp >> 2, wn = warp & 3;
  const unsigned char* ds = smem + (n % NS) * a.lay.stage;
  const unsigned char* ms = smem + a.lay.m + (n % NS) * M_BYTES;
  const int mi = lane >> 3;
#pragma unroll
  for (int mp = 0; mp < 2; ++mp)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int ob = wn * 64 + hf * 32;
      if (o0 + ob >= a.d.o) continue;
      float part[2][4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < RC / 16; ++ks) {
        uint32_t af[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldsm4t(af[mt], ms + swz(ks * 16 + (lane & 7) + ((mi >> 1) << 3), PB * 2,
                                  wm * 8 + mp * 4 + mt * 2 + (mi & 1)));
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t b[4];
          ldsm4t(b, ds + swz(ks * 16 + (lane & 7) + ((mi & 1) << 3), BN * 2,
                             ((ob + np * 16) >> 3) + (mi >> 1)));
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma(part[mt][np * 2], af[mt], b[0], b[1]);
            mma(part[mt][np * 2 + 1], af[mt], b[2], b[3]);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mp * 2 + mt][hf * 4 + nt][e] += part[mt][nt][e];
    }
}

// One block per (128 pairs, 256 columns of O), over the live rows in chunks
// of 32, two chunks' copies in flight and four M tiles. The consumers hold
// 128 sums a thread: the producers give registers up (setmaxnreg) for them.
//  producers, chunk n: wait for its copies; wait until the consumers are
//    done with chunk n − 2 (its stage and M tile serve chunk n + 2); start
//    chunk n + 2's copies; build M(n); signal it full.
//  consumers, chunk n: wait for M(n); multiply; signal its slot empty.
__global__ void __launch_bounds__(THREADS, 1) dw_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Dims& d = a.d;
  const int nfp = (d.f + PF - 1) / PF;
  const int i0 = (blockIdx.x / nfp) * PI, f0 = (blockIdx.x % nfp) * PF, o0 = blockIdx.y * BN;
  const int live = a.count ? min(*a.count, d.s) : d.s;
  const int64_t nrows = static_cast<int64_t>(live) * d.c;
  const int nq = static_cast<int>((nrows + RC - 1) / RC);
  const int tid = threadIdx.x;

  if (tid >= CONSUMERS) {  // producers
    regs_down<72>();
    const int p = tid - CONSUMERS;
    for (int n = 0; n < 2; ++n) {
      if (n < nq) copies(a, smem, nrows, n, i0, f0, o0, p);
      cp_commit();
    }
    for (int q = 0; q < nq; ++q) {
      cp_wait(1);
      bar_sync(BAR_PROD, PRODUCERS);  // chunk q's copies, every producer's
      if (q >= 2) bar_sync(BAR_EMPTY + (q - 2) % NS, THREADS);
      if (q + 2 < nq) copies(a, smem, nrows, q + 2, i0, f0, o0, p);
      cp_commit();
      build(a, smem, q, p);
      bar_arrive(BAR_FULL + q % NS, THREADS);
    }
    return;
  }

  regs_up<216>();
  float acc[4][8][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  for (int q = 0; q < nq; ++q) {
    bar_sync(BAR_FULL + q % NS, THREADS);
    mma_chunk(a, smem, q, o0, acc);
    if (q + 2 < nq) bar_arrive(BAR_EMPTY + q % NS, THREADS);
  }
  // dW[f, o, i]: lane (g, t) holds pairs g, g + 8 and columns 2t, 2t + 1
  const int warp = tid >> 5, lane = tid & 31, wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int pair = wm * 64 + mt * 16 + (lane >> 2) + half * 8;
      const int f = f0 + pair / PI, i = i0 + pair % PI;
      if (f >= d.f || i >= d.i) continue;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = o0 + wn * 64 + nt * 8 + (lane & 3) * 2 + e;
          if (o < d.o)
            a.dw[(static_cast<int64_t>(f) * d.o + o) * d.i + i] =
                __float2bfloat16_rn(acc[mt][nt][half * 2 + e]);
        }
    }
}

}  // namespace kv


// cuTensorMapEncodeTiled, from the driver at run time (null if it has none).
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      cudaGetLastError();
      f = nullptr;
    }
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(f);
  }();
  return fn;
}

// J through the TMA path, if the shape takes it (K ≤ 16, W rows 16-byte
// aligned, its shared memory fits, the driver encodes the map): 1 on a
// launch (err holds its result), 0 if the general path must run. The grid
// is persistent: a row of at most one block an SM (the kernel spreads the
// live sites over it), a row for each 256 columns of O.
int launch_fwd_tma(const j::Args& a, cudaStream_t stream, cudaError_t& err) {
  const Dims& d = a.d;
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (d.k > 16 || d.i % 8 || !aligned(a.w, 16) || !encode) return 0;
  const j::Layout lay = j::tma_layout(d.k, d.c);
  if (lay.ns == 0) return 0;
  j::TmaArgs t;
  t.a = a;
  t.a.lay = lay;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d.i), static_cast<cuuint64_t>(d.o),
                              static_cast<cuuint64_t>(d.f)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d.i) * 2,
                                 static_cast<cuuint64_t>(d.o) * d.i * 2};
  const cuuint32_t box[3] = {j::IC, j::BN, j::FC}, one[3] = {1, 1, 1};
  if (encode(&t.w_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<bf16*>(a.w), dims, strides,
             box, one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return 0;
  if ((err = set_smem(reinterpret_cast<const void*>(j::fwd_tma_kernel), lay.total)) !=
      cudaSuccess)
    return 1;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return 1;
  const int spt = j::BM / d.c, tiles = (d.s + spt - 1) / spt, gy = (d.o + j::BN - 1) / j::BN;
  const int row = sms / gy > 1 ? sms / gy : 1;
  j::fwd_tma_kernel<<<dim3(tiles < row ? tiles : row, gy), j::THREADS_T, lay.total, stream>>>(t);
  err = cudaGetLastError();
  return 1;
}

bool bad_dims(int s, int k, int c, int i, int f, int o) {
  return s < 0 || k < 0 || k > MAX_K || c < 1 || c > MAX_C || i < 1 || f < 1 || o < 1;
}

}  // namespace

// Writes out [S, C, O] at the live sites (all, without ids); the caller
// zeroes the others' rows.
extern "C" int pooled_conv_fwd_bf16(const bf16* h, const bf16* tc, const bf16* w, const int* ids,
                                    const int* count, bf16* out, int s, int k, int c, int i,
                                    int f, int o, cudaStream_t stream) {
  if (bad_dims(s, k, c, i, f, o)) return cudaErrorInvalidValue;
  if (s == 0) return cudaSuccess;
  const j::Layout lay = j::layout(k, c);
  if (lay.ns == 0) return cudaErrorInvalidValue;
  const j::Args a{h, tc, w, ids, count, out, {s, k, c, i, f, o}, lay,
                  i % 8 == 0 && aligned(w, 16), f % 4 == 0 && aligned(h, 8),
                  i % 8 == 0 && aligned(tc, 16), f % 8 == 0 && aligned(h, 16)};
  cudaError_t err = cudaSuccess;
  if (launch_fwd_tma(a, stream, err)) return err;
  if ((err = set_smem(reinterpret_cast<const void*>(j::fwd_kernel), lay.total)) != cudaSuccess)
    return err;
  const int spt = j::BM / c;
  const dim3 grid((s + spt - 1) / spt, (o + j::BN - 1) / j::BN);
  j::fwd_kernel<<<grid, j::THREADS, lay.total, stream>>>(a);
  return cudaGetLastError();
}

// K's dM kernels through the TMA path, if the shape takes it (W rows
// 16-byte aligned, both kernels' shared memory fits, the driver encodes the
// map): 1 on a launch (err holds its result), 0 if the general path must run.
template <int KT>
int launch_dm_tma(const kd::Args& a, cudaStream_t stream, cudaError_t& err) {
  const Dims& d = a.d;
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (d.i % 8 || !aligned(a.w, 16) || !encode) return 0;
  const kd::TLayout lt = kd::tma_layout(false, d.k, d.c, d.o);
  const kd::TLayout lh = kd::tma_layout(true, d.k, d.c, d.o);
  if (lt.nsw == 0 || lh.nsw == 0) return 0;
  kd::TmaArgs t;
  t.a = a;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d.i), static_cast<cuuint64_t>(d.o),
                              static_cast<cuuint64_t>(d.f)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d.i) * 2,
                                 static_cast<cuuint64_t>(d.o) * d.i * 2};
  const cuuint32_t box[3] = {kd::CT, kd::OC, kd::CT}, one[3] = {1, 1, 1};
  if (encode(&t.w_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<bf16*>(a.w), dims, strides,
             box, one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return 0;
  const dim3 grid((d.s + kd::BM / d.c - 1) / (kd::BM / d.c));
  t.lay = lt;
  if ((err = set_smem(reinterpret_cast<const void*>(kd::dm_tma_kernel<false, KT>), lt.total)) !=
      cudaSuccess)
    return 1;
  kd::dm_tma_kernel<false, KT><<<grid, kd::THREADS, lt.total, stream>>>(t);
  if ((err = cudaGetLastError()) != cudaSuccess) return 1;
  t.lay = lh;
  if ((err = set_smem(reinterpret_cast<const void*>(kd::dm_tma_kernel<true, KT>), lh.total)) !=
      cudaSuccess)
    return 1;
  kd::dm_tma_kernel<true, KT><<<grid, kd::THREADS, lh.total, stream>>>(t);
  err = cudaGetLastError();
  return 1;
}

// Writes dh [S, K, F], dtc [S, K, C·I] (+0 at the dead sites) and dW
// [F, O, I] for the gradient dout [S, C, O] of J's output.
extern "C" int pooled_conv_bwd_bf16(const bf16* h, const bf16* tc, const bf16* w,
                                    const bf16* dout, const int* ids, const int* count, bf16* dh,
                                    bf16* dtc, bf16* dw, int s, int k, int c, int i, int f, int o,
                                    cudaStream_t stream) {
  if (bad_dims(s, k, c, i, f, o)) return cudaErrorInvalidValue;
  const bool vh = f % 8 == 0 && aligned(h, 16), vt = i % 8 == 0 && aligned(tc, 16);
  const bool vd = o % 8 == 0 && aligned(dout, 16);
  cudaError_t err = cudaSuccess;
  if (s > 0 && k > 0) {
    kd::Args a{h, tc, w, dout, ids, count, dh, dtc, {s, k, c, i, f, o}, kd::Layout{},
               i % 8 == 0 && aligned(w, 16), vd, vh, vt};
    if (k > 16 ? launch_dm_tma<2>(a, stream, err) : launch_dm_tma<1>(a, stream, err)) {
      if (err != cudaSuccess) return err;
    } else {  // the general path: W stages by cp.async
      const kd::Layout lt = kd::layout(false, k, c, o), lh = kd::layout(true, k, c, o);
      if (lt.nsw == 0 || lh.nsw == 0) return cudaErrorInvalidValue;
      const dim3 grid((s + kd::BM / c - 1) / (kd::BM / c));
      a.lay = lt;
      if ((err = set_smem(reinterpret_cast<const void*>(kd::dm_kernel<false>), lt.total)) !=
          cudaSuccess)
        return err;
      kd::dm_kernel<false><<<grid, kd::THREADS, lt.total, stream>>>(a);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      a.lay = lh;
      if ((err = set_smem(reinterpret_cast<const void*>(kd::dm_kernel<true>), lh.total)) !=
          cudaSuccess)
        return err;
      kd::dm_kernel<true><<<grid, kd::THREADS, lh.total, stream>>>(a);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
  }
  const kv::Layout lv = kv::layout(k);
  if (lv.ns) {  // dW, 128 pairs a block
    if ((err = set_smem(reinterpret_cast<const void*>(kv::dw_kernel), lv.total)) != cudaSuccess)
      return err;
    const kv::Args b{h, tc, dout, ids, count, dw, {s, k, c, i, f, o}, lv, vd, vh, vt};
    const dim3 grid(((i + kv::PI - 1) / kv::PI) * ((f + kv::PF - 1) / kv::PF),
                    (o + kv::BN - 1) / kv::BN);
    kv::dw_kernel<<<grid, kv::THREADS, lv.total, stream>>>(b);
    return cudaGetLastError();
  }
  const kw::Layout lw = kw::layout(k);
  if (lw.ns == 0) return cudaErrorInvalidValue;
  if ((err = set_smem(reinterpret_cast<const void*>(kw::dw_kernel), lw.total)) != cudaSuccess)
    return err;
  const kw::Args b{h, tc, dout, ids, count, dw, {s, k, c, i, f, o}, lw, vd, vh, vt};
  const dim3 grid(((i + 7) / 8) * ((f + 7) / 8), (o + kw::BN - 1) / kw::BN);
  kw::dw_kernel<<<grid, kw::THREADS, lw.total, stream>>>(b);
  return cudaGetLastError();
}
