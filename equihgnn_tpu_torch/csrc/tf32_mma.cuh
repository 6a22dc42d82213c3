// Device helpers shared by kernels J (`pooled_conv_fwd.cu`) and K
// (`pooled_conv.cu`): cp.async copies into shared memory, the 3xTF32 split,
// one m16n8k8 TF32 tensor-core product and named barriers; kernels G and I
// (`vis_mix.cu`) take the copies and `set_smem`, kernel B (`edge_mlp.cu`)
// the copies, the split (by integer operations) and the products. Off the card (a host
// compiler parsing the sources) the copies are plain copies and the rest
// does nothing.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// cp.async of 4 or 16 bytes into shared memory, zero-filled when !valid
// (then src is any readable address and no byte is read).
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool valid) {
#if defined(__CUDA_ARCH__)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(valid ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(valid ? 4 : 0));
#else
  for (int j = 0; j < BYTES / 4; ++j) dst[j] = valid ? src[j] : 0.f;
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

// Waits until at most N of this thread's committed copy groups are still in
// flight; a barrier after it shows the finished ones to the other threads.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }

// x rounded to TF32 (10 mantissa bits), to nearest, ties away from zero,
// as an f32 bit pattern.
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
#if defined(__CUDA_ARCH__)
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
#else
  r = __float_as_uint(x);
#endif
  return r;
}

__device__ __forceinline__ float as_float(uint32_t u) { return __uint_as_float(u); }

// The 3xTF32 split of x: big = tf32(x), small = tf32(x − big).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = tf32(x - as_float(big));
}

// tf32(x) by two integer operations: the magnitude rounded at bit 13, ties
// away from zero, which are the bits cvt.rna.tf32.f32 gives for a finite x;
// they run on the integer pipe, not the conversion unit.
__device__ __forceinline__ uint32_t tf32_alu(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split_tf32_alu(float x, uint32_t& big, uint32_t& small) {
  big = tf32_alu(x);
  small = tf32_alu(x - as_float(big));
}

// d += a · b for one m16n8k8 TF32 tile of the warp (row.col); the
// fragments as PTX lays them out: a {(g, t), (g+8, t), (g, t+4),
// (g+8, t+4)}, b {(t, g), (t+4, g)}, d {(g, 2t), (g, 2t+1), (g+8, 2t),
// (g+8, 2t+1)} for lane 4g + t, (row, column).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
#endif
}

// d += a · b in 3xTF32 (big·big + big·small + small·big, the small terms
// first), from the split fragments of a and b.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// Named barriers: bar_sync waits until n threads have arrived at barrier
// id (itself included); bar_arrive counts this thread and goes on. Both
// order this thread's earlier shared-memory writes before the waiters'
// later reads.
__device__ __forceinline__ void bar_sync(int id, int n) {
#if defined(__CUDA_ARCH__)
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
#endif
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
#if defined(__CUDA_ARCH__)
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
#endif
}

// Lets a kernel use `smem` bytes of dynamic shared memory, or reports why
// not (more than a block may have: cudaErrorInvalidValue), clearing the
// error so that the next launch does not see it.
constexpr size_t MAX_SMEM = 232448;

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace
