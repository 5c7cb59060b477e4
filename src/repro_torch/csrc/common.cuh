// Helpers shared by the port's kernels (each .cu builds into its own
// shared library with a plain C interface, loaded with ctypes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// One weight of a packed carrier byte, in the ``pack_bits`` interleave
// (weight k = i*per + j sits in carrier row i at bit offset j*BITS):
// 1-bit codes {0,1} -> {-1,+1}; 2-bit codes {0,1,2} -> {-1,0,+1}.
template <int BITS>
__device__ __forceinline__ float decode_code(unsigned byte, int j) {
  const unsigned code = (byte >> (j * BITS)) & ((1u << BITS) - 1u);
  if (BITS == 1) return code ? 1.f : -1.f;
  return static_cast<float>(code) - 1.f;
}

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// ---- tensor-core helpers (mma.sync m16n8k16 bf16 -> f32, ldmatrix, cp.async)
// In the fragment layouts below, g = lane / 4 and t = lane % 4.

// Shared-memory address of a generic pointer, for the PTX operands.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8, and r[j] receives matrix j with this lane holding row g, columns
// 2t and 2t+1 (the layout of an mma A fragment's register, or of a B
// register when the matrix is stored n-major).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

// The same, transposed: r[j] holds rows 2t and 2t+1 of column g of matrix
// j, which is a B fragment's register for a matrix stored k-major (k x n
// row-major, as V or a decoded weight tile).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

// d += a * b over a 16x8x16 tile, bf16 in, f32 accumulate.
// a (16x16, row-major): a[0] (g, 2t..2t+1), a[1] (g+8, 2t..), a[2] (g, 2t+8..),
//   a[3] (g+8, 2t+8..); b (16x8): b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g);
// d (16x8, f32): d[0], d[1] (g, 2t and 2t+1), d[2], d[3] (g+8, the same).
// So a pair of d tiles side by side, packed to bf16, is the A fragment of
// the next product over their 16 columns.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to one bf16x2 register: lo in the low half (the
// lower column of an A fragment's pair).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Asynchronous global -> shared copies of BYTES (4, 8 or 16); the bytes
// past src_bytes (0 reads nothing) are written as zeros.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, int src_bytes) {
  static_assert(BYTES == 4 || BYTES == 8 || BYTES == 16, "cp.async copies 4, 8 or 16 bytes");
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(smem_u32(smem)), "l"(gmem), "r"(src_bytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 ::"r"(smem_u32(smem)), "l"(gmem), "n"(BYTES), "r"(src_bytes) : "memory");
  }
}

// Close this thread's current group of cp.async copies.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's groups are in flight; its own
// copies of the older groups are then visible to it (to the block after
// a __syncthreads).
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace repro

// Text of a cudaError_t the entries returned, for the Python wrappers.
extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
