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

// The A fragment (16 rows x 16 columns, rows r0.. of a row-major shared
// tile of stride LD, columns c0..) as ldmatrix_x4 gives it: matrices 0-3
// are (rows +0, cols +0), (+8, +0), (+0, +8), (+8, +8), mma's a[0..3].
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int r0,
                                       int c0, int lane) {
  ldmatrix_x4(a, tile + (r0 + lane % 16) * LD + c0 + (lane / 16) * 8);
}

// B fragments of two n8 tiles (n = rows n0..n0+15 of an n-major tile, k =
// columns c0..c0+15): b[0], b[1] for rows n0.., b[2], b[3] for n0+8..
template <int LD>
__device__ __forceinline__ void load_b_nmajor(uint32_t (&b)[4], const __nv_bfloat16* tile,
                                              int n0, int c0, int lane) {
  ldmatrix_x4(b, tile + (n0 + lane % 8 + (lane / 16) * 8) * LD + c0 + ((lane / 8) % 2) * 8);
}

// The same from a k-major tile (k = rows k0..k0+15, n = columns n0..n0+15),
// by ldmatrix.trans.
template <int LD>
__device__ __forceinline__ void load_b_kmajor(uint32_t (&b)[4], const __nv_bfloat16* tile,
                                              int k0, int n0, int lane) {
  ldmatrix_x4_trans(b, tile + (k0 + lane % 8 + ((lane / 8) % 2) * 8) * LD + n0 + (lane / 16) * 8);
}

// Accumulator n8 tiles 2c and 2c+1 (16 columns) rounded to bf16: the A
// fragment of a product whose k runs over those 16 columns.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack_bf16x2(lo[0], lo[1]);
  a[1] = pack_bf16x2(lo[2], lo[3]);
  a[2] = pack_bf16x2(hi[0], hi[1]);
  a[3] = pack_bf16x2(hi[2], hi[3]);
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

// ROWS rows of D bf16 (rows r0.. of a row-major tensor with n_rows rows)
// into a shared tile of row stride LD, by THREADS threads, 16 bytes a
// copy; rows past n_rows become zeros. src must be 16-byte aligned.
template <int D, int LD, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                int r0, int n_rows, int tid) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  static_assert(ROWS * CH % THREADS == 0, "whole copies per thread");
#pragma unroll
  for (int i = 0; i < ROWS * CH / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int r = c / CH, cc = c % CH;
    const bool ok = r0 + r < n_rows;
    cp_async<16>(dst + r * LD + cc * 8, ok ? src + static_cast<size_t>(r0 + r) * D + cc * 8 : src,
                 ok ? 16 : 0);
  }
}

// ---- packed 1/2-bit codes as bf16 mma operands
// The bf16 bits of each code's weight, byte c of LO / HI being the low /
// high byte for code c (1-bit: -1, +1; 2-bit: -1, 0, +1, and +2 for the
// unused code 3, as the reference's codes - 1). Every value is exact in
// bf16.
template <int BITS> struct DecodeLut;
template <> struct DecodeLut<1> { static constexpr uint32_t LO = 0x00008080u, HI = 0x00003FBFu; };
template <> struct DecodeLut<2> { static constexpr uint32_t LO = 0x00800080u, HI = 0x403F00BFu; };

// Weight j of each of 4 carrier bytes (4 columns), as 4 bf16 in two
// registers: each code c becomes the byte-permute selector nibbles (c,
// c+4), which pick its low and high byte from the tables.
template <int BITS>
__device__ __forceinline__ uint2 decode4(uint32_t w, int j) {
  constexpr uint32_t MASK = BITS == 1 ? 0x01010101u : 0x03030303u;
  const uint32_t c = (w >> (j * BITS)) & MASK;  // one code per byte
  const uint32_t sel = c * 0x11u + 0x40404040u;  // no carries: c <= 3
  return make_uint2(__byte_perm(DecodeLut<BITS>::LO, DecodeLut<BITS>::HI, sel),
                    __byte_perm(DecodeLut<BITS>::LO, DecodeLut<BITS>::HI, sel >> 16));
}

// CB (4 or 8) carrier bytes of one row (CB neighbouring columns, src
// CB-aligned in shared memory) decoded into the 8/BITS weight rows they
// hold: weight j of each byte goes to dst + j * ld, as CB bf16 (dst
// 2*CB-byte aligned). With the carrier row r of a K step at decoded rows
// r*PER.., the result is a k-major bf16 tile, which ldmatrix.trans reads
// as mma B fragments.
template <int BITS, int CB>
__device__ __forceinline__ void decode_bytes(const uint8_t* src, __nv_bfloat16* dst, int ld) {
  static_assert(CB == 4 || CB == 8, "one 4- or 8-byte carrier copy per thread");
  constexpr int PER = 8 / BITS;
  if constexpr (CB == 8) {
    const uint2 wv = *reinterpret_cast<const uint2*>(src);
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const uint2 lo = decode4<BITS>(wv.x, j), hi = decode4<BITS>(wv.y, j);
      *reinterpret_cast<uint4*>(dst + j * ld) = make_uint4(lo.x, lo.y, hi.x, hi.y);
    }
  } else {
    const uint32_t wv = *reinterpret_cast<const uint32_t*>(src);
#pragma unroll
    for (int j = 0; j < PER; ++j) *reinterpret_cast<uint2*>(dst + j * ld) = decode4<BITS>(wv, j);
  }
}

}  // namespace repro

// Text of a cudaError_t the entries returned, for the Python wrappers.
extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
