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

}  // namespace repro

// Text of a cudaError_t the entries returned, for the Python wrappers.
extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
