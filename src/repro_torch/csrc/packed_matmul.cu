// Matmul against bit-packed 1/2-bit weights, decoded in registers.
//
// Replaces the TPU kernel src/repro/kernels/packed_matmul.py::packed_matmul
// (_packed_matmul_kernel, _decode_block):
//   out[m, n] = (sum_k x[m, k] * decode(carrier)[k, n]) * scale[n]
// Weight k = i*per + j (per = 8/bits) sits in carrier row i at bit offset
// j*bits. 1-bit codes {0,1} -> {-1,+1}; 2-bit codes {0,1,2} -> {-1,0,+1}.
// x is f32 or bf16 (M, K) row-major, the carrier uint8 (K/per, N), scale
// f32 (N,), out f32 (M, N). Any M, K, N with K % per == 0.
//
// What bounds it on the H100: at decode M is the lane count (4-16), so the
// work is ~M*16 flops per carrier byte and the kernel is bound by moving
// the carrier (0.6 MB for 960x2560 at 2 bits, ~0.2 us at 3.35 TB/s) and,
// below that, by launch latency. At prefill (M = prompt bucket) it is
// bound by operations.
// What the design does: the carrier is read straight from device memory
// (neighbouring threads on neighbouring columns, so a warp reads 32
// contiguous bytes), each byte is decoded in registers next to the
// multiply-add, and the decoded weight never reaches device memory: the
// paper's packing keeps 8x/16x fewer weight bytes than bf16 on the bus.
//  * gemv path (M <= 16): one thread per output column and MT rows of x;
//    x is staged in shared memory 256 K at a time (read as broadcasts),
//    the K sweep is split over 8 warps and reduced in shared memory.
//  * tiled path (M > 16): 64x64 output tiles, 32-deep K steps; x and the
//    weight tile (decoded in registers, then staged) go through shared
//    memory, f32 FMAs on the CUDA cores. Tensor cores (wgmma) are later work.
// Accumulation is f32; scale is applied once after the K sweep. Ragged
// edges of M and N are masked here, so no padding happens in Python.
#include "common.cuh"

namespace {

using repro::cdiv;
using repro::to_f;
using repro::decode_code;

constexpr int GEMV_MAX_M = 16;
constexpr int GEMV_COLS = 32;  // output columns per block, one per lane
constexpr int GEMV_WARPS = 8;  // warps splitting the K sweep
constexpr int GEMV_MT = 8;     // rows of x per block (GEMV_MT*GEMV_COLS == threads)
constexpr int GEMV_KC = 256;   // K chunk of x staged in shared memory (multiple of 8)

template <typename T, int BITS>
__global__ void __launch_bounds__(GEMV_COLS * GEMV_WARPS)
gemv_kernel(const T* __restrict__ x, const uint8_t* __restrict__ w,
            const float* __restrict__ scale, float* __restrict__ out,
            int M, int K, int N) {
  constexpr int PER = 8 / BITS;
  __shared__ float xs[GEMV_MT][GEMV_KC];  // x chunk, f32, zero past M / K
  __shared__ float part[GEMV_WARPS][GEMV_MT][GEMV_COLS];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int n = blockIdx.x * GEMV_COLS + lane;
  const int m0 = blockIdx.y * GEMV_MT;
  float acc[GEMV_MT];
#pragma unroll
  for (int i = 0; i < GEMV_MT; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < K; k0 += GEMV_KC) {
    const int kc = min(GEMV_KC, K - k0);  // a multiple of PER: K and k0 are
    __syncthreads();                       // previous chunk consumed
    for (int e = threadIdx.x; e < GEMV_MT * GEMV_KC; e += GEMV_COLS * GEMV_WARPS) {
      const int i = e / GEMV_KC, kk = e % GEMV_KC;
      const int m = m0 + i;
      xs[i][kk] = (m < M && kk < kc) ? to_f(x[static_cast<size_t>(m) * K + k0 + kk]) : 0.f;
    }
    __syncthreads();
    if (n < N) {
      const int r0 = k0 / PER, r1 = (k0 + kc) / PER;
#pragma unroll 4
      for (int r = r0 + warp; r < r1; r += GEMV_WARPS) {
        const unsigned byte = __ldg(w + static_cast<size_t>(r) * N + n);
        const int kk0 = (r - r0) * PER;
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          const float wv = decode_code<BITS>(byte, j);
#pragma unroll
          for (int i = 0; i < GEMV_MT; ++i) acc[i] += xs[i][kk0 + j] * wv;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < GEMV_MT; ++i) part[warp][i][lane] = acc[i];
  __syncthreads();
  const int i = threadIdx.x / GEMV_COLS;
  const int c = threadIdx.x % GEMV_COLS;
  float s = 0.f;
#pragma unroll
  for (int wi = 0; wi < GEMV_WARPS; ++wi) s += part[wi][i][c];
  const int m = m0 + i;
  const int nn = blockIdx.x * GEMV_COLS + c;
  if (m < M && nn < N) out[static_cast<size_t>(m) * N + nn] = s * scale[nn];
}

constexpr int TM = 64, TN = 64, TK = 32;  // block tile; 16x16 threads, 4x4 each

template <typename T, int BITS>
__global__ void __launch_bounds__(256)
tiled_kernel(const T* __restrict__ x, const uint8_t* __restrict__ w,
             const float* __restrict__ scale, float* __restrict__ out,
             int M, int K, int N) {
  constexpr int PER = 8 / BITS;
  __shared__ float xs[TK][TM + 4];  // x tile, k-major
  __shared__ float ws[TK][TN + 4];  // decoded weight tile
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

  for (int k0 = 0; k0 < K; k0 += TK) {
    for (int e = tid; e < TM * TK; e += 256) {
      const int mm = e / TK, kk = e % TK;
      const int m = m0 + mm, k = k0 + kk;
      xs[kk][mm] = (m < M && k < K) ? to_f(x[static_cast<size_t>(m) * K + k]) : 0.f;
    }
    for (int e = tid; e < TK * TN; e += 256) {
      const int kk = e / TN, nn = e % TN;
      const int k = k0 + kk, n = n0 + nn;
      float v = 0.f;
      if (k < K && n < N)
        v = decode_code<BITS>(__ldg(w + static_cast<size_t>(k / PER) * N + n), k % PER);
      ws[kk][nn] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (m < M && n < N) out[static_cast<size_t>(m) * N + n] = acc[i][j] * scale[n];
    }
  }
}

template <typename T, int BITS>
void launch(const void* x, const void* w, const void* scale, void* out,
            int M, int K, int N, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  float* op = static_cast<float*>(out);
  if (M <= GEMV_MAX_M) {
    dim3 grid(cdiv(N, GEMV_COLS), cdiv(M, GEMV_MT));
    gemv_kernel<T, BITS><<<grid, GEMV_COLS * GEMV_WARPS, 0, stream>>>(xp, wp, sp, op, M, K, N);
  } else {
    dim3 grid(cdiv(N, TN), cdiv(M, TM));
    tiled_kernel<T, BITS><<<grid, 256, 0, stream>>>(xp, wp, sp, op, M, K, N);
  }
}

}  // namespace

// x_bf16: 0 -> x is f32, 1 -> bf16. bits: 1 or 2 (checked by the wrapper).
extern "C" int packed_matmul_launch(const void* x, int x_bf16, const void* w,
                                    const void* scale, void* out, int M, int K,
                                    int N, int bits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    if (bits == 1) launch<__nv_bfloat16, 1>(x, w, scale, out, M, K, N, s);
    else launch<__nv_bfloat16, 2>(x, w, scale, out, M, K, N, s);
  } else {
    if (bits == 1) launch<float, 1>(x, w, scale, out, M, K, N, s);
    else launch<float, 2>(x, w, scale, out, M, K, N, s);
  }
  return static_cast<int>(cudaGetLastError());
}
