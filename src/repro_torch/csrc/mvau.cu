// Fused MVAU: matmul against bit-packed 1/2-bit weights with the
// streamlined BN + activation as a multi-threshold epilogue.
//
// Replaces the TPU kernel src/repro/kernels/mvau.py::mvau (_mvau_kernel):
//   out[m, n] = offset + #{l : sign[n] * (x @ decode(carrier))[m, n] >= T[n, l]}
// x is f32 (M, K) row-major (the im2col columns: activation levels times
// one scale, not exact in bf16), the carrier uint8 (ceil(K/per), N) with
// weight k = i*per + j (per = 8/bits) in row i at bit offset j*bits
// (1-bit codes {0,1} -> {-1,+1}; 2-bit {0,1,2} -> {-1,0,+1}), T f32 (N, L)
// ascending per column with 1 <= L <= MAX_L (+inf allowed), sign f32 (N,)
// in {-1,+1}, out int32 (M, N). Any M, N and K: ragged edges are masked
// here, and x counts as zero past K, so the 1-bit carrier's padding codes
// (which decode to -1) add nothing.
//
// What bounds it on the H100: the CNV layers at batch 256 have M up to
// 200704 (conv1: 576 deep, 64 wide), so the work is 2*M*K*N f32
// operations on the CUDA cores (the reference's arithmetic is f32) against
// M*K*4 bytes of im2col columns; at 67 TFLOP/s f32 and 3.35 TB/s the
// operations bound conv1 (0.22 ms) a little above its bytes (0.14 ms).
// What the design does: the f32 accumulator never reaches device memory
// (the point of the TPU kernel), so no second pass reads it back to
// threshold it: each block keeps a 128 x 64 output tile in registers
// (8 x 4 per thread) over the whole K sweep, and the epilogue multiplies
// by the column's sign, counts the thresholds it reaches (staged once per
// block in shared memory) and writes int32 levels. x and the weight go
// through shared-memory tiles 32 deep; each carrier byte is read once per
// tile and decoded in registers into PER weights (the decode is
// common.cuh's, shared with packed_matmul). Tensor cores are later work:
// an int8 wgmma on integer levels would be exact, but its arithmetic is
// not the reference's f32.
#include "common.cuh"

namespace {

using repro::cdiv;
using repro::decode_code;

constexpr int TM = 128, TN = 64, TK = 32;  // block tile; TK is a multiple of 8
constexpr int THREADS = 256;               // 16 x 16 threads, 8 rows x 4 columns each
constexpr int RM = TM / 16, RN = TN / 16;  // 8, 4
constexpr int MAX_L = 15;                  // 4-bit activations: 2^4 - 1 thresholds

template <int BITS>
__global__ void __launch_bounds__(THREADS)
mvau_kernel(const float* __restrict__ x, const uint8_t* __restrict__ w,
            const float* __restrict__ thr, const float* __restrict__ sign,
            int* __restrict__ out, int M, int K, int N, int L, int offset) {
  constexpr int PER = 8 / BITS;
  constexpr int WROWS = TK / PER;      // carrier rows per K step
  __shared__ float xs[TM][TK + 1];     // x tile, row-major; +1 keeps the
                                       // transposed reads conflict-free
  __shared__ __align__(16) float ws[TK][TN];  // decoded weight tile
  __shared__ float ts[TN][MAX_L];      // the block's thresholds
  __shared__ float sg[TN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * TM, n0 = blockIdx.y * TN;
  const int rows = cdiv(K, PER);       // carrier rows

  for (int e = tid; e < TN * L; e += THREADS) {
    const int nn = e / L, l = e % L, n = n0 + nn;
    ts[nn][l] = n < N ? thr[static_cast<size_t>(n) * L + l] : 0.f;
  }
  for (int nn = tid; nn < TN; nn += THREADS) sg[nn] = n0 + nn < N ? sign[n0 + nn] : 1.f;

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += TK) {
    // x tile: a warp reads 32 consecutive floats of one row
    for (int e = tid; e < TM * TK; e += THREADS) {
      const int mm = e / TK, kk = e % TK;
      const int m = m0 + mm, k = k0 + kk;
      xs[mm][kk] = (m < M && k < K) ? __ldg(x + static_cast<size_t>(m) * K + k) : 0.f;
    }
    // weight tile: one carrier byte per thread and step, decoded into PER
    // rows; codes past K (and columns past N) become 0
    for (int e = tid; e < WROWS * TN; e += THREADS) {
      const int r = e / TN, nn = e % TN;
      const int row = k0 / PER + r, n = n0 + nn;
      const bool ok = row < rows && n < N;
      const unsigned byte = ok ? __ldg(w + static_cast<size_t>(row) * N + n) : 0u;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int kk = r * PER + j;
        ws[kk][nn] = (ok && k0 + kk < K) ? decode_code<BITS>(byte, j) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < TK; ++kk) {
      float a[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = xs[ty * RM + i][kk];
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * RN]);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        acc[i][0] += a[i] * b.x;
        acc[i][1] += a[i] * b.y;
        acc[i][2] += a[i] * b.z;
        acc[i][3] += a[i] * b.w;
      }
    }
    __syncthreads();
  }

  // epilogue: sign, count the thresholds reached, offset; int32 levels out
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int m = m0 + ty * RM + i;
    if (m >= M) break;
    int lv[RN];
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int nn = tx * RN + j;
      const float v = acc[i][j] * sg[nn];
      int c = offset;
      for (int l = 0; l < L; ++l) c += v >= ts[nn][l];
      lv[j] = c;
    }
    const int n = n0 + tx * RN;
    int* dst = out + static_cast<size_t>(m) * N + n;
    if (n + RN <= N && (N % 4) == 0) {
      *reinterpret_cast<int4*>(dst) = make_int4(lv[0], lv[1], lv[2], lv[3]);
    } else {
#pragma unroll
      for (int j = 0; j < RN; ++j)
        if (n + j < N) dst[j] = lv[j];
    }
  }
}

}  // namespace

// bits: 1 or 2; 1 <= L <= 15 (both checked by the wrapper). out must be
// 16-byte aligned (a fresh allocation is).
extern "C" int mvau_launch(const void* x, const void* w, const void* thr,
                           const void* sign, void* out, int M, int K, int N,
                           int L, int offset, int bits, void* stream) {
  if (L < 1 || L > MAX_L || (bits != 1 && bits != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(cdiv(M, TM), cdiv(N, TN));
  const float* xp = static_cast<const float*>(x);
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  const float* tp = static_cast<const float*>(thr);
  const float* sp = static_cast<const float*>(sign);
  int* op = static_cast<int*>(out);
  if (bits == 1)
    mvau_kernel<1><<<grid, THREADS, 0, s>>>(xp, wp, tp, sp, op, M, K, N, L, offset);
  else
    mvau_kernel<2><<<grid, THREADS, 0, s>>>(xp, wp, tp, sp, op, M, K, N, L, offset);
  return static_cast<int>(cudaGetLastError());
}
