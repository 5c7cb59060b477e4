// Matmul with the weight streamed from device memory through a shared-memory
// ring, K-chunk by K-chunk.
//
// Replaces the TPU kernel src/repro/kernels/weight_stream.py::stream_matmul
// (_stream_kernel, _decode_chunk):
//   out[m, n] = (sum_k x[m, k] * decode(w)[k, n]) * scale[n]     (f32)
// w is a uint8 carrier (ceil(K*bits/8), N) for bits 1/2, in the pack_bits
// interleave, or dense (K, N) bf16/f32 rows for bits 0. scale may be null
// (no scaling). x is f32 or bf16 (M, K) row-major. Any M, K, N.
//
// What bounds it on the H100: it runs the streamed FFN layers of budgeted
// decode, where M is the lane count (<= 16): ~2*M flops per weight, so it
// is bound by moving the weight (2-bit 960x2560: 0.6 MB, 0.18 us at
// 3.35 TB/s; dense bf16: 4.9 MB, 1.47 us) and, below that, by launch
// latency.
// What the design does about it:
//  * ring: each CTA sweeps its K range through a `depth`-stage ring in
//    shared memory (depth = the residency plan's stream_ahead, the paper's
//    R_F, 2..8). A stage is 32 storage rows x 64 columns, filled by 16-byte
//    cp.async.cg copies with one commit group per stage; stage i + depth is
//    issued into the slot of stage i once every thread has consumed it
//    (__syncthreads before the refill: no write-after-read on a slot).
//  * x (8 rows per CTA) is staged once per CTA in shared memory as f32,
//    zero past M and past K: that zero is what keeps a padded 1-bit row
//    (code 0 decodes to -1) an exact no-op, so nothing is padded on the host.
//  * the carrier is decoded in registers next to the FMA (common.cuh's
//    decode_code, the same as packed_matmul.cu); decoded weights never
//    reach device memory.
//  * filling the card: the TPU grid is N/128 programs (8 at N=960, against
//    132 SMs). Here a CTA owns 64 columns and the K sweep is split across
//    CTAs (grid.z) until there are about two CTAs per SM; the wrapper picks
//    the split. With a split, each CTA writes f32 partials and a second
//    small kernel sums them in a fixed order and applies the scale, so the
//    result does not depend on scheduling.
//  * ragged edges: rows past the weight's end and 16-byte segments past N
//    are zero-filled by cp.async (src-size 0). Where a row pitch or the base
//    is not 16-byte aligned (e.g. uint8 N = 70), the stage is filled by
//    plain masked loads instead, through the same ring.
#include "common.cuh"

namespace {

using repro::cdiv;
using repro::decode_code;
using repro::to_f;

constexpr int MT = 8;    // rows of x per CTA
constexpr int BN = 64;   // output columns per CTA
constexpr int KG = 4;    // k-groups splitting each stage's rows
constexpr int THREADS = KG * BN;
constexpr int ROWS = 32;  // storage rows per ring stage

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ uint8_t zero<uint8_t>() { return 0; }
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: no bytes read, 16 bytes of zeros written
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most `pending` of this thread's commit groups are in flight
// (wait_group takes an immediate, and the depth is a run-time value).
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::); break;
  }
}

// grid (cdiv(N, BN), cdiv(M, MT), splits); split z sweeps storage-row chunks
// [z*cps, min((z+1)*cps, nk)). out: (M, N) when splits == 1, else the
// (splits, M, N) partials.
template <typename XT, typename WT, int BITS>
__global__ void __launch_bounds__(THREADS)
stream_kernel(const XT* __restrict__ x, const WT* __restrict__ w,
              const float* __restrict__ scale, float* __restrict__ out,
              int M, int K, int N, int w_rows, int cps, int depth,
              int aligned, int splits) {
  constexpr int PER = BITS ? 8 / BITS : 1;
  constexpr int CK = ROWS * PER;  // K values per stage
  constexpr int STAGE = ROWS * BN;
  extern __shared__ __align__(16) unsigned char smem[];
  WT* ring = reinterpret_cast<WT*>(smem);
  float* xs = reinterpret_cast<float*>(smem + sizeof(WT) * STAGE * depth);
  const int klen = cps * CK;  // row stride of xs
  float* red = xs + MT * klen;

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * MT;
  const int split = blockIdx.z;
  const int chunk0 = split * cps;
  const int nloc = min(cps, cdiv(w_rows, ROWS) - chunk0);  // >= 1 by the split
  const int kbeg = chunk0 * CK;

  auto issue = [&](int i, int slot) {
    WT* dst = ring + slot * STAGE;
    const int r0 = (chunk0 + i) * ROWS;
    if (aligned) {
      constexpr int SEG = 16 / sizeof(WT);  // elements per 16-byte copy
      constexpr int SEGS = BN / SEG;        // copies per stage row
      for (int s = tid; s < ROWS * SEGS; s += THREADS) {
        const int rr = s / SEGS, c = (s % SEGS) * SEG;
        const int r = r0 + rr, n = n0 + c;
        const bool ok = r < w_rows && n < N;  // N % SEG == 0: all in or all out
        cp_async16(dst + rr * BN + c, ok ? w + static_cast<size_t>(r) * N + n : w, ok);
      }
    } else {
      for (int e = tid; e < STAGE; e += THREADS) {
        const int rr = e / BN, c = e % BN;
        const int r = r0 + rr, n = n0 + c;
        dst[e] = (r < w_rows && n < N) ? w[static_cast<size_t>(r) * N + n] : zero<WT>();
      }
    }
  };

  // warm-up: fill the ring `depth` stages ahead (one group per stage, empty
  // groups included, so the wait count below holds at the tail)
  for (int s = 0; s < depth; ++s) {
    if (s < nloc) issue(s, s);
    cp_async_commit();
  }
  for (int e = tid; e < MT * klen; e += THREADS) {
    const int i = e / klen, kk = e % klen;
    const int m = m0 + i, k = kbeg + kk;
    xs[e] = (m < M && k < K) ? to_f(x[static_cast<size_t>(m) * K + k]) : 0.f;
  }

  const int kg = tid / BN, c = tid % BN;
  float acc[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) acc[i] = 0.f;
  for (int i = 0; i < nloc; ++i) {
    const int slot = i % depth;
    cp_async_wait(depth - 1);  // stage i has landed (this thread's copies)
    __syncthreads();           // ... and every thread's, and the x tile
    const WT* st = ring + slot * STAGE;
    const float* xk = xs + i * CK;
#pragma unroll 2
    for (int rr = kg; rr < ROWS; rr += KG) {
      const WT v = st[rr * BN + c];
      if constexpr (BITS == 0) {
        const float wv = to_f(v);
#pragma unroll
        for (int m = 0; m < MT; ++m) acc[m] += xk[m * klen + rr] * wv;
      } else {
        const unsigned byte = v;
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          const float wv = decode_code<BITS>(byte, j);
#pragma unroll
          for (int m = 0; m < MT; ++m) acc[m] += xk[m * klen + rr * PER + j] * wv;
        }
      }
    }
    __syncthreads();  // slot fully consumed before it is refilled
    if (i + depth < nloc) issue(i + depth, slot);
    cp_async_commit();
  }

#pragma unroll
  for (int m = 0; m < MT; ++m) red[(kg * MT + m) * BN + c] = acc[m];
  __syncthreads();
  for (int e = tid; e < MT * BN; e += THREADS) {
    const int i = e / BN, cc = e % BN;
    const int m = m0 + i, n = n0 + cc;
    if (m >= M || n >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < KG; ++g) s += red[(g * MT + i) * BN + cc];
    if (splits == 1) {
      out[static_cast<size_t>(m) * N + n] = scale ? s * scale[n] : s;
    } else {
      out[(static_cast<size_t>(split) * M + m) * N + n] = s;
    }
  }
}

// out[e] = scale[n] * sum_z part[z][e], z in order.
__global__ void split_reduce(const float* __restrict__ part, const float* __restrict__ scale,
                             float* __restrict__ out, int M, int N, int splits) {
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t mn = static_cast<size_t>(M) * N;
  if (e >= mn) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += part[z * mn + e];
  out[e] = scale ? s * scale[e % N] : s;
}

template <typename XT, typename WT, int BITS>
int launch(const void* x, const void* w, const float* scale, float* out, float* part,
           int M, int K, int N, int splits, int cps, int depth, cudaStream_t stream) {
  constexpr int PER = BITS ? 8 / BITS : 1;
  const int w_rows = BITS ? cdiv(K, PER) : K;
  const size_t smem = sizeof(WT) * ROWS * BN * depth +
                      sizeof(float) * (static_cast<size_t>(MT) * cps * ROWS * PER + KG * MT * BN);
  auto kern = stream_kernel<XT, WT, BITS>;
  static bool opted_in = false;  // once per instantiation: allow > 48 KB
  if (!opted_in) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const int aligned = reinterpret_cast<uintptr_t>(w) % 16 == 0 && (N * sizeof(WT)) % 16 == 0;
  dim3 grid(cdiv(N, BN), cdiv(M, MT), splits);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const XT*>(x), static_cast<const WT*>(w), scale,
      splits == 1 ? out : part, M, K, N, w_rows, cps, depth, aligned, splits);
  if (splits > 1) {
    const size_t mn = static_cast<size_t>(M) * N;
    split_reduce<<<static_cast<unsigned>((mn + 255) / 256), 256, 0, stream>>>(
        part, scale, out, M, N, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename XT>
int dispatch_w(const void* x, const void* w, int bits, int w_bf16, const float* scale,
               float* out, float* part, int M, int K, int N, int splits, int cps,
               int depth, cudaStream_t s) {
  if (bits == 1)
    return launch<XT, uint8_t, 1>(x, w, scale, out, part, M, K, N, splits, cps, depth, s);
  if (bits == 2)
    return launch<XT, uint8_t, 2>(x, w, scale, out, part, M, K, N, splits, cps, depth, s);
  if (w_bf16)
    return launch<XT, __nv_bfloat16, 0>(x, w, scale, out, part, M, K, N, splits, cps, depth, s);
  return launch<XT, float, 0>(x, w, scale, out, part, M, K, N, splits, cps, depth, s);
}

}  // namespace

// x_bf16: 0 -> x f32, 1 -> bf16. bits: 1/2 (uint8 carrier) or 0 (dense rows,
// w_bf16 selects bf16 or f32). scale may be null. part: (splits, M, N) f32
// scratch, used when splits > 1. depth in [2, 8]. Checked by the wrapper.
extern "C" int stream_matmul_launch(const void* x, int x_bf16, const void* w, int bits,
                                    int w_bf16, const void* scale, void* out, void* part,
                                    int M, int K, int N, int splits, int cps, int depth,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(scale);
  float* op = static_cast<float*>(out);
  float* pp = static_cast<float*>(part);
  if (x_bf16)
    return dispatch_w<__nv_bfloat16>(x, w, bits, w_bf16, sp, op, pp, M, K, N, splits, cps,
                                     depth, s);
  return dispatch_w<float>(x, w, bits, w_bf16, sp, op, pp, M, K, N, splits, cps, depth, s);
}
