// Matmul against bit-packed 1/2-bit weights, decoded on chip.
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
// below that, by launch latency. At prefill (M = the chunk, 256-512) it is
// bound by operations (1.3-2.5 GFLOP, 1.3-2.5 us at the bf16 tensor-core
// peak), which only the tensor cores reach.
// What the design does: the decoded weight never reaches device memory
// (the paper's packing keeps 8x/16x fewer weight bytes than bf16 on the
// bus); each route decodes the carrier next to its multiply.
//  * gemv path (M <= 16, any x): one thread per output column and MT rows
//    of x; x is staged in shared memory 256 K at a time (read as
//    broadcasts), the carrier read straight from device memory (a warp
//    reads 32 contiguous bytes) and decoded in registers, the K sweep
//    split over 8 warps and reduced in shared memory.
//  * mma path (M > 16, bf16 x): 64x128 output tiles, 8 warps of 32x32, K
//    steps of 64. x tiles and the step's carrier bytes (1-2 KB) go through
//    a 3-stage cp.async ring; each thread decodes the carrier bytes it
//    copied (byte-permute lookups of the bf16 bits of -1/0/+1, exact) into
//    a double-buffered shared bf16 tile, k-major, which ldmatrix.trans
//    reads as the B operand of mma.sync m16n8k16 (bf16 in, f32
//    accumulate): one __syncthreads a step, the decode of step t+1 beside
//    the products of step t. Where the output has too few tiles for 132
//    SMs, the K sweep is split over a thread-block cluster (the plan comes
//    from the wrapper) and the partial tiles are summed in split order
//    through distributed shared memory: one launch, no atomics, the same
//    bits every run.
//  * tiled path (M > 16, f32 x): 64x64 output tiles, 32-deep K steps; x
//    and the weight tile (decoded in registers) are staged in shared
//    memory, f32 FMAs on the CUDA cores (TF32 tensor cores would round x).
// Accumulation is f32; scale is applied once after the K sweep. Ragged
// M, N and K are masked here, so no padding happens in Python.
#include <cooperative_groups.h>

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

// ---------------- mma path: bf16 x, M > 16, tensor cores ----------------

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int BM = 64, BN = 128, BK = 64;  // block tile and K step
constexpr int MMA_THREADS = 256;            // 8 warps: 2 (M) x 4 (N) of 32x32
constexpr int STAGES = 3;                   // x / carrier ring
constexpr int XLD = BK + 8;                 // padded row strides in bf16, so the 8
constexpr int WLD = BN + 8;                 // rows of an ldmatrix hit distinct banks
constexpr int PLD = BN + 4;                 // row stride of a split's f32 partial tile
constexpr int MAX_SPLITS = 8;               // the portable cluster size

template <int BITS>
struct MmaGeom {
  static constexpr int PER = 8 / BITS;
  static constexpr int CROWS = BK / PER;                    // carrier rows per K step
  static constexpr int CB = CROWS * BN / MMA_THREADS;       // carrier bytes a thread copies
  static constexpr size_t X_BYTES = sizeof(bf16) * STAGES * BM * XLD;
  static constexpr size_t C_BYTES = STAGES * CROWS * BN;
  static constexpr size_t W_BYTES = sizeof(bf16) * 2 * BK * WLD;
  static constexpr size_t SMEM = X_BYTES + C_BYTES + W_BYTES;
  static_assert(CB == 4 || CB == 8, "one 4- or 8-byte carrier copy per thread");
  static_assert(sizeof(float) * BM * PLD <= SMEM, "the partial tile reuses the ring");
};

// grid (cdiv(N, BN), cdiv(M, BM), splits), clusters of (1, 1, splits):
// split z sweeps K steps [z*cps, min((z+1)*cps, nk)). x_vec: K % 8 == 0 and
// x 16-byte aligned (x rows by cp.async); w_vec: N and the carrier aligned
// to the per-thread copy (carrier rows by cp.async).
template <int BITS>
__global__ void __launch_bounds__(MMA_THREADS)
mma_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ w,
           const float* __restrict__ scale, float* __restrict__ out,
           int M, int K, int N, int cps, int x_vec, int w_vec) {
  using G = MmaGeom<BITS>;
  constexpr int PER = G::PER, CROWS = G::CROWS, CB = G::CB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);                          // [STAGES][BM][XLD]
  uint8_t* cs = smem_raw + G::X_BYTES;                                   // [STAGES][CROWS][BN]
  bf16* ws = reinterpret_cast<bf16*>(smem_raw + G::X_BYTES + G::C_BYTES);  // [2][BK][WLD]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;
  const int gq = lane / 4, tq = lane % 4;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int nk = cdiv(K, BK);
  const int t0 = blockIdx.z * cps;
  const int ns = min(cps, nk - t0);  // >= 1 by the plan
  const int krows = K / PER;         // carrier rows
  // this thread's carrier copy: row cr of a step, columns cc .. cc+CB-1
  const int cr = tid / (BN / CB), cc = (tid % (BN / CB)) * CB;

  auto load_step = [&](int t) {  // local step t into ring stage t % STAGES
    const int k0 = (t0 + t) * BK;
    bf16* xd = xs + (t % STAGES) * BM * XLD;
#pragma unroll
    for (int i = 0; i < BM * BK / 8 / MMA_THREADS; ++i) {
      const int c = tid + i * MMA_THREADS;
      const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      const int m = m0 + r, k = k0 + kc;
      if (x_vec) {
        const bool ok = m < M && k < K;  // K % 8 == 0: all 8 in or all out
        repro::cp_async<16>(xd + r * XLD + kc, ok ? x + static_cast<size_t>(m) * K + k : x,
                            ok ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          xd[r * XLD + kc + e] = (m < M && k + e < K) ? x[static_cast<size_t>(m) * K + k + e]
                                                      : __float2bfloat16(0.f);
      }
    }
    uint8_t* cd = cs + (t % STAGES) * CROWS * BN + cr * BN + cc;
    const int r = (t0 + t) * CROWS + cr, n = n0 + cc;
    if (w_vec) {
      const bool ok = r < krows && n < N;  // N % CB == 0: all in or all out
      repro::cp_async<CB>(cd, ok ? w + static_cast<size_t>(r) * N + n : w, ok ? CB : 0);
    } else {
#pragma unroll
      for (int e = 0; e < CB; ++e)
        cd[e] = (r < krows && n + e < N) ? w[static_cast<size_t>(r) * N + n + e] : 0;
    }
  };

  // Decode this thread's carrier copy of local step t into decoded tile
  // t & 1: weights k = cr*PER + j of columns cc.. (codes past K decode to
  // finite values that meet x's zeros).
  auto decode_step = [&](int t) {
    repro::decode_bytes<BITS, CB>(cs + (t % STAGES) * CROWS * BN + cr * BN + cc,
                                  ws + (t & 1) * BK * WLD + cr * PER * WLD + cc, WLD);
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  load_step(0);
  repro::cp_async_commit();
  if (ns > 1) load_step(1);
  repro::cp_async_commit();
  repro::cp_async_wait<1>();  // step 0's copies (this thread's) landed
  decode_step(0);
  for (int t = 0; t < ns; ++t) {
    // step t's x and decoded tile visible; step t-1's stage and tile free
    __syncthreads();
    if (t + 2 < ns) load_step(t + 2);
    repro::cp_async_commit();
    repro::cp_async_wait<1>();  // step t+1's copies (this thread's) landed
    if (t + 1 < ns) decode_step(t + 1);
    const bf16* xst = xs + (t % STAGES) * BM * XLD;
    const bf16* wst = ws + (t & 1) * BK * WLD;
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t a[2][4], b[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        repro::ldmatrix_x4(a[i], xst + (wm * 32 + i * 16 + lane % 16) * XLD + kc * 16 + (lane / 16) * 8);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp)  // b0/b1 of n-tiles 2jp and 2jp+1
        repro::ldmatrix_x4_trans(
            b[jp], wst + (kc * 16 + lane % 8 + ((lane / 8) % 2) * 8) * WLD + wn * 32 + jp * 16 + (lane / 16) * 8);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          repro::mma_bf16_16816(acc[i][j], a[i], b[j / 2][(j % 2) * 2], b[j / 2][(j % 2) * 2 + 1]);
    }
  }
  repro::cp_async_wait<0>();

  if (gridDim.z == 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 32 + i * 16 + gq + 8 * h;
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int n = n0 + wn * 32 + j * 8 + tq * 2 + u;
            if (n < N) out[static_cast<size_t>(m) * N + n] = acc[i][j][2 * h + u] * scale[n];
          }
      }
    return;
  }

  // split K: each block's partial tile meets the others' in the cluster's
  // shared memory; block r sums rows [r*rows, ...) in split order
  cg::cluster_group cluster = cg::this_cluster();
  __syncthreads();  // the ring is no longer read
  float* part = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = wm * 32 + i * 16 + gq + 8 * h, c = wn * 32 + j * 8 + tq * 2;
        *reinterpret_cast<float2*>(part + r * PLD + c) = make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
  cluster.sync();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int rows = cdiv(BM, splits);
  const int r_lo = rank * rows, r_hi = min(BM, r_lo + rows);
  for (int e = tid; e < (r_hi - r_lo) * (BN / 4); e += MMA_THREADS) {
    const int r = r_lo + e / (BN / 4), c = (e % (BN / 4)) * 4;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < splits; ++q) {
      const float4 p = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, q) + r * PLD + c);
      sum.x += p.x; sum.y += p.y; sum.z += p.z; sum.w += p.w;
    }
    const int m = m0 + r;
    if (m >= M) continue;
    const float v[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (n0 + c + u < N) out[static_cast<size_t>(m) * N + n0 + c + u] = v[u] * scale[n0 + c + u];
  }
  cluster.sync();  // no block leaves while another still reads its partial
}

template <int BITS>
int launch_mma(const void* x, const void* w, const void* scale, void* out, int M,
               int K, int N, int splits, int cps, cudaStream_t stream) {
  using G = MmaGeom<BITS>;
  const int nk = cdiv(K, BK);
  // every split non-empty, together covering the sweep
  if (splits < 1 || splits > MAX_SPLITS || cps < 1 || (splits - 1) * cps >= nk ||
      splits * cps < nk)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = mma_kernel<BITS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(G::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int x_vec = K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int w_vec = N % G::CB == 0 && reinterpret_cast<uintptr_t>(w) % G::CB == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cdiv(N, BN), cdiv(M, BM), splits);
  cfg.blockDim = dim3(MMA_THREADS);
  cfg.dynamicSmemBytes = G::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const bf16*>(x),
                           static_cast<const uint8_t*>(w), static_cast<const float*>(scale),
                           static_cast<float*>(out), M, K, N, cps, x_vec, w_vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BITS>
void launch_gemv(const void* x, const void* w, const void* scale, void* out,
                 int M, int K, int N, cudaStream_t stream) {
  dim3 grid(cdiv(N, GEMV_COLS), cdiv(M, GEMV_MT));
  gemv_kernel<T, BITS><<<grid, GEMV_COLS * GEMV_WARPS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(w),
      static_cast<const float*>(scale), static_cast<float*>(out), M, K, N);
}

template <int BITS>
void launch_tiled(const void* x, const void* w, const void* scale, void* out,
                  int M, int K, int N, cudaStream_t stream) {
  dim3 grid(cdiv(N, TN), cdiv(M, TM));
  tiled_kernel<float, BITS><<<grid, 256, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(w),
      static_cast<const float*>(scale), static_cast<float*>(out), M, K, N);
}

}  // namespace

// x_bf16: 0 -> x is f32, 1 -> bf16. bits: 1 or 2 (checked by the wrapper).
// M <= 16: the gemv path; M > 16: the mma path for bf16 x, with the K split
// (splits, cps: K steps per split) the wrapper planned, else the f32
// tiled path (which ignores splits and cps, as the gemv path does).
extern "C" int packed_matmul_launch(const void* x, int x_bf16, const void* w,
                                    const void* scale, void* out, int M, int K,
                                    int N, int bits, int splits, int cps,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= GEMV_MAX_M) {
    if (x_bf16) {
      if (bits == 1) launch_gemv<__nv_bfloat16, 1>(x, w, scale, out, M, K, N, s);
      else launch_gemv<__nv_bfloat16, 2>(x, w, scale, out, M, K, N, s);
    } else {
      if (bits == 1) launch_gemv<float, 1>(x, w, scale, out, M, K, N, s);
      else launch_gemv<float, 2>(x, w, scale, out, M, K, N, s);
    }
  } else if (x_bf16) {
    return bits == 1 ? launch_mma<1>(x, w, scale, out, M, K, N, splits, cps, s)
                     : launch_mma<2>(x, w, scale, out, M, K, N, splits, cps, s);
  } else {
    if (bits == 1) launch_tiled<1>(x, w, scale, out, M, K, N, s);
    else launch_tiled<2>(x, w, scale, out, M, K, N, s);
  }
  return static_cast<int>(cudaGetLastError());
}
