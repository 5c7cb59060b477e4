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
//  * gemv path (M <= 16): one block covers all M rows (so the carrier is
//    read once) and 32 output columns; where the columns give too few
//    blocks for 132 SMs (30 at N = 960), the K sweep is split over a
//    thread-block cluster of up to 8 blocks (the plan comes from the
//    wrapper), so every decode shape puts >= 132 blocks on the card. A
//    block first requests all of its carrier bytes with 16-byte cp.async
//    copies (byte loads where N % 16 != 0), then its x slice, and only
//    then multiplies. bf16 x: x rows padded with zeros to one m16 tile,
//    each warp takes 16-deep K slabs through mma.sync m16n8k16 (f32
//    accumulate), its lanes decoding carrier words straight into B
//    registers (decode4, byte-permuted into k pairs: exact -1/0/+1). f32 x
//    (which bf16 would round): each thread decodes a 4-column carrier word
//    in registers and reads x as float4 of 4 k values, f32 FMAs on the
//    CUDA cores. The warps' partial tiles meet in shared memory, the
//    splits in split order through distributed shared memory: one launch,
//    no atomics, the same bits every run.
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

#include <type_traits>

#include "common.cuh"

namespace {

using repro::cdiv;
using repro::to_f;
using repro::decode_code;
using bf16 = __nv_bfloat16;

constexpr int MAX_SPLITS = 8;  // the portable cluster size: the most blocks one K split holds

// ---------------- gemv path: M <= 16; bf16 x on the tensor cores, f32 x on the CUDA cores

constexpr int GEMV_MAX_M = 16;
constexpr int GEMV_BN = 32;         // output columns per block, 4 per thread
constexpr int GEMV_BK = 8;          // the plan's K step: every split's K range is a multiple
constexpr int GEMV_THREADS = 256;
constexpr int GEMV_WARPS = GEMV_THREADS / 32;
constexpr int GEMV_CG = GEMV_BN / 4;               // f32: 8 column groups x 32 row groups
constexpr int GEMV_RG = GEMV_THREADS / GEMV_CG;
constexpr int GEMV_KC = 512;        // K values of a split staged at once (a multiple of 16)

// grid (cdiv(N, GEMV_BN), splits), clusters of (1, splits): block (bx, z)
// covers columns bx*GEMV_BN.. of all M <= 16 rows over K values [z*kps,
// min((z+1)*kps, K)), kps a multiple of GEMV_BK, in chunks of GEMV_KC.
// bf16 x: warp w multiplies the chunk's 16-deep K slabs w, w+8,
// .. by mma.sync m16n8k16 (x rows past M are zeros), lane (g, t) decoding
// the carrier word of columns 4g..4g+3 into the B registers of the four
// n8 tiles, tile j holding columns 4g+j. f32 x: thread (rg, cg) owns
// columns 4cg..4cg+3 and the carrier rows rg, rg+GEMV_RG, .. of a chunk,
// f32 FMAs. x_vec: K % (16/sizeof(T)) == 0 and x 16-byte aligned (16-byte
// x copies); w_vec: N % 16 == 0 and the carrier 16-byte aligned (16-byte
// carrier copies).
template <typename T, int BITS>
__global__ void __launch_bounds__(GEMV_THREADS)
gemv_kernel(const T* __restrict__ x, const uint8_t* __restrict__ w,
            const float* __restrict__ scale, float* __restrict__ out,
            int M, int K, int N, int kps, int x_vec, int w_vec) {
  constexpr int PER = 8 / BITS;
  constexpr int MT = GEMV_MAX_M;  // x rows staged, zeros past M (one m16 tile for mma)
  constexpr bool TC = std::is_same<T, bf16>::value;
  constexpr int XLD = GEMV_KC + (TC ? 8 : 4);  // row stride of the staged x, in T: 16-byte
                                               // rows, ldmatrix's 8 rows on distinct banks
  constexpr int PLD = GEMV_BN + (TC ? 1 : 0);  // row stride of a warp's partial tile
  constexpr int X_BYTES = sizeof(T) * MT * XLD;
  constexpr int P_BYTES = 4 * GEMV_WARPS * MT * PLD;
  __shared__ __align__(16) unsigned char xbuf[X_BYTES > P_BYTES ? X_BYTES : P_BYTES];
  __shared__ __align__(16) uint8_t cs[GEMV_KC / PER * GEMV_BN];  // carrier chunk
  __shared__ __align__(16) float bsum[MT * GEMV_BN];            // this split's partial tile
  __shared__ float ss[GEMV_BN];                                  // the block's scales
  T* xs = reinterpret_cast<T*>(xbuf);  // x chunk [MT][XLD], zeros past M
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n0 = blockIdx.x * GEMV_BN;
  const int k_lo = blockIdx.y * kps, k_hi = min(K, k_lo + kps);  // non-empty by the plan
  // the scales are requested first too, so the epilogue waits on no load
  const float sc = tid < GEMV_BN && n0 + tid < N ? __ldg(scale + n0 + tid) : 0.f;
  // TC: n8 tile j's accumulator, rows (gq, gq+8) x columns 4*(2tq+u)+j;
  // f32: rows m x columns 4cg+c
  float acc[TC ? 4 : MT][4];
#pragma unroll
  for (int m = 0; m < (TC ? 4 : MT); ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;

  // One chunk at the decode shapes (a split's K <= GEMV_KC): every carrier
  // byte of the block is requested before x, and both before the first
  // product.
  for (int k0 = k_lo; k0 < k_hi; k0 += GEMV_KC) {
    const int rows = min(GEMV_KC, k_hi - k0) / PER;  // K, kps and k0 are multiples of PER
    const int r0 = k0 / PER, kc = rows * PER;
    if (k0 != k_lo) __syncthreads();  // the previous chunk is consumed
    if (w_vec) {
      for (int s = tid; s < rows * (GEMV_BN / 16); s += GEMV_THREADS) {
        const int r = s / (GEMV_BN / 16), c = (s % (GEMV_BN / 16)) * 16;
        const bool ok = n0 + c < N;  // N % 16 == 0: all 16 columns in or all out
        repro::cp_async<16>(cs + r * GEMV_BN + c,
                            ok ? w + static_cast<size_t>(r0 + r) * N + n0 + c : w, ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < rows * GEMV_BN; e += GEMV_THREADS) {
        const int r = e / GEMV_BN, c = e % GEMV_BN;
        cs[e] = n0 + c < N ? __ldg(w + static_cast<size_t>(r0 + r) * N + n0 + c) : 0;
      }
    }
    // x as T, zeros past M and, for mma, past kc up to the last 16-deep slab
    const int kp = TC ? (kc + 15) / 16 * 16 : kc;
    if (x_vec) {
      constexpr int VEC = 16 / sizeof(T);  // kc % VEC == 0: K, GEMV_BK and PER are
      for (int e = tid; e < MT * (kp / VEC); e += GEMV_THREADS) {
        const int m = e / (kp / VEC), v = (e % (kp / VEC)) * VEC;
        const bool ok = m < M && v < kc;
        repro::cp_async<16>(xs + m * XLD + v, ok ? x + static_cast<size_t>(m) * K + k0 + v : x,
                            ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < MT * kp; e += GEMV_THREADS) {
        const int m = e / kp, kk = e % kp;
        xs[m * XLD + kk] = m < M && kk < kc ? x[static_cast<size_t>(m) * K + k0 + kk]
                                            : repro::from_f<T>(0.f);
      }
    }
    repro::cp_async_commit();
    repro::cp_async_wait<0>();
    __syncthreads();

    if constexpr (TC) {
      // slab s holds k = 16s + kr: B register 0 takes kr = 2t, 2t+1, register
      // 1 kr = 2t+8, 2t+9, of column 4g+j in tile j: codes jc, jc+1 of the
      // bytes of carrier rows (16s+2t)/PER and (16s+2t+8)/PER
      const int gq = lane / 4, tq = lane % 4;
      const int jc = (2 * tq) % PER;
      for (int s = warp; s < (kc + 15) / 16; s += GEMV_WARPS) {
        uint32_t a[4];
        repro::load_a<XLD>(a, xs, 0, 16 * s, lane);
        uint32_t b[2][4];  // [register][tile]
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // rows past the chunk meet x's zeros
          const uint32_t word = *reinterpret_cast<const uint32_t*>(
              cs + (16 * s + 2 * tq + 8 * h) / PER * GEMV_BN + 4 * gq);
          const uint2 lo = repro::decode4<BITS>(word, jc), hi = repro::decode4<BITS>(word, jc + 1);
          b[h][0] = __byte_perm(lo.x, hi.x, 0x5410);
          b[h][1] = __byte_perm(lo.x, hi.x, 0x7632);
          b[h][2] = __byte_perm(lo.y, hi.y, 0x5410);
          b[h][3] = __byte_perm(lo.y, hi.y, 0x7632);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) repro::mma_bf16_16816(acc[j], a, b[0][j], b[1][j]);
      }
    } else {
      // each carrier word is 4 columns of one row: weight j of its bytes is
      // k = r*PER + j, decoded to exact f32 -1/0/+1 (via their bf16 bits);
      // x comes as float4 of 4 k values, the same for the 8 threads of a row
      const int cg = tid % GEMV_CG, rg = tid / GEMV_CG;
      for (int r = rg; r < rows; r += GEMV_RG) {
        const uint32_t word = *reinterpret_cast<const uint32_t*>(cs + r * GEMV_BN + 4 * cg);
#pragma unroll
        for (int q = 0; q < PER / 4; ++q) {
          float4 xv[MT];
#pragma unroll
          for (int m = 0; m < MT; ++m)
            xv[m] = *reinterpret_cast<const float4*>(xs + m * XLD + r * PER + 4 * q);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const uint2 d = repro::decode4<BITS>(word, 4 * q + jj);
            const float wv[4] = {__uint_as_float(d.x << 16), __uint_as_float(d.x & 0xffff0000u),
                                 __uint_as_float(d.y << 16), __uint_as_float(d.y & 0xffff0000u)};
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              const float xk = jj == 0 ? xv[m].x : jj == 1 ? xv[m].y : jj == 2 ? xv[m].z : xv[m].w;
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[m][c] = fmaf(xk, wv[c], acc[m][c]);
            }
          }
        }
      }
    }
  }

  // each warp's partial tile into shared memory (f32: its 4 row groups
  // first summed by shuffles), then the 8 warps summed in order
  if (tid < GEMV_BN) ss[tid] = sc;
  __syncthreads();  // x's buffer is no longer read
  float* part = reinterpret_cast<float*>(xbuf);  // [GEMV_WARPS][MT][PLD]
  if constexpr (TC) {
    const int gq = lane / 4, tq = lane % 4;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int u = 0; u < 2; ++u)
          part[(warp * MT + gq + 8 * h) * PLD + 4 * (2 * tq + u) + j] = acc[j][2 * h + u];
  } else {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[m][c] += __shfl_xor_sync(0xffffffffu, acc[m][c], GEMV_CG);
        acc[m][c] += __shfl_xor_sync(0xffffffffu, acc[m][c], 2 * GEMV_CG);
      }
    if (lane < GEMV_CG) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
        *reinterpret_cast<float4*>(part + (warp * MT + m) * PLD + 4 * lane) =
            make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    }
  }
  __syncthreads();
  const int splits = static_cast<int>(gridDim.y);
  for (int e = tid; e < M * GEMV_BN; e += GEMV_THREADS) {
    const int m = e / GEMV_BN, c = e % GEMV_BN;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < GEMV_WARPS; ++q) s += part[(q * MT + m) * PLD + c];
    if (splits > 1) bsum[e] = s;
    else if (n0 + c < N) out[static_cast<size_t>(m) * N + n0 + c] = s * ss[c];
  }
  if (splits == 1) return;

  // split K: the partial tiles meet in the cluster's shared memory, and
  // each output is summed by one block, in split order
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  cluster.sync();
  const int rank = static_cast<int>(cluster.block_rank());
  for (int e = rank + splits * tid; e < M * GEMV_BN; e += splits * GEMV_THREADS) {
    float p[MAX_SPLITS];  // every remote load in flight before the first add
#pragma unroll
    for (int q = 0; q < MAX_SPLITS; ++q) p[q] = q < splits ? cluster.map_shared_rank(bsum, q)[e] : 0.f;
    float s = p[0];
#pragma unroll
    for (int q = 1; q < MAX_SPLITS; ++q)
      if (q < splits) s += p[q];
    const int m = e / GEMV_BN, c = e % GEMV_BN;
    if (n0 + c < N) out[static_cast<size_t>(m) * N + n0 + c] = s * ss[c];
  }
  cluster.sync();  // no block leaves while another still reads its partial
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

constexpr int BM = 64, BN = 128, BK = 64;  // block tile and K step
constexpr int MMA_THREADS = 256;            // 8 warps: 2 (M) x 4 (N) of 32x32
constexpr int STAGES = 3;                   // x / carrier ring
constexpr int XLD = BK + 8;                 // padded row strides in bf16, so the 8
constexpr int WLD = BN + 8;                 // rows of an ldmatrix hit distinct banks
constexpr int PLD = BN + 4;                 // row stride of a split's f32 partial tile

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

// cps: the plan's K steps of GEMV_BK per split
template <typename T, int BITS>
int launch_gemv(const void* x, const void* w, const void* scale, void* out, int M, int K,
                int N, int splits, int cps, cudaStream_t stream) {
  const int kps = cps * GEMV_BK;
  // every split non-empty, together covering the sweep
  if (splits < 1 || splits > MAX_SPLITS || cps < 1 || (splits - 1) * kps >= K || splits * kps < K)
    return static_cast<int>(cudaErrorInvalidValue);
  const int x_vec = K % (16 / sizeof(T)) == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int w_vec = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cdiv(N, GEMV_BN), splits);
  cfg.blockDim = dim3(GEMV_THREADS);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, gemv_kernel<T, BITS>, static_cast<const T*>(x),
                                       static_cast<const uint8_t*>(w),
                                       static_cast<const float*>(scale), static_cast<float*>(out),
                                       M, K, N, kps, x_vec, w_vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
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
// M <= 16: the gemv path, M > 16: the mma path for bf16 x, each with the K
// split (splits, cps: K steps per split, of GEMV_BK or BK values) the
// wrapper planned; else the f32 tiled path, which ignores splits and cps.
extern "C" int packed_matmul_launch(const void* x, int x_bf16, const void* w,
                                    const void* scale, void* out, int M, int K,
                                    int N, int bits, int splits, int cps,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= GEMV_MAX_M) {
    if (x_bf16)
      return bits == 1 ? launch_gemv<bf16, 1>(x, w, scale, out, M, K, N, splits, cps, s)
                       : launch_gemv<bf16, 2>(x, w, scale, out, M, K, N, splits, cps, s);
    return bits == 1 ? launch_gemv<float, 1>(x, w, scale, out, M, K, N, splits, cps, s)
                     : launch_gemv<float, 2>(x, w, scale, out, M, K, N, splits, cps, s);
  } else if (x_bf16) {
    return bits == 1 ? launch_mma<1>(x, w, scale, out, M, K, N, splits, cps, s)
                     : launch_mma<2>(x, w, scale, out, M, K, N, splits, cps, s);
  } else {
    if (bits == 1) launch_tiled<1>(x, w, scale, out, M, K, N, s);
    else launch_tiled<2>(x, w, scale, out, M, K, N, s);
  }
  return static_cast<int>(cudaGetLastError());
}
