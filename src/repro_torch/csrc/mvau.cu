// Fused MVAU on the tensor cores: matmul against bit-packed 1/2-bit
// weights with the streamlined BN + activation as a multi-threshold
// epilogue.
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
// What bounds it on the H100: CNV's layers at batch 256 run from conv1
// (M = 200704, K = 576, N = 64: 462 MB of f32 columns, 0.14 ms of bytes)
// to conv5, fc0 and fc1 (M = 256: a few MB, and 2-8 output tiles of any
// reasonable size for 132 SMs). The wide layers' least time is the bytes
// of x, once the multiply is off the CUDA cores; the narrow ones are
// bound by how many SMs the K sweep can be spread over. On the tensor
// cores the three passes, the split and the decode are bound by each SM's
// instruction throughput, which sets conv1-3's time above their bytes.
//
// What the design does:
// * Tensor cores on an exact split of x. Each thread reads its mma A
//   fragment of x from the f32 shared tile and splits every value into
//   three bf16 parts, hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi -
//   mid): each difference is exact in f32 and 3 x 8 significand bits cover
//   f32's 24, so hi + mid + lo == x for every normal x. The decoded weights
//   -1/0/+1 are exact in bf16, so every product of the three mma.sync
//   m16n8k16 passes (bf16 in, f32 accumulate) is exact. Each pass keeps
//   its own accumulator and the three are added once, (hi + mid) + lo, in
//   the epilogue: on CNV's columns (2-bit levels -2..1 times a scale s)
//   hi(level * s) = level * hi(s), so every partial sum of a pass is a
//   multiple of one power of two below 2^21 of it, exact in f32 whatever
//   order or alignment the tensor cores add in. What remains against the
//   reference's f32 dot is the final two additions' rounding, inside the
//   tie tolerance the checks already allow. (TF32, or bf16(x) alone, would
//   drop x's low bits and flip levels away from ties.)
// * A 3-stage cp.async ring carries x (16-byte copies where K % 4 == 0,
//   else 4-byte ones) and the step's carrier bytes. Each thread decodes the
//   carrier bytes it copied (common.cuh's byte-permute lookups, exact) into
//   a double-buffered k-major bf16 tile that ldmatrix.trans reads as B
//   fragments: one __syncthreads a K step, the decode of step t+1 beside
//   the products of step t.
// * 64 x 64 output tiles, 4 warps of 16 rows x 64 columns, so each value
//   of x is split by one warp only. K steps of 32 keep a block's shared
//   memory near 45 KB, so three blocks share an SM: the split and the
//   mma.sync instructions, not the ring's depth, set the time at conv1-3, and
//   more warps hide more of it. Where the output has too few tiles for
//   the SMs (conv5, fc0, fc1), the K sweep is split over a thread-block
//   cluster of at most 8 blocks (the plan comes from the wrapper); each
//   block adds its three passes, the partial tiles are summed in split
//   order through distributed shared memory, and each block thresholds its
//   share of the rows. The f32 accumulator never reaches device memory (the
//   point of the TPU kernel), each layer is one launch, and the same inputs
//   give the same bits every run.
// * The epilogue multiplies by the column's sign, counts the thresholds it
//   reaches (staged once per block in shared memory) and writes int32
//   levels.
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using repro::cdiv;

constexpr int BM = 64, BN = 64, BK = 32;  // output tile and K step
constexpr int THREADS = 128;              // 4 warps, each 16 rows x BN columns
constexpr int NT = BN / 8;                // n8 tiles per warp
constexpr int STAGES = 3;                 // x / carrier ring: step t+2 loads while step t is read
static_assert(STAGES >= 3, "the ring loads two steps ahead");
// Row strides: XLD (f32) puts the float2 A-fragment reads of a half-warp
// (rows g = 0..3 at +8 banks each, columns 2t, 2t+1) on 32 distinct banks;
// WLD (bf16) puts the 8 rows of an ldmatrix matrix in distinct banks.
constexpr int XLD = BK + 8;
constexpr int WLD = BN + 8;
constexpr int PLD = BN + 4;               // row stride of a split's f32 partial tile
constexpr int MAX_SPLITS = 8;             // the portable cluster size
constexpr int MAX_L = 15;                 // 4-bit activations: 2^4 - 1 thresholds

template <int BITS>
struct Geom {
  static constexpr int PER = 8 / BITS;
  static constexpr int CROWS = BK / PER;              // carrier rows per K step
  // carrier bytes a copying thread copies (4 or 8), and the threads that
  // copy (and decode) the step's carrier
  static constexpr int CB = CROWS * BN >= 4 * THREADS ? CROWS * BN / THREADS : 4;
  static constexpr int CT = CROWS * BN / CB;
  static constexpr size_t X_BYTES = sizeof(float) * STAGES * BM * XLD;
  static constexpr size_t C_BYTES = STAGES * CROWS * BN;
  static constexpr size_t W_BYTES = sizeof(bf16) * 2 * BK * WLD;
  static constexpr size_t SMEM = X_BYTES + C_BYTES + W_BYTES;
  static_assert(sizeof(float) * BM * PLD <= X_BYTES, "the partial tile reuses the x ring");
};

// Two f32 values as three bf16x2 registers hi, mid, lo with hi + mid + lo
// == the values (see the note above); the first value in the low halves.
__device__ __forceinline__ void split3(float2 v, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  hi = repro::pack_bf16x2(v.x, v.y);
  const float r0 = v.x - __uint_as_float(hi << 16);
  const float r1 = v.y - __uint_as_float(hi & 0xffff0000u);
  mid = repro::pack_bf16x2(r0, r1);
  lo = repro::pack_bf16x2(r0 - __uint_as_float(mid << 16), r1 - __uint_as_float(mid & 0xffff0000u));
}

// grid (cdiv(M, BM), cdiv(N, BN), splits), clusters of (1, 1, splits):
// split z sweeps K steps [z*cps, min((z+1)*cps, nk)). x_vec: K % 4 == 0 and
// x 16-byte aligned; w_vec: N and the carrier aligned to the per-thread
// copy (carrier rows by cp.async, else by plain loads).
template <int BITS>
__global__ void __launch_bounds__(THREADS)
mvau_kernel(const float* __restrict__ x, const uint8_t* __restrict__ w,
            const float* __restrict__ thr, const float* __restrict__ sign,
            int* __restrict__ out, int M, int K, int N, int L, int offset, int cps,
            int x_vec, int w_vec) {
  using G = Geom<BITS>;
  constexpr int PER = G::PER, CROWS = G::CROWS, CB = G::CB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);                          // [STAGES][BM][XLD]
  uint8_t* cs = smem_raw + G::X_BYTES;                                     // [STAGES][CROWS][BN]
  bf16* ws = reinterpret_cast<bf16*>(smem_raw + G::X_BYTES + G::C_BYTES);  // [2][BK][WLD]
  __shared__ float ts[BN][MAX_L];  // the block's thresholds
  __shared__ float sg[BN];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4, tq = lane % 4;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nk = cdiv(K, BK);
  const int t0 = blockIdx.z * cps;
  const int ns = min(cps, nk - t0);  // >= 1 by the plan
  const int krows = cdiv(K, PER);    // carrier rows
  // this thread's carrier copy (tid < CT): row cr of a step, columns cc .. cc+CB-1
  const int cr = tid / (BN / CB), cc = (tid % (BN / CB)) * CB;

  for (int e = tid; e < BN * L; e += THREADS) {
    const int nn = e / L, l = e % L, n = n0 + nn;
    ts[nn][l] = n < N ? thr[static_cast<size_t>(n) * L + l] : 0.f;
  }
  for (int nn = tid; nn < BN; nn += THREADS) sg[nn] = n0 + nn < N ? sign[n0 + nn] : 1.f;

  auto load_step = [&](int t) {  // local step t into ring stage t % STAGES
    const int k0 = (t0 + t) * BK;
    float* xd = xs + (t % STAGES) * BM * XLD;
#pragma unroll
    for (int i = 0; i < BM * BK / 4 / THREADS; ++i) {  // chunks of 4 floats
      const int c = tid + i * THREADS;
      const int r = c / (BK / 4), kc = (c % (BK / 4)) * 4;
      const int m = m0 + r, k = k0 + kc;
      float* dst = xd + r * XLD + kc;
      if (x_vec) {
        const bool ok = m < M && k < K;  // K % 4 == 0: all four in or all out
        repro::cp_async<16>(dst, ok ? x + static_cast<size_t>(m) * K + k : x, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = m < M && k + e < K;
          repro::cp_async<4>(dst + e, ok ? x + static_cast<size_t>(m) * K + k + e : x, ok ? 4 : 0);
        }
      }
    }
    if (tid >= G::CT) return;
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
    if (tid >= G::CT) return;
    repro::decode_bytes<BITS, CB>(cs + (t % STAGES) * CROWS * BN + cr * BN + cc,
                                  ws + (t & 1) * BK * WLD + cr * PER * WLD + cc, WLD);
  };

  // acc[p]: pass p (hi, mid, lo); acc[p][j] is n8 tile j of the warp's 16
  // rows in the mma d layout: [0], [1] row g, columns 8j + 2t, 8j + 2t + 1;
  // [2], [3] row g + 8, the same columns
  float acc[3][NT][4];
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[p][j][0] = acc[p][j][1] = acc[p][j][2] = acc[p][j][3] = 0.f;

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
    // this thread's A-fragment source: row g of the warp's 16, columns 2t..
    const float* xst = xs + (t % STAGES) * BM * XLD + (warp * 16 + gq) * XLD + 2 * tq;
    const bf16* wst = ws + (t & 1) * BK * WLD;
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      // a[p][r]: A register r of pass p; register r holds row g (+8 if r is
      // odd), columns 2t, 2t+1 (+8 if r >= 2) of this k16 chunk
      uint32_t a[3][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 v =
            *reinterpret_cast<const float2*>(xst + (r & 1) * 8 * XLD + kc * 16 + (r >> 1) * 8);
        split3(v, a[0][r], a[1][r], a[2][r]);
      }
      uint32_t b[NT / 2][4];  // b[jp]: b0/b1 of n-tiles 2jp and 2jp+1 (k-major tile)
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp)
        repro::load_b_kmajor<WLD>(b[jp], wst, kc * 16, jp * 16, lane);
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          repro::mma_bf16_16816(acc[p][j], a[p], b[j / 2][(j % 2) * 2], b[j / 2][(j % 2) * 2 + 1]);
    }
  }
  repro::cp_async_wait<0>();

  auto level = [&](float v, int nn) {  // column nn of the tile
    v *= sg[nn];
    int c = offset;
    for (int l = 0; l < L; ++l) c += v >= ts[nn][l];
    return c;
  };
  auto value = [&](int j, int e) { return (acc[0][j][e] + acc[1][j][e]) + acc[2][j][e]; };

  if (gridDim.z == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + warp * 16 + gq + 8 * h;
      if (m >= M) continue;
      int* orow = out + static_cast<size_t>(m) * N;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int nn = j * 8 + 2 * tq, n = n0 + nn;
        const int lv0 = level(value(j, 2 * h), nn), lv1 = level(value(j, 2 * h + 1), nn + 1);
        if (n + 1 < N && N % 2 == 0) {
          *reinterpret_cast<int2*>(orow + n) = make_int2(lv0, lv1);
        } else {
          if (n < N) orow[n] = lv0;
          if (n + 1 < N) orow[n + 1] = lv1;
        }
      }
    }
    return;
  }

  // split K: each block's partial tile (its three passes added) meets the
  // others' in the cluster's shared memory; block r sums and thresholds
  // rows [r*rows, ...) in split order
  cg::cluster_group cluster = cg::this_cluster();
  __syncthreads();  // the ring is no longer read
  float* part = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int r = warp * 16 + gq + 8 * h, c = j * 8 + 2 * tq;
      *reinterpret_cast<float2*>(part + r * PLD + c) =
          make_float2(value(j, 2 * h), value(j, 2 * h + 1));
    }
  cluster.sync();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int rows = cdiv(BM, splits);
  const int r_lo = rank * rows, r_hi = min(BM, r_lo + rows);
  for (int e = tid; e < (r_hi - r_lo) * (BN / 4); e += THREADS) {
    const int r = r_lo + e / (BN / 4), c = (e % (BN / 4)) * 4;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < splits; ++q) {
      const float4 p =
          *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, q) + r * PLD + c);
      sum.x += p.x; sum.y += p.y; sum.z += p.z; sum.w += p.w;
    }
    const int m = m0 + r;
    if (m >= M) continue;
    const float v[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (n0 + c + u < N) out[static_cast<size_t>(m) * N + n0 + c + u] = level(v[u], c + u);
  }
  cluster.sync();  // no block leaves while another still reads its partial
}

template <int BITS>
int launch(const void* x, const void* w, const void* thr, const void* sign, void* out,
           int M, int K, int N, int L, int offset, int splits, int cps, cudaStream_t stream) {
  using G = Geom<BITS>;
  const int nk = cdiv(K, BK);
  // every split non-empty, together covering the sweep
  if (splits < 1 || splits > MAX_SPLITS || cps < 1 || (splits - 1) * cps >= nk ||
      splits * cps < nk)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = mvau_kernel<BITS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(G::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int x_vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int w_vec = N % G::CB == 0 && reinterpret_cast<uintptr_t>(w) % G::CB == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cdiv(M, BM), cdiv(N, BN), splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = G::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const float*>(x),
                           static_cast<const uint8_t*>(w), static_cast<const float*>(thr),
                           static_cast<const float*>(sign), static_cast<int*>(out), M, K, N, L,
                           offset, cps, x_vec, w_vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bits: 1 or 2; 1 <= L <= 15; the K split (splits, cps: K steps of BK per
// split) the wrapper planned. out must be 8-byte aligned (a fresh
// allocation is).
extern "C" int mvau_launch(const void* x, const void* w, const void* thr,
                           const void* sign, void* out, int M, int K, int N,
                           int L, int offset, int bits, int splits, int cps,
                           void* stream) {
  if (L < 1 || L > MAX_L || (bits != 1 && bits != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bits == 1 ? launch<1>(x, w, thr, sign, out, M, K, N, L, offset, splits, cps, s)
                   : launch<2>(x, w, thr, sign, out, M, K, N, L, offset, splits, cps, s);
}
