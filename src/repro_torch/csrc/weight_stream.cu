// Matmul with the weight streamed from device memory through a shared-memory
// ring, K-stage by K-stage: one launch a call.
//
// Replaces the TPU kernel src/repro/kernels/weight_stream.py::stream_matmul
// (_stream_kernel, _decode_chunk):
//   out[m, n] = (sum_k x[m, k] * decode(w)[k, n]) * scale[n]     (f32)
// w is a uint8 carrier (ceil(K*bits/8), N) for bits 1/2, in the pack_bits
// interleave (1-bit codes {0,1} -> {-1,+1}, 2-bit {0,1,2} -> {-1,0,+1}), or
// dense (K, N) bf16/f32 rows for bits 0. scale may be null (no scaling). x
// is f32 or bf16 (M, K) row-major. Any M, K, N.
//
// What bounds it on the H100: it runs the streamed FFN layers of budgeted
// decode, where M is the lane count (<= 16): ~2*M flops per weight, so it
// is bound by moving the weight (2-bit 960x2560: 0.6 MB, 0.18 us at
// 3.35 TB/s; dense bf16: 4.9 MB, 1.47 us) and, below that, by latency: the
// weight's HBM round trip and the launch.
// What the design does about it (the geometry of packed_matmul.cu's GEMV):
//  * filling the card: a block covers one 16-row tile of x (grid y covers
//    the further tiles when M > 16) and 32 output columns, so the weight is
//    read once per tile; where the columns give too few blocks for 132 SMs
//    (30 at N = 960), the K sweep is split over a thread-block cluster of
//    up to 8 blocks (grid z; the plan comes from the wrapper: 80 x 2 = 160
//    blocks at 960x2560, 30 x 5 = 150 at 2560x960).
//  * the ring: a block sweeps its K range in stages of `sk` K values (a
//    multiple of 16, chosen by the wrapper) through a `depth`-slot ring in
//    shared memory (depth = the residency plan's stream_ahead, the paper's
//    R_F, 2..8). A slot holds one stage: its weight rows (carrier rows
//    [sk/PER][32] bytes, or dense rows [sk][WLD]) and the x slice they meet
//    ([16][sk + pad]), filled by 16-byte cp.async copies, one commit group
//    per stage. The wrapper picks sk so that at the decode shapes a split's
//    whole K range fits in `depth` stages, each of at least one 16-deep
//    slab per warp: every weight byte of the block, its x and its scales
//    are requested before the first wait. A longer K range cycles the
//    ring: the slot of stage i takes stage i + depth once it is consumed.
//    Shared memory: max(depth * slot, the warps' partial tiles) + 2.2 KB,
//    slot = sk * (weight bytes per k + 16 x elements) + 256: the ring, not
//    the weight, sets the footprint.
//  * no block barrier in the sweep: each warp owns every 8th 16-deep slab
//    of a slot (the owners rotate from slot to slot, and the stages that
//    share a slot share its owners). A warp copies its own slabs, waits on
//    its own commit groups (cp.async.wait_group, then __syncwarp), consumes
//    each slab as it lands and refills only what it read.
//  * bf16 x against 1/2-bit codes or bf16 rows: tensor cores, mma.sync
//    m16n8k16 with f32 accumulate, one slab at a time. Carrier words are
//    decoded straight into B registers (decode4, byte-permuted into k
//    pairs, as the GEMV does); bf16 rows are read by ldmatrix.trans. bf16 x
//    (-1/0/+1) and bf16 x bf16 products are exact in f32, so the sums
//    differ from the plain version only in order. f32 x, or f32 rows, keep
//    f32 FMAs on the CUDA cores (TF32 or bf16 would round them): lane (rq,
//    cg) of a warp takes the slab's 4-deep K group rq against columns
//    4cg..4cg+3.
//  * split K: the warps' partial tiles meet in shared memory, the splits'
//    in the cluster's distributed shared memory, summed in split order
//    with every remote load in flight before the first add; the scale is
//    applied in that epilogue. One launch, no atomics, the same bits every
//    run.
//  * ragged edges, masked here (nothing is padded on the host): x is zero
//    past M and past the split's end, which keeps a padded 1-bit code
//    (decoding to -1) an exact no-op; weight rows past the split's end are
//    zero-filled (cp.async src-size 0). Where a row pitch or base is not
//    16-byte aligned (e.g. uint8 N = 70), the slabs are filled by element
//    loads instead, through the same ring.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace {

using repro::cdiv;
using bf16 = __nv_bfloat16;

constexpr int MT = 16;          // rows of x per block: one m16 tile
constexpr int BN = 32;          // output columns per block
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CG = BN / 4;      // FMA route: a warp's 8 column groups x 4 K groups
constexpr int MAX_SPLITS = 8;   // the portable cluster size
constexpr int SMEM_MAX = 232448 - 4096;  // dynamic bytes a block may take (static ones beside)

// Weight bytes per K value in a stage: a carrier row of BN bytes holds PER
// K values; a dense row is padded to WLD elements (16-byte rows whose 8
// ldmatrix rows fall on distinct banks).
template <typename WT, int BITS> struct WLayout;
template <int BITS> struct WLayout<uint8_t, BITS> {
  static constexpr int PER = 8 / BITS, LD = BN, K_BYTES = BN / PER;
};
template <> struct WLayout<bf16, 0> { static constexpr int PER = 1, LD = BN + 8, K_BYTES = 2 * LD; };
template <> struct WLayout<float, 0> { static constexpr int PER = 1, LD = BN + 4, K_BYTES = 4 * LD; };

// x slice row stride in elements: 16-byte rows, ldmatrix's 8 rows on
// distinct banks for bf16.
template <typename XT> __host__ __device__ constexpr int x_pad() { return 16 / sizeof(XT); }

template <typename XT, typename WT, int BITS>
__host__ __device__ constexpr int slot_bytes(int sk) {
  return sk * (WLayout<WT, BITS>::K_BYTES + MT * static_cast<int>(sizeof(XT))) +
         MT * x_pad<XT>() * static_cast<int>(sizeof(XT));
}

template <typename XT, typename WT, int BITS>
constexpr bool kTensorCores = std::is_same<XT, bf16>::value && !std::is_same<WT, float>::value;

// the warps' partial tiles, [WARPS][MT][PLD] f32
template <typename XT, typename WT, int BITS>
constexpr int PLD = BN + (kTensorCores<XT, WT, BITS> ? 1 : 0);
template <typename XT, typename WT, int BITS>
constexpr int P_BYTES = 4 * WARPS * MT * PLD<XT, WT, BITS>;

// Wait until at most `pending` of this thread's commit groups are in flight
// (wait_group takes an immediate, and the depth is a run-time value).
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: repro::cp_async_wait<0>(); break;
    case 1: repro::cp_async_wait<1>(); break;
    case 2: repro::cp_async_wait<2>(); break;
    case 3: repro::cp_async_wait<3>(); break;
    case 4: repro::cp_async_wait<4>(); break;
    case 5: repro::cp_async_wait<5>(); break;
    case 6: repro::cp_async_wait<6>(); break;
    default: repro::cp_async_wait<7>(); break;
  }
}

// 4 neighbouring values as f32 (8- or 16-byte aligned in shared memory).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
}
__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <typename T> __device__ __forceinline__ T zero_of() { return T(0); }
template <> __device__ __forceinline__ bf16 zero_of<bf16>() { return __float2bfloat16(0.f); }

// One 16-deep slab (K values [kb, kb + 16), slab `sl` of a stage) into the
// ring slot at `base`, by one warp's 32 lanes: its weight rows, then the x
// slice they meet (rows m0.. of x), each zero past the split's end `ke`
// (and x past M).
template <typename XT, typename WT, int BITS>
__device__ __forceinline__ void load_slab(unsigned char* base, int sk, int sl,
                                           const XT* __restrict__ x, const WT* __restrict__ w,
                                           int M, int K, int N, int m0, int n0, int kb, int ke,
                                           int x_vec, int w_vec, int lane) {
  using L = WLayout<WT, BITS>;
  constexpr int PER = L::PER;
  constexpr int ROWS = 16 / PER;  // storage rows of a slab
  WT* ws = reinterpret_cast<WT*>(base) + sl * ROWS * L::LD;
  XT* xs = reinterpret_cast<XT*>(base + sk * L::K_BYTES) + 16 * sl;
  const int xld = sk + x_pad<XT>();
  const int r0 = kb / PER, r_end = cdiv(ke, PER);
  if (w_vec) {
    constexpr int SEG = 16 / sizeof(WT);  // elements per 16-byte copy
    constexpr int SEGS = BN / SEG;        // copies per row
#pragma unroll
    for (int e = lane; e < ROWS * SEGS; e += 32) {
      const int r = e / SEGS, c = (e % SEGS) * SEG;
      const bool ok = r0 + r < r_end && n0 + c < N;  // N % SEG == 0: all in or all out
      repro::cp_async<16>(ws + r * L::LD + c,
                          ok ? w + static_cast<size_t>(r0 + r) * N + n0 + c : w, ok ? 16 : 0);
    }
  } else {
    for (int e = lane; e < ROWS * BN; e += 32) {
      const int r = e / BN, c = e % BN;
      ws[r * L::LD + c] = r0 + r < r_end && n0 + c < N
                              ? w[static_cast<size_t>(r0 + r) * N + n0 + c]
                              : zero_of<WT>();
    }
  }
  if (x_vec) {
    constexpr int VEC = 16 / sizeof(XT);  // a copy is all in or all out: ke is K or a multiple of 16
    constexpr int SEGS = 16 / VEC;
#pragma unroll
    for (int e = lane; e < MT * SEGS; e += 32) {
      const int m = e / SEGS, v = (e % SEGS) * VEC;
      const bool ok = m0 + m < M && kb + v < ke;
      repro::cp_async<16>(xs + m * xld + v,
                          ok ? x + static_cast<size_t>(m0 + m) * K + kb + v : x, ok ? 16 : 0);
    }
  } else {
    for (int e = lane; e < MT * 16; e += 32) {
      const int m = e / 16, kk = e % 16;
      xs[m * xld + kk] = m0 + m < M && kb + kk < ke ? x[static_cast<size_t>(m0 + m) * K + kb + kk]
                                                    : zero_of<XT>();
    }
  }
}

// The first slab of ring slot `slot` (per_stage slabs) that warp w owns:
// slab s of slot j is warp (s + j * per_stage) % WARPS's, so the stages
// that share a slot share its owners (a warp refills only what it read),
// and the owners rotate from slot to slot when a stage has fewer slabs
// than the block has warps.
__device__ __forceinline__ int first_slab(int slot, int per_stage, int w) {
  return (w - slot * per_stage % WARPS + WARPS) % WARPS;
}

// grid (cdiv(N, BN), cdiv(M, MT), splits), clusters of (1, 1, splits):
// block (bx, by, z) covers columns bx*BN.., rows by*MT.. over K values
// [z*kps, min((z+1)*kps, K)), in stages of sk (kps and sk multiples of 16).
// x_vec: K % (16/sizeof(XT)) == 0 and x 16-byte aligned; w_vec: the weight's
// row pitch a multiple of 16 bytes and its base 16-byte aligned.
// (Without the minimum of 1 block an SM, ptxas caps registers at 64 or 128
// and spills.)
template <typename XT, typename WT, int BITS>
__global__ void __launch_bounds__(THREADS, 1)
stream_kernel(const XT* __restrict__ x, const WT* __restrict__ w,
              const float* __restrict__ scale, float* __restrict__ out,
              int M, int K, int N, int kps, int sk, int depth, int x_vec, int w_vec) {
  using L = WLayout<WT, BITS>;
  constexpr int PER = L::PER;
  constexpr bool TC = kTensorCores<XT, WT, BITS>;
  constexpr int PL = PLD<XT, WT, BITS>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) float bsum[MT * BN];  // this split's partial tile
  __shared__ float ss[BN];                        // the block's scales

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * MT;
  const int k_lo = blockIdx.z * kps, k_hi = min(K, k_lo + kps);  // non-empty by the plan
  const int per_stage = sk / 16;                      // slabs a stage
  const int nst = cdiv(cdiv(k_hi - k_lo, 16), per_stage);
  const int xld = sk + x_pad<XT>();
  const int w_bytes = sk * L::K_BYTES;
  const int slot = slot_bytes<XT, WT, BITS>(sk);
  // the scales are requested first too, so the epilogue waits on no load
  const float sc = tid < BN && n0 + tid < N ? (scale ? __ldg(scale + n0 + tid) : 1.f) : 0.f;

  // Each warp owns every 8th slab of a slot (first_slab): it copies them
  // into the ring, waits on its own commit groups and consumes them, so no
  // block barrier stands between a slab's arrival and its products.
  const int nslab = cdiv(k_hi - k_lo, 16);

  // TC: n8 tile j's accumulator, rows (gq, gq+8); FMA: rows m x columns 4cg+c
  float acc[TC ? 4 : MT][4];
#pragma unroll
  for (int m = 0; m < (TC ? 4 : MT); ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;

  // warm-up: the whole ring requested at once, one group per stage (empty
  // groups included, so the wait count below holds at the tail)
  for (int s = 0; s < depth; ++s) {
    if (s < nst)
      for (int sl = first_slab(s, per_stage, warp); sl < min(per_stage, nslab - s * per_stage);
           sl += WARPS)
        load_slab<XT, WT, BITS>(smem + static_cast<size_t>(s) * slot, sk, sl, x, w, M, K, N, m0,
                                 n0, k_lo + 16 * (s * per_stage + sl), k_hi, x_vec, w_vec, lane);
    repro::cp_async_commit();
  }
  for (int i = 0; i < nst; ++i) {
    cp_async_wait(depth - 1);  // stage i has landed (this lane's copies)
    __syncwarp();              // ... and the warp's
    const unsigned char* base = smem + static_cast<size_t>(i % depth) * slot;
    const WT* ws = reinterpret_cast<const WT*>(base);
    const XT* xs = reinterpret_cast<const XT*>(base + w_bytes);
    for (int s = first_slab(i % depth, per_stage, warp); s < min(per_stage, nslab - i * per_stage);
         s += WARPS) {
      if constexpr (TC) {
        const int gq = lane / 4, tq = lane % 4;
        uint32_t a[4];  // rows past M and K values past the split's end are zeros
        repro::ldmatrix_x4(a, xs + (lane % 16) * xld + 16 * s + (lane / 16) * 8);
        if constexpr (BITS == 0) {
          // k-major bf16 rows: tiles 0-1 from columns 0..15, 2-3 from 16..31
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t b[4];
            repro::load_b_kmajor<L::LD>(b, ws, 16 * s, 16 * h, lane);
            repro::mma_bf16_16816(acc[2 * h], a, b[0], b[1]);
            repro::mma_bf16_16816(acc[2 * h + 1], a, b[2], b[3]);
          }
        } else {
          // B register 0 takes kr = 2t, 2t+1, register 1 kr = 2t+8, 2t+9, of
          // column 4g+j in tile j: codes jc, jc+1 of the bytes of carrier
          // rows (16s+2t)/PER and (16s+2t+8)/PER
          const int jc = (2 * tq) % PER;
          const uint8_t* cs = reinterpret_cast<const uint8_t*>(ws);
          uint32_t b[2][4];  // [register][tile]
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t word = *reinterpret_cast<const uint32_t*>(
                cs + (16 * s + 2 * tq + 8 * h) / PER * BN + 4 * gq);
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
        // lane (rq, cg): the slab's 4-deep K group rq against columns
        // 4cg..4cg+3; x as float4 of 4 K values (the same for the 8 lanes
        // of a group), the weights of each K value as 4 columns (a carrier
        // word decoded to exact f32 -1/0/+1, or a dense row)
        const int cg = lane % CG, q = 4 * s + lane / CG;
        float4 xv[MT];
#pragma unroll
        for (int m = 0; m < MT; ++m) xv[m] = load4(xs + m * xld + 4 * q);
        uint32_t word = 0;
        if constexpr (BITS != 0)
          word = *reinterpret_cast<const uint32_t*>(
              reinterpret_cast<const uint8_t*>(ws) + (4 * q / PER) * BN + 4 * cg);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float4 wv;
          if constexpr (BITS != 0) {
            const uint2 d = repro::decode4<BITS>(word, (4 * q) % PER + jj);
            wv = make_float4(__uint_as_float(d.x << 16), __uint_as_float(d.x & 0xffff0000u),
                             __uint_as_float(d.y << 16), __uint_as_float(d.y & 0xffff0000u));
          } else {
            wv = load4(ws + (4 * q + jj) * L::LD + 4 * cg);
          }
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const float xk = comp(xv[m], jj);
            acc[m][0] = fmaf(xk, wv.x, acc[m][0]);
            acc[m][1] = fmaf(xk, wv.y, acc[m][1]);
            acc[m][2] = fmaf(xk, wv.z, acc[m][2]);
            acc[m][3] = fmaf(xk, wv.w, acc[m][3]);
          }
        }
      }
    }
    if (i + depth < nst) {
      __syncwarp();  // the warp's slabs of the slot are consumed before it refills them
      const int nx = i + depth;  // the stage that takes this slot next
      for (int sl = first_slab(i % depth, per_stage, warp);
           sl < min(per_stage, nslab - nx * per_stage); sl += WARPS)
        load_slab<XT, WT, BITS>(smem + static_cast<size_t>(i % depth) * slot, sk, sl, x, w, M, K,
                                 N, m0, n0, k_lo + 16 * (nx * per_stage + sl), k_hi, x_vec, w_vec,
                                 lane);
    }
    repro::cp_async_commit();
  }

  // each warp's partial tile into shared memory (FMA: its 4 K-group rows
  // first summed by shuffles), then the 8 warps summed in order
  if (tid < BN) ss[tid] = sc;
  __syncthreads();  // the ring is no longer read
  float* part = reinterpret_cast<float*>(smem);  // [WARPS][MT][PL]
  if constexpr (TC) {
    const int gq = lane / 4, tq = lane % 4;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          // bf16 rows: tile j holds columns 8j..; codes: column g of tile j is 4g+j
          const int col = BITS == 0 ? 8 * j + 2 * tq + u : 4 * (2 * tq + u) + j;
          part[(warp * MT + gq + 8 * h) * PL + col] = acc[j][2 * h + u];
        }
  } else {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[m][c] += __shfl_xor_sync(0xffffffffu, acc[m][c], CG);
        acc[m][c] += __shfl_xor_sync(0xffffffffu, acc[m][c], 2 * CG);
      }
    if (lane < CG) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
        *reinterpret_cast<float4*>(part + (warp * MT + m) * PL + 4 * lane) =
            make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    }
  }
  __syncthreads();
  const int splits = static_cast<int>(gridDim.z);
  const int rows = min(MT, M - m0);
  for (int e = tid; e < rows * BN; e += THREADS) {
    const int m = e / BN, c = e % BN;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < WARPS; ++q) s += part[(q * MT + m) * PL + c];
    if (splits > 1) bsum[e] = s;
    else if (n0 + c < N) out[static_cast<size_t>(m0 + m) * N + n0 + c] = s * ss[c];
  }
  if (splits == 1) return;

  // split K: the partial tiles meet in the cluster's shared memory, and
  // each output is summed by one block, in split order
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  cluster.sync();
  const int rank = static_cast<int>(cluster.block_rank());
  for (int e = rank + splits * tid; e < rows * BN; e += splits * THREADS) {
    float p[MAX_SPLITS];  // every remote load in flight before the first add
#pragma unroll
    for (int q = 0; q < MAX_SPLITS; ++q) p[q] = q < splits ? cluster.map_shared_rank(bsum, q)[e] : 0.f;
    float s = p[0];
#pragma unroll
    for (int q = 1; q < MAX_SPLITS; ++q)
      if (q < splits) s += p[q];
    const int m = e / BN, c = e % BN;
    if (n0 + c < N) out[static_cast<size_t>(m0 + m) * N + n0 + c] = s * ss[c];
  }
  cluster.sync();  // no block leaves while another still reads its partial
}

template <typename XT, typename WT, int BITS>
int launch(const void* x, const void* w, const float* scale, float* out, int M, int K, int N,
           int splits, int kps, int sk, int depth, cudaStream_t stream) {
  // every split non-empty, together covering the sweep; whole 16-deep slabs
  if (splits < 1 || splits > MAX_SPLITS || kps < 16 || kps % 16 || sk < 16 || sk % 16 ||
      depth < 2 || depth > 8 || (splits - 1) * kps >= K || splits * kps < K)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t ring = static_cast<size_t>(depth) * slot_bytes<XT, WT, BITS>(sk);
  const size_t smem = ring > P_BYTES<XT, WT, BITS> ? ring : P_BYTES<XT, WT, BITS>;
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = stream_kernel<XT, WT, BITS>;
  static bool opted_in = false;  // once per instantiation: allow > 48 KB
  if (!opted_in) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const int x_vec = K % (16 / sizeof(XT)) == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int w_vec = (N * sizeof(WT)) % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cdiv(N, BN), cdiv(M, MT), splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const XT*>(x), static_cast<const WT*>(w), scale, out, M, K, N, kps,
      sk, depth, x_vec, w_vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT>
int dispatch_w(const void* x, const void* w, int bits, int w_bf16, const float* scale,
               float* out, int M, int K, int N, int splits, int kps, int sk, int depth,
               cudaStream_t s) {
  if (bits == 1) return launch<XT, uint8_t, 1>(x, w, scale, out, M, K, N, splits, kps, sk, depth, s);
  if (bits == 2) return launch<XT, uint8_t, 2>(x, w, scale, out, M, K, N, splits, kps, sk, depth, s);
  if (w_bf16) return launch<XT, bf16, 0>(x, w, scale, out, M, K, N, splits, kps, sk, depth, s);
  return launch<XT, float, 0>(x, w, scale, out, M, K, N, splits, kps, sk, depth, s);
}

}  // namespace

// x_bf16: 0 -> x f32, 1 -> bf16. bits: 1/2 (uint8 carrier) or 0 (dense rows,
// w_bf16 selects bf16 or f32). scale may be null. The K sweep: `splits`
// splits of kps K values, in stages of sk through a depth-slot ring (the
// wrapper's plan; refused here if it does not cover K or overflows shared
// memory).
extern "C" int stream_matmul_launch(const void* x, int x_bf16, const void* w, int bits,
                                    int w_bf16, const void* scale, void* out, int M, int K,
                                    int N, int splits, int kps, int sk, int depth,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(scale);
  float* op = static_cast<float*>(out);
  if (x_bf16) return dispatch_w<bf16>(x, w, bits, w_bf16, sp, op, M, K, N, splits, kps, sk, depth, s);
  return dispatch_w<float>(x, w, bits, w_bf16, sp, op, M, K, N, splits, kps, sk, depth, s);
}
