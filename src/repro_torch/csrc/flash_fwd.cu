// Online-softmax attention forward (flash attention), two routes.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_fwd
// (_fwd_kernel). q: (BH, Sq, D); k, v: (BKV, Sk, D), BH % BKV == 0; q row
// bh reads kv row bh / g (g = BH / BKV: GQA without replicating K/V).
// Query i sits at position q_offset + i; key j at position j. q_offset is
// a kernel argument, or, when q_offset_dev is not null, the int32 it points
// to on the device, read by every block before anything else: one launch
// configuration (the grid depends on Sq only) then serves every offset, so
// a captured CUDA graph replays at any offset written into that int. A key is
// visible if (!causal || q_pos >= k_pos) and (window <= 0 ||
// q_pos - k_pos < window). Writes out (BH, Sq, D) in q's dtype and the f32
// log-sum-exp lse (BH, Sq); a row that sees no key gets out 0, lse -1e30.
// Any Sq and Sk are handled by masking in the kernel; D is 32, 64, 80 or
// 128.
//
// What bounds it on the H100: at the serve path's shapes (Sq = Sk = 512,
// D = 64, 15 heads) it moves ~0.4 MB and does ~0.5 GFLOP, so it is bound
// by operations, and only the tensor cores reach that bound.
//
// bf16 route (flash_fwd_mma_kernel), what the design does: one block of 4
// warps per (bh, 64-query tile), each warp owning 16 query rows. The Q
// tile's mma A fragments are read once with ldmatrix and held in
// registers for the whole key sweep. K/V tiles of 64 keys go through a
// 2-stage cp.async ring (the next tile loads while this one is used).
// S = Q K^T is mma.sync m16n8k16 (bf16 in, f32 accumulate); the mask is
// applied only on tiles that straddle the causal, window or Sk edge, and
// tiles it hides completely are never loaded. The online softmax runs on
// the accumulator fragments (row max over the quad with __shfl_xor_sync,
// one rescale of O per tile); P is rounded to bf16 in registers, where the
// m16n8 accumulator layout is already the A fragment of the PV product, so
// P never touches shared memory (rounding P before PV is the reference's
// own arithmetic: p.astype(v.dtype)). V is read with ldmatrix.trans; O
// stays in f32 registers until out = O / l is written in bf16.
//
// f32 route (flash_fwd_kernel): the CUDA-core kernel, one thread per query
// row over K/V tiles staged in shared memory, f32 throughout (the tensor
// cores would round q, k and v).
#include <math_constants.h>

#include "common.cuh"

namespace {

using repro::cdiv;
using repro::from_f;
using repro::to_f;

constexpr int BQ = 64;  // query rows per block (one per thread)
constexpr int BK = 64;  // keys per shared-memory tile
constexpr float NEG_INF = -1e30f;

template <int D, typename T>
constexpr size_t smem_bytes() {
  return sizeof(float) * BQ * (D + 1)      // q tile (padded rows: no bank conflicts)
         + sizeof(T) * 2 * BK * D          // k and v tiles
         + sizeof(float) * BQ * (BK + 1);  // each row's scores for one tile
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int sk, int causal,
                                        int window) {
  return kpos < sk && (!causal || qpos >= kpos) && (window <= 0 || qpos - kpos < window);
}

template <typename T, int D>
__global__ void __launch_bounds__(BQ)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Sk, int g, int causal,
                 int window, int q_offset, const int* __restrict__ q_offset_dev,
                 float scale) {
  if (q_offset_dev != nullptr) q_offset = *q_offset_dev;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  T* ks = reinterpret_cast<T*>(qs + BQ * (D + 1));
  T* vs = ks + BK * D;
  float* ps = reinterpret_cast<float*>(vs + BK * D);

  const int t = threadIdx.x;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const T* qb = q + static_cast<size_t>(bh) * Sq * D;
  const T* kb = k + static_cast<size_t>(bh / g) * Sk * D;
  const T* vb = v + static_cast<size_t>(bh / g) * Sk * D;

  for (int e = t; e < BQ * D; e += BQ) {
    const int r = e / D, d = e % D;
    qs[r * (D + 1) + d] = (q0 + r < Sq) ? to_f(qb[static_cast<size_t>(q0 + r) * D + d]) : 0.f;
  }

  const int qi = q0 + t;
  const bool row_ok = qi < Sq;
  const int qpos = q_offset + qi;
  // key range any row of this block can see: fully masked tiles are skipped
  const int q_lo = q_offset + q0;
  const int q_hi = q_offset + min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_hi + 1) : Sk;
  const int k_begin = window > 0 ? (max(0, q_lo - window + 1) / BK) * BK : 0;

  float m = NEG_INF, l = 0.f;
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  const float* qrow = qs + t * (D + 1);
  float* prow = ps + t * (BK + 1);

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // q tile written / previous K/V tile consumed
    for (int e = t; e < BK * D; e += BQ) {
      const int r = e / D;
      const bool in = k0 + r < Sk;
      const size_t off = static_cast<size_t>(k0) * D + e;
      ks[e] = in ? kb[off] : from_f<T>(0.f);
      vs[e] = in ? vb[off] : from_f<T>(0.f);
    }
    __syncthreads();
    if (!row_ok) continue;
    float tile_max = NEG_INF;
    for (int j = 0; j < BK; ++j) {
      float s = NEG_INF;
      if (visible(qpos, k0 + j, Sk, causal, window)) {
        const T* krow = ks + j * D;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) dot += qrow[d] * to_f(krow[d]);
        s = dot * scale;
      }
      prow[j] = s;
      tile_max = fmaxf(tile_max, s);
    }
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= corr;
    for (int j = 0; j < BK; ++j) {
      if (!visible(qpos, k0 + j, Sk, causal, window)) continue;
      const float p = expf(prow[j] - m_new);
      l += p;
      const T* vrow = vs + j * D;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] += p * to_f(vrow[d]);
    }
    m = m_new;
  }
  if (!row_ok) return;
  const float ll = fmaxf(l, 1e-30f);
  T* orow = out + (static_cast<size_t>(bh) * Sq + qi) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) orow[d] = from_f<T>(acc[d] / ll);
  lse[static_cast<size_t>(bh) * Sq + qi] = m + logf(ll);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int BH, int Sq, int Sk, int g, int causal, int window, int q_offset,
           const int* q_offset_dev, float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D, T>();
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(cdiv(Sq, BQ), BH);
  kern<<<grid, BQ, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), Sq, Sk, g, causal, window,
      q_offset, q_offset_dev, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------- bf16 route: tensor cores ----------------

using bf16 = __nv_bfloat16;
constexpr int MQ = 64;           // query rows per block: 4 warps x 16
constexpr int MK = 64;           // keys per K/V tile
constexpr int MMA_THREADS = 128;
constexpr float LOG2E = 1.4426950408889634f;

// Row stride of the shared tiles, in bf16: 16 bytes of padding, so the 8
// rows one ldmatrix matrix reads fall in distinct banks. The rows are
// 16 * (D / 8 + 1) bytes apart; D / 8 + 1 is odd at every D taken (5, 9,
// 11, 17), so 8 consecutive rows start at 8 distinct 16-byte offsets of
// the 128-byte bank window.
template <int D> __host__ __device__ constexpr int ld() { return D + 8; }

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * ld<D>() * (MQ + 2 * 2 * MK);  // q tile, 2 stages of k and v
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     float* __restrict__ lse, int Sq, int Sk, int g, int causal,
                     int window, int q_offset, const int* __restrict__ q_offset_dev,
                     float scale) {
  if (q_offset_dev != nullptr) q_offset = *q_offset_dev;
  constexpr int LD = ld<D>();
  constexpr int NT = MK / 8;   // n8 tiles of S per warp
  constexpr int DT = D / 8;    // n8 tiles of O per warp
  constexpr int KC = D / 16;   // k16 steps of QK^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + MQ * LD;       // [2][MK][LD]
  bf16* vs = ks + 2 * MK * LD;   // [2][MK][LD]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4, tq = lane % 4;
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * MQ;  // longest causal rows first
  const bf16* qb = q + static_cast<size_t>(bh) * Sq * D;
  const bf16* kb = k + static_cast<size_t>(bh / g) * Sk * D;
  const bf16* vb = v + static_cast<size_t>(bh / g) * Sk * D;

  // key range any row of this block can see: fully masked tiles are skipped
  const int q_lo = q_offset + q0;
  const int q_hi = q_offset + min(q0 + MQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_hi + 1) : Sk;
  const int k_begin = window > 0 ? (max(0, q_lo - window + 1) / MK) * MK : 0;
  const int n_tiles = k_end > k_begin ? cdiv(k_end - k_begin, MK) : 0;

  repro::load_rows_async<D, LD, MQ, MMA_THREADS>(qs, qb, q0, Sq, tid);
  repro::cp_async_commit();
  if (n_tiles > 0) {
    repro::load_rows_async<D, LD, MK, MMA_THREADS>(ks, kb, k_begin, Sk, tid);
    repro::load_rows_async<D, LD, MK, MMA_THREADS>(vs, vb, k_begin, Sk, tid);
  }
  repro::cp_async_commit();
  repro::cp_async_wait<1>();  // q landed (the first K/V tile may not have)
  __syncthreads();

  // this thread's two rows (g and g + 8 of the warp's 16), as positions
  const int row0 = q0 + warp * 16 + gq;
  const int pos[2] = {q_offset + row0, q_offset + row0 + 8};
  uint32_t qf[KC][4];  // A fragments of the warp's 16 rows, for the whole sweep
#pragma unroll
  for (int c = 0; c < KC; ++c)
    repro::ldmatrix_x4(qf[c], qs + (warp * 16 + lane % 16) * LD + c * 16 + (lane / 16) * 8);
  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};  // running max, finite: exp(-inf - m) = 0
  float l_r[2] = {0.f, 0.f};          // this lane's share of the row sums
  const float scale_log2 = scale * LOG2E;

  for (int t = 0; t < n_tiles; ++t) {
    const int kt = k_begin + t * MK;
    const int st = t & 1;
    if (t + 1 < n_tiles) {  // the next tile into the other stage
      repro::load_rows_async<D, LD, MK, MMA_THREADS>(ks + (st ^ 1) * MK * LD, kb, kt + MK, Sk, tid);
      repro::load_rows_async<D, LD, MK, MMA_THREADS>(vs + (st ^ 1) * MK * LD, vb, kt + MK, Sk, tid);
    }
    repro::cp_async_commit();
    repro::cp_async_wait<1>();  // this tile landed (the next may not have)
    __syncthreads();
    const bf16* kst = ks + st * MK * LD;
    const bf16* vst = vs + st * MK * LD;

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t b[4];  // keys 16jp.. (n-major): b0/b1 of n-tiles 2jp and 2jp+1
        repro::ldmatrix_x4(
            b, kst + (jp * 16 + lane % 8 + (lane / 16) * 8) * LD + c * 16 + ((lane / 8) % 2) * 8);
        repro::mma_bf16_16816(s[2 * jp], qf[c], b[0], b[1]);
        repro::mma_bf16_16816(s[2 * jp + 1], qf[c], b[2], b[3]);
      }
    }
    // the mask, only where the tile straddles an edge
    const bool edge = kt + MK > Sk || (causal && kt + MK - 1 > q_lo) ||
                      (window > 0 && q_hi - kt >= window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!visible(pos[e / 2], kt + j * 8 + tq * 2 + (e & 1), Sk, causal, window))
            s[j][e] = -CUDART_INF_F;
    }
    // online softmax on the fragments: rows g (e = 0, 1) and g + 8 (e = 2, 3)
    float corr[2], ml[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[h], mx * scale);
      corr[h] = exp2f((m_r[h] - m_new) * LOG2E);
      m_r[h] = m_new;
      ml[h] = m_new * LOG2E;
      l_r[h] *= corr[h];
    }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      o[j][0] *= corr[0]; o[j][1] *= corr[0];
      o[j][2] *= corr[1]; o[j][3] *= corr[1];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(s[j][e], scale_log2, -ml[e / 2]));  // masked: 0
        s[j][e] = p;
        l_r[e / 2] += p;
      }
    // O += P V: P from the S fragments as bf16 A fragments, V by ldmatrix.trans
#pragma unroll
    for (int c = 0; c < MK / 16; ++c) {
      const uint32_t a[4] = {
          repro::pack_bf16x2(s[2 * c][0], s[2 * c][1]),
          repro::pack_bf16x2(s[2 * c][2], s[2 * c][3]),
          repro::pack_bf16x2(s[2 * c + 1][0], s[2 * c + 1][1]),
          repro::pack_bf16x2(s[2 * c + 1][2], s[2 * c + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t b[4];  // keys 16c.. (k-major): b0/b1 of d-tiles 2dp and 2dp+1
        repro::ldmatrix_x4_trans(
            b, vst + (c * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD + dp * 16 + (lane / 16) * 8);
        repro::mma_bf16_16816(o[2 * dp], a, b[0], b[1]);
        repro::mma_bf16_16816(o[2 * dp + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage consumed before the next loads overwrite it
  }
  repro::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_r[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = fmaxf(l, 1e-30f);
    const int row = row0 + 8 * h;
    if (row >= Sq) continue;
    bf16* orow = out + (static_cast<size_t>(bh) * Sq + row) * D;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8 + tq * 2) =
          repro::pack_bf16x2(o[j][2 * h] / l, o[j][2 * h + 1] / l);
    if (tq == 0) lse[static_cast<size_t>(bh) * Sq + row] = m_r[h] + logf(l);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* out, void* lse,
               int BH, int Sq, int Sk, int g, int causal, int window, int q_offset,
               const int* q_offset_dev, float scale, cudaStream_t stream) {
  constexpr size_t bytes = mma_smem_bytes<D>();
  auto kern = flash_fwd_mma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(cdiv(Sq, MQ), BH);
  kern<<<grid, MMA_THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), static_cast<float*>(lse), Sq, Sk, g, causal, window,
      q_offset, q_offset_dev, scale);
  return static_cast<int>(cudaGetLastError());
}

// bf16 -> the tensor-core kernel, f32 -> the CUDA-core kernel
template <int D>
int launch_route(int bf16_in, const void* q, const void* k, const void* v, void* out,
                 void* lse, int BH, int Sq, int Sk, int g, int causal, int window,
                 int q_offset, const int* q_offset_dev, float scale, cudaStream_t s) {
  if (bf16_in)
    return launch_mma<D>(q, k, v, out, lse, BH, Sq, Sk, g, causal, window, q_offset,
                         q_offset_dev, scale, s);
  return launch<float, D>(q, k, v, out, lse, BH, Sq, Sk, g, causal, window, q_offset,
                          q_offset_dev, scale, s);
}

}  // namespace

// is_bf16: 0 -> q/k/v/out are f32, 1 -> bf16 (16-byte aligned). D in
// {32, 64, 80, 128}. q_offset_dev: null (q_offset is the offset) or a device
// int32 holding the offset.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* out, void* lse, int is_bf16, int BH, int Sq,
                                int Sk, int D, int g, int causal, int window,
                                int q_offset, const void* q_offset_dev, float scale,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* qo = static_cast<const int*>(q_offset_dev);
  switch (D) {
    case 32: return launch_route<32>(is_bf16, q, k, v, out, lse, BH, Sq, Sk, g, causal, window, q_offset, qo, scale, s);
    case 64: return launch_route<64>(is_bf16, q, k, v, out, lse, BH, Sq, Sk, g, causal, window, q_offset, qo, scale, s);
    case 80: return launch_route<80>(is_bf16, q, k, v, out, lse, BH, Sq, Sk, g, causal, window, q_offset, qo, scale, s);
    case 128: return launch_route<128>(is_bf16, q, k, v, out, lse, BH, Sq, Sk, g, causal, window, q_offset, qo, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
