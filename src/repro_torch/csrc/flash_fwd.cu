// Online-softmax attention forward (flash attention), f32 softmax.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_fwd
// (_fwd_kernel). q: (BH, Sq, D); k, v: (BKV, Sk, D), BH % BKV == 0; q row
// bh reads kv row bh / g (g = BH / BKV: GQA without replicating K/V).
// Query i sits at position q_offset + i; key j at position j. A key is
// visible if (!causal || q_pos >= k_pos) and (window <= 0 ||
// q_pos - k_pos < window). Writes out (BH, Sq, D) in q's dtype and the f32
// log-sum-exp lse (BH, Sq); a row that sees no key gets out 0, lse -1e30.
//
// What bounds it on the H100: at the serve path's shapes (Sq = Sk = 512,
// D = 64, 15 heads) it moves ~0.4 MB and does ~0.5 GFLOP, so it is bound
// by operations; this simple version runs them on the CUDA cores in f32.
// What the design does: one block per (bh, 64-query tile), one thread per
// query row; K/V tiles of 64 keys are staged in shared memory in their
// own dtype and read as broadcasts; each row's scores for a tile go to
// shared memory, then one rescale of the f32 accumulator per tile (not
// per key). Tiles that are fully masked (causal / window) are never
// loaded. Any Sq and Sk are handled by masking; D is a template
// parameter (32, 64, 128) so the accumulator stays in registers.
// Tensor cores (wgmma on the QK^T and PV tiles) are later work.
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
                 int window, int q_offset, float scale) {
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
           float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D, T>();
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(cdiv(Sq, BQ), BH);
  kern<<<grid, BQ, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), Sq, Sk, g, causal, window,
      q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* out,
               void* lse, int BH, int Sq, int Sk, int g, int causal, int window,
               int q_offset, float scale, cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, out, lse, BH, Sq, Sk, g, causal, window, q_offset, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, lse, BH, Sq, Sk, g, causal, window, q_offset, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, lse, BH, Sq, Sk, g, causal, window, q_offset, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// bf16: 0 -> q/k/v/out are f32, 1 -> bf16. D in {32, 64, 128}.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* out, void* lse, int bf16, int BH, int Sq,
                                int Sk, int D, int g, int causal, int window,
                                int q_offset, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, out, lse, BH, Sq, Sk, g, causal,
                                     window, q_offset, scale, s);
  return dispatch_d<float>(D, q, k, v, out, lse, BH, Sq, Sk, g, causal, window,
                           q_offset, scale, s);
}
