// Flash attention backward (FlashAttention-2 recipe), two passes, f32 math.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_bwd:
// its dq pass (_dq_kernel, pallas_call :282) and its dk/dv pass
// (_dkv_kernel, pallas_call :306). q, out, dout: (BH, Sq, D); k, v:
// (BKV, Sk, D), BH % BKV == 0; q row bh reads kv row bh / g (g = BH / BKV).
// Query i sits at position q_offset + i, key j at j; a pair is visible if
// (!causal || q_pos >= k_pos) and (window <= 0 || q_pos - k_pos < window).
// lse (BH, Sq) f32 comes from the forward; a row that saw no key has lse
// -1e30, and its pairs are masked before the exp (never exp(s + 1e30)).
// With s = q.k * scale, p = exp(s - lse), ds = p * (dout.v - delta) * scale:
//   dq = sum_k ds * k,  dv = sum_q p * dout,  dk = sum_q ds * q.
//
// What bounds it on the H100: at the training shape (batch 8 x 512 tokens,
// 15 q / 5 kv heads, D 64, causal) dq moves ~29 MB for ~6 GFLOP and dk/dv
// ~20 MB for ~8 GFLOP: on the tensor cores both would be bound by bytes
// or barely by operations (~9 us). This simple version does the operations
// on the CUDA cores in f32, so it is bound by issue rate, well above that.
//
// What the design does:
// * The Pallas grid's sequential last axis becomes a loop inside the block:
//   dq runs one block per (bh, 64-query tile) and loops over the key tiles
//   the causal / window mask leaves visible; dk/dv runs one block per (kv
//   row, 64-key tile) and loops over the g q heads of its GQA group and,
//   inside, over the visible query tiles. Each accumulates in f32 registers
//   and writes its output once, in the input dtype. Summing the group
//   inside the block needs no atomics (the same result every run), and the
//   per-q-head (BH, Sk, D) f32 partials of the TPU kernel never reach
//   device memory.
// * Registers: one thread per row holding k, v, dk and dv would need 4 * D
//   floats (256 at D = 64, past the 255-register limit). A row is split
//   over TPR = D / 32 neighbouring threads instead; each owns 32 columns,
//   strided by TPR (column cc * TPR + s), so the threads of a row read
//   neighbouring shared-memory words (no bank conflicts), and dot products
//   are finished with __shfl_xor_sync over the TPR lanes. A thread keeps
//   4 x 32 floats at every D.
// * delta = rowsum(dout * out) is computed by the dq pass for its rows
//   (out is read once there) and written for the dk/dv pass, which runs
//   after it on the same stream.
// * Any Sq and Sk are handled by masking (no block-divisor search); D is a
//   template parameter (32, 64, 128).
// Tensor cores (wgmma on the QK^T, dO V^T, dS K, P^T dO and dS^T Q tiles)
// are later work.
#include "common.cuh"

namespace {

using repro::cdiv;
using repro::from_f;
using repro::to_f;

constexpr int BQ = 64;    // dq: query rows per block; dk/dv: query rows per staged tile
constexpr int BK = 64;    // dq: keys per staged tile; dk/dv: keys per block
constexpr int COLS = 32;  // columns each thread owns; TPR = D / COLS threads per row

__device__ __forceinline__ bool visible(int qi, int sq, int qpos, int kpos, int sk,
                                        int causal, int window) {
  return qi < sq && kpos < sk && (!causal || qpos >= kpos) &&
         (window <= 0 || qpos - kpos < window);
}

// Sum over the TPR neighbouring lanes that share a row (TPR in {1, 2, 4}).
template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D>
constexpr size_t dq_smem() {
  return sizeof(T) * 2 * BK * D;  // k and v tiles
}

template <typename T, int D>
constexpr size_t dkv_smem() {
  return sizeof(float) * 2 * BQ + sizeof(T) * 2 * BQ * D;  // lse, delta; q, dout tiles
}

template <typename T, int D>
__global__ void __launch_bounds__(BQ * (D / COLS))
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ out,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    T* __restrict__ dq, float* __restrict__ delta, int Sq, int Sk,
                    int g, int causal, int window, int q_offset, float scale) {
  constexpr int TPR = D / COLS;
  constexpr int NT = BQ * TPR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + BK * D;

  const int t = threadIdx.x;
  const int r = t / TPR, sl = t % TPR;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int qi = q0 + r;
  const bool row_ok = qi < Sq;
  const int qpos = q_offset + qi;
  const size_t row = (static_cast<size_t>(bh) * Sq + (row_ok ? qi : 0)) * D;
  const T* kb = k + static_cast<size_t>(bh / g) * Sk * D;
  const T* vb = v + static_cast<size_t>(bh / g) * Sk * D;

  float qr[COLS], dor[COLS], acc[COLS];
  float dlt = 0.f;
#pragma unroll
  for (int cc = 0; cc < COLS; ++cc) {
    const int c = cc * TPR + sl;
    qr[cc] = row_ok ? to_f(q[row + c]) : 0.f;
    dor[cc] = row_ok ? to_f(dout[row + c]) : 0.f;
    dlt += dor[cc] * (row_ok ? to_f(out[row + c]) : 0.f);
    acc[cc] = 0.f;
  }
  dlt = row_sum<TPR>(dlt);
  const float l = row_ok ? lse[static_cast<size_t>(bh) * Sq + qi] : 0.f;
  if (row_ok && sl == 0) delta[static_cast<size_t>(bh) * Sq + qi] = dlt;

  // key range any row of this block can see: fully masked tiles are skipped
  const int q_lo = q_offset + q0;
  const int q_hi = q_offset + min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_hi + 1) : Sk;
  const int k_begin = window > 0 ? (max(0, q_lo - window + 1) / BK) * BK : 0;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // previous K/V tile consumed
    for (int e = t; e < BK * D; e += NT) {
      const bool in = k0 + e / D < Sk;
      const size_t off = static_cast<size_t>(k0) * D + e;
      ks[e] = in ? kb[off] : from_f<T>(0.f);
      vs[e] = in ? vb[off] : from_f<T>(0.f);
    }
    __syncthreads();
    for (int j = 0; j < BK; ++j) {
      const T* krow = ks + j * D;
      const T* vrow = vs + j * D;
      float sdot = 0.f, pdot = 0.f;
#pragma unroll
      for (int cc = 0; cc < COLS; ++cc) {
        const int c = cc * TPR + sl;
        sdot += qr[cc] * to_f(krow[c]);
        pdot += dor[cc] * to_f(vrow[c]);
      }
      sdot = row_sum<TPR>(sdot);
      pdot = row_sum<TPR>(pdot);
      float ds = 0.f;
      if (visible(qi, Sq, qpos, k0 + j, Sk, causal, window)) {
        const float p = expf(sdot * scale - l);
        ds = p * (pdot - dlt) * scale;
      }
#pragma unroll
      for (int cc = 0; cc < COLS; ++cc) acc[cc] += ds * to_f(krow[cc * TPR + sl]);
    }
  }
  if (!row_ok) return;
#pragma unroll
  for (int cc = 0; cc < COLS; ++cc) dq[row + cc * TPR + sl] = from_f<T>(acc[cc]);
}

template <typename T, int D>
__global__ void __launch_bounds__(BK * (D / COLS))
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int g,
                     int causal, int window, int q_offset, float scale) {
  constexpr int TPR = D / COLS;
  constexpr int NT = BK * TPR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ls = reinterpret_cast<float*>(smem_raw);
  float* dls = ls + BQ;
  T* qs = reinterpret_cast<T*>(dls + BQ);
  T* dos = qs + BQ * D;

  const int t = threadIdx.x;
  const int r = t / TPR, sl = t % TPR;
  const int kv = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int kj = k0 + r;
  const bool key_ok = kj < Sk;
  const size_t row = (static_cast<size_t>(kv) * Sk + (key_ok ? kj : 0)) * D;

  float kr[COLS], vr[COLS], dka[COLS], dva[COLS];
#pragma unroll
  for (int cc = 0; cc < COLS; ++cc) {
    const int c = cc * TPR + sl;
    kr[cc] = key_ok ? to_f(k[row + c]) : 0.f;
    vr[cc] = key_ok ? to_f(v[row + c]) : 0.f;
    dka[cc] = 0.f;
    dva[cc] = 0.f;
  }

  // query rows that can see a key of this tile
  const int k_hi = min(k0 + BK, Sk) - 1;
  const int i_begin = causal ? (max(0, k0 - q_offset) / BQ) * BQ : 0;
  const int i_end = window > 0 ? min(Sq, max(0, k_hi + window - q_offset)) : Sq;

  for (int h = 0; h < g; ++h) {
    const int bh = kv * g + h;
    const T* qb = q + static_cast<size_t>(bh) * Sq * D;
    const T* db = dout + static_cast<size_t>(bh) * Sq * D;
    const float* lb = lse + static_cast<size_t>(bh) * Sq;
    const float* deb = delta + static_cast<size_t>(bh) * Sq;
    for (int i0 = i_begin; i0 < i_end; i0 += BQ) {
      __syncthreads();  // previous q / dout tile consumed
      for (int e = t; e < BQ * D; e += NT) {
        const bool in = i0 + e / D < Sq;
        const size_t off = static_cast<size_t>(i0) * D + e;
        qs[e] = in ? qb[off] : from_f<T>(0.f);
        dos[e] = in ? db[off] : from_f<T>(0.f);
      }
      for (int e = t; e < BQ; e += NT) {
        const bool in = i0 + e < Sq;
        ls[e] = in ? lb[i0 + e] : 0.f;
        dls[e] = in ? deb[i0 + e] : 0.f;
      }
      __syncthreads();
      const int n_rows = min(BQ, Sq - i0);
      for (int i = 0; i < n_rows; ++i) {
        const T* qrow = qs + i * D;
        const T* drow = dos + i * D;
        float sdot = 0.f, pdot = 0.f;
#pragma unroll
        for (int cc = 0; cc < COLS; ++cc) {
          const int c = cc * TPR + sl;
          sdot += to_f(qrow[c]) * kr[cc];
          pdot += to_f(drow[c]) * vr[cc];
        }
        sdot = row_sum<TPR>(sdot);
        pdot = row_sum<TPR>(pdot);
        const int qi = i0 + i;
        float p = 0.f, ds = 0.f;
        if (visible(qi, Sq, q_offset + qi, kj, Sk, causal, window)) {
          p = expf(sdot * scale - ls[i]);
          ds = p * (pdot - dls[i]) * scale;
        }
#pragma unroll
        for (int cc = 0; cc < COLS; ++cc) {
          const int c = cc * TPR + sl;
          dva[cc] += p * to_f(drow[c]);
          dka[cc] += ds * to_f(qrow[c]);
        }
      }
    }
  }
  if (!key_ok) return;
#pragma unroll
  for (int cc = 0; cc < COLS; ++cc) {
    const int c = cc * TPR + sl;
    dk[row + c] = from_f<T>(dka[cc]);
    dv[row + c] = from_f<T>(dva[cc]);
  }
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* out,
              const void* dout, const void* lse, void* dq, void* delta, int BH, int Sq,
              int Sk, int g, int causal, int window, int q_offset, float scale,
              cudaStream_t stream) {
  constexpr size_t bytes = dq_smem<T, D>();
  auto kern = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(cdiv(Sq, BQ), BH);
  kern<<<grid, BQ * (D / COLS), bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(out), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<T*>(dq), static_cast<float*>(delta),
      Sq, Sk, g, causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int BKV, int Sq,
               int Sk, int g, int causal, int window, int q_offset, float scale,
               cudaStream_t stream) {
  constexpr size_t bytes = dkv_smem<T, D>();
  auto kern = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(cdiv(Sk, BK), BKV);
  kern<<<grid, BK * (D / COLS), bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), Sq,
      Sk, g, causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

#define REPRO_DISPATCH_D(FN, T, D, ...)                          \
  switch (D) {                                                   \
    case 32: return FN<T, 32>(__VA_ARGS__);                      \
    case 64: return FN<T, 64>(__VA_ARGS__);                      \
    case 128: return FN<T, 128>(__VA_ARGS__);                    \
    default: return static_cast<int>(cudaErrorInvalidValue);     \
  }

}  // namespace

// bf16: 0 -> q/k/v/out/dout/dq are f32, 1 -> bf16. D in {32, 64, 128}.
// Writes dq (BH, Sq, D) and delta (BH, Sq) f32.
extern "C" int flash_bwd_dq_launch(const void* q, const void* k, const void* v,
                                   const void* out, const void* dout, const void* lse,
                                   void* dq, void* delta, int bf16, int BH, int Sq,
                                   int Sk, int D, int g, int causal, int window,
                                   int q_offset, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    REPRO_DISPATCH_D(launch_dq, __nv_bfloat16, D, q, k, v, out, dout, lse, dq, delta, BH,
                     Sq, Sk, g, causal, window, q_offset, scale, s)
  }
  REPRO_DISPATCH_D(launch_dq, float, D, q, k, v, out, dout, lse, dq, delta, BH, Sq, Sk, g,
                   causal, window, q_offset, scale, s)
}

// Reads the delta the dq pass wrote; writes dk, dv (BKV, Sk, D), each
// summed over the g q heads of its group.
extern "C" int flash_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dk, void* dv, int bf16, int BKV, int Sq, int Sk,
                                    int D, int g, int causal, int window, int q_offset,
                                    float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    REPRO_DISPATCH_D(launch_dkv, __nv_bfloat16, D, q, k, v, dout, lse, delta, dk, dv, BKV,
                     Sq, Sk, g, causal, window, q_offset, scale, s)
  }
  REPRO_DISPATCH_D(launch_dkv, float, D, q, k, v, dout, lse, delta, dk, dv, BKV, Sq, Sk, g,
                   causal, window, q_offset, scale, s)
}
