// Flash attention backward (FlashAttention-2 recipe), two passes, two routes.
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
// 15 q / 5 kv heads, D 64, causal) dq moves ~37 MB for ~6 GFLOP and dk/dv
// ~25 MB for ~8 GFLOP: on the tensor cores the dq pass is bound by its
// bytes (~11 us) and dk/dv barely by operations (~8 us); on the CUDA cores
// in f32 both are bound by instruction throughput, far above that.
//
// Both routes turn the Pallas grid's sequential last axis into a loop
// inside the block: dq runs one block per (bh, 64-query tile) over the key
// tiles the causal / window mask leaves visible; dk/dv one block per (kv
// row, 64-key tile) over the g q heads of its GQA group and, inside, the
// visible query tiles. Each accumulates in f32 registers and writes its
// output once, in the input dtype. Summing the group inside the block needs
// no atomics (the same bits every run), and the TPU kernel's per-q-head
// (BH, Sk, D) f32 partials never reach device memory. delta = rowsum(dout
// * out) is computed by the dq pass for its rows (out is read once there)
// and written for the dk/dv pass, which runs after it on the same stream.
// Any Sq and Sk are handled by masking; D is 32, 64, 80 or 128.
//
// bf16 route (flash_bwd_dq_mma_kernel, flash_bwd_dkv_mma_kernel; the train
// path's): all five tile products on the tensor cores, mma.sync m16n8k16
// (bf16 in, f32 accumulate), 4 warps of 16 rows a block, as
// flash_fwd_mma_kernel. Score tiles live in the mma accumulator layout
// (rows g and g+8, columns 2t, 2t+1 of each n8 tile), which, rounded to
// bf16 in registers, is the A fragment of the next product: P and dS never
// touch shared memory, and they are rounded where the reference rounds
// them (ds.astype(k.dtype), p.astype(do.dtype), ds.astype(q.dtype)). The
// mask is applied only on tiles that straddle an edge, and tiles it hides
// completely are never loaded.
// * dq: Q and dO tiles arrive by cp.async, and at D <= 64 their A
//   fragments stay in registers for the whole sweep (at D 128 they are
//   re-read from shared memory, which keeps the kernel from spilling). K/V
//   tiles of 64 keys go through a 2-stage cp.async ring. Per tile S = Q K^T
//   and dP = dO V^T (K and V read n-major by ldmatrix), P = exp(S * scale -
//   lse), dS = P (dP - delta) scale, then dQ += dS K (K by ldmatrix.trans).
//   Blocks start with the last query tiles, which see the most keys.
// * dk/dv, transposed: the block's 16 keys a warp are the rows, so S^T = K
//   Q^T, dP^T = V dO^T, P^T = exp(S^T * scale - lse[q]) and dS^T = P^T
//   (dP^T - delta[q]) scale come out in the layout whose bf16 pack is the A
//   fragment of dV += P^T dO and dK += dS^T Q (dO and Q by
//   ldmatrix.trans). K and V fragments stay in registers at D <= 64; Q, dO,
//   lse and delta tiles go through a 2-stage cp.async ring that runs on
//   from one q head of the group to the next. At D 128 a staged query tile
//   is 32 rows, not 64 (the score tiles then take half the registers).
// * D 80 takes the D 128 way for the fragments (re-read from shared
//   memory in both passes) and the D 64 way for the staged query tile (64
//   rows: 32 rows of 10 16-byte copies would not share out evenly over 128
//   threads); its register arrays (scores 64, dK and dV 80) are fewer than
//   those of the D 64 kernel, which holds its fragments (64 + 64 + 64).
//   ptxas gives the D 80 passes 168 (dq) and 235 (dk/dv) registers and no
//   spill; holding Q and dO (40 more) might still fit the dq pass.
//   The grid's slow axis is the key tile, so the first key tiles, which
//   under the causal mask see the most query tiles, start first.
//
// f32 route (flash_bwd_dq_kernel, flash_bwd_dkv_kernel): the CUDA cores,
// f32 throughout (the tensor cores would round q, k, v and dout). A row is
// split over TPR neighbouring threads (1 at D 32, 2 at D 64, 4 at D 80 and
// 128), each owning the D / TPR columns c = cc * TPR + its lane (cc < D /
// TPR), so together they own every column; dot products are finished with
// __shfl_xor_sync. No main path runs it.
#include "common.cuh"

namespace {

using repro::cdiv;

constexpr int BQ = 64;    // dq: query rows per block; dk/dv: query rows per staged tile
constexpr int BK = 64;    // dq: keys per staged tile; dk/dv: keys per block

__device__ __forceinline__ bool visible(int qpos, int kpos, int sk, int causal, int window) {
  return kpos < sk && (!causal || qpos >= kpos) && (window <= 0 || qpos - kpos < window);
}

// ---------------- f32 route: CUDA cores ----------------

// Threads that share a row, and the columns each of them owns.
template <int D> __host__ __device__ constexpr int tpr() { return D <= 32 ? 1 : D <= 64 ? 2 : 4; }
template <int D> __host__ __device__ constexpr int cols() {
  static_assert(D % tpr<D>() == 0, "each thread of a row owns D / TPR columns");
  return D / tpr<D>();
}

// Sum over the TPR neighbouring lanes that share a row (TPR in {1, 2, 4}).
template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
__global__ void __launch_bounds__(BQ * tpr<D>())
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ out,
                    const float* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ dq, float* __restrict__ delta, int Sq, int Sk,
                    int g, int causal, int window, int q_offset, float scale) {
  constexpr int TPR = tpr<D>(), COLS = cols<D>();
  constexpr int NT = BQ * TPR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + BK * D;

  const int t = threadIdx.x;
  const int r = t / TPR, sl = t % TPR;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int qi = q0 + r;
  const bool row_ok = qi < Sq;
  const int qpos = q_offset + qi;
  const size_t row = (static_cast<size_t>(bh) * Sq + (row_ok ? qi : 0)) * D;
  const float* kb = k + static_cast<size_t>(bh / g) * Sk * D;
  const float* vb = v + static_cast<size_t>(bh / g) * Sk * D;

  float qr[COLS], dor[COLS], acc[COLS];
  float dlt = 0.f;
#pragma unroll
  for (int cc = 0; cc < COLS; ++cc) {
    const int c = cc * TPR + sl;
    qr[cc] = row_ok ? q[row + c] : 0.f;
    dor[cc] = row_ok ? dout[row + c] : 0.f;
    dlt += dor[cc] * (row_ok ? out[row + c] : 0.f);
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
      ks[e] = in ? kb[off] : 0.f;
      vs[e] = in ? vb[off] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < BK; ++j) {
      const float* krow = ks + j * D;
      const float* vrow = vs + j * D;
      float sdot = 0.f, pdot = 0.f;
#pragma unroll
      for (int cc = 0; cc < COLS; ++cc) {
        const int c = cc * TPR + sl;
        sdot += qr[cc] * krow[c];
        pdot += dor[cc] * vrow[c];
      }
      sdot = row_sum<TPR>(sdot);
      pdot = row_sum<TPR>(pdot);
      float ds = 0.f;
      if (row_ok && visible(qpos, k0 + j, Sk, causal, window)) {
        const float p = expf(sdot * scale - l);
        ds = p * (pdot - dlt) * scale;
      }
#pragma unroll
      for (int cc = 0; cc < COLS; ++cc) acc[cc] += ds * krow[cc * TPR + sl];
    }
  }
  if (!row_ok) return;
#pragma unroll
  for (int cc = 0; cc < COLS; ++cc) dq[row + cc * TPR + sl] = acc[cc];
}

template <int D>
__global__ void __launch_bounds__(BK * tpr<D>())
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk, int g,
                     int causal, int window, int q_offset, float scale) {
  constexpr int TPR = tpr<D>(), COLS = cols<D>();
  constexpr int NT = BK * TPR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ls = reinterpret_cast<float*>(smem_raw);
  float* dls = ls + BQ;
  float* qs = dls + BQ;
  float* dos = qs + BQ * D;

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
    kr[cc] = key_ok ? k[row + c] : 0.f;
    vr[cc] = key_ok ? v[row + c] : 0.f;
    dka[cc] = 0.f;
    dva[cc] = 0.f;
  }

  // query rows that can see a key of this tile
  const int k_hi = min(k0 + BK, Sk) - 1;
  const int i_begin = causal ? (max(0, k0 - q_offset) / BQ) * BQ : 0;
  const int i_end = window > 0 ? min(Sq, max(0, k_hi + window - q_offset)) : Sq;

  for (int h = 0; h < g; ++h) {
    const int bh = kv * g + h;
    const float* qb = q + static_cast<size_t>(bh) * Sq * D;
    const float* db = dout + static_cast<size_t>(bh) * Sq * D;
    const float* lb = lse + static_cast<size_t>(bh) * Sq;
    const float* deb = delta + static_cast<size_t>(bh) * Sq;
    for (int i0 = i_begin; i0 < i_end; i0 += BQ) {
      __syncthreads();  // previous q / dout tile consumed
      for (int e = t; e < BQ * D; e += NT) {
        const bool in = i0 + e / D < Sq;
        const size_t off = static_cast<size_t>(i0) * D + e;
        qs[e] = in ? qb[off] : 0.f;
        dos[e] = in ? db[off] : 0.f;
      }
      for (int e = t; e < BQ; e += NT) {
        const bool in = i0 + e < Sq;
        ls[e] = in ? lb[i0 + e] : 0.f;
        dls[e] = in ? deb[i0 + e] : 0.f;
      }
      __syncthreads();
      const int n_rows = min(BQ, Sq - i0);
      for (int i = 0; i < n_rows; ++i) {
        const float* qrow = qs + i * D;
        const float* drow = dos + i * D;
        float sdot = 0.f, pdot = 0.f;
#pragma unroll
        for (int cc = 0; cc < COLS; ++cc) {
          const int c = cc * TPR + sl;
          sdot += qrow[c] * kr[cc];
          pdot += drow[c] * vr[cc];
        }
        sdot = row_sum<TPR>(sdot);
        pdot = row_sum<TPR>(pdot);
        const int qi = i0 + i;
        float p = 0.f, ds = 0.f;
        if (visible(q_offset + qi, kj, Sk, causal, window)) {
          p = expf(sdot * scale - ls[i]);
          ds = p * (pdot - dls[i]) * scale;
        }
#pragma unroll
        for (int cc = 0; cc < COLS; ++cc) {
          const int c = cc * TPR + sl;
          dva[cc] += p * drow[c];
          dka[cc] += ds * qrow[c];
        }
      }
    }
  }
  if (!key_ok) return;
#pragma unroll
  for (int cc = 0; cc < COLS; ++cc) {
    const int c = cc * TPR + sl;
    dk[row + c] = dka[cc];
    dv[row + c] = dva[cc];
  }
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* out,
              const void* dout, const void* lse, void* dq, void* delta, int BH, int Sq,
              int Sk, int g, int causal, int window, int q_offset, float scale,
              cudaStream_t stream) {
  constexpr size_t bytes = sizeof(float) * 2 * BK * D;  // k and v tiles
  auto kern = flash_bwd_dq_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(cdiv(Sq, BQ), BH);
  kern<<<grid, BQ * tpr<D>(), bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(out), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(dq), static_cast<float*>(delta),
      Sq, Sk, g, causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int BKV, int Sq,
               int Sk, int g, int causal, int window, int q_offset, float scale,
               cudaStream_t stream) {
  // lse, delta; q, dout tiles
  constexpr size_t bytes = sizeof(float) * 2 * BQ + sizeof(float) * 2 * BQ * D;
  auto kern = flash_bwd_dkv_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(cdiv(Sk, BK), BKV);
  kern<<<grid, BK * tpr<D>(), bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv), Sq,
      Sk, g, causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------- bf16 route: tensor cores ----------------

using bf16 = __nv_bfloat16;
constexpr int MMA_THREADS = 128;  // 4 warps x 16 rows
constexpr float LOG2E = 1.4426950408889634f;

// Row stride of the shared tiles, in bf16: 16 bytes of padding, so the 8
// rows one ldmatrix matrix reads fall in distinct banks.
template <int D> __host__ __device__ constexpr int ld() { return D + 8; }

// At D <= 64 the fragments a warp reads on every tile (Q and dO in the dq
// pass, K and V in the dk/dv pass) are held in registers for the sweep;
// at D 80 and 128 they are re-read from shared memory, and at D 128 the
// dk/dv pass stages 32 query rows at a time, so no kernel spills.
template <int D> __host__ __device__ constexpr bool hold() { return D <= 64; }
template <int D> __host__ __device__ constexpr int dkv_rows() { return D <= 80 ? 64 : 32; }

template <int D>
constexpr size_t dq_mma_smem() {  // q, dout tiles; 2 stages of k and v; delta
  return sizeof(bf16) * ld<D>() * (2 * BQ + 2 * 2 * BK) + sizeof(float) * BQ;
}

template <int D>
constexpr size_t dkv_mma_smem() {  // k, v tiles; 2 stages of q, dout, lse and delta
  return sizeof(bf16) * ld<D>() * (2 * BK + 2 * 2 * dkv_rows<D>()) +
         sizeof(float) * 2 * 2 * dkv_rows<D>();
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ out,
                        const bf16* __restrict__ dout, const float* __restrict__ lse,
                        bf16* __restrict__ dq, float* __restrict__ delta, int Sq, int Sk, int g,
                        int causal, int window, int q_offset, float scale) {
  constexpr int LD = ld<D>();
  constexpr int NT = BK / 8;   // n8 tiles of S and dP per warp
  constexpr int DT = D / 8;    // n8 tiles of dQ per warp
  constexpr int KC = D / 16;   // k16 steps of QK^T and dO V^T
  constexpr bool HOLD = hold<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* dos = qs + BQ * LD;                      // [BQ][LD]
  bf16* ks = dos + BQ * LD;                      // [2][BK][LD]
  bf16* vs = ks + 2 * BK * LD;                   // [2][BK][LD]
  float* dls = reinterpret_cast<float*>(vs + 2 * BK * LD);  // [BQ] delta

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4, tq = lane % 4;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest causal rows first
  const size_t row_base = static_cast<size_t>(bh) * Sq;  // (bh, 0) of q, out, dout, lse
  const bf16* kb = k + static_cast<size_t>(bh / g) * Sk * D;
  const bf16* vb = v + static_cast<size_t>(bh / g) * Sk * D;

  // key range any row of this block can see: fully masked tiles are skipped
  const int q_lo = q_offset + q0;
  const int q_hi = q_offset + min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_hi + 1) : Sk;
  const int k_begin = window > 0 ? (max(0, q_lo - window + 1) / BK) * BK : 0;
  const int n_tiles = k_end > k_begin ? cdiv(k_end - k_begin, BK) : 0;

  repro::load_rows_async<D, LD, BQ, MMA_THREADS>(qs, q + row_base * D, q0, Sq, tid);
  repro::load_rows_async<D, LD, BQ, MMA_THREADS>(dos, dout + row_base * D, q0, Sq, tid);
  repro::cp_async_commit();
  if (n_tiles > 0) {
    repro::load_rows_async<D, LD, BK, MMA_THREADS>(ks, kb, k_begin, Sk, tid);
    repro::load_rows_async<D, LD, BK, MMA_THREADS>(vs, vb, k_begin, Sk, tid);
  }
  repro::cp_async_commit();

  // delta = rowsum(dout * out) in f32: two threads a row, D/2 columns each
  {
    const int r = tid / 2, qi = q0 + r;
    float s = 0.f;
    if (qi < Sq) {
      const size_t off = (row_base + qi) * D + (tid % 2) * (D / 2);
#pragma unroll
      for (int c = 0; c < D / 2; c += 8) {
        const uint4 o4 = *reinterpret_cast<const uint4*>(out + off + c);
        const uint4 d4 = *reinterpret_cast<const uint4*>(dout + off + c);
        const uint32_t ow[4] = {o4.x, o4.y, o4.z, o4.w}, dw[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)  // a bf16 is the high half of its f32
          s += __uint_as_float(dw[e] << 16) * __uint_as_float(ow[e] << 16) +
               __uint_as_float(dw[e] & 0xffff0000u) * __uint_as_float(ow[e] & 0xffff0000u);
      }
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    dls[r] = s;
    if (qi < Sq && tid % 2 == 0) delta[row_base + qi] = s;
  }
  repro::cp_async_wait<1>();  // q and dout landed (the first K/V tile may not have)
  __syncthreads();            // ... for every thread, and dls written

  // this thread's two rows (g and g + 8 of the warp's 16)
  const int row0 = q0 + warp * 16 + gq;
  const int pos[2] = {q_offset + row0, q_offset + row0 + 8};
  float lse2[2], dlt[2];  // lse * log2(e), delta
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lse2[h] = row0 + 8 * h < Sq ? lse[row_base + row0 + 8 * h] * LOG2E : 0.f;
    dlt[h] = dls[warp * 16 + gq + 8 * h];
  }
  uint32_t qf[HOLD ? KC : 1][4], df[HOLD ? KC : 1][4];  // A fragments of Q, dO
  if constexpr (HOLD) {
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      repro::load_a<LD>(qf[c], qs, warp * 16, c * 16, lane);
      repro::load_a<LD>(df[c], dos, warp * 16, c * 16, lane);
    }
  }
  float acc[DT][4];  // dQ, rows g / g+8, columns 8j + 2t, +1
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const float scale_log2 = scale * LOG2E;

  for (int t = 0; t < n_tiles; ++t) {
    const int kt = k_begin + t * BK;
    const int st = t & 1;
    if (t + 1 < n_tiles) {  // the next tile into the other stage
      repro::load_rows_async<D, LD, BK, MMA_THREADS>(ks + (st ^ 1) * BK * LD, kb, kt + BK, Sk, tid);
      repro::load_rows_async<D, LD, BK, MMA_THREADS>(vs + (st ^ 1) * BK * LD, vb, kt + BK, Sk, tid);
    }
    repro::cp_async_commit();
    repro::cp_async_wait<1>();  // this tile landed (the next may not have)
    __syncthreads();
    const bf16* kst = ks + st * BK * LD;
    const bf16* vst = vs + st * BK * LD;

    // S = Q K^T and dP = dO V^T for the warp's 16 rows and the tile's 64 keys
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      uint32_t aq[4], ad[4];
      if constexpr (HOLD) {
#pragma unroll
        for (int i = 0; i < 4; ++i) aq[i] = qf[c][i], ad[i] = df[c][i];
      } else {
        repro::load_a<LD>(aq, qs, warp * 16, c * 16, lane);
        repro::load_a<LD>(ad, dos, warp * 16, c * 16, lane);
      }
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t b[4];
        repro::load_b_nmajor<LD>(b, kst, jp * 16, c * 16, lane);
        repro::mma_bf16_16816(s[2 * jp], aq, b[0], b[1]);
        repro::mma_bf16_16816(s[2 * jp + 1], aq, b[2], b[3]);
        repro::load_b_nmajor<LD>(b, vst, jp * 16, c * 16, lane);
        repro::mma_bf16_16816(dp[2 * jp], ad, b[0], b[1]);
        repro::mma_bf16_16816(dp[2 * jp + 1], ad, b[2], b[3]);
      }
    }
    // dS = P (dP - delta) scale, with the mask only where the tile
    // straddles an edge; rows g (e = 0, 1) and g + 8 (e = 2, 3)
    const bool edge = kt + BK > Sk || (causal && kt + BK - 1 > q_lo) ||
                      (window > 0 && q_hi - kt >= window);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[j][e], scale_log2, -lse2[e / 2]));
        if (edge && !visible(pos[e / 2], kt + j * 8 + tq * 2 + (e & 1), Sk, causal, window))
          p = 0.f;
        s[j][e] = p * (dp[j][e] - dlt[e / 2]) * scale;
      }
    // dQ += dS K: dS as bf16 A fragments, K (k-major over keys) by ldmatrix.trans
#pragma unroll
    for (int c = 0; c < BK / 16; ++c) {
      uint32_t a[4];
      repro::pack_a(a, s[2 * c], s[2 * c + 1]);
#pragma unroll
      for (int dd = 0; dd < DT / 2; ++dd) {
        uint32_t b[4];
        repro::load_b_kmajor<LD>(b, kst, c * 16, dd * 16, lane);
        repro::mma_bf16_16816(acc[2 * dd], a, b[0], b[1]);
        repro::mma_bf16_16816(acc[2 * dd + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage consumed before the next loads overwrite it
  }
  repro::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= Sq) continue;
    bf16* drow = dq + (row_base + row) * D;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<uint32_t*>(drow + j * 8 + tq * 2) =
          repro::pack_bf16x2(acc[j][2 * h], acc[j][2 * h + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk, int g,
                         int causal, int window, int q_offset, float scale) {
  constexpr int LD = ld<D>();
  constexpr int TQ = dkv_rows<D>();  // query rows per staged tile
  constexpr int NT = TQ / 8;         // n8 tiles of S^T and dP^T per warp
  constexpr int DT = D / 8;          // n8 tiles of dK and dV per warp
  constexpr int KC = D / 16;         // k16 steps of K Q^T and V dO^T
  constexpr bool HOLD = hold<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [BK][LD]
  bf16* vs = ks + BK * LD;                       // [BK][LD]
  bf16* qs = vs + BK * LD;                       // [2][TQ][LD]
  bf16* dos = qs + 2 * TQ * LD;                  // [2][TQ][LD]
  float* ls = reinterpret_cast<float*>(dos + 2 * TQ * LD);  // [2][TQ] lse
  float* dls = ls + 2 * TQ;                                 // [2][TQ] delta

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4, tq = lane % 4;
  const int kv = blockIdx.x;
  const int k0 = blockIdx.y * BK;  // the slow grid axis: the first key tiles start first
  const size_t kv_base = static_cast<size_t>(kv) * Sk;

  // query rows that can see a key of this tile, in tiles of TQ, for each
  // of the g q heads of the group
  const int k_hi = min(k0 + BK, Sk) - 1;
  const int i_begin = causal ? (max(0, k0 - q_offset) / TQ) * TQ : 0;
  const int i_end = window > 0 ? min(Sq, max(0, k_hi + window - q_offset)) : Sq;
  const int n_i = i_end > i_begin ? cdiv(i_end - i_begin, TQ) : 0;
  const int n_tiles = g * n_i;

  // tile t (q head t / n_i, rows i_begin + (t % n_i) * TQ..) into stage st
  auto load_tile = [&](int t, int st) {
    const size_t base = static_cast<size_t>(kv * g + t / n_i) * Sq;
    const int i0 = i_begin + (t % n_i) * TQ;
    repro::load_rows_async<D, LD, TQ, MMA_THREADS>(qs + st * TQ * LD, q + base * D, i0, Sq, tid);
    repro::load_rows_async<D, LD, TQ, MMA_THREADS>(dos + st * TQ * LD, dout + base * D, i0, Sq,
                                                   tid);
    if (tid < 2 * TQ) {  // lse and delta, one float a thread
      const int r = tid % TQ;
      const float* src = (tid < TQ ? lse : delta) + base + i0 + r;
      const bool ok = i0 + r < Sq;
      repro::cp_async<4>((tid < TQ ? ls : dls) + st * TQ + r, ok ? src : lse, ok ? 4 : 0);
    }
  };

  repro::load_rows_async<D, LD, BK, MMA_THREADS>(ks, k + kv_base * D, k0, Sk, tid);
  repro::load_rows_async<D, LD, BK, MMA_THREADS>(vs, v + kv_base * D, k0, Sk, tid);
  if (n_tiles > 0) load_tile(0, 0);
  repro::cp_async_commit();

  uint32_t kf[HOLD ? KC : 1][4], vf[HOLD ? KC : 1][4];  // A fragments of K, V
  float dka[DT][4], dva[DT][4];  // dK, dV: rows (keys) g / g+8, columns 8j + 2t, +1
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  const int key0 = k0 + warp * 16 + gq;  // this thread's keys: key0 and key0 + 8
  const float scale_log2 = scale * LOG2E;

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) load_tile(t + 1, st ^ 1);
    repro::cp_async_commit();
    repro::cp_async_wait<1>();  // this tile (and K, V) landed (the next may not have)
    __syncthreads();
    if constexpr (HOLD) {
      if (t == 0) {
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          repro::load_a<LD>(kf[c], ks, warp * 16, c * 16, lane);
          repro::load_a<LD>(vf[c], vs, warp * 16, c * 16, lane);
        }
      }
    }
    const int i0 = i_begin + (t % n_i) * TQ;
    const bf16* qst = qs + st * TQ * LD;
    const bf16* dost = dos + st * TQ * LD;
    const float* lst = ls + st * TQ;
    const float* dlst = dls + st * TQ;

    // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys x the tile's TQ queries
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      uint32_t ak[4], av[4];
      if constexpr (HOLD) {
#pragma unroll
        for (int i = 0; i < 4; ++i) ak[i] = kf[c][i], av[i] = vf[c][i];
      } else {
        repro::load_a<LD>(ak, ks, warp * 16, c * 16, lane);
        repro::load_a<LD>(av, vs, warp * 16, c * 16, lane);
      }
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t b[4];
        repro::load_b_nmajor<LD>(b, qst, jp * 16, c * 16, lane);
        repro::mma_bf16_16816(s[2 * jp], ak, b[0], b[1]);
        repro::mma_bf16_16816(s[2 * jp + 1], ak, b[2], b[3]);
        repro::load_b_nmajor<LD>(b, dost, jp * 16, c * 16, lane);
        repro::mma_bf16_16816(dp[2 * jp], av, b[0], b[1]);
        repro::mma_bf16_16816(dp[2 * jp + 1], av, b[2], b[3]);
      }
    }
    // P^T and dS^T = P^T (dP^T - delta) scale; column (query) 8j + 2t + u,
    // rows (keys) key0 (e = u) and key0 + 8 (e = 2 + u)
    const bool edge = i0 + TQ > Sq || k0 + BK > Sk || (causal && q_offset + i0 < k0 + BK - 1) ||
                      (window > 0 && q_offset + i0 + TQ - 1 - k0 >= window);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int col = j * 8 + tq * 2 + u;
        const float l2 = lst[col] * LOG2E, dl = dlst[col];
        const int qpos = q_offset + i0 + col;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 2 * h + u;
          float p = exp2f(fmaf(s[j][e], scale_log2, -l2));
          if (edge && !(i0 + col < Sq && visible(qpos, key0 + 8 * h, Sk, causal, window)))
            p = 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - dl) * scale;
        }
      }
    // dV += P^T dO and dK += dS^T Q: P^T and dS^T as bf16 A fragments
    // (k over the queries), dO and Q (k-major over queries) by ldmatrix.trans
#pragma unroll
    for (int c = 0; c < TQ / 16; ++c) {
      uint32_t ap[4], ads[4];
      repro::pack_a(ap, s[2 * c], s[2 * c + 1]);
      repro::pack_a(ads, dp[2 * c], dp[2 * c + 1]);
#pragma unroll
      for (int dd = 0; dd < DT / 2; ++dd) {
        uint32_t b[4];
        repro::load_b_kmajor<LD>(b, dost, c * 16, dd * 16, lane);
        repro::mma_bf16_16816(dva[2 * dd], ap, b[0], b[1]);
        repro::mma_bf16_16816(dva[2 * dd + 1], ap, b[2], b[3]);
        repro::load_b_kmajor<LD>(b, qst, c * 16, dd * 16, lane);
        repro::mma_bf16_16816(dka[2 * dd], ads, b[0], b[1]);
        repro::mma_bf16_16816(dka[2 * dd + 1], ads, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage consumed before the next loads overwrite it
  }
  repro::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + 8 * h;
    if (key >= Sk) continue;
    bf16* krow = dk + (kv_base + key) * D;
    bf16* vrow = dv + (kv_base + key) * D;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      *reinterpret_cast<uint32_t*>(krow + j * 8 + tq * 2) =
          repro::pack_bf16x2(dka[j][2 * h], dka[j][2 * h + 1]);
      *reinterpret_cast<uint32_t*>(vrow + j * 8 + tq * 2) =
          repro::pack_bf16x2(dva[j][2 * h], dva[j][2 * h + 1]);
    }
  }
}

template <int D>
int launch_dq_mma(const void* q, const void* k, const void* v, const void* out,
                  const void* dout, const void* lse, void* dq, void* delta, int BH, int Sq,
                  int Sk, int g, int causal, int window, int q_offset, float scale,
                  cudaStream_t stream) {
  constexpr size_t bytes = dq_mma_smem<D>();
  auto kern = flash_bwd_dq_mma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(BH, cdiv(Sq, BQ));
  kern<<<grid, MMA_THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<bf16*>(dq), static_cast<float*>(delta), Sq,
      Sk, g, causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv_mma(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dk, void* dv, int BKV, int Sq,
                   int Sk, int g, int causal, int window, int q_offset, float scale,
                   cudaStream_t stream) {
  constexpr size_t bytes = dkv_mma_smem<D>();
  auto kern = flash_bwd_dkv_mma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(BKV, cdiv(Sk, BK));
  kern<<<grid, MMA_THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq, Sk,
      g, causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

#define REPRO_DISPATCH_D(FN, D, ...)                             \
  switch (D) {                                                   \
    case 32: return FN<32>(__VA_ARGS__);                         \
    case 64: return FN<64>(__VA_ARGS__);                         \
    case 80: return FN<80>(__VA_ARGS__);                         \
    case 128: return FN<128>(__VA_ARGS__);                       \
    default: return static_cast<int>(cudaErrorInvalidValue);     \
  }

}  // namespace

// is_bf16: 0 -> q/k/v/out/dout/dq are f32 (the CUDA-core kernel), 1 -> bf16
// (the tensor-core kernel; q, k, v, out and dout 16-byte aligned). D in
// {32, 64, 80, 128}. Writes dq (BH, Sq, D) and delta (BH, Sq) f32.
extern "C" int flash_bwd_dq_launch(const void* q, const void* k, const void* v,
                                   const void* out, const void* dout, const void* lse,
                                   void* dq, void* delta, int is_bf16, int BH, int Sq,
                                   int Sk, int D, int g, int causal, int window,
                                   int q_offset, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    REPRO_DISPATCH_D(launch_dq_mma, D, q, k, v, out, dout, lse, dq, delta, BH, Sq, Sk, g,
                     causal, window, q_offset, scale, s)
  }
  REPRO_DISPATCH_D(launch_dq, D, q, k, v, out, dout, lse, dq, delta, BH, Sq, Sk, g, causal,
                   window, q_offset, scale, s)
}

// Reads the delta the dq pass wrote; writes dk, dv (BKV, Sk, D), each
// summed over the g q heads of its group.
extern "C" int flash_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dk, void* dv, int is_bf16, int BKV, int Sq, int Sk,
                                    int D, int g, int causal, int window, int q_offset,
                                    float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    REPRO_DISPATCH_D(launch_dkv_mma, D, q, k, v, dout, lse, delta, dk, dv, BKV, Sq, Sk, g,
                     causal, window, q_offset, scale, s)
  }
  REPRO_DISPATCH_D(launch_dkv, D, q, k, v, dout, lse, delta, dk, dv, BKV, Sq, Sk, g, causal,
                   window, q_offset, scale, s)
}
