// Hand-written CUDA flash attention (forward) for Hopper, sm_90a.
//
// Replaces the TPU kernel flash_attention_kernel
// (src/repro/kernels/flash_attention/kernel.py), which walks a
// (b, hq, q block, k block) grid in order on one core and carries the
// running max, denominator and accumulator of one q block in VMEM scratch
// across its k sweep.  Here the k sweep is a loop inside one CTA: a CTA
// owns one (batch, q head, 64-row q tile) and keeps that state in
// registers, so no CTA depends on another.
//
// What it computes, as the TPU kernel does:
//   * GQA: q head ih reads kv head ih / (hq / hkv);
//   * masks: key kpos is live for query qpos when kpos < sk, and
//     qpos >= kpos (causal), and qpos - kpos < window (sliding window);
//     positions count from 0 for q and k alike, with no right-alignment
//     of sq to sk;
//   * k tiles that the causal/window test rules out for every row of the
//     q tile are skipped (exact: such a tile leaves the state as it is);
//   * s = (q . k) * scale, the exponentials, P and P.V in float32 from
//     float32 or bfloat16 inputs, P never rounded to bfloat16, and
//     out = acc / max(l, 1e-30) rounded once to the input type; a row
//     with no live key therefore comes out 0.
// Ragged tails are masked here, so any sq, sk >= 1 works.
//
// Bound: operations.  Causal prefill does 4 * dh flops per live (q, k)
// pair and reads each operand once, hundreds of flops per byte.  This
// first kernel does them as float32 FMAs on the CUDA cores (67 TFLOP/s
// peak), not on the tensor cores (989 TFLOP/s bf16): a simple, exact
// kernel first; wgmma, TMA and a bfloat16 P are later work.
// Design: 128 threads as 16 row groups x 8 column lanes; a thread holds
// 4 query rows x 8 scores of the 64-key tile and 4 rows x dh/8 output
// columns, and sums each tile's P.V apart before it meets the running
// accumulator.  q and k tiles sit transposed in shared memory (one 16-byte q
// load feeds 4 rows; 8 lanes read 8 consecutive keys), the row max and sum
// go over the 8 lanes by shuffles, and P goes through shared memory to
// the P.V product.  The k and v tiles share one buffer, so a CTA takes
// 87 KB at dh = 128 and two CTAs fit on an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BQ = 64;                // query rows of a CTA
constexpr int BK = 64;                // keys of a tile
constexpr int THREADS = 128;
constexpr int LANES = 8;              // threads that share a row group
constexpr int ROWS = BQ / (THREADS / LANES);  // query rows of a thread: 4
constexpr int SCOLS = BK / LANES;     // scores of a thread per row: 8
constexpr int QS = BQ + 4;            // row stride of the transposed q and p tiles
constexpr int KS = BK + 4;            // row stride of the transposed k tile
constexpr float NEG_INF = -1e30f;

static_assert(ROWS == 4, "a thread's rows are read as one float4");
static_assert(ROWS * SCOLS <= 32, "the live mask is one 32-bit word");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_rounded(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_rounded(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// q tile [D][QS] + k or v tile [D][KS] (the v tile [BK][D] is smaller) +
// p tile [BK][QS], in floats
template <int D>
constexpr size_t smem_floats() {
  return (size_t)D * QS + (size_t)D * KS + (size_t)BK * QS;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int hq,
                       int hkv, int sq, int sk, float scale, int causal,
                       int window) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;          // qt[d * QS + r]: row r of the q tile, transposed
  float* kv = qt + D * QS;   // kv[d * KS + c] (k, transposed), then kv[c * D + d] (v)
  float* pt = kv + D * KS;   // pt[c * QS + r]: probabilities, transposed
  constexpr int COLS = D / LANES;  // output columns of a thread

  const int ih = blockIdx.x;
  const int ib = blockIdx.y;
  const int iq = gridDim.z - 1 - blockIdx.z;  // longest causal rows first
  const int ikv = ih / (hq / hkv);
  const int q_start = iq * BQ;
  const int q_last = min(q_start + BQ, sq) - 1;
  const size_t q_off = ((size_t)ib * hq + ih) * sq * D;
  const size_t kv_off = ((size_t)ib * hkv + ikv) * sk * D;
  const T* qb = q + q_off;
  const T* kb = k + kv_off;
  const T* vb = v + kv_off;
  T* ob = o + q_off;

  const int tid = threadIdx.x;
  const int ty = tid / LANES;  // rows ty * ROWS .. ty * ROWS + 3 of the tile
  const int tx = tid % LANES;  // key / output columns tx, tx + LANES, ...

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    qt[d * QS + r] = q_start + r < sq ? to_f32(qb[(size_t)(q_start + r) * D + d]) : 0.f;
  }

  float m[ROWS], l[ROWS], acc[ROWS][COLS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < COLS; ++j) acc[i][j] = 0.f;
  }

  // keys that some row of the tile may see: [k_lo, k_hi)
  const int k_hi = causal ? min(sk, q_last + 1) : sk;
  const int k_lo = window > 0 ? max(0, q_start - window + 1) : 0;
  for (int k_start = k_lo / BK * BK; k_start < k_hi; k_start += BK) {
    __syncthreads();  // the previous tile's v and p are consumed
    for (int i = tid; i < BK * D; i += THREADS) {
      const int c = i / D, d = i % D;
      kv[d * KS + c] = k_start + c < sk ? to_f32(kb[(size_t)(k_start + c) * D + d]) : 0.f;
    }
    __syncthreads();

    float s[ROWS][SCOLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < SCOLS; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(qt + d * QS + ty * ROWS);
      const float qr[ROWS] = {qa.x, qa.y, qa.z, qa.w};
      float kc[SCOLS];
#pragma unroll
      for (int j = 0; j < SCOLS; ++j) kc[j] = kv[d * KS + tx + j * LANES];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < SCOLS; ++j) s[i][j] = fmaf(qr[i], kc[j], s[i][j]);
    }

    // online softmax over the tile: a row's 64 scores lie on 8 lanes
    float alpha[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int row = q_start + ty * ROWS + i;
      unsigned live = 0;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < SCOLS; ++j) {
        const int col = k_start + tx + j * LANES;
        const bool ok = col < sk && (!causal || row >= col) &&
                        (window <= 0 || row - col < window);
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        live |= (ok ? 1u : 0u) << j;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < LANES; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < SCOLS; ++j) {
        s[i][j] = (live >> j) & 1u ? expf(s[i][j] - m_new) : 0.f;
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 1; off < LANES; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      alpha[i] = expf(m[i] - m_new);
      l[i] = alpha[i] * l[i] + sum;
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < SCOLS; ++j)
      *reinterpret_cast<float4*>(pt + (tx + j * LANES) * QS + ty * ROWS) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();  // the k tile is consumed and p is written

    for (int i = tid; i < BK * D; i += THREADS) {
      const int c = i / D, d = i % D;
      kv[c * D + d] = k_start + c < sk ? to_f32(vb[(size_t)(k_start + c) * D + d]) : 0.f;
    }
    __syncthreads();

    // acc = acc * alpha + p.v, the tile's product summed apart first (as
    // the TPU kernel's dot): a running sum over all sk keys would lose
    // float32 digits as it grows
    float pv[ROWS][COLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j) pv[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(pt + c * QS + ty * ROWS);
      const float pr[ROWS] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const float vv = kv[c * D + tx + j * LANES];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) pv[i][j] = fmaf(pr[i], vv, pv[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j) acc[i][j] = fmaf(acc[i][j], alpha[i], pv[i][j]);
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = q_start + ty * ROWS + i;
    if (row >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < COLS; ++j)
      store_rounded(ob + (size_t)row * D + tx + j * LANES, acc[i][j] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b, int hq,
           int hkv, int sq, int sk, float scale, int causal, int window,
           cudaStream_t stream) {
  constexpr size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(hq, b, (sq + BQ - 1) / BQ);
  flash_attention_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, sq, sk, scale,
      causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// q (b, hq, sq, dh), k and v (b, hkv, sk, dh), o like q; all contiguous,
// float32 (bf16 = 0) or bfloat16 (bf16 = 1); window <= 0 means none.
// Returns the cudaError of the launch; an unsupported dh is
// cudaErrorInvalidValue (the wrapper names the supported set).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int b, int hq, int hkv, int sq,
                                   int sk, int dh, int bf16, float scale,
                                   int causal, int window, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_CASE(D)                                                          \
  case D:                                                                      \
    return bf16 ? launch<__nv_bfloat16, D>(q, k, v, o, b, hq, hkv, sq, sk,    \
                                           scale, causal, window, st)         \
                : launch<float, D>(q, k, v, o, b, hq, hkv, sq, sk, scale,     \
                                   causal, window, st);
  switch (dh) {
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}
