// Hand-written Hopper (sm_90a) kernels of the PageRank main path and of
// batched personalized PageRank.
//
// The kernels read the graph as an in-CSR over dst vertices: in_ptr
// (n_pad + 1 row pointers, padding rows empty), src (one source id per
// edge, dst-sorted) and optional per-edge weights.  Vertices are grouped in
// dst blocks of `block` rows, the Gauss-Seidel unit of the reference.
//
// One device routine does the work of a dst block for both kernels
// (accumulate_block): the block's edges [in_ptr[v0], in_ptr[v0 + block))
// are one contiguous range, so every thread of the CTA streams a strided
// share of it (coalesced src/weight loads, independent gathers in flight)
// into a shared-memory chunk; then each warp sums the chunk slices of the
// rows it owns, lanes strided over the slice and a fixed xor-shuffle tree
// across lanes.  Each row has one owner warp and chunks are added in order,
// so the sums are deterministic and use no atomics.  A high in-degree row
// costs its owner warp one shared-memory pass, not a chain of dependent
// global loads.
//
// The C entry points take raw device pointers and the caller's stream, and
// return cudaGetLastError() after the launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kChunk = 4096;         // edges staged in shared memory per round
constexpr int kSpmvThreads = 256;    // spmv_csr_acc: one CTA per dst block
constexpr int kGsThreads = 1024;     // gs_pass(_multi): the one persistent CTA
constexpr int kChunkFloats = 32768;  // gs_pass_multi: staged values per round

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// sm_acc[r] = sum over in-edges e of row v0 + r of x[src_e] * scale[src_e]
// * w_e (scale and w optional).  Shared memory: sm_val[kChunk],
// sm_acc[block], sm_ptr[block + 1].  Ends with a barrier, so sm_acc is
// visible to every thread on return.  `x` may be written by this CTA
// between calls (the Gauss-Seidel state), so it is read with plain loads,
// never through the read-only cache.
__device__ void accumulate_block(int v0, int block,
                                 const int* __restrict__ in_ptr,
                                 const int* __restrict__ src,
                                 const float* __restrict__ weights,
                                 const float* x,
                                 const float* __restrict__ scale,
                                 float* sm_val, float* sm_acc, int* sm_ptr) {
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int nwarps = blockDim.x / kWarp;
  for (int i = tid; i <= block; i += blockDim.x) sm_ptr[i] = in_ptr[v0 + i];
  for (int i = tid; i < block; i += blockDim.x) sm_acc[i] = 0.f;
  __syncthreads();
  const int e0 = sm_ptr[0];
  const int e1 = sm_ptr[block];
  for (int c0 = e0; c0 < e1; c0 += kChunk) {
    const int c1 = min(c0 + kChunk, e1);
    for (int e = c0 + tid; e < c1; e += blockDim.x) {
      const int s = src[e];
      float val = scale != nullptr ? x[s] * scale[s] : x[s];
      if (weights != nullptr) val *= weights[e];
      sm_val[e - c0] = val;
    }
    __syncthreads();
    for (int r = warp; r < block; r += nwarps) {
      const int lo = max(sm_ptr[r], c0);
      const int hi = min(sm_ptr[r + 1], c1);
      if (lo < hi) {  // uniform across the warp
        float part = 0.f;
        for (int e = lo + lane; e < hi; e += kWarp) part += sm_val[e - c0];
        part = warp_sum(part);
        if (lane == 0) sm_acc[r] += part;
      }
    }
    __syncthreads();
  }
}

size_t smem_bytes(int block) {
  return sizeof(float) * (kChunk + block) + sizeof(int) * (block + 1);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Jacobi SpMV: acc[v] = sum_e w_e * contrib[src_e].  Grid: one CTA per dst
// block.
__global__ void __launch_bounds__(kSpmvThreads)
spmv_csr_acc_kernel(const float* __restrict__ contrib,
                    const int* __restrict__ in_ptr,
                    const int* __restrict__ src,
                    const float* __restrict__ weights,
                    float* __restrict__ acc, int block) {
  extern __shared__ float smem[];
  float* sm_val = smem;
  float* sm_acc = smem + kChunk;
  int* sm_ptr = reinterpret_cast<int*>(sm_acc + block);
  const int v0 = blockIdx.x * block;
  accumulate_block(v0, block, in_ptr, src, weights, contrib, nullptr,
                   sm_val, sm_acc, sm_ptr);
  for (int i = threadIdx.x; i < block; i += blockDim.x) acc[v0 + i] = sm_acc[i];
}

// One blocked Gauss-Seidel pass, in place on `pr` (the caller passes a copy
// of the previous ranks).  A single CTA walks the dst blocks in order: it
// sums block db from `pr` as it stands (blocks below db already hold this
// pass's values, db and above the previous pass's), then, after the
// barrier that ends the sum, commits
//     new = (base * bias + dmass + d * acc) * vmask
// with frozen lanes keeping their value, and a second barrier makes the
// commit visible to the next block's gathers.  The epilogue uses
// round-to-nearest intrinsics so it is not contracted into an FMA and
// rounds as the plain version's separate torch ops do.
__global__ void __launch_bounds__(kGsThreads)
gs_pass_kernel(float* pr, const float* __restrict__ inv_out,
               const float* __restrict__ vmask, const float* __restrict__ bias,
               const uint8_t* __restrict__ frozen,
               const float* __restrict__ params,
               const int* __restrict__ in_ptr, const int* __restrict__ src,
               const float* __restrict__ weights, int n_blocks, int block) {
  extern __shared__ float smem[];
  float* sm_val = smem;
  float* sm_acc = smem + kChunk;
  int* sm_ptr = reinterpret_cast<int*>(sm_acc + block);
  const float base = params[0];
  const float d = params[1];
  const float dmass = params[2];
  for (int db = 0; db < n_blocks; ++db) {
    const int v0 = db * block;
    accumulate_block(v0, block, in_ptr, src, weights, pr, inv_out,
                     sm_val, sm_acc, sm_ptr);
    for (int i = threadIdx.x; i < block; i += blockDim.x) {
      const int v = v0 + i;
      const float vm = vmask[v];
      const float bz = bias != nullptr ? bias[v] : vm;
      const float head = __fadd_rn(__fmul_rn(base, bz), dmass);
      float next = __fmul_rn(__fadd_rn(head, __fmul_rn(d, sm_acc[i])), vm);
      if (frozen != nullptr && frozen[v]) next = pr[v];
      pr[v] = next;
    }
    __syncthreads();
  }
}

// gs_pass_multi: edges staged per round, kChunk for b <= 8 (so b = 1
// stages exactly as gs_pass does), fewer for wider batches.
__host__ __device__ inline int multi_chunk_edges(int b) {
  return kChunkFloats / b < kChunk ? kChunkFloats / b : kChunk;
}

size_t multi_smem_bytes(int block, int b) {
  return sizeof(float) * (static_cast<size_t>(multi_chunk_edges(b)) * b +
                          static_cast<size_t>(block) * b) +
         sizeof(int) * (block + 1);
}

// One blocked Gauss-Seidel pass over b rank rows at once, in place on `pr`
// (the caller passes a copy of the previous state).  The state is
// vertex-major, (n_blocks, block, b): the b rows of vertex v are the b
// contiguous floats at pr[v*b], so an edge's gather reads them in one
// 32 B sector at b = 8, and the in-CSR index stream is read once per edge
// for the whole batch.  The walk is gs_pass_kernel's: block db sums from
// `pr` as it stands (blocks below db at this pass's values), then, after
// the barrier that ends the sum, commits
//     new[v, j] = (tele[v, j] * coef[j] + d * acc[v, j]) * vmask[v]
// for every row j not in `frozen`; a frozen row is not written and keeps
// its value bit for bit.  coef[j] = (1-d) + d*dmass[j] is formed on the
// card by the caller.  One thread stages one edge: its source id, then
// the b contiguous values of that source, so each thread has b
// independent loads in flight instead of a chain per value.  Each
// vertex has one owner warp: for b <= 32 its lanes split into groups of
// bp = next power of two >= b lanes, lane l sums row l % bp over every
// (32/bp)-th edge of the slice, and an xor tree over lanes bp apart adds
// the groups (b = 1 is gs_pass's own order); for b > 32 each lane sums
// its rows serially.  Fixed order, no atomics.  Products and the epilogue
// round as the plain version's separate torch ops do.
__global__ void __launch_bounds__(kGsThreads)
gs_pass_multi_kernel(float* pr, const float* __restrict__ inv_out,
                     const float* __restrict__ vmask,
                     const float* __restrict__ tele,
                     const float* __restrict__ coef,
                     const uint8_t* __restrict__ frozen, float d,
                     const int* __restrict__ in_ptr,
                     const int* __restrict__ src,
                     const float* __restrict__ weights, int n_blocks,
                     int block, int b) {
  extern __shared__ float smem[];
  const int chunk = multi_chunk_edges(b);
  float* sm_val = smem;
  float* sm_acc = smem + static_cast<size_t>(chunk) * b;
  int* sm_ptr = reinterpret_cast<int*>(sm_acc + static_cast<size_t>(block) * b);
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int nwarps = blockDim.x / kWarp;
  int bp = 1;
  while (bp < b && bp < kWarp) bp <<= 1;
  const int lane_row = lane % bp;       // b <= 32: the row this lane sums
  const int lane_edge = lane / bp;      // and its first edge of the slice
  const int edge_step = kWarp / bp;
  const int rows_in_block = block * b;
  for (int db = 0; db < n_blocks; ++db) {
    const int v0 = db * block;
    for (int i = tid; i <= block; i += blockDim.x) sm_ptr[i] = in_ptr[v0 + i];
    for (int i = tid; i < rows_in_block; i += blockDim.x) sm_acc[i] = 0.f;
    __syncthreads();
    const int e0 = sm_ptr[0];
    const int e1 = sm_ptr[block];
    for (int c0 = e0; c0 < e1; c0 += chunk) {
      const int c1 = min(c0 + chunk, e1);
      for (int k = tid; k < c1 - c0; k += blockDim.x) {
        const int e = c0 + k;
        const int s = src[e];
        const float inv = inv_out[s];
        const float* row = pr + static_cast<size_t>(s) * b;
        float* staged = sm_val + k * b;
        if (weights != nullptr) {
          const float w = weights[e];
#pragma unroll 8
          for (int j = 0; j < b; ++j) staged[j] = row[j] * inv * w;
        } else {
#pragma unroll 8
          for (int j = 0; j < b; ++j) staged[j] = row[j] * inv;
        }
      }
      __syncthreads();
      for (int r = warp; r < block; r += nwarps) {
        const int lo = max(sm_ptr[r], c0);
        const int hi = min(sm_ptr[r + 1], c1);
        if (lo >= hi) continue;  // uniform across the warp
        if (b <= kWarp) {
          float part = 0.f;
          if (lane_row < b) {
            for (int e = lo + lane_edge; e < hi; e += edge_step) {
              part += sm_val[(e - c0) * b + lane_row];
            }
          }
#pragma unroll
          for (int off = kWarp / 2; off > 0; off >>= 1) {
            const float other = __shfl_xor_sync(0xffffffffu, part, off);
            if (off >= bp) part += other;
          }
          if (lane < b) sm_acc[r * b + lane] += part;
        } else {
          for (int j = lane; j < b; j += kWarp) {
            float part = 0.f;
            for (int e = lo; e < hi; ++e) part += sm_val[(e - c0) * b + j];
            sm_acc[r * b + j] += part;
          }
        }
      }
      __syncthreads();
    }
    for (int i = tid; i < rows_in_block; i += blockDim.x) {
      const int r = i / b;
      const int j = i - r * b;
      if (frozen != nullptr && frozen[j]) continue;
      const size_t idx = static_cast<size_t>(v0 + r) * b + j;
      const float base = __fmul_rn(tele[idx], coef[j]);
      pr[idx] = __fmul_rn(__fadd_rn(base, __fmul_rn(d, sm_acc[i])),
                          vmask[v0 + r]);
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int spmv_csr_acc(const float* contrib, const int* in_ptr,
                            const int* src, const float* weights, float* acc,
                            int n_blocks, int block, cudaStream_t stream) {
  const size_t bytes = smem_bytes(block);
  cudaError_t err = allow_smem(spmv_csr_acc_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  spmv_csr_acc_kernel<<<n_blocks, kSpmvThreads, bytes, stream>>>(
      contrib, in_ptr, src, weights, acc, block);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gs_pass(float* pr, const float* inv_out, const float* vmask,
                       const float* bias, const uint8_t* frozen,
                       const float* params, const int* in_ptr, const int* src,
                       const float* weights, int n_blocks, int block,
                       cudaStream_t stream) {
  const size_t bytes = smem_bytes(block);
  cudaError_t err = allow_smem(gs_pass_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  gs_pass_kernel<<<1, kGsThreads, bytes, stream>>>(
      pr, inv_out, vmask, bias, frozen, params, in_ptr, src, weights,
      n_blocks, block);
  return static_cast<int>(cudaGetLastError());
}

// The shared memory one gs_pass_multi CTA needs, and the most a CTA may
// opt into on `device` (a negated cudaError_t on failure): the wrapper
// rejects a (block, b) that does not fit before it launches.
extern "C" size_t gs_pass_multi_smem_bytes(int block, int b) {
  return multi_smem_bytes(block, b);
}

extern "C" int smem_per_block_optin(int device) {
  int bytes = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? bytes : -static_cast<int>(err);
}

extern "C" int gs_pass_multi(float* pr, const float* inv_out,
                             const float* vmask, const float* tele,
                             const float* coef, const uint8_t* frozen,
                             float d, const int* in_ptr, const int* src,
                             const float* weights, int n_blocks, int block,
                             int b, cudaStream_t stream) {
  const size_t bytes = multi_smem_bytes(block, b);
  cudaError_t err = allow_smem(gs_pass_multi_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  gs_pass_multi_kernel<<<1, kGsThreads, bytes, stream>>>(
      pr, inv_out, vmask, tele, coef, frozen, d, in_ptr, src, weights,
      n_blocks, block, b);
  return static_cast<int>(cudaGetLastError());
}
