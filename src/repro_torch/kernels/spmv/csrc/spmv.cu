// Hand-written Hopper (sm_90a) kernels of the PageRank main path.
//
// Both kernels read the graph as an in-CSR over dst vertices: in_ptr
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
constexpr int kGsThreads = 1024;     // gs_pass: the one persistent CTA

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
