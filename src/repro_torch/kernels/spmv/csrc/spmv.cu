// Hand-written Hopper (sm_90a) kernels of the PageRank main path and of
// batched personalized PageRank.
//
// The kernels read the graph as an in-CSR over dst vertices: in_ptr
// (n_pad + 1 row pointers, padding rows empty), src (one source id per
// edge, dst-sorted) and optional per-edge weights.  Vertices are grouped in
// dst blocks of `block` rows, the Gauss-Seidel unit of the reference.
//
// Each kernel has its own device code:
//
// * spmv_csr_acc (Jacobi SpMV) splits the merge path of row ends and edges
//   into equal shares, one per CTA of a grid that is resident at once, so a
//   hub row costs as much as any other edges and no SM waits on one block.
// * gs_pass (one blocked Gauss-Seidel pass) is one CTA walking the dst
//   blocks in order; each block's sum is accumulate_block.
// * gs_pass_multi (the same pass over b PPR rows) gives each row a
//   cluster of CTAs and spreads each block's vertices over it; each
//   CTA's walk stages the next round of edges with cp.async while it sums
//   the current one.
//
// Every sum is taken in a fixed order with no atomics, so two launches on
// one input give the same bits.  The C entry points take raw device
// pointers and the caller's stream, and return cudaGetLastError() after the
// launch (0 on success).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kChunk = 4096;         // edges staged in shared memory per round
constexpr int kGsThreads = 1024;     // gs_pass: threads of the walking CTA
constexpr int kChunkFloats = 32768;  // the parent order of gs_pass_multi: see multi_chunk_edges

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
// visible to every thread on return.  The block's edges [in_ptr[v0],
// in_ptr[v0 + block)) are one contiguous range: every thread streams a
// strided share of a chunk into shared memory, then each warp sums the
// chunk slices of the rows it owns, lanes strided over the slice and a
// fixed xor-shuffle tree across lanes, chunks added in order.  `x` may be
// written by this CTA between calls (the Gauss-Seidel state), so it is read
// with plain loads, never through the read-only cache.
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

// ---------------------------------------------------------------------------
// spmv_csr_acc: Jacobi SpMV, acc[v] = sum_e w_e * contrib[src_e].
//
// Replaces spmv_blocked (src/repro/kernels/spmv/kernel.py), whose one-hot
// tile products are a TPU device for the gather the H100 has.  Bound: bytes
// (src, in_ptr, weights and acc once, contrib gathered from L2), a few
// flops an edge.  What held the first version back was balance: one CTA per
// dst block left 24 of 32 lanes idle on rows of 8 edges and let the block
// of a hub row run alone.  Design (merge-path SpMV): the merge path of the
// n_rows row ends and the m edges (a row's end after its edges) has
// n_rows + m items; a grid of as many CTAs as the card holds at once takes
// equal shares of it.  Each CTA finds its share's first and last
// coordinate with a 128-way search over in_ptr (two halves of the CTA, one
// search each), stages the share's row ends and edge values
// contrib[src] * w in shared memory (src and weights in 16-byte loads where
// aligned, contrib through the read-only path: nothing writes it during the
// launch), and each thread walks an equal run of merge items: an edge adds
// to its running sum, a row end writes the row out.  A row cut between
// threads is joined by a segmented scan across the CTA (Kogge-Stone in each
// warp, the eight warp totals in order), a row cut between CTAs by a second
// small kernel that adds the CTAs' carries in CTA order.  A row's sum is
// thus sequential within a thread, a fixed tree across threads and
// sequential across tiles and CTAs: one order, no atomics.
// ---------------------------------------------------------------------------

constexpr int kCsrThreads = 256;
constexpr int kCsrItems = 16;                       // merge items a thread walks, at most
constexpr int kCsrTile = kCsrThreads * kCsrItems;   // merge items staged per tile
constexpr int kCsrWarps = kCsrThreads / kWarp;
constexpr int kSearchWays = kCsrThreads / 2;        // one half of the CTA per search

// Searches of merge-path diagonals d_a (threads 0..127) and d_b (128..255)
// at once, `levels` rounds of 128 probes each.  The predicate "row x ends
// before edge d - x - 1", in_ptr[x + 1] <= d - x - 1, holds on a prefix of
// x; the first x where it fails is the number of rows ended at d.  Writes
// (x_a, d_a - x_a, x_b, d_b - x_b) to out; every thread calls it.
__device__ void merge_search2(const int* __restrict__ in_ptr, int n_rows, int m,
                              int d_a, int d_b, int levels, int* cnt, int* out) {
  const int tid = threadIdx.x;
  const int half = tid / kSearchWays;
  const int i = tid % kSearchWays;
  const int d = half ? d_b : d_a;
  int lo = max(0, d - m);
  int hi = min(d, n_rows);
  for (int lv = 0; lv < levels; ++lv) {
    const long long len = hi - lo;
    const int p = lo + static_cast<int>(i * len / kSearchWays);
    const bool pred = len > 0 && __ldg(in_ptr + p + 1) <= d - p - 1;
    const unsigned ballot = __ballot_sync(0xffffffffu, pred);
    int* c_lv = cnt + (lv & 1) * kCsrWarps;  // two buffers: no barrier before reuse
    if (tid % kWarp == 0) c_lv[tid / kWarp] = __popc(ballot);
    __syncthreads();
    const int* c_half = c_lv + half * (kCsrWarps / 2);
    const int c = c_half[0] + c_half[1] + c_half[2] + c_half[3];
    if (len > 0) {
      const int new_lo = c == 0 ? lo : lo + static_cast<int>((c - 1) * len / kSearchWays) + 1;
      const int new_hi = c == kSearchWays ? hi : lo + static_cast<int>(c * len / kSearchWays);
      lo = new_lo;
      hi = new_hi;
    }
  }
  if (i == 0) {
    out[2 * half] = lo;
    out[2 * half + 1] = d - lo;
  }
}

__device__ __forceinline__ void stage_edge(const float* __restrict__ contrib,
                                           const float* __restrict__ weights,
                                           float* s_val, int j, int s, int e) {
  const float c = __ldg(contrib + s);
  s_val[j] = weights != nullptr ? c * __ldg(weights + e) : c;
}

__global__ void __launch_bounds__(kCsrThreads)
spmv_csr_acc_kernel(const float* __restrict__ contrib,
                    const int* __restrict__ in_ptr,
                    const int* __restrict__ src,
                    const float* __restrict__ weights,
                    float* __restrict__ acc, int n_rows, int m, int share,
                    int levels, int* __restrict__ carry_row,
                    float* __restrict__ carry_val) {
  __shared__ int s_end[kCsrTile + 1];   // in_ptr[x + 1] of the tile's rows
  __shared__ float s_val[kCsrTile];     // contrib[src_e] * w_e of its edges
  __shared__ int s_cnt[2 * kCsrWarps];
  __shared__ int s_coord[4];
  __shared__ int s_wkey[kCsrWarps];
  __shared__ float s_wval[kCsrWarps];
  __shared__ int s_tile_key;
  __shared__ float s_tile_val;
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int total = n_rows + m;
  const int d_begin = min(static_cast<int>(blockIdx.x) * share, total);
  const int d_end = min(d_begin + share, total);
  const int n_tiles = max(1, (d_end - d_begin + kCsrTile - 1) / kCsrTile);
  const int tile_items = (d_end - d_begin + n_tiles - 1) / n_tiles;
  float carry = 0.f;  // the open row's sum carried from the CTA's last tile
  int carry_key = -1;
  for (int t = 0; t < n_tiles; ++t) {
    const int t0 = min(d_begin + t * tile_items, d_end);
    const int t1 = min(t0 + tile_items, d_end);
    merge_search2(in_ptr, n_rows, m, t0, t1, levels, s_cnt, s_coord);
    __syncthreads();
    const int x0 = s_coord[0], y0 = s_coord[1];
    const int x1 = s_coord[2], y1 = s_coord[3];
    const int nr = x1 - x0;  // row ends in the tile
    const int ne = y1 - y0;  // edges in the tile
    for (int i = tid; i <= nr; i += kCsrThreads) {
      s_end[i] = __ldg(in_ptr + min(x0 + 1 + i, n_rows));
    }
    // edge values: a scalar head up to a 16-byte boundary, int4/float4 body
    const int head = min((4 - (y0 & 3)) & 3, ne);
    if (tid < head) stage_edge(contrib, weights, s_val, tid, __ldg(src + y0 + tid), y0 + tid);
    const int n4 = (ne - head) / 4;
    const int4* src4 = reinterpret_cast<const int4*>(src + y0 + head);
    const float4* w4 = reinterpret_cast<const float4*>(
        weights != nullptr ? weights + y0 + head : nullptr);
    // every id first, then every gather: up to 16 gathers a thread in flight
    constexpr int kVecs = kCsrItems / 4;
    int4 ids[kVecs];
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      if (tid + u * kCsrThreads < n4) ids[u] = __ldg(src4 + tid + u * kCsrThreads);
    }
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int v = tid + u * kCsrThreads;
      if (v < n4) {
        const int j = head + 4 * v;
        const float c0 = __ldg(contrib + ids[u].x), c1 = __ldg(contrib + ids[u].y);
        const float c2 = __ldg(contrib + ids[u].z), c3 = __ldg(contrib + ids[u].w);
        if (weights != nullptr) {
          const float4 w = __ldg(w4 + v);
          s_val[j] = c0 * w.x;
          s_val[j + 1] = c1 * w.y;
          s_val[j + 2] = c2 * w.z;
          s_val[j + 3] = c3 * w.w;
        } else {
          s_val[j] = c0;
          s_val[j + 1] = c1;
          s_val[j + 2] = c2;
          s_val[j + 3] = c3;
        }
      }
    }
    for (int j = head + 4 * n4 + tid; j < ne; j += kCsrThreads) {
      stage_edge(contrib, weights, s_val, j, __ldg(src + y0 + j), y0 + j);
    }
    __syncthreads();

    // this thread's run of merge items: local diagonals [dt, dt_end)
    const int len = nr + ne;
    const int ipt = (len + kCsrThreads - 1) / kCsrThreads;
    const int dt = min(tid * ipt, len);
    const int dt_end = min(dt + ipt, len);
    int xl = max(0, dt - ne), xh = min(dt, nr);
    while (xl < xh) {
      const int piv = (xl + xh) >> 1;
      if (s_end[piv] - y0 <= dt - piv - 1) xl = piv + 1; else xh = piv;
    }
    int x = xl, y = dt - xl;
    const int x_start = x;
    // thread 0 continues the row the CTA's previous tile left open
    float run = (tid == 0 && carry_key == x0) ? carry : 0.f;
    float first_val = 0.f;
    bool emitted = false;
    for (int k = dt; k < dt_end; ++k) {
      if (y < s_end[x] - y0) {
        run += s_val[y];
        ++y;
      } else {  // row x0 + x ends
        if (!emitted) {
          first_val = run;
          emitted = true;
        } else {
          acc[x0 + x] = run;
        }
        run = 0.f;
        ++x;
      }
    }

    // segmented inclusive scan of (open row, run) over the CTA's threads;
    // keys never decrease from thread to thread
    int key = x;
    float val = run;
#pragma unroll
    for (int off = 1; off < kWarp; off <<= 1) {
      const int k_up = __shfl_up_sync(0xffffffffu, key, off);
      const float v_up = __shfl_up_sync(0xffffffffu, val, off);
      if (lane >= off && k_up == key) val = v_up + val;
    }
    if (lane == kWarp - 1) {
      s_wkey[warp] = key;
      s_wval[warp] = val;
    }
    __syncthreads();
    int pre_key = -1;  // the warps before this one, joined in order
    float pre_val = 0.f;
    for (int w = 0; w < warp; ++w) {
      if (s_wkey[w] == pre_key) {
        pre_val = pre_val + s_wval[w];
      } else {
        pre_key = s_wkey[w];
        pre_val = s_wval[w];
      }
    }
    if (pre_key == key) val = pre_val + val;
    int ex_key = __shfl_up_sync(0xffffffffu, key, 1);
    float ex_val = __shfl_up_sync(0xffffffffu, val, 1);
    if (lane == 0) {
      ex_key = pre_key;
      ex_val = pre_val;
    }
    if (emitted) {
      acc[x0 + x_start] = ex_key == x_start ? ex_val + first_val : first_val;
    }
    if (tid == kCsrThreads - 1) {
      s_tile_key = x0 + key;
      s_tile_val = val;
    }
    __syncthreads();
    carry_key = s_tile_key;
    carry = s_tile_val;
  }
  if (tid == 0) {
    carry_row[blockIdx.x] = carry_key;
    carry_val[blockIdx.x] = carry;
  }
}

// Adds the carries of the CTAs that left row r open, in CTA order, to the
// part of row r that the CTA which ended it wrote.
__global__ void spmv_carry_kernel(const int* __restrict__ carry_row,
                                  const float* __restrict__ carry_val,
                                  float* __restrict__ acc, int n_ctas, int n_rows) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_ctas) return;
  const int row = carry_row[c];
  if (row < 0 || row >= n_rows || (c > 0 && carry_row[c - 1] == row)) return;
  float s = carry_val[c];
  for (int k = c + 1; k < n_ctas && carry_row[k] == row; ++k) s = s + carry_val[k];
  acc[row] = s + acc[row];
}

// Rounds of the 128-way search that pin a diagonal among n_rows + 1 rows.
int search_levels(int n_rows) {
  int levels = 1;
  for (long long len = n_rows + 1; len > kSearchWays;
       len = (len + kSearchWays - 1) / kSearchWays) {
    ++levels;
  }
  return levels;
}

// One blocked Gauss-Seidel pass, in place on `pr` (the caller passes a copy
// of the previous ranks).  Replaces spmv_gs_pass (src/repro/kernels/spmv/
// kernel.py).  A single CTA walks the dst blocks in order: it sums block db
// from `pr` as it stands (blocks below db already hold this pass's values,
// db and above the previous pass's), then, after the barrier that ends the
// sum, commits
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

// ---------------------------------------------------------------------------
// gs_pass_multi: one blocked Gauss-Seidel pass over b rank rows, in place on
// the vertex-major (n_blocks, block, b) state `pr` (the caller passes a
// copy of the previous state).  Block db sums from `pr` as it stands
// (blocks below db at this pass's values), then commits
//     new[v, j] = (tele[v, j] * coef[j] + d * acc[v, j]) * vmask[v]
// for every row j not in `frozen`; a frozen row is not written and keeps its
// value bit for bit.
//
// Replaces spmv_gs_pass_multi (src/repro/kernels/spmv/kernel.py).  Bound:
// the order of the walk, not bytes: block db must see every block below it
// committed, so a pass is n_blocks dependent steps; within a step, the rate
// at which an SM issues scattered gathers of sources from L2, and the
// serial adds of the block's longest row (its edges over the G lane groups
// of the order below).  Design:
//
// * Rows across SMs, and a row's blocks across a cluster.  Rows are
//   independent within a pass, so each row has its own cluster of C CTAs
//   on C SMs (C as large as the card holds for all rows at once, up to
//   8).  Every CTA walks all
//   dst blocks and owns the 1/C of each block's vertices it sums and
//   commits, so it gathers only their edges.  Before a block's first
//   round the cluster meets at a barrier; then each CTA reads the values
//   its peers committed for the block above from their shared memory.
// * One gather an edge.  The sums read pr[s] * inv_out[s]; a first kernel
//   writes that product for the whole state twice into the scratch `q`:
//   the old copy, which the walk never writes, and the new one, which each
//   commit writes beside pr.  A source below the block being summed is read
//   from the new copy, one in it or above from the old (peers commit their
//   parts of a block while a CTA may still be gathering for its own).  An
//   edge costs its CTA one 16-byte copy, the aligned quad that holds its
//   row's value (cp.async.cg: through L2, where the peers' writes are,
//   never a stale L1 line).
// * The next round arrives while this one is summed.  A round is up to
//   kRoundEdges edges of a CTA's part of one block.  While round k is
//   summed, every thread has already issued the copies of round k + 1
//   into the other of two buffers (the quads, and with a block's first round
//   its in_ptr slice, tele, vmask and inv_out); the src ids and weights
//   those copies read come two rounds ahead, into a ring of three.  A
//   source below the block being summed is final; a source in it or above
//   holds the previous pass's value until its own block commits; so the
//   copies are exact but for the first round of block db + 1, whose
//   sources in block db are copied before db commits.  Before a round is
//   summed one pass takes each edge's value out of its quad, and, in a
//   block's first round, takes those sources from the values the cluster
//   committed instead.  A block step waits on no global round trip.
// * The sum order depends on b alone, not on C or how rounds cut a
//   block.  For b <= 32 it is the parent kernel's, so results do not move:
//   G = 32 / bp lane groups (bp = the next power of two >= b) sum every
//   G-th edge of a row's slice of each chunk of multi_chunk_edges(b) edges
//   from the block's first edge, an xor tree joins the groups and the chunk
//   sums are added in order (b = 1 is gs_pass's order).  For b > 32 each
//   row is summed in edge order, the plain version's order.  A row cut by a
//   round keeps its lane partials in shared memory (carry) until its slice
//   ends.  Loads run eight edges ahead of the adds; the adds keep their
//   order.  The last round of a block commits each vertex as its sum ends.
// * Products and the epilogue use round-to-nearest intrinsics, so nothing
//   is contracted and each step rounds as the plain version's torch ops.
// ---------------------------------------------------------------------------

// The parent order's chunk: kChunk edges for b <= 8 (so b = 1 sums exactly
// as gs_pass does), fewer for wider batches.
__host__ __device__ inline int multi_chunk_edges(int b) {
  return kChunkFloats / b < kChunk ? kChunkFloats / b : kChunk;
}

constexpr int kMultiThreads = 512;
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int kRoundEdges = 2048;  // edges staged per round

__host__ __device__ inline int next_pow2(int b) {
  int p = 1;
  while (p < b) p <<= 1;
  return p;
}

// Shared-memory layout of one gs_pass_multi CTA owning `part` vertices of
// each block, in floats (ints take a float's slot): two buffers of quads
// and of values, three of ids and weights, two block slots, the
// accumulator, two of committed values and two carries.
struct MultiLayout {
  int quad, vals, tele, src, w, acc, cb, vmask, inv, ptr, carry, total;
  __host__ __device__ explicit MultiLayout(int part) {
    int at = 0;
    quad = take(at, 2 * kRoundEdges * 4);
    vals = take(at, 2 * kRoundEdges);
    tele = take(at, 2 * part);
    src = take(at, 3 * kRoundEdges);
    w = take(at, 3 * kRoundEdges);
    acc = take(at, part);
    cb = take(at, 2 * part);
    vmask = take(at, 2 * part);
    inv = take(at, 2 * part);
    ptr = take(at, 2 * (part + 1));
    carry = take(at, 2 * kWarp);
    total = at;
  }
  // n floats at `at`, which then moves on to the next 16-byte boundary
  __host__ __device__ static int take(int& at, int n) {
    const int start = at;
    at += (n + 3) / 4 * 4;
    return start;
  }
};

size_t multi_smem_bytes(int block, int cluster) {
  const int part = (block + cluster - 1) / cluster;
  return sizeof(float) * static_cast<size_t>(MultiLayout(part).total);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of Bytes from global to shared, cached in L1 (.ca: read-only
// data) or, for 16 bytes, in L2 only (.cg: data other SMs write).
template <int Bytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "n"(Bytes));
}

__device__ __forceinline__ void cp_async_cg16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// q[0] = q[1] = pr * inv_out[vertex] over the whole (n_pad, b) state (q
// holds two states, n floats apart).
__global__ void scale_state_kernel(float* __restrict__ q, const float* __restrict__ pr,
                                   const float* __restrict__ inv_out, long long n, int b) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    q[i] = q[n + i] = __fmul_rn(pr[i], __ldg(inv_out + i / b));
  }
}

// A block's first edge (where the parent order's chunks start) and the
// edge range [f0, f1) of the CTA's part of it.
struct Bounds {
  int e0, f0, f1;
};

// One round: edges [a0, a1) of the CTA's part of block db.  For b <= 32 a
// round lies inside one chunk [c0, c0 + chunk) of the parent order; for
// b > 32 it runs to the part's end or `round` edges.
struct Round {
  int db, e0, f0, f1, a0, a1, c0;
  __device__ bool first() const { return a0 == f0; }
  __device__ bool last() const { return a1 == f1; }
};

__device__ __forceinline__ Round make_round(int db, int a0, const Bounds& bd, int chunk,
                                            bool in_chunk, int round) {
  Round r;
  r.db = db;
  r.e0 = bd.e0;
  r.f0 = bd.f0;
  r.f1 = bd.f1;
  r.a0 = a0;
  r.c0 = bd.e0 + (a0 - bd.e0) / chunk * chunk;
  const int end = in_chunk ? min(r.c0 + chunk, bd.f1) : bd.f1;
  r.a1 = min(a0 + round, end);
  return r;
}

// part += p[0] (* w[0]), p[step] (* w[wstep]), ... n values, in that order.
// Loads run eight values ahead of the adds, so a long row costs about one
// add latency a value; a contiguous run (step 1) loads 16 bytes at a time.
template <bool HasW>
__device__ __forceinline__ float sum_run(float part, const float* p, const float* w, int n,
                                         int step, int wstep) {
  constexpr int kDepth = 8;
  int i = 0;
  if (step == 1) {
    for (; i < n && (reinterpret_cast<uintptr_t>(p + i) & 15) != 0; ++i) {
      part = __fadd_rn(part, HasW ? __fmul_rn(p[i], w[i]) : p[i]);
    }
    auto load8 = [&](float (&v)[kDepth], int at) {
      const float4 a = *reinterpret_cast<const float4*>(p + at);
      const float4 c = *reinterpret_cast<const float4*>(p + at + 4);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = c.x; v[5] = c.y; v[6] = c.z; v[7] = c.w;
      if (HasW) {  // w has p's alignment: both are slices of 16-byte aligned rounds
        const float4 wa = *reinterpret_cast<const float4*>(w + at);
        const float4 wc = *reinterpret_cast<const float4*>(w + at + 4);
        v[0] = __fmul_rn(v[0], wa.x); v[1] = __fmul_rn(v[1], wa.y);
        v[2] = __fmul_rn(v[2], wa.z); v[3] = __fmul_rn(v[3], wa.w);
        v[4] = __fmul_rn(v[4], wc.x); v[5] = __fmul_rn(v[5], wc.y);
        v[6] = __fmul_rn(v[6], wc.z); v[7] = __fmul_rn(v[7], wc.w);
      }
    };
    if (i + kDepth <= n) {
      float cur[kDepth], nxt[kDepth];
      load8(cur, i);
      for (i += kDepth; i + kDepth <= n; i += kDepth) {
        load8(nxt, i);
#pragma unroll
        for (int u = 0; u < kDepth; ++u) part = __fadd_rn(part, cur[u]);
#pragma unroll
        for (int u = 0; u < kDepth; ++u) cur[u] = nxt[u];
      }
#pragma unroll
      for (int u = 0; u < kDepth; ++u) part = __fadd_rn(part, cur[u]);
    }
  } else if (n >= kDepth) {
    float cur[kDepth], nxt[kDepth];
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      cur[u] = HasW ? __fmul_rn(p[u * step], w[u * wstep]) : p[u * step];
    }
    for (i = kDepth; i + kDepth <= n; i += kDepth) {
      const float* pn = p + i * step;
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {
        nxt[u] = HasW ? __fmul_rn(pn[u * step], w[(i + u) * wstep]) : pn[u * step];
      }
#pragma unroll
      for (int u = 0; u < kDepth; ++u) part = __fadd_rn(part, cur[u]);
#pragma unroll
      for (int u = 0; u < kDepth; ++u) cur[u] = nxt[u];
    }
#pragma unroll
    for (int u = 0; u < kDepth; ++u) part = __fadd_rn(part, cur[u]);
  }
  for (; i < n; ++i) {
    part = __fadd_rn(part, HasW ? __fmul_rn(p[i * step], w[i * wstep]) : p[i * step]);
  }
  return part;
}

__global__ void __launch_bounds__(kMultiThreads)
gs_pass_multi_kernel(float* pr, float* q, const float* __restrict__ inv_out,
                     const float* __restrict__ vmask,
                     const float* __restrict__ tele,
                     const float* __restrict__ coef,
                     const uint8_t* __restrict__ frozen, float d,
                     const int* __restrict__ in_ptr,
                     const int* __restrict__ src,
                     const float* __restrict__ weights, int n_blocks,
                     int block, int b) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int kRnd = kRoundEdges;
  constexpr int kRoundSlots = kRnd / kMultiThreads;
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int part_max = (block + C - 1) / C;
  const int lo_c = rank * block / C;  // the CTA's vertices of a block: lo_c + [0, part)
  const int part = (rank + 1) * block / C - lo_c;
  extern __shared__ __align__(16) float smem_multi[];
  float* smem = smem_multi;
  const MultiLayout L(part_max);
  float* s_quad = smem + L.quad;
  float* s_vals = smem + L.vals;
  float* s_tele = smem + L.tele;
  int* s_src = reinterpret_cast<int*>(smem + L.src);
  float* s_w = smem + L.w;
  float* s_acc = smem + L.acc;
  float* s_cb = smem + L.cb;
  float* s_vmask = smem + L.vmask;
  float* s_inv = smem + L.inv;
  int* s_ptr = reinterpret_cast<int*>(smem + L.ptr);
  float* s_carry = smem + L.carry;

  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int nwarps = kMultiThreads / kWarp;
  const int row = static_cast<int>(blockIdx.x) / C;  // the cluster's row
  const float row_coef = coef[row];
  const bool row_frozen = frozen != nullptr && frozen[row];
  // the order at b: G lane groups; lane g of a G-lane group of a warp
  // sums every G-th edge of one vertex's slice
  const int bp = next_pow2(b);
  const int G = b <= kWarp ? kWarp / bp : 1;
  const int chunk = multi_chunk_edges(b);
  const int per_warp = kWarp / G;
  const int sub = lane / G;
  const int g = lane % G;
  const bool in_chunk = b <= kWarp;
  float* q_new = q + static_cast<size_t>(n_blocks) * block * b;

  for (int i = tid; i < part; i += kMultiThreads) s_acc[i] = 0.f;

  auto bounds = [&](int x) {
    const int* at = in_ptr + static_cast<size_t>(min(x, n_blocks - 1)) * block;
    Bounds bd;
    bd.e0 = __ldg(at);
    bd.f0 = __ldg(at + lo_c);
    bd.f1 = __ldg(at + lo_c + part);
    return bd;
  };
  // copies of the CTA's part of block db: in_ptr, vmask, inv_out, tele
  auto issue_block = [&](int db) {
    const int v0 = db * block + lo_c;
    int* ptr = s_ptr + (db & 1) * (part_max + 1);
    float* vm = s_vmask + (db & 1) * part_max;
    float* ib = s_inv + (db & 1) * part_max;
    float* te = s_tele + (db & 1) * part_max;
    for (int i = tid; i <= part; i += kMultiThreads) cp_async<4>(ptr + i, in_ptr + v0 + i);
    for (int i = tid; i < part; i += kMultiThreads) {
      cp_async<4>(vm + i, vmask + v0 + i);
      cp_async<4>(ib + i, inv_out + v0 + i);
      cp_async<4>(te + i, tele + static_cast<size_t>(v0 + i) * b + row);
    }
  };
  // copies of a round's src ids and weights into ring slot `slot`, two
  // rounds ahead of the round's sum
  auto issue_ids = [&](const Round& rd, int slot) {
    int* sr = s_src + slot * kRnd;
    float* wt = s_w + slot * kRnd;
    for (int k = tid; k < rd.a1 - rd.a0; k += kMultiThreads) {
      cp_async<4>(sr + k, src + rd.a0 + k);
      if (weights != nullptr) cp_async<4>(wt + k, weights + rd.a0 + k);
    }
  };
  // copies of the quads of q that hold the CTA's row at a round's sources
  // (ids in ring slot `slot`) into buffer `buf`, one round ahead
  auto issue_quads = [&](const Round& rd, int slot, int buf) {
    const int* sr = s_src + slot * kRnd;
    float* qd = s_quad + buf * kRnd * 4;
    const int n = rd.a1 - rd.a0;
    const int below = rd.db * block;  // sources below are read from the new copy
#pragma unroll
    for (int i = 0; i < kRoundSlots; ++i) {
      const int k = tid + i * kMultiThreads;
      if (k < n) {
        const size_t at = static_cast<size_t>(sr[k]) * b + row;
        const float* from = sr[k] < below ? q_new : q;
        cp_async_cg16(qd + k * 4, from + (at & ~static_cast<size_t>(3)));
      }
    }
  };
  // ends of blocks db_now + 1, + 2 and + 3, loaded a block before they are
  // needed
  int db_now = 0;
  Bounds bd1 = bounds(1), bd2 = bounds(2), bd3 = bounds(3);
  // the round after r (r in block db_now or db_now + 1); db == n_blocks: none
  auto after = [&](const Round& r) {
    if (!r.last()) {
      Bounds bd;
      bd.e0 = r.e0;
      bd.f0 = r.f0;
      bd.f1 = r.f1;
      return make_round(r.db, r.a1, bd, chunk, in_chunk, kRnd);
    }
    const Bounds& bd = r.db == db_now ? bd1 : bd2;
    return make_round(r.db + 1, bd.f0, bd, chunk, in_chunk, kRnd);
  };

  // prologue: the ids of rounds 0 and 1, block 0's part, round 0's quads
  const Bounds bd0 = bounds(0);
  Round cur = make_round(0, bd0.f0, bd0, chunk, in_chunk, kRnd);
  Round nxt = after(cur);
  issue_block(0);
  issue_ids(cur, 0);
  if (nxt.db < n_blocks) issue_ids(nxt, 1);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  issue_quads(cur, 0, 0);
  cp_async_commit();
  for (int k = 0;; ++k) {
    const int buf = k & 1;
    const int slot = k % 3;
    const int v0 = cur.db * block + lo_c;
    cp_async_wait_all();
    // round k, its block's part and the last commit are visible; at a
    // block's first round, the cluster's commits of the block above too
    if (cur.first()) cluster.sync(); else __syncthreads();
    float* vl = s_vals + buf * kRnd;
    {  // each edge's value out of its quad; sources in block db - 1 from
       // the values the cluster committed (copied before it committed)
      const int* sr = s_src + slot * kRnd;
      const float* qd = s_quad + buf * kRnd * 4;
      const bool patch = cur.first() && cur.db > 0;  // sources in block db - 1 were copied before it committed
      const int prev = (cur.db - 1) * block;
      float* cbp = s_cb + ((cur.db - 1) & 1) * part_max;
      for (int e = tid; e < cur.a1 - cur.a0; e += kMultiThreads) {
        const int s = sr[e];
        const int local = s - prev;
        const float copied = qd[e * 4 + static_cast<int>((static_cast<size_t>(s) * b + row) & 3)];
        if (patch && !row_frozen && static_cast<unsigned>(local) < static_cast<unsigned>(block)) {
          int owner = local * C / block;
          if ((owner + 1) * block / C <= local) ++owner;
          vl[e] = *((owner == rank ? cbp : cluster.map_shared_rank(cbp, owner)) +
                    (local - owner * block / C));
        } else {
          vl[e] = copied;
        }
      }
      __syncthreads();
    }
    Round nxt2 = nxt;
    if (nxt.db < n_blocks) {
      nxt2 = after(nxt);
      if (nxt.first()) issue_block(nxt.db);
      issue_quads(nxt, (k + 1) % 3, buf ^ 1);
      if (nxt2.db < n_blocks) issue_ids(nxt2, (k + 2) % 3);
      cp_async_commit();  // round k + 1 in flight while round k is summed
    }

    // sum round k into s_acc
    const int* ptr = s_ptr + (cur.db & 1) * (part_max + 1);
    const float* wt = weights != nullptr ? s_w + slot * kRnd : nullptr;
    const float* carry_in = s_carry + buf * kWarp;
    float* carry_out = s_carry + (buf ^ 1) * kWarp;
    const int a0 = cur.a0, a1 = cur.a1;
    const int c1 = in_chunk ? min(cur.c0 + chunk, cur.f1) : cur.f1;
    // vertices with edges in [a0, a1); the last round of a block also
    // commits the vertices before them
    int r_lo = 0, r_hi = part - 1;
    if (a0 < a1 && !cur.first() && !cur.last()) {
      int lo = 0, hi = part;  // first r with ptr[r + 1] > a0
      while (lo < hi) { const int mid = (lo + hi) >> 1; if (ptr[mid + 1] > a0) hi = mid; else lo = mid + 1; }
      r_lo = lo;
    }
    if (a0 < a1 && !cur.last()) {
      int lo = 0, hi = part;  // first r with ptr[r] >= a1
      while (lo < hi) { const int mid = (lo + hi) >> 1; if (ptr[mid] >= a1) hi = mid; else lo = mid + 1; }
      r_hi = lo - 1;
    }
    if (a0 == a1 && !cur.last()) r_hi = -1;
    const float* te = s_tele + (cur.db & 1) * part_max;
    const float* vm = s_vmask + (cur.db & 1) * part_max;
    const float* ib = s_inv + (cur.db & 1) * part_max;
    float* cbw = s_cb + (cur.db & 1) * part_max;
    for (int base = r_lo + warp * per_warp; base <= r_hi; base += nwarps * per_warp) {
      const int r = base + sub;
      float part_sum = 0.f;
      bool add = false;
      if (r <= r_hi) {
        const int lo = in_chunk ? max(ptr[r], cur.c0) : ptr[r];
        const int hi = in_chunk ? min(ptr[r + 1], c1) : ptr[r + 1];
        if (lo < hi && lo < a1 && hi > a0) {  // the row's slice meets this round
          const int s0 = max(lo, a0);
          const int s1 = min(hi, a1);
          const int e = s0 + ((lo + g - s0) & (G - 1));
          const int n = e < s1 ? (s1 - e + G - 1) / G : 0;
          if (lo < a0) part_sum = carry_in[g];
          const float* at = vl + (e - a0);
          part_sum = wt != nullptr ? sum_run<true>(part_sum, at, wt + (e - a0), n, G, G)
                                   : sum_run<false>(part_sum, at, nullptr, n, G, G);
          if (hi > a1) carry_out[g] = part_sum;  // the slice goes on in the next round
          else add = true;
        }
      }
      for (int h = G / 2; h > 0; h >>= 1) {  // warp-uniform: G is
        part_sum += __shfl_xor_sync(0xffffffffu, part_sum, h);
      }
      if (g == 0 && r <= r_hi) {
        if (!cur.last()) {
          if (add) s_acc[r] += part_sum;
        } else {  // commit vertex r of block db: every round has added to it
          const float a = add ? s_acc[r] + part_sum : s_acc[r];
          s_acc[r] = 0.f;
          if (!row_frozen) {
            const float base_val = __fmul_rn(te[r], row_coef);
            const float next = __fmul_rn(__fadd_rn(base_val, __fmul_rn(d, a)), vm[r]);
            const float scaled = __fmul_rn(next, ib[r]);
            const size_t idx = static_cast<size_t>(v0 + r) * b + row;
            pr[idx] = next;
            q_new[idx] = scaled;
            cbw[r] = scaled;
          }
        }
      }
    }
    if (nxt.db >= n_blocks) break;
    if (nxt.first()) {
      db_now = nxt.db;
      bd1 = bd2;
      bd2 = bd3;
      bd3 = bounds(db_now + 3);
    }
    cur = nxt;
    nxt = nxt2;
  }
  cluster.sync();  // peers may still read this CTA's committed values
}

}  // namespace

// The CTAs of one spmv_csr_acc launch on `device`: as many as are resident
// at once (a negated cudaError_t on failure).
extern "C" int spmv_csr_acc_ctas(int device) {
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, spmv_csr_acc_kernel,
                                                        kCsrThreads, 0);
  }
  return err == cudaSuccess ? sms * per_sm : -static_cast<int>(err);
}

// `scratch` holds 2 * n_ctas ints: each CTA's open row and its carried sum.
extern "C" int spmv_csr_acc(const float* contrib, const int* in_ptr,
                            const int* src, const float* weights, float* acc,
                            int n_rows, int m, int n_ctas, int* scratch,
                            cudaStream_t stream) {
  const int total = n_rows + m;
  const int share = (total + n_ctas - 1) / n_ctas;
  int* carry_row = scratch;
  float* carry_val = reinterpret_cast<float*>(scratch + n_ctas);
  spmv_csr_acc_kernel<<<n_ctas, kCsrThreads, 0, stream>>>(
      contrib, in_ptr, src, weights, acc, n_rows, m, share, search_levels(n_rows),
      carry_row, carry_val);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  spmv_carry_kernel<<<(n_ctas + 255) / 256, 256, 0, stream>>>(
      carry_row, carry_val, acc, n_ctas, n_rows);
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

// The shared memory one gs_pass_multi CTA needs without a cluster (its
// most), and the most a CTA may opt into on `device` (a negated
// cudaError_t on failure): the wrapper rejects a (block, b) that does not
// fit before it launches.
extern "C" size_t gs_pass_multi_smem_bytes(int block) {
  return multi_smem_bytes(block, 1);
}

extern "C" int smem_per_block_optin(int device) {
  int bytes = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? bytes : -static_cast<int>(err);
}

// Launches the walk with the largest cluster (8, 4, 2 or 1 CTAs a row) for
// which every row's cluster is resident at once.
static cudaError_t launch_multi(float* pr, float* q, const float* inv_out, const float* vmask,
                                const float* tele, const float* coef, const uint8_t* frozen,
                                float d, const int* in_ptr, const int* src,
                                const float* weights, int n_blocks, int block, int b,
                                cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  for (int c = kMaxCluster; c >= 1; c /= 2) {
    if (c > 1 && (c > block || b * c > sms)) continue;
    const size_t bytes = multi_smem_bytes(block, c);
    err = cudaFuncSetAttribute(gs_pass_multi_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) {
      if (c > 1) { cudaGetLastError(); continue; }
      return err;
    }
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = c;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(b * c);
    config.blockDim = dim3(kMultiThreads);
    config.dynamicSmemBytes = bytes;
    config.stream = stream;
    config.attrs = &attr;
    config.numAttrs = 1;
    if (c > 1) {
      int resident = 0;
      if (cudaOccupancyMaxActiveClusters(&resident, gs_pass_multi_kernel, &config) !=
              cudaSuccess || resident < b) {
        cudaGetLastError();
        continue;
      }
    }
    err = cudaLaunchKernelEx(&config, gs_pass_multi_kernel, pr, q, inv_out, vmask, tele,
                             coef, frozen, d, in_ptr, src, weights, n_blocks, block, b);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
  return cudaErrorInvalidConfiguration;
}

// `q` is scratch of twice the state's size: pr * inv_out, the previous
// pass's and this pass's.
extern "C" int gs_pass_multi(float* pr, float* q, const float* inv_out,
                             const float* vmask, const float* tele,
                             const float* coef, const uint8_t* frozen,
                             float d, const int* in_ptr, const int* src,
                             const float* weights, int n_blocks, int block,
                             int b, cudaStream_t stream) {
  const long long n = static_cast<long long>(n_blocks) * block * b;
  const long long grid = (n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096;
  scale_state_kernel<<<static_cast<int>(grid), 256, 0, stream>>>(q, pr, inv_out, n, b);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_multi(pr, q, inv_out, vmask, tele, coef, frozen, d, in_ptr,
                                       src, weights, n_blocks, block, b, stream));
}
