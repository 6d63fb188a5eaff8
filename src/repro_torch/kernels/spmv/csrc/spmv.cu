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
//   blocks in order; the sources' values are gathered by helper CTAs on
//   other SMs blocks ahead, the graph's streams and those values are copied
//   into shared memory ahead by TMA, and a window of the last blocks
//   committed fixes up the few values gathered before their source's commit.
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
constexpr int kChunk = 4096;         // edges summed per round of a block (the sum order's unit)
constexpr int kChunkFloats = 32768;  // the parent order of gs_pass_multi: see multi_chunk_edges

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
//   row is summed in edge order, each round's run of it in double and
//   rounded to float once (a float chain fell 3.4e-5 entry-wise off the
//   plain version at b = 64 on full webStanford).  A row cut by a round
//   keeps its lane partials in shared memory (carry) until its slice
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

// a + x, rounded to nearest in the accumulator's type
__device__ __forceinline__ float acc_add(float a, float x) { return __fadd_rn(a, x); }
__device__ __forceinline__ double acc_add(double a, float x) {
  return __dadd_rn(a, static_cast<double>(x));
}

// part += p[0] (* w[0]), p[step] (* w[wstep]), ... n values, in that order,
// each product rounded to float and added in Acc.  Loads run eight values
// ahead of the adds, so a long row costs about one add latency a value; a
// contiguous run (step 1) loads 16 bytes at a time.
template <bool HasW, typename Acc>
__device__ __forceinline__ Acc sum_run(Acc part, const float* p, const float* w, int n,
                                       int step, int wstep) {
  constexpr int kDepth = 8;
  int i = 0;
  if (step == 1) {
    for (; i < n && (reinterpret_cast<uintptr_t>(p + i) & 15) != 0; ++i) {
      part = acc_add(part, HasW ? __fmul_rn(p[i], w[i]) : p[i]);
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
        for (int u = 0; u < kDepth; ++u) part = acc_add(part, cur[u]);
#pragma unroll
        for (int u = 0; u < kDepth; ++u) cur[u] = nxt[u];
      }
#pragma unroll
      for (int u = 0; u < kDepth; ++u) part = acc_add(part, cur[u]);
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
      for (int u = 0; u < kDepth; ++u) part = acc_add(part, cur[u]);
#pragma unroll
      for (int u = 0; u < kDepth; ++u) cur[u] = nxt[u];
    }
#pragma unroll
    for (int u = 0; u < kDepth; ++u) part = acc_add(part, cur[u]);
  }
  for (; i < n; ++i) {
    part = acc_add(part, HasW ? __fmul_rn(p[i * step], w[i * wstep]) : p[i * step]);
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
          if (in_chunk) {
            part_sum = wt != nullptr ? sum_run<true>(part_sum, at, wt + (e - a0), n, G, G)
                                     : sum_run<false>(part_sum, at, nullptr, n, G, G);
          } else {  // a row's run of the round in double, rounded once
            const double run =
                wt != nullptr
                    ? sum_run<true>(static_cast<double>(part_sum), at, wt + (e - a0), n, 1, 1)
                    : sum_run<false>(static_cast<double>(part_sum), at, nullptr, n, 1, 1);
            part_sum = __double2float_rn(run);
          }
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

// ---------------------------------------------------------------------------
// gs_pass: one blocked Gauss-Seidel pass, into `out` (a first kernel copies
// `pr` there).  Block db sums from the state as it stands (blocks below db
// at this pass's values, db and above at the previous pass's), then
// commits
//     new = (base * bias + dmass + d * acc) * vmask
// with frozen lanes keeping their value.
//
// Replaces spmv_gs_pass (src/repro/kernels/spmv/kernel.py).  Bound: the
// order, not bytes: block db must see every block below it committed, so a
// pass is n_blocks dependent steps on one SM (a hand-off between SMs costs
// more than a step); the bytes (the in-CSR and the rank-shaped operands
// once, the ranks written once) are far below that.  Design: keep the
// chain of commits on one SM, and move everything else off it.
//
// * One gather an edge.  The first kernel writes q = pr * inv_out beside
//   the copy of pr, and one 16-byte record a vertex: its in_ptr entry (the
//   sign bit set if it is frozen), head = base * bias + dmass (or, for a
//   frozen vertex, its q), vmask and inv_out.  Each commit writes q[v] =
//   new * inv_out[v], the product the sums would take.
// * Items.  The walk goes through items, a block's edges in chunks of
//   kChunk (a block of no edges is one empty item); the last item of a
//   block commits it.
// * The gathers run on other SMs, k blocks ahead.  One walker CTA and
//   kHelpers helper CTAs are launched together.  A helper gathers vals[e] =
//   q[src[e]] for the edges of block b from L2 once the walker has published
//   that every block up to b - k is committed, then flags block b.  Scattered
//   4-byte gathers issued on the walker's SM took its load/store unit about
//   a cycle an edge, which every shared-memory access of the step then
//   queued behind.
// * Streams ahead by TMA.  In the walker, a producer thread copies each
//   item's records and its src and weights ranges into a ring of D stream
//   slots, D items ahead, with 1-D bulk copies onto an mbarrier (a range
//   starts at any edge: its 16-byte aligned superset inside the array; the
//   array's last few edges go by cp.async).  A loader thread, on no barrier
//   of the walk, waits for each item's block flag and copies its vals
//   range into a ring of kValueSlots value slots the same way.
// * A window fixes up the rest.  A source in blocks (b - k, b) may have been
//   committed after the helper read it: fix-up warps mark such edges while
//   the item before is summed (and multiply in the edge weights), then give
//   them the value from a window in shared memory that holds the q of the
//   last k blocks committed.  A source in block b or above is uncommitted,
//   so its gathered value is the previous pass's; one below is final.
// * Roles and barriers.  Sum warps sum and commit item j while the fix-up
//   warps prepare item j + 1 and the producer issues item j + D's streams;
//   one barrier of the walk's warps ends the step (the commits are visible,
//   the slots free), and a named barrier hands the fixed-up item to the sum
//   warps.  Ring positions are counters (an integer division costs tens of
//   instructions).
// * The sum order is fixed, and gs_pass_multi's at b = 1: chunks of kChunk
//   edges from the block's first edge; each row's slice of a chunk summed as one
//   warp would, lanes strided 32 apart, then the fixed xor tree, the chunk
//   sums added in order.  A row of at most 32 edges in the item is summed by
//   a group of kGroup lanes, each holding every kGroup-th warp lane's value
//   and taking the tree's upper levels itself, the lower ones by shuffles:
//   the same tree; a longer slice takes the whole warp.  Products and the
//   epilogue use round-to-nearest intrinsics: nothing is contracted, and the
//   result is bit for bit the plain blocked order's.
// ---------------------------------------------------------------------------

constexpr int kGsThreads = 1024;  // every CTA of the launch
constexpr int kHelpers = 16;      // helper CTAs beside the walker
// the walker's warps: sum warps, fix-up warps, then one warp each for the
// publisher, the producer and the loader
constexpr int kSumWarps = 16;
constexpr int kFixWarps = 13;
constexpr int kFixThreads = kFixWarps * kWarp;
constexpr int kStreamWaiter = kSumWarps * kWarp;        // a fix-up thread: waits on the rings
constexpr int kPublisher = kGsThreads - 3 * kWarp;      // lane 0 of warp 29: the walk's progress
constexpr int kProducer = kGsThreads - 2 * kWarp;       // lane 0 of warp 30: the streams
constexpr int kLoader = kGsThreads - kWarp;             // warp 31: the gathered values
constexpr int kStepThreads = kGsThreads - 2 * kWarp;    // the sum, fix-up and producer warps
constexpr int kReadyThreads = (kSumWarps + kFixWarps) * kWarp;
constexpr int kStepBarrier = 1;   // the walk's step: item j's commits are visible
constexpr int kReadyBarrier = 2;  // fix-up warps to sum warps: the next item is fixed up
constexpr int kFixBarrier = 3;    // among the fix-up warps
constexpr int kGroup = 2;                    // lanes that sum a row of at most 32 edges
constexpr int kGroupRows = kWarp / kGroup;   // rows a sum warp takes at once
constexpr int kLeaves = kWarp / kGroup;      // a group lane's share of the 32 warp lanes
constexpr int kValueSlots = 4;    // items whose gathered values are in shared memory
constexpr int kMaxWindow = 8;     // k: blocks between a helper's gather and its block's sum
constexpr int kMaxStages = 4;     // D: stream slots
constexpr int kPtrMask = 0x7fffffff;  // a record's in_ptr entry; the sign bit marks frozen
static_assert((kChunk + kFixThreads - 1) / kFixThreads <= 32,
              "a fix-up thread marks its edges of an item in one 32-bit word");

__host__ __device__ inline int round16(int bytes) { return (bytes + 15) / 16 * 16; }

// Shared memory of the walker in bytes: D stream slots (records of block + 1
// vertices, then src and weights of up to kChunk edges and their alignment
// slack), kValueSlots slots of gathered values, the window of k blocks, the
// accumulators of a block cut into chunks, the mbarriers (D stream slots;
// values landed and freed, kValueSlots each) and the count of blocks
// committed.
struct GsLayout {
  int src, w, slot, values, window, acc, bar, total;
  __host__ __device__ GsLayout(int block, bool weighted, int k, int d_stages) {
    const int edges = round16(4 * (kChunk + 8));
    src = 16 * (block + 1);
    w = src + edges;
    slot = w + (weighted ? edges : 0);
    values = d_stages * slot;
    window = values + kValueSlots * edges;
    acc = window + round16(4 * k * block);
    bar = acc + round16(4 * block);
    total = bar + round16(8 * (d_stages + 2 * kValueSlots + 1));
  }
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// the mbarrier's arrival once every cp.async this thread issued has landed
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ int ld_acquire_cta(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared::cta.s32 %0, [%1];\n" : "=r"(v) : "r"(smem_addr(p)) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_cta(int* p, int v) {
  asm volatile("st.release.cta.shared::cta.s32 [%0], %1;\n" :: "r"(smem_addr(p)), "r"(v) : "memory");
}

// Named barriers of a subset of the CTA's warps: sync waits, arrive does not.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// p[i] += p[i + Off] for i < Off, then the next level down to p[0] += p[1].
template <int Off, int W>
__device__ __forceinline__ void fold(float (&p)[W]) {
#pragma unroll
  for (int i = 0; i < Off; ++i) p[i] = __fadd_rn(p[i], p[i + Off]);
  if constexpr (Off > 1) fold<Off / 2>(p);
}

// The end of the item that starts at edge a0 of a block ending at e1.
__device__ __forceinline__ int item_end(int a0, int e1) {
  return min(a0 + kChunk, e1);
}

// A position in a ring of n slots and its mbarrier phase.
struct Ring {
  int slot = 0;
  unsigned phase = 0;
  __device__ void step(int n) {
    if (++slot == n) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// The walk's items read from in_ptr: item (b, c) is chunk c of block b,
// whose edges are [e0, e1); e2 = in_ptr at the block after, loaded a block
// early.
struct ItemCursor {
  int b = 0, c = 0, e0 = 0, e1 = 0, e2 = 0;
  __device__ void start(const int* in_ptr, int n_blocks, int block) {
    e0 = in_ptr[0];
    e1 = in_ptr[min(1, n_blocks) * block];
    e2 = in_ptr[min(2, n_blocks) * block];
  }
  __device__ int a0() const { return e0 + c * kChunk; }
  __device__ void step(const int* in_ptr, int n_blocks, int block) {
    if (a0() + kChunk < e1) {
      ++c;
    } else {
      ++b;
      c = 0;
      e0 = e1;
      e1 = e2;
      e2 = in_ptr[min(b + 2, n_blocks) * block];
    }
  }
};

// out = pr, q = pr * inv_out, and the records (n + 1 of them; the last
// holds in_ptr[n]).
__global__ void gs_prep_kernel(float* __restrict__ out, float* __restrict__ q,
                               int4* __restrict__ rec, const float* __restrict__ pr,
                               const float* __restrict__ inv_out,
                               const float* __restrict__ vmask,
                               const float* __restrict__ bias,
                               const uint8_t* __restrict__ frozen,
                               const float* __restrict__ params,
                               const int* __restrict__ in_ptr, int n) {
  const float base = params[0];
  const float dmass = params[2];
  for (int v = blockIdx.x * blockDim.x + threadIdx.x; v <= n; v += gridDim.x * blockDim.x) {
    if (v == n) {
      rec[n] = make_int4(in_ptr[n], 0, 0, 0);
      break;
    }
    const float p = pr[v];
    const float inv = inv_out[v];
    const float vm = vmask[v];
    const float bz = bias != nullptr ? bias[v] : vm;
    const float qv = __fmul_rn(p, inv);
    const bool fz = frozen != nullptr && frozen[v];
    out[v] = p;
    q[v] = qv;
    const float head = __fadd_rn(__fmul_rn(base, bz), dmass);
    rec[v] = make_int4(in_ptr[v] | (fz ? ~kPtrMask : 0), __float_as_int(fz ? qv : head),
                       __float_as_int(vm), __float_as_int(inv));
  }
}

// A helper CTA: blocks h, h + H, ... (h = blockIdx.x - 1, H helpers).  Once
// the walker has committed every block up to b - k, vals[e] = q[src[e]] for
// the edges of block b, read from L2 (never a stale L1 line); then the
// block's flag.
__device__ void gs_helper(const float* q, float* vals, int* sync, const int* __restrict__ src,
                          const int* __restrict__ in_ptr, int n_blocks, int block, int k) {
  const int* progress = sync + n_blocks;  // blocks the walker has committed
  for (int b = blockIdx.x - 1; b < n_blocks; b += gridDim.x - 1) {
    if (threadIdx.x == 0) {
      while (ld_acquire(progress) < b - k + 1) {
      }
    }
    __syncthreads();
    const int e0 = __ldg(in_ptr + static_cast<size_t>(b) * block);
    const int e1 = __ldg(in_ptr + static_cast<size_t>(b + 1) * block);
    for (int e = e0 + threadIdx.x; e < e1; e += blockDim.x) vals[e] = __ldcg(q + __ldg(src + e));
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      st_release(sync + b, 1);
    }
  }
}

__global__ void __launch_bounds__(kGsThreads)
gs_pass_kernel(float* out, float* q, const int4* __restrict__ rec,
               const int* __restrict__ src, const float* __restrict__ weights,
               const float* __restrict__ params, const int* __restrict__ in_ptr,
               float* vals, int* sync, int n_blocks, int block, int m, int k,
               int d_stages) {
  if (blockIdx.x != 0) {
    gs_helper(q, vals, sync, src, in_ptr, n_blocks, block, k);
    return;
  }
  extern __shared__ __align__(16) unsigned char smem_gs[];
  const GsLayout L(block, weights != nullptr, k, d_stages);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_gs + L.bar);  // stream slots landed
  uint64_t* vfull = full + d_stages;       // value slots landed
  uint64_t* vfree = vfull + kValueSlots;   // value slots summed
  int* committed = reinterpret_cast<int*>(vfree + kValueSlots);  // blocks committed
  float* window = reinterpret_cast<float*>(smem_gs + L.window);
  float* acc_s = reinterpret_cast<float*>(smem_gs + L.acc);
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  enum Role { kSumRole, kFixRole, kPublisherRole, kProducerRole, kLoaderRole };
  const Role role = warp < kSumWarps ? kSumRole
                    : warp < kSumWarps + kFixWarps ? kFixRole
                    : warp == kPublisher / kWarp ? kPublisherRole
                    : warp == kProducer / kWarp ? kProducerRole : kLoaderRole;
  const int ftid = tid - kStreamWaiter;  // a fix-up thread's index
  const float d = params[1];
  const int k_block = k * block;
  const unsigned w_span = static_cast<unsigned>((k - 1) * block);
  int* progress = sync + n_blocks;
  auto slot_rec = [&](int s) { return reinterpret_cast<int4*>(smem_gs + s * L.slot); };
  auto slot_src = [&](int s) { return reinterpret_cast<int*>(smem_gs + s * L.slot + L.src); };
  auto slot_w = [&](int s) { return reinterpret_cast<float*>(smem_gs + s * L.slot + L.w); };
  auto slot_vals = [&](int v) {
    return reinterpret_cast<float*>(smem_gs + L.values + v * (L.w - L.src));
  };

  if (tid == 0) {
    for (int s = 0; s < d_stages; ++s) mbar_init(full + s, 1);
    for (int s = 0; s < kValueSlots; ++s) {
      mbar_init(vfull + s, 1);
      mbar_init(vfree + s, 1);
    }
    *committed = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (role == kPublisherRole) {
    // Each count of blocks committed that the walk leaves in shared memory,
    // published to the helpers at the GPU's scope (the fence waits for the
    // commits' stores), off the walk's barriers.
    if (lane == 0) {
      for (int done = 0; done < n_blocks;) {
        const int c = ld_acquire_cta(committed);
        if (c > done) {
          __threadfence();
          st_release(progress, c);
          done = c;
        } else {
          __nanosleep(32);
        }
      }
    }
    return;
  }

  if (role == kLoaderRole) {
    // The values of item i, once the helpers have flagged its block: vals
    // [a0, a1) (the 16-byte aligned superset) into value slot i % kValueSlots,
    // after the walk has summed the item that held the slot.  Items go in
    // groups of kValueSlots, lane t taking item t of a group (slot t), so
    // their waits overlap.
    ItemCursor it;
    it.start(in_ptr, n_blocks, block);
    for (unsigned phase = 0, first = 1; it.b < n_blocks; phase ^= 1, first = 0) {
      int b = n_blocks, a0 = 0, a1 = 0;
      for (int t = 0; t < kValueSlots && it.b < n_blocks; ++t) {
        if (lane == t) {
          b = it.b;
          a0 = it.a0();
          a1 = item_end(a0, it.e1);
        }
        it.step(in_ptr, n_blocks, block);
      }
      if (b < n_blocks) {
        if (!first) mbar_wait(vfree + lane, phase ^ 1);
        while (ld_acquire(sync + b) == 0) {
        }
        asm volatile("fence.proxy.async.global;\n" ::: "memory");
        const int lo4 = a0 & ~3;
        const unsigned bytes = 4u * (((a1 + 3) & ~3) - lo4);
        mbar_arrive_expect_tx(vfull + lane, bytes);
        if (bytes > 0) bulk_copy(slot_vals(lane), vals + lo4, bytes, vfull + lane);
      }
      __syncwarp();
    }
    return;
  }

  // The producer: item p of the walk is the next whose streams to copy.
  ItemCursor pit;
  if (tid == kProducer) pit.start(in_ptr, n_blocks, block);
  auto produce = [&](int s) {
    const int a0 = pit.a0();
    const int a1 = item_end(a0, pit.e1);
    const int lo = a0 & ~3;
    const int hi = max(lo, min((a1 + 3) & ~3, m & ~3));  // whole quads inside src
    const unsigned rec_bytes = 16u * (block + 1);
    const unsigned edge_bytes = 4u * (hi - lo);
    uint64_t* bar = full + s;
    const unsigned tx = rec_bytes + edge_bytes * (weights != nullptr ? 2 : 1);
    const bool tail = a1 > hi;  // the array's last edges, past its last whole quad
    if (tail) mbar_expect_tx(bar, tx); else mbar_arrive_expect_tx(bar, tx);
    bulk_copy(slot_rec(s), rec + static_cast<size_t>(pit.b) * block, rec_bytes, bar);
    if (hi > lo) {
      bulk_copy(slot_src(s), src + lo, edge_bytes, bar);
      if (weights != nullptr) bulk_copy(slot_w(s), weights + lo, edge_bytes, bar);
    }
    if (tail) {
      for (int e = hi; e < a1; ++e) {
        cp_async<4>(slot_src(s) + (e - lo), src + e);
        if (weights != nullptr) cp_async<4>(slot_w(s) + (e - lo), weights + e);
      }
      cp_async_mbar_arrive(bar);
    }
    pit.step(in_ptr, n_blocks, block);
  };

  // The edges of the item in stream slot s: its block's end, and the item's
  // range [a0, a1) from its chunk c.
  struct Span {
    int a0, a1, lo4, e1;
  };
  auto span = [&](int s, int c) {
    const int4* rc = slot_rec(s);
    Span sp;
    sp.e1 = rc[block].x & kPtrMask;
    sp.a0 = (rc[0].x & kPtrMask) + c * kChunk;
    sp.a1 = item_end(sp.a0, sp.e1);
    sp.lo4 = sp.a0 & ~3;
    return sp;
  };
  // The fix-up of the item in stream slot s and value slot vs (block b,
  // chunk c), in two passes over a fix-up thread's share of its edges
  // (edge a0 + ftid + t * kFixThreads is bit t of the mask).  The first,
  // once its values have landed, multiplies in each edge's weight and marks
  // the edges whose source lies in blocks (b - k, b): committed after the
  // helper's gather.  The second, once the blocks below b are committed,
  // gives those edges the window's value (times the weight).  Block x's
  // window slot is x % k; w_at is that of block b - k + 1.
  auto fix_marks = [&](int s, int vs, int b, int c) {
    const Span sp = span(s, c);
    const int* sr = slot_src(s);
    const float* wt = weights != nullptr ? slot_w(s) : nullptr;
    float* gv = slot_vals(vs);
    const unsigned w_lo = static_cast<unsigned>((b - k + 1) * block);
    unsigned marks = 0;
    for (int e = sp.a0 + ftid, t = 0; e < sp.a1; e += kFixThreads, ++t) {
      const unsigned o = static_cast<unsigned>(sr[e - sp.lo4]) - w_lo;
      if (o < w_span) {  // committed after its gather: the window's value
        marks |= 1u << t;
      } else if (wt != nullptr) {
        gv[e - sp.lo4] = __fmul_rn(gv[e - sp.lo4], wt[e - sp.lo4]);
      }
    }
    return marks;
  };
  auto fix_window = [&](int s, int vs, int b, int c, int w_at, unsigned marks) {
    if (marks == 0) return;
    const Span sp = span(s, c);
    const int* sr = slot_src(s);
    const float* wt = weights != nullptr ? slot_w(s) : nullptr;
    float* gv = slot_vals(vs);
    const unsigned w_lo = static_cast<unsigned>((b - k + 1) * block);
    for (; marks != 0; marks &= marks - 1) {
      const int e = sp.a0 + ftid + (__ffs(marks) - 1) * kFixThreads;
      int at = static_cast<int>(static_cast<unsigned>(sr[e - sp.lo4]) - w_lo) + w_at;
      if (at >= k_block) at -= k_block;
      const float v = window[at];
      gv[e - sp.lo4] = wt != nullptr ? __fmul_rn(v, wt[e - sp.lo4]) : v;
    }
  };
  auto step_sync = [] { named_sync(kStepBarrier, kStepThreads); };
  auto ready_sync = [] { named_sync(kReadyBarrier, kReadyThreads); };
  auto ready_arrive = [] { named_arrive(kReadyBarrier, kReadyThreads); };
  auto next = [](int x, int n) { return x + 1 == n ? 0 : x + 1; };

  // Ring positions of item j (the one being summed), j + 1 and j + 2, in
  // the stream slots (s0, s1, s2) and the value slots (v0, v1, v2).
  Ring s0, s1, s2, v0, v1, v2;
  s1.step(d_stages);
  s2.step(d_stages);
  s2.step(d_stages);
  v1.step(kValueSlots);
  v2.step(kValueSlots);
  v2.step(kValueSlots);
  int sb = 0, sc = 0;  // the item being summed: block sb, chunk sc
  int wb = 0;          // its block's window slot, sb % k

  // prologue: D items' streams; item 0 fixed up; items 0 and 1 landed
  if (tid == kProducer) {
    for (int s = 0; s < d_stages && pit.b < n_blocks; ++s) produce(s);
  }
  unsigned marks1 = 0;  // a fix-up thread's marks of item j + 1
  if (role == kFixRole) {
    if (tid == kStreamWaiter) {
      mbar_wait(full, 0);
      mbar_wait(vfull, 0);
    }
    named_sync(kFixBarrier, kFixThreads);
    fix_window(0, 0, 0, 0, k > 1 ? block : 0, fix_marks(0, 0, 0, 0));
    ready_arrive();
    const Span sp0 = span(0, 0);
    const bool last0 = sp0.a0 + kChunk >= sp0.e1;
    if (!last0 || n_blocks > 1) {  // item 1
      if (tid == kStreamWaiter) {
        mbar_wait(full + s1.slot, s1.phase);
        mbar_wait(vfull + v1.slot, v1.phase);
      }
      named_sync(kFixBarrier, kFixThreads);
      marks1 = fix_marks(s1.slot, v1.slot, last0 ? 1 : 0, last0 ? 0 : 1);
    }
  }
  step_sync();  // items 0 and 1's streams are visible to every warp of the walk

  const int grp = lane / kGroup;  // the lane's row of the warp's kGroupRows
  const int gl = lane % kGroup;   // its lane in the row's group
  while (sb < n_blocks) {
    const int4* rc = slot_rec(s0.slot);
    const Span sp = span(s0.slot, sc);
    const int a0 = sp.a0, a1 = sp.a1;
    const bool first = sc == 0;
    const bool last = a0 + kChunk >= sp.e1;
    if (role == kSumRole) {
      ready_sync();  // item j is fixed up
      const float* gv = slot_vals(v0.slot) + (a0 - sp.lo4);
      for (int r0 = warp * kGroupRows; r0 < block; r0 += kSumWarps * kGroupRows) {
        const int r = r0 + grp;
        int4 rv = make_int4(0, 0, 0, 0);  // the row's record, for its commit
        int lo = 0, hi = 0;
        if (r < block) {
          rv = rc[r];
          lo = max(rv.x & kPtrMask, a0);
          hi = min(rc[r + 1].x & kPtrMask, a1);
        }
        const int n = max(hi - lo, 0);
        // a slice of at most 32 edges: the group's tree, its leaves cut to
        // the longest such slice of the warp
        const int width = __reduce_max_sync(0xffffffffu, n <= kWarp ? n : 0);
        float p[kLeaves];
#pragma unroll
        for (int i = 0; i < kLeaves; ++i) {
          const int l = gl + kGroup * i;  // the warp lane whose value this leaf is
          p[i] = i * kGroup < width && l < n ? __fadd_rn(0.f, gv[lo + l - a0]) : 0.f;
        }
        fold<kLeaves / 2>(p);  // the levels down to kGroup
        float mine = p[0];
#pragma unroll
        for (int off = kGroup / 2; off > 0; off >>= 1) {  // the levels below kGroup
          mine = __fadd_rn(mine, __shfl_xor_sync(0xffffffffu, mine, off));
        }
        // a longer slice: the warp's strided sums and xor tree, row by row
        unsigned long_rows = __ballot_sync(0xffffffffu, gl == 0 && n > kWarp);
        while (long_rows != 0) {
          const int owner = __ffs(long_rows) - 1;
          long_rows &= long_rows - 1;
          const int olo = __shfl_sync(0xffffffffu, lo, owner);
          const int ohi = __shfl_sync(0xffffffffu, hi, owner);
          float part = 0.f;
          for (int e = olo + lane; e < ohi; e += kWarp) part = __fadd_rn(part, gv[e - a0]);
#pragma unroll
          for (int off = kWarp / 2; off > 0; off >>= 1) {
            part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, off));
          }
          if (grp == owner / kGroup) mine = part;
        }
        if (gl == 0 && r < block) {
          const float a = __fadd_rn(first ? 0.f : acc_s[r], mine);
          if (!last) {
            acc_s[r] = a;
          } else {
            float qv = __int_as_float(rv.y);  // a frozen vertex keeps its value and q
            if (rv.x >= 0) {
              const float next_v = __fmul_rn(__fadd_rn(__int_as_float(rv.y), __fmul_rn(d, a)),
                                             __int_as_float(rv.z));
              qv = __fmul_rn(next_v, __int_as_float(rv.w));
              const int v = sb * block + r;
              out[v] = next_v;
              q[v] = qv;
            }
            window[wb * block + r] = qv;
          }
        }
      }
    }
    if (last) {
      ++sb;
      sc = 0;
      wb = next(wb, k);
    } else {
      ++sc;
    }
    step_sync();  // item j's commits are visible, and its slots are free
    if (role == kFixRole && sb < n_blocks) {
      // item j + 1: the window now holds every block below it
      fix_window(s1.slot, v1.slot, sb, sc, next(wb, k) * block, marks1);
      ready_arrive();
      // item j + 2, while item j + 1 is summed: its first pass
      const Span sp1 = span(s1.slot, sc);
      const bool last1 = sp1.a0 + kChunk >= sp1.e1;
      if (!last1 || sb + 1 < n_blocks) {
        if (tid == kStreamWaiter) {
          mbar_wait(full + s2.slot, s2.phase);
          mbar_wait(vfull + v2.slot, v2.phase);
        }
        named_sync(kFixBarrier, kFixThreads);
        marks1 = fix_marks(s2.slot, v2.slot, last1 ? sb + 1 : sb, last1 ? 0 : sc + 1);
      }
    } else if (tid == kProducer) {
      if (last) st_release_cta(committed, sb);  // for the publisher
      mbar_arrive(vfree + v0.slot);  // item j's value slot may take item j + kValueSlots
      if (pit.b < n_blocks) produce(s0.slot);
    }
    s0.step(d_stages);
    s1.step(d_stages);
    s2.step(d_stages);
    v0.step(kValueSlots);
    v1.step(kValueSlots);
    v2.step(kValueSlots);
  }
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

// The stages of one gs_pass launch at `block`: k, the blocks between a
// helper's gather and its block's sum (the window), and d stream slots, the
// largest k, then the larger d, of those that fit into `smem_limit` bytes
// of shared memory.  Returns the shared memory it takes, or 0 when not even
// k = 2, d = 2 fits.
extern "C" int gs_pass_plan(int block, int weighted, int smem_limit, int* k, int* d_stages) {
  for (int kk = kMaxWindow; kk >= 2; --kk) {
    for (int dd = kMaxStages; dd >= 2; --dd) {
      const int bytes = GsLayout(block, weighted != 0, kk, dd).total;
      if (bytes <= smem_limit) {
        *k = kk;
        *d_stages = dd;
        return bytes;
      }
    }
  }
  return 0;
}

// `q` is scratch of n_blocks * block floats, `rec` of n_blocks * block + 1
// 16-byte records, `vals` of (m + 7) & ~3 floats, `sync` n_blocks + 1 ints
// set to 0; k and d_stages come from gs_pass_plan.  One walker CTA and
// kHelpers helper CTAs, launched together (cooperatively: they wait on each
// other).
extern "C" int gs_pass(float* out, float* q, void* rec, const float* pr, const float* inv_out,
                       const float* vmask, const float* bias, const uint8_t* frozen,
                       const float* params, const int* in_ptr, const int* src,
                       const float* weights, float* vals, int* sync, int n_blocks, int block,
                       int m, int k, int d_stages, cudaStream_t stream) {
  if (k < 2 || k > kMaxWindow || d_stages < 2 || d_stages > kMaxStages) {
    return cudaErrorInvalidValue;
  }
  const int n = n_blocks * block;
  const int grid = (n + 256) / 256 < 4096 ? (n + 256) / 256 : 4096;
  int4* records = static_cast<int4*>(rec);
  gs_prep_kernel<<<grid, 256, 0, stream>>>(out, q, records, pr, inv_out, vmask, bias, frozen,
                                           params, in_ptr, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = GsLayout(block, weights != nullptr, k, d_stages).total;
  err = allow_smem(gs_pass_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&out, &q, &records, &src, &weights, &params, &in_ptr, &vals, &sync,
                  &n_blocks, &block, &m, &k, &d_stages};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(gs_pass_kernel),
                                    dim3(1 + kHelpers), dim3(kGsThreads), args, bytes, stream);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
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

// info[0..5] of one kernel as launched: registers, local (spill) bytes a
// thread, static and dynamic shared memory a CTA, resident CTAs an SM and
// threads a CTA
template <typename K>
static int kernel_info(K* kernel, int threads, size_t smem, int* info) {
  cudaFuncAttributes attr;
  int ctas = 0;
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, threads, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = static_cast<int>(attr.sharedSizeBytes);
  info[3] = static_cast<int>(smem);
  info[4] = ctas;
  info[5] = threads;
  return 0;
}

// What a launch at `block` rows (`weighted` for gs_pass's streams) runs, as
// kernel_info reports it into info[0..5]: kernel 0 spmv_csr_acc_kernel, 1
// spmv_carry_kernel, 2 gs_prep_kernel, 3 gs_pass_kernel (the dynamic shared
// memory of gs_pass_plan on the current card), 4 scale_state_kernel, 5
// gs_pass_multi_kernel (a CTA's staging without a cluster, its most).
// Returns a cudaError; a kernel out of range, or a block that gs_pass_plan
// cannot stage, is cudaErrorInvalidValue.
extern "C" int spmv_kernel_info(int kernel, int block, int weighted, int* info) {
  switch (kernel) {
    case 0:
      return kernel_info(spmv_csr_acc_kernel, kCsrThreads, 0, info);
    case 1:
      return kernel_info(spmv_carry_kernel, 256, 0, info);
    case 2:
      return kernel_info(gs_prep_kernel, 256, 0, info);
    case 3: {
      int device = 0;
      cudaError_t err = cudaGetDevice(&device);
      if (err != cudaSuccess) return static_cast<int>(err);
      const int limit = smem_per_block_optin(device);
      if (limit < 0) return -limit;
      int k = 0, d_stages = 0;
      const int bytes = gs_pass_plan(block, weighted, limit, &k, &d_stages);
      if (bytes <= 0) return static_cast<int>(cudaErrorInvalidValue);
      return kernel_info(gs_pass_kernel, kGsThreads, bytes, info);
    }
    case 4:
      return kernel_info(scale_state_kernel, 256, 0, info);
    case 5:
      return kernel_info(gs_pass_multi_kernel, kMultiThreads, multi_smem_bytes(block, 1), info);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
