// Hand-written CUDA flash attention (forward) for Hopper, sm_90a.
//
// Replaces the TPU kernel flash_attention_kernel
// (src/repro/kernels/flash_attention/kernel.py), which walks a
// (b, hq, q block, k block) grid in order on one core and carries the
// running max, denominator and accumulator of one q block in VMEM scratch
// across its k sweep.  Here the k sweep is a loop inside one CTA: a CTA
// owns one (batch, q head, q tile) and keeps that state in registers, so no
// CTA depends on another.
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
// pair and reads each operand once, hundreds of flops per byte.  Two
// kernels, one per input type, behind one entry point, both on the tensor
// cores (989 TFLOP/s dense bf16):
//
// bfloat16 (tc::flash_attention_tc_kernel).  A CTA is one consumer
// warpgroup and one producer warp.  The producer's one thread loads
// the q tile and a ring of STAGES K and V tiles by TMA, swizzled 128B (64B
// at dh 32), a tile row cut into 64-column boxes; mbarriers carry "landed"
// and "consumed" between the roles.  dh 80 is not a whole number of boxes:
// its tiles are 128 columns wide in shared memory, and the TMA fills
// columns 80-127 with zeros (they lie past the 80-column tensor map), so
// Q.K^T runs its 5 k-steps of 16 on the boxes as they are, and P.V's
// columns 80-127 come out 0 and are never stored (60 % more P.V work than
// dh 80 needs: simple first).  The warpgroup runs S = Q.K^T as
// wgmma m64n64k16 from shared memory (bf16 products are exact in the
// float32 accumulator), the masks and online softmax on the accumulator
// fragment (a row's scores lie on 4 threads: shuffles), then P.V as
// wgmma with P in registers and V in shared memory (transposed B).  P is
// not rounded to one bf16: it is split into P_TERMS = 3 bf16 terms (hi,
// the rounding of what hi leaves, of what both leave), which carry its 24
// bits exactly, so P.V costs three products where a rounded P costs one:
// twice the tensor-core work of the function, for float32 digits.  Each
// tile's P.V is summed apart and folded in as acc * alpha + pv, 64 output
// columns at a time (fewer live registers, two CTAs an SM).  No load waits
// for compute: the ring keeps the next tile in flight.
//
// float32 (tc::flash_attention_f32_kernel).  A float32 value is exactly the
// sum of F32_TERMS = 3 bf16 terms, each the rounding of what the earlier
// ones leave, and a product of two bf16 terms is exact in wgmma's float32
// accumulator.  A first small kernel (split_terms_kernel) writes q, k and v
// as three bf16 planes each into scratch that the wrapper allocates (10
// bytes moved an element); tensor maps read the planes as the bf16 kernel
// reads its operands, and P is split in registers as the bf16 kernel splits
// it.  Of the 9 term products of Q.K^T, and of P.V, it keeps the 6 with
// i + j <= 2, smallest first: 12 bf16 products where the function needs 2.
// So the least time for float32-accurate work on this card is the
// function's flops x 6 over 989 TFLOP/s (the CUDA cores' float32 FMAs: 67).
// Three terms of a 64-row, 128-column tile take 48 KB, and Q beside a
// two-stage ring of K and V would pass the 227 KB a CTA may have.  So a CTA
// is two consumer warpgroups (128 query rows, 96 KB of Q's terms) over one
// K and one V slot (two each where the tile is at most 64 columns wide) and
// a producer warp, one CTA an SM.  The warpgroups share each K and V tile
// and the tensor cores, so one's softmax runs under the other's products;
// the producer refills a slot once both have read it, K's after Q.K^T and
// V's after P.V, under the other half of the tile's work.  A warpgroup
// skips a tile that none of its rows sees.  dh 80 keeps the bf16 kernel's
// 128-column tile.

#include <cuda.h>  // CUtensorMap and its enums (header only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// bfloat16: wgmma on the tensor cores, K and V fed by TMA through a ring
// ---------------------------------------------------------------------------
namespace tc {

constexpr int BQ = 64;           // query rows of a CTA: one consumer warpgroup
constexpr int BK = 64;           // keys of a tile
constexpr int STAGES = 2;        // depth of the K and V rings
constexpr int CONSUMERS = 128;   // warps 0-3: wgmma, softmax, epilogue
constexpr int THREADS = CONSUMERS + 32;  // warp 4: the TMA producer
// P is summed as P_TERMS bf16 terms, each the rounding of what the earlier
// ones leave: three carry all 24 bits of the float32 P (each subtraction is
// exact), so P.V loses nothing to bf16 (the CPU emulation in
// tests/test_torch_flash_attention.py: two terms miss the float32 budget,
// one misses it by hundreds of times).
constexpr int P_TERMS = 3;

// Shared-memory geometry of head dim D.  A tile row is cut into TMA boxes of
// SW_COLS columns (one swizzle row: 128 bytes, or 64 at D = 32); a tile is
// CHUNKS such boxes, DT columns (D rounded up to whole boxes: 128 at D = 80,
// the columns past D zeros), each box [rows][SW_BYTES] with the hardware's
// 128B (64B) swizzle, which the wgmma descriptors name as their layout.
template <int D>
struct Geo {
  static constexpr int SW_COLS = D < 64 ? D : 64;
  static constexpr int SW_BYTES = 2 * SW_COLS;
  static constexpr int DT = (D + SW_COLS - 1) / SW_COLS * SW_COLS;
  static constexpr int CHUNKS = DT / SW_COLS;
  static constexpr uint64_t LAYOUT = SW_BYTES == 128 ? 1 : 2;  // descriptor swizzle mode
  static constexpr int Q_CHUNK = BQ * SW_BYTES;
  static constexpr int KV_CHUNK = BK * SW_BYTES;
  static constexpr int Q_BYTES = BQ * DT * 2;  // the TMA counts the zero fill too
  static constexpr int KV_BYTES = BK * DT * 2;
  static constexpr int BARRIERS = 1 + 4 * STAGES;
  // 1024 bytes of slack to align the tiles to the swizzle period
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * BARRIERS;
  static_assert(D % 16 == 0 && DT <= 128, "head dims 32, 64, 80, 128");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed.  A fresh barrier
// counts its phase before 0 (parity 1) as complete, so a producer's first
// wait on an empty slot, with parity 1, passes at once.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 3-D map (columns, rows, heads) into shared memory; rows past
// the head's end and columns past D arrive as zeros, and the whole box's
// bytes are counted on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int col, int row,
                                         int head, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row), "r"(head)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle mode.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | layout << 62;
}

// K-major operand (Q or K: D contiguous), columns 16kk .. 16kk + 15: a step
// of 32 bytes inside a swizzle row, or the next box; 8-row groups lie
// 8 * SW_BYTES apart.
template <int D>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t base, int chunk_bytes, int kk) {
  using G = Geo<D>;
  const int col = 16 * kk;
  return make_desc(base + (col / G::SW_COLS) * chunk_bytes + (col % G::SW_COLS) * 2, 16,
                   8 * G::SW_BYTES, G::LAYOUT);
}

// V as the MN-major B operand: keys 16kk .. 16kk + 15 (rows) of box `chunk`
// (SW_COLS output columns); 8-key groups lie 8 * SW_BYTES apart.
template <int D>
__device__ __forceinline__ uint64_t v_desc(uint32_t base, int chunk, int kk) {
  using G = Geo<D>;
  return make_desc(base + chunk * G::KV_CHUNK + 16 * kk * G::SW_BYTES, G::KV_CHUNK,
                   8 * G::SW_BYTES, G::LAYOUT);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Registers a wgmma reads or writes: pins their writes before the fence
// (wgmma.fence orders only what precedes it) and keeps the compiler from
// touching them between the wgmma and its wait.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// S (64 x 64, float32) {+}= Q (64 x 16) . K (64 x 16)^T, both bf16 K-major in
// shared memory (descriptors qa, kb); scale_d = 0 overwrites S.
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t qa, uint64_t kb, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(qa), "l"(kb), "r"(scale_d));
}

// O (64 x 32, float32) {+}= P (64 x 16, bf16 in registers, the accumulator
// layout of wgmma_qk) . V (16 x 32, bf16 MN-major in shared memory, descriptor
// vb, transposed: imm-trans-b 1)
__device__ __forceinline__ void wgmma_pv(float (&d)[16], const uint32_t (&a)[4], uint64_t vb,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(vb), "r"(scale_d));
}

// O (64 x 64, float32) {+}= P (64 x 16, bf16 in registers, the accumulator
// layout of wgmma_qk) . V (16 x 64, bf16 MN-major in shared memory, descriptor
// vb, transposed: imm-trans-b 1)
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t (&a)[4], uint64_t vb,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(vb), "r"(scale_d));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// Grid (hq, b, q tiles); 160 threads.  Warp 4 (one thread) loads the q tile
// once and keeps K and V tiles STAGES ahead, each slot guarded by a full
// barrier (TMA bytes landed) and an empty one (all 128 consumer threads done
// reading).  Warps 0-3 are one warpgroup: thread t holds query rows
// r0 = 16 * (t / 32) + (t % 32) / 4 and r0 + 8, and of each 8-key (8-column)
// group the columns c0 = 2 * (t % 4) and c0 + 1: the wgmma accumulator layout,
// in which S turns into P's register A operand without moving.
template <int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_attention_tc_kernel(__grid_constant__ const CUtensorMap tq,
                          __grid_constant__ const CUtensorMap tk,
                          __grid_constant__ const CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                          int hq, int hkv, int sq, int sk, float scale, int causal, int window) {
  using G = Geo<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* ks = qs + G::Q_BYTES;             // STAGES K tiles
  uint8_t* vs = ks + STAGES * G::KV_BYTES;   // STAGES V tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + STAGES * G::KV_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* k_empty = v_full + STAGES;
  uint64_t* v_empty = k_empty + STAGES;

  const int ih = blockIdx.x;
  const int ib = blockIdx.y;
  const int iq = gridDim.z - 1 - blockIdx.z;  // longest causal rows first
  const int q_start = iq * BQ;
  const int q_last = min(q_start + BQ, sq) - 1;
  // keys that some row of the tile may see: [k_lo, k_hi), in tiles from k_first
  const int k_hi = causal ? min(sk, q_last + 1) : sk;
  const int k_lo = window > 0 ? max(0, q_start - window + 1) : 0;
  const int k_first = k_lo / BK * BK;
  const int n_tiles = k_hi > k_first ? (k_hi - k_first + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, CONSUMERS);
      mbar_init(v_empty + s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer warp; one thread starts the copies
    if (threadIdx.x == CONSUMERS) {
      const int q_head = ib * hq + ih;
      const int kv_head = ib * hkv + ih / (hq / hkv);
      mbar_expect_tx(q_full, G::Q_BYTES);
      for (int c = 0; c < G::CHUNKS; ++c)
        tma_load(qs + c * G::Q_CHUNK, &tq, c * G::SW_COLS, q_start, q_head, q_full);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        const uint32_t parity = (t / STAGES) & 1;
        const int k_start = k_first + t * BK;
        mbar_wait(k_empty + s, parity ^ 1);
        mbar_expect_tx(k_full + s, G::KV_BYTES);
        for (int c = 0; c < G::CHUNKS; ++c)
          tma_load(ks + s * G::KV_BYTES + c * G::KV_CHUNK, &tk, c * G::SW_COLS, k_start, kv_head,
                   k_full + s);
        mbar_wait(v_empty + s, parity ^ 1);
        mbar_expect_tx(v_full + s, G::KV_BYTES);
        for (int c = 0; c < G::CHUNKS; ++c)
          tma_load(vs + s * G::KV_BYTES + c * G::KV_CHUNK, &tv, c * G::SW_COLS, k_start, kv_head,
                   v_full + s);
      }
    }
    return;
  }

  const int tid = threadIdx.x;
  const int r0 = 16 * (tid / 32) + (tid % 32) / 4;
  const int c0 = 2 * (tid % 4);
  const uint32_t q_addr = smem_u32(qs);
  const uint32_t k_addr = smem_u32(ks);
  const uint32_t v_addr = smem_u32(vs);

  // acc[4i + 2h + c]: row r0 + 8h, output column 8i + c0 + c (of DT; those
  // from D on stay 0)
  float acc[G::DT / 2];
#pragma unroll
  for (int i = 0; i < G::DT / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  mbar_wait(q_full, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES;
    const uint32_t parity = (t / STAGES) & 1;
    const int k_start = k_first + t * BK;

    // S = Q K^T over the D real columns: sc[4i + 2h + c] is row r0 + 8h,
    // key k_start + 8i + c0 + c
    float sc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    mbar_wait(k_full + s, parity);
    hold(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_qk(sc, kmajor_desc<D>(q_addr, G::Q_CHUNK, kk),
               kmajor_desc<D>(k_addr + s * G::KV_BYTES, G::KV_CHUNK, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    hold(sc);
    mbar_arrive(k_empty + s);

    // online softmax over the tile; a row's 64 scores lie on 4 threads
    const bool edge = k_start + BK > sk || (causal && k_start + BK - 1 > q_start) ||
                      (window > 0 && q_start + BQ - 1 - k_start >= window);
    unsigned live = 0xffffffffu;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int h = (i / 2) % 2;
      if (edge) {
        const int row = q_start + r0 + 8 * h;
        const int col = k_start + 8 * (i / 4) + c0 + i % 2;
        const bool ok = col < sk && (!causal || row >= col) && (window <= 0 || row - col < window);
        live &= ~((ok ? 0u : 1u) << i);
      }
      sc[i] = (live >> i) & 1u ? sc[i] * scale : NEG_INF;
      mx[h] = fmaxf(mx[h], sc[i]);
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      mx[h] = fmaxf(m[h], mx[h]);  // the new running max
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int h = (i / 2) % 2;
      sc[i] = (live >> i) & 1u ? expf(sc[i] - mx[h]) : 0.f;
      sum[h] += sc[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      alpha[h] = expf(m[h] - mx[h]);
      l[h] = alpha[h] * l[h] + sum[h];
      m[h] = mx[h];
    }

    // P in P_TERMS bf16 terms, as wgmma A fragments: keys 16kk .. 16kk + 15
    // of the tile are accumulator columns 8kk .. 8kk + 7, register j of the
    // fragment the pair sc[8kk + 2j], sc[8kk + 2j + 1]
    uint32_t pa[P_TERMS][BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = sc[8 * kk + 2 * j], y = sc[8 * kk + 2 * j + 1];
#pragma unroll
        for (int p = 0; p < P_TERMS; ++p) {
          const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
          pa[p][kk][j] = bf16x2_bits(h);
          x -= __low2float(h);
          y -= __high2float(h);
        }
      }

    // acc = acc * alpha + P.V, the tile's product summed apart first, in
    // SW_COLS output columns at a time (one V box each), smallest term first
    mbar_wait(v_full + s, parity);
#pragma unroll
    for (int c = 0; c < G::CHUNKS; ++c) {
      float pv[G::SW_COLS / 2];
#pragma unroll
      for (int i = 0; i < G::SW_COLS / 2; ++i) pv[i] = 0.f;
      hold(pv);
#pragma unroll
      for (int p = 0; p < P_TERMS; ++p)
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) hold(pa[p][kk]);
      wgmma_fence();
#pragma unroll
      for (int p = P_TERMS - 1; p >= 0; --p)
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_pv(pv, pa[p][kk], v_desc<D>(v_addr + s * G::KV_BYTES, c, kk),
                   p < P_TERMS - 1 || kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      hold(pv);
#pragma unroll
      for (int p = 0; p < P_TERMS; ++p)
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) hold(pa[p][kk]);
#pragma unroll
      for (int i = 0; i < G::SW_COLS / 2; ++i) {
        float& a = acc[c * G::SW_COLS / 2 + i];
        a = fmaf(a, alpha[(i / 2) % 2], pv[i]);
      }
    }
    mbar_arrive(v_empty + s);
  }

  __nv_bfloat16* ob = o + ((size_t)ib * hq + ih) * sq * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q_start + r0 + 8 * h;
    if (row >= sq) continue;
    const float denom = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row * D + 8 * i + c0) =
          __floats2bfloat162_rn(acc[4 * i + 2 * h] / denom, acc[4 * i + 2 * h + 1] / denom);
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query, so that the library needs no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// (b * heads, rows, D) bf16, contiguous, as a 3-D map with boxes of
// (SW_COLS, box_rows, 1) in the swizzle of Geo<D>; at D = 80 the second box
// of a row reaches past the map's 80 columns, into the zero fill
template <int D>
bool encode(EncodeTiled fn, CUtensorMap* map, const void* base, int rows, int heads,
            int box_rows) {
  using G = Geo<D>;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)G::SW_COLS, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            G::SW_BYTES == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int b, int hq, int hkv, int sq,
           int sk, float scale, int causal, int window, cudaStream_t stream) {
  using G = Geo<D>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv;
  if (!encode<D>(fn, &tq, q, sq, b * hq, BQ) || !encode<D>(fn, &tk, k, sk, b * hkv, BK) ||
      !encode<D>(fn, &tv, v, sk, b * hkv, BK))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_tc_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(hq, b, (sq + BQ - 1) / BQ);
  flash_attention_tc_kernel<D><<<grid, THREADS, G::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), hq, hkv, sq, sk, scale, causal, window);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: the same tensor cores, on exact bf16 terms of q, k, v and P
// ---------------------------------------------------------------------------

// q, k, v and P are each summed as F32_TERMS bf16 terms, each the rounding of
// what the earlier ones leave: three carry all 24 bits of a float32 value.  Of
// the 9 term products of Q.K^T (and of P.V) the kernel keeps the PAIRS with
// i + j < F32_TERMS, smallest first; the other three lie at or below float32's
// last bit.  The CPU emulation in tests/test_torch_flash_attention.py holds the
// sum to the float32 bound, and each product that it drops breaks the bound.
constexpr int F32_TERMS = 3;
constexpr int PAIRS = 6;
constexpr int QK_PRODUCTS = 6;  // Q.K^T keeps the last QK_PRODUCTS of PAIRS
constexpr int PV_PRODUCTS = 6;  // P.V keeps the last PV_PRODUCTS of PAIRS
constexpr int F32_WGS = 2;      // consumer warpgroups of a CTA, 64 query rows each
constexpr int F32_THREADS = F32_WGS * CONSUMERS + 32;  // and a producer warp

// Pair p's term of the left operand (q or P) and of the right one (k or v),
// smallest products first: (0, 2), (1, 1), (2, 0), (0, 1), (1, 0), (0, 0).
__host__ __device__ constexpr int left_term(int p) { return p < 3 ? p : p < 5 ? p - 3 : 0; }
__host__ __device__ constexpr int right_term(int p) { return p < 3 ? 2 - p : p < 5 ? 4 - p : 0; }

// Shared memory of the float32 kernel at head dim D: a warpgroup's q tile and
// each K or V slot hold F32_TERMS tiles of Geo<D>, one a term.  At DT = 128
// a slot is 48 KB, so K and V keep one slot each (two would pass 227 KB
// beside 96 KB of Q); narrower tiles keep two.
template <int D>
struct Geo32 {
  using G = Geo<D>;
  static constexpr int STAGES = G::DT <= 64 ? 2 : 1;
  static constexpr int Q_BYTES = F32_TERMS * G::Q_BYTES;
  static constexpr int KV_BYTES = F32_TERMS * G::KV_BYTES;
  static constexpr int BARRIERS = 1 + 4 * STAGES;
  static constexpr int SMEM = 1024 + F32_WGS * Q_BYTES + 2 * STAGES * KV_BYTES + 8 * BARRIERS;
  static_assert(SMEM <= 232448, "a CTA may have 227 KB of shared memory");
};

// q, k and v (pairs of float32 values; blockIdx.y picks the tensor) into
// F32_TERMS bf16 planes each, one after the other in `out`: plane t of a
// tensor holds the rounding of what planes 0 .. t-1 leave (each subtraction
// is exact).
__global__ void __launch_bounds__(256)
split_terms_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, __nv_bfloat162* __restrict__ out, size_t q_pairs,
                   size_t kv_pairs) {
  const int y = blockIdx.y;
  const float* x = y == 0 ? q : y == 1 ? k : v;
  const size_t n = y == 0 ? q_pairs : kv_pairs;
  __nv_bfloat162* planes = out + (y == 0 ? 0 : F32_TERMS * (q_pairs + (y - 1) * kv_pairs));
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float a = x[2 * i], b = x[2 * i + 1];
#pragma unroll
    for (int t = 0; t < F32_TERMS; ++t) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      planes[t * n + i] = h;
      a -= __low2float(h);
      b -= __high2float(h);
    }
  }
}

// Grid (hq, b, 128-row q tiles); 288 threads.  Warp 8 (one thread) loads both
// warpgroups' q tiles once and each K and V tile of the CTA's key range, all
// F32_TERMS planes of it, into its slot once both warpgroups are done with
// the slot's last tile.  Warpgroup w (warps 4w .. 4w + 3) owns query rows
// q_start + 64w .. + 63 and the wgmma accumulator layout of the bf16 kernel:
// thread t holds rows r0 = 16 * (t / 32) + (t % 32) / 4 and r0 + 8, and of
// each 8-column group the columns c0 = 2 * (t % 4) and c0 + 1.
template <int D>
__global__ void __launch_bounds__(F32_THREADS, 1)
flash_attention_f32_kernel(__grid_constant__ const CUtensorMap tq,
                           __grid_constant__ const CUtensorMap tk,
                           __grid_constant__ const CUtensorMap tv, float* __restrict__ o, int b,
                           int hq, int hkv, int sq, int sk, float scale, int causal, int window) {
  using G = Geo<D>;
  using F = Geo32<D>;
  constexpr int ROWS = F32_WGS * BQ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* ks = qs + F32_WGS * F::Q_BYTES;  // F::STAGES K slots
  uint8_t* vs = ks + F::STAGES * F::KV_BYTES;  // F::STAGES V slots
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + F::STAGES * F::KV_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + F::STAGES;
  uint64_t* k_empty = v_full + F::STAGES;
  uint64_t* v_empty = k_empty + F::STAGES;

  const int ih = blockIdx.x;
  const int ib = blockIdx.y;
  const int iq = gridDim.z - 1 - blockIdx.z;  // longest causal rows first
  const int q_start = iq * ROWS;
  const int q_last = min(q_start + ROWS, sq) - 1;
  const int q_wgs = (q_last - q_start) / BQ + 1;  // warpgroups with a row below sq
  // keys that some row of the CTA may see: [k_lo, k_hi), in tiles from k_first
  const int k_hi = causal ? min(sk, q_last + 1) : sk;
  const int k_lo = window > 0 ? max(0, q_start - window + 1) : 0;
  const int k_first = k_lo / BK * BK;
  const int n_tiles = k_hi > k_first ? (k_hi - k_first + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < F::STAGES; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, F32_WGS * CONSUMERS);
      mbar_init(v_empty + s, F32_WGS * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= F32_WGS * CONSUMERS) {  // the producer warp; one thread starts the copies
    if (threadIdx.x == F32_WGS * CONSUMERS) {
      // term t of a head lies t planes (b * heads heads each) after term 0
      const int q_head = ib * hq + ih;
      const int kv_head = ib * hkv + ih / (hq / hkv);
      mbar_expect_tx(q_full, q_wgs * F::Q_BYTES);
      for (int w = 0; w < q_wgs; ++w)
        for (int t = 0; t < F32_TERMS; ++t)
          for (int c = 0; c < G::CHUNKS; ++c)
            tma_load(qs + w * F::Q_BYTES + t * G::Q_BYTES + c * G::Q_CHUNK, &tq, c * G::SW_COLS,
                     q_start + w * BQ, t * b * hq + q_head, q_full);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % F::STAGES;
        const uint32_t parity = (i / F::STAGES) & 1;
        const int k_start = k_first + i * BK;
        mbar_wait(k_empty + s, parity ^ 1);
        mbar_expect_tx(k_full + s, F::KV_BYTES);
        for (int t = 0; t < F32_TERMS; ++t)
          for (int c = 0; c < G::CHUNKS; ++c)
            tma_load(ks + s * F::KV_BYTES + t * G::KV_BYTES + c * G::KV_CHUNK, &tk,
                     c * G::SW_COLS, k_start, t * b * hkv + kv_head, k_full + s);
        mbar_wait(v_empty + s, parity ^ 1);
        mbar_expect_tx(v_full + s, F::KV_BYTES);
        for (int t = 0; t < F32_TERMS; ++t)
          for (int c = 0; c < G::CHUNKS; ++c)
            tma_load(vs + s * F::KV_BYTES + t * G::KV_BYTES + c * G::KV_CHUNK, &tv,
                     c * G::SW_COLS, k_start, t * b * hkv + kv_head, v_full + s);
      }
    }
    return;
  }

  const int wg = threadIdx.x / CONSUMERS;
  const int tid = threadIdx.x % CONSUMERS;
  const int r0 = 16 * (tid / 32) + (tid % 32) / 4;
  const int c0 = 2 * (tid % 4);
  const int q0 = q_start + wg * BQ;  // this warpgroup's first query row
  // keys its rows may see: [my_lo, my_hi), none when its rows all lie past sq
  const int my_hi = q0 >= sq ? 0 : causal ? min(sk, min(q0 + BQ, sq)) : sk;
  const int my_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const uint32_t q_addr = smem_u32(qs + wg * F::Q_BYTES);
  const uint32_t k_addr = smem_u32(ks);
  const uint32_t v_addr = smem_u32(vs);

  // acc[4i + 2h + c]: row r0 + 8h, output column 8i + c0 + c (of DT; those
  // from D on stay 0)
  float acc[G::DT / 2];
#pragma unroll
  for (int i = 0; i < G::DT / 2; ++i) acc[i] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};
  if (wg < q_wgs) mbar_wait(q_full, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % F::STAGES;
    const uint32_t parity = (i / F::STAGES) & 1;
    const int k_start = k_first + i * BK;
    if (k_start >= my_hi || k_start + BK <= my_lo) {
      // no row of this warpgroup sees the tile: release the slots in turn
      mbar_wait(k_full + s, parity);
      mbar_arrive(k_empty + s);
      mbar_wait(v_full + s, parity);
      mbar_arrive(v_empty + s);
      continue;
    }

    // the tile's operand addresses, opaque to the compiler: it forms the 12
    // products' descriptors from them at each tile instead of holding them
    // all in registers across tiles
    uint32_t qa = q_addr, ka = k_addr + s * F::KV_BYTES, va = v_addr + s * F::KV_BYTES;
    asm volatile("" : "+r"(qa), "+r"(ka), "+r"(va));

    // S = sum over the kept pairs of q_i K_j^T, the smallest first, each
    // over the D real columns: st[4j + 2h + c] is row r0 + 8h, key
    // k_start + 8j + c0 + c
    float st[BK / 2];
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) st[j] = 0.f;
    mbar_wait(k_full + s, parity);
    hold(st);
    wgmma_fence();
#pragma unroll
    for (int p = PAIRS - QK_PRODUCTS; p < PAIRS; ++p)
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_qk(st, kmajor_desc<D>(qa + left_term(p) * G::Q_BYTES, G::Q_CHUNK, kk),
                 kmajor_desc<D>(ka + right_term(p) * G::KV_BYTES, G::KV_CHUNK, kk),
                 p > PAIRS - QK_PRODUCTS || kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    hold(st);
    mbar_arrive(k_empty + s);

    // masks and the online softmax, as the bf16 kernel: a row's 64 scores
    // lie on 4 threads
    const bool edge = k_start + BK > sk || (causal && k_start + BK - 1 > q0) ||
                      (window > 0 && q0 + BQ - 1 - k_start >= window);
    unsigned keep = 0xffffffffu;
    float top[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int h = (j / 2) % 2;
      if (edge) {
        const int row = q0 + r0 + 8 * h;
        const int col = k_start + 8 * (j / 4) + c0 + j % 2;
        const bool ok = col < sk && (!causal || row >= col) && (window <= 0 || row - col < window);
        keep &= ~((ok ? 0u : 1u) << j);
      }
      st[j] = (keep >> j) & 1u ? st[j] * scale : NEG_INF;
      top[h] = fmaxf(top[h], st[j]);
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      top[h] = fmaxf(top[h], __shfl_xor_sync(0xffffffffu, top[h], 1));
      top[h] = fmaxf(top[h], __shfl_xor_sync(0xffffffffu, top[h], 2));
      top[h] = fmaxf(m_run[h], top[h]);  // the new running max
    }
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int h = (j / 2) % 2;
      st[j] = (keep >> j) & 1u ? expf(st[j] - top[h]) : 0.f;
      sum[h] += st[j];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      alpha[h] = expf(m_run[h] - top[h]);
      l_run[h] = alpha[h] * l_run[h] + sum[h];
      m_run[h] = top[h];
    }

    // P in F32_TERMS bf16 terms, as wgmma A fragments (the bf16 kernel's
    // split): keys 16kk .. 16kk + 15 are accumulator columns 8kk .. 8kk + 7
    uint32_t pt[F32_TERMS][BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = st[8 * kk + 2 * j], y = st[8 * kk + 2 * j + 1];
#pragma unroll
        for (int t = 0; t < F32_TERMS; ++t) {
          const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
          pt[t][kk][j] = bf16x2_bits(h);
          x -= __low2float(h);
          y -= __high2float(h);
        }
      }

    // acc = acc * alpha + sum over the kept pairs of P_i V_j, the tile's
    // product summed apart first, SW_COLS output columns at a time
    mbar_wait(v_full + s, parity);
#pragma unroll
    for (int c = 0; c < G::CHUNKS; ++c) {
      float pv[G::SW_COLS / 2];
#pragma unroll
      for (int j = 0; j < G::SW_COLS / 2; ++j) pv[j] = 0.f;
      hold(pv);
#pragma unroll
      for (int t = 0; t < F32_TERMS; ++t)
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) hold(pt[t][kk]);
      wgmma_fence();
#pragma unroll
      for (int p = PAIRS - PV_PRODUCTS; p < PAIRS; ++p)
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_pv(pv, pt[left_term(p)][kk],
                   v_desc<D>(va + right_term(p) * G::KV_BYTES, c, kk),
                   p > PAIRS - PV_PRODUCTS || kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      hold(pv);
#pragma unroll
      for (int t = 0; t < F32_TERMS; ++t)
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) hold(pt[t][kk]);
#pragma unroll
      for (int j = 0; j < G::SW_COLS / 2; ++j) {
        float& a = acc[c * G::SW_COLS / 2 + j];
        a = fmaf(a, alpha[(j / 2) % 2], pv[j]);
      }
    }
    mbar_arrive(v_empty + s);
  }

  float* ob = o + ((size_t)ib * hq + ih) * sq * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + 8 * h;
    if (row >= sq) continue;
    const float denom = fmaxf(l_run[h], 1e-30f);
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<float2*>(ob + (size_t)row * D + 8 * i + c0) =
          make_float2(acc[4 * i + 2 * h] / denom, acc[4 * i + 2 * h + 1] / denom);
  }
}

// Bytes of scratch the float32 kernel takes: F32_TERMS bf16 planes of q, k
// and v.
size_t f32_scratch_bytes(int b, int hq, int hkv, int sq, int sk, int dh) {
  return sizeof(__nv_bfloat16) * F32_TERMS *
         ((size_t)b * hq * sq * dh + 2 * (size_t)b * hkv * sk * dh);
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, void* scratch, int b, int hq,
               int hkv, int sq, int sk, float scale, int causal, int window,
               cudaStream_t stream) {
  using F = Geo32<D>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  const size_t nq = (size_t)b * hq * sq * D, nkv = (size_t)b * hkv * sk * D;
  const size_t most = (nq > nkv ? nq : nkv) / 2;
  const dim3 split_grid((unsigned)(most < 1024 * 256 ? (most + 255) / 256 : 1024), 3);
  split_terms_kernel<<<split_grid, 256, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<__nv_bfloat162*>(scratch), nq / 2, nkv / 2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(scratch);
  const __nv_bfloat16* kp = qp + F32_TERMS * nq;
  const __nv_bfloat16* vp = kp + F32_TERMS * nkv;
  CUtensorMap tq, tk, tv;
  if (!encode<D>(fn, &tq, qp, sq, F32_TERMS * b * hq, BQ) ||
      !encode<D>(fn, &tk, kp, sk, F32_TERMS * b * hkv, BK) ||
      !encode<D>(fn, &tv, vp, sk, F32_TERMS * b * hkv, BK))
    return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(flash_attention_f32_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, F::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(hq, b, (sq + F32_WGS * BQ - 1) / (F32_WGS * BQ));
  flash_attention_f32_kernel<D><<<grid, F32_THREADS, F::SMEM, stream>>>(
      tq, tk, tv, static_cast<float*>(o), b, hq, hkv, sq, sk, scale, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace tc

// info[0..7] of a kernel as launched: registers, local (spill) bytes a
// thread, dynamic shared memory a CTA, resident CTAs an SM, the bf16 terms
// P is summed as, the bf16 terms of each of q, k and v (1: bf16 inputs,
// exact), and the term products of Q.K^T and of P.V
template <typename K>
int kernel_info(K* kernel, int threads, int smem, int p_terms, int terms, int qk_products,
                int pv_products, int* info) {
  cudaFuncAttributes attr;
  int ctas = 0;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, threads, smem);
  if (err != cudaSuccess) return (int)err;
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = smem;
  info[3] = ctas;
  info[4] = p_terms;
  info[5] = terms;
  info[6] = qk_products;
  info[7] = pv_products;
  return 0;
}

}  // namespace

// q (b, hq, sq, dh), k and v (b, hkv, sk, dh), o like q; all contiguous,
// float32 (bf16 = 0: the float32 kernel, which takes `scratch` of
// flash_attention_scratch_bytes bytes, 16-byte aligned) or bfloat16 (bf16 =
// 1: scratch unused, operands 16-byte aligned); window <= 0 means none.
// Returns the cudaError of the launch; an unsupported dh, a bf16 operand
// that no tensor map takes or a missing scratch is cudaErrorInvalidValue
// (the wrapper names the supported set), a CUDA without
// cuTensorMapEncodeTiled cudaErrorSymbolNotFound.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* scratch, int b, int hq, int hkv,
                                   int sq, int sk, int dh, int bf16, float scale,
                                   int causal, int window, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_CASE(D)                                                          \
  case D:                                                                      \
    return bf16 ? tc::launch<D>(q, k, v, o, b, hq, hkv, sq, sk, scale, causal, \
                                window, st)                                    \
                : tc::launch_f32<D>(q, k, v, o, scratch, b, hq, hkv, sq, sk,   \
                                    scale, causal, window, st);
  switch (dh) {
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(80)
    FLASH_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}

// Bytes of scratch flash_attention_fwd takes for these operands (0 for
// bfloat16).
extern "C" long long flash_attention_scratch_bytes(int b, int hq, int hkv, int sq, int sk,
                                                   int dh, int bf16) {
  return bf16 ? 0 : (long long)tc::f32_scratch_bytes(b, hq, hkv, sq, sk, dh);
}

// What flash_attention_fwd launches for (dh, bf16), as kernel_info reports
// it into info[0..7]; returns a cudaError (an unsupported dh is
// cudaErrorInvalidValue).
extern "C" int flash_attention_info(int dh, int bf16, int* info) {
#define INFO_CASE(D)                                                                \
  case D:                                                                           \
    return bf16 ? kernel_info(tc::flash_attention_tc_kernel<D>, tc::THREADS,        \
                              tc::Geo<D>::SMEM, tc::P_TERMS, 1, 1, tc::P_TERMS,     \
                              info)                                                 \
                : kernel_info(tc::flash_attention_f32_kernel<D>, tc::F32_THREADS,   \
                              tc::Geo32<D>::SMEM, tc::F32_TERMS, tc::F32_TERMS,     \
                              tc::QK_PRODUCTS, tc::PV_PRODUCTS, info);
  switch (dh) {
    INFO_CASE(32)
    INFO_CASE(64)
    INFO_CASE(80)
    INFO_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef INFO_CASE
}
