#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it.

    python3 chip_smoke.py

Phases, one or more lines each; any failure exits non-zero:

1. device   — the card's name, and its name and power limit from nvidia-smi;
2. build    — nvcc builds the kernels from src/repro_torch/kernels/*/csrc,
               one process per source, started together;
   analysis — the port's static-analysis passes on the card
               (repro_torch.analysis.collect("cuda")): one line a kernel
               (shared memory against the 232,448 B a CTA may opt into,
               the largest block of gs_pass unweighted and weighted and of
               gs_pass_multi, and the built library's registers, spill
               bytes, static and dynamic shared memory and CTAs an SM of
               every device function; flash_attention's lines name the
               instantiation: bf16 on the tensor cores, f32 on the CUDA
               cores); the mirror of each layout against the library's
               gs_pass_plan and gs_pass_multi_smem_bytes at every block
               from 1 to one past the largest; every non-numpy registry
               variant and both PPREngine backends traced on the tiny
               R-MAT graph, host reads per iteration and uploads per solve
               against their contract; fails on any unsuppressed finding,
               and where host-reads is suppressed, on any read past the
               one design read;
3. kernels  — on the full-size webStanford surrogate (n=281,903,
               m=2,312,497) at block 256, unweighted and weighted+biased,
               each kernel is held against its plain PyTorch version and
               timed beside it (the kernel and the library call by device
               time in a profiler trace, or by CUDA events around a call
               where a trace holds no device events, each time's line
               saying which; the plain version by the host's clock),
               beside one library call where PyTorch has
               one, and beside its bound from the H100's 3.35 TB/s
               (gs_pass_multi at b = 8 rows from make_query_stream, some
               frozen, and its b = 1 identity with gs_pass; then at b = 64,
               and a pass of 65 rows in two launches, timed); gs_pass under
               whole-block freezes, the masks the adaptive schedule gives
               it (none, a random half, all but the first or the last
               block, alternating runs of 1 and 9 frozen blocks, all),
               each against its plain version, frozen lanes bit for bit
               the input;
4. solve    — the launcher's solve path (repro_torch.launch.pagerank_run)
               at full size with --handle-dangling for blocked,
               blocked_nosync, blocked_nosync_opt, blocked_adaptive,
               nosync, nosync_adaptive, barrier, barrier_edge and
               barrier_identical, with launch counts and L1 to the float64
               oracle (barrier_edge and barrier_identical within one
               iteration of barrier); then Fig 7 (no-sync needs no more
               iterations than barrier) on the paper's setting, without
               dangling redistribution;
5. adaptive — on the BFS-reordered surrogate (compute_order "bfs"):
               gs_pass under the kernel phase's whole-block masks on its
               block and edge structure; with dangling redistribution on
               and off, blocked_nosync against blocked_adaptive (passes,
               block sweeps, the share of blocks frozen per pass, one
               gs_pass a pass, L1, wall; a second blocked_adaptive solve
               holds each pass against gs_pass_ref under the masks its
               schedule gave) and nosync against nosync_adaptive at 56
               threads, every run's float64 residual at or below the
               threshold;
6. repeat   — barrier, nosync and blocked solved twice at full size, and
               blocked_adaptive and nosync_adaptive on the BFS-reordered
               graph, must give the same iterations, sweeps and ranks, and
               the residual curve of barrier, blocked and blocked_nosync
               run past the threshold shows how far 1e-8 sits above the
               float32 floor;
7. profile  — one traced solve of blocked, blocked_nosync, blocked_adaptive
               (also on the BFS-reordered graph) and ppr_blocked (8
               rows): device time by kernel and the device's busy share;
8. sticd    — the STIC-D plan of the full graph (DecompositionPlan,
               host): its counts held to the reference's, its build and
               reconstruct times; one gs_pass on the weighted, biased
               core's operands (351 blocks) against its plain version;
               barrier_sticd, nosync_sticd (56 threads) and plan_build in
               front of blocked, blocked_nosync and blocked_adaptive,
               each warmed up and beside its unplanned variant
               (iterations, sweeps, wall, L1 to the float64 oracle of the
               full graph, launches), dangling redistribution on and off;
               the planned kernel solves traced;
9. ppr      — batched PPR at full size, 8 seed rows from
               make_query_stream(n, 8, seed=0), --handle-dangling,
               threshold 1e-8: ppr_blocked (the gs_pass_multi main path),
               ppr_barrier and ppr_nosync, each row within L1 1e-4 of a
               float64 scipy oracle; a uniform ppr_blocked row against the
               global blocked fixed point; two ppr_blocked solves repeat;
               ppr_blocked at 65 rows, more than one launch takes, in
               chunks of rows, each row against the oracle;
10. engine  — PPREngine on the kernel backend, 8 slots, the 32 queries of
               make_query_stream(n, 32, seed=0) at threshold 1e-6: every
               top-k is the oracle's, q/s and latency; the torch backend
               answers with the same top-k;
11. distributed — four partitions on the card (ShardMesh((cuda,) * 4)),
               full size, threshold 1e-8, dangling redistribution on and
               off: distributed_pagerank barrier and stale (4 sweeps a
               round) and distributed_pagerank_topk (2 sweeps, 1/8 of the
               deltas), every shard's sweeps of the first 2 rounds held
               against spmv_csr_rows_ref, each solve twice (equal), L1 to
               a float64 oracle ≤ 1e-4, launches = sweeps, stale's rounds
               ≤ barrier's without dangling; the three registry entries at
               threads=56 (p = 1 on one card); spmv_csr_rows on a
               partition timed; the engine's cuda backend with its 8 slots
               over 4 shards (2 rows a gs_pass_multi launch): every
               shard's passes of a first engine step held against
               gs_pass_multi_ref, then the engine's 32 queries, every
               top-k the oracle's and the unsharded engine's;
12. dynamic — IncrementalPageRank (leaky convention, tol 1e-8): the
               blocked_nosync initial solve (gs_pass) and its float64
               refinement, 4 sink-bounded and 2 uniform batches of 250
               ops, one forced fallback (push budget 0: the warm global
               solve, every gs_pass held against gs_pass_ref on the
               updated operands) and one more, traced (device busy
               share), then a blocked (spmv_csr_acc) initial
               solve and forced fallback, each spmv_csr_acc call held
               against its plain version; every batch within L1 1e-6 of
               a float64 oracle of the updated graph and within its
               certificate plus the oracle's error, every sink-bounded
               batch a push touching under 10 % of the vertices;
13. ppr serve — the launcher's serve --backend cuda with 500 live edge
               updates in 2 batches (8 slots, 32 queries, threshold
               1e-6), all at once under the profiler (device busy share),
               then as a closed loop at half the q/s the first run
               reached (the only run that answers on the graph of the
               first batch alone): every answer on an updated graph,
               rebuilt from the seeded update stream, is its float64
               oracle's top-k, and gs_pass_multi launches on the backend
               rebuilt for each updated graph;
14. push    — ppr_push and ppr_push_priority (host float64) at rmax
               1e-8 from the distinct seed sets of the engine's first 8
               queries: rounds, pushes, the L1 certificate, wall; every
               estimate at or below the oracle, every top-10 the oracle's
               up to the certificate;
    build   — (run after phase 23, with store and faults; its two
               children start before phase 15 and stream to disk while
               phases 15–23 use the card) the out-of-core build
               pipeline through the launcher's build:
               at 1/16 of socLiveJournal1, an unordered build's raw store
               has the array files and CRC-32s of make_dataset's cache
               entry, and reorder_store of that entry equals a BFS build;
               then socLiveJournal1 at full size (n 4,847,571, m
               68,993,773) streamed to disk under build/ in two child
               processes (--stages generate, then a resume that skips it
               and runs the BFS reorder and the layout), each stage's wall
               and each child's peak RSS beside 16 m bytes; the raw store
               has the Table-1 counts and verifies, LAYOUT.json's bounds
               are partition_ranges(56); from the raw store's memmap,
               blocked_nosync (gs_pass) and blocked (spmv_csr_acc) with
               dangling redistribution, the first 2 launches of each
               warm-up held against the plain versions, launches = passes,
               L1 to the float64 oracle ≤ 1e-4, both kernels timed beside
               their bytes bounds (and torch.sparse for spmv_csr_acc);
               blocked_nosync from the BFS-reordered store, ranks in
               original ids held to the same oracle, gs_pass timed there;
               full webStanford built BFS-ordered and solved by the
               launcher's --store <build dir> --ckpt: original ids, within
               1e-4 of a resident solve's; the builds are deleted at the
               end;
    store   — the dataset cache at 1/16 of socLiveJournal1 (make_dataset
               saves, then hits: memmap-backed, CRC-verified, equal array
               for array); full webStanford saved BFS-ordered with its
               perm and solved by the launcher with --store and --ckpt:
               ranks in original ids, within 1e-4 of a resident solve's,
               the checkpoint's p and ranks the report's; the stores are
               deleted at the end;
    faults  — the Wait-Free simulator (Alg 6) on full webStanford at
               p = 8, threshold 1e-8: barrier, nosync and waitfree with no
               fault, worker 0 asleep 2, 5, 10 every iteration (Fig 8), 1,
               2, 3 workers failed at iteration 2 (Fig 9); every card run
               equal to the same run on the CPU (iterations, work, time;
               ranks within 1e-12), every converged run within the
               threshold's certificate of the leaky float64 oracle, the
               reference tests' claims, and the Fig 8/9 table;
15. flash   — flash_attention against its plain version over the
               reference's test matrix (f32/bf16 x 3 head layouts x
               causal / window 64 / full, s 256, dh 64), ragged and
               sq != sk lengths (dh 32), and 20 cases at dh 80 (GQA and
               MHA, causal / window 64 / full, ragged), every entry within
               its bound, and in bf16 few entries other than the float32
               plain result rounded to bf16; then at the prefill shapes of
               qwen2-vl-2b (b 2, hq 12, hkv 2, s 4096, dh 128; causal and
               window 512), stablelm-3b (b 2, hq 32, hkv 32, s 4096, dh 80),
               starcoder2-3b (b 2, hq 24, hkv 2, s 8192, dh 128, window
               4096, which masks a quarter of the causal pairs),
               mixtral-8x22b (b 1, hq 48, hkv 8, s 8192, dh 128, window
               4096) and whisper-medium's encoder (b 2, hq = hkv = 16,
               s 1500, dh 64, no causal mask), checked
               and timed beside the plain version, SDPA (with a band mask
               for a window) and the bound (and, in bf16, the floor of the
               kernel's own tensor-core work: P·V as P_TERMS bf16
               products);
16. prefill — qwen2-vl-2b at full width (1.54 B parameters, bf16, random
               from a seeded generator): forward at b 2, s 4096 launches
               the kernel once per layer (the main path); tokens/s over
               three runs, the trace; f32 kernel route against the plain
               route entry-wise; bf16 routes against the f32 forward;
17. decode  — 128 teacher-forced f32 decode steps against the prefill's
               logits, ms per step (no kernel on this path);
18. serve   — repro_torch.launch.serve --preset full: every request
               finishes (no kernel on this path); then the same requests
               and loop in float32 on the decode phase's weights, every
               token the engine picks held against forward's argmax over
               the tokens its slot was fed;
19. lm      — phases 16 and 17 for the other dense decoders at their
               published widths (DENSE_LMS): starcoder2-3b at b 2, s 8192
               (30 launches, its window of 4096 live), phi3-medium-14b
               (40 launches; its f32 checks on the first 10 layers, as an
               f32 copy of all 40 does not fit beside the bf16 model),
               stablelm-3b (32 launches at dh 80), gemma2-2b at b 1,
               s 8192 (no launch: softcapped attention takes the plain
               route, as in the reference; its bf16 error against its f32
               forward); then serve --preset full for starcoder2-3b and
               gemma2-2b;
20. moe     — phase 19's checks for the MoE decoders at their published
               widths on their first 4 layers (MOE_LMS; the published
               depths take 281 and 479 GB in bf16), the reckoning
               printed: mixtral-8x22b at b 1, s 8192 (4 flash launches,
               window 4096 live; f32 checks on 2 layers) and
               deepseek-v2-236b at b 1, s 4096 (MLA: the plain route, no
               launch; f32 checks on 1 layer); the pairs the sparse
               dispatch drops at capacity 1.25; the f32 and bf16
               comparisons under the dense dispatch, tokens whose
               experts differ between the compared runs reported with
               their gate margins and left out (a first flip above
               FLIP_MARGIN fails); decode at b 1 against the dense
               prefill; the f32 engine at 1 slot, every pick forward's
               argmax, and at 4 slots, every request finished;
21. ssm     — phase 19's checks for the SSM and hybrid decoders at their
               published widths and depths (SSM_LMS), every layer on the
               card: falcon-mamba-7b (64 Mamba-1 layers, b 2, s 4096; no
               attention, no launch) and zamba2-2.7b (54 Mamba-2 layers, b
               2, s 4096; its shared block after every 6 launches
               flash_attention 9 times at stablelm-3b's shape); the
               logits' range; the trace (falcon-mamba-7b's on its first 2
               layers), the launches a prefill and the scan's share of
               the device time from one layer and its scan traced alone;
               the f32 checks and decode on the first 16 and 18 layers
               (for time: a float32 copy of all fits); then serve
               --preset full for both;
22. whisper — whisper-medium at its published width and depth (24
               encoder and 24 decoder layers, 0.81 B parameters, bf16,
               random from a seeded generator), b 2, 1,500 random frames,
               448 tokens: the prefill launches the kernel once per
               encoder layer (not causal) and once per decoder layer
               (48), frames+tokens/s over three runs beside the plain
               route, the trace and the kernel's share of it; a float32
               copy of every layer, kernel route against plain route
               entry-wise; the bf16 routes against the float32 forward;
               128 teacher-forced float32 decode steps through the cross
               cache against the prefill; serve --arch whisper-medium
               exits as the reference's;
23. train   — repro_torch.launch.train: stablelm-3b --preset full (2.8 B
               parameters, bf16) for 4 sync steps at seq 256, global
               batch 8: finite losses and norms, every parameter moved, no
               flash launch (training takes the plain route), seconds a
               step, peak memory and AdamW's share of a step;
               whisper-medium --preset 100m for 2 steps; local SGD over 2
               replicas (equal after the int8 sync); a --preset 100m run
               checkpointed every 2 steps, restored from LATEST and saved
               again bit for bit, and resumed; one reduced float32 step,
               card against CPU;
24. dryrun  — the dry run's counts (repro_torch.launch.dryrun) held to the
               card: qwen2-vl-2b's bf16 prefill of phase 16 (b 2, s 4096)
               walked on the meta device by build_cell at full depth and
               run on the card with the same seeded weights under the same
               counting mode (repro_torch.utils.cost): equal FLOPs, flash
               ops equal to the kernel's launches (28), parameter bytes on
               the card equal to the dry run's argument bytes on a 1 x 1
               mesh; the counted TFLOP of phase 16's timed prefill, its
               TFLOP/s and share of 989 TFLOP/s (mfu), its roofline terms
               against its wall, the counted peak bytes against
               torch.cuda.max_memory_allocated, the dispatcher's cost a
               call of the flash op; the same FLOP check and mfu for
               phase 23's stablelm-3b train step (seq 256, batch 8), and
               AdamW's counted bytes over its measured time (bytes a
               second, share of 3.35 TB/s); and the whole grid
               (--all --both-meshes) in a host child started right after
               the build, beside the card phases: 0 failed, exactly the
               reference's cells skipped, its wall and peak RSS.

Each phase ends with its host wall on a line ``phase <name>: wall_s=``.
It then prints one JSON line naming every kernel (its ``timed_by`` says
how each of its times was taken: ``"trace"`` or ``"events"``), the
nvidia-smi line, and last the JSON device record.  Without a CUDA device, or without the port's
sources beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
if os.path.isdir(os.path.join(SRC, "repro_torch")):  # else main() stops first
    sys.path.insert(0, SRC)
    # the H100's peaks (NVIDIA data sheet) and the bounds set beside every kernel
    from repro_torch.utils.roofline import (
        BF16_TC_FLOPS,
        HBM_BYTES_PER_S,
        attention_pairs,
        bound_ms,
        flash_bound,
    )
# A kernel agrees with its plain version when its max abs error is
# ≤ KERNEL_RTOL · max|plain| and every entry is within KERNEL_RTOL · (its
# |plain| + the mean |plain| of its rank row): the sums differ only in
# float32 order.  The entry-wise bound catches a wrong entry far from a
# PPR seed, which the bound on max|plain| alone would let pass.
KERNEL_RTOL = 1e-5
SOLVE_THRESHOLD = 1e-8
FLOOR_ITERS = 150  # solves run past the threshold to find the float32 floor
# L1 to the float64 oracle at full size: the reference's tests hold 1e-5 on
# graphs of ≤ 256 vertices; float32 rank error grows with n.
L1_BOUND = {"blocked_nosync_opt": 1e-3}
L1_DEFAULT = 1e-4
# The adaptive schedules stop a unit once its certified residual bound is
# at or below threshold / 2, and the solve once every unit's last change
# (swept) or bound (skipped) is at or below threshold.  The certificate is
# in max norm: it leaves room for a residual of up to threshold / 2 at
# every vertex a skipped unit holds, so L1 to the fixed point up to
# n · threshold / (2 (1 - d)) (the L1 error is at most the residual's L1
# over 1 - d).  With dangling redistribution those residuals share one
# sign (the dangling mass a skipped block last saw), so the L1 grows with
# n, in the reference as in the port
# (tests/test_torch_adaptive.py::test_adaptive_dangling_l1_is_the_references
# and ::test_blocked_adaptive_dangling_l1_is_the_references); at full size
# it exceeds L1_DEFAULT, and the adaptive phase holds those two runs to
# this allowance, beside the per-vertex check of residual_allowance.
def adaptive_l1_bound(n: int, d: float = 0.85) -> float:
    return n * SOLVE_THRESHOLD / (2 * (1 - d))


def residual_allowance(g, pr, dangling: bool, d: float = 0.85) -> np.ndarray:
    """What the stop rule certifies about the residual each vertex keeps:
    its unit's bound before the last pass (0 if swept, at most threshold / 2
    if skipped) plus the last pass's changes of its in-neighbours, each at
    most threshold, moving it by at most d · threshold · G_v, where G_v =
    Σ_{u→v} 1/outdeg(u) (+ the dangling count / n with redistribution) is
    the row sum of the vertex gain.  So threshold · (1/2 + d · G_v), which
    holds for the plain Gauss–Seidel schedules too (their first term is
    0).  On top, a pass's float32 sums may leave each rank KERNEL_RTOL ·
    (|rank| + the mean |rank|) from the exact pass, the kernel's entry
    bound."""
    pr = np.abs(np.asarray(pr, np.float64))
    inv = np.where(g.out_degree > 0, 1.0 / np.maximum(g.out_degree, 1), 0.0)
    gv = np.bincount(g.dst, weights=inv[g.src], minlength=g.n)
    if dangling:
        gv += np.count_nonzero(g.out_degree == 0) / g.n
    return (SOLVE_THRESHOLD * (0.5 + d * gv)
            + KERNEL_RTOL * (pr + pr.mean()))


def jacobi_residual(g, pr, dangling: bool, d: float = 0.85) -> np.ndarray:
    """One float64 Jacobi step of ``pr`` minus ``pr``: the residual a
    solve leaves; the L1 error to the fixed point is at most its L1 over
    1 - d."""
    pr = np.asarray(pr, np.float64)
    inv = np.where(g.out_degree > 0, 1.0 / np.maximum(g.out_degree, 1), 0.0)
    new = (1 - d) / g.n + d * np.bincount(g.dst, weights=(pr * inv)[g.src],
                                          minlength=g.n)
    if dangling:
        new += d * pr[g.out_degree == 0].sum() / g.n
    return new - pr
PPR_ROWS = 8  # seed rows of the batched solves and of gs_pass_multi
PPR_WIDE_ROWS = 65  # one row more than one gs_pass_multi launch takes
ENGINE_QUERIES = 32
ENGINE_THRESHOLD = 1e-6
TIE = 1e-7  # oracle values this close may swap places in a top-k
TOPK_VALUE_TOL = 1e-5
# flash attention and the LM path.
# flash_attention agrees with its plain version when every entry is within
# FLASH_RTOL·(|ref| + the mean |ref| of its row): a float32 output against
# the plain result evaluated in float64, a bfloat16 output against the
# float32 plain result on the same inputs, with one bf16 rounding (half an
# ulp: BF16_ROUNDING·|ref|) on top.
FLASH_RTOL = 1e-5
BF16_ROUNDING = 2.0**-8
# That bound cannot see float32 digits under the rounding; the share of
# bf16 entries that differ from the float32 plain result rounded once to
# bf16 can.  Its limit lies between the H100's readings for the kernel's
# 3 P terms (2.0e-4 to 6.1e-4 over the cases below) and a 2-term copy of
# it (1.9e-3 to 2.3e-3), from scripts/flash_ablation.py.
BF16_DIFFER_SHARE = 1e-3
LM_BATCH, LM_SEQ = 2, 4096  # qwen2-vl-2b prefill
LOGIT_RTOL = 1e-4  # f32 logits, kernel vs plain route, entry-wise
# An MoE token routed to other experts by two f32 runs that should agree
# must have sat this near a tie (its K-th less its (K+1)-th softmax weight)
FLIP_MARGIN = 1e-5
BF16_ERR_RATIO = 1.25  # bf16 kernel route's mean error over the plain route's
DECODE_STEPS = 128
DECODE_TOL = 2e-3  # decode vs prefill, the reference test's atol = rtol
# the kernel's plain version in PLAIN_CHUNK-row q-chunks (as the models'
# plain route) where one call's float32 scores would pass 4 GiB
PLAIN_SCORE_BYTES = 4 * 2**30
PLAIN_CHUNK = 1024
# the prefill shapes the main paths give flash_attention, checked and timed
# in the flash phase: (model, (b, hq, hkv, s, dh), windows)
WHISPER_BATCH = 2
WHISPER_TOKENS = 448  # the decoder's context
# the train phase: stablelm-3b at full width, as the reference's launcher
# trains (seq 256, global batch 8, loss chunks of 128)
TRAIN_ARCH = "stablelm-3b"
TRAIN_ARGV = ["--seq-len", "256", "--global-batch", "8", "--log-every", "1"]
TRAIN_STEPS = 4
TRAIN_LOSS_RTOL = 1e-5  # one reduced f32 step, card against CPU
TRAIN_NORM_RTOL = 1e-4
FLASH_TIMED = (  # (model, (b, hq, hkv, s, dh), windows, causal)
    ("qwen2-vl-2b", (LM_BATCH, 12, 2, LM_SEQ, 128), (None, 512), True),
    ("stablelm-3b", (2, 32, 32, 4096, 80), (None,), True),
    ("starcoder2-3b", (2, 24, 2, 8192, 128), (4096,), True),
    ("mixtral-8x22b", (1, 48, 8, 8192, 128), (4096,), True),
    # whisper-medium's encoder: 1,500 frames, no causal mask
    ("whisper-medium", (WHISPER_BATCH, 16, 16, 1500, 64), (None,), False),
)
# the dense decoders after qwen2-vl-2b: (arch, prefill b, s, layers of the
# float32 checks, None for all)
DENSE_LMS = (
    # s 8192: a quarter of the causal (q, k) pairs lie outside its window of 4096
    ("starcoder2-3b", 2, 8192, None),
    # a float32 copy of all 40 layers (58.6 GB) does not fit beside the bf16 29.3 GB
    ("phi3-medium-14b", 2, 4096, 10),
    ("stablelm-3b", 2, 4096, None),
    # b 1, s 8192: its local layers' window of 4096 bites; f32 logits are 8.4 GB
    ("gemma2-2b", 1, 8192, None),
)
DENSE_SERVED = ("starcoder2-3b", "gemma2-2b")
# the MoE decoders at their published widths, which do not fit one card at
# their published depths (281 and 479 GB in bf16): (arch, prefill b, s,
# layers built, layers of the float32 checks)
MOE_LMS = (
    # s 8192: its window of 4096 is live; 20.8 GB in bf16, the f32 checks 21.6 GB
    ("mixtral-8x22b", 1, 8192, 4, 2),
    # 33.9 GB in bf16, the f32 checks 20.1 GB (with the f32 embedding and head)
    ("deepseek-v2-236b", 1, 4096, 4, 1),
)
# the SSM and hybrid decoders at their published widths and depths: (arch,
# prefill b, s, layers of the float32 checks, layers traced (None: all)).
# A float32 copy of every layer fits beside either bf16 model (29.1 GB
# beside 14.5, 9.7 beside 4.8), but with the checks at full depth the
# script took 1,137 s of its 1,200 on an H100 whose host ran the earlier
# phases 1.2x slower than usual (the ssm phases 107 s of it), so they run
# on the first quarter and third of the layers.
# zamba2-2.7b's shared block runs flash_attention at stablelm-3b's
# prefill shape (b 2, hq = hkv = 32, s 4096, dh 80, causal), which
# FLASH_TIMED already checks and times: no timed shape of its own.
SSM_LMS = (
    # a prefill runs ~270k device ops (one a token a layer in the scan);
    # the profiler takes seconds a thousand of them: traced on 2 layers
    ("falcon-mamba-7b", 2, 4096, 16, 2),
    # 3 of its 9 groups, each with the shared block after it
    ("zamba2-2.7b", 2, 4096, 18, None),
)
MOE_SERVE_LEN = 160  # one slot serves the launcher's 6 requests, ~125 decode calls
SERVE_TIE = 1e-4  # top-2 logit gap under which either token is greedy's pick
# The reference's DecompositionPlan of the full webStanford surrogate
# (host numpy, the same in both packages; tests/test_torch_sticd.py holds
# the port's plan to the reference's array for array).
STICD_STATS = {"full_n": 281903, "full_m": 2312497, "core_n": 89625,
               "core_m": 2238907, "pruned_identical": 6648,
               "pruned_chain": 30989, "pruned_dead": 154641,
               "pruned_edges": 83929, "contracted_edges": 10339}
STICD_CORE_BLOCKS = 351  # the core's dst blocks of 256
# (planned, unplanned): the two registered sticd variants and plan_build
# in front of the three blocked kernel variants
STICD_PAIRS = (("barrier_sticd", "barrier"), ("nosync_sticd", "nosync"),
               ("plan(blocked)", "blocked"), ("plan(blocked_nosync)", "blocked_nosync"),
               ("plan(blocked_adaptive)", "blocked_adaptive"))
STICD_REPS = 5  # warmed solves timed per variant; their median wall is reported
PUSH_RMAX = 1e-8
PUSH_TOPK = 10
# dynamic updates (leaky convention only): IncrementalPageRank's tol, the
# ops a batch, the reference's locality bar for sink-bounded batches
# (benchmarks/bench_dynamic.py) and the L1 every batch must reach
# the distributed solvers: four partitions on one card, the reference's
# registry defaults (stale 4 sweeps a round, topk 2 and 1/8 of the deltas)
DIST_P = 4
DIST_SWEEPS = 4
DIST_TOPK_SWEEPS = 2
DIST_SEND_FRACTION = 0.125
DIST_CHECKED_ROUNDS = 2  # rounds whose every shard sweep is held to the twin
DYN_TOL = 1e-8
DYN_OPS = 250
LOCALIZED_TOUCHED_MAX = 0.10
DYN_L1 = 1e-6
# the global float64 oracle of an updated graph stops when a step moves
# the vector by at most this in L1; it is then within d / (1 - d) of it
GLOBAL_ORACLE_STEP = 1e-13
# the build phase: socLiveJournal1 (n 4,847,571, m 68,993,773) streamed to
# disk by the launcher's build under the checkout's git-ignored build/,
# deleted at the phase's end; its parity with the in-RAM path is checked at
# 1/16 of that size; the first launches of each warm-up held to the plain
# versions; the layout stage's partitions are the launcher's --threads
STORE_DATASET = "socLiveJournal1"
BUILD_DIR = os.path.join(ROOT, "build", "smoke_build")
BUILD_PARITY_SCALE_DOWN = 16
BUILD_THREADS = 56
BUILD_CHILD_TIMEOUT = 600  # seconds for one child's build stages
STORE_CHECKED = 2
# the store phase: the dataset cache at 1/16 of socLiveJournal1, and full
# webStanford saved BFS-ordered, under build/ and deleted at the end
STORE_DIR = os.path.join(ROOT, "build", "smoke_store")
STORE_CACHE_SCALE_DOWN = 16
# the faults phase: benchmarks/bench_faults.py's setup (p = 8, threshold
# 1e-8, worker 0 asleep 2, 5, 10 every iteration; 1, 2, 3 workers failed at
# iteration 2, barrier cut at 60 rounds) on full webStanford; card and CPU
# runs of the float64 simulator differ only in the last bits of the ranks
# (CUDA's segment sums add by a tree, the CPU's in edge order)
FAULT_P = 8
FAULT_THRESHOLD = 1e-8
FAULT_SLEEPS = (2.0, 5.0, 10.0)
FAULT_FAILED = (1, 2, 3)
FAULT_FAIL_AT = 2
FAULT_BARRIER_MAX_ITER = 60
FAULT_CPU_L1 = 1e-12
# serve with live updates: the launcher's arguments (no dangling
# redistribution: updates keep the leaky convention)
SERVE_UPDATES, SERVE_BATCHES, SERVE_SEED = 500, 2, 0
SERVE_ARGV = ["serve", "--backend", "cuda", "--dataset", "webStanford",
              "--scale-down", "1", "--slots", str(PPR_ROWS), "--queries",
              str(ENGINE_QUERIES), "--threshold", str(ENGINE_THRESHOLD),
              "--updates", str(SERVE_UPDATES), "--update-batches",
              str(SERVE_BATCHES), "--seed", str(SERVE_SEED)]


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def phase_wall(name: str):
    """Print the host wall of the phase run inside, on a line of its own."""
    t0 = time.perf_counter()
    yield
    print(f"phase {name}: wall_s={time.perf_counter() - t0:.1f}", flush=True)


def time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median over ``reps`` launches of ``fn``, each between CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int, warmup: int = 3, tries: int = 3) -> tuple[float, str]:
    """Device time of one call of ``fn`` and how it was taken: the CUDA
    kernels and copies in a profiler trace of ``reps`` calls (``"trace"``).
    Unlike :func:`time_ms` it leaves out the host's time to make the call,
    which a kernel of tens of microseconds does not hide.

    A trace may hold fewer events of a kernel than the calls made (on the
    H100, often one call's or more; a sum over reps then understates the
    time), so each kernel counts as its mean over the events held, times
    its launches a call, ``ceil(events / reps)`` (exact while a trace
    loses less than one call's share of a kernel's events).  A trace now
    and then holds no device events;
    after ``tries`` such traces it falls back to :func:`time_ms`
    (``"events"``) and says so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if not rows:
            continue
        short = [f"{e.key[:40]} {e.count}" for e in rows if e.count % reps]
        if short:
            print(f"device_ms: a trace of {reps} calls held {', '.join(short)} "
                  f"events: those kernels count as the mean of the held ones",
                  flush=True)
        us = sum(e.self_device_time_total / e.count * -(-e.count // reps) for e in rows)
        return us / 1e3, "trace"
    print(f"device_ms: {tries} traces held no device time; CUDA events instead",
          flush=True)
    return time_ms(fn, reps), "events"


def batch_ms(fn, reps: int, warmup: int = 3) -> float:
    """One call's share of the time between CUDA events around ``reps``
    calls made back to back: the device's time per call wherever the
    device, not the host's wrapper, is the slower of the two.  A check on
    :func:`device_ms` that loses no event."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def agreement(out, ref) -> tuple[float, float, float]:
    """Max abs error, that over max|ref|, and the largest entry-wise error
    over |ref| plus the mean |ref| of the entry's rank row (the last axis
    of a batched ``(n_blocks, block, b)`` state indexes rows)."""
    err = (out - ref).abs()
    mag = ref.abs()
    dims = (0, 1) if ref.dim() == 3 else None
    scale = mag + mag.mean(dim=dims, keepdim=dims is not None)
    return (float(err.max()), float(err.max() / mag.max()),
            float((err / scale).max()))


def check_agreement(name: str, out, ref) -> tuple[float, float, float]:
    err, rel, ent = agreement(out, ref)
    check(rel <= KERNEL_RTOL and ent <= KERNEL_RTOL,
          f"{name} disagrees with its plain version: max abs err {err:.3e}, "
          f"over max|plain| {rel:.3e}, entry-wise {ent:.3e} "
          f"(bound {KERNEL_RTOL:g} each)")
    return err, rel, ent


def weighted_graph(g):
    """``g`` with edge weights in (0, 1] and vertex biases in [0.5, 1.5),
    from a seeded generator: the weighted+biased graph of the kernel phase."""
    from repro_torch.graphs import Graph

    rng = np.random.default_rng(1)
    return Graph.from_arrays(g.n, g.src, g.dst, g.out_degree, g.in_ptr,
                             weights=1.0 - rng.random(g.m),  # in (0, 1]
                             bias=rng.uniform(0.5, 1.5, g.n))


def gs_inputs(graph, bg, rng, d=0.85):
    """gs_pass's operands in the kernel phase, drawn from ``rng``: a random
    state, a tenth of the real lanes frozen, and params with the state's
    dangling mass.  Returns (pr, frozen, params)."""
    dev = bg.vmask.device
    n_pad = bg.n_blocks * bg.block
    shape = (bg.n_blocks, bg.block)
    pr = torch.as_tensor(rng.random(n_pad).astype(np.float32) / graph.n,
                         device=dev).reshape(shape) * bg.vmask
    frozen = torch.as_tensor(rng.random(n_pad) < 0.1,
                             device=dev).reshape(shape) & (bg.vmask > 0)
    dmass = d * float(torch.sum(pr * bg.dangling)) / graph.n
    params = torch.tensor([(1 - d) / graph.n, d, dmass], dtype=torch.float32,
                          device=dev)
    return pr, frozen, params


def block_masks(n_blocks: int) -> dict[str, np.ndarray]:
    """Whole-block freeze masks, ``(n_blocks,)`` bool, as the adaptive
    schedule gives gs_pass: none, a seeded random half, all but the first
    block, all but the last, alternating runs of 1 and 9 frozen blocks
    (each run ended by one live block; a run of 9 is longer than the k
    blocks between a helper's gather and its sum), and all."""
    runs = np.array([True, False] + [True] * 9 + [False])
    masks = {
        "none": np.zeros(n_blocks, bool),
        "random half": np.random.default_rng(3).permutation(n_blocks) < n_blocks // 2,
        "all but the first": np.arange(n_blocks) > 0,
        "all but the last": np.arange(n_blocks) < n_blocks - 1,
        "runs of 1 and 9": np.resize(runs, n_blocks),
        "all": np.ones(n_blocks, bool),
    }
    return masks


def whole_block_check(tag, bg, pr, params, dev) -> float:
    """gs_pass under each of :func:`block_masks`' whole-block freezes,
    against its plain version within the entry bound, frozen lanes bit for
    bit the input (an all-frozen pass returns its input), and timed.
    Returns the largest max abs error."""
    from repro_torch.kernels.spmv import gs_pass, gs_pass_ref

    worst = 0.0
    for name, blocks in block_masks(bg.n_blocks).items():
        frozen = torch.as_tensor(blocks, device=dev)[:, None].expand(
            bg.n_blocks, bg.block).contiguous()
        args = (pr, bg.inv_out, bg.vmask, params, bg.in_ptr, bg.src,
                bg.weights, bg.bias, frozen)
        out, ref = gs_pass(*args), gs_pass_ref(*args)
        torch.cuda.synchronize()
        err, rel, ent = check_agreement(f"gs_pass ({tag}, {name} frozen)", out, ref)
        check(torch.equal(out[frozen], pr[frozen]),
              f"gs_pass ({tag}, {name} frozen) moved a frozen lane")
        if blocks.all():
            check(torch.equal(out, pr),
                  f"gs_pass ({tag}, all frozen) did not return its input")
        ms, by = device_ms(lambda: gs_pass(*args), 10)
        worst = max(worst, err)
        print(f"kernel gs_pass {tag} whole blocks frozen ({name}: "
              f"{int(blocks.sum())} of {bg.n_blocks}): max_abs_err={err:.3e} "
              f"entry_rel={ent:.3e} (bound {KERNEL_RTOL:g}); frozen lanes "
              f"bit-identical; ms={ms:.4f} (device, by {by})", flush=True)
    return worst


def analysis_phase() -> None:
    """Run every pass of ``repro_torch.analysis`` on the card and print its
    lines; any unsuppressed finding fails the phase."""
    from repro_torch.analysis import collect, unsuppressed
    from repro_torch.core.solver import get_variant, list_variants

    findings, reports = collect("cuda")
    kernels = reports["kernels"]
    for name, rep in kernels.items():
        design = (f" [{flash_design(name.split()[1] == 'bf16')}]"
                  if name.startswith("flash_attention") else "")
        print(f"analysis: {rep.line()}{design}", flush=True)
    print(f"analysis: layout-drift: the mirror against the library at blocks 1 to "
          f"{kernels['gs_pass'].largest_block + 1} (gs_pass), 1 to "
          f"{kernels['gs_pass weighted'].largest_block + 1} (weighted), 1 to "
          f"{kernels['gs_pass_multi'].largest_block + 1} (gs_pass_multi): "
          f"{sum(f.check == 'layout-drift' for f in findings)} findings", flush=True)
    for rep in reports["trace"]:
        print(f"analysis: {rep.line()}", flush=True)
    for f in findings:
        state = f"SUPPRESSED ({f.reason})" if f.suppressed else f"FINDING: {f.message}"
        print(f"analysis: [{f.pass_name}] {f.target}: {f.check} {state}", flush=True)
    traced = {r.target for r in reports["trace"]}
    want = {n for n in list_variants() if get_variant(n).backend != "numpy"}
    want |= {"serving_torch", "serving_cuda"}
    check(traced == want, f"analysis: traced {sorted(traced)}, expected {sorted(want)}")
    for rep in reports["trace"]:
        # a suppressed host-reads finding covers the sweep-count read alone
        design = any(f.suppressed and f.check == "host-reads" for f in rep.findings)
        check(rep.reads <= rep.contract * rep.iterations + design,
              f"analysis: {rep.line()}: reads past the contract and the design read")
    check(all(rep.card for rep in kernels.values()),
          "analysis: a kernel has no report from the built library")
    hard = unsuppressed(findings)
    check(not hard, f"analysis: {len(hard)} unsuppressed finding(s): "
          + "; ".join(f"{f.target} {f.check}: {f.message}" for f in hard))


def kernel_phase(g, gw, dev):
    from repro_torch.kernels.spmv import (
        BlockedGraph, gs_pass, gs_pass_ref, spmv_csr_acc, spmv_csr_acc_ref,
    )
    from repro_torch.kernels.spmv.kernel import gs_pass_plan

    rng = np.random.default_rng(0)
    stats = {"spmv_csr_acc": {}, "gs_pass": {}, "gs_pass_multi": {}}
    for tag, graph in (("unweighted", g), ("weighted", gw)):
        bg = BlockedGraph.build(graph, block=256, device=dev)
        n_pad, m = bg.n_blocks * bg.block, graph.m
        shape = (bg.n_blocks, bg.block)
        pr, frozen, params = gs_inputs(graph, bg, rng)
        contrib = pr * bg.inv_out
        w_bytes = 0 if bg.weights is None else 4 * m
        csr_bytes = 4 * (n_pad + 1) + 4 * m + w_bytes

        def spmv():
            return spmv_csr_acc(contrib, bg.in_ptr, bg.src, bg.weights)

        def spmv_plain():
            return spmv_csr_acc_ref(contrib, bg.in_ptr, bg.src, bg.weights)

        def gs():
            return gs_pass(pr, bg.inv_out, bg.vmask, params, bg.in_ptr, bg.src,
                           bg.weights, bg.bias, frozen)

        def gs_plain():
            return gs_pass_ref(pr, bg.inv_out, bg.vmask, params, bg.in_ptr,
                               bg.src, bg.weights, bg.bias, frozen)

        out, ref = spmv(), spmv_plain()
        torch.cuda.synchronize()
        err, rel, ent = check_agreement(f"spmv_csr_acc ({tag})", out, ref)
        check(torch.equal(out, spmv()), f"spmv_csr_acc ({tag}) not deterministic")
        vals = torch.ones(m, device=dev) if bg.weights is None else bg.weights
        csr = torch.sparse_csr_tensor(bg.in_ptr, bg.src, vals, (n_pad, n_pad))
        flat = contrib.reshape(-1)
        lib_err = float((torch.mv(csr, flat).reshape(shape) - ref).abs().max())
        ms, ms_by = device_ms(spmv, 50)
        lib_ms, lib_by = device_ms(lambda: torch.mv(csr, flat), 50)
        s = stats["spmv_csr_acc"][tag] = dict(
            max_abs_err=err, rel_err=rel,
            ms=ms, plain_ms=time_ms(spmv_plain, 20), library_ms=lib_ms,
            timed_by={"ms": ms_by, "plain_ms": "events", "library_ms": lib_by},
            call_ms=time_ms(spmv, 50),
            library_call_ms=time_ms(lambda: torch.mv(csr, flat), 50))
        s["bound_ms"] = bound_ms(4 * n_pad + csr_bytes + 4 * n_pad)
        print(f"kernel spmv_csr_acc {tag}: max_abs_err={err:.3e} "
              f"rel={rel:.3e} entry_rel={ent:.3e} (bound {KERNEL_RTOL:g}) "
              f"ms={ms:.4f} (device, by {ms_by}; a call {s['call_ms']:.4f}) "
              f"plain_ms={s['plain_ms']:.4f} library_ms={lib_ms:.4f} "
              f"(device, by {lib_by}; a call {s['library_call_ms']:.4f}; torch.sparse CSR mv, "
              f"max_abs_err={lib_err:.3e}) "
              f"bound_ms={s['bound_ms']:.4f} (bytes)", flush=True)

        out, ref = gs(), gs_plain()
        torch.cuda.synchronize()
        err, rel, ent = check_agreement(f"gs_pass ({tag})", out, ref)
        check(torch.equal(out[frozen], pr[frozen]),
              f"gs_pass ({tag}) moved a frozen lane")
        check(torch.equal(out, gs()), f"gs_pass ({tag}) not deterministic")
        ms, ms_by = device_ms(gs, 20)
        k, stages = gs_pass_plan(bg.block, bg.weights is not None, dev)
        s = stats["gs_pass"][tag] = dict(
            max_abs_err=err, rel_err=rel,
            ms=ms, plain_ms=time_ms(gs_plain, 3, warmup=1), library_ms=None,
            timed_by={"ms": ms_by, "plain_ms": "events"}, k=k, D=stages)
        rank_bytes = 4 * n_pad * (4 + (bg.bias is not None)) + n_pad + 12
        s["bound_ms"] = bound_ms(rank_bytes + csr_bytes)
        print(f"kernel gs_pass {tag}: max_abs_err={err:.3e} rel={rel:.3e} "
              f"entry_rel={ent:.3e} (bound {KERNEL_RTOL:g}) k={k} D={stages} "
              f"ms={ms:.4f} (device, by {ms_by}) "
              f"plain_ms={s['plain_ms']:.4f} library_ms=null "
              f"bound_ms={s['bound_ms']:.4f} (bytes; plus "
              f"{bg.n_blocks} dependent block steps per pass)", flush=True)
        s["max_abs_err"] = max(err, whole_block_check(tag, bg, pr, params, dev))
        stats["gs_pass_multi"][tag] = multi_kernel_check(
            graph, bg, tag, gs, params, csr_bytes)
    return stats


def multi_inputs(graph, bg, b):
    """gs_pass_multi's operands at b rows: the teleport rows of
    make_query_stream(n, b, seed=0), a state of half of them plus noise,
    rows 2 and 5 frozen where there are such rows.  Returns (pr, the
    operands after pr)."""
    from repro_torch.ppr.batched import bias_scaled, blocked_rows, teleport_from_seeds
    from repro_torch.serving import make_query_stream

    dev = bg.vmask.device
    d = 0.85
    seeds = [q.seeds for q in make_query_stream(graph.n, b, seed=0)]
    t = bias_scaled(teleport_from_seeds(seeds, graph.n), graph.bias)
    tele = torch.as_tensor(blocked_rows(t.astype(np.float32), bg.n_blocks,
                                        bg.block), device=dev)
    rng = np.random.default_rng(2)
    pr = tele * 0.5 + torch.as_tensor(
        rng.random(tele.shape).astype(np.float32) / graph.n, device=dev
    ) * bg.vmask[..., None]
    dmass = torch.sum(pr * bg.dangling[..., None], dim=(0, 1))
    coef = (1.0 - d) + d * dmass
    frozen = torch.zeros(b, dtype=torch.bool, device=dev)
    frozen[[r for r in (2, 5) if r < b]] = True
    return pr, (bg.inv_out, bg.vmask, tele, coef, d, bg.in_ptr, bg.src,
                bg.weights, frozen)


def multi_kernel_check(graph, bg, tag, gs, params, csr_bytes):
    """gs_pass_multi at b = PPR_ROWS rows of make_query_stream, rows 2 and
    5 frozen, against its plain version; its b = 1 identity with gs_pass;
    its time beside PPR_ROWS launches of gs_pass; then the widest launch
    (MAX_BATCH rows) against its plain version, and the pass of
    PPR_WIDE_ROWS rows in two launches, timed."""
    from repro_torch.kernels.spmv import gs_pass, gs_pass_multi, gs_pass_multi_ref
    from repro_torch.kernels.spmv.kernel import MAX_BATCH

    dev = bg.vmask.device
    d = 0.85
    b = PPR_ROWS
    pr, args = multi_inputs(graph, bg, b)
    tele, frozen = args[2], args[8]

    def multi():
        return gs_pass_multi(pr, *args)

    def multi_plain():
        return gs_pass_multi_ref(pr, *args)

    out, ref = multi(), multi_plain()
    torch.cuda.synchronize()
    err, rel, ent = check_agreement(f"gs_pass_multi ({tag})", out, ref)
    check(torch.equal(out[..., frozen], pr[..., frozen]),
          f"gs_pass_multi ({tag}) moved a frozen row")
    check(torch.equal(out, multi()), f"gs_pass_multi ({tag}) not deterministic")
    # b = 1, a uniform base and no dangling mass: exactly gs_pass
    base = float(np.float32((1 - d) / graph.n))
    one_params = torch.tensor([base, d, 0.0], device=dev)
    x = pr[..., 0].contiguous()
    one = gs_pass(x, bg.inv_out, bg.vmask, one_params, bg.in_ptr, bg.src,
                  bg.weights)
    one_m = gs_pass_multi(x[..., None].contiguous(), bg.inv_out, bg.vmask,
                          bg.vmask[..., None].contiguous(),
                          torch.tensor([base], device=dev), d, bg.in_ptr,
                          bg.src, bg.weights)
    torch.cuda.synchronize()
    # the same sums in the same order, by design: equal bit for bit
    check(torch.equal(one_m[..., 0], one),
          f"gs_pass_multi ({tag}) at b = 1 differs from gs_pass by "
          f"{float((one_m[..., 0] - one).abs().max()):.3e}")

    def b_singles():
        for _ in range(b):
            gs()

    n_pad = bg.n_blocks * bg.block
    ms, ms_by = device_ms(multi, 10)
    s = dict(max_abs_err=err, rel_err=rel, ms=ms,
             plain_ms=time_ms(multi_plain, 3, warmup=1), library_ms=None,
             timed_by={"ms": ms_by, "plain_ms": "events"},
             singles_ms=time_ms(b_singles, 5, warmup=1), call_ms=time_ms(multi, 10))
    # pr, tele read and the new state written at b floats a vertex; inv_out
    # and vmask once; coef and the frozen mask
    s["bound_ms"] = bound_ms(3 * 4 * n_pad * b + 2 * 4 * n_pad + 5 * b + csr_bytes)
    print(f"kernel gs_pass_multi {tag} b={b}: max_abs_err={err:.3e} "
          f"rel={rel:.3e} entry_rel={ent:.3e} (bound {KERNEL_RTOL:g}) frozen "
          f"rows bit-identical; b=1 bit-identical to gs_pass; ms={ms:.4f} "
          f"(device, by {ms_by}; a call {s['call_ms']:.4f}) "
          f"plain_ms={s['plain_ms']:.4f} library_ms=null bound_ms="
          f"{s['bound_ms']:.4f} (bytes; plus {bg.n_blocks} dependent block "
          f"steps per pass); {b} launches of gs_pass: {s['singles_ms']:.4f} ms",
          flush=True)

    wide_pr, wide_args = multi_inputs(graph, bg, PPR_WIDE_ROWS)
    chunks = [(wide_pr[..., rows].contiguous(),
               tuple(a[..., rows].contiguous() if torch.is_tensor(a) and a.shape[-1:] == (PPR_WIDE_ROWS,) else a
                     for a in wide_args))
              for rows in (slice(0, MAX_BATCH), slice(MAX_BATCH, PPR_WIDE_ROWS))]
    top_pr, top_args = chunks[0]
    out, ref = gs_pass_multi(top_pr, *top_args), gs_pass_multi_ref(top_pr, *top_args)
    torch.cuda.synchronize()
    err_w, _, ent_w = check_agreement(f"gs_pass_multi ({tag}, b={MAX_BATCH})", out, ref)
    top_frozen = top_args[8]
    check(torch.equal(out[..., top_frozen], top_pr[..., top_frozen]),
          f"gs_pass_multi ({tag}, b={MAX_BATCH}) moved a frozen row")
    check(torch.equal(out, gs_pass_multi(top_pr, *top_args)),
          f"gs_pass_multi ({tag}, b={MAX_BATCH}) not deterministic")
    s["max_abs_err"] = max(err, err_w)
    s["b64_ms"], b64_by = device_ms(lambda: gs_pass_multi(top_pr, *top_args), 10)
    s["rows65_ms"], rows65_by = device_ms(
        lambda: [gs_pass_multi(p, *a) for p, a in chunks], 10)
    print(f"kernel gs_pass_multi {tag} b={MAX_BATCH}: max_abs_err={err_w:.3e} "
          f"entry_rel={ent_w:.3e} (bound {KERNEL_RTOL:g}) frozen rows "
          f"bit-identical; ms={s['b64_ms']:.4f} (device, by {b64_by}; "
          f"{s['b64_ms'] / s['ms']:.3f}x b={b}); a pass of {PPR_WIDE_ROWS} rows "
          f"in two launches ({MAX_BATCH} + {PPR_WIDE_ROWS - MAX_BATCH}): "
          f"{s['rows65_ms']:.4f} ms (device, by {rows65_by})",
          flush=True)
    return s


def solve_phase(g):
    from repro_torch.kernels.spmv import launch_counts, reset_launch_counts
    from repro_torch.launch import pagerank_run

    base = ["--dataset", "webStanford", "--scale-down", "1", "--device", "cuda",
            "--threshold", str(SOLVE_THRESHOLD)]
    expect = {"blocked": "spmv_csr_acc", "blocked_nosync": "gs_pass",
              "blocked_nosync_opt": "gs_pass", "blocked_adaptive": "gs_pass"}
    # the main paths of each kernel, --handle-dangling: the first variant
    # named is the kernel's first main path, the others later slices' own
    main_solve = {"spmv_csr_acc": ("blocked",),
                  "gs_pass": ("blocked_nosync", "blocked_adaptive")}
    launches = {}
    reports = {}
    runs = [(v, True) for v in ("blocked", "blocked_nosync", "blocked_nosync_opt",
                                "blocked_adaptive", "nosync", "nosync_adaptive",
                                "barrier", "barrier_edge", "barrier_identical")]
    runs += [("blocked", False), ("blocked_nosync", False)]
    for variant, dangling in runs:
        argv = base + ["--variant", variant] + (["--handle-dangling"] if dangling else [])
        reset_launch_counts()
        rep = pagerank_run.run(argv)
        counts = launch_counts()
        if dangling:
            for k, n in counts.items():
                if variant in main_solve.get(k, ()):
                    launches.setdefault(k, {})[variant] = n
        it = rep["iterations"]
        for k, n in counts.items():
            want = it if expect.get(variant) == k else 0
            check(n == want, f"{variant}: {k} launched {n} times, expected {want}")
        check(it > 0, f"{variant}: no iterations")
        bound = L1_BOUND.get(variant, L1_DEFAULT)
        check(rep["l1"] <= bound, f"{variant}: L1 {rep['l1']:.3e} > {bound:g}")
        print(f"solve {variant} handle_dangling={dangling}: iterations={it} "
              f"sweeps={rep['sweeps']} err={rep['err']:.3e} "
              f"wall_s={rep['wall_s']:.4f} l1={rep['l1']:.3e} (bound {bound:g}) "
              f"launches={counts}", flush=True)
        reports[(variant, dangling)] = rep
    barrier_it = reports[("barrier", True)]["iterations"]
    for variant in ("barrier_edge", "barrier_identical"):
        it = reports[(variant, True)]["iterations"]
        check(abs(it - barrier_it) <= 1,
              f"{variant}: {it} iterations, barrier {barrier_it} (expected within 1)")
    n_classes = int(g.in_neighbor_classes().max()) + 1
    print(f"solve barrier_edge / barrier_identical: "
          f"{reports[('barrier_edge', True)]['iterations']} / "
          f"{reports[('barrier_identical', True)]['iterations']} iterations, barrier "
          f"{barrier_it}; barrier_identical sums {n_classes} classes for "
          f"{g.n} vertices", flush=True)
    fig7 = (reports[("blocked_nosync", False)]["iterations"],
            reports[("blocked", False)]["iterations"])
    check(fig7[0] <= fig7[1], f"Fig 7 fails: blocked_nosync {fig7[0]} > blocked {fig7[1]}")
    print(f"fig7: blocked_nosync {fig7[0]} <= blocked {fig7[1]} iterations "
          f"(no dangling redistribution); with it: blocked_nosync "
          f"{reports[('blocked_nosync', True)]['iterations']}, blocked "
          f"{reports[('blocked', True)]['iterations']}", flush=True)
    return launches


@contextlib.contextmanager
def checked_passes(tag, calls=None):
    """Hold every gs_pass call of the blocked path (or its first ``calls``)
    against gs_pass_ref on the same operands while a solve runs: within the
    entry bound, frozen lanes bit for bit the input.  It wraps the name the
    sweep calls (``repro_torch.kernels.spmv.ops.gs_pass``), the one place
    where the masks the adaptive schedule hands the kernel can be seen;
    the real wrapper still launches and counts.  Yields the list of the
    blocks each held pass froze and the worst entry-wise error."""
    from repro_torch.kernels.spmv import gs_pass_ref, ops

    real = ops.gs_pass
    seen = {"frozen": [], "entry_rel": 0.0}

    def checked(pr, *args):
        out = real(pr, *args)
        if calls is not None and len(seen["frozen"]) >= calls:
            return out
        frozen = args[-1]  # None where no schedule freezes lanes
        name = f"gs_pass ({tag}, pass {len(seen['frozen']) + 1})"
        _, _, ent = check_agreement(name, out, gs_pass_ref(pr, *args))
        if frozen is not None:
            check(torch.equal(out[frozen], pr[frozen]), f"{name} moved a frozen lane")
        seen["frozen"].append(0 if frozen is None else int(frozen[:, 0].sum()))
        seen["entry_rel"] = max(seen["entry_rel"], ent)
        return out

    ops.gs_pass = checked
    try:
        yield seen
    finally:
        ops.gs_pass = real


@contextlib.contextmanager
def checked_spmv(tag, calls=None):
    """Hold every spmv_csr_acc call of the blocked path (or its first
    ``calls``) against spmv_csr_acc_ref on the same operands while a solve
    runs, within the entry bound (the wrapper still launches and counts).
    Yields the number of calls held and the worst entry-wise error."""
    from repro_torch.kernels.spmv import ops, spmv_csr_acc_ref

    real = ops.spmv_csr_acc
    seen = {"calls": 0, "entry_rel": 0.0}

    def checked(contrib, *args):
        out = real(contrib, *args)
        if calls is not None and seen["calls"] >= calls:
            return out
        seen["calls"] += 1
        _, _, ent = check_agreement(f"spmv_csr_acc ({tag}, call {seen['calls']})",
                                    out, spmv_csr_acc_ref(contrib, *args))
        seen["entry_rel"] = max(seen["entry_rel"], ent)
        return out

    ops.spmv_csr_acc = checked
    try:
        yield seen
    finally:
        ops.spmv_csr_acc = real


def adaptive_phase(g, dev):
    """The adaptive schedules at full size on the BFS-reordered surrogate,
    with dangling redistribution on and off: blocked_adaptive against
    blocked_nosync, and nosync_adaptive against nosync (56 threads).
    Returns the reordered graph."""
    from repro_torch.core.pagerank import l1_norm, pagerank_numpy, partition_gain_matrix
    from repro_torch.core.solver import build_variant
    from repro_torch.graphs import compute_order, permute_graph
    from repro_torch.kernels.spmv import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    gb = permute_graph(g, compute_order(g, "bfs"))
    order_s = time.perf_counter() - t0
    n_blocks = -(-gb.n // 256)
    t0 = time.perf_counter()
    gain = partition_gain_matrix(gb, 256, n_blocks)
    gain_s = time.perf_counter() - t0
    print(f"adaptive: BFS order and permuted graph in {order_s:.2f}s (host); block "
          f"gain ({n_blocks}, {n_blocks}), {int(np.count_nonzero(gain))} nonzeros, "
          f"largest row sum {gain.sum(axis=1).max():.1f}, built in {gain_s:.3f}s "
          f"(host)", flush=True)
    bundles = {}
    for variant in ("blocked_nosync", "blocked_adaptive", "nosync", "nosync_adaptive"):
        t0 = time.perf_counter()
        bundles[variant] = build_variant(variant, gb, device=dev)
        torch.cuda.synchronize()
        print(f"adaptive: {variant} bundle built in {time.perf_counter() - t0:.3f}s",
              flush=True)
    # the kernel on the reordered graph's block and edge structure, under
    # the synthetic whole-block masks of the kernel phase
    _, bgb = bundles["blocked_nosync"]
    pr, _, params = gs_inputs(gb, bgb, np.random.default_rng(0))
    whole_block_check("unweighted, BFS order", bgb, pr, params, dev)
    for dangling in (True, False):
        oracle, _ = pagerank_numpy(gb, threshold=1e-12, handle_dangling=dangling)
        kw = dict(threshold=SOLVE_THRESHOLD, handle_dangling=dangling)
        res = {}
        for variant, (v, bundle) in bundles.items():
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            r = v.run(bundle, **kw)
            pr = r.pr.cpu()
            wall = time.perf_counter() - t0
            l1 = l1_norm(pr, oracle)
            counts = launch_counts()
            want = r.iterations if variant.startswith("blocked") else 0
            check(counts["gs_pass"] == want,
                  f"adaptive {variant}: gs_pass launched {counts['gs_pass']} times "
                  f"for {r.iterations} passes, expected {want}")
            resid = jacobi_residual(gb, pr.numpy(), dangling)
            over = np.abs(resid) / residual_allowance(gb, pr.numpy(), dangling)
            check(over.max() <= 1.0,
                  f"adaptive {variant}: vertex {int(over.argmax())} keeps a "
                  f"residual {over.max():.3f}x what the stop rule certifies")
            bound = (adaptive_l1_bound(gb.n) if dangling and "adaptive" in variant
                     else L1_DEFAULT)
            check(l1 <= bound, f"adaptive {variant}: L1 {l1:.3e} > {bound:g}")
            res[variant] = r
            extra = ""
            if variant == "blocked_nosync":
                extra = f"block_sweeps={r.iterations * n_blocks} "
            elif variant == "blocked_adaptive":
                tag = f"BFS order, handle_dangling={dangling}"
                with checked_passes(tag) as seen:
                    again = v.run(bundle, **kw)
                frozen = np.array(seen["frozen"])
                share = frozen / n_blocks
                check(again.iterations == r.iterations and again.sweeps == r.sweeps
                      and torch.equal(again.pr.cpu(), pr),
                      "adaptive blocked_adaptive: the checked run differs")
                check(len(frozen) == r.iterations
                      and r.sweeps == r.iterations * n_blocks - int(frozen.sum()),
                      "adaptive blocked_adaptive: frozen blocks disagree with sweeps")
                print(f"kernel gs_pass unweighted ({tag}): each of the "
                      f"{len(frozen)} passes of blocked_adaptive, under the masks "
                      f"its schedule gave, against gs_pass_ref: entry_rel<="
                      f"{seen['entry_rel']:.3e} (bound {KERNEL_RTOL:g}); frozen "
                      f"lanes bit-identical", flush=True)
                extra = (f"block_sweeps={r.sweeps} ({r.sweeps / (r.iterations * n_blocks):.3f} "
                         f"of passes x {n_blocks}) frozen share per pass first/median/"
                         f"last={share[0]:.3f}/{np.median(share):.3f}/{share[-1]:.3f} ")
            print(f"adaptive {variant} handle_dangling={dangling}: "
                  f"iterations={r.iterations} sweeps={r.sweeps} {extra}"
                  f"l1={l1:.3e} (bound {bound:.3g}; the residual left: max "
                  f"{np.abs(resid).max():.3e}, at most {over.max():.3f} of what the "
                  f"stop rule certifies; sum {resid.sum():.3e}, L1/(1-d) "
                  f"{np.abs(resid).sum() / (1 - 0.85):.3e}) wall_s={wall:.4f} "
                  f"launches={counts}", flush=True)
        for plain, adaptive in (("blocked_nosync", "blocked_adaptive"),
                                ("nosync", "nosync_adaptive")):
            a, b = res[plain], res[adaptive]
            units = n_blocks if plain == "blocked_nosync" else 1
            print(f"adaptive handle_dangling={dangling}: {adaptive} / {plain}: "
                  f"iterations {b.iterations} / {a.iterations}, sweeps "
                  f"{b.sweeps} / {a.sweeps * units} "
                  f"({b.sweeps / (a.sweeps * units):.3f})", flush=True)
    return gb


def repeat_phase(g, gb, dev):
    """Same-input solves must repeat exactly (fixed-order sums on every
    path; the adaptive schedules on the BFS-reordered ``gb``, where they
    skip), and the residual curve past the threshold shows the float32
    floor that the 1e-8 stop rule sits above."""
    from repro_torch.core.solver import build_variant

    for variant, graph in (("barrier", g), ("nosync", g), ("blocked", g),
                           ("blocked_adaptive", gb), ("nosync_adaptive", gb)):
        v, bundle = build_variant(variant, graph, device=dev)
        a, b = (v.run(bundle, threshold=SOLVE_THRESHOLD, handle_dangling=True)
                for _ in range(2))
        check(a.iterations == b.iterations and a.sweeps == b.sweeps
              and torch.equal(a.pr, b.pr),
              f"{variant}: two solves of one input differ "
              f"({a.iterations} vs {b.iterations} iterations, {a.sweeps} vs "
              f"{b.sweeps} sweeps)")
        print(f"repeat {variant}{' (BFS order)' if graph is gb else ''}: two "
              f"solves give {a.iterations} iterations, {a.sweeps} sweeps and "
              f"identical ranks", flush=True)
    for variant in ("barrier", "blocked", "blocked_nosync"):
        v, bundle = build_variant(variant, g, device=dev)
        r = v.run(bundle, threshold=0.0, max_iter=FLOOR_ITERS,
                  handle_dangling=True)
        res = r.residuals[:r.iterations].double().numpy()
        first = {t: int(np.argmax(res <= t)) + 1 if np.any(res <= t) else None
                 for t in (1e-7, SOLVE_THRESHOLD, 1e-9)}
        # the residuals after the 1e-8 stop would have ended the solve
        after = res[first[SOLVE_THRESHOLD] or r.iterations:]
        after = after if after.size else res[-1:]
        print(f"floor {variant}: threshold 0, {r.iterations} iterations; first "
              f"at or below 1e-7/1e-8/1e-9: {first[1e-7]}/"
              f"{first[SOLVE_THRESHOLD]}/{first[1e-9]}; after the 1e-8 stop: "
              f"median {np.median(after):.3e} max {after.max():.3e}; min "
              f"{res.min():.3e}; max rank {float(r.pr.max()):.3e}", flush=True)


def traced(fn):
    """Run ``fn`` once under the profiler; returns its result, the traced
    wall in ms, the device-busy ms and the device rows by self time (None
    when the trace holds no device time: not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not rows:
        return out, wall_ms, None, None
    rows.sort(key=lambda e: -e.self_device_time_total)
    return out, wall_ms, sum(e.self_device_time_total for e in rows) / 1e3, rows


def print_trace(tag, wall_ms, busy_ms, rows, extra="", top=6):
    if rows is None:
        print(f"profile {tag}: no device time in the trace (not measured)")
        return
    print(f"profile {tag}: {extra}traced_wall_ms={wall_ms:.3f} device_busy_ms="
          f"{busy_ms:.3f} busy_share={busy_ms / wall_ms:.3f}")
    for e in rows[:top]:
        print(f"profile {tag}:   {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<5d} {e.key[:70]}")


def profile_phase(g, gb, dev):
    """One traced solve per kernel variant (blocked_adaptive on the
    launcher's graph and on the BFS-reordered ``gb``): device time by
    kernel and the device's busy share of the traced wall (the trace adds
    host overhead, so the untraced wall of the solve phase is the
    end-to-end number)."""
    from repro_torch.core.solver import build_variant
    from repro_torch.serving import make_query_stream

    seeds = [q.seeds for q in make_query_stream(g.n, PPR_ROWS, seed=0)]
    for variant, graph, opts in (("blocked", g, {}), ("blocked_nosync", g, {}),
                                 ("blocked_adaptive", g, {}),
                                 ("blocked_adaptive", gb, {}),
                                 ("ppr_blocked", g, {"seeds": seeds})):
        v, bundle = build_variant(variant, graph, device=dev)
        kw = dict(threshold=SOLVE_THRESHOLD, handle_dangling=True, **opts)
        v.run(bundle, **kw)  # warm-up
        r, wall_ms, busy_ms, rows = traced(lambda: v.run(bundle, **kw))
        tag = variant + (" (BFS order)" if graph is gb else "")
        print_trace(tag, wall_ms, busy_ms, rows,
                    extra=f"iterations={r.iterations} sweeps={r.sweeps} ")


ORACLE_THRESHOLD = 1e-12  # the PPR oracle's last step, max norm


def ppr_oracle(g, seed_sets, d=0.85, threshold=ORACLE_THRESHOLD, max_iter=2000,
               dangling=True):
    """Float64 PPR with dangling mass re-teleported onto each row (or, with
    ``dangling=False``, dropped: the leaky convention): a scipy
    sparse power iteration over all rows at once, independent of the port.
    Returns ``{seed key: (n,) row}``, keyed by the sorted seed set.  The
    iteration is a d-contraction in L1, so a row whose last step moved
    no entry by more than ``threshold`` is within d / (1 - d) · n ·
    threshold of the exact PPR in L1 (:func:`oracle_l1_err`)."""
    import scipy.sparse as sp

    from repro_torch.ppr.batched import teleport_from_seeds

    keys = sorted({tuple(sorted(set(s))) for s in seed_sets})
    t = teleport_from_seeds(keys, g.n).T.copy()  # (n, rows)
    inv = np.where(g.out_degree > 0, 1.0 / np.maximum(g.out_degree, 1), 0.0)
    vals = inv[g.src] if g.weights is None else inv[g.src] * g.weights
    a = sp.csr_matrix((vals, (g.dst, g.src)), shape=(g.n, g.n))
    dang = (g.out_degree == 0).astype(np.float64) * dangling
    pr = t.copy()
    for it in range(1, max_iter + 1):
        new = (1.0 - d) * t + d * (a @ pr) + d * (dang @ pr)[None, :] * t
        err = np.abs(new - pr).max()
        pr = new
        if err <= threshold:
            break
    check(err <= threshold, f"oracle: {err:.1e} after {max_iter} iterations")
    print(f"oracle: {len(keys)} seed sets, float64, {it} iterations to "
          f"{err:.1e}", flush=True)
    return {k: pr[:, i] for i, k in enumerate(keys)}


def oracle_l1_err(n: int, d: float = 0.85) -> float:
    return d / (1 - d) * n * ORACLE_THRESHOLD


def _key(seeds) -> tuple:
    return tuple(sorted(set(int(s) for s in seeds)))


def ppr_phase(g, dev, oracle):
    """The batched solves at full size, each row against the oracle; the
    ppr_blocked solve is the main path of gs_pass_multi."""
    from repro_torch.core.pagerank import l1_norm
    from repro_torch.core.solver import build_variant
    from repro_torch.kernels.spmv import launch_counts, reset_launch_counts
    from repro_torch.kernels.spmv.kernel import gs_pass_multi_max_batch
    from repro_torch.serving import make_query_stream

    seeds = [q.seeds for q in make_query_stream(g.n, PPR_ROWS, seed=0)]
    kw = dict(threshold=SOLVE_THRESHOLD, handle_dangling=True, seeds=seeds)
    launches = {}
    results = {}
    for variant in ("ppr_blocked", "ppr_barrier", "ppr_nosync"):
        v, bundle = build_variant(variant, g, device=dev)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        r = v.run(bundle, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        want = r.iterations if variant == "ppr_blocked" else 0
        check(counts["gs_pass_multi"] == want,
              f"{variant}: gs_pass_multi launched {counts['gs_pass_multi']} "
              f"times, expected {want}")
        if variant == "ppr_blocked":
            launches[variant] = counts["gs_pass_multi"]
        check(tuple(r.pr.shape) == (PPR_ROWS, g.n) and bool(torch.isfinite(r.pr).all()),
              f"{variant}: ranks of shape {tuple(r.pr.shape)} or not finite")
        l1 = [l1_norm(r.pr[i], oracle[_key(s)]) for i, s in enumerate(seeds)]
        check(max(l1) <= L1_DEFAULT,
              f"{variant}: row L1 {max(l1):.3e} to the oracle > {L1_DEFAULT:g}")
        print(f"ppr {variant} b={PPR_ROWS}: iterations={r.iterations} "
              f"sweeps={r.sweeps} wall_s={wall:.4f} max_row_l1={max(l1):.3e} "
              f"(bound {L1_DEFAULT:g}) launches={counts}", flush=True)
        results[variant] = (v, bundle, r)
    v, bundle, first = results["ppr_blocked"]
    again = v.run(bundle, **kw)
    check(again.iterations == first.iterations and torch.equal(again.pr, first.pr),
          f"ppr_blocked: two solves differ ({first.iterations} vs "
          f"{again.iterations} iterations)")
    print(f"repeat ppr_blocked: two solves give {first.iterations} iterations "
          f"and identical ranks", flush=True)
    uniform = v.run(bundle, threshold=SOLVE_THRESHOLD, handle_dangling=True,
                    seeds=None)
    vg, bg = build_variant("blocked", g, device=dev)
    glob = vg.run(bg, threshold=SOLVE_THRESHOLD, handle_dangling=True)
    lin = l1_norm(uniform.pr[0], glob.pr)
    check(lin <= L1_DEFAULT, f"teleport linearity: L1 {lin:.3e} > {L1_DEFAULT:g}")
    print(f"linearity: uniform ppr_blocked row ({uniform.iterations} passes) vs "
          f"global blocked ({glob.iterations} iterations): L1={lin:.3e} "
          f"(bound {L1_DEFAULT:g}); to the oracle {l1_norm(uniform.pr[0], oracle[()]):.3e}",
          flush=True)

    wide = [q.seeds for q in make_query_stream(g.n, PPR_WIDE_ROWS, seed=0)]
    per_launch = gs_pass_multi_max_batch(bundle.block, dev)
    chunks = -(-PPR_WIDE_ROWS // per_launch)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    r = v.run(bundle, threshold=SOLVE_THRESHOLD, handle_dangling=True, seeds=wide)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_launch = launch_counts()["gs_pass_multi"]
    check(chunks >= 2 and n_launch == chunks * r.iterations,
          f"ppr_blocked b={PPR_WIDE_ROWS}: {n_launch} launches of gs_pass_multi for "
          f"{r.iterations} passes, expected {chunks} a pass")
    check(tuple(r.pr.shape) == (PPR_WIDE_ROWS, g.n) and bool(torch.isfinite(r.pr).all()),
          f"ppr_blocked b={PPR_WIDE_ROWS}: ranks of shape {tuple(r.pr.shape)} or not finite")
    l1 = [l1_norm(r.pr[i], oracle[_key(s)]) for i, s in enumerate(wide)]
    check(max(l1) <= L1_DEFAULT,
          f"ppr_blocked b={PPR_WIDE_ROWS}: row L1 {max(l1):.3e} to the oracle > {L1_DEFAULT:g}")
    print(f"ppr ppr_blocked b={PPR_WIDE_ROWS}: {chunks} launches a pass (at most "
          f"{per_launch} rows each), iterations={r.iterations} wall_s={wall:.4f} "
          f"max_row_l1={max(l1):.3e} (bound {L1_DEFAULT:g}) gs_pass_multi "
          f"launches={n_launch}", flush=True)
    return launches


def _same_topk(idx, want, ref) -> bool:
    """``idx`` is ``want`` up to swaps of vertices whose oracle values tie
    within TIE."""
    return idx.shape == want.shape and bool(
        np.all((idx == want) | (np.abs(ref[idx] - ref[want]) <= TIE)))


def engine_phase(g, dev, oracle):
    """PPREngine on both backends over one query stream."""
    from repro_torch.kernels.spmv import launch_counts, reset_launch_counts
    from repro_torch.ppr import topk
    from repro_torch.serving import PPREngine, make_query_stream

    queries = make_query_stream(g.n, ENGINE_QUERIES, seed=0)
    answers = {}
    for backend in ("cuda", "torch"):
        eng = PPREngine(g, slots=PPR_ROWS, threshold=ENGINE_THRESHOLD,
                        handle_dangling=True, backend=backend, device=dev)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = eng.drain(queries)
        wall = time.perf_counter() - t0
        counts = launch_counts()
        check(sorted(r.qid for r in out) == list(range(ENGINE_QUERIES)),
              f"engine {backend}: {len(out)} responses for {ENGINE_QUERIES} queries")
        worst = 0.0
        for r in out:
            ref = oracle[_key(r.seeds)]
            want, _ = topk(ref, r.indices.size)
            check(_same_topk(r.indices, want, ref),
                  f"engine {backend}: qid {r.qid} top-k {r.indices.tolist()} "
                  f"is not the oracle's {want.tolist()}")
            worst = max(worst, float(np.abs(r.values - ref[r.indices]).max()))
        check(worst <= TOPK_VALUE_TOL,
              f"engine {backend}: top-k values off the oracle by {worst:.3e}")
        lat = np.array([r.latency_s for r in out]) * 1e3
        print(f"engine {backend}: {ENGINE_QUERIES} queries, {PPR_ROWS} slots, "
              f"threshold {ENGINE_THRESHOLD:g}: wall_s={wall:.4f} "
              f"qps={ENGINE_QUERIES / wall:.2f} p50_ms={np.percentile(lat, 50):.3f} "
              f"p99_ms={np.percentile(lat, 99):.3f} warm_hits={eng.warm_hits} "
              f"occupancy={eng.slot_occupancy:.3f} top-k = oracle's "
              f"(values within {worst:.2e}) launches={counts}", flush=True)
        answers[backend] = {r.qid: r for r in out}
    check(counts["gs_pass_multi"] == 0, "the torch backend launched gs_pass_multi")
    for qid, r in answers["cuda"].items():
        other = answers["torch"][qid].indices
        check(_same_topk(other, r.indices, oracle[_key(r.seeds)]),
              f"engine: qid {qid} top-k differs between the backends")
    print("engine: the torch backend gives the same top-k for every query",
          flush=True)
    return answers["cuda"]


def global_oracle(g, pr0=None, d=0.85, max_iter=5000, dangling=False):
    """Float64 PageRank of ``g`` by a scipy sparse power iteration
    (independent of the port), leaky or, with ``dangling``, with the
    dangling mass spread uniformly, from ``pr0`` (the previous graph's
    oracle saves iterations; the fixed point does not depend on the start),
    until a step moves at most GLOBAL_ORACLE_STEP in L1.  Returns the
    vector and its L1 error bound, d / (1 - d) times the last step (the
    step is a d-contraction in L1 either way)."""
    import scipy.sparse as sp

    inv = np.where(g.out_degree > 0, 1.0 / np.maximum(g.out_degree, 1), 0.0)
    # the dst-sorted edge list is the in-CSR already: rows dst, columns src
    # (a parallel edge is two entries, which the product adds)
    a = sp.csr_matrix((inv[g.src], np.asarray(g.src), np.asarray(g.in_ptr)),
                      shape=(g.n, g.n))
    base = (1.0 - d) / g.n
    sink = g.out_degree == 0
    pr = np.full(g.n, 1.0 / g.n) if pr0 is None else np.array(pr0, np.float64)
    for it in range(1, max_iter + 1):
        new = base + d * (a @ pr)
        if dangling:
            new += d * pr[sink].sum() / g.n
        step = np.abs(new - pr).sum()
        pr = new
        if step <= GLOBAL_ORACLE_STEP:
            break
    check(step <= GLOBAL_ORACLE_STEP,
          f"global oracle: L1 step {step:.1e} after {max_iter} iterations")
    return pr, d / (1 - d) * step, it


@contextlib.contextmanager
def checked_rows(rounds_of_sweeps: int):
    """Hold the first ``rounds_of_sweeps`` spmv_csr_rows calls of the
    distributed solvers (every shard's sweeps of their first rounds)
    against spmv_csr_rows_ref on the same operands, within the entry bound;
    later calls pass through (the wrapper launches and counts each).
    Yields the number of calls held and the worst entry-wise error."""
    from repro_torch.core import distributed
    from repro_torch.kernels.spmv import spmv_csr_rows_ref

    real = distributed.spmv_csr_rows
    seen = {"calls": 0, "entry_rel": 0.0}

    def checked(contrib, *args):
        out = real(contrib, *args)
        if seen["calls"] < rounds_of_sweeps:
            seen["calls"] += 1
            _, _, ent = check_agreement(f"spmv_csr_rows (call {seen['calls']})",
                                        out, spmv_csr_rows_ref(contrib, *args))
            seen["entry_rel"] = max(seen["entry_rel"], ent)
        return out

    distributed.spmv_csr_rows = checked
    try:
        yield seen
    finally:
        distributed.spmv_csr_rows = real


@contextlib.contextmanager
def checked_multi(tag: str, calls: int):
    """Hold the first ``calls`` gs_pass_multi calls of the batched blocked
    sweep (``repro_torch.ppr.batched.gs_pass_multi``, the name the PPR
    engine's cuda backend calls) against gs_pass_multi_ref on the same
    operands: within the entry bound, frozen rows bit for bit the input.
    Later calls pass through; the wrapper launches and counts each.
    Yields the number of calls held, the row counts b they had and the
    worst entry-wise error."""
    from repro_torch.kernels.spmv import gs_pass_multi_ref
    from repro_torch.ppr import batched

    real = batched.gs_pass_multi
    seen = {"calls": 0, "rows": set(), "entry_rel": 0.0}

    def checked(pr, *args):
        out = real(pr, *args)
        if seen["calls"] < calls:
            seen["calls"] += 1
            name = f"gs_pass_multi ({tag}, call {seen['calls']})"
            _, _, ent = check_agreement(name, out, gs_pass_multi_ref(pr, *args))
            frozen = args[-1]
            check(torch.equal(out[..., frozen], pr[..., frozen]),
                  f"{name} moved a frozen row")
            seen["rows"].add(pr.shape[-1])
            seen["entry_rel"] = max(seen["entry_rel"], ent)
        return out

    batched.gs_pass_multi = checked
    try:
        yield seen
    finally:
        batched.gs_pass_multi = real


def distributed_phase(g, dev, oracle, queries, unsharded):
    """The distributed solvers at p = DIST_P on one card
    (``ShardMesh((cuda,) * 4)``: four partitions, the exchange within the
    card's memory), dangling redistribution on and off: barrier, stale
    (DIST_SWEEPS sweeps a round) and topk (DIST_TOPK_SWEEPS,
    DIST_SEND_FRACTION).  A first solve holds every shard's sweeps of its
    first DIST_CHECKED_ROUNDS rounds against spmv_csr_rows_ref; a second,
    unchecked, is timed and counted and must repeat the first.  Each is
    held to the float64 oracle (L1 ≤ L1_DEFAULT); stale needs no more
    rounds than barrier without dangling redistribution (the paper's
    setting).  Then the registry's three entries at threads=56 (p =
    min(56, cards)), the partition SpMV timed beside its plain version,
    torch.sparse and its bound, and the engine's cuda backend with its 8
    slots split over 4 shards: every shard's gs_pass_multi passes of a
    first step (its first PPR_ROWS queries) held against gs_pass_multi_ref
    at the shard's 2 rows, then, the engine reset, the engine phase's
    queries, every top-k the oracle's and the unsharded engine's (bit for
    bit or within ties).
    Returns the partition kernel's numbers and the launches by path."""
    from repro_torch.core import (
        PartitionedGraph, ShardMesh, distributed_pagerank, distributed_pagerank_topk,
    )
    from repro_torch.core.distributed import MeshOperands
    from repro_torch.core.pagerank import l1_norm
    from repro_torch.core.solver import build_variant
    from repro_torch.kernels.spmv import (
        launch_counts, reset_launch_counts, spmv_csr_rows, spmv_csr_rows_ref,
    )
    from repro_torch.ppr import topk
    from repro_torch.serving import PPREngine

    launches = {"spmv_csr_acc": {}, "gs_pass_multi": {}}
    mesh = ShardMesh((dev,) * DIST_P)
    pg = PartitionedGraph.from_graph(g, p=DIST_P, device=dev)
    ops = MeshOperands.build(pg, mesh)
    print(f"distributed: p={DIST_P} shards on {mesh.distinct}, vp={pg.vp}, "
          f"edges a shard {[s.src.numel() for s in ops.shards]}", flush=True)
    modes = (("barrier", distributed_pagerank, dict(mode="barrier"), 1),
             ("stale", distributed_pagerank,
              dict(mode="stale", local_sweeps=DIST_SWEEPS), DIST_SWEEPS),
             ("topk", distributed_pagerank_topk,
              dict(local_sweeps=DIST_TOPK_SWEEPS, send_fraction=DIST_SEND_FRACTION),
              DIST_TOPK_SWEEPS))
    rounds = {}
    oracles = {dangling: global_oracle(g, dangling=dangling) for dangling in (True, False)}
    for dangling in (True, False):
        ref, ref_err, _ = oracles[dangling]
        for name, fn, kw, k in modes:
            kw = dict(kw, threshold=SOLVE_THRESHOLD, handle_dangling=dangling,
                      operands=ops)
            with checked_rows(DIST_CHECKED_ROUNDS * DIST_P * k) as seen:
                first = fn(pg, mesh, **kw)
            check(seen["calls"] == min(first.sweeps, DIST_CHECKED_ROUNDS * DIST_P * k),
                  f"distributed {name}: {seen['calls']} sweeps held")
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            r = fn(pg, mesh, **kw)
            wall = time.perf_counter() - t0
            counts = launch_counts()
            check(r.iterations == first.iterations and torch.equal(r.pr, first.pr),
                  f"distributed {name}: two solves differ ({first.iterations} vs "
                  f"{r.iterations} rounds)")
            check(counts["spmv_csr_acc"] == r.sweeps == r.iterations * DIST_P * k,
                  f"distributed {name}: {counts['spmv_csr_acc']} launches for "
                  f"{r.sweeps} sweeps")
            check(tuple(r.pr.shape) == (g.n,) and bool(torch.isfinite(r.pr).all()),
                  f"distributed {name}: ranks of shape {tuple(r.pr.shape)} or not finite")
            l1 = l1_norm(r.pr, ref)
            check(l1 <= L1_DEFAULT, f"distributed {name} dangling={dangling}: "
                  f"L1 {l1:.3e} > {L1_DEFAULT:g}")
            rounds[(name, dangling)] = r.iterations
            if dangling:
                launches["spmv_csr_acc"][f"distributed_{name} (p={DIST_P})"] = \
                    counts["spmv_csr_acc"]
            print(f"distributed {name} handle_dangling={dangling}: p={DIST_P} "
                  f"rounds={r.iterations} sweeps={r.sweeps} err={r.err:.3e} "
                  f"wall_s={wall:.4f} ms_per_round={wall / r.iterations * 1e3:.3f} "
                  f"l1={l1:.3e} (bound {L1_DEFAULT:g}, oracle error <= {ref_err:.1e}) "
                  f"launches={counts}; first {seen['calls']} sweeps within the "
                  f"entry bound of spmv_csr_rows_ref (worst "
                  f"{seen['entry_rel']:.3e})", flush=True)
    check(rounds[("stale", False)] <= rounds[("barrier", False)],
          f"distributed: stale {rounds[('stale', False)]} rounds > barrier "
          f"{rounds[('barrier', False)]} without dangling redistribution")
    print(f"distributed rounds, barrier / stale / topk: with dangling "
          f"{rounds[('barrier', True)]} / {rounds[('stale', True)]} / "
          f"{rounds[('topk', True)]}, without {rounds[('barrier', False)]} / "
          f"{rounds[('stale', False)]} / {rounds[('topk', False)]}", flush=True)

    ref = oracles[True][0]
    for variant in ("distributed_barrier", "distributed_stale", "distributed_topk"):
        v, bundle = build_variant(variant, g, threads=56, device=dev)
        reset_launch_counts()
        t0 = time.perf_counter()
        r = v.run(bundle, threshold=SOLVE_THRESHOLD, handle_dangling=True)
        wall = time.perf_counter() - t0
        counts = launch_counts()
        l1 = l1_norm(r.pr, ref)
        check(bundle.p == min(56, torch.cuda.device_count()) and l1 <= L1_DEFAULT
              and counts["spmv_csr_acc"] == r.sweeps,
              f"{variant} threads=56: p={bundle.p}, L1 {l1:.3e}, "
              f"{counts['spmv_csr_acc']} launches for {r.sweeps} sweeps")
        print(f"distributed registry {variant} threads=56: p={bundle.p} "
              f"rounds={r.iterations} sweeps={r.sweeps} wall_s={wall:.4f} "
              f"l1={l1:.3e} launches={counts}", flush=True)

    # the partition SpMV at the shapes the p = 4 solves give it
    gen = torch.Generator(device=dev).manual_seed(0)
    contrib = torch.rand(pg.n_pad, generator=gen, device=dev) * pg.inv_out
    part = {"max_abs_err": 0.0}
    for i, sh in enumerate(ops.shards):
        out = spmv_csr_rows(contrib, sh.in_ptr, sh.src, sh.weights)
        plain = spmv_csr_rows_ref(contrib, sh.in_ptr, sh.src, sh.weights)
        torch.cuda.synchronize()
        err, _, _ = check_agreement(f"spmv_csr_rows (partition {i})", out, plain)
        part["max_abs_err"] = max(part["max_abs_err"], err)
    sh = ops.shards[0]
    m0, gathered = sh.src.numel(), int(torch.unique(sh.src).numel())
    csr = torch.sparse_csr_tensor(sh.in_ptr, sh.src, torch.ones(m0, device=dev),
                                  (pg.vp, pg.n_pad))
    part["ms"], part["ms_by"] = device_ms(
        lambda: spmv_csr_rows(contrib, sh.in_ptr, sh.src), 50)
    part["plain_ms"] = time_ms(lambda: spmv_csr_rows_ref(contrib, sh.in_ptr, sh.src), 20)
    part["library_ms"], part["library_by"] = device_ms(lambda: torch.mv(csr, contrib), 50)
    part["bound_ms"] = bound_ms(4 * gathered + 4 * (pg.vp + 1) + 4 * m0 + 4 * pg.vp)
    print(f"kernel spmv_csr_rows partition 0 of {DIST_P} (rows {pg.vp}, edges "
          f"{m0}, {gathered} sources): ms={part['ms']:.4f} (device, by "
          f"{part['ms_by']}) plain_ms={part['plain_ms']:.4f} library_ms="
          f"{part['library_ms']:.4f} (device, by {part['library_by']}; torch.sparse "
          f"CSR mv) bound_ms={part['bound_ms']:.4f} (bytes); every partition "
          f"within the entry bound (max_abs_err {part['max_abs_err']:.3e})", flush=True)

    eng = PPREngine(g, slots=PPR_ROWS, threshold=ENGINE_THRESHOLD, handle_dangling=True,
                    backend="cuda", mesh=mesh)
    rows = PPR_ROWS // DIST_P
    held = eng.iters_per_step * DIST_P  # a step: every shard's passes
    with checked_multi(f"engine, {DIST_P} shards", held) as seen:
        eng.drain(queries[:PPR_ROWS])
    check(seen["calls"] == held and seen["rows"] == {rows},
          f"sharded engine: {seen['calls']} gs_pass_multi calls held at rows "
          f"{sorted(seen['rows'])}, want {held} at {rows}")
    print(f"engine cuda, {DIST_P} shards: the first {seen['calls']} gs_pass_multi "
          f"passes (b={rows}) within the entry bound of gs_pass_multi_ref (worst "
          f"{seen['entry_rel']:.3e}), frozen rows bit-identical", flush=True)
    eng.reset()  # a cold cache: the measured drain starts as the unsharded one
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.drain(queries)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    check(sorted(r.qid for r in out) == list(range(len(queries))),
          f"sharded engine: {len(out)} responses for {len(queries)} queries")
    check(counts["gs_pass_multi"] > 0, "sharded engine: no gs_pass_multi launch")
    launches["gs_pass_multi"][f"engine, {DIST_P} shards"] = counts["gs_pass_multi"]
    exact, worst = 0, 0.0
    for r in out:
        ref_row = oracle[_key(r.seeds)]
        want, _ = topk(ref_row, r.indices.size)
        check(_same_topk(r.indices, want, ref_row),
              f"sharded engine: qid {r.qid} top-k {r.indices.tolist()} is not "
              f"the oracle's {want.tolist()}")
        worst = max(worst, float(np.abs(r.values - ref_row[r.indices]).max()))
        other = unsharded[r.qid]
        check(_same_topk(r.indices, other.indices, ref_row),
              f"sharded engine: qid {r.qid} top-k differs from the unsharded engine's")
        exact += bool(np.array_equal(r.indices, other.indices)
                      and np.array_equal(r.values, other.values))
    check(worst <= TOPK_VALUE_TOL, f"sharded engine: values off the oracle by {worst:.3e}")
    lat = np.array([r.latency_s for r in out]) * 1e3
    print(f"engine cuda, {PPR_ROWS} slots over {DIST_P} shards ({PPR_ROWS // DIST_P} "
          f"rows a gs_pass_multi launch): wall_s={wall:.4f} "
          f"qps={len(queries) / wall:.2f} p50_ms={np.percentile(lat, 50):.3f} "
          f"p99_ms={np.percentile(lat, 99):.3f} top-k = oracle's (values within "
          f"{worst:.2e}); bit for bit the unsharded engine's for {exact} of "
          f"{len(out)} queries, the rest within oracle ties; launches={counts}",
          flush=True)
    return part, launches


def dynamic_phase(g, dev):
    """IncrementalPageRank at full size on the card, leaky convention:
    blocked_nosync (gs_pass) for the initial solve, 4 sink-bounded and 2
    uniform batches of DYN_OPS ops and one forced fallback (push budget 0)
    with every gs_pass held against gs_pass_ref on the updated operands,
    and one more, traced; then blocked (spmv_csr_acc) for one more forced
    fallback, each call
    held against spmv_csr_acc_ref.  Every batch's ranks are held to a
    float64 oracle of the updated graph: L1 < DYN_L1 and within the
    batch's certificate plus the oracle's own error.  Returns the launches
    by path."""
    from repro_torch.core.dynamic import IncrementalPageRank, random_update_batch
    from repro_torch.kernels.spmv import launch_counts, reset_launch_counts

    launches = {"gs_pass": {}, "spmv_csr_acc": {}}
    oracle = {"pr": None}

    def held(tag, ipr, rep, wall, counts, extra=""):
        t0 = time.perf_counter()
        pr, err, it = global_oracle(ipr.g, oracle["pr"])
        oracle["pr"] = pr
        o_s = time.perf_counter() - t0
        l1 = float(np.abs(ipr.pagerank - pr).sum())
        cert = ipr.certificate
        check(cert <= DYN_TOL, f"dynamic {tag}: certificate {cert:.3e} not met ({rep})")
        check(l1 < DYN_L1, f"dynamic {tag}: L1 {l1:.3e} to the oracle >= {DYN_L1:g}")
        check(l1 <= cert + err,
              f"dynamic {tag}: L1 {l1:.3e} > certificate {cert:.3e} + oracle "
              f"error {err:.1e}")
        print(f"dynamic {tag}: mode={rep.mode} ops={rep.num_ops} "
              f"rounds={rep.rounds} pushes={rep.pushes} "
              f"touched_frac={rep.touched_frac:.4f} l1_cert={rep.l1_cert:.3e} "
              f"{extra}l1_to_oracle={l1:.3e} (oracle error <= {err:.1e}, "
              f"{it} iterations, {o_s:.2f}s) wall_s={wall:.4f} launches={counts}",
              flush=True)

    def start(variant):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        ipr = IncrementalPageRank(g, variant=variant, tol=DYN_TOL, device=dev)
        wall = time.perf_counter() - t0
        counts = launch_counts()
        kernel = "gs_pass" if variant == "blocked_nosync" else "spmv_csr_acc"
        check(counts[kernel] > 0, f"dynamic {variant}: the initial solve "
              f"launched no {kernel}")
        launches[kernel][f"dynamic initial solve ({variant})"] = counts[kernel]
        r = ipr.init_report
        print(f"dynamic {variant} initial: n={g.n} m={g.m} tol={DYN_TOL:g} "
              f"iterations={r['iterations']} solve_s={r['solve_s']:.4f} "
              f"float64 refine: rounds={r['refine_rounds']} "
              f"pushes={r['refine_pushes']} refine_s={r['refine_s']:.3f} "
              f"certificate={ipr.certificate:.3e} wall_s={wall:.3f} "
              f"launches={counts}", flush=True)
        return ipr, kernel

    def forced_fallback(ipr, kernel, rng, checker):
        ipr.max_push_rounds = 0  # starves the push: the warm global solve runs
        adds, dels = random_update_batch(ipr.g, rng, DYN_OPS)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        with checker(f"dynamic fallback, {ipr.variant}") as seen:
            rep = ipr.apply(adds=adds, dels=dels)
        wall = time.perf_counter() - t0
        counts = launch_counts()
        check(rep.mode == "fallback" and counts[kernel] > 0,
              f"dynamic fallback {ipr.variant}: mode {rep.mode}, {kernel} "
              f"launched {counts[kernel]} times")
        launches[kernel][f"dynamic forced fallback ({ipr.variant})"] = counts[kernel]
        # the starved budget also skipped the fallback's refinement: run it
        ipr.max_push_rounds = 10_000
        t1 = time.perf_counter()
        r2, p2 = ipr._refine()
        refine_s = time.perf_counter() - t1
        calls = seen["calls"] if "calls" in seen else len(seen["frozen"])
        check(calls > 0, f"dynamic fallback {ipr.variant}: no {kernel} call held")
        held(f"fallback ({ipr.variant})", ipr, rep, wall, counts,
             extra=f"then refine rounds={r2} pushes={p2} refine_s={refine_s:.3f} "
                   f"certificate={ipr.certificate:.3e}; {calls} {kernel} calls "
                   f"within the entry bound of the plain version (worst "
                   f"{seen['entry_rel']:.3e}); ")

    rng = np.random.default_rng(0)
    ipr, kernel = start("blocked_nosync")
    for i, localized in enumerate([True] * 4 + [False] * 2):
        adds, dels = random_update_batch(ipr.g, rng, DYN_OPS, localized=localized)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        rep = ipr.apply(adds=adds, dels=dels)
        wall = time.perf_counter() - t0
        tag = f"batch {i + 1} ({'localized' if localized else 'uniform'})"
        check(rep.converged, f"dynamic {tag}: not converged ({rep})")
        if localized:
            check(rep.mode == "push" and rep.touched_frac < LOCALIZED_TOUCHED_MAX,
                  f"dynamic {tag}: mode {rep.mode}, touched_frac "
                  f"{rep.touched_frac:.4f} (bar {LOCALIZED_TOUCHED_MAX})")
        held(tag, ipr, rep, wall, launch_counts())
    forced_fallback(ipr, kernel, rng, checked_passes)
    # one more forced fallback, traced and unchecked: how its wall splits
    # between the host repair and the device solve; its whole cost (batch
    # draw, traced fallback, refine, oracle) is printed with it
    t_traced = time.perf_counter()
    ipr.max_push_rounds = 0
    adds, dels = random_update_batch(ipr.g, rng, DYN_OPS)
    reset_launch_counts()
    rep, wall_ms, busy_ms, rows = traced(lambda: ipr.apply(adds=adds, dels=dels))
    counts = launch_counts()
    check(rep.mode == "fallback" and counts[kernel] > 0,
          f"dynamic traced fallback: mode {rep.mode}, {counts[kernel]} {kernel} launches")
    print_trace("dynamic fallback (blocked_nosync)", wall_ms, busy_ms, rows,
                extra=f"gs_pass launches={counts[kernel]} ")
    ipr.max_push_rounds = 10_000
    t1 = time.perf_counter()
    r2, p2 = ipr._refine()
    refine_s = time.perf_counter() - t1
    held("traced fallback (blocked_nosync)", ipr, rep, wall_ms / 1e3, counts,
         extra=f"then refine rounds={r2} pushes={p2} refine_s={refine_s:.3f}; ")
    print(f"dynamic traced fallback: cost_s={time.perf_counter() - t_traced:.1f} "
          f"(batch draw, traced fallback, refine, oracle)", flush=True)
    ipr, kernel = start("blocked")
    forced_fallback(ipr, kernel, rng, checked_spmv)
    return launches


def ppr_serve_phase(g):
    """The launcher's serve with live updates at full size on the cuda
    backend: first all at once (SERVE_ARGV) under the profiler (the
    launcher call end to end, the surrogate's build included), then as a
    closed loop at half the q/s the first run reached, with the same
    updates.  The graph of each version is rebuilt from ``g`` by replaying
    the launcher's seeded update stream.  Every response solved or served
    after an update batch must be the float64 oracle's top-k on the graph
    it answers (one oracle a graph, over the seed sets of both runs), and
    gs_pass_multi must launch on the backend rebuilt for every updated
    graph that served a solve.  The all-at-once run applies both batches
    back to back, as the reference's serve does, so it answers nothing on
    version 1: that version is covered by the closed loop alone.  Returns
    the launches on the updated graphs by path."""
    from repro_torch.core.dynamic import random_update_batch
    from repro_torch.launch import pagerank_run
    from repro_torch.ppr import topk

    runs = {}
    t0 = time.perf_counter()
    rep, wall_ms, busy_ms, rows = traced(lambda: pagerank_run.run(SERVE_ARGV))
    print_trace("ppr serve --updates", wall_ms, busy_ms, rows)
    runs["serve --updates"] = rep
    qps = rep["qps"] / 2
    runs["serve --updates --qps"] = pagerank_run.run(SERVE_ARGV + ["--qps", f"{qps:.3f}"])
    serve_s = time.perf_counter() - t0
    graphs = [g]
    rng = np.random.default_rng(SERVE_SEED)
    for _ in range(SERVE_BATCHES):
        adds, dels = random_update_batch(graphs[-1], rng, SERVE_UPDATES // SERVE_BATCHES)
        graphs.append(graphs[-1].apply_updates(adds=adds, dels=dels)[0])
    for path, rep in runs.items():
        check(rep["applied"] == SERVE_UPDATES and len(rep["launches"]) == SERVE_BATCHES + 1
              and (rep["n"], rep["m"]) == (graphs[-1].n, graphs[-1].m),
              f"{path}: applied {rep['applied']} ops in {len(rep['launches']) - 1} "
              f"batches to n={rep['n']} m={rep['m']}, not the seeded stream's "
              f"n={graphs[-1].n} m={graphs[-1].m}")
    t0 = time.perf_counter()
    held = 0
    worst = 0.0
    for v in range(1, SERVE_BATCHES + 1):
        answers = [r for rep in runs.values()
                   for r, ver in zip(rep["responses"], rep["versions"]) if ver == v]
        check(len(answers) > 0, f"ppr serve: no answer on graph version {v}")
        oracle = ppr_oracle(graphs[v], [r.seeds for r in answers], dangling=False)
        for r in answers:
            ref = oracle[_key(r.seeds)]
            want, _ = topk(ref, r.indices.size)
            check(_same_topk(r.indices, want, ref),
                  f"ppr serve: qid {r.qid} (graph version {v}) top-k "
                  f"{r.indices.tolist()} is not the updated graph's {want.tolist()}")
            worst = max(worst, float(np.abs(r.values - ref[r.indices]).max()))
            held += 1
    check(worst <= TOPK_VALUE_TOL,
          f"ppr serve: top-k values off the updated oracle by {worst:.3e}")
    oracle_s = time.perf_counter() - t0
    launches = {}
    for path, rep in runs.items():
        n = 0
        for v in range(1, SERVE_BATCHES + 1):
            solved = any(not r.cached for r, ver in zip(rep["responses"], rep["versions"])
                         if ver == v)
            got = rep["launches"][v]["gs_pass_multi"]
            check(got > 0 or not solved,
                  f"{path}: no gs_pass_multi launch on graph version {v}")
            n += got
        launches[path] = n
        st = rep["stats"]["counters"]
        print(f"ppr {path}: n={rep['n']} m={rep['m']} applied={rep['applied']} "
              f"wall_s={rep['wall_s']:.4f} qps={rep['qps']:.2f} "
              f"p50_ms={rep['p50_ms']:.3f} p99_ms={rep['p99_ms']:.3f} "
              f"warm_hits={rep['warm_hits']} cache_hits={st.get('cache_hits', 0)} "
              f"invalidations={rep['invalidations']} responses by graph version "
              f"{[rep['versions'].count(v) for v in range(SERVE_BATCHES + 1)]} "
              f"gs_pass_multi launches by version "
              f"{[c['gs_pass_multi'] for c in rep['launches']]}", flush=True)
    print(f"ppr serve: {held} answers on updated graphs are the oracle's top-k "
          f"(values within {worst:.2e}); serve runs {serve_s:.1f}s (the first "
          f"traced), oracles {oracle_s:.1f}s", flush=True)
    return launches


def sticd_phase(g, dev):
    """The STIC-D plan stage at full size: the plan's counts (held to the
    reference's), one gs_pass on the weighted, biased core's operands,
    and each planned solve beside its unplanned counterpart, both warmed
    up first and timed STICD_REPS times (the median wall is compared),
    with dangling redistribution on and off; the planned kernel solves are
    also traced once.  Returns the planned blocked solves'
    kernel launches, by path."""
    from repro_torch.core.pagerank import l1_norm, pagerank_numpy
    from repro_torch.core.solver import build_variant, plan_build, plan_run
    from repro_torch.graphs import DecompositionPlan
    from repro_torch.kernels.spmv import (
        BlockedGraph, gs_pass, gs_pass_ref, launch_counts, reset_launch_counts,
    )

    t0 = time.perf_counter()
    plan = DecompositionPlan.from_graph(g)
    build_s = time.perf_counter() - t0
    stats = plan.stats()
    core = plan.core
    print(f"sticd: plan of the full graph built in {build_s:.3f}s (host): "
          f"{json.dumps(stats)}", flush=True)
    for k, want in STICD_STATS.items():
        check(stats[k] == want, f"sticd: plan {k}={stats[k]}, the reference's is {want}")
    kept = int((~plan.pruned[g.dst] & ~plan.struct_pruned[g.src]).sum())
    check(core.m == g.m - stats["pruned_edges"] + stats["contracted_edges"]
          and core.m == kept + plan.contracted_m,
          f"sticd: core_m={core.m}, full_m={g.m}, {kept} edges kept, "
          f"{plan.contracted_m} contracted")
    check(np.array_equal(core.out_degree, g.out_degree[plan.core_index])
          and bool((core.out_degree > 0).all()),
          "sticd: core out-degrees are not the full graph's, or one is 0")
    check(core.weights is not None and core.bias is not None,
          "sticd: the contracted core is not weighted and biased")
    t0 = time.perf_counter()
    plan.reconstruct(np.full(core.n, 1.0 / core.n), handle_dangling=True)
    recon_s = time.perf_counter() - t0
    print(f"sticd: core weighted and biased (weights in [{core.weights.min():.3g}, "
          f"{core.weights.max():.3g}], bias in [{core.bias.min():.3g}, "
          f"{core.bias.max():.3g}]), out-degrees the full graph's, none 0; "
          f"{core.m} = {g.m} - {stats['pruned_edges']} + "
          f"{stats['contracted_edges']} edges; reconstruct in {recon_s:.3f}s "
          f"(host)", flush=True)

    bg = BlockedGraph.build(core, block=256, device=dev)
    check(bg.n_blocks == STICD_CORE_BLOCKS,
          f"sticd: core has {bg.n_blocks} blocks, expected {STICD_CORE_BLOCKS}")
    pr, frozen, params = gs_inputs(core, bg, np.random.default_rng(0))
    args = (pr, bg.inv_out, bg.vmask, params, bg.in_ptr, bg.src, bg.weights,
            bg.bias, frozen)
    out, ref = gs_pass(*args), gs_pass_ref(*args)
    torch.cuda.synchronize()
    err, rel, ent = check_agreement("gs_pass (sticd core)", out, ref)
    check(torch.equal(out[frozen], pr[frozen]), "gs_pass (sticd core) moved a frozen lane")
    ms, by = device_ms(lambda: gs_pass(*args), 10)
    print(f"kernel gs_pass sticd core (weighted+biased, {bg.n_blocks} blocks): "
          f"max_abs_err={err:.3e} entry_rel={ent:.3e} (bound {KERNEL_RTOL:g}); "
          f"frozen lanes bit-identical; ms={ms:.4f} (device, by {by})", flush=True)
    del bg, pr, frozen, out, ref, args

    kernel_of = {"blocked": "spmv_csr_acc", "blocked_nosync": "gs_pass",
                 "blocked_adaptive": "gs_pass"}
    launches = {}
    for dangling in (True, False):
        oracle, _ = pagerank_numpy(g, threshold=1e-12, handle_dangling=dangling)
        kw = dict(threshold=SOLVE_THRESHOLD, handle_dangling=dangling)
        for planned, plain in STICD_PAIRS:
            inner = planned[len("plan("):-1] if planned.startswith("plan(") else None
            opts = dict(threads=56) if "nosync" in plain and inner is None else {}
            res = {}
            for name in (planned, plain):
                t0 = time.perf_counter()
                if name == planned and inner is not None:
                    bundle = plan_build(inner)(g, block=256, device=dev)
                    run = plan_run
                else:
                    v, bundle = build_variant(name, g, device=dev, **opts)
                    run = v.run
                torch.cuda.synchronize()
                built = time.perf_counter() - t0
                run(bundle, **kw)  # warm-up: first launches do not count
                kernel = kernel_of.get(inner or name)
                walls = []
                for _ in range(STICD_REPS):
                    torch.cuda.synchronize()
                    reset_launch_counts()
                    t0 = time.perf_counter()
                    r = run(bundle, **kw)
                    pr = r.pr.cpu() if isinstance(r.pr, torch.Tensor) else r.pr
                    walls.append(time.perf_counter() - t0)
                    counts = launch_counts()
                    for k, n in counts.items():
                        want = r.iterations if k == kernel else 0
                        check(n == want, f"sticd {name} handle_dangling={dangling}: "
                              f"{k} launched {n} times, expected {want}")
                wall = (float(np.median(walls)), min(walls), max(walls))
                # every solve, adaptive ones too, to L1_DEFAULT: the planned
                # core solve runs without dangling (reconstruct applies the
                # redistribution in closed form), and in the original order
                # the unplanned adaptive solve stays far inside it as well
                l1 = l1_norm(pr, oracle)
                check(l1 <= L1_DEFAULT, f"sticd {name} handle_dangling={dangling}: "
                      f"L1 {l1:.3e} > {L1_DEFAULT:g}")
                resid = ""
                if name == "blocked_adaptive":
                    over = (np.abs(jacobi_residual(g, pr.numpy(), dangling))
                            / residual_allowance(g, pr.numpy(), dangling)).max()
                    check(over <= 1.0, f"sticd {name} handle_dangling={dangling}: "
                          f"a vertex keeps a residual {over:.3f}x what the stop "
                          f"rule certifies")
                    resid = f" (residual at most {over:.3f} of what the stop rule certifies)"
                res[name] = (r, wall, built, l1, counts, resid)
                if dangling and name == planned and kernel is not None:
                    launches.setdefault(kernel, {})[name] = counts[kernel]
                    # where a planned kernel solve's time goes: device
                    # time by kernel, and the host's share (reconstruct)
                    _, wall_ms, busy_ms, rows = traced(lambda: run(bundle, **kw))
                    print_trace(f"sticd {name}", wall_ms, busy_ms, rows,
                                extra=f"iterations={r.iterations} ")
            (rp, wp, bp, lp, cp, _), (ru, wu, bu, lu, cu, su) = res[planned], res[plain]
            print(f"sticd handle_dangling={dangling}: {planned} / {plain}: "
                  f"iterations {rp.iterations} / {ru.iterations}, sweeps "
                  f"{rp.sweeps} / {ru.sweeps}, wall_s median of {STICD_REPS} "
                  f"{wp[0]:.4f} [{wp[1]:.4f}, {wp[2]:.4f}] / {wu[0]:.4f} "
                  f"[{wu[1]:.4f}, {wu[2]:.4f}] ({wp[0] / wu[0]:.3f}), L1 "
                  f"{lp:.3e} / {lu:.3e}{su}, built in "
                  f"{bp:.3f}s / {bu:.3f}s, launches {cp} / {cu}", flush=True)
    return launches


def push_phase(g, oracle, seed_sets):
    """ppr_push (FIFO) at full size on every seed set, and ppr_push_priority
    on the one whose FIFO solve pushed most, uniform teleport aside (a
    priority solve takes tens of seconds on the host).  Host float64.  Each
    answer is held to the oracle: estimates never above it (they are lower
    bounds); with dangling redistribution every ppr(e_v) has unit mass, so
    the true L1 error equals the certificate ``l1_bound``, and the L1 to
    the oracle must match it within the oracle's own error
    (:func:`oracle_l1_err`), which a push that lost or gained mass would
    break; and the top-k is the oracle's up to what the certificate
    allows."""
    from repro_torch.ppr import ppr_push

    tol = oracle_l1_err(g.n) + 1e-12

    def one(variant, priority, seeds):
        t0 = time.perf_counter()
        res = ppr_push(g, seeds, rmax=PUSH_RMAX, handle_dangling=True,
                       priority=priority)
        wall = time.perf_counter() - t0
        ref = oracle[_key(seeds)]
        over = float((res.est - ref).max())
        check(over <= 1e-12, f"{variant} seeds={list(seeds)}: an estimate "
              f"is {over:.3e} above the oracle")
        l1 = float(np.abs(res.est - ref).sum())
        check(abs(l1 - res.l1_bound) <= tol,
              f"{variant} seeds={list(seeds)}: L1 to the oracle {l1:.6e} is not "
              f"the certificate {res.l1_bound:.6e} within {tol:.3e}")
        idx, vals = res.topk(PUSH_TOPK)
        missed = [int(v) for v in np.argsort(ref)[::-1][:PUSH_TOPK]
                  if v not in idx]
        check(all(ref[v] <= vals[-1] + 2 * res.l1_bound + 1e-12 for v in missed),
              f"{variant} seeds={list(seeds)}: top-{PUSH_TOPK} misses "
              f"{missed} beyond the certificate")
        print(f"push {variant} seeds={list(seeds) or 'uniform'} rmax={PUSH_RMAX:g}: "
              f"rounds={res.rounds} pushes={res.pushes} l1_bound="
              f"{res.l1_bound:.6e} (L1 to the oracle {l1:.6e}, within "
              f"{abs(l1 - res.l1_bound):.3e} of it, oracle error <= {tol:.3e}; "
              f"max est - oracle {over:.3e}) top-{PUSH_TOPK} the oracle's up "
              f"to the certificate ({len(missed)} swapped) wall_s={wall:.4f}",
              flush=True)
        return res.pushes

    pushes = {seeds: one("ppr_push", False, seeds) for seeds in seed_sets}
    one("ppr_push_priority", True,
        max((s for s in seed_sets if s), key=lambda s: pushes[s]))


@contextlib.contextmanager
def timed_calls(owner, name: str):
    """Time every call of ``owner.name`` while the block runs (the real
    function still runs).  Yields ``{"calls": n, "s": seconds}``."""
    real = getattr(owner, name)
    seen = {"calls": 0, "s": 0.0}

    def timed(*args, **kw):
        t0 = time.perf_counter()
        try:
            return real(*args, **kw)
        finally:
            seen["calls"] += 1
            seen["s"] += time.perf_counter() - t0

    setattr(owner, name, timed)
    try:
        yield seen
    finally:
        setattr(owner, name, real)


def memmap_solves(g, dev, oracle, where, variants=(("blocked_nosync", "gs_pass"),
                                                   ("blocked", "spmv_csr_acc")),
                  perm=None):
    """Each of ``variants`` (variant, its kernel) with dangling
    redistribution on the memmap-backed ``g``, from one blocked build (the
    variants share the layout).  Each solve runs twice: a warm-up whose
    first STORE_CHECKED launches are held against the plain versions, then
    a counted solve (launches = passes) whose ranks, mapped to original ids
    by ``perm`` where the store was reordered, are held to the float64
    ``oracle`` (vector, L1 error bound) of the original graph within
    L1_DEFAULT.  ``where`` names the store in the printed lines.  Returns
    the bundle and, per kernel, its launches."""
    from repro_torch.core.pagerank import l1_norm
    from repro_torch.core.solver import build_variant, get_variant
    from repro_torch.graphs import unpermute_ranks
    from repro_torch.kernels.spmv import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    _, bg = build_variant("blocked_nosync", g, device=dev, block=256)
    torch.cuda.synchronize()
    print(f"build bundle ({where}): BlockedGraph from the memmap in "
          f"{time.perf_counter() - t0:.2f}s: {bg.n_blocks} blocks of {bg.block}, "
          f"largest block {int(np.diff(np.asarray(g.in_ptr)[::256]).max())} "
          f"in-edges (the last block aside)", flush=True)
    ref, ref_err = oracle
    holders = {"gs_pass": checked_passes, "spmv_csr_acc": checked_spmv}
    launches = {}
    for variant, kernel in variants:
        v = get_variant(variant)
        kw = dict(threshold=SOLVE_THRESHOLD, handle_dangling=True)
        with holders[kernel](f"{where}, {variant}", calls=STORE_CHECKED) as seen:
            v.run(bg, **kw)
        held = len(seen["frozen"]) if kernel == "gs_pass" else seen["calls"]
        check(held == STORE_CHECKED, f"{where} {variant}: {held} launches held, "
              f"expected {STORE_CHECKED}")
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = v.run(bg, **kw)
        pr = r.pr.reshape(-1)[:g.n].double().cpu().numpy()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        for k, n in counts.items():
            want = r.iterations if k == kernel else 0
            check(n == want, f"{where} {variant}: {k} launched {n} times, "
                  f"expected {want} (its passes)")
        if perm is not None:
            pr = unpermute_ranks(pr, perm)
        l1 = l1_norm(pr, ref)
        check(l1 <= L1_DEFAULT, f"{where} {variant}: L1 {l1:.3e} to the float64 "
              f"oracle > {L1_DEFAULT:g}")
        launches[kernel] = r.iterations
        print(f"build solve {variant} --handle-dangling ({where}, memmap): "
              f"passes={r.iterations} err={float(r.err):.3e} wall_s={wall:.4f} "
              f"ms_a_pass={1e3 * wall / r.iterations:.3f} l1={l1:.3e}"
              f"{' (original ids)' if perm is not None else ''} (bound "
              f"{L1_DEFAULT:g}; oracle error <= {ref_err:.1e}) launches={counts}; "
              f"the warm-up's first {STORE_CHECKED} launches within the entry "
              f"bound of the plain version (worst {seen['entry_rel']:.3e})",
              flush=True)
    return bg, launches


def memmap_kernel_times(g, bg, dev, where, kernels=("gs_pass", "spmv_csr_acc")):
    """``kernels`` (gs_pass, spmv_csr_acc) on the memmap store's operands
    by device time in a trace, beside their bytes bounds, their plain
    versions (CUDA events) and, for spmv_csr_acc, the library call
    (torch.sparse CSR mv).  gs_pass as blocked_nosync runs it: no frozen
    lanes.  ``where`` names the store in the printed lines."""
    from repro_torch.kernels.spmv import gs_pass, gs_pass_ref

    rng = np.random.default_rng(0)
    pr, _, params = gs_inputs(g, bg, rng)
    n_pad, m = bg.n_blocks * bg.block, g.m
    csr_bytes = 4 * (n_pad + 1) + 4 * m
    gs_args = (pr, bg.inv_out, bg.vmask, params, bg.in_ptr, bg.src, None, None, None)

    def gs():
        return gs_pass(*gs_args)

    stats = {}
    if "gs_pass" in kernels:
        ms, by = device_ms(gs, 5, warmup=1)
        stats["gs_pass"] = dict(
            n=g.n, m=m, ms=ms, timed_by=by, batch_ms=batch_ms(gs, 5, warmup=1),
            plain_ms=time_ms(lambda: gs_pass_ref(*gs_args), 1, warmup=0),
            bound_ms=bound_ms(4 * n_pad * 4 + 12 + csr_bytes), walk_steps=bg.n_blocks)
    if "spmv_csr_acc" in kernels:
        stats["spmv_csr_acc"] = spmv_times(g, bg, dev, pr, csr_bytes)
    for name, s in stats.items():
        lib = (f" library_ms={s['library_ms']:.4f} (torch.sparse CSR mv, by "
               f"{s['library_by']})" if "library_ms" in s else
               f" ({s['walk_steps']} dependent block steps a pass)")
        print(f"build kernel {name} ({where}) at n={s['n']} m={s['m']}: "
              f"ms={s['ms']:.4f} (device, by {s['timed_by']}; {s['batch_ms']:.4f} a "
              f"call by events around calls back to back) plain_ms="
              f"{s['plain_ms']:.4f} (events) bound_ms={s['bound_ms']:.4f} (bytes)"
              f"{lib}", flush=True)
        check(s["ms"] >= s["bound_ms"] and s["batch_ms"] >= s["bound_ms"],
              f"build kernel {name} ({where}): {s['ms']:.4f} / {s['batch_ms']:.4f} "
              f"ms below its bytes bound {s['bound_ms']:.4f}: a time lost device "
              f"work")
    return stats


def spmv_times(g, bg, dev, pr, csr_bytes):
    """spmv_csr_acc on ``bg``'s operands: device time, a call back to back,
    plain version, bytes bound and torch.sparse CSR mv."""
    from repro_torch.kernels.spmv import spmv_csr_acc, spmv_csr_acc_ref

    n_pad, m = bg.n_blocks * bg.block, g.m
    contrib = pr * bg.inv_out
    spmv_args = (contrib, bg.in_ptr, bg.src, None)

    def spmv():
        return spmv_csr_acc(*spmv_args)

    ms, by = device_ms(spmv, 20)
    csr = torch.sparse_csr_tensor(bg.in_ptr, bg.src, torch.ones(m, device=dev),
                                  (n_pad, n_pad))
    flat = contrib.reshape(-1)
    lib_ms, lib_by = device_ms(lambda: torch.mv(csr, flat), 20)
    return dict(n=g.n, m=m, ms=ms, timed_by=by, batch_ms=batch_ms(spmv, 100),
                plain_ms=time_ms(lambda: spmv_csr_acc_ref(*spmv_args), 5),
                bound_ms=bound_ms(4 * n_pad + csr_bytes + 4 * n_pad),
                library_ms=lib_ms, library_by=lib_by)


# The child samples its own RSS (/proc/self/statm) every 20 ms while it
# works, and reads the kernel's high-water mark of its address space
# (VmHWM) after it where /proc has one (the card's sandbox has none).
# ru_maxrss is reported beside them but is no measure of the child: Linux
# carries the parent's peak over the exec of a forked child, so it reads
# at least the parent's RSS at the fork.  argv is the launcher's
# ``build ...``, ``dryrun`` and the dry run's arguments (its exit code in
# ``code``), or ``make_dataset NAME SCALE_DOWN`` (the in-RAM path,
# scripts/build_rss.py's comparison).
RSS_CHILD = """
import json, os, resource, sys, threading


def rss():
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return None


peak, done = [rss()], threading.Event()


def sample():
    while not done.wait(0.02):
        now = rss()
        if now is not None and peak[0] is not None:
            peak[0] = max(peak[0], now)


sampler = threading.Thread(target=sample, daemon=True)
sampler.start()
if sys.argv[1] == "build":
    from repro_torch.launch import pagerank_run
    rep = pagerank_run.run(sys.argv[1:])
    rep = {k: rep[k] for k in ("stages", "n", "m", "nbytes")}
elif sys.argv[1] == "dryrun":
    from repro_torch.launch import dryrun
    rep = dict(code=dryrun.main(sys.argv[2:]))
else:
    from repro_torch.graphs import make_dataset
    g = make_dataset(sys.argv[2], scale_down=float(sys.argv[3]))
    rep = dict(n=g.n, m=g.m)
done.set()
sampler.join()
try:
    with open("/proc/self/status") as f:
        mem = [l.split(None, 1) for l in f if l.startswith(("Vm", "Rss"))]
except OSError:
    mem = []
mem = {k.rstrip(":"): v.strip() for k, v in mem}
hwm = mem.get("VmHWM")
print(json.dumps(dict(rep, sampled_peak=peak[0], status=mem,
                      hwm=int(hwm.split()[0]) * 1024 if hwm else None,
                      maxrss=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024)))
"""


def rss_child(argv: list[str], echo: bool = True, timeout: float = BUILD_CHILD_TIMEOUT) -> dict:
    """RSS_CHILD on ``argv`` in a child process; returns its report (for
    ``build``: stages, n, m, nbytes), its peak RSS in bytes as the child
    read it (``sampled_peak``, ``hwm``: None where not measured;
    ``maxrss`` as getrusage reports it; ``status``: /proc/self/status's
    memory lines at its end), the child's wall (``wall_s``) and its own
    output lines (``lines``), which ``echo`` prints indented."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", RSS_CHILD, *argv], env=env,
                         capture_output=True, text=True, timeout=timeout)
    lines = out.stdout.splitlines()
    if echo:
        for line in lines[:-1]:
            print(f"  {line}")
    check(out.returncode == 0 and bool(lines),
          f"child {argv}: exit {out.returncode}: {out.stderr[-3000:]}")
    rep = json.loads(lines[-1])
    rep["wall_s"] = time.perf_counter() - t0
    rep["lines"] = lines[:-1]
    return rep


def start_build_children():
    """Step 2 of :func:`build_phase`, started early: the two host processes
    that stream socLiveJournal1 at full size to disk under BUILD_DIR
    (``--stages generate``, then the resume), one after the other in a
    thread, so that they run while the LM phases use the card (they touch
    no GPU; the build phase's own wall once took 320–440 s of a 1,200 s
    budget, most of it in them).  Returns the future of their two
    reports; :func:`build_phase` waits for it."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    shutil.rmtree(BUILD_DIR, ignore_errors=True)
    argv = ["build", "--dataset", STORE_DATASET, "--scale-down", "1", "--order", "bfs",
            "--out", os.path.join(BUILD_DIR, STORE_DATASET)]
    pool = ThreadPoolExecutor(1)
    children = pool.submit(lambda: (rss_child(argv + ["--stages", "generate"], echo=False),
                                    rss_child(argv, echo=False)))
    pool.shutdown(wait=False)
    return children


def build_phase(g_ws, dev, children):
    """The out-of-core build pipeline through the launcher's ``build``.

    1. Parity at 1/BUILD_PARITY_SCALE_DOWN of socLiveJournal1: an
       unordered build's raw store has the array files and CRC-32s of
       ``make_dataset``'s cache entry (the in-RAM path), and
       ``reorder_store`` of that entry gives the reordered arrays and perm
       of a BFS build.
    2. Full size, streamed, in two child processes (``children``, from
       :func:`start_build_children`): ``--stages generate``,
       then a resume that skips generate and runs the BFS reorder and the
       layout; each stage's wall and each child's peak RSS beside 16·m
       bytes (the int64 edge list the in-RAM path holds).  The raw store
       has the Table-1 counts and passes ``verify()``; ``LAYOUT.json``'s
       bounds are the final store's ``partition_ranges(BUILD_THREADS)``.
    3. From the raw store's memmap (the in-RAM graph, by 1.):
       blocked_nosync (gs_pass) and blocked (spmv_csr_acc) held to the
       float64 oracle, both kernels timed.
    4. From the BFS-reordered store: blocked_nosync, ranks mapped to
       original ids held to the same oracle, gs_pass timed there.
    5. webStanford built BFS-ordered and solved by ``--store <build dir>
       --ckpt``: original ids, within L1_DEFAULT of the resident solve's.

    The build directories are deleted at the end.  Returns the kernels'
    stats on the raw store, gs_pass's on the BFS store, and their launches
    by path."""
    import shutil

    from repro_torch.core.pagerank import l1_norm
    from repro_torch.core.runtime import SolverCheckpoint
    from repro_torch.core.solver import build_variant
    from repro_torch.graphs import DATASETS, GraphStore, dataset_cache_path, make_dataset
    from repro_torch.graphs.pipeline import (
        final_store_path, raw_store_path, reorder_store, reordered_store_path,
    )
    from repro_torch.kernels.spmv import launch_counts, reset_launch_counts
    from repro_torch.launch import pagerank_run

    def under(name):
        return os.path.join(BUILD_DIR, name)

    try:
        # 1. parity with the in-RAM path at a cut size
        sd = BUILD_PARITY_SCALE_DOWN
        argv = ["build", "--dataset", STORE_DATASET, "--scale-down", str(sd)]
        t0 = time.perf_counter()
        plain = pagerank_run.run(argv + ["--order", "none", "--out", under("sd_none")])
        none_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        make_dataset(STORE_DATASET, scale_down=sd, cache_dir=under("cache"))
        cache_s = time.perf_counter() - t0
        entry = GraphStore(dataset_cache_path(STORE_DATASET, sd, 0, under("cache")))
        raw = GraphStore(plain["store"])
        raw.verify()
        entry.verify()
        check(raw.meta["arrays"] == entry.meta["arrays"],
              f"build parity: the 1/{sd} raw store's arrays {raw.meta['arrays']} are "
              f"not make_dataset's {entry.meta['arrays']}")
        t0 = time.perf_counter()
        adopted = GraphStore(reorder_store(entry.path, under("sd_reorder"),
                                           order="bfs")["store"])
        reorder_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        bfs = GraphStore(pagerank_run.run(argv + ["--order", "bfs", "--out",
                                                  under("sd_bfs")])["store"])
        bfs_s = time.perf_counter() - t0
        check(adopted.meta["arrays"] == bfs.meta["arrays"]
              and np.array_equal(adopted.perm(), bfs.perm()),
              f"build parity: reorder_store of the 1/{sd} cache entry differs from "
              f"build --order bfs")
        print(f"build parity ({STORE_DATASET}, scale_down {sd}: n={raw.n} m={raw.m}): "
              f"build --order none {none_s:.2f}s, its raw store's "
              f"{len(raw.meta['arrays'])} array files and CRC-32s equal to "
              f"make_dataset's cache entry ({cache_s:.2f}s); reorder_store of that "
              f"entry ({reorder_s:.2f}s) equal to build --order bfs ({bfs_s:.2f}s), "
              f"array for array with its perm", flush=True)
        for name in ("sd_none", "cache", "sd_reorder", "sd_bfs"):
            shutil.rmtree(under(name))

        # 2. full size, streamed, generate and then a resume in two children
        out = under(STORE_DATASET)
        t0 = time.perf_counter()
        first, second = children.result()
        print(f"build children (started before the flash phase): waited "
              f"{time.perf_counter() - t0:.1f}s for them", flush=True)
        for line in first["lines"] + second["lines"]:
            print(f"  {line}")
        check(list(first["stages"]) == ["generate"]
              and not first["stages"]["generate"]["skipped"],
              f"build --stages generate ran {first['stages']}")
        check([second["stages"][k]["skipped"] for k in ("generate", "reorder", "layout")]
              == [True, False, False],
              f"build resume: stages {second['stages']}, expected generate skipped")
        edge_list = 16 * second["m"]
        for tag, child in (("--stages generate", first), ("resume", second)):
            walls = " ".join(f"{k}={v['wall_s']:.2f}s" + (" (skipped)" if v["skipped"] else "")
                             for k, v in child["stages"].items())
            peaks = [p for p in (child["sampled_peak"], child["hwm"]) if p is not None]
            peak = (f"{max(peaks):,} ({max(peaks) / edge_list:.3f} of 16 m = "
                    f"{edge_list:,} bytes, the in-RAM int64 edge list)" if peaks
                    else "not measured")
            print(f"build child {tag} ({STORE_DATASET}, full size): {walls}; child "
                  f"wall_s={child['wall_s']:.2f} peak_rss_bytes={peak}; sampled every "
                  f"20 ms {child['sampled_peak']}, VmHWM {child['hwm']}, ru_maxrss "
                  f"{child['maxrss']:,} (the parent's peak carried over the exec)",
                  flush=True)
        spec = DATASETS[STORE_DATASET]
        raw = GraphStore(raw_store_path(out))
        check((raw.n, raw.m) == (spec.n_vertices, spec.n_edges),
              f"build: raw store n={raw.n} m={raw.m}, Table 1 says "
              f"{spec.n_vertices} / {spec.n_edges}")
        t0 = time.perf_counter()
        raw.verify()
        verify_s = time.perf_counter() - t0
        final = GraphStore(final_store_path(out))
        check(final.path == reordered_store_path(out) and final.order == "bfs",
              f"build: the final store is {final.path} ({final.order})")
        h = final.graph(mmap=True)
        lay = final.layout()
        check(lay is not None and lay["threads"] == BUILD_THREADS
              and lay["partition_bounds"] == h.partition_ranges(BUILD_THREADS).tolist(),
              "build: LAYOUT.json's bounds are not the final store's partition_ranges")
        print(f"build stores: raw n={raw.n} m={raw.m} bytes={raw.nbytes():,} "
              f"(verify() {verify_s:.2f}s); final {os.path.relpath(final.path, out)} "
              f"bytes={final.nbytes():,}; LAYOUT.json {len(lay['partition_edges'])} "
              f"partitions, in-edges max {max(lay['partition_edges'])} mean "
              f"{np.mean(lay['partition_edges']):.1f}", flush=True)

        # 3. solves and kernel times from the raw store's memmap
        g = raw.graph(mmap=True)
        t0 = time.perf_counter()
        oracle = global_oracle(g, dangling=True)
        print(f"build oracle: scipy float64, {oracle[2]} iterations to an L1 step "
              f"<= {GLOBAL_ORACLE_STEP:g} (L1 error <= {oracle[1]:.1e}), "
              f"{time.perf_counter() - t0:.2f}s", flush=True)
        where = f"{STORE_DATASET} raw store"
        bg, solved = memmap_solves(g, dev, oracle[:2], where)
        stats = memmap_kernel_times(g, bg, dev, where)
        for kernel, n in solved.items():
            stats[kernel]["launches"] = n
        del bg, g
        torch.cuda.empty_cache()

        # 4. the BFS-reordered store, ranks in original ids
        where = f"{STORE_DATASET} BFS store"
        bg, solved_bfs = memmap_solves(h, dev, oracle[:2], where,
                                       variants=(("blocked_nosync", "gs_pass"),),
                                       perm=final.perm())
        bfs_stats = memmap_kernel_times(h, bg, dev, where, kernels=("gs_pass",))["gs_pass"]
        bfs_stats["launches"] = solved_bfs["gs_pass"]
        print(f"build gs_pass BFS against original order ({STORE_DATASET}): "
              f"{bfs_stats['ms'] / stats['gs_pass']['ms']:.3f}x a pass "
              f"({bfs_stats['ms']:.4f} / {stats['gs_pass']['ms']:.4f} ms)", flush=True)
        del bg, h, oracle
        torch.cuda.empty_cache()

        # 5. webStanford through build and --store <build dir> --ckpt
        ws = under("webStanford")
        ckpt = under("pr")
        pagerank_run.run(["build", "--dataset", "webStanford", "--scale-down", "1",
                          "--order", "bfs", "--out", ws])
        reset_launch_counts()
        rep = pagerank_run.run(["--store", ws, "--variant", "blocked_nosync",
                                "--handle-dangling", "--threshold", str(SOLVE_THRESHOLD),
                                "--ckpt", ckpt])
        launched = launch_counts()["gs_pass"]
        check(launched == rep["iterations"],
              f"build --store: gs_pass launched {launched} times, "
              f"{rep['iterations']} passes")
        check(rep["l1"] <= L1_DEFAULT, f"build --store: L1 {rep['l1']:.3e} > {L1_DEFAULT:g}")
        v, bundle = build_variant("blocked_nosync", g_ws, device=dev)
        resident = v.run(bundle, threshold=SOLVE_THRESHOLD, handle_dangling=True)
        res_pr = resident.pr.reshape(-1)[:g_ws.n].double().cpu().numpy()
        l1_res = l1_norm(rep["pr"], res_pr)
        check(l1_res <= L1_DEFAULT, f"build --store: ranks {l1_res:.3e} in L1 from "
              f"the resident solve's (bound {L1_DEFAULT:g}): not in original ids?")
        ck = SolverCheckpoint.load(rep["ckpt"])
        check(ck.p == rep["ckpt_p"] == 1 and (ck.n, ck.round) == (g_ws.n, rep["iterations"])
              and np.array_equal(ck.pr, rep["pr"]),
              f"build --ckpt: checkpoint p={ck.p} n={ck.n} round={ck.round}, not "
              f"the report's")
        print(f"build --store <build dir> --ckpt (webStanford, BFS build): "
              f"passes={rep['iterations']} launches={launched} l1={rep['l1']:.3e} "
              f"(original ids); L1 to the resident solve {l1_res:.3e} "
              f"({resident.iterations} passes); checkpoint p={ck.p}, ranks equal the "
              f"report's", flush=True)
        by_path = {"gs_pass": {f"build blocked_nosync ({STORE_DATASET} raw)": solved["gs_pass"],
                               f"build blocked_nosync ({STORE_DATASET} BFS)":
                               solved_bfs["gs_pass"],
                               "build --store <build dir> (webStanford BFS)": launched},
                   "spmv_csr_acc": {f"build blocked ({STORE_DATASET} raw)":
                                    solved["spmv_csr_acc"]}}
        return stats, bfs_stats, by_path
    finally:
        shutil.rmtree(BUILD_DIR, ignore_errors=True)


def store_phase(g_ws, dev):
    """The graph store.  The socLiveJournal1 surrogate at
    1/STORE_CACHE_SCALE_DOWN of its size is made by ``make_dataset`` with a
    cache directory (the generate and save times printed apart), then asked
    for again: that call must hit the cache, memmap-backed, CRC-verified,
    array for array the first call's graph.  Then full webStanford
    (``g_ws``) is saved BFS-ordered with its perm and solved by the
    launcher with ``--store`` and ``--ckpt``: ranks in original ids, equal
    to a resident solve's within L1_DEFAULT, and the checkpoint reloads
    with the printed p and the same ranks.  The stores are deleted at the
    end.  Returns gs_pass's launches by path."""
    import shutil

    from repro_torch.core.pagerank import l1_norm
    from repro_torch.core.runtime import SolverCheckpoint
    from repro_torch.core.solver import build_variant, bundle_partitions
    from repro_torch.graphs import (
        GraphStore, compute_order, dataset_cache_path, make_dataset, permute_graph,
        save_graph, store,
    )
    from repro_torch.kernels.spmv import launch_counts, reset_launch_counts
    from repro_torch.launch import pagerank_run

    shutil.rmtree(STORE_DIR, ignore_errors=True)
    cache = os.path.join(STORE_DIR, "cache")
    sd = STORE_CACHE_SCALE_DOWN
    try:
        t0 = time.perf_counter()
        with timed_calls(store, "save_graph") as saved:
            g = make_dataset(STORE_DATASET, scale_down=sd, cache_dir=cache)
        total = time.perf_counter() - t0
        check(saved["calls"] == 1 and not g.is_memmap,
              f"store: the first make_dataset saved {saved['calls']} stores")
        path = dataset_cache_path(STORE_DATASET, sd, 0, cache)
        st = GraphStore(path)
        print(f"store make_dataset {STORE_DATASET} (scale_down {sd}): n={g.n} m={g.m} "
              f"generate_s={total - saved['s']:.2f} save_s={saved['s']:.2f} "
              f"bytes={st.nbytes():,} files={sorted(st.meta['arrays'])}", flush=True)
        t0 = time.perf_counter()
        with timed_calls(GraphStore, "verify") as verified:
            h = make_dataset(STORE_DATASET, scale_down=sd, cache_dir=cache)
        reload_s = time.perf_counter() - t0
        check(h.is_memmap, "store: the second make_dataset did not load the cache")
        check(verified["calls"] == 1, "store: the cache hit was not CRC-verified")
        for name in ("src", "dst", "out_degree", "in_ptr"):
            check(np.array_equal(getattr(g, name), getattr(h, name)),
                  f"store: the cache hit's {name} differs from the build's")
        check((h.weights, h.bias) == (None, None), "store: the hit grew weights")
        print(f"store cache hit: memmap-backed, CRC-verified in "
              f"{verified['s']:.2f}s (reload_s={reload_s:.2f}), every array equal "
              f"to the build's", flush=True)
        del g, h

        # webStanford BFS-ordered, through the launcher's --store and --ckpt
        perm = compute_order(g_ws, "bfs")
        ws_path = os.path.join(STORE_DIR, "webStanford_bfs")
        save_graph(ws_path, permute_graph(g_ws, perm), perm=perm, order="bfs")
        ckpt = os.path.join(STORE_DIR, "pr")
        reset_launch_counts()
        rep = pagerank_run.run(["--store", ws_path, "--variant", "blocked_nosync",
                                "--handle-dangling", "--threshold", str(SOLVE_THRESHOLD),
                                "--ckpt", ckpt])
        launched = launch_counts()["gs_pass"]
        check(launched == rep["iterations"],
              f"store --store: gs_pass launched {launched} times, "
              f"{rep['iterations']} passes")
        check(rep["l1"] <= L1_DEFAULT, f"store --store: L1 {rep['l1']:.3e} > {L1_DEFAULT:g}")
        v, bundle = build_variant("blocked_nosync", g_ws, device=dev)
        resident = v.run(bundle, threshold=SOLVE_THRESHOLD, handle_dangling=True)
        res_pr = resident.pr.reshape(-1)[:g_ws.n].double().cpu().numpy()
        l1_res = l1_norm(rep["pr"], res_pr)
        check(l1_res <= L1_DEFAULT, f"store --store: ranks {l1_res:.3e} in L1 from "
              f"the resident solve's (bound {L1_DEFAULT:g}): not in original ids?")
        ck = SolverCheckpoint.load(rep["ckpt"])
        check(ck.p == rep["ckpt_p"] == bundle_partitions(bundle) == 1,
              f"store --ckpt: checkpoint p={ck.p}, printed {rep['ckpt_p']}")
        check((ck.n, ck.round) == (g_ws.n, rep["iterations"])
              and np.array_equal(ck.pr, rep["pr"]),
              "store --ckpt: the checkpoint is not the reported ranks")
        print(f"store --store --ckpt (webStanford, BFS order, perm stored): "
              f"passes={rep['iterations']} launches={launched} l1={rep['l1']:.3e} "
              f"(original ids); L1 to the resident solve {l1_res:.3e} "
              f"({resident.iterations} passes; bound {L1_DEFAULT:g}); top5 "
              f"{rep['top5']}; checkpoint n={ck.n} p={ck.p} round={ck.round}, "
              f"ranks equal the report's", flush=True)
        return {"store --store --ckpt (webStanford BFS)": launched}
    finally:
        shutil.rmtree(STORE_DIR, ignore_errors=True)


def faults_phase(g, dev):
    """The Wait-Free simulator (Alg 6) at the reference's
    benchmarks/bench_faults.py setup, full size: full webStanford,
    PartitionedGraph at p = FAULT_P, threshold FAULT_THRESHOLD; the three
    disciplines with no fault, with worker 0 asleep every iteration (Fig
    8) and with 1, 2, 3 workers failed (Fig 9).  Every card run is held
    against the same call on the CPU (iterations, work and modelled time
    equal, ranks within FAULT_CPU_L1), every converged run against the
    leaky float64 oracle within what the threshold certifies, and the
    reference tests' claims are checked.  Prints the Fig 8/9 table."""
    from repro_torch.core.pagerank import PartitionedGraph, l1_norm
    from repro_torch.core.runtime import FaultPlan, simulate

    d = 0.85
    pgs = {"card": PartitionedGraph.from_graph(g, p=FAULT_P, device=dev),
           "cpu": PartitionedGraph.from_graph(g, p=FAULT_P, device="cpu")}
    oracle, oracle_err, _ = global_oracle(g)
    bound = d / (1 - d) * g.n * FAULT_THRESHOLD
    plans = {"none": {}}
    for s in FAULT_SLEEPS:
        plans[f"sleep {s:g}"] = {"sleeps": {(0, it): s for it in range(1, 1001)}}
    for k in FAULT_FAILED:
        plans[f"{k} failed"] = {"failures": {w: FAULT_FAIL_AT for w in range(k)}}
    runs = {}
    walls = {"card": 0.0, "cpu": 0.0}
    for plan_name, plan in plans.items():
        for disc in ("barrier", "nosync", "waitfree"):
            kw = dict(threshold=FAULT_THRESHOLD)
            if disc == "barrier" and "failures" in plan:
                kw["max_iter"] = FAULT_BARRIER_MAX_ITER  # a failure holds the barrier
            res = {}
            for where, pg in pgs.items():
                t0 = time.perf_counter()
                res[where] = simulate(pg, disc, FaultPlan(**plan), **kw)
                walls[where] += time.perf_counter() - t0
            a, b = res["card"], res["cpu"]
            l1_cpu = l1_norm(a.pr, b.pr)
            check((a.iterations, a.work_done, a.sim_time)
                  == (b.iterations, b.work_done, b.sim_time),
                  f"faults {disc} {plan_name}: card {a.iterations} iterations, "
                  f"time {a.sim_time}, work {a.work_done}; CPU {b.iterations}, "
                  f"{b.sim_time}, {b.work_done}")
            check(l1_cpu <= FAULT_CPU_L1, f"faults {disc} {plan_name}: card ranks "
                  f"{l1_cpu:.3e} in L1 from the CPU's (bound {FAULT_CPU_L1:g})")
            converged = a.iterations < kw.get("max_iter", 1000)
            l1 = l1_norm(a.pr, oracle)
            if converged:
                check(l1 <= bound + oracle_err, f"faults {disc} {plan_name}: L1 "
                      f"{l1:.3e} to the oracle > {bound:.3e}")
            runs[(plan_name, disc)] = (a, converged, l1)
            print(f"faults {disc} {plan_name}: iterations={a.iterations} "
                  f"converged={converged} sim_time={a.sim_time:g} work="
                  f"{[a.work_done[w] for w in range(FAULT_P)]} l1={l1:.3e}"
                  f"{f' (bound {bound:.3e})' if converged else ''} card-CPU "
                  f"l1={l1_cpu:.1e}", flush=True)

    # the reference tests' claims (tests/test_distributed.py)
    times = [runs[(p, "barrier")][0].sim_time for p in plans if p.startswith(("none", "sleep"))]
    check(all(x < y for x, y in zip(times, times[1:])),
          f"faults: barrier time does not grow with the sleep: {times}")
    for s in FAULT_SLEEPS:
        w, n, b = (runs[(f"sleep {s:g}", x)][0].sim_time
                   for x in ("waitfree", "nosync", "barrier"))
        check(w < b and n <= b, f"faults: at sleep {s:g} waitfree {w} or nosync "
              f"{n} not below barrier {b}")
    for k in FAULT_FAILED:
        name = f"{k} failed"
        check(runs[(name, "waitfree")][1], f"faults: waitfree did not finish, {name}")
        check(not runs[(name, "barrier")][1] and not runs[(name, "nosync")][1],
              f"faults: barrier or nosync finished with {name}")
        r = runs[(name, "waitfree")][0]
        check(sum(r.work_done.values()) == r.iterations * FAULT_P,
              f"faults: waitfree with {name} left partitions unswept")
        check(all(r.work_done[w] <= FAULT_FAIL_AT - 1 for w in range(k)),
              f"faults: a failed worker swept after its failure ({name})")

    print(f"faults: Fig 8/9 table, full webStanford, p={FAULT_P}, threshold "
          f"{FAULT_THRESHOLD:g}; sim_time (iterations), '-' where the run did not "
          f"converge", flush=True)
    print(f"faults: {'plan':10s} {'barrier':>14s} {'nosync':>14s} {'waitfree':>14s}")
    for plan_name in plans:
        cells = []
        for disc in ("barrier", "nosync", "waitfree"):
            a, converged, _ = runs[(plan_name, disc)]
            cells.append(f"{a.sim_time:g} ({a.iterations})" if converged
                         else f"- ({a.iterations})")
        print(f"faults: {plan_name:10s} " + " ".join(f"{c:>14s}" for c in cells))
    print(f"faults: simulate walls, card {walls['card']:.1f}s, CPU "
          f"{walls['cpu']:.1f}s, over {len(runs)} runs each", flush=True)


def flash_design(bf16: bool, lib=None) -> str:
    """The kernel that flash_attention_fwd launches for the dtype, as the
    built library (``lib``, else the port's) reports it."""
    from repro_torch.kernels.flash_attention import build

    if bf16:
        terms = build.kernel_info(128, True, lib)["p_terms"]
        return f"bf16: wgmma on the tensor cores, P as {terms} bf16 terms"
    return "f32: FMAs on the CUDA cores"


def plain_attention(q, k, v, causal, window):
    """The kernel's plain version on ``q, k, v`` in their dtype (scores in
    float32, or float64 for float64 inputs); in PLAIN_CHUNK-row q-chunks
    (as the models' plain route) where one call's scores would pass
    PLAIN_SCORE_BYTES."""
    from repro_torch.kernels.flash_attention import attention_ref

    b, hq, sq, dh = q.shape
    score_bytes = max(4, q.element_size())
    step = sq if b * hq * sq * k.shape[2] * score_bytes <= PLAIN_SCORE_BYTES else PLAIN_CHUNK
    return torch.cat([attention_ref(q[:, :, i:i + step], k, v, scale=dh**-0.5, causal=causal,
                                    window=window, q_offset=i)
                      for i in range(0, sq, step)], dim=2)


def flash_ref(q, k, v, causal, window):
    """The plain version's result on ``q, k, v`` cast up: for bfloat16
    inputs its float32 result (the bf16 bound and differ share are defined
    against it); for float32 inputs its float64 result.  The float32 plain
    version's own rounding nearly fills FLASH_RTOL's bound at the long
    windowed rows of starcoder2-3b's and mixtral-8x22b's prefill shapes,
    so against it the check could not tell a right float32 kernel from a
    wrong one there; at each timed shape the flash phase prints the float32
    plain result's own reading against float64, and the kernel's against
    the float32 plain result."""
    if q.dtype == torch.float32:
        return plain_attention(q.double(), k.double(), v.double(), causal, window)
    return plain_attention(q.float(), k.float(), v.float(), causal, window)


def flash_agreement(out, ref) -> tuple[float, float, int]:
    """Max abs error of ``out`` against ``ref`` (:func:`flash_ref`), the
    worst entry over its bound: 1e-5·(|ref| + mean|ref| of its row) for a
    float32 ``out`` (against the float64 plain result) or a bfloat16 one
    (against the float32 plain result), plus 2⁻⁸·|ref| (one rounding to
    bfloat16) for a bfloat16 ``out``; and for a bfloat16 ``out`` the count
    of entries that differ from ``ref`` rounded to bfloat16 (0 for
    float32).  A row is the dh values of one (batch, head, query)."""
    err = (out.float() - ref).abs()
    mag = ref.abs()
    bound = FLASH_RTOL * (mag + mag.mean(dim=-1, keepdim=True))
    differ = 0
    if out.dtype == torch.bfloat16:
        bound += BF16_ROUNDING * mag
        differ = int((out != ref.to(torch.bfloat16)).sum())
    return float(err.max()), float((err / bound).max()), differ


def _qkv(dev, dtype, b, hq, hkv, sq, sk, dh, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            for shape in ((b, hq, sq, dh), (b, hkv, sk, dh), (b, hkv, sk, dh))]


def flash_cases() -> list[tuple]:
    """(shape (b, hq, hkv, sq, sk, dh), dtype, causal, window) of the flash
    check; case i draws its inputs from seed i: the reference's test
    matrix (18, f32 then bf16), then 14 ragged cases at dh 32, then 20 at
    dh 80, stablelm-3b's head dim (GQA and MHA x causal / window 64 / full
    at s 256, and 4 ragged; f32 then bf16)."""
    cases = [((2, hq, hkv, 256, 256, 64), dtype, causal, window)
             for dtype in (torch.float32, torch.bfloat16)
             for hq, hkv in ((4, 4), (4, 2), (8, 1))
             for causal, window in ((True, None), (True, 64), (False, None))]
    cases += [((2, 4, 2, sq, sk, 32), dtype, causal, window)
              for dtype in (torch.float32, torch.bfloat16)
              for sq, sk, causal, window in (
                  (200, 200, True, None), (200, 200, True, 64), (200, 200, False, None),
                  (96, 160, True, None), (160, 96, True, None), (96, 160, False, 48),
                  (1, 37, False, None))]
    cases += [((2, hq, hkv, sq, sk, 80), dtype, causal, window)
              for dtype in (torch.float32, torch.bfloat16)
              for (hq, hkv), sq, sk, causal, window in (
                  *[(heads, 256, 256, c, w) for heads in ((8, 2), (4, 4))
                    for c, w in ((True, None), (True, 64), (False, None))],
                  ((8, 2), 200, 200, True, 48), ((4, 4), 96, 160, False, None),
                  ((8, 2), 160, 96, True, None), ((4, 4), 1, 37, False, None))]
    return cases


def flash_tag(shape) -> str:
    """The group of :func:`flash_cases` a case's shape belongs to."""
    if shape[-1] == 80:
        return "dh80"
    return "matrix" if shape[3] == 256 else "ragged"


def check_differ_share(what: str, differ: int, total: int) -> float:
    share = differ / total
    check(share <= BF16_DIFFER_SHARE,
          f"flash_attention bf16 {what}: {differ} of {total} entries ({share:.3e}) "
          f"differ from the f32 plain result rounded to bf16, over {BF16_DIFFER_SHARE:g}")
    return share


def flash_kernel_phase(dev):
    """The kernel against its plain version over the reference's test
    matrix, ragged lengths and head dim 80, each entry within its bound;
    then at the prefill shapes of FLASH_TIMED (whisper-medium's encoder
    without the causal mask), checked and timed beside the plain version,
    SDPA and the bound."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        build, flash_attention, launch_counts, reset_launch_counts,
    )

    cases = flash_cases()
    tags = ("matrix", "ragged", "dh80")
    worst = dict.fromkeys(tags, 0.0)
    differ = {tag: [0, 0] for tag in tags}  # bf16 entries: differing, all
    count = dict.fromkeys(tags, 0)
    for i, (shape, dtype, causal, window) in enumerate(cases):
        q, k, v = _qkv(dev, dtype, *shape, seed=i)
        out = flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        _, ratio, n_differ = flash_agreement(out, flash_ref(q, k, v, causal, window))
        tag = flash_tag(shape)
        check(ratio <= 1.0, f"flash_attention {tag} {shape} {dtype} causal={causal} "
              f"window={window}: worst entry at {ratio:.3f}x its bound")
        worst[tag] = max(worst[tag], ratio)
        count[tag] += 1
        if dtype == torch.bfloat16:
            differ[tag][0] += n_differ
            differ[tag][1] += out.numel()
    share = {tag: check_differ_share(f"{tag} cases", *counts)
             for tag, counts in differ.items()}
    print(f"kernel flash_attention: {len(cases)} cases agree with the plain version "
          f"({count['matrix']} of the reference's test matrix, b 2, s 256, dh 64, worst "
          f"entry {worst['matrix']:.3f}x its bound; {count['ragged']} ragged, dh 32, "
          f"worst {worst['ragged']:.3f}x; {count['dh80']} at dh 80, GQA and MHA, causal, "
          f"window, full and ragged, worst {worst['dh80']:.3f}x); bounds: f32 "
          f"{FLASH_RTOL:g}*(|ref| + row mean|ref|) against the f64 plain result, bf16 that "
          f"+ 2^-8*|ref| against the f32 plain result; bf16 entries that differ from the "
          f"f32 plain result rounded to bf16: " + ", ".join(f"{tag} {differ[tag][0]} of {differ[tag][1]} "
                                f"({share[tag]:.3e})" for tag in tags)
          + f", limit {BF16_DIFFER_SHARE:g}", flush=True)

    stats = {}
    for name, (b, hq, hkv, s, dh), windows, causal in FLASH_TIMED:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = _qkv(dev, dtype, b, hq, hkv, s, s, dh, seed=7)
            for window in windows:
                reset_launch_counts()
                out = flash_attention(q, k, v, causal=causal, window=window)
                torch.cuda.synchronize()
                ref = flash_ref(q, k, v, causal, window)
                err, ratio, n_differ = flash_agreement(out, ref)
                check(ratio <= 1.0, f"flash_attention {dtype} window={window} at "
                      f"{name}'s shape: worst entry at {ratio:.3f}x its bound")
                bf16 = dtype == torch.bfloat16
                differ = ""
                if not bf16:  # the float32 plain result's own reading, and the kernel's on it
                    plain32 = plain_attention(q, k, v, causal, window)
                    differ = (f" against the float64 plain result (the float32 plain "
                              f"result's worst entry {flash_agreement(plain32, ref)[1]:.3f}x; the "
                              f"kernel's against the float32 plain result "
                              f"{flash_agreement(out, plain32)[1]:.3f}x);")
                    del plain32
                del ref
                if bf16:
                    share = check_differ_share(f"window={window} at {name}'s shape",
                                               n_differ, out.numel())
                    differ = (f" {n_differ} of {out.numel()} entries ({share:.3e}) differ "
                              f"from the f32 plain result rounded to bf16;")
                check(torch.equal(out, flash_attention(q, k, v, causal=causal, window=window)),
                      "flash_attention is not deterministic")

                def kern():
                    return flash_attention(q, k, v, causal=causal, window=window)

                def plain():
                    return plain_attention(q, k, v, causal, window)

                st = dict(max_abs_err=err, ratio=ratio, ms=time_ms(kern, 20),
                          plain_ms=time_ms(plain, 3, warmup=1), library_ms=None)
                launches = launch_counts()["flash_attention"]
                # one library call for either mask: is_causal, or the causal
                # sliding window as an explicit (sq, sk) boolean band
                mask = None
                if window is not None:
                    dist = (torch.arange(s, device=dev)[:, None]
                            - torch.arange(s, device=dev)[None, :])
                    mask = (dist >= 0) & (dist < window)
                    del dist

                def sdpa():
                    return F.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask, is_causal=causal and mask is None,
                        scale=dh**-0.5, enable_gqa=True)

                lib_err = float((sdpa().float() - out.float()).abs().max())
                st["library_ms"] = time_ms(sdpa, 20)
                lib = (f"{st['library_ms']:.4f} (scaled_dot_product_attention"
                       f"{'' if mask is None else ' with a band mask'}, max abs diff to "
                       f"the kernel {lib_err:.3e})")
                del mask
                st["bound_ms"], st["bound_by"], flops, nbytes = flash_bound(q, k, causal, window)
                # the kernel's own tensor-core work: Q·Kᵀ once, P·V once per
                # P term, over the tile's width (128 columns at dh 80)
                terms = build.kernel_info(dh, True)["p_terms"]
                width = -(-dh // 64) * 64 if dh > 64 else dh
                floor_ms = flops * (1 + terms * width / dh) / 2 / BF16_TC_FLOPS * 1e3
                floor = f", its own tensor-core floor {floor_ms:.4f} ms" if bf16 else ""
                live = attention_pairs(s, s, causal, window)
                pairs = f"{live} live (q, k) pairs a head{'' if causal else ' (no causal mask)'}"
                if window is not None:
                    every = attention_pairs(s, s, causal, None)
                    check(live < every, f"window {window} at s {s} masks no causal pair")
                    pairs += f" of {every} causal ({1 - live / every:.4f} outside the window)"
                plain_how = ("" if b * hq * s * s * 4 <= PLAIN_SCORE_BYTES
                             else f" in {PLAIN_CHUNK}-row q-chunks")
                print(f"kernel flash_attention {str(dtype)[6:]} causal={causal} "
                      f"window={window} at {name}'s shape (b {b}, hq {hq}, hkv {hkv}, s {s}, "
                      f"dh {dh}; {flash_design(bf16)}): max_abs_err={err:.3e} worst entry "
                      f"at {ratio:.3f}x its bound;{differ} ms={st['ms']:.4f} plain_ms="
                      f"{st['plain_ms']:.4f}{plain_how} library_ms={lib} bound_ms="
                      f"{st['bound_ms']:.4f} ({st['bound_by']}: {flops:.3e} flop, "
                      f"{nbytes / 1e6:.1f} MB{floor}; {pairs}) achieved "
                      f"{flops / st['ms'] / 1e9:.1f} TFLOP/s; launches={launches} (check, "
                      f"repeat and timing)", flush=True)
                stats[(name, dtype, window)] = st
            del q, k, v, out
    return stats


def logits_worst(out, ref, rtol) -> float:
    """Worst entry of |out − ref| over rtol·(|ref| + mean|ref| of its row),
    computed in place (``out`` is consumed)."""
    mag = ref.abs()
    mag += mag.mean(dim=-1, keepdim=True)
    return float(out.sub_(ref).abs_().div_(mag.mul_(rtol)).max())


def first_layers(cfg, params, n_layers: int):
    """The first ``n_layers`` layers of ``params`` as a model of their own
    (its config and the module), sharing its tensors: no copy, and each
    parameter in its own dtype (an MoE router stays float32 in a bf16
    model)."""
    import dataclasses

    from repro_torch.models.model import DecoderLM

    sub = dataclasses.replace(cfg, n_layers=n_layers)
    state = {k: t for k, t in params.state_dict().items()
             if not k.startswith("layers.") or int(k.split(".")[1]) < n_layers}
    model = DecoderLM(sub, device="meta")
    model.load_state_dict(state, assign=True)
    return sub, model


def attention_layers(cfg) -> int:
    """Attention layers a prefill runs: every layer of a decoder, each
    application of a hybrid's shared block, none in a pure SSM."""
    if cfg.hybrid_attn_every:
        return cfg.n_layers // cfg.hybrid_attn_every
    return 0 if cfg.ssm is not None else cfg.n_layers


def device_launches(rows) -> int:
    """Device ops (kernels, copies, sets) in a trace's device rows."""
    return 0 if rows is None else sum(e.count for e in rows)


SCAN_LABEL = "ssm scan"


def labelled_trace(fn, scan_name: str):
    """Run ``fn`` once under the profiler with ``ssm.<scan_name>`` inside a
    ``record_function`` range.  Returns the traced wall in ms, the device
    rows by self time without the range's own (None when the trace holds
    no device time: not measured), and the scans' device ms, device ops
    and host ms, every call summed.  Their device time is taken from the
    kernels launched inside the ranges, where a trace of the scan alone
    (a few milliseconds of work on Mamba-2) may hold no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import ssm

    scan = getattr(ssm, scan_name)

    def labelled(*args, **kw):
        with record_function(SCAN_LABEL):
            return scan(*args, **kw)

    def ops_under(e) -> int:
        return len(e.kernels) + sum(ops_under(c) for c in e.cpu_children)

    setattr(ssm, scan_name, labelled)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        setattr(ssm, scan_name, scan)
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.key != SCAN_LABEL]
    ranges = [e for e in prof.events()
              if e.name == SCAN_LABEL and e.device_type == DeviceType.CPU]
    scans = {"ms": sum(e.device_time_total for e in ranges) / 1e3,
             "ops": sum(ops_under(e) for e in ranges),
             "host_ms": sum(e.cpu_time_total for e in ranges) / 1e3}
    if not rows:
        return wall_ms, None, scans
    rows.sort(key=lambda e: -e.self_device_time_total)
    return wall_ms, rows, scans


def ssm_trace(arch: str, cfg, params, toks, trace_layers: int | None):
    """The bf16 prefill of an SSM or hybrid model traced once, its scans
    labelled (:func:`labelled_trace`; on its first ``trace_layers`` layers
    where a full prefill's ops are more than the profiler records in
    reasonable time), then one SSM layer alone (``ssm_block_apply`` of
    layer 0 on the embedded tokens), labelled the same way and run often
    enough in one trace for ~50 ms of device work: a trace of a few
    milliseconds may lose its device events.  Prints the trace; one
    layer's device ops and time and its scan's, with the scan's device
    time over its host time (below 1: its launches bound it); the device
    ops a prefill at full depth and the scan's share of its device time,
    a cut prefill's extrapolated by one layer for each layer left out."""
    from repro_torch.models.blocks import ssm_block_apply
    from repro_torch.models.model import forward

    name = f"{cfg.ssm.variant}_scan"
    sub_cfg, sub = (cfg, params) if trace_layers is None else first_layers(cfg, params,
                                                                           trace_layers)
    wall_ms, rows, scans = labelled_trace(lambda: forward(sub_cfg, sub, toks), name)
    busy_ms = None if rows is None else sum(e.self_device_time_total for e in rows) / 1e3
    route = "kernel route" if attention_layers(cfg) else "no attention"
    cut = "" if trace_layers is None else f", first {trace_layers} of {cfg.n_layers} layers"
    print_trace(f"lm prefill {arch} (bf16, {route}{cut})", wall_ms, busy_ms, rows, top=8,
                extra=f"device ops={device_launches(rows)} ")
    if rows is None or not scans["ops"]:
        print(f"lm: {arch} scan share: not measured (the prefill's trace held no device event "
              f"of {'it' if rows is None else 'its scans'})")
        return
    reps = max(1, int(50 // (busy_ms / len(sub.layers))))
    x = params.embed[toks.long()]

    def layers():
        for _ in range(reps):
            ssm_block_apply(params.layers[0], cfg, x)

    _, layer_rows, layer_scans = labelled_trace(layers, name)
    del x
    layer = None
    if layer_rows is not None and layer_scans["ops"]:
        layer = {"n": device_launches(layer_rows) / reps,
                 "busy": sum(e.self_device_time_total for e in layer_rows) / 1e3 / reps,
                 **{k: v / reps for k, v in layer_scans.items()}}
        print(f"lm: {arch} one SSM layer (b={toks.shape[0]}, s={toks.shape[1]}; {reps} traced "
              f"in one run): {layer['n']:.1f} device ops, busy {layer['busy']:.3f} ms; its "
              f"{name}: {layer['ops']:.1f} device ops, {layer['ms']:.3f} ms on the device "
              f"against {layer['host_ms']:.3f} ms on the host, traced (ratio "
              f"{layer['ms'] / layer['host_ms']:.3f}: above 1 the device bounds it, below 1 "
              f"its launches)", flush=True)
    extra = len(params.layers) - len(sub.layers)  # layers the cut left out
    if extra and layer is None:
        print(f"lm: {arch} scan share: not measured (the layer's trace held no device event "
              f"of it or its scan)")
        return
    launches = device_launches(rows) + (extra * layer["n"] if extra else 0)
    scan_ops = scans["ops"] + (extra * layer["ops"] if extra else 0)
    busy = busy_ms + (extra * layer["busy"] if extra else 0)
    scan_ms = scans["ms"] + (extra * layer["ms"] if extra else 0)
    print(f"lm: {arch} bf16 prefill at all {cfg.n_layers} layers: {launches:.0f} device ops "
          f"({scan_ops:.0f} in the scan, {scan_ops / launches:.3f}); the scan's share of the "
          f"device time {scan_ms / busy:.3f} ({scan_ms:.3f} of {busy:.3f} ms"
          f"{'' if not extra else ', the cut extrapolated by one layer each'})", flush=True)


@contextlib.contextmanager
def recorded_routing():
    """Record every MoE routing made inside, layer after layer: a list of
    (experts ``(T, K)`` sorted, gate margin ``(T,)``), the margin being a
    token's K-th softmax weight less its (K+1)-th (how near its top-k set
    came to another).  Wraps ``repro_torch.models.mlp.moe_route``, which
    both dispatches call."""
    from repro_torch.models import mlp

    route = mlp.moe_route
    calls = []

    def recorded(params, xf, top_k):
        topw, topi = route(params, xf, top_k)
        w = torch.topk(torch.softmax(xf.float() @ params.router, dim=-1), top_k + 1).values
        calls.append((topi.sort(dim=-1).values, w[:, top_k - 1] - w[:, top_k]))
        return topw, topi

    mlp.moe_route = recorded
    try:
        yield calls
    finally:
        mlp.moe_route = route


def routing_differs(ref, other) -> torch.Tensor:
    """Tokens whose top-k set differs in some layer between two runs'
    routings (lists of :func:`recorded_routing`)."""
    return torch.stack([(ei != ej).any(dim=-1)
                        for (ei, _), (ej, _) in zip(ref, other, strict=True)]).any(dim=0)


def routing_flips(what: str, ref, other) -> tuple[torch.Tensor, str]:
    """Tokens whose top-k set differs between two runs' routings (lists of
    :func:`recorded_routing`, layer by layer).  A token that first flips in
    a layer must have come within FLIP_MARGIN of a tie there (its margin in
    ``ref``); later layers see its changed state, so only first flips are
    held.  Returns the flipped tokens (any layer) and a per-layer summary:
    flips, first flips with their largest margin, the smallest margin of
    any token."""
    flipped = torch.zeros_like(ref[0][1], dtype=torch.bool)
    per_layer = []
    for layer, ((ei, mi), (ej, _)) in enumerate(zip(ref, other, strict=True)):
        now = (ei != ej).any(dim=-1)
        first = now & ~flipped
        worst = float(mi[first].max()) if bool(first.any()) else 0.0
        check(worst <= FLIP_MARGIN,
              f"{what}: layer {layer} routes {int(first.sum())} tokens to other experts, "
              f"one with a gate margin of {worst:.3e} > {FLIP_MARGIN:g}")
        flipped |= now
        per_layer.append(f"layer {layer}: {int(now.sum())} flipped ({int(first.sum())} first, "
                         f"largest margin {worst:.2e}), smallest margin {float(mi.min()):.2e}")
    return flipped, "; ".join(per_layer)


def token_rows(t: torch.Tensor, kept: torch.Tensor | None) -> torch.Tensor:
    """The token positions ``kept`` (dim 1) of ``t``; ``t`` itself, no
    copy, for None."""
    return t if kept is None else t[:, kept]


def dropped_pairs(cfg, routing) -> list[int]:
    """Pairs the sparse dispatch drops in each layer of a recorded prefill
    (:func:`recorded_routing`) at the default capacity: each expert's pairs
    past ``expert_capacity``."""
    from repro_torch.models.mlp import expert_capacity

    out = []
    for topi, _ in routing:
        cap = expert_capacity(topi.shape[0], cfg, 1.25)
        load = torch.bincount(topi.reshape(-1), minlength=cfg.moe.n_experts)
        out.append(int((load - cap).clamp_min(0).sum()))
    return out


def lm_phase(dev, arch: str, b: int, s: int, f32_layers: int | None = None,
             layers: int | None = None, trace_layers: int | None = None):
    """``arch`` at its published width from a seeded generator (its first
    ``layers`` layers where the published depth does not fit the card):
    bf16 prefill at (b, s) on the kernel route (flash_attention once per
    GQA layer or application of a hybrid's shared block, the main path;
    gemma2-2b's softcapped attention and deepseek-v2-236b's MLA none: the
    plain route, as in the reference; a pure SSM has no attention), its
    trace (an SSM's by :func:`ssm_trace`, on its first ``trace_layers``
    layers where given), and the plain route; float32 on the same weights
    (the first ``f32_layers`` layers where a float32 copy of all would not
    fit beside the bf16 model), kernel against plain route; the bf16 routes
    against the float32 forward; DECODE_STEPS float32 decode steps against
    prefill.

    An MoE arch's prefill runs the sparse dispatch, whose dropped pairs
    are counted; its checks run the dense dispatch (no drops), at b 1 for
    decode (where the sparse dispatch drops nothing either), and report
    the tokens whose experts differ between the compared runs
    (:func:`routing_flips`), leaving them out of the comparison.  Returns
    the prefill's flash launches, the float32 config and model, and the
    best wall of the timed kernel-route prefill (seconds)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import spmv
    from repro_torch.models.common import pad_vocab
    from repro_torch.models.model import DecoderLM, decode_step, forward, init_cache, init_params

    cfg = get_config(arch)
    published = cfg.n_layers
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    moe = cfg.moe is not None
    check(not moe or b == 1, f"{arch}: decode is checked against prefill at b 1 only")
    disp = "dense" if moe else "sparse"  # the dispatch of the checks
    attn_layers = attention_layers(cfg)
    kernel_route = cfg.attn_softcap is None and cfg.attn != "mla" and attn_layers > 0
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    window = "" if cfg.window is None else f" window {cfg.window}"
    ffn = (f"MoE {cfg.moe.n_experts} experts top {cfg.moe.top_k} of d_ff "
           f"{cfg.moe.d_ff_expert} (+{cfg.moe.n_shared} shared)" if moe else cfg.mlp)
    stack = (f"heads {cfg.n_heads}/{cfg.n_kv_heads} of {cfg.resolved_head_dim}, attn "
             f"{cfg.attn}{window}, {cfg.norm}, {ffn}")
    if cfg.ssm is not None:
        sc = cfg.ssm
        width = f"head dim {sc.headdim}" if sc.variant == "mamba2" else f"dt rank {sc.dt_rank}"
        ssm_desc = (f"{sc.variant} layers (state {sc.state}, conv {sc.conv}, expand "
                    f"{sc.expand}, {width}), {cfg.norm}")
        stack = (f"{ssm_desc}, a shared block after every {cfg.hybrid_attn_every} ({stack})"
                 if cfg.hybrid_attn_every else f"{ssm_desc}, no attention")
    print(f"lm: {arch} {cfg.n_layers} layers, d_model {cfg.d_model}, {stack}, {n_params} "
          f"parameters in {cfg.dtype}, random init in {time.perf_counter() - t0:.1f}s",
          flush=True)
    if layers is not None:
        per_layer = sum(p.numel() for p in params.layers[0].parameters())
        rest = n_params - layers * per_layer
        total = torch.cuda.get_device_properties(dev).total_memory
        print(f"lm: {arch} depth cut to {layers} of its {published} layers, full width: "
              f"{per_layer} parameters a layer ({2 * per_layer / 1e9:.2f} GB bf16), "
              f"embedding and head {rest} ({2 * rest / 1e9:.2f} GB); {layers} layers "
              f"{2 * n_params / 1e9:.1f} GB, all {published} "
              f"{2 * (published * per_layer + rest) / 1e9:.1f} GB, on a {total / 1e9:.1f} GB "
              f"card; the float32 checks on {f32_layers} layers, "
              f"{4 * (f32_layers * per_layer + rest) / 1e9:.1f} GB", flush=True)
    gen = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)
    n_tok = b * s

    forward(cfg, params, toks[:, :256])  # warm-up: load the kernel, plan the products
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    spmv.reset_launch_counts()
    fa.reset_launch_counts()
    walls = []
    t0 = time.perf_counter()
    bf16_kernel = forward(cfg, params, toks)  # the main path of the flash kernel
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
    launches = fa.launch_counts()["flash_attention"]
    want = attn_layers if kernel_route else 0
    check(launches == want, f"{arch} prefill launched flash_attention {launches} "
          f"times, expected {want} ({'one per attention layer' if kernel_route else 'plain route'})")
    check(all(n == 0 for n in spmv.launch_counts().values()), "prefill ran an spmv kernel")
    check(tuple(bf16_kernel.shape) == (b, s, pad_vocab(cfg.vocab))
          and bf16_kernel.dtype == torch.float32
          and bool(torch.isfinite(bf16_kernel).all()), f"{arch} prefill logits malformed")
    for _ in range(2):
        t0 = time.perf_counter()
        forward(cfg, params, toks)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    runs = ", ".join(f"{w:.4f}" for w in walls)
    if kernel_route:
        plain_walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            bf16_plain = forward(cfg, params, toks, use_flash_kernel=False)
            torch.cuda.synchronize()
            plain_walls.append(time.perf_counter() - t0)
        routes = (f"kernel route {n_tok / min(walls):.0f} tok/s (runs {runs} s), plain route "
                  f"{n_tok / min(plain_walls):.0f} tok/s (runs "
                  f"{', '.join(f'{w:.4f}' for w in plain_walls)} s)")
    else:  # softcapped attention, MLA or none: the plain route is the path, as in the reference
        bf16_plain = bf16_kernel
        why = ("no attention" if not attn_layers else "MLA" if cfg.attn == "mla"
               else "softcapped attention")
        routes = (f"plain route only ({why}, as the reference) "
                  f"{n_tok / min(walls):.0f} tok/s (runs {runs} s)")
    pairs = ""
    if cfg.attn == "swa":
        live, every = attention_pairs(s, s, True, cfg.window), attention_pairs(s, s, True, None)
        check(live < every, f"{arch}: the window masks nothing at s {s}")
        pairs = (f"; {live} of {every} causal (q, k) pairs a head live "
                 f"({1 - live / every:.4f} outside the window)")
    if cfg.ssm is not None:  # random weights at depth: how far the residual stream grew
        pairs += (f"; logits in [{float(bf16_kernel.min()):.3f}, {float(bf16_kernel.max()):.3f}],"
                  f" std {float(bf16_kernel.std()):.3f}")
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"lm: {arch} bf16 prefill b={b} s={s}: {routes}; flash_attention launches per "
          f"prefill {launches}; peak memory {peak / 2**30:.2f} GiB{pairs}", flush=True)
    if moe:
        from repro_torch.models.mlp import expert_capacity

        with recorded_routing() as routing:
            forward(cfg, params, toks)
        drops = dropped_pairs(cfg, routing)
        total_pairs = n_tok * cfg.moe.top_k
        print(f"lm: {arch} sparse dispatch at capacity factor 1.25 ("
              f"{expert_capacity(n_tok, cfg, 1.25)} slots an expert for {total_pairs} pairs "
              f"over {cfg.moe.n_experts} experts): dropped pairs by layer {drops}, "
              f"{sum(drops)} of {total_pairs * cfg.n_layers} "
              f"({sum(drops) / (total_pairs * cfg.n_layers):.4f})", flush=True)
        del routing
    if cfg.ssm is not None:
        ssm_trace(arch, cfg, params, toks, trace_layers)
    else:
        _, wall_ms, busy_ms, rows = traced(lambda: forward(cfg, params, toks))
        print_trace(f"lm prefill {arch} (bf16, {'kernel' if kernel_route else 'plain'} route)",
                    wall_ms, busy_ms, rows, top=10 if moe else 8)

    # float32 on the same weights, TF32 off; on the first f32_layers layers
    # where the f32 copy would not fit beside the bf16 model, whose other
    # layers are freed
    sub_cfg, sub = cfg, params
    cut = f32_layers is not None and f32_layers < cfg.n_layers
    if cut:
        del bf16_kernel, bf16_plain
        sub_cfg, sub = first_layers(cfg, params, f32_layers)
        del params
        total = torch.cuda.get_device_properties(dev).total_memory
        print(f"lm: {arch} float32 checks cut to the first {f32_layers} of {cfg.n_layers} "
              f"layers, full width (a float32 copy of every layer takes "
              f"{4 * n_params / 1e9:.1f} GB beside the bf16 {2 * n_params / 1e9:.1f} GB "
              f"on a {total / 1e9:.1f} GB card); the bf16 routes rerun on that cut",
              flush=True)
    bf16_routing = {}
    if cut or moe:
        with recorded_routing() as bf16_routing["kernel"]:
            bf16_kernel = forward(sub_cfg, sub, toks, moe_dispatch=disp)
        if kernel_route:
            with recorded_routing() as bf16_routing["plain"]:
                bf16_plain = forward(sub_cfg, sub, toks, moe_dispatch=disp,
                                     use_flash_kernel=False)
        else:
            bf16_plain, bf16_routing["plain"] = bf16_kernel, bf16_routing["kernel"]
    depth = f" ({sub_cfg.n_layers} layers)" if sub_cfg is not cfg else ""
    cfg32 = dataclasses.replace(sub_cfg, dtype="float32")
    params32 = DecoderLM(cfg32, device=dev)
    params32.load_state_dict(sub.state_dict())
    del sub
    with recorded_routing() as routing32:
        f32_plain = forward(cfg32, params32, toks, moe_dispatch=disp, use_flash_kernel=False)
    torch.cuda.synchronize()
    rows_kept = None  # an MoE arch's token positions compared (None: all)
    if kernel_route:
        with recorded_routing() as routing:
            f32_kernel = forward(cfg32, params32, toks, moe_dispatch=disp)
        torch.cuda.synchronize()
        flips = ""
        if moe:
            flipped, summary = routing_flips(f"{arch} f32 kernel vs plain route", routing32,
                                             routing)
            flips = (f"; dense dispatch, {int(flipped.sum())} tokens routed to other "
                     f"experts by the two routes, left out ({summary})")
            rows_kept = ~flipped
        diff = float(token_rows(f32_kernel - f32_plain, rows_kept).abs().max())
        worst = logits_worst(token_rows(f32_kernel, rows_kept), token_rows(f32_plain, rows_kept),
                             LOGIT_RTOL)
        del f32_kernel
        check(worst <= 1.0, f"{arch} f32 prefill: kernel route off the plain route, "
              f"worst entry {worst:.3f}x its bound")
        print(f"lm: {arch} f32 prefill{depth} b={b} s={s}: kernel vs plain route max abs "
              f"diff {diff:.3e}, worst entry {worst:.4f}x the bound {LOGIT_RTOL:g}*(|ref| "
              f"+ row mean|ref|); max|logits| {float(f32_plain.abs().max()):.3f}{flips}",
              flush=True)

    ref_arg = f32_plain.argmax(dim=-1)
    err = {}
    for route, logits in ((("kernel", bf16_kernel), ("plain", bf16_plain)) if kernel_route
                          else (("plain", bf16_plain),)):
        kept, flips = rows_kept, ""
        if moe:  # bf16 rounding moves gates by far more than FLIP_MARGIN
            flipped = routing_differs(routing32, bf16_routing[route])
            kept = ~flipped
            flips = f", {int(flipped.sum())} of {s} tokens routed otherwise than in f32 left out"
        agree = float(token_rows(logits.argmax(dim=-1) == ref_arg, kept).float().mean())
        err[route] = float(token_rows(logits.sub_(f32_plain), kept).abs_().mean())
        check(bool(np.isfinite(err[route])), f"{arch} bf16 {route} route: error not finite")
        print(f"lm: {arch} bf16 {route} route{depth} vs the f32 forward: argmax agreement "
              f"{agree:.4f}, mean |diff| {err[route]:.4e}{flips}", flush=True)
    del bf16_kernel, bf16_plain, f32_plain, ref_arg, bf16_routing
    if kernel_route:
        check(err["kernel"] <= BF16_ERR_RATIO * err["plain"],
              f"{arch} bf16 prefill: kernel route's mean error {err['kernel']:.4e} > "
              f"{BF16_ERR_RATIO}x the plain route's {err['plain']:.4e}")

    # decode: teacher-force DECODE_STEPS tokens through the cache in f32
    dtoks = toks[:, :DECODE_STEPS].contiguous()
    with recorded_routing() as routing32:
        full = forward(cfg32, params32, dtoks, moe_dispatch=disp)
    cache = init_cache(cfg32, b, DECODE_STEPS, device=dev)
    fa.reset_launch_counts()
    outs = []
    torch.cuda.synchronize()
    with recorded_routing() as routing:
        t0 = time.perf_counter()
        for t in range(DECODE_STEPS):
            logits, cache = decode_step(cfg32, params32, dtoks[:, t:t + 1], cache)
            outs.append(logits[:, 0])
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / DECODE_STEPS * 1e3
    check(fa.launch_counts()["flash_attention"] == 0, "decode launched the flash kernel")
    dec = torch.stack(outs, dim=1)
    kept, flips = None, ""
    if moe:  # the steps' routings (one token each), regrouped layer by layer
        by_layer = [routing[i::cfg32.n_layers] for i in range(cfg32.n_layers)]
        flipped, summary = routing_flips(
            f"{arch} f32 decode vs prefill", routing32,
            [(torch.cat([e for e, _ in calls]), torch.cat([m for _, m in calls]))
             for calls in by_layer])
        kept = ~flipped
        flips = (f"; sparse dispatch at b 1 against the dense prefill, "
                 f"{int(flipped.sum())} tokens routed otherwise, left out ({summary})")
    derr = token_rows(dec - full, kept).abs()
    dworst = float((derr / (DECODE_TOL + DECODE_TOL * token_rows(full, kept).abs())).max())
    check(dworst <= 1.0, f"{arch} decode off prefill: worst entry {dworst:.3f}x the bound")
    print(f"lm: {arch} f32 decode{depth} b={b}, {DECODE_STEPS} teacher-forced steps: "
          f"{step_ms:.2f} ms/step; logits vs prefill max abs err {float(derr.max()):.3e}, "
          f"worst entry {dworst:.4f}x the bound (atol = rtol = {DECODE_TOL:g}); "
          f"no kernel launched{flips}", flush=True)
    _, wall_ms, busy_ms, rows = traced(lambda: decode_step(cfg32, params32, dtoks[:, :1], cache))
    print_trace(f"lm decode step {arch} (f32)", wall_ms, busy_ms, rows,
                extra=f"device ops={device_launches(rows)} ")
    print(f"lm: {arch} peak memory from the prefill on "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.1f} GB", flush=True)
    return launches, cfg32, params32, min(walls)


def serve_full(arch: str) -> None:
    """The serve launcher at its full preset for ``arch``: bf16, 4 slots,
    max-len 64, 6 requests, 16 new tokens; every request finishes and no
    kernel runs on this path."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve

    fa.reset_launch_counts()
    rep = serve.run(["--arch", arch, "--preset", "full"])
    check(rep["finished"] == rep["requests"] == 6,
          f"serve {arch}: {rep['finished']} of {rep['requests']} requests finished")
    check(fa.launch_counts()["flash_attention"] == 0, "serving launched the flash kernel")
    print(f"lm: serve --arch {arch} --preset full (bf16, 4 slots, max-len 64): "
          f"{rep['finished']} of {rep['requests']} requests finished, "
          f"{rep['tokens']} tokens in {rep['wall_s']:.3f}s = "
          f"{rep['tokens'] / rep['wall_s']:.1f} tok/s; {rep['steps']} steps "
          f"({rep['wall_s'] / rep['steps'] * 1e3:.2f} ms each), {rep['decode_calls']} "
          f"decode calls with prefill ({rep['wall_s'] / rep['decode_calls'] * 1e3:.2f} "
          f"ms each); no kernel launched", flush=True)


def serve_phase(cfg32, params32):
    """qwen2-vl-2b through the serve launcher at its full preset
    (:func:`serve_full`), then :func:`serve_held` at the launcher's 4 slots
    and max-len 64 on ``params32``."""
    serve_full("qwen2-vl-2b")
    serve_held(cfg32, params32, 4, 64)


def serve_held(cfg32, params32, slots: int, max_len: int) -> None:
    """The serve launcher's requests and loop in float32 on ``params32``,
    with ``slots`` slots: every token the engine picks, at the end of a
    prompt or in a step, must be the argmax of ``forward`` over every
    token its slot was fed so far (a slot's cache keeps the prompts and
    pending tokens of every request it served, as in the reference), or
    within SERVE_TIE of it.  ``forward`` runs an MoE's dense dispatch: the
    decode steps' sparse one drops nothing at 1 slot (the MoE archs' case;
    at more, a slot's tokens take capacity from the others')."""
    from repro_torch.launch import serve
    from repro_torch.models.model import forward
    from repro_torch.serving import ServingEngine

    requests = 6
    eng = ServingEngine(cfg32, params32, batch_slots=slots, max_len=max_len, eos=-1)
    # the (slots,) tokens of every decode call, rebuilt from what the loop
    # sees: a submit feeds the prompt to its slot and every other slot's
    # pending token once per prompt token; a step feeds every slot's
    # pending token (an idle slot's included)
    fed = []
    pending = serve.draw_requests(requests, cfg32.vocab, 16)
    picks = []  # (slot, decode call, token)
    slot_of = {}
    done = 0
    while done < requests:
        while pending:
            before = eng.tokens[:, 0].tolist()
            if not eng.submit(pending[0]):
                break
            req = pending.pop(0)
            slot = next(i for i, r in enumerate(eng.requests) if r is req)
            slot_of[req.rid] = slot
            fed += [before[:slot] + [int(t)] + before[slot + 1:] for t in req.prompt]
            picks.append((slot, len(fed) - 1, int(eng.tokens[slot, 0])))
        fed.append(eng.tokens[:, 0].tolist())
        for rid, tok in eng.step():
            picks.append((slot_of[rid], len(fed) - 1, tok))
        done = requests - len(pending) - sum(r is not None for r in eng.requests)
    check(len(fed) <= max_len, f"serve f32: {len(fed)} decode calls wrap the "
          f"{max_len}-slot ring; forward over a slot's history no longer applies")
    ties = 0
    for slot in range(slots):
        hist = torch.tensor([[call[slot] for call in fed]], device=params32.embed.device)
        logits = forward(cfg32, params32, hist, moe_dispatch="dense")[0, :, :cfg32.vocab]
        top = torch.topk(logits, 2, dim=-1)
        for s, c, tok in picks:
            if s != slot:
                continue
            best, second = top.indices[c].tolist()
            gap = float(top.values[c, 0] - top.values[c, 1])
            tie = gap < SERVE_TIE
            check(tok == best or (tie and tok == second),
                  f"serve f32: slot {slot} picked {tok} at decode call {c}; forward's "
                  f"argmax over the slot's history is {best} (top-2 gap {gap:.3e})")
            ties += tie
    print(f"lm: serve f32 {cfg32.name} ({slots} slots, max-len {max_len}; the launcher's "
          f"requests and loop on the decode phase's weights): {len(picks)} picks over "
          f"{len(fed)} decode calls, each forward's argmax over its slot's history ({ties} "
          f"top-2 gaps under {SERVE_TIE:g})", flush=True)



def serve_finishes(cfg32, params32, slots: int, max_len: int = 64) -> None:
    """The serve launcher's 6 requests and loop in float32 on
    ``params32`` with ``slots`` slots: every request finishes with its 16
    tokens, and no kernel runs on this path."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve
    from repro_torch.serving import ServingEngine

    fa.reset_launch_counts()
    eng = ServingEngine(cfg32, params32, batch_slots=slots, max_len=max_len, eos=-1)
    pending = serve.draw_requests(6, cfg32.vocab, 16)
    admitted, steps = [], 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while len(admitted) < 6 or any(r is not None for r in eng.requests):
        while pending and eng.submit(pending[0]):
            admitted.append(pending.pop(0))
        eng.step()
        steps += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(all(r.done and len(r.out) == 16 for r in admitted),
          f"serve f32 {cfg32.name} at {slots} slots: a request did not finish")
    check(fa.launch_counts()["flash_attention"] == 0, "serving launched the flash kernel")
    print(f"lm: serve f32 {cfg32.name} ({slots} slots, max-len {max_len}): 6 of 6 requests "
          f"finished, 96 tokens in {wall:.3f}s over {steps} steps "
          f"({wall / steps * 1e3:.2f} ms each); no kernel launched", flush=True)


def moe_phase(dev) -> dict:
    """The MoE decoders (MOE_LMS) at their published widths, each cut in
    depth: :func:`lm_phase` (mixtral-8x22b's prefill launches
    flash_attention once a layer, deepseek-v2-236b's MLA none), then
    :func:`serve_held` at 1 slot and :func:`serve_finishes` at 4 on its
    float32 weights.  Returns the flash launches of each prefill that has
    them."""
    fa_paths = {}
    for arch, b, s, layers, f32_layers in MOE_LMS:
        torch.cuda.empty_cache()
        with phase_wall(f"moe {arch}"):
            n, cfg32, params32, _ = lm_phase(dev, arch, b, s, f32_layers, layers=layers)
            serve_held(cfg32, params32, 1, MOE_SERVE_LEN)
            serve_finishes(cfg32, params32, 4)
        del cfg32, params32
        if n:
            fa_paths[f"{arch} prefill"] = n
    return fa_paths


def ssm_phase(dev) -> dict:
    """The SSM and hybrid decoders (SSM_LMS) at their published widths and
    depths: :func:`lm_phase` (zamba2-2.7b's prefill launches
    flash_attention once per application of its shared block,
    falcon-mamba-7b's none), then :func:`serve_full`.  Returns the flash
    launches of each prefill that has them."""
    fa_paths = {}
    for arch, b, s, f32_layers, trace_layers in SSM_LMS:
        torch.cuda.empty_cache()
        with phase_wall(f"ssm {arch}"):
            n = lm_phase(dev, arch, b, s, f32_layers, trace_layers=trace_layers)[0]
            torch.cuda.empty_cache()
            serve_full(arch)
        if n:
            fa_paths[f"{arch} prefill"] = n
    return fa_paths


def whisper_phase(dev) -> int:
    """whisper-medium at its published width and depth (24 encoder and 24
    decoder layers, d_model 1024, 0.81 B parameters with the untied head),
    random bf16 from a seeded generator, b WHISPER_BATCH, 1,500 random
    frames, WHISPER_TOKENS decoder tokens: the prefill on the kernel route
    launches flash_attention once per encoder layer (not causal) and once
    per decoder layer (the main path), timed beside the plain route over
    three runs each and traced; a float32 copy, kernel route against
    plain route entry-wise; the bf16 routes against the float32 forward;
    DECODE_STEPS teacher-forced float32 decode steps through
    init_cross_cache against the prefill; serve --arch whisper-medium
    exits as the reference's does.  Returns the prefill's launches."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve
    from repro_torch.models.common import pad_vocab
    from repro_torch.models.model import (
        DecoderLM, decode_step, encode, forward, init_cache, init_cross_cache, init_params,
    )

    arch = "whisper-medium"
    cfg = get_config(arch)
    b, s, n_frames = WHISPER_BATCH, WHISPER_TOKENS, cfg.encoder.n_frames
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"lm: {arch} {cfg.encoder.n_layers} encoder + {cfg.n_layers} decoder layers, "
          f"d_model {cfg.d_model}, heads {cfg.n_heads} of {cfg.resolved_head_dim}, "
          f"{cfg.norm}, {cfg.mlp}, sinusoidal positions, {n_params} parameters in "
          f"{cfg.dtype}, random init in {time.perf_counter() - t0:.1f}s", flush=True)
    gen = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)
    frames = torch.randn((b, n_frames, cfg.d_model), generator=gen, device=dev)
    forward(cfg, params, toks[:, :64], frames=frames)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fa.reset_launch_counts()
    walls = []
    for i in range(3):
        t0 = time.perf_counter()
        bf16_kernel = forward(cfg, params, toks, frames=frames)  # the main path
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if i == 0:
            launches = fa.launch_counts()["flash_attention"]
    want = cfg.encoder.n_layers + cfg.n_layers
    check(launches == want, f"{arch} prefill launched flash_attention {launches} times, "
          f"expected {want} (one per encoder and decoder layer)")
    check(tuple(bf16_kernel.shape) == (b, s, pad_vocab(cfg.vocab))
          and bool(torch.isfinite(bf16_kernel).all()), f"{arch} prefill logits malformed")
    plain_walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        bf16_plain = forward(cfg, params, toks, frames=frames, use_flash_kernel=False)
        torch.cuda.synchronize()
        plain_walls.append(time.perf_counter() - t0)
    n_in = b * (n_frames + s)
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"lm: {arch} bf16 prefill b={b}, {n_frames} frames, {s} tokens: kernel route "
          f"{n_in / min(walls):.0f} frames+tokens/s, {b * s / min(walls):.0f} tok/s (runs "
          f"{', '.join(f'{w:.4f}' for w in walls)} s), plain route "
          f"{n_in / min(plain_walls):.0f} frames+tokens/s (runs "
          f"{', '.join(f'{w:.4f}' for w in plain_walls)} s); flash_attention launches per "
          f"prefill {launches} ({cfg.encoder.n_layers} not causal, {cfg.n_layers} causal); "
          f"peak memory {peak / 2**30:.2f} GiB", flush=True)
    _, wall_ms, busy_ms, rows = traced(lambda: forward(cfg, params, toks, frames=frames))
    extra = ""
    if rows is not None:
        flash_ms = sum(e.self_device_time_total for e in rows if "flash" in e.key) / 1e3
        extra = f"flash_share={flash_ms / busy_ms:.3f} ({flash_ms:.3f} ms) "
    print_trace(f"lm prefill {arch} (bf16, kernel route)", wall_ms, busy_ms, rows,
                extra=extra, top=8)

    # float32 on the same weights, every layer (3.2 GB), TF32 off
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = DecoderLM(cfg32, device=dev)
    params32.load_state_dict(params.state_dict())
    del params
    f32_plain = forward(cfg32, params32, toks, frames=frames, use_flash_kernel=False)
    f32_kernel = forward(cfg32, params32, toks, frames=frames)
    torch.cuda.synchronize()
    diff = float((f32_kernel - f32_plain).abs().max())
    worst = logits_worst(f32_kernel, f32_plain, LOGIT_RTOL)
    del f32_kernel
    check(worst <= 1.0, f"{arch} f32 prefill: kernel route off the plain route, worst "
          f"entry {worst:.3f}x its bound")
    print(f"lm: {arch} f32 prefill b={b}: kernel vs plain route max abs diff {diff:.3e}, "
          f"worst entry {worst:.4f}x the bound {LOGIT_RTOL:g}*(|ref| + row mean|ref|); "
          f"max|logits| {float(f32_plain.abs().max()):.3f}", flush=True)
    ref_arg = f32_plain.argmax(dim=-1)
    err = {}
    for route, logits in (("kernel", bf16_kernel), ("plain", bf16_plain)):
        agree = float((logits.argmax(dim=-1) == ref_arg).float().mean())
        err[route] = float(logits.sub_(f32_plain).abs_().mean())
        check(bool(np.isfinite(err[route])), f"{arch} bf16 {route} route: error not finite")
        print(f"lm: {arch} bf16 {route} route vs the f32 forward: argmax agreement "
              f"{agree:.4f}, mean |diff| {err[route]:.4e}", flush=True)
    del bf16_kernel, bf16_plain, f32_plain, ref_arg
    check(err["kernel"] <= BF16_ERR_RATIO * err["plain"],
          f"{arch} bf16 prefill: kernel route's mean error {err['kernel']:.4e} > "
          f"{BF16_ERR_RATIO}x the plain route's {err['plain']:.4e}")

    # decode: the cross K/V once, then DECODE_STEPS teacher-forced f32 steps
    dtoks = toks[:, :DECODE_STEPS].contiguous()
    full = forward(cfg32, params32, dtoks, frames=frames)
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    cache = init_cache(cfg32, b, DECODE_STEPS, device=dev)
    cache["cross"] = init_cross_cache(cfg32, params32, encode(cfg32, params32, frames))
    torch.cuda.synchronize()
    cross_ms = (time.perf_counter() - t0) * 1e3
    launches_encode = fa.launch_counts()["flash_attention"]
    fa.reset_launch_counts()
    outs = []
    t0 = time.perf_counter()
    for t in range(DECODE_STEPS):
        logits, cache = decode_step(cfg32, params32, dtoks[:, t:t + 1], cache)
        outs.append(logits[:, 0])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / DECODE_STEPS * 1e3
    check(fa.launch_counts()["flash_attention"] == 0, "decode launched the flash kernel")
    dec = torch.stack(outs, dim=1)
    derr = (dec - full).abs()
    dworst = float((derr / (DECODE_TOL + DECODE_TOL * full.abs())).max())
    check(dworst <= 1.0, f"{arch} decode off prefill: worst entry {dworst:.3f}x the bound")
    print(f"lm: {arch} f32 decode b={b}, {DECODE_STEPS} teacher-forced steps through the "
          f"cross cache (encoder and cross K/V of {cfg.n_layers} layers once: "
          f"{cross_ms:.1f} ms, {launches_encode} flash launches): {step_ms:.2f} ms/step; "
          f"logits vs prefill max abs err {float(derr.max()):.3e}, worst entry "
          f"{dworst:.4f}x the bound (atol = rtol = {DECODE_TOL:g}); no kernel launched",
          flush=True)
    _, wall_ms, busy_ms, rows = traced(lambda: decode_step(cfg32, params32, dtoks[:, :1], cache))
    print_trace(f"lm decode step {arch} (f32)", wall_ms, busy_ms, rows,
                extra=f"device ops={device_launches(rows)} ")
    del params32, cache, full, dec
    try:
        serve.run(["--arch", arch, "--preset", "full"])
    except SystemExit as exc:
        print(f"lm: serve --arch {arch} --preset full exits as the reference's: {exc}",
              flush=True)
    else:
        check(False, f"serve --arch {arch} served: the engine passes no frames")
    return launches


def train_phase(dev) -> dict:
    """The training launcher (repro_torch.launch.train.run) on the card:
    stablelm-3b at --preset full (32 layers, d_model 2560, 2.8 B
    parameters in bf16, float32 AdamW moments) for TRAIN_STEPS sync steps
    at seq 256, global batch 8: every loss and gradient norm finite, every
    parameter moved, no flash launch (training takes the plain route),
    seconds a step and peak memory, and AdamW's share of a step from
    adamw_update timed alone on the same weights; whisper-medium at
    --preset 100m for 2 steps; local SGD at --preset tiny over 2 replicas
    of 2 inner steps, the replicas equal after the sync; --preset 100m
    with --ckpt-dir (a temporary directory under build/, deleted after):
    4 steps checkpointed every 2, then a run of 0 steps restores LATEST
    and saves it again bit for bit, then a run resumes from it; last, one
    train step at stablelm-3b's reduced float32 config on the card and on
    the CPU from the same weights.  Returns the full preset's median
    seconds a step (``step_s``, after the first) and ``adamw_update``'s
    milliseconds (``opt_ms``)."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch.checkpoint import restore_arrays
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train
    from repro_torch.models.model import DecoderLM
    from repro_torch.training import AdamWConfig, adamw_update, init_train_state, make_train_step

    def launched(argv):
        fa.reset_launch_counts()
        rep = train.run(argv)
        check(fa.launch_counts()["flash_attention"] == 0,
              f"train {' '.join(argv)} launched the flash kernel")
        check(bool(np.all(np.isfinite(rep["losses"] + rep["grad_norms"]))),
              f"train {' '.join(argv)}: a loss or norm is not finite")
        return rep

    full = ["--arch", TRAIN_ARCH, "--preset", "full", "--steps", str(TRAIN_STEPS)] + TRAIN_ARGV
    torch.cuda.empty_cache()
    rep = launched(full)
    n_tensors = len(list(DecoderLM(get_config(TRAIN_ARCH), device="meta").parameters()))
    check(rep["changed"] == n_tensors,
          f"train {TRAIN_ARCH}: {rep['changed']} of {n_tensors} parameters moved")
    torch.cuda.empty_cache()
    # AdamW alone on the same weights, gradients drawn once
    cfg = get_config(TRAIN_ARCH)
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    params = dict(state.params.named_parameters())
    gen = torch.Generator(device=dev).manual_seed(2)
    grads = {k: torch.randn(p.shape, generator=gen, device=dev).to(p.dtype) * 1e-3
             for k, p in params.items()}
    opt = [state.opt]

    def update():
        opt[0], _ = adamw_update(AdamWConfig(), params, grads, opt[0])

    opt_ms = time_ms(update, 3, warmup=1)
    del state, params, grads, opt
    torch.cuda.empty_cache()
    step_s = statistics.median(rep["step_s"][1:])
    print(f"train: {TRAIN_ARCH} --preset full ({rep['params']} parameters, bf16 weights and "
          f"gradients, float32 m and v), seq 256, global batch 8, loss chunks of 128: "
          f"{TRAIN_STEPS} sync steps, losses {', '.join(f'{x:.4f}' for x in rep['losses'])}, "
          f"gradient norms {', '.join(f'{x:.3f}' for x in rep['grad_norms'])}; seconds a "
          f"step {', '.join(f'{x:.3f}' for x in rep['step_s'])} (median after the first "
          f"{step_s:.3f}); peak memory {rep['peak_mem'] / 1e9:.1f} GB; adamw_update alone "
          f"{opt_ms:.1f} ms ({opt_ms / 1e3 / step_s:.3f} of a step); all {n_tensors} "
          f"parameters moved; no flash launch", flush=True)

    rep = launched(["--arch", "whisper-medium", "--preset", "100m", "--steps", "2"] + TRAIN_ARGV)
    print(f"train: whisper-medium --preset 100m ({rep['params']} parameters, 6 encoder layers "
          f"of 256 frames of ones): losses {', '.join(f'{x:.4f}' for x in rep['losses'])}, "
          f"{', '.join(f'{x:.3f}' for x in rep['step_s'])} s a step, peak memory "
          f"{rep['peak_mem'] / 1e9:.1f} GB", flush=True)

    rep = launched(["--arch", TRAIN_ARCH, "--preset", "tiny", "--dp-mode", "nosync",
                    "--replicas", "2", "--inner-steps", "2", "--steps", "1"] + TRAIN_ARGV)
    check(rep["changed"] is True, "local SGD: the replicas differ after the outer sync")
    print(f"train: {TRAIN_ARCH} --preset tiny --dp-mode nosync, 2 replicas of 2 inner steps: "
          f"outer loss {rep['losses'][0]:.4f} in {rep['step_s'][0]:.3f} s; the replicas "
          f"equal after the int8 sync", flush=True)

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="smoke_ckpt_", dir=os.path.join(ROOT, "build"))
    try:
        base = ["--arch", TRAIN_ARCH, "--preset", "100m", "--ckpt-dir", ckpt] + TRAIN_ARGV
        first = launched(base + ["--steps", "4", "--ckpt-every", "2"])
        check(first["saved"] == [2, 4], f"checkpoints at {first['saved']}, expected [2, 4]")
        saved, step = restore_arrays(ckpt)  # read whole: the next run rewrites the file
        again = launched(base + ["--steps", "0"])  # restores LATEST, saves it again
        resaved, _ = restore_arrays(ckpt)
        check(again["start_step"] == step and set(saved) == set(resaved)
              and all(saved[k].dtype == resaved[k].dtype
                      and torch.equal(saved[k].reshape(-1).view(torch.uint8),
                                      resaved[k].reshape(-1).view(torch.uint8))
                      for k in saved), "checkpoint: the restored state is not the saved one")
        resumed = launched(base + ["--steps", "1"])
        check(resumed["start_step"] == step, "checkpoint: the run did not resume")
        print(f"train: {TRAIN_ARCH} --preset 100m checkpointed at steps {first['saved']} "
              f"({len(saved)} arrays, "
              f"{sum(t.numel() * t.element_size() for t in saved.values()) / 1e9:.2f} GB); a "
              f"second run restored step {again['start_step']} from LATEST and saved it bit "
              f"for bit again; a third resumed at step {resumed['start_step']}, loss "
              f"{resumed['losses'][0]:.4f}", flush=True)
    finally:
        shutil.rmtree(ckpt)

    small = dataclasses.replace(get_config(TRAIN_ARCH).reduced(), dtype="float32")
    card = init_train_state(small, torch.Generator(device=dev).manual_seed(0), device=dev)
    host_model = DecoderLM(small, device="cpu")
    host_model.load_state_dict({k: v.detach().cpu() for k, v in card.params.state_dict().items()})
    host = init_train_state(small, params=host_model)
    toks = torch.randint(0, small.vocab, (2, 65), generator=torch.Generator().manual_seed(5))
    step = make_train_step(small, AdamWConfig(lr=1e-2, warmup_steps=2), ce_chunk=16)
    _, got = step(card, {"tokens": toks.to(dev)})
    _, want = step(host, {"tokens": toks})
    loss_rel = abs(float(got["loss"]) - float(want["loss"])) / abs(float(want["loss"]))
    norm_rel = (abs(float(got["grad_norm"]) - float(want["grad_norm"]))
                / abs(float(want["grad_norm"])))
    check(loss_rel <= TRAIN_LOSS_RTOL and norm_rel <= TRAIN_NORM_RTOL,
          f"train step card vs CPU: loss {loss_rel:.3e}, norm {norm_rel:.3e} relative")
    print(f"train: one step of {TRAIN_ARCH} reduced, float32, card vs CPU: loss "
          f"{float(got['loss']):.6f} ({loss_rel:.3e} relative, bound {TRAIN_LOSS_RTOL:g}), "
          f"gradient norm {float(got['grad_norm']):.6f} ({norm_rel:.3e}, bound "
          f"{TRAIN_NORM_RTOL:g})", flush=True)
    return {"step_s": step_s, "opt_ms": opt_ms}


DRYRUN_JSON = os.path.join(ROOT, "build", "smoke_dryrun.json")
DRYRUN_TIMEOUT = 900  # seconds for the grid's child (about 300 on 8 idle cores)
FLASH_OP = "repro_torch.flash_attention"  # the dispatcher op, as CostMode names it


def start_dryrun_child():
    """The dry run's whole grid (``repro_torch.launch.dryrun --all
    --both-meshes --json DRYRUN_JSON``) in a host child under RSS_CHILD,
    started beside the card phases, as :func:`start_build_children`'s are:
    it walks every cell on the meta device and touches no GPU.  Returns the
    future of its report."""
    from concurrent.futures import ThreadPoolExecutor

    os.makedirs(os.path.dirname(DRYRUN_JSON), exist_ok=True)
    argv = ["dryrun", "--all", "--both-meshes", "--json", DRYRUN_JSON]
    pool = ThreadPoolExecutor(1)
    child = pool.submit(rss_child, argv, False, DRYRUN_TIMEOUT)
    pool.shutdown(wait=False)
    return child


def per_call_us(fn, calls: int = 2000) -> float:
    """Host microseconds a call of ``fn`` over ``calls`` calls made back to
    back, the card synchronised once at the end."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def dryrun_phase(dev, prefill_s: float, train: dict, child) -> None:
    """The dry run's counts held to the card (module docstring, phase 24):
    ``prefill_s`` is phase 16's best prefill wall, ``train`` phase 23's
    seconds a step and AdamW milliseconds, ``child`` the grid's future."""
    from repro_torch.configs import ARCH_IDS, SHAPES, ShapeSpec, cell_runnable, get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import abstract_train_state, argument_bytes, build_cell
    from repro_torch.models.model import forward, init_params
    from repro_torch.training import AdamWConfig, adamw_update, init_train_state
    from repro_torch.utils.cost import CostMode
    from repro_torch.utils.roofline import Roofline

    mesh = make_host_mesh()
    cfg = get_config("qwen2-vl-2b")
    step, args, specs, _ = build_cell(cfg, ShapeSpec("prefill", LM_SEQ, LM_BATCH, "prefill"), mesh)
    t0 = time.perf_counter()
    with CostMode() as walk:
        step(*args)
    with CostMode() as walk_full, torch.no_grad():  # phase 16's timed forward, with the head
        forward(cfg, args[0], args[1]["tokens"])
    walk_s = time.perf_counter() - t0
    param_bytes = argument_bytes(args[0], specs[0], mesh)
    del args
    # phase 16's weights and tokens, from the same seeded generators
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    toks = torch.randint(0, cfg.vocab, (LM_BATCH, LM_SEQ),
                         generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    card_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    check(card_bytes == param_bytes, f"qwen2-vl-2b: {card_bytes} parameter bytes on the card, "
          f"the dry run's argument bytes on 1 x 1 {param_bytes}")
    fa.reset_launch_counts()
    with CostMode() as card:
        step(params, {"tokens": toks})
        torch.cuda.synchronize()
    launches = fa.launch_counts()["flash_attention"]
    with CostMode() as card_full, torch.no_grad():
        forward(cfg, params, toks)
        torch.cuda.synchronize()
    check(card.flops == walk.flops and card_full.flops == walk_full.flops,
          f"qwen2-vl-2b prefill FLOPs: card {card.flops} / {card_full.flops}, meta "
          f"{walk.flops} / {walk_full.flops}")
    check(card.ops[FLASH_OP] == walk.ops[FLASH_OP] == launches == cfg.n_layers,
          f"qwen2-vl-2b prefill: flash ops card {card.ops[FLASH_OP]}, meta "
          f"{walk.ops[FLASH_OP]}, launches {launches}, layers {cfg.n_layers}")
    # the timed forward's peak, outside the mode, against the counted one
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    with torch.no_grad():
        out = forward(cfg, params, toks)
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    del out
    predicted = param_bytes + toks.numel() * toks.element_size() + walk_full.peak_bytes
    roof = Roofline(flops=walk_full.flops, bytes_accessed=walk_full.bytes, collective_bytes=0)
    tflops = walk_full.flops / prefill_s / 1e12
    print(f"dryrun: qwen2-vl-2b bf16 prefill b={LM_BATCH} s={LM_SEQ} walked on meta at full "
          f"depth ({walk_s:.1f}s for both walks) and run on the card under the same counting "
          f"mode: FLOPs equal ({walk.flops} features only, {walk_full.flops} with the head), "
          f"flash ops {walk.ops[FLASH_OP]} = launches {launches}, parameter bytes "
          f"{card_bytes} = the dry run's argument bytes on 1 x 1", flush=True)
    print(f"dryrun: qwen2-vl-2b prefill (phase 16's timed forward, {prefill_s * 1e3:.2f} ms): "
          f"{walk_full.flops / 1e12:.3f} TFLOP counted, {tflops:.1f} TFLOP/s, mfu "
          f"{tflops * 1e12 / BF16_TC_FLOPS:.4f} of 989 TFLOP/s; roofline compute "
          f"{roof.t_compute * 1e3:.2f} ms, memory {roof.t_memory * 1e3:.2f} ms "
          f"({walk_full.bytes / 1e9:.2f} GB of eager traffic counted) against the wall "
          f"{prefill_s * 1e3:.2f} ms ({roof.dominant} bound, {roof.step_time / prefill_s:.4f} "
          f"of it)", flush=True)
    print(f"dryrun: qwen2-vl-2b prefill peak memory: counted {predicted / 2**30:.3f} GiB "
          f"(parameters and tokens {(param_bytes + toks.numel() * toks.element_size()) / 2**30:.3f}"
          f" + the walk's peak {walk_full.peak_bytes / 2**30:.3f}), max_memory_allocated "
          f"{peak / 2**30:.3f} GiB (ratio {peak / predicted:.4f}; above what was allocated "
          f"before, {(peak - base) / 2**30:.3f} GiB, {(peak - base) / walk_full.peak_bytes:.4f} "
          f"of the walk's peak)", flush=True)
    del params, toks
    # the dispatcher's cost a call of the flash op, at a shape where the host is slower
    q, k, v = (torch.randn((1, 2, 64, 64), device=dev, dtype=torch.bfloat16) for _ in range(3))
    via_op = [per_call_us(lambda: fa_kernel.flash_attention_op(q, k, v, 0.125, True, None))]
    direct = [per_call_us(lambda: fa_kernel._flash_attention_cuda(q, k, v, 0.125, True, None))]
    direct.append(per_call_us(lambda: fa_kernel._flash_attention_cuda(q, k, v, 0.125, True, None)))
    via_op.append(per_call_us(lambda: fa_kernel.flash_attention_op(q, k, v, 0.125, True, None)))
    cost_us = statistics.mean(via_op) - statistics.mean(direct)
    print(f"dryrun: the flash op through the dispatcher {statistics.mean(via_op):.1f} us a call, "
          f"its CUDA implementation called directly {statistics.mean(direct):.1f} us (host, "
          f"2,000 calls each, op/direct/direct/op): {cost_us:.1f} us a call, "
          f"{cost_us * cfg.n_layers / 1e3:.3f} ms of the {prefill_s * 1e3:.2f} ms prefill "
          f"({cfg.n_layers} calls)", flush=True)
    del q, k, v
    torch.cuda.empty_cache()

    cfg = get_config(TRAIN_ARCH)
    step, args, _, _ = build_cell(cfg, ShapeSpec("train", 256, 8, "train"), mesh)
    with CostMode() as walk:
        step(*args)
    del args
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    toks = torch.randint(0, cfg.vocab, (8, 256), generator=torch.Generator(device=dev).manual_seed(3),
                         device=dev).to(torch.int32)
    with CostMode() as card:
        step(state, {"tokens": toks})
        torch.cuda.synchronize()
    check(card.flops == walk.flops, f"{TRAIN_ARCH} train step FLOPs: card {card.flops}, meta "
          f"{walk.flops}")
    del state, toks
    torch.cuda.empty_cache()
    tflops = walk.flops / train["step_s"] / 1e12
    state = abstract_train_state(cfg)
    named = dict(state.params.named_parameters())
    grads = {name: torch.empty_like(p) for name, p in named.items()}
    with CostMode() as opt:
        adamw_update(AdamWConfig(), named, grads, state.opt)
    rate = opt.bytes / (train["opt_ms"] / 1e3)
    print(f"dryrun: {TRAIN_ARCH} train step (seq 256, batch 8; the launcher's ce_chunk 128 "
          f"and build_cell's 512 both make one loss chunk of 255): FLOPs equal on meta and "
          f"the card ({walk.flops}, {walk.flops / 1e12:.3f} TFLOP); at phase 23's "
          f"{train['step_s']:.3f} s a step {tflops:.1f} TFLOP/s, mfu "
          f"{tflops * 1e12 / BF16_TC_FLOPS:.4f} of 989 TFLOP/s; adamw_update: "
          f"{opt.bytes / 1e9:.3f} GB counted (each op's inputs and outputs once) in phase "
          f"23's {train['opt_ms']:.1f} ms, {rate / 1e12:.3f} TB/s, "
          f"{rate / HBM_BYTES_PER_S:.4f} of 3.35 TB/s", flush=True)
    del state, named, grads

    rep = child.result()
    for line in rep["lines"]:
        if line.startswith("== dry-run"):
            print(f"dryrun: grid {line}")
    with open(DRYRUN_JSON) as f:
        records = json.load(f)
    want_skip = {(a, name) for a in ARCH_IDS for name in SHAPES
                 if not cell_runnable(get_config(a), SHAPES[name])[0]}
    skipped = {(r["arch"], r["shape"]) for r in records if r["status"] == "skipped"}
    failed = [r for r in records if r["status"] not in ("ok", "skipped")]
    check(rep["code"] == 0 and not failed and skipped == want_skip
          and len(records) == 2 * len(ARCH_IDS) * len(SHAPES),
          f"dry-run grid: exit {rep['code']}, {len(failed)} failed "
          f"({[r.get('error') for r in failed][:3]}), skipped {sorted(skipped ^ want_skip)} "
          f"other than the reference's")
    peak_rss = rep["sampled_peak"]
    print(f"dryrun: grid --all --both-meshes in a host child beside the card phases: "
          f"{len(records) - 2 * len(want_skip)} cells ok, {2 * len(want_skip)} skipped as the "
          f"reference skips them, 0 failed; wall {rep['wall_s']:.1f}s, peak RSS "
          f"{'not measured' if peak_rss is None else f'{peak_rss / 2**30:.2f} GiB'}",
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside chip_smoke.py",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    # float32 comparisons below hold float32 products, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda}); "
          f"nvidia-smi: {smi}", flush=True)

    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.graphs import make_dataset
    from repro_torch.kernels.flash_attention import build as flash_build
    from repro_torch.kernels.spmv import build as spmv_build

    # one nvcc per source, all started together
    t0 = time.perf_counter()
    libs = (spmv_build, flash_build)
    with ThreadPoolExecutor(len(libs)) as pool:
        built = [f.result() for f in [pool.submit(lib.build) for lib in libs]]
    for lib in libs:
        lib.load()
    print(f"build: {len(libs)} libraries in {time.perf_counter() - t0:.1f}s", flush=True)
    for path, _ in built:
        print(f"build: {os.path.relpath(path, ROOT)}")
    dry_child = start_dryrun_child()  # the dry run's grid, on the host, beside the card

    with phase_wall("analysis"):
        analysis_phase()

    g = make_dataset("webStanford", scale_down=1)
    gw = weighted_graph(g)
    print(f"data: webStanford surrogate n={g.n} m={g.m} "
          f"dangling={int((g.out_degree == 0).sum())}", flush=True)

    with phase_wall("kernels"):
        stats = kernel_phase(g, gw, dev)
    with phase_wall("solve"):
        launches = solve_phase(g)
    with phase_wall("adaptive"):
        gb = adaptive_phase(g, dev)
    with phase_wall("repeat"):
        repeat_phase(g, gb, dev)
    with phase_wall("profile"):
        profile_phase(g, gb, dev)
    del gb
    with phase_wall("sticd"):
        for kernel, paths in sticd_phase(g, dev).items():
            launches[kernel].update(paths)
    from repro_torch.serving import make_query_stream

    with phase_wall("ppr"):
        # the engine's queries and the first rows of every batched solve
        # are a prefix of this stream
        queries = make_query_stream(g.n, max(ENGINE_QUERIES, PPR_WIDE_ROWS), seed=0)
        oracle = ppr_oracle(g, [q.seeds for q in queries] + [()])
        launches["gs_pass_multi"] = ppr_phase(g, dev, oracle)
    with phase_wall("engine"):
        unsharded = engine_phase(g, dev, oracle)
    with phase_wall("distributed"):
        part, paths = distributed_phase(g, dev, oracle, queries[:ENGINE_QUERIES],
                                        unsharded)
        for kernel, by_path in paths.items():
            launches[kernel].update(by_path)
    with phase_wall("dynamic"):
        for kernel, paths in dynamic_phase(g, dev).items():
            launches[kernel].update(paths)
    with phase_wall("ppr serve"):
        launches["gs_pass_multi"].update(ppr_serve_phase(g))
    with phase_wall("push"):
        # the distinct seed sets of the first PPR_ROWS queries of the
        # engine's stream: each push solve is host numpy and takes seconds
        # at full size
        push_phase(g, oracle, sorted({_key(q.seeds) for q in queries[:PPR_ROWS]}))
    del gw, oracle
    # the build phase's two host children stream socLiveJournal1 to disk
    # while the flash and LM phases use the card
    children = start_build_children()
    with phase_wall("flash"):
        flash = flash_kernel_phase(dev)
    fa_paths = {}  # {prefill of a model: flash launches}
    with phase_wall("prefill and decode"):
        fa_paths["qwen2-vl-2b prefill"], cfg32, params32, prefill_s = lm_phase(
            dev, "qwen2-vl-2b", LM_BATCH, LM_SEQ)
    with phase_wall("serve"):
        serve_phase(cfg32, params32)
    del cfg32, params32
    for arch, batch, seq, f32_layers in DENSE_LMS:
        torch.cuda.empty_cache()
        with phase_wall(f"lm {arch}"):
            n = lm_phase(dev, arch, batch, seq, f32_layers)[0]  # frees its f32 model
        if n:  # gemma2-2b's prefill is no path of the kernel
            fa_paths[f"{arch} prefill"] = n
    torch.cuda.empty_cache()
    with phase_wall("serve dense"):
        for arch in DENSE_SERVED:
            serve_full(arch)
    fa_paths.update(moe_phase(dev))
    fa_paths.update(ssm_phase(dev))
    torch.cuda.empty_cache()
    with phase_wall("whisper"):
        fa_paths["whisper-medium prefill"] = whisper_phase(dev)
    torch.cuda.empty_cache()
    with phase_wall("train"):
        train_stats = train_phase(dev)
    torch.cuda.empty_cache()
    with phase_wall("dryrun"):
        dryrun_phase(dev, prefill_s, train_stats, dry_child)
    torch.cuda.empty_cache()
    with phase_wall("build"):
        build_stats, bfs_stats, paths = build_phase(g, dev, children)
        for kernel, by_path in paths.items():
            launches[kernel].update(by_path)
    with phase_wall("store"):
        launches["gs_pass"].update(store_phase(g, dev))
    with phase_wall("faults"):
        faults_phase(g, dev)
    del g

    replaces = {"spmv_csr_acc": "src/repro/kernels/spmv/kernel.py:67",
                "gs_pass": "src/repro/kernels/spmv/kernel.py:181",
                "gs_pass_multi": "src/repro/kernels/spmv/kernel.py:323"}
    kernels = []
    for name, by_tag in stats.items():
        s = by_tag["unweighted"]  # the shapes the main path gives the kernel
        paths = launches[name]  # {main path: launches}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/spmv/csrc/spmv.cu",
            "replaces": replaces[name],
            # the first main path's count; each path's in launches_by_path
            "launches": next(iter(paths.values())), "launches_by_path": paths,
            "max_abs_err": max(t["max_abs_err"] for t in by_tag.values()),
            "ms": s["ms"], "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": "bytes", "library_ms": s["library_ms"],
            "timed_by": s["timed_by"],
            **({"k": s["k"], "D": s["D"]} if name == "gs_pass" else {}),
            # one partition of the p = 4 distributed solves (spmv_csr_rows)
            **({"partition_p4": part} if name == "spmv_csr_acc" else {}),
            # the build phase's full-size socLiveJournal1, from the memmaps
            # of its streamed raw store and of its BFS-reordered store
            **({STORE_DATASET: build_stats[name]} if name in build_stats else {}),
            **({f"{STORE_DATASET} BFS (build)": bfs_stats} if name == "gs_pass" else {}),
        })
    f = flash[("qwen2-vl-2b", torch.bfloat16, None)]  # its prefill's shape and dtype

    def shape_entry(st):
        return {key: st[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")}

    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:92",
        # qwen2-vl-2b's prefill; each model's in launches_by_path
        "launches": fa_paths["qwen2-vl-2b prefill"], "launches_by_path": fa_paths,
        "max_abs_err": f["max_abs_err"],
        "ms": f["ms"], "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"],
        "bound_by": f["bound_by"], "library_ms": f["library_ms"],
        "timed_by": {"ms": "events", "plain_ms": "events", "library_ms": "events"},
        # the prefill shapes of stablelm-3b (dh 80), starcoder2-3b and
        # mixtral-8x22b (window 4096), and whisper-medium's encoder, bf16
        "stablelm-3b shape": shape_entry(flash[("stablelm-3b", torch.bfloat16, None)]),
        "starcoder2-3b shape": shape_entry(flash[("starcoder2-3b", torch.bfloat16, 4096)]),
        "mixtral-8x22b shape": shape_entry(flash[("mixtral-8x22b", torch.bfloat16, 4096)]),
        # whisper-medium's encoder, not causal
        "whisper-medium encoder shape": shape_entry(
            flash[("whisper-medium", torch.bfloat16, None)]),
    })
    check(all(k["launches"] > 0 and all(n > 0 for n in k.get("launches_by_path", {}).values())
              for k in kernels), "a kernel never launched on a main path")
    print(f"total: {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
