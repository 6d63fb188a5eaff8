"""Shared-memory and register audit of the port's CUDA kernels: the
counterpart of the reference's VMEM budget (``repro.analysis.vmem``).

The reference's Pallas kernels keep their rank state in VMEM, a budget per
TensorCore.  The port's kernels stage in shared memory, a budget per CTA:
the 232,448 B a CTA may opt into on the H100 (``smem_per_block_optin`` in
``csrc/spmv.cu`` reads it from the card).  Their staging is laid out by
structs in the CUDA sources, so this pass keeps a Python mirror of each:

* ``spmv_csr_acc``: the static merge tile of ``kCsrTile`` row ends and
  edge values (:func:`csr_static_smem_bytes`), the same at any block;
* ``gs_pass``: ``GsLayout`` (``D`` stream slots of a block's records and
  a chunk of ``src``/``weights``, the gathered-value slots, the window of
  ``k`` committed blocks, the accumulators, the mbarriers) and
  ``gs_pass_plan``'s search for the largest ``k``, then ``D``, that fit
  (:class:`GsLayout`, :func:`gs_pass_plan`);
* ``gs_pass_multi``: ``MultiLayout`` of a CTA owning ``part`` vertices of
  each block, at its most without a cluster (:func:`multi_smem_bytes`);
* ``flash_attention``: the float32 kernel's ``smem_floats<D>()`` and the
  bf16 kernel's ``tc::Geo<D>::SMEM`` for each head dim of ``HEAD_DIMS``
  (:func:`flash_smem_bytes`).

From the mirror the pass computes the largest ``block`` that ``gs_pass``
(unweighted and weighted) and ``gs_pass_multi`` take — the counterparts of
the reference's "max vertices/core" — and checks:

* ``budget-overflow`` — a configuration the port's paths use does not fit:
  the blocks of the variants' builds, the engine's ``cuda`` backend, the
  launcher and the trace lint (:func:`path_blocks`), and every head dim;
* ``budget-inconsistent`` — a computed largest block does not fit, or the
  next block does.

On the card (``device="cuda"``) two more checks read the built library:

* ``register-spill`` — a kernel with local (spill) bytes above 0
  (``spmv_kernel_info``, ``flash_attention_info``);
* ``layout-drift`` — at any block from 1 to one past the computed largest
  the mirror differs from the library's own ``gs_pass_plan`` (bytes, ``k``
  and ``D``) or ``gs_pass_multi_smem_bytes``; or the static merge tile,
  a flash instantiation's shared memory or ``gs_pass``'s at the path's
  block differs from what the library reports.

The mirror must follow the structs field for field; a change to either
side shows as ``layout-drift`` on the card.
"""
from __future__ import annotations

import dataclasses

from repro_torch.analysis.findings import Finding

# The most shared memory a CTA may opt into on the H100 (227 KB), and the
# most a kernel may declare statically.
H100_SMEM_OPTIN = 232_448
STATIC_SMEM_LIMIT = 48 * 1024
# The largest block any spmv wrapper takes (kernels/spmv/kernel.py).
MAX_BLOCK = 16_384

# csrc/spmv.cu
WARP = 32
CHUNK = 4096  # kChunk: edges summed per round of a block
CSR_THREADS = 256
CSR_ITEMS = 16
CSR_TILE = CSR_THREADS * CSR_ITEMS  # kCsrTile
CSR_WARPS = CSR_THREADS // WARP
ROUND_EDGES = 2048  # kRoundEdges
VALUE_SLOTS = 4  # kValueSlots
MAX_WINDOW = 8  # kMaxWindow: k
MAX_STAGES = 4  # kMaxStages: D

# csrc/flash_attention.cu
FLASH_BQ = 64
FLASH_BK = 64
FLASH_QS = FLASH_BQ + 4
FLASH_KS = FLASH_BK + 4
TC_STAGES = 2


def round16(nbytes: int) -> int:
    return (nbytes + 15) // 16 * 16


def csr_static_smem_bytes() -> int:
    """``spmv_csr_acc_kernel``'s ``__shared__`` arrays: the tile's row ends
    (``kCsrTile + 1``) and edge values (``kCsrTile``), the search's two
    count buffers, the share's coordinates, the warp and tile carries; the
    compiler rounds a kernel's static shared memory up to 16 bytes."""
    ints = (CSR_TILE + 1) + 2 * CSR_WARPS + 4 + CSR_WARPS + 1
    floats = CSR_TILE + CSR_WARPS + 1
    return round16(4 * (ints + floats))


@dataclasses.dataclass(frozen=True)
class GsLayout:
    """``GsLayout`` of ``csrc/spmv.cu``: byte offsets of the walker CTA's
    shared memory at ``block`` rows, ``k`` window blocks and ``D`` stream
    slots; ``total`` is the dynamic shared memory of the launch."""

    src: int
    w: int
    slot: int
    values: int
    window: int
    acc: int
    bar: int
    total: int

    @classmethod
    def of(cls, block: int, weighted: bool, k: int, d_stages: int) -> "GsLayout":
        edges = round16(4 * (CHUNK + 8))
        src = 16 * (block + 1)
        w = src + edges
        slot = w + (edges if weighted else 0)
        values = d_stages * slot
        window = values + VALUE_SLOTS * edges
        acc = window + round16(4 * k * block)
        bar = acc + round16(4 * block)
        total = bar + round16(8 * (d_stages + 2 * VALUE_SLOTS + 1))
        return cls(src, w, slot, values, window, acc, bar, total)


def gs_pass_plan(block: int, weighted: bool,
                 smem_limit: int = H100_SMEM_OPTIN) -> tuple[int, int, int] | None:
    """``(k, D, bytes)`` of a ``gs_pass`` launch at ``block``: the largest
    ``k``, then the larger ``D``, whose layout fits into ``smem_limit``
    bytes, as ``gs_pass_plan`` in ``csrc/spmv.cu`` searches; ``None`` where
    not even ``k = 2, D = 2`` fits."""
    for k in range(MAX_WINDOW, 1, -1):
        for d_stages in range(MAX_STAGES, 1, -1):
            total = GsLayout.of(block, weighted, k, d_stages).total
            if total <= smem_limit:
                return k, d_stages, total
    return None


@dataclasses.dataclass(frozen=True)
class MultiLayout:
    """``MultiLayout`` of ``csrc/spmv.cu``: float offsets of a
    ``gs_pass_multi`` CTA's shared memory when it owns ``part`` vertices of
    each block (each field starts on a 16-byte boundary)."""

    quad: int
    vals: int
    tele: int
    src: int
    w: int
    acc: int
    cb: int
    vmask: int
    inv: int
    ptr: int
    carry: int
    total: int

    @classmethod
    def of(cls, part: int) -> "MultiLayout":
        at = 0
        fields = []
        for n in (2 * ROUND_EDGES * 4, 2 * ROUND_EDGES, 2 * part, 3 * ROUND_EDGES,
                  3 * ROUND_EDGES, part, 2 * part, 2 * part, 2 * part,
                  2 * (part + 1), 2 * WARP):
            fields.append(at)
            at += (n + 3) // 4 * 4
        return cls(*fields, total=at)


def multi_smem_bytes(block: int, cluster: int = 1) -> int:
    """Dynamic shared memory of a ``gs_pass_multi`` CTA at ``block`` on a
    cluster of ``cluster`` CTAs a row (``multi_smem_bytes``); the wrapper
    checks the cluster-free size, a CTA's most."""
    part = -(-block // cluster)
    return 4 * MultiLayout.of(part).total


def flash_smem_bytes(dh: int, bf16: bool) -> int:
    """Dynamic shared memory of the flash kernel launched for ``dh``: the
    bf16 kernel's ``tc::Geo<D>::SMEM`` (1,024 B of swizzle alignment, the q
    tile, the K and V rings, the mbarriers), the float32 kernel's
    ``smem_floats<D>()`` (the q and k tiles transposed, the p tile)."""
    if bf16:
        barriers = 1 + 4 * TC_STAGES
        return 1024 + FLASH_BQ * dh * 2 + 2 * TC_STAGES * FLASH_BK * dh * 2 + 8 * barriers
    return 4 * (dh * FLASH_QS + dh * FLASH_KS + FLASH_BK * FLASH_QS)


def largest_block(fits) -> int:
    """The largest block in ``[1, MAX_BLOCK]`` for which ``fits(block)``
    holds (0 if none), for a ``fits`` that holds on a prefix."""
    lo, hi = 0, MAX_BLOCK + 1  # fits(lo) (vacuously at 0), not fits(hi)
    while lo + 1 < hi:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    return lo


def gs_fits(weighted: bool, smem_limit: int = H100_SMEM_OPTIN):
    return lambda block: gs_pass_plan(block, weighted, smem_limit) is not None


def multi_fits(smem_limit: int = H100_SMEM_OPTIN):
    return lambda block: multi_smem_bytes(block) <= smem_limit


def path_blocks() -> tuple[int, ...]:
    """The blocks the port's paths launch the Gauss–Seidel kernels at: the
    defaults of the blocked variants' and ``ppr_blocked``'s builds, of the
    engine's ``cuda`` backend and of the launcher's ``--block``, and the
    trace lint's."""
    import inspect

    from repro_torch.analysis.trace_lint import LINT_OPTS
    from repro_torch.kernels.spmv import ops
    from repro_torch.launch.pagerank_run import DEFAULT_BLOCK
    from repro_torch.serving.ppr_engine import _KernelBackend

    defaults = {inspect.signature(fn).parameters["block"].default
                for fn in (ops._build, ops.BlockedGraph.build, _KernelBackend)}
    return tuple(sorted(defaults | {DEFAULT_BLOCK, LINT_OPTS["block"]}))


def _flash_cases() -> tuple[tuple[int, bool], ...]:
    from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS

    return tuple((dh, bf16) for dh in HEAD_DIMS for bf16 in (True, False))


@dataclasses.dataclass
class KernelBudget:
    """The audit's line for one kernel: its shared memory at the paths'
    configuration against the budget, the largest block it takes (``None``
    where its staging does not grow with the block), and on the card what
    the built library reports (``card``: one entry per device function)."""

    kernel: str
    smem_bytes: int
    budget: int
    largest_block: int | None = None
    detail: str = ""
    card: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def line(self) -> str:
        out = (f"kernels: {self.kernel}: {self.smem_bytes:,} B shared memory of "
               f"{self.budget:,}")
        if self.largest_block is not None:
            out += f", largest block {self.largest_block:,}"
        if self.detail:
            out += f" ({self.detail})"
        for fn, info in self.card.items():
            static = ("" if "static_smem_bytes" not in info
                      else f"{info['static_smem_bytes']:,} B static + ")
            out += (f"; {fn}: {info['registers']} registers, {info['spill_bytes']} "
                    f"spill bytes, {static}{info['smem_bytes']:,} B dynamic shared, "
                    f"{info['ctas_per_sm']} CTAs an SM")
        return out


def budgets(smem_limit: int = H100_SMEM_OPTIN) -> dict[str, KernelBudget]:
    """The mirror's budget of every kernel at the paths' configuration."""
    at = max(path_blocks())
    out = {"spmv_csr_acc": KernelBudget(
        "spmv_csr_acc", csr_static_smem_bytes(), STATIC_SMEM_LIMIT,
        detail=f"static merge tile of {CSR_TILE} items, any block")}
    for weighted in (False, True):
        name = "gs_pass weighted" if weighted else "gs_pass"
        plan = gs_pass_plan(at, weighted, smem_limit)
        detail = (f"block {at}: k {plan[0]}, D {plan[1]}" if plan
                  else f"block {at}: no stage fits")
        out[name] = KernelBudget(name, plan[2] if plan else 0, smem_limit,
                                 largest_block(gs_fits(weighted, smem_limit)), detail)
    out["gs_pass_multi"] = KernelBudget(
        "gs_pass_multi", multi_smem_bytes(at), smem_limit,
        largest_block(multi_fits(smem_limit)), f"block {at}, one CTA a row")
    for dh, bf16 in _flash_cases():
        name = f"flash_attention {'bf16' if bf16 else 'f32'} dh {dh}"
        out[name] = KernelBudget(name, flash_smem_bytes(dh, bf16), smem_limit)
    return out


def budget_findings(smem_limit: int = H100_SMEM_OPTIN,
                    blocks: tuple[int, ...] | None = None) -> list[Finding]:
    """``budget-overflow`` at every configuration the paths use and
    ``budget-inconsistent`` of every computed largest block."""
    blocks = path_blocks() if blocks is None else blocks
    out: list[Finding] = []

    def overflow(kernel, msg):
        out.append(Finding("kernels", kernel, "budget-overflow", msg))

    if csr_static_smem_bytes() > STATIC_SMEM_LIMIT:
        overflow("spmv_csr_acc", f"the static merge tile takes "
                 f"{csr_static_smem_bytes()} B > {STATIC_SMEM_LIMIT} B")
    for block in blocks:
        if not 0 < block <= MAX_BLOCK:
            overflow("gs_pass", f"block {block} is outside (0, {MAX_BLOCK}]")
            continue
        for weighted in (False, True):
            if gs_pass_plan(block, weighted, smem_limit) is None:
                overflow("gs_pass", f"block {block} ({'weighted' if weighted else 'unweighted'})"
                         f" leaves no room for one stage in {smem_limit} B")
        if multi_smem_bytes(block) > smem_limit:
            overflow("gs_pass_multi", f"block {block} needs {multi_smem_bytes(block)} B "
                     f"> {smem_limit} B")
    for dh, bf16 in _flash_cases():
        need = flash_smem_bytes(dh, bf16)
        if need > smem_limit:
            overflow("flash_attention", f"dh {dh} ({'bf16' if bf16 else 'f32'}) needs "
                     f"{need} B > {smem_limit} B")
    for kernel, fits in (("gs_pass", gs_fits(False, smem_limit)),
                         ("gs_pass", gs_fits(True, smem_limit)),
                         ("gs_pass_multi", multi_fits(smem_limit))):
        mx = largest_block(fits)
        if mx < 1 or not fits(mx) or (mx < MAX_BLOCK and fits(mx + 1)):
            out.append(Finding(
                "kernels", kernel, "budget-inconsistent",
                f"computed largest block {mx}: fits({mx}) = {fits(mx)}, "
                f"fits({mx + 1}) = {fits(mx + 1)}"))
    return out


# ---------------------------------------------------------------------------
# On the card: the built library against the mirror
# ---------------------------------------------------------------------------


def card_info(block: int) -> dict[str, dict[str, dict]]:
    """What the built libraries report at ``block``: ``spmv_kernel_info``
    of each device function of ``csrc/spmv.cu`` (gs_pass unweighted and
    weighted) and ``flash_attention_info`` of each instantiation, keyed by
    the budget lines of :func:`budgets`."""
    from repro_torch.kernels.flash_attention import build as flash_build
    from repro_torch.kernels.spmv import build as spmv_build

    def spmv(kernel, weighted=False):
        return spmv_build.kernel_info(kernel, block, weighted)

    out = {
        "spmv_csr_acc": {k: spmv(k) for k in ("spmv_csr_acc", "spmv_carry")},
        "gs_pass": {k: spmv(k) for k in ("gs_prep", "gs_pass")},
        "gs_pass weighted": {"gs_pass": spmv("gs_pass", True)},
        "gs_pass_multi": {k: spmv(k) for k in ("scale_state", "gs_pass_multi")},
    }
    for dh, bf16 in _flash_cases():
        # flash_attention_info reports the dynamic shared memory only
        out[f"flash_attention {'bf16' if bf16 else 'f32'} dh {dh}"] = {
            "flash_attention": flash_build.kernel_info(dh, bf16)}
    return out


def drift_findings(lib, smem_limit: int, reports: dict[str, KernelBudget]) -> list[Finding]:
    """``layout-drift``: the mirror against the library ``lib`` at every
    block from 1 to one past the computed largest, and against the
    reported shared memory of every kernel at the path's configuration."""
    import ctypes

    out: list[Finding] = []

    def drift(kernel, msg):
        out.append(Finding("kernels", kernel, "layout-drift", msg))

    for weighted in (False, True):
        name = "gs_pass weighted" if weighted else "gs_pass"
        bad = []
        for block in range(1, reports[name].largest_block + 2):
            k, d_stages = ctypes.c_int(0), ctypes.c_int(0)
            got = lib.gs_pass_plan(block, int(weighted), smem_limit, ctypes.byref(k),
                                   ctypes.byref(d_stages))
            lib_plan = (k.value, d_stages.value, got) if got > 0 else None
            if lib_plan != gs_pass_plan(block, weighted, smem_limit):
                bad.append(f"block {block}: library {lib_plan}, mirror "
                           f"{gs_pass_plan(block, weighted, smem_limit)}")
        if bad:
            kind = "weighted" if weighted else "unweighted"
            drift("gs_pass", f"{len(bad)} blocks differ ({kind}), first {bad[0]}")
    bad = [block for block in range(1, reports["gs_pass_multi"].largest_block + 2)
           if lib.gs_pass_multi_smem_bytes(block) != multi_smem_bytes(block)]
    if bad:
        drift("gs_pass_multi", f"{len(bad)} blocks differ, first {bad[0]}: library "
              f"{lib.gs_pass_multi_smem_bytes(bad[0])} B, mirror {multi_smem_bytes(bad[0])} B")
    for name, rep in reports.items():
        for fn, info in rep.card.items():
            if fn in ("spmv_carry", "gs_prep", "scale_state"):
                continue  # no shared memory in the mirror
            reported = info.get("static_smem_bytes", 0) + info["smem_bytes"]
            if reported != rep.smem_bytes:
                drift(name.split(" ")[0], f"{name}: {fn} reports {reported} B of shared "
                      f"memory, the mirror {rep.smem_bytes} B")
    return out


def card_findings(reports: dict[str, KernelBudget]) -> list[Finding]:
    """``register-spill`` and, where a kernel cannot be resident,
    ``budget-overflow`` from what the library reports."""
    out: list[Finding] = []
    for name, rep in reports.items():
        for fn, info in rep.card.items():
            if info["spill_bytes"] > 0:
                out.append(Finding("kernels", fn, "register-spill",
                                   f"{name}: {info['spill_bytes']} local bytes a thread "
                                   f"({info['registers']} registers)"))
            if info["ctas_per_sm"] < 1:
                out.append(Finding("kernels", fn, "budget-overflow",
                                   f"{name}: no CTA fits on an SM"))
    return out


def audit(device: str = "cuda") -> tuple[list[Finding], dict[str, KernelBudget]]:
    """The kernels pass: the mirror's findings and budget lines, and on
    ``device="cuda"`` the card's: the library's report of every kernel at
    the paths' largest block, ``register-spill`` and ``layout-drift``."""
    import torch

    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        return budget_findings(), budgets()
    from repro_torch.kernels.spmv import build as spmv_build

    lib = spmv_build.load()
    index = torch.cuda.current_device() if dev.index is None else dev.index
    smem_limit = lib.smem_per_block_optin(index)
    if smem_limit < 0:
        raise RuntimeError(f"smem_per_block_optin failed with cudaError {-smem_limit}")
    with torch.cuda.device(index):
        reports = budgets(smem_limit)
        at = max(path_blocks())
        for name, fns in card_info(at).items():
            reports[name].card = fns
        findings = budget_findings(smem_limit)
        findings += card_findings(reports)
        findings += drift_findings(lib, smem_limit, reports)
    return findings, reports
