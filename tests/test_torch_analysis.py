"""The port's static-analysis passes (``repro_torch.analysis``) on the CPU,
held against the reference's (``repro.analysis``) on the same inputs.

Two halves, as ``tests/test_analysis.py``:

* **seeded violations** — each pass is aimed at a deliberately-broken
  input (a block one past the largest, a mirror that drifts from the
  library, a float64 op, reads over the contract, a copy to ``meta``, an
  exchange under ``nosync``, run signatures that drop ``handle_dangling``,
  broken test trees) and must flag it with the matching check key; where
  the reference has the same pass, both must;
* **clean run** — the real kernels and the whole registry produce no
  unsuppressed finding, each variant's check keys are the reference's
  under the name map ``pallas*`` → ``blocked*``, ``ppr_pallas`` →
  ``ppr_blocked``, and the documented suppressions fire.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.analysis import apply_suppressions, unsuppressed
from repro_torch.analysis import kernels as K
from repro_torch.analysis.contracts import (
    audit_dangling_flow,
    audit_metadata,
    audit_registry,
)
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.trace_lint import (
    COPY_OPS,
    HOST_READ_CONTRACT,
    READ_OPS,
    OpRecord,
    OpRecorder,
    lint_ops,
    read_contract,
    trace_engine,
    trace_reports,
    trace_variant,
    upload_contract,
)
from repro_torch.core.solver import get_variant, list_variants


def _checks(findings):
    return {f.check for f in findings}


def _triples(findings):
    return sorted((f.pass_name, f.target, f.check) for f in findings)


TRACED = [n for n in list_variants() if get_variant(n).backend != "numpy"] + [
    "serving_torch", "serving_cuda"]
# the reference's names for the port's targets
# the targets whose schedule counts sweeps on the device: solve reads the
# count once after the loop (a design read the suppression list names)
SWEEP_READ = {"nosync", "nosync_opt", "nosync_sticd", "ppr_nosync", "blocked_adaptive"}
REF_NAME = {"blocked": "pallas", "blocked_adaptive": "pallas_adaptive",
            "blocked_nosync": "pallas_nosync", "blocked_nosync_opt": "pallas_nosync_opt",
            "ppr_blocked": "ppr_pallas", "serving_torch": "serving_jax",
            "serving_cuda": "serving_pallas"}


# ---------------------------------------------------------------------------
# kernels pass (the counterpart of the reference's vmem pass)
# ---------------------------------------------------------------------------


def test_kernel_budgets_clean_and_largest_blocks():
    assert K.budget_findings() == []
    reps = K.budgets()
    # (kCsrTile + 1) + kCsrTile words + 39, rounded up to 16 B as nvcc lays
    # out static shared memory (32,928 B on the H100)
    assert reps["spmv_csr_acc"].smem_bytes == 32_928
    # the largest blocks each kernel takes in the H100's 232,448 B a CTA
    assert reps["gs_pass"].largest_block == 3041
    assert reps["gs_pass weighted"].largest_block == 2295
    assert reps["gs_pass_multi"].largest_block == 2297
    # the path's block 256 keeps the widest window and every stream slot
    assert K.gs_pass_plan(256, False)[:2] == (8, 4)
    assert K.gs_pass_plan(256, True)[:2] == (8, 4)
    assert all(r.smem_bytes <= r.budget for r in reps.values())


def _about(f, kernel):
    """Whether finding ``f`` is about ``kernel``'s line of the budget."""
    if kernel == "gs_pass_multi":
        return f.target == kernel
    tag = "(weighted)" if kernel.endswith("weighted") else "(unweighted)"
    return f.target == "gs_pass" and tag in f.message


@pytest.mark.parametrize("kernel", ["gs_pass", "gs_pass weighted", "gs_pass_multi"])
def test_kernel_budget_flags_a_block_one_past_the_largest(kernel):
    mx = K.budgets()[kernel].largest_block
    assert not [f for f in K.budget_findings(blocks=(mx,)) if _about(f, kernel)]
    over = [f for f in K.budget_findings(blocks=(mx + 1,)) if _about(f, kernel)]
    assert _checks(over) == {"budget-overflow"}


def test_kernel_budget_flags_block_outside_the_wrappers_range():
    assert _checks(K.budget_findings(blocks=(K.MAX_BLOCK + 1,))) == {"budget-overflow"}


def test_kernel_budget_flags_an_inconsistent_largest_block(monkeypatch):
    real = K.largest_block
    monkeypatch.setattr(K, "largest_block", lambda fits: real(fits) + 1)
    found = K.budget_findings()
    assert _checks(found) == {"budget-inconsistent"}
    assert {f.target for f in found} == {"gs_pass", "gs_pass_multi"}


class _MirrorLib:
    """A stand-in for the built library whose exports compute what the
    mirror computes, optionally off by 16 bytes at one block."""

    def __init__(self, off_at=None, multi_off_at=None):
        self.off_at, self.multi_off_at = off_at, multi_off_at

    def gs_pass_plan(self, block, weighted, limit, k, d_stages):
        plan = K.gs_pass_plan(block, bool(weighted), limit)
        if plan is None:
            return 0
        k._obj.value, d_stages._obj.value = plan[0], plan[1]
        return plan[2] + (16 if block == self.off_at else 0)

    def gs_pass_multi_smem_bytes(self, block):
        return K.multi_smem_bytes(block) + (16 if block == self.multi_off_at else 0)


def test_layout_drift_clean_against_the_mirror_and_flags_one_block():
    reps = K.budgets()
    assert K.drift_findings(_MirrorLib(), K.H100_SMEM_OPTIN, reps) == []
    drift = K.drift_findings(_MirrorLib(off_at=1000), K.H100_SMEM_OPTIN, reps)
    assert _checks(drift) == {"layout-drift"}
    assert "block 1000" in drift[0].message
    # one past the largest is swept too
    mx = reps["gs_pass_multi"].largest_block
    drift = K.drift_findings(_MirrorLib(multi_off_at=mx + 1), K.H100_SMEM_OPTIN, reps)
    assert _triples(drift) == [("kernels", "gs_pass_multi", "layout-drift")]


def test_layout_drift_flags_reported_shared_memory_off_the_mirror():
    reps = K.budgets()
    good = {"registers": 48, "spill_bytes": 0, "static_smem_bytes": 32_928,
            "smem_bytes": 0, "ctas_per_sm": 2}
    reps["spmv_csr_acc"].card = {"spmv_csr_acc": dict(good)}
    assert K.drift_findings(_MirrorLib(), K.H100_SMEM_OPTIN, reps) == []
    reps["spmv_csr_acc"].card = {"spmv_csr_acc": dict(good, static_smem_bytes=32_940)}
    assert _triples(K.drift_findings(_MirrorLib(), K.H100_SMEM_OPTIN, reps)) == [
        ("kernels", "spmv_csr_acc", "layout-drift")]


def test_card_findings_flag_spills_and_kernels_that_never_fit():
    reps = K.budgets()
    info = {"registers": 255, "spill_bytes": 0, "static_smem_bytes": 0,
            "smem_bytes": 0, "ctas_per_sm": 1}
    reps["gs_pass"].card = {"gs_pass": dict(info)}
    assert K.card_findings(reps) == []
    reps["gs_pass"].card = {"gs_pass": dict(info, spill_bytes=8),
                            "gs_prep": dict(info, ctas_per_sm=0)}
    assert _triples(K.card_findings(reps)) == [
        ("kernels", "gs_pass", "register-spill"), ("kernels", "gs_prep", "budget-overflow")]


def test_path_blocks_cover_the_launcher_the_builds_and_the_lint():
    from repro_torch.analysis.trace_lint import LINT_OPTS
    from repro_torch.launch.pagerank_run import DEFAULT_BLOCK

    assert K.path_blocks() == tuple(sorted({DEFAULT_BLOCK, LINT_OPTS["block"]}))


@pytest.mark.skipif(torch.cuda.is_available(), reason="holds the run without a card")
def test_kernel_audit_needs_a_card_unless_asked_for_the_cpu():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        K.audit("cuda")
    findings, reps = K.audit("cpu")
    assert findings == [] and "gs_pass_multi" in reps


# ---------------------------------------------------------------------------
# trace pass (the counterpart of the reference's jaxpr pass)
# ---------------------------------------------------------------------------


def test_recorder_sees_scalar_reads_and_not_tolist_of_a_cpu_tensor():
    x = torch.arange(4.0)
    with OpRecorder() as rec:
        y = float(x.sum())
    assert y == 6.0
    assert [r.op for r in rec.records] == ["aten.sum.default",
                                           "aten._local_scalar_dense.default"]
    with OpRecorder() as rec:
        x.tolist()
        x.numpy()
    # the CPU blind spot the module docstring names: no read is recorded
    assert lint_ops(rec.records, target="fixture", schedule="barrier") == []
    assert not {r.op for r in rec.records} & (READ_OPS | COPY_OPS)


def test_lint_flags_float64_leak_but_not_host_data():
    x = torch.ones(4)
    with OpRecorder() as rec:
        torch.sum(x.to(torch.float64))
    assert _checks(lint_ops(rec.records, target="fixture")) == {"float64-leak"}
    with OpRecorder() as rec:
        torch.as_tensor(np.ones(4), dtype=torch.float32) * x
    assert any(r.op == "aten.lift_fresh.default" for r in rec.records)
    assert lint_ops(rec.records, target="fixture") == []
    fed = [OpRecord("aten.add.Tensor", ("cpu",), (("cpu", "torch.float64"),))]
    assert _checks(lint_ops(fed, target="fixture")) == {"float64-leak"}
    # a float64 output on another device than the solve's is not on its path
    assert lint_ops(fed, target="fixture", devices=("cuda:0",)) == []


@pytest.mark.parametrize("schedule,layout", sorted(HOST_READ_CONTRACT))
def test_lint_flags_reads_over_the_contract(schedule, layout):
    per_it = read_contract(schedule, layout)
    read = OpRecord("aten._local_scalar_dense.default", ("cpu",))
    allowed = [read] * (per_it * 3)
    assert lint_ops(allowed, target="fixture", schedule=schedule, layout=layout,
                    iterations=3) == []
    over = lint_ops(allowed + [read], target="fixture", schedule=schedule,
                    layout=layout, iterations=3)
    assert _checks(over) == {"host-reads"}


def test_reads_from_a_card_count_and_reads_of_the_host_do_not():
    to_host = OpRecord("aten._to_copy.default", ("cuda:0",), (("cpu", "torch.float32"),))
    upload = OpRecord("aten._to_copy.default", ("cpu",), (("cuda:0", "torch.float32"),))
    host_scalar = OpRecord("aten._local_scalar_dense.default", ("cpu",))
    kw = dict(target="fixture", schedule="barrier", iterations=1, uploads=1,
              devices=("cuda:0",))
    assert lint_ops([to_host, upload, host_scalar, host_scalar], **kw) == []
    assert _checks(lint_ops([to_host, to_host], **kw)) == {"host-reads"}


def test_lint_flags_an_upload_on_every_iteration():
    upload = OpRecord("aten._to_copy.default", ("cpu",), (("cuda:0", "torch.float32"),))
    kw = dict(target="fixture", schedule="barrier", iterations=3, devices=("cuda:0",))
    # the teleport row of a variant that takes seeds is placed once a solve
    assert lint_ops([upload], uploads=upload_contract(("seeds",)), **kw) == []
    assert _checks(lint_ops([upload] * 3, uploads=upload_contract(("seeds",)),
                            **kw)) == {"device-transfer"}
    # a variant without seeds places everything in build
    assert upload_contract(()) == 0
    assert _checks(lint_ops([upload], **kw)) == {"device-transfer"}
    # recorded: a host list made a device tensor on each iteration
    with OpRecorder() as rec:
        x = torch.zeros(4, device="meta")
        for i in range(3):
            x = x + torch.tensor([float(i)] * 4).to("meta")
    assert _checks(lint_ops(rec.records, target="fixture", schedule="barrier",
                            iterations=3, devices=("meta",))) == {"device-transfer"}


def test_lint_flags_a_copy_to_a_device_outside_the_solve():
    with OpRecorder() as rec:
        torch.ones(3).to("meta")
    assert _checks(lint_ops(rec.records, target="fixture")) == {"device-transfer"}
    assert lint_ops(rec.records, target="fixture", devices=("cpu", "meta")) == []
    other_card = OpRecord("aten.copy_.default", ("cuda:0", "cuda:1"),
                          (("cuda:0", "torch.float32"),))
    assert _checks(lint_ops([other_card], target="fixture", devices=("cuda:0",))) == {
        "device-transfer"}
    # between two devices of the mesh it is the exchange
    assert lint_ops([other_card], target="fixture", devices=("cuda:0", "cuda:1")) == []


@pytest.mark.parametrize("op", ["exchange.all_gather", "exchange.topk"])
def test_lint_flags_collective_only_under_nosync(op):
    recs = [OpRecord(op)]
    assert _checks(lint_ops(recs, target="fixture", schedule="nosync")) == {
        "collective-in-nosync"}
    # the same exchange under a barrier schedule is the barrier the metadata
    # declares
    assert lint_ops(recs, target="fixture", schedule="barrier") == []


@pytest.mark.parametrize("topk", [False, True])
def test_exchange_counter_counts_one_a_round(topk):
    from repro_torch.analysis.trace_lint import tiny_graph
    from repro_torch.core.distributed import (
        ShardMesh, distributed_pagerank, distributed_pagerank_topk, exchange_counts,
        reset_exchange_counts,
    )
    from repro_torch.core.pagerank import PartitionedGraph

    mesh = ShardMesh(("cpu",) * 2)
    pg = PartitionedGraph.from_graph(tiny_graph(), p=2, device="cpu")
    reset_exchange_counts()
    if topk:
        r = distributed_pagerank_topk(pg, mesh, send_fraction=0.5, threshold=1e-6)
    else:
        r = distributed_pagerank(pg, mesh, mode="stale", threshold=1e-6)
    counts = exchange_counts()
    assert counts == {"all_gather": 0 if topk else r.iterations,
                      "topk": r.iterations if topk else 0}
    reset_exchange_counts()
    assert exchange_counts() == {"all_gather": 0, "topk": 0}


def test_untraceable_is_a_finding_not_a_crash(monkeypatch):
    from repro_torch.analysis import trace_lint

    monkeypatch.setattr(trace_lint, "tiny_graph", lambda: None)
    rep = trace_variant("blocked", "cpu")
    assert _triples(rep.findings) == [("trace", "blocked", "untraceable")]
    rep = trace_lint.trace_engine("torch", {}, "cpu")
    assert _triples(rep.findings) == [("trace", "serving_torch", "untraceable")]


@pytest.mark.skipif(torch.cuda.is_available(), reason="holds the run without a card")
def test_trace_needs_a_card_unless_asked_for_the_cpu():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trace_variant("barrier", "cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trace_engine("torch", {}, "cuda")


@pytest.fixture(scope="module")
def port_reports():
    return {r.target: r for r in trace_reports("cpu")}


@pytest.fixture(scope="module")
def reference_keys():
    from repro.analysis.jaxpr_lint import jaxpr_findings, serving_findings

    keys = collections.defaultdict(set)
    for f in jaxpr_findings() + serving_findings():
        keys[f.target].add(f.check)
    return keys


@pytest.mark.parametrize("name", TRACED)
def test_trace_keys_are_the_references(name, port_reports, reference_keys):
    """The port's check keys of every traced target equal the reference's
    jaxpr lint's under the name map.  Where the reference cannot trace
    (its Pallas Gauss–Seidel kernels under jax 0.9.0) the port is held to
    no finding, which the reference's clean-run test asserts.  ``host-reads``
    is the port's own check (its engine loop is on the host): it fires, and
    is suppressed, on the sweep-count read alone."""
    want = reference_keys.get(REF_NAME.get(name, name), set()) - {"untraceable"}
    got = {f.check for f in port_reports[name].findings}
    assert got - {"host-reads"} == want
    assert ("host-reads" in got) == (name in SWEEP_READ)


@pytest.mark.parametrize("name", TRACED)
def test_trace_reads_within_the_contract(name, port_reports):
    rep = port_reports[name]
    assert rep.iterations > 0
    assert rep.uploads <= rep.upload_contract
    if (rep.schedule, rep.layout) == ("nosync", "serving"):
        assert rep.reads == 0
    else:
        # the CPU sees every read of solve's stop rule and the sweep count
        # (a scalar read); the adaptive plan's tolist() only on the card
        assert rep.reads == rep.iterations + (name in SWEEP_READ)


def test_trace_sees_the_exchanges_of_the_distributed_solvers(port_reports):
    for name, kind in (("distributed_barrier", "all_gather"),
                       ("distributed_stale", "all_gather"), ("distributed_topk", "topk")):
        rep = port_reports[name]
        assert rep.exchanges[kind] == rep.iterations


# ---------------------------------------------------------------------------
# contracts pass: every broken run through both packages' audits
# ---------------------------------------------------------------------------


def _result(pr):
    from repro_torch.core.solver import PageRankResult

    return PageRankResult(pr, 0, 0.0)


def _cannot_receive(bundle, *, threshold=1e-8, max_iter=100):
    return _result(bundle)


def _drops_explicit(bundle, *, handle_dangling=False, **kw):
    return _result(bundle)  # accepts the flag, ignores it


def _kw_never_forwarded(bundle, **kw):
    return _result(bundle)


@pytest.mark.parametrize("run,phrase", [
    (_cannot_receive, "cannot receive"),
    (_drops_explicit, "never reads it"),
    (_kw_never_forwarded, "never"),
])
def test_contracts_flag_broken_runs_as_the_reference(run, phrase):
    from repro.analysis.contracts import audit_dangling_flow as ref_audit

    port = audit_dangling_flow(run, target="fixture")
    ref = ref_audit(run, target="fixture")
    assert _checks(port) == _checks(ref) == {"dangling-flow"}
    assert phrase in port[0].message and phrase in ref[0].message


def test_contracts_accept_real_plumbing_shapes_as_the_reference():
    from repro.analysis.contracts import audit_dangling_flow as ref_audit

    def explicit(bundle, *, handle_dangling=False, **kw):
        return _result(bundle if not handle_dangling else bundle)

    def forwards(bundle, **kw):
        return explicit(bundle, **kw)

    def _filter(kw):
        return {k: v for k, v in kw.items() if k == "handle_dangling"}

    helper = lambda b, **kw: explicit(b, **_filter(kw))  # noqa: E731

    for run in (explicit, forwards, helper):
        assert not audit_dangling_flow(run, target="fixture"), run
        assert not ref_audit(run, target="fixture"), run


def test_contracts_metadata_vocabulary():
    good = get_variant("nosync")
    assert not audit_metadata(good)
    bad = dataclasses.replace(good, schedule="async", description="", backend="pallas")
    assert _checks(audit_metadata(bad)) == {"metadata-empty", "metadata-vocabulary"}


def test_register_variant_rejects_bad_metadata_at_registration():
    from repro_torch.core.solver import _REGISTRY, register_variant

    with pytest.raises(ValueError, match="description"):
        register_variant("bad_fixture", build=lambda g, **_: g,
                         run=lambda b, **kw: None, description="", layout="host",
                         backend="numpy", schedule="sequential")
    with pytest.raises(ValueError, match="backend"):
        register_variant("bad_fixture", build=lambda g, **_: g,
                         run=lambda b, **kw: None, description="x", layout="host",
                         backend="tpu", schedule="sequential")
    assert "bad_fixture" not in _REGISTRY


def test_contract_audit_clean_per_variant():
    audit = audit_registry()
    assert len(audit) == 22
    assert all(not fs for fs in audit.values()), \
        {k: [f.to_dict() for f in v] for k, v in audit.items() if v}


def test_launcher_list_shows_the_contract_column(capsys):
    from repro_torch.launch import pagerank_run

    report = pagerank_run.run(["--list"])
    assert report["contract"] == {name: [] for name in list_variants()}
    lines = capsys.readouterr().out.splitlines()
    assert "contract" in lines[0]
    rows = lines[2:]
    assert len(rows) == 22 and all("✓" in row for row in rows)


def test_launcher_list_shows_a_failed_check(monkeypatch, capsys):
    from repro_torch.core import solver
    from repro_torch.launch import pagerank_run

    v = solver._REGISTRY["barrier"]
    monkeypatch.setitem(solver._REGISTRY, "barrier", dataclasses.replace(v, run=_drops_explicit))
    report = pagerank_run.run(["--list"])
    assert report["contract"]["barrier"] == ["dangling-flow"]
    row = next(line for line in capsys.readouterr().out.splitlines()
               if line.startswith("barrier "))
    assert "dangling-flow" in row and "✓" not in row


# ---------------------------------------------------------------------------
# markers pass: triple for triple the reference's
# ---------------------------------------------------------------------------


def test_markers_pass_clean_on_repo_as_the_reference():
    from repro.analysis.markers import marker_findings as ref_markers
    from repro_torch.analysis.markers import marker_findings, registered_markers

    assert {"tier1", "slow", "subprocess", "cuda"} <= registered_markers()
    assert marker_findings() == [] == ref_markers()


def _write_tree(root, ini: str | None, files: dict[str, str]):
    if ini is not None:
        (root / "pytest.ini").write_text(ini)
    tests = root / "tests"
    tests.mkdir()
    for name, text in files.items():
        (tests / name).write_text(text)


INI = ("[pytest]\nmarkers =\n    tier1: gate\n    slow: slow tier\n"
       "    subprocess: spawns workers\n")
BAD = ("import subprocess\nimport pytest\nimport sys\n"
       "@pytest.mark.tier1\n@pytest.mark.sloow\n"
       "def test_a():\n    subprocess.run([sys.executable, '-V'])\n"
       "@pytest.mark.subprocess\ndef test_b():\n    pass\n")
MODULE_MARKED = ("import subprocess\nimport pytest\nimport sys\n"
                 "pytestmark = [pytest.mark.slow, pytest.mark.subprocess]\n"
                 "def test_a():\n    subprocess.run([sys.executable, '-V'])\n")


@pytest.mark.parametrize("ini,files,want", [
    (INI, {"test_bad.py": BAD}, {"unregistered-marker", "explicit-tier1",
                                 "unmarked-subprocess", "subprocess-not-slow"}),
    (None, {"test_bad.py": BAD}, {"missing-config", "unregistered-marker",
                                  "explicit-tier1", "unmarked-subprocess",
                                  "subprocess-not-slow"}),
    (INI, {"test_mod.py": MODULE_MARKED}, set()),
    ("[pytest]\nmarkers =\n    tier1: a\n", {"test_mod.py": MODULE_MARKED},
     {"missing-config", "unregistered-marker"}),
], ids=["violations", "no-ini", "module-pytestmark", "tiers-missing"])
def test_markers_pass_flags_violations_as_the_reference(tmp_path, ini, files, want):
    from repro.analysis.markers import marker_findings as ref_markers
    from repro_torch.analysis.markers import marker_findings

    _write_tree(tmp_path, ini, files)
    port = marker_findings(tmp_path)
    assert _checks(port) == want
    assert _triples(port) == _triples(ref_markers(tmp_path))


# ---------------------------------------------------------------------------
# the whole slice: clean run, suppressions, CLI
# ---------------------------------------------------------------------------


def test_full_registry_runs_clean_and_suppressions_fire():
    from repro_torch.analysis import run_all

    findings = run_all("cpu")
    assert unsuppressed(findings) == [], [f.to_dict() for f in findings]
    fired = {(f.target, f.check) for f in findings if f.suppressed}
    assert fired == {("distributed_stale", "collective-in-nosync"),
                     ("distributed_topk", "collective-in-nosync")} | {
        (name, "host-reads") for name in SWEEP_READ}


def test_suppressions_do_not_hide_new_findings():
    fresh = Finding("trace", "distributed_stale", "host-reads", "fixture")
    known = Finding("trace", "distributed_stale", "collective-in-nosync", "x")
    other_pass = Finding("kernels", "distributed_stale", "collective-in-nosync", "x")
    out = apply_suppressions([fresh, known, other_pass])
    assert not fresh.suppressed and not other_pass.suppressed
    assert known.suppressed and known.reason
    assert unsuppressed(out) == [fresh, other_pass]


def test_cli_strict_on_the_cpu_exits_0(tmp_path, capsys):
    import json

    from repro_torch.analysis.__main__ import main

    out = tmp_path / "analysis.json"
    assert main(["--device", "cpu", "--strict", "--json", str(out)]) == 0
    text = capsys.readouterr().out
    assert "largest block 3,041" in text and "0 unsuppressed" in text
    assert "trace: nosync_adaptive (adaptive, partitioned)" in text
    report = json.loads(out.read_text())
    assert report["unsuppressed"] == 0 and len(report["trace"]) == len(TRACED)


def test_cli_strict_fails_on_an_unsuppressed_finding(monkeypatch, capsys):
    from repro_torch.analysis import __main__ as cli
    from repro_torch.analysis import markers

    monkeypatch.setattr(markers, "marker_findings",
                        lambda: [Finding("markers", "x.py", "explicit-tier1", "fixture")])
    assert cli.main(["--pass", "markers", "--strict"]) == 1
    assert "FINDING [markers] x.py: explicit-tier1" in capsys.readouterr().out
    assert cli.main(["--pass", "markers"]) == 0


@pytest.mark.skipif(torch.cuda.is_available(), reason="holds the run without a card")
def test_cli_without_a_card_exits_nonzero_and_says_why(capsys):
    from repro_torch.analysis.__main__ import main

    assert main([]) != 0
    assert "torch.cuda.is_available() is False" in capsys.readouterr().err


def test_ctypes_stand_in_is_what_the_drift_check_passes():
    """The drift check hands ``byref`` pointers to the library; the mirror
    stand-in writes through them as the C function does."""
    k, d_stages = ctypes.c_int(0), ctypes.c_int(0)
    got = _MirrorLib().gs_pass_plan(256, 0, K.H100_SMEM_OPTIN, ctypes.byref(k),
                                    ctypes.byref(d_stages))
    assert (k.value, d_stages.value, got) == K.gs_pass_plan(256, False)
