"""The benchmark's copy of the port's R-MAT generator gives what the
port's original gives: the quadrant walk bit for bit on the port's own
uniforms, and the configurations' sizes and parameters."""
import numpy as np
import pytest
import torch

from bench import graphgen, harness

from conftest import ROOT


@pytest.mark.parametrize("scale,m,abc,seed", [
    (8, 3000, (0.57, 0.19, 0.19), 0),
    (10, 9000, (0.60, 0.19, 0.19), 2**31 + 7),
    (12, 20000, (0.30, 0.25, 0.25), 12345),
])
def test_rmat_equals_the_ports(scale, m, abc, seed):
    from repro_torch.graphs.rmat import rmat_edges

    want = rmat_edges(scale, m, *abc, seed=seed)
    # the port's stream: scale levels of m doubles, then the permutation
    rng = np.random.default_rng(seed)
    src, dst = graphgen.quadrant_walk(
        [torch.from_numpy(rng.random(m)) for _ in range(scale)], *abc)
    perm = torch.from_numpy(rng.permutation(1 << scale))
    for w, g in zip(want, (perm[src].to(torch.int32), perm[dst].to(torch.int32))):
        assert np.array_equal(w, g.numpy())


def test_fold_and_scale_equal_the_ports():
    from repro_torch.graphs.datasets import _dataset_rmat_params

    n, m, abc = _dataset_rmat_params("socLiveJournal1", 1)
    c = harness.load_json(ROOT / "bench" / "configs" / "soc-livejournal1.json")
    assert (c["n"], c["m"]) == (n, m)
    assert (c["rmat"]["a"], c["rmat"]["b"], c["rmat"]["c"]) == abc
    assert graphgen.scale_of(4_847_571) == 23 and graphgen.scale_of(50) == 6


def test_surrogate_is_the_seeds_relabeling():
    cfg = {"n": 5000, "m": 40000, "graph_seed": 0, "block": 256,
           "rmat": {"a": 0.57, "b": 0.19, "c": 0.19}}
    seed = 2**33 + 5  # more than 32 signed bits hold
    a = graphgen.surrogate_edges(cfg, seed, "cpu")
    b = graphgen.surrogate_edges(cfg, seed, "cpu")
    c = graphgen.surrogate_edges(cfg, seed + 1, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    for t in a[:2]:
        assert t.dtype == torch.int32 and t.numel() == 40000
        assert int(t.min()) >= 0 and int(t.max()) < 5000
    # the same structure: undoing each seed's relabeling gives one edge list
    undo = [(torch.argsort(r)[s.long()], torch.argsort(r)[d.long()]) for s, d, r in (a, c)]
    assert torch.equal(undo[0][0], undo[1][0]) and torch.equal(undo[0][1], undo[1][1])
    # each vertex stays in its block of 256 (the last block holds 136)
    for relabel in (a[2], c[2]):
        assert torch.equal(relabel // 256, torch.arange(5000) // 256)
        assert torch.equal(torch.sort(relabel).values, torch.arange(5000))
