"""The plain reference against a dense float64 numpy power iteration on
tiny graphs, and its lower-precision control against its judges."""
import numpy as np
import pytest
import torch

from bench import reference


def tiny_graph(n=60, m=300, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    src[:5] = dst[:5] = 1  # parallel edges and a self loop
    return n, src, dst


def columns(n, seed_sets):
    """Teleport columns: uniform over each seed set, over every vertex for
    the empty set."""
    t = torch.zeros((n, len(seed_sets)), dtype=torch.float64)
    for j, seeds in enumerate(seed_sets):
        t[list(seeds) or slice(None), j] = 1.0 / (len(set(seeds)) or n)
    return t


def dense_pagerank(n, src, dst, tele, d, dangling, iters=3000):
    out = np.bincount(src, minlength=n).astype(np.float64)
    a = np.zeros((n, n))
    for u, v in zip(src, dst):
        a[v, u] += 1.0 / out[u]
    x = tele.copy()
    for _ in range(iters):
        x = (1 - d) * tele + d * a @ x + (d * x[out == 0].sum(0) / n if dangling else 0)
    return x


@pytest.mark.parametrize("dangling", [True, False])
def test_fixed_points(dangling):
    n, src, dst = tiny_graph()
    sets = [(), (3,), (4, 9, 9), (0, 59)]
    tele = columns(n, sets)
    want = dense_pagerank(n, src, dst, tele.numpy(), 0.85, dangling)
    op = reference.Operator(n, torch.from_numpy(src), torch.from_numpy(dst))
    got, first = reference.iterate(op, tele, d=0.85, dangling=dangling, stop=1e-8)
    assert np.abs(got.numpy() - want).max() < 1e-14
    assert all(0 < f < reference.MAX_ITER for f in first)


def test_stop_rule_counts_the_first_step_under_it():
    n, src, dst = tiny_graph(seed=1)
    tele = columns(n, [()])
    op = reference.Operator(n, torch.from_numpy(src), torch.from_numpy(dst))
    _, first = reference.iterate(op, tele, d=0.85, dangling=True, stop=1e-6, tight=False)
    x, steps = tele, []
    for _ in range(first[0]):
        new = op.step(x, tele, 0.85, True)
        steps.append(float((new - x).abs().max()))
        x = new
    assert steps[-1] <= 1e-6 < min(steps[:-1])


def test_judges():
    ref = torch.tensor([0.5, 0.2, 0.2, 0.1], dtype=torch.float64)
    assert reference.judge_ranks(ref.clone(), ref) == {"l1": 0.0, "max_rel": 0.0}
    r = reference.judge_ranks(ref * torch.tensor([1, 1, 1, 1.1], dtype=torch.float64), ref)
    assert r["max_rel"] == pytest.approx(0.1) and r["l1"] == pytest.approx(0.01)
    assert np.isnan(reference.judge_ranks(ref * np.nan, ref)["l1"])
