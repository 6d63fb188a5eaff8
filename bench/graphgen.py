"""R-MAT surrogates of the paper's Table 1 graphs, made from a seed.

A copy of the port's generator (``graphs/rmat.py::rmat_edges``, folded to
``n`` vertices as ``graphs/datasets.py`` folds it), kept here so that the
yardstick does not move when the program does.  :func:`quadrant_walk` is
the port's arithmetic (``bench/tests/test_copies.py`` holds it to the
port's edges on the port's own uniforms); the benchmark draws its
uniforms from a ``torch.Generator`` on the device the edges are made on
(the full soc-LiveJournal1 surrogate takes about a second on the card
against most of a minute for the port's numpy stream on the host).  The
benchmark's graph is the configuration's structure with its vertices
relabeled by the run's seed inside their blocks.
"""
from __future__ import annotations

import math
from typing import Iterable

import torch


def quadrant_walk(levels: Iterable[torch.Tensor], a: float, b: float,
                  c: float) -> tuple[torch.Tensor, torch.Tensor]:
    """``(src, dst)`` int64 cells of the ``2**scale`` square, one level a
    uniform tensor: quadrant a (top left), b (top right), c (bottom left),
    d (bottom right)."""
    src = dst = None
    for r in levels:
        right = ((r >= a) & (r < a + b)) | (r >= a + b + c)
        down = r >= a + b
        if src is None:
            src = down.to(torch.int64)
            dst = right.to(torch.int64)
        else:
            src = src * 2 + down
            dst = dst * 2 + right
        del right, down
    return src, dst


def scale_of(n: int) -> int:
    """The R-MAT scale the port folds ``n`` vertices from."""
    return max(6, math.ceil(math.log2(n)))


def surrogate_edges(config: dict, seed: int, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The ``config``'s graph, relabeled by ``seed``: int32 ``(src, dst)``
    tensors of its ``m`` edges over its ``n`` vertices on ``device``, and
    the int64 ``(n,)`` relabeling.

    The structure is the configuration's: ``m`` R-MAT edges drawn by a
    ``torch.Generator`` seeded with its ``graph_seed`` (float32 level
    draws, a permutation of the ``2**scale`` ids, the fold ``id % n``).
    ``seed`` draws a relabeling that permutes the ids inside each block of
    ``block`` consecutive ids, so that every seed hands the program another
    in-CSR while the blocks, and the order a Gauss–Seidel pass walks them
    in, keep their vertices: every seed runs the same work."""
    n, m, block = int(config["n"]), int(config["m"]), int(config["block"])
    p = config["rmat"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(config["graph_seed"]))
    scale = scale_of(n)
    src, dst = quadrant_walk(
        (torch.rand(m, generator=gen, device=device) for _ in range(scale)),
        p["a"], p["b"], p["c"])
    perm = torch.randperm(1 << scale, generator=gen, device=device)
    gen.manual_seed(int(seed))
    ids = torch.arange(n, device=device)
    key = (ids // block).to(torch.float64) + torch.rand(n, generator=gen, device=device,
                                                       dtype=torch.float64)
    relabel = torch.empty_like(ids)
    relabel[torch.argsort(key)] = ids
    src = relabel[torch.remainder(perm[src], n)].to(torch.int32)
    dst = relabel[torch.remainder(perm[dst], n)].to(torch.int32)
    return src, dst, relabel
