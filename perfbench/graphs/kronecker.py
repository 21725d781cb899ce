"""Graph500's Kronecker generator with LDBC Graphalytics' clean-up, on the
device.

The Graph500 specification's generator: each of ``edgefactor * 2**scale``
edges picks one quadrant per level of the recursive adjacency matrix with
probabilities A, B, C and 1 - A - B - C, and the vertex labels are then
scrambled by a random permutation.  Graphalytics' graph500 datasets are
that output with self-loops and duplicate edges removed and the isolated
vertices dropped; the rest are relabelled densely here (in order of the
scrambled label).  The program is handed the symmetrized directed edges.

Everything runs in plain torch from one ``torch.Generator`` on ``device``,
in a few large calls, so set-up stays short at scale 22 (67 M edges).
"""
from __future__ import annotations

import torch


def kronecker_edges(scale: int, edgefactor: int, a: float, b: float,
                    c: float, seed: int, device) -> tuple[torch.Tensor,
                                                          torch.Tensor]:
    """The raw generator output: ``(i, j)`` int64 endpoint labels of
    ``edgefactor * 2**scale`` edges in ``[0, 2**scale)``."""
    n = 1 << scale
    m = edgefactor * n
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    ab = a + b
    a_norm = a / ab
    c_norm = c / (1.0 - ab)
    i = torch.zeros(m, dtype=torch.int64, device=device)
    j = torch.zeros(m, dtype=torch.int64, device=device)
    for level in range(scale):
        ii = torch.rand(m, generator=gen, device=device) > ab
        thresh = torch.where(ii, c_norm, a_norm)
        jj = torch.rand(m, generator=gen, device=device) > thresh
        i |= ii.to(torch.int64) << level
        j |= jj.to(torch.int64) << level
    perm = torch.randperm(n, generator=gen, device=device)
    return perm[i], perm[j]


def graphalytics_clean(i: torch.Tensor, j: torch.Tensor, n: int
                       ) -> tuple[torch.Tensor, torch.Tensor, int, int]:
    """Drop self-loops and duplicate undirected edges, drop isolated
    vertices and relabel the rest densely.  Returns the symmetrized
    directed ``(src, dst)`` int32 tensors, the vertex count and the count
    of unique undirected edges."""
    keep = i != j
    i, j = i[keep], j[keep]
    key = torch.unique(torch.minimum(i, j) * n + torch.maximum(i, j))
    lo, hi = key // n, key % n
    present = torch.zeros(n, dtype=torch.bool, device=i.device)
    present[lo] = True
    present[hi] = True
    new_id = torch.cumsum(present.to(torch.int64), 0) - 1
    n_vertices = int(present.sum())
    lo, hi = new_id[lo].to(torch.int32), new_id[hi].to(torch.int32)
    return (torch.cat([lo, hi]), torch.cat([hi, lo]), n_vertices,
            int(key.numel()))


def make(cfg: dict, seed: int, device):
    """The configuration's graph: ``kronecker_edges`` then
    ``graphalytics_clean``."""
    from perfbench.graphs import Graph
    i, j = kronecker_edges(int(cfg["scale"]), int(cfg["edgefactor"]),
                           float(cfg["a"]), float(cfg["b"]),
                           float(cfg["c"]), seed, device)
    src, dst, n_vertices, _ = graphalytics_clean(i, j,
                                                 1 << int(cfg["scale"]))
    del i, j
    return Graph(src.cpu().numpy(), dst.cpu().numpy(), n_vertices, src, dst)
