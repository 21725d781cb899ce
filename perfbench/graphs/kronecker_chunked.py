"""Graph500's Kronecker generator with LDBC Graphalytics' clean-up, in
bounded device memory, for graphs that one card cannot clean whole.

The rules are :mod:`perfbench.graphs.kronecker`'s: each of ``edgefactor *
2**scale`` edges picks one quadrant per level of the recursive adjacency
matrix with probabilities A, B, C and 1 - A - B - C, the vertex labels are
scrambled by a random permutation, self-loops and duplicate undirected
edges are removed, the isolated vertices dropped and the rest relabelled
densely in order of the scrambled label; the program is handed the
symmetrized directed edges.

What differs is the memory.  The edges are drawn in chunks of
:data:`CHUNK` on ``device``, each chunk leaving only its undirected keys
``min * n + max`` (int64; a self-loop leaves -1); the keys are then
deduplicated one key range of :data:`RANGES` at a time, and the cleaned
edges are written straight into host arrays.  At scale 26 the device holds
the 1.07 G keys (8.6 GB), the unique keys of the ranges done so far and one
range's sort, some 25 GB, where :mod:`kronecker` holds about 80 GB.  The
returned graph keeps its edges on the host (``src_t`` / ``dst_t`` are CPU
views of ``src`` / ``dst``), so no card holds the graph while the program
runs.  The random stream is drawn chunk by chunk, so a seed gives another
graph than :mod:`kronecker` gives, of the same law.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from perfbench.graphs import Graph

CHUNK = 1 << 26          # edges drawn at once
RANGES = 8               # key ranges deduplicated one at a time


@dataclasses.dataclass
class HostGraph(Graph):
    """A cleaned graph on the host.  Every vertex has an edge (the
    clean-up drops the isolated ones), so ``n_connected`` is ``n`` without
    a count over the edges."""

    @property
    def n_connected(self) -> int:
        return self.n


def edge_keys(scale: int, edgefactor: int, a: float, b: float, c: float,
              seed: int, device) -> torch.Tensor:
    """The undirected keys ``min(i, j) * n + max(i, j)`` of the raw
    generator's ``edgefactor * 2**scale`` edges, scrambled labels, -1 for a
    self-loop: int64 on ``device``."""
    n = 1 << scale
    m = edgefactor * n
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    perm = torch.randperm(n, generator=gen, device=device)
    ab = a + b
    a_norm = a / ab
    c_norm = c / (1.0 - ab)
    keys = torch.empty(m, dtype=torch.int64, device=device)
    for lo in range(0, m, CHUNK):
        size = min(CHUNK, m - lo)
        i = torch.zeros(size, dtype=torch.int64, device=device)
        j = torch.zeros(size, dtype=torch.int64, device=device)
        for level in range(scale):
            ii = torch.rand(size, generator=gen, device=device) > ab
            thresh = torch.where(ii, c_norm, a_norm)
            jj = torch.rand(size, generator=gen, device=device) > thresh
            i |= ii.to(torch.int64) << level
            j |= jj.to(torch.int64) << level
        i, j = perm[i], perm[j]
        keys[lo:lo + size] = torch.where(
            i != j, torch.minimum(i, j) * n + torch.maximum(i, j), -1)
    return keys


def unique_by_range(keys: torch.Tensor, n: int) -> list[torch.Tensor]:
    """The unique keys in ``[0, n * n)``, one sorted tensor per key range
    of :data:`RANGES`, in order (so their concatenation is sorted)."""
    cuts = [n * n * r // RANGES for r in range(RANGES + 1)]
    return [torch.unique(keys[(keys >= lo) & (keys < hi)], sorted=True)
            for lo, hi in zip(cuts[:-1], cuts[1:])]


def make(cfg: dict, seed: int, device) -> HostGraph:
    """The configuration's graph, its edges on the host."""
    scale = int(cfg["scale"])
    n = 1 << scale
    keys = edge_keys(scale, int(cfg["edgefactor"]), float(cfg["a"]),
                     float(cfg["b"]), float(cfg["c"]), seed, device)
    parts = unique_by_range(keys, n)
    del keys
    present = torch.zeros(n, dtype=torch.bool, device=device)
    for u in parts:
        present[u // n] = True
        present[u % n] = True
    new_id = torch.cumsum(present.to(torch.int64), 0) - 1
    n_vertices = int(present.sum())
    del present
    e = sum(int(u.numel()) for u in parts)
    src = np.empty(2 * e, np.int32)
    dst = np.empty(2 * e, np.int32)
    at = 0
    for r, u in enumerate(parts):
        k = int(u.numel())
        lo = new_id[u // n].to(torch.int32).cpu()
        hi = new_id[u % n].to(torch.int32).cpu()
        parts[r] = None
        for out, first, second in ((src, lo, hi), (dst, hi, lo)):
            torch.from_numpy(out[at:at + k]).copy_(first)
            torch.from_numpy(out[e + at:e + at + k]).copy_(second)
        at += k
    return HostGraph(src, dst, n_vertices, torch.from_numpy(src),
                     torch.from_numpy(dst))
