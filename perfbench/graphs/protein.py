"""A frozen copy of the synthetic protein-interaction network.

The benchmark's own copy of ``protein_network`` (Barabási–Albert backbone,
5 % noise edges, 1 % isolated proteins), so that a later change to the
program's generator cannot change the graphs the benchmark measures.  Same
numpy calls in the same order: seed 0 at n = 5000 gives 41,102 directed
edges and 50 dangling nodes.
"""
from __future__ import annotations

import numpy as np


def dedupe_symmetrize(src: np.ndarray, dst: np.ndarray,
                      n: int) -> tuple[np.ndarray, np.ndarray]:
    """Symmetrize an undirected edge list, drop self-loops and duplicates;
    the result is sorted by ``src * n + dst``."""
    mask = src != dst
    src, dst = src[mask], dst[mask]
    a = np.concatenate([src, dst])
    b = np.concatenate([dst, src])
    key = a.astype(np.int64) * n + b
    _, idx = np.unique(key, return_index=True)
    return a[idx].astype(np.int32), b[idx].astype(np.int32)


def barabasi_albert(n: int, m_edges: int, rng) -> tuple[np.ndarray,
                                                         np.ndarray]:
    """Preferential attachment by the repeated-nodes trick, with a tenth
    of the targets drawn uniformly."""
    repeated: list[int] = []
    src_list: list[int] = []
    dst_list: list[int] = []
    for i in range(m_edges + 1):
        for j in range(i + 1, m_edges + 1):
            src_list.append(i)
            dst_list.append(j)
            repeated += [i, j]
    for v in range(m_edges + 1, n):
        targets = set()
        while len(targets) < m_edges:
            if repeated and rng.random() < 0.9:
                targets.add(repeated[rng.integers(len(repeated))])
            else:
                targets.add(int(rng.integers(0, v)))
        for t in targets:
            src_list.append(v)
            dst_list.append(t)
            repeated += [v, t]
    return dedupe_symmetrize(np.array(src_list, np.int64),
                             np.array(dst_list, np.int64), n)


def protein_network(n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Directed symmetric int32 COO ``(src, dst)`` of the network."""
    rng = np.random.default_rng(seed)
    src, dst = barabasi_albert(n, 4, np.random.default_rng(seed))
    k = max(1, int(0.05 * len(src) / 2))
    ns = rng.integers(0, n, size=k, dtype=np.int64)
    nd = rng.integers(0, n, size=k, dtype=np.int64)
    src, dst = dedupe_symmetrize(np.concatenate([src.astype(np.int64), ns]),
                                 np.concatenate([dst.astype(np.int64), nd]),
                                 n)
    iso = rng.choice(n, size=max(1, n // 100), replace=False)
    gone = np.isin(src, iso) | np.isin(dst, iso)
    return src[~gone], dst[~gone]


def make(cfg: dict, seed: int, device):
    """The configuration's graph: ``protein_network(cfg["n"], seed)``,
    every protein kept (the isolated ones are the dangling nodes)."""
    from perfbench.graphs import Graph
    src, dst = protein_network(int(cfg["n"]), seed)
    return Graph.from_numpy(src, dst, int(cfg["n"]), device)
