"""Protein-interaction-style network generators (host-side data pipeline).

The paper analyzes protein networks (hu.MAP 2.0 / HuRI-like).  Those are
scale-free, sparse, undirected graphs.  We generate synthetic stand-ins with
the same statistics: Barabási–Albert preferential attachment (scale-free,
the default "protein network"), Erdős–Rényi (control), plus a loader for
tab/space-separated edge lists so real datasets drop in unchanged.

All generators return a deduplicated, symmetrized COO edge list
``(src, dst)`` of ``int32`` numpy arrays — the canonical interchange format
for ``graph.transition``.
"""
from __future__ import annotations

import numpy as np


def _dedupe_symmetrize(src: np.ndarray, dst: np.ndarray,
                       n: int) -> tuple[np.ndarray, np.ndarray]:
    """Symmetrize an undirected edge list, drop self-loops and duplicates."""
    mask = src != dst
    src, dst = src[mask], dst[mask]
    a = np.concatenate([src, dst])
    b = np.concatenate([dst, src])
    key = a.astype(np.int64) * n + b
    _, idx = np.unique(key, return_index=True)
    return a[idx].astype(np.int32), b[idx].astype(np.int32)


def erdos_renyi(n: int, avg_degree: float = 8.0,
                seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """G(n, p) with p chosen for the given expected degree."""
    rng = np.random.default_rng(seed)
    m = int(n * avg_degree / 2)
    src = rng.integers(0, n, size=2 * m, dtype=np.int64)
    dst = rng.integers(0, n, size=2 * m, dtype=np.int64)
    return _dedupe_symmetrize(src, dst, n)


def barabasi_albert(n: int, m_edges: int = 4,
                    seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Preferential attachment: each new node attaches to ``m_edges``
    existing nodes with probability proportional to degree.  Produces the
    heavy-tailed degree distribution typical of protein interactomes."""
    rng = np.random.default_rng(seed)
    if n <= m_edges:
        raise ValueError("need n > m_edges")
    # Efficient BA via the repeated-nodes trick: targets sampled uniformly
    # from a list in which each node appears once per unit of degree.
    repeated: list[int] = []
    src_list: list[int] = []
    dst_list: list[int] = []
    # seed clique over the first m_edges+1 nodes
    for i in range(m_edges + 1):
        for j in range(i + 1, m_edges + 1):
            src_list.append(i)
            dst_list.append(j)
            repeated += [i, j]
    for v in range(m_edges + 1, n):
        targets = set()
        while len(targets) < m_edges:
            # mix of preferential attachment and uniform fallback
            if repeated and rng.random() < 0.9:
                targets.add(repeated[rng.integers(len(repeated))])
            else:
                targets.add(int(rng.integers(0, v)))
        for t in targets:
            src_list.append(v)
            dst_list.append(t)
            repeated += [v, t]
    return _dedupe_symmetrize(np.array(src_list, np.int64),
                              np.array(dst_list, np.int64), n)


def protein_network(n: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Synthetic protein-interaction network: scale-free BA backbone with
    ~hu.MAP-like mean degree (~8) plus a sprinkle of random "noise" edges
    (false-positive interactions) and 1% isolated proteins (dangling nodes —
    exercising the PageRank dangling fix)."""
    rng = np.random.default_rng(seed)
    src, dst = barabasi_albert(n, m_edges=4, seed=seed)
    # noise edges: 5% extra random interactions
    k = max(1, int(0.05 * len(src) / 2))
    ns = rng.integers(0, n, size=k, dtype=np.int64)
    nd = rng.integers(0, n, size=k, dtype=np.int64)
    src, dst = _dedupe_symmetrize(np.concatenate([src.astype(np.int64), ns]),
                                  np.concatenate([dst.astype(np.int64), nd]),
                                  n)
    # isolate ~1% of nodes (remove all their edges) -> dangling columns
    iso = rng.choice(n, size=max(1, n // 100), replace=False)
    iso_set = np.isin(src, iso) | np.isin(dst, iso)
    return src[~iso_set], dst[~iso_set]


def load_edge_list(path: str, n: int | None = None
                   ) -> tuple[np.ndarray, np.ndarray, int]:
    """Load a whitespace-separated ``src dst`` edge list (hu.MAP/HuRI dump
    format).  Returns (src, dst, n_nodes)."""
    data = np.loadtxt(path, dtype=np.int64, usecols=(0, 1), comments="#")
    data = np.atleast_2d(data)
    src, dst = data[:, 0], data[:, 1]
    n = int(max(src.max(), dst.max()) + 1) if n is None else n
    s, d = _dedupe_symmetrize(src, dst, n)
    return s, d, n


def degrees(src: np.ndarray, n: int) -> np.ndarray:
    """Out-degree per node of the directed expansion (== degree, symmetric)."""
    return np.bincount(src, minlength=n).astype(np.int64)
