"""Sizes cycling through ``seed_set_sizes``, each vertex drawn by
Zipf(``zipf_s``) over a seeded random ranking of all vertices, the ranks
taken at the midpoint quantiles of that law and shuffled (``zipf_s = 0``
is uniform)."""
from __future__ import annotations

import numpy as np


def ranks(count: int, n: int, s: float, rng) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** s
    cdf = np.cumsum(w) / w.sum()
    u = (np.arange(count) + 0.5) / count
    return rng.permutation(np.minimum(np.searchsorted(cdf, u), n - 1))


def sets(count: int, graph, traffic: dict, rng) -> list:
    n = graph.n
    sizes = np.resize(np.asarray(traffic["seed_set_sizes"], np.int64), count)
    sizes = rng.permutation(sizes)
    ranking = rng.permutation(n)
    vertices = ranking[ranks(int(sizes.sum()), n, float(traffic["zipf_s"]),
                             rng)]
    return [np.unique(p) for p in np.split(vertices, np.cumsum(sizes)[:-1])]
