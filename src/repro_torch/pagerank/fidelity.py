"""Rank-fidelity metrics for reduced-precision PageRank.

The port's own copy of ``repro.pagerank.fidelity`` (pure numpy; the port
imports nothing of the JAX package).

L1 distance is the wrong lens for quantized ranks: a bf16-stored operator
shifts every score by O(eps) relative — a large L1 number — while leaving
the *ordering* (what PageRank is actually used for) essentially intact.
These metrics measure what serving cares about: does the top-k set and its
internal order survive the precision cut?

All functions take two (n,) score vectors (any array-like, CPU tensors
included; computed host-side in float64 so the metric itself never adds
rounding noise) and treat ``ref`` as the ground-truth ranking.
"""
from __future__ import annotations

import numpy as np

__all__ = ["topk_overlap", "kendall_tau", "l1"]


def _as1d(x) -> np.ndarray:
    a = np.asarray(x, np.float64).ravel()
    return a


def topk_overlap(scores, ref, k: int = 100) -> float:
    """|top-k(scores) ∩ top-k(ref)| / k — set agreement of the two top-k
    lists, order-insensitive.  1.0 means the reduced-precision tier
    surfaces exactly the same top-k nodes."""
    a, b = _as1d(scores), _as1d(ref)
    k = min(k, a.size)
    if k == 0:
        return 1.0
    ta = np.argpartition(-a, k - 1)[:k]
    tb = np.argpartition(-b, k - 1)[:k]
    return float(len(np.intersect1d(ta, tb)) / k)


def kendall_tau(scores, ref, k: int = 100) -> float:
    """Kendall tau-a rank correlation over the reference's top-k nodes:
    concordant minus discordant pairs over all pairs (ties count zero).
    Pairwise O(k²) in numpy — no scipy dependency; k=100 is ~5k pairs."""
    a, b = _as1d(scores), _as1d(ref)
    k = min(k, a.size)
    if k < 2:
        return 1.0
    idx = np.argpartition(-b, k - 1)[:k]
    sa, sb = a[idx], b[idx]
    da = np.sign(sa[:, None] - sa[None, :])
    db = np.sign(sb[:, None] - sb[None, :])
    iu = np.triu_indices(k, 1)
    return float(np.sum(da[iu] * db[iu]) / iu[0].size)


def l1(scores, ref) -> float:
    """Plain L1 distance — kept alongside the rank metrics so reports can
    show both the (large-looking) score drift and the (near-perfect)
    ordering fidelity of a reduced tier."""
    return float(np.sum(np.abs(_as1d(scores) - _as1d(ref))))
