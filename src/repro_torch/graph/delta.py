"""Edge-set canonicalization: the subset of ``repro.graph.delta`` that the
engine's edge-set contract needs.

:func:`edge_keys` is the sorted-key set representation of a directed edge
list; :func:`dedupe_directed` collapses duplicate directed edges.  The
streaming-delta records (``GraphDelta``, ``apply_delta``, ``EdgeStream``)
are not ported yet.
"""
from __future__ import annotations

import numpy as np

__all__ = ["dedupe_directed", "edge_keys"]


def edge_keys(src: np.ndarray, dst: np.ndarray, n: int) -> np.ndarray:
    """Sorted unique int64 keys ``src * n + dst`` of a directed edge list —
    the set representation every delta operation works on."""
    return np.unique(np.asarray(src, np.int64) * int(n)
                     + np.asarray(dst, np.int64))


def dedupe_directed(src: np.ndarray, dst: np.ndarray, n: int,
                    drop_self_loops: bool = True
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Collapse duplicate directed edges (no symmetrization).  The engine
    passes ``drop_self_loops=False``: the transition matrices support
    self-loops, so they stay."""
    src, dst = np.asarray(src, np.int64), np.asarray(dst, np.int64)
    if drop_self_loops:
        mask = src != dst
        src, dst = src[mask], dst[mask]
    keys = np.unique(src * int(n) + dst)
    return (keys // n).astype(np.int32), (keys % n).astype(np.int32)
