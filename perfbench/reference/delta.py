"""Edge deltas on an undirected graph, with set semantics.

A graph is the sorted array of its undirected keys ``u * n + v`` with
``u < v``.  A delta is applied deletes first, then inserts: the new edge
set is ``(E \\ deleted) | inserted``, so deleting a missing edge or
inserting a present one changes nothing.
"""
from __future__ import annotations

import numpy as np


def undirected_keys(src: np.ndarray, dst: np.ndarray, n: int) -> np.ndarray:
    lo = np.minimum(src, dst).astype(np.int64)
    hi = np.maximum(src, dst).astype(np.int64)
    return np.unique(lo * n + hi)


def pair_keys(pairs: np.ndarray, n: int) -> np.ndarray:
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    return undirected_keys(pairs[:, 0], pairs[:, 1], n)


def apply(keys: np.ndarray, inserted: np.ndarray, deleted: np.ndarray,
          n: int) -> np.ndarray:
    """The edge set after one delta of ``(k, 2)`` undirected pairs."""
    kept = np.setdiff1d(keys, pair_keys(deleted, n), assume_unique=True)
    return np.union1d(kept, pair_keys(inserted, n))


def directed(keys: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Both directions of every undirected edge, as ``(src, dst)``."""
    lo, hi = keys // n, keys % n
    return np.concatenate([lo, hi]), np.concatenate([hi, lo])
