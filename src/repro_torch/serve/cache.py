"""LRU PPR result cache with delta-aware invalidation.

The port's own copy of ``repro.serve.cache`` (pure numpy on the host; the
port imports nothing of the JAX package).  The serve engine's ``refresh``
calls the delta-aware invalidation after every applied graph update.

Entries are keyed by (precision tier, canonical seed set) and stamped
with the graph version they were solved at.  On a graph delta the serve
engine does NOT flush wholesale: the Gauss–Southwell view of the update
says the new fixed point differs from the old by

    x' − x = (I − dH')⁻¹ · d·ΔH · x

and ΔH is nonzero ONLY in the changed columns (an edge touching node u
rewrites column u of the column-stochastic H).  A cached answer ``x``
is therefore perturbed in proportion to the probability mass it parks
on the changed columns, weighted by how much each column actually
moved: inserting one edge at a degree-1000 hub shifts its column by
``O(1/1000)`` in L1, at a leaf by ``O(1)``.  ``invalidate`` scores each
entry with that first-order push residual —

    score(x) = Σ_{u ∈ changed} x[u] · w_u,   w_u ≈ ‖δ column_u‖₁

— and drops it only when the score clears ``keep_eps``; survivors are
re-stamped to the new version.  ``keep_eps`` defaults well under the
serve parity gate, so kept entries still match a post-delta cold solve.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass

import numpy as np

__all__ = ["CacheEntry", "ResultCache"]

CacheKey = tuple[str, tuple[int, ...]]


@dataclass
class CacheEntry:
    ranks: np.ndarray          # (n,) served PPR vector
    version: int               # graph version the entry is valid for


class ResultCache:
    """Bounded LRU over served PPR answers.

    ``get`` misses (and evicts) on a graph-version mismatch — entries
    that survived ``invalidate`` carry the current version, so a stale
    stamp means the entry was solved before a delta that perturbed it.
    ``invalidate`` implements the delta-aware policy above; passing
    ``cols=None`` is the escape hatch that drops everything (used after
    a resilience-path recovery, where no per-column story exists).
    """

    def __init__(self, capacity: int = 1024, keep_eps: float = 1e-6):
        self.capacity = int(capacity)
        self.keep_eps = float(keep_eps)
        self._entries: OrderedDict[CacheKey, CacheEntry] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0

    @staticmethod
    def key(seeds, precision: str) -> CacheKey:
        """Canonical key: sorted unique seed ids under the precision tag
        (tiers never alias — a bf16 answer must not serve an f32 ask)."""
        canon = np.unique(np.asarray(seeds, np.int64).ravel())
        return (str(precision), tuple(int(s) for s in canon))

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: CacheKey) -> bool:
        return key in self._entries

    # ------------------------------ lookups ----------------------------- #
    def get(self, key: CacheKey, version: int) -> np.ndarray | None:
        entry = self._entries.get(key)
        if entry is not None and entry.version != int(version):
            # solved before a perturbing delta: drop rather than serve stale
            del self._entries[key]
            entry = None
        if entry is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return entry.ranks

    def put(self, key: CacheKey, ranks: np.ndarray, version: int) -> int:
        """Insert/refresh an entry; returns how many entries LRU-evicted."""
        self._entries[key] = CacheEntry(np.asarray(ranks), int(version))
        self._entries.move_to_end(key)
        evicted = 0
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            evicted += 1
        self.evictions += evicted
        return evicted

    # --------------------------- invalidation --------------------------- #
    def invalidate(self, cols: np.ndarray | None, col_w: np.ndarray | None,
                   version: int) -> tuple[int, int]:
        """Delta-aware invalidation after a graph update.

        ``cols`` are the changed transition columns (delta endpoints) and
        ``col_w`` their per-column L1 perturbation weights; entries whose
        first-order impact score ``Σ ranks[cols]·col_w`` exceeds
        ``keep_eps`` are dropped, the rest re-stamped to ``version``.
        ``cols=None`` (or an unscored update) drops everything.
        Returns ``(dropped, kept)``.
        """
        version = int(version)
        if cols is None:
            dropped = len(self._entries)
            self._entries.clear()
            self.invalidations += dropped
            return dropped, 0
        cols = np.asarray(cols, np.int64)
        col_w = np.asarray(col_w, np.float64)
        dropped = 0
        for key in list(self._entries):
            entry = self._entries[key]
            score = float((entry.ranks[cols] * col_w).sum())
            if score > self.keep_eps:
                del self._entries[key]
                dropped += 1
            else:
                entry.version = version
        self.invalidations += dropped
        return dropped, len(self._entries)
