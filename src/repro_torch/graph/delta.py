"""Streaming graph deltas: timestamped edge insert/delete batches.

The port's own copy of ``repro.graph.delta`` (pure numpy; bit-equal to
the JAX package's for the same inputs and seed).  :class:`GraphDelta` is
the canonical interchange record for one batch of edge changes,
:func:`apply_delta` folds a delta into a COO edge list (the from-scratch
oracle the incremental engine is tested against), :func:`compose` folds a
backlog of deltas into one, and :class:`EdgeStream` evolves a
Barabási–Albert graph over a fixed node capacity by
preferential-attachment arrivals and oldest-first expiries.
:func:`edge_keys` is the sorted-key set representation of a directed edge
list; :func:`dedupe_directed` collapses duplicate directed edges.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.generators import (_dedupe_symmetrize,
                                          barabasi_albert)

__all__ = ["GraphDelta", "apply_delta", "compose", "dedupe_directed",
           "EdgeStream", "edge_keys"]


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


@dataclasses.dataclass(frozen=True)
class GraphDelta:
    """One timestamped batch of edge changes.

    ``insert_*`` / ``delete_*`` are COO int32 arrays; semantics are
    set-like and applied deletes-first: the post-delta edge set is
    ``(E \\ deletes) | inserts`` (so an edge listed in both survives).
    Inserting an existing edge or deleting a missing one is a no-op.
    """

    insert_src: np.ndarray
    insert_dst: np.ndarray
    delete_src: np.ndarray
    delete_dst: np.ndarray
    timestamp: float = 0.0

    def __post_init__(self):
        """Strict construction: malformed deltas used to sail through and
        blow up deep inside layout patching (or not at all) — reject them
        here with a clear error.  Checks: matching src/dst lengths,
        integral finite ids, no negative ids, no self-loops.  Range
        against ``n`` stays in :meth:`canonical` (a delta does not know
        its graph size).  Arrays are normalized to 1-D int32.  Untrusted
        streams should screen with :func:`repro_torch.graph.validate.
        validate_delta` instead of catching this."""
        for side in ("insert", "delete"):
            src = np.atleast_1d(np.asarray(getattr(self, f"{side}_src")))
            dst = np.atleast_1d(np.asarray(getattr(self, f"{side}_dst")))
            if src.shape[0] != dst.shape[0]:
                raise ValueError(
                    f"GraphDelta {side} src/dst length mismatch: "
                    f"{src.shape[0]} vs {dst.shape[0]}")
            for name, arr in ((f"{side}_src", src), (f"{side}_dst", dst)):
                if np.issubdtype(arr.dtype, np.floating):
                    a = arr.astype(np.float64)
                    if arr.size and not np.isfinite(a).all():
                        raise ValueError(
                            f"GraphDelta {name} has non-finite entries")
                    if arr.size and (a != np.floor(a)).any():
                        raise ValueError(
                            f"GraphDelta {name} has non-integral entries")
                elif not np.issubdtype(arr.dtype, np.integer):
                    raise ValueError(
                        f"GraphDelta {name} must hold integer node ids, "
                        f"got dtype {arr.dtype}")
            src = src.astype(np.int32)
            dst = dst.astype(np.int32)
            if src.size and (src.min() < 0 or dst.min() < 0):
                raise ValueError(
                    f"GraphDelta {side} edges name negative node ids")
            if src.size and (src == dst).any():
                k = int(np.argmax(src == dst))
                raise ValueError(
                    f"GraphDelta {side} edges contain self-loop "
                    f"({int(src[k])}, {int(dst[k])}); self-loops are not "
                    f"part of the undirected-edge dialect")
            object.__setattr__(self, f"{side}_src", src)
            object.__setattr__(self, f"{side}_dst", dst)

    @classmethod
    def inserts(cls, src, dst, timestamp: float = 0.0) -> "GraphDelta":
        e = np.empty(0, np.int32)
        return cls(np.atleast_1d(np.asarray(src)),
                   np.atleast_1d(np.asarray(dst)),
                   e, e.copy(), timestamp)

    @classmethod
    def deletes(cls, src, dst, timestamp: float = 0.0) -> "GraphDelta":
        e = np.empty(0, np.int32)
        return cls(e, e.copy(),
                   np.atleast_1d(np.asarray(src)),
                   np.atleast_1d(np.asarray(dst)), timestamp)

    @property
    def n_insert(self) -> int:
        return int(len(self.insert_src))

    @property
    def n_delete(self) -> int:
        return int(len(self.delete_src))

    @property
    def n_changed(self) -> int:
        """Directed edges named by this delta (after canonicalization this
        counts both directions of an undirected change)."""
        return self.n_insert + self.n_delete

    def canonical(self, n: int, symmetric: bool = True) -> "GraphDelta":
        """Canonicalize both sides: drop self-loops and duplicates, and
        (for the undirected graphs every generator produces) symmetrize —
        each undirected change becomes its two directed edges.  Node ids
        must be in ``[0, n)``."""
        for arr in (self.insert_src, self.insert_dst,
                    self.delete_src, self.delete_dst):
            arr = np.atleast_1d(arr)
            if arr.size and (arr.min() < 0 or arr.max() >= n):
                raise ValueError(f"delta names node outside [0, {n})")
        clean = _dedupe_symmetrize if symmetric else dedupe_directed
        ins = clean(np.asarray(self.insert_src, np.int64),
                    np.asarray(self.insert_dst, np.int64), n)
        dele = clean(np.asarray(self.delete_src, np.int64),
                     np.asarray(self.delete_dst, np.int64), n)
        return GraphDelta(ins[0], ins[1], dele[0], dele[1], self.timestamp)


def apply_delta(src: np.ndarray, dst: np.ndarray, delta: GraphDelta,
                n: int, symmetric: bool = True
                ) -> tuple[np.ndarray, np.ndarray]:
    """Fold one delta into a COO edge list: ``(E \\ deletes) | inserts``.

    This is the host-side oracle — the graph a from-scratch engine would be
    built on — against which the incremental layout patches are verified.
    Returns the post-delta edge list in canonical (key-sorted) order.
    """
    delta = delta.canonical(n, symmetric=symmetric)
    keys = edge_keys(src, dst, n)
    del_keys = edge_keys(delta.delete_src, delta.delete_dst, n)
    ins_keys = edge_keys(delta.insert_src, delta.insert_dst, n)
    keys = np.union1d(np.setdiff1d(keys, del_keys, assume_unique=True),
                      ins_keys)
    return (keys // n).astype(np.int32), (keys % n).astype(np.int32)


def compose(deltas, n: int, symmetric: bool = True) -> GraphDelta:
    """Fold a sequence of deltas into ONE with identical semantics to
    applying them in order (so a refresh that coalesces k queued stream
    ticks pays one solve, not k).  The fold keeps the latest state of each
    edge: an edge re-inserted after a queued delete ends up inserted, a
    deleted insert ends up deleted — ``apply_delta(E, compose(ds)) ==
    reduce(apply_delta, ds, E)``.  Timestamp is the last delta's."""
    I = np.empty(0, np.int64)
    D = np.empty(0, np.int64)
    t = 0.0
    for d in deltas:
        d = d.canonical(n, symmetric=symmetric)
        i2 = edge_keys(d.insert_src, d.insert_dst, n)
        d2 = edge_keys(d.delete_src, d.delete_dst, n)
        I = np.union1d(np.setdiff1d(I, d2, assume_unique=True), i2)
        D = np.union1d(np.setdiff1d(D, i2, assume_unique=True), d2)
        t = d.timestamp
    return GraphDelta((I // n).astype(np.int32), (I % n).astype(np.int32),
                      (D // n).astype(np.int32), (D % n).astype(np.int32),
                      t)


class EdgeStream:
    """Streaming Barabási–Albert evolution over a fixed node capacity.

    Starts from a :func:`~repro_torch.graph.generators.barabasi_albert`
    snapshot (``base()``) and yields timestamped :class:`GraphDelta` batches:
    arrivals attach preferentially (both endpoints drawn with probability
    proportional to ``degree + 1``, so isolated nodes can rejoin), expiries
    retire the *oldest* live edges first — the FIFO lifetime model of an
    interaction feed.  Deltas come out already canonicalized (symmetric,
    deduped), ready for ``DynamicPageRankEngine.update`` or
    :func:`apply_delta`.
    """

    def __init__(self, n: int, m_edges: int = 4, seed: int = 0,
                 insert_per_step: int = 8, delete_per_step: int = 4,
                 dt: float = 1.0):
        self.n = int(n)
        self.insert_per_step = int(insert_per_step)
        self.delete_per_step = int(delete_per_step)
        self.dt = float(dt)
        self.t = 0.0
        self._rng = np.random.default_rng(seed)
        src, dst = barabasi_albert(n, m_edges=m_edges, seed=seed)
        self._base = (src.copy(), dst.copy())
        # undirected bookkeeping: one (u < v) pair per edge, FIFO-ordered
        lo, hi = np.minimum(src, dst), np.maximum(src, dst)
        pairs = np.unique(lo.astype(np.int64) * self.n + hi)
        self._fifo: list[int] = list(pairs)
        self._live: set[int] = set(self._fifo)
        self._deg = np.bincount(np.concatenate([src, dst]),
                                minlength=n).astype(np.int64) // 2

    def base(self) -> tuple[np.ndarray, np.ndarray]:
        """The starting snapshot (directed symmetric COO)."""
        return self._base[0].copy(), self._base[1].copy()

    @property
    def n_live_edges(self) -> int:
        return len(self._live)

    def _sample_arrival(self) -> int | None:
        w = (self._deg + 1).astype(np.float64)
        w /= w.sum()
        for _ in range(64):
            u, v = self._rng.choice(self.n, size=2, p=w)
            if u == v:
                continue
            key = int(min(u, v)) * self.n + int(max(u, v))
            if key not in self._live:
                return key
        return None

    def step(self) -> GraphDelta:
        """Advance one tick: sample arrivals, expire the oldest edges,
        return the canonical delta (arrivals this tick never expire in the
        same tick)."""
        self.t += self.dt
        ins: list[int] = []
        for _ in range(self.insert_per_step):
            key = self._sample_arrival()
            if key is None:
                break
            ins.append(key)
            self._live.add(key)
            self._deg[key // self.n] += 1
            self._deg[key % self.n] += 1
        n_del = min(self.delete_per_step, len(self._fifo))
        dels = self._fifo[:n_del]
        self._fifo = self._fifo[n_del:] + ins
        for key in dels:
            self._live.discard(key)
            self._deg[key // self.n] -= 1
            self._deg[key % self.n] -= 1
        ins_a = np.asarray(ins, np.int64)
        del_a = np.asarray(dels, np.int64)
        return GraphDelta(
            (ins_a // self.n).astype(np.int32),
            (ins_a % self.n).astype(np.int32),
            (del_a // self.n).astype(np.int32),
            (del_a % self.n).astype(np.int32),
            self.t).canonical(self.n, symmetric=True)

    def __iter__(self):
        while True:
            yield self.step()
