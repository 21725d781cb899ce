"""Delta validation & quarantine: the ingestion firewall for the live path.

The port's own copy of ``repro.graph.validate`` (pure numpy), over the
port's :class:`~repro_torch.graph.delta.GraphDelta`.  A live serving graph
takes edge updates from the outside world, and the outside world sends
garbage: node ids past the graph, negative ids, NaN payloads from a broken
producer, the same edge repeated 10k times, batches ten times the refresh
budget.  :func:`validate_delta` screens every delta *before* it reaches an
engine and resolves bad edges by policy:

* ``"quarantine"`` (default) — drop invalid edges into structured
  :class:`DeadLetter` records and pass the clean remainder through;
* ``"reject"`` — raise :class:`DeltaRejected` on the first problem
  (strict producers, tests);
* ``"clip"`` — rescue range errors by clamping ids into ``[0, n)``,
  quarantine what cannot be clamped (NaN, self-loops).

Per-edge reasons: ``nonfinite``, ``non_integral``, ``negative_id``,
``out_of_range``, ``self_loop``.  Batch-level reasons: ``oversized_batch``
(accepted edges truncated to ``max_batch_edges``), ``duplicate_flood``
(duplicate/unique ratio past ``max_duplicate_ratio`` — the DoS signature;
the surplus is dead-lettered, the deduped edges proceed).

:meth:`repro_torch.serve.engine.PageRankQueryEngine.push_update` consumes
this in the resilient mode; the dead-letter queue is the operator's audit
trail.
"""
from __future__ import annotations

import dataclasses
from collections import Counter, deque

import numpy as np

from repro_torch.graph.delta import GraphDelta

__all__ = ["ValidationPolicy", "DeadLetter", "DeadLetterQueue",
           "DeltaRejected", "ValidationResult", "validate_delta"]


@dataclasses.dataclass(frozen=True)
class ValidationPolicy:
    """How :func:`validate_delta` resolves invalid edges.

    ``on_invalid``: ``"quarantine"`` | ``"reject"`` | ``"clip"`` (see
    module docstring).  ``max_batch_edges`` bounds the directed edges one
    delta may name (0 disables); ``max_duplicate_ratio`` is the largest
    tolerated total/unique ratio per side before the batch is flagged as a
    duplicate flood; ``allow_self_loops`` passes self-loops through to the
    engine's canonicalizer (which drops them) instead of dead-lettering."""

    on_invalid: str = "quarantine"
    max_batch_edges: int = 4096
    max_duplicate_ratio: float = 8.0
    allow_self_loops: bool = False

    def __post_init__(self):
        if self.on_invalid not in ("quarantine", "reject", "clip"):
            raise ValueError(
                f"on_invalid must be quarantine|reject|clip, "
                f"got {self.on_invalid!r}")


@dataclasses.dataclass(frozen=True)
class DeadLetter:
    """One quarantined group of edges: why, which side of the delta, and
    the offending (raw, uncast) endpoint arrays."""

    reason: str
    side: str                 # "insert" | "delete" | "batch"
    src: np.ndarray
    dst: np.ndarray
    timestamp: float = 0.0

    @property
    def n_edges(self) -> int:
        return int(np.atleast_1d(self.src).shape[0])


class DeadLetterQueue:
    """Bounded FIFO of :class:`DeadLetter` records — the audit trail the
    serving layer keeps so rejected updates are inspectable, not lost."""

    def __init__(self, maxlen: int = 256):
        self._q: deque[DeadLetter] = deque(maxlen=maxlen)
        self.total_seen = 0

    def push(self, letter: DeadLetter) -> None:
        self.total_seen += 1
        self._q.append(letter)

    def extend(self, letters) -> None:
        for let in letters:
            self.push(let)

    def counts(self) -> dict[str, int]:
        """Edges quarantined per reason (over the retained window)."""
        c: Counter[str] = Counter()
        for let in self._q:
            c[let.reason] += let.n_edges
        return dict(c)

    def __len__(self) -> int:
        return len(self._q)

    def __iter__(self):
        return iter(self._q)


class DeltaRejected(ValueError):
    """A delta failed validation under ``on_invalid="reject"``."""

    def __init__(self, reasons, n_bad: int):
        self.reasons = tuple(sorted(set(reasons)))
        self.n_bad = int(n_bad)
        super().__init__(
            f"delta rejected: {n_bad} invalid edge(s) "
            f"[{', '.join(self.reasons)}]")


@dataclasses.dataclass(frozen=True)
class ValidationResult:
    """Outcome of one validation pass.  ``delta`` is the cleaned
    :class:`GraphDelta` ready for the engine, or ``None`` when nothing
    survived (the caller skips the refresh); ``dead_letters`` carries the
    quarantined edges, ``reasons`` the sorted distinct reason tags."""

    delta: GraphDelta | None
    n_accepted: int
    n_dropped: int
    dead_letters: tuple[DeadLetter, ...]
    reasons: tuple[str, ...]

    @property
    def clean(self) -> bool:
        return self.n_dropped == 0


def _screen_side(src, dst, n: int, side: str, policy: ValidationPolicy,
                 timestamp: float):
    """Validate one side (inserts or deletes) of a delta.  Returns
    ``(src_ok, dst_ok, letters)`` with the survivors cast to int64."""
    src = np.atleast_1d(np.asarray(src))
    dst = np.atleast_1d(np.asarray(dst))
    if src.shape[0] != dst.shape[0]:
        raise ValueError(
            f"{side} src/dst length mismatch: "
            f"{src.shape[0]} vs {dst.shape[0]}")
    letters: list[DeadLetter] = []

    def drop(mask: np.ndarray, reason: str):
        nonlocal src, dst
        if mask.any():
            letters.append(DeadLetter(reason, side, src[mask].copy(),
                                      dst[mask].copy(), timestamp))
            src, dst = src[~mask], dst[~mask]

    # float payloads first: NaN/Inf, then fractional ids — neither can be
    # cast to a node id, under any policy
    if (np.issubdtype(src.dtype, np.floating)
            or np.issubdtype(dst.dtype, np.floating)):
        s, d = src.astype(np.float64), dst.astype(np.float64)
        drop(~(np.isfinite(s) & np.isfinite(d)), "nonfinite")
        s, d = src.astype(np.float64), dst.astype(np.float64)
        drop((s != np.floor(s)) | (d != np.floor(d)), "non_integral")
    src = src.astype(np.int64)
    dst = dst.astype(np.int64)

    # range errors: clip rescues them, the other policies drop them
    bad_range = (src < 0) | (dst < 0) | (src >= n) | (dst >= n)
    if policy.on_invalid == "clip":
        if bad_range.any():
            letters.append(DeadLetter("out_of_range_clipped", side,
                                      src[bad_range].copy(),
                                      dst[bad_range].copy(), timestamp))
        src = np.clip(src, 0, n - 1)
        dst = np.clip(dst, 0, n - 1)
    else:
        drop((src < 0) | (dst < 0), "negative_id")
        drop((src >= n) | (dst >= n), "out_of_range")

    if not policy.allow_self_loops:
        drop(src == dst, "self_loop")

    # duplicate flood: total/unique past the policy bound — dedupe always,
    # dead-letter the surplus only when it crosses the threshold
    if src.shape[0]:
        keys = src * int(n) + dst
        uniq, first = np.unique(keys, return_index=True)
        ratio = keys.shape[0] / uniq.shape[0]
        if (policy.max_duplicate_ratio
                and ratio > policy.max_duplicate_ratio):
            dup_mask = np.ones(keys.shape[0], bool)
            dup_mask[first] = False
            letters.append(DeadLetter("duplicate_flood", side,
                                      src[dup_mask].copy(),
                                      dst[dup_mask].copy(), timestamp))
            src, dst = src[first], dst[first]

    return src, dst, letters


def validate_delta(delta: GraphDelta, n: int,
                   policy: ValidationPolicy | None = None
                   ) -> ValidationResult:
    """Screen ``delta`` against a graph of ``n`` nodes under ``policy``.

    Never mutates the input.  Under ``"reject"`` raises
    :class:`DeltaRejected` if anything is invalid; otherwise returns a
    :class:`ValidationResult` whose ``delta`` (int32, validated) is safe
    for ``GraphDelta.canonical`` / ``DynamicPageRankEngine.update``."""
    policy = policy if policy is not None else ValidationPolicy()
    t = float(getattr(delta, "timestamp", 0.0))
    ins_s, ins_d, l_ins = _screen_side(delta.insert_src, delta.insert_dst,
                                       n, "insert", policy, t)
    del_s, del_d, l_del = _screen_side(delta.delete_src, delta.delete_dst,
                                       n, "delete", policy, t)
    letters = l_ins + l_del

    # batch budget: accepted directed edges, inserts first
    budget = int(policy.max_batch_edges)
    if budget and ins_s.shape[0] + del_s.shape[0] > budget:
        keep_ins = min(ins_s.shape[0], budget)
        keep_del = budget - keep_ins
        over_s = np.concatenate([ins_s[keep_ins:], del_s[keep_del:]])
        over_d = np.concatenate([ins_d[keep_ins:], del_d[keep_del:]])
        letters.append(DeadLetter("oversized_batch", "batch",
                                  over_s, over_d, t))
        ins_s, ins_d = ins_s[:keep_ins], ins_d[:keep_ins]
        del_s, del_d = del_s[:keep_del], del_d[:keep_del]

    reasons = tuple(sorted({let.reason for let in letters}))
    n_dropped = sum(let.n_edges for let in letters)
    if policy.on_invalid == "reject" and letters:
        raise DeltaRejected(reasons, n_dropped)

    n_accepted = int(ins_s.shape[0] + del_s.shape[0])
    if n_accepted == 0:
        clean = None
    else:
        clean = GraphDelta(ins_s.astype(np.int32), ins_d.astype(np.int32),
                           del_s.astype(np.int32), del_d.astype(np.int32),
                           t)
    return ValidationResult(clean, n_accepted, n_dropped,
                            tuple(letters), reasons)
