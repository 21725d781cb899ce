"""The comparison that decides ``correct``: what the timed path produced,
against the plain float64 reference (:mod:`perfbench.reference`).

Numbers compared, each against its limit in ``perfbench/limits/<cell>.json``
(``PERF.md`` gives the readings each limit was set from):

* ``l1_gap``: the L1 distance of a rank vector from the reference's
  (the vectors sum to 1): the solves' vectors after ``n_iters`` steps,
  or the live engine's global ranks against the fixed point of the graph
  with every delta so far applied;
* ``topk_gap``: for each top-k answer (ids and scores), the larger of the
  widest gap between a served score and the reference's value at that id,
  and how far the reference's k-th best lies above the lowest reference
  value among the served ids (0 when the served ids are a true top-k).

A run is correct when every number is at or under its limit, nothing
failed and something was attempted.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import delta as rdelta
from perfbench.reference import pagerank as rpr

# steps of the reference's fixed point: 0.85 ** 300 is below 1e-21
FIXED_POINT_ITERS = 300
PPR_BLOCK = 256


def operator(src_t, dst_t, n: int, cfg: dict, precision: str):
    return rpr.Operator(src_t, dst_t, n, layout=cfg["reference"],
                        precision=precision)


def global_ranks(graph, cfg: dict, n_iters: int,
                 precision: str = "f64") -> torch.Tensor:
    op = operator(graph.src_t, graph.dst_t, graph.n, cfg, precision)
    return rpr.pagerank(op, float(cfg["d"]), n_iters)


def ppr_columns(op, sets: list, d: float) -> np.ndarray:
    """The fixed point of every seed set, (n, Q) in float64 on the host,
    in blocks of ``PPR_BLOCK`` columns."""
    cols = [rpr.ppr(op, sets[i:i + PPR_BLOCK], d, FIXED_POINT_ITERS)
            .double().cpu().numpy() for i in range(0, len(sets), PPR_BLOCK)]
    return np.concatenate(cols, axis=1) if cols else np.zeros((op.n, 0))


def top(x: torch.Tensor, k: int) -> tuple:
    """The ids and scores of the ``k`` largest entries, on the host."""
    scores, idx = x.double().cpu().topk(k)
    return idx.numpy(), scores.numpy()


def answers(op, sets: list, d: float, k: int) -> list:
    """``(seed set, (ids, scores))`` of each seed set's top ``k`` at the
    fixed point of ``op``: what a server computing with ``op`` answers."""
    X = ppr_columns(op, sets, d)
    return [(s, top(torch.from_numpy(X[:, j]), k))
            for j, s in enumerate(sets)]


def topk_gap(ref: np.ndarray, idx, scores, k: int) -> float:
    idx = np.asarray(idx, np.int64)
    at = ref[idx]
    kth = np.partition(ref, -k)[-k]
    return float(max(np.max(np.abs(np.asarray(scores, np.float64) - at)),
                     kth - at.min(), 0.0))


def verdict(values: dict, limits: dict) -> dict:
    return {name: {"value": float(v), "limit": limits.get(name)}
            for name, v in values.items()}


def judge_solves(solves: list, ref: torch.Tensor, k: int,
                 limits: dict) -> dict:
    ref = ref.double().cpu()
    ref_np = ref.numpy()
    l1 = max(float(torch.sum(torch.abs(x.double().cpu() - ref)))
             for x, _, _ in solves)
    tg = max(topk_gap(ref_np, idx, sc, k) for _, idx, sc in solves)
    return verdict({"l1_gap": l1, "topk_gap": tg}, limits)


def _answers_gap(op, answers: list, d: float, k: int) -> float:
    """The widest ``topk_gap`` over ``(seed set, (ids, scores))``
    answers, each against the fixed point of its seed set."""
    if not answers:
        return 0.0
    keys = {}
    for seeds, _ in answers:
        keys.setdefault(tuple(np.unique(seeds).tolist()), len(keys))
    ref = ppr_columns(op, [np.array(s) for s in keys], d)
    return max(topk_gap(ref[:, keys[tuple(np.unique(seeds).tolist())]],
                        idx, sc, k) for seeds, (idx, sc) in answers)


def judge_answers(graph, cfg: dict, answers: list, k: int,
                  limits: dict) -> dict:
    op = operator(graph.src_t, graph.dst_t, graph.n, cfg, "f64")
    return verdict({"topk_gap": _answers_gap(op, answers, float(cfg["d"]),
                                             k)}, limits)


def live_graphs(graph, ticks: list, counts):
    """The directed edges after the first ``c`` ticks, for each ``c`` of
    ``counts`` in increasing order, as device tensors."""
    n = graph.n
    keys = rdelta.undirected_keys(graph.src, graph.dst, n)
    applied = 0
    for c in sorted(set(counts)):
        for ins, dele in ticks[applied:c]:
            keys = rdelta.apply(keys, ins, dele, n)
        applied = c
        src, dst = rdelta.directed(keys, n)
        yield c, (torch.from_numpy(src).to(graph.src_t.device),
                  torch.from_numpy(dst).to(graph.src_t.device))


def judge_live(graph, cfg: dict, ticks: list, refreshes: list, k: int,
               limits: dict) -> dict:
    """``refreshes``: ``(ticks applied, global ranks, answers)`` of the
    sampled refreshes."""
    d = float(cfg["d"])
    by_count: dict = {}
    for c, ranks, answers in refreshes:
        by_count.setdefault(c, []).append((ranks, answers))
    l1 = tg = 0.0
    for c, (src, dst) in live_graphs(graph, ticks, by_count):
        op = operator(src, dst, graph.n, cfg, "f64")
        ref = rpr.pagerank(op, d, FIXED_POINT_ITERS).double().cpu()
        for ranks, answers in by_count[c]:
            l1 = max(l1, float(torch.sum(torch.abs(ranks.double().cpu()
                                                   - ref))))
            tg = max(tg, _answers_gap(op, answers, d, k))
    return verdict({"l1_gap": l1, "topk_gap": tg}, limits)


def is_correct(checks: dict, rec: dict) -> bool:
    return (rec.get("attempted", 0) > 0 and rec.get("failed", 1) == 0
            and all(c["limit"] is not None and c["value"] <= c["limit"]
                    for c in checks.values()))
