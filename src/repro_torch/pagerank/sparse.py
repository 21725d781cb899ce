"""Ranking helpers over a computed rank vector.  Only
:func:`top_k_proteins` is ported so far; the sparse solvers and
personalized PageRank of ``repro.pagerank.sparse`` wait for the batched
PPR slice."""
from __future__ import annotations

import torch

__all__ = ["top_k_proteins"]


def top_k_proteins(pr: torch.Tensor, k: int = 10):
    """Ranked (index, score) of the k most central proteins."""
    scores, idx = torch.topk(pr, k)
    return idx, scores
