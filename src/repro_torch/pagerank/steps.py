"""Canonical per-iteration PageRank step functions.

The reference loops in :mod:`repro_torch.pagerank.dense` and the
:class:`repro_torch.pagerank.engine.PageRankEngine` tiers route through
these, so the arithmetic is defined in exactly one place, as in
``repro.pagerank.steps``.  The personalized steps are not ported yet.
"""
from __future__ import annotations

from typing import Callable

import torch

__all__ = ["dense_step", "sparse_step"]


def dense_step(H: torch.Tensor, pr: torch.Tensor, d: float) -> torch.Tensor:
    """One power iteration against a dangling-fixed dense H."""
    n = H.shape[0]
    return d * (H @ pr) + (1.0 - d) / n


def sparse_step(matvec: Callable[[torch.Tensor], torch.Tensor],
                pr: torch.Tensor, dang: torch.Tensor, d: float,
                n: int) -> torch.Tensor:
    """One power iteration with the explicit dangling-leak correction."""
    leak = torch.sum(pr * dang) / n
    return d * (matvec(pr) + leak) + (1.0 - d) / n
