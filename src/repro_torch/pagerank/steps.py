"""Canonical per-iteration PageRank step functions.

The reference loops in :mod:`repro_torch.pagerank.dense` and the
:class:`repro_torch.pagerank.engine.PageRankEngine` tiers route through
these, so the arithmetic is defined in exactly one place, as in
``repro.pagerank.steps``.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

__all__ = ["dense_step", "sparse_step", "ppr_step", "ppr_step_batched",
           "seed_matrix"]


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


def ppr_step(matvec: Callable[[torch.Tensor], torch.Tensor],
             pr: torch.Tensor, v: torch.Tensor, dang: torch.Tensor,
             d: float) -> torch.Tensor:
    """One personalized step: teleport (and leak) flow to ``v``, not 1/n."""
    leak = torch.sum(pr * dang)
    return d * (matvec(pr) + leak * v) + (1.0 - d) * v


def ppr_step_batched(matvec: Callable[[torch.Tensor], torch.Tensor],
                     PR: torch.Tensor, V: torch.Tensor, dang: torch.Tensor,
                     d: float) -> torch.Tensor:
    """Batched personalized step: ``PR``/``V`` are (N, Q); Q queries share
    the single sweep over H inside ``matvec``."""
    leak = torch.sum(PR * dang[:, None], dim=0)           # (Q,)
    return d * (matvec(PR) + V * leak[None, :]) + (1.0 - d) * V


def seed_matrix(n: int, seed_sets: Sequence[np.ndarray]) -> np.ndarray:
    """Stack per-user seed index sets into the (N, Q) float32 teleport
    matrix on the host.  Duplicate indices accumulate (multiplicity
    weighting), so every column is a proper distribution summing to 1."""
    V = np.zeros((n, len(seed_sets)), np.float32)
    for q, seeds in enumerate(seed_sets):
        idx = np.asarray(seeds, np.int64).ravel()
        if idx.size == 0:
            raise ValueError(f"query {q}: empty seed set")
        np.add.at(V[:, q], idx, 1.0 / idx.size)
    return V
