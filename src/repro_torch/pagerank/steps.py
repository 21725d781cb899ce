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

from repro_torch.obs.trace import instrumented_tol_loop

__all__ = ["dense_step", "sparse_step", "ppr_step", "ppr_step_batched",
           "frontier_push", "seed_matrix"]


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


def frontier_push(Ab: Callable[[torch.Tensor], torch.Tensor],
                  x0: torch.Tensor, tol, n: int, max_pushes: int, *,
                  residual: Callable[[torch.Tensor], torch.Tensor],
                  trace: bool = False):
    """Gauss–Southwell push to the fixed point ``x = Ab(x)`` of a damped
    affine operator, for one vector or a block of queries.  Every sweep
    pushes the whole frontier mask ``|r| ≥ tol/n`` into the iterate and
    refreshes the residual ``r = Ab(x) − x`` from scratch, on the chunked
    tolerance loop with its watchdog; ``residual(r)`` is the loop's exit
    measure.  The real initial residual seeds the loop (on the device), so
    an already-converged frontier takes no sweep.  Returns ``(x, r, iters,
    residual, grow, ring)``."""
    thresh = tol / n

    def step(state):
        x, r = state
        x = x + r * (torch.abs(r) >= thresh).to(x.dtype)
        r = Ab(x) - x
        return (x, r), residual(r)

    r0 = Ab(x0) - x0
    (x, r), iters, res, grow, ring = instrumented_tol_loop(
        step, (x0, r0), tol=tol, max_iters=max_pushes, watchdog=True,
        trace=trace, res0=residual(r0))
    return x, r, iters, res, grow, ring


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
