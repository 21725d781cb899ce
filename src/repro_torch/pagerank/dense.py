"""Dense PageRank power iteration (reference implementation).

``pagerank_dense`` iterates to an L1-residual tolerance through the shared
:func:`repro_torch.obs.trace.instrumented_tol_loop` (convergence watchdog
and optional residual-trajectory ring); ``pagerank_dense_fixed`` runs the
paper's fixed 100-iteration schedule as a plain loop with no host sync.
Both route through :func:`repro_torch.pagerank.steps.dense_step`.  The
start vector and the residual take ``H.dtype``, as in the JAX package.
"""
from __future__ import annotations

import torch

from repro_torch.obs.trace import instrumented_tol_loop
from repro_torch.pagerank.steps import dense_step

__all__ = ["pagerank_dense", "pagerank_dense_fixed"]


def pagerank_dense(H: torch.Tensor, d: float = 0.85, tol=1e-6,
                   max_iters: int = 1000, x0: torch.Tensor | None = None,
                   watchdog: bool = True, trace: bool = False):
    """Returns ``(pr, n_iters, residual, grow, ring)`` as device tensors.
    ``x0`` warm-starts the loop from a previous rank vector; ``None`` is
    the classic uniform cold start.  ``grow`` is the watchdog's
    consecutive-growth counter at exit; ``ring`` is ``None`` unless
    ``trace``."""
    n = H.shape[0]
    pr0 = (torch.full((n,), 1.0 / n, dtype=H.dtype, device=H.device)
           if x0 is None else x0)

    def step(pr):
        new = dense_step(H, pr, d)
        return new, torch.sum(torch.abs(new - pr))

    return instrumented_tol_loop(step, pr0, tol=tol, max_iters=max_iters,
                                 watchdog=watchdog, trace=trace,
                                 dtype=H.dtype)


def pagerank_dense_fixed(H: torch.Tensor, n_iters: int = 100,
                         d: float = 0.85) -> torch.Tensor:
    """The paper's schedule: exactly ``n_iters`` iterations."""
    n = H.shape[0]
    pr = torch.full((n,), 1.0 / n, dtype=H.dtype, device=H.device)
    for _ in range(n_iters):
        pr = dense_step(H, pr, d)
    return pr
