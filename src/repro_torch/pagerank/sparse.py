"""Sparse PageRank, personalized PageRank, and ranking helpers.

Sparse H drops the dense dangling columns, so the update carries an
explicit dangling correction:

    PR' = d * (H_sparse @ PR + 1*sum(PR[dangling])/N) + (1-d)/N

which equals the dense-H update exactly.  Works with any ``matvec``
(a :class:`~repro_torch.graph.sparse.CSRMatrix`'s, the engine's layouts).
The per-iteration bodies are the shared steps of
:mod:`repro_torch.pagerank.steps`; the loops are plain Python loops over
device tensors, as ``jax.lax.scan`` is in the JAX package, and
``pagerank_sparse_tol`` runs the port's chunked tolerance loop
(:func:`repro_torch.obs.trace.instrumented_tol_loop`, no watchdog) in place
of ``jax.lax.while_loop``.  ``device`` defaults to ``"cuda"``: pass
``device="cpu"`` when ``matvec`` runs on the CPU.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device
from repro_torch.obs.trace import instrumented_tol_loop
from repro_torch.pagerank.steps import ppr_step, sparse_step

__all__ = ["pagerank_sparse", "pagerank_sparse_tol", "top_k_proteins",
           "personalized_pagerank"]


def _start(n: int, dangling, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The uniform start vector and the dangling mask on ``device``."""
    dev = resolve_device(device)
    pr0 = torch.full((n,), 1.0 / n, dtype=torch.float32, device=dev)
    return pr0, _dangling(dangling, n, dev)


def _dangling(dangling, n: int, device) -> torch.Tensor:
    if dangling is None:
        return torch.zeros((n,), dtype=torch.float32, device=device)
    return torch.as_tensor(dangling).to(device=device, dtype=torch.float32)


def pagerank_sparse(matvec: Callable[[torch.Tensor], torch.Tensor], n: int,
                    dangling=None, d: float = 0.85, n_iters: int = 100, *,
                    device: str | torch.device | None = None
                    ) -> torch.Tensor:
    """Fixed-iteration sparse power iteration.

    ``matvec``: y = H_sparse @ x (column-stochastic except dangling columns)
    ``dangling``: float32 (n,) mask of dangling nodes (1.0 where dangling).
    ``device`` is where the rank vector lives (that of ``matvec``'s
    operands).
    """
    pr, dang = _start(n, dangling, device)
    for _ in range(n_iters):
        pr = sparse_step(matvec, pr, dang, d, n)
    return pr


def pagerank_sparse_tol(matvec: Callable[[torch.Tensor], torch.Tensor],
                        n: int, dangling=None, d: float = 0.85,
                        tol: float = 1e-6, max_iters: int = 1000, *,
                        device: str | torch.device | None = None):
    """Tolerance-terminated variant; returns ``(pr, iters, residual)`` as
    device tensors."""
    pr0, dang = _start(n, dangling, device)

    def step(pr):
        new = sparse_step(matvec, pr, dang, d, n)
        return new, torch.sum(torch.abs(new - pr))

    pr, iters, res, _, _ = instrumented_tol_loop(
        step, pr0, tol=tol, max_iters=max_iters, watchdog=False,
        trace=False)
    return pr, iters, res


def top_k_proteins(pr, k: int = 10):
    """Ranked (index, score) of the k most central proteins; ``pr`` is a
    tensor or a numpy array (then the result lies on the CPU)."""
    scores, idx = torch.topk(torch.as_tensor(pr), k)
    return idx, scores


def personalized_pagerank(matvec: Callable[[torch.Tensor], torch.Tensor],
                          n: int, seeds, dangling=None, d: float = 0.85,
                          n_iters: int = 100, *,
                          device: str | torch.device | None = None
                          ) -> torch.Tensor:
    """Personalized PageRank: the teleport distribution is concentrated on
    ``seeds`` (protein-complex identification à la the paper's ref [7] —
    rank proteins by proximity to a seed set instead of globally).

    ``seeds``: integer indices of the seed proteins.  A repeated seed
    counts once, as ``.at[seeds].set`` does in the JAX package.
    """
    dev = resolve_device(device)
    idx = torch.as_tensor(np.asarray(seeds, np.int64)).to(dev)
    v = torch.zeros((n,), dtype=torch.float32, device=dev)
    v[idx] = 1.0 / idx.shape[0]
    dang = _dangling(dangling, n, dev)
    pr = v
    for _ in range(n_iters):
        pr = ppr_step(matvec, pr, v, dang, d)
    return pr
