"""Public entry points of the kernel layer, as in ``repro.kernels.ops``.

There is no ``interpret`` switch and no ``REPRO_PALLAS_INTERPRET``: the
device of the tensors decides.  A CUDA tensor launches the hand-written
kernel (K2 for :func:`matvec` and :func:`gemv_batched`, K3 for
:func:`spmv`, K4 for :func:`pagerank_iteration`); a CPU tensor runs the
kernel's plain version.
"""
from __future__ import annotations

import torch

from repro_torch.graph.sparse import BSRMatrix
from repro_torch.kernels.bsr_spmv import bsr_spmv
from repro_torch.kernels.common import upcast_f32
from repro_torch.kernels.pagerank_step import pagerank_step
from repro_torch.kernels.streaming_matvec import streaming_matvec

__all__ = ["matvec", "gemv_batched", "spmv", "pagerank_iteration"]


def matvec(W: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = W @ x via the streaming kernel (the paper's MV, B = 1)."""
    return streaming_matvec(W, x[None, :])[0]


def gemv_batched(W: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Y = X @ W^T — the batched GEMV."""
    return streaming_matvec(W, X)


def spmv(bsr: BSRMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = H_bsr @ x, trimmed to the logical (unpadded) length, with one
    launch of the BSR kernel.  ``x`` is (m,), or (m, Q) for Q queries (the
    layout of ``BSRMatrix.matmat``), which goes to the kernel as (Q, m)
    rows and comes back as (n, Q).  An int8 layout's per-row scales fold
    into the accumulated f32 row sums here — never into the stored
    operand."""
    n = bsr.shape[0]
    x = upcast_f32(x)
    if x.dim() == 1:
        y = bsr_spmv(bsr.blocks, bsr.block_cols, x)
        if bsr.row_scales is not None:
            y = y * bsr.row_scales
        return y[:n]
    Y = bsr_spmv(bsr.blocks, bsr.block_cols, x.T)       # (Q, nb_r * bs)
    if bsr.row_scales is not None:
        Y = Y * bsr.row_scales
    return Y[:, :n].T


def pagerank_iteration(H: torch.Tensor, pr: torch.Tensor,
                       dangling: torch.Tensor | None = None,
                       d: float = 0.85) -> torch.Tensor:
    """One PageRank step with the dangling correction through the
    unpadded step kernel: ``d * (H @ pr) + t`` with ``t = d * sum(pr *
    dangling) / n + (1 - d) / n`` computed on the device (no host sync).

    One-shot convenience path: the leak is a separate pass over ``pr``.
    Loops should use :class:`repro_torch.pagerank.engine.PageRankEngine`,
    which prepares the layout once and carries the in-kernel leak."""
    n = H.shape[0]
    if dangling is None:
        t = (1.0 - d) / n
    else:
        leak = torch.sum(pr * dangling) / n
        t = d * leak + (1.0 - d) / n
    return pagerank_step(H, pr, t, d=d)
