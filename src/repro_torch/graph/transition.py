"""PageRank transition matrix H from an edge list.

``H[i, j] = 1 / outdeg(j)`` when there is an edge j -> i (column-stochastic).
Dangling nodes (outdeg 0) get uniform columns ``1/N`` when the fix is on.
Every layout here is built in numpy exactly as ``repro.graph.transition``
builds it, so the two packages' layouts are bit-identical, and only then
placed on the requested device.  The engine's ``ell`` tiers build the
transition CSR and the split ELL on their own device
(``repro_torch.pagerank.engine``) to the same bits; these functions are
their host reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.graph.sparse import BSRMatrix, CSRMatrix, ELLMatrix
from repro_torch.kernels.common import resolve_device

__all__ = ["dangling_fix", "transition_dense_np", "build_transition_dense",
           "build_transition_csr", "build_transition_ell",
           "build_transition_bsr", "dangling_mask"]


def dangling_fix(H: np.ndarray) -> np.ndarray:
    """Replace all-zero columns with uniform 1/N (numpy, host-side)."""
    H = np.array(H, np.float32, copy=True)
    n = H.shape[0]
    colsum = H.sum(axis=0)
    dangling = colsum == 0
    H[:, dangling] = 1.0 / n
    return H


def transition_dense_np(src: np.ndarray, dst: np.ndarray, n: int,
                        fix_dangling: bool = True) -> np.ndarray:
    """Dense column-stochastic H as a host float32 array."""
    A = np.zeros((n, n), np.float32)
    A[dst, src] = 1.0                       # edge src -> dst contributes H[dst, src]
    outdeg = np.bincount(src, minlength=n).astype(np.float32)
    nz = outdeg > 0
    A[:, nz] /= outdeg[nz]
    if fix_dangling:
        A = dangling_fix(A)
    return A


def build_transition_dense(src: np.ndarray, dst: np.ndarray, n: int,
                           fix_dangling: bool = True,
                           device: str | torch.device | None = None
                           ) -> torch.Tensor:
    """Dense column-stochastic H (the paper's fabric layout) on
    ``device``."""
    dev = resolve_device(device)
    return torch.from_numpy(
        transition_dense_np(src, dst, n, fix_dangling)).to(dev)


def build_transition_csr(src: np.ndarray, dst: np.ndarray, n: int,
                         device: str | torch.device | None = None
                         ) -> CSRMatrix:
    outdeg = np.bincount(src, minlength=n).astype(np.float32)
    vals = 1.0 / outdeg[src]
    return CSRMatrix.from_coo(dst, src, vals, shape=(n, n), device=device)


def build_transition_ell(src: np.ndarray, dst: np.ndarray, n: int,
                         k: int | None = None,
                         device: str | torch.device | None = None
                         ) -> ELLMatrix:
    return ELLMatrix.from_csr(
        build_transition_csr(src, dst, n, device=device), k=k)


def build_transition_bsr(src: np.ndarray, dst: np.ndarray, n: int,
                         bs: int = 128, max_blocks: int | None = None,
                         device: str | torch.device | None = None
                         ) -> BSRMatrix:
    """Block-sparse H, dangling-UNFIXED (the ``bsr`` tier pays the leak
    explicitly)."""
    outdeg = np.bincount(src, minlength=n).astype(np.float32)
    A = np.zeros((n, n), np.float32)
    A[dst, src] = 1.0 / outdeg[src]
    return BSRMatrix.from_dense(A, bs=bs, max_blocks=max_blocks,
                                device=device)


def dangling_mask(src: np.ndarray, n: int) -> np.ndarray:
    """Boolean mask of dangling nodes (no out-edges)."""
    return np.bincount(src, minlength=n) == 0
