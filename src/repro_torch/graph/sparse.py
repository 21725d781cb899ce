"""Sparse matrix containers on torch tensors.

Only :class:`CSRMatrix` is ported so far: it is the host/reference format
and the source of the engine's split-ELL layout.  The ELL and BSR
containers of ``repro.graph.sparse`` are not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device

__all__ = ["CSRMatrix"]


@dataclasses.dataclass(frozen=True)
class CSRMatrix:
    data: torch.Tensor      # (nnz,) f32
    indices: torch.Tensor   # (nnz,) i32 column ids
    indptr: torch.Tensor    # (n_rows+1,) i32
    row_ids: torch.Tensor   # (nnz,) i32 — precomputed row of each nnz
    shape: tuple[int, int] = (0, 0)

    @staticmethod
    def from_coo(src: np.ndarray, dst: np.ndarray, vals: np.ndarray,
                 shape: tuple[int, int],
                 device: str | torch.device | None = None) -> "CSRMatrix":
        """Rows ``src``, columns ``dst``; built in numpy (row-major sorted,
        exactly as the JAX container builds it), then placed on
        ``device``."""
        dev = resolve_device(device)
        order = np.lexsort((dst, src))
        rows = np.asarray(src)[order]
        cols = np.asarray(dst)[order]
        data = np.asarray(vals)[order].astype(np.float32)
        indptr = np.zeros(shape[0] + 1, np.int32)
        np.add.at(indptr, rows + 1, 1)
        indptr = np.cumsum(indptr).astype(np.int32)

        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

        return CSRMatrix(put(data, np.float32), put(cols, np.int32),
                         put(indptr, np.int32), put(rows, np.int32),
                         shape=tuple(shape))

    @property
    def nnz(self) -> int:
        return self.data.shape[0]

    def row_positions(self) -> tuple[np.ndarray, np.ndarray]:
        """Host-side (row, position-within-row) of every nnz — the scatter
        coordinates of the engine's split-ELL layout prep."""
        indptr = self.indptr.cpu().numpy()
        counts = np.diff(indptr)
        rows = np.repeat(np.arange(self.shape[0]), counts)
        pos = np.arange(rows.size) - np.repeat(indptr[:-1], counts)
        return rows, pos

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x.  The row sums go through ``index_add_``, which on a
        CUDA tensor adds in atomic (unfixed) order."""
        prod = self.data * x.index_select(0, self.indices)
        out = torch.zeros(self.shape[0], dtype=prod.dtype, device=x.device)
        return out.index_add_(0, self.row_ids, prod)
