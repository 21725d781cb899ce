"""Sparse matrix containers on torch tensors.

Three formats, as in ``repro.graph.sparse``, each built in numpy exactly as
the JAX container builds it (so the arrays are bit-identical) and only then
placed on a device:

* :class:`CSRMatrix` — host/reference format; the engine's ``ell`` tiers
  build the same container on their device
  (``repro_torch.pagerank.engine._transition_csr``) as the source of their
  layouts.
* :class:`ELLMatrix` — fixed nonzeros-per-row padding; SpMV is a dense
  gather and a rowwise sum.
* :class:`BSRMatrix` — block-sparse rows with dense (bs x bs) blocks, the
  layout of the ``bsr`` tier and of the hand-written kernel
  :func:`repro_torch.kernels.bsr_spmv.bsr_spmv`.  Its ``matvec`` /
  ``matmat`` here are the plain PyTorch definitions (the JAX tier's
  einsum); the engine's ``bsr`` tier runs the kernel through
  :func:`repro_torch.kernels.ops.spmv`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device, upcast_f32

__all__ = ["CSRMatrix", "ELLMatrix", "BSRMatrix"]


def _put(a, dtype, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)


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
        return CSRMatrix(_put(data, np.float32, dev),
                         _put(cols, np.int32, dev),
                         _put(indptr, np.int32, dev),
                         _put(rows, np.int32, dev), shape=tuple(shape))

    @property
    def nnz(self) -> int:
        return self.data.shape[0]

    def row_positions(self) -> tuple[np.ndarray, np.ndarray]:
        """Host-side (row, position-within-row) of every nnz — the scatter
        coordinates shared by the ELL builders and the engine's split-ELL
        layout prep."""
        indptr = self.indptr.cpu().numpy()
        counts = np.diff(indptr)
        rows = np.repeat(np.arange(self.shape[0]), counts)
        pos = np.arange(rows.size) - np.repeat(indptr[:-1], counts)
        return rows, pos

    def to(self, device: str | torch.device) -> "CSRMatrix":
        """The same matrix on ``device``."""
        return dataclasses.replace(
            self, data=self.data.to(device), indices=self.indices.to(device),
            indptr=self.indptr.to(device), row_ids=self.row_ids.to(device))

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x.  The row sums go through ``index_add_``, which on a
        CUDA tensor adds in atomic (unfixed) order."""
        prod = self.data * x.index_select(0, self.indices)
        out = torch.zeros(self.shape[0], dtype=prod.dtype, device=x.device)
        return out.index_add_(0, self.row_ids, prod)


@dataclasses.dataclass(frozen=True)
class ELLMatrix:
    """ELLPACK: ``data``/``indices`` are (n_rows, K) with zero padding."""

    data: torch.Tensor      # (n_rows, K) f32, 0 padded
    indices: torch.Tensor   # (n_rows, K) i32, 0 padded (data==0 masks)
    shape: tuple[int, int] = (0, 0)

    @staticmethod
    def from_csr(csr: CSRMatrix, k: int | None = None) -> "ELLMatrix":
        """Rows truncated at the ``k`` budget (default: the largest row),
        by one bulk scatter; placed on ``csr``'s device."""
        counts = np.diff(csr.indptr.cpu().numpy())
        kk = int(counts.max()) if k is None else k
        n = csr.shape[0]
        data = np.zeros((n, kk), np.float32)
        idx = np.zeros((n, kk), np.int32)
        cols = csr.indices.cpu().numpy()
        vals = csr.data.cpu().numpy()
        rows, pos = csr.row_positions()
        keep = pos < kk
        data[rows[keep], pos[keep]] = vals[keep]
        idx[rows[keep], pos[keep]] = cols[keep]
        dev = csr.data.device
        return ELLMatrix(_put(data, np.float32, dev),
                         _put(idx, np.int32, dev), shape=csr.shape)

    @property
    def k(self) -> int:
        return self.data.shape[1]

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.matmat(x[:, None])[:, 0]

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        """Y = A @ X for (M, Q) X — one gather serves all Q columns;
        reduced-precision ``data`` is upcast and summed in f32."""
        data = upcast_f32(self.data)
        return torch.sum(data[..., None] * X[self.indices.long()], dim=1)

    def todense(self) -> torch.Tensor:
        n, _ = self.shape
        rows = torch.arange(n, device=self.data.device).repeat_interleave(
            self.k)
        out = torch.zeros(self.shape, dtype=torch.float32,
                          device=self.data.device)
        return out.index_put_((rows, self.indices.reshape(-1).long()),
                              upcast_f32(self.data).reshape(-1),
                              accumulate=True)


@dataclasses.dataclass(frozen=True)
class BSRMatrix:
    """Block-sparse rows: for each block-row, a fixed budget of
    ``max_blocks`` dense (bs x bs) blocks (zero-padded), with their
    block-column indices.

    ``blocks``:    (n_block_rows, max_blocks, bs, bs) f32 — or a reduced
                   storage dtype (bf16/f16/int8); products upcast and
                   accumulate in f32.
    ``block_cols``:(n_block_rows, max_blocks) i32 — padded entries point at
                   block-column 0 with an all-zero block (safe to
                   accumulate).
    ``row_scales``:(n_block_rows * bs,) f32 per-row dequantization scales
                   for int8 blocks, folded into the accumulated row sums;
                   ``None`` for float layouts.
    """

    blocks: torch.Tensor
    block_cols: torch.Tensor
    shape: tuple[int, int] = (0, 0)
    row_scales: torch.Tensor | None = None

    @staticmethod
    def from_dense(A: np.ndarray, bs: int = 128,
                   max_blocks: int | None = None,
                   device: str | torch.device | None = None
                   ) -> "BSRMatrix":
        """Blocks in ``np.nonzero`` row-major order, the slot of a block
        being its rank since its block-row's start (the dynamic engine's
        slot map relies on this order)."""
        dev = resolve_device(device)
        A = np.asarray(A, np.float32)
        n, m = A.shape
        nb_r = -(-n // bs)
        nb_c = -(-m // bs)
        Ap = np.zeros((nb_r * bs, nb_c * bs), np.float32)
        Ap[:n, :m] = A
        blk = Ap.reshape(nb_r, bs, nb_c, bs).transpose(0, 2, 1, 3)
        nz = np.abs(blk).sum(axis=(2, 3)) > 0          # (nb_r, nb_c)
        counts = nz.sum(axis=1)
        mb = int(counts.max()) if max_blocks is None else max_blocks
        mb = max(mb, 1)
        blocks = np.zeros((nb_r, mb, bs, bs), np.float32)
        bcols = np.zeros((nb_r, mb), np.int32)
        r_idx, c_idx = np.nonzero(nz)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot = np.arange(len(r_idx)) - np.repeat(starts, counts)
        keep = slot < mb
        blocks[r_idx[keep], slot[keep]] = blk[r_idx[keep], c_idx[keep]]
        bcols[r_idx[keep], slot[keep]] = c_idx[keep]
        return BSRMatrix(_put(blocks, np.float32, dev),
                         _put(bcols, np.int32, dev), shape=(n, m))

    @property
    def block_size(self) -> int:
        return self.blocks.shape[-1]

    @property
    def max_blocks(self) -> int:
        return self.blocks.shape[1]

    def to(self, device: str | torch.device) -> "BSRMatrix":
        """The same layout on ``device``."""
        return dataclasses.replace(
            self, blocks=self.blocks.to(device),
            block_cols=self.block_cols.to(device),
            row_scales=(None if self.row_scales is None
                        else self.row_scales.to(device)))

    def tensors(self) -> tuple[torch.Tensor, ...]:
        """The array fields in the JAX pytree's leaf order (``blocks``,
        ``block_cols``, then ``row_scales`` when present)."""
        return (self.blocks, self.block_cols) + (
            () if self.row_scales is None else (self.row_scales,))

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """Plain BSR SpMV (the JAX container's definition)."""
        return self.matmat(x[:, None])[:, 0]

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        """Y = A @ X for (M, Q) X — blocks are gathered once per sweep;
        padded slots accumulate their zero block."""
        bs = self.block_size
        nb_r = self.blocks.shape[0]
        q = X.shape[1]
        m_pad = -(-self.shape[1] // bs) * bs
        Xp = torch.zeros((m_pad, q), dtype=X.dtype, device=X.device)
        Xp[:self.shape[1]] = X
        xb = Xp.reshape(-1, bs, q)                    # (nb_c, bs, Q)
        gathered = xb[self.block_cols.long()]         # (nb_r, mb, bs, Q)
        y = torch.einsum("rbij,rbjq->riq", upcast_f32(self.blocks),
                         upcast_f32(gathered))
        y = y.reshape(nb_r * bs, q)
        if self.row_scales is not None:
            y = y * self.row_scales[:, None]
        return y[:self.shape[0]]

    def todense(self) -> torch.Tensor:
        """The (n, m) float32 matrix, row scales applied."""
        nb_r, mb, bs, _ = self.blocks.shape
        nb_c = -(-self.shape[1] // bs)
        out = torch.zeros((nb_r, nb_c, bs, bs), dtype=torch.float32,
                          device=self.blocks.device)
        rows = torch.arange(nb_r, device=out.device).repeat_interleave(mb)
        out.index_put_((rows, self.block_cols.reshape(-1).long()),
                       upcast_f32(self.blocks).reshape(-1, bs, bs),
                       accumulate=True)
        out = out.transpose(1, 2).reshape(nb_r * bs, nb_c * bs)
        if self.row_scales is not None:
            out = out * self.row_scales[:, None]
        return out[:self.shape[0], :self.shape[1]]
