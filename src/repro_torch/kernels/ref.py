"""Plain PyTorch versions of the port's kernels (the correctness contract).

Each function is the mathematical definition its hand-written kernel must
match: the CPU tests run it against the JAX package, and ``chip_smoke.py``
holds the CUDA kernel against it on the card.  Reduced-precision operands
(bf16 / f16 / int8) go through :func:`upcast_f32` — the same
upcast-then-accumulate-in-f32 contract the kernels implement.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import upcast_f32

__all__ = ["streaming_matvec_ref", "bsr_spmv_ref", "pagerank_step_ref",
           "pagerank_step_fused_ref"]


def streaming_matvec_ref(W: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Y = X @ W^T, f32 accumulation."""
    return upcast_f32(X) @ upcast_f32(W).T


def bsr_spmv_ref(blocks: torch.Tensor, block_cols: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """BSR matvec ``y = H_bsr @ x`` over zero-padded blocks: ``x`` (m,)
    gives (nb_r * bs,); a query batch ``X`` (B, m), one query per row,
    gives (B, nb_r * bs).  ``x`` is zero-padded to a multiple of the block
    size; padded slots (zero blocks at block column 0) contribute 0."""
    nb_r, mb, bs, _ = blocks.shape
    X = x[None, :] if x.dim() == 1 else x
    if X.shape[1] % bs:
        X = torch.nn.functional.pad(X, (0, bs - X.shape[1] % bs))
    xb = X.reshape(X.shape[0], -1, bs)
    gathered = xb[:, block_cols.long()]              # (B, nb_r, mb, bs)
    y = torch.einsum("rbij,qrbj->qri", upcast_f32(blocks),
                     upcast_f32(gathered)).reshape(X.shape[0], nb_r * bs)
    return y[0] if x.dim() == 1 else y


def pagerank_step_ref(H: torch.Tensor, pr: torch.Tensor, t,
                      d: float = 0.85) -> torch.Tensor:
    return d * (upcast_f32(H) @ upcast_f32(pr)) + t


def pagerank_step_fused_ref(Hp: torch.Tensor, xp: torch.Tensor,
                            dangp: torch.Tensor, t: torch.Tensor,
                            scales: torch.Tensor | None = None, *,
                            d: float = 0.85
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused step on the pre-padded layout: ``yp = d * (s * (Hp @ xp))
    + t`` as a (1, Np) row, and ``leak = sum(yp * dangp)`` as a 0-dim
    tensor.  The epilogue runs in the kernel's order: the int8 row scale
    first, then the damping, then ``t``."""
    acc = upcast_f32(xp) @ upcast_f32(Hp).T               # (1, Np)
    if scales is not None:
        acc = scales * acc
    yp = d * acc + t.reshape(())
    return yp, torch.sum(yp * dangp)
