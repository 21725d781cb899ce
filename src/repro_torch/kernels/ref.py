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

__all__ = ["streaming_matvec_ref", "pagerank_step_ref",
           "pagerank_step_fused_ref"]


def streaming_matvec_ref(W: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Y = X @ W^T, f32 accumulation."""
    return upcast_f32(X) @ upcast_f32(W).T


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
