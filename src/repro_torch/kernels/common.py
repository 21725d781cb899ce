"""Shared kernel-layer helpers (dependency-free leaf module).

:func:`upcast_f32` is the mixed-precision contract: operand tiles may be
stored in a reduced dtype (bf16 / f16 / int8), but every multiply-accumulate
happens in float32.  :func:`resolve_device` is the one place the port's
entry points turn their ``device`` argument into a ``torch.device``: they
run on the card unless the caller asks for the CPU.
"""
from __future__ import annotations

import torch

__all__ = ["upcast_f32", "resolve_device"]


def upcast_f32(x: torch.Tensor) -> torch.Tensor:
    """Upcast a (possibly reduced-precision) operand to float32 for
    accumulation.  On a float32 input this returns the tensor itself, so
    the float32 tiers run exactly the same arithmetic through the shared
    code paths."""
    return x.to(torch.float32)


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means ``"cuda"``.  A CUDA device raises when CUDA is
    absent: the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
