"""Gradient compression with error feedback (the cross-pod all-reduce
trick), the port's counterpart of ``repro.train.compression``.

Int8 quantisation with a per-tensor scale; the quantisation error is
carried in an error-feedback buffer and re-added next step, so the
*accumulated* update is unbiased.  On a multi-pod deployment the int8
tensor is what crosses the interconnect; here compress -> decompress is
modelled on one device, which is numerically the same.  ``torch.round``
rounds half to even as ``jnp.round`` does, so ``q`` and ``scale`` are the
JAX package's bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.train.tree import leaves

__all__ = ["quantize_int8", "dequantize_int8", "compress_with_error_feedback",
           "compressed_bytes"]


def quantize_int8(x: torch.Tensor):
    """Symmetric per-tensor int8 quantisation.  Returns (q, scale), the
    scale a 0-d float32 tensor on ``x``'s device."""
    amax = x.abs().max()
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


@torch.no_grad()
def compress_with_error_feedback(grads, ef):
    """Per leaf: g' = deq(quant(g + ef)); ef' = (g + ef) - g'.  Writes g'
    into ``grads`` and ef' into ``ef`` (trees of one structure, float32
    leaves) and returns them: a second gradient-sized tree per step would
    be waste at full width."""
    for g, e in zip(leaves(grads), leaves(ef), strict=True):
        corrected = g + e
        deq = dequantize_int8(*quantize_int8(corrected))
        torch.sub(corrected, deq, out=e)
        g.copy_(deq)
    return grads, ef


def compressed_bytes(tree) -> int:
    """Wire bytes if this tree were all-reduced compressed (int8 +
    scale)."""
    return sum(x.numel() + 4 for x in leaves(tree))
