"""Reduced-precision layout tiers: storage dtypes, quantization, accounting.

Every prepared layout carries a ``precision`` dimension:

* ``"f32"``  — float32 operands.
* ``"bf16"`` / ``"f16"`` — the H/ELL *value* arrays are stored in the
  reduced dtype; every kernel upcasts in-register and accumulates in
  float32.
* ``"int8"`` — per-row-scaled integers (``q = round(v/s)`` with
  ``s = rowmax/127``, float32 scales), dequantized by folding the row scale
  into the already-accumulated float32 row sums.

The rank vector, the dangling mask, residuals, and all loop carries stay
float32 in every tier — only the prepared operand values shrink.  The
quantizer runs in numpy, exactly as in ``repro.pagerank.precision``, so the
two packages' quantized layouts are bit-identical; handed torch tensors, it
runs on their device with the same bits.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

__all__ = ["PRECISIONS", "STORAGE_DTYPES", "SOLVE_DTYPE",
           "resolve_precision", "solve_dtype", "rowmax_scales",
           "quantize_int8", "quantize_rows", "layout_nbytes"]

PRECISIONS = ("f32", "bf16", "f16", "int8")

STORAGE_DTYPES = {
    "f32": torch.float32,
    "bf16": torch.bfloat16,
    "f16": torch.float16,
    "int8": torch.int8,
}

# every solve (rank vectors, residuals, scales, accumulation) runs here
SOLVE_DTYPE = torch.float32


def resolve_precision(precision: str) -> str:
    """Validate and resolve a precision tier; ``"auto"`` stays ``"f32"`` —
    reduced precision is an explicit accuracy trade the caller opts into,
    never something the auto policy silently picks."""
    if precision == "auto":
        return "f32"
    if precision not in PRECISIONS:
        raise ValueError(
            f"precision {precision!r} not in {PRECISIONS + ('auto',)}")
    return precision


def solve_dtype(x, name: str = "x0"):
    """Coerce a user-supplied solve input (warm-start vector, tolerance) to
    the float32 solve dtype — the single coercion point.  ``None`` passes
    through; a float32 tensor passes through untouched (warm starts are
    never re-cast); a float64 input (numpy or torch) gets one explicit,
    warned downcast.  Returns a tensor on the input's own device (a
    numpy array or Python number lands on the CPU)."""
    if x is None:
        return None
    host_dt = getattr(x, "dtype", None)
    if isinstance(host_dt, torch.dtype):
        is_f64 = host_dt == torch.float64
    else:
        is_f64 = host_dt is not None and np.dtype(host_dt) == np.float64
    if is_f64:
        warnings.warn(
            f"{name} is float64 but the engine solves in float32; "
            "downcasting once here (pass float32 to silence)",
            UserWarning, stacklevel=3)
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.array(x, copy=True))
    x = torch.as_tensor(x)
    if x.dtype == SOLVE_DTYPE:
        return x
    return x.to(SOLVE_DTYPE)


def rowmax_scales(absmax: np.ndarray) -> np.ndarray:
    """Per-row int8 dequantization scales from per-row abs-maxima:
    ``s = rowmax / 127`` so the largest entry maps to ±127; all-zero rows
    get scale 1.0 (their quantized entries are 0 regardless)."""
    if isinstance(absmax, torch.Tensor):
        absmax = absmax.float()
        # a tensor divisor: CUDA divides by a Python scalar as a product
        # with its reciprocal, which can miss numpy's quotient by an ulp
        d = torch.full((), 127.0, device=absmax.device)
        return torch.where(absmax > 0, absmax / d, 1.0)
    absmax = np.asarray(absmax, np.float32)
    return np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)


def quantize_int8(vals: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """Round-to-nearest int8 quantization ``q = clip(rint(v / s), ±127)``.
    ``scales`` must broadcast against ``vals`` (pre-expanded to the row
    axis by the caller)."""
    if isinstance(vals, torch.Tensor):      # round: half to even, as rint
        q = torch.round(vals.float() / scales)
        return q.clamp_(-127, 127).to(torch.int8)
    q = np.rint(np.asarray(vals, np.float32) / scales)
    return np.clip(q, -127, 127).astype(np.int8)


def quantize_rows(vals: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """A 2-D host array quantized to int8 by rows: ``(q, scales)``, the
    scales from each row's abs-max."""
    scales = rowmax_scales(np.abs(vals).max(axis=1, initial=0.0))
    return quantize_int8(vals, scales[:, None]), scales


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _leaves(t)
    elif hasattr(tree, "tensors"):          # a container: BSRMatrix
        yield from tree.tensors()
    elif hasattr(tree, "shards"):           # a ShardedTensor: its global
        yield tree                          # size, as a JAX sharded array
    elif tree is not None:
        raise TypeError(f"layout leaf of type {type(tree).__name__}")


def layout_nbytes(operands) -> dict:
    """Byte accounting of a prepared layout (a nest of tuples of tensors
    and containers such as ``BSRMatrix``),
    split into *value* bytes (the matrix values — what precision tiers
    shrink — plus their float32 scales) and *index* bytes (integer
    column/row arrays other than int8, which no precision tier touches)."""
    value = index = 0
    for leaf in _leaves(operands):
        nbytes = leaf.numel() * leaf.element_size()
        dt = leaf.dtype
        if (not dt.is_floating_point and not dt.is_complex
                and dt not in (torch.int8, torch.bool)):
            index += nbytes
        else:
            value += nbytes
    return {"value_bytes": int(value), "index_bytes": int(index),
            "total_bytes": int(value + index)}
