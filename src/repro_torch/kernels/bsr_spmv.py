"""Block-sparse-row SpMV: ``y = H_bsr @ x`` over zero-padded (bs x bs)
blocks, with float32 accumulation, for blocks stored as float32, bfloat16,
float16 or int8.

:func:`bsr_spmv` is the ``bsr`` tier's product.  ``x`` is one vector (the
TPU kernel's own function) or a batch of queries ``X`` (B, m), one query
per row, so the tier's personalized PageRank and landmark push make one
launch per iteration or sweep for all queries.  On CUDA tensors it
launches the hand-written Hopper kernel in ``csrc/bsr_spmv.cu``; on CPU
tensors it runs the plain version
:func:`repro_torch.kernels.ref.bsr_spmv_ref`.  A CUDA input either
launches the kernel or raises — there is no fallback.  int8 row scales are
the caller's to apply (``ops.spmv`` and the engine), as in the JAX
package.

``x`` shorter than the blocks' columns is zero-padded to a multiple of the
block size (a copy of ``x``, as the Pallas wrapper pads); the engine's
layouts pass it padded already.

``launches`` counts kernel launches per storage dtype; only the CUDA path
adds to it, once per launch.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels._build import KernelLaunchError
from repro_torch.kernels.ref import bsr_spmv_ref

__all__ = ["bsr_spmv", "launches", "reset_launches"]

_DTYPES = {torch.float32: (0, "f32"), torch.bfloat16: (1, "bf16"),
           torch.float16: (2, "f16"), torch.int8: (3, "int8")}

launches = {name: 0 for _, name in _DTYPES.values()}

_lib = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _library():
    global _lib
    if _lib is None:
        from repro_torch.kernels import _build
        lib = _build.load("bsr_spmv")
        lib.bsr_spmv_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
            + [ctypes.c_void_p])
        lib.bsr_spmv_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"bsr_spmv: {msg}")


def bsr_spmv(blocks: torch.Tensor, block_cols: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """``y = H_bsr @ x``.

    ``blocks``: (nb_r, mb, bs, bs) float32, bfloat16, float16 or int8,
    contiguous; ``block_cols``: (nb_r, mb) int32 block columns (padded
    slots: zero blocks at column 0).  ``x``: (m,) float32, or (B, m) for B
    queries, with m at most ``nb_c * bs``.  Returns (nb_r * bs,) or
    (B, nb_r * bs) float32.  Two calls on the same inputs give the same
    bits, and a query's result does not depend on the rest of its batch.
    """
    _check(blocks.dim() == 4 and blocks.shape[2] == blocks.shape[3],
           f"blocks {tuple(blocks.shape)} must be (nb_r, mb, bs, bs)")
    nb_r, mb, bs, _ = blocks.shape
    _check(tuple(block_cols.shape) == (nb_r, mb),
           f"block_cols {tuple(block_cols.shape)} must be {(nb_r, mb)}")
    _check(x.dim() in (1, 2), f"x {tuple(x.shape)} must be (m,) or (B, m)")
    if all(a.device.type == "cpu" for a in (blocks, block_cols, x)):
        return bsr_spmv_ref(blocks, block_cols, x)

    dev = blocks.device
    _check(dev.type == "cuda" and block_cols.device == dev
           and x.device == dev, "all tensors must be on one CUDA device")
    _check(blocks.dtype in _DTYPES, f"unsupported storage dtype "
           f"{blocks.dtype}")
    _check(block_cols.dtype == torch.int32, "block_cols must be int32")
    _check(x.dtype == torch.float32, "x must be float32")
    _check(blocks.is_contiguous() and block_cols.is_contiguous(),
           "blocks and block_cols must be contiguous")
    _check(bs % 4 == 0, f"the block size must be a multiple of 4, got {bs}")
    _check(blocks.data_ptr() % (4 * blocks.element_size()) == 0,
           "blocks must be aligned to 4 elements")
    X = x[None, :] if x.dim() == 1 else x
    B, m = X.shape
    _check(B > 0 and m > 0 and nb_r > 0 and mb > 0, "empty operand")
    if m % bs:
        X = F.pad(X, (0, bs - m % bs))
    X = X.contiguous()
    if X.data_ptr() % 16:
        X = X.clone()
    lib = _library()
    code, name = _DTYPES[blocks.dtype]
    Y = torch.empty((B, nb_r * bs), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):          # launch on the tensors' card
        err = lib.bsr_spmv_launch(
            code, blocks.data_ptr(), block_cols.data_ptr(), X.data_ptr(),
            Y.data_ptr(), nb_r, mb, bs, X.shape[1], B,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise KernelLaunchError(
            f"bsr_spmv launch failed: cudaError_t {err}")
    launches[name] += 1
    return Y[0] if x.dim() == 1 else Y
