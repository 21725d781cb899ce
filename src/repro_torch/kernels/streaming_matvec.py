"""Weight-streaming batched matrix-vector product: ``Y = X @ W.T`` with
float32 accumulation, for ``W`` (N, M) stored as float32, bfloat16,
float16 or int8 and ``X`` (B, M) float32.

:func:`streaming_matvec` is the batched personalized PageRank kernel: the
B queries ride its batch axis and share one sweep over ``W`` (the padded
transition matrix).  On CUDA tensors it launches the hand-written Hopper
kernel in ``csrc/streaming_matvec.cu``; on CPU tensors it runs the plain
version :func:`repro_torch.kernels.ref.streaming_matvec_ref`.  A CUDA
input either launches the kernel or raises — there is no fallback.  int8
row scales are the caller's to apply, as in the JAX package.

Any N and M are taken.  The kernel needs M to be a multiple of 4, so only
then does the wrapper pad the columns of ``W`` and ``X`` (a copy); the
engine's pre-padded layouts never need it.

``launches`` counts kernel launches per storage dtype, and
``batch_launches`` the same launches per (storage dtype, batch size B);
only the CUDA path adds to them, once per launch.
"""
from __future__ import annotations

import ctypes
from collections import Counter

import torch
import torch.nn.functional as F

from repro_torch.kernels._build import KernelLaunchError
from repro_torch.kernels.ref import streaming_matvec_ref

__all__ = ["streaming_matvec", "launches", "batch_launches",
           "reset_launches"]

_DTYPES = {torch.float32: (0, "f32"), torch.bfloat16: (1, "bf16"),
           torch.float16: (2, "f16"), torch.int8: (3, "int8")}

# the kernel reads W in groups of this many columns
_COL_MULT = 4

launches = {name: 0 for _, name in _DTYPES.values()}
batch_launches: Counter = Counter()     # (dtype name, B) -> launches

_lib = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
    batch_launches.clear()


def _library():
    global _lib
    if _lib is None:
        from repro_torch.kernels import _build
        lib = _build.load("streaming_matvec")
        lib.streaming_matvec_launch.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.streaming_matvec_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"streaming_matvec: {msg}")


def streaming_matvec(W: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """``Y = X @ W.T`` as a (B, N) float32 tensor.

    ``W``: (N, M) float32, bfloat16, float16 or int8, contiguous.  ``X``:
    (B, M) float32, contiguous.  Every product is accumulated in float32;
    two calls on the same inputs give the same bits.
    """
    _check(W.dim() == 2 and X.dim() == 2 and X.shape[1] == W.shape[1],
           f"W {tuple(W.shape)} and X {tuple(X.shape)} must be (N, M) and "
           "(B, M)")
    if W.device.type == "cpu" and X.device.type == "cpu":
        return streaming_matvec_ref(W, X)

    dev = W.device
    _check(dev.type == "cuda" and X.device == dev,
           "both tensors must be on one CUDA device")
    _check(W.dtype in _DTYPES, f"unsupported storage dtype {W.dtype}")
    _check(X.dtype == torch.float32, "X must be float32")
    _check(W.is_contiguous() and X.is_contiguous(),
           "both tensors must be contiguous")
    N, M = W.shape
    B = X.shape[0]
    _check(N > 0 and M > 0 and B > 0, "empty operand")
    if M % _COL_MULT:
        pad = _COL_MULT - M % _COL_MULT
        W, X = F.pad(W, (0, pad)), F.pad(X, (0, pad))
        M += pad
    _check(W.data_ptr() % (_COL_MULT * W.element_size()) == 0
           and X.data_ptr() % 16 == 0,
           f"W must be aligned to {_COL_MULT} elements and X to 16 bytes")
    lib = _library()
    code, name = _DTYPES[W.dtype]
    Y = torch.empty((B, N), dtype=torch.float32, device=dev)
    # the runtime launches on the current device: make it the tensors'
    # (the shards of a mesh may lie on several cards)
    with torch.cuda.device(dev):
        err = lib.streaming_matvec_launch(
            code, W.data_ptr(), X.data_ptr(), Y.data_ptr(), N, M, B,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise KernelLaunchError(
            f"streaming_matvec launch failed: cudaError_t {err}")
    launches[name] += 1
    batch_launches[name, B] += 1
    return Y
