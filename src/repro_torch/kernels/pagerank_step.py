"""PageRank iterations: y = d * (H @ x) + t in one pass over H.

Two entry points, both hand-written Hopper kernels in
``csrc/pagerank_step.cu``:

* :func:`pagerank_step_fused` (K1) — the engine's hot-loop kernel on the
  **pre-padded** layout (:func:`pad_pagerank_operands` pads once per
  graph); it also returns the dangling leak of the new rank vector.
* :func:`pagerank_step` (K4) — the unpadded convenience step behind
  ``ops.pagerank_iteration``: any (N, M) H, no leak output, and nothing
  padded or copied per call.

On CUDA tensors each launches its kernel; on CPU tensors each runs its
plain version (:func:`repro_torch.kernels.ref.pagerank_step_fused_ref`,
:func:`repro_torch.kernels.ref.pagerank_step_ref`).  A CUDA input either
launches the kernel or raises — there is no fallback.

``launches`` (K1) and ``step_launches`` (K4) count kernel launches per
storage dtype; only the CUDA path adds to them, once per launch.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels._build import KernelLaunchError
from repro_torch.kernels.ref import (pagerank_step_fused_ref,
                                     pagerank_step_ref)

__all__ = ["pagerank_step_fused", "pagerank_step", "pad_pagerank_operands",
           "launches", "step_launches", "reset_launches"]

_DTYPES = {torch.float32: (0, "f32"), torch.bfloat16: (1, "bf16"),
           torch.float16: (2, "f16"), torch.int8: (3, "int8")}

# rows one CTA of either kernel owns (kRowsPerCta in the source)
ROWS_PER_CTA = 8
# padding multiple of pad_pagerank_operands
PAD = 256

launches = {name: 0 for _, name in _DTYPES.values()}
step_launches = {name: 0 for _, name in _DTYPES.values()}

_lib = None


def reset_launches() -> None:
    """Zero both counts (K1's ``launches`` and K4's ``step_launches``)."""
    for counts in (launches, step_launches):
        for k in counts:
            counts[k] = 0


def _library():
    global _lib
    if _lib is None:
        from repro_torch.kernels import _build
        lib = _build.load("pagerank_step")
        lib.pagerank_step_fused_launch.argtypes = [
            ctypes.c_int] + [ctypes.c_void_p] * 8 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        lib.pagerank_step_fused_launch.restype = ctypes.c_int
        lib.pagerank_step_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 4
            + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
        lib.pagerank_step_launch.restype = ctypes.c_int
        lib.pagerank_step_fused_rows_per_block.argtypes = []
        lib.pagerank_step_fused_rows_per_block.restype = ctypes.c_int
        rows = lib.pagerank_step_fused_rows_per_block()
        if rows != ROWS_PER_CTA:
            raise _build.KernelBuildError(
                f"pagerank_step.cu owns {rows} rows per CTA, the wrapper "
                f"expects {ROWS_PER_CTA}")
        _lib = lib
    return _lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"pagerank_step_fused: {msg}")


def _check_step(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"pagerank_step: {msg}")


def pagerank_step_fused(Hp: torch.Tensor, xp: torch.Tensor,
                        dangp: torch.Tensor, t: torch.Tensor,
                        scales: torch.Tensor | None = None, *,
                        d: float = 0.85) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused iteration on the pre-padded layout.

    ``Hp``: (Np, Mp) transition matrix stored as float32, bfloat16,
    float16 or int8, zero-padded so that Np is a multiple of
    :data:`ROWS_PER_CTA` and Mp of 16 (:func:`pad_pagerank_operands` does
    that).  ``xp``: (1, Mp) float32 rank vector, ``dangp``: (1, Np)
    float32 dangling mask (zero in the padded tail), ``t``: the float32
    teleport-plus-leak scalar (a 0-dim or 1-element tensor; it stays on
    the device).  ``scales``: optional (1, Np) float32 per-row
    dequantization scales of an int8 layout.  Returns ``(yp, leak)``: the
    (1, Np) float32 ``yp = d * (s * (Hp @ xp)) + t`` (the padded tail holds
    ``t``) and the 0-dim ``leak = sum(yp * dangp)``.
    """
    Np, Mp = Hp.shape
    _check(Np % ROWS_PER_CTA == 0 and Mp % 16 == 0,
           f"inputs must be pre-padded: Np a multiple of {ROWS_PER_CTA} and "
           f"Mp of 16, got {(Np, Mp)} (pad with pad_pagerank_operands)")
    args = [Hp, xp, dangp, t] + ([] if scales is None else [scales])
    if all(a.device.type == "cpu" for a in args):
        return pagerank_step_fused_ref(Hp, xp, dangp, t, scales, d=d)

    dev = Hp.device
    _check(dev.type == "cuda" and all(a.device == dev for a in args),
           "all tensors must be on one CUDA device")
    _check(Hp.dtype in _DTYPES, f"unsupported storage dtype {Hp.dtype}")
    _check(xp.shape == (1, Mp) and dangp.shape == (1, Np),
           f"xp {tuple(xp.shape)} / dangp {tuple(dangp.shape)} do not "
           f"match Hp {(Np, Mp)}")
    _check(t.numel() == 1, "t must hold one value")
    for name, a in (("xp", xp), ("dangp", dangp), ("t", t)) + (
            () if scales is None else (("scales", scales),)):
        _check(a.dtype == torch.float32, f"{name} must be float32")
    _check(scales is None or scales.shape == (1, Np),
           f"scales must be (1, {Np})")
    _check(all(a.is_contiguous() for a in args),
           "all tensors must be contiguous")
    _check(Hp.data_ptr() % 16 == 0 and xp.data_ptr() % 16 == 0,
           "Hp and xp must be 16-byte aligned")
    lib = _library()
    code, name = _DTYPES[Hp.dtype]
    yp = torch.empty((1, Np), dtype=torch.float32, device=dev)
    partials = torch.empty((Np // ROWS_PER_CTA,), dtype=torch.float32,
                           device=dev)
    leak = torch.empty((), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):          # launch on the tensors' card
        err = lib.pagerank_step_fused_launch(
            code, Hp.data_ptr(), xp.data_ptr(), dangp.data_ptr(),
            t.data_ptr(), None if scales is None else scales.data_ptr(),
            yp.data_ptr(), partials.data_ptr(), leak.data_ptr(), Np, Mp,
            float(d), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise KernelLaunchError(
            f"pagerank_step_fused launch failed: cudaError_t {err}")
    launches[name] += 1
    return yp, leak


def pagerank_step(H: torch.Tensor, pr: torch.Tensor, t, *,
                  d: float = 0.85) -> torch.Tensor:
    """One unpadded iteration: ``d * (H @ pr) + t`` as an (N,) float32
    tensor.

    ``H``: (N, M) float32, bfloat16, float16 or int8, contiguous; ``pr``:
    (M,) float32; ``t``: the float32 teleport-plus-leak scalar (a 0-dim or
    1-element tensor, kept on the device; a Python number is placed
    there).  Any N and M are taken, at any element alignment, and H is
    never padded or copied: when a row of H is a multiple of 16 bytes and
    H and ``pr`` are 16-byte aligned, the rows of a warp stream together
    and share each load of ``pr``; otherwise each row loads a head and a
    tail of single elements around a 16-byte-aligned body, and ``pr`` is
    read a float at a time.
    """
    _check_step(H.dim() == 2 and pr.dim() == 1 and pr.shape[0] == H.shape[1],
           f"H {tuple(H.shape)} and pr {tuple(pr.shape)} must be (N, M) "
           "and (M,)")
    if not isinstance(t, torch.Tensor):
        # a fill on the device: no host-to-device copy, no sync
        t = torch.full((), float(t), dtype=torch.float32, device=H.device)
    if all(a.device.type == "cpu" for a in (H, pr, t)):
        return pagerank_step_ref(H, pr, t.reshape(()), d=d)

    dev = H.device
    _check_step(dev.type == "cuda" and pr.device == dev and t.device == dev,
           "all tensors must be on one CUDA device")
    _check_step(H.dtype in _DTYPES, f"unsupported storage dtype {H.dtype}")
    _check_step(pr.dtype == torch.float32 and t.dtype == torch.float32,
           "pr and t must be float32")
    _check_step(t.numel() == 1, "t must hold one value")
    _check_step(H.is_contiguous(), "H must be contiguous")
    N, M = H.shape
    _check_step(N > 0 and M > 0, "empty operand")
    pr, t = pr.contiguous(), t.contiguous()
    lib = _library()
    code, name = _DTYPES[H.dtype]
    y = torch.empty((N,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):          # launch on the tensors' card
        err = lib.pagerank_step_launch(
            code, H.data_ptr(), pr.data_ptr(), t.data_ptr(), y.data_ptr(),
            N, M, float(d), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise KernelLaunchError(
            f"pagerank_step launch failed: cudaError_t {err}")
    step_launches[name] += 1
    return y


def pad_pagerank_operands(H: torch.Tensor, dangling=None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """One-time layout prep for :func:`pagerank_step_fused`.

    Returns ``(Hp, dangp)``, zero-padded on ``H``'s device: each axis to a
    multiple of :data:`PAD` (of 128 for an axis of at most 128 entries),
    which is the JAX package's default layout, so both hold the same
    bytes.  Do this once per graph so nothing in the hot loop re-pads.
    """
    N, M = H.shape
    Np, Mp = _padded(N), _padded(M)
    Hp = F.pad(H, (0, Mp - M, 0, Np - N)).contiguous()
    dang = (torch.zeros((N,), dtype=torch.float32, device=H.device)
            if dangling is None else
            torch.as_tensor(dangling).to(device=H.device,
                                         dtype=torch.float32))
    dangp = F.pad(dang, (0, Np - N))[None, :].contiguous()
    return Hp, dangp


def _padded(x: int) -> int:
    return _mult(x, min(PAD, _mult(x, 128)))


def _mult(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
