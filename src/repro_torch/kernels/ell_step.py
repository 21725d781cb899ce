"""One PageRank step on the ``ell`` tier's split-ELL layout, in two
launches of the hand-written Hopper kernels in ``csrc/ell_step.cu``.

:func:`ell_step` takes the layout's operands ``(data, idx, ov_r, ov_c,
ov_v[, scales])``, its :class:`EllMeta`, the dangling mask, a rank vector
``x`` and its leak ``sum(x * dang)``, and returns the next rank vector and
its leak, both on the device:

    new  = d * (s * (ELL(x) + overflow(x)) + leak / N) + (1 - d) / N
    leak = sum(new * dang)

The layout may also be a block of n rows of a larger H whose column
indices reach the whole vector x of N entries (the ``ell_split_sharded``
tier keeps one such block per card): ``dang`` is then the block's, the
returned leak is the block's part of the next leak, and the leak handed in
may be the (P,) parts of every block, summed in their order.  On one card
N = n and the leak is one number.

On CUDA tensors it launches the kernels (pass 1 over the overflow tail, in
fixed chunks of :data:`CHUNK` entries; pass 2 over the rows, which also
reduces the next leak); on CPU tensors it runs the plain version
:func:`ell_step_ref`.  A CUDA input either launches the kernels or raises
— there is no fallback.  Every sum runs in a fixed order, so two calls
give the same bits.  The kernels replace no TPU kernel: the JAX ``ell``
tier reaches no Pallas call (the note in the source says why they exist).

:func:`ell_meta` builds the metadata the kernels read beside the operands,
once per layout: the rows' counts of real ELL entries, the overflow's
compact row pointers and row ids, each chunk's first row, each pass-2
block's first overflow row, and the last-block ticket.

``launches`` counts kernel launches per storage dtype (two a step, one
when the layout has no overflow); only the CUDA path adds to it.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels._build import KernelLaunchError
from repro_torch.kernels.common import upcast_f32

__all__ = ["EllMeta", "ell_meta", "ell_step", "ell_step_ref", "CHUNK",
           "ROWS_PER_BLOCK", "launches", "reset_launches"]

_DTYPES = {torch.float32: (0, "f32"), torch.bfloat16: (1, "bf16"),
           torch.float16: (2, "f16"), torch.int8: (3, "int8")}

# overflow entries one pass-1 block owns, rows one pass-2 block owns,
# overflow entries one pass-1 thread owns (kChunk, kRowsPerBlock and kPer
# in the source, checked when it is loaded)
CHUNK = 1024
ROWS_PER_BLOCK = 128
RUN = 8

launches = {name: 0 for _, name in _DTYPES.values()}

_lib = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


class EllMeta(NamedTuple):
    """The kernels' view of a split-ELL layout with n rows and R overflow
    rows, int32 on the layout's device.  ``counts`` (n,): each row's real
    ELL entries, ``min(indeg, k0)``, or ``None`` to read all k0 slots;
    ``ov_ptr`` (R + 1,): the overflow entries of compact row r are
    ``ov_ptr[r]:ov_ptr[r + 1]``; ``ov_rows`` (R,): their rows;
    ``chunk_row`` (chunks + 1,): the compact row of entry ``c * CHUNK``
    (the last entry's for the last); ``block_ov`` (blocks + 1,): the first
    compact row at or past row ``b * ROWS_PER_BLOCK``; ``ticket`` (1,):
    pass 2's last-block counter, zero between steps."""
    counts: torch.Tensor | None
    ov_ptr: torch.Tensor
    ov_rows: torch.Tensor
    chunk_row: torch.Tensor
    block_ov: torch.Tensor
    ticket: torch.Tensor

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self
                   if t is not None)


def ell_meta(ov_r: torch.Tensor, n: int,
             counts: torch.Tensor | None = None) -> EllMeta:
    """:class:`EllMeta` of a layout with n rows whose overflow rows are
    ``ov_r`` (one per entry, in row-major order, as ``_split_ell`` and the
    JAX package build it), on ``ov_r``'s device."""
    dev = ov_r.device
    rows = ov_r.long()
    if rows.numel() > 1 and bool((rows[1:] < rows[:-1]).any()):
        raise ValueError("ell_meta: the overflow tail must be in row-major "
                         "order")
    ov_rows, sizes = torch.unique_consecutive(rows, return_counts=True)
    ov_ptr = F.pad(torch.cumsum(sizes, 0), (1, 0))
    E = rows.numel()
    chunks = -(-E // CHUNK)
    first = (torch.arange(chunks + 1, device=dev) * CHUNK).clamp(
        max=max(E - 1, 0))
    chunk_row = torch.searchsorted(ov_ptr, first, right=True) - 1
    blocks = -(-n // ROWS_PER_BLOCK)
    block_ov = torch.searchsorted(
        ov_rows, torch.arange(blocks + 1, device=dev) * ROWS_PER_BLOCK)
    return EllMeta(None if counts is None else counts.int(), ov_ptr.int(),
                   ov_rows.int(), chunk_row.int(),
                   block_ov.int(), torch.zeros(1, dtype=torch.int32,
                                               device=dev))


def _ordered_sums(slot: torch.Tensor, values: torch.Tensor):
    """The sums of ``values`` over each run of equal ``slot`` (which never
    decreases), each in element order, and the first element of each
    run."""
    sums = torch.zeros(int(slot[-1]) + 1, device=values.device).index_add_(
        0, slot, values)
    slots, size = torch.unique_consecutive(slot, return_counts=True)
    return sums[slots], F.pad(torch.cumsum(size, 0), (1, 0))[:-1]


def _leak_sum(leak: torch.Tensor) -> torch.Tensor:
    """The leak from its parts, added in order (one part: itself)."""
    parts = leak.reshape(-1)
    total = parts[0]
    for k in range(1, parts.numel()):
        total = total + parts[k]
    return total


def ell_step_ref(operands: tuple, meta: EllMeta, dang: torch.Tensor,
                 x: torch.Tensor, leak: torch.Tensor, *,
                 d: float = 0.85) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`ell_step`, summed as the kernels sum:
    the ELL block's first ``counts`` entries of each row; the overflow by
    runs of :data:`RUN` entries, the runs of each (row, chunk) pair, the
    chunks of each row, each in order; the int8 scales on the row sum, the
    leak's parts in order, the damping, the next leak (the block's part of
    it)."""
    data, idx, _, ov_c, ov_v = operands[:5]
    scales = operands[5] if len(operands) == 6 else None
    k0 = data.shape[1]
    n = x.shape[0]
    prod = upcast_f32(data) * x[idx.long()]
    if meta.counts is not None:
        slot = torch.arange(k0, device=x.device)
        prod = torch.where(slot[None, :] < meta.counts[:, None], prod, 0.0)
    y = torch.sum(prod, dim=1)
    E, R = ov_v.numel(), meta.ov_rows.numel()
    if E:
        row = torch.repeat_interleave(torch.arange(R, device=x.device),
                                      meta.ov_ptr.long().diff())
        e = torch.arange(E, device=x.device)
        # each row's run of a thread's RUN entries, then the runs of a
        # (row, chunk) pair, then the chunks of a row: each in order
        runs, first = _ordered_sums(row + e // RUN,
                                    upcast_f32(ov_v) * x[ov_c.long()])
        row, e = row[first], e[first]
        part, first = _ordered_sums(row + e // CHUNK, runs)
        tail = torch.zeros(R, device=x.device).index_add_(0, row[first],
                                                          part)
        y = y.index_add(0, meta.ov_rows.long(), tail)
    if scales is not None:
        y = y * scales
    new = d * (y + _leak_sum(leak) / n) + (1.0 - d) / n
    return new, torch.sum(new * dang)


def _library():
    global _lib
    if _lib is None:
        from repro_torch.kernels import _build
        lib = _build.load("ell_step")
        lib.ell_overflow_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int,
                                                      ctypes.c_void_p])
        lib.ell_overflow_launch.restype = ctypes.c_int
        lib.ell_rows_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 3
            + [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 8
            + [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4
            + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        lib.ell_rows_launch.restype = ctypes.c_int
        names = ("ell_step_chunk", "ell_step_rows_per_block", "ell_step_run")
        for name in names:
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        got = tuple(getattr(lib, name)() for name in names)
        if got != (CHUNK, ROWS_PER_BLOCK, RUN):
            raise _build.KernelBuildError(
                f"ell_step.cu takes chunks, blocks and runs of {got}, the "
                f"wrapper expects {(CHUNK, ROWS_PER_BLOCK, RUN)}")
        _lib = lib
    return _lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"ell_step: {msg}")


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def ell_step(operands: tuple, meta: EllMeta, dang: torch.Tensor,
             x: torch.Tensor, leak: torch.Tensor, *, d: float = 0.85,
             annotate=None, out: tuple | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """One step: returns ``(new, leak')`` as above, ``new`` (n,) float32
    and ``leak'`` a 0-dim float32 tensor on x's device.

    ``operands``: the ``ell`` tier's ``(data (n, k0), idx (n, k0), ov_r,
    ov_c, ov_v)``, values float32, bfloat16, float16 or int8 (then with
    float32 row scales (n,) appended), indices int32 below N, all
    contiguous; ``meta``: their :func:`ell_meta`; ``dang``: (n,) float32;
    ``x``: (N,) float32, N >= n; ``leak``: ``sum(x * dang)`` over the
    whole vector, one float32 or its (P,) parts, on the device.
    ``annotate``, if given, maps ``"overflow"`` and ``"rows"`` to a context
    manager placed around that pass's launch.  ``out``, if given, is the
    ``(new, leak')`` pair to write into: a contiguous (n,) float32 view and
    a one-float32 view, on x's device."""
    if all(t.device.type == "cpu" for t in (x, dang, operands[0])):
        got = ell_step_ref(operands, meta, dang, x, leak, d=d)
        if out is None:
            return got
        out[0].copy_(got[0])
        out[1].copy_(got[1].reshape(out[1].shape))
        return out
    data, idx, _, ov_c, ov_v = operands[:5]
    scales = operands[5] if len(operands) == 6 else None
    n, k0 = data.shape
    N = x.shape[0]
    dev = x.device
    _check(dev.type == "cuda" and all(
        t.device == dev for t in (data, ov_v, dang, leak, meta.ov_ptr)),
        "all tensors must be on one CUDA device")
    _check(data.dtype in _DTYPES and ov_v.dtype == data.dtype,
           f"unsupported storage dtypes {data.dtype} / {ov_v.dtype}")
    _check(x.dim() == 1 and N >= n and N < 2**31 and dang.shape == (n,)
           and leak.numel() >= 1 and leak.is_contiguous()
           and x.dtype == dang.dtype == leak.dtype == torch.float32,
           f"x {tuple(x.shape)} must be (N >= {n},), dang "
           f"{tuple(dang.shape)} ({n},), float32, and the leak float32")
    _check(out is None or (
        out[0].shape == (n,) and out[1].numel() == 1
        and out[0].is_contiguous()
        and all(t.device == dev and t.dtype == torch.float32 for t in out)),
        f"out must be a contiguous ({n},) float32 view and one float32 on "
        "x's device")
    _check(idx.dtype == ov_c.dtype == torch.int32
           and (scales is None or scales.dtype == torch.float32),
           "indices must be int32 and int8 scales float32")
    _check(all(t.is_contiguous() for t in operands),
           "the operands must be contiguous")
    E = ov_v.numel()
    _check(E < 2**31 - CHUNK, f"{E} overflow entries overrun int32")
    _check(ov_v.data_ptr() % 16 == 0 and ov_c.data_ptr() % 16 == 0,
           "ov_v and ov_c must be 16-byte aligned")
    lib = _library()
    code, name = _DTYPES[data.dtype]
    stream = torch.cuda.current_stream(dev).cuda_stream
    R = meta.ov_rows.numel()
    blocks = meta.block_ov.numel() - 1
    chunks = meta.chunk_row.numel() - 1
    scratch = torch.empty(R + chunks + blocks, dtype=torch.float32,
                          device=dev)
    part = scratch.data_ptr()
    block_leak = part + 4 * (R + chunks)
    if out is None:
        new = torch.empty(n, dtype=torch.float32, device=dev)
        leak_out = torch.empty((), dtype=torch.float32, device=dev)
    else:
        new, leak_out = out
    ranges = annotate or (lambda _: contextlib.nullcontext())
    x = x.contiguous()
    with torch.cuda.device(dev):          # launch on the tensors' card
        if E:
            with ranges("overflow"):
                err = lib.ell_overflow_launch(
                    code, ov_v.data_ptr(), ov_c.data_ptr(),
                    meta.ov_ptr.data_ptr(), meta.chunk_row.data_ptr(),
                    x.data_ptr(), part, E, stream)
            if err:
                raise KernelLaunchError(
                    f"ell_step overflow launch failed: cudaError_t {err}")
            launches[name] += 1
        with ranges("rows"):
            err = lib.ell_rows_launch(
                code, data.data_ptr(), idx.data_ptr(), _ptr(meta.counts), n,
                k0, meta.ov_ptr.data_ptr(), meta.ov_rows.data_ptr(),
                meta.block_ov.data_ptr(), part, _ptr(scales),
                dang.data_ptr(), x.data_ptr(), leak.data_ptr(),
                leak.numel(), N, new.data_ptr(), block_leak,
                meta.ticket.data_ptr(), leak_out.data_ptr(), float(d),
                float((1.0 - d) / N), stream)
        if err:
            raise KernelLaunchError(
                f"ell_step rows launch failed: cudaError_t {err}")
        launches[name] += 1
    return new, leak_out
