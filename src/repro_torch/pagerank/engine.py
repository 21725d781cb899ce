"""PageRank engine: prepare a layout once, then run the power iteration on
the device.

The PyTorch counterpart of ``repro.pagerank.engine.PageRankEngine`` for the
single-device tiers:

* ``"dense"``       — dangling-fixed dense H (f32), ``H @ x`` sweeps.
* ``"ell"``         — split ELLPACK: a tight per-row budget (``ell_k``,
  default the 90th degree percentile) plus a COO overflow tail for hub
  rows.  On the card ``run`` and ``run_tol`` take each step in two
  launches of the hand-written split-ELL kernel
  (:func:`repro_torch.kernels.ell_step.ell_step`); the CPU and the batched
  products keep the eager gathers.
* ``"bsr"``         — block-sparse rows (``bsr_block_size`` blocks, 128 by
  default), H stored dangling-unfixed with the explicit leak; every
  product is one launch of the hand-written BSR kernel
  (:func:`repro_torch.kernels.bsr_spmv.bsr_spmv`, through
  :func:`repro_torch.kernels.ops.spmv`), for one vector or for all the
  queries of a PPR iteration or push sweep.
* ``"fused_dense"`` — the pre-padded dense layout through the hand-written
  fused kernel (:func:`repro_torch.kernels.pagerank_step
  .pagerank_step_fused`), which emits the dangling leak of the new rank
  vector from its own epilogue; its batched personalized PageRank runs on
  the hand-written streaming kernel
  (:func:`repro_torch.kernels.streaming_matvec.streaming_matvec`).  It
  stands for the JAX ``pallas_dense`` tier.
* ``"dense_sharded"`` — dangling-unfixed dense H blocked ``P(row, col)``
  over a 2-D :class:`~repro_torch.launch.mesh.Mesh`, iterated with the
  paper's fabric schedule (:mod:`repro_torch.pagerank.distributed`): one
  K2 launch per shard per iteration, one horizontal-bus psum and one
  re-injection; explicit scalar leak.
* ``"ell_sharded"`` — full-K ELL rows sharded over the flattened mesh,
  rank vector replicated, one all_gather per iteration.
* ``"auto"``        — :func:`select_backend` by density and device
  topology (more than one device picks a sharded tier).

Every tier supports the four storage precisions (f32, bf16, f16, int8 with
per-row scales); the solve itself is float32.  ``run`` issues its
iterations with no host sync; ``run_tol`` syncs once per
:data:`repro_torch.obs.trace.CHUNK` steps (see :mod:`repro_torch.obs.trace`).
The sharded tiers zero-pad N (and the PPR query axis) to what the mesh
divides; pad entries never feed back into real ranks and results are
sliced back to N.  Duplicate directed edges are collapsed up front, by one
sort on the engine's device, so every tier sees the same graph; self-loops
stay.  The ``ell`` tiers build their transition CSR from that edge set on
the same device.  The engine runs on the card unless ``device`` (or the
mesh) asks for the CPU.
"""
from __future__ import annotations

import contextlib
import math
import warnings
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import fabric_matvec as fm
from repro_torch.core.fabric_matvec import P, ShardedTensor
from repro_torch.graph import transition as tr
from repro_torch.graph.sparse import BSRMatrix, CSRMatrix, ELLMatrix
from repro_torch.kernels import ops as kops
from repro_torch.kernels.common import resolve_device, upcast_f32
from repro_torch.kernels.ell_step import ell_meta, ell_step
from repro_torch.kernels.pagerank_step import (pad_pagerank_operands,
                                               pagerank_step_fused)
from repro_torch.kernels.streaming_matvec import streaming_matvec
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.pagerank import distributed as dist
from repro_torch.obs.registry import NullRegistry, default_registry
from repro_torch.obs.trace import SolveTrace, instrumented_tol_loop
from repro_torch.pagerank.dense import pagerank_dense, pagerank_dense_fixed
from repro_torch.pagerank.precision import (PRECISIONS, STORAGE_DTYPES,
                                            layout_nbytes, quantize_int8,
                                            resolve_precision, rowmax_scales,
                                            solve_dtype)
from repro_torch.pagerank.resilience import (ConvergenceError, SolveResult,
                                             make_solve_info)
from repro_torch.pagerank.steps import (ppr_step_batched, seed_matrix,
                                        sparse_step)

__all__ = ["PageRankEngine", "select_backend", "default_mesh", "BACKENDS",
           "SHARDED_BACKENDS", "PRECISIONS"]

BACKENDS = ("dense", "ell", "bsr", "fused_dense", "dense_sharded",
            "ell_sharded")
SHARDED_BACKENDS = ("dense_sharded", "ell_sharded")

# auto-selection thresholds on nnz / n^2 (the CPU and every multi-device
# mesh keep the JAX package's), and the single-card CUDA branch, set from
# scripts/backend_sweep.py's run(100) table on NVIDIA H100 80GB HBM3,
# 700.00 W (PERF.md): the dense tier (cuBLAS) wins at every swept density
# up to N = 5000, where every tier is bound by its launches; at N = 10000
# ell wins at densities up to 0.05 and dense from 0.2.  bsr and
# fused_dense win no cell.
DENSE_DENSITY = 0.25    # at/above: blocked-dense sweeps beat index chasing
CUDA_DENSE_DENSITY = 0.2
CUDA_DENSE_MAX_N = 5000


def select_backend(n: int, density: float,
                   device: str | torch.device | None = None,
                   n_devices: int | None = None,
                   precision: str = "auto") -> str:
    """Pick an execution backend from graph density and the device
    topology.

    ``device`` defaults to ``"cuda"``; ``n_devices`` defaults to
    ``torch.cuda.device_count()`` on CUDA, and the CPU counts as one device
    unless the caller says otherwise.  More than one device picks a
    sharded tier (``dense_sharded`` at ``DENSE_DENSITY`` and above, else
    ``ell_sharded``), as in the JAX package.  On one CPU, dense graphs take
    the ``dense`` tier and the rest ``ell``, as in the JAX package.  On one
    card the ``dense`` tier takes graphs of at most ``CUDA_DENSE_MAX_N``
    nodes and denser ones from ``CUDA_DENSE_DENSITY``, ``ell`` the rest
    (``scripts/backend_sweep.py``).  ``precision`` is validated but never
    alters the choice: reduced precision is an explicit accuracy trade,
    never an auto-policy pick.
    """
    resolve_precision(precision)
    kind = torch.device("cuda" if device is None else device).type
    if n_devices is None:
        n_devices = torch.cuda.device_count() if kind == "cuda" else 1
    if n_devices > 1:
        return ("dense_sharded" if density >= DENSE_DENSITY
                else "ell_sharded")
    if kind == "cuda":
        return ("dense" if n <= CUDA_DENSE_MAX_N
                or density >= CUDA_DENSE_DENSITY else "ell")
    return "dense" if density >= DENSE_DENSITY else "ell"


def default_mesh(backend: str, device: str | torch.device,
                 shards: int | None = None) -> Mesh:
    """The mesh a sharded tier takes by default: every visible device of
    ``device``'s kind (the CPU being one), or ``shards`` positions all on
    ``device``; a near-square 2-D (row, col) mesh for the dense fabric
    schedule, a flat 1-D mesh for the row-sharded ELL tier."""
    device = resolve_device(device)
    if shards is not None:
        devices = [device] * int(shards)
    elif device.type == "cuda":
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    else:
        devices = [device]
    ndev = len(devices)
    if backend == "ell_sharded":
        return make_mesh((ndev,), ("shard",), devices)
    r = int(math.isqrt(ndev))
    while ndev % r:
        r -= 1
    return make_mesh((r, ndev // r), ("row", "col"), devices)


class DeviceEdges(NamedTuple):
    """The engine's edge set on its device, for the layout build: the
    deduplicated edges (integer ids) and the out- and in-degree vectors
    (int64, length ``n``)."""
    src: torch.Tensor
    dst: torch.Tensor
    outdeg: torch.Tensor
    indeg: torch.Tensor


class EdgeSet(NamedTuple):
    """The engine's edge set on the host: the deduplicated edges (int32),
    their sorted unique keys ``src * n + dst`` (int64) and the out- and
    in-degree vectors (int64, length ``n``); ``on_device`` holds the same
    edges and degrees on the engine's device."""
    src: np.ndarray
    dst: np.ndarray
    keys: np.ndarray
    outdeg: np.ndarray
    indeg: np.ndarray
    on_device: DeviceEdges


def _device_ids(a, device: torch.device) -> torch.Tensor:
    """Vertex ids on ``device`` as int64, uploaded in their own integer
    width (half the bytes for int32)."""
    a = np.asarray(a)
    if a.dtype not in (np.int32, np.int64):
        a = a.astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device).long()


def _device_edges(s: torch.Tensor, d: torch.Tensor, n: int) -> DeviceEdges:
    """Deduplicated edges on their device, with their degree vectors."""
    return DeviceEdges(s, d, torch.bincount(s, minlength=n),
                       torch.bincount(d, minlength=n))


def _edge_set(src, dst, n: int, device: torch.device,
              metrics=None) -> EdgeSet:
    """Collapse duplicate directed edges on ``device``: the engine's
    contract is a *set* of edges (a repeated (u, v) would inflate outdeg(u)
    in the dense layout but add twice in CSR/ELL); self-loops are kept.
    One sort of the keys ``src * n + dst`` gives the edges, the keys and
    both degree vectors, equal in value and dtype to
    ``delta.dedupe_directed(..., drop_self_loops=False)``,
    ``delta.edge_keys`` and ``np.bincount``, and kept on ``device`` besides.
    The span ``prepare.dedupe`` (fields ``device``, ``edges_in``,
    ``edges_dropped``) covers the upload, the sort and the split, up to the
    edges on the host; ``prepare.keys`` the degree counts and the keys'
    copy to the host."""
    m = metrics if metrics is not None else NullRegistry()
    with m.span("prepare.dedupe", device=str(device)) as fields:
        keys = _device_ids(src, device) * n + _device_ids(dst, device)
        edges_in = keys.numel()
        keys = torch.unique(keys, sorted=True)
        s = torch.div(keys, n, rounding_mode="floor").to(torch.int32)
        d = torch.remainder(keys, n).to(torch.int32)
        src, dst = s.cpu().numpy(), d.cpu().numpy()
        if fields is not None:              # None from a NullRegistry
            fields["edges_in"] = edges_in
            fields["edges_dropped"] = edges_in - len(src)
    with m.span("prepare.keys"):
        on_device = _device_edges(s, d, n)
        outdeg = on_device.outdeg.cpu().numpy()
        indeg = on_device.indeg.cpu().numpy()
        keys = keys.cpu().numpy()
    return EdgeSet(src, dst, keys, outdeg, indeg, on_device)


def _transition_csr(edges: DeviceEdges, n: int) -> CSRMatrix:
    """``tr.build_transition_csr`` on the edges' device, bit for bit.  H's
    rows are ``dst`` and its columns ``src``, so its row-major order is
    that of the transposed keys ``dst * n + src``: unique in an edge set,
    so one plain sort.  Values ``1 / outdeg[src]`` in float32, ``indptr``
    the cumulative in-degrees; rows, columns and ``indptr`` int32."""
    keys = torch.sort(edges.dst.long() * n + edges.src.long()).values
    rows = torch.div(keys, n, rounding_mode="floor")
    cols = keys - rows * n
    del keys
    vals = torch.reciprocal(edges.outdeg.float())[cols]
    indptr = F.pad(torch.cumsum(edges.indeg, 0), (1, 0))
    return CSRMatrix(vals, cols.int(), indptr.int(), rows.int(),
                     shape=(n, n))


def _scatter(values: torch.Tensor, at: torch.Tensor,
             size: int) -> torch.Tensor:
    """A zero vector of ``size`` with ``values`` written at ``at``; an
    entry aimed at ``size`` lands in a spare slot past the end and is
    dropped (the only slot written twice)."""
    out = values.new_zeros(size + 1).index_put_((at,), values)
    return out[:size]


def _split_ell(csr: CSRMatrix, k0: int | None = None):
    """Split-ELL layout on the CSR's device: a per-row budget ``k0`` (the
    90th percentile of the row counts, read on the host, by default) plus a
    COO overflow tail for the power-law hub rows, the entries past ``k0``
    in the CSR's row-major order.  Returns ``((data, idx, ov_r, ov_c,
    ov_v), k0, overflow_nnz)``, float32 values and int32 indices."""
    n = csr.shape[0]
    if k0 is None:
        counts = np.diff(csr.indptr.cpu().numpy())
        k0 = max(4, int(np.percentile(counts, 90))) if len(counts) else 4
    rows = csr.row_ids.long()
    pos = torch.arange(csr.nnz, device=rows.device) - csr.indptr.long()[rows]
    in_ell = pos < k0
    at = torch.where(in_ell, rows * k0 + pos, n * k0)
    data = _scatter(csr.data, at, n * k0).view(n, k0)
    idx = _scatter(csr.indices, at, n * k0).view(n, k0)
    ov = torch.nonzero(~in_ell).squeeze(1)     # ascending: row-major
    return ((data, idx, csr.row_ids[ov], csr.indices[ov], csr.data[ov]), k0,
            int(ov.numel()))


def _row_scale(y: torch.Tensor, scales: torch.Tensor | None) -> torch.Tensor:
    """Fold an int8 layout's per-row f32 scales into the row sums of a
    vector (n,) or a query block (n, Q)."""
    if scales is None:
        return y
    return y * (scales if y.dim() == 1 else scales[:, None])


# the registry of the products that run outside an engine's step loop
_QUIET = NullRegistry()


def _matvec(backend: str, operands, x: torch.Tensor,
            metrics=_QUIET) -> torch.Tensor:
    """y = H @ x on the prepared layout (tagged by ``backend``, the
    engine's ``_mv_backend``), for a vector x (n,) or a query block x
    (n, Q).  Value arrays may be stored in a reduced dtype; they are
    upcast at the multiply and accumulated in f32.  int8 layouts append
    their per-row f32 scales to the operand tuple (``bsr``: the
    container's ``row_scales``).  ``metrics.annotate`` marks the product
    over the layout's rows (``engine.step.rows``) and ``ell``'s overflow
    tail (``engine.step.overflow``)."""
    if backend == "dense":
        scales = operands[1] if len(operands) == 2 else None
        with metrics.annotate("engine.step.rows"):
            y = upcast_f32(operands[0]) @ x
        return _row_scale(y, scales)
    if backend == "ell":
        data, idx, ov_r, ov_c, ov_v = operands[:5]
        scales = operands[5] if len(operands) == 6 else None
        data, ov_v = upcast_f32(data), upcast_f32(ov_v)
        vec = x.dim() == 1
        with metrics.annotate("engine.step.rows"):
            y = torch.sum((data if vec else data[..., None]) * x[idx], dim=1)
        with metrics.annotate("engine.step.overflow"):
            tail = torch.zeros_like(y).index_add_(
                0, ov_r, (ov_v if vec else ov_v[:, None]) * x[ov_c])
        return _row_scale(y + tail, scales)
    if backend == "sell":
        # two-bucket sliced ELLPACK (the dynamic engine's patchable ELL
        # tier, repro_torch.pagerank.dynamic): rows permuted into a low
        # tier and a hub tier, two dense gathers, no index_add_
        dl, il, dh, ih, inv = operands[:5]
        sl, sh = operands[5:7] if len(operands) == 7 else (None, None)
        dl, dh = upcast_f32(dl), upcast_f32(dh)
        with metrics.annotate("engine.step.rows"):
            if x.dim() == 1:
                yl = torch.sum(dl * x[il], dim=1)
                yh = torch.sum(dh * x[ih], dim=1)
            else:
                yl = torch.sum(dl[..., None] * x[il], dim=1)
                yh = torch.sum(dh[..., None] * x[ih], dim=1)
        return torch.cat([_row_scale(yl, sl), _row_scale(yh, sh)],
                         dim=0)[inv]
    if backend == "bsr":
        # one launch of the BSR kernel for a vector or a query block; the
        # container's int8 row scales are applied after it
        with metrics.annotate("engine.step.rows"):
            return kops.spmv(operands[0], x)
    raise ValueError(f"unknown backend {backend!r}")


def _uniform(n: int, device: torch.device) -> torch.Tensor:
    return torch.full((n,), 1.0 / n, dtype=torch.float32, device=device)


def _on_ell_kernel(backend: str, x: torch.Tensor) -> bool:
    """Whether a solve of ``x`` steps through the split-ELL kernel: one
    vector on the card, on the ``ell`` layout."""
    return backend == "ell" and x.device.type == "cuda" and x.dim() == 1


def _ell_kernel_step(operands, meta, dang, d, metrics):
    """One step of :func:`ell_step` on the carry ``(x, sum(x * dang))``,
    in the range ``engine.step.combine`` around its passes' ranges
    ``engine.step.overflow`` and ``engine.step.rows``."""
    def ranges(part):
        return metrics.annotate(f"engine.step.{part}")

    def step(carry):
        with metrics.annotate("engine.step.combine"):
            return ell_step(operands, meta, dang, *carry, d=d,
                            annotate=ranges)
    return step


def _run_fixed(operands, dang, d, *, backend: str, n: int, n_iters: int,
               metrics, meta=None):
    """``n_iters`` steps from the uniform vector; each step is the
    profiler range ``engine.step.combine``, around its product's
    ranges.  On the card the ``ell`` layout steps through the split-ELL
    kernel (``meta`` its :func:`ell_meta`), which keeps the leak on the
    device."""
    pr = _uniform(n, dang.device)
    if _on_ell_kernel(backend, pr):
        step = _ell_kernel_step(operands, meta, dang, d, metrics)
        carry = (pr, torch.sum(pr * dang))
        for _ in range(n_iters):
            carry = step(carry)
        return carry[0]
    for _ in range(n_iters):
        with metrics.annotate("engine.step.combine"):
            pr = sparse_step(lambda v: _matvec(backend, operands, v, metrics),
                             pr, dang, d, n)
    return pr


def _run_tol(operands, dang, d, tol, x0, *, backend: str, n: int,
             max_iters: int, watchdog: bool, trace: bool, metrics,
             meta=None):
    pr0 = _uniform(n, dang.device) if x0 is None else x0
    if _on_ell_kernel(backend, pr0):
        kernel_step = _ell_kernel_step(operands, meta, dang, d, metrics)

        def ell_step_res(carry):
            new = kernel_step(carry)
            return new, torch.sum(torch.abs(new[0] - carry[0]))

        out = instrumented_tol_loop(
            ell_step_res, (pr0, torch.sum(pr0 * dang)), tol=tol,
            max_iters=max_iters, watchdog=watchdog, trace=trace)
        return (out[0][0], *out[1:])

    def step(pr):
        with metrics.annotate("engine.step.combine"):
            new = sparse_step(
                lambda v: _matvec(backend, operands, v, metrics), pr, dang,
                d, n)
        return new, torch.sum(torch.abs(new - pr))

    return instrumented_tol_loop(step, pr0, tol=tol, max_iters=max_iters,
                                 watchdog=watchdog, trace=trace)


def _ppr_matvec(backend: str, operands, dang):
    """The batched ``X -> H @ X`` of personalized PageRank.  The f32 dense
    operand is the dangling-FIXED H (the uniform 1/n leak folded into the
    dangling columns — right for global PageRank, wrong for PPR, where the
    leak teleports to V); zeroing those columns reconstructs the unfixed H
    exactly, once per call.  Reduced-precision dense tiers store H
    unfixed, so there the same mask changes nothing."""
    if backend == "dense":
        scales = operands[1] if len(operands) == 2 else None
        H = upcast_f32(operands[0]) * (1.0 - dang)[None, :]
        return lambda X: _row_scale(H @ X, scales)
    return lambda X: _matvec(backend, operands, X)


def _run_ppr(operands, dang, V, d, *, backend: str, n_iters: int):
    mv = _ppr_matvec(backend, operands, dang)
    PR = V
    for _ in range(n_iters):
        PR = ppr_step_batched(mv, PR, V, dang, d)
    return PR


def _ppr_fused_operator(Hp, dangp, scales, Vp, d: float):
    """The batched personalized operator on the fused tier's pre-padded,
    transposed (Q, Mp) layout: ``Ab(X) = d * (Y + Vp * leak) + (1 - d) *
    Vp`` with ``Y = X @ Hp.T`` from the streaming kernel.  The leak
    ``sum(X * dangp)`` per query is taken from X before the kernel (which
    has no leak output); an int8 layout's (1, Np) row scales multiply Y
    after it.  ``Vp`` of width Mp serves as a (Q, Np) operand, which needs
    square padding."""
    if Hp.shape[0] != Hp.shape[1]:
        raise ValueError(f"the fused tier's PPR needs a square padded "
                         f"layout, got {tuple(Hp.shape)}")

    def Ab(X):
        leak = torch.sum(X * dangp, dim=1)                 # (Q,)
        Y = streaming_matvec(Hp, X)
        if scales is not None:
            Y = Y * scales
        return d * (Y + Vp * leak[:, None]) + (1.0 - d) * Vp

    return Ab


def _run_ppr_fused(Hp, dangp, Vp, scales, *, n: int, n_iters: int,
                   d: float):
    # Vp: (Q, Mp) — queries ride the batch axis of streaming_matvec, so
    # all Q teleport distributions share one sweep over Hp per iteration
    Ab = _ppr_fused_operator(Hp, dangp, scales, Vp, d)
    PR = Vp
    for _ in range(n_iters):
        PR = Ab(PR)
    return PR[:, :n].T.contiguous()                       # (n, Q)


def _fused_start(x0, dangp, *, n: int, Mp: int, d: float):
    """Padded start vector and its teleport-plus-leak scalar ``t0``."""
    x0 = _uniform(n, dangp.device) if x0 is None else x0
    xp0 = F.pad(x0, (0, Mp - n))[None, :]
    return xp0, d * torch.sum(xp0 * dangp) / n + (1.0 - d) / n


def _run_fixed_fused(Hp, dangp, scales, *, n: int, n_iters: int, d: float):
    xp, t = _fused_start(None, dangp, n=n, Mp=Hp.shape[1], d=d)
    for _ in range(n_iters):
        xp, leak = pagerank_step_fused(Hp, xp, dangp, t, scales, d=d)
        t = d * leak / n + (1.0 - d) / n
    return xp[0, :n]


def _run_tol_fused(Hp, dangp, tol, x0, scales, *, n: int, max_iters: int,
                   d: float, watchdog: bool, trace: bool):
    state0 = _fused_start(x0, dangp, n=n, Mp=Hp.shape[1], d=d)

    def step(carry):
        xp, t = carry
        yp, leak = pagerank_step_fused(Hp, xp, dangp, t, scales, d=d)
        res = torch.sum(torch.abs(yp[0, :n] - xp[0, :n]))
        return (yp, d * leak / n + (1.0 - d) / n), res

    (xp, _), iters, res, grow, ring = instrumented_tol_loop(
        step, state0, tol=tol, max_iters=max_iters, watchdog=watchdog,
        trace=trace)
    return xp[0, :n], iters, res, grow, ring


def _engine_device(device, mesh: Mesh | None) -> torch.device:
    """The engine's device: the mesh's first device when a mesh is given
    (``device``, if also given, must name it), else ``device`` resolved."""
    if mesh is None:
        return resolve_device(device)
    first = mesh.device_list[0]
    if device is not None and resolve_device(device) != first:
        raise ValueError(f"device {device!r} is not the mesh's first "
                         f"device {first}")
    return first


class PageRankEngine:
    """Prepared PageRank over one graph.

    Build it once per graph from the COO edge list, then call ``run`` /
    ``run_tol``.  ``device`` defaults to ``"cuda"`` and raises when CUDA is
    absent; pass ``device="cpu"`` to run on the CPU, where the fused tier
    takes its kernel's plain version.  The sharded tiers run on ``mesh``
    (default: every visible device of ``device``'s kind, the CPU being
    one); results come back on the mesh's first device.
    :meth:`from_layout` builds an engine around operands prepared
    elsewhere (e.g. by the JAX package, through
    :func:`repro_torch.pagerank.convert.layout_from_numpy`).
    """

    def __init__(self, src: np.ndarray, dst: np.ndarray, n: int, *,
                 d: float = 0.85, backend: str = "auto",
                 bsr_block_size: int = 128, ell_k: int | None = None,
                 device: str | torch.device | None = None,
                 mesh: Mesh | None = None, metrics=None,
                 precision: str = "auto"):
        dev = _engine_device(device, mesh)
        n = int(n)
        # the registry first: the span "prepare" covers the whole build,
        # in the phases prepare.dedupe, .keys, .csr, .pack and .upload
        self.metrics = metrics if metrics is not None else default_registry()
        m = self.metrics
        with m.span("prepare") as fields:
            # host edge-set bookkeeping (sorted src*n+dst keys + degree
            # vectors): the landmark index (repro_torch.pagerank.landmarks)
            # reads hub degrees and out-neighborhoods off the engine
            edges = _edge_set(src, dst, n, dev, m)
            src, dst, self._keys, self._outdeg, self._indeg = edges[:5]
            self.n_edges = int(len(src))
            self.density = self.n_edges / float(n * n)
            if backend == "auto":
                backend = select_backend(
                    n, self.density, device=dev,
                    n_devices=None if mesh is None else mesh.size)
            if fields is not None:              # None from a NullRegistry
                fields["backend"] = backend
            self._init_common(n, d, backend, precision, dev, metrics, mesh)
            self._ell_k = ell_k
            self._bsr_block_size = int(bsr_block_size)
            self._prepare_layout(src, dst, edges.on_device)

    def _init_common(self, n, d, backend, precision, device, metrics,
                     mesh=None) -> None:
        if backend not in BACKENDS:
            raise ValueError(
                f"backend {backend!r} not in {BACKENDS + ('auto',)}")
        self.n = int(n)
        self.d = float(d)
        self.device = device
        self.backend = backend
        self.precision = resolve_precision(precision)
        self.storage_dtype = STORAGE_DTYPES[self.precision]
        self._scales = None
        self.layout = backend
        # the sharded tiers' mesh, axes and padded N; the replicated (ell)
        # or row-block (dense) PPR copy of the layout, placed at first use
        self.mesh = None
        self._axes: tuple[str, ...] = ()
        self._n_pad = self.n
        self._ppr_operands: tuple | None = None
        self._ppr_scales = None
        # the split-ELL kernel's metadata of an ell layout (ell_meta)
        self._ell_meta = None
        if backend in SHARDED_BACKENDS:
            self.mesh = (mesh if mesh is not None
                         else default_mesh(backend, device))
            self._axes = tuple(self.mesh.axis_names)
            if backend == "dense_sharded" and len(self._axes) != 2:
                raise ValueError("dense_sharded needs a 2-D mesh, got axes "
                                 f"{self._axes}")
            shards = (math.lcm(*self.mesh.shape.values())
                      if backend == "dense_sharded" else self.mesh.size)
            self._n_pad = -(-self.n // shards) * shards
        # the layout tag the runners dispatch _matvec on: the backend
        # itself, except the dynamic engine's patchable SELL tier ("sell"
        # while backend == "ell")
        self._mv_backend = backend
        # the last run_tol's SolveInfo and the warn-once latch for
        # silently exhausted solves
        self.last_solve_info = None
        self._warned_nonconverged = False
        # metrics sink: the process default registry unless injected
        self.metrics = metrics if metrics is not None else default_registry()

    @classmethod
    def from_layout(cls, backend: str, layout: dict, n: int, *,
                    d: float = 0.85, precision: str = "f32",
                    device: str | torch.device | None = None,
                    metrics=None) -> "PageRankEngine":
        """An engine around prepared operands: ``layout`` is the dict of
        :func:`repro_torch.pagerank.convert.layout_from_numpy`
        (``operands``, ``scales``, ``dang``, and the host edge bookkeeping
        ``keys``, ``outdeg``, ``indeg`` that the landmark index reads, or
        ``None`` where the layout came without it)."""
        eng = cls.__new__(cls)
        mesh = layout.get("mesh")
        dev = _engine_device(device, mesh)
        eng._init_common(n, d, backend, precision, dev, metrics, mesh)
        eng._keys = layout.get("keys")
        eng._outdeg = layout.get("outdeg")
        eng._indeg = layout.get("indeg")
        if backend in SHARDED_BACKENDS:
            eng._operands = tuple(layout["operands"])
            eng._dang = layout["dang"]
            eng._scales = layout.get("scales")
            eng.layout = eng._sharded_layout_name(
                eng._operands[0].shape[1] if backend == "ell_sharded"
                else None)
        else:
            eng._operands = tuple(o.to(dev) for o in layout["operands"])
            eng._dang = layout["dang"].to(dev)
            if backend == "ell":            # no counts: all k0 slots read
                eng._ell_meta = ell_meta(eng._operands[2], n)
            if layout.get("scales") is not None:
                eng._scales = layout["scales"].to(dev)
        if eng.precision != "f32":
            eng.layout = f"{eng.layout}[{eng.precision}]"
        eng._record_layout_bytes()
        return eng

    def _put(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _shard(self, a, spec, dtype=None) -> ShardedTensor:
        """A host array (or CPU tensor) cut over the mesh by ``spec``, in
        ``dtype`` (default: its own)."""
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(a))
        if dtype is not None:
            t = t.to(dtype)
        return ShardedTensor.from_global(t, self.mesh, spec)

    def _pad_replicated(self, v: np.ndarray) -> ShardedTensor:
        padded = np.zeros((self._n_pad,), np.float32)
        padded[:self.n] = v
        return self._shard(padded, P())

    def _sharded_layout_name(self, k: int | None) -> str:
        if self.backend == "dense_sharded":
            r, c = self.mesh.shape.values()
            return f"dense_sharded({r}x{c} mesh, n_pad={self._n_pad})"
        return (f"ell_sharded(k={k}, shards={self.mesh.size}, "
                f"n_pad={self._n_pad})")

    def _prepare_layout(self, src: np.ndarray, dst: np.ndarray,
                        edges: DeviceEdges | None = None) -> None:
        """Build the backend's prepared device layout from a deduplicated
        COO edge list.  The ``ell`` tiers build their transition CSR on the
        engine's device from ``edges`` (the edge list uploaded where none
        is given), in the span ``prepare.csr``; ``prepare.pack`` holds the
        rest of the build: ``ell``'s split ELL on the device,
        ``ell_sharded``'s full-width rows and the other tiers' layouts in
        numpy, as the JAX package builds them.  ``prepare.upload`` places
        what the pack left on the host.  Each phase ends in a synchronize
        unless the registry is a :class:`NullRegistry`."""
        self._mv_backend = self.backend
        self.layout = self.backend
        self._scales = None
        csr = None
        if self.backend in ("ell", "ell_sharded"):
            with self._phase("prepare.csr"):
                if edges is None:
                    edges = _device_edges(_device_ids(src, self.device),
                                          _device_ids(dst, self.device),
                                          self.n)
                csr = _transition_csr(edges, self.n)
        with self._phase("prepare.pack"):
            if self.backend == "ell":
                dang = (edges.outdeg == 0).float()
            else:
                dang = tr.dangling_mask(src, self.n).astype(np.float32)
            host = self._pack(src, dst, dang, csr)
        del edges, csr
        with self._phase("prepare.upload"):
            self._upload(host, dang)
        if self.precision != "f32":
            self.layout = f"{self.layout}[{self.precision}]"
        self._record_layout_bytes()

    @contextlib.contextmanager
    def _phase(self, name: str):
        """The span ``name`` around one phase of the layout build.  With a
        recording registry the phase ends once the engine's cards have
        done its work, so none of its device time falls into a later
        phase; a :class:`NullRegistry` adds no wait."""
        with self.metrics.span(name):
            yield
            if not isinstance(self.metrics, NullRegistry):
                self._synchronize()

    def _pack(self, src: np.ndarray, dst: np.ndarray, dang, csr) -> tuple:
        """The tier's layout: on ``ell`` the device operands in the storage
        dtype (and the split-ELL kernel's ``_ell_meta`` beside them), on
        the other tiers the host layout (numpy arrays; CPU tensors on
        ``fused_dense``), quantized there where the tier stores int8."""
        n = self.n
        if self.backend == "ell":
            ops, k0, ov_nnz = _split_ell(csr, k0=self._ell_k)
            self.layout = f"ell(k0={k0})+overflow(nnz={ov_nnz})"
            self._ell_meta = ell_meta(
                ops[2], n, torch.clamp(csr.indptr.diff(), max=k0))
            return self._quantize_split_ell(ops)
        if self.backend == "bsr":
            return self._pack_bsr(src, dst)
        if self.backend in SHARDED_BACKENDS:
            return self._pack_sharded(src, dst, csr)
        if self.backend == "dense":
            if self.precision == "f32":
                return (tr.transition_dense_np(src, dst, n),)
            # reduced tiers store H dangling-UNFIXED and pay the explicit
            # scalar leak through sparse_step
            H = tr.transition_dense_np(src, dst, n, fix_dangling=False)
            if self.precision != "int8":
                return (H,)
            scales = rowmax_scales(np.abs(H).max(axis=1, initial=0.0))
            return quantize_int8(H, scales[:, None]), scales
        # fused_dense
        H = torch.from_numpy(
            tr.transition_dense_np(src, dst, n, fix_dangling=False))
        Hp, dangp = pad_pagerank_operands(H, torch.from_numpy(dang))
        if self.precision != "int8":
            return Hp.to(self.storage_dtype), dangp, None
        Hp_np = Hp.numpy()
        scales = rowmax_scales(np.abs(Hp_np).max(axis=1, initial=0.0))
        return (torch.from_numpy(quantize_int8(Hp_np, scales[:, None])),
                dangp, scales)

    def _upload(self, host: tuple, dang: np.ndarray) -> None:
        """Place :meth:`_pack`'s layout on the engine's device (on the
        mesh for the sharded tiers)."""
        if self.backend in SHARDED_BACKENDS:
            self._upload_sharded(host, dang)
            return
        if self.backend == "ell":               # built on the device
            self._operands, self._dang = host, dang
            return
        self._dang = self._put(dang)
        if self.backend == "bsr":
            self._operands = (self._upload_bsr(host),)
        elif self.backend == "dense":
            self._operands = (
                tuple(self._put(a) for a in host) if self.precision == "int8"
                else (self._put(host[0]).to(self.storage_dtype),))
        else:                                   # fused_dense
            Hp, dangp, scales = host
            if scales is not None:
                # (1, Np): the fused kernel applies it per row in its
                # epilogue
                self._scales = self._put(scales[None, :])
            self._operands = (Hp.to(self.device), dangp.to(self.device))

    def _synchronize(self) -> None:
        """Wait for the engine's cards (the mesh's, on the sharded tiers)
        to finish the placement."""
        devices = (self.mesh.device_list if self.mesh is not None
                   else [self.device])
        for dev in {d for d in devices if d.type == "cuda"}:
            torch.cuda.synchronize(dev)

    def _pack_sharded(self, src: np.ndarray, dst: np.ndarray,
                      csr) -> tuple:
        """The two mesh layouts, built in numpy at the padded N.
        ``dense_sharded``: H dangling-UNFIXED (explicit leak).
        ``ell_sharded``: full-K ELL rows from the transition CSR, read on
        the host, where ``ell_k`` is a minimum row capacity and never a
        truncation (the dynamic engine passes ``maxdeg + slack``).  Returns
        ``(vals, idx or None, int8 scales or None, k or None)``."""
        n, n_pad = self.n, self._n_pad
        if self.backend == "dense_sharded":
            vals = np.zeros((n_pad, n_pad), np.float32)
            vals[:n, :n] = tr.transition_dense_np(src, dst, n,
                                                  fix_dangling=False)
            idx = k = None
        else:
            csr = csr.to("cpu")
            counts = np.diff(csr.indptr.numpy())
            maxdeg = int(counts.max()) if len(counts) else 0
            k = maxdeg if self._ell_k is None else max(int(self._ell_k),
                                                       maxdeg)
            ell = ELLMatrix.from_csr(csr, k=k)
            vals = np.zeros((n_pad, ell.k), np.float32)
            idx = np.zeros((n_pad, ell.k), np.int32)
            vals[:n] = ell.data.numpy()
            idx[:n] = ell.indices.numpy()
            k = ell.k
        scales = None
        if self.precision == "int8":
            scales = rowmax_scales(np.abs(vals).max(axis=1, initial=0.0))
            vals = quantize_int8(vals, scales[:, None])
        return vals, idx, scales, k

    def _upload_sharded(self, host: tuple, dang: np.ndarray) -> None:
        """Cut :meth:`_pack_sharded`'s layout over the mesh:
        ``dense_sharded`` blocked ``P(row, col)`` with int8 scales
        replicated, ``ell_sharded`` over the flattened mesh with int8
        scales row-sharded like the rows."""
        vals, idx, scales, k = host
        self._ppr_operands = self._ppr_scales = None
        dense = self.backend == "dense_sharded"
        spec = P(*self._axes) if dense else P(self._axes)
        extra = () if idx is None else (self._shard(idx, spec),)
        if scales is not None:
            self._scales = self._shard(scales, P() if dense else spec)
        self._operands = (self._shard(vals, spec, self.storage_dtype),
                          *extra)
        self._dang = self._pad_replicated(dang)
        self.layout = self._sharded_layout_name(k)

    def _pack_bsr(self, src: np.ndarray, dst: np.ndarray) -> tuple:
        """The dangling-unfixed block layout on the host: ``(blocks,
        block_cols, shape, int8 row scales or None)``.  int8 scales are
        per row, the abs-max over the row's whole block budget (slot and
        in-block column)."""
        bsr = tr.build_transition_bsr(src, dst, self.n,
                                      bs=self._bsr_block_size, device="cpu")
        blocks = bsr.blocks.numpy()
        cols = bsr.block_cols.numpy()
        if self.precision != "int8":
            return blocks, cols, bsr.shape, None
        nb_r, _, bs, _ = blocks.shape
        # axis 2 is the row within a block: reduce over (slot, col)
        absmax = np.abs(blocks).max(axis=(1, 3))            # (nb_r, bs)
        scales = rowmax_scales(absmax.reshape(-1))          # (nb_r * bs,)
        return (quantize_int8(blocks, scales.reshape(nb_r, 1, bs, 1)), cols,
                bsr.shape, scales)

    def _upload_bsr(self, host: tuple) -> BSRMatrix:
        """:meth:`_pack_bsr`'s layout on the device, in the storage
        dtype."""
        blocks, cols, shape, scales = host
        if scales is None:
            return BSRMatrix(self._put(blocks).to(self.storage_dtype),
                             self._put(cols), shape=shape)
        return BSRMatrix(self._put(blocks), self._put(cols), shape=shape,
                         row_scales=self._put(scales))

    def _quantize_split_ell(self, ops: tuple) -> tuple:
        """A split-ELL layout in the storage dtype, on its device.  int8
        scales are computed over the FULL row — the ELL block's entries
        and the overflow tail share the row's abs-max — and appended as a
        sixth operand."""
        data, idx, ov_r, ov_c, ov_v = ops
        if self.precision != "int8":
            return (data.to(self.storage_dtype), idx, ov_r, ov_c,
                    ov_v.to(self.storage_dtype))
        absmax = data.abs().amax(dim=1).scatter_reduce(
            0, ov_r.long(), ov_v.abs(), "amax")
        scales = rowmax_scales(absmax)
        return (quantize_int8(data, scales[:, None]), idx, ov_r, ov_c,
                quantize_int8(ov_v, scales[ov_r]), scales)

    def _record_layout_bytes(self) -> None:
        """Operand-byte accounting of the prepared layout, exported as the
        ``layout.bytes`` gauge and kept as ``self.layout_bytes``."""
        extras = () if self._scales is None else (self._scales,)
        self.layout_bytes = layout_nbytes(tuple(self._operands) + extras)
        self.metrics.gauge("layout.bytes").set(
            self.layout_bytes["total_bytes"])

    @property
    def operands(self) -> tuple:
        """The prepared (already padded; sharded on the mesh tiers) layout
        tensors."""
        return self._operands

    def _pad_x0(self, x0: torch.Tensor | None) -> torch.Tensor | None:
        """Zero-pad a warm-start vector to the sharded tiers' padded N."""
        if x0 is None or self._n_pad == self.n:
            return x0
        return F.pad(x0, (0, self._n_pad - self.n))

    def _ppr_layout(self) -> tuple[tuple, ShardedTensor | None]:
        """The sharded tiers' PPR copy of the layout, placed once at first
        use (serve flushes never re-gather it, run-only engines never pay
        it): the row blocks ``P(row, None)`` of H on ``dense_sharded`` (one
        more H in memory), the replicated ELL operands on
        ``ell_sharded``."""
        if self._ppr_operands is None:
            spec = (P(self._axes[0], None)
                    if self.backend == "dense_sharded" else P())
            self._ppr_operands = tuple(fm.reshard(o, spec)
                                       for o in self._operands)
            self._ppr_scales = (None if self._scales is None
                                else fm.reshard(self._scales, P()))
        return self._ppr_operands, self._ppr_scales

    def lower_run(self) -> dict:
        """The per-iteration schedule of ``run`` on the sharded tiers, the
        counterpart of the JAX package's AOT lowering for collective
        audits: one ``run(1)`` with :mod:`repro_torch.core.fabric_matvec`'s
        counters zeroed before and read after.  Returns the collectives
        by kind, the bytes each kind moved, and the shard-local K2 calls by
        (storage type, batch size) — K2 launches on the card."""
        if self.backend not in SHARDED_BACKENDS:
            raise ValueError(f"lower_run audits the sharded tiers, not "
                             f"{self.backend!r}")
        fm.reset_counts()
        self.run(1)
        out = {"backend": self.backend, "mesh": dict(self.mesh.shape),
               "devices": [str(d) for d in self.mesh.device_list],
               "collectives": dict(fm.collectives),
               "bytes": dict(fm.collective_bytes),
               "k2_launches": {f"{p},B={b}": c for (p, b), c
                               in fm.local_products.items()}}
        fm.reset_counts()
        return out

    # ------------------------------ queries ------------------------------ #
    def run(self, n_iters: int = 100) -> torch.Tensor:
        """Fixed-schedule power iteration, issued with no host sync, in
        the profiler range ``engine.run``."""
        with self.metrics.annotate("engine.run"):
            if self.backend == "dense_sharded":
                return dist.pagerank_distributed(
                    self._operands[0], self.mesh, n_iters, self.d,
                    *self._axes, dangling=self._dang, n_true=self.n,
                    scales=self._scales).full()[:self.n]
            if self.backend == "ell_sharded":
                return dist.pagerank_distributed_sparse(
                    *self._operands, self.mesh, n_iters, self.d,
                    dangling=self._dang, axes=self._axes, n_true=self.n,
                    scales=self._scales).full()[:self.n]
            if self.backend == "fused_dense":
                Hp, dangp = self._operands
                return _run_fixed_fused(Hp, dangp, self._scales, n=self.n,
                                        n_iters=n_iters, d=self.d)
            if self.backend == "dense" and self.precision == "f32":
                return pagerank_dense_fixed(self._operands[0],
                                            n_iters=n_iters, d=self.d)
            return _run_fixed(self._operands, self._dang, self.d,
                              backend=self._mv_backend, n=self.n,
                              n_iters=n_iters, metrics=self.metrics,
                              meta=self._ell_meta)

    def run_tol(self, tol: float = 1e-6, max_iters: int = 1000,
                x0: np.ndarray | torch.Tensor | None = None, *,
                watchdog: bool = True, raise_on_fail: bool = False,
                trace: bool = True):
        """Tolerance-terminated power iteration.  Returns a
        :class:`~repro_torch.pagerank.resilience.SolveResult` — the
        ``(pr, n_iters, residual)`` 3-tuple carrying the full
        :class:`~repro_torch.pagerank.resilience.SolveInfo` as ``.info``
        (also kept as ``self.last_solve_info``).

        ``x0`` warm-starts the loop (shape ``(n,)``).  ``watchdog`` aborts
        on NaN/Inf or sustained residual growth.  A solve that did not
        converge warns once per engine, or raises
        :class:`~repro_torch.pagerank.resilience.ConvergenceError` with
        ``raise_on_fail=True``.  ``trace`` records the per-iteration
        residual ring (``result.info.trace``)."""
        # the single coercion point for user solve inputs: float32 passes
        # through untouched, float64 gets one explicit warned downcast
        x0 = solve_dtype(x0, name="x0")
        if x0 is not None:
            x0 = x0.to(self.device)
        tol_f32 = solve_dtype(tol, name="tol")
        with self.metrics.span("solve", backend=self.backend), \
                self.metrics.annotate("engine.run"):
            if self.backend in SHARDED_BACKENDS:
                kw = dict(tol=tol_f32, max_iters=max_iters, d=self.d,
                          dangling=self._dang, n_true=self.n,
                          x0=self._pad_x0(x0), watchdog=watchdog,
                          trace=trace, scales=self._scales)
                if self.backend == "dense_sharded":
                    out = dist.pagerank_distributed_tol(
                        self._operands[0], self.mesh,
                        row_axis=self._axes[0], col_axis=self._axes[1], **kw)
                else:
                    out = dist.pagerank_distributed_sparse_tol(
                        *self._operands, self.mesh, axes=self._axes, **kw)
                out = (out[0].full()[:self.n], *out[1:])
            elif self.backend == "fused_dense":
                Hp, dangp = self._operands
                out = _run_tol_fused(
                    Hp, dangp, tol_f32, x0, self._scales, n=self.n,
                    max_iters=max_iters, d=self.d, watchdog=watchdog, trace=trace)
            elif self.backend == "dense" and self.precision == "f32":
                out = pagerank_dense(self._operands[0], d=self.d,
                                     tol=tol_f32, max_iters=max_iters,
                                     x0=x0, watchdog=watchdog, trace=trace)
            else:
                out = _run_tol(self._operands, self._dang, self.d, tol_f32,
                               x0, backend=self._mv_backend, n=self.n,
                               max_iters=max_iters, watchdog=watchdog,
                               trace=trace, metrics=self.metrics,
                               meta=self._ell_meta)
            return self._finish_solve(out, tol, max_iters, raise_on_fail)

    def ppr(self, seed_sets: Sequence[np.ndarray],
            n_iters: int = 100) -> torch.Tensor:
        """Batched personalized PageRank: one (N, Q) propagation for Q
        per-user seed sets; returns the (N, Q) rank matrix on the engine's
        device.  On ``fused_dense`` every iteration is one launch of the
        streaming kernel for all Q queries."""
        with self.metrics.span("ppr", backend=self.backend,
                               q=len(seed_sets)):
            self.metrics.counter("engine.ppr_queries").inc(len(seed_sets))
            return self._ppr(seed_sets, n_iters)

    def _ppr(self, seed_sets: Sequence[np.ndarray],
             n_iters: int) -> torch.Tensor:
        V = seed_matrix(self.n, seed_sets)
        if self.backend in SHARDED_BACKENDS:
            # the query axis is padded to the mesh column count (dense) or
            # the shard count (ell) with zero columns, sliced back after
            q = V.shape[1]
            q_shards = (self.mesh.shape[self._axes[1]]
                        if self.backend == "dense_sharded"
                        else self.mesh.size)
            q_pad = -(-q // q_shards) * q_shards
            Vp = np.zeros((self._n_pad, q_pad), np.float32)
            Vp[:self.n, :q] = V
            ops, scales = self._ppr_layout()
            if self.backend == "dense_sharded":
                PR = dist.ppr_distributed_dense(
                    ops[0], self._dang, self._put(Vp), self.mesh, n_iters,
                    self.d, *self._axes, scales=scales)
            else:
                PR = dist.ppr_distributed_sparse(
                    *ops, self._dang, self._put(Vp), self.mesh, n_iters,
                    self.d, axes=self._axes, scales=scales)
            return PR.full()[:self.n, :q]
        if self.backend == "fused_dense":
            Hp, dangp = self._operands
            Vp = np.zeros((V.shape[1], Hp.shape[1]), np.float32)
            Vp[:, :self.n] = V.T
            return _run_ppr_fused(Hp, dangp, self._put(Vp), self._scales,
                                  n=self.n, n_iters=n_iters, d=self.d)
        return _run_ppr(self._operands, self._dang, self._put(V), self.d,
                        backend=self._mv_backend, n_iters=n_iters)

    def _finish_solve(self, out, tol: float, max_iters: int,
                      raise_on_fail: bool) -> SolveResult:
        """Host-side epilogue of every tolerance solve: build the
        :class:`SolveInfo` from the loop's exit scalars, record it (plus
        the solve counters and event in the metrics registry), and apply
        the raise/warn-once policy for non-converged solves."""
        pr, iters, res, grow, ring = out
        trace = SolveTrace(ring, iters) if ring is not None else None
        info = make_solve_info(iters, res, grow, tol=tol,
                               max_iters=max_iters, trace=trace)
        self.last_solve_info = info
        m = self.metrics
        m.counter("engine.solves").inc()
        m.counter(f"engine.solve.{info.status}").inc()
        m.event("solve", backend=self.backend, precision=self.precision,
                iters=info.iters, residual=info.residual,
                status=info.status)
        if info.failed:
            m.event("watchdog", backend=self.backend, iters=info.iters,
                    residual=info.residual, status=info.status)
        if not info.converged:
            if raise_on_fail:
                raise ConvergenceError(info)
            if not self._warned_nonconverged:
                self._warned_nonconverged = True
                reason = ("nonfinite residual" if info.nonfinite else
                          "diverging residual" if info.diverged else
                          f"max_iters={max_iters} exhausted")
                warnings.warn(
                    f"run_tol did not converge ({reason}; iters="
                    f"{info.iters}, residual={info.residual:.3e}, tol="
                    f"{tol:.1e}); check run_tol(...).info — further "
                    f"non-converged solves on this engine stay silent",
                    RuntimeWarning, stacklevel=3)
        return SolveResult(pr, iters, res, info)
