"""PageRank engine: prepare a layout once, then run the power iteration on
the device.

The PyTorch counterpart of ``repro.pagerank.engine.PageRankEngine``.  Each
backend is one :class:`Tier`, which owns its layout's build, its eager
product, its global step and its push and personalized operators:

* ``"dense"`` — dense H, ``H @ x`` sweeps (:class:`DenseTier`).
* ``"ell"`` — split ELLPACK, on the card the hand-written split-ELL kernel
  (:class:`EllTier`).
* ``"bsr"`` — block-sparse rows on the hand-written BSR kernel
  (:class:`BsrTier`).
* ``"fused_dense"`` — the pre-padded dense layout on the hand-written fused
  and streaming kernels (:class:`FusedDenseTier`); it stands for the JAX
  ``pallas_dense`` tier.
* ``"dense_sharded"`` / ``"ell_sharded"`` — dense blocks on a 2-D
  :class:`~repro_torch.launch.mesh.Mesh` through the paper's fabric
  schedule, or full-K ELL rows over the flattened mesh
  (:class:`DenseShardedTier`, :class:`EllShardedTier`).
* ``"ell_split_sharded"`` — one split ELL per position of the flattened
  mesh, the rows in the ``ell`` tier's degree order cut into blocks of
  about equal entries, built on the mesh's devices from the caller's edges,
  each step the split-ELL kernel on every block and an exchange of the
  fresh blocks (:class:`EllSplitShardedTier`).
* ``"auto"`` — :func:`select_backend` by density and device topology (more
  than one device picks a sharded tier).

Every tier supports the four storage precisions (f32, bf16, f16, int8 with
per-row scales); the solve itself is float32.  ``run`` issues its
iterations with no host sync; ``run_tol`` syncs once per
:data:`repro_torch.obs.trace.CHUNK` steps (see :mod:`repro_torch.obs.trace`).
The sharded tiers zero-pad N (and the PPR query axis) to what the mesh
divides; pad entries never feed back into real ranks and results are
sliced back to N.  Duplicate directed edges are collapsed up front, by one
sort on the engine's device, so every tier sees the same graph; self-loops
stay.  The ``ell`` tiers build their transition CSR from that edge set on
the same device; on a graph of more than :data:`HOT_COLUMNS` vertices the
``ell`` layout numbers its vertices by out-degree (``vertex_order``), and
every answer leaves the engine in the caller's ids.  The engine runs on the
card unless ``device`` (or the mesh) asks for the CPU.
"""
from __future__ import annotations

import contextlib
import math
import warnings
from typing import Callable, NamedTuple, Sequence

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
from repro_torch.pagerank.precision import (PRECISIONS, STORAGE_DTYPES,
                                            layout_nbytes, quantize_int8,
                                            quantize_rows, resolve_precision,
                                            rowmax_scales,
                                            solve_dtype)
from repro_torch.pagerank.resilience import (ConvergenceError, SolveResult,
                                             make_solve_info)
from repro_torch.pagerank.steps import (dense_step, ppr_step_batched,
                                        seed_matrix, sparse_step)

__all__ = ["PageRankEngine", "select_backend", "default_mesh", "BACKENDS",
           "SHARDED_BACKENDS", "PRECISIONS"]

BACKENDS = ("dense", "ell", "bsr", "fused_dense", "dense_sharded",
            "ell_sharded", "ell_split_sharded")
SHARDED_BACKENDS = ("dense_sharded", "ell_sharded", "ell_split_sharded")

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

# the ell layout's vertex order: past this many vertices x (float32)
# outgrows the 128 kB of an SM's L1 that the split-ELL kernel's gathers can
# keep beside its streams, and the layout numbers the vertices by
# out-degree, how often each column of x is gathered, so the hot columns
# share the first lines of x; at or below it x fits whatever the order
HOT_COLUMNS = 32_768


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


def _degree_order(outdeg: torch.Tensor, n: int):
    """The ``ell`` layouts' vertex order: past :data:`HOT_COLUMNS` vertices
    the vertices by out-degree, descending, ties by id (one stable sort of
    n keys), as ``(order, pos)``: ``order[i]`` the caller's id of layout
    position ``i``, ``pos`` its inverse; at or below it ``(None, None)``."""
    if n <= HOT_COLUMNS:
        return None, None
    order = torch.sort(-outdeg, stable=True).indices
    pos = torch.empty_like(order)
    pos[order] = torch.arange(n, device=order.device)
    return order, pos


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


def _pack_split_ell(e, csr: CSRMatrix, k0: int | None):
    """The split ELL of a transition CSR (all of H, or a block of its
    rows whose columns reach the whole vector) at the row budget ``k0``
    (``None``: :func:`_split_ell`'s own) in the engine's storage
    precision, and its kernel metadata: ``(operands, meta, k0,
    overflow_nnz)``.  int8 takes its scales over the FULL row (the ELL
    block's entries and the overflow tail share the row's abs-max) as a
    sixth operand."""
    ops, k0, ov_nnz = _split_ell(csr, k0=k0)
    meta = ell_meta(ops[2], csr.shape[0],
                    torch.clamp(csr.indptr.diff(), max=k0))
    data, idx, ov_r, ov_c, ov_v = ops
    if e.precision != "int8":
        return ((data.to(e.storage_dtype), idx, ov_r, ov_c,
                 ov_v.to(e.storage_dtype)), meta, k0, ov_nnz)
    absmax = data.abs().amax(dim=1).scatter_reduce(
        0, ov_r.long(), ov_v.abs(), "amax")
    scales = rowmax_scales(absmax)
    return ((quantize_int8(data, scales[:, None]), idx, ov_r, ov_c,
             quantize_int8(ov_v, scales[ov_r]), scales), meta, k0, ov_nnz)


# the registry of the products that run outside an engine's step loop
_QUIET = NullRegistry()


def _uniform(n: int, device: torch.device) -> torch.Tensor:
    return torch.full((n,), 1.0 / n, dtype=torch.float32, device=device)


# --------------------------------------------------------------------------- #
# the tiers: one stateless object per layout kind                             #
# --------------------------------------------------------------------------- #
class Tier:
    """One layout kind of the engine: its build, its eager product, its
    global step, the push's affine operator and the batched personalized
    operator, each in the tier's own layout.

    A tier holds no state: there is one instance per kind, and every
    method reads the engine ``e``'s ``_operands``, ``_dang``, ``_scales``,
    ``_ell_meta`` and ``_order`` / ``_pos`` when it is called, so a patch
    or a rollback of those attributes needs no word to the tier.  This
    base is an eager tier of one device: its step is ``sparse_step`` over
    :meth:`product`, its state the rank vector, its batched layout the
    (N, Q) block.  A kind supplies ``pack(e, src, dst, csr, dang)``, the
    layout before the upload, and ``upload(e, host, dang)``, which places
    it and the dangling mask."""
    sharded = False         # runs on the engine's mesh (distributed.py)
    edges_on_mesh = False   # builds from the caller's edges on the mesh
    fused = False           # steps through the fused kernel (K1)
    device_csr = False      # builds its transition CSR in prepare.csr
    node_axis = 0           # the node axis of the batched layout

    # ------------------------------ build ------------------------------ #
    def build(self, e, src: np.ndarray, dst: np.ndarray,
              edges: DeviceEdges | None) -> None:
        """The layout from a deduplicated COO edge list, in the phases
        ``prepare.csr`` (the tiers that build their transition CSR on the
        engine's device from ``edges``, the edge list uploaded where none
        is given), ``prepare.pack`` and ``prepare.upload``."""
        csr = None
        if self.device_csr:
            with e._phase("prepare.csr") as fields:
                if edges is None:
                    edges = _device_edges(_device_ids(src, e.device),
                                          _device_ids(dst, e.device), e.n)
                edges = self.relabel(e, edges, fields)
                csr = _transition_csr(edges, e.n)
        with e._phase("prepare.pack"):
            dang = self.dangling(e, src, edges)
            host = self.pack(e, src, dst, csr, dang)
        del edges, csr
        with e._phase("prepare.upload"):
            self.upload(e, host, dang)

    def relabel(self, e, edges: DeviceEdges, fields) -> DeviceEdges:
        """The device edges in the layout's vertex order; the caller's ids
        unless the tier numbers its vertices anew."""
        return edges

    def dangling(self, e, src: np.ndarray, edges):
        """The dangling mask (float32, 1 where a vertex has no out-edge)."""
        return tr.dangling_mask(src, e.n).astype(np.float32)

    def adopt(self, e, layout: dict) -> None:
        """Take operands prepared elsewhere (``from_layout``)."""
        e._operands = tuple(o.to(e.device) for o in layout["operands"])
        e._dang = layout["dang"].to(e.device)
        if layout.get("scales") is not None:
            e._scales = layout["scales"].to(e.device)

    # ----------------------------- products ---------------------------- #
    @staticmethod
    def scale_rows(y: torch.Tensor, scales: torch.Tensor | None
                   ) -> torch.Tensor:
        """Fold an int8 layout's per-row f32 scales into the row sums of a
        vector (n,) or a query block (n, Q)."""
        if scales is None:
            return y
        return y * (scales if y.dim() == 1 else scales[:, None])

    def product(self, ops: tuple, x: torch.Tensor,
                metrics=_QUIET) -> torch.Tensor:
        """y = H @ x on the operands ``ops`` for a vector x (n,) or a query
        block x (n, Q).  Reduced-precision values are upcast at the
        multiply and accumulated in f32; int8 layouts carry their per-row
        f32 scales in ``ops``.  ``metrics.annotate`` marks the product
        over the layout's rows (``engine.step.rows``)."""
        raise NotImplementedError(f"{type(self).__name__} has no eager "
                                  "product")

    # ---------------------------- global step --------------------------- #
    def start(self, e, x0: torch.Tensor | None):
        """The step's state at ``x0`` (the uniform vector if ``None``)."""
        return _uniform(e.n, e._dang.device) if x0 is None else x0

    def eager_step(self, e, metrics):
        """One power iteration of a rank vector, the profiler range
        ``engine.step.combine`` around its product's ranges."""
        ops, dang, d, n = e._operands, e._dang, e.d, e.n

        def step(x):
            with metrics.annotate("engine.step.combine"):
                return sparse_step(lambda v: self.product(ops, v, metrics),
                                   x, dang, d, n)
        return step

    def step(self, e, metrics):
        """The global step on the tier's state."""
        return self.eager_step(e, metrics)

    def vector(self, e, state) -> torch.Tensor:
        """The rank vector (n,) of a state, in the layout's vertex order."""
        return state

    def ranks(self, e, state) -> torch.Tensor:
        """The rank vector (n,) of a state, in the caller's ids."""
        return self.vector(e, state)

    def run(self, e, n_iters: int) -> torch.Tensor:
        step, state = self.step(e, e.metrics), self.start(e, None)
        for _ in range(n_iters):
            state = step(state)
        return self.ranks(e, state)

    def run_tol(self, e, tol, x0, max_iters: int, watchdog: bool,
                trace: bool):
        step = self.step(e, e.metrics)

        def body(state):
            new = step(state)
            return new, torch.sum(torch.abs(self.vector(e, new)
                                            - self.vector(e, state)))

        out = instrumented_tol_loop(body, self.start(e, x0), tol=tol,
                                    max_iters=max_iters, watchdog=watchdog,
                                    trace=trace)
        return (self.ranks(e, out[0]), *out[1:])

    # ------------------------------- push ------------------------------- #
    def push_operator(self, e, x0: torch.Tensor):
        """The push's damped affine operator ``Ab(x) = A·x + b`` of one
        rank vector in the tier's layout, ``x0`` placed in that layout, and
        the rank vector of a layout vector: ``(Ab, x0, ranks)``."""
        return self.eager_step(e, _QUIET), x0, lambda x: x

    # ---------------------- personalized PageRank ---------------------- #
    def enter(self, e, A: np.ndarray) -> torch.Tensor:
        """A host (n, Q) block in the batched layout on the device."""
        return e._put(A)

    def leave(self, e, X: torch.Tensor) -> torch.Tensor:
        """The (n, Q) block of a batched-layout one."""
        return X

    def batched_product(self, e):
        """``X -> H @ X`` on a query block of the batched layout."""
        ops = e._operands
        return lambda X: self.product(ops, X)

    def ppr_operator(self, e, V: torch.Tensor):
        """The batched personalized operator ``Ab(X) = d·(H·X + V·leak) +
        (1−d)·V`` in the batched layout (``V`` in it too)."""
        mv, dang, d = self.batched_product(e), e._dang, e.d
        return lambda X: ppr_step_batched(mv, X, V, dang, d)

    def ppr(self, e, V: np.ndarray, n_iters: int) -> torch.Tensor:
        """``n_iters`` personalized steps from the host (n, Q) teleport
        block ``V``; the (n, Q) ranks."""
        PR = V = self.enter(e, V)
        Ab = self.ppr_operator(e, V)
        for _ in range(n_iters):
            PR = Ab(PR)
        return self.leave(e, PR).contiguous()


class DenseTier(Tier):
    """H as a dense (n, n) matrix.  f32 stores it dangling-FIXED (the
    uniform 1/n leak folded into the dangling columns) and steps with
    ``dense_step``; the reduced precisions store it unfixed and pay the
    explicit scalar leak through ``sparse_step``."""

    def pack(self, e, src, dst, csr, dang):
        n = e.n
        if e.precision == "f32":
            return (tr.transition_dense_np(src, dst, n),)
        H = tr.transition_dense_np(src, dst, n, fix_dangling=False)
        if e.precision != "int8":
            return (H,)
        return quantize_rows(H)

    def upload(self, e, host, dang):
        e._dang = e._put(dang)
        e._operands = (tuple(e._put(a) for a in host)
                       if e.precision == "int8"
                       else (e._put(host[0]).to(e.storage_dtype),))

    def product(self, ops, x, metrics=_QUIET):
        scales = ops[1] if len(ops) == 2 else None
        with metrics.annotate("engine.step.rows"):
            y = upcast_f32(ops[0]) @ x
        return self.scale_rows(y, scales)

    def eager_step(self, e, metrics):
        if e.precision != "f32":
            return super().eager_step(e, metrics)
        H, d = e._operands[0], e.d
        return lambda x: dense_step(H, x, d)

    def batched_product(self, e):
        # PPR teleports the leak to V: the dangling fix of the f32 operand
        # is undone by zeroing those columns, once per call (a no-op on the
        # unfixed reduced layouts)
        ops = e._operands
        scales = ops[1] if len(ops) == 2 else None
        H = upcast_f32(ops[0]) * (1.0 - e._dang)[None, :]
        return lambda X: self.scale_rows(H @ X, scales)


class EllTier(Tier):
    """Split ELLPACK: a per-row budget ``k0`` (``ell_k``, default the 90th
    degree percentile) plus a COO overflow tail for the hub rows, built on
    the engine's device.  On the card ``run`` and ``run_tol`` take each
    step in two launches of the split-ELL kernel
    (:func:`repro_torch.kernels.ell_step.ell_step`, its metadata the
    engine's ``_ell_meta``) on the carry ``(x, sum(x * dang))``; the CPU
    and the batched products take the eager gathers.

    On a graph of more than :data:`HOT_COLUMNS` vertices the layout's rows
    and columns are the vertices by out-degree (:meth:`relabel`): the
    engine's ``_order`` maps a layout position to the caller's id, ``_pos``
    back.  The states, the push's vector and the batched blocks live in
    that order; :meth:`ranks`, :meth:`leave` and the push's ranks return
    the caller's ids."""
    device_csr = True

    def relabel(self, e, edges, fields):
        """Past :data:`HOT_COLUMNS` vertices, number them by out-degree,
        descending, ties by id (one stable sort of n keys); the edges and
        both degree vectors follow.  The span's fields (a recording
        registry's) get ``order``, ``"degree"`` or ``"given"``, and
        ``hot_share``, the share of the entries whose column lies among
        the first :data:`HOT_COLUMNS` of the layout."""
        e._order, e._pos = _degree_order(edges.outdeg, e.n)
        if e._order is not None:
            order, pos = e._order, e._pos.to(edges.src.dtype)
            edges = DeviceEdges(torch.index_select(pos, 0, edges.src),
                                torch.index_select(pos, 0, edges.dst),
                                edges.outdeg[order], edges.indeg[order])
        if fields is not None:              # None from a NullRegistry
            fields["order"] = "given" if e._order is None else "degree"
            hot = int(torch.count_nonzero(edges.src < HOT_COLUMNS))
            fields["hot_share"] = hot / max(1, edges.src.numel())
        return edges

    def dangling(self, e, src, edges):
        return (edges.outdeg == 0).float()

    def pack(self, e, src, dst, csr, dang):
        host, e._ell_meta, k0, ov_nnz = _pack_split_ell(e, csr, e._ell_k)
        e.layout = f"ell(k0={k0})+overflow(nnz={ov_nnz})"
        return host

    def upload(self, e, host, dang):            # built on the device
        e._operands, e._dang = host, dang

    def adopt(self, e, layout):
        super().adopt(e, layout)
        e._ell_meta = ell_meta(e._operands[2], e.n)   # all k0 slots read

    def product(self, ops, x, metrics=_QUIET):
        data, idx, ov_r, ov_c, ov_v = ops[:5]
        scales = ops[5] if len(ops) == 6 else None
        data, ov_v = upcast_f32(data), upcast_f32(ov_v)
        vec = x.dim() == 1
        with metrics.annotate("engine.step.rows"):
            y = torch.sum((data if vec else data[..., None]) * x[idx], dim=1)
        with metrics.annotate("engine.step.overflow"):
            tail = torch.zeros_like(y).index_add_(
                0, ov_r, (ov_v if vec else ov_v[:, None]) * x[ov_c])
        return self.scale_rows(y + tail, scales)

    @staticmethod
    def place(e, X: torch.Tensor) -> torch.Tensor:
        """A vector or (n, Q) block in the caller's ids, in the layout's
        order."""
        return X if e._order is None else X[e._order]

    def start(self, e, x0):
        x = super().start(e, None if x0 is None else self.place(e, x0))
        return (x, torch.sum(x * e._dang)) if self._kernel(e) else x

    def step(self, e, metrics):
        if not self._kernel(e):
            return super().step(e, metrics)
        ops, meta, dang, d = e._operands, e._ell_meta, e._dang, e.d

        def ranges(part):
            return metrics.annotate(f"engine.step.{part}")

        def step(carry):
            with metrics.annotate("engine.step.combine"):
                return ell_step(ops, meta, dang, *carry, d=d,
                                annotate=ranges)
        return step

    def vector(self, e, state):
        return state[0] if isinstance(state, tuple) else state

    def ranks(self, e, state):
        return self.leave(e, self.vector(e, state))

    def push_operator(self, e, x0):
        return (self.eager_step(e, _QUIET), self.place(e, x0),
                lambda x: self.leave(e, x))

    def enter(self, e, A):
        return self.place(e, super().enter(e, A))

    def leave(self, e, X):
        return X if e._pos is None else X[e._pos]

    @staticmethod
    def _kernel(e) -> bool:
        """Whether the engine's solves step through the split-ELL kernel:
        on the card."""
        return e._dang.device.type == "cuda"


class BsrTier(Tier):
    """Block-sparse rows (``bsr_block_size`` blocks, 128 by default), H
    stored dangling-unfixed: every product is one launch of the BSR kernel
    (:func:`repro_torch.kernels.bsr_spmv.bsr_spmv`, through
    :func:`repro_torch.kernels.ops.spmv`), for one vector or for all the
    queries of a PPR iteration or push sweep."""

    def pack(self, e, src, dst, csr, dang):
        """``(blocks, block_cols, shape, int8 row scales or None)`` on the
        host; int8 scales per row, the abs-max over the row's whole block
        budget (slot and in-block column)."""
        bsr = tr.build_transition_bsr(src, dst, e.n, bs=e._bsr_block_size,
                                      device="cpu")
        blocks = bsr.blocks.numpy()
        cols = bsr.block_cols.numpy()
        if e.precision != "int8":
            return blocks, cols, bsr.shape, None
        nb_r, _, bs, _ = blocks.shape
        # axis 2 is the row within a block: reduce over (slot, col)
        absmax = np.abs(blocks).max(axis=(1, 3))            # (nb_r, bs)
        scales = rowmax_scales(absmax.reshape(-1))          # (nb_r * bs,)
        return (quantize_int8(blocks, scales.reshape(nb_r, 1, bs, 1)), cols,
                bsr.shape, scales)

    def upload(self, e, host, dang):
        e._dang = e._put(dang)
        blocks, cols, shape, scales = host
        if scales is None:
            bsr = BSRMatrix(e._put(blocks).to(e.storage_dtype),
                            e._put(cols), shape=shape)
        else:
            bsr = BSRMatrix(e._put(blocks), e._put(cols), shape=shape,
                            row_scales=e._put(scales))
        e._operands = (bsr,)

    def product(self, ops, x, metrics=_QUIET):
        # the container's int8 row scales are applied inside ops.spmv
        with metrics.annotate("engine.step.rows"):
            return kops.spmv(ops[0], x)


class FusedDenseTier(Tier):
    """The pre-padded dense layout ``(Hp, dangp)``, H dangling-unfixed.
    Its step is the fused kernel (K1, :func:`repro_torch.kernels
    .pagerank_step.pagerank_step_fused`), which emits the leak of the new
    vector from its epilogue, on the state ``(xp, t)``: the (1, Mp) padded
    vector and its teleport-plus-leak scalar.  Its push and its batched
    personalized operator run on the streaming kernel (K2,
    :func:`repro_torch.kernels.streaming_matvec.streaming_matvec`), the
    latter in the transposed (Q, Mp) layout; an int8 layout's (1, Np) row
    scales multiply the kernels' outputs."""
    fused = True
    node_axis = 1

    def pack(self, e, src, dst, csr, dang):
        H = torch.from_numpy(
            tr.transition_dense_np(src, dst, e.n, fix_dangling=False))
        Hp, dangp = pad_pagerank_operands(H, torch.from_numpy(dang))
        if e.precision != "int8":
            return Hp.to(e.storage_dtype), dangp, None
        q, scales = quantize_rows(Hp.numpy())
        return torch.from_numpy(q), dangp, scales

    def upload(self, e, host, dang):
        e._dang = e._put(dang)
        Hp, dangp, scales = host
        if scales is not None:
            # (1, Np): the fused kernel applies it per row in its epilogue
            e._scales = e._put(scales[None, :])
        e._operands = (Hp.to(e.device), dangp.to(e.device))

    def start(self, e, x0):
        (Hp, dangp), n, d = e._operands, e.n, e.d
        x0 = _uniform(n, dangp.device) if x0 is None else x0
        xp0 = F.pad(x0, (0, Hp.shape[1] - n))[None, :]
        return xp0, d * torch.sum(xp0 * dangp) / n + (1.0 - d) / n

    def step(self, e, metrics):
        (Hp, dangp), scales, n, d = e._operands, e._scales, e.n, e.d

        def step(state):
            yp, leak = pagerank_step_fused(Hp, state[0], dangp, state[1],
                                           scales, d=d)
            return yp, d * leak / n + (1.0 - d) / n
        return step

    def vector(self, e, state):
        return state[0][0, :e.n]

    def push_operator(self, e, x0):
        """Pad entries of H, dang and x0 are zero and ``real`` masks the
        affine terms off the tail, so the residual stays zero there and
        the frontier never touches it."""
        (Hp, dangp), scales, n, d = e._operands, e._scales, e.n, e.d
        Mp = Hp.shape[1]
        real = (torch.arange(Mp, device=Hp.device) < n).to(torch.float32)[None]

        def Ab(xp):
            y = streaming_matvec(Hp, xp)
            if scales is not None:
                y = y * scales
            leak = torch.sum(xp * dangp)
            return d * (y + leak / n * real) + (1.0 - d) / n * real

        return Ab, F.pad(x0, (0, Mp - n))[None, :], lambda xp: xp[0, :n]

    def enter(self, e, A):
        # queries ride the batch axis of streaming_matvec, so all Q share
        # one sweep over Hp per step
        Ap = np.zeros((A.shape[1], e._operands[0].shape[1]), np.float32)
        Ap[:, :e.n] = A.T
        return e._put(Ap)

    def leave(self, e, X):
        return X[:, :e.n].T

    def ppr_operator(self, e, V):
        """``Y = X @ Hp.T`` from the streaming kernel; the leak
        ``sum(X * dangp)`` per query is taken from X before it (the kernel
        has no leak output).  ``V`` of width Mp serves as a (Q, Np)
        operand, which needs square padding."""
        (Hp, dangp), scales, d = e._operands, e._scales, e.d
        if Hp.shape[0] != Hp.shape[1]:
            raise ValueError(f"the fused tier's PPR needs a square padded "
                             f"layout, got {tuple(Hp.shape)}")

        def Ab(X):
            leak = torch.sum(X * dangp, dim=1)                 # (Q,)
            Y = streaming_matvec(Hp, X)
            if scales is not None:
                Y = Y * scales
            return d * (Y + V * leak[:, None]) + (1.0 - d) * V

        return Ab


class Schedules(NamedTuple):
    """A sharded layout's loops in :mod:`~repro_torch.pagerank.distributed`."""
    run: Callable
    run_tol: Callable
    push: Callable
    ppr: Callable


class ShardedTier(Tier):
    """A layout cut over the engine's mesh at the padded N, built in numpy
    as the JAX package builds it.  ``run``, ``run_tol``, ``ppr`` and the
    dynamic engine's push are its :class:`Schedules`; the landmark push
    runs the batched operator on the engine's PPR copy of the layout
    (:meth:`ppr_layout`) in the padded (N_pad, Q) layout."""
    sharded = True

    def pack(self, e, src, dst, csr, dang):
        vals, idx = self.rows(e, src, dst, csr)
        if e.precision != "int8":
            return vals, idx, None
        vals, scales = quantize_rows(vals)
        return vals, idx, scales

    def upload(self, e, host, dang):
        vals, idx, scales = host
        e._ppr_operands = e._ppr_scales = None
        spec, scale_spec, _ = self.specs(e)
        extra = () if idx is None else (e._shard(idx, spec),)
        if scales is not None:
            e._scales = e._shard(scales, scale_spec)
        e._operands = (e._shard(vals, spec, e.storage_dtype), *extra)
        padded = np.zeros((e._n_pad,), np.float32)
        padded[:e.n] = dang
        e._dang = e._shard(padded, P())
        e.layout = self.layout_name(e)

    def adopt(self, e, layout):
        e._operands = tuple(layout["operands"])
        e._dang = layout["dang"]
        e._scales = layout.get("scales")
        e.layout = self.layout_name(e)

    def ppr_layout(self, e) -> tuple[tuple, ShardedTensor | None]:
        """The PPR copy of the layout, placed once at first use (serve
        flushes never re-gather it, run-only engines never pay it); every
        patch drops it."""
        if e._ppr_operands is None:
            spec = self.specs(e)[2]
            e._ppr_operands = tuple(fm.reshard(o, spec) for o in e._operands)
            e._ppr_scales = (None if e._scales is None
                             else fm.reshard(e._scales, P()))
        return e._ppr_operands, e._ppr_scales

    def _pad_x0(self, e, x0):
        if x0 is None or e._n_pad == e.n:
            return x0
        return F.pad(x0, (0, e._n_pad - e.n))

    def run(self, e, n_iters):
        return self.schedules.run(
            *e._operands, e.mesh, n_iters, e.d, dangling=e._dang,
            n_true=e.n, scales=e._scales, **self.axes(e)).full()[:e.n]

    def run_tol(self, e, tol, x0, max_iters, watchdog, trace):
        out = self.schedules.run_tol(
            *e._operands, e.mesh, tol=tol, max_iters=max_iters, d=e.d,
            dangling=e._dang, n_true=e.n, x0=self._pad_x0(e, x0),
            watchdog=watchdog, trace=trace, scales=e._scales,
            **self.axes(e))
        return (out[0].full()[:e.n], *out[1:])

    def push(self, e, x0, tol: float, max_pushes: int, trace: bool):
        """The dynamic engine's shard-local push."""
        out = self.schedules.push(
            *e._operands, e.mesh, self._pad_x0(e, x0),
            tol=float(np.float32(tol)), max_pushes=max_pushes, d=e.d,
            dangling=e._dang, n_true=e.n, trace=trace, scales=e._scales,
            **self.axes(e))
        return (out[0].full()[:e.n], *out[1:])

    def ppr(self, e, V, n_iters):
        # the query axis is padded with zero columns to what the mesh
        # divides, sliced back after
        q = V.shape[1]
        Vp = np.pad(V, ((0, 0), (0, -q % self.query_shards(e))))
        ops, scales = self.ppr_layout(e)
        return self.schedules.ppr(*ops, e._dang, self.enter(e, Vp), e.mesh,
                                  n_iters, e.d, scales=scales,
                                  **self.axes(e)).full()[:e.n, :q]

    def enter(self, e, A):
        Ap = np.zeros((e._n_pad, A.shape[1]), np.float32)
        Ap[:e.n] = A
        return e._put(Ap)

    def leave(self, e, X):
        return X[:e.n]

    def ppr_operator(self, e, V):
        mv = self.batched_product(e)
        dang, d = e._dang.full(), e.d
        return lambda X: ppr_step_batched(mv, X, V, dang, d)


class DenseShardedTier(ShardedTier):
    """Dangling-unfixed dense H blocked ``P(row, col)`` over a 2-D mesh,
    int8 scales replicated: the paper's fabric schedule, one K2 launch per
    shard, one horizontal-bus psum and one re-injection per iteration.  Its PPR copy is the row blocks ``P(row, None)`` (one
    more H in memory), each with its mesh column's queries."""
    schedules = Schedules(dist.pagerank_distributed,
                          dist.pagerank_distributed_tol,
                          dist.push_distributed_tol,
                          dist.ppr_distributed_dense)

    def shard_multiple(self, e):
        if len(e._axes) != 2:
            raise ValueError("dense_sharded needs a 2-D mesh, got axes "
                             f"{e._axes}")
        return math.lcm(*e.mesh.shape.values())

    def query_shards(self, e):
        return e.mesh.shape[e._axes[1]]

    def axes(self, e):
        return {"row_axis": e._axes[0], "col_axis": e._axes[1]}

    def specs(self, e):
        """The layout's, the int8 scales' and the PPR copy's specs."""
        return P(*e._axes), P(), P(e._axes[0], None)

    def layout_name(self, e):
        r, c = e.mesh.shape.values()
        return f"dense_sharded({r}x{c} mesh, n_pad={e._n_pad})"

    def rows(self, e, src, dst, csr):
        vals = np.zeros((e._n_pad, e._n_pad), np.float32)
        vals[:e.n, :e.n] = tr.transition_dense_np(src, dst, e.n,
                                                  fix_dangling=False)
        return vals, None

    def batched_product(self, e):
        ops, scales = self.ppr_layout(e)
        return lambda X: dist.ppr_matmat_dense(ops[0], X, e.mesh,
                                               **self.axes(e), scales=scales)


class EllShardedTier(ShardedTier):
    """Full-K ELL rows sharded over the flattened mesh, int8 scales
    row-sharded like the rows, the rank vector replicated: one all_gather
    per iteration.  Its PPR copy is the replicated layout; the landmark
    push takes its product on the mesh's first device."""
    device_csr = True
    schedules = Schedules(dist.pagerank_distributed_sparse,
                          dist.pagerank_distributed_sparse_tol,
                          dist.push_distributed_sparse_tol,
                          dist.ppr_distributed_sparse)

    def shard_multiple(self, e):
        return e.mesh.size

    query_shards = shard_multiple

    def axes(self, e):
        return {"axes": e._axes}

    def specs(self, e):
        return P(e._axes), P(e._axes), P()

    def layout_name(self, e):
        return (f"ell_sharded(k={e._operands[0].shape[1]}, "
                f"shards={e.mesh.size}, n_pad={e._n_pad})")

    def rows(self, e, src, dst, csr):
        """Full-K rows from the transition CSR, read on the host, where
        ``ell_k`` is a minimum row capacity and never a truncation (the
        dynamic engine passes ``maxdeg + slack``)."""
        csr = csr.to("cpu")
        counts = np.diff(csr.indptr.numpy())
        maxdeg = int(counts.max()) if len(counts) else 0
        k = maxdeg if e._ell_k is None else max(int(e._ell_k), maxdeg)
        ell = ELLMatrix.from_csr(csr, k=k)
        vals = np.zeros((e._n_pad, ell.k), np.float32)
        idx = np.zeros((e._n_pad, ell.k), np.int32)
        vals[:e.n] = ell.data.numpy()
        idx[:e.n] = ell.indices.numpy()
        return vals, idx

    def batched_product(self, e):
        ops, scales = self.ppr_layout(e)
        data, idx = upcast_f32(ops[0].shards[0]), ops[1].shards[0]
        sc = None if scales is None else scales.shards[0]
        return lambda X: self.scale_rows(
            torch.sum(data[..., None] * X[idx], dim=1), sc)


def _balanced_rows(counts: torch.Tensor, parts: int) -> list[int]:
    """Row bounds ``[0, r_1, ..., n]`` of ``parts`` blocks of consecutive
    rows whose entry ``counts`` (n,) add up to about equal sums: each
    bound is the row before which the entries come nearest to its share,
    and every block keeps at least one row."""
    n = counts.numel()
    cum = torch.cumsum(counts, 0)
    total = int(cum[-1])
    targets = [(total * b + parts // 2) // parts for b in range(1, parts)]
    at = torch.searchsorted(cum, torch.tensor(targets, dtype=cum.dtype,
                                              device=cum.device))
    # entries before row i: cum[i - 1]; the first row at or past a share
    # is at[b], so the bound is at[b] or at[b] + 1
    before = F.pad(cum, (1, 0))
    lo = before[at].tolist()
    hi = before[torch.clamp(at + 1, max=n)].tolist()
    bounds = [0]
    for b, (i, t) in enumerate(zip(at.tolist(), targets), start=1):
        r = i if t - lo[b - 1] <= hi[b - 1] - t else i + 1
        bounds.append(min(max(r, bounds[-1] + 1), n - (parts - b)))
    return bounds + [n]


class EllSplitShardedTier(ShardedTier):
    """One split ELL per position of the engine's mesh, flattened over
    all of its axes.  The vertices are numbered as the ``ell`` tier numbers
    them (:func:`_degree_order`), and the rows are cut into one block per
    position so that the blocks carry about equal numbers of entries
    (:func:`_balanced_rows`): in degree order equal row counts would put
    most entries on the first.  Each block is a split ELL
    (:func:`_split_ell`) whose column indices reach the whole vector, with
    its :func:`~repro_torch.kernels.ell_step.ell_meta`, on its position's
    device.  Every block takes the ``k0`` that the ``ell`` tier takes for
    the whole graph (``ell_k``, default the 90th percentile of all the
    rows' counts), so a row is split as there: a block of hub rows keeps
    their long tails in the overflow, whose chunks spread them over the
    card, and not in ELL rows that few lanes walk.

    The build (:meth:`build`) never puts the whole edge set on one device,
    nor a whole-graph layout on the host.  A step runs both passes of the
    split-ELL kernel over every block against that position's replica of
    the rank vector, then exchanges the fresh blocks and the blocks' parts
    of the next leak (:func:`~repro_torch.pagerank.distributed
    .split_ell_step`); ``run`` and ``run_tol`` are the engine's one loop and
    one tolerance loop.  The engine keeps per position the operands
    (``_operands``), the metadata (``_ell_meta``) and the dangling mask of
    the block's rows (``_dang``), and the row bounds (``_rows``).

    The host edge bookkeeping that the landmark index reads (``_keys``,
    ``_outdeg``, ``_indeg``) stays unbuilt on this tier, and ``ppr``, the
    push, the dynamic engine and ``from_layout`` raise: they run on
    ``ell_sharded``."""
    edges_on_mesh = True
    run = Tier.run
    run_tol = Tier.run_tol

    def shard_multiple(self, e):
        return 1                    # blocks are ragged: N is never padded

    def build(self, e, src, dst, edges=None):
        """The layout from the caller's edges, in the phases
        ``prepare.shard`` (each position uploads its share of the edge
        list and sends every edge to the position that owns its ``dst``
        among equal ranges of the caller's ids, where the edges are
        deduplicated, exactly, since a repeated edge has one ``dst``; the
        out- and in-degrees summed across positions; the degree order and
        the row bounds; each edge sent on to the block that owns its row),
        ``prepare.csr`` (each block's rows of the transition CSR) and
        ``prepare.pack`` (each block's split ELL).  The span
        ``prepare.shard`` gets the fields ``rows_per_card`` and
        ``entries_per_card``, one entry per position."""
        devs, n = e.mesh.device_list, e.n
        parts = len(devs)
        if n < parts:
            raise ValueError(f"ell_split_sharded needs a vertex per mesh "
                             f"position: n = {n} on {parts} positions")
        with e._phase("prepare.shard") as fields:
            keys = _keys_by_dst(src, dst, n, devs)
            outdeg = _summed(keys, n, devs[0], lambda k: k % n)
            indeg = _summed(keys, n, devs[0], lambda k: k // n)
            e._order, e._pos = _degree_order(outdeg, n)
            if e._order is not None:
                outdeg, indeg = outdeg[e._order], indeg[e._order]
            rows = _balanced_rows(indeg, parts)
            keys = _keys_by_block(keys, e._pos, rows, n, devs)
            entries = [int(k.numel()) for k in keys]
            e._rows = tuple(rows)
            e.n_edges = sum(entries)
            e.density = e.n_edges / float(n * n)
            if fields is not None:          # None from a NullRegistry
                fields["rows_per_card"] = [b - a for a, b
                                           in zip(rows[:-1], rows[1:])]
                fields["entries_per_card"] = entries
        with e._phase("prepare.csr"):
            inv = torch.reciprocal(outdeg.float())
            csrs = []
            for p, dev in enumerate(devs):
                a, b = rows[p], rows[p + 1]
                csrs.append(_block_csr(keys[p], a, b, n, inv.to(dev),
                                       indeg[a:b].to(dev)))
                keys[p] = None
        with e._phase("prepare.pack"):
            k0 = e._ell_k if e._ell_k is not None else max(
                4, int(np.percentile(indeg.cpu().numpy(), 90)))
            packed = [_pack_split_ell(e, csr, k0) for csr in csrs]
            del csrs
            e._operands = tuple(ops for ops, *_ in packed)
            e._ell_meta = tuple(meta for _, meta, *_ in packed)
            e._dang = tuple((outdeg[a:b] == 0).float().to(dev)
                            for dev, a, b in zip(devs, rows[:-1], rows[1:]))
            e.layout = (f"ell_split_sharded(blocks={parts}, k0={k0}, "
                        f"overflow={[ov for *_, ov in packed]})")

    def adopt(self, e, layout):
        self._unsupported("from_layout")

    @staticmethod
    def _unsupported(what: str):
        raise NotImplementedError(
            f"{what} is not supported on ell_split_sharded, which runs "
            "run and run_tol only; use ell_sharded")

    def start(self, e, x0):
        x = _uniform(e.n, e.device) if x0 is None else EllTier.place(e, x0)
        return dist.split_ell_start(x, e._dang, e._rows, e.mesh)

    def step(self, e, metrics):
        return dist.split_ell_step(e._operands, e._ell_meta, e._dang,
                                   e._rows, e.mesh, e.d, metrics)

    def vector(self, e, state):
        return state[0]

    def ranks(self, e, state):
        return self.leave(e, state[0])

    def leave(self, e, X):
        return X if e._pos is None else X[e._pos]

    def push(self, e, x0, tol, max_pushes, trace):
        self._unsupported("the push")

    def push_operator(self, e, x0):
        self._unsupported("the push")

    def ppr(self, e, V, n_iters):
        self._unsupported("ppr")

    def ppr_operator(self, e, V):
        self._unsupported("ppr")

    def batched_product(self, e):
        self._unsupported("the batched product")


def _keys_by_dst(src, dst, n: int, devs) -> list[torch.Tensor]:
    """The caller's edges as sorted unique keys ``dst * n + src`` (int64),
    on the position that owns ``dst`` among equal ranges of the caller's
    ids: each position uploads one contiguous share of the arrays, keeps
    its unique keys and sends each range's keys to its owner, which
    deduplicates what it receives."""
    parts = len(devs)
    step = -(-n // parts)
    cuts = np.linspace(0, len(src), parts + 1).astype(np.int64)
    sent: list[list] = [[] for _ in devs]
    for p, dev in enumerate(devs):
        a, b = cuts[p], cuts[p + 1]
        keys = torch.unique(_device_ids(dst[a:b], dev) * n
                            + _device_ids(src[a:b], dev), sorted=True)
        at = torch.searchsorted(keys, torch.arange(
            1, parts, device=dev, dtype=torch.int64) * (step * n)).tolist()
        for q, piece in enumerate(torch.tensor_split(keys, at)):
            sent[q].append(piece.to(devs[q]))
        del keys
    return [torch.unique(torch.cat(pieces), sorted=True) for pieces in sent]


def _summed(keys, n: int, dev, ids) -> torch.Tensor:
    """``bincount(ids(keys[p]))`` of every position added up, in order,
    on ``dev``: a degree vector (int64, length n)."""
    total = None
    for k in keys:
        c = torch.bincount(ids(k), minlength=n).to(dev)
        total = c if total is None else total + c
    return total


def _keys_by_block(keys, pos, rows, n: int, devs) -> list[torch.Tensor]:
    """Every position's keys ``dst * n + src`` in the caller's ids, sent to
    the block that owns ``dst`` in the layout's order and there sorted as
    keys ``row * n + col`` of the layout (row-major)."""
    sent: list[list] = [[] for _ in devs]
    for p, (k, dev) in enumerate(zip(keys, devs)):
        d, s = k // n, k % n
        if pos is not None:
            where = pos.to(dev)
            d, s = where[d], where[s]
        k = d * n + s
        for q, (a, b) in enumerate(zip(rows[:-1], rows[1:])):
            sent[q].append(k[(d >= a) & (d < b)].to(devs[q]))
        keys[p] = None
        del d, s, k
    return [torch.sort(torch.cat(pieces)).values for pieces in sent]


def _block_csr(keys: torch.Tensor, a: int, b: int, n: int,
               inv: torch.Tensor, indeg: torch.Tensor) -> CSRMatrix:
    """Rows ``a:b`` of the transition CSR from their sorted keys ``row * n
    + col`` in the layout's order, as :func:`_transition_csr` builds all
    of it: values ``inv[col]`` (``inv`` the reciprocal out-degrees, float32),
    ``indptr`` the cumulative in-degrees ``indeg`` of the rows, rows local
    to the block, columns global; int32 indices."""
    rows = torch.div(keys, n, rounding_mode="floor")
    cols = keys - rows * n
    indptr = F.pad(torch.cumsum(indeg, 0), (1, 0))
    return CSRMatrix(inv[cols], cols.int(), indptr.int(), (rows - a).int(),
                     shape=(b - a, n))


# every backend's tier, one instance each
TIERS = {"dense": DenseTier(), "ell": EllTier(), "bsr": BsrTier(),
         "fused_dense": FusedDenseTier(), "dense_sharded": DenseShardedTier(),
         "ell_sharded": EllShardedTier(),
         "ell_split_sharded": EllSplitShardedTier()}


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
    :func:`repro_torch.pagerank.convert.layout_from_numpy`).  The layout's
    build, step and batched operators belong to its :class:`Tier`
    (``self._tier``, picked once from ``_TIERS`` by the backend's name).
    """
    _TIERS = TIERS

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
            on_device = None
            if self._TIERS.get(backend, Tier).edges_on_mesh:
                # the tier builds from the caller's edges on its mesh and
                # keeps no host edge bookkeeping
                self._keys = self._outdeg = self._indeg = None
            else:
                # host edge-set bookkeeping (sorted src*n+dst keys + degree
                # vectors): the landmark index (repro_torch.pagerank
                # .landmarks) reads hub degrees and out-neighborhoods off
                # the engine
                edges = _edge_set(src, dst, n, dev, m)
                src, dst, self._keys, self._outdeg, self._indeg = edges[:5]
                on_device = edges.on_device
                self.n_edges = int(len(src))
                self.density = self.n_edges / float(n * n)
                if backend == "auto":
                    backend = select_backend(
                        n, self.density, device=dev,
                        n_devices=None if mesh is None else mesh.size)
            if fields is not None:              # None from a NullRegistry
                fields["backend"] = backend
            self._init_common(n, d, backend, precision, dev, mesh)
            self._ell_k = ell_k
            self._bsr_block_size = int(bsr_block_size)
            self._prepare_layout(src, dst, on_device)

    def _init_common(self, n, d, backend, precision, device,
                     mesh=None) -> None:
        if backend not in BACKENDS:
            raise ValueError(
                f"backend {backend!r} not in {BACKENDS + ('auto',)}")
        self.n = int(n)
        self.d = float(d)
        self.device = device
        self.backend = backend
        self._tier = self._TIERS[backend]
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
        # the split-ELL kernel's metadata of an ell layout (ell_meta), and
        # its vertex order (layout position -> caller's id) and inverse
        self._ell_meta = None
        self._order: torch.Tensor | None = None
        self._pos: torch.Tensor | None = None
        if self._tier.sharded:
            self.mesh = (mesh if mesh is not None
                         else default_mesh(backend, device))
            self._axes = tuple(self.mesh.axis_names)
            shards = self._tier.shard_multiple(self)
            self._n_pad = -(-self.n // shards) * shards
        # the last run_tol's SolveInfo and the warn-once latch for
        # silently exhausted solves
        self.last_solve_info = None
        self._warned_nonconverged = False

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
        eng.metrics = metrics if metrics is not None else default_registry()
        eng._init_common(n, d, backend, precision,
                         _engine_device(device, mesh), mesh)
        eng._keys = layout.get("keys")
        eng._outdeg = layout.get("outdeg")
        eng._indeg = layout.get("indeg")
        eng._tier.adopt(eng, layout)
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

    def _prepare_layout(self, src: np.ndarray, dst: np.ndarray,
                        edges: DeviceEdges | None = None) -> None:
        """Build the tier's prepared device layout from a deduplicated COO
        edge list (:meth:`Tier.build`): ``ell``'s split ELL on the device,
        ``ell_sharded``'s full-width rows and the other tiers' layouts in
        numpy, as the JAX package builds them.  Each phase ends in a
        synchronize unless the registry is a :class:`NullRegistry`."""
        self.layout = self.backend
        self._scales = None
        self._tier.build(self, src, dst, edges)
        if self.precision != "f32":
            self.layout = f"{self.layout}[{self.precision}]"
        self._record_layout_bytes()

    @contextlib.contextmanager
    def _phase(self, name: str):
        """The span ``name`` around one phase of the layout build.  With a
        recording registry the phase ends once the engine's cards have
        done its work, so none of its device time falls into a later
        phase; a :class:`NullRegistry` adds no wait.  Yields the span's
        fields (``None`` from a :class:`NullRegistry`)."""
        with self.metrics.span(name) as fields:
            yield fields
            if not isinstance(self.metrics, NullRegistry):
                self._synchronize()

    def _synchronize(self) -> None:
        """Wait for the engine's cards (the mesh's, on the sharded tiers)
        to finish the placement."""
        devices = (self.mesh.device_list if self.mesh is not None
                   else [self.device])
        for dev in {d for d in devices if d.type == "cuda"}:
            torch.cuda.synchronize(dev)

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
        tensors.  An ``ell`` layout's rows and columns, and its dangling
        mask, are in :attr:`vertex_order`."""
        return self._operands

    @property
    def vertex_order(self) -> torch.Tensor | None:
        """The layout's vertex order: ``None`` where it keeps the caller's
        ids, else the int64 ``order`` on the engine's device whose entry
        ``i`` is the caller's id of layout position ``i``.  Only an ``ell``
        layout built here over more than :data:`HOT_COLUMNS` vertices has
        one: the vertices by out-degree, descending, ties by id."""
        return self._order

    def lower_run(self) -> dict:
        """The per-iteration schedule of ``run`` on the sharded tiers, the
        counterpart of the JAX package's AOT lowering for collective
        audits: one ``run(1)`` with :mod:`repro_torch.core.fabric_matvec`'s
        counters zeroed before and read after.  Returns the collectives
        by kind, the bytes each kind moved, and the shard-local K2 calls by
        (storage type, batch size) — K2 launches on the card."""
        if not self._tier.sharded:
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
            return self._tier.run(self, n_iters)

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
            out = self._tier.run_tol(self, tol_f32, x0, max_iters, watchdog,
                                     trace)
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
            return self._tier.ppr(self, seed_matrix(self.n, seed_sets),
                                  n_iters)

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
