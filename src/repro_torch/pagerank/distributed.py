"""Distributed PageRank — the paper's workload on a device mesh.

The counterpart of ``repro.pagerank.distributed``: two layouts, each in a
fixed-schedule and a tolerance-terminated variant, the shard-local push of
the live-update path, and the query-sharded batched PPR schedules that back
the ``dense_sharded`` / ``ell_sharded`` tiers of
:class:`repro_torch.pagerank.engine.PageRankEngine`:

* :func:`pagerank_distributed` / :func:`pagerank_distributed_tol` — dense H
  sharded ``P(row, col)`` over a 2-D mesh, iterating the paper's fabric
  schedule (:mod:`repro_torch.core.fabric_matvec`: shard-local products on
  K2 -> horizontal-bus psum -> diagonal re-injection).
* :func:`pagerank_distributed_sparse` /
  :func:`pagerank_distributed_sparse_tol` — ELL rows sharded over the
  flattened mesh, rank vector replicated, one all_gather per iteration.
* :func:`push_distributed_tol` / :func:`push_distributed_sparse_tol` — the
  Gauss–Southwell frontier push on the same two layouts.
* :func:`ppr_distributed_dense` / :func:`ppr_distributed_sparse` — the
  batched (N, Q) personalized PageRank sharded over the **query** axis.
* :func:`split_ell_start` / :func:`split_ell_step` — the ``ell_split_sharded``
  tier's state and step: a split ELL of a block of rows per position of the
  flattened mesh, stepped by the split-ELL kernel against the position's
  replica of the rank vector, then the fresh blocks and the blocks' parts
  of the next leak exchanged (:func:`repro_torch.core.fabric_matvec
  .gather_blocks`); the engine's own loops run it.

Uneven shapes are zero-padded: every entry point takes ``n_true`` and keeps
the ``1/n`` teleports, the dangling leak and the residuals on the real
nodes; callers slice ``[:n_true]``.  One process drives the mesh
(:mod:`repro_torch.launch.mesh`).  The fixed schedules issue their
iterations with no host sync; the tolerance variants run the port's chunked
masked loop (:func:`repro_torch.obs.trace.instrumented_tol_loop`: one host
sync per ``CHUNK`` steps) on a residual that is one scalar for the whole
mesh, so every position stops at the same iteration.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import fabric_matvec as fm
from repro_torch.core.fabric_matvec import P, ShardedTensor, shard_map
from repro_torch.kernels.common import upcast_f32
from repro_torch.kernels.ell_step import ell_step
from repro_torch.launch.mesh import Mesh
from repro_torch.obs.trace import instrumented_tol_loop

__all__ = ["split_ell_start", "split_ell_step",
           "pagerank_distributed", "pagerank_distributed_tol",
           "pagerank_distributed_sparse", "pagerank_distributed_sparse_tol",
           "push_distributed_tol", "push_distributed_sparse_tol",
           "ppr_distributed_dense", "ppr_distributed_sparse",
           "ppr_matmat_dense", "make_sharded_inputs_dense"]


def _pr0(n: int, n_true: int, device, dtype=torch.float32) -> torch.Tensor:
    """Uniform 1/n_true on the real nodes, exactly 0 on the pad tail."""
    pr = torch.zeros((n,), dtype=dtype, device=device)
    pr[:n_true] = 1.0 / n_true
    return pr


def _real_mask(n: int, n_true: int, device,
               dtype=torch.float32) -> torch.Tensor:
    return (torch.arange(n, device=device) < n_true).to(dtype)


class _Carry:
    """Threads sharded tensors of fixed layouts through the tolerance loop,
    whose state is a flat tuple of tensors: one slot per distinct (device,
    block) of each layout, in mesh order."""

    def __init__(self, mesh: Mesh, *layouts):
        self.mesh = mesh
        self.layouts = layouts                  # (spec, shape) pairs
        self.index, self.first = [], []
        for spec, shape in layouts:
            seen, ix, first = {}, [], []
            for p, dev in enumerate(mesh.device_list):
                key = (dev, fm._ranges(mesh, P(*spec), shape, p))
                if key not in seen:
                    seen[key] = len(first)
                    first.append(p)
                ix.append(seen[key])
            self.index.append(ix)
            self.first.append(first)

    def pack(self, *xs: ShardedTensor) -> tuple:
        return tuple(x.shards[p] for x, first in zip(xs, self.first)
                     for p in first)

    def unpack(self, flat) -> list[ShardedTensor]:
        out, i = [], 0
        for (spec, shape), ix, first in zip(self.layouts, self.index,
                                            self.first):
            slots = flat[i:i + len(first)]
            i += len(first)
            out.append(ShardedTensor(self.mesh, spec, shape,
                                     [slots[k] for k in ix]))
        return out


def _replicated(x, mesh: Mesh, n: int) -> ShardedTensor:
    if x is None:
        x = torch.zeros((n,), dtype=torch.float32,
                        device=mesh.device_list[0])
    return fm._as(x, mesh, P())


def _thresh(tol, nt: int) -> float:
    """The push frontier threshold ``float32(tol) / n`` in float32."""
    return float(np.float32(tol) / np.float32(nt))


# --------------------------------------------------------------------------- #
# dense fabric schedule (2-D mesh)                                            #
# --------------------------------------------------------------------------- #
def _dense_iter(H, pr, dangling, mesh, row_axis, col_axis, d, nt,
                scales=None) -> ShardedTensor:
    """The fabric-schedule iteration, shared by the fixed, tolerance and
    push variants: shard-local products on K2, the horizontal-bus psum
    (which carries each column block's partial leak ``sum(pr * dang)``
    beside the products, as XLA combines the two all-reduces), the int8
    row scales after the bus sum, the affine step, and the re-injection
    into the vertical-bus layout.  ``dangling`` and ``scales`` are
    replicated; each position reads its own block of them."""
    H = fm._as(H, mesh, P(row_axis, col_axis))
    pr = fm._as(pr, mesh, P(col_axis))
    s = None if scales is None else fm._as(scales, mesh, P(row_axis))
    dc = None if dangling is None else fm._as(dangling, mesh, P(col_axis))

    # the column block's share of the leak, once per (device, block)
    part = None if dc is None else shard_map(torch.dot, mesh, pr, dc)

    def site(h, x, lk):
        # the site multiplies, and the leak's share riding the horizontal
        # bus beside them (one psum for both)
        y = fm.local_matvec(h, x)
        return y if lk is None else torch.cat([y, lk.reshape(1)])

    def adder(yl, sb):
        y, leak = (yl, 0.0) if dc is None else (yl[:-1], yl[-1])
        if sb is not None:
            y = y * sb
        return d * (y + leak / nt) + (1.0 - d) / nt

    bus = fm.psum(shard_map(site, mesh, H, pr, part), mesh, col_axis)
    y = shard_map(adder, mesh, bus, s)
    return fm.matvec_iterated_reshard(
        ShardedTensor(mesh, P(row_axis), (H.shape[0],), y), mesh, row_axis,
        col_axis)


def _dense_setup(H, dangling, scales, mesh, row_axis, col_axis):
    H = fm._as(H, mesh, P(row_axis, col_axis))
    n = H.shape[0]
    dang = (None if dangling is None else
            fm.reshard(_replicated(dangling, mesh, n), P(col_axis)))
    sc = (None if scales is None else
          fm.reshard(_replicated(scales, mesh, n), P(row_axis)))
    return H, n, dang, sc


def _col_l1(r: ShardedTensor, mesh, col_axis, mask=None) -> torch.Tensor:
    """The L1 norm of a P(col) vector (masked): the column blocks' partial
    sums, one psum; position 0's copy of the mesh-wide scalar."""
    if mask is None:
        part = shard_map(lambda a: torch.sum(torch.abs(a)), mesh, r)
    else:
        part = shard_map(lambda a, m: torch.sum(torch.abs(a) * m), mesh, r,
                         mask)
    return fm.psum(part, mesh, col_axis)[0]


def pagerank_distributed(H, mesh: Mesh, n_iters: int = 100, d: float = 0.85,
                         row_axis: str = "data", col_axis: str = "model",
                         dangling=None, n_true: int | None = None,
                         scales=None) -> ShardedTensor:
    """Dense fabric-schedule PageRank.  H: (N, N) sharded P(row, col);
    returns PR (N,) sharded P(col) (vertical-bus layout).

    With ``dangling`` given, H must be the *unfixed* transition matrix and
    the leak is applied as an explicit scalar; with ``dangling=None`` H
    must be dangling-fixed.  H may be stored reduced-precision (K2 upcasts
    each tile); the iterate is float32, and ``scales`` carries an int8
    layout's per-row scales."""
    H, n, dang, sc = _dense_setup(H, dangling, scales, mesh, row_axis,
                                  col_axis)
    nt = int(n if n_true is None else n_true)
    pr = ShardedTensor.from_global(_pr0(n, nt, mesh.device_list[0]), mesh,
                                   P(col_axis))
    for _ in range(n_iters):
        pr = _dense_iter(H, pr, dang, mesh, row_axis, col_axis, d, nt, sc)
    return pr


def pagerank_distributed_tol(H, mesh: Mesh, tol: float = 1e-6,
                             max_iters: int = 1000, d: float = 0.85,
                             row_axis: str = "data", col_axis: str = "model",
                             dangling=None, n_true: int | None = None,
                             x0=None, watchdog: bool = True,
                             trace: bool = False, scales=None):
    """Tolerance-terminated fabric-schedule PageRank: the masked L1
    residual is one psum'd scalar for the whole mesh, so every position
    stops on the same iteration, with the same watchdog verdict.  Returns
    ``(pr, n_iters, residual, grow, ring)``; ``x0`` (padded to N, zeros on
    the pad tail) warm-starts the loop."""
    H, n, dang, sc = _dense_setup(H, dangling, scales, mesh, row_axis,
                                  col_axis)
    nt = int(n if n_true is None else n_true)
    dev0 = mesh.device_list[0]
    mask = ShardedTensor.from_global(_real_mask(n, nt, dev0), mesh,
                                     P(col_axis))
    x0 = _pr0(n, nt, dev0) if x0 is None else upcast_f32(x0)
    carry = _Carry(mesh, (P(col_axis), (n,)))

    def step(flat):
        (pr,) = carry.unpack(flat)
        new = _dense_iter(H, pr, dang, mesh, row_axis, col_axis, d, nt, sc)
        res = _col_l1(ShardedTensor(mesh, new.spec, new.shape,
                                    shard_map(torch.sub, mesh, new, pr)),
                      mesh, col_axis, mask)
        return carry.pack(new), res

    flat, iters, res, grow, ring = instrumented_tol_loop(
        step, carry.pack(fm._as(x0, mesh, P(col_axis))), tol=tol,
        max_iters=max_iters, watchdog=watchdog, trace=trace)
    return carry.unpack(flat)[0], iters, res, grow, ring


# --------------------------------------------------------------------------- #
# sparse row-sharded schedule (flattened mesh)                                #
# --------------------------------------------------------------------------- #
def _ell_block_iter(data, idx, pr, dang, mesh, axes, d, nt,
                    scales=None) -> ShardedTensor:
    """The row-sharded ELL iteration (local rows -> leak -> damp -> tiled
    all_gather): each position sweeps its own row block against the
    replicated rank vector in float32; the leak is computed replicated, no
    collective."""
    def body(data_blk, idx_blk, pr_full, leak, scale_blk):
        y = torch.sum(upcast_f32(data_blk) * pr_full[idx_blk], dim=1)
        if scale_blk is not None:
            y = y * scale_blk
        return d * (y + leak) + (1.0 - d) / nt

    # the replicated leak, once per device
    leak = shard_map(lambda x, g: torch.dot(x, g) / nt, mesh, pr, dang)
    y = shard_map(body, mesh, data, idx, pr, leak, scales)
    return ShardedTensor(mesh, P(), pr.shape,
                         fm.all_gather(y, mesh, axes, dim=0))


def _ell_setup(ell_data, ell_idx, dangling, scales, mesh, axes):
    data = fm._as(ell_data, mesh, P(axes))
    idx = fm._as(ell_idx, mesh, P(axes))
    n = data.shape[0]
    sc = None if scales is None else fm._as(scales, mesh, P(axes))
    return data, idx, n, _replicated(dangling, mesh, n), sc


def pagerank_distributed_sparse(ell_data, ell_idx, mesh: Mesh,
                                n_iters: int = 100, d: float = 0.85,
                                dangling=None,
                                axes: tuple[str, ...] = ("data", "model"),
                                n_true: int | None = None,
                                scales=None) -> ShardedTensor:
    """Row-sharded ELL PageRank.  ``ell_data`` / ``ell_idx``: (N, K)
    sharded over rows on the flattened mesh axes; PR replicated; one tiled
    all_gather of the fresh row blocks per iteration.  ``scales``: an int8
    layout's (N,) per-row scales, row-sharded like the ELL operands."""
    data, idx, n, dang, sc = _ell_setup(ell_data, ell_idx, dangling, scales,
                                        mesh, axes)
    nt = int(n if n_true is None else n_true)
    pr = fm._as(_pr0(n, nt, mesh.device_list[0]), mesh, P())
    for _ in range(n_iters):
        pr = _ell_block_iter(data, idx, pr, dang, mesh, axes, d, nt, sc)
    return pr


def pagerank_distributed_sparse_tol(ell_data, ell_idx, mesh: Mesh,
                                    tol: float = 1e-6, max_iters: int = 1000,
                                    d: float = 0.85, dangling=None,
                                    axes: tuple[str, ...] = ("data", "model"),
                                    n_true: int | None = None, x0=None,
                                    watchdog: bool = True,
                                    trace: bool = False, scales=None):
    """Tolerance-terminated row-sharded ELL PageRank.  After each
    iteration's all_gather every position holds the whole fresh vector, so
    the residual and the exit decision are the same everywhere without an
    extra collective.  Returns ``(pr, n_iters, residual, grow, ring)``."""
    data, idx, n, dang, sc = _ell_setup(ell_data, ell_idx, dangling, scales,
                                        mesh, axes)
    nt = int(n if n_true is None else n_true)
    dev0 = mesh.device_list[0]
    mask = fm._as(_real_mask(n, nt, dev0), mesh, P())
    x0 = _pr0(n, nt, dev0) if x0 is None else upcast_f32(x0)
    carry = _Carry(mesh, (P(), (n,)))

    def step(flat):
        (pr,) = carry.unpack(flat)
        new = _ell_block_iter(data, idx, pr, dang, mesh, axes, d, nt, sc)
        res = shard_map(lambda a, b, m: torch.sum(torch.abs(a - b) * m),
                        mesh, new, pr, mask)[0]
        return carry.pack(new), res

    flat, iters, res, grow, ring = instrumented_tol_loop(
        step, carry.pack(fm._as(x0, mesh, P())), tol=tol,
        max_iters=max_iters, watchdog=watchdog, trace=trace)
    return carry.unpack(flat)[0], iters, res, grow, ring


# --------------------------------------------------------------------------- #
# shard-local Gauss–Southwell push (the live-update primitive)                #
# --------------------------------------------------------------------------- #
def _push(residual, l1, carry, x0, tol, nt, max_pushes, watchdog, trace):
    """The frontier loop shared by both layouts: every sweep pushes the
    mask ``|r| >= tol/n`` into the iterate and recomputes the residual;
    the real initial residual seeds the loop."""
    thresh = _thresh(tol, nt)

    def push(xb, rb):
        return xb + rb * (torch.abs(rb) >= thresh).to(xb.dtype)

    def step(flat):
        x, r = carry.unpack(flat)
        x = ShardedTensor(carry.mesh, x.spec, x.shape,
                          shard_map(push, carry.mesh, x, r))
        r = residual(x)
        return carry.pack(x, r), l1(r)

    r0 = residual(x0)
    flat, sweeps, res, grow, ring = instrumented_tol_loop(
        step, carry.pack(x0, r0), tol=tol, max_iters=max_pushes,
        watchdog=watchdog, trace=trace, res0=l1(r0))
    return carry.unpack(flat)[0], sweeps, res, grow, ring


def push_distributed_tol(H, mesh: Mesh, x0, tol: float = 1e-6,
                         max_pushes: int = 1000, d: float = 0.85,
                         row_axis: str = "data", col_axis: str = "model",
                         dangling=None, n_true: int | None = None,
                         watchdog: bool = True, trace: bool = False,
                         scales=None):
    """Frontier push on the dense fabric layout: the frontier update is
    elementwise on each position's P(col) block, so the per-sweep
    collectives are those of :func:`_dense_iter` plus one psum for the
    residual's L1 norm.  The residual is masked to the real nodes, so the
    pad tail never enters the frontier.  ``x0`` must be padded to N (zeros
    on the tail).  Returns ``(x, sweeps, residual, grow, ring)``."""
    H, n, dang, sc = _dense_setup(H, dangling, scales, mesh, row_axis,
                                  col_axis)
    nt = int(n if n_true is None else n_true)
    spec = P(col_axis)
    mask = ShardedTensor.from_global(_real_mask(n, nt, mesh.device_list[0]),
                                     mesh, spec)

    def residual(x):
        new = _dense_iter(H, x, dang, mesh, row_axis, col_axis, d, nt, sc)
        return ShardedTensor(mesh, spec, x.shape, shard_map(
            lambda a, b, m: (a - b) * m, mesh, new, x, mask))

    return _push(residual, lambda r: _col_l1(r, mesh, col_axis),
                 _Carry(mesh, (spec, (n,)), (spec, (n,))),
                 fm._as(upcast_f32(x0), mesh, spec), tol, nt, max_pushes,
                 watchdog, trace)


def push_distributed_sparse_tol(ell_data, ell_idx, mesh: Mesh, x0,
                                tol: float = 1e-6, max_pushes: int = 1000,
                                d: float = 0.85, dangling=None,
                                axes: tuple[str, ...] = ("data", "model"),
                                n_true: int | None = None,
                                watchdog: bool = True, trace: bool = False,
                                scales=None):
    """Frontier push on the row-sharded ELL layout: each position sweeps its
    own row block and the per-sweep all_gather re-assembles the operator
    image, after which the residual, the frontier and the exit are
    computed from the replicated vector with no extra collective.  Returns
    ``(x, sweeps, residual, grow, ring)``."""
    data, idx, n, dang, sc = _ell_setup(ell_data, ell_idx, dangling, scales,
                                        mesh, axes)
    nt = int(n if n_true is None else n_true)
    mask = fm._as(_real_mask(n, nt, mesh.device_list[0]), mesh, P())

    def residual(x):
        new = _ell_block_iter(data, idx, x, dang, mesh, axes, d, nt, sc)
        return ShardedTensor(mesh, P(), x.shape, shard_map(
            lambda a, b, m: (a - b) * m, mesh, new, x, mask))

    def l1(r):
        return shard_map(lambda a: torch.sum(torch.abs(a)), mesh, r)[0]

    return _push(residual, l1, _Carry(mesh, (P(), (n,)), (P(), (n,))),
                 fm._as(upcast_f32(x0), mesh, P()), tol, nt, max_pushes,
                 watchdog, trace)


# --------------------------------------------------------------------------- #
# query-sharded batched personalized PageRank                                 #
# --------------------------------------------------------------------------- #
def _global(x) -> torch.Tensor:
    return x.full() if isinstance(x, ShardedTensor) else torch.as_tensor(x)


def ppr_distributed_dense(H, dang, V, mesh: Mesh, n_iters: int = 100,
                          d: float = 0.85, row_axis: str = "data",
                          col_axis: str = "model",
                          scales=None) -> ShardedTensor:
    """Batched PPR with the (N, Q) rank matrix sharded over the query axis.

    H is the *unfixed* transition matrix in row blocks ``P(row, None)``
    (replicated along ``col_axis``; a H in another layout is resharded
    here, as the JAX ``in_spec`` does on every call).  Each mesh column
    owns Q/C queries and each mesh row N/R rows of the sweep: the product
    of a row block with the column's queries is one K2 launch with
    ``W`` = the (N/R, N) row block and ``X`` = the (Q/C, N) query rows,
    and one row-axis all_gather per iteration re-assembles the sweep.
    Returns the (N, Q) rank matrix sharded ``P(None, col)``."""
    Hr = fm._as(H, mesh, P(row_axis, None))
    n = Hr.shape[0]
    dg = _replicated(dang, mesh, n)
    sc = (None if scales is None
          else fm._as(_replicated(scales, mesh, n), mesh, P(row_axis)))
    Vt = fm._as(upcast_f32(_global(V)).T.contiguous(), mesh,
                P(col_axis, None))                        # (Q, N) rows
    q = Vt.shape[0]

    def step(pr, y, v, g):                   # ppr_step_batched, transposed
        leak = torch.sum(pr * g[None, :], dim=1)
        return d * (y + v * leak[:, None]) + (1.0 - d) * v

    PRt = Vt
    for _ in range(n_iters):
        Y = _rowblock_product(Hr, sc, PRt, mesh, row_axis)
        PRt = ShardedTensor(mesh, Vt.spec, Vt.shape,
                            shard_map(step, mesh, PRt, Y, Vt, dg))
    return ShardedTensor(mesh, P(None, col_axis), (n, q),
                         shard_map(lambda t: t.T.contiguous(), mesh, PRt))


def _rowblock_product(Hr: ShardedTensor, sc, Xt: ShardedTensor, mesh: Mesh,
                      row_axis: str) -> ShardedTensor:
    """``(H @ X).T`` for query rows ``Xt`` (Q, N) sharded ``P(col, None)``:
    per position one K2 launch of its (N/R, N) row block with its column's
    (Q/C, N) queries, the int8 row scales after it, and one row-axis
    all_gather re-assembling the (Q/C, N) sweep."""
    def sweep(h, x, s):
        y = fm.local_matmat(h, x)                          # (Q/C, N/R)
        return y if s is None else y * s[None, :]

    Y = fm.all_gather(shard_map(sweep, mesh, Hr, Xt, sc), mesh, row_axis,
                      dim=1)
    return ShardedTensor(mesh, Xt.spec, Xt.shape, Y)


def ppr_matmat_dense(H, X: torch.Tensor, mesh: Mesh, row_axis: str = "data",
                     col_axis: str = "model", scales=None) -> torch.Tensor:
    """``H @ X`` for a global (N, Q) block of queries on the row-block
    layout of :func:`ppr_distributed_dense` (the landmark push's product):
    Q is padded to the mesh column count, the queries are spread over the
    mesh columns, and the product comes back as a global (N, Q) tensor on
    ``X``'s device."""
    Hr = fm._as(H, mesh, P(row_axis, None))
    n, q = X.shape
    sc = None if scales is None else fm._as(scales, mesh, P(row_axis))
    cols = mesh.shape[col_axis]
    Xt = torch.zeros((-(-q // cols) * cols, n), dtype=torch.float32,
                     device=X.device)
    Xt[:q] = X.T
    Y = _rowblock_product(Hr, sc, fm._as(Xt, mesh, P(col_axis, None)), mesh,
                          row_axis)
    return Y.full(X.device)[:q].T


def ppr_distributed_sparse(ell_data, ell_idx, dang, V, mesh: Mesh,
                           n_iters: int = 100, d: float = 0.85,
                           axes: tuple[str, ...] = ("data", "model"),
                           scales=None) -> ShardedTensor:
    """Batched PPR over replicated ELL operands, (N, Q) sharded over the
    query axis on the flattened mesh: each position propagates its own
    query block end to end with no per-iteration collective."""
    data = fm._as(ell_data, mesh, P())
    idx = fm._as(ell_idx, mesh, P())
    n = data.shape[0]
    dg = _replicated(dang, mesh, n)
    sc = None if scales is None else fm._as(scales, mesh, P())
    Vs = fm._as(upcast_f32(_global(V)), mesh, P(None, axes))

    def propagate(data_full, idx_full, dang_full, v_blk, scale_full):
        data_full = upcast_f32(data_full)
        PR = v_blk
        for _ in range(n_iters):
            leak = torch.sum(PR * dang_full[:, None], dim=0)
            Y = torch.sum(data_full[..., None] * PR[idx_full], dim=1)
            if scale_full is not None:
                Y = Y * scale_full[:, None]
            PR = d * (Y + v_blk * leak[None, :]) + (1.0 - d) * v_blk
        return PR

    return ShardedTensor(mesh, Vs.spec, Vs.shape, shard_map(
        propagate, mesh, data, idx, dg, Vs, sc))


def make_sharded_inputs_dense(H, mesh: Mesh, row_axis: str = "data",
                              col_axis: str = "model") -> ShardedTensor:
    """Host -> device placement of a dense H in the fabric layout."""
    return ShardedTensor.from_global(torch.as_tensor(H), mesh,
                                     P(row_axis, col_axis))


# --------------------------------------------------------------------------- #
# split-ELL row blocks of unequal size (flattened mesh, ell_split_sharded)    #
# --------------------------------------------------------------------------- #
def _spans(rows) -> tuple[list, list]:
    """The row span of every block and the slot of its leak part."""
    spans = list(zip(rows[:-1], rows[1:]))
    return spans, [(p, p + 1) for p in range(len(spans))]


def split_ell_start(x: torch.Tensor, dangs, rows, mesh: Mesh) -> tuple:
    """The state of :func:`split_ell_step` at the rank vector ``x`` (N,),
    in the layout's order: a replica of ``x`` on every position, then on
    every position the (P,) parts of its leak ``sum(x * dang)``, one per
    block, each summed on the block's position."""
    devs = mesh.device_list
    spans, slots = _spans(rows)
    xs = [x.to(dev) for dev in devs]
    parts = [torch.empty(len(devs), dtype=torch.float32, device=dev)
             for dev in devs]
    for p, (a, b) in enumerate(spans):
        parts[p][p] = torch.sum(xs[p][a:b] * dangs[p])
    fm.gather_blocks([(parts, slots)])
    return (*xs, *parts)


def split_ell_step(operands, metas, dangs, rows, mesh: Mesh, d: float,
                   metrics):
    """The ``ell_split_sharded`` step on the state ``(x_0 .. x_P-1, l_0 ..
    l_P-1)`` of :func:`split_ell_start`: on every position both passes of
    the split-ELL kernel over its block (``operands[p]``, ``metas[p]``,
    ``dangs[p]``, rows ``rows[p]:rows[p + 1]`` of H, columns into the whole
    vector) against its replica ``x_p`` and the leak's parts ``l_p``,
    written into its rows of a fresh vector and its slot of fresh parts;
    then, in the profiler range ``engine.step.exchange``, every block and
    every part copied to every other position (one
    :func:`~repro_torch.core.fabric_matvec.gather_blocks`, the part of a
    block on the streams of its block's copy).  Every position
    sums the parts in block order, so the replicas stay equal bit for bit.
    Counts ``engine.sharded_steps`` and the bytes copied in
    ``engine.exchange_bytes`` on the host, with no sync."""
    devs = mesh.device_list
    n = int(rows[-1])
    spans, slots = _spans(rows)
    steps = metrics.counter("engine.sharded_steps")
    moved = metrics.counter("engine.exchange_bytes")

    def ranges(part):
        return metrics.annotate(f"engine.step.{part}")

    def step(state):
        xs, parts = state[:len(devs)], state[len(devs):]
        new = [torch.empty(n, dtype=torch.float32, device=dev)
               for dev in devs]
        new_parts = [torch.empty(len(devs), dtype=torch.float32, device=dev)
                     for dev in devs]
        for p, (a, b) in enumerate(spans):
            ell_step(operands[p], metas[p], dangs[p], xs[p], parts[p], d=d,
                     annotate=ranges, out=(new[p][a:b], new_parts[p][p:p + 1]))
        with metrics.annotate("engine.step.exchange"):
            nbytes = fm.gather_blocks([(new, spans), (new_parts, slots)])
        steps.inc()
        moved.inc(nbytes)
        return (*new, *new_parts)

    return step
