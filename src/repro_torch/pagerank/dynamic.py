"""Incremental PageRank over a streaming graph.

The PyTorch counterpart of ``repro.pagerank.dynamic`` for the single-device
tiers.  :class:`DynamicPageRankEngine` extends
:class:`~repro_torch.pagerank.engine.PageRankEngine` with an ``update()``
path that folds a :class:`~repro_torch.graph.delta.GraphDelta` into the
*prepared* device layouts and re-solves from the previous rank vector.

Three refresh strategies, picked automatically by delta size:

* **push** — a Gauss–Southwell frontier sweep: the residual ``r = A·x + b
  − x`` of the *new* operator at the *old* ranks is nonzero only near the
  changed edges; every sweep pushes the frontier mask ``|r| ≥ tol/n`` into
  the iterate and refreshes the residual, until ``‖r‖₁ ≤ tol``.  It runs
  on the port's chunked masked tolerance loop
  (:mod:`repro_torch.obs.trace`): the JAX sweep count, one host sync per
  ``CHUNK`` sweeps, whole chunks issued.  On ``fused_dense`` each sweep is
  one launch of the streaming kernel (K2) at one query, on ``bsr`` one of
  the BSR kernel (K3).
* **warm** — the layouts are patched and ``run_tol`` re-runs from ``x0 =``
  the previous ranks (on ``fused_dense`` through the fused step, K1).
* **rebuild** — deltas above ``rebuild_frac`` of the edge set, or that the
  layout cannot hold (a SELL row outgrowing its slack, a BSR insert in a
  block outside the prepared structure), rebuild the layout and still
  warm-start the solve.  int8 layouts always rebuild: a changed row needs
  a new quantization scale.

Layout patches, one per tier:

* **dense / fused_dense** — the changed transition *columns* are
  recomputed on the host and written in one scatter (the padded fused
  layout keeps its padding; the dangling mask is patched alongside).
* **ell** — the dynamic ``ell`` tier is a two-bucket sliced ELLPACK
  (SELL): rows permuted into a low tier (per-row budget ≈ the 90th degree
  percentile + slack) and a hub tier, each with capacity slack, so small
  deltas change no array shape; the affected rows are rewritten.
* **bsr** — value patches inside the *existing* block structure: a host
  (block-row, block-col) -> slot map, in ``BSRMatrix.from_dense``'s
  row-major block order, addresses every changed entry as ``blocks[br,
  slot, r % bs, c % bs]``.  Deletes zero entries in place; only an insert
  that needs a new block escalates to a rebuild.
* **ell_sharded** — the full-K row layout is built with ``maxdeg + slack``
  columns of headroom, and every affected row is rewritten in the shard
  that owns it; the replicated dangling mask is patched on every position
  and the PPR copy of the layout is dropped (placed again at first use).
* **dense_sharded** — each changed column is written into the shards of
  its mesh column (the padded tail stays zero), the dangling mask beside
  it, and the row-block PPR copy is dropped.

The push runs shard-local on the sharded tiers
(:func:`repro_torch.pagerank.distributed.push_distributed_tol` /
``push_distributed_sparse_tol``), on the same chunked tolerance loop; the
auto policy picks the same strategies sharded as on one device.

Each patch writes into a copy of the array it changes (as the JAX
package's functional scatters do), never into the array the engine holds:
an update that fails part way restores the engine's attributes and so its
whole state (the all-or-nothing rollback).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.fabric_matvec import ShardedTensor
from repro_torch.graph import transition as tr
from repro_torch.graph.delta import GraphDelta, edge_keys
from repro_torch.kernels.common import upcast_f32
from repro_torch.obs.registry import NullRegistry
from repro_torch.obs.trace import SolveTrace
from repro_torch.pagerank.engine import (TIERS, PageRankEngine, Tier,
                                         _edge_set)
from repro_torch.pagerank.landmarks import _key_slice
from repro_torch.pagerank.precision import quantize_rows
from repro_torch.pagerank.resilience import EngineSnapshot, make_solve_info
from repro_torch.pagerank.steps import frontier_push

__all__ = ["DynamicPageRankEngine", "UpdateInfo", "PATCHABLE_BACKENDS"]

_QUIET = NullRegistry()

# every tier patches in place (the sharded ones in the shards that own the
# change); capacity overflow still escalates to rebuild, and int8 always
# rebuilds (coerced_from records it)
PATCHABLE_BACKENDS = ("dense", "ell", "fused_dense", "bsr", "dense_sharded",
                      "ell_sharded")


@dataclasses.dataclass(frozen=True)
class UpdateInfo:
    """What one ``update()`` actually did."""
    strategy: str                 # "push" | "warm" | "rebuild" | "noop"
    n_inserted: int               # effective directed inserts
    n_deleted: int                # effective directed deletes
    cols_patched: int
    rows_patched: int
    iters: int                    # push sweeps or warm/rebuild iterations
    residual: float
    overflow: bool                # layout capacity exceeded: a SELL row
    #                               outgrew its slack, or a BSR insert
    #                               needs a block outside the structure
    # convergence-watchdog verdict of the refresh solve
    diverged: bool = False
    nonfinite: bool = False
    # the auto policy wanted this strategy but the layout forced a rebuild
    # (``strategy`` always reports what actually ran)
    coerced_from: str | None = None

    @property
    def healthy(self) -> bool:
        """The refresh solve's rank vector is trustworthy (no watchdog
        abort)."""
        return not (self.diverged or self.nonfinite)


def _write_index(st: ShardedTensor, dim: int, index: np.ndarray,
                 values: np.ndarray) -> ShardedTensor:
    """A copy of ``st`` with ``st[..., index, ...] = values`` along
    ``dim`` (``values`` holds the global extent of the other dims): each
    shard holding some of ``index`` is copied and written on its device,
    the others are kept as they are."""
    index = np.asarray(index, np.int64)
    vals = torch.from_numpy(np.ascontiguousarray(values))
    shards, done = [], {}
    for p, (t, dev) in enumerate(zip(st.shards, st.mesh.device_list)):
        key = (dev, id(t))
        if key not in done:
            rng = st.ranges(p)
            lo, hi = rng[dim]
            sel = np.flatnonzero((index >= lo) & (index < hi))
            if len(sel) == 0:
                done[key] = t
            else:
                v = vals.index_select(dim, torch.from_numpy(sel))
                if v.dim() == 2:
                    a, b = rng[1 - dim]
                    v = v.narrow(1 - dim, a, b - a)
                local = torch.from_numpy(index[sel] - lo).to(dev)
                new = t.clone()
                if dim == 0:
                    new[local] = v.to(device=dev, dtype=t.dtype)
                else:
                    new[:, local] = v.to(device=dev, dtype=t.dtype)
                done[key] = new
        shards.append(done[key])
    return ShardedTensor(st.mesh, st.spec, st.shape, shards)


def _in_sorted(sorted_keys: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """Membership of ``vals`` in a sorted unique key array."""
    if len(vals) == 0 or len(sorted_keys) == 0:
        return np.zeros(len(vals), bool)
    idx = np.searchsorted(sorted_keys, vals)
    idx = np.minimum(idx, len(sorted_keys) - 1)
    return sorted_keys[idx] == vals


class SellTier(Tier):
    """The dynamic engine's patchable ``ell`` layout: a two-bucket sliced
    ELLPACK.  Rows are permuted into a low tier (per-row budget the 90th
    degree percentile + slack) and a hub tier, each with capacity slack,
    so small deltas change no array shape; a product is two dense gathers
    and no ``index_add_``.  Built on the host, in no phase span."""

    def build(self, e, src, dst, edges):
        n = e.n
        e._dang = e._put(tr.dangling_mask(src, n).astype(np.float32))
        csr = tr.build_transition_csr(src, dst, n, device="cpu")
        counts = np.diff(csr.indptr.numpy())
        # tier threshold at the 90th degree percentile; capacities sit
        # ``slack`` (low) / >= 16 rounded to 32 (high) ABOVE the largest
        # row they hold, so every row has patch headroom — a row outgrowing
        # its tier is what escalates update() to the rebuild path
        thresh = max(4, int(np.percentile(counts, 90)) if len(counts)
                     else 0)
        k_low = thresh + e._slack
        maxdeg = int(counts.max()) if len(counts) else 0
        k_high = -(-(max(maxdeg, k_low) + max(16, e._slack)) // 32) * 32
        high = counts > thresh
        low_rows = np.where(~high)[0]
        high_rows = np.where(high)[0]
        perm = np.concatenate([low_rows, high_rows])
        e._sell_k = (k_low, k_high)
        e._sell_pos = np.empty(n, np.int64)          # row -> index in tier
        e._sell_pos[low_rows] = np.arange(len(low_rows))
        e._sell_pos[high_rows] = np.arange(len(high_rows))
        e._sell_high = high
        inv = np.empty(n, np.int64)
        inv[perm] = np.arange(n)
        dl = np.zeros((len(low_rows), k_low), np.float32)
        il = np.zeros((len(low_rows), k_low), np.int32)
        dh = np.zeros((len(high_rows), k_high), np.float32)
        ih = np.zeros((len(high_rows), k_high), np.int32)
        rows, pos = csr.row_positions()
        cols = csr.indices.numpy()
        vals = csr.data.numpy()
        in_low = ~high[rows]
        r_l = e._sell_pos[rows[in_low]]
        dl[r_l, pos[in_low]] = vals[in_low]
        il[r_l, pos[in_low]] = cols[in_low]
        r_h = e._sell_pos[rows[~in_low]]
        dh[r_h, pos[~in_low]] = vals[~in_low]
        ih[r_h, pos[~in_low]] = cols[~in_low]
        inv = e._put(inv.astype(np.int32))
        if e.precision == "int8":
            # per-row scales per tier, appended to the operand tuple
            (ql, sl), (qh, sh) = quantize_rows(dl), quantize_rows(dh)
            e._operands = (e._put(ql), e._put(il), e._put(qh), e._put(ih),
                           inv, e._put(sl), e._put(sh))
        else:
            dtype = e.storage_dtype
            e._operands = (e._put(dl).to(dtype), e._put(il),
                           e._put(dh).to(dtype), e._put(ih), inv)
        e.layout = (f"sell(k_low={k_low}, k_high={k_high}, "
                    f"n_high={len(high_rows)}, slack={e._slack})")

    def product(self, ops, x, metrics=_QUIET):
        dl, il, dh, ih, inv = ops[:5]
        sl, sh = ops[5:7] if len(ops) == 7 else (None, None)
        dl, dh = upcast_f32(dl), upcast_f32(dh)
        vec = x.dim() == 1
        with metrics.annotate("engine.step.rows"):
            yl = torch.sum((dl if vec else dl[..., None]) * x[il], dim=1)
            yh = torch.sum((dh if vec else dh[..., None]) * x[ih], dim=1)
        return torch.cat([self.scale_rows(yl, sl), self.scale_rows(yh, sh)],
                         dim=0)[inv]


# --------------------------------------------------------------------------- #
# Gauss–Southwell push: frontier-masked residual sweeps                       #
# --------------------------------------------------------------------------- #
def _push_tol(e, tol, x0, *, max_pushes: int, trace: bool = False):
    """The push on one device: :func:`frontier_push` on the tier's damped
    affine operator ``Ab(x) = A·x + b``, in the tier's layout, to the L1
    residual ``tol`` (a float32 0-dim tensor).  Returns ``(x, iters,
    residual, grow, ring)``."""
    Ab, x0, ranks = e._tier.push_operator(e, x0)
    x, _, *out = frontier_push(Ab, x0, tol, e.n, max_pushes, trace=trace,
                               residual=lambda r: torch.sum(torch.abs(r)))
    return ranks(x), *out


def _push_fused(e, tol, x0, *, max_pushes: int, trace: bool = False):
    """The push of the fused tier, one launch of the streaming kernel per
    sweep (plus one for the start residual); a name of its own, so that a
    fault can be planted in that tier's push alone."""
    return _push_tol(e, tol, x0, max_pushes=max_pushes, trace=trace)


# --------------------------------------------------------------------------- #
# the dynamic engine                                                          #
# --------------------------------------------------------------------------- #
class DynamicPageRankEngine(PageRankEngine):
    """A :class:`PageRankEngine` over a *live* graph.

    Same constructor, same ``run`` / ``run_tol`` / ``ppr`` surface (the
    ``ell`` backend swaps in the patchable SELL layout; ``bsr`` keeps a
    host block-structure map for in-block value patches), plus:

    * ``update(delta)`` — fold a :class:`~repro_torch.graph.delta
      .GraphDelta` into the prepared layouts and refresh the ranks;
      returns ``(pr, UpdateInfo)``.  Strategy is picked automatically
      (push for at most ``push_max_changed`` changed edges, a warm-started
      ``run_tol`` for larger patchable deltas, a rebuild beyond
      ``rebuild_frac`` of the edge set or when the layout cannot hold the
      delta); ``strategy=`` forces one.
    * ``ranks`` — the latest solved rank vector (refreshed by every
      ``run`` / ``run_tol`` / ``update``), what the serving layer reads.
    * ``snapshot`` / ``restore`` / ``rebuild_and_solve`` — host snapshots
      and the rebuild from the authoritative host edge set.

    ``update``'s default ``tol=1e-6`` keeps incremental and from-scratch
    ranks within 1e-5 (L1) of each other.
    """
    _TIERS = {**TIERS, "ell": SellTier()}

    def __init__(self, src: np.ndarray, dst: np.ndarray, n: int, *,
                 slack: int = 8, push_max_changed: int = 64,
                 rebuild_frac: float = 0.05, symmetric: bool = True, **kw):
        self._slack = int(slack)
        self.push_max_changed = int(push_max_changed)
        self.rebuild_frac = float(rebuild_frac)
        self.symmetric = bool(symmetric)
        self._pr: torch.Tensor | None = None
        super().__init__(src, dst, n, **kw)
        # the parent's edge set reversed: sorted dst * n + src
        self._rkeys = _edge_set(self._keys % self.n, self._keys // self.n,
                                self.n, self.device).keys

    # --------------------------- layout prep --------------------------- #
    def _prepare_layout(self, src: np.ndarray, dst: np.ndarray,
                        edges=None) -> None:
        if self.backend == "ell_sharded":
            # patch headroom: the engine takes ``_ell_k`` as a minimum row
            # capacity, so maxdeg + slack keeps every shape fixed across
            # small deltas; a row outgrowing it escalates to a rebuild
            maxdeg = int(self._indeg.max()) if len(self._indeg) else 0
            self._ell_k = maxdeg + max(4, self._slack)
        super()._prepare_layout(src, dst, edges)
        if self.backend == "bsr":
            self._bsr_index(src, dst)

    def _bsr_index(self, src: np.ndarray, dst: np.ndarray) -> None:
        """Host map of the prepared BSR block structure: sorted int64
        ``(block-row * nb_c + block-col)`` keys plus each block's slot
        within its block-row.  ``BSRMatrix.from_dense`` lays blocks out in
        row-major order with slot = rank since the row start, so the map
        is reconstructible from the edge set alone.  Patches never change
        the structure, so the map stays valid until the next
        ``_prepare_layout``."""
        bsr = self._operands[0]
        bs = int(bsr.block_size)
        self._bsr_nbc = -(-self.n // bs)
        pairs = np.unique((np.asarray(dst, np.int64) // bs)
                          * np.int64(self._bsr_nbc)
                          + np.asarray(src, np.int64) // bs)
        brows = pairs // self._bsr_nbc
        counts = np.bincount(brows, minlength=bsr.blocks.shape[0])
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        self._bsr_pairs = pairs
        self._bsr_slots = (np.arange(len(pairs))
                           - starts[brows]).astype(np.int64)

    # ----------------------- solver front doors ------------------------ #
    @property
    def ranks(self) -> torch.Tensor | None:
        """Latest solved rank vector (``None`` until the first solve)."""
        return self._pr

    def run(self, n_iters: int = 100) -> torch.Tensor:
        pr = super().run(n_iters)
        self._pr = pr
        return pr

    def run_tol(self, tol: float = 1e-6, max_iters: int = 1000,
                x0: np.ndarray | torch.Tensor | None = None, **kw):
        out = super().run_tol(tol, max_iters, x0, **kw)
        self._pr = out[0]
        return out

    # ------------------- snapshots & recovery hooks -------------------- #
    def snapshot(self) -> EngineSnapshot:
        """Host copy of everything needed to rebuild this engine: the
        sorted edge-key set and the latest ranks (device layouts are
        derived state, rebuilt by :meth:`restore`)."""
        return EngineSnapshot(
            keys=np.asarray(self._keys, np.int64).copy(),
            ranks=(None if self._pr is None
                   else self._pr.detach().cpu().numpy().astype(
                       np.float32).copy()),
            residual=0.0)

    def restore(self, snap: EngineSnapshot) -> None:
        """Roll the engine back to ``snap``: rebuild the host bookkeeping
        and every prepared device layout from its edge keys and reinstate
        its ranks."""
        n = self.n
        keys = np.sort(np.asarray(snap.keys, np.int64))
        src = (keys // n).astype(np.int32)
        dst = (keys % n).astype(np.int32)
        self._keys = keys
        self._rkeys = np.sort((keys % n) * np.int64(n) + keys // n)
        self._outdeg = np.bincount(src, minlength=n).astype(np.int64)
        self._indeg = np.bincount(dst, minlength=n).astype(np.int64)
        self.n_edges = len(keys)
        self.density = self.n_edges / float(n * n)
        self._prepare_layout(src, dst)
        self._pr = (None if snap.ranks is None
                    else self._put(np.asarray(snap.ranks, np.float32)))

    def rebuild_and_solve(self, tol: float = 1e-6, max_iters: int = 1000,
                          x0: np.ndarray | torch.Tensor | None = None, **kw):
        """Rebuild every prepared device layout from the (authoritative)
        host edge keys and re-solve, warm-started from ``x0``.  Returns the
        ``run_tol`` result."""
        with self.metrics.span("rebuild", backend=self.backend):
            self._rebuild()
        return self.run_tol(tol=tol, max_iters=max_iters, x0=x0, **kw)

    # --------------------------- the update ---------------------------- #
    def update(self, delta: GraphDelta, *, tol: float = 1e-6,
               max_iters: int = 1000, strategy: str = "auto"
               ) -> tuple[torch.Tensor, UpdateInfo]:
        """Fold ``delta`` into the prepared layouts and refresh the ranks.

        Returns ``(pr, UpdateInfo)``.  ``strategy``: ``"auto"`` (the
        policy by delta size), or force ``"push"`` / ``"warm"`` /
        ``"rebuild"``.  Every update records an ``update.<strategy>``
        counter, the ``span.update`` latency, the ``update.patch`` /
        ``update.rebuild`` layout timings and one ``update`` event; a
        coercion to rebuild adds ``update.coerced`` and an
        ``update_coerced`` event."""
        with self.metrics.span("update"):
            pr, info = self._update(delta, tol=tol, max_iters=max_iters,
                                    strategy=strategy)
        self.metrics.counter(f"update.{info.strategy}").inc()
        if info.coerced_from is not None:
            self.metrics.counter("update.coerced").inc()
            self.metrics.event("update_coerced",
                               requested=info.coerced_from,
                               ran=info.strategy, overflow=info.overflow)
        self.metrics.event("update", strategy=info.strategy,
                           n_ins=info.n_inserted, n_del=info.n_deleted,
                           iters=info.iters, residual=info.residual,
                           overflow=info.overflow, healthy=info.healthy)
        return pr, info

    def _update(self, delta: GraphDelta, *, tol: float, max_iters: int,
                strategy: str) -> tuple[torch.Tensor, UpdateInfo]:
        if strategy not in ("auto", "push", "warm", "rebuild"):
            raise ValueError(f"unknown strategy {strategy!r}")
        plan = self._plan(delta)
        if plan is None:
            if self._pr is None:
                self.run_tol(tol=tol, max_iters=max_iters)
            return self._pr, UpdateInfo("noop", 0, 0, 0, 0, 0, 0.0, False)
        # validate BEFORE committing any bookkeeping, so a raise leaves the
        # engine exactly as it was.  int8 layouts never patch: a changed
        # row needs a new quantization scale (a rebuild in disguise)
        patchable = (self.backend in PATCHABLE_BACKENDS
                     and not plan["overflow"]
                     and self.precision != "int8")
        coerced_from = None
        if strategy == "auto":
            if (plan["n_changed"] > self.rebuild_frac
                    * max(plan["n_edges_before"], 1)):
                strategy = "rebuild"
            else:
                want = ("push" if self._pr is not None
                        and plan["n_changed"] <= self.push_max_changed
                        else "warm")
                if patchable:
                    strategy = want
                else:
                    strategy, coerced_from = "rebuild", want
        elif strategy in ("push", "warm") and not patchable:
            raise ValueError(
                f"strategy {strategy!r} needs a patchable layout "
                f"(backend in {PATCHABLE_BACKENDS}, no capacity overflow "
                f"or BSR block-structure change, precision != 'int8')")
        elif strategy == "push" and self._pr is None:
            raise ValueError("push needs previous ranks; run/run_tol first")

        # apply atomically: every field is replaced, never mutated in place
        # (the patches write into copies), so restoring the attribute dict
        # rolls the whole engine back if the patch or the solve fails
        state = dict(self.__dict__)
        try:
            self._commit(plan)
            if strategy == "rebuild":
                with self.metrics.span("update.rebuild"):
                    self._rebuild()
                rows = cols = 0
            else:
                with self.metrics.span("update.patch"):
                    rows, cols = self._patch(plan)
            x0 = self._pr
            if strategy == "push":
                with self.metrics.span("solve", backend=self.backend,
                                       strategy="push"):
                    pr, iters, res, grow, ring = self._push(
                        x0, tol, max_iters)
                    self.last_solve_info = make_solve_info(
                        iters, res, grow, tol=tol, max_iters=max_iters,
                        trace=(SolveTrace(ring, iters)
                               if ring is not None else None))
                self.metrics.counter("engine.solves").inc()
                self.metrics.counter(
                    f"engine.solve.{self.last_solve_info.status}").inc()
                self._pr = pr
            else:
                pr, iters, res = self.run_tol(tol=tol, max_iters=max_iters,
                                              x0=x0)
        except BaseException:
            self.__dict__.clear()
            self.__dict__.update(state)
            raise
        solve = self.last_solve_info
        return pr, UpdateInfo(strategy, plan["n_ins"], plan["n_del"],
                              cols, rows, int(iters), float(res),
                              bool(plan["overflow"]),
                              diverged=solve.diverged,
                              nonfinite=solve.nonfinite,
                              coerced_from=coerced_from)

    # ------------------------ host bookkeeping ------------------------- #
    def _plan(self, delta: GraphDelta) -> dict | None:
        """Canonicalize the delta against the current edge set and compute
        the patch plan (affected rows/columns, post-delta key sets and
        degrees, overflow flag) WITHOUT touching any engine state — or
        return ``None`` for an effective no-op.  ``_commit`` applies it."""
        n = self.n
        delta = delta.canonical(n, symmetric=self.symmetric)
        ins = edge_keys(delta.insert_src, delta.insert_dst, n)
        dels = edge_keys(delta.delete_src, delta.delete_dst, n)
        eff_ins = ins[~_in_sorted(self._keys, ins)]
        eff_del = dels[_in_sorted(self._keys, dels)]
        eff_del = eff_del[~_in_sorted(ins, eff_del)]   # delete-then-insert
        changed = np.concatenate([eff_ins, eff_del])
        if len(changed) == 0:
            return None
        new_keys = np.union1d(
            np.setdiff1d(self._keys, eff_del, assume_unique=True), eff_ins)

        def rkey(k):
            return (k % n) * np.int64(n) + k // n

        new_rkeys = np.union1d(
            np.setdiff1d(self._rkeys, rkey(eff_del), assume_unique=True),
            rkey(eff_ins))
        outdeg, indeg = self._outdeg.copy(), self._indeg.copy()
        np.add.at(outdeg, (eff_ins // n), 1)
        np.add.at(outdeg, (eff_del // n), -1)
        np.add.at(indeg, (eff_ins % n), 1)
        np.add.at(indeg, (eff_del % n), -1)

        cols = np.unique(changed // n)
        rows = np.empty(0, np.int64)
        overflow = False
        extra: dict = {}
        if self.backend in ("ell", "ell_sharded"):
            # only the row-major layouts patch rows (dense tiers rewrite
            # whole columns, BSR individual block entries)
            parts = [changed % n]
            for u in cols:
                parts.append(_key_slice(self._keys, int(u), n))
                parts.append(_key_slice(new_keys, int(u), n))
            rows = np.unique(np.concatenate(parts))
            if self.backend == "ell":
                k_low, k_high = self._sell_k
                cap = np.where(self._sell_high[rows], k_high, k_low)
            else:           # full-K sharded rows: one capacity for all
                cap = self._operands[0].shape[1]
            overflow = bool((indeg[rows] > cap).any())
        elif self.backend == "bsr":
            # per changed column its old and new out-neighbor sets; only
            # the post-delta sets can need a block the structure does not
            # hold — the structure change that forces a rebuild
            bs = int(self._operands[0].block_size)
            old_nbrs = [_key_slice(self._keys, int(u), n) for u in cols]
            new_nbrs = [_key_slice(new_keys, int(u), n) for u in cols]
            need = [(vv // bs) * np.int64(self._bsr_nbc) + int(u) // bs
                    for u, vv in zip(cols, new_nbrs) if len(vv)]
            if need:
                need = np.unique(np.concatenate(need))
                overflow = not bool(_in_sorted(self._bsr_pairs, need).all())
            extra = {"bsr_old": old_nbrs, "bsr_new": new_nbrs}
        return {"cols": cols, "rows": rows, "overflow": overflow,
                "n_ins": len(eff_ins), "n_del": len(eff_del),
                "n_changed": len(changed),
                "n_edges_before": len(self._keys),
                "keys": new_keys, "rkeys": new_rkeys,
                "outdeg": outdeg, "indeg": indeg, **extra}

    def _commit(self, plan: dict) -> None:
        """Swap in the post-delta bookkeeping computed by ``_plan``."""
        self._keys = plan["keys"]
        self._rkeys = plan["rkeys"]
        self._outdeg = plan["outdeg"]
        self._indeg = plan["indeg"]
        self.n_edges = len(self._keys)
        self.density = self.n_edges / float(self.n * self.n)

    def _rebuild(self) -> None:
        src = (self._keys // self.n).astype(np.int32)
        dst = (self._keys % self.n).astype(np.int32)
        self._prepare_layout(src, dst)

    # -------------------------- layout patches ------------------------- #
    def _column(self, u: int, fix_dangling: bool) -> np.ndarray:
        """Recompute transition column ``u`` from the current edge set."""
        col = np.zeros(self.n, np.float32)
        nbrs = _key_slice(self._keys, u, self.n)
        if len(nbrs):
            col[nbrs] = 1.0 / len(nbrs)
        elif fix_dangling:
            col[:] = 1.0 / self.n
        return col

    def _columns(self, cols: np.ndarray, fix_dangling: bool,
                 dtype: torch.dtype) -> torch.Tensor:
        """The recomputed columns as an (n, C) device tensor in the
        layout's storage dtype (never widening the prepared array)."""
        mat = np.stack([self._column(int(u), fix_dangling) for u in cols],
                       axis=1)
        return self._put(mat).to(dtype)

    def _patch(self, plan: dict) -> tuple[int, int]:
        """Write the recomputed rows/columns into copies of the prepared
        arrays.  Returns ``(rows_patched, cols_patched)``."""
        n = self.n
        cols = plan["cols"]
        if self.mesh is not None:
            return self._patch_sharded(plan)
        ci = self._put(cols)
        flags = self._put((self._outdeg[cols] == 0).astype(np.float32))
        dang = self._dang.clone()
        dang[ci] = flags
        self._dang = dang
        if self.backend == "dense":
            # the f32 dense operand is dangling-fixed, the reduced ones
            # unfixed
            H = self._operands[0].clone()
            H[:, ci] = self._columns(cols, self.precision == "f32", H.dtype)
            self._operands = (H,)
            return 0, len(cols)
        if self.backend == "bsr":
            self._patch_bsr(plan)
            return 0, len(cols)
        if self.backend == "fused_dense":
            Hp, dangp = (o.clone() for o in self._operands)
            Hp[:n, ci] = self._columns(cols, False, Hp.dtype)
            dangp[0, ci] = flags
            self._operands = (Hp, dangp)
            return 0, len(cols)
        # ell: rewrite every affected SELL row in its tier
        rows = plan["rows"]
        k_low, k_high = self._sell_k
        dl, il, dh, ih, inv = (o.clone() if i < 4 else o
                               for i, o in enumerate(self._operands[:5]))
        for tier, k, (data_op, idx_op) in ((False, k_low, (dl, il)),
                                           (True, k_high, (dh, ih))):
            sel = rows[self._sell_high[rows] == tier]
            if len(sel) == 0:
                continue
            data, idx = self._rebuild_rows(sel, k)
            pos = self._put(self._sell_pos[sel])
            data_op[pos] = self._put(data).to(data_op.dtype)
            idx_op[pos] = self._put(idx)
        self._operands = (dl, il, dh, ih, inv)
        return len(rows), len(cols)

    def _patch_sharded(self, plan: dict) -> tuple[int, int]:
        """The sharded tiers' patches, written into copies of the shards
        that hold the change; the PPR copy of the layout goes stale and is
        dropped."""
        cols = plan["cols"]
        self._dang = _write_index(
            self._dang, 0, cols, (self._outdeg[cols] == 0).astype(np.float32))
        self._ppr_operands = self._ppr_scales = None
        if self.backend == "dense_sharded":
            mat = np.zeros((self._n_pad, len(cols)), np.float32)
            mat[:self.n] = np.stack([self._column(int(u), False)
                                     for u in cols], axis=1)
            self._operands = (_write_index(self._operands[0], 1, cols, mat),)
            return 0, len(cols)
        rows = plan["rows"]
        data_op, idx_op = self._operands
        data, idx = self._rebuild_rows(rows, int(data_op.shape[1]))
        self._operands = (_write_index(data_op, 0, rows, data),
                          _write_index(idx_op, 0, rows, idx))
        return len(rows), len(cols)

    def _patch_bsr(self, plan: dict) -> None:
        """Rewrite every changed entry inside the existing BSR block
        structure with one scatter.  For each changed column ``u`` the
        union of its old and new out-neighbors is touched: entries in
        ``new`` get the recomputed ``1/outdeg`` value, entries only in
        ``old`` are zeroed in place (their block stays; padded slots
        already accumulate zeros).  ``_plan`` guaranteed every touched
        block exists, so the host slot map resolves every coordinate."""
        bsr = self._operands[0]
        bs = int(bsr.block_size)
        parts = []
        for u, old, new in zip(plan["cols"], plan["bsr_old"],
                               plan["bsr_new"]):
            vs = np.union1d(old, new)
            if len(vs) == 0:
                continue
            val = np.zeros(len(vs), np.float32)
            if len(new):
                val[_in_sorted(new, vs)] = 1.0 / len(new)
            key = (vs // bs) * np.int64(self._bsr_nbc) + int(u) // bs
            slot = self._bsr_slots[np.searchsorted(self._bsr_pairs, key)]
            parts.append((vs // bs, slot, vs % bs,
                          np.full(len(vs), int(u) % bs, np.int64), val))
        if not parts:
            return
        br, sl, lr, lc, vals = (np.concatenate(a) for a in zip(*parts))
        blocks = bsr.blocks.clone()
        blocks[self._put(br), self._put(sl), self._put(lr),
               self._put(lc)] = self._put(vals).to(blocks.dtype)
        self._operands = (dataclasses.replace(bsr, blocks=blocks),)

    def _rebuild_rows(self, sel: np.ndarray, k: int
                      ) -> tuple[np.ndarray, np.ndarray]:
        """Recompute the SELL rows ``sel`` (width ``k``) from the current
        edge set: one vectorized slice-gather over the sorted reverse keys
        yields every (row, slot, col, val) at once."""
        n = self.n
        sel64 = sel.astype(np.int64)
        lo = np.searchsorted(self._rkeys, sel64 * n)
        hi = np.searchsorted(self._rkeys, (sel64 + 1) * n)
        cnt = hi - lo
        total = int(cnt.sum())
        data = np.zeros((len(sel), k), np.float32)
        idx = np.zeros((len(sel), k), np.int32)
        if total:
            starts = np.concatenate([[0], np.cumsum(cnt)[:-1]])
            slot = np.arange(total) - np.repeat(starts, cnt)
            flat = np.repeat(lo, cnt) + slot
            j = np.repeat(np.arange(len(sel)), cnt)
            u = self._rkeys[flat] % n
            data[j, slot] = 1.0 / self._outdeg[u]
            idx[j, slot] = u
        return data, idx

    # ------------------------------ push -------------------------------- #
    def _push(self, x0: torch.Tensor, tol: float, max_pushes: int,
              trace: bool = True):
        if self.mesh is not None:
            return self._tier.push(self, x0, tol, max_pushes, trace)
        tol_t = torch.tensor(tol, dtype=torch.float32).to(self.device)
        push = _push_fused if self._tier.fused else _push_tol
        return push(self, tol_t, x0, max_pushes=max_pushes, trace=trace)
