"""MELOPPR-style landmark/hub PPR precomputation for the serve path.

The PyTorch counterpart of ``repro.pagerank.landmarks`` for the
single-device tiers.  On the power-law graphs this system serves, a small
set of top-degree hubs dominates random walks: most of any
personalized-PageRank vector's mass flows through them.
:class:`LandmarkIndex` precomputes the PPR vectors of the top-degree hubs
ONCE (one batched (N, H) ``engine.ppr`` call, any backend / precision
tier) and answers arbitrary queries as a cheap linear combination of
those vectors plus a short, bounded Gauss–Southwell residual push.

**The algebra.**  With the dangling leak teleported to the seed
distribution ``v``, the PPR fixed point satisfies
``x = d·H·x + (d·dangᵀx + (1−d))·v``, i.e. ``x(v) = normalize(R·v)``
with the resolvent ``R = (I − dH)⁻¹``.  ``R`` is *linear* in ``v``, so:

* per hub ``h`` the engine's solved ``x(e_h)`` gives the resolvent
  column ``R·e_h = x(e_h) / c_h`` with ``c_h = (1−d) + d·dangᵀx(e_h)``;
* a query over seeds S combines columns: ``R·v = Σ_s w_s·R·e_s``;
* for a non-hub seed, ``R = I + d·R·H`` expands one step exactly:
  ``R·e_s = e_s + (d/outdeg(s))·Σ_{t∈out(s)} R·e_t`` — hub
  out-neighbors use their stored columns, tail out-neighbors truncate to
  ``R·e_t ≈ e_t`` (the MELOPPR decomposition).

The combination is only the **warm start**: the answer then runs a
frontier push on the batched personalized operator down to ``tol``
against the engine's operands, so stale or truncated hub vectors only
cost extra sweeps, never accuracy.  Any column whose residual bound is
not met within ``max_pushes`` sweeps falls back to an exact batched
``engine.ppr`` solve.

On the card the hub columns and the answers come to the host once per
build and once per answer (an explicit ``.cpu()``), never inside a loop.
On ``fused_dense`` every push sweep is one launch of the streaming kernel
for all (padded) queries, on ``bsr`` one launch of the BSR kernel, on
``dense_sharded`` one K2 launch per mesh position (its row block of H with
its mesh column's queries).  ``ell_sharded`` pushes against the engine's
replicated PPR copy of its layout.  The push runs in the port's chunked
tolerance loop (:mod:`repro_torch.obs.trace`): it stops at the same sweep
as the JAX ``while_loop`` and issues at most ``CHUNK - 1`` masked sweeps
after that, which change nothing.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.fabric_matvec import ShardedTensor
from repro_torch.obs.registry import default_registry
from repro_torch.pagerank.steps import frontier_push, seed_matrix

__all__ = ["LandmarkIndex"]


def _key_slice(sorted_keys: np.ndarray, u: int, n: int) -> np.ndarray:
    """Out-neighbors of ``u`` from the engine's sorted src*n+dst keys."""
    lo = np.searchsorted(sorted_keys, u * np.int64(n))
    hi = np.searchsorted(sorted_keys, (u + 1) * np.int64(n))
    return (sorted_keys[lo:hi] % n).astype(np.int64)


# --------------------------------------------------------------------------- #
# the index                                                                   #
# --------------------------------------------------------------------------- #
class LandmarkIndex:
    """Precomputed top-degree hub PPR + hub-combination query answering.

    ``build()`` solves the ``n_hubs`` top-(in+out)-degree hubs as ONE
    batched ``engine.ppr`` call and stores their resolvent columns on the
    host; ``answer(seed_sets)`` warm-starts from the hub combination and
    pushes the residual below ``tol`` (max per-column L1) in
    ``<= max_pushes`` masked sweeps, falling back to an exact batched
    solve for any column that missed the bound.  ``ensure(version)``
    rebuilds lazily — at first use and every ``rebuild_every`` graph
    versions.  The engine must carry its host edge bookkeeping
    (``_keys``, ``_outdeg``, ``_indeg``).
    """

    def __init__(self, engine, n_hubs: int = 64, tol: float = 1e-7,
                 max_pushes: int = 256, n_iters: int = 100,
                 rebuild_every: int = 16, metrics=None):
        if getattr(engine, "_outdeg", None) is None:
            raise ValueError("the engine carries no host edge bookkeeping "
                             "(_keys, _outdeg, _indeg); pass it to "
                             "layout_from_numpy")
        self.engine = engine
        self.n_hubs = int(n_hubs)
        self.tol = float(tol)
        self.max_pushes = int(max_pushes)
        self.n_iters = int(n_iters)
        self.rebuild_every = max(1, int(rebuild_every))
        self.metrics = (metrics if metrics is not None
                        else getattr(engine, "metrics", None)
                        or default_registry())
        self.hubs: np.ndarray | None = None       # (H,) sorted node ids
        self._Y: np.ndarray | None = None         # (n, H) resolvent columns
        self._hub_pos: np.ndarray | None = None   # node -> column, -1 = tail
        self.built_version: int | None = None

    # ------------------------------ build ------------------------------ #
    @property
    def built(self) -> bool:
        return self._Y is not None

    def ensure(self, version: int = 0) -> None:
        if (self.built_version is not None
                and abs(int(version) - self.built_version)
                < self.rebuild_every):
            return
        self.build(version)

    def build(self, version: int = 0) -> None:
        e = self.engine
        k = min(self.n_hubs, e.n)
        with self.metrics.span("landmarks.build", hubs=k):
            deg = e._outdeg + e._indeg
            hubs = np.sort(np.argpartition(deg, -k)[-k:].astype(np.int64))
            X = e.ppr([[int(h)] for h in hubs],
                      n_iters=self.n_iters).cpu().numpy().astype(np.float64)
            # x(e_h) = c_h · R e_h with c_h = (1−d) + d·dangᵀx(e_h): divide
            # the normalization back out so columns combine linearly
            dang = e._dang
            if isinstance(dang, ShardedTensor):
                dang = dang.full()
            dang = dang.cpu().numpy().astype(np.float64)[:e.n]
            c = (1.0 - e.d) + e.d * (dang @ X)                    # (H,)
            self._Y = (X / c[None, :]).astype(np.float32)
            self._hub_pos = np.full(e.n, -1, np.int64)
            self._hub_pos[hubs] = np.arange(k)
            self.hubs = hubs
            self.built_version = int(version)
        self.metrics.counter("landmarks.builds").inc()
        self.metrics.gauge("landmarks.hubs").set(k)

    # ---------------------------- estimate ----------------------------- #
    def estimate(self, seed_sets) -> tuple[np.ndarray, list[float]]:
        """Hub-combination warm starts: the (n, Q) estimate matrix (each
        column a distribution) plus the per-query fraction of one-step
        walk mass covered by stored hub columns (1.0 = fully hub-resolved,
        0.0 = pure truncation)."""
        e, d = self.engine, self.engine.d
        n = e.n
        Y, pos = self._Y, self._hub_pos
        X0 = np.zeros((n, len(seed_sets)), np.float32)
        coverage = []
        for q, seeds in enumerate(seed_sets):
            idx = np.asarray(seeds, np.int64).ravel()
            w = 1.0 / idx.size
            y = X0[:, q]
            covered = total = 0.0
            for s in idx:
                s = int(s)
                j = pos[s]
                if j >= 0:
                    y += w * Y[:, j]
                    covered += w
                    total += w
                    continue
                total += w
                y[s] += w
                outdeg = int(e._outdeg[s])
                if outdeg == 0:
                    covered += w          # dangling: R·e_s = e_s exactly
                    continue
                nbrs = _key_slice(e._keys, s, n)
                ws = w * d / outdeg
                hub_n = nbrs[pos[nbrs] >= 0]
                tail_n = nbrs[pos[nbrs] < 0]
                if hub_n.size:
                    y += ws * Y[:, pos[hub_n]].sum(axis=1)
                if tail_n.size:
                    np.add.at(y, tail_n, ws)
                covered += w * (1.0 - d) + ws * hub_n.size
            X0[:, q] = np.maximum(y, 0.0) / max(float(y.sum()), 1e-30)
            coverage.append(covered / max(total, 1e-30))
        return X0, coverage

    # ----------------------------- answer ------------------------------ #
    def answer(self, seed_sets, tol: float | None = None,
               max_pushes: int | None = None) -> tuple[np.ndarray, dict]:
        """Serve ``seed_sets``: hub-combination warm start, bounded
        residual push, exact-solve fallback for any column over the bound.
        Returns ``(X, info)`` with ``X`` the (n, Q) host PPR matrix
        (columns clipped + renormalized) and ``info`` recording sweeps /
        fallbacks / paths / hub coverage."""
        if not self.built:
            self.build(self.built_version or 0)
        tol = self.tol if tol is None else float(tol)
        max_pushes = (self.max_pushes if max_pushes is None
                      else int(max_pushes))
        e = self.engine
        q = len(seed_sets)
        with self.metrics.span("landmarks.answer", q=q):
            X0, coverage = self.estimate(seed_sets)
            V = seed_matrix(e.n, seed_sets)
            # pad the query axis to the next power of two with zero
            # columns (V=0 keeps X=R=0 identically, so pad columns never
            # move the max-residual exit test), as the JAX package does
            q_pad = 1 << max(0, q - 1).bit_length()
            if q_pad != q:
                V = np.pad(V, ((0, 0), (0, q_pad - q)))
                X0 = np.pad(X0, ((0, 0), (0, q_pad - q)))
            X, res_col, sweeps = self._push(V, X0, tol, max_pushes)
            X, res_col = X[:, :q], res_col[:q]
            # NaN-safe: a poisoned column fails `<= tol` and falls back
            bad = np.flatnonzero(~(res_col <= tol))
            if bad.size:
                exact = e.ppr([seed_sets[j] for j in bad],
                              n_iters=self.n_iters).cpu().numpy()
                X = np.array(X)         # write into a copy, as in JAX
                X[:, bad] = exact
                self.metrics.counter("landmarks.fallbacks").inc(
                    int(bad.size))
            X = np.clip(X, 0.0, None)
            X /= X.sum(axis=0, keepdims=True)
        self.metrics.counter("landmarks.queries").inc(q)
        bad_set = set(int(j) for j in bad)
        return X, {"sweeps": int(sweeps), "fallbacks": int(bad.size),
                   "paths": ["exact" if j in bad_set else "hub"
                             for j in range(q)],
                   "coverage": coverage}

    # ------------------------------ push ------------------------------- #
    def _push(self, V, X0, tol, max_pushes):
        """The batched residual push (:func:`frontier_push`) on the
        engine's personalized operator ``Ab(X) = d·(H·X + V·leak) +
        (1−d)·V``, in its tier's layout.  The loop residual is the MAX
        per-column L1 residual, so exit means every query met the bound;
        the per-column residuals come back so the caller can fall back per
        query when the loop exhausted ``max_pushes``.  The result comes to
        the host in one copy: ``(X (n, Q), per-column residual (Q,),
        sweeps)``."""
        e = self.engine
        tier, axis = e._tier, e._tier.node_axis
        Ab = tier.ppr_operator(e, tier.enter(e, V))
        X, R, sweeps, _, _, _ = frontier_push(
            Ab, tier.enter(e, X0), tol, e.n, max_pushes,
            residual=lambda R: torch.max(torch.sum(torch.abs(R), dim=axis)))
        res_col = torch.sum(torch.abs(R), dim=axis).cpu()
        return (tier.leave(e, X).cpu().numpy(), res_col.numpy(),
                int(sweeps.cpu()))
