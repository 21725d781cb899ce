"""Resilience layer for the live PageRank serving path: the port of
``repro.pagerank.resilience`` (the delta-ingestion half lives in
:mod:`repro_torch.graph.validate`).

* **Convergence watchdogs** — :func:`watchdog_update` is threaded through
  every tolerance loop: NaN/Inf residuals and sustained residual growth
  abort the loop early instead of spinning to ``max_iters``, and
  :class:`SolveInfo` reports ``converged`` / ``diverged`` / ``nonfinite``
  so callers can tell a good vector from a poisoned one.
* **Last-known-good snapshots** — :class:`RankStore` keeps a bounded ring
  of :class:`EngineSnapshot` records (edge keys, ranks, residual), enough
  to rebuild a whole engine (layout + ranks) from host state after any
  device-side corruption.
* **Graceful degradation** — :class:`ResilientRefresher` drives
  ``DynamicPageRankEngine.update`` through the escalation ladder
  ``push/warm → rebuild → restore-snapshot`` with bounded
  exponential-backoff retries (:class:`RetryPolicy`), returning a
  structured :class:`RefreshOutcome` instead of raising into the serving
  layer.  The ladder takes what the JAX package's takes (an exception of
  the update or the rebuild, a poisoned solve) and never a fault of the
  card itself (:func:`is_kernel_fault`): a kernel that does not build or
  launch, or a CUDA error, propagates.
* **Deterministic fault injection** — :class:`FaultInjector` corrupts
  ranks, layout tensors and deltas, and forces update-step exceptions, all
  from one seeded numpy RNG drawn in the JAX injector's order, so its log
  equals the JAX injector's on the same engine, seed and script.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Iterable

import numpy as np
import torch

from repro_torch.graph.delta import GraphDelta
from repro_torch.kernels._build import KernelBuildError, KernelLaunchError
from repro_torch.kernels.common import resolve_device

__all__ = [
    "GROWTH_FACTOR", "GROWTH_PATIENCE", "watchdog_init", "watchdog_update",
    "SolveInfo", "SolveResult", "ConvergenceError", "make_solve_info",
    "ranks_healthy", "ppr_healthy", "EngineSnapshot", "RankStore",
    "RetryPolicy", "RefreshOutcome", "ResilientRefresher", "FaultInjector",
    "raw_delta", "is_kernel_fault",
]

# Residual-growth watchdog: abort when the L1 residual grows by more than
# GROWTH_FACTOR x in one iteration for GROWTH_PATIENCE consecutive
# iterations.  Power iteration under a damped column-stochastic operator is
# a contraction — the residual decays geometrically — so sustained 8x
# per-iteration growth only happens when the operator itself is corrupt
# and the iterate is headed for overflow.  NaN/Inf residuals exit
# immediately regardless.
GROWTH_FACTOR = 8.0
GROWTH_PATIENCE = 4


def watchdog_init(device: str | torch.device | None = None):
    """Initial ``(grow, ok)`` watchdog carry for a tolerance loop, on
    ``device`` (default ``"cuda"``; raises without CUDA)."""
    device = resolve_device(device)
    return (torch.zeros((), dtype=torch.int32, device=device),
            torch.ones((), dtype=torch.bool, device=device))


def watchdog_update(res: torch.Tensor, res_prev: torch.Tensor,
                    grow: torch.Tensor):
    """One watchdog step, evaluated on the device inside the loop: returns
    the new ``(grow, ok)`` carry.  ``ok`` goes False on a nonfinite
    residual or when growth persists past :data:`GROWTH_PATIENCE`; the
    loop's ``active`` mask ANDs it in."""
    grow = torch.where(res > GROWTH_FACTOR * res_prev, grow + 1,
                       torch.zeros_like(grow)).to(torch.int32)
    ok = torch.isfinite(res) & (grow < GROWTH_PATIENCE)
    return grow, ok


@dataclasses.dataclass(frozen=True)
class SolveInfo:
    """What a tolerance-terminated solve actually did.

    Exactly one of ``converged`` / ``diverged`` / ``nonfinite`` /
    ``exhausted`` describes the exit; ``failed`` groups the two poisoned
    exits (the vector must not be served), ``exhausted`` is the legal but
    unconverged case.  ``trace`` carries the residual trajectory
    (:class:`repro_torch.obs.trace.SolveTrace`) when the solve was run
    with tracing on."""

    iters: int
    residual: float
    tol: float
    max_iters: int
    converged: bool
    diverged: bool
    nonfinite: bool
    trace: object | None = None   # SolveTrace; object to keep eq/repr cheap

    @property
    def iterations(self) -> int:
        """Alias of ``iters``."""
        return self.iters

    @property
    def failed(self) -> bool:
        return self.diverged or self.nonfinite

    @property
    def exhausted(self) -> bool:
        return not (self.converged or self.failed)

    @property
    def status(self) -> str:
        """One-word exit verdict for metrics labels and event logs."""
        return ("converged" if self.converged else
                "nonfinite" if self.nonfinite else
                "diverged" if self.diverged else "exhausted")


class SolveResult(tuple):
    """``(pr, iters, residual)`` — a plain 3-tuple — carrying the full
    :class:`SolveInfo` as ``.info`` for callers that check health."""

    info: SolveInfo

    def __new__(cls, pr, iters, residual, info: SolveInfo):
        obj = super().__new__(cls, (pr, iters, residual))
        obj.info = info
        return obj

    @property
    def pr(self):
        return self[0]

    @property
    def iters(self):
        return self[1]

    @property
    def residual(self):
        return self[2]

    @property
    def trace(self):
        """The solve's residual trajectory (``info.trace`` shortcut)."""
        return self.info.trace


class ConvergenceError(RuntimeError):
    """Raised by ``run_tol(raise_on_fail=True)`` when the solve did not
    converge (exhausted, diverged, or nonfinite)."""

    def __init__(self, info: SolveInfo):
        self.info = info
        reason = ("nonfinite residual" if info.nonfinite else
                  "diverging residual" if info.diverged else
                  f"max_iters={info.max_iters} exhausted")
        super().__init__(
            f"PageRank solve failed to converge: {reason} "
            f"(iters={info.iters}, residual={info.residual:.3e}, "
            f"tol={info.tol:.1e})")


def make_solve_info(iters, residual, grow, *, tol: float,
                    max_iters: int, trace=None) -> SolveInfo:
    """Build the host-side :class:`SolveInfo` from the device scalars every
    watchdogged loop returns (``grow`` is the consecutive-growth counter
    at exit)."""
    iters = int(iters)
    residual = float(residual)
    grow = int(grow)
    nonfinite = not math.isfinite(residual)
    diverged = (not nonfinite) and grow >= GROWTH_PATIENCE
    converged = (not nonfinite) and (not diverged) and residual <= tol
    return SolveInfo(iters=iters, residual=residual, tol=float(tol),
                     max_iters=int(max_iters), converged=converged,
                     diverged=diverged, nonfinite=nonfinite, trace=trace)


# --------------------------------------------------------------------------- #
# health checks                                                               #
# --------------------------------------------------------------------------- #
def _host(x) -> np.ndarray:
    """One host copy of a tensor (or an array as it is)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def ranks_healthy(pr, atol: float = 1e-3) -> bool:
    """A servable global rank vector: every entry finite and non-negative,
    total mass 1 (to ``atol``)."""
    pr = _host(pr)
    if pr.size == 0 or not np.isfinite(pr).all():
        return False
    return bool((pr >= -1e-6).all()
                and abs(float(pr.sum()) - 1.0) <= atol)


def ppr_healthy(PPR, atol: float = 1e-3) -> bool:
    """A servable (N, Q) personalized-PageRank batch: finite, non-negative,
    every query column a distribution."""
    PPR = _host(PPR)
    if PPR.size == 0 or not np.isfinite(PPR).all():
        return False
    return bool((PPR >= -1e-6).all()
                and np.abs(PPR.sum(axis=0) - 1.0).max() <= atol)


def is_kernel_fault(exc: BaseException) -> bool:
    """A fault of the card rather than of the data: a kernel that did not
    build or launch, or an error of the CUDA runtime (``torch
    .AcceleratorError`` where this torch has it, else a ``RuntimeError``
    whose message starts with ``"CUDA error"``).  A sticky CUDA error
    leaves the context unusable, so serving on after one would be wrong:
    the ladder and the serve path re-raise these."""
    accel = getattr(torch, "AcceleratorError", None)
    return (isinstance(exc, (KernelBuildError, KernelLaunchError))
            or (accel is not None and isinstance(exc, accel))
            or (isinstance(exc, RuntimeError)
                and str(exc).startswith("CUDA error")))


# --------------------------------------------------------------------------- #
# last-known-good snapshots                                                   #
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class EngineSnapshot:
    """Everything needed to rebuild a healthy engine on the host: the edge
    set (sorted int64 keys), the solved ranks, and the solve residual —
    device layouts are *derived* state and are reconstructed on restore."""

    keys: np.ndarray              # sorted int64 edge keys (src * n + dst)
    ranks: np.ndarray | None      # solved rank vector (host copy)
    residual: float
    version: int = -1             # graph version stamped by RankStore


class RankStore:
    """Bounded ring of last-known-good :class:`EngineSnapshot` records.

    ``record`` only ever sees healthy states (the refresher checks before
    recording), so ``latest()`` is always a safe restore target; the bound
    keeps snapshot memory at ``maxlen * (E + N)`` words."""

    def __init__(self, maxlen: int = 4):
        self._snaps: deque[EngineSnapshot] = deque(maxlen=maxlen)
        self.version = 0

    def record(self, engine, residual: float = 0.0) -> EngineSnapshot:
        self.version += 1
        snap = dataclasses.replace(engine.snapshot(),
                                   residual=float(residual),
                                   version=self.version)
        self._snaps.append(snap)
        return snap

    def latest(self) -> EngineSnapshot | None:
        return self._snaps[-1] if self._snaps else None

    def __len__(self) -> int:
        return len(self._snaps)


# --------------------------------------------------------------------------- #
# retry policy                                                                #
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff: attempt k (0-based) sleeps
    ``base_delay_s * factor**k`` before retrying, ``max_retries`` retries
    after the first attempt.  Pure and deterministic."""

    max_retries: int = 2
    base_delay_s: float = 0.0     # tests keep 0; deployments set > 0
    factor: float = 2.0

    def delays(self) -> Iterable[float]:
        """Pre-sleep for each attempt: 0 for the first, then the backoff
        schedule — ``len == 1 + max_retries``."""
        yield 0.0
        for k in range(self.max_retries):
            yield self.base_delay_s * (self.factor ** k)


# --------------------------------------------------------------------------- #
# the escalation ladder                                                       #
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class RefreshOutcome:
    """Structured result of one resilient refresh — what the serving layer
    tags responses with instead of catching exceptions.

    ``status``: ``"ok"`` (update healthy first try aside from retries),
    ``"recovered"`` (needed a full rebuild), ``"restored"`` (rolled back to
    the last-known-good snapshot — the delta is NOT in the graph), or
    ``"failed"`` (every rung failed; engine left in its pre-call state).
    ``delta_applied`` tells the caller whether to re-queue the delta."""

    status: str
    delta_applied: bool
    attempts: int
    update_info: object | None = None
    error: str | None = None


class ResilientRefresher:
    """Drives ``DynamicPageRankEngine.update`` through the escalation
    ladder with retries, records healthy states into a :class:`RankStore`,
    and lets no engine failure propagate — a fault of the card excepted
    (:func:`is_kernel_fault`), which always does.

    Ladder: (1) ``engine.update`` (its own auto policy already escalates
    push → warm → rebuild by delta size) with :class:`RetryPolicy` retries
    on exceptions — ``update`` is atomic-on-raise, so a failed attempt
    leaves the engine clean; (2) if the update *returned* but the solve or
    the ranks are poisoned (NaN layout, diverging loop), a full
    ``rebuild_and_solve`` from host bookkeeping, warm-started from the
    last good snapshot; (3) if even that fails, ``engine.restore`` of the
    last-known-good snapshot (delta dropped back to the caller)."""

    def __init__(self, store: RankStore | None = None,
                 retry: RetryPolicy | None = None,
                 healthy_atol: float = 1e-3):
        self.store = store if store is not None else RankStore()
        self.retry = retry if retry is not None else RetryPolicy()
        self.healthy_atol = float(healthy_atol)

    # ------------------------------------------------------------------ #
    def _solve_ok(self, engine, pr) -> bool:
        info = getattr(engine, "last_solve_info", None)
        if info is not None and info.failed:
            return False
        return ranks_healthy(pr, atol=self.healthy_atol)

    def baseline(self, engine) -> EngineSnapshot | None:
        """Record the engine's current (healthy) state as the first
        restore target; no-op when it is not healthy yet."""
        if engine.ranks is not None and self._solve_ok(engine, engine.ranks):
            return self.store.record(
                engine, residual=getattr(engine, "last_solve_info", None)
                and engine.last_solve_info.residual or 0.0)
        return None

    def refresh(self, engine, delta: GraphDelta, *, tol: float = 1e-6,
                max_iters: int = 1000) -> RefreshOutcome:
        """Fold ``delta`` into ``engine`` via the escalation ladder; raises
        only a fault of the card."""
        attempts = 0
        last_err: BaseException | None = None
        result = None
        for delay in self.retry.delays():
            if delay:
                time.sleep(delay)
            attempts += 1
            try:
                result = engine.update(delta, tol=tol, max_iters=max_iters)
                break
            except Exception as e:          # noqa: BLE001 — ladder contract
                if is_kernel_fault(e):
                    raise
                last_err = e
        if result is None:
            # every attempt raised; update's rollback left the engine in
            # its pre-delta state, which is still the last good one —
            # nothing to restore, the delta goes back to the caller
            return RefreshOutcome("failed", False, attempts,
                                  error=repr(last_err))
        pr, info = result
        if self._solve_ok(engine, pr):
            self.store.record(engine, residual=info.residual)
            return RefreshOutcome("ok", True, attempts, update_info=info)
        # the delta is committed but the solve is poisoned (corrupt layout
        # values, diverging loop): rebuild every device layout from the
        # host edge set and re-solve, warm-started from the last good ranks
        snap = self.store.latest()
        x0 = None if snap is None else snap.ranks
        try:
            res = engine.rebuild_and_solve(tol=tol, max_iters=max_iters,
                                           x0=x0)
            if self._solve_ok(engine, res[0]):
                self.store.record(engine, residual=float(res[2]))
                return RefreshOutcome("recovered", True, attempts,
                                      update_info=info)
        except Exception as e:              # noqa: BLE001 — ladder contract
            if is_kernel_fault(e):
                raise
            last_err = e
        # last rung: roll the engine back to the snapshot; the delta is
        # NOT applied and must be re-queued by the caller
        if snap is not None:
            engine.restore(snap)
            return RefreshOutcome("restored", False, attempts,
                                  update_info=info,
                                  error=last_err and repr(last_err))
        return RefreshOutcome("failed", False, attempts, update_info=info,
                              error=last_err and repr(last_err))

    def recover(self, engine, *, tol: float = 1e-6,
                max_iters: int = 1000) -> RefreshOutcome:
        """Delta-less recovery for corruption detected outside a refresh
        (e.g. a poisoned serve batch): rebuild from host bookkeeping, else
        restore the last snapshot.  Raises only a fault of the card."""
        snap = self.store.latest()
        x0 = None if snap is None else snap.ranks
        last_err = None
        try:
            res = engine.rebuild_and_solve(tol=tol, max_iters=max_iters,
                                           x0=x0)
            if self._solve_ok(engine, res[0]):
                self.store.record(engine, residual=float(res[2]))
                return RefreshOutcome("recovered", True, 1)
        except Exception as e:              # noqa: BLE001 — ladder contract
            if is_kernel_fault(e):
                raise
            last_err = e
        if snap is not None:
            engine.restore(snap)
            return RefreshOutcome("restored", False, 1,
                                  error=last_err and repr(last_err))
        return RefreshOutcome("failed", False, 1,
                              error=last_err and repr(last_err))


# --------------------------------------------------------------------------- #
# deterministic fault injection                                               #
# --------------------------------------------------------------------------- #
def raw_delta(insert_src, insert_dst, delete_src=(), delete_dst=(),
              timestamp: float = 0.0) -> GraphDelta:
    """Construct a :class:`GraphDelta` WITHOUT the constructor validation —
    the injector's way of producing the malformed deltas the validation
    layer must catch.  (Production code never needs this.)"""
    d = object.__new__(GraphDelta)
    for name, val in (("insert_src", insert_src), ("insert_dst", insert_dst),
                      ("delete_src", delete_src), ("delete_dst", delete_dst)):
        object.__setattr__(d, name, np.atleast_1d(np.asarray(val)))
    object.__setattr__(d, "timestamp", timestamp)
    return d


# the storage types the JAX injector takes for "float": numpy's floating
# types.  bfloat16 is not one of them (ml_dtypes' bfloat16 is no subtype of
# np.floating), so a bf16 layout has its next float operand poisoned;
# torch.is_floating_point would count bfloat16 and break that parity
_INJECTABLE = (torch.float16, torch.float32, torch.float64)


class FaultInjector:
    """Seeded, deterministic fault injection against a live engine.

    Every fault is drawn from one ``default_rng(seed)`` stream in the JAX
    injector's order and logged to ``.log``, so a failing run replays
    bit-identically from the seed and the log equals the JAX injector's.
    Faults cover the four classes the resilience layer must survive:
    malformed deltas, corrupted rank vectors, corrupted layout tensors,
    and forced update-step exceptions."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)
        self.log: list[str] = []

    # ------------------------------ deltas ----------------------------- #
    def corrupt_delta(self, n: int, kind: str = "out_of_range",
                      size: int = 4, timestamp: float = 0.0) -> GraphDelta:
        """A malformed insert delta of the requested fault class (built
        via :func:`raw_delta`, bypassing constructor validation)."""
        size = max(int(size), 1)
        src = self.rng.integers(0, n, size=size)
        dst = (src + 1 + self.rng.integers(0, max(n - 1, 1), size=size)) % n
        if kind == "out_of_range":
            dst = dst + n                       # every id past the graph
        elif kind == "negative":
            src = -1 - src
        elif kind == "self_loop":
            dst = src.copy()
        elif kind == "nan":
            src = src.astype(np.float64)
            src[:: 2] = np.nan
        elif kind == "dup_flood":
            src = np.repeat(src[:1], size * 64)
            dst = np.repeat(dst[:1], size * 64)
        elif kind == "oversized":
            reps = size * 64
            src = self.rng.integers(0, n, size=reps)
            dst = (src + 1) % n
        else:
            raise ValueError(f"unknown delta fault kind {kind!r}")
        self.log.append(f"delta:{kind}(size={len(np.atleast_1d(src))})")
        return raw_delta(src, dst, timestamp=timestamp)

    # ------------------------------ ranks ------------------------------ #
    def corrupt_ranks(self, engine, kind: str = "nan", k: int = 4) -> None:
        """Poison ``k`` entries of the engine's latest rank vector (written
        back on the engine's device)."""
        if engine.ranks is None:
            raise ValueError("engine has no solved ranks to corrupt")
        pr = _host(engine.ranks).copy()
        idx = self.rng.choice(pr.shape[0], size=min(k, pr.shape[0]),
                              replace=False)
        pr[idx] = {"nan": np.nan, "inf": np.inf, "negative": -1.0}[kind]
        engine._pr = torch.from_numpy(pr).to(engine.device)
        self.log.append(f"ranks:{kind}(k={len(idx)})")

    # ------------------------------ layout ----------------------------- #
    def corrupt_layout(self, engine, kind: str = "nan", k: int = 4) -> None:
        """Poison ``k`` values of the first float tensor in the engine's
        prepared layout (the dense H, the ELL/SELL data tier, the BSR
        blocks, whichever the backend prepared; "float" as the JAX
        injector reads it, so not bfloat16).  ``kind="huge"`` plants
        finite-but-absurd values and ``kind="scale"`` multiplies the whole
        tensor by 32 — a spectral radius ≫ 1, the deterministic way to
        exercise the residual-growth (``diverged``) watchdog rather than
        the NaN/Inf check.  The tensor is edited through a float32 host
        copy and written back in its storage dtype on its device; a sharded
        operand (the sharded tiers') is written back onto its own mesh
        positions in its own layout."""
        ops = list(engine._operands)
        target = None
        for i, op in enumerate(ops):
            arr = getattr(op, "blocks", op)     # BSRMatrix stores .blocks
            if arr.dtype in _INJECTABLE:
                target = i
                break
        if target is None:
            raise ValueError("no float layout array to corrupt")
        op = ops[target]
        is_bsr = hasattr(op, "blocks")
        is_sharded = hasattr(op, "shards")
        dev_arr = (op.blocks if is_bsr else
                   op.full() if is_sharded else op)
        arr = dev_arr.detach().to("cpu", torch.float32).numpy().copy()
        flat = arr.reshape(-1)
        if kind == "scale":
            arr *= 32.0
            idx = np.empty(0, np.int64)
        else:
            idx = self.rng.choice(flat.shape[0], size=min(k, flat.shape[0]),
                                  replace=False)
            # "huge" stays finite long enough for the growth counter to
            # matter; whether it trips diverged or nonfinite depends on
            # how fast the corrupt entries feed back
            flat[idx] = {"nan": np.nan, "inf": np.inf, "huge": 1e4}[kind]
        new = torch.from_numpy(arr).to(device=dev_arr.device,
                                       dtype=dev_arr.dtype)
        if is_sharded:
            new = type(op).from_global(new, op.mesh, op.spec)
            if engine.backend == "dense_sharded":
                # its PPR reads the row blocks of H, which must see the
                # poison as the JAX tier's per-call reshard does
                engine._ppr_operands = None
        ops[target] = (dataclasses.replace(op, blocks=new) if is_bsr
                       else new)
        engine._operands = tuple(ops)
        self.log.append(f"layout:{kind}(k={len(idx)},operand={target})")

    # --------------------------- update failures ----------------------- #
    def fail_next_updates(self, engine, times: int = 1,
                          exc_type: type = RuntimeError) -> None:
        """Force the next ``times`` calls of ``engine.update`` to raise
        (the simulated backend-step exception): the wrapper raises
        *before* touching engine state, then restores the real method."""
        inner = engine.update
        state = {"left": int(times)}

        def failing_update(*args, **kwargs):
            if state["left"] > 0:
                state["left"] -= 1
                if state["left"] == 0:
                    engine.update = inner
                raise exc_type(
                    f"injected backend-step failure "
                    f"({int(times) - state['left']}/{int(times)})")
            engine.update = inner
            return inner(*args, **kwargs)

        engine.update = failing_update
        self.log.append(f"update:fail(times={times})")
