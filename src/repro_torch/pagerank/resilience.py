"""Convergence watchdog and solve status: the subset of
``repro.pagerank.resilience`` that the tolerance solve needs.

:func:`watchdog_update` is threaded through every tolerance loop:
NaN/Inf residuals and sustained residual growth abort the loop early
instead of spinning to ``max_iters``, and :class:`SolveInfo` reports
``converged`` / ``diverged`` / ``nonfinite`` so callers can tell a good
vector from a poisoned one.  :class:`EngineSnapshot` is the host record
the dynamic engine's ``snapshot`` / ``restore`` exchange.  The snapshot
store, the refresher and the fault injector are not ported yet.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

__all__ = [
    "GROWTH_FACTOR", "GROWTH_PATIENCE", "watchdog_init", "watchdog_update",
    "SolveInfo", "SolveResult", "ConvergenceError", "make_solve_info",
    "EngineSnapshot",
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


def watchdog_init(device: str | torch.device = "cpu"):
    """Initial ``(grow, ok)`` watchdog carry for a tolerance loop."""
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


@dataclasses.dataclass(frozen=True)
class EngineSnapshot:
    """Everything needed to rebuild a healthy engine on the host: the edge
    set (sorted int64 keys), the solved ranks, and the solve residual —
    device layouts are *derived* state and are reconstructed on restore."""

    keys: np.ndarray              # sorted int64 edge keys (src * n + dst)
    ranks: np.ndarray | None      # solved rank vector (host copy)
    residual: float
    version: int = -1             # graph version stamped by a rank store
