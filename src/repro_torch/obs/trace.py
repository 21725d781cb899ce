"""Solve traces: the residual trajectory ring every tolerance loop records,
and the one instrumented tolerance loop they share.

:func:`instrumented_tol_loop` is the single tolerance loop of the port's
engine tiers and of the reference ``pagerank_dense``.  It carries the
convergence watchdog of :mod:`repro_torch.pagerank.resilience` and a
fixed-size (:data:`TRACE_LEN`) residual ring, ``ring[i % TRACE_LEN] =
residual_i``; a solve longer than the ring keeps its last ``TRACE_LEN``
residuals.

The loop on the device.  The JAX package runs this loop as one device
``lax.while_loop`` with no host syncs.  PyTorch has no device-side loop, so
this port steps in fixed chunks of :data:`CHUNK` iterations:

* every step is applied under the device-side mask
  ``active = (res > tol) & (i < max_iters) & ok``: ``torch.where`` freezes
  the state, ``i``, ``res``, the watchdog carry and the ring once the loop
  would have exited, so the steps issued after the exit change nothing;
* the host reads ``active`` once per chunk, before issuing the chunk, and
  stops there; it never issues more than ``max_iters`` steps in all.

This gives exactly the iteration count, the ``res0`` early exit and the
watchdog verdict of the JAX loop, at one host sync per :data:`CHUNK`
steps, and at most ``CHUNK - 1`` steps of wasted device work after the
exit.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["TRACE_LEN", "CHUNK", "SolveTrace", "instrumented_tol_loop"]

TRACE_LEN = 64

# steps issued between two host reads of the loop's ``active`` flag
CHUNK = 8


class SolveTrace:
    """Lazy host view of the residual trajectory ring.

    Holds the device ring until :attr:`residuals` is read (a solve's trace
    costs no host copy unless inspected).  The trajectory is returned
    oldest-first; for solves longer than the ring, it is the last
    ``len(ring)`` residuals.
    """

    def __init__(self, ring: torch.Tensor, iters):
        self._ring = ring
        self._iters = iters
        self._cache: np.ndarray | None = None

    @property
    def n_iters(self) -> int:
        return int(self._iters)

    @property
    def residuals(self) -> np.ndarray:
        """Chronological residual trajectory (the host copy happens
        here)."""
        if self._cache is None:
            ring = self._ring.detach().cpu().numpy()
            it = int(self._iters)
            if it <= len(ring):
                self._cache = ring[:it].copy()
            else:
                k = it % len(ring)
                self._cache = np.concatenate([ring[k:], ring[:k]])
        return self._cache

    @property
    def ratios(self) -> np.ndarray:
        """Per-iteration contraction ratios ``res[i+1] / res[i]`` — ~d for
        a healthy damped power iteration, > 1 sustained when diverging.
        Computed on the unwrapped chronological trajectory, so every ratio
        pairs two chronologically adjacent retained samples."""
        r = self.residuals
        if len(r) < 2:
            return np.empty(0, r.dtype if len(r) else np.float32)
        with np.errstate(divide="ignore", invalid="ignore"):
            return r[1:] / r[:-1]

    def __len__(self) -> int:
        return len(self.residuals)

    def __repr__(self) -> str:       # sync-free (repr must stay cheap)
        return f"SolveTrace(window={int(self._ring.shape[0])})"


def _where(mask: torch.Tensor, new, old):
    """``torch.where`` over a state that is a tensor or a tuple of them;
    the mask follows each tensor to its device (a sharded state's shards
    may lie on several)."""
    if isinstance(new, tuple):
        return tuple(_where(mask, a, b) for a, b in zip(new, old))
    return torch.where(mask.to(new.device), new, old)


def instrumented_tol_loop(step, state0, *, tol, max_iters: int,
                          watchdog: bool = True, trace: bool = True,
                          res0=None, dtype=torch.float32):
    """The shared tolerance-terminated loop: run ``step`` until the
    residual drops to ``tol``, ``max_iters`` is hit, or the watchdog
    aborts.

    ``step(state) -> (new_state, residual)`` supplies the backend's
    arithmetic; ``state`` is a tensor or a tuple of tensors (the rank
    vector, the fused tier's ``(xp, t)`` carry, a sharded tier's shards);
    the loop's own scalars live on the first tensor's device.
    ``res0`` seeds the loop residual (default ``inf``: always take the
    first step); a tensor ``res0`` stays on the device, so seeding the loop
    costs no host sync.  ``tol`` is a Python float or a 0-dim tensor.

    Returns ``(state, iters, residual, grow, ring)`` as device tensors;
    ``ring`` is ``None`` with ``trace=False``.
    """
    from repro_torch.pagerank.resilience import (watchdog_init,
                                                 watchdog_update)

    leaf = state0[0] if isinstance(state0, tuple) else state0
    dev = leaf.device
    if isinstance(res0, torch.Tensor):
        res = res0.to(device=dev, dtype=dtype).reshape(())
    else:
        res = torch.full((), float("inf") if res0 is None else float(res0),
                         dtype=dtype, device=dev)
    if isinstance(tol, torch.Tensor):
        tol = tol.to(dev)
    i = torch.zeros((), dtype=torch.int32, device=dev)
    grow, ok = watchdog_init(dev)
    ring = torch.zeros((TRACE_LEN if trace else 0,), dtype=torch.float32,
                       device=dev)
    state = state0

    def active():
        return (res > tol) & (i < max_iters) & ok

    issued = 0
    while issued < max_iters and bool(active()):     # one sync per chunk
        n_steps = min(CHUNK, max_iters - issued)
        for _ in range(n_steps):
            live = active()
            new_state, new_res = step(state)
            new_res = new_res.to(dtype)
            if watchdog:
                new_grow, new_ok = watchdog_update(new_res, res, grow)
                grow = torch.where(live, new_grow, grow)
                ok = torch.where(live, new_ok, ok)
            if trace:
                slot = torch.remainder(i, TRACE_LEN).long().reshape(1)
                written = ring.index_put(
                    (slot,), new_res.to(torch.float32).reshape(1))
                ring = torch.where(live, written, ring)
            state = _where(live, new_state, state)
            res = torch.where(live, new_res, res)
            i = torch.where(live, i + 1, i)
        issued += n_steps
    return state, i, res, grow, (ring if trace else None)
