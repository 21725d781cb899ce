"""Fault tolerance & elasticity: failure-aware shard assignment, straggler
mitigation policy, preemption handling, and the restart loop contract.

The port's own copy of ``repro.train.fault`` (pure Python, no tensor).  On
a real 1000+-node deployment the runtime signals (heartbeats, preemption
notices) come from the cluster manager; here the *policies* are pure,
deterministic, unit-tested functions, and ``launch/train.py`` wires them to
a simulated failure injector so the checkpoint -> crash -> resume path is
exercised end to end.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Sequence

__all__ = ["assign_shards", "reassign_on_failure", "StragglerPolicy",
           "PreemptionGuard", "run_with_restarts"]


# --------------------------------------------------------------------------- #
# Deterministic data-shard reassignment (node failures / elastic resize)     #
# --------------------------------------------------------------------------- #
def assign_shards(n_shards: int, hosts: Sequence[int]) -> dict[int, list[int]]:
    """Round-robin over the *sorted* live hosts — deterministic for any
    subset, so every survivor computes the same assignment with no
    coordination (rendezvous-style)."""
    live = sorted(hosts)
    if not live:
        raise ValueError("no live hosts")
    out: dict[int, list[int]] = {h: [] for h in live}
    for s in range(n_shards):
        out[live[s % len(live)]].append(s)
    return out


def reassign_on_failure(n_shards: int, hosts: Sequence[int],
                        failed: Sequence[int]) -> dict[int, list[int]]:
    return assign_shards(n_shards, [h for h in hosts if h not in set(failed)])


# --------------------------------------------------------------------------- #
# Straggler mitigation                                                       #
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class StragglerPolicy:
    """Backup-step policy: if a host's step time exceeds ``threshold`` x the
    rolling median, its shard is re-executed by the fastest idle host and
    the first result wins (speculative execution, MapReduce-style)."""

    threshold: float = 2.0
    window: int = 16

    def detect(self, step_times: dict[int, list[float]]) -> list[int]:
        """Hosts whose recent mean exceeds threshold x global median."""
        recents = {h: (sum(t[-self.window:]) / max(len(t[-self.window:]), 1))
                   for h, t in step_times.items() if t}
        if len(recents) < 2:
            return []
        vals = sorted(recents.values())
        median = vals[len(vals) // 2]
        return [h for h, v in recents.items() if v > self.threshold * median]

    def backups(self, stragglers: Sequence[int],
                assignment: dict[int, list[int]]) -> dict[int, list[int]]:
        """Map straggler shards onto the least-loaded non-straggler hosts."""
        healthy = [h for h in sorted(assignment) if h not in set(stragglers)]
        if not healthy:
            return {}
        out: dict[int, list[int]] = {h: [] for h in healthy}
        i = 0
        for s in sorted(stragglers):
            for shard in assignment.get(s, []):
                out[healthy[i % len(healthy)]].append(shard)
                i += 1
        return {h: v for h, v in out.items() if v}


# --------------------------------------------------------------------------- #
# Preemption                                                                   #
# --------------------------------------------------------------------------- #
class PreemptionGuard:
    """SIGTERM-aware flag: the train loop checkpoints and exits cleanly when
    the cluster manager preempts the job."""

    def __init__(self, install: bool = True):
        self._flagged = False
        if install:
            try:
                signal.signal(signal.SIGTERM, self._handler)
            except ValueError:          # non-main thread (tests)
                pass

    def _handler(self, signum, frame):
        self._flagged = True

    def flag(self) -> None:             # for tests / manual triggering
        self._flagged = True

    @property
    def should_stop(self) -> bool:
        return self._flagged


# --------------------------------------------------------------------------- #
# Restart loop                                                                #
# --------------------------------------------------------------------------- #
def run_with_restarts(step_fn: Callable[[int], int], start_step: int,
                      max_steps: int, max_restarts: int = 3,
                      on_failure: Callable[[int, Exception], None]
                      | None = None) -> int:
    """Drive ``step_fn(step) -> next_step`` with bounded restart-on-exception
    (the in-process analogue of the cluster-level restart contract).  The
    caller's ``step_fn`` is responsible for reloading state from the latest
    checkpoint when it observes a step rollback."""
    step = start_step
    restarts = 0
    while step < max_steps:
        try:
            step = step_fn(step)
        except Exception as e:      # noqa: BLE001 — restart contract
            restarts += 1
            if on_failure is not None:
                on_failure(step, e)
            if restarts > max_restarts:
                raise
            time.sleep(0.01)
    return step
