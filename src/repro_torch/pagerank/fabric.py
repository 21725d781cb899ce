"""PageRank executed on the fabric *simulator* (the faithful tier).

Thin wrapper over ``core.schedule.pagerank`` returning both the rank vector
and the paper-accounted step count, so callers can cross-check against the
analytical model (``core.timing``) and against the native implementation
(``pagerank.dense``).  The seconds are those of the paper's fabric at
200 MHz, never of the card the simulator runs on.
"""
from __future__ import annotations

import torch

from repro_torch.core import schedule, timing

__all__ = ["pagerank_on_fabric"]


def pagerank_on_fabric(H: torch.Tensor, n_iters: int = 100, d: float = 0.85,
                       use_messages: bool = False):
    """Returns (pr, steps, seconds_at_200MHz)."""
    res = schedule.pagerank(H, n_iters=n_iters, d=d,
                            use_messages=use_messages)
    seconds = res.steps * timing.DEFAULT_SPEC.step_seconds
    return res.result, res.steps, seconds
