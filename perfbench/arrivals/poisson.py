"""A Poisson process of ``rate_per_s``: ``round(rate * seconds)`` gaps at
the midpoint quantiles of the exponential distribution of mean
``1 / rate``, shuffled."""
from __future__ import annotations

import numpy as np


def times(traffic: dict, seconds: float, rng) -> np.ndarray:
    rate = float(traffic["rate_per_s"])
    count = max(1, int(round(rate * seconds)))
    u = (np.arange(count) + 0.5) / count
    gaps = -np.log1p(-u) / rate
    return np.cumsum(rng.permutation(gaps))
