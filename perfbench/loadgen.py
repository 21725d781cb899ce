"""The general load generator: what a traffic file asks for, drawn from the
run's seed through the laws it names (``arrivals/<name>.py``,
``seedsets/<name>.py``)."""
from __future__ import annotations

import numpy as np

from perfbench import find


def rng_for(seed: int, stream: str) -> np.random.Generator:
    """An independent generator per named stream of one run's seed."""
    words = [int(seed) & 0xFFFFFFFF, int(seed) >> 32,
             *stream.encode()]
    return np.random.default_rng(np.random.SeedSequence(words))


def plan(graph, traffic: dict, seed: int, seconds: float,
         stream: str) -> tuple[np.ndarray, list]:
    """Due times of an open loop's requests over ``seconds`` and the seed
    sets they send (``queries_per_tick`` per request, default 1)."""
    due = find("arrivals", traffic["arrivals"]).times(
        traffic, seconds, rng_for(seed, stream))
    per = int(traffic.get("queries_per_tick", 1))
    sets = find("seedsets", traffic["seed_sets"]).sets(
        len(due) * per, graph, traffic, rng_for(seed, f"{stream}_queries"))
    return due, sets
