"""A frozen copy of the program's streaming rule for live edge updates.

The rule of ``EdgeStream``: each tick samples arrivals whose endpoints are
drawn with probability proportional to degree + 1 (so isolated proteins
can rejoin) and retires the oldest live edges first; an edge that arrives
in a tick never expires in the same tick.  Unlike the program's class it
starts from any undirected graph, with the edges' ages in an order drawn
from the caller's generator, and it returns plain undirected pairs.
"""
from __future__ import annotations

from collections import deque

import numpy as np


class EdgeStream:
    def __init__(self, src: np.ndarray, dst: np.ndarray, n: int, rng,
                 arrivals: int, expiries: int):
        self.n = int(n)
        self.arrivals = int(arrivals)
        self.expiries = int(expiries)
        self._rng = rng
        lo = np.minimum(src, dst).astype(np.int64)
        hi = np.maximum(src, dst).astype(np.int64)
        pairs = np.unique(lo * self.n + hi)
        self._fifo = deque(int(k) for k in pairs[rng.permutation(len(pairs))])
        self._live = set(self._fifo)
        self._deg = np.bincount(np.concatenate([pairs // self.n,
                                                pairs % self.n]),
                                minlength=self.n).astype(np.int64)

    def _arrival(self) -> int | None:
        w = (self._deg + 1).astype(np.float64)
        w /= w.sum()
        for _ in range(64):
            u, v = self._rng.choice(self.n, size=2, p=w)
            if u == v:
                continue
            key = int(min(u, v)) * self.n + int(max(u, v))
            if key not in self._live:
                return key
        return None

    def step(self) -> tuple[np.ndarray, np.ndarray]:
        """One tick: ``(inserted, deleted)`` undirected pairs, each an
        (k, 2) int32 array of ``(u, v)`` with ``u < v``."""
        ins: list[int] = []
        for _ in range(self.arrivals):
            key = self._arrival()
            if key is None:
                break
            ins.append(key)
            self._live.add(key)
            self._deg[key // self.n] += 1
            self._deg[key % self.n] += 1
        dels = [self._fifo.popleft()
                for _ in range(min(self.expiries, len(self._fifo)))]
        self._fifo.extend(ins)
        for key in dels:
            self._live.discard(key)
            self._deg[key // self.n] -= 1
            self._deg[key % self.n] -= 1
        return _pairs(ins, self.n), _pairs(dels, self.n)


def _pairs(keys: list[int], n: int) -> np.ndarray:
    k = np.asarray(keys, np.int64)
    return np.stack([k // n, k % n], axis=1).astype(np.int32)
