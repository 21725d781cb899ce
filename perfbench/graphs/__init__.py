"""The benchmark's graphs, one generator module per name.

A configuration names its generator (``"generator": "protein"`` finds
``perfbench/graphs/protein.py``); each module has ``make(cfg, seed,
device) -> Graph``.  The program is handed the numpy edge arrays, the
plain reference the device tensors.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from perfbench import find


@dataclasses.dataclass
class Graph:
    """A directed symmetric edge list over ``n`` vertices, with no
    duplicate edges and no self-loops."""
    src: np.ndarray          # (E,) int32
    dst: np.ndarray          # (E,) int32
    n: int
    src_t: torch.Tensor      # the same edges on the device
    dst_t: torch.Tensor

    @classmethod
    def from_numpy(cls, src, dst, n: int, device) -> "Graph":
        return cls(src, dst, n, torch.from_numpy(src).to(device),
                   torch.from_numpy(dst).to(device))

    @property
    def n_directed(self) -> int:
        return int(self.src.shape[0])

    @property
    def n_undirected(self) -> int:
        """Unique undirected edges (each is two directed entries)."""
        return self.n_directed // 2

    @property
    def n_connected(self) -> int:
        """Vertices with at least one edge."""
        return int(np.count_nonzero(np.bincount(self.src, minlength=self.n)))


def make(cfg: dict, seed: int, device) -> Graph:
    return find("graphs", cfg["generator"]).make(cfg, seed, device)
