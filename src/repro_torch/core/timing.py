"""The paper's analytical latency/throughput model (Fig. 4C, Fig. 6, Table I).

All equations come straight from the text:

* MV over an (N x M) matrix:            ``N + 3``  time steps   (Fig. 3)
* one PageRank iteration, N proteins:   ``N + 6``  time steps   (Fig. 4B)
* n iterations, unlimited fabric:       ``n * (N + 6)``          (Fig. 4B)
* n iterations, finite fabric of S sites (Fig. 4C): the N x N transition
  matrix is processed in ``ceil(N^2 / S)`` square tiles of side ``sqrt(S)``;
  each tile costs ``sqrt(S) + 6`` steps ⇒

      steps = n * ceil(N^2 / S) * (sqrt(S) + 6)

  At S = 4096 (64x64 tiles), f = 200 MHz, N = 5000, n = 100 this gives
  42.728e6 cycles = **213.64 ms**, matching the paper's headline 213.6 ms.

Table-I-derived silicon constants are exposed for the energy/area model in
``benchmarks/table1_design.py``.

The port's own copy of ``repro.core.timing`` (it imports only
``dataclasses`` and ``math``).  These are times of the paper's fabric at
200 MHz, never of the card the port runs on.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class FabricSpec:
    """Hardware constants of the paper's evaluated design (Table I)."""

    clock_hz: float = 200e6          # uniform 200 MHz across the flow
    n_sites: int = 4096              # "leveraging only 4096 available units"
    site_power_w: float = 4.1e-3     # per-site power, TSMC 28nm HPC+
    site_area_mm2: float = 6.0       # per-site area (Table I)
    site_gates: int = 98_000
    process: str = "TSMC 28nm CLN28HPC+ 1P8M 0.9V"

    @property
    def tile_side(self) -> int:
        s = int(math.isqrt(self.n_sites))
        assert s * s == self.n_sites, "site count must be a square for tiling"
        return s

    @property
    def step_seconds(self) -> float:
        return 1.0 / self.clock_hz

    @property
    def fabric_power_w(self) -> float:
        return self.n_sites * self.site_power_w


DEFAULT_SPEC = FabricSpec()


# --------------------------------------------------------------------------- #
# Step counts (exact integer arithmetic)                                      #
# --------------------------------------------------------------------------- #
def matvec_steps(n_rows: int) -> int:
    """Fig. 3 / Fig. 6A: steps for an (N x M) MV — independent of M."""
    return n_rows + 3


def pagerank_iteration_steps(n_nodes: int) -> int:
    """Fig. 4B: one iteration = MV (N+3) + d-mult (1) + add (1) + offload (1)."""
    return n_nodes + 6


def pagerank_steps_unlimited(n_nodes: int, n_iters: int) -> int:
    """Fig. 4B total: n * (N + 6), assuming the fabric fits the full matrix."""
    return n_iters * pagerank_iteration_steps(n_nodes)


def pagerank_tiles(n_nodes: int, spec: FabricSpec = DEFAULT_SPEC) -> int:
    """Fig. 4C: number of sqrt(S) x sqrt(S) tiles covering the N x N matrix."""
    return math.ceil(n_nodes * n_nodes / spec.n_sites)


def pagerank_steps_tiled(n_nodes: int, n_iters: int,
                         spec: FabricSpec = DEFAULT_SPEC) -> int:
    """Fig. 4C: finite-fabric step count (the paper's throughput model)."""
    per_tile = spec.tile_side + 6
    return n_iters * pagerank_tiles(n_nodes, spec) * per_tile


# --------------------------------------------------------------------------- #
# Wall-clock / throughput / energy                                            #
# --------------------------------------------------------------------------- #
def matvec_latency_s(n_rows: int, spec: FabricSpec = DEFAULT_SPEC) -> float:
    """Fig. 6A curve."""
    return matvec_steps(n_rows) * spec.step_seconds


def pagerank_latency_s(n_nodes: int, n_iters: int = 100,
                       spec: FabricSpec = DEFAULT_SPEC) -> float:
    """Fig. 6B curve (finite fabric). 5000 nodes, 100 iters -> 0.21364 s."""
    return pagerank_steps_tiled(n_nodes, n_iters, spec) * spec.step_seconds


def pagerank_throughput_flops(n_nodes: int, n_iters: int = 100,
                              spec: FabricSpec = DEFAULT_SPEC) -> float:
    """Useful FLOP/s the fabric sustains on PageRank (2 N^2 + 2 N per iter)."""
    flops = n_iters * (2.0 * n_nodes * n_nodes + 2.0 * n_nodes)
    return flops / pagerank_latency_s(n_nodes, n_iters, spec)


def pagerank_energy_j(n_nodes: int, n_iters: int = 100,
                      spec: FabricSpec = DEFAULT_SPEC) -> float:
    """Energy estimate from Table I's per-site power (whole-fabric active)."""
    return spec.fabric_power_w * pagerank_latency_s(n_nodes, n_iters, spec)
