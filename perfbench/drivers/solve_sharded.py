"""The closed loop of :mod:`perfbench.drivers.solve` on a configuration
whose graph is shared by several cards: the engine is built on the cell's
mesh from a graph that stays on the host, and the window's solves are held
to the float64 reference across the cards
(:mod:`perfbench.reference.pagerank_cards`), built after ``outputs()`` has
freed the engine, so that every card's memory is free for it.

A program that lacks the configuration's tier is refused before the
engine is built, so such a run ends at once and not after a build of the
whole edge set on one card."""
from __future__ import annotations

import torch

from perfbench import bench, checks
from perfbench.drivers import solve
from perfbench.reference import pagerank_cards as cards


def ranks(graph, cfg: dict, n_iters: int, devices,
          precision: str = "f64") -> torch.Tensor:
    """The reference's ``n_iters`` steps across ``devices``."""
    return cards.global_ranks(graph.src_t, graph.dst_t, graph.n,
                              float(cfg["d"]), n_iters, devices, precision)


def control_devices(cfg: dict) -> list:
    """The cards of the configuration's deployment (``cards``, which the
    driver holds equal to the cell's ``chips``), or as many positions on
    the CPU where there is no card."""
    return bench.cell_devices("cuda" if torch.cuda.is_available() else "cpu",
                              int(cfg["cards"]))


class Driver(solve.Driver):
    def __init__(self, cfg, traffic, graph, seed, seconds, devices,
                 registry):
        from repro_torch.pagerank.engine import BACKENDS
        if cfg["backend"] not in BACKENDS:
            raise SystemExit(f"perfbench: the program has no tier "
                             f"{cfg['backend']!r} (it has {BACKENDS})")
        if len(devices) != int(cfg["cards"]):
            raise SystemExit(f"perfbench: the configuration's {cfg['cards']} "
                             f"cards are not the cell's {len(devices)} chips")
        super().__init__(cfg, traffic, graph, seed, seconds, devices,
                         registry)

    def judge(self, out: dict, limits: dict) -> dict:
        ref = ranks(self.graph, self.cfg, self.n_iters, self.devices).cpu()
        return checks.judge_solves(out["solves"], ref, self.top_k, limits)

    @staticmethod
    def control(cfg: dict, traffic: dict, graph, seed: int,
                seconds: float) -> dict:
        k, n_iters = int(traffic["top_k"]), int(cfg["n_iters"])
        devices = control_devices(cfg)
        x = ranks(graph, cfg, n_iters, devices, "tf32")
        ref = ranks(graph, cfg, n_iters, devices, "f64")
        return checks.judge_solves([(x, *checks.top(x, k))], ref, k, {})
