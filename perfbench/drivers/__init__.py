"""How a traffic mix drives the program: one module per driver, found by
the mix's ``"driver"`` (``drivers/<name>.py``).

A driver module holds one class ``Driver``, a subclass of :class:`Driver`
below.  Its constructor builds the program and warms up every shape its
traffic uses (set-up).  Then ``window()`` runs the timed window,
``stretch(seconds, stream)`` runs a further stretch of the same traffic
(traced; ``stream`` names the draws of an open loop, so that two stretches
send different requests) and returns the ``requests`` it sent (solves,
queries, ticks) and its ``calls``, ``outputs()`` hands over what the window
produced and drops the program, and ``judge(out, limits)`` holds it to the
plain reference (:mod:`perfbench.checks`).  Its static ``control(cfg,
traffic, graph, seed, seconds)`` returns the numbers that the same
comparison gives for the control: the reference, in the next precision
down, in the program's place (:mod:`perfbench.control`).

A driver keeps in ``rec`` what the metric readers read, among them
``attempted``, the requests of the window, and ``calls``, its solves,
flushes or refreshes.

A driver is handed the cell's devices (``devices``, one per chip; the
first is its ``device``).  Over several, the engine is built on a mesh of
them (:func:`cell_mesh`); with one it gets no mesh.  Every wait is on all
of them (:func:`sync_all`).
"""
from __future__ import annotations

import math
import sys
import time
import traceback

import torch

from perfbench import find, loadgen


def load(name: str):
    """The class ``Driver`` of ``drivers/<name>.py``."""
    return find("drivers", name).Driver


def sync_all(devices) -> None:
    """Wait for every CUDA card among ``devices``, each once."""
    for dev in dict.fromkeys(torch.device(d) for d in devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def cell_mesh(backend: str, devices):
    """The sharded tiers' mesh over the cell's own devices, never over
    every visible card: 1-D (``shard``) for ``ell_sharded``, else the
    near-square 2-D (``row``, ``col``) mesh of the program's
    ``default_mesh``."""
    from repro_torch.launch.mesh import make_mesh
    n = len(devices)
    if backend == "ell_sharded":
        return make_mesh((n,), ("shard",), devices)
    r = math.isqrt(n)
    while n % r:
        r -= 1
    return make_mesh((r, n // r), ("row", "col"), devices)


class Reservoir:
    """A uniform sample of ``k`` items of a stream of unknown length,
    drawn from the run's seed, plus the stream's last item."""

    def __init__(self, k: int, rng):
        self.k, self.rng = int(k), rng
        self.items: list = []
        self.seen = 0
        self.last = None

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1
        self.last = item

    def sample(self) -> list:
        return self.items + ([self.last] if self.last is not None
                             and all(i is not self.last for i in self.items)
                             else [])


class Driver:
    def __init__(self, cfg: dict, traffic: dict, graph, seed: int,
                 seconds: float, devices, registry):
        self.cfg, self.traffic, self.graph = cfg, traffic, graph
        self.seed, self.seconds = seed, float(seconds)
        self.devices, self.registry = list(devices), registry
        self.device = self.devices[0]
        self.d = float(cfg["d"])
        self.top_k = int(traffic["top_k"])
        self.rec: dict = {"spans": {}, "graph": {
            "n_connected": graph.n_connected,
            "n_undirected": graph.n_undirected}}

    def _engine(self, cls, **kw):
        if len(self.devices) > 1:
            kw["mesh"] = cell_mesh(self.cfg["backend"], self.devices)
        t0 = time.perf_counter()
        eng = cls(self.graph.src, self.graph.dst, self.graph.n, d=self.d,
                  backend=self.cfg["backend"],
                  precision=self.cfg["precision"], device=self.device,
                  metrics=self.registry, **kw)
        sync_all(self.devices)
        self.rec["spans"]["prepare"] = [time.perf_counter() - t0]
        return eng

    def _counters(self) -> dict:
        return dict(self.registry.as_dict()["counters"])

    def timed(self) -> dict:
        """The measured window, with the program's counters over it."""
        before = self._counters()
        self.window()
        after = self._counters()
        self.rec["counters"] = {k: v - before.get(k, 0)
                                for k, v in after.items()}
        return self.rec


class Served(Driver):
    """What the open-loop drivers share: the serve engine in front of an
    engine, its warm-up, the plan of an open loop, and how a failed call
    is recorded."""

    def _serve_engine(self, eng) -> None:
        from repro_torch.pagerank import LandmarkIndex
        from repro_torch.serve import PageRankQueryEngine, ResultCache
        t = self.traffic
        self.landmarks = LandmarkIndex(eng, n_hubs=int(t["landmark_hubs"]),
                                       metrics=self.registry)
        self.qe = PageRankQueryEngine(
            eng, n_iters=int(t["n_iters"]), max_batch=int(t["max_batch"]),
            cache=ResultCache(int(t["cache_capacity"])),
            landmarks=self.landmarks, metrics=self.registry,
            **({"refresh_tol": float(t["refresh_tol"])}
               if "refresh_tol" in t else {}))

    def _warm_queries(self, eng) -> None:
        """Every query block the serve path can issue: the landmark push
        at 1 to ``max_batch`` queries (it pads to a power of two) and the
        exact fallback at each count; the cache is not touched."""
        self.landmarks.build(0)
        rng = loadgen.rng_for(self.seed, "warm")
        for q in range(1, int(self.traffic["max_batch"]) + 1):
            sets = [rng.choice(self.graph.n, size=2, replace=False)
                    for _ in range(q)]
            self.landmarks.answer(sets)
            eng.ppr(sets, n_iters=int(self.traffic["n_iters"])).cpu()
        sync_all(self.devices)

    def _queries(self, seconds: float, stream: str) -> tuple:
        return loadgen.plan(self.graph, self.traffic, self.seed, seconds,
                            stream)

    def _fail(self, err: BaseException) -> None:
        self.rec.setdefault("errors", []).append(repr(err))
        if len(self.rec["errors"]) == 1:
            traceback.print_exception(err, file=sys.stderr)
