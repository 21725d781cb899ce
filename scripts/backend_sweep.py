#!/usr/bin/env python3
"""The single-device tiers of the PyTorch port against graph density, on one
CUDA card: the table that sets ``select_backend``'s CUDA branch.

Run from the repository root:

    python3 scripts/backend_sweep.py [--out FILE]

For every N in ``SIZES`` and density in ``DENSITIES`` it draws a symmetric
G(n, p) graph (no self-loops, from one numpy seed), builds a
``PageRankEngine`` on each of the ``dense``, ``ell``, ``bsr`` and
``fused_dense`` tiers (float32) and times ``run(100)``: wall time from the
host with the card synchronised before and after, one warm-up call, then
the median of 5 with the smallest and largest beside it.  Each tier's ranks
are held to the ``dense`` tier's (rtol 1e-4, atol 1e-7).  A cell with more
than ``MAX_EDGES`` directed edges is skipped and listed as such: the
host's layout build is the slow part there.

It prints one line per cell and, last, one JSON object with every cell, the
card's name and power limit, and for each N the smallest density at which a
dense tier beats both sparse tiers; the same object goes to ``--out``
(default ``build/backend_sweep/table.json``).  It needs a card; without one
it exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import nvidia_smi  # noqa: E402

SIZES = (1000, 5000, 10000)
DENSITIES = (0.001, 0.01, 0.05, 0.2, 0.5)
TIERS = ("dense", "ell", "bsr", "fused_dense")
N_ITERS = 100
REPEATS = 5
SEED = 0
MAX_EDGES = 25_000_000


def gnp(np, n: int, density: float, seed: int):
    """A symmetric G(n, p) edge list with p = density (no self-loops)."""
    rng = np.random.default_rng(seed)
    upper = np.triu(rng.random((n, n), dtype=np.float32) < density, k=1)
    src, dst = np.nonzero(upper | upper.T)
    return src.astype(np.int32), dst.astype(np.int32)


def timed(torch, fn) -> dict:
    """Wall time of ``fn`` in ms: one warm-up call, then the median of
    ``REPEATS`` with the card synchronised around each call."""
    fn()
    times = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return {"median_ms": statistics.median(times), "min_ms": min(times),
            "max_ms": max(times)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=str(ROOT / "build" / "backend_sweep"
                                             / "table.json"))
    args = parser.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("backend_sweep: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.obs.registry import NullRegistry
    from repro_torch.pagerank import PageRankEngine

    card = nvidia_smi()
    print(f"card: {card}; run({N_ITERS}) wall time, median of {REPEATS}")
    dev = torch.device("cuda")
    t_script = time.perf_counter()
    cells = []
    failed = 0
    for n in SIZES:
        for density in DENSITIES:
            expected = density * n * (n - 1)
            if expected > MAX_EDGES:
                cells.append({"n": n, "density": density,
                              "skipped": f"about {expected:.0f} edges > "
                                         f"MAX_EDGES {MAX_EDGES}"})
                print(f"  N={n} p={density}: skipped "
                      f"({cells[-1]['skipped']})")
                continue
            src, dst = gnp(np, n, density, SEED + n)
            cell = {"n": n, "density": density, "edges": int(len(src)),
                    "measured_density": len(src) / float(n * n)}
            ranks = {}
            for tier in TIERS:
                t0 = time.perf_counter()
                eng = PageRankEngine(src, dst, n, backend=tier, device=dev,
                                     metrics=NullRegistry())
                torch.cuda.synchronize()
                build_s = time.perf_counter() - t0
                cell[tier] = dict(timed(torch, lambda e=eng: e.run(N_ITERS)),
                                  build_s=build_s)
                ranks[tier] = eng.run(N_ITERS)
                del eng
            for tier in TIERS[1:]:
                ok = bool(torch.allclose(ranks[tier], ranks["dense"],
                                         rtol=1e-4, atol=1e-7))
                cell[tier]["agrees_with_dense"] = ok
                failed += not ok
            cell["fastest"] = min(TIERS, key=lambda t: cell[t]["median_ms"])
            cells.append(cell)
            print(f"  N={n} p={density} ({cell['edges']} edges): "
                  + ", ".join(f"{t} {cell[t]['median_ms']:.3f} ms "
                              f"[{cell[t]['min_ms']:.3f}, "
                              f"{cell[t]['max_ms']:.3f}]" for t in TIERS)
                  + f"; fastest {cell['fastest']}")
            del ranks
            torch.cuda.empty_cache()
    crossover = {}
    for n in SIZES:
        dense_wins = [c["density"] for c in cells
                      if c["n"] == n and "fastest" in c
                      and c["fastest"] in ("dense", "fused_dense")]
        crossover[n] = min(dense_wins) if dense_wins else None
    table = {"card": card, "torch": torch.__version__,
             "n_iters": N_ITERS, "repeats": REPEATS, "cells": cells,
             "dense_wins_from_density": crossover,
             "seconds": time.perf_counter() - t_script}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(table, indent=1))
    print(json.dumps(table))
    if failed:
        print(f"backend_sweep: {failed} tier runs disagree with dense",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
