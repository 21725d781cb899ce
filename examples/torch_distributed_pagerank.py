"""Distributed PageRank through the one engine front door, on the PyTorch
port: the paper's fabric schedule as collectives on a 4 x 4 mesh.

The port's counterpart of ``distributed_pagerank.py``.  The vertical bus is
the ``P('model')`` layout of the rank vector, the horizontal bus the psum
over the mesh row, and the adder-column re-injection the diagonal
broadcast.  ``dense_sharded`` cuts H into 16 tiles once; each iteration
is one launch of the streaming kernel (K2) per tile on the card.  One
process drives the mesh: its 16 positions all lie on ``--device`` (a 4 x 4
mesh of one card, or of the CPU), which runs the real schedule but is not
16 devices.  Prints the schedule's collectives per iteration
(``PageRankEngine.lower_run``) and serves a query-sharded PPR batch.

Run:  PYTHONPATH=src python examples/torch_distributed_pagerank.py
      [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.graph import generators as gen
from repro_torch.launch.mesh import make_mesh
from repro_torch.pagerank import PageRankEngine
from repro_torch.serve import PageRankQueryEngine


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device of every mesh position "
                    "(default: cuda)")
    args = ap.parse_args(argv)
    n, iters = 1024, 100
    mesh = make_mesh((4, 4), ("data", "model"), [args.device] * 16)
    print(f"mesh: {mesh.shape} over {mesh.size} positions, devices "
          f"{sorted({str(d) for d in mesh.device_list})}")

    src, dst = gen.protein_network(n, seed=3)
    eng = PageRankEngine(src, dst, n, backend="dense_sharded", mesh=mesh)
    H = eng.operands[0]
    print(f"H: {H.shape} sharded {H.spec} -> {tuple(H.shards[0].shape)} "
          f"per position [{eng.layout}]")

    eng.run(n_iters=iters)                   # builds the kernels on a card
    _sync(eng.device)
    t0 = time.perf_counter()
    pr = eng.run(n_iters=iters)
    _sync(eng.device)
    dt = time.perf_counter() - t0

    ref = PageRankEngine(src, dst, n, backend="dense",
                         device=eng.device).run(n_iters=iters)
    np.testing.assert_allclose(pr.cpu().numpy(), ref.cpu().numpy(),
                               rtol=2e-4, atol=1e-8)
    sched = eng.lower_run()
    c = sched["collectives"]
    n_ar = c.get("psum", 0) + c.get("psum_masked", 0)
    print(f"{iters} fabric-schedule iterations: {dt * 1e3:.1f} ms "
          f"({mesh.size} positions on {eng.device})")
    print(f"collectives per iteration: all-reduce x{n_ar} "
          f"(horizontal bus + diagonal re-injection); by kind {c}, bytes "
          f"{sched['bytes']}; K2 launches {sched['k2_launches']}")
    print("distributed == single-device reference: OK")

    # the same prepared engine serves multi-user personalized PageRank with
    # the (N, Q) batch sharded over the mesh's query axis
    qe = PageRankQueryEngine(eng, n_iters=40, max_batch=8)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    results = qe.query_batch(
        [rng.choice(n, size=3, replace=False) for _ in range(8)], top_k=5)
    dt = time.perf_counter() - t0
    print(f"8-user PPR batch, query-sharded over the mesh: "
          f"{dt * 1e3:.1f} ms -> top-1 proteins "
          f"{[int(idx[0]) for idx, _ in results]}")


if __name__ == "__main__":
    main()
