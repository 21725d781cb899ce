"""Live-serving PageRank under fault injection, on the PyTorch port.

The port's counterpart of `faulty_stream_pagerank.py`, with the same
8-step script, prints and exit code: a seeded `FaultInjector` interleaves
every fault class the resilience layer must survive — malformed deltas
(out-of-range / negative / NaN ids, self-loops, duplicate floods),
corrupted device layouts (NaN and scaled operands that trip the
convergence watchdog), and forced update-step exceptions.  The resilient
`PageRankQueryEngine` quarantines bad edges into its dead-letter queue,
drives recovery through the retry → rebuild → restore-snapshot ladder,
and keeps serving finite sum-to-1 results tagged fresh/stale/degraded.
A fault of the card itself (a kernel that does not build or launch, a
CUDA error) is not turned into a status: it ends the run.

Exits non-zero if any serve fails its health check or the final ranks
diverge from a from-scratch engine built on the accepted edges.

Run:  PYTHONPATH=src python examples/torch_faulty_stream_pagerank.py
      [--nodes N] [--device cpu] [--backend ell|fused_dense|bsr|dense]
      ``--backend fused_dense`` runs the solves on the fused step kernel
      and the pushes and serves on the streaming matvec kernel, ``bsr``
      all of them on the BSR kernel (on the card); add ``--jsonl
      events.jsonl --metrics-out metrics.json`` to record the run's
      observability stream (inspect with scripts/obs_report.py)
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.graph.delta import EdgeStream, apply_delta
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.pagerank import (DynamicPageRankEngine, FaultInjector,
                                  PageRankEngine)
from repro_torch.pagerank.resilience import ranks_healthy
from repro_torch.serve import PageRankQueryEngine, ServeResilience


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    ap.add_argument("--backend", default="ell",
                    choices=["dense", "ell", "fused_dense", "bsr"],
                    help="the live engine's layout tier")
    ap.add_argument("--jsonl", default=None,
                    help="append the event log to this JSONL file")
    ap.add_argument("--metrics-out", default=None,
                    help="write the registry's final dump to this JSON file")
    args = ap.parse_args(argv)
    n = args.nodes

    reg = MetricsRegistry(jsonl_path=args.jsonl)
    stream = EdgeStream(n, m_edges=4, seed=args.seed, insert_per_step=4,
                        delete_per_step=0)
    src, dst = stream.base()
    cur = (src, dst)
    engine = DynamicPageRankEngine(src, dst, n, backend=args.backend,
                                   device=args.device, metrics=reg)
    pr, iters, _ = engine.run_tol(1e-7)
    serve = PageRankQueryEngine(engine, n_iters=60, max_batch=4,
                                resilience=ServeResilience(), metrics=reg)
    inj = FaultInjector(seed=args.seed)
    rng = np.random.default_rng(args.seed)
    print(f"base graph: n={n}, edges={engine.n_edges}, "
          f"cold solve {int(iters)} iters; injector seed={args.seed}")

    failures = 0
    script = [
        ("delta", "out_of_range"), ("delta", "negative"),
        ("layout", "nan"), ("delta", "self_loop"),
        ("update", None), ("delta", "nan"),
        ("layout", "scale"), ("delta", "dup_flood"),
    ]
    for step, (klass, kind) in enumerate(script):
        # a clean stream tick always rides along with the injected fault
        good = stream.step()
        serve.push_update(good)
        cur = apply_delta(cur[0], cur[1], good, n)
        if klass == "delta":
            res = serve.push_update(inj.corrupt_delta(n, kind=kind))
            if res.delta is not None:          # valid remainder proceeds
                cur = apply_delta(cur[0], cur[1], res.delta, n)
        elif klass == "layout":
            inj.corrupt_layout(engine, kind=kind)
        elif klass == "update":
            inj.fail_next_updates(engine, times=1)

        queries = [serve.submit(uid=step * 10 + q,
                                seeds=rng.choice(n, size=3, replace=False),
                                top_k=5)
                   for q in range(2)]
        serve.flush()                          # raises only a card fault
        outcome = serve.last_refresh_outcome
        ok = all(np.isfinite(q.result[1]).all() and q.status != "unserved"
                 for q in queries)
        failures += 0 if ok else 1
        print(f"step {step}: fault={klass}:{kind or 'raise':>12s}  "
              f"refresh={outcome.status:9s} (attempts={outcome.attempts})  "
              f"served status={queries[0].status:8s} "
              f"v{queries[0].graph_version}  healthy={ok}")

    print(f"dead letters: {serve.dead_letters.counts()} "
          f"(total_seen={serve.dead_letters.total_seen})")
    print(f"injector log: {len(inj.log)} faults -> {inj.log}")

    # acceptance: the survivor matches a from-scratch engine on the edges
    # that were actually accepted
    ref = PageRankEngine(cur[0], cur[1], n, backend="ell",
                         device=args.device).run_tol(1e-7,
                                                     max_iters=1000)[0]
    l1 = float((engine.ranks - ref).abs().sum())
    healthy = ranks_healthy(engine.ranks)
    print(f"after {len(script)} faulted steps: healthy={healthy}, "
          f"L1(live, from-scratch) = {l1:.2e}")
    if args.metrics_out:
        reg.dump_json(args.metrics_out)
    reg.close()
    if failures or not healthy or l1 > 1e-5:
        print("FAULT-INJECTION SMOKE: FAIL", file=sys.stderr)
        return 1
    print("FAULT-INJECTION SMOKE: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
