"""Live-serving PageRank over a streaming protein-interaction graph, on the
PyTorch port.

The port's counterpart of ``streaming_pagerank.py``: a Barabási–Albert
interactome evolves through timestamped edge arrivals and expiries
(``EdgeStream``), ``DynamicPageRankEngine`` folds each delta into its
prepared layout (Gauss–Southwell push for small deltas, a warm-started
tolerance loop or a rebuild when the auto policy escalates), and
``PageRankQueryEngine`` keeps serving batched personalized-PageRank
queries whose results are never staler than one refresh interval.  The
final ranks are held to a from-scratch solve (L1 <= 1e-4, or the run
fails).

Run:  PYTHONPATH=src python examples/torch_streaming_pagerank.py
      [--nodes N] [--device cpu] [--backend dense|ell|bsr|fused_dense|
      dense_sharded|ell_sharded] [--shards K] [--cache]
      add ``--jsonl events.jsonl --metrics-out metrics.json`` to record
      the run's observability stream (inspect with scripts/obs_report.py);
      the sharded tiers run on every visible card, or on ``--shards K``
      mesh positions all on ``--device``: deltas are patched into the
      shards that own them and the push runs shard-local
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.graph.delta import EdgeStream, apply_delta
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.pagerank import DynamicPageRankEngine, PageRankEngine
from repro_torch.pagerank.engine import (BACKENDS, SHARDED_BACKENDS,
                                         default_mesh)
from repro_torch.serve import PageRankQueryEngine, ResultCache


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=2000)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    ap.add_argument("--backend", default="ell", choices=BACKENDS,
                    help="engine layout tier")
    ap.add_argument("--shards", type=int, default=None,
                    help="the sharded tiers' mesh positions, all on "
                    "--device (default: one per visible card)")
    ap.add_argument("--jsonl", default=None,
                    help="append the live observability event log here")
    ap.add_argument("--metrics-out", default=None,
                    help="dump the final registry as_dict JSON here")
    ap.add_argument("--cache", action="store_true",
                    help="serve a Zipf-repeating query pool through the "
                         "delta-aware result cache; prints the hit rate "
                         "and gates cached answers against an exact "
                         "post-stream solve")
    args = ap.parse_args(argv)
    n = args.nodes

    metrics = MetricsRegistry(jsonl_path=args.jsonl)
    stream = EdgeStream(n, m_edges=4, seed=0, insert_per_step=6,
                        delete_per_step=4)
    src, dst = stream.base()
    mesh = (default_mesh(args.backend, args.device, args.shards)
            if args.backend in SHARDED_BACKENDS else None)
    engine = DynamicPageRankEngine(
        src, dst, n, backend=args.backend, metrics=metrics,
        device=None if mesh is not None else args.device, mesh=mesh)
    pr, iters, _ = engine.run_tol(1e-7)
    where = (f"mesh {dict(mesh.shape)} on "
             f"{sorted({str(d) for d in mesh.device_list})}"
             if mesh is not None else f"device {engine.device}")
    print(f"base graph: n={n}, edges={engine.n_edges}, "
          f"layout={engine.layout}, {where}, "
          f"cold solve {int(iters)} iters")

    # --cache: a Zipf-repeating pool of seed sets through the delta-aware
    # result cache (higher n_iters so cached answers pass the exact-parity
    # gate below); without the flag the serve path has no cache
    cache = pool = zipf = None
    cache_rng = np.random.default_rng(1)
    if args.cache:
        cache = ResultCache(capacity=32)
        pool = [np.sort(cache_rng.choice(n, size=3, replace=False))
                for _ in range(8)]
        zipf = 1.0 / np.arange(1, 9, dtype=np.float64) ** 1.1
        zipf /= zipf.sum()
    serve = PageRankQueryEngine(engine,
                                n_iters=100 if args.cache else 60,
                                max_batch=4, metrics=metrics, cache=cache)
    rng = np.random.default_rng(0)
    cur = (src, dst)
    for step, delta in zip(range(args.steps), stream):
        # cache mode interleaves deltas on alternate ticks: delta ticks
        # exercise the delta-aware invalidation, quiet ticks let the Zipf
        # repeats hit
        pushed = (not args.cache) or step % 2 == 0
        if pushed:
            serve.push_update(delta)      # edges arrive while queries queue
        queries = [serve.submit(uid=step * 10 + q,
                                seeds=(pool[cache_rng.choice(8, p=zipf)]
                                       if args.cache else
                                       rng.choice(n, size=3,
                                                  replace=False)),
                                top_k=5)
                   for q in range(3)]
        t0 = time.perf_counter()
        serve.flush()                     # refresh graph, then serve batch
        dt = (time.perf_counter() - t0) * 1e3
        info = serve.last_update_info
        if pushed:
            cur = apply_delta(cur[0], cur[1], delta, n)
            refresh = (f"+{delta.n_insert // 2}/-{delta.n_delete // 2} "
                       f"edges  refresh={info.strategy:7s} "
                       f"({info.iters:3d} sweeps, residual "
                       f"{info.residual:.1e})")
        else:
            refresh = "+0/-0 edges  refresh=  (skipped: quiet tick)"
        top = queries[0].result[0][:3]
        lag = metrics.gauge("serve.freshness_lag_s").value or 0.0
        print(f"t={delta.timestamp:4.1f}  {refresh}  "
              f"flush {dt:6.1f} ms  lag {lag:5.3f} s  "
              f"top proteins uid{queries[0].uid}: {top}")

    # the whole stream, cross-checked against a from-scratch engine
    scratch = PageRankEngine(cur[0], cur[1], n, backend="ell",
                             device=engine.device)
    ref = scratch.run_tol(1e-8, max_iters=1000)[0]
    l1 = float(torch.sum(torch.abs(engine.ranks - ref)))
    print(f"after {args.steps} deltas: L1(incremental, from-scratch) = "
          f"{l1:.2e}  (refreshes={serve.n_refreshes})")
    if l1 > 1e-4:       # incremental ranks must track a fresh solve
        raise SystemExit(f"parity failure: L1={l1:.2e} > 1e-4")
    h = metrics.histogram("serve.batch_ms").summary()
    if h["count"]:
        print(f"serve latency: n={h['count']}  p50={h['p50']:.1f} ms  "
              f"p95={h['p95']:.1f} ms")
    if args.cache:
        total = cache.hits + cache.misses
        print(f"result cache: {cache.hits}/{total} hits "
              f"({len(cache)} live entries, "
              f"{cache.invalidations} invalidated across "
              f"{serve.graph_version} graph versions)")
        if cache.hits == 0:     # a Zipf pool of 8 must repeat within a run
            raise SystemExit("cache smoke failure: zero hits")
        # every cached answer must match an exact solve of the FINAL graph
        entries = list(cache._entries.items())
        if entries:
            exact = scratch.ppr([list(k[1]) for k, _ in entries],
                                n_iters=300).cpu().numpy()
            worst = max(float(np.abs(e.ranks - exact[:, j]).sum())
                        for j, (_, e) in enumerate(entries))
            print(f"cached-vs-exact parity over {len(entries)} entries: "
                  f"L1 <= {worst:.2e}")
            if worst > 1e-4:
                raise SystemExit(
                    f"cache parity failure: L1={worst:.2e} > 1e-4")
    if args.metrics_out:
        metrics.dump_json(args.metrics_out)
        print(f"registry dump -> {args.metrics_out}")
    metrics.close()


if __name__ == "__main__":
    main()
