"""End-to-end PageRank launcher — the paper's own application, the port's
single-device tiers, one front door.

Every tier goes through :class:`~repro_torch.pagerank.engine
.PageRankEngine` (layout prepared once): the dense reference tier and the
tiers named by ``--backend`` (by default the split-ELL tier and the
fused-kernel tier; ``bsr`` is the block-sparse tier on its kernel), the
fused and ``bsr`` tiers at the chosen storage precision.  The sharded mesh
tiers (``dense_sharded``, ``ell_sharded``) run when the mesh has more than
one shard: over every visible card, or ``--shards K`` positions all on the
chosen device (as the JAX launcher's virtual devices do); with one device
they are skipped.  Prints each tier's max|diff| against dense, its ``run``
wall time, and the top-k proteins; a float32 tier that disagrees with
dense fails the run.  Last comes the paper's model of its own fabric
(``paper_fabric_model``, from :mod:`repro_torch.core.timing`), printed
apart from the card's times.

Usage (on the card; ``--device cpu`` runs the plain versions on the CPU):
    python -m repro_torch.launch.pagerank_run --nodes 5000 --iters 100
    python -m repro_torch.launch.pagerank_run --precision bf16
    python -m repro_torch.launch.pagerank_run --backend bsr
    python -m repro_torch.launch.pagerank_run --shards 4
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.pagerank_5k import full as pagerank_cfg
from repro_torch.core import timing
from repro_torch.graph import generators as gen
from repro_torch.graph import transition as tr
from repro_torch.kernels.common import resolve_device
from repro_torch.pagerank import PageRankEngine
from repro_torch.pagerank.engine import SHARDED_BACKENDS, default_mesh
from repro_torch.pagerank.precision import PRECISIONS
from repro_torch.pagerank.sparse import top_k_proteins


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_engine(eng: PageRankEngine, iters: int
                 ) -> tuple[float, torch.Tensor]:
    """Warm up (builds the kernels on first use), then time one run."""
    eng.run(n_iters=iters)
    _sync(eng.device)
    t0 = time.perf_counter()
    pr = eng.run(n_iters=iters)
    _sync(eng.device)
    return time.perf_counter() - t0, pr


def run(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=pagerank_cfg().n_nodes)
    ap.add_argument("--iters", type=int, default=pagerank_cfg().n_iters)
    ap.add_argument("--damping", type=float, default=pagerank_cfg().damping)
    ap.add_argument("--seed", type=int, default=pagerank_cfg().seed)
    ap.add_argument("--top-k", type=int, default=10)
    ap.add_argument("--precision", choices=PRECISIONS, default="f32",
                    help="storage precision of the fused and bsr tiers' "
                    "layouts")
    ap.add_argument("--backend", action="append",
                    choices=("ell", "bsr", "fused_dense"),
                    help="a tier to run beside dense (repeatable; default: "
                    "ell and fused_dense)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--shards", type=int, default=None,
                    help="run the sharded tiers on this many mesh positions, "
                    "all on --device (default: one per visible card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    n, iters, d = args.nodes, args.iters, args.damping
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"protein network: {n} nodes (BA scale-free + noise), "
          f"{iters} iterations, d={d}, device {device} ({name})")
    src, dst = gen.protein_network(n, seed=args.seed)
    print(f"  edges (directed): {len(src):,}   "
          f"dangling: {int(tr.dangling_mask(src, n).sum())}")

    results = {}
    eng_dense = PageRankEngine(src, dst, n, d=d, backend="dense",
                               device=device)
    results["engine_dense"], pr_dense = _time_engine(eng_dense, iters)

    for backend in args.backend or ("ell", "fused_dense"):
        precision = "f32" if backend == "ell" else args.precision
        eng = PageRankEngine(src, dst, n, d=d, backend=backend,
                             precision=precision, device=device)
        results[f"engine_{eng.layout}"], pr = _time_engine(eng, iters)
        err = float(torch.max(torch.abs(pr - pr_dense)))
        print(f"  engine[{eng.layout}] vs dense: max|diff|={err:.2e}")
        if precision == "f32":
            torch.testing.assert_close(pr_dense, pr, rtol=1e-3, atol=1e-7)

    # sharded mesh tiers: the same front door, any device topology
    n_dev = (args.shards if args.shards is not None
             else torch.cuda.device_count() if device.type == "cuda" else 1)
    if n_dev > 1:
        for backend in SHARDED_BACKENDS:
            mesh = default_mesh(backend, device, args.shards)
            eng = PageRankEngine(src, dst, n, d=d, backend=backend,
                                 mesh=mesh)
            results[f"engine_{backend}"], pr = _time_engine(eng, iters)
            err = float(torch.max(torch.abs(pr - pr_dense)))
            print(f"  engine[{eng.layout}] vs dense: max|diff|={err:.2e} "
                  f"(mesh devices {[str(v) for v in mesh.device_list]})")
            torch.testing.assert_close(pr_dense, pr, rtol=1e-3, atol=1e-7)
    else:
        print("  (single device: sharded tiers skipped — pass --shards 8 to "
              "exercise them)")

    idx, scores = top_k_proteins(pr_dense, k=args.top_k)
    print(f"\ntop-{args.top_k} proteins: "
          f"{[(int(i), round(float(s), 5)) for i, s in zip(idx, scores)]}")
    print(f"\nrun({iters}) wall time on {name}:")
    for k, v in results.items():
        print(f"  {k:>40}: {v * 1e3:9.2f} ms")
    # the paper's model of its fabric, not a time of this device
    results["paper_fabric_model"] = timing.pagerank_latency_s(n, iters)
    print(f"\npaper_fabric_model (the paper's model of its own fabric, "
          f"N={n}, {iters} iters): "
          f"{results['paper_fabric_model'] * 1e3:.2f} ms")
    print("  (paper reports 213.6 ms for N=5000, 100 iters @200MHz, "
          "4096 sites)")
    return results


if __name__ == "__main__":
    run()
