#!/usr/bin/env python3
"""The sharded mesh tiers across several CUDA cards, held to the same tiers
on a mesh of one card.

Run from the repository root on a machine with two or more cards:

    python3 scripts/mesh_cards_check.py [--devices cuda:0,cuda:1,...]

On the paper's config (``protein_network(5000, seed=0)``, 100 iterations,
d = 0.85) it builds ``dense_sharded`` on a near-square mesh over the
devices (default: every visible card) and ``ell_sharded`` over them, and
beside each the same tier on a mesh of the same shape whose positions all
lie on the first device.  For each tier it checks that every shard lies on
its position's device, then runs ``run(100)`` (K2 launched once per shard
per iteration on ``dense_sharded``), ``run_tol(1e-6)``, ``ppr`` of 8 seed
sets, a 16-hub landmark build with one answer, and one push update of the
dynamic engine, each held to the one-device mesh (rtol 1e-5, atol 1e-7;
iterations and sweeps within 1) and ``run(100)`` to the ``dense`` tier; and
it times ``run(100)`` on both meshes (host clock, median of 5 with the
smallest and largest).  Then ``ell_split_sharded`` on a 2 x 2 mesh over
four devices, beside four positions of the first, on the ``graph500_26``
configuration's graph at ``--split-scale`` (default 22, seed 0): every
block on its position's device, ``run(10)`` bit-equal to the one-device
mesh (the exchange only copies) and within rtol 1e-5, atol 1e-7 of the
``ell`` tier, ``run_tol(1e-7)`` within the same of the one-device mesh,
and ``run(10)`` timed on both.  It prints one line per check and, last,
one JSON
object; it exits non-zero if a check fails, and without CUDA unless
``--devices`` names CPU positions (a rehearsal).
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

N_NODES, N_ITERS, DAMPING, SEED = 5000, 100, 0.85, 0
TOL = dict(rtol=1e-5, atol=1e-7)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--devices", default=None,
                        help="comma-separated devices (default: every card)")
    parser.add_argument("--split-scale", type=int, default=22,
                        help="scale of the ell_split_sharded check's graph")
    args = parser.parse_args()
    import numpy as np
    import torch
    if args.devices is None:
        if not torch.cuda.is_available():
            print("mesh_cards_check: CUDA is not available",
                  file=sys.stderr)
            return 2
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    else:
        devices = args.devices.split(",")
    if len(devices) < 2:
        print(f"mesh_cards_check: needs two or more devices, got "
              f"{devices}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.graph.delta import GraphDelta, apply_delta, edge_keys
    from repro_torch.graph.generators import protein_network
    from repro_torch.kernels import streaming_matvec as k2
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.obs.registry import NullRegistry
    from repro_torch.pagerank import (DynamicPageRankEngine, LandmarkIndex,
                                      PageRankEngine)

    def sync():
        for d in {torch.device(x) for x in devices}:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def wall(fn):
        fn()
        sync()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        return {"median_ms": statistics.median(times), "min_ms": min(times),
                "max_ms": max(times)}

    failed = []

    def check(cond, what):
        print(f"  {'ok  ' if cond else 'FAIL'} {what}")
        if not cond:
            failed.append(what)

    def close(a, b, what):
        err = float((a.cpu() - b.cpu()).abs().max())
        check(bool(torch.allclose(a.cpu(), b.cpu(), **TOL)),
              f"{what}: max|diff| {err:.3e}")
        return err

    k = len(devices)
    r = int(math.isqrt(k))
    while k % r:
        r -= 1
    meshes = {"dense_sharded": ((r, k // r), ("row", "col")),
              "ell_sharded": ((k,), ("shard",))}
    src, dst = protein_network(N_NODES, seed=SEED)
    rng = np.random.default_rng(SEED)
    sets = [rng.choice(N_NODES, size=3, replace=False) for _ in range(8)]
    dense = PageRankEngine(src, dst, N_NODES, d=DAMPING, backend="dense",
                           device=devices[0], metrics=NullRegistry())
    ref_pr = dense.run(N_ITERS)
    have = set(edge_keys(src, dst, N_NODES).tolist())
    pairs = []
    while len(pairs) < 3:
        u, v = (int(x) for x in rng.integers(0, N_NODES, 2))
        if u != v and u * N_NODES + v not in have:
            pairs.append((u, v))
    iu, iv = np.array(pairs).T
    delta = GraphDelta(iu, iv, src[:2], dst[:2])
    fresh = PageRankEngine(*apply_delta(src, dst, delta, N_NODES), N_NODES,
                           d=DAMPING, backend="dense", device=devices[0],
                           metrics=NullRegistry()).run(300)
    out = {"devices": devices, "tiers": {}}
    for backend, (shape, axes) in meshes.items():
        print(f"{backend}: mesh {shape} over {devices}, beside the same "
              f"shape on {devices[0]}")
        got = {}
        for name, devs in (("cards", devices), ("one", [devices[0]] * k)):
            mesh = make_mesh(shape, axes, devs)
            eng = PageRankEngine(src, dst, N_NODES, d=DAMPING,
                                 backend=backend, mesh=mesh,
                                 metrics=NullRegistry())
            placed = all(s.device == torch.device(d) for o in eng.operands
                         for s, d in zip(o.shards, devs))
            k2.reset_launches()
            pr = eng.run(N_ITERS)
            sync()
            launched = sum(k2.launches.values())
            res = eng.run_tol(tol=1e-6, max_iters=1000)
            X = eng.ppr(sets, N_ITERS)
            lm = LandmarkIndex(eng, n_hubs=16, tol=1e-7, n_iters=N_ITERS,
                               metrics=NullRegistry())
            lm.build(0)
            A, info = lm.answer(sets[:2])
            dyn = DynamicPageRankEngine(src, dst, N_NODES, d=DAMPING,
                                        backend=backend, mesh=mesh,
                                        metrics=NullRegistry())
            dyn.run_tol(1e-7, max_iters=1000)
            upr, uinfo = dyn.update(delta)
            got[name] = dict(placed=placed, pr=pr, res=res, X=X, lm=lm,
                             A=torch.from_numpy(A), info=info, upr=upr,
                             uinfo=uinfo, launched=launched,
                             wall=wall(lambda e=eng: e.run(N_ITERS)))
        c, o = got["cards"], got["one"]
        check(c["placed"], "every shard on its position's card")
        tiles = k if backend == "dense_sharded" else 0
        check(c["launched"] == tiles * N_ITERS,
              f"run({N_ITERS}) launched K2 {c['launched']} times, want "
              f"{tiles * N_ITERS}")
        errs = {"run": close(c["pr"], o["pr"], "run vs one card"),
                "run_vs_dense": close(c["pr"], ref_pr, "run vs dense"),
                "run_tol": close(c["res"].pr, o["res"].pr,
                                 "run_tol vs one card"),
                "ppr": close(c["X"], o["X"], "ppr(8) vs one card"),
                "landmarks": close(torch.from_numpy(c["lm"]._Y),
                                   torch.from_numpy(o["lm"]._Y),
                                   "landmark hub columns vs one card"),
                "answer": close(c["A"], o["A"], "landmark answer vs one "
                                "card"),
                "update": close(c["upr"], o["upr"], "push update vs one "
                                "card")}
        check(abs(c["res"].info.iters - o["res"].info.iters) <= 1,
              f"run_tol iterations {c['res'].info.iters} vs "
              f"{o['res'].info.iters}")
        check(abs(c["info"]["sweeps"] - o["info"]["sweeps"]) <= 1,
              "landmark answer sweeps within 1")
        check(c["uinfo"].strategy == o["uinfo"].strategy == "push",
              f"update strategies {c['uinfo'].strategy} / "
              f"{o['uinfo'].strategy}")
        l1 = float(torch.sum(torch.abs(c["upr"].cpu() - fresh.cpu())))
        check(l1 <= 1e-5, f"update L1 vs a fresh solve {l1:.3e}")
        print(f"  run({N_ITERS}) wall, median of 5 [min, max]: across "
              f"cards {c['wall']['median_ms']:.3f} ms "
              f"[{c['wall']['min_ms']:.3f}, {c['wall']['max_ms']:.3f}], "
              f"one card {o['wall']['median_ms']:.3f} ms "
              f"[{o['wall']['min_ms']:.3f}, {o['wall']['max_ms']:.3f}]")
        out["tiers"][backend] = {
            "mesh": list(shape), "max_abs_diff": errs,
            "run_tol_iters": [c["res"].info.iters, o["res"].info.iters],
            "update_l1_vs_fresh": l1, "k2_launches_run": c["launched"],
            "run_wall_cards": c["wall"], "run_wall_one_device": o["wall"]}
    if k == 4:
        out["tiers"]["ell_split_sharded"] = split_check(
            torch, devices, args.split_scale, check, wall)
    if all(torch.device(d).type == "cuda" for d in devices):
        import subprocess
        out["cards"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    out["failed"] = failed
    print(json.dumps(out))
    return 1 if failed else 0


def split_check(torch, devices, scale, check, wall) -> dict:
    """``ell_split_sharded`` on four devices beside four positions of the
    first, and beside the ``ell`` tier on the first."""
    sys.path.insert(0, str(ROOT))
    from perfbench.graphs import kronecker_chunked
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.obs.registry import NullRegistry
    from repro_torch.pagerank import PageRankEngine

    cfg = json.loads((ROOT / "perfbench" / "configs"
                      / "graph500_26.json").read_text())
    g = kronecker_chunked.make({**cfg, "scale": scale}, SEED, devices[0])
    print(f"ell_split_sharded: 2 x 2 over {devices}, beside 4 positions of "
          f"{devices[0]}; graph500_26 at scale {scale}: n {g.n}, "
          f"{len(g.src)} directed entries")
    got = {}
    for name, devs in (("cards", devices), ("one", [devices[0]] * 4)):
        eng = PageRankEngine(g.src, g.dst, g.n, d=cfg["d"],
                             backend="ell_split_sharded",
                             mesh=make_mesh((2, 2), ("row", "col"), devs),
                             metrics=NullRegistry())
        placed = all(t.device == torch.device(d)
                     for ops, d in zip(eng.operands, devs) for t in ops)
        got[name] = dict(placed=placed, pr=eng.run(10),
                         res=eng.run_tol(1e-7, max_iters=1000),
                         wall=wall(lambda e=eng: e.run(10)))
        del eng
    c, o = got["cards"], got["one"]
    ell = PageRankEngine(g.src, g.dst, g.n, d=cfg["d"], backend="ell",
                         device=devices[0], metrics=NullRegistry()).run(10)
    check(c["placed"], "every block on its position's device")
    check(bool(torch.equal(c["pr"].cpu(), o["pr"].cpu())),
          "run(10) bit-equal to the one-device mesh")
    err = float((c["pr"].cpu() - ell.cpu()).abs().max())
    check(bool(torch.allclose(c["pr"].cpu(), ell.cpu(), **TOL)),
          f"run(10) vs the ell tier: max|diff| {err:.3e}")
    err_tol = float((c["res"].pr.cpu() - o["res"].pr.cpu()).abs().max())
    check(bool(torch.allclose(c["res"].pr.cpu(), o["res"].pr.cpu(), **TOL)),
          f"run_tol vs the one-device mesh: max|diff| {err_tol:.3e}")
    print(f"  run(10) wall, median of 5 [min, max]: across devices "
          f"{c['wall']['median_ms']:.3f} ms [{c['wall']['min_ms']:.3f}, "
          f"{c['wall']['max_ms']:.3f}], one device "
          f"{o['wall']['median_ms']:.3f} ms [{o['wall']['min_ms']:.3f}, "
          f"{o['wall']['max_ms']:.3f}]")
    return {"mesh": [2, 2], "scale": scale, "n": g.n,
            "entries": len(g.src), "max_abs_diff_vs_ell": err,
            "run_tol_max_abs_diff": err_tol,
            "run_tol_iters": [c["res"].info.iters, o["res"].info.iters],
            "run_wall_cards": c["wall"], "run_wall_one_device": o["wall"]}


if __name__ == "__main__":
    sys.exit(main())
