"""Run the port's multi-pod dry run (``repro_torch.launch.dryrun``) over
every (architecture x shape x mesh) cell of the pod and multi-pod
meshes, one command-line process per cell, as many at a time as the host
has cores, and print the records as markdown tables.

The dry run is host-only (meta tensors) and single-threaded, so the cells
run side by side; the MoE cells, whose ``moe_ep`` runs once per mesh
position, start first.  Each process writes its record to ``--out`` and
its output to ``--out``/logs.

Usage:
    PYTHONPATH=src python scripts/torch_dryrun_sweep.py --out DIR
    PYTHONPATH=src python scripts/torch_dryrun_sweep.py --out DIR --report

The first prints one row per cell, then the summary of ``--report``; it
exits non-zero when a cell fails, after listing it with its error.
``--report`` runs nothing: it prints the records already in ``--out``,
one row per architecture (pod / multi-pod side by side), and a table of
``moe_ep``'s collectives.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import (ARCH_IDS, applicable_shapes,  # noqa: E402
                                 get_config)

CARD_BYTES = 80e9           # an H100's device memory


def _cost(cell) -> tuple:
    """Longest first: MoE, then the larger mesh, then training."""
    arch, shape, mesh = cell
    return (get_config(arch).family != "moe", mesh != "multipod",
            shape != "train_4k")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--report", action="store_true")
    args = ap.parse_args()
    out = Path(args.out)
    if args.report:
        return report(out)
    (out / "logs").mkdir(parents=True, exist_ok=True)
    jobs = os.cpu_count() or 1
    cells = sorted(((a, s, m) for a in ARCH_IDS
                    for s in applicable_shapes(get_config(a))
                    for m in ("pod", "multipod")), key=_cost)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    pending, running, wall = list(cells), {}, {}
    while pending or running:
        while pending and len(running) < jobs:
            cell = pending.pop(0)
            log = open(out / "logs" / ("_".join(cell) + ".log"), "w")
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", cell[0], "--shape", cell[1], "--mesh", cell[2],
                   "--out", str(out)]
            running[cell] = (subprocess.Popen(cmd, stdout=log,
                                              stderr=subprocess.STDOUT,
                                              env=env, cwd=ROOT), log,
                             time.perf_counter())
        time.sleep(0.5)
        for cell, (proc, log, t) in list(running.items()):
            if proc.poll() is not None:
                log.close()
                wall[cell] = (time.perf_counter() - t, proc.returncode)
                del running[cell]
    total = time.perf_counter() - t0

    print("| Arch | Shape | Mesh | Status | Run s (process s) | Args GiB / "
          "device (of 80 GB) | Dot FLOPs (global) | moe_ep collectives |")
    print("|---|---|---|---|---|---|---|---|")
    failed = []
    for cell in sorted(cells):
        arch, shape, mesh = cell
        secs, rc = wall[cell]
        path = out / f"{arch}_{shape}_{mesh}.json"
        if rc != 0 or not path.exists():
            lines = (out / "logs" / ("_".join(cell) + ".log")).read_text(
            ).strip().splitlines()
            err = next((ln for ln in lines if ln.startswith("FAIL")),
                       lines[-1] if lines else "no output")
            failed.append((cell, err))
            print(f"| {arch} | {shape} | {mesh} | FAIL | ({secs:.1f}) | — "
                  f"| — | {err} |")
            continue
        r = json.loads(path.read_text())
        arg = r["memory"]["argument_bytes"]
        coll = "; ".join(f"{k}: {v['count']} calls, {v['bytes']:,} B"
                         for k, v in sorted(r["collectives"].items())) or "—"
        print(f"| {arch} | {shape} | {mesh} | ok | {r['lower_s']} "
              f"({secs:.1f}) | {arg / 2**30:.2f} "
              f"({'fits' if arg < CARD_BYTES else 'over'}) | "
              f"{r['dots']['dot_flops']:.4e} | {coll} |")
    print(f"{len(cells)} cells, {len(failed)} failed, {total:.1f} s wall "
          f"with {jobs} processes")
    print()
    report(out)
    for cell, err in failed:
        print(f"FAIL {' x '.join(cell)}: {err}")
    return 1 if failed else 0


def report(out: Path) -> int:
    """The records in ``out``, one row per architecture: per shape the
    run seconds, per-device argument GiB and global dot FLOPs on the pod
    / multi-pod mesh; then ``moe_ep``'s collectives per cell."""
    recs = {}
    for path in out.glob("*.json"):
        r = json.loads(path.read_text())
        recs[r["arch"], r["shape"], r["mesh"]] = r
    shapes = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
    print("| Arch | " + " | ".join(shapes) + " |")
    print("|---|" + "---|" * len(shapes))
    for arch in ARCH_IDS:
        row = []
        for shape in shapes:
            pod, multi = (recs.get((arch, shape, m))
                          for m in ("pod", "multipod"))
            if pod is None and multi is None:
                row.append("—")
                continue
            secs = " / ".join(f"{r['lower_s']}" if r else "FAIL"
                              for r in (pod, multi))
            gib = " / ".join(f"{r['memory']['argument_bytes'] / 2**30:.2f}"
                             if r else "—" for r in (pod, multi))
            fl = " / ".join(f"{r['dots']['dot_flops']:.3e}" if r else "—"
                            for r in (pod, multi))
            row.append(f"{secs} s; {gib} GiB; {fl}")
        print(f"| {arch} | " + " | ".join(row) + " |")
    print()
    print("| Arch | Shape | moe_ep collectives, pod | multi-pod |")
    print("|---|---|---|---|")
    for (arch, shape, mesh), r in sorted(recs.items()):
        if mesh != "pod" or not r["collectives"]:
            continue
        multi = recs.get((arch, shape, "multipod"), {})

        def fmt(c):
            return "; ".join(f"{k}: {v['count']} calls, {v['bytes']:,} B"
                             for k, v in sorted(c.items())) or "—"
        print(f"| {arch} | {shape} | {fmt(r['collectives'])} | "
              f"{fmt(multi.get('collectives', {}))} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
