"""Readings for the limits of ``correct``: the control, and the program,
over many seeds in one process.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3
        [--seconds S] [--program] [--out FILE]

The control is the plain reference put in the program's place, computed
on TF32-rounded operands (:func:`perfbench.reference.pagerank.tf32`): the
same rank vectors and answers a window would produce, judged by the same
comparison.  Each driver's ``control`` says how (:mod:`perfbench.drivers`).  ``--program`` also runs the cell itself on each seed (set-up,
a window of ``--seconds``, the comparison), as ``run.py`` does.  Prints
one JSON line per seed and reading; the limits come from these
(``PERF.md``).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def control_readings(bench, workload: str, seed: int, seconds: float,
                     device, config_overrides=None,
                     traffic_overrides=None) -> dict:
    """The comparison's numbers for the control on one seed: the cell's
    driver (``drivers/<name>.py``) says what a window would produce."""
    from perfbench import drivers, graphs
    from perfbench.bench import PB, load_json
    cell = bench.workload(workload)
    cfg = {**bench.config(cell["config"]), **(config_overrides or {})}
    traffic = {**load_json(PB / "traffic" / f"{cell['traffic']}.json"),
               **(traffic_overrides or {})}
    graph = graphs.make(cfg, seed, device)
    got = drivers.load(traffic["driver"]).control(cfg, traffic, graph, seed,
                                                  seconds)
    return {name: c["value"] for name, c in got.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from perfbench import bench as B
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 3
    bench = B.Benchmark(ROOT, parked=True)
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        row = {"workload": args.workload, "seed": seed,
               "control": control_readings(bench, args.workload, seed,
                                           args.seconds, "cuda")}
        row["control_s"] = time.perf_counter() - t0
        if args.program:
            t1 = time.perf_counter()
            out = B.run_cell(bench, args.workload, seed, args.seconds, False,
                             device="cuda", t_start=t1)
            res = out["result"]
            row["program"] = {k: c["value"] for k, c in
                              res["checks"].items()}
            row.update(correct=res["correct"], failed=res["failed"],
                       attempted=res["attempted"],
                       metrics={k: m["value"]
                                for k, m in res["metrics"].items()})
            torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)
        lines.append(row)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n"
                                          for r in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
