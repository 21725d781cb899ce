"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

From the root of a checkout: the cell is looked up in ``BENCHMARK.json``,
the program is the ``repro_torch`` package under ``src/``.  Set-up
(imports, the CUDA context, the graph made from ``--seed``, the program's
layouts, the cell's warm-up) runs first, then ``--seconds`` of the cell's
traffic are measured; ``--trace 1`` then runs two stretches of the same
traffic under ``torch.profiler`` (:mod:`perfbench.devtrace`) and reports
the per-layer metrics instead of the end-to-end ones.  What the window produced is held to the plain
reference; the numbers compared go to standard error beside their limits,
and the last line of standard output is the result as one JSON object.

Exit codes: 0 with a result line; 2 for bad arguments; 3 without enough
CUDA cards; 4 when the program is missing; 5 when the process loaded JAX
or the JAX package.
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


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        print(f"perfbench: the program (src/repro_torch) is not in {ROOT}",
              file=sys.stderr)
        return 4
    # the harness's own modules are imported as perfbench.*, never as
    # top-level names from this directory
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from perfbench import bench as B

    bench = B.Benchmark(ROOT)
    try:
        cell = bench.workload(args.workload)
    except KeyError as err:
        print(f"perfbench: {err}", file=sys.stderr)
        return 2
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA card(s); "
              f"available: {torch.cuda.is_available()}, "
              f"count: {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    out = B.run_cell(bench, args.workload, args.seed, args.seconds,
                     bool(args.trace), device="cuda", t_start=T_START)
    if out["forbidden"]:
        print(f"perfbench: the run loaded {', '.join(out['forbidden'])}",
              file=sys.stderr)
        return 5
    result = out["result"]
    print(f"setup_s {out['rec']['setup_s']!r}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
