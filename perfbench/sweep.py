"""Find an open-loop cell's knee: the highest offered rate whose backlog
does not grow across the window.  Where a backlog coalesces (the live
cell folds every tick that is due into one refresh), it cannot grow, and
the knee is taken as the lowest swept rate whose p95 is twice that of the
lowest rate swept.

    python3 perfbench/sweep.py --workload <cell> --rates 100,200,400
        [--seconds S] [--seed N]

One process, one run of the cell per rate (its traffic file with
``rate_per_s`` replaced).  Per rate it prints the completed rate, the
latency's p50 / p95, and the mean lag of the first and the last quarter of
the requests: a lag that grows from the first quarter to the last is a
growing backlog.  The cell's traffic file then takes 4/5 of the knee.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=2**31 + 1)
    args = ap.parse_args(argv)
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import numpy as np
    import torch

    from perfbench import bench as B
    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 3
    bench = B.Benchmark(ROOT, parked=True)
    for rate in (float(r) for r in args.rates.split(",")):
        out = B.run_cell(bench, args.workload, args.seed, args.seconds,
                         False, device="cuda", t_start=time.perf_counter(),
                         traffic_overrides={"rate_per_s": rate})
        rec, res = out["rec"], out["result"]
        lat = np.asarray(rec["latencies_s"]) * 1e3
        lag = np.asarray(rec["lags_s"]) * 1e3
        q = max(1, len(lag) // 4)
        print(json.dumps({
            "rate": rate, "completed_per_s": rec["completed"]
            / rec["window_s"], "window_s": rec["window_s"],
            "p50_ms": float(np.median(lat)),
            "p95_ms": float(np.percentile(lat, 95)),
            "lag_first_ms": float(lag[:q].mean()),
            "lag_last_ms": float(lag[-q:].mean()),
            "correct": res["correct"], "failed": res["failed"]}),
            flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
