"""Where one cell's time goes inside the program: the phases of the
engine's constructor and each step's device time by phase.

    python3 perfbench/phases.py --workload <name> --seed <n>
                                [--seconds <s>]

From the root of a checkout, on a CUDA card.  Sets the cell up as
``perfbench/run.py --trace 1`` does (a ``MetricsRegistry`` with profiler
annotations in the program's hands), then runs two stretches of the
cell's traffic of ``--seconds`` each (default: the mix's
``trace_seconds``) under ``torch.profiler``: one of the device alone, one
of the host as well.  Prints one JSON object: the harness's clock around
the constructor (``prepare_s``), the program's ``prepare`` span and its
phases in seconds (``program_spans``), and per stretch ``busy_s``, the
iterations issued, device seconds by the innermost program range
(:func:`perfbench.spans.by_span`) and the same in µs per iteration.  An
operation is placed by the device-side copies of the ranges, and in the
host's stretch also by the range around the runtime call that launched
it (a profile of the device alone carries no copies of the ranges on
torch 2.11).

Exit codes: 0 with the object; 2 for an unknown cell; 3 without a card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def split(torch, body, host: bool) -> tuple[object, dict]:
    """Run ``body()`` under the profiler (the device alone, or with
    ``host`` the host as well); returns its value and the stretch's busy
    seconds and device seconds by innermost program range: by the
    device-side copies of the ranges (``by_span_device``; a profile of the
    device alone may carry none) and, with ``host``, by the range around
    the runtime call that launched each operation (``by_span_launch``; a
    device operation shares its launch's id)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from perfbench import devtrace, spans
    activities = [ProfilerActivity.CUDA] + (
        [ProfilerActivity.CPU] if host else [])
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        value = body()
        torch.cuda.synchronize()
    events = prof.events()

    def ranges(side):
        return [(e.time_range.start, e.time_range.end, e.name)
                for e in events if e.device_type == side
                and getattr(e, "is_user_annotation", False)]

    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    spans_on_device = ranges(DeviceType.CUDA)
    ops = [(e.time_range.start, e.time_range.end,
            (e.time_range.start + e.time_range.end) / 2) for e in device]
    busy = devtrace._union((s, t) for s, t, _ in ops)
    out = {"busy_s": sum(t - s for s, t in busy) / 1e6, "ops": len(ops),
           "device_ranges": len(spans_on_device),
           "by_span_device": spans.by_span(ops, spans_on_device)}
    if host:
        launch = {e.id: e.time_range.start for e in events
                  if e.device_type == DeviceType.CPU
                  and e.name.startswith("cuda")}
        points = [launch.get(e.id) for e in device]
        out["unlinked"] = sum(1 for t in points if t is None)
        out["by_span_launch"] = spans.by_span(
            [(s, t, s if p is None else p)
             for (s, t, _), p in zip(ops, points)], ranges(DeviceType.CPU))
    return value, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args(argv)
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from perfbench import bench as B
    from perfbench import drivers, graphs, spans
    from repro_torch.obs.registry import MetricsRegistry

    bench = B.Benchmark(ROOT)
    try:
        cell = bench.workload(args.workload)
    except KeyError as err:
        print(f"perfbench: {err}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("perfbench: no CUDA card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = bench.config(cell["config"])
    traffic = B.load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    seconds = (float(traffic["trace_seconds"]) if args.seconds is None
               else args.seconds)
    registry = MetricsRegistry(profiler_annotations=True)
    graph = graphs.make(cfg, args.seed, "cuda")
    driver = drivers.load(traffic["driver"])(cfg, traffic, graph, args.seed,
                                             seconds, "cuda", registry)
    out = {"workload": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(0),
           "prepare_s": driver.rec["spans"]["prepare"][0],
           "program_spans": spans.prepare_phases(registry.span_records)}
    for name, host in (("device_stretch", False), ("host_stretch", True)):
        t0 = time.perf_counter()
        info, got = split(torch, lambda: driver.stretch(seconds, "trace"),
                          host)
        iters = info["iterations"]
        got.update(window_s=time.perf_counter() - t0, iterations=iters)
        for key in [k for k in got if k.startswith("by_span")]:
            got[f"us_per_iter{key[7:]}"] = {
                k: v / iters * 1e6 for k, v in got[key].items()}
        out[name] = got
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
