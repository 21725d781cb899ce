"""One run of one cell, driven by ``BENCHMARK.json`` and the files it names.

A cell (``workloads`` entry) names a configuration and a traffic mix.  The
harness finds

* the configuration at the ``file`` its ``configs`` entry gives: the graph
  generator (``perfbench/graphs/<generator>.py``) and its sizes, the
  engine's tier and precision, and the reference's layout;
* the traffic mix at ``perfbench/traffic/<traffic>.json``: the parameters
  and the parts it names, its driver (``perfbench/drivers/<name>.py``)
  and the laws of an open loop (``perfbench/arrivals/<name>.py``,
  ``perfbench/seedsets/<name>.py``);
* the limits of its comparison at ``perfbench/limits/<cell>.json``;
* each metric's reader at ``perfbench/metrics/<name>.py``, or, for a name
  split by a suffix (``idle_share.serve``), at the file of the part before
  the first dot (``idle_share.py``).  A reader's ``read(rec)`` returns the
  number or ``None`` when the run left nothing to read.

Adding a cell, a configuration, a mix or a metric therefore takes new
files and new ``BENCHMARK.json`` entries, never an edit; a cell held back
in ``perfbench/parked.json`` comes in by moving its entries.

A cell's ``chips`` sets its devices (:func:`cell_devices`): its driver
builds the engine on a mesh over them, set-up and the traced stretches end
when all of them have finished, ``memory_peak_bytes`` is the fullest
card's, and ``busy_s`` the mean over the cards (:mod:`perfbench.devtrace`).
A cell of one chip runs on ``device`` alone, as it always has.
"""
from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

from perfbench import checks, devtrace, drivers, graphs, work

PB = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks", "chip_smoke")


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


SECTIONS = ("configs", "workloads", "end_to_end", "per_layer")


class Benchmark:
    """``BENCHMARK.json``; with ``parked``, also the entries of
    ``perfbench/parked.json``: cells proven on the card and held back from
    the benchmark, which a later benchmark moves into it as they are."""

    def __init__(self, root: Path, parked: bool = False):
        self.root = Path(root)
        self.spec = load_json(self.root / "BENCHMARK.json")
        if parked:
            held = load_json(PB / "parked.json")
            for key in SECTIONS:
                self.spec[key] = self.spec[key] + held[key]

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        entry = next(c for c in self.spec["configs"] if c["name"] == name)
        return load_json(self.root / entry["file"])

    def metrics(self, workload: str, trace: bool) -> list[dict]:
        """The metrics this cell reports in a run of this kind."""
        kind = "per_layer" if trace else "end_to_end"
        return [m for m in self.spec[kind]
                if workload in m.get("workloads", [workload])]


def reader(name: str):
    base = PB / "metrics"
    path = base / f"{name}.py"
    if not path.is_file():
        path = base / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics.{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the port must not load,
    compared whole (``repro_torch`` is not ``repro``)."""
    loaded = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(loaded.intersection(FORBIDDEN))


def cell_devices(device, chips: int) -> list:
    """The devices of a cell of ``chips`` chips: ``device`` alone for one;
    else cards 0 to ``chips`` - 1 of a CUDA ``device``, or ``chips``
    positions on the CPU (the program's mesh allows a device at several
    positions)."""
    if chips == 1:
        return [device]
    if torch.device(device).type == "cuda":
        return [f"cuda:{i}" for i in range(chips)]
    return [device] * chips


def run_cell(bench: Benchmark, workload: str, seed: int, seconds: float,
             trace: bool, *, device="cuda", t_start: float,
             config_overrides: dict | None = None,
             traffic_overrides: dict | None = None) -> dict:
    """Set up, measure, trace (``trace``), judge.  Returns the result
    line's object; its ``checks`` key comes last."""
    from repro_torch.obs.registry import MetricsRegistry, NullRegistry
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = bench.workload(workload)
    cfg = {**bench.config(cell["config"]), **(config_overrides or {})}
    traffic = {**load_json(PB / "traffic" / f"{cell['traffic']}.json"),
               **(traffic_overrides or {})}
    limits_path = PB / "limits" / f"{workload}.json"
    limits = load_json(limits_path) if limits_path.is_file() else {}
    on_card = torch.device(device).type == "cuda"
    chips = int(cell["chips"])
    devices = cell_devices(device, chips)
    registry = (MetricsRegistry(profiler_annotations=True) if trace
                else NullRegistry())

    graph = graphs.make(cfg, seed, devices[0])
    driver = drivers.load(traffic["driver"])(cfg, traffic, graph, seed,
                                             seconds, devices, registry)
    drivers.sync_all(devices)
    setup_s = time.perf_counter() - t_start
    rec = driver.timed()
    rec.update(setup_s=setup_s, chips=chips, device_kind=(
        torch.cuda.get_device_name(0) if on_card else "cpu"),
        work_bytes_per_iter=work.iteration_bytes(graph.n, graph.n_directed))
    if trace and on_card:
        seconds_traced = float(traffic["trace_seconds"])
        info, prof = devtrace.device_stretch(
            torch, lambda: driver.stretch(seconds_traced, "trace"), devices)
        host, hprof = devtrace.host_stretch(
            torch, lambda: driver.stretch(seconds_traced, "trace_host"),
            devices)
        rec["profile"] = {**prof, **info, "idle_gaps": hprof["idle_gaps"]}
        # calls (solves, flushes, refreshes) per second: the profilers'
        # cost to the host shows as a lower rate in a closed loop
        rec["calls_per_s"] = {
            "window": rec["calls"] / rec["window_s"],
            "device_profile": info["calls"] / prof["window_s"],
            "host_profile": host["calls"] / hprof["window_s"]}
    peaks = [torch.cuda.max_memory_allocated(d) if on_card else 0
             for d in devices]
    out = driver.outputs()
    if on_card:
        torch.cuda.empty_cache()
    found = forbidden_modules()
    checks_done = driver.judge(out, limits)

    metrics = {}
    for m in bench.metrics(workload, trace):
        value = reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": rec["device_kind"], "count": chips,
           "memory_peak_bytes": int(max(peaks))}
    if chips > 1:
        dev["memory_peak_bytes_per_card"] = [int(p) for p in peaks]
    result = {"correct": checks.is_correct(checks_done, rec),
              "attempted": int(rec["attempted"]),
              "failed": int(rec["failed"]), "metrics": metrics,
              "device": dev}
    if "profile" in rec:
        prof = rec["profile"]
        dev.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        if chips > 1:
            dev["busy_s_per_card"] = prof["busy_s_per_card"]
        result["breakdown"] = {"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}
        result["calls_per_s"] = rec["calls_per_s"]
    result["checks"] = checks_done
    return {"result": result, "forbidden": found, "rec": rec}
