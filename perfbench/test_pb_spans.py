"""The program's span records as the phase readers find them, and the
split of device time by program range (:mod:`perfbench.spans`)."""
import time
from pathlib import Path

import pytest

from perfbench import bench as B
from perfbench import spans

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("dedupe", "keys", "csr", "pack", "upload")


def test_by_span_takes_the_innermost_range_on_the_device():
    # one iteration's ranges as the device-side copies give them, in µs
    ranges = [(-5, 104, "engine.run"), (0, 50, "engine.step.combine"),
              (2, 20, "engine.step.rows"), (25, 45, "engine.step.overflow"),
              (52, 98, "engine.step.combine")]
    ops = [(s, e, (s + e) / 2) for s, e in
           [(-5, -4), (0, 1), (2, 20), (25, 30), (31, 45), (46, 50),
            (52, 98), (100, 104), (110, 114)]]
    got = spans.by_span(ops, ranges)
    assert got == pytest.approx({
        "engine.step.rows": 18e-6, "engine.step.overflow": 19e-6,
        "engine.step.combine": 51e-6, "engine.run": 5e-6,
        spans.NONE: 4e-6})


def test_by_span_counts_overlapping_operations_once():
    ops = [(0, 10, 5), (5, 15, 10), (12, 14, 13), (20, 30, 25)]
    got = spans.by_span(ops, [(0, 11, "a"), (11, 40, "b")])
    # the union, 25 µs: a takes [0, 15) (both points lie in it), b
    # [20, 30); [12, 14) adds nothing
    assert sum(got.values()) == pytest.approx(25e-6)
    assert got == pytest.approx({"a": 15e-6, "b": 10e-6})


def test_by_span_places_by_launch_on_the_host():
    # the host's ranges end long before the device runs their kernels:
    # each operation is placed by the launch given as its point
    ranges = [(0, 10, "engine.step.rows"), (10, 20, "engine.step.overflow")]
    ops = [(50, 60, 3), (60, 90, 12), (90, 95, 30)]
    assert spans.by_span(ops, ranges) == pytest.approx({
        "engine.step.rows": 10e-6, "engine.step.overflow": 30e-6,
        spans.NONE: 5e-6})


def _span(name, sid, parent, start, end):
    return {"name": name, "id": sid, "parent": parent, "start_ns": start,
            "end_ns": end, "fields": {}}


def test_phases_are_the_children_of_the_last_prepare():
    recs = [_span("prepare.dedupe", 1, 0, 0, 10), _span("prepare", 0, None,
                                                         0, 40),
            _span("prepare.dedupe", 3, 2, 50, 60),
            _span("prepare.pack", 4, 2, 60, 70),
            _span("prepare.pack", 5, 2, 70, 75),
            _span("inner", 6, 5, 71, 72), _span("prepare", 2, None, 50, 90)]
    assert spans.prepare_phases(recs) == pytest.approx(
        {"prepare": 40e-9, "prepare.dedupe": 10e-9, "prepare.pack": 15e-9})
    assert spans.prepare_phases(recs[:1]) == {}


def test_records_are_read_off_the_live_registry():
    from repro_torch.obs.registry import MetricsRegistry
    older, reg = MetricsRegistry(), MetricsRegistry()
    with older.span("prepare"):
        with older.span("prepare.keys"):
            pass
    with reg.span("prepare"):
        with reg.span("prepare.dedupe"):
            time.sleep(0.002)
    assert spans.records() == reg.span_records
    assert spans.phase_s("prepare.dedupe") >= 0.002
    assert spans.phase_s("prepare.keys") is None


def test_a_traced_cpu_run_reports_the_phases():
    bench = B.Benchmark(ROOT)
    out = B.run_cell(bench, "graph500_22.solve", 2**31 + 11, 0.2, True,
                     device="cpu", t_start=time.perf_counter(),
                     config_overrides={"scale": 9})
    got = out["result"]["metrics"]
    phases = [got[f"prepare_{p}_s.graph"]["value"] for p in PHASES]
    assert all(v > 0 for v in phases)
    assert sum(phases) <= got["prepare_s.graph"]["value"]
