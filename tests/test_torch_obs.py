"""PyTorch port, the registry's spans and profiler ranges on the CPU: span
records nest by parent id on ``time.monotonic_ns`` and stay bounded,
``annotate`` and the :class:`NullRegistry` record nothing, and the
engine's constructor and ``ell`` steps carry their phases (the five
children of ``prepare`` on every single-device tier and the sharded
ones, ``engine.run`` and the step ranges in a profile) with results
bit-identical to an untraced engine."""
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.graph.generators import protein_network
from repro_torch.launch.mesh import make_mesh
from repro_torch.obs.registry import MAX_SPANS, MetricsRegistry, NullRegistry
from repro_torch.pagerank import PageRankEngine

PHASES = ["prepare.dedupe", "prepare.keys", "prepare.csr", "prepare.pack",
          "prepare.upload"]


def _by_name(reg):
    return {r["name"]: r for r in reg.span_records}


def test_span_records_nest_by_parent_on_the_monotonic_clock():
    reg = MetricsRegistry()
    t0 = time.monotonic_ns()
    with reg.span("outer", backend="ell") as fields:
        with reg.span("inner"):
            with reg.span("leaf"):
                time.sleep(0.001)
        with reg.span("inner2"):
            pass
        fields["late"] = 3
    t1 = time.monotonic_ns()
    with reg.span("next"):
        pass
    got = _by_name(reg)
    assert [r["name"] for r in reg.span_records] == [
        "leaf", "inner", "inner2", "outer", "next"]
    assert got["outer"]["parent"] is None and got["next"]["parent"] is None
    assert got["inner"]["parent"] == got["outer"]["id"]
    assert got["inner2"]["parent"] == got["outer"]["id"]
    assert got["leaf"]["parent"] == got["inner"]["id"]
    assert len({r["id"] for r in reg.span_records}) == 5
    assert got["outer"]["fields"] == {"backend": "ell", "late": 3}
    for r in reg.span_records[:4]:
        assert t0 <= r["start_ns"] <= r["end_ns"] <= t1
    assert (got["outer"]["start_ns"] <= got["inner"]["start_ns"]
            <= got["leaf"]["start_ns"] <= got["leaf"]["end_ns"]
            <= got["inner"]["end_ns"] <= got["inner2"]["start_ns"]
            <= got["outer"]["end_ns"])
    assert got["leaf"]["end_ns"] - got["leaf"]["start_ns"] >= 1_000_000
    # the histogram and the event read the record's duration
    ev = [e for e in reg.events if e["name"] == "outer"][0]
    assert ev["late"] == 3 and ev["backend"] == "ell"
    assert ev["ms"] == (got["outer"]["end_ns"]
                        - got["outer"]["start_ns"]) / 1e6
    assert reg.as_dict()["histograms"]["span.outer"]["count"] == 1


def test_a_span_that_raises_is_recorded_and_closed():
    reg = MetricsRegistry()
    with pytest.raises(ValueError):
        with reg.span("outer"):
            with reg.span("failing"):
                raise ValueError("boom")
    with reg.span("after"):
        pass
    got = _by_name(reg)
    assert got["failing"]["parent"] == got["outer"]["id"]
    assert got["after"]["parent"] is None


def test_span_records_stay_bounded():
    reg = MetricsRegistry()
    for i in range(MAX_SPANS + 3):
        with reg.span(f"s{i}"):
            pass
    kept = reg.span_records
    assert len(kept) == MAX_SPANS
    assert kept[0]["name"] == "s3" and kept[-1]["id"] == MAX_SPANS + 2
    assert reg.as_dict()["n_events"] == MAX_SPANS + 3


@pytest.mark.parametrize("annotations", [False, True])
def test_annotate_records_nothing(annotations):
    reg = MetricsRegistry(profiler_annotations=annotations)
    with reg.annotate("engine.step.rows"):
        torch.ones(4).sum()
    assert reg.span_records == [] and reg.events == []
    assert reg.as_dict()["histograms"] == {}
    if not annotations:
        assert reg.annotate("a") is reg.annotate("b")


def test_the_null_registry_records_nothing_and_allocates_no_context():
    null = NullRegistry()
    shared = null.span("prepare")
    assert null.span("other", backend="ell") is shared
    assert null.annotate("engine.run") is shared
    assert MetricsRegistry().annotate("engine.run") is shared
    with null.span("prepare") as fields:
        with null.annotate("engine.step.rows"):
            pass
    assert fields is None
    assert null.span_records == [] and null.events == []
    assert null.as_dict()["histograms"] == {}


def test_spans_and_annotations_reach_the_profile_on_the_span_clock():
    reg = MetricsRegistry(profiler_annotations=True)
    with reg.span("warm"):                  # the first range imports
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with reg.span("outer"):
            time.sleep(0.002)
            with reg.annotate("inner"):
                torch.ones(1000).sum()
            time.sleep(0.002)
    # the profile's clock is the wall clock; its start placed on
    # time.monotonic_ns puts the ranges on the records' clock
    start = (prof.profiler.kineto_results.trace_start_ns()
             - (time.time_ns() - time.monotonic_ns()))
    got = {e.name: (start + e.time_range.start * 1000,
                    start + e.time_range.end * 1000)
           for e in prof.events() if e.name in ("outer", "inner")}
    assert set(got) == {"outer", "inner"}
    rec = _by_name(reg)["outer"]
    # the record and its range open and close within a millisecond of
    # each other, and the annotation, 2 ms from either end, lies inside
    assert abs(rec["start_ns"] - got["outer"][0]) < 1_000_000
    assert abs(got["outer"][1] - rec["end_ns"]) < 1_000_000
    assert rec["start_ns"] < got["inner"][0] < got["inner"][1] \
        < rec["end_ns"]


@pytest.fixture(scope="module")
def graph():
    n = 400
    src, dst = protein_network(n, seed=11)
    return n, src, dst


TIERS = [("dense", None), ("ell", None), ("bsr", None),
         ("fused_dense", None), ("dense_sharded", (2, 2)),
         ("ell_sharded", (4,))]


@pytest.mark.parametrize("backend,shape", TIERS, ids=[t for t, _ in TIERS])
def test_the_constructor_splits_into_its_phases(graph, backend, shape):
    n, src, dst = graph
    mesh = None
    if shape is not None:
        axes = ("row", "col") if len(shape) == 2 else ("shard",)
        mesh = make_mesh(shape, axes, ["cpu"] * int(np.prod(shape)))
    reg = MetricsRegistry()
    PageRankEngine(src, dst, n, backend=backend, device="cpu", mesh=mesh,
                   metrics=reg)
    top = [r for r in reg.span_records if r["name"] == "prepare"]
    assert len(top) == 1 and top[0]["fields"] == {"backend": backend}
    kids = [r for r in reg.span_records if r["parent"] == top[0]["id"]]
    want = [p for p in PHASES
            if p != "prepare.csr" or backend in ("ell", "ell_sharded")]
    assert [r["name"] for r in kids] == want
    assert all(r["name"] in PHASES for r in reg.span_records
               if r is not top[0])
    for a, b in zip(kids, kids[1:]):
        assert a["end_ns"] <= b["start_ns"]
    assert top[0]["start_ns"] <= kids[0]["start_ns"]
    assert kids[-1]["end_ns"] <= top[0]["end_ns"]


def test_the_ell_phases_cover_the_constructor():
    src, dst = protein_network(20000, seed=3)
    covered = []
    for _ in range(3):      # a preempted gap between phases reads lower
        reg = MetricsRegistry()
        PageRankEngine(src, dst, 20000, backend="ell", device="cpu",
                       metrics=reg)
        top = _by_name(reg)["prepare"]
        kids = sum(r["end_ns"] - r["start_ns"] for r in reg.span_records
                   if r["parent"] == top["id"])
        covered.append(kids / (top["end_ns"] - top["start_ns"]))
    assert max(covered) >= 0.95


def test_only_a_recording_registry_waits_for_the_upload(graph, monkeypatch):
    n, src, dst = graph
    waits = []
    monkeypatch.setattr(PageRankEngine, "_synchronize",
                        lambda self: waits.append(self.backend))
    PageRankEngine(src, dst, n, backend="ell", device="cpu",
                   metrics=NullRegistry())
    assert waits == []
    PageRankEngine(src, dst, n, backend="ell", device="cpu",
                   metrics=MetricsRegistry())
    assert waits == ["ell"]


@pytest.mark.parametrize("backend", ["ell", "bsr"])
def test_steps_are_traced_without_changing_a_bit(graph, backend):
    n, src, dst = graph
    quiet = PageRankEngine(src, dst, n, backend=backend, device="cpu",
                           metrics=NullRegistry())
    traced = PageRankEngine(src, dst, n, backend=backend, device="cpu",
                            metrics=MetricsRegistry(
                                profiler_annotations=True))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pr = traced.run(7)
        tol = traced.run_tol(1e-7, max_iters=300)
    assert torch.equal(pr, quiet.run(7))
    again = quiet.run_tol(1e-7, max_iters=300)
    assert torch.equal(tol[0], again[0]) and tol[1] == again[1]
    names = [e.name for e in prof.events()]
    runs, steps = names.count("engine.run"), names.count(
        "engine.step.combine")
    assert runs == 2 and steps == 7 + int(tol[1]) + (-int(tol[1])) % 8
    assert names.count("engine.step.rows") == steps
    assert names.count("engine.step.overflow") == (
        steps if backend == "ell" else 0)
    # the ranges record nothing in the registry: only the solve span
    assert [r["name"] for r in traced.metrics.span_records
            if not r["name"].startswith("prepare")] == ["solve"]
