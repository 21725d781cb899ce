"""``BENCHMARK.json`` against the rules the harness and its checker rely
on, and the load generator's promises."""
import json
import re
from pathlib import Path

import numpy as np
import pytest

from perfbench import bench, drivers, find, graphs, loadgen
from perfbench.drivers import Reservoir

ROOT = Path(__file__).resolve().parents[1]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
PARKED = json.loads((ROOT / "perfbench" / "parked.json").read_text())
# the held-back cells are held to the same rules, so that moving their
# entries into BENCHMARK.json makes a valid benchmark
ALL = {k: SPEC[k] + PARKED[k] for k in bench.SECTIONS}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in ALL["workloads"]]
METRICS = ALL["end_to_end"] + ALL["per_layer"]


def reports(cell: str, kind: str) -> set:
    return {m["name"] for m in ALL[kind]
            if cell in m.get("workloads", [cell])}


def test_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [x["name"] for x in ALL["configs"] + ALL["workloads"]
             + METRICS]
    assert all(NAME.match(n) for n in names)
    for kind in ("configs", "workloads"):
        assert len({x["name"] for x in ALL[kind]}) == len(ALL[kind])
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    assert all(m["better"] in ("lower", "higher") for m in METRICS)
    whys = [x["why"] for x in ALL["configs"] + ALL["workloads"]]
    assert all(0 < len(w) <= 200 and "\n" not in w for w in whys)


def chips_follow_the_rule(workloads) -> bool:
    """Every cell takes 1 or 4 chips, and at most a quarter of the cells,
    rounded down, take 4; one always may."""
    chips = [w["chips"] for w in workloads]
    return (all(c in (1, 4) for c in chips)
            and chips.count(4) <= max(1, len(chips) // 4))


@pytest.mark.parametrize("chips,ok", [
    ([4], True), ([1, 4], True), ([1, 1, 1, 4], True),
    ([1, 1, 4, 4], False), ([4, 4], False), ([1, 2], False),
    ([1, 1, 1, 1, 1, 1, 1, 4, 4], True), ([1, 1, 1, 1, 1, 1, 4, 4, 4], False),
])
def test_the_chips_rule_on_a_local_spec(chips, ok):
    cells = [{"name": f"c{i}", "chips": c} for i, c in enumerate(chips)]
    assert chips_follow_the_rule(cells) is ok


def test_every_cell_is_complete():
    assert chips_follow_the_rule(ALL["workloads"])
    for w in ALL["workloads"]:
        assert w["chips"] in (1, 4)
        e2e = reports(w["name"], "end_to_end")
        assert "setup_s" in e2e and len(e2e) >= 2
        assert reports(w["name"], "per_layer")
        traffic = json.loads(
            (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json")
            .read_text())
        assert issubclass(drivers.load(traffic["driver"]), drivers.Driver)
        for kind, key in (("arrivals", "arrivals"), ("seedsets", "seed_sets")):
            if key in traffic:
                assert (ROOT / "perfbench" / kind
                        / f"{traffic[key]}.py").is_file()
        assert (ROOT / "perfbench" / "limits" / f"{w['name']}.json"
                ).is_file()


def test_bounds():
    for m in ALL["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("m", ALL["per_layer"], ids=lambda m: m["name"])
def test_a_layer_metric_moves_what_its_cells_report(m):
    for cell in m["workloads"]:
        assert m["moves"] in reports(cell, "end_to_end")


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_every_metric_has_a_reader(m):
    assert callable(bench.reader(m["name"]).read)


def test_configs_name_their_files():
    for c in ALL["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert (ROOT / "perfbench" / "graphs"
                / f"{cfg['generator']}.py").is_file()


def test_parked_cells_stay_out_of_the_benchmark():
    for key in bench.SECTIONS:
        assert not ({x["name"] for x in SPEC[key]}
                    & {x["name"] for x in PARKED[key]}), key
    held = {w["name"] for w in PARKED["workloads"]}
    for m in PARKED["end_to_end"] + PARKED["per_layer"]:
        assert set(m["workloads"]) <= held, m["name"]
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}


def test_every_seed_offers_the_same_work():
    poisson = find("arrivals", "poisson")
    traffic = {"rate_per_s": 300.0, "seed_set_sizes": [1, 2, 3, 4, 5],
               "zipf_s": 1.1}
    a = poisson.times(traffic, 10.0, loadgen.rng_for(1, "x"))
    b = poisson.times(traffic, 10.0, loadgen.rng_for(2**31 + 5, "x"))
    assert len(a) == len(b) == 3000
    np.testing.assert_allclose(np.sort(np.diff(a, prepend=0)),
                               np.sort(np.diff(b, prepend=0)))
    assert not np.allclose(a, b)
    zipf = find("seedsets", "zipf")
    g = graphs.Graph.from_numpy(np.zeros(0, np.int32), np.zeros(0, np.int32),
                                5000, "cpu")
    s1 = zipf.sets(500, g, traffic, loadgen.rng_for(1, "q"))
    s2 = zipf.sets(500, g, traffic, loadgen.rng_for(1, "q"))
    assert all(np.array_equal(x, y) for x, y in zip(s1, s2))
    assert all(1 <= len(s) <= 5 for s in s1)


def test_an_open_loop_plan_draws_through_the_laws_it_names():
    g = graphs.Graph.from_numpy(np.zeros(0, np.int32), np.zeros(0, np.int32),
                                400, "cpu")
    traffic = json.loads((ROOT / "perfbench" / "traffic" / "live.json")
                         .read_text())
    due, sets = loadgen.plan(g, traffic, 2**31 + 9, 2.0, "arrivals")
    per = traffic["queries_per_tick"]
    assert len(due) == round(traffic["rate_per_s"] * 2.0)
    assert np.all(np.diff(due) >= 0) and len(sets) == len(due) * per
    again = loadgen.plan(g, traffic, 2**31 + 9, 2.0, "arrivals")
    np.testing.assert_array_equal(due, again[0])
    other = loadgen.plan(g, traffic, 2**31 + 9, 2.0, "trace")
    assert not np.array_equal(due, other[0])


@pytest.mark.parametrize("name", ["solve", "serve", "live"])
def test_a_driver_is_found_by_name_with_its_control(name):
    cls = drivers.load(name)
    assert issubclass(cls, drivers.Driver)
    for method in ("window", "stretch", "outputs", "judge", "control"):
        assert callable(getattr(cls, method)), method


def test_reservoir_keeps_k_and_the_last():
    r = Reservoir(4, np.random.default_rng(0))
    for i in range(100):
        r.offer(i)
    got = r.sample()
    assert len(got) == 5 and got[-1] == 99 and len(set(got)) == 5
