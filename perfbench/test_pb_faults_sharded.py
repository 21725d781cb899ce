"""The four-card cell ``graph500_26.solve_sharded`` at scale 9 on four CPU
positions, through ``run_cell``: ``correct`` for the program as it is;
not for the control (the reference across the cards in TF32 in the
program's place) nor for three faults planted in the timed path: one
card's block left out of the exchange, a step that returns its state
unchanged, an answer altered where it is produced.  A traced run reports
the cell's metrics of the sharded tier with the values the program
counted."""
import time
from pathlib import Path

import pytest
import torch

from perfbench import bench as B
from perfbench import checks
from perfbench.control import control_readings

ROOT = Path(__file__).resolve().parents[1]
CELL = "graph500_26.solve_sharded"
SMALL = {"scale": 9}
SECONDS = 0.3
SEED = 2**31 + 91


@pytest.fixture(scope="module")
def bench():
    return B.Benchmark(ROOT)


def run(bench, trace=False, config=None):
    return B.run_cell(bench, CELL, SEED, SECONDS, trace, device="cpu",
                      t_start=time.perf_counter(),
                      config_overrides={**SMALL, **(config or {})})


def test_the_program_is_correct(bench):
    res = run(bench)["result"]
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["device"]["count"] == 4
    assert set(res["metrics"]) == {"setup_s", "evps"}


def test_the_control_is_not(bench):
    got = control_readings(bench, CELL, SEED, SECONDS, "cpu", SMALL)
    limits = B.load_json(B.PB / "limits" / f"{CELL}.json")
    assert set(got) == set(limits)
    assert not checks.is_correct(checks.verdict(got, limits),
                                 {"attempted": 1, "failed": 0}), got


def block_left_out(mp):
    """The exchange leaves the second card's rows out of every other
    card's vector."""
    from repro_torch.core import fabric_matvec as fm
    real = fm.gather_blocks

    def gather(groups):
        return real([(outs, [(a, a) if q == 1 and b - a > 1 else (a, b)
                             for q, (a, b) in enumerate(spans)])
                     for outs, spans in groups])

    mp.setattr(fm, "gather_blocks", gather)


def step_unchanged(mp):
    """Every step returns its state unchanged."""
    import repro_torch.pagerank.distributed as dist
    mp.setattr(dist, "split_ell_step", lambda *a: lambda state: state)


def answer_altered(mp):
    """One entry of every solved rank vector is changed."""
    from repro_torch.pagerank import PageRankEngine
    real = PageRankEngine.run

    def run_(self, n_iters=100):
        pr = real(self, n_iters).clone()
        pr[0] += 1e-4
        return pr

    mp.setattr(PageRankEngine, "run", run_)


@pytest.mark.parametrize("fault", [block_left_out, step_unchanged,
                                   answer_altered])
def test_a_fault_is_not_correct(bench, monkeypatch, fault):
    fault(monkeypatch)
    res = run(bench)["result"]
    assert not res["correct"], res["checks"]


def test_a_traced_run_reports_the_sharded_tiers_metrics(bench):
    out = run(bench, trace=True)
    res, rec = out["result"], out["rec"]
    assert res["correct"], res["checks"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    # the device metrics need a card's trace; the program's are here
    assert set(m) == {"prepare_s.sharded", "prepare_shard_s.sharded",
                      "prepare_csr_s.sharded", "prepare_pack_s.sharded",
                      "shard_skew.sharded", "exchange_bytes_per_iter.sharded"}
    n = rec["graph"]["n_connected"]
    assert m["exchange_bytes_per_iter.sharded"] == 3 * 4 * (n + 4)
    counters = rec["counters"]
    assert counters["engine.sharded_steps"] == 10 * rec["calls"]
    assert 1.0 <= m["shard_skew.sharded"] <= 1.05
    assert 0 < m["prepare_shard_s.sharded"] < m["prepare_s.sharded"]
    phases = [m[f"prepare_{k}_s.sharded"] for k in ("shard", "csr", "pack")]
    assert all(t > 0 for t in phases) and sum(phases) < m["prepare_s.sharded"]


def test_a_program_without_the_tier_is_refused_at_once(bench, monkeypatch):
    import repro_torch.pagerank.engine as eng
    monkeypatch.setattr(eng, "BACKENDS", eng.BACKENDS[:-1])
    t0 = time.perf_counter()
    with pytest.raises(SystemExit, match="no tier 'ell_split_sharded'"):
        run(bench)
    assert time.perf_counter() - t0 < 10


def test_a_cell_of_other_chips_than_the_configurations_cards_is_refused(
        bench):
    with pytest.raises(SystemExit, match="2 cards are not the cell's 4"):
        run(bench, config={"cards": 2})


def test_no_fault_leaks_into_the_next_test():
    import repro_torch.pagerank.distributed as dist
    from repro_torch.core import fabric_matvec as fm
    assert dist.split_ell_step.__module__ == dist.__name__
    assert fm.gather_blocks.__module__ == fm.__name__
    assert torch.get_default_dtype() == torch.float32
