"""``correct`` at a size a test run holds, on the CPU: true for the
program as it is, false for the control (the reference in TF32 in the
program's place) and for each fault the cell can have, planted in the
timed path underneath a whole run of the harness."""
import time
from pathlib import Path

import numpy as np
import pytest

from perfbench import bench as B
from perfbench import checks
from perfbench.control import control_readings

ROOT = Path(__file__).resolve().parents[1]
SMALL = {"protein5k": {"n": 300}, "graph500_22": {"scale": 9}}
# serve: fast enough arrivals that batches of several queries form
LOAD = {"protein5k.serve": {"rate_per_s": 400},
        "protein5k.live": {"rate_per_s": 30}}
SECONDS = 0.3
SEED = 2**31 + 77


@pytest.fixture(scope="module")
def bench():
    return B.Benchmark(ROOT, parked=True)


def run(bench, cell):
    cfg = bench.workload(cell)["config"]
    out = B.run_cell(bench, cell, SEED, SECONDS, False, device="cpu",
                     t_start=time.perf_counter(),
                     config_overrides=SMALL[cfg],
                     traffic_overrides=LOAD.get(cell))
    return out["result"]


CELLS = ["protein5k.solve", "graph500_22.solve", "protein5k.serve",
         "protein5k.live"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_is_correct(bench, cell):
    res = run(bench, cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not(bench, cell):
    cfg = bench.workload(cell)["config"]
    got = control_readings(bench, cell, SEED, SECONDS, "cpu", SMALL[cfg],
                           LOAD.get(cell))
    limits = B.load_json(B.PB / "limits" / f"{cell}.json")
    assert not checks.is_correct(checks.verdict(got, limits),
                                 {"attempted": 1, "failed": 0}), got


# ----------------------------------------------------------------- faults
def step_unchanged(mp):
    """Every power-iteration or push step returns its state unchanged."""
    import repro_torch.pagerank.dynamic as dyn
    import repro_torch.pagerank.engine as eng
    import repro_torch.pagerank.landmarks as lm
    mp.setattr(eng, "pagerank_step_fused",
               lambda Hp, xp, dangp, t, scales, d: (xp, (xp * dangp).sum()))
    mp.setattr(eng, "sparse_step", lambda mv, pr, dang, d, n: pr)
    real = dyn._push_fused
    mp.setattr(dyn, "_push_fused",
               lambda *a, **kw: real(*a, **{**kw, "max_pushes": 0}))
    mp.setattr(lm.LandmarkIndex, "_push",
               lambda self, V, X0, tol, mp_: (X0, np.zeros(V.shape[1]), 0))


def half_batch(mp):
    """Only the first half of each batch is solved; the rest get the mean
    of the solved answers."""
    from repro_torch.serve.engine import PageRankQueryEngine
    real = PageRankQueryEngine._solve_batch

    def solve(self, seed_sets):
        h = (len(seed_sets) + 1) // 2
        X = real(self, seed_sets[:h])
        rest = np.repeat(X.mean(axis=1, keepdims=True), len(seed_sets) - h,
                         axis=1)
        return np.concatenate([X, rest], axis=1)

    mp.setattr(PageRankQueryEngine, "_solve_batch", solve)


def answer_altered(mp):
    """The answer is changed where it is produced: one score of every
    served top-k, or one entry of every solved rank vector."""
    import repro_torch.serve.engine as se
    from repro_torch.pagerank import PageRankEngine
    real_top, real_run = se._topk, PageRankEngine.run

    def topk(ranks, k):
        idx, scores = real_top(ranks, k)
        scores = scores.copy()
        scores[-1] *= 1.001
        return idx, scores

    def run(self, n_iters=100):
        pr = real_run(self, n_iters).clone()
        pr[0] += 1e-4
        return pr

    mp.setattr(se, "_topk", topk)
    mp.setattr(PageRankEngine, "run", run)


FAULTS = {"step_unchanged": step_unchanged, "half_batch": half_batch,
          "answer_altered": answer_altered}
CASES = [(c, f) for c in CELLS for f in FAULTS
         if not (f == "half_batch" and c.endswith(".solve"))]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_fault_is_not_correct(bench, monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    res = run(bench, cell)
    assert not res["correct"], res["checks"]


def test_no_fault_leaks_into_the_next_test(bench):
    import repro_torch.pagerank.engine as eng
    assert eng.sparse_step.__module__ == "repro_torch.pagerank.steps"
