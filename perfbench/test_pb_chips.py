"""A cell of four chips on the CPU: the cell's devices handed to its
driver, the engine on a mesh over them, every card waited for, and busy
time and roofline read across the cards."""
import copy
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from perfbench import bench as B
from perfbench import devtrace, drivers

ROOT = Path(__file__).resolve().parents[1]
CELL = "graph500_22.solve"
SMALL = {"scale": 9}
SEED = 2**31 + 23


def local_bench(chips: int) -> B.Benchmark:
    """The benchmark with ``CELL`` asking for ``chips`` chips, in this
    test's copy of the spec only."""
    bench = B.Benchmark(ROOT)
    bench.spec = copy.deepcopy(bench.spec)
    bench.workload(CELL)["chips"] = chips
    return bench


def run_recording_engines(monkeypatch, bench, backend):
    """``run_cell`` on the CPU, keeping each engine its driver built and
    the keywords it was built with."""
    built = []
    real = drivers.Driver._engine

    def engine(self, cls, **kw):
        eng = real(self, cls, **kw)
        built.append(eng)
        return eng

    monkeypatch.setattr(drivers.Driver, "_engine", engine)
    out = B.run_cell(bench, CELL, SEED, 0.2, False, device="cpu",
                     t_start=time.perf_counter(),
                     config_overrides={**SMALL, "backend": backend})
    return out, built


def test_cell_devices():
    assert B.cell_devices("cuda", 1) == ["cuda"]
    assert B.cell_devices("cpu", 1) == ["cpu"]
    assert B.cell_devices("cuda", 4) == [f"cuda:{i}" for i in range(4)]
    assert B.cell_devices("cpu", 4) == ["cpu"] * 4


def test_a_four_chip_cell_runs_on_a_mesh_of_its_devices(monkeypatch):
    out, built = run_recording_engines(monkeypatch, local_bench(4),
                                       "ell_sharded")
    res = out["result"]
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["device"]["count"] == 4 and out["rec"]["chips"] == 4
    assert res["device"]["memory_peak_bytes_per_card"] == [0] * 4
    (eng,) = built
    assert eng.backend == "ell_sharded" and eng.mesh.size == 4
    assert eng.mesh.axis_names == ("shard",)
    assert eng.mesh.device_list == [torch.device("cpu")] * 4


def test_a_one_chip_cell_builds_its_engine_without_a_mesh(monkeypatch):
    seen = []
    real = drivers.Driver._engine

    def engine(self, cls, **kw):
        seen.append((list(self.devices), dict(kw)))
        return real(self, cls, **kw)

    monkeypatch.setattr(drivers.Driver, "_engine", engine)
    res = B.run_cell(local_bench(1), CELL, SEED, 0.2, False, device="cpu",
                     t_start=time.perf_counter(),
                     config_overrides=SMALL)["result"]
    assert res["correct"], res["checks"]
    assert res["device"]["count"] == 1
    assert "memory_peak_bytes_per_card" not in res["device"]
    assert seen == [(["cpu"], {})]


@pytest.mark.parametrize("backend,shape", [
    ("ell_sharded", {"shard": 4}), ("dense_sharded", {"row": 2, "col": 2})])
def test_the_mesh_is_built_over_the_cells_devices(backend, shape):
    mesh = drivers.cell_mesh(backend, ["cpu"] * 4)
    assert mesh.shape == shape and mesh.size == 4


def test_every_card_is_waited_for_once(monkeypatch):
    waited = []
    monkeypatch.setattr(torch.cuda, "synchronize", waited.append)
    drivers.sync_all(["cuda:0", "cuda:1", "cuda:0", "cpu", "cuda:3"])
    assert waited == [torch.device(f"cuda:{i}") for i in (0, 1, 3)]
    waited.clear()
    drivers.sync_all(["cpu"] * 4)
    assert waited == []


def event(start, end, card, name="k", kind=None):
    from torch.autograd import DeviceType
    return SimpleNamespace(
        time_range=SimpleNamespace(start=start, end=end), name=name,
        device_type=kind or DeviceType.CUDA, device_index=card,
        is_user_annotation=False)


def test_busy_time_is_the_mean_of_the_cards_unions():
    from torch.autograd import DeviceType
    # card 0: [0, 10) and [5, 20) overlap, 20 µs; card 1: 30 µs and 10 µs
    # apart, 40 µs; the host's event is no device operation
    events = [event(0, 10, 0), event(5, 20, 0), event(100, 130, 1),
              event(200, 210, 1), event(0, 500, 0, "host", DeviceType.CPU)]
    got = devtrace.reduce_device(events, [0, 1])
    assert got["busy_s_per_card"] == pytest.approx([20e-6, 40e-6])
    assert got["busy_s"] == pytest.approx(30e-6)
    assert got["kernels"] == 4
    assert got["device_ops"] == [["k", pytest.approx(65e-6)]]
    # a card of the cell that ran nothing counts as idle
    got = devtrace.reduce_device(events, [0, 1, 2, 3])
    assert got["busy_s_per_card"] == pytest.approx([20e-6, 40e-6, 0, 0])
    assert got["busy_s"] == pytest.approx(15e-6)


def test_one_card_gives_the_single_union():
    events = [event(0, 10, 0), event(5, 20, 0), event(100, 130, 0),
              event(125, 140, 5)]
    # the reduction before cells of several cards: one union of every
    # device operation, whatever its index
    union = devtrace._union((e.time_range.start, e.time_range.end)
                            for e in events)
    single = sum(t - s for s, t in union) / 1e6
    # a cell of one chip names its card "cuda", without an index
    got = devtrace.reduce_device(events, [None])
    assert got["busy_s"] == single and got["busy_s_per_card"] == [single]
    assert single == pytest.approx(60e-6)


def test_the_roofline_counts_the_bandwidth_of_every_card():
    share = B.reader("roofline_share.graph").read
    rec = {"device_kind": "NVIDIA H100 80GB HBM3",
           "work_bytes_per_iter": 125_000_000,
           "profile": {"iterations": 1000, "busy_s": 0.2}}
    one = share({**rec, "chips": 1})
    assert one == pytest.approx(125e9 / 3.35e12 / 0.2 * 100)
    assert share({**rec, "chips": 4}) == pytest.approx(one / 4)
