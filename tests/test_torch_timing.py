"""PyTorch port, the paper's analytical model of its fabric: every case of
tests/test_timing.py run against ``repro_torch.core.timing`` and held to
``repro.core.timing`` on the same arguments, and the port's launcher
printing the paper's line.  These are times of the paper's 200 MHz fabric,
never of the card the port runs on."""
import pytest
from hypothesis import given, settings, strategies as st

from repro.core import timing as jtiming
from repro_torch.core import timing
from repro_torch.launch import pagerank_run


def test_headline_213_6_ms():
    """5000 proteins, 100 iterations, 4096 sites, 200 MHz -> 213.6 ms."""
    t = timing.pagerank_latency_s(5000, 100)
    assert t * 1e3 == pytest.approx(213.6, abs=0.1)
    assert t == jtiming.pagerank_latency_s(5000, 100)


def test_tile_model_components():
    spec = timing.DEFAULT_SPEC
    assert spec.tile_side == 64
    assert timing.pagerank_tiles(5000) == 6104          # ceil(25e6/4096)
    assert timing.pagerank_steps_tiled(5000, 100) == 100 * 6104 * 70
    assert spec == timing.FabricSpec()
    assert (spec.fabric_power_w, spec.step_seconds) == (
        jtiming.DEFAULT_SPEC.fabric_power_w, jtiming.DEFAULT_SPEC.step_seconds)


@pytest.mark.parametrize("n_rows", [256, 512, 1024, 2048, 4096, 8192])
def test_fig6a_latency_curve(n_rows):
    """Fig. 6A: MV latency == (N+3) cycles at 200 MHz."""
    lat = timing.matvec_latency_s(n_rows)
    assert lat == pytest.approx((n_rows + 3) * 5e-9)
    assert lat == jtiming.matvec_latency_s(n_rows)


@pytest.mark.parametrize("n", [1000, 2000, 3000, 4000, 5000])
def test_fig6b_throughput_curve_monotone(n):
    t = timing.pagerank_latency_s(n, 100)
    assert t > 0
    if n > 1000:
        assert t > timing.pagerank_latency_s(n - 1000, 100)
    assert t == jtiming.pagerank_latency_s(n, 100)


def test_unlimited_fabric_model():
    """Fig. 4B: n * (N + 6)."""
    assert timing.pagerank_steps_unlimited(5000, 100) == 100 * 5006
    t = (timing.pagerank_steps_unlimited(5000, 100)
         * timing.DEFAULT_SPEC.step_seconds)
    assert t == pytest.approx(2.503e-3, rel=1e-3)


def test_table1_constants():
    spec = timing.DEFAULT_SPEC
    assert spec.clock_hz == 200e6
    assert spec.site_power_w == pytest.approx(4.1e-3)
    assert spec.site_gates == 98_000
    assert spec.fabric_power_w == pytest.approx(4096 * 4.1e-3)
    assert spec.process == jtiming.DEFAULT_SPEC.process


@given(n=st.integers(1, 100_000))
@settings(max_examples=100, deadline=None)
def test_matvec_steps_formula(n):
    assert timing.matvec_steps(n) == n + 3
    assert timing.pagerank_iteration_steps(n) == n + 6


@given(n=st.integers(64, 20_000), iters=st.integers(1, 500))
@settings(max_examples=50, deadline=None)
def test_tiled_at_least_unlimited(n, iters):
    """Finite fabric can never beat the unlimited-fabric bound (for N > tile
    side, where tiling actually bites)."""
    if n >= timing.DEFAULT_SPEC.tile_side:
        assert (timing.pagerank_steps_tiled(n, iters)
                >= iters * (timing.DEFAULT_SPEC.tile_side + 6))
    assert (timing.pagerank_steps_tiled(n + 64, iters)
            >= timing.pagerank_steps_tiled(n, iters))
    assert (timing.pagerank_steps_tiled(n, iters + 1)
            > timing.pagerank_steps_tiled(n, iters))
    assert (timing.pagerank_steps_tiled(n, iters)
            == jtiming.pagerank_steps_tiled(n, iters))


def test_throughput_and_energy_sane():
    thr = timing.pagerank_throughput_flops(5000, 100)
    assert 1e9 < thr < 1e12          # fabric sustains ~23 GFLOP/s useful
    e = timing.pagerank_energy_j(5000, 100)
    assert e == pytest.approx(16.79 * 0.2136, rel=0.01)  # 16.8 W * 213.6 ms
    assert (thr, e) == (jtiming.pagerank_throughput_flops(5000, 100),
                        jtiming.pagerank_energy_j(5000, 100))


def test_launcher_prints_the_papers_fabric_model(capsys):
    """The launcher records the model beside the card's times and prints
    it on a line of its own, labelled as the paper's (at 300 nodes here to
    stay cheap; the 5000-node figure is the headline test above)."""
    results = pagerank_run.run(["--nodes", "300", "--iters", "20",
                                "--device", "cpu"])
    out = capsys.readouterr().out
    assert results["paper_fabric_model"] == timing.pagerank_latency_s(300, 20)
    line = next(ln for ln in out.splitlines()
                if ln.startswith("paper_fabric_model"))
    assert "the paper's model of its own fabric" in line
    assert f"{timing.pagerank_latency_s(300, 20) * 1e3:.2f} ms" in line
    assert "(paper reports 213.6 ms for N=5000, 100 iters" in out
    # the model is not listed among the card's wall times
    walls = out.split("wall time on")[1].split("paper_fabric_model")[0]
    assert "paper" not in walls
