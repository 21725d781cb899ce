"""PyTorch port, engine on the CPU: every ported tier and precision against
the JAX engine on the same graph, the chunked tolerance loop against the
JAX ``while_loop``, the layout carried across packages, and the port's
import hygiene."""
import json
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph import generators as jgen
from repro.graph import transition as jtr
from repro.obs import registry as jreg
from repro.obs.trace import SolveTrace as JSolveTrace
from repro.pagerank import PageRankEngine as JEngine
from repro.pagerank import engine as jengine
from repro.pagerank.dense import pagerank_dense as jpagerank_dense
from repro.pagerank.sparse import top_k_proteins as jtop_k
from repro_torch.launch.mesh import make_mesh
from repro_torch.obs import registry as treg
from repro_torch.obs.trace import TRACE_LEN, SolveTrace
from repro_torch.pagerank import ConvergenceError
from repro_torch.pagerank import PageRankEngine as TEngine
from repro_torch.pagerank import engine as tengine
from repro_torch.pagerank.convert import layout_from_numpy
from repro_torch.pagerank.dense import pagerank_dense as tpagerank_dense
from repro_torch.pagerank.sparse import top_k_proteins as ttop_k

# port backend name -> JAX backend name: the one table the tests read
BACKEND_MAP = {"dense": "dense", "ell": "ell", "bsr": "bsr",
               "fused_dense": "pallas_dense",
               "dense_sharded": "dense_sharded",
               "ell_sharded": "ell_sharded"}
# the sharded tiers run on the JAX default mesh of conftest's 8 devices
# and on a CPU mesh of the same shape in the port
SHARDED_MESH = {"dense_sharded": ((2, 4), ("row", "col")),
                "ell_sharded": ((8,), ("shard",))}
PRECISIONS = ("f32", "bf16", "f16", "int8")
# engine vs reference (tests/test_pagerank_engine.py)
TOL = {"dense": dict(rtol=1e-5, atol=1e-7), "ell": dict(rtol=1e-4,
                                                        atol=1e-7),
       "bsr": dict(rtol=1e-5, atol=1e-7),
       "fused_dense": dict(rtol=1e-5, atol=1e-7),
       "dense_sharded": dict(rtol=1e-5, atol=1e-7),
       "ell_sharded": dict(rtol=1e-5, atol=1e-7)}
SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(scope="module")
def net():
    n = 200
    src, dst = jgen.protein_network(n, seed=7)
    assert int(jtr.dangling_mask(src, n).sum()) > 0
    return n, src, dst


def _tmesh(backend):
    if backend not in SHARDED_MESH:
        return None
    shape, axes = SHARDED_MESH[backend]
    return make_mesh(shape, axes, ["cpu"] * int(np.prod(shape)))


def _pair(net, backend, precision="f32"):
    n, src, dst = net
    j = JEngine(src, dst, n, backend=BACKEND_MAP[backend],
                precision=precision, metrics=jreg.NullRegistry())
    t = TEngine(src, dst, n, backend=backend, precision=precision,
                device="cpu", mesh=_tmesh(backend),
                metrics=treg.NullRegistry())
    return j, t


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _leaves(operands):
    """The operand tensors, a container (BSRMatrix) flattened in its JAX
    pytree leaf order, a sharded operand as its global tensor."""
    return [t.full() if hasattr(t, "shards") else t for o in operands
            for t in (o.tensors() if hasattr(o, "tensors") else (o,))]


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("backend", ["dense", "ell"])
def test_run_matches_jax(net, backend, precision):
    j, t = _pair(net, backend, precision)
    assert t.layout == j.layout
    np.testing.assert_allclose(_np(t.run(100)), _np(j.run(100)),
                               **TOL[backend])


@pytest.mark.parametrize("precision", PRECISIONS)
def test_fused_run_matches_pallas(net, precision):
    j, t = _pair(net, "fused_dense", precision)
    assert [tuple(o.shape) for o in t.operands] == [
        tuple(o.shape) for o in j.operands]
    pr = t.run(15)
    assert pr.shape == (net[0],) and pr.dtype == torch.float32
    np.testing.assert_allclose(_np(pr), _np(j.run(15)), **TOL["fused_dense"])


@pytest.mark.parametrize("backend", list(BACKEND_MAP))
@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_run_tol_matches_jax(net, backend, precision):
    j, t = _pair(net, backend, precision)
    jr = j.run_tol(tol=1e-7, max_iters=300)
    tr_ = t.run_tol(tol=1e-7, max_iters=300)
    # float32 accumulation order may move the exit by one iteration
    assert abs(int(tr_.iters) - int(jr.iters)) <= 1
    assert tr_.info.status == jr.info.status == "converged"
    assert t.last_solve_info is tr_.info
    assert tr_.info.trace.n_iters == tr_.info.iters
    assert tr_.info.trace.residuals[-1] == pytest.approx(tr_.info.residual,
                                                         rel=1e-6)
    np.testing.assert_allclose(_np(tr_.pr), _np(jr.pr), rtol=1e-4,
                               atol=1e-7)


@pytest.mark.parametrize("backend", list(BACKEND_MAP))
def test_trace_ring_unwraps_past_window(net, backend):
    """tol=0 never converges: 70 iterations wrap the 64-slot ring; the
    unwrapped trajectory is the last 64 residuals, oldest first, and it
    agrees with the JAX ring to the float32 noise floor."""
    j, t = _pair(net, backend)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        jr = j.run_tol(tol=0.0, max_iters=70)
        tr_ = t.run_tol(tol=0.0, max_iters=70)
        short = t.run_tol(tol=0.0, max_iters=TRACE_LEN)
    assert int(tr_.iters) == int(jr.iters) == 70
    assert tr_.info.status == jr.info.status == "exhausted"
    tres, jres = tr_.info.trace.residuals, jr.info.trace.residuals
    assert len(tres) == len(jres) == TRACE_LEN
    assert tres[-1] == pytest.approx(tr_.info.residual, rel=1e-6)
    # residuals 7..64 of the wrapped run are residuals 7..64 of the run
    # that fit the ring, in the same order
    assert np.array_equal(tres[:TRACE_LEN - 6],
                          short.info.trace.residuals[6:])
    # the tail sits at the float32 noise floor of an L1 residual (~1e-8),
    # where summation order decides the digits: atol of the engine checks
    np.testing.assert_allclose(tres, jres, rtol=2e-2, atol=1e-7)


@pytest.mark.parametrize("iters", [0, 5, 64, 65, 130])
def test_solve_trace_unwrap_matches_jax(iters):
    ring = np.arange(TRACE_LEN, dtype=np.float32) + 1.0
    got = SolveTrace(torch.from_numpy(ring), torch.tensor(iters))
    want = JSolveTrace(jnp.asarray(ring), jnp.int32(iters))
    assert np.array_equal(got.residuals, want.residuals)
    assert np.array_equal(got.ratios, want.ratios)
    assert len(got) == len(want) and got.n_iters == iters


@pytest.mark.parametrize("backend", list(BACKEND_MAP))
def test_warm_start(net, backend):
    j, t = _pair(net, backend)
    x0 = np.asarray(j.run(100), np.float32)
    jr = j.run_tol(tol=1e-7, max_iters=300, x0=x0)
    tr_ = t.run_tol(tol=1e-7, max_iters=300, x0=x0)
    cold = t.run_tol(tol=1e-7, max_iters=300)
    assert abs(int(tr_.iters) - int(jr.iters)) <= 1
    assert int(tr_.iters) < int(cold.iters)
    np.testing.assert_allclose(_np(tr_.pr), _np(jr.pr), rtol=1e-4,
                               atol=1e-7)


def test_res0_early_exit_and_max_iters_bound():
    """An already-converged start takes no step; the loop never issues
    more than max_iters steps.  A tensor ``res0`` (the landmark push's)
    stays on the device and gives the JAX loop's early exit and
    iteration count."""
    from repro.obs.trace import instrumented_tol_loop as jloop
    from repro_torch.obs.trace import instrumented_tol_loop
    H = torch.eye(4) * 0.5
    calls = []

    def step(x):
        calls.append(1)
        return H @ x, torch.tensor(1.0)

    x0 = torch.ones(4)
    state, i, res, grow, ring = instrumented_tol_loop(
        step, x0, tol=1e-3, max_iters=10, res0=0.0)
    assert int(i) == 0 and not calls and torch.equal(state, x0)
    state, i, res, grow, ring = instrumented_tol_loop(
        step, x0, tol=1e-3, max_iters=3)
    assert int(i) == 3 and len(calls) == 3
    assert torch.equal(state, x0 / 8)

    # a halving residual from a tensor res0, against the JAX while_loop
    def tstep(x):
        new = 0.5 * x
        return new, torch.sum(torch.abs(new - x))

    def jstep(x):
        new = 0.5 * x
        return new, jnp.sum(jnp.abs(new - x))

    for r0, max_iters in ((0.5, 40), (1e-4, 40), (4.0, 40), (4.0, 3)):
        res0 = torch.tensor(r0)
        tout = instrumented_tol_loop(tstep, x0, tol=1e-3,
                                     max_iters=max_iters, trace=False,
                                     res0=res0)
        jout = jloop(jstep, jnp.ones(4), tol=1e-3, max_iters=max_iters,
                     trace=False, res0=jnp.float32(r0))
        assert int(tout[1]) == int(jout[1])
        assert float(tout[2]) == float(jout[2])
        np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    assert int(tout[1]) == 3
    # res0 is used as given, with no host round trip
    seen = []

    class Res0(torch.Tensor):
        def __float__(self):
            seen.append(1)
            return super().__float__()

    instrumented_tol_loop(tstep, x0, tol=1e-3, max_iters=2, trace=False,
                          res0=torch.tensor(0.5).as_subclass(Res0))
    assert not seen


@pytest.mark.parametrize("scale,status", [(50.0, "diverged"),
                                          (float("nan"), "nonfinite")])
def test_watchdog_matches_jax(net, scale, status):
    n, src, dst = net
    H = np.asarray(jtr.build_transition_dense(src, dst, n)) * scale
    kw = dict(d=0.85, tol=1e-7, max_iters=200, watchdog=True, trace=True)
    jout = jpagerank_dense(jnp.asarray(H), **kw)
    tout = tpagerank_dense(torch.from_numpy(H), **kw)
    for a, b in zip(tout[1:4], jout[1:4]):          # iters, res, grow
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)
    info = tengine.make_solve_info(tout[1], tout[2], tout[3], tol=1e-7,
                                   max_iters=200)
    assert info.status == status and info.failed


def test_raise_on_fail_and_warn_once(net):
    _, t = _pair(net, "ell")
    with pytest.raises(ConvergenceError, match="max_iters=3 exhausted"):
        t.run_tol(tol=1e-12, max_iters=3, raise_on_fail=True)
    with pytest.warns(RuntimeWarning, match="did not converge"):
        t.run_tol(tol=1e-12, max_iters=3)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        res = t.run_tol(tol=1e-12, max_iters=3)     # silent the 2nd time
    assert res.info.exhausted and not res.info.failed


def test_single_warned_f64_downcast(net):
    _, t = _pair(net, "fused_dense")
    x0 = np.full(net[0], 1.0 / net[0])              # float64
    with pytest.warns(UserWarning) as rec:
        r64 = t.run_tol(tol=1e-7, max_iters=300, x0=x0)
    msgs = [str(w.message) for w in rec if w.category is UserWarning]
    assert len(msgs) == 1 and msgs[0].startswith("x0 is float64")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        r32 = t.run_tol(tol=1e-7, max_iters=300, x0=x0.astype(np.float32))
    assert torch.equal(r64.pr, r32.pr)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("backend", list(BACKEND_MAP))
def test_layout_bytes_and_carried_layout(net, backend, precision):
    """layout_bytes equals the JAX engine's; the JAX operands carried
    across equal the port's own build, bit for bit (a BSR container as its
    pytree leaves)."""
    j, t = _pair(net, backend, precision)
    assert t.layout_bytes == j.layout_bytes
    arrays = {"operands": [np.asarray(o)
                           for o in jax.tree_util.tree_leaves(j.operands)],
              "scales": None if j._scales is None else np.asarray(j._scales),
              "dang": np.asarray(j._dang)}
    lay = layout_from_numpy(backend, arrays, precision=precision,
                            device="cpu", mesh=t.mesh)
    assert len(lay["operands"]) == len(t.operands)
    assert len(_leaves(lay["operands"])) == len(_leaves(t.operands))
    for a, b in zip(_leaves(lay["operands"]), _leaves(t.operands)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert (lay["scales"] is None) == (t._scales is None)
    if t._scales is not None:
        assert torch.equal(*_leaves((lay["scales"], t._scales)))
    assert torch.equal(*_leaves((lay["dang"], t._dang)))
    e = TEngine.from_layout(backend, lay, net[0], precision=precision,
                            device="cpu", metrics=treg.NullRegistry())
    assert e.layout_bytes == t.layout_bytes
    k = 15 if backend == "fused_dense" else 100
    assert torch.equal(e.run(k), t.run(k))


def test_layout_from_numpy_rejects_mismatch(net):
    j, _ = _pair(net, "dense", "bf16")
    arrays = {"operands": [np.asarray(o) for o in j.operands],
              "scales": None, "dang": np.asarray(j._dang)}
    with pytest.raises(ValueError, match="bf16|stores"):
        layout_from_numpy("dense", arrays, precision="f16", device="cpu")
    with pytest.raises(ValueError, match="operands"):
        layout_from_numpy("dense", arrays, precision="int8", device="cpu")


def test_select_backend_parity():
    """cpu: the JAX choice; one card: the sweep's choice
    (scripts/backend_sweep.py, PERF.md), which on an H100 is the ``dense``
    tier up to N = 5000 at every density, where the JAX TPU policy takes
    pallas_dense, ell or bsr."""
    for n, density in [(200, 0.5), (200, 0.25), (500, 0.1), (500, 0.01),
                       (100, 0.01)]:
        assert tengine.select_backend(n, density, device="cpu") == \
            jengine.select_backend(n, density, device="cpu", n_devices=1)
        assert tengine.select_backend(n, density, device="cuda",
                                      n_devices=1) == "dense"
    with pytest.raises(ValueError):
        tengine.select_backend(10, 0.5, device="cpu", precision="f64")


def test_engine_defaults_to_cuda(net, monkeypatch):
    n, src, dst = net
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TEngine(src, dst, n)
    with pytest.raises(ValueError, match="backend"):
        TEngine(src, dst, n, backend="pallas_dense", device="cpu")


def test_dedupe_and_self_loops_match_jax():
    n = 30
    rng = np.random.default_rng(9)
    src = rng.integers(0, n, 150)
    dst = rng.integers(0, n, 150)
    src = np.concatenate([src, src[:20], [3, 4]])     # duplicates
    dst = np.concatenate([dst, dst[:20], [3, 4]])     # + self-loops
    for backend in ("dense", "ell"):
        j = JEngine(src, dst, n, backend=backend, metrics=jreg.NullRegistry())
        t = TEngine(src, dst, n, backend=backend, device="cpu",
                    metrics=treg.NullRegistry())
        assert t.n_edges == j.n_edges and t.density == j.density
        assert np.array_equal(t._keys, j._keys)
        np.testing.assert_allclose(_np(t.run(50)), _np(j.run(50)),
                                   **TOL[backend])


def test_metrics_spans_counters_events(net):
    n, src, dst = net
    jm, tm = jreg.MetricsRegistry(), treg.MetricsRegistry()
    j = JEngine(src, dst, n, backend="pallas_dense", metrics=jm)
    t = TEngine(src, dst, n, backend="fused_dense", device="cpu",
                metrics=tm)
    j.run_tol(tol=1e-7, max_iters=300)
    t.run_tol(tol=1e-7, max_iters=300)
    jd, td = jm.as_dict(), tm.as_dict()
    assert td["counters"] == jd["counters"]
    assert td["gauges"] == jd["gauges"]
    assert set(td["histograms"]) == set(jd["histograms"])
    assert [e["kind"] for e in tm.events] == [e["kind"] for e in jm.events]
    for te, je in zip(tm.events, jm.events):
        assert list(te) == list(je)
        if te["kind"] == "solve":
            assert te["precision"] == je["precision"]
            assert te["status"] == je["status"]


def test_registry_jsonl_byte_compatible(tmp_path):
    regs = {}
    for name, mod in (("jax", jreg), ("torch", treg)):
        path = tmp_path / f"{name}.jsonl"
        reg = mod.MetricsRegistry(jsonl_path=str(path), window=4)
        reg.event("solve", backend="ell", iters=3, residual=1e-7,
                  status="converged")
        reg.counter("engine.solves").inc(2)
        for v in (3.0, 1.0, 2.0, 5.0, 4.0):
            reg.histogram("h").observe(v)
        reg.close()
        lines = [json.loads(s) for s in path.read_text().splitlines()]
        for ev in lines:
            ev.pop("t_ms")
        regs[name] = (lines, reg.as_dict())
    assert regs["torch"] == regs["jax"]
    assert treg.EVENT_SCHEMA_VERSION == jreg.EVENT_SCHEMA_VERSION
    null = treg.NullRegistry()
    with null.span("x"):
        null.counter("c").inc()
    assert null.as_dict()["counters"] == {}


def test_profiler_annotations_span():
    reg = treg.MetricsRegistry(profiler_annotations=True)
    with reg.span("solve", backend="ell"):
        torch.ones(2).sum()
    assert reg.as_dict()["histograms"]["span.solve"]["count"] == 1


def test_top_k_proteins_matches_jax(net):
    j, t = _pair(net, "dense")
    jidx, jsc = jtop_k(j.run(100), k=10)
    tidx, tsc = ttop_k(t.run(100), k=10)
    assert np.array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=1e-5)


def test_launcher_runs_on_cpu(capsys):
    from repro_torch.launch import pagerank_run
    res = pagerank_run.run(["--nodes", "150", "--iters", "10",
                            "--device", "cpu", "--precision", "bf16"])
    out = capsys.readouterr().out
    assert "fused_dense[bf16]" in out and "top-10 proteins" in out
    assert set(res) == {"engine_dense", "engine_fused_dense[bf16]",
                        "paper_fabric_model"} | {
        k for k in res if k.startswith("engine_ell")}


def test_launcher_fails_when_ell_disagrees(monkeypatch):
    """As in the JAX launcher, a wrong ell tier fails the run."""
    from repro_torch.launch import pagerank_run
    matvec = tengine._matvec
    monkeypatch.setattr(tengine, "_matvec",
                        lambda b, ops, x: 1.1 * matvec(b, ops, x))
    with pytest.raises(AssertionError):
        pagerank_run.run(["--nodes", "150", "--iters", "10",
                          "--device", "cpu"])


def test_import_hygiene_subprocess():
    """The port imports neither jax nor the JAX package when it runs."""
    code = (
        "import sys, numpy as np\n"
        "import repro_torch\n"
        "from repro_torch.graph.generators import protein_network\n"
        "from repro_torch.pagerank import PageRankEngine\n"
        "from repro_torch.launch import pagerank_run\n"
        "from repro_torch.pagerank import convert, LandmarkIndex\n"
        "from repro_torch.pagerank import sparse, fidelity\n"
        "from repro_torch.serve import PageRankQueryEngine, ResultCache\n"
        "from repro_torch.pagerank import DynamicPageRankEngine\n"
        "from repro_torch.pagerank.resilience import EngineSnapshot\n"
        "from repro_torch.pagerank import FaultInjector\n"
        "from repro_torch.graph.validate import validate_delta\n"
        "from repro_torch.serve import ServeResilience\n"
        "from repro_torch.core import timing\n"
        "from repro_torch.graph import (BSRMatrix, ELLMatrix,\n"
        "    build_transition_bsr, build_transition_ell)\n"
        "from repro_torch.graph.delta import (EdgeStream, GraphDelta,\n"
        "    apply_delta, compose)\n"
        "from repro_torch.kernels import ops, bsr_spmv, ref\n"
        "import torch\n"
        "src, dst = protein_network(64, seed=0)\n"
        "H = torch.rand(64, 64)\n"
        "ops.matvec(H, torch.rand(64))\n"
        "ops.gemv_batched(H, torch.rand(2, 64))\n"
        "ops.pagerank_iteration(H, torch.rand(64), torch.zeros(64))\n"
        "b = build_transition_bsr(src, dst, 64, bs=32, device='cpu')\n"
        "ops.spmv(b, torch.rand(64)); build_transition_ell(src, dst, 64,\n"
        "    device='cpu')\n"
        "from repro_torch.pagerank.engine import default_mesh\n"
        "for b in ('dense', 'ell', 'bsr', 'fused_dense', 'dense_sharded',\n"
        "          'ell_sharded'):\n"
        "    mesh = (default_mesh(b, 'cpu', 4) if b.endswith('sharded')\n"
        "            else None)\n"
        "    e = PageRankEngine(src, dst, 64, backend=b, device='cpu',\n"
        "                       mesh=mesh)\n"
        "    e.run(5); e.run_tol(1e-6, max_iters=50)\n"
        "    X = e.ppr([[1, 2], [3]], n_iters=10)\n"
        "    lm = LandmarkIndex(e, n_hubs=4, n_iters=20)\n"
        "    qe = PageRankQueryEngine(e, n_iters=20, cache=ResultCache(8),\n"
        "                             landmarks=lm)\n"
        "    r = qe.query_batch([[1, 2], [3], [1, 2]], top_k=3)\n"
        "    assert len(r) == 3 and lm.built\n"
        "    fidelity.topk_overlap(X[:, 0], X[:, 1], k=5)\n"
        "    st = EdgeStream(64, m_edges=3, seed=1)\n"
        "    s0, d0 = st.base()\n"
        "    dyn = DynamicPageRankEngine(s0, d0, 64, backend=b,\n"
        "                                device='cpu', mesh=mesh)\n"
        "    dyn.run_tol(1e-7)\n"
        "    qe = PageRankQueryEngine(dyn, n_iters=20, cache=ResultCache(8))\n"
        "    qe.push_update(st.step()); qe.push_update(st.step())\n"
        "    qe.query_batch([[1, 2]]); snap = dyn.snapshot()\n"
        "    assert qe.n_refreshes == 1; dyn.restore(snap)\n"
        "    rq = PageRankQueryEngine(dyn, n_iters=20,\n"
        "                             resilience=ServeResilience())\n"
        "    FaultInjector(seed=0).corrupt_layout(dyn, kind='nan')\n"
        "    rq.push_update(st.step()); q = rq.submit(0, [1, 2]); rq.flush()\n"
        "    assert rq.last_refresh_outcome.status in ('ok', 'recovered')\n"
        "    assert q.status == 'fresh'\n"
        "assert round(timing.pagerank_latency_s(5000, 100) * 1e3, 1) == 213.6\n"
        "from repro_torch.core import fabric, isa, schedule\n"
        "from repro_torch.core.convert import fabric_from_numpy\n"
        "from repro_torch.pagerank import pagerank_on_fabric\n"
        "from repro_torch.graph.transition import build_transition_dense\n"
        "m = isa.from_hex('00f44121999a0051', device='cpu')\n"
        "assert isa.to_hex(m) == '00f44121999a0051'\n"
        "fab0 = fabric.Fabric.create(4, 4, 'cpu')\n"
        "fin, _ = fabric.run(fab0, isa.Message.empty((2, 4), device='cpu'),\n"
        "                    isa.Message.empty((2, 4), device='cpu'))\n"
        "def arrays(obj):\n"
        "    return {k: arrays(v) if isinstance(v, isa.Message) else\n"
        "            v.numpy() for k, v in vars(obj).items()}\n"
        "fabric_from_numpy(arrays(fin), device='cpu')\n"
        "mv = schedule.matvec(torch.rand(4, 3), torch.rand(3),\n"
        "                     use_messages=True)\n"
        "assert mv.steps == 7 and int(mv.state.conflicts) == 0\n"
        "H = build_transition_dense(src, dst, 64, device='cpu')\n"
        "pr, steps, secs = pagerank_on_fabric(H, n_iters=3)\n"
        "assert steps == 3 * 70\n"
        "assert schedule.pagerank_tiled(H, n_iters=2).steps == 2 * 70\n"
        "from repro_torch.launch.mesh import make_mesh\n"
        "from repro_torch.core import fabric_matvec as fm\n"
        "from repro_torch.pagerank import distributed\n"
        "fm.fabric_gemv_batched(torch.rand(8, 4), torch.rand(2, 4),\n"
        "    make_mesh((2, 2), ('data', 'model'), ['cpu'] * 4))\n"
        "from repro_torch.configs import get_smoke_config, get_config\n"
        "from repro_torch.models import model as M\n"
        "from repro_torch.models.convert import cache_to_numpy\n"
        "from repro_torch.serve import ServeEngine, Request\n"
        "from repro_torch.launch import serve as lm_serve\n"
        "M.abstract_params(get_config('llama3-8b'))\n"
        "for arch in ('llama3-8b', 'olmoe-1b-7b', 'mamba2-2.7b',\n"
        "             'zamba2-2.7b', 'musicgen-large',\n"
        "             'llama-3.2-vision-90b'):\n"
        "    cfg = get_smoke_config(arch)\n"
        "    lm = M.init_params(cfg, 0, device='cpu')\n"
        "    b = ({'tokens': torch.zeros((1, 4), dtype=torch.long)}\n"
        "         if cfg.embed_input else\n"
        "         {'embeds': torch.rand(1, 4, cfg.d_model)})\n"
        "    if cfg.family == 'vlm':\n"
        "        b['vision_embeds'] = torch.rand(1, cfg.n_vision_tokens,\n"
        "                                        cfg.vision_dim)\n"
        "    M.forward(lm, b, cfg)\n"
        "    _, c = M.prefill(lm, b, cfg, 8)\n"
        "    d = {k: v[:, :1] for k, v in b.items() if k != 'vision_embeds'}\n"
        "    M.decode_step(lm, d, c, cfg); cache_to_numpy(c)\n"
        "cfg = get_smoke_config('llama3-8b')\n"
        "se = ServeEngine(cfg, M.init_params(cfg, 0, device='cpu'))\n"
        "se.serve([Request(0, np.arange(1, 5, dtype=np.int32), 2)])\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin"})
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout
