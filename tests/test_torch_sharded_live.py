"""PyTorch port, the sharded mesh tiers' live and serving paths on the CPU,
each against the JAX package on the same inputs: live updates with their
strategies, shard-local patches and pushes (``tests/test_dynamic.py``), the
solve info and the injector's write-back (``tests/test_resilience.py``),
the landmark index (``tests/test_serve_accel.py``), the precision tiers
(``tests/test_precision.py``) and the PPR columns
(``tests/test_pagerank_properties.py``).

The JAX side runs on conftest's 8 virtual CPU devices and its default
meshes; the port's side on the same mesh shapes of ``["cpu"] * 8``.
Tolerances: the dynamic parity bound L1 <= 1e-5 (``tests/test_dynamic.py``)
against the JAX engine and a from-scratch solve; the landmark answers at
the JAX test's max abs 1e-5; the precision tiers at the JAX suite's
``SUM_TOL``."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.graph import generators as jgen
from repro.graph.delta import EdgeStream as JStream
from repro.graph.delta import GraphDelta as JDelta
from repro.launch.mesh import make_mesh as jmake_mesh
from repro.obs import registry as jreg
from repro.pagerank import DynamicPageRankEngine as JDyn
from repro.pagerank import FaultInjector as JInjector
from repro.pagerank import LandmarkIndex as JLandmarks
from repro.pagerank import PageRankEngine as JEngine
from repro_torch.core.fabric_matvec import ShardedTensor
from repro_torch.graph.delta import EdgeStream, GraphDelta, apply_delta
from repro_torch.graph.delta import edge_keys
from repro_torch.launch.mesh import make_mesh
from repro_torch.obs import registry as treg
from repro_torch.pagerank import DynamicPageRankEngine as TDyn
from repro_torch.pagerank import FaultInjector
from repro_torch.pagerank import LandmarkIndex
from repro_torch.pagerank import PageRankEngine as TEngine
from repro_torch.pagerank.resilience import ranks_healthy

SHARDED = ("dense_sharded", "ell_sharded")
PRECISIONS = ("f32", "bf16", "f16", "int8")
DEFAULT = {"dense_sharded": ((2, 4), ("row", "col")),
           "ell_sharded": ((8,), ("shard",))}
L1_TOL = 1e-5
SUM_TOL = {"f32": 1e-5, "bf16": 0.06, "f16": 0.01, "int8": 0.2}


def tmesh(backend):
    shape, axes = DEFAULT[backend]
    return make_mesh(shape, axes, ["cpu"] * int(np.prod(shape)))


def jmesh(backend):
    return jmake_mesh(*DEFAULT[backend])


def _np(x):
    if isinstance(x, ShardedTensor):
        x = x.full()
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(x, np.float64)


def _l1(a, b):
    return float(np.abs(_np(a) - _np(b)).sum())


def _absent_pairs(src, dst, n, k, seed=0):
    have = set(edge_keys(src, dst, n).tolist())
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < k:
        u, v = (int(x) for x in rng.integers(0, n, size=2))
        if u != v and u * n + v not in have and (u, v) not in out:
            out.append((u, v))
    a = np.array(out, np.int64)
    return a[:, 0], a[:, 1]


def _scratch(src, dst, n, delta=None):
    if delta is not None:
        src, dst = apply_delta(src, dst, delta, n)
    return TEngine(src, dst, n, backend="dense", device="cpu").run_tol(
        1e-8, max_iters=500)[0]


@pytest.fixture(scope="module")
def net(multi_device):
    n = 64
    src, dst = jgen.protein_network(n, seed=5)
    return n, src, dst


def _dyn_pair(net, backend, **kw):
    n, src, dst = net
    j = JDyn(src, dst, n, backend=backend, mesh=jmesh(backend),
             metrics=jreg.NullRegistry(), **kw)
    t = TDyn(src, dst, n, backend=backend, mesh=tmesh(backend),
             metrics=treg.NullRegistry(), **kw)
    return j, t


# --------------------------------------------------------------------------- #
# live updates (tests/test_dynamic.py)                                        #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("backend", SHARDED)
def test_run_tol_x0_warm_start_sharded(net, backend):
    n, src, dst = net
    j, t = _dyn_pair(net, backend)
    pr, cold, _ = t.run_tol(tol=1e-7, max_iters=500)
    pr2, warm, res2 = t.run_tol(tol=1e-7, max_iters=500, x0=pr)
    assert int(warm) <= 2 < int(cold)
    assert float(res2) <= 1e-7
    jpr, jcold, _ = j.run_tol(tol=1e-7, max_iters=500)
    assert abs(int(cold) - int(jcold)) <= 1
    _, jwarm, _ = j.run_tol(tol=1e-7, max_iters=500, x0=np.asarray(jpr))
    assert abs(int(warm) - int(jwarm)) <= 1


@pytest.mark.parametrize("backend", SHARDED)
@pytest.mark.parametrize("strategy", ["auto", "push", "warm", "rebuild"])
def test_sharded_update_matches_from_scratch(net, backend, strategy):
    n, src, dst = net
    j, t = _dyn_pair(net, backend)
    j.run_tol(1e-7, max_iters=500)
    t.run_tol(1e-7, max_iters=500)
    iu, iv = _absent_pairs(src, dst, n, 3, seed=1)
    args = (iu, iv, np.asarray(src[:2]), np.asarray(dst[:2]))
    pr, info = t.update(GraphDelta(*args), strategy=strategy)
    jpr, jinfo = j.update(JDelta(*args), strategy=strategy)
    assert info.strategy == jinfo.strategy == (
        strategy if strategy != "auto" else "push")
    assert info.coerced_from is None
    assert (info.cols_patched, info.rows_patched) == (jinfo.cols_patched,
                                                      jinfo.rows_patched)
    assert abs(info.iters - jinfo.iters) <= 1
    pr_np = _np(pr)
    assert (pr_np >= 0).all()
    assert pr_np.sum() == pytest.approx(1.0, abs=1e-4)
    assert _l1(pr, jpr) <= L1_TOL
    assert _l1(pr, _scratch(src, dst, n, GraphDelta(*args))) <= L1_TOL


@pytest.mark.parametrize("backend", SHARDED)
def test_sharded_insert_then_delete_is_noop(net, backend):
    """A delta and its inverse restore every shard bit-exactly, on the
    same positions."""
    n, src, dst = net
    _, t = _dyn_pair(net, backend)
    pr0 = t.run_tol(1e-7, max_iters=500)[0]
    before = [o.full().clone() for o in t.operands]
    dang_before = t._dang.full().clone()
    edges = _absent_pairs(src, dst, n, 3, seed=2)
    t.update(GraphDelta.inserts(*edges))
    pr2, _ = t.update(GraphDelta.deletes(*edges))
    for a, b in zip(before, t.operands):
        assert torch.equal(a, b.full())
    assert torch.equal(dang_before, t._dang.full())
    assert _l1(pr0, pr2) <= L1_TOL


@pytest.mark.parametrize("backend", SHARDED)
def test_sharded_patch_preserves_shardings(net, backend):
    """A patch keeps every operand's layout and devices, writes only the
    shards that hold the change (into copies), and drops the stale PPR
    copy of the layout."""
    n, src, dst = net
    _, t = _dyn_pair(net, backend)
    t.run_tol(1e-7, max_iters=500)
    t.ppr([[1, 2]], n_iters=10)
    assert t._ppr_operands is not None
    ops = t.operands
    specs = [(o.spec, o.shape, [s.device for s in o.shards]) for o in ops]
    values = [[s.clone() for s in o.shards] for o in ops]
    delta = GraphDelta.inserts(*_absent_pairs(src, dst, n, 2, seed=6))
    _, info = t.update(delta)
    assert info.strategy == "push"
    assert [(o.spec, o.shape, [s.device for s in o.shards])
            for o in t.operands] == specs
    # the shards the engine held are untouched (the rollback's contract)
    for old, vals in zip(ops, values):
        assert all(torch.equal(a, v) for a, v in zip(old.shards, vals))
    assert any(a is not b for o_old, o_new in zip(ops, t.operands)
               for a, b in zip(o_old.shards, o_new.shards))
    assert t._ppr_operands is None


def test_sharded_capacity_overflow_escalates(net):
    n, src, dst = net
    j, t = _dyn_pair(net, "ell_sharded", slack=2, rebuild_frac=1.0)
    j.run_tol(1e-7, max_iters=500)
    t.run_tol(1e-7, max_iters=500)
    cap = int(t.operands[0].shape[1])
    assert cap == int(j.operands[0].shape[1])
    indeg = np.bincount(dst, minlength=n)
    w = int(np.argmax(indeg))
    have = set(dst[src == w].tolist()) | {w}
    nbrs = [v for v in range(n) if v not in have][:cap - indeg[w] + 2]
    pr, info = t.update(GraphDelta.inserts([w] * len(nbrs), nbrs))
    jpr, jinfo = j.update(JDelta.inserts([w] * len(nbrs), nbrs))
    assert info.overflow and info.strategy == jinfo.strategy == "rebuild"
    assert info.coerced_from == jinfo.coerced_from == "push"
    assert int(t.operands[0].shape[1]) > cap
    assert _l1(pr, jpr) <= L1_TOL
    delta = GraphDelta.inserts([w] * len(nbrs), nbrs)
    assert _l1(pr, _scratch(src, dst, n, delta)) <= L1_TOL


@pytest.mark.parametrize("backend", SHARDED)
def test_sharded_auto_policy_matches_single_device(net, backend):
    n, src, dst = net
    local = "dense" if backend == "dense_sharded" else "ell"
    a = TDyn(src, dst, n, backend=local, device="cpu")
    _, b = _dyn_pair(net, backend)
    (u1, u2), (v1, v2) = _absent_pairs(src, dst, n, 2, seed=8)
    _, ia = a.update(GraphDelta.inserts([u1], [v1]))
    _, ib = b.update(GraphDelta.inserts([u1], [v1]))
    assert ia.strategy == ib.strategy == "warm"
    a.run_tol(1e-7, max_iters=500)
    b.run_tol(1e-7, max_iters=500)
    _, ia = a.update(GraphDelta.inserts([u2], [v2]))
    _, ib = b.update(GraphDelta.inserts([u2], [v2]))
    assert ia.strategy == ib.strategy == "push"
    assert ia.coerced_from is None and ib.coerced_from is None
    rng = np.random.default_rng(9)
    bu = rng.integers(0, n, size=a.n_edges // 4)
    bv = (bu + rng.integers(1, n, size=bu.size)) % n
    _, ia = a.update(GraphDelta.inserts(bu, bv))
    _, ib = b.update(GraphDelta.inserts(bu, bv))
    assert ia.strategy == ib.strategy == "rebuild"


@pytest.mark.parametrize("backend", SHARDED)
def test_sharded_stream_of_updates_tracks_scratch(net, backend):
    """A stream of mixed deltas: the same strategy per delta as the JAX
    sharded tier, and ranks that never drift from either it or the
    from-scratch oracle."""
    n = net[0]
    kw = dict(m_edges=3, seed=4, insert_per_step=4, delete_per_step=3)
    stream, jstream = EdgeStream(n, **kw), JStream(n, **kw)
    s0, d0 = stream.base()
    t = TDyn(s0, d0, n, backend=backend, mesh=tmesh(backend))
    j = JDyn(*jstream.base(), n, backend=backend, mesh=jmesh(backend))
    t.run_tol(1e-7, max_iters=500)
    j.run_tol(1e-7, max_iters=500)
    cur = (s0, d0)
    for _, delta, jdelta in zip(range(4), stream, jstream):
        pr, info = t.update(delta)
        jpr, jinfo = j.update(jdelta)
        assert info.strategy == jinfo.strategy
        cur = apply_delta(cur[0], cur[1], delta, n)
    assert _l1(pr, jpr) <= L1_TOL
    assert _l1(pr, _scratch(cur[0], cur[1], n)) <= L1_TOL


# --------------------------------------------------------------------------- #
# resilience (tests/test_resilience.py)                                       #
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def net200(multi_device):
    n = 200
    src, dst = jgen.protein_network(n, seed=11)
    return n, src, dst


@pytest.mark.parametrize("backend", SHARDED)
def test_sharded_backends_report_solve_info(net200, backend):
    n, src, dst = net200
    t = TEngine(src, dst, n, backend=backend, mesh=tmesh(backend))
    j = JEngine(src, dst, n, backend=backend, mesh=jmesh(backend))
    res = t.run_tol(tol=1e-6, max_iters=500)
    jres = j.run_tol(tol=1e-6, max_iters=500)
    assert res.info.converged and res.info.iters == int(res[1])
    assert ranks_healthy(res[0])
    assert res.info.status == jres.info.status
    assert abs(res.info.iters - jres.info.iters) <= 1


@pytest.mark.parametrize("kind,status", [("inf", None), ("nan", None),
                                         ("scale", "diverged")])
@pytest.mark.parametrize("backend", SHARDED)
def test_layout_fault_on_sharded_backend_flags_failed(net200, backend, kind,
                                                      status):
    """The injector writes the poisoned operand back onto its own mesh
    positions (same layout, same devices), and the watchdog aborts as the
    JAX tier's does."""
    n, src, dst = net200
    t = TEngine(src, dst, n, backend=backend, mesh=tmesh(backend))
    j = JEngine(src, dst, n, backend=backend, mesh=jmesh(backend))
    spec = (t.operands[0].spec, [s.device for s in t.operands[0].shards])
    inj = FaultInjector(seed=1)
    inj.corrupt_layout(t, kind=kind)
    JInjector(seed=1).corrupt_layout(j, kind=kind)
    assert (t.operands[0].spec,
            [s.device for s in t.operands[0].shards]) == spec
    assert inj.log == [f"layout:{kind}(k={0 if kind == 'scale' else 4},"
                       "operand=0)"]
    with pytest.warns(RuntimeWarning, match="did not converge"):
        res = t.run_tol(tol=1e-7, max_iters=500)
    with pytest.warns(RuntimeWarning, match="did not converge"):
        jres = j.run_tol(tol=1e-7, max_iters=500)
    assert res.info.failed and res.info.iters < 50
    assert res.info.status == jres.info.status
    assert status is None or res.info.status == status
    assert abs(res.info.iters - jres.info.iters) <= 1


# --------------------------------------------------------------------------- #
# the landmark index (tests/test_serve_accel.py)                              #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("backend", SHARDED)
def test_landmark_answers_are_faithful_distributions(multi_device, backend):
    from repro.pagerank.fidelity import kendall_tau, topk_overlap
    n, seed = 200, 7
    src, dst = jgen.protein_network(n, seed=seed)
    eng = TEngine(src, dst, n, backend=backend, mesh=tmesh(backend))
    jeng = JEngine(src, dst, n, backend=backend, mesh=jmesh(backend))
    lm = LandmarkIndex(eng, n_hubs=16, tol=1e-7, n_iters=60)
    jlm = JLandmarks(jeng, n_hubs=16, tol=1e-7, n_iters=60)
    lm.build(0)
    jlm.build(0)
    assert np.array_equal(lm.hubs, jlm.hubs)
    np.testing.assert_allclose(lm._Y, np.asarray(jlm._Y), rtol=1e-5,
                               atol=1e-7)
    rng = np.random.default_rng(0)
    seed_sets = [np.sort(rng.choice(n, size=3, replace=False))
                 for _ in range(4)]
    X, info = lm.answer(seed_sets)
    jX, jinfo = jlm.answer(seed_sets)
    assert X.shape == (n, 4) and float(X.min()) >= 0.0
    np.testing.assert_allclose(X.sum(axis=0), 1.0, atol=1e-5)
    assert abs(info["sweeps"] - jinfo["sweeps"]) <= 1
    assert info["fallbacks"] == jinfo["fallbacks"]
    # the JAX answers are within 1e-5 of an exact 200-iteration solve
    # (tests/test_serve_accel.py); the port's within 1e-5 of them
    jX = np.asarray(jX)
    assert float(np.abs(X - jX).max()) <= 1e-5
    for k in range(4):
        assert topk_overlap(X[:, k], jX[:, k], k=50) >= 0.99
        assert kendall_tau(X[:, k], jX[:, k], k=50) >= 0.99


def test_ell_sharded_landmarks_share_the_ppr_copy(multi_device):
    n = 200
    src, dst = jgen.protein_network(n, seed=7)
    eng = TEngine(src, dst, n, backend="ell_sharded",
                  mesh=tmesh("ell_sharded"))
    LandmarkIndex(eng, n_hubs=8, n_iters=30).build(0)
    ops = eng._ppr_operands
    assert ops is not None and all(o.spec == () or all(
        p is None for p in o.spec) for o in ops)
    LandmarkIndex(eng, n_hubs=8, n_iters=30).answer([[3, 5]])
    assert eng._ppr_operands is ops


# --------------------------------------------------------------------------- #
# precision tiers (tests/test_precision.py)                                   #
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def net_prec(multi_device):
    n = 200
    src, dst = jgen.protein_network(n, seed=3)
    return src, dst, n


@pytest.mark.parametrize("backend", SHARDED)
def test_f32_tier_bit_identical_to_default(backend, net_prec):
    src, dst, n = net_prec
    base = TEngine(src, dst, n, backend=backend, mesh=tmesh(backend))
    f32 = TEngine(src, dst, n, backend=backend, mesh=tmesh(backend),
                  precision="f32")
    assert base.precision == "f32"
    assert torch.equal(base.run(60), f32.run(60))
    a, b = base.run_tol(tol=1e-8), f32.run_tol(tol=1e-8)
    assert torch.equal(a[0], b[0]) and int(a[1]) == int(b[1])


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("backend", SHARDED)
def test_rank_invariants_all_backends_precisions(backend, precision,
                                                 net_prec):
    src, dst, n = net_prec
    eng = TEngine(src, dst, n, backend=backend, mesh=tmesh(backend),
                  precision=precision)
    jeng = JEngine(src, dst, n, backend=backend, mesh=jmesh(backend),
                   precision=precision)
    if precision != "f32":
        assert f"[{precision}]" in eng.layout
    pr, iters, res = eng.run_tol(tol=1e-6, max_iters=500)
    _, jiters, _ = jeng.run_tol(tol=1e-6, max_iters=500)
    pr = _np(pr)
    assert np.isfinite(pr).all() and (pr >= -1e-6).all()
    assert abs(pr.sum() - 1.0) <= SUM_TOL[precision]
    assert abs(int(iters) - int(jiters)) <= 1


# --------------------------------------------------------------------------- #
# PPR columns (tests/test_pagerank_properties.py)                             #
# --------------------------------------------------------------------------- #
@settings(max_examples=4, deadline=None)
@given(seed=st.integers(0, 10_000),
       seeds_a=st.lists(st.integers(0, 23), min_size=1, max_size=4),
       seeds_b=st.lists(st.integers(0, 23), min_size=1, max_size=4))
def test_ppr_columns_are_distributions(multi_device, seed, seeds_a, seeds_b):
    n = 24
    src, dst = jgen.barabasi_albert(n, m_edges=2, seed=seed)
    eng = TEngine(src, dst, n, backend="ell_sharded",
                  mesh=tmesh("ell_sharded"))
    jeng = JEngine(src, dst, n, backend="ell_sharded",
                   mesh=jmesh("ell_sharded"))
    sets = [np.asarray(seeds_a), np.asarray(seeds_b)]
    PPR = _np(eng.ppr(sets, n_iters=60))
    assert PPR.shape == (n, 2) and (PPR >= 0).all()
    np.testing.assert_allclose(PPR.sum(axis=0), 1.0, atol=1e-4)
    np.testing.assert_allclose(PPR, _np(jeng.ppr(sets, n_iters=60)),
                               rtol=1e-5, atol=1e-7)
