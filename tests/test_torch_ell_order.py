"""PyTorch port, the ``ell`` layout's vertex order on the CPU.  Past
``HOT_COLUMNS`` vertices the layout numbers the vertices by out-degree,
descending, ties by id, so the most-gathered columns of x share its first
lines.  On a degree-skewed graph of 50,000 vertices: the order is that
stable sort; the layout equals, bit for bit, the host build of the
relabelled edges; ``run``, ``run_tol``, ``ppr``, the push and the landmark
answers come back in the caller's ids and match the JAX package's ``ell``
engine within the engine parity tests' tolerances.  At 32,768 vertices the
layout keeps the caller's ids, at 32,769 it does not; the dynamic engine,
``ell_sharded`` and carried layouts keep them always.  The ``prepare.csr``
span carries the order and the share of entries in the hot columns."""
import numpy as np
import pytest
import torch

from repro.obs import registry as jreg
from repro.pagerank import PageRankEngine as JEngine
from repro.pagerank import dynamic as jdyn
from repro.pagerank.landmarks import LandmarkIndex as JLandmarks
from repro_torch.graph.delta import dedupe_directed
from repro_torch.launch.mesh import make_mesh
from repro_torch.obs.registry import MetricsRegistry, NullRegistry
from repro_torch.pagerank import (DynamicPageRankEngine, LandmarkIndex,
                                  PageRankEngine)
from repro_torch.pagerank import dynamic as tdyn
from repro_torch.pagerank.convert import layout_from_numpy
from repro_torch.pagerank.engine import HOT_COLUMNS
from repro_torch.pagerank.precision import PRECISIONS, layout_nbytes
from test_torch_layout_build import _assert_bits, _degree_order, _ell_host

# engine vs reference (tests/test_torch_engine.py, test_torch_ppr.py,
# test_torch_dynamic.py, test_torch_serve.py)
RUN_TOL = dict(rtol=1e-4, atol=1e-7)
PPR_TOL = dict(rtol=1e-5, atol=1e-7)
L1_BOUND = 1e-5
LM_ATOL = 1e-5
SEED_SETS = [[3, 50], [120], [7, 7, 9], [49_999], [0, 1, 2, 3, 4]]


def _skewed(n=50_000, seed=33):
    """Out-degrees by Zipf(2) up to 2000 on randomly placed ids, 5 %
    dangling; a fifth of the targets on Zipf hubs (rows past k0)."""
    rng = np.random.default_rng(seed)
    deg = np.minimum(rng.zipf(2.0, n), 2000)
    deg[rng.random(n) < 0.05] = 0
    src = np.repeat(rng.permutation(n), deg)
    m = src.size
    dst = np.where(rng.random(m) < 0.2, (rng.zipf(1.5, m) * 7919) % n,
                   rng.integers(0, n, m))
    return src.astype(np.int64), dst.astype(np.int64), n


SRC, DST, N = _skewed()


def _engine(src=SRC, dst=DST, n=N, metrics=None, **kw):
    kw.setdefault("backend", "ell")
    if kw.get("mesh") is None:
        kw.setdefault("device", "cpu")
    return PageRankEngine(src, dst, n, metrics=metrics or NullRegistry(),
                          **kw)


@pytest.fixture(scope="module")
def pair():
    return (JEngine(SRC, DST, N, backend="ell", metrics=jreg.NullRegistry()),
            _engine())


def test_the_order_is_a_stable_bijection_by_out_degree():
    eng = _engine()
    order = eng.vertex_order
    assert order.dtype == torch.int64 and order.device.type == "cpu"
    order = order.numpy()
    assert np.array_equal(np.sort(order), np.arange(N))
    s, _ = dedupe_directed(SRC, DST, N, drop_self_loops=False)
    outdeg = np.bincount(s, minlength=N)
    deg = outdeg[order]
    assert bool((np.diff(deg) <= 0).all())
    ties = np.diff(deg) == 0
    assert bool((np.diff(order)[ties] > 0).all())       # ties by id
    assert np.array_equal(order, _degree_order(SRC, DST, N))
    # the engine's host bookkeeping stays in the caller's ids
    assert np.array_equal(eng._outdeg, outdeg)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("ell_k", [None, 3])
def test_the_ordered_layout_equals_the_host_build_of_relabelled_edges(
        ell_k, precision):
    eng = _engine(ell_k=ell_k, precision=precision)
    order = _degree_order(SRC, DST, N)
    assert np.array_equal(eng.vertex_order.numpy(), order)
    ops, dang, layout = _ell_host(SRC, DST, N, ell_k, precision, order)
    _assert_bits(eng.operands, ops)
    _assert_bits((eng._dang,), (dang,))
    assert eng.layout == layout
    assert eng.layout_bytes == layout_nbytes(ops)


@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_run_matches_jax_in_the_callers_ids(precision):
    j = JEngine(SRC, DST, N, backend="ell", precision=precision,
                metrics=jreg.NullRegistry())
    t = _engine(precision=precision)
    assert t.vertex_order is not None
    np.testing.assert_allclose(t.run(10).numpy(), np.asarray(j.run(10)),
                               **RUN_TOL)


def test_run_tol_matches_jax_cold_and_warm(pair):
    j, t = pair
    for x0 in (None, np.asarray(j.run(5), np.float32)):
        jr = j.run_tol(tol=1e-7, max_iters=300, x0=x0)
        tr_ = t.run_tol(tol=1e-7, max_iters=300, x0=x0)
        assert abs(int(tr_.iters) - int(jr.iters)) <= 1
        assert tr_.info.status == jr.info.status == "converged"
        np.testing.assert_allclose(tr_.pr.numpy(), np.asarray(jr.pr),
                                   **RUN_TOL)


def test_ppr_matches_jax(pair):
    j, t = pair
    got = t.ppr(SEED_SETS, n_iters=60)
    assert got.shape == (N, len(SEED_SETS)) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(j.ppr(SEED_SETS, n_iters=60)),
                               **PPR_TOL)


def test_the_push_matches_jax(pair):
    """The push from a warm start in the caller's ids, on the tier's
    operator in the layout's order, against the JAX push."""
    j, t = pair
    x0 = np.array(j.run(20), np.float32)
    tol = np.float32(1e-7)
    jx, jit_, *_ = jdyn._push_tol(j.operands, j._dang, j.d, tol, x0,
                                  backend="ell", n=N, max_pushes=200)
    tx, tit, *_ = tdyn._push_tol(t, torch.tensor(tol), torch.from_numpy(x0),
                                 max_pushes=200)
    assert abs(int(tit) - int(jit_)) <= 1
    assert float(np.abs(tx.numpy() - np.asarray(jx)).sum()) <= L1_BOUND


def test_landmark_answers_match_jax(pair):
    j, t = pair
    jl = JLandmarks(j, n_hubs=16, tol=1e-7, n_iters=60)
    tl = LandmarkIndex(t, n_hubs=16, tol=1e-7, n_iters=60,
                       metrics=NullRegistry())
    jX, jinfo = jl.answer(SEED_SETS)
    tX, tinfo = tl.answer(SEED_SETS)
    assert np.array_equal(tl.hubs, jl.hubs)
    assert abs(tinfo["sweeps"] - jinfo["sweeps"]) <= 1
    assert tinfo["fallbacks"] == jinfo["fallbacks"] == 0
    np.testing.assert_allclose(tX, np.asarray(jX), rtol=0, atol=LM_ATOL)
    np.testing.assert_allclose(tinfo["coverage"], jinfo["coverage"],
                               rtol=1e-6)


def _tail_graph(n):
    """A ring plus five more out-edges of the last vertex, so the degree
    order differs from the identity."""
    ring = np.arange(n)
    return (np.concatenate([ring, np.full(5, n - 1)]),
            np.concatenate([(ring + 1) % n, np.arange(5) * 7]), n)


def test_the_order_starts_past_hot_columns():
    assert HOT_COLUMNS == 32_768
    src, dst, n = _tail_graph(HOT_COLUMNS)
    eng = _engine(src, dst, n)
    assert eng.vertex_order is None
    ops, dang, _ = _ell_host(src, dst, n, None, "f32")
    _assert_bits(eng.operands, ops)
    src, dst, n = _tail_graph(HOT_COLUMNS + 1)
    order = _engine(src, dst, n).vertex_order.numpy()
    assert order[0] == n - 1
    assert np.array_equal(order[1:], np.arange(n - 1))


@pytest.mark.parametrize("kind", ["dynamic", "ell_sharded", "from_layout"])
def test_other_ell_layouts_keep_the_callers_ids(kind):
    src, dst, n = _tail_graph(HOT_COLUMNS + 1)
    if kind == "dynamic":
        eng = DynamicPageRankEngine(src, dst, n, backend="ell", device="cpu",
                                    metrics=NullRegistry())
    elif kind == "ell_sharded":
        eng = _engine(src, dst, n, backend="ell_sharded",
                      mesh=make_mesh((2,), ("shard",), ["cpu"] * 2))
    else:
        ops, dang, _ = _ell_host(src, dst, n, None, "f32")
        lay = layout_from_numpy("ell", {"operands": [o.numpy() for o in ops],
                                        "scales": None,
                                        "dang": dang.numpy()},
                                precision="f32", device="cpu")
        eng = PageRankEngine.from_layout("ell", lay, n, device="cpu",
                                         metrics=NullRegistry())
        _assert_bits(eng.operands, ops)
    assert eng.vertex_order is None
    x = eng.run(3)
    assert x.shape == (n,)


def _csr_fields(eng_kw, graph):
    reg = MetricsRegistry()
    _engine(*graph, metrics=reg, **eng_kw)
    rec = [r for r in reg.span_records if r["name"] == "prepare.csr"]
    assert len(rec) == 1
    return rec[0]["fields"]


def test_the_csr_span_carries_the_order_and_the_hot_share():
    fields = _csr_fields({}, (SRC, DST, N))
    s, _ = dedupe_directed(SRC, DST, N, drop_self_loops=False)
    pos = np.argsort(_degree_order(SRC, DST, N))        # id -> position
    hot = float(np.mean(pos[s] < HOT_COLUMNS))
    given = float(np.mean(s < HOT_COLUMNS))
    assert fields["order"] == "degree"
    assert fields["hot_share"] == pytest.approx(hot, abs=1e-12)
    assert fields["hot_share"] > given
    small = _csr_fields({}, _tail_graph(300))
    assert small == {"order": "given", "hot_share": 1.0}
    # ell_sharded builds its CSR in the same phase, in the caller's ids
    sharded = _csr_fields(
        {"backend": "ell_sharded",
         "mesh": make_mesh((2,), ("shard",), ["cpu"] * 2)}, _tail_graph(300))
    assert sharded == {}
