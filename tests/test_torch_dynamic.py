"""PyTorch port, live graph updates on the CPU: the delta records
(``GraphDelta``, ``apply_delta``, ``compose``, ``EdgeStream``) bit-equal to
``repro.graph.delta``; ``DynamicPageRankEngine.update`` on every patchable
single-device tier against the JAX dynamic engine (the same strategy,
coercion and overflow, ranks within the L1 1e-5 bound of
tests/test_dynamic.py); the block-structure, int8 and row-capacity
escalations; the all-or-nothing rollback, snapshots and restore; and the
serve engine's refresh-before-flush with the delta-aware cache
invalidation, counted as the JAX package counts it."""
import jax
import numpy as np
import pytest
import torch

from obs_parity import shared_events

from repro.graph import delta as jdelta
from repro.graph import generators as jgen
from repro.obs import registry as jreg
from repro.pagerank import DynamicPageRankEngine as JDyn
from repro.pagerank.landmarks import LandmarkIndex as JLandmarks
from repro.serve import PageRankQueryEngine as JQueryEngine
from repro.serve import ResultCache as JCache
from repro_torch.graph import delta as tdelta
from repro_torch.obs import registry as treg
from repro_torch.pagerank import dynamic as tdyn
from repro_torch.pagerank import engine as tengine
from repro_torch.pagerank import (DynamicPageRankEngine, LandmarkIndex,
                                  PageRankEngine)
from repro_torch.serve import PageRankQueryEngine, ResultCache

# port backend name -> JAX backend name (as in tests/test_torch_engine.py)
DYN_MAP = {"dense": "dense", "ell": "ell", "fused_dense": "pallas_dense",
           "bsr": "bsr"}
STRATEGIES = ("auto", "push", "warm", "rebuild")
# incremental vs from-scratch (tests/test_dynamic.py)
L1_BOUND = 1e-5
N = 64
FIELDS = ("insert_src", "insert_dst", "delete_src", "delete_dst")


@pytest.fixture(scope="module")
def net():
    src, dst = jgen.protein_network(N, seed=5)
    return src, dst


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _l1(a, b):
    return float(np.abs(_np(a) - _np(b)).sum())


def _scratch(src, dst, n=N):
    return PageRankEngine(src, dst, n, backend="dense", device="cpu",
                          metrics=treg.NullRegistry()).run(300)


def _absent_pairs(src, dst, n, k, seed=0):
    """k undirected pairs not in the edge set (effective inserts)."""
    have = set(tdelta.edge_keys(src, dst, n).tolist())
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < k:
        u, v = (int(x) for x in rng.integers(0, n, size=2))
        if u != v and u * n + v not in have and (u, v) not in out:
            out.append((u, v))
    a = np.array(out, np.int64)
    return a[:, 0], a[:, 1]


def _same_delta(t, j):
    for f in FIELDS:
        a, b = getattr(t, f), getattr(j, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert t.timestamp == j.timestamp


def _dyn_pair(net, backend, precision="f32", tm=None, jm=None, **kw):
    src, dst = net
    j = JDyn(src, dst, N, backend=DYN_MAP[backend], precision=precision,
             metrics=jm or jreg.NullRegistry(), **kw)
    t = DynamicPageRankEngine(src, dst, N, backend=backend,
                              precision=precision, device="cpu",
                              metrics=tm or treg.NullRegistry(), **kw)
    return j, t


def _layout(eng):
    return [o.clone() for op in eng.operands
            for o in (op.tensors() if hasattr(op, "tensors") else (op,))]


# --------------------------------------------------------------------- #
# the delta records, bit-equal                                          #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("symmetric", [True, False])
def test_graphdelta_canonical_bit_equal(symmetric):
    rng = np.random.default_rng(1)
    iu, iv = rng.integers(0, 30, 12), rng.integers(0, 30, 12)
    keep = iu != iv
    du, dv = rng.integers(0, 30, 5), rng.integers(0, 30, 5)
    dkeep = du != dv
    args = (np.concatenate([iu[keep], iu[keep][:3]]),
            np.concatenate([iv[keep], iv[keep][:3]]), du[dkeep], dv[dkeep])
    t = tdelta.GraphDelta(*args, timestamp=2.5).canonical(30, symmetric)
    j = jdelta.GraphDelta(*args, timestamp=2.5).canonical(30, symmetric)
    _same_delta(t, j)
    assert (t.n_insert, t.n_delete, t.n_changed) == (j.n_insert, j.n_delete,
                                                     j.n_changed)
    _same_delta(tdelta.GraphDelta.inserts(iu[keep], iv[keep], 1.0),
                jdelta.GraphDelta.inserts(iu[keep], iv[keep], 1.0))
    _same_delta(tdelta.GraphDelta.deletes(3, 4),
                jdelta.GraphDelta.deletes(3, 4))


@pytest.mark.parametrize("args", [
    ([1, 2], [3], [], []),              # length mismatch
    ([1.5], [2], [], []),               # non-integral
    ([float("nan")], [2], [], []),      # non-finite
    (["a"], ["b"], [], []),             # not integer ids
    ([-1], [2], [], []),                # negative id
    ([3], [3], [], []),                 # self-loop
])
def test_graphdelta_rejects_malformed_like_jax(args):
    with pytest.raises(ValueError) as te:
        tdelta.GraphDelta(*(np.asarray(a) for a in args))
    with pytest.raises(ValueError) as je:
        jdelta.GraphDelta(*(np.asarray(a) for a in args))
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="outside"):
        tdelta.GraphDelta.inserts([1], [40]).canonical(30)


def test_apply_delta_and_compose_bit_equal(net):
    src, dst = net
    rng = np.random.default_rng(2)
    deltas = []
    for k in range(4):
        iu, iv = _absent_pairs(src, dst, N, 3, seed=10 + k)
        pick = rng.integers(0, len(src), 2)
        deltas.append((iu, iv, src[pick], dst[pick], float(k)))
    deltas.append((src[:1], dst[:1], src[:1], dst[:1], 9.0))  # both sides
    t_ds = [tdelta.GraphDelta(*d[:4], timestamp=d[4]) for d in deltas]
    j_ds = [jdelta.GraphDelta(*d[:4], timestamp=d[4]) for d in deltas]
    tcur, jcur = (src, dst), (src, dst)
    for td, jd in zip(t_ds, j_ds):
        tcur = tdelta.apply_delta(*tcur, td, N)
        jcur = jdelta.apply_delta(*jcur, jd, N)
        for a, b in zip(tcur, jcur):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    tc = tdelta.compose(t_ds, N)
    _same_delta(tc, jdelta.compose(j_ds, N))
    # one composed delta == the sequence
    for a, b in zip(tdelta.apply_delta(src, dst, tc, N), tcur):
        assert np.array_equal(a, b)
    _same_delta(tdelta.compose(t_ds[:2], N, symmetric=False),
                jdelta.compose(j_ds[:2], N, symmetric=False))


def test_edge_stream_bit_equal():
    kw = dict(m_edges=4, seed=3, insert_per_step=6, delete_per_step=4)
    t, j = tdelta.EdgeStream(300, **kw), jdelta.EdgeStream(300, **kw)
    for a, b in zip(t.base(), j.base()):
        assert np.array_equal(a, b)
    for td, jd, _ in zip(t, j, range(8)):
        _same_delta(td, jd)
    assert t.n_live_edges == j.n_live_edges and t.t == j.t


# --------------------------------------------------------------------- #
# DynamicPageRankEngine.update against the JAX dynamic engine           #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("backend", list(DYN_MAP))
def test_update_matches_jax(net, backend, strategy):
    src, dst = net
    j, t = _dyn_pair(net, backend)
    assert t.layout == j.layout.replace("pallas_dense", "fused_dense")
    assert t.layout_bytes == j.layout_bytes
    j.run_tol(1e-7, max_iters=500)
    t.run_tol(1e-7, max_iters=500)
    iu, iv = _absent_pairs(src, dst, N, 3, seed=1)
    jp, ji = j.update(jdelta.GraphDelta(iu, iv, src[:2], dst[:2]),
                      strategy=strategy)
    tp, ti = t.update(tdelta.GraphDelta(iu, iv, src[:2], dst[:2]),
                      strategy=strategy)
    assert ti.strategy == ji.strategy == (
        strategy if strategy != "auto" else "push")
    assert (ti.n_inserted, ti.n_deleted, ti.cols_patched, ti.rows_patched,
            ti.overflow, ti.coerced_from, ti.healthy) == (
        ji.n_inserted, ji.n_deleted, ji.cols_patched, ji.rows_patched,
        ji.overflow, ji.coerced_from, ji.healthy)
    assert abs(ti.iters - ji.iters) <= 1
    assert t.ranks is tp and t.n_edges == j.n_edges
    assert np.array_equal(t._keys, j._keys)
    assert _l1(tp, jp) <= L1_BOUND
    s2, d2 = tdelta.apply_delta(src, dst, tdelta.GraphDelta(
        iu, iv, src[:2], dst[:2]), N)
    assert _l1(tp, _scratch(s2, d2)) <= L1_BOUND
    # the patched layout equals the JAX patched layout
    for a, b in zip(_layout(t), jax.tree_util.tree_leaves(j.operands)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


def test_bsr_structure_change_forces_rebuild(net):
    """An insert in a block the layout never materialized cannot be
    patched: a forced push refuses, the auto policy rebuilds and records
    the coercion, as in the JAX package."""
    src, dst = net
    j, t = _dyn_pair(net, "bsr", bsr_block_size=8, rebuild_frac=1.0)
    j.run_tol(1e-7, max_iters=500)
    t.run_tol(1e-7, max_iters=500)
    assert np.array_equal(t._bsr_pairs, j._bsr_pairs)
    assert np.array_equal(t._bsr_slots, j._bsr_slots)
    bs, nbc = 8, t._bsr_nbc
    present = set(t._bsr_pairs.tolist())
    u, v = next((u, v) for u in range(N) for v in range(u + 1, N)
                if (v // bs) * nbc + u // bs not in present
                and (u // bs) * nbc + v // bs not in present)
    with pytest.raises(ValueError, match="patchable"):
        t.update(tdelta.GraphDelta.inserts([u], [v]), strategy="push")
    tp, ti = t.update(tdelta.GraphDelta.inserts([u], [v]))
    jp, ji = j.update(jdelta.GraphDelta.inserts([u], [v]))
    assert ti.overflow and ti.strategy == ji.strategy == "rebuild"
    assert ti.coerced_from == ji.coerced_from == "push"
    assert _l1(tp, jp) <= L1_BOUND
    s2, d2 = tdelta.apply_delta(src, dst,
                                tdelta.GraphDelta.inserts([u], [v]), N)
    assert _l1(tp, _scratch(s2, d2)) <= L1_BOUND


@pytest.mark.parametrize("backend", list(DYN_MAP))
def test_int8_coerces_to_rebuild(net, backend):
    src, dst = net
    j, t = _dyn_pair(net, backend, precision="int8")
    j.run_tol(1e-7, max_iters=500)
    t.run_tol(1e-7, max_iters=500)
    iu, iv = _absent_pairs(src, dst, N, 2, seed=4)
    with pytest.raises(ValueError, match="int8"):
        t.update(tdelta.GraphDelta.inserts(iu, iv), strategy="warm")
    tp, ti = t.update(tdelta.GraphDelta.inserts(iu, iv))
    jp, ji = j.update(jdelta.GraphDelta.inserts(iu, iv))
    assert ti.strategy == ji.strategy == "rebuild"
    assert ti.coerced_from == ji.coerced_from == "push"
    assert not ti.overflow
    assert _l1(tp, jp) <= L1_BOUND


def test_sell_row_overflow_escalates_and_is_recorded(net):
    src, dst = net
    tm, jm = treg.MetricsRegistry(), jreg.MetricsRegistry()
    j, t = _dyn_pair(net, "ell", slack=2, rebuild_frac=1.0, tm=tm, jm=jm)
    assert t._sell_k == j._sell_k
    j.run_tol(1e-7, max_iters=500)
    t.run_tol(1e-7, max_iters=500)
    deg = np.bincount(src, minlength=N)
    w = int(np.argmin(np.where(deg > 0, deg, N)))
    nbrs = [v for v in range(N) if v != w][:t._sell_k[0] + 2]
    tp, ti = t.update(tdelta.GraphDelta.inserts([w] * len(nbrs), nbrs))
    jp, ji = j.update(jdelta.GraphDelta.inserts([w] * len(nbrs), nbrs))
    assert ti.overflow and ti.strategy == ji.strategy == "rebuild"
    assert ti.coerced_from == ji.coerced_from == "push"
    assert _l1(tp, jp) <= L1_BOUND
    for m in (tm, jm):
        assert m.counter("update.coerced").value == 1
        assert m.counter("update.rebuild").value == 1
    tevents = shared_events(tm)
    assert [e["kind"] for e in tevents] == [e["kind"] for e in jm.events]
    for te, je in zip(tevents, jm.events):
        assert list(te) == list(je)
        if te["kind"] in ("update", "update_coerced"):
            for k in ("strategy", "n_ins", "n_del", "overflow", "healthy",
                      "requested", "ran"):
                assert te.get(k) == je.get(k)


def test_forced_strategy_validation_leaves_no_trace(net):
    src, dst = net
    t = DynamicPageRankEngine(src, dst, N, backend="ell", device="cpu",
                              metrics=treg.NullRegistry())
    (u1,), (v1,) = _absent_pairs(src, dst, N, 1, seed=4)
    with pytest.raises(ValueError, match="strategy"):
        t.update(tdelta.GraphDelta.inserts([u1], [v1]), strategy="bogus")
    with pytest.raises(ValueError, match="push"):
        t.update(tdelta.GraphDelta.inserts([u1], [v1]), strategy="push")
    edges = t.n_edges
    pr, info = t.update(tdelta.GraphDelta.inserts([u1], [v1]),
                        strategy="warm")
    assert info.strategy == "warm" and info.n_inserted == 2
    assert t.n_edges == edges + 2
    # a no-op delta returns the held ranks
    pr2, info = t.update(tdelta.GraphDelta.inserts([u1], [v1]))
    assert info.strategy == "noop" and pr2 is t.ranks is pr


@pytest.mark.parametrize("backend", list(DYN_MAP))
def test_rollback_restores_the_whole_engine(net, backend, monkeypatch):
    """A failure after the bookkeeping and the layout patch were applied
    rolls the engine back: the same edge set, the very same layout
    tensors (patches wrote into copies), the same ranks."""
    src, dst = net
    _, t = _dyn_pair(net, backend)
    pr0 = t.run_tol(1e-7, max_iters=500)[0]
    keys0, ops0, dang0 = t._keys, t.operands, t._dang
    layout0 = _layout(t)
    iu, iv = _absent_pairs(src, dst, N, 3, seed=6)
    delta = tdelta.GraphDelta(iu, iv, src[:2], dst[:2])

    def boom(*a, **k):
        raise RuntimeError("device lost")

    monkeypatch.setattr(t, "_push", boom)
    with pytest.raises(RuntimeError, match="device lost"):
        t.update(delta)
    assert t._keys is keys0 and t.operands is ops0 and t._dang is dang0
    assert t.ranks is pr0
    for a, b in zip(layout0, _layout(t)):
        assert torch.equal(a, b)
    monkeypatch.undo()
    pr, info = t.update(delta)
    assert info.strategy == "push"
    s2, d2 = tdelta.apply_delta(src, dst, delta, N)
    assert _l1(pr, _scratch(s2, d2)) <= L1_BOUND


@pytest.mark.parametrize("backend", list(DYN_MAP))
def test_snapshot_restore_and_rebuild_and_solve(net, backend):
    src, dst = net
    _, t = _dyn_pair(net, backend)
    pr0 = t.run_tol(1e-7, max_iters=500)[0]
    layout0 = _layout(t)
    snap = t.snapshot()
    assert snap.keys.dtype == np.int64 and np.array_equal(snap.keys,
                                                          t._keys)
    iu, iv = _absent_pairs(src, dst, N, 3, seed=7)
    t.update(tdelta.GraphDelta.inserts(iu, iv))
    assert t.n_edges == len(snap.keys) + 6
    t.restore(snap)
    assert np.array_equal(t._keys, snap.keys)
    assert t.n_edges == len(snap.keys)
    assert torch.equal(t.ranks, pr0)
    for a, b in zip(layout0, _layout(t)):
        assert torch.equal(a, b)
    r = t.rebuild_and_solve(tol=1e-7, x0=pr0)
    assert r.info.converged and int(r.iters) <= 2
    assert _l1(r.pr, _scratch(src, dst)) <= L1_BOUND


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("backend", list(DYN_MAP))
def test_insert_then_delete_restores_the_layout(net, backend, precision):
    src, dst = net
    _, t = _dyn_pair(net, backend, precision=precision)
    pr0 = t.run_tol(1e-7, max_iters=500)[0]
    layout0, dang0 = _layout(t), t._dang.clone()
    edges = _absent_pairs(src, dst, N, 3, seed=2)
    t.update(tdelta.GraphDelta.inserts(*edges))
    pr2, _ = t.update(tdelta.GraphDelta.deletes(*edges))
    for a, b in zip(layout0, _layout(t)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(dang0, t._dang)
    assert _l1(pr0, pr2) <= L1_BOUND


def test_auto_policy_picks_by_delta_size(net):
    src, dst = net
    t = DynamicPageRankEngine(src, dst, N, backend="bsr", device="cpu",
                              metrics=treg.NullRegistry())
    (u1, u2), (v1, v2) = _absent_pairs(src, dst, N, 2, seed=3)
    _, info = t.update(tdelta.GraphDelta.inserts([u1], [v1]))
    assert info.strategy == "warm"          # no ranks yet: cold warm-start
    t.run_tol(1e-7, max_iters=500)
    _, info = t.update(tdelta.GraphDelta.inserts([u2], [v2]))
    assert info.strategy == "push"
    rng = np.random.default_rng(0)
    bu = rng.integers(0, N, size=t.n_edges // 4)
    bv = (bu + rng.integers(1, N, size=bu.size)) % N
    _, info = t.update(tdelta.GraphDelta.inserts(bu, bv))
    assert info.strategy == "rebuild" and info.coerced_from is None


def test_fused_push_runs_on_the_streaming_kernel(net, monkeypatch):
    """The fused push calls the streaming kernel at one query in the
    padded (1, Mp) layout: once for the start residual and once per
    issued sweep (whole chunks of 8)."""
    src, dst = net
    _, t = _dyn_pair(net, "fused_dense")
    t.run_tol(1e-7, max_iters=500)
    calls = []
    real = tengine.streaming_matvec

    def spy(W, X):
        calls.append(tuple(X.shape))
        return real(W, X)

    monkeypatch.setattr(tengine, "streaming_matvec", spy)
    iu, iv = _absent_pairs(src, dst, N, 2, seed=8)
    _, info = t.update(tdelta.GraphDelta.inserts(iu, iv))
    assert info.strategy == "push"
    Mp = t.operands[0].shape[1]
    assert calls == [(1, Mp)] * (1 + -(-info.iters // 8) * 8)


def test_dynamic_ell_serves_ppr_and_landmarks_on_sell(net):
    """The dynamic ell tier's SELL layout serves the static tier's PPR,
    and the landmark push runs on the engine's tier (SELL)."""
    src, dst = net
    j, t = _dyn_pair(net, "ell")
    assert isinstance(t._tier, tdyn.SellTier) and t.backend == "ell"
    sets = [np.array([1, 2]), np.array([7])]
    static = PageRankEngine(src, dst, N, backend="ell", device="cpu",
                            metrics=treg.NullRegistry())
    np.testing.assert_allclose(t.ppr(sets, n_iters=40).numpy(),
                               static.ppr(sets, n_iters=40).numpy(),
                               rtol=1e-5, atol=1e-7)
    tl = LandmarkIndex(t, n_hubs=8, n_iters=60, metrics=treg.NullRegistry())
    jl = JLandmarks(j, n_hubs=8, n_iters=60, metrics=jreg.NullRegistry())
    TX, tinfo = tl.answer(sets)
    JX, jinfo = jl.answer(sets)
    assert tinfo["fallbacks"] == jinfo["fallbacks"] == 0
    np.testing.assert_allclose(TX, np.asarray(JX), rtol=0, atol=1e-5)


@pytest.mark.parametrize("backend", ["fused_dense", "bsr"])
def test_stream_of_updates_tracks_scratch(backend):
    """A stream of mixed deltas: the incremental ranks never drift from
    the from-scratch solve, and match the JAX engine's."""
    n = 64
    kw = dict(m_edges=3, seed=2, insert_per_step=4, delete_per_step=3)
    ts, js = tdelta.EdgeStream(n, **kw), jdelta.EdgeStream(n, **kw)
    s0, d0 = ts.base()
    t = DynamicPageRankEngine(s0, d0, n, backend=backend, device="cpu",
                              metrics=treg.NullRegistry())
    j = JDyn(s0, d0, n, backend=DYN_MAP[backend],
             metrics=jreg.NullRegistry())
    t.run_tol(1e-7, max_iters=500)
    j.run_tol(1e-7, max_iters=500)
    cur = (s0, d0)
    for _, td, jd in zip(range(5), ts, js):
        tp, ti = t.update(td)
        jp, ji = j.update(jd)
        assert ti.strategy == ji.strategy
        cur = tdelta.apply_delta(cur[0], cur[1], td, n)
    assert _l1(tp, jp) <= L1_BOUND
    assert _l1(tp, _scratch(cur[0], cur[1], n)) <= L1_BOUND


# --------------------------------------------------------------------- #
# the serve engine's live refresh                                       #
# --------------------------------------------------------------------- #
def test_serve_refresh_before_flush_and_invalidation_match_jax(net):
    """Two queued deltas coalesce into one update before the queued
    queries are served, and the delta-aware cache invalidation drops and
    keeps what the JAX engine's does."""
    src, dst = net
    j, t = _dyn_pair(net, "ell")
    j.run_tol(1e-7, max_iters=500)
    t.run_tol(1e-7, max_iters=500)
    tm, jm = treg.MetricsRegistry(), jreg.MetricsRegistry()
    tq = PageRankQueryEngine(t, n_iters=50, max_batch=8, metrics=tm,
                             cache=ResultCache(16))
    jq = JQueryEngine(j, n_iters=50, max_batch=8, metrics=jm,
                      cache=JCache(16))
    rng = np.random.default_rng(3)
    seeds = [np.sort(rng.choice(N, size=2, replace=False))
             for _ in range(3)]
    for qe in (tq, jq):
        qe.query_batch(seeds, top_k=4)            # fill the caches
    iu, iv = _absent_pairs(src, dst, N, 3, seed=7)
    results = {}
    for name, qe, mod in (("t", tq, tdelta), ("j", jq, jdelta)):
        queries = [qe.submit(10 + u, s, top_k=4)
                   for u, s in enumerate(seeds)]
        qe.push_update(mod.GraphDelta.inserts(iu[:2], iv[:2]))
        qe.push_update(mod.GraphDelta.inserts(iu[2:], iv[2:]))
        assert qe.n_refreshes == 0                # nothing applied yet
        qe.flush()
        assert qe.n_refreshes == 1
        assert qe.last_update_info.strategy == "push"
        assert qe.last_update_info.n_inserted == 6
        results[name] = queries
    assert tq.graph_version == jq.graph_version == 1
    for k in ("hits", "misses", "evictions", "invalidations"):
        assert getattr(tq.cache, k) == getattr(jq.cache, k), k
    assert len(tq.cache) == len(jq.cache)
    assert set(tq.cache._entries) == set(jq.cache._entries)
    for tqq, jqq in zip(results["t"], results["j"]):
        assert tqq.cache_outcome == jqq.cache_outcome
        np.testing.assert_allclose(tqq.result[1], jqq.result[1], rtol=1e-4,
                                   atol=1e-7)
    for name in ("serve.refresh.ok", "serve.cache.invalidations"):
        assert tm.counter(name).value == jm.counter(name).value
    tk = [e["kind"] for e in tm.events if e["kind"] in
          ("refresh", "cache_invalidate")]
    assert tk == [e["kind"] for e in jm.events if e["kind"] in
                  ("refresh", "cache_invalidate")]
    # served against the post-delta graph
    s2, d2 = tdelta.apply_delta(src, dst,
                                tdelta.GraphDelta.inserts(iu, iv), N)
    fresh = PageRankQueryEngine(
        PageRankEngine(s2, d2, N, backend="ell", device="cpu",
                       metrics=treg.NullRegistry()), n_iters=50)
    for q, (widx, wsc) in zip(results["t"],
                              fresh.query_batch(seeds, top_k=4)):
        np.testing.assert_allclose(q.result[1], wsc, rtol=1e-4, atol=1e-7)


def test_serve_refresh_requeues_on_failure(net, monkeypatch):
    src, dst = net
    _, t = _dyn_pair(net, "dense")
    t.run_tol(1e-7, max_iters=500)
    qe = PageRankQueryEngine(t, n_iters=20)
    assert qe.refresh() == []
    iu, iv = _absent_pairs(src, dst, N, 2, seed=9)
    d1 = tdelta.GraphDelta.inserts(iu[:1], iv[:1])
    d2 = tdelta.GraphDelta.inserts(iu[1:], iv[1:])
    qe.push_update(d1)
    qe.push_update(d2)

    def boom(*a, **k):
        raise RuntimeError("update failed")

    monkeypatch.setattr(t, "update", boom)
    with pytest.raises(RuntimeError, match="update failed"):
        qe.refresh()
    assert len(qe._pending_deltas) == 2 and qe.graph_version == 0
    monkeypatch.undo()
    infos = qe.refresh()
    assert len(infos) == 1 and infos[0].n_inserted == 4
    assert qe.graph_version == 1 and qe._pending_deltas == []
    with pytest.raises(ValueError, match="outside"):
        qe.push_update(tdelta.GraphDelta.inserts([1], [N + 3]))


def test_invalidate_all_matches_jax(net):
    """The escape hatch for a change with no per-column story: the clock
    moves and every cached answer goes, counted as in the JAX package."""
    src, dst = net
    j, t = _dyn_pair(net, "dense")
    tm, jm = treg.MetricsRegistry(), jreg.MetricsRegistry()
    tq = PageRankQueryEngine(t, n_iters=20, metrics=tm, cache=ResultCache(8))
    jq = JQueryEngine(j, n_iters=20, metrics=jm, cache=JCache(8))
    for qe in (tq, jq):
        qe.query_batch([[1, 2], [5]])
        qe._invalidate_all()
    assert tq.graph_version == jq.graph_version == 1
    assert len(tq.cache) == len(jq.cache) == 0
    assert tq.cache.invalidations == jq.cache.invalidations == 2
    te = [e for e in tm.events if e["kind"] == "cache_invalidate"]
    je = [e for e in jm.events if e["kind"] == "cache_invalidate"]
    assert [(e["cols"], e["dropped"], e["kept"], e["version"]) for e in te] \
        == [(e["cols"], e["dropped"], e["kept"], e["version"]) for e in je]


def test_static_engine_still_refuses_updates(net):
    src, dst = net
    qe = PageRankQueryEngine(PageRankEngine(src, dst, N, backend="dense",
                                            device="cpu"))
    with pytest.raises(TypeError, match="DynamicPageRankEngine"):
        qe.push_update(tdelta.GraphDelta.inserts([1], [2]))
