"""PyTorch port, the serving path on the CPU: the result cache, the
landmark (hub) PPR index on every single-device tier, and the batched
query engine with and without the cache and the index, each against the
JAX package on the same graph and seed sets (Pallas in interpret mode).
The cache cases are those of tests/test_serve_accel.py that need no
dynamic engine."""
import numpy as np
import pytest
import torch

from repro.graph import generators as jgen
from repro.obs import registry as jreg
from repro.pagerank import PageRankEngine as JEngine
from repro.pagerank.landmarks import LandmarkIndex as JLandmarks
from repro.serve import PageRankQueryEngine as JQueryEngine
from repro.serve import ResultCache as JCache
from repro_torch.obs import registry as treg
from repro_torch.pagerank import LandmarkIndex, PageRankEngine
from repro_torch.pagerank.convert import layout_from_numpy
from repro_torch.pagerank.fidelity import kendall_tau, topk_overlap
from repro_torch.pagerank.landmarks import _key_slice
from repro_torch.serve import (CacheEntry, PageRankQueryEngine, PPRQuery,
                               ResultCache, ServeResilience)

BACKEND_MAP = {"dense": "dense", "ell": "ell", "fused_dense": "pallas_dense"}
PRECISIONS = ("f32", "bf16", "f16", "int8")
# landmark answer vs reference (tests/test_serve_accel.py:183-189)
LM_ATOL = 1e-5
N = 200


@pytest.fixture(scope="module")
def net():
    src, dst = jgen.protein_network(N, seed=7)
    return src, dst


@pytest.fixture(scope="module")
def seed_sets():
    rng = np.random.default_rng(0)
    return [np.sort(rng.choice(N, size=3, replace=False)) for _ in range(3)]


def _pair(net, backend, precision="f32", tm=None, jm=None):
    src, dst = net
    j = JEngine(src, dst, N, backend=BACKEND_MAP[backend],
                precision=precision, metrics=jm or jreg.NullRegistry())
    t = PageRankEngine(src, dst, N, backend=backend, precision=precision,
                       device="cpu", metrics=tm or treg.NullRegistry())
    return j, t


def _fidelity(X, ref):
    for j in range(X.shape[1]):
        assert float(np.abs(X[:, j] - ref[:, j]).max()) <= LM_ATOL
        assert topk_overlap(X[:, j], ref[:, j], k=50) >= 0.99
        assert kendall_tau(X[:, j], ref[:, j], k=50) >= 0.99


def _same_topk(got, want, scores_atol=1e-6):
    """Top-k results agree: scores within ``scores_atol``; indices equal
    where the scores do not tie (torch.topk and lax.top_k may order ties
    differently), else as sets."""
    gi, gs = (np.asarray(a) for a in got)
    wi, ws = (np.asarray(a) for a in want)
    np.testing.assert_allclose(gs, ws, atol=scores_atol, rtol=0)
    if len(np.unique(ws)) == len(ws):
        assert np.array_equal(gi, wi)
    else:
        assert set(gi.tolist()) == set(wi.tolist())


# --------------------------------------------------------------------- #
# ResultCache unit behavior (ported from tests/test_serve_accel.py)
# --------------------------------------------------------------------- #
def test_cache_key_is_canonical_over_seed_order_and_dupes():
    a = ResultCache.key([5, 9, 5], "f32")
    b = ResultCache.key(np.asarray([9, 5]), "f32")
    assert a == b == ("f32", (5, 9)) == JCache.key([5, 9, 5], "f32")


def test_cache_key_precision_tiers_never_alias():
    seeds = [3, 1, 4]
    keys = {ResultCache.key(seeds, p) for p in ("f32", "bf16", "f16",
                                                "int8")}
    assert len(keys) == 4
    cache = ResultCache(capacity=8)
    cache.put(ResultCache.key(seeds, "f32"), np.ones(4), 0)
    assert cache.get(ResultCache.key(seeds, "bf16"), 0) is None
    assert cache.get(ResultCache.key(seeds, "f32"), 0) is not None


def test_cache_lru_eviction_order_and_counter():
    cache = ResultCache(capacity=2)
    k = [ResultCache.key([i], "f32") for i in range(3)]
    cache.put(k[0], np.zeros(2), 0)
    cache.put(k[1], np.zeros(2), 0)
    assert cache.get(k[0], 0) is not None   # touch k0: k1 becomes LRU
    assert cache.put(k[2], np.zeros(2), 0) == 1
    assert cache.evictions == 1 and len(cache) == 2
    assert k[1] not in cache and k[0] in cache and k[2] in cache


def test_cache_version_mismatch_is_a_miss_and_drops_the_entry():
    cache = ResultCache(capacity=4)
    key = ResultCache.key([7], "f32")
    cache.put(key, np.ones(3), version=0)
    assert cache.get(key, version=1) is None
    assert cache.misses == 1 and key not in cache
    assert isinstance(CacheEntry(np.ones(2), 0).ranks, np.ndarray)


def test_cache_invalidate_scores_first_order_impact():
    cache = ResultCache(capacity=4, keep_eps=1e-6)
    hot = np.zeros(10)
    hot[4] = 0.3                            # parks mass on the delta column
    cold = np.zeros(10)
    cold[9] = 0.3                           # mass far from the delta
    cache.put(ResultCache.key([4], "f32"), hot, 0)
    cache.put(ResultCache.key([9], "f32"), cold, 0)
    dropped, kept = cache.invalidate(np.asarray([4]), np.asarray([0.5]),
                                     version=1)
    assert (dropped, kept) == (1, 1)
    assert cache.invalidations == 1
    # the survivor was re-stamped: it hits at the NEW version
    assert cache.get(ResultCache.key([9], "f32"), 1) is not None
    assert cache.get(ResultCache.key([4], "f32"), 1) is None


def test_cache_invalidate_none_cols_flushes_everything():
    cache = ResultCache(capacity=4)
    for i in range(3):
        cache.put(ResultCache.key([i], "f32"), np.zeros(2), 0)
    assert cache.invalidate(None, None, version=1) == (3, 0)
    assert len(cache) == 0 and cache.invalidations == 3


# --------------------------------------------------------------------- #
# LandmarkIndex against the JAX index
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("backend", list(BACKEND_MAP))
def test_landmark_answer_matches_jax(net, seed_sets, backend, precision):
    j, t = _pair(net, backend, precision)
    jl = JLandmarks(j, n_hubs=16, tol=1e-7, n_iters=60)
    tl = LandmarkIndex(t, n_hubs=16, tol=1e-7, n_iters=60)
    jX, jinfo = jl.answer(seed_sets)
    tX, tinfo = tl.answer(seed_sets)
    assert np.array_equal(tl.hubs, jl.hubs)
    assert tX.shape == (N, len(seed_sets)) and tX.dtype == np.float32
    assert float(tX.min()) >= 0.0
    np.testing.assert_allclose(tX.sum(axis=0), 1.0, atol=1e-5)
    _fidelity(tX, jX)
    # the push stops where the JAX while_loop stops (float32 order may
    # move the exit by one sweep)
    assert abs(tinfo["sweeps"] - jinfo["sweeps"]) <= 1
    assert tinfo["fallbacks"] == jinfo["fallbacks"] == 0
    assert tinfo["paths"] == jinfo["paths"]
    np.testing.assert_allclose(tinfo["coverage"], jinfo["coverage"],
                               rtol=1e-6)
    # and it is faithful to the port's own exact solver, whose columns
    # the answer's contract renormalizes (a reduced-precision H does not
    # keep the mass at 1)
    exact = t.ppr(seed_sets, n_iters=200).numpy()
    _fidelity(tX, exact / exact.sum(axis=0))


def test_landmark_answer_pads_queries_to_a_power_of_two(net, monkeypatch):
    """Q = 3 runs the push on 4 columns, the pad column all zero."""
    from repro_torch.pagerank import landmarks as tlm
    _, t = _pair(net, "fused_dense", "int8")
    tl = LandmarkIndex(t, n_hubs=8, tol=1e-7, n_iters=40)
    shapes = []
    real = tlm._hub_push_fused

    def spy(Hp, dangp, scales, Vp, X0p, tol, **kw):
        shapes.append(tuple(Vp.shape))
        assert not Vp[3].any() and not X0p[3].any()
        return real(Hp, dangp, scales, Vp, X0p, tol, **kw)

    monkeypatch.setattr(tlm, "_hub_push_fused", spy)
    X, _ = tl.answer([[1], [2, 3], [4, 5, 6]])
    assert shapes == [(4, t.operands[0].shape[1])] and X.shape == (N, 3)


def test_landmark_exhausted_push_budget_falls_back_to_exact(net):
    j, t = _pair(net, "ell")
    seed_sets = [[3, 50], [120]]
    jl = JLandmarks(j, n_hubs=8, tol=1e-9, max_pushes=1, n_iters=100)
    tl = LandmarkIndex(t, n_hubs=8, tol=1e-9, max_pushes=1, n_iters=100)
    jX, jinfo = jl.answer(seed_sets)
    tX, tinfo = tl.answer(seed_sets)
    assert tinfo["fallbacks"] == jinfo["fallbacks"] == 2
    assert tinfo["paths"] == ["exact", "exact"]
    assert tinfo["sweeps"] == 1
    np.testing.assert_allclose(tX, jX, atol=1e-6)
    oracle = t.ppr(seed_sets, n_iters=100).numpy()
    np.testing.assert_allclose(tX, oracle / oracle.sum(axis=0), atol=1e-6)


def test_landmark_rebuild_policy_tracks_graph_version(net):
    _, t = _pair(net, "ell")
    lm = LandmarkIndex(t, n_hubs=8, rebuild_every=4, n_iters=40)
    assert not lm.built
    lm.ensure(0)
    assert lm.built and lm.built_version == 0
    lm.ensure(3)                            # within the rebuild window
    assert lm.built_version == 0
    lm.ensure(4)                            # drift budget exceeded
    assert lm.built_version == 4


def test_landmark_index_over_a_carried_layout(net, seed_sets):
    """The JAX engine's layout and host bookkeeping carried across give
    the JAX index's answer."""
    j, _ = _pair(net, "fused_dense")
    arrays = {"operands": [np.asarray(o) for o in j.operands],
              "scales": None, "dang": np.asarray(j._dang), "keys": j._keys,
              "outdeg": j._outdeg, "indeg": j._indeg}
    lay = layout_from_numpy("fused_dense", arrays, precision="f32",
                            device="cpu")
    t = PageRankEngine.from_layout("fused_dense", lay, N, device="cpu",
                                   metrics=treg.NullRegistry())
    jX, _ = JLandmarks(j, n_hubs=16, tol=1e-7, n_iters=60).answer(seed_sets)
    tX, _ = LandmarkIndex(t, n_hubs=16, tol=1e-7,
                          n_iters=60).answer(seed_sets)
    _fidelity(tX, jX)
    bare = PageRankEngine.from_layout(
        "fused_dense", {k: lay[k] for k in ("operands", "scales", "dang")},
        N, device="cpu")
    with pytest.raises(ValueError, match="bookkeeping"):
        LandmarkIndex(bare)


def test_key_slice_is_the_out_neighborhood(net):
    j, t = _pair(net, "ell")
    src, dst = net
    for u in (0, 5, 77):
        want = np.unique(dst[src == u])
        assert np.array_equal(_key_slice(t._keys, u, N), want)


# --------------------------------------------------------------------- #
# PageRankQueryEngine against the JAX engine
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("mode", ["plain", "cache", "landmarks"])
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("backend", list(BACKEND_MAP))
def test_query_batch_matches_jax(net, seed_sets, backend, precision, mode):
    j, t = _pair(net, backend, precision)

    def make(pkg_engine, qe_cls, cache_cls, lm_cls):
        kw = {}
        if mode == "cache":
            kw["cache"] = cache_cls(capacity=16)
        if mode == "landmarks":
            kw["landmarks"] = lm_cls(pkg_engine, n_hubs=16, tol=1e-7,
                                     n_iters=60)
        return qe_cls(pkg_engine, n_iters=60, max_batch=8, **kw)

    jq = make(j, JQueryEngine, JCache, JLandmarks)
    tq = make(t, PageRankQueryEngine, ResultCache, LandmarkIndex)
    want = jq.query_batch(seed_sets, top_k=10)
    got = tq.query_batch(seed_sets, top_k=10)
    atol = LM_ATOL if mode == "landmarks" else 1e-7
    for g, w in zip(got, want):
        _same_topk(g, w, scores_atol=atol)
    if mode == "cache":
        # a second round is served from the cache, with the same answers
        again = tq.query_batch(seed_sets, top_k=10)
        assert tq.cache.hits == len(seed_sets)
        for a, g in zip(again, got):
            assert np.array_equal(a[0], g[0]) and np.array_equal(a[1], g[1])


def test_submit_flushes_at_max_batch_and_stamps_outcomes(net):
    _, t = _pair(net, "ell")
    qe = PageRankQueryEngine(t, n_iters=40, max_batch=2,
                             cache=ResultCache(capacity=4))
    a = qe.submit(0, [4, 17, 4])
    assert a.result is None and np.array_equal(a.seeds, [4, 17])
    b = qe.submit(1, [17, 4])                # flushes the batch of two
    assert a.cache_outcome == b.cache_outcome == "miss"
    c = qe.submit(2, [4, 17])
    qe.flush()
    assert c.cache_outcome == "hit"
    assert np.array_equal(c.result[0], a.result[0])
    assert isinstance(c, PPRQuery) and qe.flush() == []
    for bad in ([], [N], [-1]):
        with pytest.raises(ValueError):
            qe.submit(9, bad)


def test_serve_metrics_and_event_schema_match_jax(net, seed_sets):
    jm, tm = jreg.MetricsRegistry(), treg.MetricsRegistry()
    j, t = _pair(net, "ell", tm=tm, jm=jm)
    for eng, qe_cls, cache_cls, m in ((j, JQueryEngine, JCache, jm),
                                      (t, PageRankQueryEngine, ResultCache,
                                       tm)):
        qe = qe_cls(eng, n_iters=30, max_batch=8, cache=cache_cls(8))
        qe.query_batch(seed_sets)
        qe.query_batch(seed_sets[:2])
    jd, td = jm.as_dict(), tm.as_dict()
    assert td["counters"] == jd["counters"]
    assert set(td["histograms"]) == set(jd["histograms"])
    assert set(td["gauges"]) == set(jd["gauges"])
    jserve = [e for e in jm.events if e["kind"] == "serve"]
    tserve = [e for e in tm.events if e["kind"] == "serve"]
    assert len(tserve) == len(jserve) == 2
    for te, je in zip(tserve, jserve):
        assert list(te) == list(je)
        for k in ("batch", "status", "precision", "cache_hits",
                  "cache_misses", "graph_version"):
            assert te[k] == je[k]


def test_static_engine_refuses_updates_and_resilience(net):
    _, t = _pair(net, "dense")
    qe = PageRankQueryEngine(t)
    with pytest.raises(TypeError, match="DynamicPageRankEngine"):
        qe.push_update(object())
    # the resilient mode takes a static engine, as the JAX package's does,
    # and still refuses its updates
    rq = PageRankQueryEngine(t, resilience=ServeResilience())
    with pytest.raises(TypeError, match="DynamicPageRankEngine"):
        rq.push_update(object())
    q = rq.submit(0, [1, 2])
    rq.flush()
    assert q.status == "fresh" and q.graph_version == 0


def test_serve_defaults_to_cuda(net, monkeypatch):
    src, dst = net
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PageRankQueryEngine(PageRankEngine(src, dst, N))
