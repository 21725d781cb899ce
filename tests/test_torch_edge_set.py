"""PyTorch port, the engine's edge set: one sort on the engine's device
(``repro_torch.pagerank.engine._edge_set``) gives the deduplicated edges,
their sorted keys and both degree vectors equal, in value and dtype, to the
host path of ``delta.dedupe_directed(..., drop_self_loops=False)``,
``delta.edge_keys`` and ``np.bincount``; the constructor's spans
``prepare.dedupe`` (with the input and collapsed-duplicate counts) and
``prepare.keys`` stay; the dynamic engine keeps its parent's edge set and
reverses it for ``_rkeys``, through construction and rebuilds.  The last
test runs the same comparison on the card and skips without one (marker
``cuda``)."""
import numpy as np
import pytest
import torch

from repro_torch.graph.delta import (GraphDelta, apply_delta,
                                     dedupe_directed, edge_keys)
from repro_torch.graph.generators import protein_network
from repro_torch.obs.registry import MetricsRegistry, NullRegistry
from repro_torch.pagerank import DynamicPageRankEngine, PageRankEngine
from repro_torch.pagerank.engine import _edge_set


def _random(n, m, seed, dtype=np.int32):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, m).astype(dtype),
            rng.integers(0, n, m).astype(dtype))


def _cases():
    rs, rd = _random(40, 200, 1)
    big_s, big_d = _random(70_000, 50_000, 2)   # keys past 2**31
    return {
        "duplicates": (np.array([0, 1, 0, 2, 1, 0], np.int32),
                       np.array([1, 2, 1, 0, 2, 1], np.int32), 3),
        "self_loops": (np.array([0, 1, 1, 2, 2], np.int32),
                       np.array([0, 1, 1, 0, 2], np.int32), 3),
        "empty": (np.zeros(0, np.int32), np.zeros(0, np.int32), 5),
        "n1": (np.array([0, 0, 0], np.int32), np.array([0, 0, 0], np.int32),
               1),
        "isolated": (np.array([7, 2, 7, 2], np.int32),
                     np.array([2, 7, 2, 7], np.int32), 12),
        "int64": (rs.astype(np.int64), rd.astype(np.int64), 40),
        "random": (np.concatenate([big_s, big_s[:9000]]),
                   np.concatenate([big_d, big_d[:9000]]), 70_000),
    }


CASES = _cases()


def _host_path(src, dst, n):
    """What the constructor computed on the host before the edge set moved
    to the device."""
    s, d = dedupe_directed(src, dst, n, drop_self_loops=False)
    return (s, d, edge_keys(s, d, n),
            np.bincount(s, minlength=n).astype(np.int64),
            np.bincount(d, minlength=n).astype(np.int64))


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype
        assert np.array_equal(g, w)


@pytest.mark.parametrize("case", list(CASES))
def test_edge_set_equals_the_host_path(case):
    src, dst, n = CASES[case]
    es = _edge_set(src, dst, n, torch.device("cpu"))
    want = _host_path(src, dst, n)
    _assert_same(es, want)
    assert es.src.dtype == np.int32 and es.keys.dtype == np.int64
    assert len(es.outdeg) == n and len(es.indeg) == n


@pytest.mark.parametrize("backend", ["ell", "fused_dense"])
def test_the_constructor_records_its_edge_counts(backend):
    src, dst, n = CASES["duplicates"]
    reg = MetricsRegistry()
    eng = PageRankEngine(src, dst, n, backend=backend, device="cpu",
                         metrics=reg)
    recs = {r["name"]: r for r in reg.span_records}
    top = recs["prepare"]
    assert recs["prepare.dedupe"]["fields"] == {
        "device": "cpu", "edges_in": 6, "edges_dropped": 3}
    assert recs["prepare.dedupe"]["parent"] == top["id"]
    assert recs["prepare.keys"]["parent"] == top["id"]
    assert recs["prepare.dedupe"]["end_ns"] <= recs["prepare.keys"][
        "start_ns"]
    ev = [e for e in reg.events if e.get("name") == "prepare.dedupe"][0]
    assert ev["edges_in"] == 6 and ev["edges_dropped"] == 3
    assert eng.n_edges == 3
    _assert_same((eng._keys, eng._outdeg, eng._indeg),
                 _host_path(src, dst, n)[2:])
    # a cleaned, symmetrized input collapses nothing
    s, d = protein_network(200, seed=4)
    reg = MetricsRegistry()
    PageRankEngine(s, d, 200, backend=backend, device="cpu", metrics=reg)
    f = [r for r in reg.span_records if r["name"] == "prepare.dedupe"][0]
    assert f["fields"]["edges_in"] == len(s)
    assert f["fields"]["edges_dropped"] == 0


def _dyn_host(src, dst, n):
    s, d, keys, outdeg, indeg = _host_path(src, dst, n)
    rkeys = np.sort(np.asarray(d, np.int64) * n + np.asarray(s, np.int64))
    return keys, rkeys, outdeg, indeg


def _dyn_state(eng):
    return eng._keys, eng._rkeys, eng._outdeg, eng._indeg


def _absent_pairs(src, dst, n, k, seed):
    have = set(zip(src.tolist(), dst.tolist()))
    rng = np.random.default_rng(seed)
    pairs = []
    while len(pairs) < k:
        u, v = (int(x) for x in rng.integers(0, n, 2))
        if u != v and (u, v) not in have and (v, u) not in have:
            pairs.append((u, v))
            have |= {(u, v), (v, u)}
    return (np.array([u for u, _ in pairs], np.int32),
            np.array([v for _, v in pairs], np.int32))


@pytest.mark.parametrize("backend", ["dense", "ell", "bsr", "fused_dense"])
def test_the_dynamic_engine_keeps_its_parents_edge_set(backend):
    n = 300
    s, d = protein_network(n, seed=5)
    src = np.concatenate([s, s[:40], [3, 9]])         # duplicates
    dst = np.concatenate([d, d[:40], [3, 9]])         # + self-loops
    eng = DynamicPageRankEngine(src, dst, n, backend=backend, device="cpu",
                                metrics=NullRegistry())
    _assert_same(_dyn_state(eng), _dyn_host(src, dst, n))
    eng.rebuild_and_solve(tol=1e-6)
    _assert_same(_dyn_state(eng), _dyn_host(src, dst, n))
    iu, iv = _absent_pairs(src, dst, n, 3, seed=6)
    delta = GraphDelta.inserts(iu, iv)
    _, info = eng.update(delta, strategy="rebuild")
    assert info.strategy == "rebuild"
    s1, d1 = apply_delta(src, dst, delta, n)
    _assert_same(_dyn_state(eng), _dyn_host(s1, d1, n))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_edge_set_on_the_card_equals_the_host_path(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the edge set's card path")
    src, dst, n = CASES[case]
    reg = MetricsRegistry()
    es = _edge_set(src, dst, n, torch.device("cuda"), reg)
    _assert_same(es, _host_path(src, dst, n))
    rec = [r for r in reg.span_records if r["name"] == "prepare.dedupe"][0]
    assert rec["fields"]["device"] == "cuda"
    eng = DynamicPageRankEngine(src, dst, n, backend="ell", device="cuda",
                                metrics=NullRegistry())
    _assert_same(_dyn_state(eng), _dyn_host(src, dst, n))
