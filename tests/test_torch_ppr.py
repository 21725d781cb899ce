"""PyTorch port, batched personalized PageRank on the CPU: the step
functions, the seed matrix, the sparse solvers, the fidelity metrics and
``PageRankEngine.ppr`` on every single-device tier and precision, each
against the JAX package on the same inputs (Pallas in interpret mode)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from obs_parity import shared_histograms

from repro.graph import generators as jgen
from repro.graph import transition as jtr
from repro.obs import registry as jreg
from repro.pagerank import PageRankEngine as JEngine
from repro.pagerank import fidelity as jfid
from repro.pagerank import sparse as jsparse
from repro.pagerank import steps as jsteps
from repro_torch.obs import registry as treg
from repro_torch.pagerank import PageRankEngine as TEngine
from repro_torch.pagerank import engine as tengine
from repro_torch.pagerank import fidelity as tfid
from repro_torch.pagerank import sparse as tsparse
from repro_torch.pagerank import steps as tsteps
from repro_torch.pagerank.convert import layout_from_numpy

# port backend name -> JAX backend name (as in tests/test_torch_engine.py)
BACKEND_MAP = {"dense": "dense", "ell": "ell", "fused_dense": "pallas_dense"}
PRECISIONS = ("f32", "bf16", "f16", "int8")
# engine vs reference (tests/test_pagerank_engine.py)
TOL = dict(rtol=1e-5, atol=1e-7)
SEED_SETS = [[3, 50], [120], [7, 7, 9], [199], [0, 1, 2, 3, 4]]


@pytest.fixture(scope="module")
def net():
    n = 200
    src, dst = jgen.protein_network(n, seed=7)
    assert int(jtr.dangling_mask(src, n).sum()) > 0
    return n, src, dst


def _pair(net, backend, precision="f32", tmetrics=None, jmetrics=None):
    n, src, dst = net
    j = JEngine(src, dst, n, backend=BACKEND_MAP[backend],
                precision=precision,
                metrics=jmetrics or jreg.NullRegistry())
    t = TEngine(src, dst, n, backend=backend, precision=precision,
                device="cpu", metrics=tmetrics or treg.NullRegistry())
    return j, t


def test_seed_matrix_bit_equal_with_duplicates():
    sets = [[3, 3, 5], np.asarray([0]), [9, 1, 9, 9], [4, 2]]
    got = tsteps.seed_matrix(10, sets)
    want = jsteps.seed_matrix(10, sets)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
    assert got[3, 0] == np.float32(2 / 3) and got[9, 2] == np.float32(0.75)
    with pytest.raises(ValueError, match="empty seed set"):
        tsteps.seed_matrix(10, [[1], []])


def test_ppr_steps_match_jax(net):
    n, src, dst = net
    rng = np.random.default_rng(1)
    H = np.array(jtr.build_transition_dense(src, dst, n,
                                            fix_dangling=False))
    dang = np.asarray(jtr.dangling_mask(src, n), np.float32)
    V = tsteps.seed_matrix(n, SEED_SETS)
    PR = rng.dirichlet(np.ones(n), size=len(SEED_SETS)).T.astype(np.float32)
    Hj, Ht = jnp.asarray(H), torch.from_numpy(H)
    want = jsteps.ppr_step_batched(lambda X: Hj @ X, jnp.asarray(PR),
                                   jnp.asarray(V), jnp.asarray(dang), 0.85)
    got = tsteps.ppr_step_batched(lambda X: Ht @ X, torch.from_numpy(PR),
                                  torch.from_numpy(V), torch.from_numpy(dang),
                                  0.85)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want1 = jsteps.ppr_step(lambda x: Hj @ x, jnp.asarray(PR[:, 0]),
                            jnp.asarray(V[:, 0]), jnp.asarray(dang), 0.85)
    got1 = tsteps.ppr_step(lambda x: Ht @ x, torch.from_numpy(PR[:, 0]),
                           torch.from_numpy(V[:, 0]), torch.from_numpy(dang),
                           0.85)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), **TOL)
    # one column of the batched step is the single step
    np.testing.assert_allclose(got[:, 0].numpy(), got1.numpy(), **TOL)


def _csr_pair(net):
    """The same CSR matvec in both packages."""
    from repro.graph.transition import build_transition_csr as jcsr
    from repro_torch.graph.transition import build_transition_csr as tcsr
    n, src, dst = net
    jm, tm = jcsr(src, dst, n), tcsr(src, dst, n, device="cpu")
    dang = np.asarray(jtr.dangling_mask(src, n), np.float32)
    return jm.matvec, tm.matvec, dang


def test_pagerank_sparse_matches_jax(net):
    n = net[0]
    jmv, tmv, dang = _csr_pair(net)
    want = jsparse.pagerank_sparse(jmv, n, dang, n_iters=60)
    got = tsparse.pagerank_sparse(tmv, n, dang, n_iters=60, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # without a dangling mask the leak is dropped in both
    want0 = jsparse.pagerank_sparse(jmv, n, None, n_iters=20)
    got0 = tsparse.pagerank_sparse(tmv, n, None, n_iters=20, device="cpu")
    np.testing.assert_allclose(got0.numpy(), np.asarray(want0), **TOL)


@pytest.mark.parametrize("tol,max_iters", [(1e-7, 300), (1e-3, 300),
                                           (1e-9, 5)])
def test_pagerank_sparse_tol_matches_jax(net, tol, max_iters):
    n = net[0]
    jmv, tmv, dang = _csr_pair(net)
    jpr, ji, jres = jsparse.pagerank_sparse_tol(jmv, n, dang, tol=tol,
                                                max_iters=max_iters)
    tpr, ti, tres = tsparse.pagerank_sparse_tol(tmv, n, dang, tol=tol,
                                                max_iters=max_iters,
                                                device="cpu")
    # float32 accumulation order may move the exit by one iteration
    assert abs(int(ti) - int(ji)) <= 1 and int(ti) <= max_iters
    np.testing.assert_allclose(tpr.numpy(), np.asarray(jpr), rtol=1e-4,
                               atol=1e-7)
    assert float(tres) <= tol or int(ti) == max_iters


def test_personalized_pagerank_matches_jax(net):
    n = net[0]
    jmv, tmv, dang = _csr_pair(net)
    for seeds in ([3, 50, 120], [7, 7, 9]):
        want = jsparse.personalized_pagerank(
            jmv, n, jnp.asarray(seeds, jnp.int32), dang, n_iters=60)
        got = tsparse.personalized_pagerank(tmv, n, seeds, dang,
                                            n_iters=60, device="cpu")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_sparse_solvers_default_to_cuda(net, monkeypatch):
    n = net[0]
    _, tmv, dang = _csr_pair(net)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tsparse.pagerank_sparse(tmv, n, dang),
                 lambda: tsparse.pagerank_sparse_tol(tmv, n, dang),
                 lambda: tsparse.personalized_pagerank(tmv, n, [1], dang)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_top_k_proteins_takes_numpy():
    pr = np.asarray([0.1, 0.4, 0.2, 0.3], np.float32)
    idx, sc = tsparse.top_k_proteins(pr, k=2)
    assert idx.tolist() == [1, 3] and sc.numpy().tolist() == [
        np.float32(0.4), np.float32(0.3)]
    # a strided column of a host matrix, as the serve engine passes it
    M = np.stack([pr, pr[::-1]], axis=1)
    assert tsparse.top_k_proteins(M[:, 1], k=1)[0].tolist() == [2]


def test_fidelity_equals_jax():
    rng = np.random.default_rng(5)
    a = rng.random(300).astype(np.float32)
    b = a + rng.normal(0, 1e-3, 300).astype(np.float32)
    for k in (1, 10, 100, 500):
        assert tfid.topk_overlap(a, b, k=k) == jfid.topk_overlap(a, b, k=k)
        assert tfid.kendall_tau(a, b, k=k) == jfid.kendall_tau(a, b, k=k)
    assert tfid.l1(a, b) == jfid.l1(a, b)
    assert tfid.topk_overlap(torch.from_numpy(a), b, k=10) == \
        jfid.topk_overlap(a, b, k=10)
    assert tfid.kendall_tau(a[:1], b[:1]) == jfid.kendall_tau(a[:1], b[:1])


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("backend", list(BACKEND_MAP))
def test_engine_ppr_matches_jax(net, backend, precision):
    """Every single-device tier at every precision; the f32 ``dense`` case
    is the dangling-FIXED H that PPR must unfix."""
    j, t = _pair(net, backend, precision)
    k = 40 if backend == "fused_dense" else 100
    want = np.asarray(j.ppr(SEED_SETS, n_iters=k))
    got = t.ppr(SEED_SETS, n_iters=k)
    assert got.shape == (net[0], len(SEED_SETS))
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_dense_ppr_unfixes_dangling_columns(net):
    """The f32 dense operand is dangling-fixed; without the mask PPR would
    leak mass uniformly and drift from the unfixed reduced-precision
    layout's answer."""
    j, t = _pair(net, "dense")
    H = t.operands[0]
    dang = t._dang.bool()
    assert torch.all(H[:, dang] > 0)            # fixed: 1/n columns
    got = t.ppr(SEED_SETS, n_iters=100)
    _, ell = _pair(net, "ell")
    np.testing.assert_allclose(got.numpy(), ell.ppr(SEED_SETS, 100).numpy(),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(got.sum(dim=0).numpy(), 1.0, atol=1e-5)


def test_fused_ppr_goes_through_the_streaming_kernel(net, monkeypatch):
    """One streaming_matvec call per iteration for all queries, on the
    pre-padded (Q, Mp) layout; on CPU tensors it launches nothing."""
    from repro_torch.kernels import streaming_matvec as k2
    _, t = _pair(net, "fused_dense", "int8")
    calls = []
    real = tengine.streaming_matvec

    def spy(W, X):
        calls.append((W.shape, X.shape, W.dtype))
        return real(W, X)

    monkeypatch.setattr(tengine, "streaming_matvec", spy)
    before = dict(k2.launches)
    t.ppr(SEED_SETS, n_iters=7)
    Hp = t.operands[0]
    assert calls == [(Hp.shape, (len(SEED_SETS), Hp.shape[1]),
                      torch.int8)] * 7
    assert k2.launches == before


def test_fused_ppr_needs_square_padding():
    lay = {"operands": (torch.zeros((256, 512)), torch.zeros((1, 512))),
           "dang": torch.zeros(200)}
    e = TEngine.from_layout("fused_dense", lay, 200, device="cpu",
                            metrics=treg.NullRegistry())
    with pytest.raises(ValueError, match="square"):
        e.ppr([[1]], n_iters=1)


def test_ppr_span_counter_and_bookkeeping_match_jax(net):
    jm, tm = jreg.MetricsRegistry(), treg.MetricsRegistry()
    j, t = _pair(net, "fused_dense", tmetrics=tm, jmetrics=jm)
    j.ppr(SEED_SETS, n_iters=5)
    t.ppr(SEED_SETS, n_iters=5)
    jd, td = jm.as_dict(), tm.as_dict()
    assert td["counters"] == jd["counters"]
    assert td["counters"]["engine.ppr_queries"] == len(SEED_SETS)
    assert shared_histograms(td) == set(jd["histograms"])
    assert [e for e in tm.events if e["kind"] == "span"][-1]["name"] == \
        "ppr"
    for name in ("_keys", "_outdeg", "_indeg"):
        assert np.array_equal(getattr(t, name), getattr(j, name))
        assert getattr(t, name).dtype == np.int64


@pytest.mark.parametrize("backend", list(BACKEND_MAP))
def test_carried_layout_keeps_bookkeeping_and_ppr(net, backend):
    j, t = _pair(net, backend, "bf16")
    arrays = {"operands": [np.asarray(o) for o in j.operands],
              "scales": None if j._scales is None else np.asarray(j._scales),
              "dang": np.asarray(j._dang), "keys": j._keys,
              "outdeg": j._outdeg, "indeg": j._indeg}
    lay = layout_from_numpy(backend, arrays, precision="bf16", device="cpu")
    e = TEngine.from_layout(backend, lay, net[0], precision="bf16",
                            device="cpu", metrics=treg.NullRegistry())
    for name in ("_keys", "_outdeg", "_indeg"):
        assert np.array_equal(getattr(e, name), getattr(j, name))
    assert torch.equal(e.ppr(SEED_SETS, 10), t.ppr(SEED_SETS, 10))
    bare = layout_from_numpy(backend, {k: arrays[k] for k in
                                       ("operands", "scales", "dang")},
                             precision="bf16", device="cpu")
    assert bare["keys"] is None and bare["outdeg"] is None
