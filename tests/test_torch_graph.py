"""PyTorch port, host graph layer: generators, edge-set canonicalization,
and the transition layouts must equal the JAX package's exactly."""
import numpy as np
import pytest
import torch

from repro.graph import delta as jdelta
from repro.graph import generators as jgen
from repro.graph import transition as jtr
from repro_torch.graph import delta as tdelta
from repro_torch.graph import generators as tgen
from repro_torch.graph import transition as ttr
from repro_torch.graph.sparse import CSRMatrix


@pytest.fixture(scope="module")
def net():
    n = 200
    src, dst = jgen.protein_network(n, seed=7)
    return n, src, dst


@pytest.mark.parametrize("name,args", [
    ("protein_network", (200, 7)),
    ("protein_network", (137, 3)),
    ("barabasi_albert", (150, 4, 1)),
    ("erdos_renyi", (150, 6.0, 2)),
])
def test_generators_bit_identical(name, args):
    js, jd = getattr(jgen, name)(*args)
    ts, td = getattr(tgen, name)(*args)
    assert ts.dtype == js.dtype == np.int32
    assert np.array_equal(ts, js) and np.array_equal(td, jd)


def test_dedupe_symmetrize_and_load_edge_list(tmp_path):
    rng = np.random.default_rng(11)
    src = rng.integers(0, 40, size=300)
    dst = rng.integers(0, 40, size=300)
    for a, b in zip(jgen._dedupe_symmetrize(src, dst, 40),
                    tgen._dedupe_symmetrize(src, dst, 40)):
        assert np.array_equal(a, b)
    path = tmp_path / "edges.txt"
    path.write_text("# src dst\n" + "\n".join(
        f"{s} {d}" for s, d in zip(src, dst)))
    js, jd, jn = jgen.load_edge_list(str(path))
    ts, td, tn = tgen.load_edge_list(str(path))
    assert jn == tn and np.array_equal(js, ts) and np.array_equal(jd, td)
    assert np.array_equal(jgen.degrees(js, jn), tgen.degrees(ts, tn))


@pytest.mark.parametrize("drop_self_loops", [True, False])
def test_dedupe_directed_and_edge_keys(drop_self_loops):
    rng = np.random.default_rng(5)
    n = 30
    src = rng.integers(0, n, size=200)
    dst = rng.integers(0, n, size=200)
    src[:5] = dst[:5]                              # self-loops present
    js, jd = jdelta.dedupe_directed(src, dst, n, drop_self_loops)
    ts, td = tdelta.dedupe_directed(src, dst, n, drop_self_loops)
    assert np.array_equal(js, ts) and np.array_equal(jd, td)
    assert bool(np.any(ts == td)) != drop_self_loops
    assert np.array_equal(jdelta.edge_keys(src, dst, n),
                          tdelta.edge_keys(src, dst, n))


@pytest.mark.parametrize("fix", [True, False])
def test_transition_dense_bit_identical(net, fix):
    n, src, dst = net
    want = np.asarray(jtr.build_transition_dense(src, dst, n,
                                                 fix_dangling=fix))
    got = ttr.build_transition_dense(src, dst, n, fix_dangling=fix,
                                     device="cpu")
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(ttr.transition_dense_np(src, dst, n, fix), want)


def test_dangling_fix_and_mask(net):
    n, src, dst = net
    A = ttr.transition_dense_np(src, dst, n, fix_dangling=False)
    assert np.array_equal(ttr.dangling_fix(A), jtr.dangling_fix(A))
    mask = ttr.dangling_mask(src, n)
    assert mask.sum() > 0
    assert np.array_equal(mask, jtr.dangling_mask(src, n))


def test_transition_csr_bit_identical(net):
    n, src, dst = net
    j = jtr.build_transition_csr(src, dst, n)
    t = ttr.build_transition_csr(src, dst, n, device="cpu")
    assert t.shape == j.shape and t.nnz == j.nnz
    for field in ("data", "indices", "indptr", "row_ids"):
        a, b = getattr(t, field).numpy(), np.asarray(getattr(j, field))
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    for a, b in zip(t.row_positions(), j.row_positions()):
        assert np.array_equal(a, b)


def test_csr_matvec_matches_jax(net):
    n, src, dst = net
    x = np.random.default_rng(0).random(n, dtype=np.float32)
    j = jtr.build_transition_csr(src, dst, n)
    t = ttr.build_transition_csr(src, dst, n, device="cpu")
    np.testing.assert_allclose(t.matvec(torch.from_numpy(x)).numpy(),
                               np.asarray(j.matvec(x)), rtol=1e-6,
                               atol=1e-8)


def test_csr_from_coo_direct():
    src = np.array([2, 0, 1, 0])
    dst = np.array([1, 2, 0, 0])
    vals = np.array([0.5, 1.0, 2.0, 3.0], np.float32)
    t = CSRMatrix.from_coo(src, dst, vals, (3, 3), device="cpu")
    dense = np.zeros((3, 3), np.float32)
    dense[src, dst] = vals
    x = np.arange(1, 4, dtype=np.float32)
    assert np.array_equal(t.matvec(torch.from_numpy(x)).numpy(), dense @ x)
