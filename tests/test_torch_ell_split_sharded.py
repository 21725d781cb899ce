"""PyTorch port, the ``ell_split_sharded`` tier on the CPU: a split ELL
per position of a mesh of four CPU positions, built from the caller's
edges on the mesh, stepped by the split-ELL kernel's plain version and an
exchange of the row blocks.

``run`` and ``run_tol`` are held to a float64 power iteration written
here (``RUN_TOL``: the float32 steps' rounding, the tolerance every tier
is held to against the JAX package's float64 engine in the engine's parity
tests; the L1 distance within ``L1_BOUND``) and to the ``ell`` tier on one
device (``TIER_TOL``: the same arithmetic, summed in another order, since
the blocks take their own ``k0`` and the leak is added block by block).
Graphs: seeded Kronecker graphs at scales 8 to 10 and past the degree
order's 32,768 vertices, and small graphs made by hand with dangling
vertices, a hub row longer than ``k0``, repeated edges and self-loops, and
n not divisible by 4.  Also the build's span and counters, the balance of
the blocks, the edge set never gathered on one device, and the clear error
of what the tier does not run."""
import numpy as np
import pytest
import torch

from repro_torch.core import fabric_matvec as fm
from repro_torch.launch.mesh import make_mesh
from repro_torch.obs.registry import MetricsRegistry, NullRegistry
from repro_torch.pagerank import (DynamicPageRankEngine, LandmarkIndex,
                                  PageRankEngine)
from repro_torch.pagerank import engine as tengine

RUN_TOL = dict(rtol=1e-4, atol=1e-7)
L1_BOUND = 1e-5
TIER_TOL = dict(rtol=1e-5, atol=1e-7)
D = 0.85
MESHES = {"1d": ((4,), ("shard",)), "2x2": ((2, 2), ("row", "col"))}


def kronecker(scale, seed, edgefactor=16):
    """A seeded Graph500 Kronecker graph (A/B/C 0.57/0.19/0.19), the
    labels scrambled, symmetrized; self-loops and repeats left for the
    engine to collapse."""
    rng = np.random.default_rng(seed)
    m = edgefactor << scale
    i = np.zeros(m, np.int64)
    j = np.zeros(m, np.int64)
    for level in range(scale):
        ii = rng.random(m) > 0.76
        jj = rng.random(m) > np.where(ii, 0.19 / 0.24, 0.57 / 0.76)
        i |= ii.astype(np.int64) << level
        j |= jj.astype(np.int64) << level
    perm = rng.permutation(1 << scale)
    i, j = perm[i], perm[j]
    return np.concatenate([i, j]), np.concatenate([j, i]), 1 << scale


def by_hand():
    rng = np.random.default_rng(7)
    n = 203                         # not divisible by 4
    s = rng.integers(0, n - 20, 900)        # the last 20 are dangling
    d = rng.integers(0, n, 900)
    hub_n = 1001
    hs = np.concatenate([rng.integers(0, hub_n, 3000),
                         rng.choice(hub_n, 600, replace=False)])
    hd = np.concatenate([rng.integers(0, hub_n, 3000), np.full(600, 17)])
    ds = np.concatenate([s, s[:50], [5, 9, 9]])     # repeats, self-loops
    dd = np.concatenate([d, d[:50], [5, 9, 9]])
    return {"dangling": (s, d, n, None), "hub": (hs, hd, hub_n, 4),
            "repeats": (ds, dd, n, None)}


GRAPHS = {**by_hand(), "kron8": (*kronecker(8, 1), None),
          "kron10": (*kronecker(10, 2), None)}


def f64_ranks(src, dst, n, n_iters):
    """Global PageRank in float64 on the edge set: H[i, j] = 1 / outdeg(j)
    for j -> i, dangling rank leaked uniformly."""
    keys = np.unique(np.asarray(src, np.int64) * n + np.asarray(dst))
    s, d = keys // n, keys % n
    outdeg = np.bincount(s, minlength=n).astype(np.float64)
    w = 1.0 / outdeg[s]
    x = np.full(n, 1.0 / n)
    for _ in range(n_iters):
        y = np.bincount(d, weights=w * x[s], minlength=n)
        x = D * (y + x[outdeg == 0].sum() / n) + (1.0 - D) / n
    return torch.from_numpy(x)


def split(src, dst, n, mesh="1d", metrics=None, **kw):
    shape, axes = MESHES[mesh]
    return PageRankEngine(src, dst, n, d=D, backend="ell_split_sharded",
                          mesh=make_mesh(shape, axes, ["cpu"] * 4),
                          metrics=metrics or NullRegistry(), **kw)


def ell(src, dst, n, **kw):
    return PageRankEngine(src, dst, n, d=D, backend="ell", device="cpu",
                          metrics=NullRegistry(), **kw)


def assert_near_f64(got, ref):
    torch.testing.assert_close(got.double(), ref, **RUN_TOL)
    assert float(torch.sum(torch.abs(got.double() - ref))) <= L1_BOUND


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", list(GRAPHS))
def test_run_matches_float64_and_the_ell_tier(case, mesh):
    src, dst, n, ell_k = GRAPHS[case]
    eng = split(src, dst, n, mesh, ell_k=ell_k)
    got = eng.run(20)
    assert got.shape == (n,) and got.dtype == torch.float32
    assert_near_f64(got, f64_ranks(src, dst, n, 20))
    torch.testing.assert_close(got, ell(src, dst, n, ell_k=ell_k).run(20),
                               **TIER_TOL)
    assert torch.equal(eng.run(20), got)


@pytest.mark.parametrize("case", ["dangling", "hub", "kron10"])
def test_run_tol_matches_float64_and_the_ell_tier(case):
    src, dst, n, ell_k = GRAPHS[case]
    eng, one = split(src, dst, n, ell_k=ell_k), ell(src, dst, n, ell_k=ell_k)
    got, iters, res = eng.run_tol(1e-6, max_iters=300)
    want, want_iters, _ = one.run_tol(1e-6, max_iters=300)
    assert eng.last_solve_info.converged and float(res) <= 1e-6
    assert abs(int(iters) - int(want_iters)) <= 1
    torch.testing.assert_close(got, want, **TIER_TOL)
    assert_near_f64(got, f64_ranks(src, dst, n, int(iters)))
    x0 = torch.linspace(1.0, 2.0, n)
    warm = eng.run_tol(1e-6, max_iters=300, x0=x0 / x0.sum())[0]
    torch.testing.assert_close(warm, got, rtol=1e-4, atol=1e-7)


def test_past_the_hot_columns_the_vertices_are_in_degree_order():
    src, dst, n = kronecker(16, 3, edgefactor=2)
    eng, one = split(src, dst, n), ell(src, dst, n)
    assert n > tengine.HOT_COLUMNS
    assert torch.equal(eng.vertex_order, one.vertex_order)
    got = eng.run(10)
    torch.testing.assert_close(got, one.run(10), **TIER_TOL)
    assert_near_f64(got, f64_ranks(src, dst, n, 10))


def test_blocks_carry_equal_entries_on_their_devices():
    src, dst, n, _ = GRAPHS["kron10"]
    reg = MetricsRegistry()
    eng = split(src, dst, n, metrics=reg)
    (rec,) = [r for r in reg.span_records if r["name"] == "prepare.shard"]
    (top,) = [r for r in reg.span_records if r["name"] == "prepare"]
    assert rec["parent"] == top["id"]
    rows, entries = (rec["fields"]["rows_per_card"],
                     rec["fields"]["entries_per_card"])
    keys = np.unique(np.asarray(src, np.int64) * n + dst)
    assert sum(rows) == n and all(r > 0 for r in rows)
    assert sum(entries) == eng.n_edges == keys.size
    assert max(entries) * 4 <= 1.05 * sum(entries)
    assert list(np.diff(eng._rows)) == rows
    for p, ops in enumerate(eng.operands):
        assert ops[0].shape[0] == rows[p] == eng._dang[p].shape[0]
        assert int(ops[1].max()) < n      # columns reach the whole vector
        assert ops[0].device == eng.mesh.device_list[p]
    assert eng._keys is None and eng._outdeg is None and eng._indeg is None


def test_the_step_counts_its_exchange_on_the_host():
    src, dst, n, _ = GRAPHS["dangling"]
    reg = MetricsRegistry()
    eng = split(src, dst, n, metrics=reg)
    fm.reset_counts()
    eng.run(7)
    counters = reg.as_dict()["counters"]
    assert counters["engine.sharded_steps"] == 7
    # every block to the three other positions, and every leak part
    assert counters["engine.exchange_bytes"] == 7 * 3 * 4 * (n + 4)
    assert fm.collectives["all_gather"] == 2 * 7 + 1
    fm.reset_counts()


def test_the_edge_set_is_never_gathered_on_one_device(monkeypatch):
    def gather(*a, **kw):
        raise AssertionError("_edge_set called")

    monkeypatch.setattr(tengine, "_edge_set", gather)
    src, dst, n, _ = GRAPHS["kron8"]
    assert_near_f64(split(src, dst, n).run(10), f64_ranks(src, dst, n, 10))


def test_a_block_left_out_of_the_exchange_shows(monkeypatch):
    src, dst, n, _ = GRAPHS["kron8"]
    eng = split(src, dst, n)
    real = fm.gather_blocks

    def skip_first(groups):
        (outs, spans), *rest = groups
        return real([(outs, [(a, a) if q == 1 else (a, b)
                             for q, (a, b) in enumerate(spans)]), *rest])

    monkeypatch.setattr(fm, "gather_blocks", skip_first)
    got = eng.run(10)
    assert float(torch.sum(torch.abs(got.double()
                                     - f64_ranks(src, dst, n, 10)))) > 1e-3


@pytest.mark.parametrize("call", ["ppr", "dynamic", "from_layout",
                                  "landmarks"])
def test_what_the_tier_does_not_run_raises_naming_ell_sharded(call):
    src, dst, n, _ = GRAPHS["dangling"]
    mesh = make_mesh((4,), ("shard",), ["cpu"] * 4)
    if call == "dynamic":
        with pytest.raises(NotImplementedError, match="ell_sharded"):
            DynamicPageRankEngine(src, dst, n, backend="ell_split_sharded",
                                  mesh=mesh)
        return
    eng = split(src, dst, n)
    if call == "ppr":
        with pytest.raises(NotImplementedError, match="ell_sharded"):
            eng.ppr([[1, 2]], n_iters=5)
    elif call == "from_layout":
        with pytest.raises(NotImplementedError, match="ell_sharded"):
            PageRankEngine.from_layout(
                "ell_split_sharded", {"operands": eng.operands,
                                      "dang": eng._dang, "mesh": mesh}, n)
    else:
        with pytest.raises(ValueError, match="bookkeeping"):
            LandmarkIndex(eng)


def test_fewer_vertices_than_positions_are_refused():
    with pytest.raises(ValueError, match="a vertex per mesh position"):
        split(np.array([0, 1]), np.array([1, 2]), 3)
