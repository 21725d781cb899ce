"""PyTorch port, the engine's tiers on the CPU: the names that the
benchmark's fault tests (``perfbench/test_pb_faults.py``) patch are still
on every tier's path, and each backend name picks one tier object, the
same one from the constructor and from ``from_layout``, the SELL tier on a
dynamic ``ell`` engine."""
import numpy as np
import pytest
import torch

from repro_torch.graph.delta import GraphDelta
from repro_torch.launch.mesh import make_mesh
from repro_torch.obs.registry import NullRegistry
from repro_torch.pagerank import DynamicPageRankEngine, PageRankEngine
from repro_torch.pagerank import dynamic as tdyn
from repro_torch.pagerank import engine as tengine

N = 64


def _graph(seed=0):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, N, 400), rng.integers(0, N, 400)
    keep = (src != dst) & (src < N - 4)         # four dangling vertices
    return src[keep], dst[keep]


def _engine(backend, precision="f32", cls=PageRankEngine, **kw):
    src, dst = _graph()
    if backend in tengine.SHARDED_BACKENDS:
        shape, axes = (((2, 2), ("row", "col")) if backend == "dense_sharded"
                       else ((4,), ("shard",)))
        kw["mesh"] = make_mesh(shape, axes, ["cpu"] * 4)
    else:
        kw["device"] = "cpu"
    return cls(src, dst, N, backend=backend, precision=precision,
               metrics=NullRegistry(), bsr_block_size=16, **kw)


def _assert_start(eng):
    uniform = torch.full((N,), 1.0 / N)
    x0 = torch.linspace(1.0, 2.0, N)
    x0 = x0 / x0.sum()
    assert torch.equal(eng.run(5), uniform)
    assert torch.equal(eng.run_tol(1e-6)[0], uniform)
    assert torch.equal(eng.run_tol(1e-6, x0=x0)[0], x0)


EAGER = [("dense", "int8", PageRankEngine), ("ell", "f32", PageRankEngine),
         ("ell", "int8", PageRankEngine), ("bsr", "f32", PageRankEngine),
         ("bsr", "int8", PageRankEngine),
         ("ell", "f32", DynamicPageRankEngine),
         ("ell", "int8", DynamicPageRankEngine)]


@pytest.mark.parametrize("backend,precision,cls", EAGER)
def test_every_eager_step_goes_through_sparse_step(monkeypatch, backend,
                                                   precision, cls):
    """``engine.sparse_step`` returning its input freezes ``run`` and
    ``run_tol`` at their start vector on the eager tiers (``sell`` on the
    dynamic engine)."""
    eng = _engine(backend, precision, cls)
    monkeypatch.setattr(tengine, "sparse_step",
                        lambda mv, pr, dang, d, n: pr)
    _assert_start(eng)


@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_every_fused_step_goes_through_the_fused_kernel(monkeypatch,
                                                        precision):
    eng = _engine("fused_dense", precision)
    monkeypatch.setattr(
        tengine, "pagerank_step_fused",
        lambda Hp, xp, dangp, t, scales, d: (xp, (xp * dangp).sum()))
    _assert_start(eng)


def test_a_fused_push_goes_through_push_fused(monkeypatch):
    eng = _engine("fused_dense", cls=DynamicPageRankEngine)
    eng.run_tol(1e-7, max_iters=500)
    calls = []
    real = tdyn._push_fused

    def spy(*a, **kw):
        calls.append(kw["max_pushes"])
        return real(*a, **kw)

    monkeypatch.setattr(tdyn, "_push_fused", spy)
    _, info = eng.update(GraphDelta.inserts(np.array([1]), np.array([9])))
    assert info.strategy == "push" and calls == [1000]


def test_each_backend_has_one_tier():
    assert set(tengine.TIERS) == set(tengine.BACKENDS)
    tiers = list(tengine.TIERS.values())
    assert len({id(t) for t in tiers}) == len(tiers)
    assert all(isinstance(t, tengine.Tier) for t in tiers)
    assert {b for b, t in tengine.TIERS.items() if t.sharded} == set(
        tengine.SHARDED_BACKENDS)


def _f64_ranks(n_iters, d=0.85):
    """Global PageRank of ``_graph()`` in float64."""
    src, dst = _graph()
    keys = np.unique(src.astype(np.int64) * N + dst)
    s, t = keys // N, keys % N
    outdeg = np.bincount(s, minlength=N).astype(np.float64)
    x = np.full(N, 1.0 / N)
    for _ in range(n_iters):
        y = np.bincount(t, weights=x[s] / outdeg[s], minlength=N)
        x = d * (y + x[outdeg == 0].sum() / N) + (1.0 - d) / N
    return torch.from_numpy(x)


@pytest.mark.parametrize("backend", tengine.BACKENDS)
def test_the_constructor_and_from_layout_pick_the_same_tier(backend):
    eng = _engine(backend, "int8")
    assert eng._tier is tengine.TIERS[backend]
    layout = {"operands": eng.operands, "dang": eng._dang,
              "scales": eng._scales, "mesh": eng.mesh}
    if eng._tier.edges_on_mesh:
        # no JAX tier lays out such a layout: the tier takes none, and is
        # held in its place to float64 (int8 keeps 1 / outdeg to 8 bits a
        # row: the ell tier reads 4.3e-3 of a rank from it here) and to
        # the ell tier, whose rows it quantizes alike
        with pytest.raises(NotImplementedError, match="ell_sharded"):
            PageRankEngine.from_layout(backend, layout, N, precision="int8",
                                       device=eng.device,
                                       metrics=NullRegistry())
        got = eng.run(5)
        torch.testing.assert_close(got.double(), _f64_ranks(5), rtol=1e-2,
                                   atol=1e-6)
        torch.testing.assert_close(got, _engine("ell", "int8").run(5),
                                   rtol=1e-5, atol=1e-7)
        return
    carried = PageRankEngine.from_layout(backend, layout, N,
                                         precision="int8", device=eng.device,
                                         metrics=NullRegistry())
    assert carried._tier is eng._tier
    assert torch.equal(carried.run(5), eng.run(5))


def test_a_dynamic_ell_engine_keeps_the_sell_tier_through_a_rebuild():
    eng = _engine("ell", cls=DynamicPageRankEngine)
    assert isinstance(eng._tier, tdyn.SellTier)
    assert eng._tier is not tengine.TIERS["ell"]
    eng.run_tol(1e-6)
    rng = np.random.default_rng(1)
    u, v = rng.integers(0, N, 40), rng.integers(0, N, 40)
    _, info = eng.update(GraphDelta.inserts(u[u != v], v[u != v]),
                         strategy="rebuild")
    assert info.strategy == "rebuild"
    assert isinstance(eng._tier, tdyn.SellTier)
    assert eng.layout.startswith("sell(")
