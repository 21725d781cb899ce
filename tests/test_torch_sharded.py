"""PyTorch port, the sharded mesh tiers on the CPU: the fabric schedule
(``core/fabric_matvec.py``), the distributed solvers
(``pagerank/distributed.py``) and the ``dense_sharded`` / ``ell_sharded``
engine tiers, each against the JAX package on the same inputs.

The JAX side runs on conftest's 8 virtual CPU devices; the port's side on a
mesh of ``["cpu"] * k`` with the same shape: 2 x 4 (the global reshard of
``matvec_iterated_reshard``), 2 x 2 (its diagonal re-injection), 1-D 8, and
uneven N.  Tolerances: rtol 1e-5 / atol 1e-7 against the JAX engine
(``tests/test_pagerank_engine.py``), max abs 1e-6 against the port's
``dense`` tier (``tests/test_engine_golden.py``), iteration counts within
1 (``tests/test_obs.py``); the fabric products at the JAX tests' own
tolerances."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from repro.core import fabric_matvec as jfm
from repro.graph import generators as jgen
from repro.graph import transition as jtr
from repro.launch.mesh import make_mesh as jmake_mesh
from repro.obs import registry as jreg
from repro.pagerank import PageRankEngine as JEngine
from repro.pagerank import distributed as jdist
from repro.pagerank import engine as jengine
from repro_torch.core import fabric_matvec as fm
from repro_torch.core.fabric_matvec import P, ShardedTensor
from repro_torch.graph import transition as ttr
from repro_torch.launch.mesh import Mesh, make_host_mesh, make_mesh
from repro_torch.obs import registry as treg
from repro_torch.pagerank import PageRankEngine as TEngine
from repro_torch.pagerank import distributed as tdist
from repro_torch.pagerank import engine as tengine

SHARDED = ("dense_sharded", "ell_sharded")
PRECISIONS = ("f32", "bf16", "f16", "int8")
# engine vs the JAX engine, and vs the dense tier (golden sharded bound)
TOL = dict(rtol=1e-5, atol=1e-7)
DENSE_ABS = 1e-6
# the JAX default meshes on 8 devices, as (shape, axes)
DEFAULT = {"dense_sharded": ((2, 4), ("row", "col")),
           "ell_sharded": ((8,), ("shard",))}


def tmesh(shape, axes):
    return make_mesh(shape, axes, ["cpu"] * int(np.prod(shape)))


def _np(x):
    if isinstance(x, ShardedTensor):
        x = x.full()
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def net(multi_device):
    n = 200
    src, dst = jgen.protein_network(n, seed=7)
    assert int(jtr.dangling_mask(src, n).sum()) > 0
    return n, src, dst


def _pair(net, backend, precision="f32", shape=None, axes=None, n=None,
          src=None, dst=None):
    if n is None:
        n, src, dst = net
    shape, axes = (DEFAULT[backend] if shape is None else (shape, axes))
    j = JEngine(src, dst, n, backend=backend, precision=precision,
                mesh=jmake_mesh(shape, axes), metrics=jreg.NullRegistry())
    t = TEngine(src, dst, n, backend=backend, precision=precision,
                mesh=tmesh(shape, axes), metrics=treg.NullRegistry())
    return j, t


class _NoSync:
    """Raises if a tensor is read back to the host inside the block (what
    a host sync would do on the card)."""

    NAMES = ("item", "tolist", "numpy", "cpu", "__bool__", "__float__",
             "__int__")

    def __enter__(self):
        self.saved = {k: getattr(torch.Tensor, k) for k in self.NAMES}

        def refuse(*_a, **_k):
            raise AssertionError("host sync inside run()")

        for k in self.NAMES:
            setattr(torch.Tensor, k, refuse)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            setattr(torch.Tensor, k, v)


# --------------------------------------------------------------------------- #
# launch/mesh.py                                                              #
# --------------------------------------------------------------------------- #
def test_mesh_names_shape_and_positions():
    m = tmesh((2, 4), ("data", "model"))
    assert m.shape == {"data": 2, "model": 4} and m.size == 8
    assert m.axis_names == ("data", "model")
    assert m.coords(5) == {"data": 1, "model": 1}
    j = jmake_mesh((2, 4), ("data", "model"))
    assert dict(m.shape) == dict(j.shape) and m.size == j.size
    assert m == tmesh((2, 4), ("data", "model"))
    assert m != tmesh((4, 2), ("data", "model"))


def test_mesh_never_picks_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh((2, 2), ("data", "model"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_host_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh((2,), ("shard",), ["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh((2, 2), ("data", "model"), ["cpu"] * 3)
    host = make_host_mesh(["cpu"] * 3)
    assert host.shape == {"data": 3, "model": 1}
    assert isinstance(host, Mesh)


# --------------------------------------------------------------------------- #
# core/fabric_matvec.py (tests/test_fabric_matvec.py)                         #
# --------------------------------------------------------------------------- #
def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_matvec_single_device():
    A, x = _rand((8, 8), 0), _rand((8,), 1)
    y = fm.matvec(torch.from_numpy(A), torch.from_numpy(x),
                  tmesh((1, 1), ("data", "model")))
    want = np.asarray(jfm.matvec(jnp.asarray(A), jnp.asarray(x),
                                 jmake_mesh((1, 1), ("data", "model"))))
    np.testing.assert_allclose(_np(y), A @ x, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(y), want, rtol=1e-5, atol=1e-6)


def test_matvec_scatter_single_device():
    A, x = _rand((8, 8), 0), _rand((8,), 1)
    y = fm.matvec_scatter(torch.from_numpy(A), torch.from_numpy(x),
                          tmesh((1, 1), ("data", "model")))
    want = np.asarray(jfm.matvec_scatter(
        jnp.asarray(A), jnp.asarray(x), jmake_mesh((1, 1),
                                                   ("data", "model"))))
    np.testing.assert_allclose(_np(y), A @ x, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(y), want, rtol=1e-5, atol=1e-6)


def test_gemv_batched_single_device():
    W, X = _rand((16, 8), 2), _rand((4, 8), 3)
    Y = fm.fabric_gemv_batched(torch.from_numpy(W), torch.from_numpy(X),
                               tmesh((1, 1), ("data", "model")))
    want = np.asarray(jfm.fabric_gemv_batched(
        jnp.asarray(W), jnp.asarray(X), jmake_mesh((1, 1),
                                                   ("data", "model"))))
    np.testing.assert_allclose(_np(Y), X @ W.T, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_np(Y), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 4), (2, 2), (4, 4)])
def test_multidevice_semantics(multi_device, shape):
    """The 16-device subprocess case of the JAX suite, on the port's CPU
    mesh: the fabric matvec, its re-injection back to the vertical-bus
    layout, 8 iterated PageRank steps and the scatter variant's
    collective; against the JAX package in process where conftest's 8
    devices hold the mesh."""
    axes = ("data", "model")
    mesh = tmesh(shape, axes)
    N = 32
    A, x = _rand((N, N), 0), _rand((N,), 1)
    Ad = fm.ShardedTensor.from_global(torch.from_numpy(A), mesh,
                                      P("data", "model"))
    xd = fm.ShardedTensor.from_global(torch.from_numpy(x), mesh, P("model"))
    y = fm.matvec(Ad, xd, mesh)
    np.testing.assert_allclose(_np(y), A @ x, rtol=1e-4, atol=1e-5)
    x2 = fm.matvec_iterated_reshard(y, mesh)
    assert x2.spec == P("model")
    np.testing.assert_allclose(_np(x2), _np(y), rtol=1e-6)
    H = np.random.default_rng(4).random((N, N), dtype=np.float32)
    H /= H.sum(0, keepdims=True)
    Hd = fm.ShardedTensor.from_global(torch.from_numpy(H), mesh,
                                      P("data", "model"))
    prd = fm.ShardedTensor.from_global(torch.full((N,), 1.0 / N), mesh,
                                       P("model"))
    pr_ref = np.full((N,), 1.0 / N, np.float32)
    for _ in range(8):
        yd = fm.matvec(Hd, prd, mesh)
        yd = ShardedTensor(mesh, yd.spec, yd.shape, fm.shard_map(
            lambda t: 0.85 * t + 0.15 / N, mesh, yd))
        prd = fm.matvec_iterated_reshard(yd, mesh)
        pr_ref = 0.85 * (H @ pr_ref) + 0.15 / N
    np.testing.assert_allclose(_np(prd), pr_ref, rtol=1e-4)
    fm.reset_counts()
    ys = fm.matvec_scatter(Ad, xd, mesh)
    assert fm.collectives["psum_scatter"] == 1, "no collective!"
    assert ys.spec == P(("data", "model"))
    np.testing.assert_allclose(_np(ys), A @ x, rtol=1e-4, atol=1e-5)
    if np.prod(shape) <= jax.device_count():
        jm = jmake_mesh(shape, axes)
        jAd = jax.device_put(A, NamedSharding(jm, JP("data", "model")))
        jxd = jax.device_put(x, NamedSharding(jm, JP("model")))
        jy = jfm.matvec(jAd, jxd, jm)
        np.testing.assert_allclose(_np(y), np.asarray(jy), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(
            _np(x2), np.asarray(jfm.matvec_iterated_reshard(jy, jm)),
            rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape,kinds", [((2, 2), {"psum_masked": 1}),
                                         ((2, 4), {"reshard": 1}),
                                         ((1, 4), {})])
def test_reinjection_takes_the_diagonal_only_on_a_square_mesh(shape, kinds):
    """2 x 2: the masked diagonal psum; 2 x 4: the global reshard; 1 x 4:
    every position already holds the whole vector, so its column block is
    cut locally and nothing moves."""
    mesh = tmesh(shape, ("data", "model"))
    y = fm.ShardedTensor.from_global(torch.arange(16.0), mesh, P("data"))
    fm.reset_counts()
    x = fm.matvec_iterated_reshard(y, mesh)
    assert dict(fm.collectives) == kinds
    assert torch.equal(x.full(), torch.arange(16.0))
    # every shard is its own contiguous tensor on its position's device
    assert all(s.is_contiguous() and s.device.type == "cpu"
               for s in x.shards)


def test_collectives_sum_in_mesh_order_and_repeat_bit_equal():
    """A psum adds the group's shards left to right in mesh order; two
    positions of one group on one device share the result, and a repeat
    gives the same bits."""
    mesh = tmesh((2, 4), ("data", "model"))
    xs = [torch.tensor([float(10 ** p)]) for p in range(8)]
    out = fm.psum(xs, mesh, "model")
    want0 = ((xs[0] + xs[1]) + xs[2]) + xs[3]
    assert torch.equal(out[0], want0) and out[0] is out[3]
    assert torch.equal(out[4], ((xs[4] + xs[5]) + xs[6]) + xs[7])
    again = fm.psum(xs, mesh, "model")
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    g = fm.all_gather(xs, mesh, ("data", "model"))
    assert torch.equal(g[0], torch.cat(xs))
    s = fm.psum_scatter([torch.arange(8.0) * (p + 1) for p in range(8)],
                        mesh, "model")
    assert torch.equal(s[1], torch.arange(8.0)[2:4] * 10)
    m = fm.psum_masked(xs, mesh, "data", [p < 3 for p in range(8)])
    assert torch.equal(m[5], xs[1]) and torch.equal(m[7], torch.zeros(1))


def test_sharded_tensor_layouts_round_trip():
    mesh = tmesh((2, 4), ("data", "model"))
    x = torch.arange(64.0).reshape(8, 8)
    for spec in (P("data", "model"), P("model", None), P(None, "data"),
                 P(("data", "model"), None), P()):
        st = ShardedTensor.from_global(x, mesh, spec)
        assert torch.equal(st.full(), x)
        for other in (P("data", None), P(None, ("data", "model"))):
            assert torch.equal(fm.reshard(st, other).full(), x)
    with pytest.raises(ValueError, match="does not split"):
        ShardedTensor.from_global(torch.zeros(6), mesh, P("model"))


# --------------------------------------------------------------------------- #
# pagerank/distributed.py                                                     #
# --------------------------------------------------------------------------- #
def test_distributed_dangling_regression_2d_mesh(net):
    """Unfixed H plus the explicit leak on a 2 x 4 mesh against the JAX
    function and the dangling-fixed dense reference."""
    n, src, dst = net
    Hu = np.asarray(jtr.build_transition_dense(src, dst, n,
                                               fix_dangling=False))
    dang = jtr.dangling_mask(src, n).astype(np.float32)
    jm = jmake_mesh((2, 4), ("data", "model"))
    jpr = jax.jit(lambda Hd: jdist.pagerank_distributed(
        Hd, jm, n_iters=80, dangling=jnp.asarray(dang)))(
        jdist.make_sharded_inputs_dense(jnp.asarray(Hu), jm))
    mesh = tmesh((2, 4), ("data", "model"))
    pr = tdist.pagerank_distributed(
        tdist.make_sharded_inputs_dense(torch.from_numpy(Hu), mesh), mesh,
        n_iters=80, dangling=torch.from_numpy(dang))
    ref = TEngine(src, dst, n, backend="dense", device="cpu").run(80)
    np.testing.assert_allclose(_np(pr), np.asarray(jpr), **TOL)
    assert float(np.abs(_np(pr) - _np(ref)).max()) <= DENSE_ABS


@pytest.mark.parametrize("layout", ["dense", "ell"])
def test_distributed_on_a_4x4_mesh(net, layout):
    """The 16-device script of tests/test_pagerank.py on the port's 4 x 4
    CPU mesh: the fixed-H fabric schedule and the row-sharded ELL schedule
    against the dense reference at its rtol 2e-4, atol 1e-7."""
    n = 128
    src, dst = jgen.protein_network(n, seed=11)
    mesh = tmesh((4, 4), ("data", "model"))
    ref = TEngine(src, dst, n, backend="dense", device="cpu").run(60)
    if layout == "dense":
        H = ttr.build_transition_dense(src, dst, n, device="cpu")
        pr = tdist.pagerank_distributed(
            tdist.make_sharded_inputs_dense(H, mesh), mesh, n_iters=60)
    else:
        ell = ttr.build_transition_ell(src, dst, n, k=64, device="cpu")
        dang = torch.from_numpy(ttr.dangling_mask(src, n).astype(np.float32))
        pr = tdist.pagerank_distributed_sparse(
            ell.data, ell.indices, mesh, n_iters=60, dangling=dang)
    np.testing.assert_allclose(_np(pr), _np(ref), rtol=2e-4, atol=1e-7)


# --------------------------------------------------------------------------- #
# the engine tiers (tests/test_engine_sharded.py)                             #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("backend", SHARDED)
def test_sharded_matches_dense_reference(net, backend):
    j, t = _pair(net, backend)
    n, src, dst = net
    assert t.mesh is not None and t.mesh.size > 1
    assert t.layout == j.layout and t._n_pad == j._n_pad
    pr = t.run(100)
    ref = TEngine(src, dst, n, backend="dense", device="cpu").run(100)
    assert pr.shape == (n,) and pr.dtype == torch.float32
    np.testing.assert_allclose(_np(pr), _np(j.run(100)), **TOL)
    assert float(np.abs(_np(pr) - _np(ref)).max()) <= DENSE_ABS
    assert float(pr.sum()) == pytest.approx(1.0, abs=1e-3)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("backend", SHARDED)
def test_sharded_run_every_precision_matches_jax(net, backend, precision):
    j, t = _pair(net, backend, precision)
    assert t.layout == j.layout
    assert t.layout_bytes == j.layout_bytes
    np.testing.assert_allclose(_np(t.run(60)), _np(j.run(60)), **TOL)


@pytest.mark.parametrize("backend", SHARDED)
def test_sharded_early_exit_across_mesh(net, backend):
    """The residual is one scalar for the whole mesh: the solve stops at
    the JAX sharded tier's iteration (within 1) and the JAX single-device
    dense reference's (within 2, the JAX test's bound)."""
    j, t = _pair(net, backend)
    n, src, dst = net
    tr_ = t.run_tol(tol=1e-7, max_iters=500)
    jr = j.run_tol(tol=1e-7, max_iters=500)
    assert 0 < int(tr_.iters) < 500 and float(tr_.residual) <= 1e-7
    assert abs(int(tr_.iters) - int(jr.iters)) <= 1
    from repro.pagerank import pagerank_dense
    ref, ref_iters, _, _, _ = pagerank_dense(
        jtr.build_transition_dense(src, dst, n), tol=1e-7, max_iters=500)
    assert abs(int(tr_.iters) - int(ref_iters)) <= 2
    np.testing.assert_allclose(_np(tr_.pr), _np(jr.pr), **TOL)
    assert float(np.abs(_np(tr_.pr) - np.asarray(ref)).max()) <= 1e-5
    assert tr_.info.trace.n_iters == tr_.info.iters


@pytest.mark.parametrize("backend", SHARDED)
def test_sharded_uneven_n_pads_and_slices(multi_device, backend):
    n = 203
    src, dst = jgen.protein_network(n, seed=5)
    j, t = _pair(None, backend, n=n, src=src, dst=dst)
    assert t._n_pad > n and t._n_pad == j._n_pad
    pr = t.run(80)
    assert pr.shape == (n,)
    np.testing.assert_allclose(_np(pr), _np(j.run(80)), **TOL)
    ref = TEngine(src, dst, n, backend="dense", device="cpu").run(80)
    assert float(np.abs(_np(pr) - _np(ref)).max()) <= DENSE_ABS


@pytest.mark.parametrize("backend", SHARDED)
def test_sharded_batched_ppr_matches_single_device(net, backend):
    """Query-sharded (N, Q) propagation, with Q = 5 indivisible by the
    shard count, against the JAX tier and the port's ell tier."""
    j, t = _pair(net, backend)
    n, src, dst = net
    rng = np.random.default_rng(0)
    seed_sets = [rng.choice(n, size=3, replace=False) for _ in range(5)]
    got = t.ppr(seed_sets, n_iters=60)
    assert got.shape == (n, 5)
    np.testing.assert_allclose(_np(got), _np(j.ppr(seed_sets, n_iters=60)),
                               **TOL)
    want = TEngine(src, dst, n, backend="ell", device="cpu").ppr(
        seed_sets, n_iters=60)
    assert float(np.abs(_np(got) - _np(want)).max()) <= 1e-5
    np.testing.assert_allclose(_np(got).sum(axis=0), 1.0, atol=1e-3)


@pytest.mark.parametrize("precision", ["bf16", "int8"])
@pytest.mark.parametrize("backend", SHARDED)
def test_sharded_ppr_reduced_precision_matches_jax(net, backend, precision):
    j, t = _pair(net, backend, precision)
    seed_sets = [[3, 50], [120], [7, 8, 9]]
    np.testing.assert_allclose(_np(t.ppr(seed_sets, n_iters=40)),
                               _np(j.ppr(seed_sets, n_iters=40)), **TOL)


def test_dense_sharded_explicit_square_mesh(net):
    """The 2 x 2 mesh takes the diagonal re-injection."""
    j, t = _pair(net, "dense_sharded", shape=(2, 2),
                 axes=("data", "model"))
    np.testing.assert_allclose(_np(t.run(100)), _np(j.run(100)), **TOL)
    assert t.lower_run()["collectives"] == {"psum": 1, "psum_masked": 1}


@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_dense_sharded_square_mesh_matches_jax(net, precision):
    """The 2 x 2 mesh (the diagonal re-injection) through run_tol, ppr with
    Q padded to the mesh columns, and a landmark build, against the JAX
    tier on the same mesh shape."""
    from repro.pagerank import LandmarkIndex as JLandmarks
    from repro_torch.pagerank import LandmarkIndex
    j, t = _pair(net, "dense_sharded", precision, shape=(2, 2),
                 axes=("data", "model"))
    tr_, jr = t.run_tol(tol=1e-7, max_iters=500), j.run_tol(tol=1e-7,
                                                           max_iters=500)
    assert abs(int(tr_.iters) - int(jr.iters)) <= 1
    np.testing.assert_allclose(_np(tr_.pr), _np(jr.pr), **TOL)
    sets = [[3, 50], [120], [7, 8, 9]]
    np.testing.assert_allclose(_np(t.ppr(sets, n_iters=40)),
                               _np(j.ppr(sets, n_iters=40)), **TOL)
    lm = LandmarkIndex(t, n_hubs=8, n_iters=40)
    jlm = JLandmarks(j, n_hubs=8, n_iters=40)
    lm.build(0)
    jlm.build(0)
    assert np.array_equal(lm.hubs, jlm.hubs)
    np.testing.assert_allclose(lm._Y, np.asarray(jlm._Y), **TOL)


def test_ell_sharded_on_2d_mesh_flattens_axes(net):
    j, t = _pair(net, "ell_sharded", shape=(2, 4), axes=("data", "model"))
    assert t._axes == j._axes == ("data", "model")
    assert t.operands[0].spec == P(("data", "model"), None)
    np.testing.assert_allclose(_np(t.run(100)), _np(j.run(100)), **TOL)


def test_dense_sharded_rejects_1d_mesh(net):
    n, src, dst = net
    with pytest.raises(ValueError, match="2-D mesh"):
        TEngine(src, dst, n, backend="dense_sharded",
                mesh=tmesh((8,), ("shard",)))


def test_engine_mesh_and_device_must_agree(net):
    n, src, dst = net
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TEngine(src, dst, n, backend="ell_sharded", device="cuda",
                mesh=tmesh((2,), ("shard",)))
    eng = TEngine(src, dst, n, backend="ell_sharded", device="cpu",
                  mesh=tmesh((2,), ("shard",)))
    assert eng.device == torch.device("cpu")
    # no mesh: every visible device of the engine's kind, the CPU is one
    one = TEngine(src, dst, n, backend="dense_sharded", device="cpu")
    assert one.mesh.size == 1 and one.mesh.shape == {"row": 1, "col": 1}


@pytest.mark.parametrize("backend,shards", [("dense_sharded", 4),
                                            ("ell_sharded", 3)])
def test_default_mesh_places_shards_on_one_device(backend, shards):
    mesh = tengine.default_mesh(backend, "cpu", shards)
    assert mesh.size == shards
    assert set(mesh.device_list) == {torch.device("cpu")}
    if backend == "dense_sharded":
        assert mesh.shape == {"row": 2, "col": 2}
    else:
        assert mesh.shape == {"shard": 3}


@pytest.mark.parametrize("backend", SHARDED)
def test_sharded_run_makes_no_host_sync(net, backend):
    _, t = _pair(net, backend, "int8")
    with _NoSync():
        pr = t.run(5)
    assert pr.shape == (net[0],)


def test_lower_run_counts_the_schedule(net):
    """One iteration's collectives by kind, their bytes and the K2 calls,
    against the shapes: 2 x 4 dense (one bus psum carrying the leak, one
    global reshard, 8 shard products), 2 x 2 dense (psum + the masked
    diagonal psum, 4 products), ell (one all_gather, no K2)."""
    n = net[0]
    _, t = _pair(net, "dense_sharded")
    got = t.lower_run()
    assert got["collectives"] == {"psum": 1, "reshard": 1}
    assert got["k2_launches"] == {"f32,B=1": 8}
    # the bus psum: 8 partial row blocks of 100 plus the leak, float32
    assert got["bytes"]["psum"] == 8 * (n // 2 + 1) * 4
    assert got["devices"] == ["cpu"] * 8
    _, t = _pair(net, "dense_sharded", "bf16", shape=(2, 2),
                 axes=("data", "model"))
    got = t.lower_run()
    assert got["collectives"] == {"psum": 1, "psum_masked": 1}
    assert got["k2_launches"] == {"bf16,B=1": 4}
    assert got["bytes"]["psum_masked"] == 2 * (n // 2) * 4
    _, t = _pair(net, "ell_sharded")
    got = t.lower_run()
    assert got["collectives"] == {"all_gather": 1}
    assert got["k2_launches"] == {}
    with pytest.raises(ValueError, match="sharded"):
        TEngine(*net[1:], net[0], backend="dense", device="cpu").lower_run()


# --------------------------------------------------------------------------- #
# select_backend with the device topology                                     #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("n,density", [(5000, 0.004), (1000, 0.4),
                                       (200, 0.25), (500, 0.01)])
@pytest.mark.parametrize("n_devices", [2, 8])
def test_select_backend_device_count_dimension(n, density, n_devices):
    """More than one device picks the JAX package's sharded tier, on the
    CPU and on CUDA alike."""
    want = jengine.select_backend(n, density, device="cpu",
                                  n_devices=n_devices)
    assert want in SHARDED
    for device in ("cpu", "cuda"):
        assert tengine.select_backend(n, density, device=device,
                                      n_devices=n_devices) == want


def test_select_backend_default_device_count(monkeypatch):
    """The CPU counts as one device unless the caller says otherwise; on
    CUDA the default is torch.cuda.device_count()."""
    assert tengine.select_backend(5000, 0.004, device="cpu") == "ell"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tengine.select_backend(5000, 0.004) == "ell_sharded"
    assert tengine.select_backend(5000, 0.4, device="cuda") == \
        "dense_sharded"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tengine.select_backend(5000, 0.004) == "dense"


@pytest.mark.parametrize("n,density,want", [
    (1000, 0.001, "dense"), (5000, 0.001, "dense"), (5000, 0.5, "dense"),
    (10000, 0.001, "ell"), (10000, 0.05, "ell"), (10000, 0.2, "dense"),
    (50000, 0.0002, "ell")])
def test_select_backend_cuda_branch_follows_the_sweep(n, density, want):
    """One card: the ``dense`` tier up to N = 5000 at every density, and
    from density 0.2 above it; ``ell`` for the rest (the sweep's table in
    PERF.md)."""
    assert tengine.select_backend(n, density, device="cuda",
                                  n_devices=1) == want


def test_auto_engine_picks_sharded_tier(net):
    n, src, dst = net
    mesh = tmesh((8,), ("shard",))
    eng = TEngine(src, dst, n, mesh=mesh, metrics=treg.NullRegistry())
    jeng = JEngine(src, dst, n, metrics=jreg.NullRegistry())     # 8 devices
    assert eng.backend == jeng.backend in SHARDED
    assert eng.backend == tengine.select_backend(n, eng.density,
                                                 device="cpu", n_devices=8)


@pytest.mark.parametrize("backend", SHARDED)
def test_serve_query_engine_on_sharded_backend(net, backend):
    """PageRankQueryEngine flushes multi-user batches onto the mesh
    unchanged: the same top-5 as the JAX sharded serve, the scores within
    the JAX test's rtol 1e-4, atol 1e-7."""
    from repro.serve import PageRankQueryEngine as JQE
    from repro_torch.serve import PageRankQueryEngine as TQE
    j, t = _pair(net, backend)
    n = net[0]
    rng = np.random.default_rng(1)
    seed_sets = [rng.choice(n, size=2, replace=False) for _ in range(6)]
    qe = TQE(t, n_iters=40, max_batch=4)
    results = qe.query_batch(seed_sets, top_k=5)
    assert len(results) == 6 and not qe._queue
    ref = JQE(j, n_iters=40, max_batch=4).query_batch(seed_sets, top_k=5)
    for (idx, scores), (ridx, rscores) in zip(results, ref):
        np.testing.assert_array_equal(idx, ridx)
        np.testing.assert_allclose(scores, rscores, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("precision", ["f32", "int8"])
@pytest.mark.parametrize("backend", SHARDED)
def test_sharded_layout_carried_from_jax(net, backend, precision):
    """The JAX sharded tier's global arrays, carried across and cut over
    the port's mesh, equal the port's own build and run the same bits."""
    from repro_torch.pagerank.convert import layout_from_numpy
    j, t = _pair(net, backend, precision)
    arrays = {"operands": [np.asarray(o) for o in j.operands],
              "scales": None if j._scales is None else np.asarray(j._scales),
              "dang": np.asarray(j._dang)}
    with pytest.raises(ValueError, match="needs a mesh"):
        layout_from_numpy(backend, arrays, precision=precision,
                          device="cpu")
    lay = layout_from_numpy(backend, arrays, precision=precision,
                            mesh=t.mesh)
    for a, b in zip(lay["operands"], t.operands):
        assert a.spec == b.spec and torch.equal(a.full(), b.full())
    e = TEngine.from_layout(backend, lay, net[0], precision=precision,
                            metrics=treg.NullRegistry())
    assert e.layout == t.layout and e.layout_bytes == t.layout_bytes
    assert torch.equal(e.run(30), t.run(30))
