"""PyTorch port, the block-sparse tier on the CPU: the ELL and BSR
containers and builders against ``repro.graph`` (bit for bit), the BSR
kernel's plain version against the JAX Pallas kernel in interpret mode and
against ``BSRMatrix.matvec`` at the sweep shapes of tests/test_kernels.py,
the query batch, int8 ``ops.spmv``, and the engine's ``bsr`` tier
(``run``, ``run_tol``, ``ppr``, ``LandmarkIndex.answer``) against the JAX
``bsr`` tier at all four precisions.  The CUDA kernel itself is held
against the same plain version on the card (``chip_smoke.py``,
``tests/test_torch_cuda.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph import generators as jgen
from repro.graph import sparse as jsparse
from repro.graph import transition as jtr
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.bsr_spmv import bsr_spmv as jbsr_spmv
from repro.obs import registry as jreg
from repro.pagerank import PageRankEngine as JEngine
from repro.pagerank.landmarks import LandmarkIndex as JLandmarks
from repro_torch.graph import sparse as tsparse
from repro_torch.graph import transition as ttr
from repro_torch.kernels import ops as tops
from repro_torch.kernels import bsr_spmv as tbsr
from repro_torch.kernels import ref as tref
from repro_torch.obs import registry as treg
from repro_torch.pagerank import LandmarkIndex, PageRankEngine
from repro_torch.pagerank import engine as tengine

PRECISIONS = ("f32", "bf16", "f16", "int8")
# kernel vs oracle, f32 accumulation in another order (tests/test_kernels)
TOL32 = dict(rtol=1e-5, atol=5e-5)
# engine vs reference (tests/test_pagerank_engine.py)
TOL = dict(rtol=1e-5, atol=1e-7)
# |sum - 1| slack per storage tier (tests/test_precision.py)
SUM_TOL = {"f32": 1e-5, "bf16": 0.06, "f16": 0.01, "int8": 0.2}
# landmark answer vs the JAX answer (tests/test_serve_accel.py:183-189)
LM_ATOL = 1e-5
N = 200
SEED_SETS = [[3, 50], [120], [7, 7, 9], [199], [0, 1, 2, 3, 4]]


@pytest.fixture(scope="module")
def net():
    src, dst = jgen.protein_network(N, seed=7)
    assert int(jtr.dangling_mask(src, N).sum()) > 0
    return src, dst


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _sparse_case(n, density, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n)).astype(np.float32)
    A[rng.random(size=A.shape) > density] = 0.0
    return A, rng.normal(size=n).astype(np.float32)


# --------------------------------------------------------------------- #
# containers and builders, bit for bit                                  #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("bs,max_blocks", [(32, None), (128, None),
                                           (64, 2)])
def test_bsr_from_dense_bit_identical(bs, max_blocks):
    A, _ = _sparse_case(200, 0.02, seed=bs)
    A[:64] = 0.0                    # an empty block row at bs <= 64
    j = jsparse.BSRMatrix.from_dense(A, bs=bs, max_blocks=max_blocks)
    t = tsparse.BSRMatrix.from_dense(A, bs=bs, max_blocks=max_blocks,
                                     device="cpu")
    assert np.array_equal(t.blocks.numpy(), np.asarray(j.blocks))
    assert np.array_equal(t.block_cols.numpy(), np.asarray(j.block_cols))
    assert t.block_cols.dtype == torch.int32
    assert (t.shape, t.block_size, t.max_blocks) == (
        j.shape, j.block_size, j.max_blocks)
    if max_blocks is None:
        np.testing.assert_array_equal(t.todense().numpy(), A)


@pytest.mark.parametrize("k", [None, 3])
def test_ell_from_csr_bit_identical(net, k):
    src, dst = net
    j = jtr.build_transition_ell(src, dst, N, k=k)
    t = ttr.build_transition_ell(src, dst, N, k=k, device="cpu")
    assert np.array_equal(t.data.numpy(), np.asarray(j.data))
    assert np.array_equal(t.indices.numpy(), np.asarray(j.indices))
    assert t.k == j.k and t.shape == j.shape
    np.testing.assert_array_equal(t.todense().numpy(),
                                  np.asarray(j.todense()))
    x = np.random.default_rng(0).random(N).astype(np.float32)
    np.testing.assert_allclose(t.matvec(torch.from_numpy(x)).numpy(),
                               np.asarray(j.matvec(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("bs", [32, 128])
def test_build_transition_bsr_bit_identical(net, bs):
    src, dst = net
    j = jtr.build_transition_bsr(src, dst, N, bs=bs)
    t = ttr.build_transition_bsr(src, dst, N, bs=bs, device="cpu")
    assert np.array_equal(t.blocks.numpy(), np.asarray(j.blocks))
    assert np.array_equal(t.block_cols.numpy(), np.asarray(j.block_cols))
    assert t.row_scales is None and t.shape == (N, N)
    # the unfixed H: dangling columns are zero
    np.testing.assert_array_equal(
        t.todense().numpy(),
        np.asarray(jtr.build_transition_dense(src, dst, N,
                                              fix_dangling=False)))


# --------------------------------------------------------------------- #
# K3's plain version                                                    #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("n,bs,density", [
    (256, 128, 0.3), (384, 128, 0.1), (512, 128, 0.05),
    (200, 128, 0.2),            # padded rows
    (256, 256, 0.3),
])
def test_bsr_spmv_ref_matches_pallas_and_container(n, bs, density):
    A, x = _sparse_case(n, density, seed=n)
    jb = jsparse.BSRMatrix.from_dense(A, bs=bs)
    tb = tsparse.BSRMatrix.from_dense(A, bs=bs, device="cpu")
    got = tref.bsr_spmv_ref(tb.blocks, tb.block_cols, torch.from_numpy(x))
    assert got.shape == (tb.blocks.shape[0] * bs,)
    kernel = np.asarray(jbsr_spmv(jb.blocks, jb.block_cols,
                                  jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), kernel, **TOL32)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jref.bsr_spmv_ref(jb.blocks, jb.block_cols,
                                                  jnp.asarray(x))), **TOL32)
    np.testing.assert_allclose(got.numpy()[:n],
                               np.asarray(jb.matvec(jnp.asarray(x))),
                               rtol=1e-4, atol=1e-4)
    # the wrapper on CPU tensors is the plain version
    assert torch.equal(tbsr.bsr_spmv(tb.blocks, tb.block_cols,
                                     torch.from_numpy(x)), got)
    np.testing.assert_allclose(tb.matvec(torch.from_numpy(x)).numpy(),
                               A @ x, rtol=2e-4, atol=2e-4)


def test_bsr_empty_rows():
    """Block-rows with zero stored blocks produce exact zeros."""
    A = np.zeros((256, 256), np.float32)
    A[:128, :128] = 1.0
    tb = tsparse.BSRMatrix.from_dense(A, bs=128, device="cpu")
    y = tops.spmv(tb, torch.ones(256))
    np.testing.assert_allclose(y[:128].numpy(), 128.0, rtol=1e-6)
    assert torch.equal(y[128:], torch.zeros(128))


def test_bsr_spmv_batch_axis():
    """Queries as rows: every row of the batch is its own vector product,
    and the batch equals the JAX container's (M, Q) matmat, transposed."""
    A, _ = _sparse_case(300, 0.1, seed=5)
    tb = tsparse.BSRMatrix.from_dense(A, bs=128, device="cpu")
    jb = jsparse.BSRMatrix.from_dense(A, bs=128)
    X = np.random.default_rng(6).random((5, 300)).astype(np.float32)
    Y = tbsr.bsr_spmv(tb.blocks, tb.block_cols, torch.from_numpy(X))
    assert Y.shape == (5, 384)
    for q in range(5):
        np.testing.assert_allclose(
            Y[q].numpy(),
            tref.bsr_spmv_ref(tb.blocks, tb.block_cols,
                              torch.from_numpy(X[q])).numpy(), **TOL32)
    np.testing.assert_allclose(Y[:, :300].numpy().T,
                               np.asarray(jb.matmat(jnp.asarray(X.T))),
                               **TOL32)
    # ops.spmv takes the container's (M, Q) layout
    np.testing.assert_allclose(tops.spmv(tb, torch.from_numpy(X.T)).numpy(),
                               Y[:, :300].numpy().T, rtol=0, atol=0)
    with pytest.raises(ValueError, match="block_cols"):
        tbsr.bsr_spmv(tb.blocks, tb.block_cols[:, :1], torch.from_numpy(X))


@pytest.mark.parametrize("precision", PRECISIONS)
def test_ops_spmv_matches_jax(net, precision):
    """ops.spmv on the engine's prepared layout at every precision (int8
    with its row scales applied after the kernel) against JAX ops.spmv
    (Pallas in interpret mode) on the same layout."""
    src, dst = net
    j = JEngine(src, dst, N, backend="bsr", precision=precision,
                metrics=jreg.NullRegistry())
    t = PageRankEngine(src, dst, N, backend="bsr", precision=precision,
                       device="cpu", metrics=treg.NullRegistry())
    jb, tb = j.operands[0], t.operands[0]
    assert (tb.row_scales is None) == (precision != "int8")
    x = np.random.default_rng(1).dirichlet(np.ones(N)).astype(np.float32)
    got = tops.spmv(tb, torch.from_numpy(x)).numpy()
    want = np.asarray(jops.spmv(jb, jnp.asarray(x), interpret=True))
    assert got.shape == want.shape == (N,)
    np.testing.assert_allclose(got, want, **TOL32)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)


# --------------------------------------------------------------------- #
# the bsr tier against the JAX bsr tier                                 #
# --------------------------------------------------------------------- #
def _pair(net, precision, **kw):
    src, dst = net
    j = JEngine(src, dst, N, backend="bsr", precision=precision,
                metrics=jreg.NullRegistry(), **kw)
    t = PageRankEngine(src, dst, N, backend="bsr", precision=precision,
                       device="cpu", metrics=treg.NullRegistry(), **kw)
    return j, t


@pytest.mark.parametrize("precision", PRECISIONS)
def test_bsr_tier_layout_matches_jax(net, precision):
    j, t = _pair(net, precision)
    for a, b in zip(jax.tree_util.tree_leaves(j.operands),
                    t.operands[0].tensors()):
        assert np.array_equal(_np(b), _np(a))
    assert t.layout == j.layout
    assert t.layout_bytes == j.layout_bytes
    assert torch.equal(t._dang, torch.from_numpy(np.array(j._dang)))


@pytest.mark.parametrize("precision", PRECISIONS)
def test_bsr_tier_run_run_tol_ppr_match_jax(net, precision):
    j, t = _pair(net, precision)
    pr = t.run(100)
    assert pr.shape == (N,) and pr.dtype == torch.float32
    np.testing.assert_allclose(pr.numpy(), np.asarray(j.run(100)), **TOL)
    assert abs(float(pr.sum()) - 1.0) <= SUM_TOL[precision]
    jr = j.run_tol(tol=1e-7, max_iters=300)
    tr_ = t.run_tol(tol=1e-7, max_iters=300)
    assert abs(int(tr_.iters) - int(jr.iters)) <= 1
    assert tr_.info.status == jr.info.status == "converged"
    np.testing.assert_allclose(tr_.pr.numpy(), np.asarray(jr.pr), rtol=1e-4,
                               atol=1e-7)
    X = t.ppr(SEED_SETS, n_iters=60)
    assert X.shape == (N, len(SEED_SETS))
    np.testing.assert_allclose(X.numpy(), np.asarray(j.ppr(SEED_SETS,
                                                           n_iters=60)),
                               **TOL)


def test_bsr_tier_other_block_size(net):
    j, t = _pair(net, "f32", bsr_block_size=32)
    assert tuple(t.operands[0].blocks.shape) == tuple(
        j.operands[0].blocks.shape)
    np.testing.assert_allclose(t.run(50).numpy(), np.asarray(j.run(50)),
                               **TOL)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_bsr_landmark_answer_matches_jax(net, precision):
    j, t = _pair(net, precision)
    jl = JLandmarks(j, n_hubs=16, tol=1e-7, n_iters=60,
                    metrics=jreg.NullRegistry())
    tl = LandmarkIndex(t, n_hubs=16, tol=1e-7, n_iters=60,
                       metrics=treg.NullRegistry())
    sets = SEED_SETS[:3]
    JX, jinfo = jl.answer(sets)
    TX, tinfo = tl.answer(sets)
    assert TX.shape == (N, 3)
    assert tinfo["fallbacks"] == jinfo["fallbacks"]
    assert tinfo["paths"] == jinfo["paths"]
    assert abs(tinfo["sweeps"] - jinfo["sweeps"]) <= 1
    np.testing.assert_allclose(TX, np.asarray(JX), rtol=0, atol=LM_ATOL)


def test_bsr_tier_goes_through_the_bsr_kernel(net, monkeypatch):
    """One K3 call per iteration of run and ppr (all queries in one), and
    one per landmark push sweep, through the wrapper ops.spmv reaches."""
    _, t = _pair(net, "f32")
    calls = []
    real = tops.bsr_spmv

    def spy(blocks, cols, x):
        calls.append(tuple(x.shape))
        return real(blocks, cols, x)

    monkeypatch.setattr(tops, "bsr_spmv", spy)
    t.run(7)
    assert calls == [(N,)] * 7
    calls.clear()
    t.ppr(SEED_SETS, n_iters=5)
    assert calls == [(len(SEED_SETS), N)] * 5
    calls.clear()
    lm = LandmarkIndex(t, n_hubs=4, n_iters=5, metrics=treg.NullRegistry())
    lm.build()
    calls.clear()
    _, info = lm.answer(SEED_SETS[:2])
    # the start residual plus whole chunks of masked sweeps, 2 queries
    assert len(calls) == 1 + -(-info["sweeps"] // 8) * 8
    assert set(calls) == {(2, N)}


def test_select_backend_keeps_ell_for_sparse_graphs_on_cuda():
    """The port has the bsr tier, but on one card the auto policy never
    picks it: the density sweep (scripts/backend_sweep.py, PERF.md) found
    bsr fastest in no cell.  Sparse graphs above N = 5000 keep ell; up to
    N = 5000 the dense tier won at every density swept."""
    assert tengine.select_backend(10000, 0.0016, device="cuda",
                                  n_devices=1) == "ell"
    assert tengine.select_backend(5000, 0.0016, device="cuda",
                                  n_devices=1) == "dense"
    assert "bsr" in tengine.BACKENDS
    assert all(tengine.select_backend(n, p, device="cuda", n_devices=1)
               != "bsr" for n in (300, 5000, 10000, 50000)
               for p in (0.0005, 0.001, 0.02, 0.1, 0.5))
