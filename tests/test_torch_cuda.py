"""PyTorch port on the card: the hand-written kernels (the fused step K1,
the streaming matvec K2, the BSR SpMV K3, the unpadded step K4 and the
``ell`` tier's split-ELL step) against their plain versions, the
wrappers' checks on CUDA tensors, the engine's fused, ``bsr`` and ``ell``
tiers (``run``, ``run_tol`` and batched PPR) with their launch counts, ``ops.pagerank_iteration``, one dynamic update per
patchable tier, the sharded mesh tiers on a mesh of the card against the
same calls on a CPU mesh (K2 at their shard shapes against its plain
version), the fabric simulator (hop mode, the full-width hop-mode matvec
and the tiled schedule) against its CPU run, the LM stack's token server
and a smoke train step against the CPU, the training path's
defaults, and a registry span's clock against the profiler's device
timeline.  K2 and K3 run at every batch
width of their kernels,
and a NaN in one query's x is held to that query.  K1 and K4 run at the
edges of their row-streaming core (one CTA's rows, fewer rows than SMs,
rows that are not 16-byte aligned, H at an element offset), a NaN in x
reaches every row, and 100 K1 steps replayed from a CUDA graph give the
eager bits.  The split-ELL step runs at every storage type with and
without its row counts, on a hub row over 16 chunks long, and repeats
bit for bit.  Every test here needs
a CUDA card and ``nvcc``; without a card each one skips with the reason
(they carry the ``cuda`` marker).
On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import fabric, isa, schedule
from repro_torch.core.convert import fabric_from_numpy, message_from_numpy
from repro_torch.graph.delta import GraphDelta, apply_delta, edge_keys
from repro_torch.graph.generators import protein_network
from repro_torch.graph.sparse import BSRMatrix
from repro_torch.graph.transition import build_transition_dense
from repro_torch.kernels import bsr_spmv as k3
from repro_torch.kernels import ell_step as ell
from repro_torch.kernels import ops
from repro_torch.kernels import pagerank_step as k1
from repro_torch.kernels import streaming_matvec as k2
from repro_torch.kernels.ref import (bsr_spmv_ref, pagerank_step_fused_ref,
                                     pagerank_step_ref, streaming_matvec_ref)
from repro_torch.launch.mesh import make_mesh
from repro_torch.obs.registry import NullRegistry
from repro_torch.pagerank import (DynamicPageRankEngine, LandmarkIndex,
                                  PageRankEngine)
from repro_torch.pagerank.dense import pagerank_dense_fixed
from repro_torch.pagerank.engine import (TIERS, _edge_set, _split_ell,
                                         _transition_csr)

pytestmark = pytest.mark.cuda

TOL32 = dict(rtol=1e-5, atol=5e-5)
# the same comparison scaled to PageRank's values: every yp is at least t
TIGHT = dict(rtol=1e-5, atol=1e-9)

STORE = {"f32": torch.float32, "bf16": torch.bfloat16,
         "f16": torch.float16, "int8": torch.int8}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(Np, Mp, precision, dev, seed=0):
    rng = np.random.default_rng(seed)
    H = rng.random((Np, Mp), dtype=np.float32) * (2.0 / Mp)
    scales = None
    if precision == "int8":
        s = (np.abs(H).max(axis=1) / 127.0).astype(np.float32)
        H = np.clip(np.rint(H / s[:, None]), -127, 127).astype(np.int8)
        scales = torch.from_numpy(s[None, :]).to(dev)
    Ht = torch.from_numpy(H).to(dev)
    if precision != "int8":
        Ht = Ht.to(STORE[precision])
    x = torch.from_numpy(rng.random((1, Mp), dtype=np.float32) / Mp).to(dev)
    dang = torch.from_numpy(
        (rng.random((1, Np)) < 0.05).astype(np.float32)).to(dev)
    return Ht, x, dang, torch.tensor(1e-4, device=dev), scales


@pytest.mark.parametrize("precision", list(STORE))
@pytest.mark.parametrize("Np,Mp", [(256, 256), (512, 768), (5120, 5120),
                                   (k1.ROWS_PER_CTA, 512)])
def test_kernel_matches_plain(cuda, Np, Mp, precision):
    Hp, xp, dangp, t, scales = _case(Np, Mp, precision, cuda)
    before = k1.launches[precision]
    yp, leak = k1.pagerank_step_fused(Hp, xp, dangp, t, scales)
    torch.cuda.synchronize()
    assert k1.launches[precision] == before + 1
    yr, lr = pagerank_step_fused_ref(Hp, xp, dangp, t, scales)
    torch.testing.assert_close(yp, yr, **TOL32)
    torch.testing.assert_close(leak, lr, **TOL32)
    torch.testing.assert_close(yp, yr, **TIGHT)
    torch.testing.assert_close(leak, lr, **TIGHT)
    again = k1.pagerank_step_fused(Hp, xp, dangp, t, scales)
    assert torch.equal(again[0], yp) and torch.equal(again[1], leak)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    Hp, xp, dangp, t, _ = _case(256, 256, "f32", cuda)
    bad = [
        (Hp.double(), xp, dangp, t, "storage dtype"),
        (Hp, xp.double(), dangp, t, "float32"),
        (Hp, xp.cpu(), dangp, t, "one CUDA device"),
        (Hp.t(), xp, dangp, t, "contiguous"),
        (Hp, xp[:, :128], dangp, t, "match"),
    ]
    for H, x, dg, tt, msg in bad:
        with pytest.raises(ValueError, match=msg):
            k1.pagerank_step_fused(H, x, dg, tt)


def test_engine_fused_tier_on_card(cuda):
    n = 1200
    src, dst = protein_network(n, seed=3)
    for precision in STORE:
        # the dense tier at the same precision: the same H and leak
        dense = PageRankEngine(src, dst, n, backend="dense",
                               precision=precision, device=cuda,
                               metrics=NullRegistry())
        ref = dense.run(100)
        eng = PageRankEngine(src, dst, n, backend="fused_dense",
                             precision=precision, device=cuda,
                             metrics=NullRegistry())
        before = k1.launches[precision]
        torch.cuda.set_sync_debug_mode("error")     # run() never syncs
        try:
            pr = eng.run(100)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        assert k1.launches[precision] == before + 100
        torch.testing.assert_close(pr, ref, rtol=1e-5, atol=1e-7)
        if precision == "f32":
            assert torch.equal(eng.run(100), pr)
            r = eng.run_tol(tol=1e-6)
            d = dense.run_tol(tol=1e-6)
            assert r.info.converged and abs(r.info.iters - d.info.iters) <= 1
        assert torch.isfinite(pr).all()


def _smv_case(N, M, B, precision, dev, seed=0):
    """W (N, M) and X (B, M) at PageRank's scale: W in [0, 2/M), X rows
    distributions; int8 as integers (their scales are the caller's)."""
    rng = np.random.default_rng(seed)
    W = rng.random((N, M), dtype=np.float32) * (2.0 / M)
    if precision == "int8":
        W = np.rint(W * (127.0 * M / 2.0)).astype(np.int8)
    Wt = torch.from_numpy(W).to(dev)
    if precision != "int8":
        Wt = Wt.to(STORE[precision])
    X = rng.random((B, M), dtype=np.float32)
    X /= X.sum(axis=1, keepdims=True)
    return Wt, torch.from_numpy(X).to(dev)


@pytest.mark.parametrize("precision", list(STORE))
@pytest.mark.parametrize("N,M,B", [(300, 130, 3), (256, 256, 1),
                                   (512, 768, 8), (5120, 5120, 1),
                                   (5120, 5120, 8), (5120, 5120, 64),
                                   (640, 384, 100)])
def test_streaming_matvec_matches_plain(cuda, N, M, B, precision):
    W, X = _smv_case(N, M, B, precision, cuda, seed=N + M + B)
    before = k2.launches[precision]
    Y = k2.streaming_matvec(W, X)
    torch.cuda.synchronize()
    assert k2.launches[precision] == before + 1
    assert Y.shape == (B, N) and Y.dtype == torch.float32
    ref = streaming_matvec_ref(W, X)
    torch.testing.assert_close(Y, ref, **TOL32)
    torch.testing.assert_close(Y, ref, **TIGHT)
    assert torch.equal(k2.streaming_matvec(W, X), Y)
    # a query's result does not depend on what shares its batch
    assert torch.equal(k2.streaming_matvec(W, X[:1].contiguous()), Y[:1])


# every padded batch width of K2 (8, 16, 32 and 64 queries per CTA), its
# ragged edge, and B past 64 (groups along the grid's y)
K2_BATCHES = (1, 2, 3, 7, 8, 9, 16, 33, 64, 65, 100)


@pytest.mark.parametrize("precision", list(STORE))
@pytest.mark.parametrize("N,M", [(5120, 5120), (1037, 1244)])
@pytest.mark.parametrize("B", K2_BATCHES)
def test_streaming_matvec_batch_widths(cuda, B, N, M, precision):
    """At the main path's layout and at a ragged one (N past a row block,
    M not a multiple of the 32-column group): the plain version's
    tolerances, bit-identical repeats, and the first, a middle and the last
    query alone equal to the same query in the batch."""
    W, X = _smv_case(N, M, B, precision, cuda, seed=N + M + B)
    Y = k2.streaming_matvec(W, X)
    torch.cuda.synchronize()
    ref = streaming_matvec_ref(W, X)
    torch.testing.assert_close(Y, ref, **TOL32)
    torch.testing.assert_close(Y, ref, **TIGHT)
    assert torch.equal(k2.streaming_matvec(W, X), Y)
    for q in sorted({0, B // 2, B - 1}):
        alone = k2.streaming_matvec(W, X[q:q + 1].contiguous())
        assert torch.equal(alone, Y[q:q + 1])


@pytest.mark.parametrize("precision", list(STORE))
@pytest.mark.parametrize("B", [5, 17, 65])
def test_streaming_matvec_nan_stays_in_its_query(cuda, B, precision):
    """A NaN in one query's X reaches every output of that query and no
    other: the split X tiles do not mix queries, and the zero-fill past B
    holds."""
    W, X = _smv_case(640, 768, B, precision, cuda, seed=B)
    clean = k2.streaming_matvec(W, X)
    for q in sorted({0, B // 2, B - 1}):
        Xn = X.clone()
        Xn[q, 300] = float("nan")
        Y = k2.streaming_matvec(W, Xn)
        torch.cuda.synchronize()
        nan = torch.isnan(Y)
        assert nan[q].all()
        others = torch.arange(B, device=cuda) != q
        assert not nan[others].any()
        assert torch.equal(Y[others], clean[others])


def test_streaming_matvec_rejects_what_the_kernel_does_not_take(cuda):
    W, X = _smv_case(256, 256, 4, "f32", cuda)
    flat = torch.empty(256 * 256 + 1, device=cuda)
    misaligned = flat[1:].view(256, 256)
    bad = [
        (W.double(), X, "storage dtype"),
        (W, X.double(), "float32"),
        (W, X.cpu(), "one CUDA device"),
        (W.t(), X, "contiguous"),
        (W, X[:, :128].contiguous(), "must be"),
        (misaligned, X, "aligned"),
        (W, torch.empty(4 * 256 + 1, device=cuda)[1:].view(4, 256),
         "aligned"),
    ]
    for w, x, msg in bad:
        with pytest.raises(ValueError, match=msg):
            k2.streaming_matvec(w, x)


def test_engine_fused_ppr_on_card(cuda):
    n = 1200
    src, dst = protein_network(n, seed=3)
    rng = np.random.default_rng(4)
    seed_sets = [rng.choice(n, size=rng.integers(1, 6), replace=False)
                 for _ in range(8)]
    for precision in STORE:
        dense = PageRankEngine(src, dst, n, backend="dense",
                               precision=precision, device=cuda,
                               metrics=NullRegistry())
        ref = dense.ppr(seed_sets, n_iters=100)
        eng = PageRankEngine(src, dst, n, backend="fused_dense",
                             precision=precision, device=cuda,
                             metrics=NullRegistry())
        before = k2.launches[precision]
        X = eng.ppr(seed_sets, n_iters=100)
        torch.cuda.synchronize()
        assert k2.launches[precision] == before + 100
        assert X.shape == (n, 8) and torch.isfinite(X).all()
        torch.testing.assert_close(X, ref, rtol=1e-5, atol=1e-7)
        assert torch.equal(eng.ppr(seed_sets, n_iters=100), X)
        if precision == "f32":
            torch.testing.assert_close(X.sum(dim=0),
                                       torch.ones(8, device=cuda),
                                       rtol=0, atol=1e-5)
            lm = LandmarkIndex(eng, n_hubs=16, tol=1e-7)
            A, info = lm.answer(seed_sets)
            exact = eng.ppr(seed_sets, n_iters=200).cpu().numpy()
            assert info["fallbacks"] == 0
            assert float(np.abs(A - exact).max()) <= 1e-5


def _bsr_case(n, bs, density, B, precision, dev, seed=0, empty_row=False):
    """A BSR layout of a random (n, n) matrix at PageRank's scale (entries
    in [0, 2/n)) and X (B, n) whose rows are distributions; int8 blocks
    as integers (their scales are the caller's)."""
    rng = np.random.default_rng(seed)
    A = rng.random((n, n), dtype=np.float32) * (2.0 / n)
    A[rng.random((n, n)) > density] = 0.0
    if empty_row:
        A[:bs] = 0.0                # block row 0 holds no block
    bsr = BSRMatrix.from_dense(A, bs=bs, device="cpu")
    blocks = bsr.blocks
    if precision == "int8":
        blocks = torch.round(blocks * (127.0 * n / 2.0)).to(torch.int8)
    else:
        blocks = blocks.to(STORE[precision])
    X = rng.random((B, n), dtype=np.float32)
    X /= X.sum(axis=1, keepdims=True)
    return (blocks.to(dev), bsr.block_cols.to(dev),
            torch.from_numpy(X).to(dev))


# every batch tile of the kernel (B up to 1, 2, 4, 8, 16, 32, 64) at both
# block sizes, partial tiles, and B past 64 (groups along the grid's y)
K3_BATCHES = [(n, bs, density, B, B % 2 == int(bs == 128))
              for n, bs, density in ((300, 32, 0.2), (384, 128, 0.1))
              for B in (2, 5, 16, 17, 32, 63, 65, 100)]


@pytest.mark.parametrize("precision", list(STORE))
@pytest.mark.parametrize("n,bs,density,B,empty", [
    (200, 32, 0.3, 1, False), (300, 32, 0.2, 8, True),
    (256, 128, 0.3, 1, False), (300, 128, 0.5, 64, False),
    (384, 128, 0.1, 100, True), (5000, 128, 0.02, 1, False),
    (5000, 128, 0.02, 8, False)] + K3_BATCHES)
def test_bsr_spmv_matches_plain(cuda, n, bs, density, B, empty, precision):
    blocks, cols, X = _bsr_case(n, bs, density, B, precision, cuda,
                                seed=n + bs + B, empty_row=empty)
    before = k3.launches[precision]
    Y = k3.bsr_spmv(blocks, cols, X)
    torch.cuda.synchronize()
    assert k3.launches[precision] == before + 1
    assert Y.shape == (B, blocks.shape[0] * bs) and Y.dtype == torch.float32
    ref = bsr_spmv_ref(blocks, cols, X)
    torch.testing.assert_close(Y, ref, **TOL32)
    torch.testing.assert_close(Y, ref, **TIGHT)
    assert torch.equal(k3.bsr_spmv(blocks, cols, X), Y)
    # a query's result does not depend on what shares its batch, and the
    # vector form is the batch form at B = 1
    y0 = k3.bsr_spmv(blocks, cols, X[0])
    assert torch.equal(k3.bsr_spmv(blocks, cols, X[:1].contiguous())[0], y0)
    assert torch.equal(Y[0], y0)
    if empty:
        assert torch.equal(Y[:, :bs], torch.zeros_like(Y[:, :bs]))


def test_bsr_spmv_propagates_nan_in_block_zero(cuda):
    """Padded slots point at block column 0 and are accumulated: a NaN in
    x block 0 reaches every row that has a padded slot, as on the TPU."""
    A = np.zeros((256, 256), np.float32)
    A[:128, 128:] = 1.0             # block row 0: one block, at column 1
    A[128:, :] = 1.0                # block row 1: two blocks
    bsr = BSRMatrix.from_dense(A, bs=128, max_blocks=2, device=cuda)
    x = torch.ones(256, device=cuda)
    x[3] = float("nan")
    y = k3.bsr_spmv(bsr.blocks, bsr.block_cols, x)
    assert torch.isnan(y).all()     # row 0's padded slot reads block 0


@pytest.mark.parametrize("precision", list(STORE))
@pytest.mark.parametrize("B", [5, 17, 65])
def test_bsr_spmv_nan_stays_in_its_query(cuda, B, precision):
    """A NaN in one query's x reaches that query's rows that read its
    block column, and no other query: the staged x tiles do not mix
    queries, and the zero-fill past B holds."""
    blocks, cols, X = _bsr_case(384, 128, 0.3, B, precision, cuda, seed=B)
    bs = blocks.shape[2]
    clean = k3.bsr_spmv(blocks, cols, X)
    # rows whose block row has a slot at block column 1
    reads = (cols == 1).any(dim=1).repeat_interleave(bs)
    assert reads.any()
    for q in sorted({0, B // 2, B - 1}):
        Xn = X.clone()
        Xn[q, bs + 72] = float("nan")
        Y = k3.bsr_spmv(blocks, cols, Xn)
        torch.cuda.synchronize()
        nan = torch.isnan(Y)
        assert torch.equal(nan[q], reads)
        others = torch.arange(B, device=cuda) != q
        assert not nan[others].any()
        assert torch.equal(Y[others], clean[others])


def test_bsr_spmv_rejects_what_the_kernel_does_not_take(cuda):
    blocks, cols, X = _bsr_case(256, 128, 0.3, 2, "f32", cuda)
    bad = [
        (blocks.double(), cols, X, "storage dtype"),
        (blocks, cols.long(), X, "int32"),
        (blocks, cols, X.double(), "float32"),
        (blocks, cols, X.cpu(), "one CUDA device"),
        (blocks.transpose(2, 3), cols, X, "contiguous"),
        (torch.zeros((1, 1, 6, 6), device=cuda),
         torch.zeros((1, 1), dtype=torch.int32, device=cuda),
         torch.ones(6, device=cuda), "multiple of 4"),
    ]
    for b, c, x, msg in bad:
        with pytest.raises(ValueError, match=msg):
            k3.bsr_spmv(b, c, x)


@pytest.mark.parametrize("precision", list(STORE))
@pytest.mark.parametrize("N,M", [(300, 130), (257, 1001), (1000, 1000),
                                 (5000, 5000), (7, 130), (5, 1), (9, 3),
                                 (300, 5001)])
def test_pagerank_step_matches_plain(cuda, N, M, precision):
    rng = np.random.default_rng(N + M)
    H = rng.random((N, M), dtype=np.float32) * (2.0 / M)
    if precision == "int8":
        Ht = torch.from_numpy(np.rint(H * (127.0 * M / 2.0)).astype(np.int8))
    else:
        Ht = torch.from_numpy(H).to(STORE[precision])
    Ht = Ht.to(cuda)
    pr = torch.from_numpy(rng.dirichlet(np.ones(M)).astype(np.float32)).to(
        cuda)
    t = torch.tensor(0.15 / N, device=cuda)
    before = k1.step_launches[precision]
    y = k1.pagerank_step(Ht, pr, t, d=0.85)
    torch.cuda.synchronize()
    assert k1.step_launches[precision] == before + 1
    assert y.shape == (N,) and y.dtype == torch.float32
    ref = pagerank_step_ref(Ht, pr, t, d=0.85)
    torch.testing.assert_close(y, ref, **TOL32)
    torch.testing.assert_close(y, ref, **TIGHT)
    assert torch.equal(k1.pagerank_step(Ht, pr, t, d=0.85), y)
    # the one-element load path (pr not 16-byte aligned) gives the same
    # values within the tolerance
    flat = torch.empty(M + 1, device=cuda)
    flat[1:] = pr
    torch.testing.assert_close(k1.pagerank_step(Ht, flat[1:], t, d=0.85),
                               ref, **TIGHT)
    # H as a view at an element offset (rows off their 16-byte alignment)
    store = torch.empty(N * M + 1, dtype=Ht.dtype, device=cuda)
    Hv = store[1:].view(N, M)
    Hv.copy_(Ht)
    y_off = k1.pagerank_step(Hv, pr, t, d=0.85)
    torch.testing.assert_close(y_off, ref, **TIGHT)
    assert torch.equal(k1.pagerank_step(Hv, pr, t, d=0.85), y_off)


@pytest.mark.parametrize("precision", list(STORE))
@pytest.mark.parametrize("kernel,N,M", [("K1", 512, 768), ("K4", 1000, 1000),
                                        ("K4", 257, 1001)])
def test_step_nan_in_x_reaches_every_row(cuda, kernel, N, M, precision):
    """A NaN in one entry of x reaches every row, padded ones included
    (0 * NaN is NaN), as in the plain version."""
    H, x, dang, t, scales = _case(N, M, precision, cuda, seed=N + M)
    x[0, M // 3] = float("nan")
    if kernel == "K1":
        y, leak = k1.pagerank_step_fused(H, x, dang, t, scales)
        ref, ref_leak = pagerank_step_fused_ref(H, x, dang, t, scales)
        assert torch.isnan(leak) and torch.isnan(ref_leak)
    else:
        y = k1.pagerank_step(H, x[0], t)
        ref = pagerank_step_ref(H, x[0], t)
    torch.cuda.synchronize()
    assert torch.isnan(ref).all()
    assert torch.isnan(y).all()


@pytest.mark.parametrize("precision", list(STORE))
def test_fused_steps_replayed_from_a_graph_match_eager(cuda, precision):
    """100 K1 steps with the leak fed back, as run(100) takes them, give
    the same bits replayed from a CUDA graph (twice) as eagerly."""
    n = 512
    Hp, xp, dangp, t, scales = _case(n, n, precision, cuda, seed=7)

    def steps(x, tt):
        for _ in range(100):
            x, leak = k1.pagerank_step_fused(Hp, x, dangp, tt, scales)
            tt = 0.85 * leak / n + 0.15 / n
        return x, tt

    want = steps(xp, t)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        steps(xp, t)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = steps(xp, t)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_pagerank_iteration_loop_on_card(cuda):
    """quickstart's loop: 100 ops.pagerank_iteration steps at N = 1200
    against pagerank_dense_fixed, one K4 launch per step."""
    n = 1200
    src, dst = protein_network(n, seed=1)
    H = PageRankEngine(src, dst, n, backend="dense", device=cuda,
                       metrics=NullRegistry()).operands[0]
    pr = torch.full((n,), 1.0 / n, device=cuda)
    before = k1.step_launches["f32"]
    for _ in range(100):
        pr = ops.pagerank_iteration(H, pr)
    torch.cuda.synchronize()
    assert k1.step_launches["f32"] == before + 100
    torch.testing.assert_close(pr, pagerank_dense_fixed(H, n_iters=100),
                               rtol=1e-4, atol=1e-7)


def test_engine_bsr_tier_on_card(cuda):
    n = 1200
    src, dst = protein_network(n, seed=3)
    rng = np.random.default_rng(4)
    seed_sets = [rng.choice(n, size=rng.integers(1, 6), replace=False)
                 for _ in range(8)]
    for precision in STORE:
        dense = PageRankEngine(src, dst, n, backend="dense",
                               precision=precision, device=cuda,
                               metrics=NullRegistry())
        eng = PageRankEngine(src, dst, n, backend="bsr",
                             precision=precision, device=cuda,
                             metrics=NullRegistry())
        before = k3.launches[precision]
        pr = eng.run(100)
        torch.cuda.synchronize()
        assert k3.launches[precision] == before + 100
        torch.testing.assert_close(pr, dense.run(100), rtol=1e-5, atol=1e-7)
        before = k3.launches[precision]
        X = eng.ppr(seed_sets, n_iters=100)
        torch.cuda.synchronize()
        assert k3.launches[precision] == before + 100
        torch.testing.assert_close(X, dense.ppr(seed_sets, n_iters=100),
                                   rtol=1e-5, atol=1e-7)
        if precision == "f32":
            r, d = eng.run_tol(tol=1e-6), dense.run_tol(tol=1e-6)
            assert r.info.converged and abs(r.info.iters - d.info.iters) <= 1


# --------------------------------------------------------------------- #
# the ell tier's split-ELL kernel                                       #
# --------------------------------------------------------------------- #
def _ell_graphs():
    """Graphs for the split-ELL kernel: two hub rows past k0, empty rows
    and dangling vertices; a protein network; a hub row whose overflow
    spans four chunks; no overflow at all."""
    rng = np.random.default_rng(30)
    n = 300
    s = np.concatenate([rng.integers(0, 250, 1500),
                        rng.integers(0, 250, 250)])
    d = np.concatenate([rng.integers(20, n, 1500), np.full(180, 7),
                        np.full(70, 11)])
    ps, pd = protein_network(400, seed=12)
    hub = rng.choice(60_000, 12_000, replace=False)
    zs = rng.integers(0, 70_000, 50_000)
    zd = (rng.zipf(1.6, 50_000) - 1) % 70_000
    return {"hubs": (s, d, n, None), "protein": (ps, pd, 400, 3),
            "chunks": (np.concatenate([zs, hub]),
                       np.concatenate([zd, np.full(12_000, 5)]), 70_000,
                       None),
            "no_overflow": (s, d, n, 400)}


def _ell_engine(src, dst, n, device, **kw):
    return PageRankEngine(src, dst, n, backend="ell", device=device,
                          metrics=NullRegistry(), **kw)


def _rank_like(n, seed, device):
    x = torch.from_numpy(np.random.default_rng(seed).random(n)).float()
    return (x / x.sum()).to(device)


def _f64_steps(eng, n_iters):
    """``n_iters`` steps from the uniform vector in float64 on the
    engine's own operands: the exact sums the float32 steps round, in the
    caller's ids (the operands are in the engine's ``vertex_order``)."""
    ops = tuple(o.double() if o.is_floating_point() else o
                for o in eng.operands)
    dang, n, ell = eng._dang.double(), eng.n, TIERS["ell"]
    x = torch.full((n,), 1.0 / n, dtype=torch.float64, device=dang.device)
    for _ in range(n_iters):
        x = eng.d * (ell.product(ops, x) + torch.sum(x * dang) / n) \
            + (1.0 - eng.d) / n
    order = eng.vertex_order
    return x if order is None else torch.empty_like(x).index_copy_(0, order,
                                                                   x)


@pytest.mark.parametrize("precision", list(STORE))
def test_ell_step_kernel_matches_its_plain_version(cuda, precision):
    """One step of the kernel against its plain version on the same card
    tensors (rtol 1e-5, atol 1e-7), the new vector and its leak, on every
    graph with the metadata's counts and as a carried layout without
    them; a second call gives the same bits."""
    for case, (src, dst, n, ell_k) in _ell_graphs().items():
        eng = _ell_engine(src, dst, n, cuda, ell_k=ell_k,
                          precision=precision)
        x = _rank_like(n, n, cuda)
        leak = torch.sum(x * eng._dang)
        for meta in (eng._ell_meta, eng._ell_meta._replace(counts=None)):
            args = (eng.operands, meta, eng._dang, x, leak)
            new, lk = ell.ell_step(*args, d=eng.d)
            want, want_lk = ell.ell_step_ref(*args, d=eng.d)
            torch.cuda.synchronize()
            torch.testing.assert_close(new, want, rtol=1e-5, atol=1e-7,
                                       msg=case)
            torch.testing.assert_close(lk, want_lk, rtol=1e-5, atol=1e-7,
                                       msg=case)
            again = ell.ell_step(*args, d=eng.d)
            assert torch.equal(again[0], new) and torch.equal(again[1], lk)
            assert int(meta.ticket) == 0


@pytest.mark.parametrize("precision", list(STORE))
def test_ell_tier_runs_on_its_kernel(cuda, precision):
    """``run(10)`` on the card launches one step's kernels ten times,
    repeats bit for bit (no atomics), and matches the same steps in
    float64 (rtol 1e-5, atol 1e-7); ``run_tol`` repeats bit for bit and,
    in float32, stops within an iteration of the CPU engine's."""
    src, dst, n, _ = _ell_graphs()["chunks"]
    eng = _ell_engine(src, dst, n, cuda, precision=precision)
    cpu = _ell_engine(src, dst, n, "cpu", precision=precision)
    x = _rank_like(n, 1, cuda)
    before = ell.launches[precision]
    ell.ell_step(eng.operands, eng._ell_meta, eng._dang, x,
                 torch.sum(x * eng._dang), d=eng.d)
    per_step = ell.launches[precision] - before
    assert per_step == 2
    before = ell.launches[precision]
    pr = eng.run(10)
    torch.cuda.synchronize()
    assert ell.launches[precision] - before == 10 * per_step
    assert torch.equal(eng.run(10), pr)
    torch.testing.assert_close(pr.double(), _f64_steps(eng, 10), rtol=1e-5,
                               atol=1e-7)
    r = eng.run_tol(tol=1e-6, max_iters=200)
    assert torch.equal(eng.run_tol(tol=1e-6, max_iters=200)[0], r[0])
    if precision == "f32":
        c = cpu.run_tol(tol=1e-6, max_iters=200)
        assert r.info.converged and abs(r.info.iters - c.info.iters) <= 1


@pytest.mark.parametrize("precision", list(STORE))
def test_ell_kernel_on_a_power_law_graph(cuda, precision):
    """About 3 M entries with a hub row of some 190,000 overflow entries
    (over 16 chunks): ``run(10)`` against the same ten steps in float64 on
    the same operands (rtol 1e-5, atol 1e-7)."""
    rng = np.random.default_rng(31)
    n = 200_000
    src = rng.integers(0, n - 1000, 3_000_000)
    dst = (rng.zipf(1.4, 3_000_000) * 7919) % n
    eng = _ell_engine(src, dst, n, cuda, precision=precision)
    ptr = eng._ell_meta.ov_ptr.long()
    assert int(ptr.diff().max()) > 16 * ell.CHUNK
    torch.testing.assert_close(eng.run(10).double(), _f64_steps(eng, 10),
                               rtol=1e-5, atol=1e-7)


def _identity_ordered(src, dst, n, dev):
    """An ``ell`` engine of the graph in the caller's ids, carried in
    through ``from_layout`` from the split ELL of the unordered edges (no
    row counts: the kernel reads all k0 slots)."""
    edges = _edge_set(src, dst, n, dev).on_device
    ops, _, _ = _split_ell(_transition_csr(edges, n))
    layout = {"operands": ops, "dang": (edges.outdeg == 0).float(),
              "scales": None}
    return PageRankEngine.from_layout("ell", layout, n, device=dev,
                                      metrics=NullRegistry())


@pytest.mark.parametrize("precision", list(STORE))
def test_ell_kernel_on_an_ordered_layout(cuda, precision):
    """On the 3 M-entry power-law graph, whose layout is in degree order:
    one step of the kernel against its plain version (rtol 1e-5, atol
    1e-7), two ``run(10)`` bit for bit, and, in float32, ``run(10)``'s
    ranks within an L1 of 1.5e-5 (the benchmark's ``l1_gap`` limit) of an
    engine of the same graph in the caller's ids."""
    rng = np.random.default_rng(31)
    n = 200_000
    src = rng.integers(0, n - 1000, 3_000_000)
    dst = (rng.zipf(1.4, 3_000_000) * 7919) % n
    eng = _ell_engine(src, dst, n, cuda, precision=precision)
    order = eng.vertex_order
    assert order is not None and order.device.type == cuda.type
    assert not torch.equal(order, torch.arange(n, device=cuda))
    x = _rank_like(n, 5, cuda)
    args = (eng.operands, eng._ell_meta, eng._dang, x,
            torch.sum(x * eng._dang))
    new, lk = ell.ell_step(*args, d=eng.d)
    want, want_lk = ell.ell_step_ref(*args, d=eng.d)
    torch.testing.assert_close(new, want, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(lk, want_lk, rtol=1e-5, atol=1e-7)
    pr = eng.run(10)
    assert torch.equal(eng.run(10), pr)
    if precision == "f32":
        ident = _identity_ordered(src, dst, n, cuda)
        assert ident.vertex_order is None
        assert float(torch.sum(torch.abs(pr - ident.run(10)))) <= 1.5e-5


def _split_engine(src, dst, n, devices, **kw):
    mesh = make_mesh((len(devices),), ("shard",), devices)
    return PageRankEngine(src, dst, n, backend="ell_split_sharded",
                          mesh=mesh, metrics=NullRegistry(), **kw)


@pytest.mark.parametrize("precision", list(STORE))
def test_ell_step_kernel_on_a_block_of_rows(cuda, precision):
    """The block form: every block of an ``ell_split_sharded`` layout on
    four positions of the card, stepped against the whole vector with the
    leak handed in as the blocks' four parts, written into its rows of a
    longer vector and its slot of the parts, against the plain version
    (rtol 1e-5, atol 1e-7); the rows outside the block stay untouched and
    a second call gives the same bits."""
    for case, (src, dst, n, ell_k) in _ell_graphs().items():
        eng = _split_engine(src, dst, n, [cuda] * 4, ell_k=ell_k,
                            precision=precision)
        spans = list(zip(eng._rows[:-1], eng._rows[1:]))
        x = _rank_like(n, n, cuda)
        parts = torch.stack([torch.sum(x[a:b] * dg)
                             for (a, b), dg in zip(spans, eng._dang)])
        for p, (a, b) in enumerate(spans):
            args = (eng.operands[p], eng._ell_meta[p], eng._dang[p], x, parts)
            new = torch.zeros(n, device=cuda)
            lk = torch.zeros(4, device=cuda)
            ell.ell_step(*args, d=eng.d, out=(new[a:b], lk[p:p + 1]))
            want, want_lk = ell.ell_step_ref(*args, d=eng.d)
            torch.cuda.synchronize()
            torch.testing.assert_close(new[a:b], want, rtol=1e-5, atol=1e-7,
                                       msg=case)
            torch.testing.assert_close(lk[p], want_lk, rtol=1e-5, atol=1e-7,
                                       msg=case)
            assert not new[:a].any() and not new[b:].any()
            assert int(torch.count_nonzero(lk)) <= 1
            again, again_lk = ell.ell_step(*args, d=eng.d)
            assert torch.equal(again, new[a:b]) and torch.equal(again_lk,
                                                                lk[p])


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_ell_split_sharded_tier_on_the_card(cuda, precision):
    """``run(10)`` and ``run_tol`` of the tier on four positions of the
    card against the same tier on four CPU positions (the plain version;
    rtol 1e-5, atol 1e-7; ``run_tol(1e-6)``'s steps within 1 in f32) and,
    in f32, against the ``ell`` tier; two launches a block and step; two
    ``run(10)`` give the same bits."""
    src, dst, n, _ = _ell_graphs()["chunks"]
    eng = _split_engine(src, dst, n, [cuda] * 4, precision=precision)
    cpu = _split_engine(src, dst, n, ["cpu"] * 4, precision=precision)
    before = ell.launches[precision]
    got = eng.run(10)
    assert ell.launches[precision] - before == 2 * 10 * 4
    torch.testing.assert_close(got.cpu(), cpu.run(10), rtol=1e-5, atol=1e-7)
    assert torch.equal(eng.run(10), got)
    r = eng.run_tol(1e-6, max_iters=200)
    rc = cpu.run_tol(1e-6, max_iters=200)
    torch.testing.assert_close(r[0].cpu(), rc[0], rtol=1e-5, atol=1e-7)
    if precision == "f32":
        # the reduced storages stall near their residual floor, where two
        # summation orders stop at different steps (as on the ell tier)
        assert r.info.converged and abs(r.info.iters - rc.info.iters) <= 1
        one = _ell_engine(src, dst, n, cuda)
        torch.testing.assert_close(got, one.run(10), rtol=1e-5, atol=1e-7)


def test_ell_step_rejects_what_the_kernel_does_not_take(cuda):
    src, dst, n, _ = _ell_graphs()["hubs"]
    eng = _ell_engine(src, dst, n, cuda)
    x = _rank_like(n, 2, cuda)
    leak = torch.sum(x * eng._dang)
    with pytest.raises(ValueError, match="one CUDA device"):
        ell.ell_step(eng.operands, eng._ell_meta, eng._dang.cpu(), x, leak)
    with pytest.raises(ValueError, match="float32"):
        ell.ell_step(eng.operands, eng._ell_meta, eng._dang, x.double(),
                     leak)
    data, idx, *rest = eng.operands
    with pytest.raises(ValueError, match="int32"):
        ell.ell_step((data, idx.long(), *rest), eng._ell_meta, eng._dang, x,
                     leak)
    strided = data.t().contiguous().t()
    with pytest.raises(ValueError, match="contiguous"):
        ell.ell_step((strided, idx, *rest), eng._ell_meta, eng._dang, x,
                     leak)


@pytest.mark.parametrize("backend", ["dense", "ell", "fused_dense", "bsr"])
def test_dynamic_update_on_card(cuda, backend):
    """One push update per patchable tier, held to a from-scratch solve
    (L1 <= 1e-5); the fused push launches K2 once per issued sweep plus
    once for its start residual, the bsr push K3."""
    n = 1200
    src, dst = protein_network(n, seed=5)
    dyn = DynamicPageRankEngine(src, dst, n, backend=backend, device=cuda,
                                metrics=NullRegistry())
    dyn.run_tol(1e-7, max_iters=500)
    have = set(edge_keys(src, dst, n).tolist())
    blocks = (set(dyn._bsr_pairs.tolist()) if backend == "bsr" else None)
    rng = np.random.default_rng(6)
    pairs = []
    while len(pairs) < 3:
        u, v = (int(x) for x in rng.integers(0, n, 2))
        if u == v or u * n + v in have or v * n + u in have:
            continue
        if blocks is not None and not {
                (v // 128) * dyn._bsr_nbc + u // 128,
                (u // 128) * dyn._bsr_nbc + v // 128} <= blocks:
            continue            # an in-block insert: the bsr tier patches
        pairs.append((u, v))
    iu, iv = np.array(pairs).T
    delta = GraphDelta(iu, iv, src[:2], dst[:2])
    counts = {"fused_dense": k2.launches, "bsr": k3.launches}.get(backend)
    before = None if counts is None else counts["f32"]
    pr, info = dyn.update(delta)
    torch.cuda.synchronize()
    assert info.strategy == "push" and info.healthy
    if counts is not None:
        issued = -(-info.iters // 8) * 8
        assert counts["f32"] - before == 1 + issued
    s2, d2 = apply_delta(src, dst, delta, n)
    ref = PageRankEngine(s2, d2, n, backend="dense", device=cuda,
                         metrics=NullRegistry()).run(300)
    assert float(torch.sum(torch.abs(pr - ref))) <= 1e-5


# --------------------------------------------------------------------- #
# the sharded mesh tiers on a mesh of the card                          #
# --------------------------------------------------------------------- #
SHARD_MESHES = {"dense_sharded": ((2, 2), ("row", "col")),
                "ell_sharded": ((4,), ("shard",))}


def _shard_mesh(backend, device):
    shape, axes = SHARD_MESHES[backend]
    return make_mesh(shape, axes, [device] * int(np.prod(shape)))


# the shard-local products of dense_sharded at N = 5000: 2 x 2 tiles at
# B = 1, 1 x 4 tiles (1250 columns, padded by the wrapper), and the PPR row
# blocks with Q / C queries (8 or 64 queries over 2 or 4 mesh columns)
@pytest.mark.parametrize("precision", list(STORE))
@pytest.mark.parametrize("N,M,B", [(2500, 2500, 1), (5000, 1250, 1),
                                   (2500, 5000, 4), (2500, 5000, 32),
                                   (5000, 5000, 2), (5000, 5000, 16)])
def test_streaming_matvec_at_shard_shapes(cuda, N, M, B, precision):
    W, X = _smv_case(N, M, B, precision, cuda, seed=N + M + B)
    Y = k2.streaming_matvec(W, X)
    torch.cuda.synchronize()
    ref = streaming_matvec_ref(W, X)
    torch.testing.assert_close(Y, ref, **TOL32)
    torch.testing.assert_close(Y, ref, **TIGHT)
    assert torch.equal(k2.streaming_matvec(W, X), Y)


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("backend", list(SHARD_MESHES))
def test_sharded_tier_on_card_matches_cpu(cuda, backend, precision):
    """run, run_tol and ppr on a mesh of the card against the same calls on
    a CPU mesh of the same shape (rtol 1e-5, atol 1e-7, iterations within
    1); dense_sharded launches K2 once per shard per iteration."""
    n = 1000
    src, dst = protein_network(n, seed=3)
    kw = dict(backend=backend, precision=precision, metrics=NullRegistry())
    card = PageRankEngine(src, dst, n, mesh=_shard_mesh(backend, cuda), **kw)
    cpu = PageRankEngine(src, dst, n, mesh=_shard_mesh(backend, "cpu"), **kw)
    tiles = 4 if backend == "dense_sharded" else 0
    before = k2.batch_launches[precision, 1]
    pr = card.run(50)
    torch.cuda.synchronize()
    assert k2.batch_launches[precision, 1] - before == tiles * 50
    assert pr.device.type == "cuda"
    torch.testing.assert_close(pr.cpu(), cpu.run(50), rtol=1e-5, atol=1e-7)
    r, c = card.run_tol(tol=1e-7), cpu.run_tol(tol=1e-7)
    assert abs(r.info.iters - c.info.iters) <= 1
    torch.testing.assert_close(r.pr.cpu(), c.pr, rtol=1e-5, atol=1e-7)
    sets = [[3, 50], [120], [7, 8, 9], [400]]
    before = k2.batch_launches[precision, 2]
    X = card.ppr(sets, n_iters=40)
    torch.cuda.synchronize()
    assert k2.batch_launches[precision, 2] - before == tiles * 40
    torch.testing.assert_close(X.cpu(), cpu.ppr(sets, n_iters=40),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("backend", list(SHARD_MESHES))
def test_sharded_landmarks_on_card_match_cpu(cuda, backend):
    """A 16-hub landmark build and the push of one answer on a mesh of the
    card (dense_sharded: K2 on the row blocks of H) against the same on a
    CPU mesh: the hubs and sweeps equal, the columns and answers within
    rtol 1e-5, atol 1e-7."""
    n = 1000
    src, dst = protein_network(n, seed=3)
    got = {}
    for dev in (cuda, "cpu"):
        eng = PageRankEngine(src, dst, n, backend=backend,
                             mesh=_shard_mesh(backend, dev),
                             metrics=NullRegistry())
        lm = LandmarkIndex(eng, n_hubs=16, tol=1e-7, n_iters=60,
                           metrics=NullRegistry())
        lm.build(0)
        X, info = lm.answer([[3, 50], [120], [7, 8, 9]])
        got[str(dev)] = (lm.hubs, lm._Y, X, info)
    (h, Y, X, info), (hc, Yc, Xc, infoc) = got.values()
    assert np.array_equal(h, hc) and info["sweeps"] == infoc["sweeps"]
    np.testing.assert_allclose(Y, Yc, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(X, Xc, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("backend", list(SHARD_MESHES))
def test_sharded_dynamic_update_on_card(cuda, backend):
    """A push update on a mesh of the card, written into the shards that
    own the change, held to a from-scratch solve (L1 <= 1e-5)."""
    n = 1200
    src, dst = protein_network(n, seed=5)
    dyn = DynamicPageRankEngine(src, dst, n, backend=backend,
                                mesh=_shard_mesh(backend, cuda),
                                metrics=NullRegistry())
    dyn.run_tol(1e-7, max_iters=500)
    have = set(edge_keys(src, dst, n).tolist())
    rng = np.random.default_rng(6)
    pairs = []
    while len(pairs) < 3:
        u, v = (int(x) for x in rng.integers(0, n, 2))
        if u != v and u * n + v not in have and v * n + u not in have:
            pairs.append((u, v))
    iu, iv = np.array(pairs).T
    delta = GraphDelta(iu, iv, src[:2], dst[:2])
    pr, info = dyn.update(delta)
    torch.cuda.synchronize()
    assert info.strategy == "push" and info.healthy
    assert all(s.device.type == "cuda" for o in dyn.operands
               for s in o.shards)
    s2, d2 = apply_delta(src, dst, delta, n)
    ref = PageRankEngine(s2, d2, n, backend="dense", device=cuda,
                         metrics=NullRegistry()).run(300)
    assert float(torch.sum(torch.abs(pr - ref))) <= 1e-5


# --------------------------------------------------------------------- #
# non-finite input: the resilient path's watchdog verdicts rest on it   #
# --------------------------------------------------------------------- #
POISON = {"nan": float("nan"), "inf": float("inf"), "huge": 1e4}


def _poison_cases(places, int8_places=("x",)):
    """(precision, kind, place) triples: an int8 H holds no NaN, Inf or
    1e4, so int8 is poisoned in x (and in K1's row scales)."""
    return [(p, k, place) for p in STORE for k in POISON
            for place in (int8_places if p == "int8" else places)]


def _plant(t, idx, val):
    """Write ``val`` at ``idx`` of a tensor in its storage dtype."""
    t[idx] = torch.tensor(val, dtype=torch.float32).to(t.dtype)


def _same_nonfinite(y, ref, what):
    """The kernel's isfinite mask equals the plain version's entry by
    entry, and its finite entries meet TOL32.  Values where both are
    non-finite may differ: K2's split of an Inf takes Inf - Inf, NaN."""
    fin = torch.isfinite(y)
    assert torch.equal(fin, torch.isfinite(ref)), what
    torch.testing.assert_close(y[fin], ref[fin], **TOL32, msg=what)


@pytest.mark.parametrize("precision,kind,place", _poison_cases(
    ("H", "pad", "x"), int8_places=("x", "scales", "pad_scales")))
def test_fused_step_nonfinite_matches_plain(cuda, precision, kind, place):
    """K1 with a NaN, an Inf or 1e4 in H, in a padded row of H (or of the
    int8 row scales), or in x: the plain version's isfinite mask, and a
    non-finite leak whenever any yp is, the padded rows included (0 * NaN
    and 0 * Inf are NaN)."""
    Np, Mp, n, m = 512, 768, 475, 747
    Hp, xp, dangp, t, scales = _case(Np, Mp, precision, cuda, seed=13)
    Hp[n:], Hp[:, m:] = 0, 0
    xp[0, m:], dangp[0, n:] = 0, 0
    val = POISON[kind]
    if place == "H":
        _plant(Hp, (n // 2, m // 3), val)
    elif place == "pad":
        _plant(Hp, (Np - 3, m // 3), val)       # a padded row of H
    elif place == "x":
        _plant(xp, (0, m // 3), val)
    elif place == "scales":
        _plant(scales, (0, n // 2), val)
    else:
        _plant(scales, (0, Np - 3), val)        # a padded row's scale
    yp, leak = k1.pagerank_step_fused(Hp, xp, dangp, t, scales)
    torch.cuda.synchronize()
    yr, lr = pagerank_step_fused_ref(Hp, xp, dangp, t, scales)
    _same_nonfinite(yp, yr, f"K1 {precision} {kind} in {place}")
    _same_nonfinite(leak.reshape(1), lr.reshape(1), "K1 leak")
    if not torch.isfinite(yp).all():
        assert not torch.isfinite(leak)
    if kind != "huge" and place in ("pad", "pad_scales"):
        assert not torch.isfinite(yp[0, Np - 3]) and not torch.isfinite(leak)


@pytest.mark.parametrize("B", [1, 8, 64])
@pytest.mark.parametrize("precision,kind,place", _poison_cases(("H", "x")))
def test_streaming_matvec_nonfinite_matches_plain(cuda, precision, kind,
                                                  place, B):
    W, X = _smv_case(640, 768, B, precision, cuda, seed=B + 29)
    if place == "H":
        _plant(W, (100, 300), POISON[kind])
    else:
        _plant(X, (B - 1, 300), POISON[kind])
    Y = k2.streaming_matvec(W, X)
    torch.cuda.synchronize()
    _same_nonfinite(Y, streaming_matvec_ref(W, X),
                    f"K2 {precision} B={B} {kind} in {place}")


@pytest.mark.parametrize("B", [1, 8, 64])
@pytest.mark.parametrize("precision,kind,place",
                         _poison_cases(("H", "pad", "x")))
def test_bsr_spmv_nonfinite_matches_plain(cuda, precision, kind, place, B):
    """K3 with a NaN, an Inf or 1e4 in a real block, in a padded slot (a
    zero block at block column 0, accumulated like any other) or in x."""
    n, bs = 384, 128
    rng = np.random.default_rng(B + 31)
    A = rng.random((n, n), dtype=np.float32) * (2.0 / n)
    A[:bs, bs:] = 0.0               # block row 0: one block, two padded
    bsr = BSRMatrix.from_dense(A, bs=bs, device="cpu")
    assert bsr.blocks.shape[1] == 3 and int(bsr.block_cols[0, 2]) == 0
    blocks = bsr.blocks
    if precision == "int8":
        blocks = torch.round(blocks * (127.0 * n / 2.0)).to(torch.int8)
    else:
        blocks = blocks.to(STORE[precision])
    blocks, cols = blocks.to(cuda), bsr.block_cols.to(cuda)
    X = torch.from_numpy(rng.dirichlet(np.ones(n), size=B).astype(
        np.float32)).to(cuda)
    if place == "H":
        _plant(blocks, (1, 1, 5, 7), POISON[kind])
    elif place == "pad":
        _plant(blocks, (0, 2, 5, 7), POISON[kind])
    else:
        _plant(X, (B - 1, 7), POISON[kind])
    Y = k3.bsr_spmv(blocks, cols, X)
    torch.cuda.synchronize()
    ref = bsr_spmv_ref(blocks, cols, X)
    _same_nonfinite(Y, ref, f"K3 {precision} B={B} {kind} in {place}")
    if place == "pad" and kind != "huge":
        assert not torch.isfinite(Y[:, 5]).any()


@pytest.mark.parametrize("precision,kind,place", _poison_cases(("H", "x")))
def test_pagerank_step_nonfinite_matches_plain(cuda, precision, kind,
                                               place):
    W, X = _smv_case(1000, 1000, 1, precision, cuda, seed=37)
    x = X[0].clone()
    if place == "H":
        _plant(W, (400, 300), POISON[kind])
    else:
        _plant(x, (300,), POISON[kind])
    t = torch.tensor(0.15 / 1000, device=cuda)
    y = k1.pagerank_step(W, x, t, d=0.85)
    torch.cuda.synchronize()
    _same_nonfinite(y, pagerank_step_ref(W, x, t, d=0.85),
                    f"K4 {precision} {kind} in {place}")


# --------------------------------------------------------------------- #
# the fabric simulator on the card, against its CPU run                 #
# --------------------------------------------------------------------- #
def _msgs(rng, shape, n_sites, live):
    op = rng.integers(1, 11, shape).astype(np.int32)
    op[rng.random(shape) >= live] = isa.NOP
    return {"opcode": op,
            "dest": rng.integers(0, n_sites, shape).astype(np.int32),
            "value": (rng.uniform(0.5, 2.0, shape)
                      * rng.choice([-1.0, 1.0], shape)).astype(np.float32),
            "next_opcode": rng.integers(1, 11, shape).astype(np.int32),
            "next_dest": rng.integers(0, n_sites, shape).astype(np.int32)}


def _tree(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: _tree(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, tuple):
        return tuple(_tree(o) for o in obj)
    return obj.cpu()


def _same_bits(a, b, path="state"):
    if isinstance(a, dict):
        for k in a:
            _same_bits(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, tuple):
        for i, (x, y) in enumerate(zip(a, b)):
            _same_bits(x, y, f"{path}[{i}]")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, path
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), path


@pytest.mark.parametrize("rows,cols,seed", [(4, 4, 0), (8, 9, 1), (64, 65, 2)])
def test_fabric_hop_mode_matches_cpu(cuda, rows, cols, seed):
    """A random programmed state with messages on every wire and random
    injections at both edges: every cycle's wires, the final state and the
    conflict count on the card equal the CPU run's bit for bit."""
    rng = np.random.default_rng(seed)
    n, T = rows * cols, 12
    start = {"values": (rng.uniform(0.5, 2.0, (rows, cols))
                        * rng.choice([-1.0, 1.0], (rows, cols))
                        ).astype(np.float32),
             "next_opcode": rng.integers(1, 11, (rows, cols)).astype(np.int32),
             "next_dest": rng.integers(0, n, (rows, cols)).astype(np.int32),
             "right": _msgs(rng, (rows, cols), n, 0.5),
             "down": _msgs(rng, (rows, cols), n, 0.5),
             "conflicts": np.zeros((), np.int32)}
    left, top = (_msgs(rng, (T, k), n, 0.7) for k in (rows, cols))
    card, cpu = (_tree(fabric.run(
        fabric_from_numpy(start, device=dev),
        message_from_numpy(left, device=dev),
        message_from_numpy(top, device=dev), extra_cycles=rows + cols))
        for dev in (cuda, torch.device("cpu")))
    _same_bits(card, cpu)
    assert int(card[0]["conflicts"]) > 0


def test_fabric_matvec_hop_mode_full_width(cuda):
    """The whole 64 x 65 fabric loaded by Prog messages: 0 conflicts, 67
    steps, equal to fast mode at rtol 1e-6 and to the CPU run's bits."""
    rng = np.random.default_rng(41)
    A = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    slow = schedule.matvec(A.to(cuda), b.to(cuda), use_messages=True)
    fast = schedule.matvec(A.to(cuda), b.to(cuda))
    assert slow.state.device.type == "cuda" and slow.state.shape == (64, 65)
    assert int(slow.state.conflicts) == 0 and slow.steps == fast.steps == 67
    torch.testing.assert_close(slow.result, fast.result, rtol=1e-6, atol=0)
    cpu = schedule.matvec(A, b, use_messages=True)
    _same_bits(_tree(slow.state), _tree(cpu.state))


@pytest.mark.parametrize("n,iters", [(130, 20), (300, 10)])
def test_fabric_pagerank_tiled_matches_cpu(cuda, n, iters):
    src, dst = protein_network(n, seed=1)
    H = build_transition_dense(src, dst, n, device="cpu")
    got = schedule.pagerank_tiled(H.to(cuda), n_iters=iters)
    want = schedule.pagerank_tiled(H, n_iters=iters)
    assert got.result.device.type == "cuda" and got.steps == want.steps
    torch.testing.assert_close(got.result.cpu(), want.result, rtol=1e-6,
                               atol=0)
    torch.testing.assert_close(
        got.result, pagerank_dense_fixed(H.to(cuda), iters), rtol=1e-4,
        atol=1e-7)


def test_fabric_creators_default_to_the_card(cuda):
    assert fabric.Fabric.create(4, 4).device.type == "cuda"
    assert isa.Message.make(isa.PROG, 5, 10.1).value.device.type == "cuda"
    m = isa.from_hex("00f44121999a0051")
    assert m.opcode.device.type == "cuda"
    assert isa.to_hex(m) == "00f44121999a0051"


# --------------------------------------------------------------------------- #
# the LM stack (no kernel of its own): the card by default.  chip_smoke.py's  #
# phase 3i holds the ten smoke configs on the card to their CPU runs          #
# --------------------------------------------------------------------------- #
def test_lm_serving_defaults_to_the_card(cuda):
    """init_params, init_cache, ssm_decode_init and rope_frequencies
    default to the card; the token server on the card gives the CPU's
    greedy tokens."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import layers, ssm
    from repro_torch.models import model as M
    from repro_torch.serve import ServeEngine
    cfg = get_smoke_config("llama3-8b")
    lm = M.init_params(cfg, 0)
    assert all(p.device.type == "cuda" for p in lm.parameters())
    assert M.init_cache(cfg, 1, 8)["k"].device.type == "cuda"
    state = ssm.ssm_decode_init(get_smoke_config("mamba2-2.7b"), 1)
    assert all(t.device.type == "cuda" for t in state)
    assert layers.rope_frequencies(16, 1e4).device.type == "cuda"
    host = M.init_params(cfg, 0, device="cpu")
    card = M.init_params(cfg, 0, device="cpu").to(cuda)   # moves in place
    prompt = np.array([3, 1, 4, 1, 5], np.int32)
    card_out = ServeEngine(cfg, card).generate(prompt, 12)
    assert card_out == ServeEngine(cfg, host).generate(prompt, 12)


# --------------------------------------------------------------------------- #
# the LM training path (no kernel of its own): the card by default, and a    #
# smoke train step on the card against the CPU.  chip_smoke.py's phase 3j     #
# holds all ten smoke configs and trains internlm2-1.8b at full width         #
# --------------------------------------------------------------------------- #
def test_lm_training_defaults_to_the_card(cuda, tmp_path):
    """make_train_state, make_batch, the data iterator, restore and the
    launcher default to the card."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataIterator, make_batch
    from repro_torch.launch import train as lm_train
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import make_train_state
    cfg = get_smoke_config("internlm2-1.8b")
    params, opt = make_train_state(cfg, 0)
    tensors = (list(params.parameters()) + list(opt.m.parameters())
               + list(opt.ef.parameters()) + [opt.step])
    assert all(t.device.type == "cuda" for t in tensors)
    shape = ShapeConfig("t", 8, 2, "train")
    assert make_batch(cfg, shape, 0)["tokens"].device.type == "cuda"
    assert next(DataIterator(cfg, shape))["tokens"].device.type == "cuda"
    ckpt.save(str(tmp_path), 1, {"opt": opt})
    back, _, _ = ckpt.restore(str(tmp_path), {"opt": opt})
    assert back["opt"].step.device.type == "cuda"
    res = lm_train.run(["--arch", "internlm2-1.8b", "--smoke", "--steps",
                        "2"])
    assert np.isfinite(res["final_loss"])
    host, _ = make_train_state(cfg, 0, device="cpu")
    with pytest.raises(ValueError):       # a CPU model, the card's flags
        lm_train.run(["--arch", "internlm2-1.8b", "--smoke"], model=host)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "olmoe-1b-7b",
                                  "zamba2-2.7b"])
def test_lm_train_step_on_card_matches_cpu(cuda, arch):
    """One train_step of a smoke config from the same weights and batch:
    the loss, the gradient norm and every gradient leaf on the card within
    the CPU-vs-JAX tolerances of tests/train_parity.py (TF32 off), on
    tests/train_batch.py's fixed-seed batch."""
    from train_batch import batch as fixed_batch
    from repro_torch.configs import get_smoke_config
    from repro_torch.train import (OptimizerConfig, init_opt_state, loss_fn,
                                   make_train_state, train_step)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = get_smoke_config(arch)
        host, _ = make_train_state(cfg, 0, device="cpu")
        card, _ = make_train_state(cfg, 0, device="cpu")
        card = card.to("cuda")
        batch = fixed_batch(cfg)
        got = {}
        for name, model in (("cpu", host), ("cuda", card)):
            b = {k: torch.from_numpy(v).to(name) for k, v in batch.items()}
            total, _ = loss_fn(model, b, cfg)
            total.backward()
            grads = [p.grad.cpu().numpy() for p in model.parameters()]
            _, _, m = train_step(model, init_opt_state(model), b, cfg,
                                 OptimizerConfig(warmup_steps=2,
                                                 total_steps=10))
            got[name] = (float(m["loss"]), float(m["grad_norm"]), grads)
        (hl, hn, hg), (dl, dn, dg) = got["cpu"], got["cuda"]
        assert dl == pytest.approx(hl, rel=1e-5)
        assert dn == pytest.approx(hn, rel=1e-4)
        for a, b in zip(hg, dg, strict=True):
            assert np.all(np.isfinite(b))
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-3 * max(
                float(np.abs(a).max()), 1e-30))
        assert all(p.grad is None for p in card.parameters())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


# --------------------------------------------------------------------------- #
# the LM stack on the mesh (no kernel of its own): the expert-parallel MoE   #
# on a mesh of the card against the same mesh on the CPU, and the train      #
# launcher's host mesh.  chip_smoke.py's phase 3k serves olmoe-1b-7b at full #
# width on a 1 x 4 mesh of the card and trains it on a 2 x 4 one             #
# --------------------------------------------------------------------------- #
def _moe_case(arch):
    """olmoe's or granite-moe's smoke MoE weights and an (8, 16, D) x, from
    numpy seed 0 at each leaf's init std."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import moe
    cfg = get_smoke_config(arch)
    rng = np.random.default_rng(0)
    params = {k: (rng.standard_normal(s.shape) * s.std()).astype(np.float32)
              for k, s in moe.moe_specs(cfg).items()}
    x = rng.standard_normal((8, 16, cfg.d_model)).astype(np.float32)
    return cfg, params, x


@pytest.mark.parametrize("rules", ["DEFAULT_RULES", "INFERENCE_RULES"])
@pytest.mark.parametrize("shape", [(2, 4), (1, 4)], ids=["2x4", "1x4"])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "granite-moe-3b-a800m"])
def test_moe_ep_on_a_mesh_of_the_card_matches_the_cpu_mesh(cuda, arch,
                                                           shape, rules):
    """moe_ep's output, aux loss, dropped fraction and gradients on a mesh
    whose every position is the card, against the same mesh on the CPU,
    within the CPU-vs-JAX tolerances of tests/test_torch_moe_ep.py; a
    repeated forward and backward on the card is bit-equal."""
    from repro_torch.models import moe_ep
    from repro_torch.sharding import partition as P_
    cfg, params, x = _moe_case(arch)
    got = {}
    for name in ("cpu", "cuda:0", "cuda:0 again"):
        dev = name.split()[0]
        mesh = make_mesh(shape, ("data", "model"),
                         [dev] * (shape[0] * shape[1]))
        tp = {k: torch.tensor(v, device=dev, requires_grad=True)
              for k, v in params.items()}
        tx = torch.tensor(x, device=dev, requires_grad=True)
        with P_.use_mesh(mesh, getattr(P_, rules)):
            y, aux = moe_ep.moe_ep(tp, tx, cfg)
        assert y.device == torch.device(dev)
        ((y.float() ** 2).sum() + aux["aux_loss"]).backward()
        got[name] = ([y.detach()] + [tp[k].grad for k in sorted(tp)]
                     + [tx.grad], float(aux["aux_loss"].detach()),
                     float(aux["dropped_frac"]))
    (host, haux, hdrop), (card, daux, ddrop) = got["cpu"], got["cuda:0"]
    torch.testing.assert_close(card[0].cpu(), host[0], rtol=1e-5,
                               atol=1e-6 * float(host[0].abs().max()))
    assert daux == pytest.approx(haux, rel=1e-6) and ddrop == hdrop
    for a, b in zip(host[1:], card[1:], strict=True):
        torch.testing.assert_close(b.cpu(), a, rtol=0,
                                   atol=1e-5 * float(a.abs().max()))
    again = got["cuda:0 again"]
    assert all(torch.equal(a, b) for a, b in zip(card, again[0]))
    assert again[1:] == (daux, ddrop)


def test_train_launcher_builds_its_mesh_of_the_cards(cuda, monkeypatch):
    """devices=None takes every visible card (one card: no mesh); a mesh
    of 4 positions on the card prints the same losses as the same mesh on
    the CPU, from the same weights."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import train as lm_train
    from repro_torch.train import make_train_state
    seen = []
    build = lm_train.make_host_mesh

    def spy(devices):
        mesh = build(devices)
        seen.append(mesh)
        return mesh

    monkeypatch.setattr(lm_train, "make_host_mesh", spy)
    argv = ["--arch", "olmoe-1b-7b", "--smoke", "--batch", "8", "--seq",
            "16", "--steps", "3", "--log-every", "1"]
    assert np.isfinite(lm_train.run(argv)["final_loss"])
    assert seen[-1].device_list == [
        torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    cfg = get_smoke_config("olmoe-1b-7b")
    losses = {}
    for dev in ("cpu", "cuda:0"):
        model, _ = make_train_state(cfg, 0, device="cpu")
        losses[dev] = lm_train.run(argv, model=model.to(dev),
                                   devices=[dev] * 4)["final_loss"]
        assert seen[-1].shape == {"data": 4, "model": 1}
    assert losses["cuda:0"] == pytest.approx(losses["cpu"], abs=1e-3)


def test_dry_run_predicts_the_card_train_step(cuda):
    """internlm2-1.8b smoke ``train`` on a 1 x 1 mesh: the dry run's
    argument bytes equal the bytes of the real state and batch on the
    card, and its dot FLOPs those counted over one real step."""
    from repro_torch.configs import ShapeConfig, get_smoke_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch import dryrun
    from repro_torch.train import make_train_state
    cfg = get_smoke_config("internlm2-1.8b")
    shape = ShapeConfig("train", 64, 4, "train")
    axes = ("data", "model")
    meta, card = make_mesh((1, 1), axes, ["meta"]), make_mesh((1, 1), axes,
                                                              [cuda])
    rules = dryrun.cell_rules(meta, "train")
    fn, args, specs = dryrun.build_cell(cfg, shape, meta)
    pred = dryrun.measure(fn, args, specs, meta, rules)
    params, opt = make_train_state(cfg, 0, compression="none", device=cuda)
    batch = make_batch(cfg, shape, 0, device=cuda)
    real = dryrun.measure(fn, (params, opt, batch), specs, card, rules)
    state = [p for p in params.parameters()] + [opt.step] + list(
        opt.m.parameters()) + list(opt.v.parameters()) + list(batch.values())
    assert all(t.is_cuda for t in state)
    assert pred.argument_bytes == sum(t.numel() * t.element_size()
                                      for t in state) == real.global_bytes
    assert real.counter.dot_flops == pred.counter.dot_flops > 0
    assert real.counter.n_dots == pred.counter.n_dots
    assert torch.isfinite(real.out[2]["loss"])


def test_a_span_encloses_its_kernel_on_the_profile_clock(cuda):
    """The registry's span records (``time.monotonic_ns``) and the
    profiler's device timeline share one clock once the profile's start
    (wall clock) is placed on ``monotonic_ns``: each of two spans, 2 ms of
    host sleep on either side of a synchronized matmul, encloses its own
    kernel and not the other's."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs.registry import MetricsRegistry
    reg = MetricsRegistry()
    a = torch.randn(2048, 2048, device=cuda)
    (a @ a).sum().item()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for name in ("first", "second"):
            with reg.span(name):
                time.sleep(0.002)
                a @ a
                torch.cuda.synchronize()
                time.sleep(0.002)
    start = (prof.profiler.kineto_results.trace_start_ns()
             - (time.time_ns() - time.monotonic_ns()))
    kernels = sorted((start + e.time_range.start * 1000,
                      start + e.time_range.end * 1000)
                     for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False))
    spans = [(r["start_ns"], r["end_ns"]) for r in reg.span_records]
    inside = [[s + 1_000_000 < ks < ke < e - 1_000_000 for s, e in spans]
              for ks, ke in kernels]
    assert kernels and all(sum(row) == 1 for row in inside)
    assert all(any(col) for col in zip(*inside))
