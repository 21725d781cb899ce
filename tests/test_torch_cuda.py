"""PyTorch port on the card: the hand-written fused-step and streaming
matvec kernels against their plain versions, the wrappers' checks on CUDA
tensors, and the engine's fused tier (``run`` and batched PPR).  Every
test here needs a CUDA card and ``nvcc``; without a card each one skips
with the reason (they carry the ``cuda`` marker).
On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.graph.generators import protein_network
from repro_torch.kernels import pagerank_step as k1
from repro_torch.kernels import streaming_matvec as k2
from repro_torch.kernels.ref import (pagerank_step_fused_ref,
                                     streaming_matvec_ref)
from repro_torch.obs.registry import NullRegistry
from repro_torch.pagerank import LandmarkIndex, PageRankEngine

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
@pytest.mark.parametrize("Np,Mp", [(256, 256), (512, 768), (5120, 5120)])
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
