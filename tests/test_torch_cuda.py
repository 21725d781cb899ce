"""PyTorch port on the card: the hand-written fused-step kernel against
its plain version, the wrapper's checks on CUDA tensors, and the engine's
fused tier.  Every test here needs a CUDA card and ``nvcc``; without a
card each one skips with the reason (they carry the ``cuda`` marker).
On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.graph.generators import protein_network
from repro_torch.kernels import pagerank_step as k1
from repro_torch.kernels.ref import pagerank_step_fused_ref
from repro_torch.obs.registry import NullRegistry
from repro_torch.pagerank import PageRankEngine

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
