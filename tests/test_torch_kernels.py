"""PyTorch port, kernel layer on the CPU: the plain versions of the fused
PageRank step and of the streaming batched matvec (what the wrappers run
for CPU tensors) against the JAX Pallas kernels in interpret mode, the
one-time padding, and the wrappers' checks.  The CUDA kernels themselves
are held against the same plain versions on the card by ``chip_smoke.py``
and ``tests/test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import pagerank_step as jps
from repro.kernels import ref as jref
from repro.kernels.streaming_matvec import streaming_matvec as jsmv
from repro_torch.kernels import pagerank_step as tps
from repro_torch.kernels import streaming_matvec as tsmv
from repro_torch.kernels import ref as tref
from repro_torch.kernels.common import resolve_device, upcast_f32

# f32 accumulation in another order than the oracle (tests/test_kernels.py)
TOL32 = dict(rtol=1e-5, atol=5e-5)
# reduced-precision storage, f32 accumulation (tests/test_kernels.py)
TOL_LOW = dict(rtol=2e-3, atol=2e-3)
PRECISIONS = ("f32", "bf16", "f16", "int8")
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16, "f16": jnp.float16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}


def _operands(Np, Mp, precision, seed):
    """Seeded numpy inputs in PageRank's range on a padded layout: the
    last rows/columns are zero padding, the dangling mask is zero there."""
    rng = np.random.default_rng(seed)
    n, m = Np - 37, Mp - 21
    H = np.zeros((Np, Mp), np.float32)
    H[:n, :m] = rng.random((n, m), dtype=np.float32) * (2.0 / m)
    x = np.zeros((1, Mp), np.float32)
    x[0, :m] = rng.random(m, dtype=np.float32) / m
    dang = np.zeros((1, Np), np.float32)
    dang[0, :n] = rng.random(n) < 0.05
    t = np.float32(0.15 / n + 0.01)
    scales = None
    if precision == "int8":
        absmax = np.abs(H).max(axis=1)
        s = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
        H = np.clip(np.rint(H / s[:, None]), -127, 127).astype(np.int8)
        scales = s[None, :]
    return H, x, dang, t, scales, n


def _jax_store(H, precision):
    return jnp.asarray(H) if precision == "int8" else \
        jnp.asarray(H).astype(JDT[precision])


def _torch_store(H, precision):
    h = torch.from_numpy(H)
    return h if precision == "int8" else h.to(TDT[precision])


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("Np,Mp", [(256, 256), (512, 768)])
def test_fused_step_matches_pallas(Np, Mp, precision):
    H, x, dang, t, scales, n = _operands(Np, Mp, precision, seed=Np + Mp)
    jy, jleak = jps.pagerank_step_fused(
        _jax_store(H, precision), jnp.asarray(x), jnp.asarray(dang),
        jnp.asarray(t), None if scales is None else jnp.asarray(scales),
        d=0.85, interpret=True)
    ts = None if scales is None else torch.from_numpy(scales)
    before = dict(tps.launches)
    ty, tleak = tps.pagerank_step_fused(
        _torch_store(H, precision), torch.from_numpy(x),
        torch.from_numpy(dang), torch.tensor(t), ts, d=0.85)
    assert tps.launches == before          # the CPU path launches nothing
    assert ty.shape == (1, Np) and ty.dtype == torch.float32
    assert tleak.shape == () and tleak.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL32)
    np.testing.assert_allclose(float(tleak), float(jleak), **TOL32)
    # the padded tail holds t, not 0 — in both packages
    assert np.all(ty.numpy()[0, n:] == t)
    assert np.all(np.asarray(jy)[0, n:] == t)


def test_fused_ref_epilogue_order():
    """s * acc first, then d * acc + t: the int8 epilogue of the TPU
    kernel, reproduced in plain torch."""
    Hq = torch.tensor([[2, 0], [0, -3]], dtype=torch.int8)
    xp = torch.tensor([[0.5, 0.25]])
    dangp = torch.tensor([[1.0, 0.0]])
    s = torch.tensor([[0.1, 0.2]])
    y, leak = tref.pagerank_step_fused_ref(Hq, xp, dangp, torch.tensor(0.01),
                                           s, d=0.5)
    acc = s * torch.tensor([[1.0, -0.75]])
    want = 0.5 * acc + 0.01
    assert torch.equal(y, want)
    assert torch.equal(leak, want[0, 0])


@pytest.mark.parametrize("N,M", [(200, 200), (300, 130), (256, 512)])
def test_pad_pagerank_operands_matches_jax(N, M):
    rng = np.random.default_rng(N * M)
    H = rng.random((N, M), dtype=np.float32)
    dang = (rng.random(N) < 0.1).astype(np.float32)
    jHp, jd, _, _ = jps.pad_pagerank_operands(jnp.asarray(H), dang)
    tHp, td = tps.pad_pagerank_operands(torch.from_numpy(H), dang)
    assert tHp.shape == jHp.shape
    assert np.array_equal(tHp.numpy(), np.asarray(jHp))
    assert np.array_equal(td.numpy(), np.asarray(jd))
    assert tHp.is_contiguous() and td.shape == (1, tHp.shape[0])
    _, td0 = tps.pad_pagerank_operands(torch.from_numpy(H))
    assert not td0.any()


def test_pagerank_step_ref_matches_jax():
    rng = np.random.default_rng(3)
    H = rng.random((64, 64), dtype=np.float32)
    pr = rng.random(64, dtype=np.float32)
    want = np.asarray(jref.pagerank_step_ref(jnp.asarray(H), jnp.asarray(pr),
                                             jnp.float32(0.002)))
    got = tref.pagerank_step_ref(torch.from_numpy(H), torch.from_numpy(pr),
                                 0.002)
    np.testing.assert_allclose(got.numpy(), want, **TOL32)


def test_wrapper_rejects_unpadded_layout():
    Hp = torch.zeros((256, 200))
    with pytest.raises(ValueError, match="pre-padded"):
        tps.pagerank_step_fused(Hp, torch.zeros((1, 200)),
                                torch.zeros((1, 256)), torch.tensor(0.0))


def test_reset_launches():
    tps.launches["f32"] += 3
    tps.reset_launches()
    assert set(tps.launches) == set(PRECISIONS)
    assert all(v == 0 for v in tps.launches.values())


def test_upcast_and_resolve_device(monkeypatch):
    x = torch.ones(3, dtype=torch.bfloat16)
    assert upcast_f32(x).dtype == torch.float32
    f = torch.ones(3)
    assert upcast_f32(f) is f
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")


def test_build_module_lists_sources_without_building():
    from repro_torch.kernels import _build
    assert "pagerank_step" in _build.sources()
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    assert tps._lib is None or torch.cuda.is_available()


def _smv_operands(N, M, B, precision, seed):
    """Seeded numpy W (N, M) in the precision's storage and X (B, M)."""
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((N, M), dtype=np.float32)
    X = rng.standard_normal((B, M), dtype=np.float32)
    if precision == "int8":
        W = np.clip(np.rint(W * 40.0), -127, 127).astype(np.int8)
    return W, X


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("N,M", [(256, 256), (300, 130)])
def test_streaming_matvec_matches_pallas(N, M, B, precision):
    """The wrapper's CPU path (the plain version) against the JAX kernel in
    interpret mode, as tests/test_kernels.py runs it: any N and M, the
    four storage dtypes, f32 accumulation."""
    W, X = _smv_operands(N, M, B, precision, seed=N + M + B)
    want = np.asarray(jsmv(_jax_store(W, precision), jnp.asarray(X),
                           block_n=128, block_m=128))
    before = dict(tsmv.launches)
    got = tsmv.streaming_matvec(_torch_store(W, precision),
                                torch.from_numpy(X))
    assert tsmv.launches == before         # the CPU path launches nothing
    assert got.shape == (B, N) and got.dtype == torch.float32
    tol = TOL32 if precision == "f32" else TOL_LOW
    np.testing.assert_allclose(got.numpy(), want, **tol)


def test_streaming_matvec_ref_matches_jax_ref():
    W, X = _smv_operands(64, 96, 5, "bf16", seed=11)
    want = np.asarray(jref.streaming_matvec_ref(
        _jax_store(W, "bf16"), jnp.asarray(X)))
    got = tref.streaming_matvec_ref(_torch_store(W, "bf16"),
                                    torch.from_numpy(X))
    np.testing.assert_allclose(got.numpy(), want, **TOL32)


def test_streaming_matvec_rejects_mismatched_shapes():
    with pytest.raises(ValueError, match="must be"):
        tsmv.streaming_matvec(torch.zeros((8, 16)), torch.zeros((2, 12)))
    with pytest.raises(ValueError, match="must be"):
        tsmv.streaming_matvec(torch.zeros((8, 16)), torch.zeros(16))


def test_streaming_matvec_reset_launches():
    tsmv.launches["int8"] += 2
    tsmv.reset_launches()
    assert set(tsmv.launches) == set(PRECISIONS)
    assert all(v == 0 for v in tsmv.launches.values())
    assert tsmv._lib is None or torch.cuda.is_available()
    from repro_torch.kernels import _build
    assert "streaming_matvec" in _build.sources()
