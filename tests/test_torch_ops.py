"""PyTorch port, ``repro_torch.kernels.ops`` on the CPU: the four entry
points (``matvec`` and ``gemv_batched`` on K2, ``spmv`` on K3,
``pagerank_iteration`` on K4) against the JAX ``repro.kernels.ops`` with
Pallas in interpret mode, and K4's plain version against the JAX
``pagerank_step`` at the shapes of tests/test_kernels.py.  The CUDA
kernels are held against the same plain versions on the card
(``chip_smoke.py``, ``tests/test_torch_cuda.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph import generators as jgen
from repro.graph import sparse as jsparse
from repro.graph import transition as jtr
from repro.kernels import ops as jops
from repro.kernels.pagerank_step import pagerank_step as jpagerank_step
from repro.pagerank import pagerank_dense_fixed as jdense_fixed
from repro_torch.graph import sparse as tsparse
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pagerank_step as tps
from repro_torch.kernels import ref as tref
from repro_torch.pagerank.dense import pagerank_dense_fixed

# f32 accumulation in another order than the oracle (tests/test_kernels.py)
TOL32 = dict(rtol=1e-5, atol=5e-5)
# bf16 inputs, f32 accumulation (tests/test_kernels.py)
TOL_LOW = dict(rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("N,M,B", [(128, 128, 1), (128, 384, 4),
                                   (100, 90, 1), (37, 129, 3)])
def test_matvec_and_gemv_batched_match_jax(N, M, B, dtype):
    rng = np.random.default_rng(N + M + B)
    W = rng.normal(size=(N, M)).astype(np.float32)
    X = rng.normal(size=(B, M)).astype(np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jW, tW = jnp.asarray(W).astype(jdt), torch.from_numpy(W).to(tdt)
    tol = TOL32 if dtype == "f32" else TOL_LOW
    got = tops.gemv_batched(tW, torch.from_numpy(X))
    assert got.shape == (B, N) and got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jops.gemv_batched(jW, jnp.asarray(X),
                                                  interpret=True)), **tol)
    y = tops.matvec(tW, torch.from_numpy(X[0]))
    assert y.shape == (N,)
    np.testing.assert_allclose(
        y.numpy(), np.asarray(jops.matvec(jW, jnp.asarray(X[0]),
                                          interpret=True)), **tol)


@pytest.mark.parametrize("n,bs,density", [(256, 128, 0.3), (200, 128, 0.2),
                                          (300, 32, 0.1)])
def test_spmv_matches_jax(n, bs, density):
    rng = np.random.default_rng(n + bs)
    A = rng.normal(size=(n, n)).astype(np.float32)
    A[rng.random(size=A.shape) > density] = 0.0
    x = rng.normal(size=n).astype(np.float32)
    got = tops.spmv(tsparse.BSRMatrix.from_dense(A, bs=bs, device="cpu"),
                    torch.from_numpy(x))
    want = jops.spmv(jsparse.BSRMatrix.from_dense(A, bs=bs),
                     jnp.asarray(x), interpret=True)
    assert got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL32)
    np.testing.assert_allclose(got.numpy(), A @ x, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("n", [128, 256, 500, 1000])
def test_pagerank_step_ref_matches_pallas(n):
    """K4's plain version (what the wrapper runs on CPU tensors) against
    the JAX Pallas step in interpret mode (tests/test_kernels.py:121)."""
    src, dst = jgen.protein_network(n, seed=n)
    H = np.array(jtr.build_transition_dense(src, dst, n))
    pr = np.full(n, 1.0 / n, np.float32)
    t = np.float32(0.15 / n)
    want = jpagerank_step(jnp.asarray(H), jnp.asarray(pr), jnp.asarray(t),
                          d=0.85, interpret=True)
    got = tps.pagerank_step(torch.from_numpy(H), torch.from_numpy(pr),
                            torch.tensor(t), d=0.85)
    assert torch.equal(got, tref.pagerank_step_ref(
        torch.from_numpy(H), torch.from_numpy(pr), torch.tensor(t), d=0.85))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("N,M", [(300, 130), (37, 129)])
def test_pagerank_step_unpadded_shapes(N, M):
    """Any (N, M): the step is computed on H as given, with a Python
    number for t placed on the device."""
    rng = np.random.default_rng(N)
    H = rng.random((N, M), dtype=np.float32) / M
    pr = rng.random(M, dtype=np.float32)
    want = jpagerank_step(jnp.asarray(H), jnp.asarray(pr), jnp.float32(1e-3),
                          d=0.85, interpret=True)
    got = tps.pagerank_step(torch.from_numpy(H), torch.from_numpy(pr), 1e-3,
                            d=0.85)
    assert got.shape == (N,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL32)
    with pytest.raises(ValueError, match="pagerank_step: "):
        tps.pagerank_step(torch.from_numpy(H), torch.from_numpy(pr[:5]), 0.0)


def test_pagerank_iteration_three_phase_matches_jax():
    """The step with the dangling correction == the paper's separate
    MV / scale / add phases (tests/test_kernels.py:137), in both
    packages."""
    n = 300
    src, dst = jgen.protein_network(n, seed=3)
    H = np.array(jtr.build_transition_dense(src, dst, n,
                                            fix_dangling=False))
    dang = jtr.dangling_mask(src, n).astype(np.float32)
    pr = np.random.default_rng(0).random(n).astype(np.float32)
    pr /= pr.sum()
    got = tops.pagerank_iteration(torch.from_numpy(H), torch.from_numpy(pr),
                                  dangling=torch.from_numpy(dang))
    want = jops.pagerank_iteration(jnp.asarray(H), jnp.asarray(pr),
                                   dangling=jnp.asarray(dang),
                                   interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)
    leak = float((pr * dang).sum()) / n
    unfused = 0.85 * (H @ pr + leak) + 0.15 / n
    np.testing.assert_allclose(got.numpy(), unfused, rtol=1e-5, atol=1e-7)


def test_full_pagerank_via_pagerank_iteration_matches_dense():
    """quickstart's loop: 30 steps against pagerank_dense_fixed, in both
    packages (tests/test_kernels.py:150)."""
    n = 256
    src, dst = jgen.protein_network(n, seed=1)
    H = np.array(jtr.build_transition_dense(src, dst, n))
    pr = torch.full((n,), 1.0 / n)
    jpr = jnp.full((n,), 1.0 / n)
    for _ in range(30):
        pr = tops.pagerank_iteration(torch.from_numpy(H), pr)
        jpr = jops.pagerank_iteration(jnp.asarray(H), jpr, interpret=True)
    want = pagerank_dense_fixed(torch.from_numpy(H), n_iters=30)
    np.testing.assert_allclose(pr.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose(
        pr.numpy(), np.asarray(jdense_fixed(jnp.asarray(H), n_iters=30)),
        rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(pr.numpy(), np.asarray(jpr), rtol=1e-5,
                               atol=1e-7)


def test_step_launch_counts_start_at_zero_and_reset():
    tps.step_launches["f32"] += 3
    tps.launches["bf16"] += 1
    tps.reset_launches()
    assert set(tps.step_launches.values()) == {0}
    assert set(tps.launches.values()) == {0}
    # CPU tensors run the plain version and launch nothing
    tops.pagerank_iteration(torch.eye(4), torch.ones(4))
    assert set(tps.step_launches.values()) == {0}
