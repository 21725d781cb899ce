"""The numerical design of the streaming matvec kernel (K2), in plain torch
on the CPU.

``csrc/streaming_matvec.cu`` computes ``Y = X @ W.T`` on TF32 tensor cores
(m16n8k8 ``mma.sync``) and is held to its plain version
(``streaming_matvec_ref``, float32) within rtol 1e-5 / atol 1e-9.  These
tests emulate its arithmetic on a 5120-column product of distributions, the
shape of batched personalized PageRank on the main path, and pin why it is
built as it is:

* operands rounded to TF32 as ``cvt.rna.tf32.f32`` does (to nearest, ties
  away from zero, 10 mantissa bits kept); a remainder handed to the tensor
  core as it is, which reads it truncated to TF32;
* each mma adds its 8 exact products to its accumulator and truncates the
  sum to float32 (a model of the tensor core's adder, not a measurement;
  ``scripts/k2_tile_sweep.py --probe`` measures the card);
* the kernel's schedule: 32-column groups of 4 k-steps, k-step ``s`` taking
  columns ``8t + 2s`` and ``8t + 2s + 1`` (t = 0..3); the mma accumulator
  added into a float32 sum and restarted from zero after every ``restart``
  k-steps; the columns split into 8 ranges whose partial sums are added in
  order.

Under that model the split products (3 for float32 W: xs*wb, xb*ws, xb*wb;
2 for bf16 / f16 / int8 W, exact in TF32: xs*w, xb*w) meet the gate when
the accumulator restarts every 1, 2 or 4 k-steps, and miss it when one
accumulator is chained through all 640 k-steps; a single TF32 product
misses it whatever the schedule.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ref import streaming_matvec_ref

TIGHT = dict(rtol=1e-5, atol=1e-9)
N, M, B = 256, 5120, 8
GROUP, SPLITS = 32, 8


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: to nearest, ties away from zero (finite x)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_truncated(x: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of a float32 register as a TF32 operand."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def toward_zero(x: torch.Tensor) -> torch.Tensor:
    """A float64 tensor rounded toward zero to float32."""
    y = x.float()
    over = y.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def k_steps(A: torch.Tensor) -> torch.Tensor:
    """(rows, M) -> (rows, M / 32, 4, 8): group, k-step, the step's 8
    columns (k-step s of a group takes columns 8t + 2s and 8t + 2s + 1)."""
    r = A.shape[0]
    return (A.double().reshape(r, -1, 4, 4, 2).permute(0, 1, 3, 2, 4)
            .reshape(r, -1, 4, 8))


def products(W: torch.Tensor, X: torch.Tensor, scheme: str) -> list:
    """The products of each mma, in the kernel's order, as (B, N, groups,
    4) float64 sums of each k-step's 8 exact products."""
    Wf = W.float()
    if scheme == "single":
        pairs = [(tf32_rna(X), tf32_rna(Wf))]
    else:
        xb = tf32_rna(X)
        xs = tf32_truncated(X - xb)
        if scheme == "split3":
            wb = tf32_rna(Wf)
            ws = tf32_truncated(Wf - wb)
            pairs = [(xs, wb), (xb, ws), (xb, wb)]
        else:   # split2: W is exact in TF32
            assert torch.equal(tf32_truncated(Wf), Wf)
            pairs = [(xs, Wf), (xb, Wf)]
    return [torch.einsum("bgsk,ngsk->bngs", k_steps(x), k_steps(w))
            for x, w in pairs]


def emulate(W: torch.Tensor, X: torch.Tensor, scheme: str, restart: int,
            splits: int = SPLITS) -> torch.Tensor:
    """The kernel's arithmetic under the model above; ``restart`` 0 chains
    one accumulator through a split's whole range."""
    prods = products(W, X, scheme)
    groups = prods[0].shape[2]
    partials = []
    for r in range(splits):
        acc = torch.zeros(X.shape[0], W.shape[0])
        c = torch.zeros_like(acc)
        for g in range(r * groups // splits, (r + 1) * groups // splits):
            for s in range(4):
                for p in prods:
                    c = toward_zero(c.double() + p[:, :, g, s])
                if restart and (s + 1) % restart == 0:
                    acc, c = acc + c, torch.zeros_like(c)
        partials.append(acc + c)
    Y = partials[0]
    for p in partials[1:]:
        Y = Y + p
    return Y


def _case(storage: str, seed: int = 0):
    """W at PageRank's scale (int8 as integers), X rows distributions."""
    rng = np.random.default_rng(seed)
    W = rng.random((N, M), dtype=np.float32) * (2.0 / M)
    X = rng.random((B, M), dtype=np.float32)
    X /= X.sum(axis=1, keepdims=True)
    Wt = torch.from_numpy(W)
    if storage == "int8":
        Wt = torch.from_numpy(np.rint(W * (127.0 * M / 2.0)).astype(np.int8))
    elif storage != "f32":
        Wt = Wt.to({"bf16": torch.bfloat16, "f16": torch.float16}[storage])
    return Wt, torch.from_numpy(X)


def test_tf32_rounding_matches_cvt_rna():
    x = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11,
                      -(1.0 + 2.0**-11), 1.0 + 2.0**-11 - 2.0**-23,
                      3.0e-5], dtype=torch.float32)
    got = tf32_rna(x)
    # ties go away from zero, anything under half an ulp goes down
    want = torch.tensor([1.0, 1.0 + 2.0**-10, 1.0 + 2 * 2.0**-10,
                         -(1.0 + 2.0**-10), 1.0], dtype=torch.float32)
    assert torch.equal(got[:5], want)
    assert torch.equal(tf32_truncated(got), got)
    assert abs(float(got[5]) / 3.0e-5 - 1.0) <= 2.0**-11
    # the remainder is exact in float32, and xb + xs gives x back
    r = x - got
    assert torch.equal(got + r, x)


@pytest.mark.parametrize("restart", [1, 2, 4])
@pytest.mark.parametrize("storage", ["f32", "bf16", "f16", "int8"])
def test_split_products_meet_the_gate(storage, restart):
    W, X = _case(storage, seed=restart)
    scheme = "split3" if storage == "f32" else "split2"
    Y = emulate(W, X, scheme, restart)
    ref = streaming_matvec_ref(W, X)
    torch.testing.assert_close(Y, ref, **TIGHT)
    exact = X.double() @ W.double().T
    rel = float(((Y.double() - exact).abs() / exact).max())
    assert rel < 2e-6


def test_single_tf32_product_misses_the_gate():
    W, X = _case("f32")
    for restart in (1, 2, 4):
        Y = emulate(W, X, "single", restart)
        assert not torch.allclose(Y, streaming_matvec_ref(W, X), **TIGHT)


def test_one_accumulator_through_640_k_steps_misses_the_gate():
    """Why the accumulator restarts: chained through a whole row (one
    split, 640 k-steps) the truncating adds drift past rtol 1e-5."""
    W, X = _case("f32")
    Y = emulate(W, X, "split3", restart=0, splits=1)
    assert not torch.allclose(Y, streaming_matvec_ref(W, X), **TIGHT)


def test_schedule_is_per_query():
    """A query's emulated row is the same bits alone and in its batch: the
    schedule depends on the column index alone."""
    W, X = _case("bf16", seed=3)
    Y = emulate(W, X, "split2", restart=2)
    for q in (0, B - 1):
        assert torch.equal(emulate(W, X[q:q + 1], "split2", restart=2),
                           Y[q:q + 1])
