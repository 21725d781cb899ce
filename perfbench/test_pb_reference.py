"""The plain reference against values worked by hand, and its two layouts
against each other."""
import numpy as np
import pytest
import torch

from perfbench.graphs import kronecker
from perfbench.reference import delta as rdelta
from perfbench.reference import pagerank as rpr

# 0 -> 1, 0 -> 2, 1 -> 2; vertex 2 is dangling
SRC = torch.tensor([0, 0, 1])
DST = torch.tensor([1, 2, 2])


@pytest.mark.parametrize("layout", ["dense", "csr"])
def test_one_step_by_hand(layout):
    op = rpr.Operator(SRC, DST, 3, layout=layout)
    x = rpr.pagerank(op, 0.85, 1).numpy()
    # H x = (0, 1/6, 1/2); the leak of vertex 2 is (1/3) / 3
    want = 0.85 * (np.array([0, 1 / 6, 1 / 2]) + 1 / 9) + 0.05
    np.testing.assert_allclose(x, want, rtol=0, atol=1e-15)
    assert abs(x.sum() - 1.0) < 1e-15


@pytest.mark.parametrize("layout", ["dense", "csr"])
def test_ppr_one_step_by_hand(layout):
    op = rpr.Operator(SRC, DST, 3, layout=layout)
    x = rpr.ppr(op, [[0], [2]], 0.85, 1).numpy()
    # seed 0: 0.85 * H e0 + 0.15 e0; seed 2 (dangling): all rank returns
    np.testing.assert_allclose(x[:, 0], [0.15, 0.425, 0.425], atol=1e-15)
    np.testing.assert_allclose(x[:, 1], [0.0, 0.0, 1.0], atol=1e-15)


def test_fixed_point_of_a_cycle_is_uniform():
    op = rpr.Operator(torch.tensor([0, 1, 2]), torch.tensor([1, 2, 0]), 3)
    np.testing.assert_allclose(rpr.pagerank(op, 0.85, 50).numpy(),
                               np.full(3, 1 / 3), atol=1e-15)


def test_csr_equals_dense_on_a_kronecker_graph():
    i, j = kronecker.kronecker_edges(10, 8, 0.57, 0.19, 0.19, 5, "cpu")
    src, dst, n, _ = kronecker.graphalytics_clean(i, j, 1 << 10)
    dense = rpr.Operator(src, dst, n, layout="dense")
    csr = rpr.Operator(src, dst, n, layout="csr")
    np.testing.assert_allclose(rpr.pagerank(csr, 0.85, 30).numpy(),
                               rpr.pagerank(dense, 0.85, 30).numpy(),
                               rtol=1e-12, atol=0)
    sets = [[0], [3, 7, 9]]
    np.testing.assert_allclose(rpr.ppr(csr, sets, 0.85, 30).numpy(),
                               rpr.ppr(dense, sets, 0.85, 30).numpy(),
                               rtol=1e-12, atol=1e-18)


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      1.0 + 2 ** -12], dtype=torch.float32)
    # ties go to even: 1 + 2^-11 -> 1, 1 + 3 * 2^-11 -> 1 + 2^-9
    assert rpr.tf32(x).tolist() == [1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9,
                                    1.0]


def test_delta_is_deletes_first_then_inserts():
    n = 10
    keys = rdelta.undirected_keys(np.array([0, 1, 2]), np.array([1, 2, 3]),
                                  n)
    ins = np.array([[4, 5], [2, 1]])        # (1, 2) listed in both
    dele = np.array([[1, 2], [7, 8]])       # (7, 8) is absent
    got = rdelta.apply(keys, ins, dele, n)
    assert got.tolist() == [0 * n + 1, 1 * n + 2, 2 * n + 3, 4 * n + 5]
    src, dst = rdelta.directed(got, n)
    assert sorted(zip(src.tolist(), dst.tolist()))[:2] == [(0, 1), (1, 0)]
