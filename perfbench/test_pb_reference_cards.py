"""The plain reference across cards (``reference/pagerank_cards.py``) on
four CPU positions against the one-device reference: the same power
iteration, in float64 and for the control in TF32 with float32 sums."""
import pytest
import torch

from perfbench.graphs import kronecker
from perfbench.reference import pagerank as rpr
from perfbench.reference import pagerank_cards as cards


@pytest.fixture(scope="module")
def graph():
    i, j = kronecker.kronecker_edges(10, 16, 0.57, 0.19, 0.19, 5, "cpu")
    src, dst, n, _ = kronecker.graphalytics_clean(i, j, 1 << 10)
    # a vertex with no out-edge: drop the edges leaving vertex 0
    keep = src != 0
    return src[keep], dst[keep], n


@pytest.mark.parametrize("precision,tol", [
    ("f64", dict(rtol=1e-12, atol=0)),
    # float32 sums of the same rounded products, in another order
    ("tf32", dict(rtol=1e-5, atol=1e-9))])
def test_cards_match_one_device(graph, precision, tol, monkeypatch):
    src, dst, n = graph
    monkeypatch.setattr(cards, "CHUNK", 5000)       # several chunks
    op = cards.Operator(src, dst, n, ["cpu"] * 4, precision=precision)
    assert op.bounds[0] == 0 and op.bounds[-1] == n and len(op.bounds) == 5
    sizes = [r.numel() for r in op.rows]
    assert sum(sizes) == src.numel() and max(sizes) < 0.4 * sum(sizes)
    one = rpr.Operator(src, dst, n, layout="csr", precision=precision)
    torch.testing.assert_close(rpr.pagerank(op, 0.85, 10),
                               rpr.pagerank(one, 0.85, 10), **tol)
    x = torch.rand(n, dtype=op.dang.dtype)
    torch.testing.assert_close(op.matvec(x), one.matvec(x), **tol)
    assert float(op.dang[0]) == 1.0
