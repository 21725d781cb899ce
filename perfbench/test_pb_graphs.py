"""The frozen generators: pinned sizes and determinism."""
import numpy as np
import torch

from perfbench.graphs import kronecker, protein
from perfbench.graphs.stream import EdgeStream


def test_protein5k_at_seed_0():
    src, dst = protein.protein_network(5000, 0)
    assert len(src) == 41_102
    assert int(np.sum(np.bincount(src, minlength=5000) == 0)) == 50
    assert not np.any(src == dst)
    keys = src.astype(np.int64) * 5000 + dst
    assert np.unique(keys).size == keys.size
    back = np.sort(dst.astype(np.int64) * 5000 + src)
    assert np.array_equal(np.sort(keys), back)          # symmetric


def test_kronecker_is_deterministic_and_clean():
    a = kronecker.kronecker_edges(9, 16, 0.57, 0.19, 0.19, 11, "cpu")
    b = kronecker.kronecker_edges(9, 16, 0.57, 0.19, 0.19, 11, "cpu")
    c = kronecker.kronecker_edges(9, 16, 0.57, 0.19, 0.19, 12, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert a[0].numel() == 16 * 512 and int(a[0].max()) < 512
    src, dst, n, m = kronecker.graphalytics_clean(*a, 512)
    # pinned: 460 of 512 vertices keep an edge, 4,739 unique edges
    assert (n, m) == (460, 4739) and src.numel() == 2 * m
    assert not bool(torch.any(src == dst))
    assert int(torch.bincount(src.long(), minlength=n).min()) > 0
    keys = src.long() * n + dst.long()
    assert torch.unique(keys).numel() == keys.numel()
    # the same seed always gives the same cleaned graph
    again = kronecker.graphalytics_clean(*b, 512)
    assert torch.equal(again[0], src) and again[2:] == (n, m)


def test_kronecker_skew_puts_edges_on_few_vertices():
    src, _, n, _ = kronecker.graphalytics_clean(
        *kronecker.kronecker_edges(12, 16, 0.57, 0.19, 0.19, 3, "cpu"),
        1 << 12)
    deg = np.sort(torch.bincount(src.long()).numpy())[::-1]
    assert deg[: n // 10].sum() > 0.5 * deg.sum()


def test_stream_keeps_the_edge_count_and_expires_oldest_first():
    src, dst = protein.protein_network(300, 4)
    s = EdgeStream(src, dst, 300, np.random.default_rng(1), 6, 6)
    oldest = list(s._fifo)[:12]
    live = len(s._live)
    ins1, del1 = s.step()
    ins2, del2 = s.step()
    assert len(s._live) == live
    assert [int(u) * 300 + int(v) for u, v in np.concatenate([del1, del2])
            ] == oldest
    assert np.all(ins1[:, 0] < ins1[:, 1])
