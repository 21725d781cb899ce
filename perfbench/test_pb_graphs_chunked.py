"""The bounded-memory Kronecker generator (``graphs/kronecker_chunked.py``)
held to the clean-up's rules and to the whole-graph generator's sizes."""
import numpy as np
import pytest
import torch

from perfbench.graphs import kronecker, kronecker_chunked

CFG = {"edgefactor": 16, "a": 0.57, "b": 0.19, "c": 0.19}


def make(scale, seed):
    return kronecker_chunked.make({**CFG, "scale": scale}, seed, "cpu")


@pytest.mark.parametrize("scale", [9, 12])
def test_the_graph_keeps_the_clean_up_rules(scale):
    g = make(scale, 2**31 + 5)
    src, dst, n = g.src.astype(np.int64), g.dst.astype(np.int64), g.n
    assert g.src.dtype == g.dst.dtype == np.int32
    assert not np.any(src == dst)                       # no self-loops
    keys = src * n + dst
    assert np.unique(keys).size == keys.size            # no duplicates
    assert np.array_equal(np.sort(keys), np.sort(dst * n + src))  # symmetric
    deg = np.bincount(src, minlength=n)
    assert src.min() >= 0 and src.max() < n and deg.min() > 0  # dense ids
    assert g.n_connected == n == int(np.count_nonzero(deg))
    assert g.n_undirected * 2 == g.n_directed


@pytest.mark.parametrize("scale", [10, 12])
def test_sizes_are_near_the_whole_graph_generators(scale):
    whole = [kronecker.graphalytics_clean(*kronecker.kronecker_edges(
        scale, 16, 0.57, 0.19, 0.19, s, "cpu"), 1 << scale)[2:]
        for s in (1, 2, 3)]
    for seed in (1, 2, 3):
        g = make(scale, seed)
        for n, m in whole:
            assert abs(g.n - n) <= 0.03 * n
            assert abs(g.n_undirected - m) <= 0.03 * m


def test_chunks_and_key_ranges_change_nothing_but_the_stream(monkeypatch):
    a = make(10, 77)
    b = make(10, 77)
    assert np.array_equal(a.src, b.src) and np.array_equal(a.dst, b.dst)
    assert not np.array_equal(make(10, 78).src[:100], a.src[:100])
    # the key ranges split the dedupe only: one range gives the same graph
    monkeypatch.setattr(kronecker_chunked, "RANGES", 1)
    one = make(10, 77)
    assert np.array_equal(one.src, a.src) and one.n == a.n
    # chunks of 1000 edges draw another stream of the same law
    monkeypatch.setattr(kronecker_chunked, "CHUNK", 1000)
    small = make(10, 77)
    assert abs(small.n_undirected - a.n_undirected) <= 0.03 * a.n_undirected


def test_the_edges_stay_on_the_host():
    g = make(9, 3)
    assert g.src_t.device.type == g.dst_t.device.type == "cpu"
    assert g.src_t.data_ptr() == g.src.ctypes.data      # no copy
    assert torch.equal(g.dst_t, torch.from_numpy(g.dst))
