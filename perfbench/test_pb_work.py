"""The work bytes do not depend on the tier that computes the
iteration."""
import numpy as np
import pytest

from perfbench import work
from perfbench.graphs import protein


def test_three_vertex_graph_by_hand():
    # 0 -> 1, 0 -> 2, 1 -> 2: three int32 indices, three vertices of 16 B
    assert work.iteration_bytes(3, 3) == 3 * 4 + 3 * 16 == 60
    assert work.iteration_bytes(3, 3, vectors=8) == 480


def test_protein5k_needs_244_kb_an_iteration():
    src, _ = protein.protein_network(5000, 0)
    assert work.iteration_bytes(5000, len(src)) == 244_408


@pytest.mark.parametrize("backend", ["dense", "ell", "bsr", "fused_dense"])
def test_same_bytes_on_every_tier(backend):
    from repro_torch.pagerank import PageRankEngine
    src, dst = protein.protein_network(200, 2)
    eng = PageRankEngine(src, dst, 200, backend=backend, device="cpu")
    assert work.engine_iteration_bytes(eng) == work.iteration_bytes(
        200, len(src))
    # duplicates collapse: the graph, not the edge list, sets the work
    eng2 = PageRankEngine(np.concatenate([src, src[:5]]),
                          np.concatenate([dst, dst[:5]]), 200,
                          backend=backend, device="cpu")
    assert work.engine_iteration_bytes(eng2) == work.engine_iteration_bytes(
        eng)
