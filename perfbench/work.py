"""The bytes of work that one PageRank iteration needs, whatever layout or
kernel computes it.

Per iteration and per query vector: one int32 column index per directed
edge (4 B), and per vertex its row offset, the rank read, the rank
written and the 1/outdeg factor (16 B).  The values of H are 1/outdeg and
can be derived, so they are not counted.  A layout that pads rows, stores
H dense or reads x more than once moves more than this; the roofline
share of a kernel built on these bytes therefore holds across tiers.
"""
from __future__ import annotations

EDGE_BYTES = 4
VERTEX_BYTES = 16


def iteration_bytes(n_vertices: int, n_directed_edges: int,
                    vectors: int = 1) -> int:
    return (EDGE_BYTES * int(n_directed_edges)
            + VERTEX_BYTES * int(n_vertices)) * int(vectors)


def engine_iteration_bytes(engine, vectors: int = 1) -> int:
    """The same from an engine's graph: its vertex count and its
    deduplicated directed edges."""
    return iteration_bytes(engine.n, engine.n_edges, vectors)
