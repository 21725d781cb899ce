"""Graphalytics' EVPS: (vertices with an edge + undirected edges) times
solves completed, over the window's seconds."""


def read(rec):
    done = rec.get("completed", 0)
    if not done:
        return None
    g = rec["graph"]
    return (g["n_connected"] + g["n_undirected"]) * done / rec["window_s"]
