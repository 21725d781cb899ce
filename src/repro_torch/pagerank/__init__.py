from repro_torch.pagerank.dense import pagerank_dense, pagerank_dense_fixed
from repro_torch.pagerank.engine import PageRankEngine, select_backend
from repro_torch.pagerank.resilience import (ConvergenceError, SolveInfo,
                                             SolveResult)

__all__ = ["pagerank_dense", "pagerank_dense_fixed", "PageRankEngine",
           "select_backend", "ConvergenceError", "SolveInfo", "SolveResult"]
