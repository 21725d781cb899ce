from repro_torch.pagerank.dense import pagerank_dense, pagerank_dense_fixed
from repro_torch.pagerank.dynamic import (PATCHABLE_BACKENDS,
                                          DynamicPageRankEngine, UpdateInfo)
from repro_torch.pagerank.engine import PageRankEngine, select_backend
from repro_torch.pagerank.fabric import pagerank_on_fabric
from repro_torch.pagerank.landmarks import LandmarkIndex
from repro_torch.pagerank.resilience import (ConvergenceError,
                                             EngineSnapshot, FaultInjector,
                                             RankStore, RefreshOutcome,
                                             ResilientRefresher, RetryPolicy,
                                             SolveInfo, SolveResult)
from repro_torch.pagerank.sparse import pagerank_sparse

__all__ = ["pagerank_dense", "pagerank_dense_fixed", "pagerank_sparse",
           "pagerank_on_fabric",
           "PageRankEngine", "select_backend", "LandmarkIndex",
           "DynamicPageRankEngine", "UpdateInfo", "PATCHABLE_BACKENDS",
           "ConvergenceError", "EngineSnapshot", "FaultInjector",
           "RankStore", "RefreshOutcome", "ResilientRefresher",
           "RetryPolicy", "SolveInfo", "SolveResult"]
