from repro_torch.serve.cache import CacheEntry, ResultCache
from repro_torch.serve.engine import PageRankQueryEngine, PPRQuery

__all__ = ["PageRankQueryEngine", "PPRQuery", "CacheEntry", "ResultCache"]
