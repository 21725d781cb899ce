from repro_torch.serve.cache import CacheEntry, ResultCache
from repro_torch.serve.engine import (PageRankQueryEngine, PPRQuery,
                                      ServeResilience)

__all__ = ["PageRankQueryEngine", "PPRQuery", "ServeResilience",
           "CacheEntry", "ResultCache"]
