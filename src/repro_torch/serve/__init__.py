from repro_torch.serve.cache import CacheEntry, ResultCache
from repro_torch.serve.engine import (PageRankQueryEngine, PPRQuery, Request,
                                      ServeEngine, ServeResilience,
                                      batched_decode_fn)

__all__ = ["Request", "ServeEngine", "batched_decode_fn",
           "PageRankQueryEngine", "PPRQuery", "ServeResilience",
           "CacheEntry", "ResultCache"]
