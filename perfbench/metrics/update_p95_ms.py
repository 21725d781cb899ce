"""95th percentile, in ms, of every tick's time from its due time until
the flush that folded its delta in returned answers on the updated graph
(a failed tick counts until the run gave up on it)."""
from perfbench.metrics import p95


def read(rec):
    v = p95(rec.get("latencies_s", []))
    return None if v is None else v * 1e3
