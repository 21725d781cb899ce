"""95th percentile, in ms, of how late the harness sent each request past
its due time."""
from perfbench.metrics import p95


def read(rec):
    v = p95(rec.get("lags_s", []))
    return None if v is None else v * 1e3
