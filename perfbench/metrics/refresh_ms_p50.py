"""Median, in ms, of the harness's spans around each ``refresh()``,
ending in a synchronize."""
from perfbench.metrics import p50


def read(rec):
    v = p50(rec["spans"].get("refresh", []))
    return None if v is None else v * 1e3
