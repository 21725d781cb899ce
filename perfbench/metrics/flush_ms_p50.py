"""Median, in ms, of the harness's spans around each call that flushed
(an explicit flush, or a submit that filled a batch), ending when the
answers are on the host."""
from perfbench.metrics import p50


def read(rec):
    v = p50(rec["spans"].get("flush", []))
    return None if v is None else v * 1e3
