"""Bytes the sharded tier copies between the cards in a step: the
program's counters ``engine.exchange_bytes`` over ``engine.sharded_steps``
across the window (counted on the host, with no sync)."""


def read(rec):
    counters = rec.get("counters") or {}
    steps = counters.get("engine.sharded_steps", 0)
    if not steps:
        return None
    return counters.get("engine.exchange_bytes", 0) / steps
