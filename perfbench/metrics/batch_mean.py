"""Queries per flushed batch: the program's counters ``serve.queries``
over ``serve.batches`` in the window."""


def read(rec):
    c = rec.get("counters", {})
    return (c["serve.queries"] / c["serve.batches"]
            if c.get("serve.batches") else None)
