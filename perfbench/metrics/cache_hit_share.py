"""Share of the window's queries that the result cache answered: the
program's counters ``serve.cache.hits`` over hits plus misses."""


def read(rec):
    c = rec.get("counters", {})
    total = c.get("serve.cache.hits", 0) + c.get("serve.cache.misses", 0)
    return c.get("serve.cache.hits", 0) / total if total else None
