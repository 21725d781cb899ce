"""The largest card's share of the layout's entries over the mean card's:
the fields ``entries_per_card`` of the program's last span
``prepare.shard``."""
from perfbench.spans import records


def read(rec):
    shard = [r for r in records() if r["name"] == "prepare.shard"]
    entries = shard[-1]["fields"].get("entries_per_card") if shard else None
    if not entries or not sum(entries):
        return None
    return max(entries) * len(entries) / sum(entries)
