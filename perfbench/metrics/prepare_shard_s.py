"""Seconds of the sharded tier's partition of the edges over the cards
(``ell_split_sharded``: the upload of each card's share of the edge list,
the exchange by ``dst`` and the dedupe on each card, the degrees summed
across cards, the degree order and the row bounds, the exchange into the
row blocks): the program's span ``prepare.shard`` inside ``prepare``, the
engine's constructor."""
from perfbench.spans import phase_s


def read(rec):
    return phase_s("prepare.shard")
