"""Seconds of the engine's edge dedupe on its device (``_edge_set``: the
upload, one ``torch.unique`` of the keys ``src * n + dst``, the edges back
on the host): the program's span ``prepare.dedupe`` inside ``prepare``,
the engine's constructor."""
from perfbench.spans import phase_s


def read(rec):
    return phase_s("prepare.dedupe")
