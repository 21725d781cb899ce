"""Seconds of the engine's edge dedupe (``_dedupe_edges``): the program's
span ``prepare.dedupe`` inside ``prepare``, the engine's constructor."""
from perfbench.spans import phase_s


def read(rec):
    return phase_s("prepare.dedupe")
