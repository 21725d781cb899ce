"""Seconds of the engine's degree counts on its device and the degrees and
keys copied to the host (``_edge_set``, after the dedupe's one sort): the
program's span ``prepare.keys`` inside ``prepare``, the engine's
constructor."""
from perfbench.spans import phase_s


def read(rec):
    return phase_s("prepare.keys")
