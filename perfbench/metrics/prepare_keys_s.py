"""Seconds of the engine's host edge keys and degree counts
(``edge_keys`` and two ``bincount``s): the program's span
``prepare.keys`` inside ``prepare``, the engine's constructor."""
from perfbench.spans import phase_s


def read(rec):
    return phase_s("prepare.keys")
