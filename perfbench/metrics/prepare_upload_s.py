"""Seconds of the layout's placement on the card, ending in a
synchronize: the program's span ``prepare.upload`` inside ``prepare``,
the engine's constructor."""
from perfbench.spans import phase_s


def read(rec):
    return phase_s("prepare.upload")
