"""Seconds of the rest of the layout's host build (on ``ell``: the
degree percentile, ``row_positions``, the (n, k0) scatters and the
overflow): the program's span ``prepare.pack`` inside ``prepare``, the
engine's constructor."""
from perfbench.spans import phase_s


def read(rec):
    return phase_s("prepare.pack")
